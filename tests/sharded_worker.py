"""What each rank runs in tests/test_torch_sharded.py's gloo worlds: the
port's sharded forms on CPU tensors, from numpy inputs the parent made.
Torch only (never jax): the ranks are new processes that import this module
by name (nmpc_tpu_torch.parallel.dryrun.run_world). Each function returns
host values (numpy arrays, numbers, strings), the same on every rank where
the outputs are gathered.
"""

import dataclasses
import sys

import numpy as np
import torch
import torch.distributed as dist

from nmpc_tpu_torch.parallel import batch as TB
from nmpc_tpu_torch.parallel import consensus as TC
from nmpc_tpu_torch.parallel import decentralized as TD
from nmpc_tpu_torch.parallel import dryrun, mesh as M
from nmpc_tpu_torch.scenarios import get
from nmpc_tpu_torch.solver import ALILQRConfig

ROUND_CFG = dict(n_outer=3, n_inner=5)                   # tests/test_parallel.py:72-88
CONSENSUS_CFG = dict(n_outer=4, n_inner=8, tol_con=1e-3)  # tests/test_consensus.py:71-111
STEP_CFG = dict(n_outer=4, n_inner=8, tol_con=1e-4)


def raises(fn, *args, **kw) -> str:
    """The type and message of what fn raises ('' if it returns)."""
    try:
        fn(*args, **kw)
    except Exception as e:  # noqa: BLE001  (the parent asserts the type)
        return f"{type(e).__name__}: {e}"
    return ""


def np_(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def _setup():
    torch.set_num_threads(1)
    assert "jax" not in sys.modules and "nmpc_tpu" not in sys.modules


def _step_batch(x0s):
    base = get("two_robot_swap").make(N=10, device="cpu")
    return TB.batch_ocp(base, torch.as_tensor(x0s))


def _data_parallel(mesh, axis, x0s) -> dict:
    """The data-parallel step sharded over `axis` and unsharded."""
    ob = _step_batch(x0s)
    cfg = ALILQRConfig(**STEP_CFG)
    r, x_loc, mean = dryrun.mpc_step(TB.shard_ocp_batch(ob, mesh, axis), cfg, TB.batched_solve,
                                     mesh, axis)
    r1, x1, mean1 = dryrun.mpc_step(ob, cfg)
    g = lambda t: np_(M.gather_rows(t, mesh, axis))  # noqa: E731
    return dict(U=g(r.U), X=g(r.X), cost=g(r.cost), x_next=g(x_loc), mean=float(mean),
                U1=np_(r1.U), X1=np_(r1.X), cost1=np_(r1.cost), x_next1=np_(x1),
                mean1=float(mean1))


def two_ranks(inp: dict) -> dict:
    """Every two-rank case: placements, row round trips and raises,
    shard_ocp_batch, the data-parallel step, the decentralized round,
    consensus with both engines (each beside the port's single-program
    form) and the dry run."""
    from torch.distributed.tensor import Replicate, Shard

    _setup()
    rank = dist.get_rank()
    out = {"rank": rank}
    mesh = M.data_mesh(device_type="cpu")
    out["placements"] = (M.batch_sharding(mesh) == [Shard(0)]
                         and M.replicated(mesh) == [Replicate()])
    x = torch.arange(8 * 3, dtype=torch.float32).reshape(8, 3)
    loc = M.shard_rows(x, mesh)
    out["rows"] = np_(loc)
    out["fresh"] = loc.untyped_storage().data_ptr() != x.untyped_storage().data_ptr()
    out["round_trip"] = bool(torch.equal(M.gather_rows(loc, mesh), x))
    out["raise_rows"] = raises(M.shard_rows, x[:7], mesh)
    out["raise_n"] = raises(M.data_mesh, 3, device_type="cpu")

    # shard_ocp_batch: a moving-obstacle template, per-scenario schedules
    tpl = TD.robot_template(5, 0.1, 0.3, 3, device="cpu")
    ob = dataclasses.replace(tpl, x0=torch.as_tensor(inp["ob_x0"]),
                             xref=torch.as_tensor(inp["ob_xref"]),
                             mov_obs=torch.as_tensor(inp["ob_mov"]))
    sh = TB.shard_ocp_batch(ob, mesh)
    out["ob"] = {f.name: np_(getattr(sh, f.name)) for f in dataclasses.fields(sh)
                 if isinstance(getattr(sh, f.name), torch.Tensor)}
    out["ob_shared"] = all(getattr(sh, f) is getattr(ob, f) for f in ("Qdiag", "u_hi", "dmin2"))
    out["raise_ob"] = raises(TB.shard_ocp_batch, dataclasses.replace(
        ob, x0=ob.x0[:3], xref=ob.xref[:3], mov_obs=ob.mov_obs[:3]), mesh)

    out["step"] = _data_parallel(mesh, "data", inp["step_x0"])

    # the decentralized round
    rmesh = M.data_mesh(axis="robots", device_type="cpu")
    m, N = inp["dec_poses"].shape[0], inp["dec_plans"].shape[1] - 1
    dtpl = TD.robot_template(N, 0.1, 0.3, m, device="cpu")
    cfg = ALILQRConfig(**ROUND_CFG)
    poses, goals, plans = (torch.as_tensor(inp[k]) for k in ("dec_poses", "dec_goals",
                                                             "dec_plans"))
    w = TD.cold_warms(dtpl, m, cfg)
    u, p = TD.decentralized_step_sharded(rmesh, dtpl, cfg)(poses, goals, plans, w.U, w.lam, w.mu)
    _, u1, p1 = TD.decentralized_step(dtpl, poses.reshape(-1), goals, plans, w, cfg,
                                      rh_bias=0.0, engine="xla")
    out["dec"] = dict(u=np_(u), plans=np_(p), u1=np_(u1.reshape(m, 2)), plans1=np_(p1))

    # consensus, both engines
    m, N = inp["con_goals"].shape[0], inp["con_N"]
    ctpl = TD.robot_template(N, 0.1, 0.25, m, device="cpu")
    cfg = ALILQRConfig(**CONSENSUS_CFG)
    xj, goals = torch.as_tensor(inp["con_x0"]), torch.as_tensor(inp["con_goals"])
    for engine in ("xla", "fused"):
        run = TC.consensus_solve_sharded(rmesh, ctpl, cfg, rounds=3, damping=0.5, rh_bias=0.05,
                                         engine=engine)
        X, U, wf, plans_f, v, d = run(xj.reshape(m, 3), goals)
        X1, U1, _, _, v1, d1 = TC.consensus_solve(ctpl, xj, goals, cfg, rounds=3, damping=0.5,
                                                  engine=engine, rh_bias=0.05)
        out[f"con_{engine}"] = dict(X=np_(X), U=np_(U), lam=np_(wf.lam), plans=np_(plans_f),
                                    v=np_(v), d=np_(d), X1=np_(X1), U1=np_(U1), v1=np_(v1),
                                    d1=np_(d1))
    out["dryrun"] = dryrun.dryrun_multichip(mesh)
    # the fleet_batch example, sharded over the world it finds
    from nmpc_tpu_torch.examples import fleet_batch

    out["fleet"] = fleet_batch.run(4, "cpu", N=5)
    return out


def four_ranks(inp: dict) -> dict:
    """The two-level (2, 2) hosts x chips mesh: rows in row-major order, a
    round trip, the data-parallel step laid over both dimensions; and a
    data mesh over the first two ranks only."""
    _setup()
    out = {"rank": dist.get_rank()}
    mesh2 = M.hosts_chips_mesh(2, device_type="cpu")
    hc = ("hosts", "chips")
    x = torch.arange(8 * 2, dtype=torch.float32).reshape(8, 2)
    loc = M.shard_rows(x, mesh2, hc)
    out["rows"] = np_(loc)
    out["index"] = M.axis_index(mesh2, hc)
    out["round_trip"] = bool(torch.equal(M.gather_rows(loc, mesh2, hc), x))
    out["placements"] = M.batch_sharding(mesh2, hc) == [M.Shard(0), M.Shard(0)]
    out["placements_chips"] = M.batch_sharding(mesh2, "chips") == [M.Replicate(), M.Shard(0)]
    out["step"] = _data_parallel(mesh2, hc, inp["step_x0"])
    sub = M.data_mesh(2, device_type="cpu")
    out["sub_coordinate"] = sub.get_coordinate()
    out["sub_raise"] = raises(M.shard_rows, x, sub) if out["rank"] >= 2 else ""
    ob = _step_batch(inp["step_x0"])
    dist.destroy_process_group()
    out["raise_no_world"] = raises(TB.shard_ocp_batch, ob, mesh2, hc)
    return out
