"""The multi-device dry run of the sharded forms. Port of
`__graft_entry__.py::dryrun_multichip`.

`dryrun_multichip(mesh)` runs on an initialized world of any size, every
rank calling it with the same 1-D mesh (`mesh.data_mesh`), and holds each
sharded form against its single-program form on the same inputs (made from
numpy seeds, so every rank makes the same ones), at the reference's
tolerances:

* the data-parallel MPC step (`shard_ocp_batch`, the solve, the first
  control through the plant, the mean cost all-reduced): x_next atol 1e-4,
  mean cost rtol 1e-4; with `batched_solve` (the reference's engine here)
  and with `solve_batched` (the fleet's, on CUDA tensors K1 and K2);
* the decentralized exchange round (`decentralized_step_sharded`) against
  `decentralized_step` with rh_bias=0 and engine "xla": u and plans atol
  1e-4;
* the two-level ("hosts", "chips") mesh when the world size is even: the
  batch laid over both dimensions, mean cost rtol 1e-4 and U atol 1e-4;
* consensus (`consensus_solve_sharded`, engine "fused") against
  `consensus_solve`: U and X atol 1e-4, violation history atol 1e-5;
* the family-I GN fleet (solver/gn.py) on the data mesh: U atol 1e-4, cost
  rtol 1e-4;
* the shared-factor ADMM fleet (one `qp_setup`, per-element q, l, u
  sharded): x atol 1e-5.

`run_world` starts such a world in new processes (scripts and tests):
`run_world(dryrun_rank, 2, "gloo", "cuda")` runs the dry run on two ranks
that share one card and exchange through gloo.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
import tempfile

import numpy as np
import torch
import torch.distributed as dist

from nmpc_tpu_torch.ocp.problem import OCP
from nmpc_tpu_torch.parallel.batch import batch_ocp, batched_solve, shard_ocp_batch
from nmpc_tpu_torch.parallel.consensus import consensus_solve, consensus_solve_sharded
from nmpc_tpu_torch.parallel.decentralized import (
    cold_warms,
    decentralized_step,
    decentralized_step_sharded,
    robot_template,
)
from nmpc_tpu_torch.parallel.mesh import (
    all_reduce,
    axis_size,
    data_mesh,
    gather_rows,
    hosts_chips_mesh,
    init_world,
    shard_rows,
)
from nmpc_tpu_torch.sim.plant import PlantConfig, plant_step
from nmpc_tpu_torch.solver.alilqr import ALILQRConfig
from nmpc_tpu_torch.solver.alilqr_batched import solve_batched


def mesh_device(mesh) -> torch.device:
    """The device a rank of the mesh computes on: its current card, or the
    CPU for a "cpu" mesh."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def mpc_step(ocp_b: OCP, cfg: ALILQRConfig, solve=batched_solve, mesh=None, axis="data"):
    """The data-parallel MPC step on this rank's batch: solve, apply the
    first control through the plant, and the mean cost over the whole batch
    (a SUM all-reduce over `axis` divided by B, or the local mean without a
    mesh). Returns (result, x_next [b, nx], mean_cost)."""
    res = solve(ocp_b, cfg=cfg)
    x_next, _ = plant_step(ocp_b.x0, res.U[:, 0, :], ocp_b.T, PlantConfig())
    if mesh is None:
        return res, x_next, res.cost.mean()
    B = ocp_b.x0.shape[0] * axis_size(mesh, axis)
    return res, x_next, all_reduce(res.cost.sum(), mesh, axis) / B


def _close(tag: str, got, want, atol: float = 0.0, rtol: float = 0.0) -> float:
    torch.testing.assert_close(got, want, atol=atol, rtol=rtol, msg=lambda m: f"{tag}: {m}")
    return float((got - want).abs().max()) if got.numel() else 0.0


def _circle(m: int, dev) -> torch.Tensor:
    ang = np.arange(m) * 2 * np.pi / max(m, 1)
    return torch.tensor(np.stack([np.cos(ang), np.sin(ang), ang], -1), dtype=torch.float32,
                        device=dev)


def dryrun_multichip(mesh) -> dict:
    """Every block of the reference's dry run on the world of `mesh` (a 1-D
    mesh over all its ranks), each sharded form held against its
    single-program form (module note). Returns {block: largest |sharded -
    single-program|}; any disagreement raises."""
    from nmpc_tpu_torch.scenarios import get

    dev = mesh_device(mesh)
    n = mesh.size()
    axis = mesh.mesh_dim_names[0]
    errs = {}

    # ---- data-parallel MPC step over the scenario batch ----
    base = get("two_robot_swap").make(N=5, device=dev)
    cfg = ALILQRConfig(n_outer=2, n_inner=3)
    B = 2 * n
    x0s = base.x0[None] + torch.tensor(
        0.05 * np.random.default_rng(0).standard_normal((B, base.nx)), dtype=torch.float32,
        device=dev)
    ob = batch_ocp(base, x0s)
    for name, solve in (("batched_solve", batched_solve), ("solve_batched", solve_batched)):
        _, x_loc, mean = mpc_step(shard_ocp_batch(ob, mesh, axis), cfg, solve, mesh, axis)
        x_next = gather_rows(x_loc, mesh, axis)
        _, x_ref, mean_ref = mpc_step(ob, cfg, solve)
        assert x_next.shape == (B, base.nx) and torch.isfinite(mean)
        errs[f"data-parallel step, {name}"] = _close(
            f"sharded data-parallel MPC step ({name}) against unsharded", x_next, x_ref, atol=1e-4)
        _close(f"sharded mean cost ({name})", mean, mean_ref, rtol=1e-4)

    # ---- decentralized robot-sharded exchange round ----
    m, N = n, 4
    rmesh = data_mesh(n, axis="robots", device_type=mesh.device_type)
    tpl = robot_template(N, 0.1, 0.3, m, device=dev)
    dcfg = ALILQRConfig(n_outer=1, n_inner=2)
    poses = _circle(m, dev)
    goals = -poses
    plans = poses[:, None, :2].repeat(1, N + 1, 1)
    w = cold_warms(tpl, m, dcfg)
    step = decentralized_step_sharded(rmesh, tpl, dcfg)
    u, plans_new = step(poses, goals, plans, w.U, w.lam, w.mu)
    assert u.shape == (m, 2) and plans_new.shape == (m, N + 1, 2)
    _, u1, p1 = decentralized_step(tpl, poses.reshape(-1), goals, plans, w, dcfg, rh_bias=0.0,
                                   engine="xla")
    errs["decentralized exchange"] = max(
        _close("sharded decentralized controls", u, u1.reshape(m, 2), atol=1e-4),
        _close("sharded decentralized plans", plans_new, p1, atol=1e-4))

    # ---- two-level hosts x chips mesh ----
    if n % 2 == 0:
        mesh2 = hosts_chips_mesh(2, device_type=mesh.device_type)
        hc = ("hosts", "chips")
        r2, _, cost2 = mpc_step(shard_ocp_batch(ob, mesh2, hc), cfg, batched_solve, mesh2, hc)
        r1, _, cost1 = mpc_step(ob, cfg, batched_solve)
        errs["hosts x chips"] = _close("hosts x chips controls", gather_rows(r2.U, mesh2, hc),
                                       r1.U, atol=1e-4)
        _close("hosts x chips mean cost", cost2, cost1, rtol=1e-4)

    # ---- robot-sharded joint solve (Jacobi-AL consensus) ----
    mc = 2 * n
    tpl_c = robot_template(N, 0.1, 0.3, mc, device=dev)
    poses_c = _circle(mc, dev)
    run = consensus_solve_sharded(rmesh, tpl_c, dcfg, rounds=2)
    Xc, Uc, _, _, violh, deltah = run(poses_c, -poses_c)
    assert Xc.shape == (mc, N + 1, 3) and Uc.shape == (mc, N, 2) and violh.shape == (2,)
    assert torch.isfinite(violh).all() and torch.isfinite(deltah).all()
    Xc1, Uc1, _, _, violh1, _ = consensus_solve(tpl_c, poses_c.reshape(-1), -poses_c, dcfg,
                                                rounds=2)
    errs["consensus"] = max(_close("sharded consensus controls", Uc, Uc1, atol=1e-4),
                            _close("sharded consensus states", Xc, Xc1, atol=1e-4),
                            _close("sharded consensus violation history", violh, violh1,
                                   atol=1e-5))

    # ---- family-I GN fleet on the data mesh ----
    from nmpc_tpu_torch.sim.lidar import obstacle_points, ray_angles
    from nmpc_tpu_torch.solver import gn

    sc = get("lidar_v4")
    lbase = sc.make(N=6, device=dev)
    R = sc.num_rays
    scan = torch.full((R,), 3.5, device=dev)
    scan[1], scan[2] = 0.9, 1.1
    lbase = dataclasses.replace(lbase, p_obs=obstacle_points(lbase.x0[:3], scan, ray_angles(
        R, torch.float32, dev)), x0=torch.cat([lbase.x0[:3], scan]))
    gcfg = gn.GNConfig(Nc=3, n_gn=2, n_outer=2)
    noise = torch.tensor(0.05 * np.random.default_rng(1).standard_normal((B, 3)),
                         dtype=torch.float32, device=dev)
    ob_l = batch_ocp(lbase, torch.cat([lbase.x0[None, :3] + noise,
                                       lbase.x0[None, 3:].expand(B, R)], dim=1))
    r_sh = gn.solve_batched(shard_ocp_batch(ob_l, mesh, axis), cfg=gcfg)
    r_un = gn.solve_batched(ob_l, cfg=gcfg)
    errs["GN fleet"] = _close("sharded GN fleet controls", gather_rows(r_sh.U, mesh, axis),
                              r_un.U, atol=1e-4)
    _close("sharded GN fleet costs", gather_rows(r_sh.cost, mesh, axis), r_un.cost, rtol=1e-4)

    # ---- shared-factor ADMM fleet on the data mesh ----
    from nmpc_tpu_torch.solver.admm import ADMMConfig, build_ltv_mpc_qp, qp_setup, qp_solve_batched

    eye = torch.eye(2)
    Pq, Aq, _, _, pack = build_ltv_mpc_qp(
        [[1.0, 0.1], [0.0, 1.0]], [[0.005], [0.1]], eye, 0.1 * torch.eye(1), eye, 6,
        x_lo=[-5.0, -5.0], x_hi=[5.0, 5.0], u_lo=[-1.5], u_hi=[1.5], device=dev)
    acfg = ADMMConfig(max_iter=60)
    fac = qp_setup(Pq, Aq, acfg)
    rng = np.random.default_rng(2)
    qs = torch.tensor(0.1 * rng.standard_normal((B, Pq.shape[0])), dtype=torch.float32,
                      device=dev)
    x_inits = 0.5 * rng.standard_normal((B, 2))
    ls, us = (torch.stack(t) for t in zip(*(pack(x) for x in x_inits)))
    x_sh = qp_solve_batched(fac, *(shard_rows(a, mesh, axis) for a in (qs, ls, us)), acfg)[0]
    x_un = qp_solve_batched(fac, qs, ls, us, acfg)[0]
    errs["ADMM fleet"] = _close("sharded batched-ADMM solution", gather_rows(x_sh, mesh, axis),
                                x_un, atol=1e-5)
    return errs


def _world_main(rank: int, fn, world_size: int, backend: str, workdir: str, args: tuple):
    init_world(backend, rank, world_size, "file://" + os.path.join(workdir, "store"))
    try:
        out = fn(*args)
        with open(os.path.join(workdir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    finally:
        if dist.is_initialized():   # fn may have left the world itself
            dist.destroy_process_group()


def run_world(fn, world_size: int, backend: str, *args, workdir: str | None = None) -> list:
    """fn(*args) in each of world_size new processes (torch.multiprocessing,
    spawned) that form a world on `backend` through a file store in
    `workdir` (a new temporary directory by default). fn must be importable
    by module and name and return host values. Returns the ranks' results
    in rank order; a rank that fails raises here."""
    import torch.multiprocessing as mp

    workdir = tempfile.mkdtemp(prefix="nmpc_world_") if workdir is None else workdir
    mp.spawn(_world_main, args=(fn, world_size, backend, workdir, args), nprocs=world_size,
             join=True)
    out = []
    for r in range(world_size):
        with open(os.path.join(workdir, f"rank{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


def dryrun_rank(device_type: str) -> dict:
    """One rank's dry run on a mesh over the whole world: the blocks'
    largest errors and the kernel launches this rank made."""
    from nmpc_tpu_torch.ops import cuda_build

    if device_type == "cuda":
        # ranks beyond the cards share them (two ranks on one card: gloo)
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())
    else:
        torch.set_num_threads(1)    # the ranks share the host's cores
    cuda_build.reset_launch_counts()
    errs = dryrun_multichip(data_mesh(device_type=device_type))
    return {"errs": errs, "launches": dict(cuda_build.launch_counts)}

