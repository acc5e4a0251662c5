"""The port's sharded forms (nmpc_tpu_torch/parallel/mesh.py, batch.py::
shard_ocp_batch, decentralized_step_sharded, consensus_solve_sharded and
parallel/dryrun.py) on gloo worlds of CPU processes, against the port's
single-program forms and against the reference's sharded forms on the
8-device CPU mesh of tests/conftest.py (`data_mesh(2, axis="robots")`, as
tests/test_consensus.py:71-111 and tests/test_parallel.py:36-88,153-170).

A world of 2 ranks and one of 4 (for the (2, 2) hosts x chips mesh) are
spawned once for the module (tests/sharded_worker.py, torch only, one
intra-op thread a rank, a file store under tmp_path), while the parent
computes the reference's results with JAX. Inputs are made from numpy
seeds and handed to both packages.

Tolerances: sharded against the port's own single-program form at the
reference's dry-run tolerances (__graft_entry__.py:48-142: x_next, U and X
atol 1e-4, mean cost rtol 1e-4, violation and delta histories atol 1e-5);
the port's sharded forms against the reference's at
tests/test_torch_parallel.py's and tests/test_torch_consensus.py's stated
ones (a round's controls and plans atol 1e-2 and cost rtol 5e-4; consensus
X 5e-3, U 1e-2, histories 5e-3). Rows, placements and round trips exactly.
"""

import functools
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import sharded_worker as W
from nmpc_tpu.parallel import consensus as JC
from nmpc_tpu.parallel import decentralized as JD
from nmpc_tpu.parallel.batch import batch_ocp as jax_batch_ocp
from nmpc_tpu.parallel.batch import batched_solve as jax_batched_solve
from nmpc_tpu.parallel.batch import shard_ocp_batch as jax_shard_ocp_batch
from nmpc_tpu.parallel.mesh import data_mesh as jax_data_mesh
from nmpc_tpu.scenarios import get as jax_get
from nmpc_tpu.solver.alilqr import ALILQRConfig as JaxConfig
from nmpc_tpu.solver.alilqr import cold_start as jax_cold_start
from nmpc_tpu_torch.parallel import dryrun
from nmpc_tpu_torch.parallel import mesh as TM
from nmpc_tpu_torch.parallel.batch import batch_ocp, shard_ocp_batch
from nmpc_tpu_torch.scenarios import get


def circle(m, heading):
    ang = np.arange(m) * 2 * np.pi / m
    x0 = np.stack([np.cos(ang), np.sin(ang), ang + heading], -1)
    goals = np.stack([-np.cos(ang), -np.sin(ang), ang + heading], -1)
    return x0.astype(np.float32), goals.astype(np.float32)


def make_inputs() -> dict:
    rng = np.random.default_rng(11)
    base = jax_get("two_robot_swap").make(N=10)
    step_x0 = np.asarray(base.x0)[None] + 0.05 * rng.standard_normal((8, base.nx))
    dec_poses, dec_goals = circle(4, np.pi)                 # tests/test_parallel.py:72-88, m=4
    con_x0, con_goals = circle(4, np.pi)                    # tests/test_consensus.py:71-111, m=4
    return dict(
        ob_x0=rng.standard_normal((4, 3)).astype(np.float32),
        ob_xref=rng.standard_normal((4, 5, 3)).astype(np.float32),
        ob_mov=rng.standard_normal((4, 5, 2, 2)).astype(np.float32),
        step_x0=step_x0.astype(np.float32),
        dec_poses=dec_poses, dec_goals=dec_goals,
        dec_plans=np.repeat(dec_poses[:, None, :2], 11, 1),
        con_x0=con_x0.reshape(-1), con_goals=con_goals, con_N=12)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """The 2- and 4-rank worlds, started at once in the background: their
    results (a list over ranks each) come from .result()."""
    inp = make_inputs()
    pool = ThreadPoolExecutor(2)
    two = pool.submit(dryrun.run_world, W.two_ranks, 2, "gloo", inp,
                      workdir=str(tmp_path_factory.mktemp("world2")))
    four = pool.submit(dryrun.run_world, W.four_ranks, 4, "gloo", inp,
                       workdir=str(tmp_path_factory.mktemp("world4")))
    yield inp, two, four
    pool.shutdown(wait=True)


def same_on_every_rank(outs, key):
    """The gathered output `key` of every rank, held equal bit for bit;
    rank 0's returned."""
    for o in outs[1:]:
        for k, v in outs[0][key].items():
            np.testing.assert_array_equal(o[key][k], v, err_msg=f"{key}.{k}")
    return outs[0][key]


def test_consensus_sharded_matches_reference_and_single_program(worlds):
    """consensus_solve_sharded with both engines on m=4 robots over 2 ranks
    (N=12, 3 rounds, rh_bias=0.05: the reference test's configuration with
    m halved): against the port's single-program form at the dry run's
    tolerances and against the reference's sharded form on a 2-device
    mesh. The reference runs first, while the worlds solve."""
    inp, two, _ = worlds
    m, N = 4, inp["con_N"]
    tpl = JD.robot_template(N, 0.1, 0.25, m)
    cfg = JaxConfig(**W.CONSENSUS_CFG)
    mesh = jax_data_mesh(2, axis="robots")
    want = {}
    for engine in ("xla", "fused"):
        run = JC.consensus_solve_sharded(mesh, tpl, cfg=cfg, rounds=3, damping=0.5,
                                         rh_bias=0.05, engine=engine)
        X, U, w, plans, v, d = run(jnp.asarray(inp["con_x0"]).reshape(m, 3),
                                   jnp.asarray(inp["con_goals"]))
        want[engine] = [np.asarray(a) for a in (X, U, v, d, w.lam, plans)]
    outs = two.result()
    for engine in ("xla", "fused"):
        got = same_on_every_rank(outs, f"con_{engine}")
        np.testing.assert_allclose(got["U"], got["U1"], atol=1e-4)
        np.testing.assert_allclose(got["X"], got["X1"], atol=1e-4)
        np.testing.assert_allclose(got["v"], got["v1"], atol=1e-5)
        np.testing.assert_allclose(got["d"], got["d1"], atol=1e-5)
        X, U, v, d, lam, plans = want[engine]
        np.testing.assert_allclose(got["X"], X, atol=5e-3)
        np.testing.assert_allclose(got["U"], U, atol=1e-2)
        np.testing.assert_allclose(got["v"], v, atol=5e-3)
        np.testing.assert_allclose(got["d"], d, atol=5e-3)
        np.testing.assert_allclose(got["plans"], plans, atol=5e-3)
        assert got["lam"].shape == lam.shape


def test_decentralized_step_sharded_matches_reference(worlds):
    """decentralized_step_sharded on m=4 robots over 2 ranks, N=10,
    ALILQRConfig(n_outer=3, n_inner=5) (tests/test_parallel.py:72-88 with m
    halved): against the port's `decentralized_step` (rh_bias=0, the
    per-scenario engine, neighbours in ascending order) at the dry run's
    1e-4, and against the reference's sharded form at a round's 1e-2; every
    robot moves toward its antipode."""
    inp, two, _ = worlds
    m, N = 4, 10
    tpl = JD.robot_template(N, 0.1, 0.3, m)
    step = JD.decentralized_step_sharded(jax_data_mesh(2, axis="robots"), tpl,
                                         JaxConfig(**W.ROUND_CFG), axis="robots")
    w = jax.vmap(lambda _: jax_cold_start(tpl))(jnp.arange(m))
    u, plans = step(*(jnp.asarray(inp[k]) for k in ("dec_poses", "dec_goals", "dec_plans")),
                    w.U, w.lam, w.mu)
    got = same_on_every_rank(two.result(), "dec")
    np.testing.assert_allclose(got["u"], got["u1"], atol=1e-4)
    np.testing.assert_allclose(got["plans"], got["plans1"], atol=1e-4)
    np.testing.assert_allclose(got["u"], np.asarray(u), atol=1e-2)
    np.testing.assert_allclose(got["plans"], np.asarray(plans), atol=1e-2)
    assert got["u"][:, 0].min() > 0.0


@pytest.mark.parametrize("world", [2, 4])
def test_data_parallel_step_matches_unsharded_and_reference(worlds, world):
    """The data-parallel MPC step (shard_ocp_batch, batched_solve, the plant,
    the all-reduced mean cost) on two_robot_swap N=10, B=8: over a 2-rank
    data mesh and over the (2, 2) hosts x chips mesh, against the unsharded
    step at the dry run's tolerances, and the solve against the
    reference's sharded batched_solve on the same layout (U 1e-2, X 5e-3,
    cost rtol 5e-4)."""
    inp, two, four = worlds
    ob = jax_batch_ocp(jax_get("two_robot_swap").make(N=10), jnp.asarray(inp["step_x0"]))
    if world == 2:
        mesh, axis = jax_data_mesh(2), "data"
    else:
        mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("hosts", "chips"))
        axis = ("hosts", "chips")
    res = jax.jit(functools.partial(jax_batched_solve, cfg=JaxConfig(**W.STEP_CFG)))(
        jax_shard_ocp_batch(ob, mesh, axis=axis))
    outs = (two if world == 2 else four).result()
    got = same_on_every_rank(outs, "step")
    np.testing.assert_allclose(got["x_next"], got["x_next1"], atol=1e-4)
    np.testing.assert_allclose(got["U"], got["U1"], atol=1e-4)
    np.testing.assert_allclose(got["mean"], got["mean1"], rtol=1e-4)
    np.testing.assert_allclose(got["mean"], got["cost"].mean(), rtol=1e-6)
    np.testing.assert_allclose(got["U"], np.asarray(res.U), atol=1e-2)
    np.testing.assert_allclose(got["X"], np.asarray(res.X), atol=5e-3)
    np.testing.assert_allclose(got["cost"], np.asarray(res.cost), rtol=5e-4)


def test_placements_rows_and_round_trips(worlds):
    """batch_sharding / replicated; shard_rows gives each rank its rows as
    a fresh allocation (row-major over ("hosts", "chips")), gather_rows
    brings them back exactly; an indivisible axis, more devices than ranks
    and a rank outside a smaller mesh raise."""
    _, two, four = worlds
    x = np.arange(8 * 3, dtype=np.float32).reshape(8, 3)
    for o in two.result():
        r = o["rank"]
        assert o["placements"] and o["fresh"] and o["round_trip"]
        np.testing.assert_array_equal(o["rows"], x[4 * r:4 * r + 4])
        assert o["raise_rows"].startswith("ValueError: 7 rows do not divide over 2 shards")
        assert o["raise_n"].startswith("ValueError: data_mesh: 3 devices asked of a world of 2")
    x = np.arange(8 * 2, dtype=np.float32).reshape(8, 2)
    for o in four.result():
        r = o["rank"]
        assert o["index"] == r and o["round_trip"]
        assert o["placements"] and o["placements_chips"]
        np.testing.assert_array_equal(o["rows"], x[2 * r:2 * r + 2])
        assert o["sub_coordinate"] == ((r,) if r < 2 else None)
        assert (o["sub_raise"].startswith(f"RuntimeError: rank {r} is not in the mesh")
                if r >= 2 else o["sub_raise"] == "")


def test_shard_ocp_batch_rows_and_replicas(worlds):
    """shard_ocp_batch gives each rank its rows of x0, xref and a
    per-scenario mov_obs [B, N, n_mov, 2] and every other field as it is;
    an indivisible B raises, and so does a call after the world is gone."""
    inp, two, four = worlds
    tpl = JD.robot_template(5, 0.1, 0.3, 3)
    for o in two.result():
        r = o["rank"]
        sl = slice(2 * r, 2 * r + 2)
        for name, key in (("x0", "ob_x0"), ("xref", "ob_xref"), ("mov_obs", "ob_mov")):
            np.testing.assert_array_equal(o["ob"][name], inp[key][sl], err_msg=name)
        for name in ("Qdiag", "Rdiag", "u_lo", "u_hi", "x_lo", "x_hi", "dmin2", "obstacles"):
            np.testing.assert_array_equal(o["ob"][name], np.asarray(getattr(tpl, name)), name)
        assert o["ob_shared"]
        assert o["raise_ob"].startswith("ValueError: 3 rows do not divide over 2 shards")
    for o in four.result():
        assert o["raise_no_world"].startswith("RuntimeError: no torch.distributed process group")


def test_nothing_starts_a_world_behind_the_caller():
    """Without a world, data_mesh and shard_ocp_batch raise; none is made."""
    assert not torch.distributed.is_initialized()
    with pytest.raises(RuntimeError, match="no torch.distributed process group"):
        TM.data_mesh()
    ob = batch_ocp(get("two_robot_swap").make(N=5, device="cpu"), torch.zeros((4, 6)))
    with pytest.raises(RuntimeError, match="no torch.distributed process group"):
        shard_ocp_batch(ob, None)
    assert not torch.distributed.is_initialized()


def test_dryrun_multichip_on_two_ranks(worlds):
    """The port's dry run on the 2-rank world: every block of the
    reference's (the data-parallel step with both engines, the
    decentralized exchange, hosts x chips, consensus, the GN fleet, the
    ADMM fleet) passed its own assertion on every rank."""
    _, two, _ = worlds
    outs = two.result()
    for o in outs:
        assert set(o["dryrun"]) == {
            "data-parallel step, batched_solve", "data-parallel step, solve_batched",
            "decentralized exchange", "hosts x chips", "consensus", "GN fleet", "ADMM fleet"}
        assert o["dryrun"] == outs[0]["dryrun"]


def test_fleet_batch_example_shards_over_the_world(worlds):
    """examples/fleet_batch.py in the 2-rank world shards its batch over a
    data mesh of the world (2 scenarios a rank) and reports the converged
    share and largest violation of all 4, as the single-device run does."""
    from nmpc_tpu_torch.examples import fleet_batch

    _, two, _ = worlds
    one = fleet_batch.run(4, "cpu", N=5)
    assert one["devices"] == 1
    for o in two.result():
        r = o["fleet"]
        assert r["devices"] == 2 and r["B"] == 4 and r["solves_per_s"] > 0
        assert (r["converged"], r["max_viol"]) == (one["converged"], one["max_viol"])
