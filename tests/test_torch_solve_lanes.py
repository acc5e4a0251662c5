"""The port's staged route (nmpc_tpu_torch.solver.alilqr_batched._solve_lanes:
K4 expansions, K3 Riccati sweep, K5 line-search merits and K6 accepted
rollout per inner iteration) against the reference's
`solve_batched(mega=False)`, whose Pallas kernels run in interpret mode on the
CPU. Inputs are made with numpy from a seed and handed to both packages.

The staged path is its own algorithm, not a slower megakernel: a grid line
search, another stop rule and another way of counting inner iterations
(counted at the start of an iteration, for every scenario, converged or
not), so each route is held against its own reference, inner_iters
included.

Tolerances: cost rtol 1e-4 and U atol 5e-3, as tests/test_batched_solver.py
holds batched against per-scenario solves; on the six-robot swap U atol
5e-2 (the flat cost valley of its converged controls, see
tests/test_torch_solve_batched.py); on moving obstacles the tolerances of
tests/test_batched_solver.py:48-86 (cost rtol 5e-4, U atol 1e-2, violation
< 1e-3, clearance > dmin - 1e-2).

Two checks are looser than that, each by its measured gap. Near
convergence the staged path decides at the f32 rounding level: its stop
rule rel < 1e-7 is about two ulp of a merit of ~470, and its grid line
search compares candidates that sit within +-2 ulp of the current merit
(measured on the two-robot batch below: the best candidate's decrease was
-1 ulp at an Armijo slope of 2.7e-5). Merits summed in another order than
the reference's therefore stop some scenarios an iteration earlier or later,
and a scenario whose violation is then above tol_con takes one more outer
step, on which every scenario of the batch re-runs its inner loop and
counts it. So:
  * two_robot_swap: outer_iters within 1 and inner_iters within 2 of the
    reference (measured: one scenario of four took 4 outer steps against 3,
    inner counts [13 12 14 15] against [15 11 12 13]; the port's own f64 run
    flips another scenario). The counting rule itself is held exactly by
    `test_converged_scenarios_keep_counting`, built so that no tie decides.
  * obstacle_scenario_3 batch: U atol 1e-2 (measured 5.5e-3 against the
    reference; the port's own f32 and f64 runs differ by 5.2e-3).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nmpc_tpu.ocp import problem as JP
from nmpc_tpu.parallel.batch import batch_ocp as jax_batch_ocp
from nmpc_tpu.scenarios import get as jax_get
from nmpc_tpu.solver.alilqr import ALILQRConfig as JaxConfig
from nmpc_tpu.solver.alilqr import WarmStart as JaxWarm
from nmpc_tpu.solver.alilqr_batched import solve_batched as jax_solve_batched
from nmpc_tpu_torch.ocp import problem as TP
from nmpc_tpu_torch.ops import cuda_build
from nmpc_tpu_torch.solver import alilqr_batched
from nmpc_tpu_torch.solver.alilqr import ALILQRConfig, warm_from_numpy
from nmpc_tpu_torch.solver.alilqr_batched import solve_batched, solve_one

CFG = dict(n_outer=8, n_inner=15, tol_con=1e-4)                    # test_batched_solver.py:16
BENCH = dict(n_outer=6, n_inner=12, tol_con=1e-3, ls="adaptive")   # bench.py
OBS = dict(n_outer=12, n_inner=25, tol_con=1e-3)
OBS_X0 = (0.5, 0.6, 1.571)   # in the slalom: the obstacle rows are active at N=10


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs six workers on the CPU's cores,
    where more threads a worker only wait on each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def port_ocp(o):
    data = {f.name: np.asarray(getattr(o, f.name))
            for f in dataclasses.fields(o) if f.name not in JP.OCP_META}
    return TP.ocp_from_numpy(data, device="cpu", **{k: getattr(o, k) for k in JP.OCP_META})


def _batch(name, B, spread, seed, N=10, **make):
    base = jax_get(name).make(N=N, **make)
    rng = np.random.default_rng(seed)
    x0 = (np.asarray(base.x0)[None]
          + spread * rng.standard_normal((B, base.nx))).astype(np.float32)
    return jax_batch_ocp(base, jnp.asarray(x0))


def _reference(ob, cfg_kw):
    cfg = JaxConfig(**{**cfg_kw, "mega": False})
    return jax.jit(functools.partial(jax_solve_batched, cfg=cfg))(ob)


def _no_megakernel(monkeypatch):
    """Make the megakernel route fail loudly, so a test shows its solve
    took the staged route."""
    def refuse(*args, **kwargs):
        raise AssertionError("routed to the megakernel")
    monkeypatch.setattr(alilqr_batched, "_solve_mega", refuse)


def test_two_robot_swap_matches_reference_staged_path():
    ob = _batch("two_robot_swap", 4, 0.05, seed=0)
    jr = _reference(ob, CFG)
    tr = solve_batched(port_ocp(ob), cfg=ALILQRConfig(**CFG, mega=False))
    np.testing.assert_allclose(tr.cost.numpy(), np.asarray(jr.cost), rtol=1e-4)
    np.testing.assert_allclose(tr.U.numpy(), np.asarray(jr.U), atol=5e-3)
    np.testing.assert_array_equal(tr.converged.numpy(), np.asarray(jr.converged))
    # rounding-level ties (module docstring): within one outer step and two
    # inner iterations
    assert np.abs(tr.outer_iters.numpy() - np.asarray(jr.outer_iters)).max() <= 1
    assert np.abs(tr.inner_iters.numpy() - np.asarray(jr.inner_iters)).max() <= 2
    assert bool(tr.converged.all())
    assert tr.X.shape == (4, 11, 6) and tr.lam.shape == (4, 10, 21)


def test_converged_scenarios_keep_counting():
    """The staged counting rule, exactly: an iteration counts at its start
    for every scenario not yet done in this outer step, and each outer step
    restarts the inner loop of every scenario, converged or not. Scenario 0
    is warm-started at its own solution: its first iteration stops it, and it
    converges on the first outer step; the cold ones run every iteration of
    their budget (n_inner=2 keeps them far from the rounding-level ties)."""
    ob = _batch("two_robot_swap", 3, 0.05, seed=4)
    first = solve_batched(port_ocp(ob), cfg=ALILQRConfig(**CFG, mega=False))
    z = np.zeros
    warm = (np.stack([first.U[0].numpy(), z((10, 4), np.float32), z((10, 4), np.float32)]),
            np.stack([first.lam[0].numpy(), z((10, 21), np.float32), z((10, 21), np.float32)]),
            np.array([float(first.mu[0]), 10.0, 10.0], np.float32))
    kw = dict(n_outer=3, n_inner=2, tol_con=1e-4)
    jr = jax.jit(functools.partial(jax_solve_batched, cfg=JaxConfig(**kw, mega=False)))(
        ob, JaxWarm(*(jnp.asarray(a) for a in warm)))
    tr = solve_batched(port_ocp(ob), warm_from_numpy(*warm, device="cpu"), ALILQRConfig(**kw, mega=False))
    assert tr.converged.tolist() == [True, False, False]
    assert tr.outer_iters.tolist() == [1, 3, 3]
    assert tr.inner_iters.tolist() == [3, 6, 6]  # scenario 0: one per outer step
    np.testing.assert_array_equal(tr.converged.numpy(), np.asarray(jr.converged))
    np.testing.assert_array_equal(tr.outer_iters.numpy(), np.asarray(jr.outer_iters))
    np.testing.assert_array_equal(tr.inner_iters.numpy(), np.asarray(jr.inner_iters))
    np.testing.assert_allclose(tr.cost.numpy(), np.asarray(jr.cost), rtol=1e-4)


def test_six_robot_bench_config_matches_reference_staged_path():
    ob = _batch("six_robot_antipodal", 8, 0.1, seed=1)
    jr = _reference(ob, BENCH)
    tr = solve_batched(port_ocp(ob), cfg=ALILQRConfig(**BENCH, mega=False))
    np.testing.assert_allclose(tr.cost.numpy(), np.asarray(jr.cost), rtol=1e-4)
    np.testing.assert_allclose(tr.U.numpy(), np.asarray(jr.U), atol=5e-2)
    np.testing.assert_array_equal(tr.converged.numpy(), np.asarray(jr.converged))


def test_obstacle_problem_takes_the_staged_route(monkeypatch):
    """obstacle_scenario_3 (six static obstacles) from inside the slalom with
    mega=False: the solve takes the staged route, which is compared with the
    reference's. (With the default mega=True K1 and K2 take obstacle rows:
    tests/test_torch_megasolve.py holds that route.)"""
    _no_megakernel(monkeypatch)
    ob = _batch("obstacle_scenario_3", 8, 0.05, seed=2, x0=OBS_X0)
    jr = _reference(ob, OBS)
    tr = solve_batched(port_ocp(ob), cfg=ALILQRConfig(**OBS, mega=False))
    np.testing.assert_allclose(tr.cost.numpy(), np.asarray(jr.cost), rtol=1e-4)
    np.testing.assert_allclose(tr.U.numpy(), np.asarray(jr.U), atol=1e-2)  # see docstring
    np.testing.assert_array_equal(tr.converged.numpy(), np.asarray(jr.converged))
    np.testing.assert_array_equal(tr.outer_iters.numpy(), np.asarray(jr.outer_iters))
    n_obs = ob.n_obs
    assert float(tr.lam[:, :, :n_obs].max()) > 0.0  # the obstacle rows shaped it


def test_moving_obstacles_match_reference_staged_path(monkeypatch):
    """tests/test_batched_solver.py:48-86 on the staged route (mega=False): a
    two-slot robot_template with a per-scenario schedule, one disc parked on
    the straight start-goal line."""
    from nmpc_tpu.parallel.batch import batch_ocp
    from nmpc_tpu.parallel.decentralized import robot_template

    _no_megakernel(monkeypatch)
    tpl = robot_template(8, 0.1, 0.3, 3)
    B = 3
    x0s = np.asarray([[-0.5, 0, 0], [-0.4, 0.2, 0], [-0.6, -0.2, 0]], np.float32)
    goals = np.tile(np.asarray([[0.6, 0.0, 0.0]], np.float32), (B, 1))
    rng = np.random.default_rng(2)
    mov = np.tile(np.asarray([[0.05, 0.02], [5.0, 5.0]], np.float32)[None, None], (B, 8, 1, 1))
    mov = (mov + 0.01 * rng.standard_normal(mov.shape)).astype(np.float32)
    ob = dataclasses.replace(
        batch_ocp(tpl, jnp.asarray(x0s), jnp.asarray(np.tile(goals[:, None], (1, 8, 1)))),
        mov_obs=jnp.asarray(mov))
    jr = _reference(ob, CFG)
    tr = solve_batched(port_ocp(ob), cfg=ALILQRConfig(**CFG, mega=False))
    assert tr.U.shape == (B, 8, 2)
    np.testing.assert_allclose(tr.cost.numpy(), np.asarray(jr.cost), rtol=5e-4)
    np.testing.assert_allclose(tr.U.numpy(), np.asarray(jr.U), atol=1e-2)
    assert float(tr.viol.max()) < 1e-3
    d = np.sqrt(np.sum((tr.X[:, 1:-1, :2].numpy() - mov[:, 1:, 0, :]) ** 2, -1))
    assert float(d.min()) > 0.3 - 1e-2


@pytest.mark.parametrize("mega", [False, True])
def test_shared_moving_obstacle_schedule_is_broadcast(mega):
    """An unbatched [N, n_mov, 2] schedule gives every scenario the same
    rows as the same schedule given per scenario, on both routes."""
    from nmpc_tpu.parallel.decentralized import robot_template

    tpl = port_ocp(robot_template(8, 0.1, 0.3, 3))
    kw = dict(dtype=torch.float32)
    mov = torch.tensor([[0.05, 0.02], [5.0, 5.0]], **kw)[None].repeat(8, 1, 1)
    x0s = torch.tensor([[-0.5, 0, 0], [-0.4, 0.2, 0]], **kw)
    xref = torch.tensor([0.6, 0.0, 0.0], **kw)[None, None].repeat(2, 8, 1)
    shared = dataclasses.replace(tpl, x0=x0s, xref=xref, mov_obs=mov)
    per = dataclasses.replace(shared, mov_obs=mov[None].repeat(2, 1, 1, 1))
    cfg = ALILQRConfig(n_outer=3, n_inner=5, mega=mega)
    a, b = solve_batched(shared, cfg=cfg), solve_batched(per, cfg=cfg)
    assert torch.equal(a.U, b.U) and torch.equal(a.lam, b.lam)


def test_solve_one_on_an_obstacle_problem():
    """solve_one (B=1) on the staged route (mega=False) from a start in the
    slalom where the obstacle rows bite. (At OBS_X0 itself the single solve
    is ill-conditioned: the reference and the port's f32 and f64 runs end
    1e-3 apart in cost.)"""
    from nmpc_tpu.solver.alilqr_batched import solve_one as jax_solve_one

    ref = jax_get("obstacle_scenario_3").make(N=10, x0=(0.55, 0.65, 1.571))
    jr = jax.jit(functools.partial(jax_solve_one, cfg=JaxConfig(**OBS, mega=False)))(ref)
    tr = solve_one(port_ocp(ref), cfg=ALILQRConfig(**OBS, mega=False))
    assert tr.U.shape == (10, 2) and tr.cost.shape == ()
    np.testing.assert_allclose(float(tr.cost), float(jr.cost), rtol=1e-4)
    np.testing.assert_allclose(tr.U.numpy(), np.asarray(jr.U), atol=5e-3)
    assert bool(tr.converged) and bool(jr.converged)
    assert int(tr.outer_iters) == int(jr.outer_iters)
    assert float(tr.lam[:, :ref.n_obs].max()) > 0.0


def test_cpu_staged_path_launches_no_kernel():
    cuda_build.reset_launch_counts()
    ob = port_ocp(_batch("obstacle_scenario_3", 2, 0.05, seed=5, x0=OBS_X0))
    res = solve_batched(ob, cfg=ALILQRConfig(n_outer=2, n_inner=3, mega=False))
    assert torch.isfinite(res.cost).all() and int(res.inner_iters.min()) >= 1
    assert cuda_build.launch_counts == dict.fromkeys(cuda_build.launch_counts, 0)
    assert len(cuda_build.launch_counts) == 9


@pytest.mark.parametrize("n_outer", [0, 1])
def test_staged_path_with_few_outer_steps(n_outer):
    """n_outer=0 returns the warm controls rolled out; one outer step counts
    its inner iterations and leaves outer_iters at 1."""
    ob = port_ocp(_batch("two_robot_swap", 3, 0.05, seed=6))
    res = solve_batched(ob, cfg=ALILQRConfig(n_outer=n_outer, n_inner=4, mega=False))
    assert res.X.shape == (3, 11, 6) and torch.isfinite(res.X).all()
    assert res.outer_iters.tolist() == [n_outer] * 3
    if n_outer == 0:
        assert float(res.U.abs().max()) == 0.0
        assert res.inner_iters.tolist() == [0, 0, 0]
    else:
        assert 1 <= int(res.inner_iters.min()) and int(res.inner_iters.max()) <= 4


@pytest.mark.parametrize("mega", [True, False])
def test_unknown_line_search_raises(mega):
    """cfg.ls never picks the route: a value neither route knows raises on
    both, though the staged route does not read it."""
    ob = port_ocp(_batch("two_robot_swap", 2, 0.05, seed=6))
    with pytest.raises(ValueError, match="line search"):
        solve_batched(ob, cfg=ALILQRConfig(ls="armijo", mega=mega))


def test_route_follows_the_shape_not_the_alpha_count(monkeypatch):
    """More than 32 alphas: the megakernel route takes them on a pair-only
    problem and agrees with the reference's solve_batched (its megakernel
    in interpret mode) at the same grid; the staged route runs them too on
    an obstacle problem with mega=False."""
    alphas = tuple(0.8 ** k for k in range(33))
    kw = dict(n_outer=1, n_inner=2, alphas=alphas)
    ob = _batch("two_robot_swap", 2, 0.05, seed=6)
    jr = jax.jit(functools.partial(jax_solve_batched, cfg=JaxConfig(**kw)))(ob)
    routed, mega = [], alilqr_batched._solve_mega
    monkeypatch.setattr(alilqr_batched, "_solve_mega",
                        lambda *a, **k: routed.append(1) or mega(*a, **k))
    tr = solve_batched(port_ocp(ob), cfg=ALILQRConfig(**kw))
    assert routed == [1]
    np.testing.assert_allclose(tr.cost.numpy(), np.asarray(jr.cost), rtol=1e-4)
    np.testing.assert_allclose(tr.U.numpy(), np.asarray(jr.U), atol=5e-3)
    _no_megakernel(monkeypatch)
    obs = port_ocp(_batch("obstacle_scenario_3", 2, 0.05, seed=5, x0=OBS_X0))
    res = solve_batched(obs, cfg=ALILQRConfig(n_outer=1, n_inner=2, alphas=alphas, mega=False))
    assert torch.isfinite(res.cost).all() and res.inner_iters.tolist() == [2, 2]
