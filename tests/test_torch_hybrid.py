"""The hybrid route of the port's solve_batched (LiDAR rays, RK4 and
sweep="scan"), compact=True and cold_seed="polar", against the reference
nmpc_tpu.solver.alilqr_batched.solve_batched on the same numpy inputs; and
the per-scenario `solve` on the same problem classes against the
reference's `solve`.

Tolerances: cost rtol 1e-4 and U atol 5e-3 per scenario
(tests/test_batched_solver.py's batched-against-per-scenario criteria)
where the reference itself is stable under a 1e-7 move of x0 (as
tests/reference_spread.py measures it: U moves by 1.4e-6 on the RK4 cases,
3.5e-3 on the ray cases, whose 1/d-free ray rows leave a flat valley).
The Euler pair problem with the scan sweep moves U by 1.5e-2 under such a
move (cost by 3.2e-6), so its U is held at 5e-2, as six-robot solves are
(tests/test_torch_solver.py); the RK4 batch at N=12 moves U by 6.7e-2, so
the RK4 cases sit at N=15. compact=True is held bit for
bit against compact=False, as the reference's test holds it
(tests/test_batched_solver.py:290-315). The polar seed is held to 1e-5
against the reference's `_polar_seed`; the solve from it by cost at rtol
1e-3 and the batch's mean cost at 1e-4 (a near-tied alpha pick moves one
of the four scenarios by 1.2e-4 in cost, to the lower side).
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
from nmpc_tpu.sim.lidar import obstacle_points as jax_obstacle_points
from nmpc_tpu.sim.lidar import ray_angles as jax_ray_angles
from nmpc_tpu.solver import alilqr as JS
from nmpc_tpu.solver import alilqr_batched as JB
from nmpc_tpu_torch.ocp import problem as TP
from nmpc_tpu_torch.ops import cuda_build
from nmpc_tpu_torch.solver import alilqr_batched as TB
from nmpc_tpu_torch.solver import ALILQRConfig, WarmStart, solve, solve_batched


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Eager loops of small ops: one intra-op thread (more only spin)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def port_ocp(o):
    data = {f.name: np.asarray(getattr(o, f.name))
            for f in dataclasses.fields(o) if f.name not in JP.OCP_META}
    return TP.ocp_from_numpy(data, device="cpu", **{k: getattr(o, k) for k in JP.OCP_META})


def ray_problem(N=15):
    """lidar_v2 (full horizon, no 1/d cost, ray_lo=0.3) with its ray states
    and frozen points from one scan with two rays on an obstacle."""
    base = jax_get("lidar_v2").make(N=N, ray_lo=0.3)
    scan = np.full((10,), 3.5, np.float32)
    scan[1], scan[2] = 0.6, 0.8
    p_obs = jax_obstacle_points(base.x0[:3], jnp.asarray(scan), jax_ray_angles(10, jnp.float32))
    return dataclasses.replace(base, p_obs=p_obs, x0=base.x0.at[3:].set(jnp.asarray(scan)))


def ray_batch(B=4, N=15, seed=0):
    base = ray_problem(N)
    rng = np.random.default_rng(seed)
    x0s = np.repeat(np.asarray(base.x0)[None], B, 0)
    x0s[:, :3] += 0.05 * rng.standard_normal((B, 3))
    return jax_batch_ocp(base, jnp.asarray(x0s, jnp.float32))


def rk4_batch(B=4, N=15, seed=1):
    base = dataclasses.replace(jax_get("two_robot_swap").make(N=N, T=0.1), integrator="rk4")
    rng = np.random.default_rng(seed)
    x0s = np.asarray(base.x0)[None] + 0.05 * rng.standard_normal((B, base.nx))
    return jax_batch_ocp(base, jnp.asarray(x0s, jnp.float32))


def euler_batch(name="two_robot_swap", B=4, N=10, seed=2, spread=0.05):
    base = jax_get(name).make(N=N, T=0.1) if name != "six_robot_antipodal" else jax_get(name).make(N=N)
    rng = np.random.default_rng(seed)
    x0s = np.asarray(base.x0)[None] + spread * rng.standard_normal((B, base.nx))
    return jax_batch_ocp(base, jnp.asarray(x0s, jnp.float32))


def _hold(tr, jr, u_atol=5e-3):
    np.testing.assert_allclose(tr.cost.numpy(), np.asarray(jr.cost), rtol=1e-4)
    np.testing.assert_allclose(tr.U.numpy(), np.asarray(jr.U), atol=u_atol)
    np.testing.assert_allclose(tr.viol.numpy(), np.asarray(jr.viol), atol=1e-4)
    assert tr.X.shape == np.asarray(jr.X).shape and torch.isfinite(tr.X).all()


# (problem, config, U atol: 5e-3, or 5e-2 where the reference spreads)
# (the per-scenario `solve` runs "rk4 scan": the scan with plain rollouts)
CASES = {"rays": (ray_batch, dict(n_outer=4, n_inner=8, tol_con=1e-3), 5e-3),
         "rk4": (rk4_batch, dict(n_outer=4, n_inner=8), 5e-3),
         "rk4 scan": (rk4_batch, dict(n_outer=4, n_inner=8, sweep="scan"), 5e-3),
         "euler scan": (euler_batch, dict(n_outer=4, n_inner=8, sweep="scan"), 5e-2)}


@pytest.mark.parametrize("case", ["rays", "rk4", "euler scan"])
def test_hybrid_route_matches_reference(case):
    """Rays, RK4 and the scan sweep take the hybrid route (K3 through
    riccati_fused, or the associative scan; K5/K6 on the Euler pair problem,
    plain rollouts elsewhere; their plain versions on the CPU) and agree
    with the reference's solve_batched; outer counts equal."""
    make, kw, u_atol = CASES[case]
    ob = make()
    jr = jax.jit(functools.partial(JB.solve_batched, cfg=JS.ALILQRConfig(**kw)))(ob)
    cuda_build.reset_launch_counts()
    tr = solve_batched(port_ocp(ob), cfg=ALILQRConfig(**kw))
    assert not any(cuda_build.launch_counts.values())   # CPU tensors: no kernel
    _hold(tr, jr, u_atol)
    np.testing.assert_array_equal(tr.outer_iters.numpy(), np.asarray(jr.outer_iters))
    assert np.abs(tr.inner_iters.numpy() - np.asarray(jr.inner_iters)).max() <= 1


@pytest.mark.parametrize("case", ["rays", "rk4 scan"])
def test_per_scenario_solve_matches_reference(case):
    """The per-scenario engine on a ray problem (jacfwd Jacobians and the
    1/d-free ray expansion) and on RK4 with the scan sweep."""
    make, kw, _ = CASES[case]
    o = make(B=1)
    one = dataclasses.replace(o, x0=o.x0[0], xref=o.xref[0])
    jr = jax.jit(functools.partial(JS.solve, cfg=JS.ALILQRConfig(**kw)))(one)
    tr = solve(port_ocp(one), cfg=ALILQRConfig(**kw))
    np.testing.assert_allclose(float(tr.cost), float(jr.cost), rtol=1e-4)
    np.testing.assert_allclose(tr.U.numpy(), np.asarray(jr.U), atol=5e-3)
    assert int(tr.outer_iters) == int(jr.outer_iters)


def test_hybrid_route_is_taken_where_the_reference_takes_it():
    """Routing by shape and sweep before any launch: rays, RK4 and
    sweep='scan' take _solve_hybrid; an Euler pair problem with sweep='seq'
    does not."""
    calls = []
    real = TB._solve_hybrid
    TB._solve_hybrid = lambda *a, **k: calls.append(a[-1]) or real(*a, **k)
    try:
        cfg = ALILQRConfig(n_outer=1, n_inner=1)
        solve_batched(port_ocp(ray_batch(B=2, N=5)), cfg=cfg)
        solve_batched(port_ocp(rk4_batch(B=2, N=5)), cfg=cfg)
        solve_batched(port_ocp(euler_batch(B=2, N=5)), cfg=dataclasses.replace(cfg, sweep="scan"))
        assert calls == ["seq", "seq", "scan"]
        solve_batched(port_ocp(euler_batch(B=2, N=5)), cfg=cfg)
        solve_batched(port_ocp(euler_batch(B=2, N=5)), cfg=dataclasses.replace(cfg, mega=False))
        assert len(calls) == 3
    finally:
        TB._solve_hybrid = real


def test_compact_is_element_wise_identical():
    """compact=True (the batch permuted so unconverged scenarios come first
    between outer steps) returns every output bit for bit as compact=False,
    on a batch whose scenarios converge at different outer steps."""
    ob = port_ocp(euler_batch("six_robot_antipodal", B=8, N=8, seed=3, spread=0.08))
    cfg = ALILQRConfig(n_outer=5, n_inner=8)
    r0 = solve_batched(ob, cfg=cfg)
    r1 = solve_batched(ob, cfg=dataclasses.replace(cfg, compact=True))
    assert len(set(r0.outer_iters.tolist())) > 1   # the permutation is not the identity
    for name in ("X", "U", "cost", "viol", "lam", "mu", "inner_iters", "outer_iters", "converged"):
        assert torch.equal(getattr(r0, name), getattr(r1, name)), name


def test_polar_seed_matches_reference():
    ob = euler_batch(B=4, N=12, seed=4)
    want = JB._polar_seed(ob, 4)
    got = TB._polar_seed(port_ocp(ob))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    assert float(got.abs().max()) > 0.1   # a moving seed, not rest
    cfg = dict(n_outer=4, n_inner=8, cold_seed="polar")
    jr = jax.jit(functools.partial(JB.solve_batched, cfg=JS.ALILQRConfig(**cfg)))(ob)
    t = port_ocp(ob)
    tr = solve_batched(t, cfg=ALILQRConfig(**cfg))
    np.testing.assert_allclose(tr.cost.numpy(), np.asarray(jr.cost), rtol=1e-3)
    np.testing.assert_allclose(float(tr.cost.mean()), float(np.asarray(jr.cost).mean()), rtol=1e-4)
    # the seed is the warm start's controls, nothing else
    warm = WarmStart(U=got, lam=torch.zeros((4, t.N, t.n_con)), mu=torch.full((4,), 10.0))
    tw = solve_batched(t, warm, ALILQRConfig(n_outer=4, n_inner=8))
    assert torch.equal(tw.U, tr.U) and torch.equal(tw.cost, tr.cost)
    # ray-augmented problems ignore it, as in the reference
    rb = port_ocp(ray_batch(B=2, N=5))
    cfg1 = ALILQRConfig(n_outer=1, n_inner=2)
    assert torch.equal(solve_batched(rb, cfg=dataclasses.replace(cfg1, cold_seed="polar")).U,
                       solve_batched(rb, cfg=cfg1).U)
