"""The port's condensed Gauss-Newton engine (nmpc_tpu_torch.solver.gn)
against the reference nmpc_tpu.solver.gn on the same numpy inputs, and the
reference's own GN tests (tests/test_gn_lidar.py:17-37,151-240) on the port.

Tolerances. The normal equations and the residuals at one iterate are the
same function: H and g at the reference test's rtol 2e-5 / atol 2e-4,
residuals at 1e-6. A GN solve stops short of full precision (n_gn x n_outer
budgets), and the reference alone, with x0 moved by 1e-7, moves its U by
up to 1.1e-2 on these problems (9.4e-3 on lidar_v4 N=20 Nc=10, 1.1e-2 on
the unblocked single robot): the port's solves are held by cost at rtol
1e-4 and U at 5e-2, as six-robot solves are (tests/test_torch_solver.py).
The port against itself carries the reference tests' own tolerances
(batched against per-scenario: cost rtol 1e-5, U atol 1e-4; GN against
iLQR unblocked: cost 1e-4 relative, U 1e-2). The slsqp_multigoal waypoint
loop: the reference moves X_hist by up to 8e-4 over its first 40 steps
under such a move; the port's is held to 2e-3 over them, and by the
reference test's outcome (the first waypoint reached) over 100.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nmpc_tpu.mpc import driver as JD
from nmpc_tpu.ocp import problem as JP
from nmpc_tpu.ocp.problem import make_ocp as jax_make_ocp
from nmpc_tpu.scenarios import get as jax_get
from nmpc_tpu.sim.lidar import obstacle_points, ray_angles
from nmpc_tpu.solver import gn as JG
from nmpc_tpu_torch.mpc import driver as TD
from nmpc_tpu_torch.ocp import problem as TP
from nmpc_tpu_torch.scenarios import get
from nmpc_tpu_torch.solver import ALILQRConfig, gn, solve


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


def lidar_problem(N=20, scan_at=((1, 0.9),)):
    """lidar_v4 with its ray states and frozen points from one scan at the
    registry start (tests/test_gn_lidar.py's fixture)."""
    sc = jax_get("lidar_v4")
    o = sc.make(N=N)
    scan = np.full((10,), 3.5, np.float32)
    for i, d in scan_at:
        scan[i] = d
    p_obs = obstacle_points(o.x0[:3], jnp.asarray(scan), ray_angles(10, jnp.float32))
    return dataclasses.replace(o, p_obs=p_obs, x0=o.x0.at[3:].set(jnp.asarray(scan)))


def _t(a):
    return torch.tensor(np.asarray(a))


def test_normal_equations_and_residuals_match_reference():
    """_normal_scan and the residuals at a random iterate, against the
    reference's, and the port's scan against its own dense Jacobian (the
    reference test's criterion)."""
    o = lidar_problem(N=20)
    Nc = 10
    key = jax.random.PRNGKey(0)
    U_blk = 0.05 * jax.random.normal(key, (Nc, o.nu), o.x0.dtype)
    lam = 0.5 * jnp.abs(jax.random.normal(key, (o.N, o.n_con), o.x0.dtype))
    t = port_ocp(o)
    H, g = gn._normal_scan(t, _t(U_blk), _t(lam), 10.0, Nc)
    jH, jg = JG._normal_scan(o, U_blk, lam, jnp.asarray(10.0), Nc)
    np.testing.assert_allclose(H.numpy(), np.asarray(jH), rtol=2e-5, atol=2e-4)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=2e-5, atol=2e-4)
    r = gn._residuals(t, _t(U_blk), _t(lam), 10.0)
    np.testing.assert_allclose(r.numpy(), np.asarray(JG._residuals(o, U_blk, lam, 10.0)),
                               rtol=1e-6, atol=1e-6)
    Hd, gd = gn._dense_normal(dataclasses.replace(t, x0=t.x0[None], xref=t.xref[None]),
                              _t(U_blk).reshape(1, -1), _t(lam)[None], torch.tensor([10.0]), Nc)
    np.testing.assert_allclose(H.numpy(), Hd[0].numpy(), rtol=2e-5, atol=2e-4)
    np.testing.assert_allclose(g.numpy(), gd[0].numpy(), rtol=2e-5, atol=2e-4)


def test_residual_jacobian_at_a_tie_matches_reference():
    """A u row exactly on its bound with lam = 0 makes act = max(0, lam -
    mu c) tie at 0 (the LiDAR loop's normal state after final_clamp):
    JAX's derivative is 1/2 there, torch.maximum's too (torch.clamp's would
    be 1). The dense residual Jacobian there equals the reference's."""
    o = lidar_problem(N=8)
    Nc = 4
    U_blk = np.zeros((Nc, o.nu), np.float32)
    U_blk[:, 0] = np.asarray(o.u_hi)[0]          # v on its upper bound
    U_blk[1:, 1] = 0.3
    lam = np.zeros((o.N, o.n_con), np.float32)
    mu = 10.0

    def jres(z):
        return JG._residuals(o, z.reshape(Nc, o.nu), jnp.asarray(lam), jnp.asarray(mu))

    want = np.asarray(jax.jacfwd(jres)(jnp.asarray(U_blk.reshape(-1))))
    t = port_ocp(o)
    got = torch.func.jacfwd(lambda z: gn._residuals(t, z.reshape(Nc, t.nu), _t(lam),
                                                    torch.tensor(mu)))(_t(U_blk).reshape(-1))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    # the tie is there: a u row's residual derivative is half of mu^(1/2)
    row = np.abs(want).max(axis=1)
    assert np.isclose(row, 0.5 * np.sqrt(mu), rtol=1e-6).any()


CASES = {"lidar_v4 Nc=10 scan": (lambda: lidar_problem(N=20), dict(Nc=10, n_gn=12, n_outer=6, tol_con=1e-3)),
         "lidar_v4 Nc=10 dense": (lambda: lidar_problem(N=20),
                                  dict(Nc=10, n_gn=12, n_outer=6, tol_con=1e-3, normal="dense")),
         "single robot unblocked": (lambda: jax_make_ocp(m=1, N=30, T=0.05, x0=[0, 0, 0],
                                                         x_goal=[1.0, 1.5, 0.0]),
                                    dict(n_gn=20, n_outer=8))}


@pytest.mark.parametrize("case", list(CASES))
def test_solve_matches_reference(case):
    make, kw = CASES[case]
    o = make()
    jr = jax.jit(functools.partial(JG.solve, cfg=JG.GNConfig(**kw)))(o)
    tr = gn.solve(port_ocp(o), cfg=gn.GNConfig(**kw))
    np.testing.assert_allclose(float(tr.cost), float(jr.cost), rtol=1e-4)
    np.testing.assert_allclose(tr.U.numpy(), np.asarray(jr.U), atol=5e-2)
    np.testing.assert_allclose(float(tr.viol), float(jr.viol), atol=1e-4)
    assert int(tr.outer_iters) == int(jr.outer_iters) and bool(tr.converged) == bool(jr.converged)
    assert tr.X.shape == np.asarray(jr.X).shape and tr.inner_iters.dtype == torch.int32


def test_gn_matches_ilqr_unblocked():
    """tests/test_gn_lidar.py:17-26 on the port: GN without blocking reaches
    the AL-iLQR optimum."""
    o = TP.make_ocp(m=1, N=50, T=0.01, x0=[0, 0, 0], x_goal=[1.0, 1.5, 0.0], device="cpu")
    r1 = solve(o, cfg=ALILQRConfig(tol_cost=1e-9, n_inner=50, n_outer=20, tol_con=1e-5))
    r2 = gn.solve(o, cfg=gn.GNConfig(tol_cost=1e-9, n_gn=40, n_outer=20, tol_con=1e-5))
    assert abs(float(r1.cost) - float(r2.cost)) / (1 + float(r1.cost)) < 1e-4
    assert float((r1.U - r2.U).abs().max()) < 1e-2


def test_move_blocking_freezes_tail():
    """tests/test_gn_lidar.py:29-37: Nc=2 < N=5, u frozen after Nc."""
    o = TP.make_ocp(m=1, N=5, T=0.5, x0=[0, 0, 0], x_goal=[2.0, 2.0, 0.0], device="cpu")
    r = gn.solve(o, cfg=gn.GNConfig(Nc=2, n_gn=30, n_outer=10))
    for k in range(2, 5):
        torch.testing.assert_close(r.U[k], r.U[1], rtol=1e-6, atol=0.0)
    assert float(r.viol) < 1e-3


def test_batched_matches_per_scenario_and_reference():
    """tests/test_gn_lidar.py:151-182 on the port (a jittered lidar_v4 batch,
    solve_batched against element-wise solve, the reference's tolerances),
    and the batch against the reference's solve_batched."""
    base = lidar_problem(N=30, scan_at=[(i, 1.2) for i in range(10)])
    base = dataclasses.replace(base, xref=jnp.tile(jnp.concatenate(
        [jnp.asarray(jax_get("lidar_v4").waypoints[0], jnp.float32),
         jnp.zeros((10,), jnp.float32)])[None], (30, 1)))
    x0s = jnp.stack([base.x0, base.x0.at[0].add(0.05), base.x0.at[1].add(-0.05)])
    ob = dataclasses.replace(base, x0=x0s, xref=jnp.broadcast_to(base.xref[None], (3, 30, 13)))
    cfg = dict(Nc=15, n_gn=12, n_outer=6, tol_con=1e-3)
    tb = port_ocp(ob)
    rb = gn.solve_batched(tb, cfg=gn.GNConfig(**cfg))
    assert rb.U.shape == (3, 30, 2)
    r0 = gn.solve(port_ocp(base), cfg=gn.GNConfig(**cfg))
    torch.testing.assert_close(rb.cost[0], r0.cost, rtol=1e-5, atol=0.0)
    torch.testing.assert_close(rb.U[0], r0.U, rtol=0.0, atol=1e-4)
    jr = jax.jit(functools.partial(JG.solve_batched, cfg=JG.GNConfig(**cfg)))(ob)
    np.testing.assert_allclose(rb.cost.numpy(), np.asarray(jr.cost), rtol=1e-4)
    np.testing.assert_allclose(rb.U.numpy(), np.asarray(jr.U), atol=5e-2)


def test_normal_scan_and_dense_reach_the_same_optimum():
    """tests/test_gn_lidar.py:234-240 on the port: the published lidar_v4
    config at N=40, Nc=20 with either form of the normal equations."""
    o = port_ocp(lidar_problem(N=40))
    rs = gn.solve(o, cfg=gn.GNConfig(Nc=20, n_gn=15, n_outer=6, normal="scan"))
    rd = gn.solve(o, cfg=gn.GNConfig(Nc=20, n_gn=15, n_outer=6, normal="dense"))
    np.testing.assert_allclose(float(rs.cost), float(rd.cost), rtol=1e-3)
    assert float(rs.viol) < 1e-4


def test_gn_closed_loop_waypoints_matches_reference():
    """tests/test_gn_lidar.py:83-98 on the port: the GN engine (Nc=1) drives
    slsqp_multigoal's waypoint loop through solve_fn; pointwise against the
    reference over the first 40 steps, and the first waypoint reached
    within 100 steps."""
    sc = jax_get("slsqp_multigoal")
    cfg = dict(Nc=sc.Nc, n_gn=15, n_outer=6)
    mpc = dict(max_steps=100, advance_tol=sc.advance_tol, escape=True)
    jr = jax.jit(functools.partial(
        JD.closed_loop_waypoints, waypoints=sc.waypoint_array, solver_cfg=JG.GNConfig(Nc=sc.Nc),
        mpc=JD.MPCConfig(**mpc), solve_fn=lambda o, w: JG.solve(o, w, JG.GNConfig(**cfg))))(sc.make())
    tsc = get("slsqp_multigoal")
    tr = TD.closed_loop_waypoints(
        tsc.make(device="cpu"), tsc.waypoint_array, solver_cfg=gn.GNConfig(Nc=sc.Nc),
        mpc=TD.MPCConfig(**mpc), solve_fn=lambda o, w: gn.solve(o, w, gn.GNConfig(**cfg)))
    np.testing.assert_allclose(tr.X_hist[:41].numpy(), np.asarray(jr.X_hist)[:41], atol=2e-3)
    assert int(tr.goal_idx_hist[-1]) >= 1 and int(jr.goal_idx_hist[-1]) >= 1
    assert int(tr.goal_idx_hist[-1]) == int(jr.goal_idx_hist[-1])
