"""The LiDAR-augmented model on the port: its dynamics Jacobians and stage
expansions (torch.func.jacfwd, as the reference's jax.jacfwd), the RK4
Jacobians, and the LiDAR closed loop (nmpc_tpu_torch.mpc.lidar), each
against the reference nmpc_tpu on the same numpy inputs.

The Jacobians and expansions are the same functions at one point: held at
rtol/atol 1e-5 (1e-4 relative on the 1/d Hessian's d^-4 entries). At the
lidar_v4 cold start ray 0 lies on the pose's x axis (delta_y = 0 exactly):
JAX differentiates |t| at 0 as +1, so A[3, 1] = 1 there, and the port's
ray dynamics must give the same (torch.abs would give 0).

The closed loop (lidar_v4 at N=40, Nc=20, the fleet recipe's 10x4, 20
steps): the reference alone, with the start moved by 1e-7, moves X_hist
by at most 2e-6 over its first 6 steps and by up to 1e-3 from step 7 on (a
GN solve there parts along a flat valley). The port is held pointwise at
1e-4 over those 6 steps, and by outcome over all 20: the clearance within
1e-2 of the reference's and above the ray bound's 0.15 - 1e-2, the same
waypoint index, the controls inside the actuator box.

The batched loop (closed_loop_lidar_batched, the port of the reference
fuzz's jax.vmap(closed_loop_lidar)) at B=3 fuzz fields, N=10, Nc=5, 15
steps: the fuzz bifurcates within a few steps. With the template's start
moved by 1e-7 the reference's own X_hist moves by at most 3.2e-7 over rows
0-4 of single-obstacle seed 2, 2.2e-7 over rows 0-3 of seed 7 and 4.0e-7
over rows 0-5 of gauntlet seed 5, then by 1.8e-4 to 2.0e-3 (the longest
stable prefixes of the fuzz's 16 fields at this size; seeds 0, 1, 3-6 of
the single class part by 2.2e-5 to 3.0e-4 at the first solve already;
`JAX_PLATFORMS=cpu python tests/reference_spread.py lidar_fuzz`). Those
rows are held at X_hist atol 1e-4; all 15 steps by outcome: the goal
index and done flags equal, each step's clearance within 1e-2, the
controls inside the actuator box.

The oracle loop's replica (tools/cl_parity.py::lidar_oracle_loop, the
port of tools/gen_cl_parity.py::lidar_oracle_loop) is pinned as the
reference pins its own (tests/test_cl_parity.py:163-237): driven by one
scan-dependent law, the replica and closed_loop_lidar part only by the f32
against f64 plant (< 2e-3), through a goal advance.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nmpc_tpu.mpc.lidar import closed_loop_lidar as jax_closed_loop_lidar
from nmpc_tpu.ocp import problem as JP
from nmpc_tpu.scenarios import get as jax_get
from nmpc_tpu.sim.lidar import obstacle_points, ray_angles, raycast
from nmpc_tpu.solver import alilqr as JS
from nmpc_tpu.solver import gn as JG
from nmpc_tpu_torch.mpc import closed_loop_lidar, closed_loop_lidar_batched
from nmpc_tpu_torch.ocp import problem as TP
from nmpc_tpu_torch.solver import alilqr as TS
from nmpc_tpu_torch.solver import gn

OBSTACLES = np.array([[0.5, 0.25, 0.1]], np.float32)   # tools/gen_cl_parity.py:251


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


def cold_start(N=10):
    """lidar_v4 at its registry start, U = 0, ray states and points from one
    scan of the CL_PARITY circle at that pose: states (X [N+1, 13], U)."""
    o = jax_get("lidar_v4").make(N=N)
    angles = ray_angles(10, jnp.float32)
    pose = o.x0[:3]
    scan = raycast(pose, jnp.asarray(OBSTACLES), angles)
    o = dataclasses.replace(o, x0=jnp.concatenate([pose, scan]),
                            p_obs=obstacle_points(pose, scan, angles))
    U = jnp.zeros((N, o.nu), jnp.float32)
    return o, jax.jit(JP.rollout)(o, U), U


def test_ray_jacobians_match_reference_at_the_cold_start():
    o, X, U = cold_start()
    jA, jB = jax.jit(jax.vmap(lambda x, u: JS._stage_jacobians(o, x, u)))(X[:-1], U)
    t = port_ocp(o)
    A, B = TS._stage_jacobians(t, torch.tensor(np.asarray(X[:-1])), torch.tensor(np.asarray(U)))
    assert float(o.p_obs[0, 1]) == 0.0 and float(X[0, 1]) == 0.0   # ray 0 on the pose's axis
    assert float(jA[0, 3, 1]) == 1.0                                 # JAX: d|t|/dt = +1 at 0
    np.testing.assert_array_equal(A[:, 3, 1].numpy(), np.asarray(jA[:, 3, 1]))
    np.testing.assert_allclose(A.numpy(), np.asarray(jA), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(B.numpy(), np.asarray(jB), rtol=1e-5, atol=1e-5)


def test_ray_expansion_matches_reference():
    """The 1/d cost's gradient and Hessian diagonal and the constraint
    Jacobians by jacfwd, at the cold start's states and controls moved off
    rest, with nonnegative duals and mu = 10."""
    o, _, _ = cold_start()
    rng = np.random.default_rng(0)
    U = jnp.asarray(0.1 * rng.standard_normal((o.N, o.nu)), jnp.float32)
    X = jax.jit(JP.rollout)(o, U)
    lam = jnp.asarray(np.abs(rng.standard_normal((o.N, o.n_con))), jnp.float32)
    want = jax.jit(jax.vmap(lambda x, u, r, l: JS._stage_expansion(o, x, u, r, l, None, 10.0)))(
        X[:-1], U, o.xref, lam)
    t = port_ocp(o)
    got = TS._stage_expansion(t, torch.tensor(np.asarray(X[:-1])), torch.tensor(np.asarray(U)),
                              t.xref, torch.tensor(np.asarray(lam)), None, torch.tensor(10.0))
    for name, g, w in zip(("lx", "lu", "lxx", "luu", "lux"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-5, err_msg=name)


def test_rk4_jacobians_and_expansion_match_reference():
    o = dataclasses.replace(jax_get("two_robot_swap").make(N=6, T=0.1), integrator="rk4")
    rng = np.random.default_rng(1)
    U = jnp.asarray(0.2 * rng.standard_normal((o.N, o.nu)), jnp.float32)
    X = jax.jit(JP.rollout)(o, U)
    jA, jB = jax.jit(jax.vmap(lambda x, u: JS._stage_jacobians(o, x, u)))(X[:-1], U)
    t = port_ocp(o)
    Xt, Ut = torch.tensor(np.asarray(X[:-1])), torch.tensor(np.asarray(U))
    A, B = TS._stage_jacobians(t, Xt, Ut)
    np.testing.assert_allclose(A.numpy(), np.asarray(jA), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(B.numpy(), np.asarray(jB), rtol=1e-5, atol=1e-6)
    lam = jnp.asarray(np.abs(rng.standard_normal((o.N, o.n_con))), jnp.float32)
    want = jax.jit(jax.vmap(lambda x, u, r, l: JS._stage_expansion(o, x, u, r, l, None, 10.0)))(
        X[:-1], U, o.xref, lam)
    got = TS._stage_expansion(t, Xt, Ut, t.xref, torch.tensor(np.asarray(lam)), None,
                              torch.tensor(10.0))
    for name, g, w in zip(("lx", "lu", "lxx", "luu", "lux"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5, err_msg=name)


def test_closed_loop_lidar_matches_reference():
    sc = jax_get("lidar_v4")
    o = sc.make(N=40)
    wps = np.asarray(sc.waypoints, np.float32)
    cfg = dict(Nc=20, n_gn=10, n_outer=4, tol_con=1e-3)
    steps = 20
    jX, jU, jclr, jgidx, jdone = jax.jit(functools.partial(
        jax_closed_loop_lidar, sim_obstacles=jnp.asarray(OBSTACLES), waypoints=jnp.asarray(wps),
        cfg=JG.GNConfig(**cfg), max_steps=steps))(o)
    X, U, clr, gidx, done = closed_loop_lidar(port_ocp(o), torch.tensor(OBSTACLES),
                                              torch.tensor(wps), cfg=gn.GNConfig(**cfg),
                                              max_steps=steps)
    assert X.shape == (steps + 1, 3) and U.shape == (steps, 2) and gidx.dtype == torch.int32
    np.testing.assert_allclose(X[:7].numpy(), np.asarray(jX)[:7], atol=1e-4)
    assert abs(float(clr.min()) - float(jclr.min())) <= 1e-2
    assert float(clr.min()) >= 0.15 - 1e-2
    np.testing.assert_array_equal(gidx.numpy(), np.asarray(jgidx))
    assert bool(done) == bool(jdone)
    u_hi = np.asarray(o.u_hi)
    assert (U.abs().numpy() <= u_hi + 1e-6).all()


# the batched loop's fields (tests/test_lidar_fuzz.py::_random_field, seed
# and obstacle count) and the X_hist rows held pointwise (module note)
LOOP_FIELDS = ((2, 1, 5), (7, 1, 4), (5, 2, 6))
LOOP_CFG = dict(Nc=5, n_gn=10, n_outer=6, tol_con=1e-3)


def fuzz_fields():
    from test_lidar_fuzz import _random_field

    geoms = [_random_field(s, n) for s, n, _ in LOOP_FIELDS]
    return np.stack([g[1] for g in geoms]), np.stack([g[0][None] for g in geoms])


def test_raycast_with_a_field_a_pose_matches_the_one_pose_call():
    """raycast over poses [B, 3] against fields [B, n, 3] gives, row for
    row, the one-pose call's ranges bit for bit (a disabled far slot and a
    field with no circle in range included)."""
    from nmpc_tpu_torch.sim.lidar import obstacle_points as t_points
    from nmpc_tpu_torch.sim.lidar import ray_angles as t_angles
    from nmpc_tpu_torch.sim.lidar import raycast as t_raycast

    obs, _ = fuzz_fields()
    obs = np.concatenate([obs, [[[50.0, 50.0, 0.01], [50.0, 50.0, 0.01]]]]).astype(np.float32)
    rng = np.random.default_rng(0)
    poses = torch.tensor(np.c_[0.3 * rng.standard_normal((4, 2)), rng.uniform(-3, 3, 4)],
                         dtype=torch.float32)
    angles = t_angles(10)
    got = t_raycast(poses, torch.tensor(obs), angles)
    assert got.shape == (4, 10)
    for i in range(4):
        assert torch.equal(got[i], t_raycast(poses[i], torch.tensor(obs[i]), angles))
        want = raycast(jnp.asarray(poses[i].numpy()), jnp.asarray(obs[i]),
                       ray_angles(10, jnp.float32))
        np.testing.assert_allclose(got[i].numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    assert float(got[3].min()) == 3.5
    pts = t_points(poses, got, angles)
    for i in range(4):
        assert torch.equal(pts[i], t_points(poses[i], got[i], angles))


def test_batched_lidar_loop_matches_reference_vmap():
    """closed_loop_lidar_batched at B=3 against the reference fuzz's
    jax.jit(jax.vmap(closed_loop_lidar)) on the same fields: pointwise over
    the rows where the reference is stable, by outcome over all steps
    (module note)."""
    o = jax_get("lidar_v4").make(N=10)
    obs, goals = fuzz_fields()
    steps = 15
    jX, jU, jclr, jgidx, jdone = jax.jit(jax.vmap(lambda ob, wps: jax_closed_loop_lidar(
        o, sim_obstacles=ob, waypoints=wps, cfg=JG.GNConfig(**LOOP_CFG), max_steps=steps)))(
        jnp.asarray(obs), jnp.asarray(goals))
    X, U, clr, gidx, done = closed_loop_lidar_batched(
        port_ocp(o), torch.tensor(obs), torch.tensor(goals), cfg=gn.GNConfig(**LOOP_CFG),
        max_steps=steps)
    assert X.shape == (3, steps + 1, 3) and U.shape == (3, steps, 2) and clr.shape == (3, steps)
    assert gidx.dtype == torch.int32 and done.shape == (3,)
    for i, (_, _, held) in enumerate(LOOP_FIELDS):
        np.testing.assert_allclose(X[i, :held].numpy(), np.asarray(jX[i, :held]), atol=1e-4)
    np.testing.assert_array_equal(gidx.numpy(), np.asarray(jgidx))
    np.testing.assert_array_equal(done.numpy(), np.asarray(jdone))
    np.testing.assert_allclose(clr.numpy(), np.asarray(jclr), atol=1e-2)
    assert (U.abs().numpy() <= np.asarray(o.u_hi) + 1e-6).all()
    assert np.isfinite(X.numpy()).all()


def test_batched_lidar_loop_at_one_row_is_the_single_loop():
    """At B=1 the batched loop gives closed_loop_lidar's histories bit for
    bit, by default and with an unbatched solve_fn (gn.solve) in place of
    the batched engine."""
    o = port_ocp(jax_get("lidar_v4").make(N=10))
    obs, goals = fuzz_fields()
    cfg = gn.GNConfig(**LOOP_CFG)
    batched = closed_loop_lidar_batched(o, torch.tensor(obs[2:]), torch.tensor(goals[2:]), cfg=cfg,
                                        max_steps=6)
    for fn in (None, lambda ocp, w: gn.solve(ocp, w, cfg)):
        one = closed_loop_lidar(o, torch.tensor(obs[2]), torch.tensor(goals[2]), cfg=cfg,
                                max_steps=6, solve_fn=fn)
        for a, b in zip(one, batched):
            assert b.shape[0] == 1 and torch.equal(a, b[0])


def _replica_setup():
    """tests/test_cl_parity.py:180-223: lidar_v4 at N=8 with two close
    waypoints (goal headings along the approach) and the scan-dependent law
    with a decaying horizon, for both packages: (reference scenario, port
    scenario, law(pose, goal, scan, xp), decay [N, 1])."""
    from nmpc_tpu_torch.scenarios import get

    th_g = float(np.arctan2(0.1, 0.2))
    wps = ((0.2, 0.1, th_g), (0.4, 0.2, th_g))
    jsc = dataclasses.replace(jax_get("lidar_v4"), waypoints=wps)
    tsc = dataclasses.replace(get("lidar_v4"), waypoints=wps)
    decay = (0.9 ** np.arange(8)[:, None]).astype(np.float32)

    def law(pose3, goal3, scan, xp):
        ex, ey = goal3[0] - pose3[0], goal3[1] - pose3[1]
        delta = xp.arctan2(ey, ex) - pose3[2]
        delta = xp.arctan2(xp.sin(delta), xp.cos(delta))
        gain = xp.float32(0.5) + xp.float32(0.5) * scan.min() / xp.float32(3.5)
        return xp.hypot(ex, ey) * gain, xp.float32(0.6) * xp.tanh(delta)

    return jsc, tsc, law, decay


class _TorchMath:
    """The law's xp for torch tensors."""
    float32 = staticmethod(lambda v: torch.tensor(v, dtype=torch.float32))
    arctan2, sin, cos, hypot, tanh = torch.atan2, torch.sin, torch.cos, torch.hypot, torch.tanh


def _solve_fn_np(law, decay):
    def fn(pose, goal, scan, p_obs, U0):
        v, w = law(pose.astype(np.float32), np.asarray(goal, np.float32),
                   scan.astype(np.float32), np)
        return np.stack([v, w]).astype(np.float32)[None] * decay
    return fn


def test_lidar_oracle_loop_replica_matches_driver():
    """tests/test_cl_parity.py:163-237 on the port: cl_parity's
    lidar_oracle_loop against closed_loop_lidar, both driven by the same
    scan-dependent law: step-exact up to the f32 against f64 plant (dev <
    2e-3), through a goal advance."""
    from nmpc_tpu_torch.ocp import problem as P
    from nmpc_tpu_torch.solver.alilqr import SolveResult
    from nmpc_tpu_torch.tools import cl_parity as CP
    from nmpc_tpu_torch.tools import lidar_fleet as LF

    _, tsc, law, decay = _replica_setup()
    ocp = tsc.make(N=8, device="cpu")
    dec = torch.tensor(decay)

    def solve_fn_torch(ocp_k, warm):
        pose, scan = ocp_k.x0[:3], ocp_k.x0[3:]
        v, w = law(pose, ocp_k.xref[-1][:3], scan, _TorchMath)
        U = torch.stack([v, w])[None] * dec
        z = torch.zeros(())
        return SolveResult(X=P.rollout(ocp_k, U), U=U, lam=warm.lam, mu=warm.mu, cost=z, viol=z,
                           inner_iters=torch.zeros((), dtype=torch.int32),
                           outer_iters=torch.zeros((), dtype=torch.int32),
                           converged=torch.ones((), dtype=torch.bool))

    X, U, clr, gidx, done = closed_loop_lidar(
        ocp, torch.tensor(LF.TOUR_OBSTACLES, dtype=torch.float32),
        torch.tensor(tsc.waypoints, dtype=torch.float32), solve_fn=solve_fn_torch, max_steps=60)
    o = CP.lidar_oracle_loop(dataclasses.replace(tsc, N=8), 60, solve_fn=_solve_fn_np(law, decay))
    Xe, Xo = X.double().numpy(), o["X"]
    n = min(len(Xe), len(Xo))
    assert n > 10
    dev = np.abs(Xe[:n] - Xo[:n]).max()
    assert dev < 2e-3, dev
    assert int(gidx[-1]) >= 1


def test_lidar_oracle_loop_replica_matches_reference_replica():
    """The port's replica against the reference's
    tools/gen_cl_parity.py::lidar_oracle_loop under the same law: both
    step an f64 plant from each package's f32 scan, which the law reads
    through scan.min() (the two raycasts agree to ~1e-7)."""
    import sys
    from pathlib import Path

    from nmpc_tpu_torch.tools import cl_parity as CP

    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))
    from gen_cl_parity import lidar_oracle_loop as jax_replica

    jsc, tsc, law, decay = _replica_setup()
    fn = _solve_fn_np(law, decay)
    ref = jax_replica(dataclasses.replace(jsc, N=8), max_steps=60, log_every=0, solve_fn=fn)
    got = CP.lidar_oracle_loop(dataclasses.replace(tsc, N=8), 60, solve_fn=fn)
    assert got["steps"] == ref["steps"] and got["reached"] == ref["reached"]
    np.testing.assert_allclose(got["X"], ref["X"], atol=1e-5)
    assert abs(got["min_dist"] - ref["min_dist"]) < 1e-5
