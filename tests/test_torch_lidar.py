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
from nmpc_tpu_torch.mpc import closed_loop_lidar
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
