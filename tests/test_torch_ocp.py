"""The port's problem layer (nmpc_tpu_torch: registry, OCP functions, Euler
and constraint Jacobians) against the JAX reference, on the same inputs.

Inputs are made with numpy from a seed and handed to both packages. The
registry must match exactly (atol 0); the OCP functions at rtol 1e-6 /
atol 1e-6 (the same f32 formulas, evaluated in another order)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nmpc_tpu.models.unicycle import euler_jacobians as jax_euler_jacobians
from nmpc_tpu.ocp import problem as JP
from nmpc_tpu.ocp.jacobians import stage_constraint_jacobians as jax_con_jac
from nmpc_tpu.scenarios.registry import REGISTRY as JAX_REGISTRY
from nmpc_tpu_torch.models.unicycle import euler_jacobians
from nmpc_tpu_torch.ocp import problem as TP
from nmpc_tpu_torch.ocp.jacobians import stage_constraint_jacobians
from nmpc_tpu_torch.scenarios.registry import REGISTRY

TOL = dict(rtol=1e-6, atol=1e-6)


def port_ocp(o):
    """The port's OCP holding exactly the reference OCP's data."""
    data = {f.name: np.asarray(getattr(o, f.name))
            for f in dataclasses.fields(o) if f.name not in JP.OCP_META}
    meta = {k: getattr(o, k) for k in JP.OCP_META}
    return TP.ocp_from_numpy(data, device="cpu", **meta)


def test_registry_has_the_same_entries():
    assert list(REGISTRY) == list(JAX_REGISTRY)
    assert len(REGISTRY) == 35
    for name, s in REGISTRY.items():
        assert dataclasses.asdict(s) == dataclasses.asdict(JAX_REGISTRY[name]), name


@pytest.mark.parametrize("name", list(JAX_REGISTRY))
def test_registry_make_matches_reference(name):
    ref = JAX_REGISTRY[name].make()
    got = REGISTRY[name].make(device="cpu")
    for f in dataclasses.fields(ref):
        a, b = getattr(ref, f.name), getattr(got, f.name)
        if f.name in JP.OCP_META:
            assert a == b, (name, f.name)
        else:
            assert b.dtype == torch.float32, (name, f.name)
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0, atol=0,
                                       err_msg=f"{name}.{f.name}")
    assert (got.nx, got.nu, got.n_con) == (ref.nx, ref.nu, ref.n_con)


SCEN = ("six_robot_antipodal", "two_robot_swap", "obstacle_scenario_2")


def _inputs(ocp, seed=0, B=5):
    rng = np.random.default_rng(seed)
    X = (np.asarray(ocp.x0)[None, None]
         + 0.4 * rng.standard_normal((B, ocp.N + 1, ocp.nx))).astype(np.float32)
    U = (0.3 * rng.standard_normal((B, ocp.N, ocp.nu))).astype(np.float32)
    lam = np.abs(rng.standard_normal((B, ocp.N, ocp.n_con))).astype(np.float32)
    mu = rng.uniform(1.0, 100.0, B).astype(np.float32)
    return X, U, lam, mu


@pytest.fixture(params=SCEN)
def pair(request):
    ref = JAX_REGISTRY[request.param].make(N=8)
    return ref, port_ocp(ref)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_rollout(pair):
    ref, got = pair
    _, U, _, _ = _inputs(ref)
    want = jax.vmap(lambda u: JP.rollout(ref, u))(jnp.asarray(U))
    np.testing.assert_allclose(TP.rollout(got, _t(U)).numpy(), np.asarray(want), **TOL)


def test_stage_constraints(pair):
    ref, got = pair
    X, U, _, _ = _inputs(ref)
    want = jax.vmap(jax.vmap(lambda x, u: JP.stage_constraints(ref, x, u)))(
        jnp.asarray(X[:, :-1]), jnp.asarray(U))
    np.testing.assert_allclose(
        TP.stage_constraints(got, _t(X[:, :-1]), _t(U)).numpy(), np.asarray(want), **TOL)


def test_masked_trajectory_constraints(pair):
    ref, got = pair
    X, U, _, _ = _inputs(ref)
    want = jax.vmap(lambda x, u: JP.masked_trajectory_constraints(ref, x, u))(
        jnp.asarray(X), jnp.asarray(U))
    np.testing.assert_allclose(
        TP.masked_trajectory_constraints(got, _t(X), _t(U)).numpy(), np.asarray(want), **TOL)


def test_al_total_cost(pair):
    ref, got = pair
    X, U, lam, mu = _inputs(ref)
    want = jax.vmap(lambda x, u, l, m: JP.al_total_cost(ref, x, u, l, m))(
        jnp.asarray(X), jnp.asarray(U), jnp.asarray(lam), jnp.asarray(mu))
    np.testing.assert_allclose(
        TP.al_total_cost(got, _t(X), _t(U), _t(lam), _t(mu)).numpy(), np.asarray(want), **TOL)


def test_euler_jacobians(pair):
    ref, got = pair
    X, U, _, _ = _inputs(ref)
    wA, wB = jax.vmap(jax.vmap(lambda x, u: jax_euler_jacobians(x, u, ref.T)))(
        jnp.asarray(X[:, :-1]), jnp.asarray(U))
    A, B = euler_jacobians(_t(X[:, :-1]), _t(U), got.T)
    np.testing.assert_allclose(A.numpy(), np.asarray(wA), **TOL)
    np.testing.assert_allclose(B.numpy(), np.asarray(wB), **TOL)


def test_stage_constraint_jacobians(pair):
    ref, got = pair
    X, _, _, _ = _inputs(ref)
    wJx, wJu = jax.vmap(jax.vmap(lambda x: jax_con_jac(ref, x)))(jnp.asarray(X[:, :-1]))
    Jx, Ju = stage_constraint_jacobians(got, _t(X[:, :-1]))
    np.testing.assert_allclose(Jx.numpy(), np.asarray(wJx), **TOL)
    np.testing.assert_allclose(
        np.broadcast_to(Ju.numpy(), wJu.shape), np.asarray(wJu), **TOL)


def test_lidar_rollout_and_cost():
    """Ray-augmented model (family I): 1-norm ray propagation and the 1/d cost."""
    ref = JAX_REGISTRY["lidar_v4"].make(N=8, p_obs=jnp.asarray(
        np.random.default_rng(5).uniform(-1, 1, (10, 2)), jnp.float32))
    got = port_ocp(ref)
    X, U, lam, mu = _inputs(ref, seed=5)
    X[..., 3:] = np.abs(X[..., 3:]) + 0.2  # ray distances stay positive
    want_X = jax.vmap(lambda u: JP.rollout(ref, u))(jnp.asarray(U))
    np.testing.assert_allclose(TP.rollout(got, _t(U)).numpy(), np.asarray(want_X), **TOL)
    want = jax.vmap(lambda x, u, l, m: JP.al_total_cost(ref, x, u, l, m))(
        jnp.asarray(X), jnp.asarray(U), jnp.asarray(lam), jnp.asarray(mu))
    np.testing.assert_allclose(
        TP.al_total_cost(got, _t(X), _t(U), _t(lam), _t(mu)).numpy(), np.asarray(want), **TOL)


def test_moving_obstacle_rows():
    """Per-stage moving-obstacle rows (the decentralized mode's neighbour
    plans): constraints, masking and Jacobians with a per-stage schedule."""
    rng = np.random.default_rng(6)
    mov = rng.uniform(-1, 1, (8, 2, 2)).astype(np.float32)
    ref = JP.make_ocp(m=2, N=8, T=0.1, x0=[-1, 0, 0, 1, 0, 3.1], x_goal=[1, 0, 0, -1, 0, 3.1],
                      dmin=0.3, collision=True, mov_obs=jnp.asarray(mov))
    got = port_ocp(ref)
    X, U, _, _ = _inputs(ref, seed=6)
    want = jax.vmap(lambda x, u: JP.masked_trajectory_constraints(ref, x, u))(
        jnp.asarray(X), jnp.asarray(U))
    np.testing.assert_allclose(
        TP.masked_trajectory_constraints(got, _t(X), _t(U)).numpy(), np.asarray(want), **TOL)
    wJx, _ = jax.vmap(jax.vmap(lambda x, mk: jax_con_jac(ref, x, mk), in_axes=(0, 0)),
                      in_axes=(0, None))(jnp.asarray(X[:, :-1]), jnp.asarray(mov))
    Jx, _ = stage_constraint_jacobians(got, _t(X[:, :-1]), _t(mov))
    np.testing.assert_allclose(Jx.numpy(), np.asarray(wJx), **TOL)


def test_batch_helpers_and_cold_start():
    from nmpc_tpu_torch.parallel.batch import batch_ocp, random_starts
    from nmpc_tpu_torch.solver.alilqr import ALILQRConfig, cold_start

    base = REGISTRY["six_robot_antipodal"].make(N=10, device="cpu")
    ob = random_starts(base, torch.Generator().manual_seed(0), 64, spread=0.2)
    assert ob.x0.shape == (64, 18) and ob.xref.shape == (64, 10, 18)
    d = (ob.x0 - base.x0).reshape(64, 6, 3).abs().amax(dim=(0, 1))
    assert float(d[0]) <= 0.2 and float(d[1]) <= 0.2 and float(d[2]) <= 0.1
    assert torch.equal(ob.xref[5], base.xref)
    ob2 = batch_ocp(base, base.x0[None].repeat(3, 1), base.xref[None].repeat(3, 1, 1) + 1.0)
    assert torch.equal(ob2.xref[2], base.xref + 1.0)
    w = cold_start(base, ALILQRConfig(mu_init=5.0))
    assert w.U.shape == (10, 12) and w.lam.shape == (10, base.n_con) and float(w.mu) == 5.0
