"""The port's per-scenario AL-iLQR (nmpc_tpu_torch.solver.alilqr.solve) and
its batched form (parallel.batch.batched_solve) against the reference
nmpc_tpu.solver.alilqr.solve / nmpc_tpu.parallel.batch.batched_solve and the
f64 SLSQP oracle, on the same numpy inputs.

Tolerances. At `PARITY` (the default config with the inner stop at
tol_cost=1e-5) the two engines follow the same iterates: cost rtol 1e-4, U
atol 5e-3 (5e-2 on six robots, as tests/test_torch_solve_batched.py), inner
and outer counts equal (measured: U within 1e-6, every count equal). At the
default tol_cost=1e-7 the inner stop sits ~1.6 ulp of the merit, so where
an iteration stops is decided by rounding: the reference alone, with x0
moved by 1e-7, changes its single_robot inner count by up to 3 and U by
up to 6.5e-3 (tests/reference_spread.py).
There the solve is held by cost (rtol 1e-4) and U at 5e-2. The oracle,
warm-start and deep-alpha tests carry tests/test_solver.py's and
tests/test_batched_solver.py's criteria.
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
from nmpc_tpu.parallel.batch import batched_solve as jax_batched_solve
from nmpc_tpu.scenarios import get as jax_get
from nmpc_tpu.solver.alilqr import ALILQRConfig as JaxConfig
from nmpc_tpu.solver.alilqr import solve as jax_solve
from nmpc_tpu_torch.ocp import problem as TP
from nmpc_tpu_torch.parallel import batch_ocp, batched_solve
from nmpc_tpu_torch.scenarios import get
from nmpc_tpu_torch.solver import ALILQRConfig, WarmStart, solve

from oracle import solve_oracle

PARITY = dict(tol_cost=1e-5)
TIGHT = dict(tol_cost=1e-9, n_inner=50, n_outer=20, tol_con=1e-5)     # tests/test_solver.py:15


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


CASES = {"single_robot": dict(N=25, T=0.1), "two_robot_swap": dict(N=25, T=0.1),
         "six_robot_antipodal": dict(N=10)}


def _both(o, cfg_kw):
    jr = jax.jit(functools.partial(jax_solve, cfg=JaxConfig(**cfg_kw)))(o)
    tr = solve(port_ocp(o), cfg=ALILQRConfig(**cfg_kw))
    return jr, tr


@pytest.mark.parametrize("name", list(CASES))
def test_solve_matches_reference(name):
    jr, tr = _both(jax_get(name).make(**CASES[name]), PARITY)
    np.testing.assert_allclose(float(tr.cost), float(jr.cost), rtol=1e-4)
    np.testing.assert_allclose(tr.U.numpy(), np.asarray(jr.U), atol=5e-2 if name.startswith("six") else 5e-3)
    np.testing.assert_allclose(tr.X.numpy(), np.asarray(jr.X), atol=5e-3)
    assert int(tr.inner_iters) == int(jr.inner_iters) and int(tr.outer_iters) == int(jr.outer_iters)
    assert bool(tr.converged) == bool(jr.converged)
    assert tr.X.shape == jr.X.shape and tr.lam.shape == jr.lam.shape
    assert tr.inner_iters.dtype == torch.int32 and tr.mu.shape == ()


@pytest.mark.parametrize("name", list(CASES))
def test_solve_at_the_default_stop_rule(name):
    jr, tr = _both(jax_get(name).make(**CASES[name]), {})
    np.testing.assert_allclose(float(tr.cost), float(jr.cost), rtol=1e-4)
    np.testing.assert_allclose(tr.U.numpy(), np.asarray(jr.U), atol=5e-2)
    assert float(tr.viol) <= float(jr.viol) + 1e-4


def test_single_robot_matches_oracle():
    # tests/test_solver.py:23-33: mpc_online_casadi.py's config, T=0.01, N=50
    ocp = TP.make_ocp(m=1, N=50, T=0.01, x0=[0, 0, 0], x_goal=[1.0, 1.5, 0.0], device="cpu")
    res = solve(ocp, cfg=ALILQRConfig(**TIGHT))
    U_o, _, cost_o = solve_oracle([0, 0, 0], [1.0, 1.5, 0.0], 50, 0.01)
    assert float(res.viol) < 1e-4
    np.testing.assert_allclose(float(res.cost), cost_o, rtol=1e-4)
    np.testing.assert_allclose(res.U.numpy(), U_o, atol=5e-3)
    # the v bound is active at the start and the clamp holds it
    assert res.U[:, 0].max() <= 0.22 + 1e-6 and float(res.U[0, 0]) > 0.2199


def test_warm_start_accelerates():
    # tests/test_solver.py:74-87
    ocp = TP.make_ocp(m=2, N=30, T=0.1, x0=[-0.4, 0, 0, 0.4, 0, np.pi],
                      x_goal=[0.5, 0, 0, -0.5, 0, np.pi], dmin=0.3, collision=True, device="cpu")
    cfg = ALILQRConfig(**TIGHT)
    res1 = solve(ocp, cfg=cfg)
    res2 = solve(ocp, WarmStart(U=res1.U, lam=res1.lam, mu=res1.mu), cfg)
    assert int(res2.inner_iters) <= max(3, int(res1.inner_iters) // 4)
    assert float(res2.viol) < 1e-4


def test_deep_alpha_grid_escapes_box_stall():
    """tests/test_batched_solver.py:243-262 on the per-scenario engine: the
    two_robot_swap reference NLP (N=100, T=0.02) with alphas down to 1e-5
    reaches the f64 oracle optimum basin (4025.99)."""
    deep = (1.0, 0.5, 0.25, 0.1, 0.03, 0.01, 0.003, 0.001, 3e-4, 1e-4, 3e-5, 1e-5)
    res = solve(get("two_robot_swap").make(device="cpu"),
                cfg=ALILQRConfig(alphas=deep, tol_cost=1e-9, n_inner=60, n_outer=20, tol_con=1e-5))
    assert float(res.cost) < 4027.0
    assert float(res.viol) < 1e-4
    assert bool(res.converged)


def test_batched_solve_matches_reference():
    base = jax_get("two_robot_swap").make(N=10)
    rng = np.random.default_rng(7)
    x0 = (np.asarray(base.x0)[None] + 0.1 * rng.standard_normal((8, base.nx))).astype(np.float32)
    ob = jax_batch_ocp(base, jnp.asarray(x0))
    jr = jax.jit(functools.partial(jax_batched_solve, cfg=JaxConfig(**PARITY)))(ob)
    tob = port_ocp(ob)
    tr = batched_solve(tob, ALILQRConfig(**PARITY))
    np.testing.assert_allclose(tr.cost.numpy(), np.asarray(jr.cost), rtol=1e-4)
    np.testing.assert_allclose(tr.U.numpy(), np.asarray(jr.U), atol=5e-3)
    # counts: each scenario's are those of its own solve. Against the
    # reference, 2 of these 8 stop an iteration and an outer step apart at
    # tol_cost=1e-5 (violations within rounding of tol_con); the reference's
    # batched and per-scenario counts agree with each other, as the port's do
    alone = [solve(dataclasses.replace(tob, x0=x, xref=r), cfg=ALILQRConfig(**PARITY))
             for x, r in zip(tob.x0, tob.xref)]
    assert tr.inner_iters.tolist() == [int(r.inner_iters) for r in alone]
    assert tr.outer_iters.tolist() == [int(r.outer_iters) for r in alone]
    assert tr.converged.tolist() == [bool(r.converged) for r in alone]
    assert np.abs(tr.inner_iters.numpy() - np.asarray(jr.inner_iters)).max() <= 1
    assert np.abs(tr.outer_iters.numpy() - np.asarray(jr.outer_iters)).max() <= 1


def test_finished_scenario_stays_frozen():
    """A scenario that converges at its first outer step keeps its carry
    while a harder one iterates on: its result is its own solve at B=1
    (counts equal, states to rounding), not one that went on iterating."""
    base = get("two_robot_swap").make(N=10, device="cpu")
    cfg = ALILQRConfig(**PARITY)
    easy = base.xref[0]                  # starting at the goal: converged at once
    x0 = torch.stack([easy, base.x0])
    res = batched_solve(batch_ocp(base, x0), cfg)
    alone = [solve(dataclasses.replace(base, x0=x), cfg=cfg) for x in x0]
    assert int(res.outer_iters[0]) < int(res.outer_iters[1])
    for i, r in enumerate(alone):
        assert int(res.outer_iters[i]) == int(r.outer_iters)
        assert int(res.inner_iters[i]) == int(r.inner_iters)
        assert float(res.mu[i]) == float(r.mu)
        torch.testing.assert_close(res.U[i], r.U, rtol=0, atol=1e-6)
        torch.testing.assert_close(res.X[i], r.X, rtol=0, atol=1e-6)
