"""The port's consensus mode (nmpc_tpu_torch/parallel/consensus.py) against
the reference's on the CPU: the joint pair violation exactly, consensus
rounds with either engine, the two-robot joint solve against a centralized
solve, and a short closed loop pointwise. Inputs are made with numpy and
handed to both packages.

Tolerances: rounds at tests/test_consensus.py:191-212's config (m=3,
N=10, 3 rounds): X atol 5e-3, U 1e-2 (the engine-level tolerance that
compounds over the rounds), the violation and delta histories atol 5e-3.
The two-robot case by tests/test_consensus.py:42-68's criteria (violation
< 1e-3, delta < 2e-2, joint cost within 1.15x of the centralized solve).
The closed loop pointwise (X_hist atol 5e-3, U_hist 2e-2) only from a start
the reference itself moves less under a 1e-7 move of x0
(tests/reference_spread.py: 2.4e-3 in X_hist and 6.7e-3 in U_hist over
these 8 steps; from the seed-2 start it reaches 1.9e-2 by step 15).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nmpc_tpu.parallel import consensus as JC
from nmpc_tpu.solver.alilqr import ALILQRConfig as JaxConfig
from nmpc_tpu_torch.ocp.problem import make_ocp
from nmpc_tpu_torch.parallel import consensus as TC
from nmpc_tpu_torch.solver import ALILQRConfig, solve
from test_torch_parallel import circle

ROUNDS_CFG = dict(n_outer=3, n_inner=6, tol_con=1e-3)     # tests/test_consensus.py:202
LOOP_CFG = dict(n_outer=4, n_inner=10, tol_con=1e-4)      # tests/test_consensus.py:150


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("m", [2, 3, 6])
def test_joint_pair_violation_matches_reference(m):
    rng = np.random.default_rng(m)
    plans = (0.4 * rng.standard_normal((m, 9, 2))).astype(np.float32)
    want = JC.joint_pair_violation(jnp.asarray(plans), 0.09, 8)
    got = TC.joint_pair_violation(torch.tensor(plans), torch.tensor(0.09), 8)
    assert float(got) == float(want) and float(want) > 0.0


@pytest.mark.parametrize("engine", ["fused", "xla"])
def test_consensus_solve_matches_reference(engine):
    m, N = 3, 10
    x0, goals = circle(m)
    jtpl = JC.robot_template(N, 0.1, 0.3, m)
    jX, jU, _, _, jv, jd = jax.jit(functools.partial(
        JC.consensus_solve, cfg=JaxConfig(**ROUNDS_CFG), rounds=3, damping=0.5,
        engine=engine))(jtpl, jnp.asarray(x0), jnp.asarray(goals))
    ttpl = TC.robot_template(N, 0.1, 0.3, m, device="cpu")
    tX, tU, w, plans, tv, td = TC.consensus_solve(
        ttpl, torch.tensor(x0), torch.tensor(goals), ALILQRConfig(**ROUNDS_CFG), rounds=3,
        damping=0.5, engine=engine)
    assert tX.shape == (m, N + 1, 3) and tU.shape == (m, N, 2) and plans.shape == (m, N + 1, 2)
    assert tv.shape == td.shape == (3,) and w.lam.shape == (m, N, ttpl.n_con)
    np.testing.assert_allclose(tX.numpy(), np.asarray(jX), atol=5e-3)
    np.testing.assert_allclose(tU.numpy(), np.asarray(jU), atol=1e-2)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=5e-3)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=5e-3)


def test_consensus_matches_centralized_two_robot():
    """The offset head-on swap: the consensus iterate is joint-feasible,
    settled, and within 1.15x of the centralized joint solve's cost."""
    N, T, dmin = 30, 0.1, 0.3
    x0 = torch.tensor([-0.7, 0.05, 0.0, 0.7, -0.05, np.pi])
    goals = torch.tensor([[0.7, 0.05, 0.0], [-0.7, -0.05, np.pi]])
    goal_j = goals.reshape(-1)
    cfg = ALILQRConfig(n_outer=8, n_inner=15, tol_con=1e-4)
    central = make_ocp(m=2, N=N, T=T, x0=x0, x_goal=goal_j, dmin=dmin, collision=True,
                       device="cpu")
    res_c = solve(central, cfg=cfg)
    assert float(res_c.viol) < 1e-3
    tpl = TC.robot_template(N, T, dmin, m=2, device="cpu")
    X, U, _, _, violh, deltah = TC.consensus_solve(tpl, x0, goals, cfg, rounds=12, damping=0.5,
                                                   engine="xla")
    assert float(violh[-1]) < 1e-3
    assert float(deltah[-1]) < 2e-2

    def joint_cost(Xj, Uj):
        e = Xj[:-1] - goal_j[None]
        return float(torch.sum(e * e * central.Qdiag[None]) + torch.sum(Uj * Uj * central.Rdiag[None]))

    c_cons = joint_cost(X.transpose(0, 1).reshape(N + 1, -1), U.transpose(0, 1).reshape(N, -1))
    assert c_cons <= 1.15 * joint_cost(res_c.X, res_c.U) + 1e-6


def test_consensus_closed_loop_matches_reference():
    """8 steps of three robots crossing a jittered circle (N=10, T=0.1,
    dmin 0.3, 3 rounds a step), fused engine, pointwise against the
    reference."""
    x0, goals = circle(3, 0.8, 0.3, seed=1)
    kw = dict(N=10, T=0.1, dmin=0.3, rounds=3, max_steps=8)
    jX, jU, jm, jd = jax.jit(functools.partial(JC.consensus_closed_loop, cfg=JaxConfig(**LOOP_CFG),
                                               **kw))(jnp.asarray(x0), jnp.asarray(goals))
    tX, tU, tm, td = TC.consensus_closed_loop(x0, goals, cfg=ALILQRConfig(**LOOP_CFG),
                                              device="cpu", **kw)
    assert tX.shape == (9, 9) and tU.shape == (8, 6)
    np.testing.assert_allclose(tX.numpy(), np.asarray(jX), atol=5e-3)
    np.testing.assert_allclose(tU.numpy(), np.asarray(jU), atol=2e-2)
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), atol=5e-3)
    assert bool(td) == bool(jd)
