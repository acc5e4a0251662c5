"""The port's decentralized mode (nmpc_tpu_torch/parallel/decentralized.py)
against the reference's on the CPU: the neighbour index and the right-hand
traffic rule exactly, one decentralized round with either engine, and a
short closed loop pointwise. Inputs are made with numpy and handed to both
packages.

Tolerances: a round at tests/test_parallel.py:125-147's (cost rtol 5e-4,
controls and plans atol 1e-2: the fused engine against the per-scenario
one, merits summed in another order). The closed loop pointwise (X_hist
atol 5e-3, U_hist 2e-2) only from a start where the reference itself moves
by less under a 1e-7 move of x0 (tests/reference_spread.py: 1.0e-3 in
X_hist and 7.6e-3 in U_hist over these 15 steps; from the seed-1 start the
same move parts its rows by 1.4e-2 from step 18 on).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nmpc_tpu.parallel import decentralized as JD
from nmpc_tpu.solver.alilqr import ALILQRConfig as JaxConfig
from nmpc_tpu.solver.alilqr import cold_start as jax_cold_start
from nmpc_tpu_torch.parallel import decentralized as TD
from nmpc_tpu_torch.solver import ALILQRConfig

CFG = dict(n_outer=6, n_inner=12, tol_con=1e-4)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def circle(m, r=1.0, jitter=0.0, seed=0):
    """m robots on a circle of radius r (angles jittered by `jitter` x
    N(0, 1)), each bound for its antipode: (x0_joint [3m], goals [m, 3])."""
    rng = np.random.default_rng(seed)
    ang = np.arange(m) * 2 * np.pi / m + jitter * rng.standard_normal(m)
    x0 = np.stack([r * np.cos(ang), r * np.sin(ang), ang + np.pi], -1).reshape(-1)
    goals = np.stack([-r * np.cos(ang), -r * np.sin(ang), ang + np.pi], -1)
    return x0.astype(np.float32), goals.astype(np.float32)


def _round_inputs(m, N, seed):
    """A mid-loop round: the joint state on a jittered circle, exchanged
    plans a little off the straight lines, goals."""
    rng = np.random.default_rng(seed)
    x0, goals = circle(m, 0.8, 0.3, seed)
    s = np.linspace(0.0, 0.5, N + 1)[None, :, None]
    start, goal = x0.reshape(m, 3)[:, None, :2], goals[:, None, :2]
    plans = start + s * (goal - start) + 0.02 * rng.standard_normal((m, N + 1, 2))
    return x0, goals, plans.astype(np.float32)


@pytest.mark.parametrize("m", [2, 3, 6])
def test_neighbor_index_matches_reference(m):
    np.testing.assert_array_equal(TD._neighbor_index(m).numpy(), np.asarray(JD._neighbor_index(m)))


def test_right_hand_shift_matches_reference():
    """The reference's rh_bias lines, op by op (each correctly rounded), on
    the same neighbour plans: bit for bit."""
    m, N = 4, 6
    x0, _, plans = _round_inputs(m, N, seed=3)
    poses, nbr = jnp.asarray(x0).reshape(m, 3), JD._neighbor_index(m)
    mov = jnp.swapaxes(jnp.asarray(plans)[nbr][:, :, 1:N + 1, :], 1, 2)
    rel = mov - poses[:, None, None, :2]
    nrm = jnp.sqrt(jnp.sum(rel * rel, axis=-1, keepdims=True) + 1e-9)
    left = jnp.stack([-rel[..., 1], rel[..., 0]], axis=-1) / nrm
    want = mov + 0.03 * left
    tmov = torch.tensor(plans)[TD._neighbor_index(m)][:, :, 1:N + 1, :].transpose(1, 2)
    got = TD.right_hand_shift(tmov, torch.tensor(x0).reshape(m, 3), 0.03)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("engine", ["fused", "xla"])
def test_decentralized_step_matches_reference(engine):
    """One round at m=3, N=10 (stale plans, rh_bias 0.03, cold warm
    starts): the port's engine against the reference's same engine."""
    m, N = 3, 10
    x0, goals, plans = _round_inputs(m, N, seed=1)
    jtpl = JD.robot_template(N, 0.1, 0.3, m)
    w = jax.vmap(lambda _: jax_cold_start(jtpl))(jnp.arange(m))
    jr, ju, jp = jax.jit(functools.partial(JD.decentralized_step, jtpl, cfg=JaxConfig(**CFG),
                                           engine=engine))(
        jnp.asarray(x0), jnp.asarray(goals), jnp.asarray(plans), w)
    ttpl = TD.robot_template(N, 0.1, 0.3, m, device="cpu")
    tr, tu, tp = TD.decentralized_step(ttpl, torch.tensor(x0), torch.tensor(goals),
                                       torch.tensor(plans), TD.cold_warms(ttpl, m, ALILQRConfig()),
                                       ALILQRConfig(**CFG), engine=engine)
    np.testing.assert_allclose(tr.cost.numpy(), np.asarray(jr.cost), rtol=5e-4)
    np.testing.assert_allclose(tu.numpy(), np.asarray(ju), atol=1e-2)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=1e-2)
    assert tr.inner_iters.shape == (m,) and int(tr.inner_iters.min()) >= 1
    assert float(tr.viol.max()) < 1e-3


def test_fused_and_xla_engines_agree():
    """The port's two engines on the same round (tests/test_parallel.py:125-147
    at m=4, N=12, cold plans)."""
    m, N = 4, 12
    x0, goals = circle(m)
    tpl = TD.robot_template(N, 0.1, 0.3, m, device="cpu")
    plans = torch.tensor(x0).reshape(m, 3)[:, None, :2].repeat(1, N + 1, 1)
    out = {e: TD.decentralized_step(tpl, torch.tensor(x0), torch.tensor(goals), plans,
                                    TD.cold_warms(tpl, m), ALILQRConfig(**CFG), engine=e)
           for e in ("fused", "xla")}
    (rf, uf, pf), (rx, ux, px) = out["fused"], out["xla"]
    np.testing.assert_allclose(rf.cost.numpy(), rx.cost.numpy(), rtol=5e-4)
    np.testing.assert_allclose(uf.numpy(), ux.numpy(), atol=1e-2)
    np.testing.assert_allclose(pf.numpy(), px.numpy(), atol=1e-2)
    assert float(uf[0::2].min()) > 0.0   # every robot drives toward its antipode


def test_decentralized_closed_loop_matches_reference():
    """15 steps of three robots crossing a jittered circle (N=10, T=0.1,
    dmin 0.3), fused engine, pointwise against the reference."""
    x0, goals = circle(3, 0.8, 0.3, seed=2)
    kw = dict(N=10, T=0.1, dmin=0.3, max_steps=15)
    jX, jU, jm, jd = jax.jit(functools.partial(JD.decentralized_closed_loop, cfg=JaxConfig(**CFG),
                                               **kw))(jnp.asarray(x0), jnp.asarray(goals))
    tX, tU, tm, td = TD.decentralized_closed_loop(x0, goals, cfg=ALILQRConfig(**CFG),
                                                  device="cpu", **kw)
    assert tX.shape == (16, 9) and tU.shape == (15, 6) and tm.shape == (16,)
    np.testing.assert_allclose(tX.numpy(), np.asarray(jX), atol=5e-3)
    np.testing.assert_allclose(tU.numpy(), np.asarray(jU), atol=2e-2)
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), atol=5e-3)
    assert bool(td) == bool(jd)


def test_closed_loop_stops_once_done():
    """From the goal the loop is done at its first step: every row is the
    start, the controls zero, and no solve runs."""
    x0, goals = circle(2, 0.5)
    calls = []
    real = TD.solve_robots
    try:
        TD.solve_robots = lambda *a, **k: calls.append(1) or real(*a, **k)
        X, U, mind, done = TD.decentralized_closed_loop(goals.reshape(-1), goals, N=5, T=0.1,
                                                        dmin=0.3, max_steps=7, device="cpu")
    finally:
        TD.solve_robots = real
    assert bool(done) and calls == []
    assert X.shape == (8, 6) and torch.equal(X, torch.tensor(goals.reshape(-1))[None].repeat(8, 1))
    assert U.shape == (7, 4) and float(U.abs().max()) == 0.0
    assert torch.allclose(mind, torch.full((8,), 1.0))


def test_solve_robots_never_gives_way_to_the_plain_engine():
    """engine="fused" runs `solve_batched` or raises: a template its kernels
    do not take (RK4 dynamics) raises NotImplementedError, where the
    reference would vmap its per-scenario solve; an unknown engine raises
    ValueError."""
    import dataclasses

    m, N = 2, 5
    x0, goals = circle(m)
    tpl = TD.robot_template(N, 0.1, 0.3, m, device="cpu")
    plans = torch.tensor(x0).reshape(m, 3)[:, None, :2].repeat(1, N + 1, 1)
    args = (torch.tensor(x0), torch.tensor(goals), plans, TD.cold_warms(tpl, m),
            ALILQRConfig(n_outer=1, n_inner=2))
    with pytest.raises(NotImplementedError, match="rk4"):
        TD.decentralized_step(dataclasses.replace(tpl, integrator="rk4"), *args, engine="fused")
    with pytest.raises(ValueError, match="unknown engine"):
        TD.decentralized_step(tpl, *args, engine="fusd")
