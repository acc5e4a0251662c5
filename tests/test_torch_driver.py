"""The port's MPC driver (nmpc_tpu_torch.mpc.driver) against
nmpc_tpu.mpc.driver: warm-start shifts, the escape law, the config check,
the point-stabilization loop, the rejection path and the early exit.
tests/test_torch_driver_modes.py holds the other modes.

Tolerances and cases. shift_warm and steady_warm are exact. The escape law:
flags equal and controls atol 2e-6 (8 ulp of pi: the bearing error passes
through atan2 and two atan2(sin, cos) wraps, whose f32 results differ by
an ulp or two between XLA's and PyTorch's libraries, then the gain 1.5;
measured up to 1.55e-6 over 2048-state batches), on crafted states drawn
away from the law's branch boundaries. Closed loops run the default per-scenario engine at
`FAST` (tests/test_mpc.py's config) and are held pointwise: X_hist and
err_hist atol 5e-3, U_hist atol 2e-2, steps and arrival equal. U is held
looser than X because a loop's controls carry each solve's f32 spread: the
reference against itself, with x0 moved by 1e-7, differs by up to 8.8e-3
in U_hist (8.5e-4 in X_hist) on these loops (tests/reference_spread.py
measures every figure here).

Pointwise parity needs loops without a bifurcation. single_robot from its
registry start (heading 0, goal bearing 56 degrees) picks, at its third
step, between turning and reversing by rounding: the reference alone, with
x0 moved by 1e-7, differs from itself by up to 3.07 in X_hist over 30
steps. So that start is held over its first two steps, and the 30-step loop
starts the robot heading at its goal. two_robot_swap is mirror-symmetric
(either passing side is optimal); its 15-step loop turns the second robot
to face its goal, which breaks the symmetry.
"""

import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nmpc_tpu.mpc import driver as JD
from nmpc_tpu.ocp import problem as JP
from nmpc_tpu.scenarios import get as jax_get
from nmpc_tpu.solver.alilqr import ALILQRConfig as JaxConfig
from nmpc_tpu.solver.alilqr import SolveResult as JaxResult
from nmpc_tpu.solver.alilqr import WarmStart as JaxWarm
from nmpc_tpu_torch.mpc import driver as TD
from nmpc_tpu_torch.ocp import problem as TP
from nmpc_tpu_torch.solver import ALILQRConfig, SolveResult, WarmStart

FAST = dict(n_outer=10, n_inner=20, tol_con=1e-4)     # tests/test_mpc.py:23


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


def _scenario(name, **kw):
    kw = {k: jnp.asarray(v, jnp.float32) if isinstance(v, tuple) else v for k, v in kw.items()}
    return jax_get(name).make(**kw)


def _loops(o, mpc_kw, fn="closed_loop", **kw):
    jr = jax.jit(functools.partial(getattr(JD, fn), solver_cfg=JaxConfig(**FAST),
                                   mpc=JD.MPCConfig(**mpc_kw), **kw))(o)
    tr = getattr(TD, fn)(port_ocp(o), ALILQRConfig(**FAST), TD.MPCConfig(**mpc_kw))
    return jr, tr


def hold_loop(jr, tr, u_atol=2e-2):
    np.testing.assert_allclose(tr.X_hist.numpy(), np.asarray(jr.X_hist), atol=5e-3)
    np.testing.assert_allclose(tr.U_hist.numpy(), np.asarray(jr.U_hist), atol=u_atol)
    np.testing.assert_allclose(tr.err_hist.numpy(), np.asarray(jr.err_hist), atol=5e-3)
    np.testing.assert_allclose(tr.min_dist_hist.numpy(), np.asarray(jr.min_dist_hist), atol=5e-3)
    np.testing.assert_array_equal(tr.goal_idx_hist.numpy(), np.asarray(jr.goal_idx_hist))
    assert int(tr.steps_used) == int(jr.steps_used)
    assert bool(tr.reached) == bool(jr.reached)
    for f in dataclasses.fields(jr):
        assert getattr(tr, f.name).shape == getattr(jr, f.name).shape, f.name
    assert tr.iter_hist.dtype == torch.int32 and tr.steps_used.dtype == torch.int32


# ---------------------------------------------------------------------------
# warm starts, the config check
# ---------------------------------------------------------------------------


def _results(rng, lead, N=7, nu=4, nc=9):
    U = rng.standard_normal((*lead, N, nu)).astype(np.float32)
    lam = np.abs(rng.standard_normal((*lead, N, nc))).astype(np.float32)
    mu = rng.uniform(10, 1e4, lead).astype(np.float32)
    z = np.zeros(lead, np.float32)
    jr = JaxResult(X=None, U=jnp.asarray(U), lam=jnp.asarray(lam), mu=jnp.asarray(mu), cost=z,
                   viol=z, inner_iters=z, outer_iters=z, converged=z)
    tr = SolveResult(X=None, U=torch.tensor(U), lam=torch.tensor(lam), mu=torch.tensor(mu),
                     cost=None, viol=None, inner_iters=None, outer_iters=None, converged=None)
    return jr, tr


@pytest.mark.parametrize("lead", [(), (5,)])
def test_shift_and_steady_warm_exact(lead):
    jr, tr = _results(np.random.default_rng(len(lead)), lead)
    cfg, jcfg = ALILQRConfig(mu_init=37.0), JaxConfig(mu_init=37.0)
    for mu_reset in (False, True):
        for decay in (1.0, 0.9):
            shift = jax.vmap if lead else (lambda f: f)
            jw = shift(lambda r: JD.shift_warm(r, jcfg, mu_reset, decay))(jr)
            tw = TD.shift_warm(tr, cfg, mu_reset, decay)
            for a, b in zip((jw.U, jw.lam, jw.mu), (tw.U, tw.lam, tw.mu)):
                np.testing.assert_array_equal(b.numpy(), np.broadcast_to(np.asarray(a), b.shape))
    jw, tw = JD.steady_warm(jr, 0.8), TD.steady_warm(tr, 0.8)
    for a, b in zip((jw.U, jw.lam, jw.mu), (tw.U, tw.lam, tw.mu)):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def test_mpc_config_check():
    TD.MPCConfig(escape_stall_steps=254)
    with pytest.raises(ValueError, match="escape_stall_steps"):
        TD.MPCConfig(escape_stall_steps=255)
    assert [f.name for f in dataclasses.fields(TD.MPCConfig)] == \
        [f.name for f in dataclasses.fields(JD.MPCConfig)]
    assert TD.MPCConfig() == TD.MPCConfig(**dataclasses.asdict(JD.MPCConfig()))


# ---------------------------------------------------------------------------
# the escape law
# ---------------------------------------------------------------------------


def _escape_inputs(rng, o, B, K):
    """B crafted states around the goal: robots 0-1 m from their goals at
    any heading, controls from every stall band (hard < 1e-3, creep < 0.02,
    the dither band [0.02, 0.04), active), every counter and latch state,
    20% done. Draws that fall within 1e-4 of a branch boundary of the law
    (the gear switch |delta| = pi/2, the wrap at pi, the distance and stall
    thresholds, the clearance gate) are redrawn."""
    m = o.m
    goal = np.asarray(o.xref[-1])
    gpos = goal[: 3 * m].reshape(m, 3)
    r = rng.uniform(0.0, 1.0, (B, m))
    phi = rng.uniform(-np.pi, np.pi, (B, m))
    pose = np.stack([gpos[:, 0] + r * np.cos(phi), gpos[:, 1] + r * np.sin(phi),
                     rng.uniform(-np.pi, np.pi, (B, m))], -1)
    x = pose.reshape(B, 3 * m).astype(np.float32)
    band = rng.integers(0, 4, (B, m))
    mag = np.choose(band, [rng.uniform(0, 9e-4, (B, m)), rng.uniform(1.1e-3, 0.019, (B, m)),
                           rng.uniform(0.021, 0.039, (B, m)), rng.uniform(0.05, 0.2, (B, m))])
    u = (mag[..., None] * rng.choice([-1.0, 1.0], (B, m, 2))
         * np.stack([np.ones((B, m)), rng.uniform(0.3, 1.0, (B, m))], -1)).reshape(B, 2 * m)
    kind = rng.integers(0, 3, (B, m))
    packed = rng.integers(0, K + 1, (B, m)) * TD._CNT_BASE + rng.integers(0, K + 1, (B, m))
    esc = np.choose(kind, [np.zeros((B, m), np.int64), packed, np.full((B, m), TD._ESC_LATCH)])
    done = rng.uniform(size=B) < 0.2
    # distance of each draw to the law's branch boundaries (f64)
    thresh = 0.1 / np.sqrt(m)
    ex, ey = gpos[:, 0] - pose[..., 0], gpos[:, 1] - pose[..., 1]
    dist = np.hypot(ex, ey)
    delta = np.angle(np.exp(1j * (np.arctan2(ey, ex) - pose[..., 2])))
    err_i = np.sqrt(dist**2 + (gpos[:, 2] - pose[..., 2]) ** 2)
    near = [np.abs(np.abs(delta) - np.pi / 2), np.pi - np.abs(delta),
            np.abs(dist - max(0.35 * thresh, 0.02)), np.abs(err_i - 0.7 * thresh),
            np.abs(err_i - 0.35 * thresh)]
    if o.n_pairs:
        pos = pose[..., :2]
        d = np.linalg.norm(pos[:, :, None] - pos[:, None], axis=-1) + np.eye(m) * 1e9
        near.append(np.abs(d.min(-1) - 1.5 * float(np.sqrt(o.dmin2))))
    if o.n_obs:
        od = np.linalg.norm(pose[..., None, :2] - np.asarray(o.obstacles)[:, :2], axis=-1)
        od = od - np.asarray(o.obstacles)[:, 2] - float(o.robot_radius)
        near.append(np.abs(np.sqrt(np.maximum(od, 1e-3) ** 2).min(-1)
                           - 1.5 * float(o.robot_radius + o.obs_margin)))
    keep = np.all([(n > 1e-4).all(-1) if n.ndim > 1 else n > 1e-4 for n in near], axis=0)
    return (x[keep], u[keep].astype(np.float32), esc[keep].astype(np.int32), done[keep])


@pytest.mark.parametrize("name,kw", [
    ("six_robot_antipodal", dict(N=5)),           # pair rows
    ("obstacle_scenario_1", dict(N=5)),           # a static obstacle, no pairs
    ("single_robot", dict(N=5, T=0.1)),           # neither
])
def test_escape_control_matches_reference(name, kw):
    o = jax_get(name).make(**kw)
    mpc = JD.MPCConfig(escape=True)
    x, u, esc, done = _escape_inputs(np.random.default_rng(5), o, 2048, mpc.escape_stall_steps)
    goal = o.xref[-1]
    ju, jflags = jax.jit(jax.vmap(lambda a, b, c, d: JD._escape_control(o, mpc, a, goal, b, c, d)))(
        jnp.asarray(x), jnp.asarray(u), jnp.asarray(esc), jnp.asarray(done))
    t = port_ocp(o)
    tu, tflags = TD._escape_control(t, TD.MPCConfig(escape=True), torch.tensor(x), t.xref[-1],
                                    torch.tensor(u), torch.tensor(esc), torch.tensor(done))
    assert x.shape[0] > 1500 and tflags.dtype == torch.int32
    np.testing.assert_array_equal(tflags.numpy(), np.asarray(jflags))
    np.testing.assert_allclose(tu.numpy(), np.asarray(ju), rtol=0, atol=2e-6)
    # every state of the law was visited: latched, counting, cleared
    f = tflags.numpy()
    assert (f == TD._ESC_LATCH).any() and ((f > 0) & (f < TD._ESC_LATCH)).any() and (f == 0).any()
    # one robot, unbatched, as the loops call it
    tu1, tf1 = TD._escape_control(t, TD.MPCConfig(escape=True), torch.tensor(x[0]), t.xref[-1],
                                  torch.tensor(u[0]), torch.tensor(esc[0]), torch.tensor(done[0]))
    np.testing.assert_allclose(tu1.numpy(), np.asarray(ju[0]), rtol=0, atol=2e-6)
    np.testing.assert_array_equal(tf1.numpy(), np.asarray(jflags[0]))


# ---------------------------------------------------------------------------
# point stabilization
# ---------------------------------------------------------------------------


def test_single_robot_closed_loop_matches_reference():
    o = _scenario("single_robot", N=25, T=0.1, x0=(0.0, 0.0, 0.98))   # heading at its goal
    hold_loop(*_loops(o, dict(max_steps=30, stop_tol=5e-2, escape=True)))


def test_single_robot_registry_start_prefix():
    """The registry start over the two steps before its bifurcation."""
    jr, tr = _loops(_scenario("single_robot", N=25, T=0.1), dict(max_steps=2, stop_tol=5e-2, escape=True))
    hold_loop(jr, tr, u_atol=5e-3)


def test_two_robot_swap_closed_loop_matches_reference():
    o = _scenario("two_robot_swap", N=25, T=0.1, x0=(-1.0, -1.0, 0.785, 1.0, 1.0, 3.9))
    hold_loop(*_loops(o, dict(max_steps=15, escape=True)))


def _fake_solve(lib):
    """A stand-in engine with the same arithmetic in both packages: each
    call halves the warm controls and adds (0.15, 0.3); a solve whose start
    lies in one of three bands of x is bad: a NaN cost, a violation over
    viol_fallback, or a NaN control."""
    xp = jnp if lib == "jax" else torch
    where = jnp.where if lib == "jax" else torch.where

    def fn(o, w):
        x = o.x0[0]
        U = 0.5 * w.U + xp.asarray([0.15, 0.3]) if lib == "jax" else 0.5 * w.U + torch.tensor([0.15, 0.3])
        bad_cost = (x > 0.02) & (x < 0.05)
        bad_viol = (x > 0.08) & (x < 0.11)
        bad_u = (x > 0.14) & (x < 0.17)
        U = where(bad_u & (xp.arange(U.shape[0])[:, None] == 1), math.nan, U)
        cost = where(bad_cost, math.nan, xp.sum(U * U))
        viol = where(bad_viol, 1e31, 0.0)
        kw = dict(X=xp.zeros((o.N + 1, o.nx)), U=U, lam=w.lam + 1.0, mu=w.mu, cost=cost,
                  viol=viol, inner_iters=xp.ones((), dtype=xp.int32),
                  outer_iters=xp.ones((), dtype=xp.int32), converged=xp.ones((), dtype=bool))
        return (JaxResult if lib == "jax" else SolveResult)(**kw)
    return fn


def test_rejection_matches_reference():
    """A plan with a NaN cost, a NaN control or a violation over
    viol_fallback is rejected: U and lam revert to the warm start's, the
    rest (cost, viol, iterations) stays the new solve's."""
    o = JP.make_ocp(m=1, N=5, T=0.1, x0=[0.0, 0.0, 0.0], x_goal=[1.0, 0.0, 0.0])
    mpc = dict(max_steps=12)
    jr = jax.jit(functools.partial(JD.closed_loop, mpc=JD.MPCConfig(**mpc),
                                   solve_fn=_fake_solve("jax")))(o)
    tr = TD.closed_loop(port_ocp(o), mpc=TD.MPCConfig(**mpc), solve_fn=_fake_solve("torch"))
    xs = np.asarray(jr.X_hist)[:-1, 0]
    edges = np.array([0.02, 0.05, 0.08, 0.11, 0.14, 0.17])
    assert np.abs(xs[:, None] - edges).min() > 1e-4   # no band edge decided by rounding
    bands = [((xs > lo) & (xs < hi)).sum() for lo, hi in edges.reshape(3, 2)]
    assert min(bands) >= 1, bands                      # every kind of rejection happened
    np.testing.assert_allclose(tr.X_hist.numpy(), np.asarray(jr.X_hist), atol=1e-6)
    np.testing.assert_allclose(tr.U_hist.numpy(), np.asarray(jr.U_hist), atol=1e-6)
    np.testing.assert_array_equal(np.isnan(tr.cost_hist.numpy()), np.isnan(np.asarray(jr.cost_hist)))
    np.testing.assert_allclose(tr.viol_hist.numpy(), np.asarray(jr.viol_hist))
    assert torch.isfinite(tr.X_hist).all()


def _counting(fn, calls):
    def wrapped(o, w):
        calls.append(1)
        return fn(o, w)
    return wrapped


def test_early_exit_gives_the_full_loop(monkeypatch):
    """Once the loop is done and its carry repeats, it stops solving; its
    histories equal, bit for bit, those of the loop that solves every step
    (and the reference's, at the loop tolerances)."""
    o = JP.make_ocp(m=1, N=10, T=0.1, x0=[0.75, 1.45, 0.1], x_goal=[1.0, 1.5, 0.0])
    mpc = dict(max_steps=25, stop_tol=5e-2, escape=True)
    t = port_ocp(o)
    cfg = ALILQRConfig(**FAST)
    short, full = [], []
    early = TD.closed_loop(t, cfg, TD.MPCConfig(**mpc),
                           solve_fn=_counting(lambda a, w: TD.solve(a, w, cfg), short))
    monkeypatch.setattr(TD, "_repeats", lambda *a: False)
    every = TD.closed_loop(t, cfg, TD.MPCConfig(**mpc),
                           solve_fn=_counting(lambda a, w: TD.solve(a, w, cfg), full))
    assert bool(early.reached) and int(early.steps_used) < mpc["max_steps"] - 2
    assert len(full) == mpc["max_steps"] and len(short) <= int(early.steps_used) + 2
    for f in dataclasses.fields(early):
        a, b = getattr(early, f.name), getattr(every, f.name)
        assert torch.equal(TD._bits(a), TD._bits(b)), f.name
    jr = jax.jit(functools.partial(JD.closed_loop, solver_cfg=JaxConfig(**FAST),
                                   mpc=JD.MPCConfig(**mpc)))(o)
    hold_loop(jr, early)


def test_warm_start_argument_and_generator():
    """closed_loop takes a warm start and a generator: noise-free plants
    ignore the generator; a noisy plant draws from it reproducibly."""
    from nmpc_tpu_torch.sim import plant_from_numpy

    o = JP.make_ocp(m=1, N=5, T=0.1, x0=[0.0, 0.0, 0.0], x_goal=[0.5, 0.2, 0.0])
    t = port_ocp(o)
    cfg = ALILQRConfig(**FAST)
    mpc = TD.MPCConfig(max_steps=4)
    warm = WarmStart(U=torch.full((5, 2), 0.1), lam=torch.zeros((5, t.n_con)), mu=torch.tensor(10.0))
    a = TD.closed_loop(t, cfg, mpc, warm=warm)
    b = TD.closed_loop(t, cfg, mpc, warm=warm, generator=torch.Generator().manual_seed(0))
    assert torch.equal(a.X_hist, b.X_hist)
    jr = jax.jit(functools.partial(JD.closed_loop, solver_cfg=JaxConfig(**FAST), mpc=JD.MPCConfig(max_steps=4),
                                   warm=JaxWarm(U=jnp.full((5, 2), 0.1), lam=jnp.zeros((5, o.n_con)),
                                                mu=jnp.asarray(10.0))))(o)
    hold_loop(jr, a)
    noisy = plant_from_numpy(process_noise=np.full(3, 0.01, np.float32),
                             odom_noise=np.full(3, 0.01, np.float32), device="cpu")
    runs = [TD.closed_loop(t, cfg, mpc, plant=noisy, generator=torch.Generator().manual_seed(2))
            for _ in range(2)]
    assert torch.equal(runs[0].X_hist, runs[1].X_hist)
    assert not torch.equal(runs[0].X_hist, a.X_hist)
