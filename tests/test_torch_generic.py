"""The user-dynamics hook on the port (ocp/problem.make_generic_ocp; the
per-scenario `solve`, `solve_batched`'s hybrid route and the receding-horizon
loop over a user model) against the JAX package on the same problem data:
the reference demo's Van der Pol OCP (N=20, dt 0.5, RK4 with 4 substeps,
x1 >= -0.25) and the first-order process (K=3, tau=5, Euler), as
tests/test_generic_dynamics.py builds them.

Tolerances: per-scenario U at that file's atol (5e-2 Van der Pol, 2e-2 the
process) and cost at rtol 1e-4; the batched solve per scenario at the
batched-against-per-scenario criteria of tests/test_batched_solver.py:30-34
(cost rtol 1e-4, U atol 5e-3); the loop's final state within 1e-3 of the
reference's and both within 0.3 of the setpoint (that file's criterion).
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
from nmpc_tpu.solver import alilqr as JS
from nmpc_tpu.solver import alilqr_batched as JB
from nmpc_tpu_torch.ocp import problem as TP
from nmpc_tpu_torch.ops import cuda_build
from nmpc_tpu_torch.parallel import batch_ocp
from nmpc_tpu_torch.solver import ALILQRConfig, solve, solve_batched

CFG = dict(n_outer=10, n_inner=40, tol_con=1e-5)   # the reference demo's
K_GAIN, TAU = 3.0, 5.0


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Eager loops of small ops: one intra-op thread (more only spin)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def vdp_jax(x, u):
    x1, x2 = x[0], x[1]
    return jnp.stack([(1.0 - x2 * x2) * x1 - x2 + u[0], x1])


def vdp_torch(x, u):
    x1, x2 = x[0], x[1]
    return torch.stack([(1.0 - x2 * x2) * x1 - x2 + u[0], x1])


def proc(x, u):
    """dy/dt = (-y + K u) / tau: the same expression in either framework."""
    return (-x + K_GAIN * u) / TAU


VDP = dict(nx=2, nu=1, N=20, T=0.5, x0=[0.0, 1.0], x_goal=[0.0, 0.0], u_lo=[-1.0],
           u_hi=[1.0], x_lo=[-0.25, -TP.BIG], integrator="rk4", substeps=4)
PROC = dict(nx=1, nu=1, N=30, T=0.5, x0=[0.0], x_goal=[10.0], Qdiag=[1.0], Rdiag=[0.01],
            u_lo=[0.0], u_hi=[5.0], integrator="euler")


def _hold(tr, jr, u_atol, cost_rtol=1e-4):
    np.testing.assert_allclose(tr.cost.numpy(), np.asarray(jr.cost), rtol=cost_rtol)
    np.testing.assert_allclose(tr.U.numpy(), np.asarray(jr.U), atol=u_atol)
    np.testing.assert_array_equal(tr.converged.numpy(), np.asarray(jr.converged))
    assert torch.isfinite(tr.X).all() and tr.X.shape == np.asarray(jr.X).shape


def test_generic_ocp_matches_reference():
    """make_generic_ocp's fields, a step of each integrator, and the
    Jacobians of the user model (torch.func.jacfwd through vmap) against
    the reference's at a few points."""
    for (fj, ft), kw in (((vdp_jax, vdp_torch), VDP), ((proc, proc), PROC),
                         ((proc, proc), dict(PROC, integrator="rk4", substeps=3))):
        jo, to = JP.make_generic_ocp(fj, **kw), TP.make_generic_ocp(ft, device="cpu", **kw)
        for f in dataclasses.fields(to):
            a, b = getattr(to, f.name), getattr(jo, f.name)
            if f.name in TP.OCP_META:
                assert f.name == "dyn_fn" or a == b, f.name
            else:
                np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=f.name)
        rng = np.random.default_rng(len(kw))
        xs = rng.normal(size=(5, to.nx)).astype(np.float32)
        us = rng.normal(size=(5, to.nu)).astype(np.float32)
        want = [JP.step_dynamics(jo, jnp.asarray(x), jnp.asarray(u)) for x, u in zip(xs, us)]
        got = TP.step_dynamics(to, torch.from_numpy(xs), torch.from_numpy(us))
        np.testing.assert_allclose(got.numpy(), np.stack(want), rtol=1e-6, atol=1e-6)
        from nmpc_tpu.solver.alilqr import _stage_jacobians as jax_jac
        from nmpc_tpu_torch.solver.alilqr import _stage_jacobians as torch_jac

        A, B = torch_jac(to, torch.from_numpy(xs), torch.from_numpy(us))
        for i in range(5):
            Aj, Bj = jax_jac(jo, jnp.asarray(xs[i]), jnp.asarray(us[i]))
            np.testing.assert_allclose(A[i].numpy(), np.asarray(Aj), rtol=1e-5, atol=1e-6)
            np.testing.assert_allclose(B[i].numpy(), np.asarray(Bj), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("model", ["vdp", "process"])
def test_per_scenario_solve_matches_reference(model):
    fj, ft, kw, u_atol = ((vdp_jax, vdp_torch, VDP, 5e-2) if model == "vdp"
                          else (proc, proc, PROC, 2e-2))
    jr = jax.jit(functools.partial(JS.solve, cfg=JS.ALILQRConfig(**CFG)))(
        JP.make_generic_ocp(fj, **kw))
    tr = solve(TP.make_generic_ocp(ft, device="cpu", **kw), cfg=ALILQRConfig(**CFG))
    assert bool(tr.converged) and float(tr.viol) < 1e-4
    _hold(tr, jr, u_atol)
    if model == "vdp":   # the x1 >= -0.25 bound is active at the optimum
        assert -0.25 - 1e-4 <= float(tr.X[1:20, 0].min()) < -0.2


def test_batched_vdp_matches_reference():
    """solve_batched on a B=8 Van der Pol batch (starts jittered by 0.05)
    takes the hybrid route: expansions by jacfwd, K3's plain version at (2,
    1), plain rollouts of every candidate; no kernel is counted on the CPU."""
    rng = np.random.default_rng(3)
    x0s = (np.asarray(VDP["x0"])[None] + 0.05 * rng.standard_normal((8, 2))).astype(np.float32)
    cfg = dict(n_outer=6, n_inner=20, tol_con=1e-4)
    jr = jax.jit(functools.partial(JB.solve_batched, cfg=JS.ALILQRConfig(**cfg)))(
        jax_batch_ocp(JP.make_generic_ocp(vdp_jax, **VDP), jnp.asarray(x0s)))
    cuda_build.reset_launch_counts()
    tb = batch_ocp(TP.make_generic_ocp(vdp_torch, device="cpu", **VDP), torch.from_numpy(x0s))
    tr = solve_batched(tb, cfg=ALILQRConfig(**cfg))
    assert not any(cuda_build.launch_counts.values())
    assert bool(tr.converged.all())
    _hold(tr, jr, 5e-3)
    np.testing.assert_array_equal(tr.outer_iters.numpy(), np.asarray(jr.outer_iters))


def test_generic_closed_loop_driver():
    """The hand-rolled receding-horizon loop of the reference's test over
    the first-order process (plant = the model's own step, shifted warm
    starts), 25 periods, beside the reference's loop."""
    from nmpc_tpu.mpc.driver import shift_warm as jax_shift
    from nmpc_tpu_torch.mpc.driver import shift_warm

    kw = dict(PROC, N=10)
    jo, to = JP.make_generic_ocp(proc, **kw), TP.make_generic_ocp(proc, device="cpu", **kw)
    jcfg, tcfg = JS.ALILQRConfig(n_outer=4, n_inner=15, tol_con=1e-4), ALILQRConfig(
        n_outer=4, n_inner=15, tol_con=1e-4)
    jsolve = jax.jit(functools.partial(JS.solve, cfg=jcfg))
    xj, xt, wt = jo.x0, to.x0, None
    for _ in range(25):
        rj = jsolve(dataclasses.replace(jo, x0=xj))
        xj = JP.step_dynamics(dataclasses.replace(jo, x0=xj), xj, rj.U[0])
        rt = solve(dataclasses.replace(to, x0=xt), cfg=tcfg)
        xt = TP.step_dynamics(dataclasses.replace(to, x0=xt), xt, rt.U[0])
        wt = shift_warm(rt, tcfg)
        jax_shift(rj, jcfg)
    assert wt.U.shape == (10, 1)
    assert abs(float(xt[0]) - 10.0) < 0.3
    assert abs(float(xt[0]) - float(xj[0])) < 1e-3


def unicycle_jax(x, u):
    return jnp.stack([u[0] * jnp.cos(x[2]), u[0] * jnp.sin(x[2]), u[1]])


def unicycle_torch(x, u):
    return torch.stack([u[0] * torch.cos(x[2]), u[0] * torch.sin(x[2]), u[1]])


UNI = dict(nx=3, nu=2, N=10, T=0.1, x0=[0.0, 0.0, 0.0], x_goal=[1.0, 0.5, 0.0],
           Qdiag=[1.0, 5.0, 0.1], Rdiag=[0.5, 0.05], u_lo=[-0.22, -2.84], u_hi=[0.22, 2.84],
           integrator="rk4")


def moving_generic(B=4, seed=6):
    """A user unicycle model (make_generic_ocp, RK4) given one moving
    obstacle, the schedule of tests/test_torch_hybrid.py::moving_ray_batch
    (0.35 ahead, drifting across the path, keep-out 0.3): the reference's
    OCP and the port's, each with a per-scenario schedule [B, N, 1, 2]
    (jittered by 0.01) and starts jittered by 0.02, as numpy-made inputs."""
    rng = np.random.default_rng(seed)
    N = UNI["N"]
    sched = np.stack([np.full(N, 0.35), -0.02 * np.arange(N)], -1)[:, None, :]
    mov = (sched[None] + 0.01 * rng.standard_normal((B, N, 1, 2))).astype(np.float32)
    x0s = (np.asarray(UNI["x0"])[None] + 0.02 * rng.standard_normal((B, 3))).astype(np.float32)
    jo = dataclasses.replace(JP.make_generic_ocp(unicycle_jax, **UNI), n_mov=1,
                             dmin2=jnp.float32(0.09), mov_obs=jnp.asarray(mov[0]))
    to = dataclasses.replace(TP.make_generic_ocp(unicycle_torch, device="cpu", **UNI), n_mov=1,
                             dmin2=torch.tensor(0.09), mov_obs=torch.from_numpy(mov[0]))
    jb = dataclasses.replace(jax_batch_ocp(jo, jnp.asarray(x0s)), mov_obs=jnp.asarray(mov))
    tb = dataclasses.replace(batch_ocp(to, torch.from_numpy(x0s)), mov_obs=torch.from_numpy(mov))
    return jo, to, jb, tb


def test_user_model_with_moving_obstacles_matches_reference():
    """dyn_fn with moving obstacles: the per-scenario `solve` (one shared
    schedule) at this file's per-scenario tolerances, and solve_batched's
    hybrid route with per-scenario schedules, with the Riccati sweep and
    with the scan, at the batched criteria (a 1e-7 move of x0 moves the
    reference's U by 8.1e-4 in the per-scenario solve and 1.7e-3 in the
    batch, tests/reference_spread.py gn); the moving-obstacle row is
    active."""
    jo, to, jb, tb = moving_generic()
    cfg = dict(n_outer=4, n_inner=10, tol_con=1e-3)
    jr = jax.jit(functools.partial(JS.solve, cfg=JS.ALILQRConfig(**cfg)))(jo)
    tr = solve(to, cfg=ALILQRConfig(**cfg))
    _hold(tr, jr, 2e-2)
    assert float(tr.lam[1:, 0].max()) > 0.0
    for sweep in ("seq", "scan"):
        kw = dict(cfg, sweep=sweep)
        jr = jax.jit(functools.partial(JB.solve_batched, cfg=JS.ALILQRConfig(**kw)))(jb)
        tr = solve_batched(tb, cfg=ALILQRConfig(**kw))
        _hold(tr, jr, 5e-3)
        np.testing.assert_array_equal(tr.outer_iters.numpy(), np.asarray(jr.outer_iters))
        assert float(tr.lam[:, 1:, 0].max()) > 0.0
