"""The port's driver modes against nmpc_tpu.mpc.driver: compute delay with
and without compensation, yaw wrapping, the rt recipe, trajectory
tracking, plan-then-replay and waypoint tours (one past an obstacle). The same
tolerances and choice of well-conditioned starts as
tests/test_torch_driver.py (its docstring says why): X_hist and err_hist
atol 5e-3, U_hist atol 2e-2 (5e-3 over a one-step prefix), steps, arrival
and waypoint indices equal.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nmpc_tpu.mpc import driver as JD
from nmpc_tpu.ocp import problem as JP
from nmpc_tpu.scenarios import get as jax_get
from nmpc_tpu.sim.plant import PlantConfig as JaxPlant
from nmpc_tpu.solver.alilqr import ALILQRConfig as JaxConfig
from nmpc_tpu_torch.mpc import driver as TD
from nmpc_tpu_torch.sim import plant_from_numpy
from nmpc_tpu_torch.solver import ALILQRConfig

from test_torch_driver import FAST, _loops, _scenario, hold_loop, port_ocp

HEADING = dict(N=25, T=0.1, x0=(0.0, 0.0, 0.98))   # single_robot, heading at its goal


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Eager loops of small ops: one intra-op thread (more only spin)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("compensate", [False, True])
def test_delay_closed_loop_matches_reference(compensate):
    o = _scenario("single_robot", **HEADING)
    hold_loop(*_loops(o, dict(max_steps=15, stop_tol=5e-2, escape=True, delay=1,
                              delay_compensate=compensate)))


def test_wrap_yaw_closed_loop_matches_reference():
    """The start's yaw is its goal bearing minus 2 pi: wrapped, the robot
    faces its goal."""
    o = _scenario("single_robot", N=25, T=0.1, x0=(0.0, 0.0, 0.98 - 2 * np.pi),
                  x_goal=(1.0, 1.5, 0.98))
    jr, tr = _loops(o, dict(max_steps=15, stop_tol=5e-2, wrap_yaw=True))
    hold_loop(jr, tr)
    th = tr.X_hist[1:, 2]
    assert (th >= 0).all() and (th < 2 * np.pi).all()


def test_rt_closed_loop_matches_reference():
    o = _scenario("single_robot", **HEADING)
    full, rt = dict(n_outer=6, n_inner=12, tol_con=1e-4), dict(n_outer=3, n_inner=10, tol_con=1e-3)
    mpc = dict(max_steps=10, escape=True)
    jr = jax.jit(functools.partial(JD.rt_closed_loop, full_cfg=JaxConfig(**full),
                                   rt_cfg=JaxConfig(**rt), mpc=JD.MPCConfig(**mpc)))(o)
    tr = TD.rt_closed_loop(port_ocp(o), ALILQRConfig(**full), ALILQRConfig(**rt), TD.MPCConfig(**mpc))
    hold_loop(jr, tr)
    assert int(tr.iter_hist.max()) <= 30


def test_tracking_matches_reference():
    # tests/test_mpc.py:112-133: Xref = [cos(0.1 t), sin(0.1 t), 0]
    o = JP.make_ocp(m=1, N=10, T=0.5, x0=[1, 0, 0], x_goal=[1, 0, 0])

    def ref(xp, t):
        p = xp.stack([xp.cos(0.1 * t), xp.sin(0.1 * t), 0.0 * t])
        return xp.tile(p[None, :], (10, 1))

    mpc = dict(max_steps=20)
    jr = jax.jit(functools.partial(JD.closed_loop_tracking, ref_fn=functools.partial(ref, jnp),
                                   solver_cfg=JaxConfig(**FAST), mpc=JD.MPCConfig(**mpc)))(o)
    tr = TD.closed_loop_tracking(port_ocp(o), functools.partial(ref, torch), ALILQRConfig(**FAST),
                                 TD.MPCConfig(**mpc))
    hold_loop(jr, tr)
    assert int(tr.steps_used) == 20 and not bool(tr.reached)


def test_plan_then_replay_matches_reference():
    """Offline against the model, replayed through a plant with substeps
    and actuator saturation."""
    o = JP.make_ocp(m=1, N=25, T=0.1, x0=[0, 0, 0.6], x_goal=[0.4, 0.3, 0.6])
    mpc = dict(max_steps=20, stop_tol=5e-2)
    u_sat = np.array([0.2, 2.0], np.float32)
    jplant = JaxPlant(substeps=4, u_sat=jnp.asarray(u_sat))
    joff, jrep = jax.jit(functools.partial(JD.plan_then_replay, solver_cfg=JaxConfig(**FAST),
                                           mpc=JD.MPCConfig(**mpc), plant=jplant))(o)
    toff, trep = TD.plan_then_replay(port_ocp(o), ALILQRConfig(**FAST), TD.MPCConfig(**mpc),
                                     plant_from_numpy(4, u_sat=u_sat, device="cpu"))
    hold_loop(joff, toff)
    np.testing.assert_allclose(trep.numpy(), np.asarray(jrep), atol=5e-3)
    assert trep.shape == (21, 3)


def _waypoints(o, wps, mpc):
    jr = jax.jit(functools.partial(JD.closed_loop_waypoints, waypoints=wps,
                                   solver_cfg=JaxConfig(**FAST), mpc=JD.MPCConfig(**mpc)))(o)
    tr = TD.closed_loop_waypoints(port_ocp(o), torch.tensor(np.asarray(wps)), ALILQRConfig(**FAST),
                                  TD.MPCConfig(**mpc))
    return jr, tr


def test_waypoint_tour_matches_reference():
    """A two-waypoint tour that advances once within 30 steps."""
    o = JP.make_ocp(m=1, N=25, T=0.1, x0=[0, 0, 0], x_goal=[0.3, 0, 0])
    wps = jnp.asarray([[0.3, 0.0, 0.0], [0.6, 0.1, 0.2]], jnp.float32)
    jr, tr = _waypoints(o, wps, dict(max_steps=30))
    hold_loop(jr, tr)
    assert int(tr.goal_idx_hist[-1]) == 1


SIDE_OBSTACLE = dict(m=1, N=25, T=0.1, x0=[0, 0, 0], x_goal=[0.6, 0, 0],
                     obstacles=((0.35, 0.25, 0.1),), robot_radius=0.15, obs_margin=0.05)


def test_obstacle_waypoint_loop_matches_reference():
    """The per-scenario engine with a static-obstacle row that turns active:
    a robot driving past an obstacle beside its path grazes the keep-out
    ring (0.30 from its centre) over 25 steps."""
    o = JP.make_ocp(**SIDE_OBSTACLE)
    wps = jnp.asarray([[0.6, 0.0, 0.0], [0.6, 0.4, 1.57]], jnp.float32)
    jr, tr = _waypoints(o, wps, dict(max_steps=25))
    hold_loop(jr, tr)
    X = tr.X_hist.numpy()
    assert np.hypot(X[:, 0] - 0.35, X[:, 1] - 0.25).min() >= 0.3 - 1e-2


def test_obstacle_scenario_first_step_matches_reference():
    """obstacle_scenario_1 at N=25 over its first two waypoints (the setup
    of tests/test_mpc.py:149-165), its first step only: from the second its
    steering sits at the omega bound and flips with rounding (the reference
    against itself, x0 moved by 1e-7, parts by 2.0e-2 in X_hist at step 2;
    tests/reference_spread.py)."""
    sc = jax_get("obstacle_scenario_1")
    jr, tr = _waypoints(sc.make(N=25), jnp.asarray(sc.waypoints[:2], jnp.float32),
                        dict(max_steps=1, advance_tol=sc.advance_tol))
    hold_loop(jr, tr, u_atol=5e-3)
