"""Frozen scenario registry — the reference's compatibility surface.

Port of nmpc_tpu/scenarios/registry.py. The reference registry imports
jax.numpy, so the port carries its own copy of the 35 entries;
tests/test_torch_ocp.py holds every entry's `make()` against the
reference's, field by field. Each (m, T, N, dmin, bounds, x0, xs, waypoints,
obstacles) tuple is one entry, citing the reference file:lines it reproduces.

Families:
  A  scipy-SLSQP pure-Python prototypes    F  paper simulation scenarios 1-6
  C  single-robot online NMPC              G  real-hardware implementations
  D  centralized multi-robot, no collision H  static-obstacle avoidance
  E  centralized collision-free            I  LiDAR-augmented NMPC
"""

from __future__ import annotations

import dataclasses
import math

import torch

from nmpc_tpu_torch.device import DEVICE
from nmpc_tpu_torch.ocp.problem import OCP, make_ocp

_PI = math.pi


@dataclasses.dataclass(frozen=True)
class Scenario:
    name: str
    family: str
    source: str                   # reference file:lines this reproduces
    m: int
    N: int
    T: float
    x0: tuple
    x_goal: tuple | None = None
    waypoints: tuple | None = None  # sequence of (x, y, theta) goals
    dmin: float = 0.0
    collision: bool = False
    v_max: float = 0.22
    omega_max: float = 2.84
    pos_bound: float = 10.0
    theta_bound: float | None = None  # None = unbounded
    stop_tol: float = 1e-1
    advance_tol: float = 0.075
    obstacles: tuple | None = None    # ((ox, oy, r), ...)
    robot_radius: float = 0.1
    obs_margin: float = 0.05
    Nc: int | None = None             # control horizon (move blocking)
    num_rays: int = 0
    inv_dist_weight: float = 0.0
    notes: str = ""

    def make(self, dtype=torch.float32, device=DEVICE, **overrides) -> OCP:
        goal = self.x_goal
        if goal is None:
            assert self.waypoints, f"{self.name}: no goal or waypoints"
            goal = self.waypoints[0]
        kw = dict(
            m=self.m,
            N=self.N,
            T=self.T,
            x0=torch.as_tensor(self.x0, dtype=dtype, device=device),
            x_goal=torch.as_tensor(goal, dtype=dtype, device=device),
            v_max=self.v_max,
            omega_max=self.omega_max,
            pos_bound=self.pos_bound,
            theta_bound=1e9 if self.theta_bound is None else self.theta_bound,
            dmin=self.dmin,
            collision=self.collision,
            obstacles=None if self.obstacles is None else torch.as_tensor(
                self.obstacles, dtype=dtype, device=device),
            robot_radius=self.robot_radius,
            obs_margin=self.obs_margin,
            num_rays=self.num_rays,
            inv_dist_weight=self.inv_dist_weight,
            dtype=dtype,
            device=device,
        )
        if self.num_rays:
            # the ray lower bound IS the robot radius in every reference
            # variant (v2 :177, v3 :67,153, v4 :67)
            kw["ray_lo"] = self.robot_radius
        kw.update(overrides)
        return make_ocp(**kw)

    @property
    def waypoint_array(self):
        assert self.waypoints
        return torch.as_tensor(self.waypoints, dtype=torch.float32)


def _interleave(*poses):
    out = []
    for p in poses:
        out.extend(p)
    return tuple(out)


# Six-robot antipodal unit circle (paper headline), sim variant
_SIX_X0 = (
    +0.866, +0.5, -2.618, +0.0, +1.0, -1.57, -0.866, +0.5, -0.523,
    -0.866, -0.5, +0.523, +0.0, -1.0, +1.57, +0.866, -0.5, +2.618,
)
_SIX_XS = (
    -0.866, -0.5, -2.618, +0.0, -1.0, -1.57, +0.866, -0.5, -0.523,
    +0.866, +0.5, +0.523, +0.0, +1.0, +1.57, -0.866, +0.5, +2.618,
)

# Eight-robot unit circle rotation-swap
_EIGHT_X0 = (
    0.866, 0.5, -2.618, 0.5, 0.866, -2.094, -0.5, 0.866, -1.047, -0.866, 0.5, -0.523,
    -0.866, -0.5, 0.523, -0.5, -0.866, 1.047, 0.5, -0.866, 2.094, 0.866, -0.5, 2.618,
)
_EIGHT_XS = (
    -0.866, -0.5, -2.618, -0.5, -0.866, -2.094, 0.5, -0.866, -1.047, 0.866, -0.5, -0.523,
    0.866, 0.5, 0.523, 0.5, 0.866, 1.047, -0.5, 0.866, 2.094, -0.866, 0.5, 2.618,
)

# Ten-robot two-row line crossing. Goals from the script (:409-411); the
# Gazebo spawn poses are not in the repo (the module-level x0 is a stale
# placeholder), so the start rows are reconstructed as the mirrored formation
# implied by the goals: row A starts at y=-1 heading +y, row B at y=+1
# heading -y, so the rows cross.
_TEN_XS = (
    -1.5, +1.0, 1.57, -0.5, +1.0, 1.57, +0.5, +1.0, 1.57, +1.5, +1.0, 1.57, +2.5, +1.0, 1.57,
    -1.5, -1.0, -1.57, -0.5, -1.0, -1.57, +0.5, -1.0, -1.57, +1.5, -1.0, -1.57, +2.5, +2.5, 0.0,
)
_TEN_X0 = (
    -1.5, -1.0, 1.57, -0.5, -1.0, 1.57, +0.5, -1.0, 1.57, +1.5, -1.0, 1.57, +2.5, -1.0, 1.57,
    -1.5, +1.0, -1.57, -0.5, +1.0, -1.57, +0.5, +1.0, -1.57, +1.5, +1.0, -1.57, +2.5, +1.0, -1.57,
)

# First-scenario waypoint tour (first_scenario.py:173-185; same list in
# decentralized_first_scenario.py:249-260 with goal 1 = (1.0, 0.5, 0))
_TOUR_WAYPOINTS = (
    (1.0, 0.5, 0.0),
    (0.0, 0.75, -1.57),
    (-0.5, 0.5, 3.14),
    (-0.5, -0.75, 0.785),
    (0.75, -0.75, -0.785),
    (0.0, 0.0, 0.0),
)

# Lab waypoint tour, inch-derived meters (centralized_one_robots_implementation.py:176-187)
_LAB_WAYPOINTS = (
    (0.8382, 0.3556, 0.785),
    (0.0, 0.7112, -1.57),
    (-1.176, 0.3556, -3.14),
    (-0.5588, -0.7112, 0.785),
    (0.8382, -0.7112, -0.785),
    (0.0, 0.0, 0.0),
)

# Obstacle-scenario waypoint tours (…_mpc_obstacle_avoidance.py goal lists)
_OBS1_WAYPOINTS = (
    (1.5, 1.5, 0.0), (0.0, 0.75, -1.57), (-0.5, 0.5, 3.14),
    (-0.5, -0.75, 0.785), (0.75, -0.75, -0.785), (0.0, 0.0, 0.0),
)
_OBS2_WAYPOINTS = (
    (1.5, 1.5, 0.0), (0.5, 0.0, -1.57), (-0.5, 1.5, 3.14),
    (-1.0, -0.75, 0.785), (0.5, -2.0, -0.785), (0.0, 0.0, 0.0),
)
_OBS3_WAYPOINTS = (
    (1.5, 1.5, 0.0), (-1.0, 2.5, -1.57), (1.5, 3.0, 3.14),
    (-1.0, 0.5, 0.785), (0.0, 4.0, -0.785), (0.0, 0.0, 0.0),
)


_SCENARIOS = [
    # ----- family A: scipy-SLSQP prototypes (capability: short-horizon MPC,
    # control horizon Nc < N, multi-goal, trajectory tracking) -----
    Scenario(
        name="slsqp_pose", family="A",
        source="AllScripts/mpc_control_pose_py.py:99-172",
        m=1, N=3, T=0.5, x0=(0, 0, 0), x_goal=(2.0, 2.0, 0.0),
        v_max=0.22, omega_max=2.84, stop_tol=0.075,
        notes="pure-Python SLSQP prototype; N=3, Dt=0.5",
    ),
    Scenario(
        name="slsqp_pose_nc", family="A",
        source="AllScripts/mpc_control_pose_py_modified.py:32-95",
        m=1, N=5, T=0.5, x0=(0, 0, 0), x_goal=(2.0, 2.0, 0.0),
        Nc=2, stop_tol=0.075,
        notes="control horizon Nc=2 < N=5 (move blocking)",
    ),
    Scenario(
        name="slsqp_pose_multi", family="A",
        source="AllScripts/mpc_control_pose_multi_robot_py.py:90-114,125-155",
        m=1, N=5, T=0.5, x0=(0, 0, 0), x_goal=(1.0, -2.0, 1.57),
        Nc=2, v_max=0.1, omega_max=0.5, pos_bound=3.0, theta_bound=3.14,
        stop_tol=0.075,
        notes="despite the filename this drives ONE robot (a single "
              "/cmd_vel publisher, :123); the loss carries a reference-"
              "velocity term u'R(u-uref) with Vref=0 (:103,36), which "
              "reduces to the standard u'Ru. Param-only variant of "
              "slsqp_pose_nc: reduced limits v<=0.1, w<=0.5, state box "
              "+-3.0 / theta +-3.14 (:110-118)",
    ),
    Scenario(
        name="slsqp_multigoal", family="A",
        source="AllScripts/mpc_pose_control_scipyminimizer_multiple_goals.py:97-137",
        m=1, N=20, T=0.5, x0=(0, 0, 0),
        waypoints=((2.0, 2.0, 0.0), (0.0, 0.0, 0.0)), Nc=1, advance_tol=0.2,
    ),
    Scenario(
        name="tracking_circle", family="A",
        source="AllScripts/mpc_control_trajectory_tracking.py:93-127",
        m=1, N=3, T=0.5, x0=(1, 0, 0), x_goal=(1.0, 0.0, 0.0),
        notes="time-varying reference [cos(0.1 t), sin(0.1 t), 0]",
    ),
    # ----- family C: single-robot online NMPC -----
    Scenario(
        name="single_robot", family="C",
        source="AllScripts/mpc_online_casadi.py:56-61,137-141",
        m=1, N=50, T=0.01, x0=(0, 0, 0), x_goal=(1.0, 1.5, 0.0), stop_tol=5e-2,
    ),
    Scenario(
        name="tb3_1", family="C",
        source="AllScripts/mpc_online_casadi_tb3_1.py:56-57,137-141",
        m=1, N=200, T=0.01, x0=(0, 0, 0), x_goal=(0.0, 0.0, 0.0), stop_tol=5e-2,
        notes="decentralized deployment clone 1 (uncoupled node)",
    ),
    Scenario(
        name="tb3_2", family="C",
        source="AllScripts/mpc_online_casadi_tb3_2.py:56-57,137-141",
        m=1, N=200, T=0.01, x0=(0, 0, 0), x_goal=(3.0, 1.0, 0.0), stop_tol=5e-2,
    ),
    Scenario(
        name="tb3_3", family="C",
        source="AllScripts/mpc_online_casadi_tb3_3.py:56-57,137-141",
        m=1, N=200, T=0.01, x0=(0, 0, 0), x_goal=(0.0, -3.0, 5.497), stop_tol=5e-2,
    ),
    # ----- family D: centralized multi-robot, no collision constraints -----
    Scenario(
        name="two_robot_centralized", family="D",
        source="AllScripts/mpc_online_casadi_tb3_multi_centralized.py:71-73,157-166",
        m=2, N=50, T=0.01,
        x0=(-2.0, -1.0, 0.0, 2.5, 0.0, 0.0),
        x_goal=(1.0, 0.0, 0.0, 3.0, 1.0, 0.0),
    ),
    # ----- family E: centralized collision-free (Gazebo) -----
    Scenario(
        name="two_robot_swap", family="E",
        source="AllScripts/mpc_online_casadi_tb3_two_centralized_collision_free.py:80-84,192-201",
        m=2, N=100, T=0.02,
        x0=(-1.0, -1.0, 0.785, 1.0, 1.0, 2.356),
        x_goal=(1.0, 1.0, 0.785, -1.0, -1.0, 2.356),
        dmin=0.25, collision=True,
    ),
    Scenario(
        name="five_robot", family="E",
        source="AllScripts/mpc_online_casadi_tb3_multi_centralized_collision_free.py:115-119,253-267",
        m=5, N=70, T=0.02,
        x0=(-1, 1, -0.785, 1, 1, -2.356, 1, -1, 2.356, -1, -1, 0.785, 0, 0, 0),
        x_goal=(1, -1, -0.785, -1, -1, -2.356, -1, 1, 2.356, 1, 1, 0.785, 0, 0, 0),
        dmin=0.3, collision=True,
    ),
    Scenario(
        name="six_robot_antipodal", family="E",
        source="AllScripts/mpc_online_casadi_tb3_six_multi_centralized_collision_free.py:127-131,291-310",
        m=6, N=35, T=0.2, x0=_SIX_X0, x_goal=_SIX_XS,
        dmin=0.3, collision=True,
        notes="paper headline case: antipodal swap on the unit circle",
    ),
    Scenario(
        name="eight_robot", family="E",
        source="AllScripts/mpc_online_casadi_tb3_eight_multi_centralized_collision_free.py:148-152,341-363",
        m=8, N=5, T=0.02, x0=_EIGHT_X0, x_goal=_EIGHT_XS,
        dmin=0.25, collision=True,
    ),
    Scenario(
        name="ten_robot", family="E",
        source="AllScripts/mpc_online_casadi_tb3_ten_multi_centralized_collision_avoidance.py:169-173,389-411",
        m=10, N=20, T=0.1, x0=_TEN_X0, x_goal=_TEN_XS,
        dmin=0.3, collision=True,
        notes="two-row line crossing; start poses reconstructed (Gazebo world not in repo)",
    ),
    Scenario(
        name="decentralized_two_robots", family="E",
        source="AllScripts/decentralized_two_robots.py:80-84,192-201",
        m=2, N=50, T=0.1,
        x0=(-1.0, -1.0, 0.785, 1.0, 1.0, 2.356),
        x_goal=(1.0, 1.0, 0.785, -1.0, -1.0, -2.356),
        dmin=0.25, collision=True,
    ),
    # ----- family F: paper simulation scenarios 1-6 -----
    Scenario(
        name="first_scenario", family="F",
        source="AllScripts/first_scenario.py:58-59,173-185",
        m=1, N=100, T=0.05, x0=(0, 0, 0), waypoints=_TOUR_WAYPOINTS,
    ),
    Scenario(
        name="second_scenario", family="F",
        source="AllScripts/second_scenario.py:80-84,193-202",
        m=2, N=50, T=0.1,
        x0=(-1.0, -1.0, 0.785, 1.0, 1.0, 2.356),
        x_goal=(1.0, 1.0, 0.785, -1.0, -1.0, -2.356),
        dmin=0.25, collision=True,
    ),
    Scenario(
        name="third_scenario", family="F",
        source="AllScripts/third_scenario.py:92-96,219-230",
        m=3, N=50, T=0.05,
        x0=(-1, -1, 1.57, 0, -1, 1.57, 1, -1, 1.57),
        x_goal=(2, 2, 0, 2, 1, 0, 2, 0, 0),
        dmin=0.3, collision=True,
        notes="horizontal line -> vertical column",
    ),
    Scenario(
        name="fourth_scenario", family="F",
        source="AllScripts/fourth_scenario.py:104-108,242-254",
        m=4, N=50, T=0.1,
        x0=(-1, 1, -0.785, 1, 1, -2.356, -1, -1, 0.785, 1, -1, 2.356),
        x_goal=(1, -1, -0.785, -1, -1, -2.356, 1, 1, 0.785, -1, 1, 2.356),
        dmin=0.3, collision=True,
        notes="square corners, antipodal swap",
    ),
    Scenario(
        name="fifth_scenario", family="F",
        source="AllScripts/fifth_scenario.py:115-119,255-269",
        m=5, N=35, T=0.1,
        x0=(-0.5, 1, 0, -1, 0.5, 0, -1.5, 0, 0, -1, -0.5, 0, -0.5, -1, 0),
        x_goal=(0.5, -1, 0, 1, -0.5, 0, 1.5, 0, 0, 1, 0.5, 0, 0.5, 1, 0),
        dmin=0.3, collision=True,
        notes="left arc -> mirrored right arc",
    ),
    Scenario(
        name="sixth_scenario", family="F",
        source="AllScripts/sixth_scenario.py:127-131",
        m=6, N=35, T=0.3, x0=_SIX_X0, x_goal=_SIX_XS,
        dmin=0.3, collision=True,
        notes="six_robot_antipodal with T=0.3",
    ),
    # ----- family G: real-hardware implementations -----
    Scenario(
        name="one_robot_impl", family="G",
        source="AllScripts/centralized_one_robots_implementation.py:58-59,176-187",
        m=1, N=100, T=0.05, x0=(0, 0, 0), waypoints=_LAB_WAYPOINTS,
    ),
    Scenario(
        name="two_robot_impl", family="G",
        source="AllScripts/centralized_two_robots_implementation.py:101-105,213-224",
        m=2, N=70, T=0.05,
        x0=(-0.7112, -0.7112, 0.785, 0.7112, 0.7112, -2.356),
        x_goal=(0.7112, 0.7112, 0.785, -0.7112, -0.7112, -2.356),
        dmin=0.15, collision=True,
    ),
    Scenario(
        name="three_robot_impl", family="G",
        source="AllScripts/centralized_three_robots_implementation.py:127-131,254-269",
        m=3, N=60, T=0.05,
        x0=(0, -0.7112, 1.57, -0.5588, -0.7112, 1.57, -1.176, -0.7112, 1.57),
        x_goal=(1.176, -0.3556, 0, 1.176, 0, 0, 1.176, 0.3556, 0),
        dmin=0.15, collision=True,
    ),
    Scenario(
        name="four_robot_impl", family="G",
        source="AllScripts/centralized_four_robots_implementation.py:150-154,288-304",
        m=4, N=45, T=0.1,
        x0=(-0.7112, 0.7112, -0.785, 0.7112, 0.7112, -2.356,
            -0.7112, -0.7112, 0.785, 0.7112, -0.7112, 2.356),
        x_goal=(0.7112, -0.7112, -0.785, -0.7112, -0.7112, -2.356,
                0.7112, 0.7112, 0.785, -0.7112, 0.7112, 2.356),
        dmin=0.4, collision=True,
    ),
    Scenario(
        name="five_robot_impl", family="G",
        source="AllScripts/centralized_five_robots_implementation.py:174-178,315-335",
        m=5, N=40, T=0.1,
        x0=(0, 0.7112, 0, -0.2794, 0.3556, 0, -0.5588, 0, 0,
            -0.2794, -0.3556, 0, 0, -0.7112, 0),
        x_goal=(0.5588, -0.7112, 0, 0.8382, -0.3556, 0, 1.176, 0, 0,
                0.8382, 0.3556, 0, 0.5588, 0.7112, 0),
        dmin=0.4, collision=True,
    ),
    Scenario(
        name="six_robot_impl", family="G",
        source="AllScripts/centralized_six_robots_implementation.py:197-205,364-388",
        m=6, N=35, T=0.3,
        x0=(0.7, 0.4, -2.618, 0, 0.8, -1.57, -0.7, 0.4, -0.523,
            -0.7, -0.4, 0.523, 0, -0.8, 1.57, 0.7, -0.4, 2.618),
        x_goal=(-0.7, -0.4, -2.618, 0, -0.8, -1.57, 0.7, -0.4, -0.523,
                0.7, 0.4, 0.523, 0, 0.8, 1.57, -0.7, 0.4, 2.618),
        dmin=0.4, collision=True, v_max=0.15, omega_max=1.5,
        notes="reduced actuator limits on the real TB3s",
    ),
    # ----- family H: static-obstacle avoidance (known map) -----
    Scenario(
        name="obstacle_scenario_1", family="H",
        source="AllScripts/first_scenario_mpc_obstacle_avoidance.py:58-63,96-99,197-208",
        m=1, N=100, T=0.1, x0=(0, 0, 0), waypoints=_OBS1_WAYPOINTS,
        obstacles=((0.4, 1.1, 0.15),), robot_radius=0.15, obs_margin=0.05,
        omega_max=_PI / 4, theta_bound=2 * _PI,
    ),
    Scenario(
        name="obstacle_scenario_2", family="H",
        source="AllScripts/second_scenario_mpc_obstacle_avoidance.py:58-60,97-111,211-221",
        m=1, N=100, T=0.1, x0=(0, 0, 0), waypoints=_OBS2_WAYPOINTS,
        obstacles=((1.0, 0.5, 0.15), (-0.75, 0.0, 0.125),
                   (0.0, -1.25, 0.15), (0.0, 1.0, 0.125)),
        robot_radius=0.15, obs_margin=0.05, omega_max=_PI / 4, theta_bound=2 * _PI,
    ),
    Scenario(
        name="obstacle_scenario_3", family="H",
        source="AllScripts/third_scenario_mpc_obstacle_avoidance.py:58-60,97-119,222-233",
        m=1, N=100, T=0.2, x0=(0, 0, 0), waypoints=_OBS3_WAYPOINTS,
        obstacles=((-0.6, 3.3, 0.2), (0.6, 3.3, 0.125), (0.0, 2.3, 0.15),
                   (1.0, 2.3, 0.15), (-0.6, 1.3, 0.2), (0.6, 1.3, 0.175)),
        robot_radius=0.2, obs_margin=0.05, omega_max=_PI / 4, theta_bound=2 * _PI,
        notes="slalom corridor",
    ),
    Scenario(
        name="decentralized_first_scenario", family="F",
        source="AllScripts/decentralized_first_scenario.py:94-95,249-260",
        m=1, N=200, T=0.05, x0=(0, 0, 0), waypoints=_TOUR_WAYPOINTS,
        robot_radius=0.15,
        notes="single-robot waypoint tour, longest reference horizon (N=200); "
              "the script's LiDAR use is passive min-distance monitoring "
              "(its gradient-correction code is commented out :67-80)",
    ),
    # ----- family I: LiDAR-augmented NMPC -----
    Scenario(
        name="lidar_v2", family="I",
        source="AllScripts/obs_avoid_static_first_scenario_v2.py:51-58,89,138-143,177,251-253",
        m=1, N=100, T=0.05, x0=(0, 0, 0),
        waypoints=((1.0, 0.5, 0.0), (0.0, 0.75, -1.57)),
        num_rays=10,
        robot_radius=0.2, v_max=0.22, omega_max=2.84,
        notes="v2 semantics: ray distances as a separate decision matrix "
              "D [numRays, N+1] with its own 1-norm equality dynamics and "
              "bound D >= robot_radius (:89,138-143,177), no 1/d cost, no Nc "
              "blocking. The multiple-shooting D-matrix form and the "
              "augmented-state form are the SAME transcription (identical "
              "equality rows, identical bounds, D carries no cost), so this "
              "runs on the augmented model with inv_dist_weight=0 and full "
              "control horizon — only the constants differ from v3",
    ),
    Scenario(
        name="lidar_v3", family="I",
        source="AllScripts/obs_avoid_static_first_scenario_v3.py:55-67,109-133",
        m=1, N=125, T=0.075, x0=(0, 0, 0),
        waypoints=((1.0, 0.5, 0.0), (0.0, 0.0, 0.0)),
        num_rays=10,
        robot_radius=0.15, v_max=0.15, omega_max=1.5,
        notes="augmented state [x,y,th,d_1..d_10]; full control horizon "
              "(no Nc blocking), no 1/d proximity cost — the v3 semantics; "
              "runs on the AL-iLQR engine via closed_loop_lidar(solve_fn=...)",
    ),
    Scenario(
        name="lidar_v4", family="I",
        source="AllScripts/obs_avoid_static_first_scenario_v4.py:59-75,123-136",
        m=1, N=100, T=0.075, x0=(0, 0, 0),
        waypoints=((1.0, 0.5, 0.0), (0.0, 0.0, 0.0)),
        Nc=50, num_rays=10, inv_dist_weight=0.1,
        robot_radius=0.15, v_max=0.15, omega_max=1.5,
        notes="augmented state [x,y,th,d_1..d_10]; Nc move blocking; 1/d cost",
    ),
]

REGISTRY: dict[str, Scenario] = {s.name: s for s in _SCENARIOS}


def get(name: str) -> Scenario:
    return REGISTRY[name]
