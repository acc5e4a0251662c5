"""Real-robot host driver, the family-G hardware path. Port of
nmpc_tpu/io/robot.py on the port's sim/frames.py.

The hardware loop on the native runtime instead of rospy:
  * per-robot odometry arrives on the UDP bus as [x, y, theta] in the
    robot's power-on frame and is aligned to the lab frame with the
    per-robot SE(2) transform;
  * the joint measurement is latched race-free immediately before each
    solve;
  * the first optimal (v, omega) per robot is sent as a cmd topic;
  * pacing uses the drift-free monotonic Rate.

Topic convention: topic id r        = odom of robot r   (3 doubles)
                  topic id 100 + r  = cmd_vel of robot r (2 doubles)
"""

from __future__ import annotations

import numpy as np
import torch

from nmpc_tpu_torch.io.bridge import Bus, Rate, UdpPublisher
from nmpc_tpu_torch.sim.frames import se2_local_to_global

CMD_BASE = 100


class RobotBridge:
    def __init__(self, m: int, bus: Bus, cmd_pub: UdpPublisher | None = None,
                 frame_origins: np.ndarray | None = None):
        self.m = m
        self.bus = bus
        self.cmd_pub = cmd_pub
        self.frame_origins = (np.zeros((m, 3)) if frame_origins is None
                              else np.asarray(frame_origins, dtype=np.float64))

    def latch_joint_state(self, default: np.ndarray) -> np.ndarray:
        """Race-free latch of all robots' poses, aligned to the lab frame.
        Robots that have not reported yet keep their `default` slice."""
        x = np.array(default, dtype=np.float64).reshape(self.m, 3).copy()
        for r in range(self.m):
            pose, _ = self.bus.latch(r, 3)
            if pose is not None:
                x[r] = se2_local_to_global(torch.from_numpy(pose),
                                           torch.from_numpy(self.frame_origins[r])).numpy()
        return x.reshape(-1)

    def send_commands(self, u_joint) -> None:
        u = np.asarray(u_joint, dtype=np.float64).reshape(self.m, 2)
        for r in range(self.m):
            self.bus.publish(CMD_BASE + r, u[r])
            if self.cmd_pub is not None:
                self.cmd_pub.send(CMD_BASE + r, u[r])

    def stop_all(self) -> None:
        self.send_commands(np.zeros(2 * self.m))


def run_realtime(solve_step, bridge: RobotBridge, x0: np.ndarray, period_s: float,
                 max_steps: int, goal: np.ndarray | None = None, stop_tol: float = 1e-1):
    """Host-side receding-horizon loop against real robots: each period
    latch the joint measurement, solve (solve_step(x_joint [3m]) -> u_joint
    [2m], the solve on the device), send the first controls, and sleep to
    the next deadline. Returns (states [S, 3m], commands [S, 2m], missed
    deadlines)."""
    rate = Rate(period_s)
    xs, us = [], []
    missed = 0
    x = np.asarray(x0, dtype=np.float64)
    try:
        for _ in range(max_steps):
            x = bridge.latch_joint_state(x)
            if goal is not None and np.linalg.norm(x - goal) <= stop_tol:
                break
            u = solve_step(x)
            u = (u.detach().cpu().numpy() if isinstance(u, torch.Tensor)
                 else np.asarray(u)).reshape(-1)
            bridge.send_commands(u)
            xs.append(x.copy())
            us.append(u.copy())
            missed = rate.sleep()
    finally:
        bridge.stop_all()
        rate.close()
    return np.asarray(xs), np.asarray(us), missed
