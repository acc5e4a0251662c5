"""SE(2) frame alignment for real-robot odometry. Port of
nmpc_tpu/sim/frames.py.

Each physical TurtleBot3 reports odometry in its own power-on frame; the
reference aligns them to the lab frame per robot with
  P_global = R_z(theta_init) @ P_local + p_init,   phi = theta + theta_init
and recovers yaw from the quaternion z-component as theta = 2*arcsin(q_z).
"""

from __future__ import annotations

import math

import torch


def yaw_from_quat_z(qz, qw=None):
    """Reference convention: theta = 2 * arcsin(q_z) (valid for planar poses)."""
    return 2.0 * torch.arcsin(torch.as_tensor(qz))


def se2_local_to_global(pose_local, frame_origin):
    """pose_local, frame_origin: [..., 3] (x, y, theta). Returns global pose."""
    x, y, th = pose_local[..., 0], pose_local[..., 1], pose_local[..., 2]
    x0, y0, th0 = frame_origin[..., 0], frame_origin[..., 1], frame_origin[..., 2]
    c, s = torch.cos(th0), torch.sin(th0)
    return torch.stack([x0 + c * x - s * y, y0 + s * x + c * y, th + th0], dim=-1)


def se2_global_to_local(pose_global, frame_origin):
    x, y, th = pose_global[..., 0], pose_global[..., 1], pose_global[..., 2]
    x0, y0, th0 = frame_origin[..., 0], frame_origin[..., 1], frame_origin[..., 2]
    dx, dy = x - x0, y - y0
    c, s = torch.cos(th0), torch.sin(th0)
    return torch.stack([c * dx + s * dy, -s * dx + c * dy, th - th0], dim=-1)


def wrap_to_2pi(theta):
    """Yaw wrap to [0, 2pi) (the reference scripts' `modify()`); floor
    modulo, as jnp.mod."""
    return torch.remainder(theta, 2.0 * math.pi)
