"""Planar LiDAR simulator: ray-circle intersection ranges. Port of
nmpc_tpu/sim/lidar.py.

Stands in for the TurtleBot3 LDS that feeds /scan in the reference: numRays
rays at body-frame angles B0[j] = 2 pi j / numRays, ranges capped at
scan_max = 3.5 m (the reference maps Inf returns to 3.5). Vectorized over
rays x obstacles; `pose` may carry leading batch dimensions, and so may
`obstacles` (a field a pose: [B, n, 3] against pose [B, 3]), row for row
the one-pose call.
"""

from __future__ import annotations

import math

import torch


def ray_angles(num_rays: int, dtype=torch.float32, device=None):
    """Body-frame ray directions B0[j] = 2 pi j / numRays."""
    return (2.0 * math.pi / num_rays) * torch.arange(num_rays, dtype=dtype, device=device)


def raycast(pose, obstacles, angles, scan_max=3.5):
    """Ranges from `pose` [..., 3] along body angles [R] against circles
    [..., n, 3] (one field for every pose, or one a pose) -> [..., R].

    Solves |o + t d - c|^2 = r^2 per ray/obstacle; returns the smallest
    positive hit distance, capped at scan_max."""
    world = pose[..., 2, None] + angles                                   # [..., R]
    d = torch.stack([torch.cos(world), torch.sin(world)], dim=-1)        # [..., R, 2]
    oc = obstacles[..., :2] - pose[..., None, :2]                        # [..., n, 2]
    b = torch.sum(d[..., :, None, :] * oc[..., None, :, :], dim=-1)      # [..., R, n]
    cc = torch.sum(oc * oc, dim=-1) - obstacles[..., 2] ** 2             # [..., n]
    disc = b * b - cc[..., None, :]
    t = b - torch.sqrt(torch.clamp(disc, min=0.0))
    t = torch.where((disc >= 0.0) & (t > 0.0), t, math.inf)
    if obstacles.shape[-2]:
        rng = torch.amin(t, dim=-1)
    else:
        rng = torch.full(world.shape, math.inf, dtype=world.dtype, device=world.device)
    return torch.clamp(rng, max=scan_max)


def obstacle_points(pose, scan, angles):
    """Frozen obstacle points pObs[j] = Rz(th) (scan_j e(B0_j)) + p: the ray
    endpoints in the world frame. pose [..., 3], scan [..., R] -> [..., R, 2]."""
    world = pose[..., 2, None] + angles
    return pose[..., None, :2] + scan[..., None] * torch.stack(
        [torch.cos(world), torch.sin(world)], dim=-1)
