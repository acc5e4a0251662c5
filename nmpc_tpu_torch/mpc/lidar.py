"""LiDAR-augmented closed-loop MPC, family I (v4 semantics). Port of
nmpc_tpu/mpc/lidar.py.

Per step, with the simulated scan in place of the robot's /scan:
  scan <- raycast(pose)                    x0   <- [pose; scan]
  pObs <- Rz(th) (scan_j e(B0_j)) + p      (the rays' points, frozen)
  solve the augmented-state OCP (condensed GN with Nc move blocking by
  default), apply u*[0], advance the plant.
The augmented dynamics, the d >= robot_radius bounds and the (1/d)' L (1/d)
cost live in the OCP (ocp/problem.py).

The reference's `lax.scan` over steps is a Python loop here with the same
fixed-length histories; as mpc/driver.py's loops, it stops solving once a
step ends done with its carry bit for bit unchanged (every later step would
repeat it) and copies that step's row into the rows left.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from nmpc_tpu_torch.mpc.driver import _repeats
from nmpc_tpu_torch.ocp.problem import OCP
from nmpc_tpu_torch.sim.lidar import obstacle_points, ray_angles, raycast  # noqa: F401
from nmpc_tpu_torch.sim.plant import PlantConfig, plant_step
from nmpc_tpu_torch.solver import gn
from nmpc_tpu_torch.solver.alilqr import WarmStart


def closed_loop_lidar(
    ocp: OCP,                     # LiDAR-augmented template (num_rays > 0)
    sim_obstacles: torch.Tensor,  # [n, 3] ground-truth circles for the raycaster
    waypoints: torch.Tensor,      # [G, 3] pose goals
    cfg: gn.GNConfig = gn.GNConfig(Nc=50, normal="dense"),
    max_steps: int = 300,
    advance_tol: float = 0.1,
    scan_max: float = 3.5,
    plant: PlantConfig = PlantConfig(),
    solve_fn=None,
):
    """Returns (X_hist [S+1, 3] poses, U_hist [S, 2], min_clearance [S],
    goal_idx_hist [S] int32, reached).

    solve_fn(ocp, warm) overrides the NLP engine. Default is the condensed
    GN solver with cfg's Nc move blocking (v4 semantics); for v2/v3
    semantics (full control horizon) pass the AL-iLQR engine, e.g.
    solve_fn=lambda o, w: alilqr.solve(o, w, ALILQRConfig(...)). Warm start
    each step: the solution's controls shifted one stage, the multipliers
    cold and mu at cfg.mu_init (the scan-dependent constraints change every
    step, so carried multipliers misprice the new active set)."""
    dev, dtype = ocp.device, ocp.x0.dtype
    R, N = ocp.num_rays, ocp.N
    angles = ray_angles(R, dtype, dev)
    sim_obstacles = torch.as_tensor(sim_obstacles, dtype=dtype, device=dev)
    waypoints = torch.as_tensor(waypoints, dtype=dtype, device=dev)
    G = waypoints.shape[0]
    solve_fn = solve_fn or functools.partial(gn.solve, cfg=cfg)
    mu0 = torch.tensor(cfg.mu_init, dtype=dtype, device=dev)

    def goal_at(gidx):
        return waypoints[torch.clamp(gidx, max=G - 1).long()]

    def step(carry):
        pose, w, done, gidx = carry
        err = torch.linalg.norm(pose - goal_at(gidx))
        advance = (err < advance_tol) & (~done)
        gidx = gidx + advance.to(torch.int32)
        done = done | (gidx >= G)
        goal = goal_at(gidx)
        scan = raycast(pose, sim_obstacles, angles, scan_max)
        goal_aug = torch.cat([goal, goal.new_zeros(R)])
        ocp_k = dataclasses.replace(ocp, x0=torch.cat([pose, scan]),
                                    xref=goal_aug[None].repeat(N, 1),
                                    p_obs=obstacle_points(pose, scan, angles))
        res = solve_fn(ocp_k, w)
        u0 = torch.where(done, 0.0, res.U[0])
        pose_next_full, _ = plant_step(pose, u0, ocp.T, plant)
        pose_next = torch.where(done, pose, pose_next_full)
        w_next = WarmStart(U=torch.cat([res.U[1:], res.U[-1:]]),
                           lam=torch.zeros_like(res.lam), mu=mu0)
        w_next = WarmStart(*(torch.where(done, a, b) for a, b in
                             zip((w.U, w.lam, w.mu), (w_next.U, w_next.lam, w_next.mu))))
        # true clearance to the nearest obstacle surface
        dc = torch.sqrt(torch.sum((pose_next[:2][None] - sim_obstacles[:, :2]) ** 2, dim=-1))
        clearance = torch.amin(dc - sim_obstacles[:, 2])
        return (pose_next, w_next, done, gidx), (pose_next, u0, clearance, gidx)

    w0 = WarmStart(U=torch.zeros((N, 2), dtype=dtype, device=dev),
                   lam=torch.zeros((N, ocp.n_con), dtype=dtype, device=dev), mu=mu0)
    pose0 = ocp.x0[:3]
    carry = (pose0, w0, torch.zeros((), dtype=torch.bool, device=dev),
             torch.zeros((), dtype=torch.int32, device=dev))
    rows = []
    for k in range(max_steps):
        new, out = step(carry)
        rows.append(out)
        stop = k + 1 < max_steps and _repeats(carry, new, 2)
        carry = new
        if stop:
            rows.extend([out] * (max_steps - len(rows)))
            break
    X_t, U_t, clr_t, gidx_t = (torch.stack(list(col)) for col in zip(*rows))
    return torch.cat([pose0[None], X_t]), U_t, clr_t, gidx_t, carry[2]
