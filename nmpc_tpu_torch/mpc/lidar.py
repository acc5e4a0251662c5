"""LiDAR-augmented closed-loop MPC, family I (v4 semantics). Port of
nmpc_tpu/mpc/lidar.py.

Per step, with the simulated scan in place of the robot's /scan:
  scan <- raycast(pose)                    x0   <- [pose; scan]
  pObs <- Rz(th) (scan_j e(B0_j)) + p      (the rays' points, frozen)
  solve the augmented-state OCP (condensed GN with Nc move blocking by
  default), apply u*[0], advance the plant.
The augmented dynamics, the d >= robot_radius bounds and the (1/d)' L (1/d)
cost live in the OCP (ocp/problem.py).

The loop body is `closed_loop_lidar_batched`, the port of
`jax.vmap(closed_loop_lidar)` over B fields and tours (the reference's
LiDAR fuzz, tests/test_lidar_fuzz.py:80-88): each row steps as the
reference's single form does, and one `gn.solve_batched` a step solves
every row's problem, each with its own frozen points (p_obs [B, R, 2]).
`closed_loop_lidar` is that loop at B = 1. The reference's `lax.scan` over
steps is a Python loop here with the same fixed-length histories; as
mpc/driver.py's loops, it stops solving once a step ends done (every row)
with its carry bit for bit unchanged (every later step would repeat it)
and copies that step's row into the rows left.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from nmpc_tpu_torch.mpc.driver import _repeats
from nmpc_tpu_torch.ocp.problem import OCP, batch_fields
from nmpc_tpu_torch.sim.lidar import obstacle_points, ray_angles, raycast  # noqa: F401
from nmpc_tpu_torch.sim.plant import PlantConfig, plant_step
from nmpc_tpu_torch.solver import gn
from nmpc_tpu_torch.solver.alilqr import SolveResult, WarmStart


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
    step, so carried multipliers misprice the new active set).

    This is closed_loop_lidar_batched at B = 1, each output's batch axis
    dropped; solve_fn sees one unbatched problem."""
    dev, dtype = ocp.device, ocp.x0.dtype
    out = closed_loop_lidar_batched(
        ocp, torch.as_tensor(sim_obstacles, dtype=dtype, device=dev)[None],
        torch.as_tensor(waypoints, dtype=dtype, device=dev)[None], cfg, max_steps, advance_tol,
        scan_max, plant, None if solve_fn is None else functools.partial(_one_row, solve_fn))
    return tuple(a[0] for a in out)


def _one_row(solve_fn, ocp_b: OCP, warm_b: WarmStart) -> SolveResult:
    """solve_fn(ocp, warm) of one unbatched problem, on a batch of one: the
    batch axis taken off the OCP's batch fields and the warm start, and put
    back on every field of the result."""
    ocp = dataclasses.replace(ocp_b, **{k: getattr(ocp_b, k)[0] for k in batch_fields(ocp_b)})
    res = solve_fn(ocp, WarmStart(warm_b.U[0], warm_b.lam[0], warm_b.mu[0]))
    return SolveResult(**{f.name: getattr(res, f.name)[None] for f in dataclasses.fields(res)})


def closed_loop_lidar_batched(
    ocp: OCP,                     # LiDAR-augmented template (num_rays > 0)
    sim_obstacles: torch.Tensor,  # [B, n, 3] each row's ground-truth circles
    waypoints: torch.Tensor,      # [B, G, 3] each row's pose goals
    cfg: gn.GNConfig = gn.GNConfig(Nc=50, normal="dense"),
    max_steps: int = 300,
    advance_tol: float = 0.1,
    scan_max: float = 3.5,
    plant: PlantConfig = PlantConfig(),
    solve_fn=None,
):
    """closed_loop_lidar over B rows at once, the port of
    `jax.vmap(closed_loop_lidar)` over (sim_obstacles, waypoints): every row
    starts from the template's pose (x0 [nx]; or its own, x0 [B, nx]).
    Returns (X_hist [B, S+1, 3], U_hist [B, S, 2], min_clearance [B, S],
    goal_idx_hist [B, S] int32, reached [B]).

    A step follows the single form's order on each row (advance the goal,
    set done, raycast the row's field, freeze the row's points), then
    solves all B problems in one call: solve_fn(ocp_b, warm_b) on the
    batched OCP (x0 [B, nx], xref [B, N, nx], p_obs [B, R, 2]) and
    WarmStart [B, ...], by default gn.solve_batched at cfg. A done row
    keeps its pose and warm start; the others take the shifted controls,
    cold multipliers and mu = cfg.mu_init. The loop stops solving once
    every row's carry repeats and copies the last step's row into the rows
    left, as the single form does."""
    dev, dtype = ocp.device, ocp.x0.dtype
    R, N = ocp.num_rays, ocp.N
    angles = ray_angles(R, dtype, dev)
    sim_obstacles = torch.as_tensor(sim_obstacles, dtype=dtype, device=dev)
    waypoints = torch.as_tensor(waypoints, dtype=dtype, device=dev)
    B, G = waypoints.shape[:2]
    rows = torch.arange(B, device=dev)
    solve_fn = solve_fn or functools.partial(gn.solve_batched, cfg=cfg)
    mu0 = torch.full((B,), cfg.mu_init, dtype=dtype, device=dev)

    def goal_at(gidx):
        return waypoints[rows, torch.clamp(gidx, max=G - 1).long()]

    def step(carry):
        pose, w, done, gidx = carry
        err = torch.linalg.norm(pose - goal_at(gidx), dim=-1)
        advance = (err < advance_tol) & (~done)
        gidx = gidx + advance.to(torch.int32)
        done = done | (gidx >= G)
        goal = goal_at(gidx)
        scan = raycast(pose, sim_obstacles, angles, scan_max)             # [B, R]
        goal_aug = torch.cat([goal, goal.new_zeros(B, R)], dim=-1)
        ocp_k = dataclasses.replace(ocp, x0=torch.cat([pose, scan], dim=-1),
                                    xref=goal_aug[:, None].repeat(1, N, 1),
                                    p_obs=obstacle_points(pose, scan, angles))
        res = solve_fn(ocp_k, w)
        u0 = torch.where(done[:, None], 0.0, res.U[:, 0])
        pose_next_full, _ = plant_step(pose, u0, ocp.T, plant)
        pose_next = torch.where(done[:, None], pose, pose_next_full)
        w_next = WarmStart(U=torch.cat([res.U[:, 1:], res.U[:, -1:]], dim=1),
                           lam=torch.zeros_like(res.lam), mu=mu0)
        w_next = WarmStart(*(torch.where(done.reshape(-1, *[1] * (a.dim() - 1)), a, b)
                             for a, b in zip((w.U, w.lam, w.mu),
                                             (w_next.U, w_next.lam, w_next.mu))))
        # true clearance to the nearest obstacle surface of the row's field
        dc = torch.sqrt(torch.sum((pose_next[:, None, :2] - sim_obstacles[..., :2]) ** 2, dim=-1))
        clearance = torch.amin(dc - sim_obstacles[..., 2], dim=-1)
        return (pose_next, w_next, done, gidx), (pose_next, u0, clearance, gidx)

    w0 = WarmStart(U=torch.zeros((B, N, 2), dtype=dtype, device=dev),
                   lam=torch.zeros((B, N, ocp.n_con), dtype=dtype, device=dev), mu=mu0)
    pose0 = ocp.x0[..., :3].expand(B, 3)
    carry = (pose0, w0, torch.zeros(B, dtype=torch.bool, device=dev),
             torch.zeros(B, dtype=torch.int32, device=dev))
    rows_out = []
    for k in range(max_steps):
        new, out = step(carry)
        rows_out.append(out)
        stop = k + 1 < max_steps and _repeats(carry, new, 2)
        carry = new
        if stop:
            rows_out.extend([out] * (max_steps - len(rows_out)))
            break
    X_t, U_t, clr_t, gidx_t = (torch.stack(list(col), dim=1) for col in zip(*rows_out))
    return torch.cat([pose0[:, None], X_t], dim=1), U_t, clr_t, gidx_t, carry[2]
