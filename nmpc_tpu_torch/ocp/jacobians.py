"""Analytic constraint Jacobians. Port of nmpc_tpu/ocp/jacobians.py.

Every inequality row of `stage_constraints` has closed-form derivatives with
a static sparsity pattern:

  pair row (i, j):  d2 = |pi - pj|^2        dJ/dpi = 2(pi - pj), anti-sym
  obstacle row:     c  = |pi - po| - r - m  dJ/dpi = (pi - po)/|pi - po|
  moving row:       c  = |pi - qk|^2 - d2   dJ/dpi = 2(pi - qk)
  box rows:         +/- identity

Applies to every model without LiDAR rays.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from nmpc_tpu_torch.ocp.problem import OCP, pair_indices


@functools.lru_cache(maxsize=None)
def _incidence(m: int, nx: int, n_obs: int, n_mov: int):
    """Static incidence matrices (numpy), cached per problem class."""
    P = m * (m - 1) // 2
    Ax = np.zeros((P, nx), np.float32)
    Ay = np.zeros((P, nx), np.float32)
    for p, (i, j) in enumerate(zip(*pair_indices(m))):
        Ax[p, 3 * i] = 1.0
        Ax[p, 3 * j] = -1.0
        Ay[p, 3 * i + 1] = 1.0
        Ay[p, 3 * j + 1] = -1.0
    Ox = np.zeros((m * n_obs, nx), np.float32)
    Oy = np.zeros((m * n_obs, nx), np.float32)
    for i in range(m):
        for o in range(n_obs):
            Ox[i * n_obs + o, 3 * i] = 1.0
            Oy[i * n_obs + o, 3 * i + 1] = 1.0
    Mx = np.zeros((m * n_mov, nx), np.float32)
    My = np.zeros((m * n_mov, nx), np.float32)
    for i in range(m):
        for o in range(n_mov):
            Mx[i * n_mov + o, 3 * i] = 1.0
            My[i * n_mov + o, 3 * i + 1] = 1.0
    return Ax, Ay, Ox, Oy, Mx, My


def stage_constraint_jacobians(ocp: OCP, x: torch.Tensor, mov_k=None):
    """(Jx [..., n_con, nx], Ju [n_con, nu]) of stage_constraints at x.
    Only state-dependent rows depend on x; box rows are constants, so Ju
    carries no batch dimensions."""
    assert ocp.num_rays == 0, "LiDAR-augmented model has no analytic Jacobian"
    m, nx, nu = ocp.m, ocp.nx, ocp.nu
    lead = x.shape[:-1]
    kw = dict(dtype=x.dtype, device=x.device)
    Ax, Ay, Ox, Oy, Mx, My = (
        torch.as_tensor(a, **kw) for a in _incidence(m, nx, ocp.n_obs, ocp.n_mov)
    )
    pos = x[..., : 3 * m].reshape(*lead, m, 3)[..., :2]
    blocks = []
    if ocp.n_pairs:
        ii, jj = pair_indices(m)
        diff = pos[..., list(ii), :] - pos[..., list(jj), :]       # [..., P, 2]
        blocks.append(2.0 * (diff[..., 0:1] * Ax + diff[..., 1:2] * Ay))
    if ocp.n_obs:
        delta = pos[..., :, None, :] - ocp.obstacles[:, :2]      # [..., m, n_obs, 2]
        dist = torch.sqrt(torch.clamp(torch.sum(delta * delta, -1), min=1e-12))
        unit = (delta / dist[..., None]).reshape(*lead, m * ocp.n_obs, 2)
        blocks.append(unit[..., 0:1] * Ox + unit[..., 1:2] * Oy)
    if ocp.n_mov:
        mov_k = ocp.mov_obs[..., 0, :, :] if mov_k is None else mov_k
        delta = (pos[..., :, None, :] - mov_k[..., None, :, :]).reshape(
            *lead, m * ocp.n_mov, 2)
        blocks.append(2.0 * (delta[..., 0:1] * Mx + delta[..., 1:2] * My))
    eye_x = torch.eye(nx, **kw)
    fixed = torch.cat([torch.zeros((2 * nu, nx), **kw), eye_x, -eye_x], dim=0)
    Jx = torch.cat(blocks + [fixed.expand(*lead, *fixed.shape)], dim=-2)

    n_state_rows = ocp.n_pairs + m * ocp.n_obs + m * ocp.n_mov
    eye_u = torch.eye(nu, **kw)
    Ju = torch.cat([
        torch.zeros((n_state_rows, nu), **kw), eye_u, -eye_u,
        torch.zeros((2 * nx, nu), **kw),
    ], dim=0)
    return Jx, Ju
