"""Unicycle (differential-drive) kinematics, single robot and m-robot stacked.

Port of nmpc_tpu/models/unicycle.py. State [x1, y1, th1, ..., xm, ym, thm],
control [v1, w1, ..., vm, wm]; every function takes any number of leading
batch dimensions.
"""

from __future__ import annotations

import torch


def _rhs(th: torch.Tensor, v: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """[v cos th, v sin th, w] stacked on a new last axis."""
    vc = v * torch.cos(th)
    return torch.stack([vc, v * torch.sin(th), w.expand(vc.shape)], dim=-1)


def unicycle_rhs(x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Continuous-time RHS for one unicycle. x=[px,py,th], u=[v,w]."""
    return _rhs(x[..., 2], u[..., 0], u[..., 1])


def stacked_unicycle_rhs(x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """RHS for m stacked unicycles. x: [..., 3m], u: [..., 2m]; strided views
    of the headings and controls, no copy of x or u."""
    rhs = _rhs(x[..., 2::3], u[..., 0::2], u[..., 1::2])
    return rhs.reshape(*rhs.shape[:-2], x.shape[-1])


def euler_step(x: torch.Tensor, u: torch.Tensor, dt) -> torch.Tensor:
    """Explicit Euler: the reference's transcription integrator."""
    return x + dt * stacked_unicycle_rhs(x, u)


def rk4_step(x: torch.Tensor, u: torch.Tensor, dt) -> torch.Tensor:
    """Classic RK4 with zero-order-hold control."""
    f = stacked_unicycle_rhs
    k1 = f(x, u)
    k2 = f(x + 0.5 * dt * k1, u)
    k3 = f(x + 0.5 * dt * k2, u)
    k4 = f(x + dt * k3, u)
    return x + (dt / 6.0) * (k1 + 2.0 * k2 + 2.0 * k3 + k4)


def discrete_dynamics(x: torch.Tensor, u: torch.Tensor, dt,
                      integrator: str = "euler") -> torch.Tensor:
    if integrator == "euler":
        return euler_step(x, u, dt)
    if integrator == "rk4":
        return rk4_step(x, u, dt)
    raise ValueError(f"unknown integrator {integrator!r}")


def euler_jacobians(x: torch.Tensor, u: torch.Tensor, dt):
    """Analytic (A, B) of the Euler map for m stacked unicycles.

    A = d x_{k+1} / d x_k : [..., 3m, 3m] (block-diagonal, 3x3 blocks)
    B = d x_{k+1} / d u_k : [..., 3m, 2m] (block-diagonal, 3x2 blocks)
    """
    m = x.shape[-1] // 3
    lead = x.shape[:-1]
    th = x[..., 2::3]
    v = u[..., 0::2]
    s, c = torch.sin(th), torch.cos(th)
    r = torch.arange(m, device=x.device)
    A = torch.zeros(*lead, 3 * m, 3 * m, dtype=x.dtype, device=x.device)
    B = torch.zeros(*lead, 3 * m, 2 * m, dtype=x.dtype, device=x.device)
    diag = torch.arange(3 * m, device=x.device)
    A[..., diag, diag] = 1.0
    A[..., 3 * r, 3 * r + 2] = -dt * v * s
    A[..., 3 * r + 1, 3 * r + 2] = dt * v * c
    B[..., 3 * r, 2 * r] = dt * c
    B[..., 3 * r + 1, 2 * r] = dt * s
    B[..., 3 * r + 2, 2 * r + 1] = dt * torch.ones_like(th)
    return A, B
