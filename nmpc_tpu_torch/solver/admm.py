"""Batched dense ADMM QP solver (the OSQP capability). Port of
nmpc_tpu/solver/admm.py, plain PyTorch: the reference has no Pallas kernel
here (its Cholesky and products run outside any kernel), so the
factorization is torch.linalg.cholesky_ex and each iteration's solve
torch.cholesky_solve and matrix products.

    min 0.5 x'Px + q'x  s.t. l <= Ax <= u

OSQP's splitting with a dense KKT matrix factorized once (it depends on P,
A and the per-row penalty only, not on l, u, q: OSQP's `update(l, u)`
property), reused across iterations, batch elements and MPC steps:
  x+ = solve(P + sigma I + A' diag(rho) A, sigma x - q + A'(rho z - y))
  z+ = clip(alpha A x+ + (1 - alpha) z + y / rho, l, u)
  y+ = y + rho (alpha A x+ + (1 - alpha) z - z+)
Equality rows (u - l < 1e-9) get a 1e3x rho (OSQP's constraint-type
scaling); alpha is the over-relaxation.

One implementation serves one QP and many: `_admm` iterates a batch with a
per-element `done` mask, so a finished element's (x, z, y) and iteration
count stay frozen while the others iterate, as `vmap` of the reference's
`lax.while_loop` freezes it; `qp_solve` is that loop at B = 1.
"""

from __future__ import annotations

import dataclasses

import torch

from nmpc_tpu_torch.device import DEVICE

# iterations between the host's reads of "all done" (frozen elements do not
# change, so reading late only costs the finished batch's idle iterations)
DONE_CHECK_EVERY = 8


@dataclasses.dataclass(frozen=True)
class ADMMConfig:
    rho: float = 1.0
    sigma: float = 1e-6
    max_iter: int = 400
    eps_abs: float = 1e-4
    eps_rel: float = 1e-4
    alpha: float = 1.6   # over-relaxation (OSQP default)


@dataclasses.dataclass(frozen=True)
class QPFactor:
    """A factorized QP: shared (chol [n, n], A [rows, n], P [n, n], rho
    [rows]) or per element (a leading [B] on every field)."""

    chol: torch.Tensor  # upper Cholesky factor U of K = P + sigma I + A' diag(rho) A
                        # (K = U'U), as the reference's cho_factor(lower=False)
    A: torch.Tensor
    P: torch.Tensor
    rho: torch.Tensor   # per-row penalty (equality rows boosted)


def qp_setup(P: torch.Tensor, A: torch.Tensor, cfg: ADMMConfig = ADMMConfig(),
             l=None, u=None) -> QPFactor:
    """Factorize once; reuse across solves (OSQP `setup`). If (l, u) are
    given, equality rows (u - l ~ 0) get a 1e3x rho boost. P [..., n, n],
    A [..., rows, n] (a leading batch factorizes each element; l and u
    [..., rows] broadcast against it)."""
    n = P.shape[-1]
    kw = dict(dtype=P.dtype, device=P.device)
    if l is not None and u is not None:
        eq = (torch.as_tensor(u, **kw) - torch.as_tensor(l, **kw)) < 1e-9
        rho = torch.where(eq, 1e3 * cfg.rho, cfg.rho).to(P.dtype)
        rho = rho.expand(*A.shape[:-1])
    else:
        rho = torch.full(A.shape[:-1], cfg.rho, **kw)
    At = A.transpose(-1, -2)
    K = P + cfg.sigma * torch.eye(n, **kw) + At @ (rho[..., :, None] * A)
    chol, _ = torch.linalg.cholesky_ex(K, upper=True)
    return QPFactor(chol=chol, A=A, P=P.expand(*A.shape[:-2], n, n), rho=rho)


def _mv(M, v):
    """M [..., r, c] @ v [B, c] -> [B, r] (M shared or per element)."""
    return (M @ v[..., None])[..., 0]


def _admm(fac: QPFactor, q, l, u, cfg: ADMMConfig, x, y):
    """The ADMM loop over a batch (q [B, n], l and u [B, rows], warm x [B, n]
    and y [B, rows]) with a per-element done mask. Returns (x, y, iters [B]
    int32, done [B] bool, prim [B])."""
    A, At, rho = fac.A, fac.A.transpose(-1, -2), fac.rho
    B = q.shape[0]
    z = torch.minimum(torch.maximum(_mv(A, x), l), u)
    it = torch.zeros(B, dtype=torch.int32, device=q.device)
    done = torch.zeros(B, dtype=torch.bool, device=q.device)
    for i in range(cfg.max_iter):
        if i % DONE_CHECK_EVERY == 0 and bool(done.all()):
            break
        run = ~done
        rhs = cfg.sigma * x - q + _mv(At, rho * z - y)
        x_new = torch.cholesky_solve(rhs[..., None], fac.chol, upper=True)[..., 0]
        Ax = _mv(A, x_new)
        Ax_rel = cfg.alpha * Ax + (1 - cfg.alpha) * z
        z_new = torch.minimum(torch.maximum(Ax_rel + y / rho, l), u)
        y_new = y + rho * (Ax_rel - z_new)
        prim = torch.amax(torch.abs(Ax - z_new), dim=-1)
        dual = torch.amax(torch.abs(_mv(At, rho * (z_new - z))), dim=-1)
        scale_p = torch.maximum(torch.amax(torch.abs(Ax), dim=-1),
                                torch.amax(torch.abs(z_new), dim=-1))
        scale_d = torch.clamp(torch.amax(torch.abs(_mv(fac.P, x_new) + q), dim=-1), min=1.0)
        stop = ((prim <= cfg.eps_abs + cfg.eps_rel * scale_p)
                & (dual <= cfg.eps_abs + cfg.eps_rel * scale_d))
        x = torch.where(run[:, None], x_new, x)
        z = torch.where(run[:, None], z_new, z)
        y = torch.where(run[:, None], y_new, y)
        it = it + run.to(torch.int32)
        done = done | (run & stop)
    Ax = _mv(A, x)
    prim = torch.amax(torch.abs(Ax - torch.minimum(torch.maximum(Ax, l), u)), dim=-1)
    return x, y, it, done, prim


def qp_solve(fac: QPFactor, q, l, u, cfg: ADMMConfig = ADMMConfig(), x0=None, y0=None):
    """Solve min 0.5 x'Px + q'x  s.t. l <= Ax <= u for one QP (q [n], l and
    u [rows]; fac shared). Returns (x, y, iters, converged, prim_res)."""
    kw = dict(dtype=q.dtype, device=q.device)
    x = torch.zeros(fac.A.shape[-1], **kw) if x0 is None else x0
    y = torch.zeros(fac.A.shape[-2], **kw) if y0 is None else y0
    out = _admm(fac, q[None], l[None], u[None], cfg, x[None], y[None])
    return tuple(o[0] for o in out)


# the reference's name for the batched setup: `qp_setup` already takes a
# batched A [B, rows, n] (and P, l, u shared or batched)
qp_setup_batched = qp_setup


def qp_solve_batched(fac: QPFactor, q, l, u, cfg: ADMMConfig = ADMMConfig(), x0=None, y0=None):
    """Fleet entry: solve B QPs in one call. `fac` may be shared (one
    factorization) or per element (from `qp_setup_batched`). q [B, n], l
    and u [B, rows]; optional warm starts [B, ...]. Returns the tuple of
    `qp_solve`, batched; each element's result is its own `qp_solve`'s."""
    B, n, rows = q.shape[0], fac.A.shape[-1], fac.A.shape[-2]
    kw = dict(dtype=q.dtype, device=q.device)
    x = torch.zeros((B, n), **kw) if x0 is None else x0
    y = torch.zeros((B, rows), **kw) if y0 is None else y0
    return _admm(fac, q, l, u, cfg, x, y)


def build_ltv_mpc_qp(Ad, Bd, Qd, Rd, QNd, N, x_lo, x_hi, u_lo, u_hi, device=DEVICE):
    """Assemble the reference's sparse LTV-MPC QP structure densely:
      z = [x_0..x_N; u_0..u_{N-1}],
      P = blkdiag(I_N (x) Q, QN, I_N (x) R),
      equality rows: -x_{k+1} + Ad x_k + Bd u_k = 0 and x_0 = x_init,
      inequality rows: box on every x_k and u_k.
    Returns (P, A, l_template, u_template, pack) where l/u rows [0:nx] hold
    -x_init (updated each MPC step, OSQP `update(l, u)` style). float32 on
    `device`, the card unless the caller asks for another."""
    kw = dict(dtype=torch.float32, device=device)
    Ad, Bd, Qd, Rd, QNd, x_lo, x_hi, u_lo, u_hi = (
        torch.as_tensor(a, **kw) for a in (Ad, Bd, Qd, Rd, QNd, x_lo, x_hi, u_lo, u_hi))
    nx, nu = Bd.shape
    nz = (N + 1) * nx + N * nu
    P = torch.zeros((nz, nz), **kw)
    for k in range(N):
        P[k * nx:(k + 1) * nx, k * nx:(k + 1) * nx] = Qd
    P[N * nx:(N + 1) * nx, N * nx:(N + 1) * nx] = QNd
    off = (N + 1) * nx
    for k in range(N):
        P[off + k * nu:off + (k + 1) * nu, off + k * nu:off + (k + 1) * nu] = Rd

    n_eq = (N + 1) * nx
    A = torch.zeros((n_eq + nz, nz), **kw)
    A[:nx, :nx] = -torch.eye(nx, **kw)   # x_0 = x_init row block
    for k in range(N):
        r = (k + 1) * nx
        A[r:r + nx, k * nx:(k + 1) * nx] = Ad
        A[r:r + nx, (k + 1) * nx:(k + 2) * nx] = -torch.eye(nx, **kw)
        A[r:r + nx, off + k * nu:off + (k + 1) * nu] = Bd
    A[n_eq:, :] = torch.eye(nz, **kw)

    x_box_lo = torch.cat([x_lo.repeat(N + 1), u_lo.repeat(N)])
    x_box_hi = torch.cat([x_hi.repeat(N + 1), u_hi.repeat(N)])
    l = torch.cat([torch.zeros(n_eq, **kw), x_box_lo])
    u = torch.cat([torch.zeros(n_eq, **kw), x_box_hi])

    def pack(x_init, q_xref=None):
        """Per-step updates: x_init into the first equality rows."""
        x_init = torch.as_tensor(x_init, **kw)
        l_k, u_k = l.clone(), u.clone()
        l_k[:nx] = -x_init
        u_k[:nx] = -x_init
        return l_k, u_k

    return P, A, l, u, pack
