"""AL-iLQR building blocks: configuration, warm start and result types, stage
expansions and the dense backward Riccati sweep. Port of the parts of
nmpc_tpu/solver/alilqr.py that the batched main path and the plain versions
of its kernels use; the per-scenario `solve`, `_line_search` and
`_inner_ilqr` are not ported yet.

Structure of the solver: an outer PHR multiplier loop
(lam <- max(0, lam - mu c), mu <- b mu) around an inner iLQR descent on the
AL merit. Every function here takes a leading batch dimension written out.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from nmpc_tpu_torch.device import DEVICE
from nmpc_tpu_torch.models.unicycle import euler_jacobians
from nmpc_tpu_torch.ocp import problem as P
from nmpc_tpu_torch.ocp.jacobians import stage_constraint_jacobians
from nmpc_tpu_torch.ocp.problem import OCP

# sweep='auto' resolves to the associative-scan backward pass only from this
# horizon on (nmpc_tpu/solver/alilqr_batched.py: effectively unreachable).
SCAN_N_MIN = 10_000


@dataclasses.dataclass(frozen=True)
class ALILQRConfig:
    """Solver options; fields and defaults as nmpc_tpu.solver.alilqr.ALILQRConfig."""

    n_outer: int = 12         # AL multiplier updates
    n_inner: int = 25         # max iLQR iterations per outer step
    mu_init: float = 10.0     # initial penalty weight
    mu_factor: float = 10.0   # penalty growth per outer step
    mu_max: float = 1e4       # cap (f32-friendly conditioning; lam does the rest)
    reg: float = 1e-6         # fixed Levenberg regularizer on Quu
    alphas: tuple = (1.0, 0.5, 0.25, 0.1, 0.03, 0.01, 0.003, 0.001)
    tol_cost: float = 1e-7    # relative merit-decrease stop (inner)
    tol_con: float = 1e-4     # max constraint violation stop (outer)
    lam_max: float = 1e6      # multiplier clip
    armijo: float = 1e-4      # accept fraction of expected decrease
    mega: bool = True         # batched path: the whole inner solve in one
                              # kernel per AL outer step (ops/megasolve.py)
                              # where K1 admits the problem; obstacle
                              # problems take the staged path (four kernels
                              # per inner iteration, a grid line search that
                              # does not read `ls`). False sends pair-only
                              # problems there too: a comparison and
                              # diagnostic route, slower and converging less
                              # often on the measured six-robot batch
    ls: str = "cascade"       # line search of the inner solve:
                              # "cascade" = try every cfg.alphas candidate in
                              # order, keep the best Armijo-passing one;
                              # "adaptive" = carried per-scenario trial step,
                              # ls_rounds first-accept Armijo rounds per
                              # iteration, backtrack by ls_beta on rejection,
                              # grow by ls_grow (capped at 1) on acceptance
    ls_rounds: int = 2        # adaptive: candidate evaluations per iteration;
                              # a scenario that fails every round retries at
                              # its shrunk trial next iteration
                              # (fail-continue) and gives up only once the
                              # trial falls below ls_trial_min
    ls_beta: float = 0.2      # adaptive: backtrack factor on rejection
    ls_grow: float = 4.0      # adaptive: growth factor on acceptance
    ls_trial_min: float = 1e-5  # adaptive: give-up threshold on the trial
    cold_seed: str = "zero"   # initial controls without a WarmStart: "zero"
                              # (reference-faithful); "polar" is not ported
    compact: bool = False     # permute unconverged scenarios into dense tiles
                              # between outer steps; not ported
    sweep: str = "seq"        # backward pass: "seq" = O(N) Riccati sweep;
                              # "scan" (associative-scan LQR) is not ported;
                              # "auto" = scan iff N >= SCAN_N_MIN
    final_clamp: bool = True  # project the returned controls onto the
                              # actuator box and re-roll once (feasibility
                              # restoration; the plant saturates anyway)


@dataclasses.dataclass(frozen=True)
class WarmStart:
    U: torch.Tensor    # [(B,) N, nu]
    lam: torch.Tensor  # [(B,) N, n_con]
    mu: torch.Tensor   # [(B,)] penalty weight


@dataclasses.dataclass(frozen=True)
class SolveResult:
    X: torch.Tensor            # [(B,) N+1, nx] optimal state trajectory
    U: torch.Tensor            # [(B,) N, nu]  optimal controls
    lam: torch.Tensor          # [(B,) N, n_con] final multipliers (warm-startable)
    mu: torch.Tensor           # final penalty weight
    cost: torch.Tensor         # reference objective (no penalty terms)
    viol: torch.Tensor         # max inequality violation
    inner_iters: torch.Tensor  # total iLQR iterations used (int32)
    outer_iters: torch.Tensor  # AL outer steps used (int32)
    converged: torch.Tensor    # bool


def cold_start(ocp: OCP, cfg: ALILQRConfig = ALILQRConfig()) -> WarmStart:
    kw = dict(dtype=ocp.x0.dtype, device=ocp.device)
    return WarmStart(
        U=torch.zeros((ocp.N, ocp.nu), **kw),
        lam=torch.zeros((ocp.N, ocp.n_con), **kw),
        mu=torch.tensor(cfg.mu_init, **kw),
    )


def warm_from_numpy(U, lam, mu, device=DEVICE) -> WarmStart:
    """The port's WarmStart from numpy arrays (e.g. a reference result)."""
    return WarmStart(*(torch.as_tensor(np.array(a), device=device)
                       for a in (U, lam, mu)))


# ---------------------------------------------------------------------------
# Stage expansions
# ---------------------------------------------------------------------------


def _stage_jacobians(ocp: OCP, x, u):
    """(A, B) of the discrete step: analytic for the plain Euler model."""
    if ocp.integrator == "euler" and ocp.num_rays == 0 and ocp.dyn_fn is None:
        return euler_jacobians(x, u, ocp.T)
    raise NotImplementedError(
        "dynamics Jacobians by automatic differentiation (RK4, LiDAR rays, "
        "dyn_fn) are not ported yet")


def _stage_expansion(ocp: OCP, x, u, xref_k, lam_k, mov_k, mu):
    """Gradients and Gauss-Newton Hessians of the AL merit stage term.
    x [..., nx], u [..., nu], lam_k [..., n_con], mu broadcastable to the
    leading shape of x."""
    if ocp.num_rays or ocp.dyn_fn is not None:
        raise NotImplementedError(
            "expansions of LiDAR-augmented or dyn_fn problems are not ported yet")
    kw = dict(dtype=x.dtype, device=x.device)
    lead = x.shape[:-1]
    dx = x - xref_k
    lx = 2.0 * ocp.Qdiag * dx
    lu = 2.0 * ocp.Rdiag * u
    lxx = torch.diag(2.0 * ocp.Qdiag).expand(*lead, ocp.nx, ocp.nx)
    luu = torch.diag(2.0 * ocp.Rdiag).expand(*lead, ocp.nu, ocp.nu)
    lux = torch.zeros((*lead, ocp.nu, ocp.nx), **kw)

    # PHR penalty: grad = -J' act, GN hess = mu J' 1[active] J
    c = P.stage_constraints(ocp, x, u, mov_k)
    Jx, Ju = stage_constraint_jacobians(ocp, x, mov_k)
    mu = torch.as_tensor(mu, **kw)[..., None]
    act = torch.clamp(lam_k - mu * c, min=0.0)
    w = mu * (act > 0.0).to(x.dtype)
    JxT = Jx.transpose(-1, -2)
    lx = lx - (JxT @ act[..., None])[..., 0]
    lu = lu - act @ Ju
    JxW = Jx * w[..., None]
    JuW = Ju * w[..., None]
    lxx = lxx + JxT @ JxW
    luu = luu + Ju.T @ JuW
    lux = lux + Ju.T @ JxW
    return lx, lu, lxx, luu, lux


# ---------------------------------------------------------------------------
# Backward Riccati sweep
# ---------------------------------------------------------------------------


def _backward_pass(ocp: OCP, cfg: ALILQRConfig, X, U, lam, mu):
    """LQR backward recursion over the AL-quadratized problem, batched.

    X [B, N+1, nx], U [B, N, nu], lam [B, N, n_con], mu [B] -> kff [B, N, nu],
    Kfb [B, N, nu, nx], dV1 [B], dV2 [B]. Terminal value is exactly zero: the
    reference objective carries no terminal cost and no constraints on X[N].
    Dense sequential form (nmpc_tpu/solver/alilqr.py:275-308)."""
    sweep = cfg.sweep
    if sweep == "auto":
        sweep = "scan" if ocp.N >= SCAN_N_MIN else "seq"
    if sweep != "seq":
        raise NotImplementedError("sweep='scan' (associative-scan LQR) is not ported yet")
    Xs = X[..., :-1, :]
    A, B = _stage_jacobians(ocp, Xs, U)
    lx, lu, lxx, luu, lux = _stage_expansion(
        ocp, Xs, U, ocp.xref, lam, ocp.mov_obs if ocp.n_mov else None,
        torch.as_tensor(mu, dtype=X.dtype, device=X.device)[..., None])

    nx, nu, N = ocp.nx, ocp.nu, ocp.N
    lead = X.shape[:-2]
    kw = dict(dtype=X.dtype, device=X.device)
    reg_I = cfg.reg * torch.eye(nu, **kw)
    Vx = torch.zeros((*lead, nx, 1), **kw)
    Vxx = torch.zeros((*lead, nx, nx), **kw)
    dV1 = torch.zeros(lead, **kw)
    dV2 = torch.zeros(lead, **kw)
    kff = torch.empty((*lead, N, nu), **kw)
    Kfb = torch.empty((*lead, N, nu, nx), **kw)
    for k in reversed(range(N)):
        A_k, B_k = A[..., k, :, :], B[..., k, :, :]
        At, Bt = A_k.transpose(-1, -2), B_k.transpose(-1, -2)
        AtV = At @ Vxx
        Qx = lx[..., k, :, None] + At @ Vx
        Qu = lu[..., k, :, None] + Bt @ Vx
        Qxx = lxx[..., k, :, :] + AtV @ A_k
        Qux = lux[..., k, :, :] + Bt @ Vxx @ A_k
        Quu = luu[..., k, :, :] + Bt @ Vxx @ B_k + reg_I
        Quu = 0.5 * (Quu + Quu.transpose(-1, -2))
        L, _ = torch.linalg.cholesky_ex(Quu)
        kk = -torch.cholesky_solve(Qu, L)
        KK = -torch.cholesky_solve(Qux, L)
        KKt = KK.transpose(-1, -2)
        Quxt = Qux.transpose(-1, -2)
        Vx = Qx + KKt @ Quu @ kk + KKt @ Qu + Quxt @ kk
        Vxx = Qxx + KKt @ Quu @ KK + KKt @ Qux + Quxt @ KK
        Vxx = 0.5 * (Vxx + Vxx.transpose(-1, -2))
        dV1 = dV1 + torch.sum(kk * Qu, dim=(-2, -1))
        dV2 = dV2 + 0.5 * torch.sum(kk * (Quu @ kk), dim=(-2, -1))
        kff[..., k, :] = kk[..., 0]
        Kfb[..., k, :, :] = KK
    return kff, Kfb, dV1, dV2
