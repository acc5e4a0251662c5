"""AL-iLQR: the per-scenario engine and its building blocks. Port of
nmpc_tpu/solver/alilqr.py: configuration, warm start and result types, stage
expansions (analytic for Euler unicycles; the dynamics Jacobians of RK4 and
LiDAR-augmented models and the ray rows' constraint Jacobians by
torch.func.jacfwd, as the reference's jax.jacfwd), the dense backward
Riccati sweep or the associative-scan LQR (sweep="scan"), the forward
rollout, the cascade line search, the inner iLQR loop and `solve`. User
dynamics (dyn_fn) are not ported and raise.

Structure of the solver: an outer PHR multiplier loop
(lam <- max(0, lam - mu c), mu <- b mu) around an inner iLQR descent on the
AL merit. Every function here takes a leading batch dimension written out.

One implementation serves one scenario and many: `_solve_scenarios` runs B
scenarios with per-scenario `done` masks at both loop levels, so a finished
scenario's carry (X, U, cost, duals, iteration counts) stays frozen while
the others iterate, as `vmap` of the reference's `lax.while_loop` freezes
it. `solve` is that implementation at B = 1 and
`parallel.batch.batched_solve` at any B. Everything is plain PyTorch: the
reference's per-scenario engine is XLA code with no Pallas kernel, so on the
card each step is a chain of small PyTorch kernels and the loop's host
syncs (one per inner and outer iteration, to leave the loops early).
"""

from __future__ import annotations

import dataclasses

import math

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
                              # where K1 admits the problem (pair, obstacle,
                              # moving-obstacle and box rows). False takes
                              # the staged path (four kernels per inner
                              # iteration, a grid line search that does not
                              # read `ls`): a comparison and diagnostic
                              # route, slower and converging less often on
                              # the measured six-robot batch
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
                              # (reference-faithful); "polar" = a per-robot
                              # polar go-to-goal law rolled through the model
                              # (batched engine only; ignored with rays)
    compact: bool = False     # megakernel route: permute unconverged
                              # scenarios to the front of the batch between
                              # outer steps (results bit for bit the same)
    sweep: str = "seq"        # backward pass: "seq" = O(N) Riccati sweep;
                              # "scan" = O(log N) associative-scan LQR
                              # (ops/assoc_lqr.py; the batched engine's
                              # hybrid route); "auto" = scan iff N >= SCAN_N_MIN
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


def _vmap_flat(fn, *args):
    """fn (on one point's tensors) over the broadcast leading dimensions of
    args (each [..., d]): torch.func.vmap over the flattened points, the
    results reshaped back to the leading shape."""
    lead = torch.broadcast_shapes(*(a.shape[:-1] for a in args))
    flat = [a.expand(*lead, a.shape[-1]).reshape(-1, a.shape[-1]) for a in args]
    out = torch.func.vmap(fn)(*flat)
    return tuple(o.reshape(*lead, *o.shape[1:]) for o in out)


def _stage_jacobians(ocp: OCP, x, u):
    """(A, B) of the discrete step: analytic for the plain Euler model,
    torch.func.jacfwd for RK4 and LiDAR-augmented models (the reference's
    jax.jacfwd; problem.step_dynamics differentiates its kinks as JAX
    does). x [..., nx], u [..., nu]."""
    if ocp.dyn_fn is not None:
        raise NotImplementedError("user dynamics (dyn_fn) are not ported yet")
    if ocp.integrator == "euler" and ocp.num_rays == 0:
        return euler_jacobians(x, u, ocp.T)
    F = lambda xx, uu: P.step_dynamics(ocp, xx, uu)  # noqa: E731
    return _vmap_flat(torch.func.jacfwd(F, argnums=(0, 1)), x, u)


def _stage_expansion(ocp: OCP, x, u, xref_k, lam_k, mov_k, mu):
    """Gradients and Gauss-Newton Hessians of the AL merit stage term.
    x [..., nx], u [..., nu], lam_k [..., n_con], mu broadcastable to the
    leading shape of x. LiDAR-augmented problems add the 1/d cost's
    gradient and Hessian diagonal and take the constraint Jacobians by
    torch.func.jacfwd (as the reference); the others the analytic ones."""
    if ocp.dyn_fn is not None:
        raise NotImplementedError("expansions of dyn_fn problems are not ported yet")
    kw = dict(dtype=x.dtype, device=x.device)
    lead = torch.broadcast_shapes(x.shape[:-1], u.shape[:-1])
    dx = x - xref_k
    lx = 2.0 * ocp.Qdiag * dx
    lu = 2.0 * ocp.Rdiag * u
    lxx = torch.diag(2.0 * ocp.Qdiag).expand(*lead, ocp.nx, ocp.nx)
    luu = torch.diag(2.0 * ocp.Rdiag).expand(*lead, ocp.nu, ocp.nu)
    lux = torch.zeros((*lead, ocp.nu, ocp.nx), **kw)

    c = P.stage_constraints(ocp, x, u, mov_k)
    if ocp.num_rays:
        # inverse-distance cost w sum 1/d^2: grad -2w/d^3, hess 6w/d^4 (diag)
        d = torch.maximum(x[..., 3:], x.new_tensor(1e-3))
        gray = -2.0 * ocp.inv_dist_weight / d**3
        hray = 6.0 * ocp.inv_dist_weight / d**4
        lx = torch.cat([lx[..., :3], lx[..., 3:] + gray], dim=-1)
        lxx = lxx + torch.diag_embed(torch.cat([torch.zeros_like(hray[..., :3]), hray], -1))
        if mov_k is not None:
            raise NotImplementedError("moving obstacles with LiDAR rays are not ported")
        Jx, Ju = _vmap_flat(torch.func.jacfwd(
            lambda xx, uu: P.stage_constraints(ocp, xx, uu), argnums=(0, 1)), x, u)
    else:
        Jx, Ju = stage_constraint_jacobians(ocp, x, mov_k)

    # PHR penalty: grad = -J' act, GN hess = mu J' 1[active] J
    mu = torch.as_tensor(mu, **kw)[..., None]
    act = torch.clamp(lam_k - mu * c, min=0.0)
    w = mu * (act > 0.0).to(x.dtype)
    JxT, JuT = Jx.transpose(-1, -2), Ju.transpose(-1, -2)
    lx = lx - (JxT @ act[..., None])[..., 0]
    # the analytic Ju is one [n_con, nu] for every point, jacfwd's per point
    lu = lu - (act @ Ju if Ju.dim() == 2 else (JuT @ act[..., None])[..., 0])
    JxW = Jx * w[..., None]
    JuW = Ju * w[..., None]
    lxx = lxx + JxT @ JxW
    luu = luu + JuT @ JuW
    lux = lux + JuT @ JxW
    return lx, lu, lxx, luu, lux


# ---------------------------------------------------------------------------
# Backward Riccati sweep
# ---------------------------------------------------------------------------


def resolve_sweep(cfg: ALILQRConfig, N: int) -> str:
    """cfg.sweep with 'auto' resolved: the scan from SCAN_N_MIN stages on."""
    if cfg.sweep == "auto":
        return "scan" if N >= SCAN_N_MIN else "seq"
    if cfg.sweep not in ("seq", "scan"):
        raise ValueError(f"unknown sweep {cfg.sweep!r}")
    return cfg.sweep


def scan_gains(A, B, lx, lu, lxx, luu_reg, lux):
    """The horizon-parallel backward pass (ops/assoc_lqr.parallel_lqr_gains)
    on stage blocks [..., N, ...] with Quu's regularizer already added.
    Iterates are single-shooting consistent, so the LQ subproblem in delta
    coordinates has zero defects. Returns (kff [..., N, nu], Kfb [..., N, nu,
    nx], dV1 [...]): dV1 = sum_k kff_k . Qu_k with Qu_k = lu_k + B_k' Vx_{k+1}
    and Vx = -v (delta coordinates)."""
    from nmpc_tpu_torch.ops.assoc_lqr import parallel_lqr_gains  # ops imports this module

    lead = A.dim() - 3   # the batch dimensions before the horizon
    first = lambda a: a.movedim(lead, 0)  # noqa: E731  horizon first
    Af, Bf = first(A), first(B)
    kff, Kfb, _, v = parallel_lqr_gains(Af, Bf, torch.zeros_like(first(lx)), first(lxx),
                                        first(lx), first(luu_reg), first(lu), first(lux))
    Qu = first(lu) - (Bf.mT @ v[1:, ..., None])[..., 0]
    dV1 = torch.sum(kff * Qu, dim=(0, -1))
    return kff.movedim(0, lead), Kfb.movedim(0, lead), dV1


def _backward_pass(ocp: OCP, cfg: ALILQRConfig, X, U, lam, mu):
    """LQR backward recursion over the AL-quadratized problem, batched.

    X [B, N+1, nx], U [B, N, nu], lam [B, N, n_con], mu [B] -> kff [B, N, nu],
    Kfb [B, N, nu, nx], dV1 [B], dV2 [B]. Terminal value is exactly zero: the
    reference objective carries no terminal cost and no constraints on X[N].
    Dense sequential form (nmpc_tpu/solver/alilqr.py:275-308), or with
    sweep="scan" the associative-scan LQR (`scan_gains`; dV2 is then 0, as
    in the reference)."""
    Xs = X[..., :-1, :]
    A, B = _stage_jacobians(ocp, Xs, U)
    lx, lu, lxx, luu, lux = _stage_expansion(
        ocp, Xs, U, ocp.xref, lam, ocp.mov_obs if ocp.n_mov else None,
        torch.as_tensor(mu, dtype=X.dtype, device=X.device)[..., None])

    nx, nu, N = ocp.nx, ocp.nu, ocp.N
    lead = X.shape[:-2]
    kw = dict(dtype=X.dtype, device=X.device)
    reg_I = cfg.reg * torch.eye(nu, **kw)
    if resolve_sweep(cfg, N) == "scan":
        kff, Kfb, dV1 = scan_gains(A, B, lx, lu, lxx, luu + reg_I, lux)
        return kff, Kfb, dV1, torch.zeros(lead, **kw)
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


# ---------------------------------------------------------------------------
# Forward pass: the cascade line search
# ---------------------------------------------------------------------------


def _forward_rollout(ocp: OCP, X, U, kff, Kfb, alpha):
    """Roll the affine policy u_k = U_k + alpha kff_k + Kfb_k (x_k - X_k)
    from x0 through the dynamics. X [..., N+1, nx], U and kff [..., N, nu],
    Kfb [..., N, nu, nx]; alpha broadcasts against their leading shape (a
    scalar, or [A, 1] for A candidates over B scenarios, giving [A, B, ...]).
    Returns (Xn [..., N+1, nx], Un [..., N, nu])."""
    alpha = torch.as_tensor(alpha, dtype=X.dtype, device=X.device)[..., None]
    x = ocp.x0
    xs, us = [x], []
    for k in range(ocp.N):
        dx = x - X[..., k, :]
        u = U[..., k, :] + alpha * kff[..., k, :] + (Kfb[..., k, :, :] @ dx[..., None])[..., 0]
        x = P.step_dynamics(ocp, x, u)
        xs.append(x)
        us.append(u)
    return torch.stack(torch.broadcast_tensors(*xs), dim=-2), torch.stack(us, dim=-2)


def _line_search(ocp: OCP, cfg: ALILQRConfig, X, U, kff, Kfb, lam, mu, cost0, dV1):
    """Every candidate of cfg.alphas rolled at once, as a leading batch
    dimension (the reference's vmap over alphas). Accepts the cheapest
    candidate that achieves an Armijo fraction of the expected LQR decrease
    and lowers the merit. X [B, N+1, nx], cost0 and dV1 [B] -> (Xn, Un,
    cost [B], improved [B] bool).

    A NaN merit fails the Armijo test ((cost0 - nan) >= e is False) and is
    masked to inf; argmin takes the first of tied minima, as jnp.argmin."""
    alphas = torch.tensor(cfg.alphas, dtype=X.dtype, device=X.device)
    Xs, Us = _forward_rollout(ocp, X, U, kff, Kfb, alphas[:, None])   # [A, B, ...]
    costs = P.al_total_cost(ocp, Xs, Us, lam, mu)                     # [A, B]
    expected = cfg.armijo * alphas[:, None] * torch.clamp(-dV1, min=0.0)
    ok = (cost0 - costs) >= expected
    best = torch.argmin(torch.where(ok, costs, math.inf), dim=0)      # [B]
    cost_best = costs.gather(0, best[None])[0]
    improved = ok.gather(0, best[None])[0] & (cost_best < cost0)
    rows = torch.arange(X.shape[0], device=X.device)
    Xn = torch.where(improved[:, None, None], Xs[best, rows], X)
    Un = torch.where(improved[:, None, None], Us[best, rows], U)
    cost = torch.where(improved, cost_best, cost0)
    return Xn, Un, cost, improved


# ---------------------------------------------------------------------------
# Solve
# ---------------------------------------------------------------------------


def _inner_ilqr(ocp: OCP, cfg: ALILQRConfig, X, U, lam, mu, active):
    """iLQR descent on the AL merit for the scenarios where `active` [B] is
    set; the others keep their X, U and a zero count. Each scenario
    iterates while it < n_inner and it is not done (the reference's
    `(it < n_inner) & ~done`), its carry frozen from then on. Returns (X, U,
    cost [B], iters [B] int32)."""
    cost = P.al_total_cost(ocp, X, U, lam, mu)
    it = torch.zeros(X.shape[0], dtype=torch.int32, device=X.device)
    done = ~active
    for _ in range(cfg.n_inner):
        if bool(done.all()):
            break
        run = ~done
        kff, Kfb, dV1, _ = _backward_pass(ocp, cfg, X, U, lam, mu)
        Xn, Un, costn, improved = _line_search(ocp, cfg, X, U, kff, Kfb, lam, mu, cost, dV1)
        rel_drop = (cost - costn) / (1.0 + torch.abs(cost))
        stop = (~improved) | (rel_drop < cfg.tol_cost)
        X = torch.where(run[:, None, None], Xn, X)
        U = torch.where(run[:, None, None], Un, U)
        cost = torch.where(run, costn, cost)
        it = it + run.to(torch.int32)
        done = done | stop
    return X, U, cost, it


def _solve_scenarios(ocp_b: OCP, warm: WarmStart | None = None,
                     cfg: ALILQRConfig = ALILQRConfig()) -> SolveResult:
    """The per-scenario engine over a batch (x0 [B, nx], xref [B, N, nx];
    warm [B, ...] or None for the cold start): the outer PHR loop with a
    per-scenario `done` mask around `_inner_ilqr`, then the final clamp.
    Each scenario's result is the reference `solve` of that scenario alone:
    a scenario that is done keeps its carry while the others iterate."""
    B = ocp_b.x0.shape[0]
    kw = dict(dtype=ocp_b.x0.dtype, device=ocp_b.device)
    if warm is None:
        warm = WarmStart(U=torch.zeros((B, ocp_b.N, ocp_b.nu), **kw),
                         lam=torch.zeros((B, ocp_b.N, ocp_b.n_con), **kw),
                         mu=torch.full((B,), cfg.mu_init, **kw))
    U, lam, mu = warm.U, warm.lam, warm.mu
    X = P.rollout(ocp_b, U)
    i32 = dict(dtype=torch.int32, device=ocp_b.device)
    outer, inner_tot = torch.zeros(B, **i32), torch.zeros(B, **i32)
    viol = torch.full((B,), math.inf, **kw)
    done = torch.zeros(B, dtype=torch.bool, device=ocp_b.device)
    for _ in range(cfg.n_outer):
        if bool(done.all()):
            break
        run = ~done
        Xn, Un, _, iters = _inner_ilqr(ocp_b, cfg, X, U, lam, mu, run)
        c = P.masked_trajectory_constraints(ocp_b, Xn, Un)
        violn = torch.clamp(-torch.amin(c, dim=(-2, -1)), min=0.0)
        lamn = torch.clamp(lam - mu[:, None, None] * c, min=0.0, max=cfg.lam_max)
        newly = violn < cfg.tol_con
        mun = torch.where(newly, mu, torch.clamp(mu * cfg.mu_factor, max=cfg.mu_max))
        X = torch.where(run[:, None, None], Xn, X)
        U = torch.where(run[:, None, None], Un, U)
        lam = torch.where(run[:, None, None], lamn, lam)
        mu = torch.where(run, mun, mu)
        viol = torch.where(run, violn, viol)
        outer = outer + run.to(torch.int32)
        inner_tot = inner_tot + iters
        done = done | newly
    if cfg.final_clamp:
        U = torch.maximum(torch.minimum(U, ocp_b.u_hi), ocp_b.u_lo)
        X = P.rollout(ocp_b, U)
        viol = P.max_violation(ocp_b, X, U)
    return SolveResult(X=X, U=U, lam=lam, mu=mu, cost=P.total_cost(ocp_b, X, U), viol=viol,
                       inner_iters=inner_tot, outer_iters=outer, converged=done)


def one_scenario(batched_solve, ocp: OCP, warm: WarmStart | None, cfg: ALILQRConfig) -> SolveResult:
    """batched_solve(ocp_b, warm_b, cfg) on one scenario: unbatched OCP and
    WarmStart in (a batch of one), unbatched SolveResult out."""
    ocp_b = dataclasses.replace(ocp, x0=ocp.x0[None], xref=ocp.xref[None])
    warm_b = None if warm is None else WarmStart(
        *(torch.as_tensor(a, device=ocp.device)[None] for a in (warm.U, warm.lam, warm.mu)))
    res = batched_solve(ocp_b, warm_b, cfg)
    return SolveResult(**{f.name: getattr(res, f.name)[0] for f in dataclasses.fields(res)})


def solve(ocp: OCP, warm: WarmStart | None = None,
          cfg: ALILQRConfig = ALILQRConfig()) -> SolveResult:
    """Solve one NMPC problem (unbatched OCP and WarmStart in, unbatched
    SolveResult out): `_solve_scenarios` at B = 1. The line search is always
    the cascade over cfg.alphas; cfg.mega, cfg.ls, cfg.compact and
    cfg.cold_seed are read by the batched engine only, as in the reference."""
    return one_scenario(_solve_scenarios, ocp, warm, cfg)
