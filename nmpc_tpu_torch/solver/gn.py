"""Condensed Gauss-Newton AL solver with control-horizon move blocking.
Port of nmpc_tpu/solver/gn.py (plain PyTorch: the reference has no Pallas
kernel here; its Cholesky is XLA's, here torch.linalg.cholesky).

Decision = U_blk [Nc, nu] (u_k = U_blk[min(k, Nc - 1)]), the states
eliminated by the exact rollout, one dense Gauss-Newton system of size
Nc nu per iteration. The augmented-Lagrangian outer loop and the PHR
penalty are the iLQR engine's, and it returns the same SolveResult /
WarmStart types, so every MPC driver can take it as its `solve_fn`.

One implementation serves one scenario and many, as solver/alilqr.py's:
`_solve_scenarios` runs B scenarios with per-scenario `done` masks at both
loop levels (a finished scenario's carry stays frozen while the others
iterate, as `vmap` of the reference's `lax.while_loop` freezes it);
`solve` is it at B = 1 and `solve_batched` at any B. Each GN iteration is
one batched [B, nz, nz] Cholesky, the normal equations from a stagewise
forward-sensitivity scan (normal="scan") or from the residual Jacobian
materialized by torch.func.jacfwd (normal="dense"), and every line-search
candidate's merit at once.

Kinks are differentiated as JAX does (ocp/problem.py): max by
torch.maximum, |t| with derivative +1 at 0.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from nmpc_tpu_torch.ocp import problem as P
from nmpc_tpu_torch.ocp.problem import OCP
from nmpc_tpu_torch.solver.alilqr import SolveResult, WarmStart, _stage_jacobians, one_scenario


@dataclasses.dataclass(frozen=True)
class GNConfig:
    """Solver options; fields and defaults as nmpc_tpu.solver.gn.GNConfig."""

    Nc: int | None = None     # control horizon; None = N (no blocking)
    n_outer: int = 8
    n_gn: int = 15            # Gauss-Newton iterations per outer step
    mu_init: float = 10.0
    mu_factor: float = 10.0
    mu_max: float = 1e4
    reg: float = 1e-6
    alphas: tuple = (1.0, 0.5, 0.25, 0.1, 0.03, 0.01, 0.003)
    tol_cost: float = 1e-7
    tol_con: float = 1e-4
    lam_max: float = 1e6
    final_clamp: bool = True  # project returned controls onto the actuator
                              # box + re-roll (see ALILQRConfig.final_clamp)
    normal: str = "scan"      # how the GN normal equations are formed:
                              # "scan" = stagewise forward-sensitivity scan
                              # accumulating H = J'J and g = J'r without
                              # materializing J; "dense" = J by jacfwd


def expand_controls(U_blk: torch.Tensor, N: int) -> torch.Tensor:
    """u_k = U_blk[min(k, Nc-1)], the move-blocking rule. U_blk [..., Nc, nu]
    -> [..., N, nu]."""
    idx = torch.clamp(torch.arange(N, device=U_blk.device), max=U_blk.shape[-2] - 1)
    return U_blk[..., idx, :]


def _mu(mu, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(mu, dtype=like.dtype, device=like.device)


def _residuals(ocp: OCP, U_blk, lam, mu):
    """Stacked residual vector r with merit = 0.5 ||r||^2: state cost,
    control cost, (LiDAR 1/d cost) and PHR penalty rows. U_blk [..., Nc,
    nu], lam [..., N, n_con], mu of the leading shape -> r [..., n_res]."""
    U = expand_controls(U_blk, ocp.N)
    X = P.rollout(ocp, U)
    lead = X.shape[:-2]
    mu = _mu(mu, X)
    dx = X[..., :-1, :] - ocp.xref
    parts = [(torch.sqrt(2.0 * ocp.Qdiag) * dx).reshape(*lead, -1),
             (torch.sqrt(2.0 * ocp.Rdiag) * U).expand(*lead, *U.shape[-2:]).reshape(*lead, -1)]
    if ocp.num_rays:
        d = torch.maximum(X[..., :-1, 3:], X.new_tensor(1e-3))
        parts.append((torch.sqrt(2.0 * ocp.inv_dist_weight) / d).reshape(*lead, -1))
    c = P.masked_trajectory_constraints(ocp, X, U)
    act = torch.maximum(torch.zeros_like(c), lam - mu[..., None, None] * c)
    parts.append((act / torch.sqrt(mu)[..., None, None]).reshape(*lead, -1))
    return torch.cat(parts, dim=-1)


def _merit(ocp: OCP, U_blk, lam, mu):
    r = _residuals(ocp, U_blk, lam, mu)
    return 0.5 * torch.sum(r * r, dim=-1)


def _stage_residual(ocp: OCP, x, u, xref_k, lam_k, mask_k, mov_k, mu):
    """One stage's residual rows (the set of _residuals, permuted: the
    normal equations H = J'J, g = J'r are permutation-invariant). One
    point: x [nx], u [nu], xref_k [nx], lam_k and mask_k [n_con], mu []."""
    parts = [torch.sqrt(2.0 * ocp.Qdiag) * (x - xref_k), torch.sqrt(2.0 * ocp.Rdiag) * u]
    if ocp.num_rays:
        d = torch.maximum(x[3:], x.new_tensor(1e-3))
        parts.append(torch.sqrt(2.0 * ocp.inv_dist_weight) / d)
    c = P.stage_constraints(ocp, x, u, mov_k)
    c = torch.where(mask_k > 0, c, torch.full_like(c, P.BIG))
    act = torch.maximum(torch.zeros_like(c), lam_k - mu * c)
    parts.append(act / torch.sqrt(mu))
    return torch.cat(parts)


def _per_scenario(ocp_b: OCP, fn, *args):
    """torch.func.vmap of fn(ocp, *args) over the batch axis of ocp_b's
    scenario fields and of args."""
    names = P.batch_fields(ocp_b)

    def one(fields, *a):
        return fn(dataclasses.replace(ocp_b, **dict(zip(names, fields))), *a)

    return torch.func.vmap(one)(tuple(getattr(ocp_b, k) for k in names), *args)


def _normal_scan(ocp: OCP, U_blk, lam, mu, Nc: int):
    """Gauss-Newton normal equations by forward-sensitivity scan.

    Propagates S_k = dX_k/dvec(U_blk) [nx, nz] along the rollout
    (S_{k+1} = A_k S_k + B_k E_k with E_k the move-blocking selector) and
    accumulates H = sum_k J_k' J_k, g = sum_k J_k' r_k stagewise, where
    J_k = dr_k/dx . S_k + dr_k/du . E_k (E_k puts dr_k/du into the columns
    of block min(k, Nc-1)); J itself is never materialized. Batched: ocp
    with x0 [B, nx], xref [B, N, nx] (and a per-scenario p_obs [B, R, 2]),
    U_blk [B, Nc, nu], lam [B, N, n_con], mu [B] -> (H [B, nz, nz], g [B,
    nz]); unbatched (x0 [nx]) without the leading axis. The B N points
    take their scenario's xref, duals, mask and schedule through the flat
    vmap, and their scenario's p_obs through _stage_jacobians (a stage's
    residual rows do not read p_obs: the rays' points enter only through
    the dynamics)."""
    if ocp.x0.dim() == 1:
        ocp_b = dataclasses.replace(ocp, x0=ocp.x0[None], xref=ocp.xref[None])
        H, g = _normal_scan(ocp_b, U_blk[None], lam[None], _mu(mu, U_blk)[None], Nc)
        return H[0], g[0]
    N, nx, nu = ocp.N, ocp.nx, ocp.nu
    B, nz = U_blk.shape[0], Nc * nu
    kw = dict(dtype=U_blk.dtype, device=U_blk.device)
    mu = _mu(mu, U_blk).expand(B)
    U = expand_controls(U_blk, N)
    X = P.rollout(ocp, U)
    mask = P.constraint_mask(ocp).expand(B, N, ocp.n_con)
    Xs = X[:, :-1]
    # every stage's residual and its Jacobians at once (one vmap over the
    # B N points), then the sensitivity recursion over the stages
    pts = [Xs, U, ocp.xref.expand(B, N, nx), lam, mask, mu[:, None].expand(B, N)]
    if ocp.n_mov:
        pts.append(ocp.mov_obs.expand(B, *ocp.mov_obs.shape[-3:]))
    flat = [t.reshape(B * N, *t.shape[2:]) for t in pts]

    def rf(xx, uu, xr, lk, mk, m_, mov_k=None):
        return _stage_residual(ocp, xx, uu, xr, lk, mk, mov_k, m_)

    r = torch.func.vmap(rf)(*flat).reshape(B, N, -1)
    drx, dru = (d.reshape(B, N, *d.shape[1:])
                for d in torch.func.vmap(torch.func.jacfwd(rf, argnums=(0, 1)))(*flat))
    A, Bm = _stage_jacobians(ocp, Xs, U)
    S = torch.zeros((B, nx, nz), **kw)
    H = torch.zeros((B, nz, nz), **kw)
    g = torch.zeros((B, nz), **kw)
    for k in range(N):
        b = min(k, Nc - 1)
        Jk = drx[:, k] @ S
        Jk[..., b * nu:(b + 1) * nu] += dru[:, k]
        H = H + Jk.mT @ Jk
        g = g + (Jk.mT @ r[:, k, :, None])[..., 0]
        S = A[:, k] @ S
        S[..., b * nu:(b + 1) * nu] += Bm[:, k]
    return H, g


def _dense_normal(ocp_b: OCP, flat, lam, mu, Nc: int):
    """(H without reg, g) from the residual Jacobian [B, n_res, nz] by
    torch.func.jacfwd, one scenario at a time under torch.func.vmap."""
    nu = ocp_b.nu

    def res(o, z, lam_, mu_):
        return _residuals(o, z.reshape(Nc, nu), lam_, mu_)

    r = _residuals(ocp_b, flat.reshape(-1, Nc, nu), lam, mu)
    J = _per_scenario(ocp_b, lambda o, z, l_, m_: torch.func.jacfwd(
        lambda zz: res(o, zz, l_, m_))(z), flat, lam, mu)
    return J.mT @ J, (J.mT @ r[..., None])[..., 0]


def _solve_scenarios(ocp_b: OCP, warm: WarmStart | None = None,
                     cfg: GNConfig = GNConfig()) -> SolveResult:
    """The condensed GN-AL solve of a batch (x0 [B, nx], xref [B, N, nx];
    warm [B, ...] or None for the cold start), each scenario's result that
    of the reference `solve` of it alone."""
    if cfg.normal not in ("scan", "dense"):
        raise ValueError(f"unknown normal-equations form {cfg.normal!r}")
    N, nu = ocp_b.N, ocp_b.nu
    B = ocp_b.x0.shape[0]
    Nc = N if cfg.Nc is None else cfg.Nc
    nz = Nc * nu
    kw = dict(dtype=ocp_b.x0.dtype, device=ocp_b.device)
    if warm is None:
        warm = WarmStart(U=torch.zeros((B, N, nu), **kw),
                         lam=torch.zeros((B, N, ocp_b.n_con), **kw),
                         mu=torch.full((B,), cfg.mu_init, **kw))
    U_blk, lam, mu = warm.U[:, :Nc], warm.lam, _mu(warm.mu, warm.U).expand(B)
    eye = cfg.reg * torch.eye(nz, **kw)
    alphas = torch.tensor(cfg.alphas, **kw)
    rows = torch.arange(B, device=ocp_b.device)
    i32 = dict(dtype=torch.int32, device=ocp_b.device)

    def gn_inner(U_blk, lam, mu, active):
        cost = _merit(ocp_b, U_blk, lam, mu)
        it = torch.zeros(B, **i32)
        done = ~active
        for _ in range(cfg.n_gn):
            if bool(done.all()):
                break
            run = ~done
            flat = U_blk.reshape(B, nz)
            if cfg.normal == "scan":
                H, g = _normal_scan(ocp_b, U_blk, lam, mu, Nc)
            else:
                H, g = _dense_normal(ocp_b, flat, lam, mu, Nc)
            L, _ = torch.linalg.cholesky_ex(H + eye)
            step = -torch.cholesky_solve(g[..., None], L)[..., 0]
            zs = flat + alphas[:, None, None] * step                       # [A, B, nz]
            costs = _merit(ocp_b, zs.reshape(-1, B, Nc, nu), lam, mu)      # [A, B]
            best = torch.argmin(costs, dim=0)
            cbest = costs[best, rows]
            improved = cbest < cost
            z_new = torch.where(improved[:, None], zs[best, rows], flat)
            cost_new = torch.where(improved, cbest, cost)
            rel = (cost - cost_new) / (1.0 + torch.abs(cost))
            stop = (~improved) | (rel < cfg.tol_cost)
            U_blk = torch.where(run[:, None, None], z_new.reshape(B, Nc, nu), U_blk)
            cost = torch.where(run, cost_new, cost)
            it = it + run.to(torch.int32)
            done = done | stop
        return U_blk, it

    outer, tot = torch.zeros(B, **i32), torch.zeros(B, **i32)
    viol = torch.full((B,), math.inf, **kw)
    done = torch.zeros(B, dtype=torch.bool, device=ocp_b.device)
    for _ in range(cfg.n_outer):
        if bool(done.all()):
            break
        run = ~done
        U_new, iters = gn_inner(U_blk, lam, mu, run)
        U = expand_controls(U_new, N)
        c = P.masked_trajectory_constraints(ocp_b, P.rollout(ocp_b, U), U)
        viol_new = torch.clamp(-torch.amin(c, dim=(-2, -1)), min=0.0)
        lam_new = torch.clamp(lam - mu[:, None, None] * c, min=0.0, max=cfg.lam_max)
        newly = viol_new < cfg.tol_con
        mu_new = torch.where(newly, mu, torch.clamp(mu * cfg.mu_factor, max=cfg.mu_max))
        U_blk = torch.where(run[:, None, None], U_new, U_blk)
        lam = torch.where(run[:, None, None], lam_new, lam)
        mu = torch.where(run, mu_new, mu)
        viol = torch.where(run, viol_new, viol)
        outer = outer + run.to(torch.int32)
        tot = tot + iters
        done = done | newly
    U = expand_controls(U_blk, N)
    if cfg.final_clamp:
        U = torch.maximum(torch.minimum(U, ocp_b.u_hi), ocp_b.u_lo)
    X = P.rollout(ocp_b, U)
    if cfg.final_clamp:
        viol = P.max_violation(ocp_b, X, U)
    return SolveResult(X=X, U=U, lam=lam, mu=mu, cost=P.total_cost(ocp_b, X, U), viol=viol,
                       inner_iters=tot, outer_iters=outer, converged=done)


def solve(ocp: OCP, warm: WarmStart | None = None, cfg: GNConfig = GNConfig()) -> SolveResult:
    """Condensed GN-AL solve of one problem (unbatched OCP and WarmStart in,
    unbatched SolveResult out): `_solve_scenarios` at B = 1."""
    return one_scenario(_solve_scenarios, ocp, warm, cfg)


def solve_batched(ocp_b: OCP, warm: WarmStart | None = None,
                  cfg: GNConfig = GNConfig()) -> SolveResult:
    """Batched condensed GN-AL over the batch fields of ocp_b (x0 [B, nx],
    xref [B, N, nx], and a per-scenario mov_obs [B, N, n_mov, 2] or LiDAR
    scan p_obs [B, R, 2] if present: the reference's jax.vmap of `solve`
    with those on the batch axis); warm [B, ...] or None. The family-I (LiDAR v4) fleet engine:
    per GN iteration one batched [B, Nc nu, Nc nu] Cholesky plus the
    batched residuals and sensitivities."""
    return _solve_scenarios(ocp_b, warm, cfg)
