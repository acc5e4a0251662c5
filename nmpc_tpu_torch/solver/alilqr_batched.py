"""Batch-native AL-iLQR: the production path for scenario fleets. Port of
`solve_batched`, `solve_one`, `_solve_mega`, `_solve_lanes`, `_polar_seed`
and `_finalize` from nmpc_tpu/solver/alilqr_batched.py, with the
reference's hybrid route.

Three routes, chosen as the reference chooses them, from cfg.mega, cfg.sweep
and the problem's static shape before any launch, the same on CPU and CUDA
tensors:

* `_solve_mega` (cfg.mega, sweep "seq", a problem of the fused kernels'
  class (ops/rollout.supports: pair, static-obstacle, moving-obstacle and
  box rows of Euler unicycles) and K1's block fits the card
  (ops/megasolve.mega_fits, m <= 16)): each AL outer step is two
  kernel launches over the whole batch, K1 (ops/megasolve.inner_solve_fused)
  running the inner iLQR solve of every scenario and K2
  (ops/megasolve.al_update_lanes) updating the multipliers and measuring the
  violation. With cfg.compact the unconverged scenarios are permuted to the
  front of the batch between outer steps (results bit for bit those
  without).
* `_solve_lanes` (sweep "seq" on the same class where cfg.mega=False or
  mega_fits refuses, as it does at every m > 16): the staged path; on the
  card K3-K6 take every problem of the class at any m and any number of
  obstacle rows (ops/rollout.unsupported: K3 takes any stage shape, K4 and
  K5 their device-memory forms where the rows overflow their tiles), bound
  by device memory alone. Each inner
  iteration is four launches, K4 expansions, K3 Riccati sweep, K5
  line-search merits and K6 accepted rollout, on lane-major data ([N, rows,
  B]) with no transposes inside the inner loop; the AL update between outer
  steps runs in plain PyTorch.
* `_solve_hybrid` (everything else: LiDAR rays, RK4, user dynamics
  (dyn_fn), sweep="scan"): the reference's hybrid. Stage expansions in
  plain PyTorch (dynamics Jacobians
  by torch.func.jacfwd where they are not analytic), then K3 through
  `riccati_fused` at the problem's own stage shape (or the associative-scan
  LQR of ops/assoc_lqr.py under sweep="scan"), then the line-search
  cascade: K5 and K6 on the fused kernels' class (rollout.supports), plain
  PyTorch rollouts of every candidate elsewhere.

Per-scenario convergence masks, inner and outer iteration counts and warm
starts follow the reference, each route its own (they count inner
iterations differently). On CUDA tensors a shape a kernel of the route is
not built for raises NotImplementedError: there is no fallback.

No padding: the reference pads B to a multiple of its 128-lane tile; the
CUDA kernels mask the ragged edge of their grid instead.
"""

from __future__ import annotations

import dataclasses

import torch

from nmpc_tpu_torch.ocp import problem as P
from nmpc_tpu_torch.ocp.problem import OCP
from nmpc_tpu_torch.ops import rollout
from nmpc_tpu_torch.ops.cuda_build import lane, std
from nmpc_tpu_torch.ops.expansions import expansions_fused
from nmpc_tpu_torch.ops.megasolve import (al_update_lanes, cuda_unsupported, inner_solve_fused,
                                          mega_fits)
from nmpc_tpu_torch.ops.riccati import riccati_fused, riccati_lanes
from nmpc_tpu_torch.solver.alilqr import (ALILQRConfig, SolveResult, WarmStart, _forward_rollout,
                                          _stage_expansion, _stage_jacobians, one_scenario,
                                          resolve_sweep, scan_gains)


def _finalize(ocp_b: OCP, X, U, cfg: ALILQRConfig):
    """Final feasibility restoration (see ALILQRConfig.final_clamp): project
    the controls onto the actuator box, re-roll, recompute cost/viol."""
    if cfg.final_clamp:
        U = torch.maximum(torch.minimum(U, ocp_b.u_hi), ocp_b.u_lo)
        X = P.rollout(ocp_b, U)
    viol = P.max_violation(ocp_b, X, U)
    cost = P.total_cost(ocp_b, X, U)
    return X, U, cost, viol


def _solve_mega(ocp_b: OCP, U, lam, mu, cfg: ALILQRConfig, *,
                graph_safe: bool = False) -> SolveResult:
    """Kernel path: per AL outer step one K1 launch (the whole inner solve)
    and one K2 launch (multiplier update + violation).

    The loop ends once every scenario is done (a host sync a step, as the
    reference's lax.while_loop ends on the device). While some scenario
    still runs, the scenarios already done re-run K1 from their own U with
    their frozen lam and mu and take its output (U and Xs), as the
    reference does; their lam, mu, counts and done flag stay.

    graph_safe: no host sync. Every one of cfg.n_outer steps launches K1 and
    K2; a step after the one at which the last scenario finished keeps U and
    Xs as they stood (torch.where on the batch's "all done", a tensor), and
    its lam, mu and counts stay by the masks above. The result is the
    early-exit loop's bit for bit, at any B (the form a CUDA graph captures,
    tools/latency.py). It refuses cfg.compact, whose permutation is a host
    decision.

    cfg.compact: before an outer step at which some scenario is done, the
    batch is permuted so that the scenarios still running come first (a
    stable sort on `done`; the permutation composes across steps, the
    problem data is gathered by it, and the outputs are put back in the
    caller's order at the end). Each scenario's arithmetic is the same
    wherever it sits, so the results are those without compaction, bit for
    bit."""
    if graph_safe and cfg.compact:
        raise ValueError("_solve_mega: cfg.compact permutes the batch on a host decision; "
                         "the graph-safe form does not take it")
    B = ocp_b.x0.shape[0]
    dev = ocp_b.device
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    inner_tot = torch.zeros(B, dtype=torch.int32, device=dev)
    outer_vec = torch.zeros(B, dtype=torch.int32, device=dev)
    perm = torch.arange(B, device=dev)
    per_mov = ocp_b.n_mov and ocp_b.mov_obs.dim() == 4
    ocp_k = ocp_b
    Xs = None
    for _ in range(cfg.n_outer):
        settled = None                  # graph_safe: every scenario done before this step
        if graph_safe:
            settled = None if Xs is None else done.all()
        elif Xs is not None and bool(done.all()):
            break
        if cfg.compact and bool(done.any()):
            order = torch.argsort(done.to(torch.uint8), stable=True)   # running first
            perm = perm[order]
            U, lam, mu, done, inner_tot, outer_vec = (
                a[order] for a in (U, lam, mu, done, inner_tot, outer_vec))
            ocp_k = dataclasses.replace(
                ocp_b, x0=ocp_b.x0[perm], xref=ocp_b.xref[perm],
                mov_obs=ocp_b.mov_obs[perm] if per_mov else ocp_b.mov_obs)
        outer_vec = outer_vec + (~done).to(torch.int32)
        Xs_new, U_new, _, iters = inner_solve_fused(ocp_k, ocp_k.x0, ocp_k.xref, lam, mu, U, cfg)
        if settled is None:
            Xs, U = Xs_new, U_new
        else:
            Xs, U = torch.where(settled, Xs, Xs_new), torch.where(settled, U, U_new)
        # scenarios done before this step re-ran a no-op pass: don't count it
        iters = torch.where(done, torch.zeros_like(iters), iters)
        lam_new, viol = al_update_lanes(ocp_k, Xs, U, lam, mu, cfg.lam_max)
        newly = viol < cfg.tol_con
        lam = torch.where(done[:, None, None], lam, lam_new)
        mu = torch.where(done | newly, mu,
                         torch.clamp(mu * cfg.mu_factor, max=cfg.mu_max))
        done = done | newly
        inner_tot = inner_tot + iters
    if cfg.compact:
        inv = torch.argsort(perm)
        U, lam, mu, done, inner_tot, outer_vec = (
            a[inv] for a in (U, lam, mu, done, inner_tot, outer_vec))
        Xs = None if Xs is None else Xs[inv]
    if Xs is None:  # n_outer == 0: the warm controls, rolled out
        X = P.rollout(ocp_b, U)
    else:
        # terminal state for the full trajectory output
        xN = P.step_dynamics(ocp_b, Xs[:, -1], U[:, -1])
        X = torch.cat([Xs, xN[:, None]], dim=1)
    X, U, cost, viol = _finalize(ocp_b, X, U, cfg)
    return SolveResult(X=X, U=U, lam=lam, mu=mu, cost=cost, viol=viol,
                       inner_iters=inner_tot, outer_iters=outer_vec,
                       converged=done)


def _mov_lanes(ocp_b: OCP, B: int):
    """Lane-major moving-obstacle schedule [N, 2 n_mov, B] (None without
    moving obstacles). A shared [N, n_mov, 2] schedule is broadcast; a
    per-scenario one has shape [B, N, n_mov, 2]."""
    if not ocp_b.n_mov:
        return None
    mov = ocp_b.mov_obs
    if mov.dim() == 3:
        mov = mov[None].expand(B, *mov.shape)
    return lane(mov.reshape(B, ocp_b.N, 2 * ocp_b.n_mov))


def _al_update(ocp_b: OCP, X, U, lam, mu, done, cfg: ALILQRConfig):
    """The AL outer step's update in plain PyTorch on the masked constraints
    of (X [B, N+1, n], U): (lam, mu, done, newly done) for the scenarios not
    yet done (the others keep theirs)."""
    cmask = P.masked_trajectory_constraints(ocp_b, X, U)
    viol = torch.clamp(-torch.amin(cmask, dim=(1, 2)), min=0.0)
    lam_new = torch.clamp(lam - mu[:, None, None] * cmask, min=0.0, max=cfg.lam_max)
    newly = viol < cfg.tol_con
    lam = torch.where(done[:, None, None], lam, lam_new)
    mu = torch.where(done | newly, mu, torch.clamp(mu * cfg.mu_factor, max=cfg.mu_max))
    return lam, mu, done | newly


def _solve_lanes(ocp_b: OCP, U, lam, mu, cfg: ALILQRConfig) -> SolveResult:
    """Staged path: per inner iteration one launch each of K4 (expansions),
    K3 (Riccati sweep), K5 (merits of the alpha grid) and K6 (accepted
    rollout), all on lane-major data; the AL update between outer steps in
    plain PyTorch on the masked constraints.

    Semantics of the reference's `_solve_lanes`, which differ from the
    megakernel's on purpose: one initial K6 rollout with zero gains and
    alpha 0; each outer step restarts the inner done mask, so scenarios that
    are already converged keep iterating (their lam and mu frozen) and their
    iterations count; an iteration counts at its start for every scenario
    not yet done; the line search is always the grid of cfg.alphas with the
    Armijo test, taking the argmin of the passing candidates and accepting
    it only if it also lowers the merit (cfg.ls is not read); the inner stop
    is done |= ~accepted | (rel < tol_cost)."""
    B = ocp_b.x0.shape[0]
    N, n, nu = ocp_b.N, ocp_b.nx, ocp_b.nu
    kw = dict(dtype=ocp_b.x0.dtype, device=ocp_b.device)
    alphas = torch.tensor(cfg.alphas, **kw)
    ls_alphas = (0.0,) + tuple(cfg.alphas)
    mov_l = _mov_lanes(ocp_b, B)
    x0_l = lane(ocp_b.x0)            # [n, B]
    xref_l = lane(ocp_b.xref)        # [N, n, B]
    # initial rollout: alpha 0 and zero gains give u = U exactly
    Xtail_l, U_l = rollout.rollout_alpha_lanes(
        ocp_b, x0_l, torch.zeros((N, n, B), **kw), lane(U), torch.zeros((N, nu, B), **kw),
        torch.zeros((N, nu, n, B), **kw), torch.zeros((B,), **kw))

    def stages(Xtail_l):  # states 0..N-1
        return torch.cat([x0_l[None], Xtail_l[:-1]])

    def inner(Xtail_l, U_l, lam_l, mu):
        done = torch.zeros(B, dtype=torch.bool, device=ocp_b.device)
        it_vec = torch.zeros(B, dtype=torch.int32, device=ocp_b.device)
        for _ in range(cfg.n_inner):
            if bool(done.all()):
                break
            it_vec = it_vec + (~done).to(torch.int32)
            Xs_l = stages(Xtail_l)
            exp = expansions_fused(ocp_b, Xs_l, U_l, xref_l, lam_l, mu, mov_l)
            kff_l, Kfb_l, dV1 = riccati_lanes(exp, cfg.reg)
            costs_all = rollout.linesearch_costs_lanes(
                ocp_b, x0_l, Xs_l, U_l, kff_l, Kfb_l, xref_l, lam_l, mu, ls_alphas, mov_l)
            cost_cur, costs = costs_all[0], costs_all[1:]
            expected = cfg.armijo * alphas[:, None] * torch.clamp(-dV1, min=0.0)[None]
            ok = (cost_cur[None] - costs) >= expected
            best = torch.argmin(torch.where(ok, costs, torch.inf), dim=0)[None]
            costn = costs.gather(0, best)[0]
            okb = ok.gather(0, best)[0] & (costn < cost_cur)
            upd = okb & ~done
            alpha_best = torch.where(upd, alphas[best[0]], 0.0)
            Xtail_l, U_l = rollout.rollout_alpha_lanes(
                ocp_b, x0_l, Xs_l, U_l, kff_l, Kfb_l, alpha_best)
            costn = torch.where(upd, costn, cost_cur)
            rel = (cost_cur - costn) / (1.0 + torch.abs(cost_cur))
            done = done | ~okb | (rel < cfg.tol_cost)
        return Xtail_l, U_l, it_vec

    done = torch.zeros(B, dtype=torch.bool, device=ocp_b.device)
    inner_tot = torch.zeros(B, dtype=torch.int32, device=ocp_b.device)
    outer_vec = torch.zeros(B, dtype=torch.int32, device=ocp_b.device)
    for _ in range(cfg.n_outer):
        if bool(done.all()):
            break
        outer_vec = outer_vec + (~done).to(torch.int32)
        Xtail_l, U_l, iters = inner(Xtail_l, U_l, lane(lam), mu.contiguous())
        # AL update on the masked constraints (the terminal state is a dummy:
        # no row reads it)
        Xs = std(stages(Xtail_l))
        lam, mu, done = _al_update(ocp_b, torch.cat([Xs, Xs[:, -1:]], dim=1), std(U_l), lam, mu,
                                   done, cfg)
        inner_tot = inner_tot + iters
    X = torch.cat([ocp_b.x0[:, None], std(Xtail_l)], dim=1)
    X, U, cost, viol = _finalize(ocp_b, X, std(U_l), cfg)
    return SolveResult(X=X, U=U, lam=lam, mu=mu, cost=cost, viol=viol,
                       inner_iters=inner_tot, outer_iters=outer_vec,
                       converged=done)


def hybrid_expansions(ocp_b: OCP, X, U, lam, mu) -> tuple:
    """The hybrid route's stage blocks in plain PyTorch, the inputs of its
    backward pass (K3 at the problem's own stage shape): the dynamics
    Jacobians and the AL merit's expansion at (X [B, N+1, n], U [B, N, nu],
    lam [B, N, n_con], mu [B]) -> (A [B, N, n, n], B [B, N, n, nu], lx, lu,
    lxx, luu, lux), each with every batch and stage axis written out."""
    Xs = X[:, :-1]
    mov = ocp_b.mov_obs if ocp_b.n_mov else None
    A, Bm = _stage_jacobians(ocp_b, Xs, U)
    exp = (A, Bm, *_stage_expansion(ocp_b, Xs, U, ocp_b.xref, lam, mov, mu[:, None]))
    return tuple(t.expand(*Xs.shape[:2], *t.shape[2:]) for t in exp)


def _solve_hybrid(ocp_b: OCP, U, lam, mu, cfg: ALILQRConfig, sweep: str) -> SolveResult:
    """The reference's hybrid route (alilqr_batched.py:486-610): per inner
    iteration the stage expansions in plain PyTorch, the backward pass by K3
    (`riccati_fused`, at the problem's own stage shape) or, with sweep
    "scan", by the associative-scan LQR, then the line search: where the
    staged kernels take the problem (ops/rollout.unsupported is None), K5
    for every candidate's merit (row 0, alpha 0, is the current iterate's)
    and K6 for the accepted rollout; elsewhere every candidate rolled in
    plain PyTorch at once and the best kept. The AL update between outer
    steps runs in plain PyTorch. Semantics as `_solve_lanes`: each outer step
    restarts the inner done mask, an iteration counts at its start for every
    scenario not yet done, done |= ~accepted | (rel < tol_cost)."""
    B = ocp_b.x0.shape[0]
    kw = dict(dtype=ocp_b.x0.dtype, device=ocp_b.device)
    staged = rollout.supports(ocp_b)
    alphas = torch.tensor(cfg.alphas, **kw)
    ls_alphas = (0.0,) + tuple(cfg.alphas)   # row 0 = current-iterate merit
    reg_I = cfg.reg * torch.eye(ocp_b.nu, **kw)
    mov_b = None
    if ocp_b.n_mov and staged:
        mov = ocp_b.mov_obs
        mov_b = mov if mov.dim() == 4 else mov[None].expand(B, *mov.shape)
    rows = torch.arange(B, device=ocp_b.device)
    X = P.rollout(ocp_b, U)

    def inner(X, U, lam, mu):
        # with K5 the current iterate's merit is row 0 of its costs
        cost = torch.zeros(B, **kw) if staged else P.al_total_cost(ocp_b, X, U, lam, mu)
        done = torch.zeros(B, dtype=torch.bool, device=ocp_b.device)
        it_vec = torch.zeros(B, dtype=torch.int32, device=ocp_b.device)
        for _ in range(cfg.n_inner):
            if bool(done.all()):
                break
            it_vec = it_vec + (~done).to(torch.int32)
            A, Bm, lx, lu, lxx, luu, lux = hybrid_expansions(ocp_b, X, U, lam, mu)
            if sweep == "scan":
                kff, Kfb, dV1 = scan_gains(A, Bm, lx, lu, lxx, luu + reg_I, lux)
            else:
                kff, Kfb, dV1 = riccati_fused(A, Bm, lx, lu, lxx, luu, lux, reg=cfg.reg)
            if staged:
                costs = rollout.linesearch_costs(ocp_b, ocp_b.x0, X, U, kff, Kfb, ocp_b.xref, lam,
                                                 mu, ls_alphas, mov_b)
                cost_cur, costs = costs[0], costs[1:]
            else:
                cost_cur = cost
                Xc, Uc = _forward_rollout(ocp_b, X, U, kff, Kfb, alphas[:, None])  # [A, B, ...]
                costs = P.al_total_cost(ocp_b, Xc, Uc, lam, mu)
            expected = cfg.armijo * alphas[:, None] * torch.clamp(-dV1, min=0.0)[None]
            ok = (cost_cur[None] - costs) >= expected
            best = torch.argmin(torch.where(ok, costs, torch.inf), dim=0)
            costn = costs[best, rows]
            okb = ok[best, rows] & (costn < cost_cur)
            upd = okb & ~done
            if staged:
                X, U = rollout.rollout_alpha(ocp_b, ocp_b.x0, X, U, kff, Kfb,
                                             torch.where(upd, alphas[best], 0.0))
            else:
                X = torch.where(upd[:, None, None], Xc[best, rows], X)
                U = torch.where(upd[:, None, None], Uc[best, rows], U)
            cost = torch.where(upd, costn, cost_cur)
            rel = (cost_cur - cost) / (1.0 + torch.abs(cost_cur))
            done = done | ~okb | (rel < cfg.tol_cost)
        return X, U, it_vec

    done = torch.zeros(B, dtype=torch.bool, device=ocp_b.device)
    inner_tot = torch.zeros(B, dtype=torch.int32, device=ocp_b.device)
    outer_vec = torch.zeros(B, dtype=torch.int32, device=ocp_b.device)
    for _ in range(cfg.n_outer):
        if bool(done.all()):
            break
        outer_vec = outer_vec + (~done).to(torch.int32)
        X, U, iters = inner(X, U, lam, mu)
        lam, mu, done = _al_update(ocp_b, X, U, lam, mu, done, cfg)
        inner_tot = inner_tot + iters
    X, U, cost, viol = _finalize(ocp_b, X, U, cfg)
    return SolveResult(X=X, U=U, lam=lam, mu=mu, cost=cost, viol=viol,
                       inner_iters=inner_tot, outer_iters=outer_vec,
                       converged=done)


def _polar_seed(ocp_b: OCP) -> torch.Tensor:
    """Cold-start controls from a per-robot polar go-to-goal law rolled
    through the model (ALILQRConfig.cold_seed='polar'): turn to the goal
    bearing, drive proportional to distance, clipped to the actuator box.
    The seed ignores constraints (lam starts at 0 and mu at mu_init, as
    with a zero seed). Returns U [B, N, nu]."""
    m, B = ocp_b.m, ocp_b.x0.shape[0]
    gp = ocp_b.xref[:, -1, : 3 * m].reshape(B, m, 3)
    v_hi, w_hi = ocp_b.u_hi[0::2][:m], ocp_b.u_hi[1::2][:m]
    x, us = ocp_b.x0, []
    for _ in range(ocp_b.N):
        pose = x[:, : 3 * m].reshape(B, m, 3)
        ex, ey = gp[..., 0] - pose[..., 0], gp[..., 1] - pose[..., 1]
        dist = torch.hypot(ex, ey)
        delta = torch.atan2(ey, ex) - pose[..., 2]
        delta = torch.atan2(torch.sin(delta), torch.cos(delta))
        v = torch.minimum(torch.maximum(1.5 * dist * torch.cos(delta), -v_hi), v_hi)
        v = torch.where(torch.abs(delta) < 1.2, v, 0.0)
        w = torch.minimum(torch.maximum(1.5 * delta, -w_hi), w_hi)
        u = torch.stack([v, w], dim=-1).reshape(B, 2 * m)
        x = P.step_dynamics(ocp_b, x, u)
        us.append(u)
    return torch.stack(us, dim=1)


def route(ocp_b: OCP, cfg: ALILQRConfig) -> str:
    """The route `solve_batched` takes for this batch and config, from its
    static shape and cfg alone, by the reference's rule
    (alilqr_batched.py:492-500): "mega" (the megakernel route, K1 and K2)
    where the fused kernels take the problem (rollout.supports), the sweep is
    "seq", cfg.mega and K1's block fits (megasolve.mega_fits); else "staged"
    (K4, K3, K5, K6) on the same class with sweep "seq"; else "hybrid". An
    unknown cfg.sweep raises ValueError. mega_fits is the card's admission,
    not the reference's TPU VMEM estimate: pair-only at N=10, m = 14-16 take
    the megakernel route here and the staged route in the reference."""
    if rollout.supports(ocp_b) and resolve_sweep(cfg, ocp_b.N) == "seq":
        return "mega" if cfg.mega and mega_fits(ocp_b, cfg) else "staged"
    return "hybrid"


def _warm_or_cold(ocp_b: OCP, warm: WarmStart | None, cfg: ALILQRConfig) -> WarmStart:
    """The warm start, or the cold one cfg.cold_seed asks for; raises
    ValueError for an unknown cfg.ls or cfg.cold_seed."""
    if cfg.ls not in ("cascade", "adaptive"):
        raise ValueError(f"solve_batched: unknown line search {cfg.ls!r}")
    if cfg.cold_seed not in ("zero", "polar"):
        raise ValueError(f"solve_batched: unknown cold_seed {cfg.cold_seed!r}")
    if warm is not None:
        return warm
    B, N, nu, nc = ocp_b.x0.shape[0], ocp_b.N, ocp_b.nu, ocp_b.n_con
    kw = dict(dtype=ocp_b.x0.dtype, device=ocp_b.device)
    # the polar seed is ignored for ray-augmented problems, as in the reference
    U0 = (_polar_seed(ocp_b) if cfg.cold_seed == "polar" and ocp_b.num_rays == 0
          else torch.zeros((B, N, nu), **kw))
    return WarmStart(U=U0, lam=torch.zeros((B, N, nc), **kw),
                     mu=torch.full((B,), cfg.mu_init, **kw))


def _mega_admitted(ocp_b: OCP, cfg: ALILQRConfig) -> None:
    why = cuda_unsupported(ocp_b, cfg)
    if why is not None:
        raise NotImplementedError(f"solve_batched: the megakernel route does not cover {why}")


def solve_batched(ocp_b: OCP, warm: WarmStart | None = None,
                  cfg: ALILQRConfig = ALILQRConfig()) -> SolveResult:
    """Solve a batch of OCPs (batch axis on x0 [B, nx] and xref [B, N, nx];
    mov_obs [B, N, n_mov, 2] for per-scenario moving-obstacle schedules).

    Route (the reference's, `route`): with sweep "seq" on a problem of the
    fused kernels' class (rollout.supports), `_solve_mega` if cfg.mega and
    K1's block fits (megasolve.mega_fits), else the staged `_solve_lanes`;
    everything else `_solve_hybrid`. No other setting of cfg
    picks the route: an unknown cfg.ls, cfg.sweep or cfg.cold_seed raises
    ValueError. On CUDA tensors every kernel of the route runs its hand
    kernel or raises; on CPU tensors the plain PyTorch versions run."""
    warm = _warm_or_cold(ocp_b, warm, cfg)
    way = route(ocp_b, cfg)
    if way == "mega":
        _mega_admitted(ocp_b, cfg)
        return _solve_mega(ocp_b, warm.U, warm.lam, warm.mu, cfg)
    if way == "staged":
        return _solve_lanes(ocp_b, warm.U, warm.lam, warm.mu, cfg)
    return _solve_hybrid(ocp_b, warm.U, warm.lam, warm.mu, cfg, resolve_sweep(cfg, ocp_b.N))


def solve_batched_graph(ocp_b: OCP, warm: WarmStart | None = None,
                        cfg: ALILQRConfig = ALILQRConfig()) -> SolveResult:
    """`solve_batched` on its megakernel route with no host sync, the form a
    CUDA graph captures: all cfg.n_outer AL steps run, K1 and K2 each, and
    the result is `solve_batched`'s bit for bit (`_solve_mega`'s
    graph_safe). Raises NotImplementedError where solve_batched would take
    another route, and ValueError for cfg.compact."""
    warm = _warm_or_cold(ocp_b, warm, cfg)
    way = route(ocp_b, cfg)
    if way != "mega":
        raise NotImplementedError(f"solve_batched_graph: the batch takes the {way} route, "
                                  f"not the megakernel route")
    _mega_admitted(ocp_b, cfg)
    return _solve_mega(ocp_b, warm.U, warm.lam, warm.mu, cfg, graph_safe=True)


def solve_one(ocp: OCP, warm: WarmStart | None = None,
              cfg: ALILQRConfig = ALILQRConfig()) -> SolveResult:
    """Single-scenario solve through the batched path (B = 1): unbatched
    OCP / WarmStart in, unbatched SolveResult out."""
    return one_scenario(solve_batched, ocp, warm, cfg)


def solve_one_graph(ocp: OCP, warm: WarmStart | None = None,
                    cfg: ALILQRConfig = ALILQRConfig()) -> SolveResult:
    """`solve_one` with no host sync (`solve_batched_graph` at B = 1): bit
    for bit `solve_one`'s result, with cfg.n_outer K1 launches."""
    return one_scenario(solve_batched_graph, ocp, warm, cfg)
