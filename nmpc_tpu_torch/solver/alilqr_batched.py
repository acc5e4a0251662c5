"""Batch-native AL-iLQR: the production path for scenario fleets. Port of
`solve_batched`, `solve_one`, `_solve_mega`, `_solve_lanes` and `_finalize`
from nmpc_tpu/solver/alilqr_batched.py.

Two routes, chosen as the reference chooses them, from cfg.mega and the
problem's static shape before any launch, the same on CPU and CUDA tensors:

* `_solve_mega` (cfg.mega and K1 admits the problem: pair, static-obstacle,
  moving-obstacle and box rows): each AL outer step is two kernel launches
  over the whole batch, K1 (ops/megasolve.inner_solve_fused) running the
  inner iLQR solve of every scenario and K2 (ops/megasolve.al_update_lanes)
  updating the multipliers and measuring the violation. Family H and the
  robot-parallel modes' moving-obstacle subproblems take it by default, as
  the reference sends them to its megakernel.
* `_solve_lanes` (cfg.mega=False): the staged path. Each inner iteration
  is four launches, K4 expansions, K3 Riccati sweep, K5 line-search merits
  and K6 accepted rollout, on lane-major data ([N, rows, B]) with no
  transposes inside the inner loop; the AL update between outer steps runs
  in plain PyTorch.

Per-scenario convergence masks, inner and outer iteration counts and warm
starts follow the reference, each route its own (they count inner
iterations differently). What neither route covers raises
NotImplementedError: LiDAR rays, RK4, dyn_fn, m outside
cuda_build.ROBOT_COUNTS, sweep="scan", compact=True, cold_seed="polar".

No padding: the reference pads B to a multiple of its 128-lane tile; the
CUDA kernels mask the ragged edge of their grid instead.
"""

from __future__ import annotations

import torch

from nmpc_tpu_torch.ocp import problem as P
from nmpc_tpu_torch.ocp.problem import OCP
from nmpc_tpu_torch.ops import rollout
from nmpc_tpu_torch.ops.cuda_build import lane, std
from nmpc_tpu_torch.ops.expansions import expansions_fused
from nmpc_tpu_torch.ops.megasolve import al_update_lanes, cuda_unsupported, inner_solve_fused
from nmpc_tpu_torch.ops.riccati import riccati_lanes
from nmpc_tpu_torch.solver.alilqr import SCAN_N_MIN, ALILQRConfig, SolveResult, WarmStart, one_scenario


def _finalize(ocp_b: OCP, X, U, cfg: ALILQRConfig):
    """Final feasibility restoration (see ALILQRConfig.final_clamp): project
    the controls onto the actuator box, re-roll, recompute cost/viol."""
    if cfg.final_clamp:
        U = torch.maximum(torch.minimum(U, ocp_b.u_hi), ocp_b.u_lo)
        X = P.rollout(ocp_b, U)
    viol = P.max_violation(ocp_b, X, U)
    cost = P.total_cost(ocp_b, X, U)
    return X, U, cost, viol


def _solve_mega(ocp_b: OCP, U, lam, mu, cfg: ALILQRConfig) -> SolveResult:
    """Kernel path: per AL outer step one K1 launch (the whole inner solve)
    and one K2 launch (multiplier update + violation)."""
    B = ocp_b.x0.shape[0]
    dev = ocp_b.device
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    inner_tot = torch.zeros(B, dtype=torch.int32, device=dev)
    outer_vec = torch.zeros(B, dtype=torch.int32, device=dev)
    Xs = None
    for _ in range(cfg.n_outer):
        if Xs is not None and bool(done.all()):
            break
        outer_vec = outer_vec + (~done).to(torch.int32)
        Xs, U, _, iters = inner_solve_fused(ocp_b, ocp_b.x0, ocp_b.xref, lam, mu, U, cfg)
        # scenarios done before this step re-ran a no-op pass: don't count it
        iters = torch.where(done, torch.zeros_like(iters), iters)
        lam_new, viol = al_update_lanes(ocp_b, Xs, U, lam, mu, cfg.lam_max)
        newly = viol < cfg.tol_con
        lam = torch.where(done[:, None, None], lam, lam_new)
        mu = torch.where(done | newly, mu,
                         torch.clamp(mu * cfg.mu_factor, max=cfg.mu_max))
        done = done | newly
        inner_tot = inner_tot + iters
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
        cmask = P.masked_trajectory_constraints(
            ocp_b, torch.cat([Xs, Xs[:, -1:]], dim=1), std(U_l))
        viol = torch.clamp(-torch.amin(cmask, dim=(1, 2)), min=0.0)
        lam_new = torch.clamp(lam - mu[:, None, None] * cmask, min=0.0, max=cfg.lam_max)
        newly = viol < cfg.tol_con
        lam = torch.where(done[:, None, None], lam, lam_new)
        mu = torch.where(done | newly, mu, torch.clamp(mu * cfg.mu_factor, max=cfg.mu_max))
        done = done | newly
        inner_tot = inner_tot + iters
    X = torch.cat([ocp_b.x0[:, None], std(Xtail_l)], dim=1)
    X, U, cost, viol = _finalize(ocp_b, X, std(U_l), cfg)
    return SolveResult(X=X, U=U, lam=lam, mu=mu, cost=cost, viol=viol,
                       inner_iters=inner_tot, outer_iters=outer_vec,
                       converged=done)


def solve_batched(ocp_b: OCP, warm: WarmStart | None = None,
                  cfg: ALILQRConfig = ALILQRConfig()) -> SolveResult:
    """Solve a batch of OCPs (batch axis on x0 [B, nx] and xref [B, N, nx];
    mov_obs [B, N, n_mov, 2] for per-scenario moving-obstacle schedules).

    Route: `_solve_mega` if cfg.mega and K1 admits the problem's shape
    (megasolve.cuda_unsupported), else the staged `_solve_lanes`. No other
    setting of cfg picks the route: an unknown cfg.ls raises ValueError, and
    what the megakernel route does not cover raises NotImplementedError. On
    CUDA tensors every numeric step of the inner loop runs in the hand
    kernels; on CPU tensors in their plain PyTorch versions."""
    why = rollout.unsupported(ocp_b)
    if why is not None:
        raise NotImplementedError(f"solve_batched: neither route covers {why}")
    if cfg.ls not in ("cascade", "adaptive"):
        raise ValueError(f"solve_batched: unknown line search {cfg.ls!r}")
    sweep = cfg.sweep
    if sweep == "auto":
        sweep = "scan" if ocp_b.N >= SCAN_N_MIN else "seq"
    if sweep == "scan":
        raise NotImplementedError("solve_batched: sweep='scan' is not ported yet")
    if cfg.compact:
        raise NotImplementedError("solve_batched: compact=True is not ported yet")
    B = ocp_b.x0.shape[0]
    N, nu, nc = ocp_b.N, ocp_b.nu, ocp_b.n_con
    kw = dict(dtype=ocp_b.x0.dtype, device=ocp_b.device)
    if warm is None:
        if cfg.cold_seed != "zero":
            raise NotImplementedError(f"solve_batched: cold_seed={cfg.cold_seed!r} is not ported yet")
        warm = WarmStart(U=torch.zeros((B, N, nu), **kw),
                         lam=torch.zeros((B, N, nc), **kw),
                         mu=torch.full((B,), cfg.mu_init, **kw))
    if cfg.mega and cuda_unsupported(ocp_b) is None:
        why = cuda_unsupported(ocp_b, cfg)
        if why is not None:
            raise NotImplementedError(f"solve_batched: the megakernel route does not cover {why}")
        return _solve_mega(ocp_b, warm.U, warm.lam, warm.mu, cfg)
    return _solve_lanes(ocp_b, warm.U, warm.lam, warm.mu, cfg)


def solve_one(ocp: OCP, warm: WarmStart | None = None,
              cfg: ALILQRConfig = ALILQRConfig()) -> SolveResult:
    """Single-scenario solve through the batched path (B = 1): unbatched
    OCP / WarmStart in, unbatched SolveResult out."""
    return one_scenario(solve_batched, ocp, warm, cfg)
