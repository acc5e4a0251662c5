"""Batch-native AL-iLQR: the production path for scenario fleets. Port of
`solve_batched`, `solve_one`, `_solve_mega` and `_finalize` from
nmpc_tpu/solver/alilqr_batched.py.

Each AL outer step is two kernel launches over the whole batch: K1
(ops/megasolve.inner_solve_fused) runs the inner iLQR solve of every
scenario, K2 (ops/megasolve.al_update_lanes) updates the multipliers and
measures the violation. Between them only masks and the mu schedule run
here. Per-scenario convergence masks, inner and outer iteration counts and
warm starts follow the reference; the loop ends when every scenario is done
or after n_outer steps.

No padding: the reference pads B to a multiple of its 128-lane tile; the
CUDA kernels mask the ragged edge of their grid instead.

Not ported yet: the staged `_solve_lanes` path (cfg.mega=False), the
`sweep="scan"` hybrid, the polar cold seed and `compact=True`.
"""

from __future__ import annotations

import dataclasses

import torch

from nmpc_tpu_torch.ocp import problem as P
from nmpc_tpu_torch.ocp.problem import OCP
from nmpc_tpu_torch.ops import rollout
from nmpc_tpu_torch.ops.megasolve import al_update_lanes, inner_solve_fused
from nmpc_tpu_torch.solver.alilqr import ALILQRConfig, SolveResult, WarmStart


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


def solve_batched(ocp_b: OCP, warm: WarmStart | None = None,
                  cfg: ALILQRConfig = ALILQRConfig()) -> SolveResult:
    """Solve a batch of OCPs (batch axis on x0 [B, nx] and xref [B, N, nx]).

    On CUDA tensors every numeric step of the AL loop runs in the two hand
    kernels; on CPU tensors in their plain PyTorch versions."""
    if not rollout.supports(ocp_b):
        raise NotImplementedError(
            "solve_batched: LiDAR-ray, RK4 and dyn_fn problems take the "
            "reference's XLA path, which is not ported yet")
    if not cfg.mega:
        raise NotImplementedError("solve_batched: the staged path (mega=False) is not ported yet")
    if cfg.sweep == "scan":
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
    return _solve_mega(ocp_b, warm.U, warm.lam, warm.mu, cfg)


def solve_one(ocp: OCP, warm: WarmStart | None = None,
              cfg: ALILQRConfig = ALILQRConfig()) -> SolveResult:
    """Single-scenario solve through the batched path (B = 1): unbatched
    OCP / WarmStart in, unbatched SolveResult out."""
    ocp_b = dataclasses.replace(ocp, x0=ocp.x0[None], xref=ocp.xref[None])
    warm_b = None if warm is None else WarmStart(
        *(torch.as_tensor(a, device=ocp.device)[None] for a in (warm.U, warm.lam, warm.mu)))
    res = solve_batched(ocp_b, warm_b, cfg)
    return SolveResult(**{f.name: getattr(res, f.name)[0]
                          for f in dataclasses.fields(res)})
