"""Where K1's time goes: K1 with one phase ablated at a fixed iteration count
(K8). Port of tools/exp_mega_phases.py.

Two designs (`design=`):
  warp   (default) the solver's K1 itself, csrc/inner_warp.cuh (one warp per
         scenario), built with the template flags of `inner_solve_warp`
         (kPhase, kEarlyExit; csrc/tools.cu parts 9-15) and launched at K1's
         geometry, so the ablations cannot drift from the kernel the solver
         runs;
  first  K1's first design, csrc/megasolve.cuh (one thread per scenario,
         parts 1-7), which no route has launched since the warp design: the
         A/B baseline.
Modes, with the reference's semantics:

  full        K1's iteration: sweep, line search (K1's, per cfg.ls), accepted
              step (the warp design's candidate rollout stored it; the first
              design rolls it out again)
  inv_solve   the gains through the explicit inverse of the Cholesky factor;
              NO line search (alpha = 1), as in the reference, so its saving
              reads against no_ls, not against full
  no_ls       alpha = 1 always: no candidate rollouts
  no_solve    diagonal gains -Qu / (Quu_ii + reg): factorization and
              substitutions ablated; alpha = 1
  no_expcon   LQR-only expansions: no constraint row at all (box rows
              included); alpha = 1
  sweep_only  no merit, no rollouts: X and U never change, the cost is 0

Every mode runs n_iter iterations on every scenario, with no early exit, and
every mode but `full` and `sweep_only` returns the initial merit as its cost
(only `full` line-searches). The ablations give wrong solver output on
purpose: they rank where the cycles go. `phase_ablation(..., early_exit=True)`
(mode full only) is K1 itself, bit for bit (design "warp": the solver's K1;
"first": its first design). CPU tensors take the plain version whatever the
design.

    python -m nmpc_tpu_torch.tools.exp_mega_phases [--design first]

times the six modes on the card at the reference's inputs (six_robot_antipodal
N=10, B=32768, lam = 0, mu = 10, U = 0, n_outer * n_inner = 72 iterations),
in turns with `full` first and last, on the warp design (or the first).
"""

from __future__ import annotations

import dataclasses
import functools
import statistics
import sys

import torch

from nmpc_tpu_torch.ocp import problem as P
from nmpc_tpu_torch.ops import cuda_build, megasolve
from nmpc_tpu_torch.solver.alilqr import ALILQRConfig, _stage_expansion, _stage_jacobians

MODES = ("full", "inv_solve", "no_ls", "no_solve", "no_expcon", "sweep_only")
DESIGNS = ("warp", "first")


def check_design(design: str) -> None:
    if design not in DESIGNS:
        raise ValueError(f"unknown design {design!r}; designs are {DESIGNS}")


def _lqr_expansion(o, Xs, U):
    """The stage expansion without any constraint row."""
    lead = Xs.shape[:-1]
    kw = dict(dtype=Xs.dtype, device=Xs.device)
    lx = 2.0 * o.Qdiag * (Xs - o.xref)
    lu = 2.0 * o.Rdiag * U
    lxx = torch.diag(2.0 * o.Qdiag).expand(*lead, o.nx, o.nx)
    luu = torch.diag(2.0 * o.Rdiag).expand(*lead, o.nu, o.nu)
    return lx, lu, lxx, luu, torch.zeros((*lead, o.nu, o.nx), **kw)


def _sweep(o, cfg: ALILQRConfig, X, U, lam, mu, mode: str):
    """Plain backward sweep of a mode, in K1's formulation: dense blocks of
    the expansion (solver.alilqr), gains from (Quu + reg I), and the value
    update Vx' = Qx + Qux' kff, Vxx' = Qxx + Qux' Kfb (no symmetrisation).
    -> kff [B, N, nu], Kfb [B, N, nu, nx], dV1 [B]."""
    Xs = X[:, :-1]
    A, Bm = _stage_jacobians(o, Xs, U)
    if mode == "no_expcon":
        lx, lu, lxx, luu, lux = _lqr_expansion(o, Xs, U)
    else:
        lx, lu, lxx, luu, lux = _stage_expansion(o, Xs, U, o.xref, lam, None, mu[:, None])
    Bsz, N, n, nu = X.shape[0], o.N, o.nx, o.nu
    kw = dict(dtype=X.dtype, device=X.device)
    eye = torch.eye(nu, **kw)
    Vx = torch.zeros((Bsz, n, 1), **kw)
    Vxx = torch.zeros((Bsz, n, n), **kw)
    dV1 = torch.zeros((Bsz,), **kw)
    kff = torch.empty((Bsz, N, nu), **kw)
    Kfb = torch.empty((Bsz, N, nu, n), **kw)
    for k in reversed(range(N)):
        A_k, B_k = A[:, k], Bm[:, k]
        At, Bt = A_k.transpose(-1, -2), B_k.transpose(-1, -2)
        Qx = lx[:, k, :, None] + At @ Vx
        Qu = lu[:, k, :, None] + Bt @ Vx
        Qxx = lxx[:, k] + At @ Vxx @ A_k
        Qux = lux[:, k] + Bt @ Vxx @ A_k
        Quu = luu[:, k] + Bt @ Vxx @ B_k
        if mode == "no_solve":
            d = 1.0 / (torch.diagonal(Quu, dim1=-2, dim2=-1) + cfg.reg)
            kk, KK = -(d[..., None] * Qu), -(d[..., None] * Qux)
        else:
            L, _ = torch.linalg.cholesky_ex(Quu + cfg.reg * eye)
            rhs = torch.cat([Qu, Qux], dim=-1)
            if mode == "inv_solve":
                Linv = torch.linalg.solve_triangular(L, eye.expand_as(L), upper=False)
                sol = Linv.transpose(-1, -2) @ (Linv @ rhs)
            else:
                sol = torch.cholesky_solve(rhs, L)
            kk, KK = -sol[..., :1], -sol[..., 1:]
        Quxt = Qux.transpose(-1, -2)
        Vx = Qx + Quxt @ kk
        Vxx = Qxx + Quxt @ KK
        dV1 = dV1 + torch.sum(kk * Qu, dim=(-2, -1))
        kff[:, k] = kk[..., 0]
        Kfb[:, k] = KK
    return kff, Kfb, dV1


def phase_ablation_plain(ocp, x0, xref, lam, mu, U, cfg: ALILQRConfig, mode: str, n_iter: int,
                         *, candidates: torch.Tensor | None = None):
    """Plain K8: `mode` for n_iter iterations on every scenario, built from
    ops/megasolve.inner_solve_plain's pieces (merit, closed-loop rollout,
    line searches). Arguments and results as `inner_solve_plain`; iters is
    n_iter everywhere.

    candidates: an optional integer tensor [B] to which each scenario's
    line-search rollouts are added (mode `full` only: adaptive one a round
    until one passes, cascade every alpha), as `inner_solve_plain` counts
    them; tools/roofline.py counts the warp design's K8 and K9 from them."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; modes are {MODES}")
    if cfg.ls not in ("adaptive", "cascade"):
        raise ValueError(f"unknown line search {cfg.ls!r}")
    o = dataclasses.replace(ocp, x0=x0, xref=xref)
    B = x0.shape[0]
    kw = dict(dtype=x0.dtype, device=x0.device)
    # the masked stage-0 rows feed only the stage-0 value function
    lam_bp = torch.where(P.constraint_mask(o) > 0, lam, torch.zeros_like(lam))
    X = P.rollout(o, U)
    cost = (torch.zeros((B,), **kw) if mode == "sweep_only"
            else megasolve.al_merit(o, X, U, lam, mu))
    trial = torch.ones((B,), **kw)
    zero = torch.zeros((B,), **kw)
    for _ in range(n_iter):
        if mode == "sweep_only":   # no output depends on the sweep
            continue
        kff, Kfb, dV1 = _sweep(o, cfg, X, U, lam_bp, mu, mode)
        if mode != "full":
            X, U = megasolve._forward(o, X, U, kff, Kfb, torch.ones((B,), **kw))
            continue
        slope = torch.clamp(-dV1, min=0.0)

        def cost_of(alpha):
            return megasolve.al_merit(o, *megasolve._forward(o, X, U, kff, Kfb, alpha), lam, mu)

        best_cost, best_alpha = cost.clone(), zero.clone()
        if cfg.ls == "adaptive":
            acc = torch.zeros((B,), dtype=torch.bool, device=x0.device)
            for _ in range(cfg.ls_rounds):
                if bool(acc.all()):
                    break
                if candidates is not None:
                    candidates += (~acc).to(candidates.dtype)
                a = torch.where(acc, zero, trial)
                ca = cost_of(a)
                ok = (~acc) & ((cost - ca) >= cfg.armijo * a * slope) & (ca < cost)
                best_cost = torch.where(ok, ca, best_cost)
                best_alpha = torch.where(ok, a, best_alpha)
                acc = acc | ok
                trial = torch.where(acc, trial, trial * cfg.ls_beta)
            trial = torch.where(best_alpha > 0,
                                torch.clamp(best_alpha * cfg.ls_grow, max=1.0), trial)
        else:
            if candidates is not None:
                candidates += len(cfg.alphas)
            for a in cfg.alphas:
                a_t = torch.full((B,), a, **kw)
                ca = cost_of(a_t)
                ok = ((cost - ca) >= cfg.armijo * a_t * slope) & (ca < best_cost)
                best_cost = torch.where(ok, ca, best_cost)
                best_alpha = torch.where(ok, a_t, best_alpha)
        # alpha = 0 reproduces the nominal exactly
        X, U = megasolve._forward(o, X, U, kff, Kfb, best_alpha)
        cost = torch.where(best_alpha > 0, best_cost, cost)
    iters = torch.full((B,), n_iter, dtype=torch.int32, device=x0.device)
    return X[:, :-1].contiguous(), U, cost, iters


def f64_runs(ocp, x0, xref, lam, mu, U, cfg: ALILQRConfig, mode: str, n_iter: int) -> tuple:
    """`mode`'s plain version at these inputs in f32 and in f64."""
    f64 = dataclasses.replace(ocp, **{
        f.name: getattr(ocp, f.name).double() for f in dataclasses.fields(ocp)
        if isinstance(getattr(ocp, f.name), torch.Tensor) and getattr(ocp, f.name).is_floating_point()})
    want = phase_ablation_plain(ocp, x0, xref, lam, mu, U, cfg, mode, n_iter)
    exact = phase_ablation_plain(f64, x0.double(), xref.double(), lam.double(), mu.double(),
                                 U.double(), cfg, mode, n_iter)
    return want, exact


def f64_witness(ocp, x0, xref, lam, mu, U, cfg: ALILQRConfig, mode: str, n_iter: int,
                got, runs=None) -> dict:
    """Where `mode`'s undamped steps diverge, any two f32 runs part by chance.
    This shows it instead of assuming it: `mode`'s plain version in f32 and
    in f64 at these inputs (`f64_runs`, or `runs` where the caller has
    them), and the kernel's result `got` (Xs, U, cost, iters), each held
    against the f64 run per scenario. A scenario is diverged where the f64
    run takes a position or control beyond kernel_check.DIVERGED; each of the
    rest is missed by a result whose U parts from f64 by more than 5e-3
    (phase 3's tolerance). Returns the counts (scenarios, diverged,
    plain_missed, kernel_missed) and max |dU| over the scenarios not
    diverged (kernel_vs_plain, plain_vs_f64, kernel_vs_f64)."""
    from nmpc_tpu_torch.ops.kernel_check import DIVERGED

    want, exact = (f64_runs(ocp, x0, xref, lam, mu, U, cfg, mode, n_iter) if runs is None
                   else runs)
    pos = torch.cat([exact[0][..., 0::3], exact[0][..., 1::3]], dim=-1)
    diverged = (pos.abs().amax(dim=(1, 2)) > DIVERGED) | (exact[1].abs().amax(dim=(1, 2)) > DIVERGED)
    held = ~diverged

    def du(a, b):
        return (a[1].double() - b[1].double()).abs().amax(dim=(1, 2))[held]

    def worst(d):
        return float(d.max()) if d.numel() else 0.0

    plain, kernel = du(want, exact), du(got, exact)
    return {"scenarios": int(x0.shape[0]), "diverged": int(diverged.sum()),
            "plain_missed": int((plain > 5e-3).sum()), "kernel_missed": int((kernel > 5e-3).sum()),
            "kernel_vs_plain": worst(du(got, want)), "plain_vs_f64": worst(plain),
            "kernel_vs_f64": worst(kernel)}


def phase_ablation(ocp, x0, xref, lam, mu, U, cfg: ALILQRConfig, mode: str, n_iter: int,
                   early_exit: bool = False, design: str = "warp"):
    """K8 wrapper: `mode` at n_iter iterations, the CUDA kernel of `design`
    ("warp": the solver's K1 under the tools' flags; "first": K1's first
    design) for CUDA tensors, which it launches (counted as
    'phase_ablation') or raises, and the plain version for CPU tensors.
    early_exit=True (mode 'full' only) keeps K1's stop rule: that is K1 at
    n_inner = n_iter. Pair and box rows only."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; modes are {MODES}")
    check_design(design)
    if early_exit and mode != "full":
        raise ValueError("the early exit is K1's, mode 'full' only")
    cfg_n = dataclasses.replace(cfg, n_inner=n_iter)
    if x0.device.type == "cpu":
        if early_exit:
            return megasolve.inner_solve_plain(ocp, x0, xref, lam, mu, U, cfg_n)
        return phase_ablation_plain(ocp, x0, xref, lam, mu, U, cfg, mode, n_iter)
    if design == "first":
        return megasolve.inner_launch(
            ocp, x0, xref, lam, mu, U, cfg_n, "phase_ablation", cuda_build.load_tools,
            lambda lib: functools.partial(lib.nmpc_phase_ablation, MODES.index(mode),
                                          int(early_exit)))
    return warp_variant(ocp, x0, xref, lam, mu, U, cfg_n, "phase_ablation",
                        lambda lib: (functools.partial(lib.nmpc_phase_ablation_warp,
                                                       MODES.index(mode), int(early_exit)),
                                     lib.nmpc_warp_slot_bytes(0)))


def warp_variant(ocp, x0, xref, lam, mu, U, cfg: ALILQRConfig, what: str, entry):
    """A variant of K1's warp design from the tools library (entry(lib) ->
    (launch function, slot bytes), megasolve.warp_launch's `entry`) at K1's
    geometry (megasolve.K1_WARPS scenarios a block); pair and box rows
    only."""
    if megasolve.obstacle_rows(ocp):
        raise NotImplementedError(f"{what}: the tools' variants of K1 take no obstacle rows")
    return megasolve.warp_launch(ocp, x0, xref, lam, mu, U, cfg, what, cuda_build.load_tools,
                                 megasolve.K1_WARPS, entry)


def time_in_turns(runs: dict, order, rounds: int) -> dict:
    """{name: [ms, ...]}: after one warm-up call of each, `rounds` passes
    over `order`, each call timed alone with CUDA events."""
    from nmpc_tpu_torch.utils.timing import cuda_ms

    for name in dict.fromkeys(order):
        runs[name]()
    out = {name: [] for name in runs}
    for _ in range(rounds):
        for name in order:
            out[name].append(cuda_ms(runs[name], 1, warmup=0))
    return out


def time_modes(ocp_b, lam, mu, U, cfg: ALILQRConfig, n_iter: int, design: str = "warp") -> dict:
    """The six modes of `design` on the card, three rounds in turns with
    `full` first and last: {mode: [ms, ...]} (full twice per round)."""
    runs = {mode: functools.partial(phase_ablation, ocp_b, ocp_b.x0, ocp_b.xref, lam, mu, U,
                                    cfg, mode, n_iter, design=design) for mode in MODES}
    return time_in_turns(runs, (*MODES, "full"), 3)


def summarize(times: dict) -> dict:
    """{mode: (min ms, median ms)}."""
    return {k: (min(v), statistics.median(v)) for k, v in times.items()}


def savings(summary: dict) -> dict:
    """Share of `full`'s median each mode saves; inv_solve also against no_ls."""
    full = summary["full"][1]
    out = {k: 100.0 * (full - v[1]) / full for k, v in summary.items() if k != "full"}
    out["inv_solve vs no_ls"] = 100.0 * (summary["no_ls"][1] - summary["inv_solve"][1]) / summary["no_ls"][1]
    return out


def main(argv=None) -> int:
    import argparse

    from nmpc_tpu_torch.tools.roofline import bench_batch, card, require_card

    ap = argparse.ArgumentParser(prog="python -m nmpc_tpu_torch.tools.exp_mega_phases")
    ap.add_argument("--design", choices=DESIGNS, default="warp")
    design = ap.parse_args(argv).design
    require_card("exp_mega_phases")
    B = 32768
    cfg = ALILQRConfig(n_outer=6, n_inner=12, tol_con=1e-3, ls="adaptive")
    base, ob = bench_batch(B, seed=0)
    kw = dict(dtype=torch.float32, device=ob.device)
    lam = torch.zeros((B, base.N, base.n_con), **kw)
    mu = torch.full((B,), 10.0, **kw)
    U = torch.zeros((B, base.N, base.nu), **kw)
    n_iter = cfg.n_outer * cfg.n_inner
    print(f"K1's {design} design, B={B}, fixed {n_iter} iterations per scenario, "
          f"{torch.cuda.get_device_name(0)} [{card()}]")
    summ = summarize(time_modes(ob, lam, mu, U, cfg, n_iter, design))
    save = savings(summ)
    for mode in MODES:
        lo, med = summ[mode]
        tail = "" if mode == "full" else f"  (saves {save[mode]:5.1f}% of full)"
        print(f"{mode:10s}: min {lo:8.1f} ms, median {med:8.1f} ms{tail}")
    print(f"inv_solve against no_ls: saves {save['inv_solve vs no_ls']:.1f}%")
    return 0


if __name__ == "__main__":
    sys.exit(main())
