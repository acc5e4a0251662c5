"""Where K1's time goes, by phase, on the card: a clock64 split.

    python -m nmpc_tpu_torch.tools.k1_phases [M]
    python -m nmpc_tpu_torch.tools.k1_phases team [M]

Builds csrc/megasolve.cu for M robots (default 6) at the solver's register
cap with K1's phase probes compiled in (-DNMPC_K1_PROBES: at each
NMPC_PROBE(i) of inner_warp.cuh a lane reads clock64 and adds the cycles
since the last mark to phase i; the sums over warps are read back through
`nmpc_phases`), and runs K1 at the first-step inputs of tools/k1_launch.py
and at the converged state of a main-path solve of that batch. Prints each
phase's share of the summed warp cycles and its cycles per warp and
iteration run. The probes cost registers and time, so the shares are the
result, not the times.

`team` splits K1's team design (csrc/inner_team.cuh, M in
cuda_build.TEAM_ROBOTS, default 1) by TEAM_PHASES: the sweep's stage (ring
wait, expansion, Q blocks, factor and gains, value update), the rollouts'
stage (ring wait,
the stage's arithmetic), and per launch and iteration the initial rollout,
the sweep, the candidates and the pick with the accepted step; at M=1 at
path (b)'s first-step inputs (tools/k1_launch.py::path_b_first_step) and
at the converged state of its solve, at M=2 at k1_launch's. The cycles are
each team lane 0's. Needs a card.
"""

from __future__ import annotations

import ctypes
import sys

import torch

from nmpc_tpu_torch.ops import cuda_build

# the phase that ends at each NMPC_PROBE(i) of csrc/inner_warp.cuh: per stage
# of backward_sweep_warp (0-7), per launch and iteration of inner_solve_warp
# (10-12)
PHASES = {0: "stage rows", 1: "box rows", 2: "pairs and dynamics", 3: "Q blocks", 4: "Cholesky",
          5: "substitutions", 6: "gains out", 7: "value update", 10: "initial rollout",
          11: "sweep", 12: "line search"}


# the phases of the team design (csrc/inner_team.cuh): per stage of
# sweep_team (0-4) and of rollout_team (5-6), per launch and iteration of
# inner_solve_team (10-13)
TEAM_PHASES = {0: "sweep: ring wait", 1: "sweep: expansion", 2: "sweep: Q blocks",
               3: "sweep: factor and gains", 4: "sweep: value update",
               5: "rollouts: ring wait", 6: "rollouts: stage", 10: "initial rollout",
               11: "sweep", 12: "candidates", 13: "accepted step"}


def split(lib, run, n_inner: int, phases: dict = PHASES) -> tuple:
    """({phase: summed warp cycles}, iterations run summed over scenarios)
    of one call run() -> K1's results at n_inner iterations at most, by the
    phases of `phases` (PHASES: the warp design's; TEAM_PHASES)."""
    from nmpc_tpu_torch.tools.roofline import k1_executed

    if lib.nmpc_phases(None, 1) != 0:
        raise RuntimeError("k1_phases: resetting the counters failed")
    iters = run()[3]
    torch.cuda.synchronize()
    out = (ctypes.c_ulonglong * 16)()
    if lib.nmpc_phases(out, 0) != 0:
        raise RuntimeError("k1_phases: reading the counters failed")
    return {name: out[i] for i, name in phases.items()}, int(k1_executed(iters, n_inner).sum())


def main(argv=None) -> int:
    from nmpc_tpu_torch.ops import megasolve
    from nmpc_tpu_torch.solver import ALILQRConfig, solve_batched
    from nmpc_tpu_torch.tools.k1_launch import first_step, k1_ptxas
    from nmpc_tpu_torch.tools.roofline import card, require_card
    from nmpc_tpu_torch.utils.timing import cuda_ms

    require_card("k1_phases")
    args = sys.argv[1:] if argv is None else argv
    if args and args[0] == "team":
        return team_main(args[1:])
    m = int(args[0]) if args else 6
    cfg = ALILQRConfig(n_outer=6, n_inner=12, tol_con=1e-3, ls="adaptive")
    lib, report = cuda_build.load_k1_variant(m, probes=True)
    ob, lam0, mu0, U0 = first_step(m, cfg)
    res = solve_batched(ob, cfg=cfg)
    print(f"{torch.cuda.get_device_name(0)} [{card()}]; m={m} B={ob.x0.shape[0]} N={ob.N}; "
          f"K1 with probes: {k1_ptxas(report)}")
    for state, (lam, mu, U) in (("first step", (lam0, mu0, U0)), ("converged", (res.lam, res.mu, res.U))):
        def run(lam=lam, mu=mu, U=U):
            return megasolve.warp_launch(ob, ob.x0, ob.xref, lam, mu, U, cfg, "inner_solve_fused",
                                         lambda _: lib, megasolve.K1_WARPS)
        ms = cuda_ms(run, 2)
        cycles, executed = split(lib, run, cfg.n_inner)
        total = cycles["initial rollout"] + cycles["sweep"] + cycles["line search"]
        print(f"{state}: {ms:.2f} ms with the probes, {executed / ob.x0.shape[0]:.2f} iterations "
              f"run per scenario")
        for name, c in cycles.items():
            print(f"  {name:20s} {100 * c / total:5.1f}%  {c / max(executed, 1):10.0f} cycles per "
                  f"warp and iteration")
    return 0


def team_main(args: list) -> int:
    """`k1_phases team [M]`: the team design's split (module note)."""
    from nmpc_tpu_torch.ops import megasolve
    from nmpc_tpu_torch.solver import ALILQRConfig, solve_batched
    from nmpc_tpu_torch.tools.k1_launch import first_step, k1_ptxas, path_b_first_step
    from nmpc_tpu_torch.tools.roofline import card
    from nmpc_tpu_torch.utils.timing import cuda_ms

    m = int(args[0]) if args else 1
    if m == 1:
        cfg = ALILQRConfig(n_outer=12, n_inner=25, tol_con=1e-3)
        ob, lam0, mu0, U0 = path_b_first_step(cfg)
    else:
        cfg = ALILQRConfig(n_outer=6, n_inner=12, tol_con=1e-3, ls="adaptive")
        ob, lam0, mu0, U0 = first_step(m, cfg)
    lib, report = cuda_build.load_k1_variant(m, probes=True, team={})
    res = solve_batched(ob, cfg=cfg)
    print(f"{torch.cuda.get_device_name(0)} [{card()}]; m={m} B={ob.x0.shape[0]} N={ob.N} "
          f"{cfg.ls}; K1's team design {cuda_build.team_geometry(lib)} with probes: "
          f"{k1_ptxas(report, 'inner_team_kernelILi%dELb%dE' % (m, m == 1))}")
    for state, (lam, mu, U) in (("first step", (lam0, mu0, U0)), ("converged", (res.lam, res.mu, res.U))):
        def run(lam=lam, mu=mu, U=U):
            return megasolve.team_launch(ob, ob.x0, ob.xref, lam, mu, U, cfg, "inner_solve_fused",
                                         lambda _: lib, megasolve.K1_TEAM_WARPS)
        ms = cuda_ms(run, 2)
        cycles, executed = split(lib, run, cfg.n_inner, TEAM_PHASES)
        total = sum(cycles[TEAM_PHASES[i]] for i in (10, 11, 12, 13))
        print(f"{state}: {ms:.2f} ms with the probes, {executed / ob.x0.shape[0]:.2f} iterations "
              f"run per scenario")
        for name, c in cycles.items():
            print(f"  {name:24s} {100 * c / total:5.1f}%  {c / max(executed, 1):10.0f} cycles per "
                  f"team and iteration")
    return 0


if __name__ == "__main__":
    sys.exit(main())
