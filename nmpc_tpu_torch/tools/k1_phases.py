"""Where K1's time goes, by phase, on the card: a clock64 split.

    python -m nmpc_tpu_torch.tools.k1_phases [M]

Builds csrc/megasolve.cu for M robots (default 6) at the solver's register
cap with K1's phase probes compiled in (-DNMPC_K1_PROBES: at each
NMPC_PROBE(i) of inner_warp.cuh a lane reads clock64 and adds the cycles
since the last mark to phase i; the sums over warps are read back through
`nmpc_phases`), and runs K1 at the first-step inputs of tools/k1_launch.py
and at the converged state of a main-path solve of that batch. Prints each
phase's share of the summed warp cycles and its cycles per warp and
iteration run. The probes cost registers and time, so the shares are the
result, not the times. Needs a card.
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


def split(lib, run, n_inner: int) -> tuple:
    """({phase: summed warp cycles}, iterations run summed over scenarios)
    of one call run() -> K1's results at n_inner iterations at most."""
    from nmpc_tpu_torch.tools.roofline import k1_executed

    if lib.nmpc_phases(None, 1) != 0:
        raise RuntimeError("k1_phases: resetting the counters failed")
    iters = run()[3]
    torch.cuda.synchronize()
    out = (ctypes.c_ulonglong * 16)()
    if lib.nmpc_phases(out, 0) != 0:
        raise RuntimeError("k1_phases: reading the counters failed")
    return {name: out[i] for i, name in PHASES.items()}, int(k1_executed(iters, n_inner).sum())


def main(argv=None) -> int:
    from nmpc_tpu_torch.ops import megasolve
    from nmpc_tpu_torch.solver import ALILQRConfig, solve_batched
    from nmpc_tpu_torch.tools.k1_launch import first_step, k1_ptxas
    from nmpc_tpu_torch.tools.roofline import card, require_card
    from nmpc_tpu_torch.utils.timing import cuda_ms

    require_card("k1_phases")
    args = sys.argv[1:] if argv is None else argv
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


if __name__ == "__main__":
    sys.exit(main())
