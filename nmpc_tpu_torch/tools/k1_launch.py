"""K1's launch geometry on the card: its register cap and warps per block.

    python -m nmpc_tpu_torch.tools.k1_launch [M,...]

For each robot count M (default: every one of SCENARIOS) builds
csrc/megasolve.cu once per register cap in CAPS (the blocks of 128 threads
per SM that the
registers must allow: 65,536 / (128 c) registers a thread) and times K1 at
the main path's first-step inputs (zero warm controls and duals, mu_init,
ALILQRConfig(n_outer=6, n_inner=12, tol_con=1e-3, ls="adaptive"), starts
jittered by 0.1 N(0, 1)) with each of WARPS scenarios per block, all
variants of one M in turns (forward, then backward). Prints each build's
ptxas line, whether every variant returns the same bits, and the times,
fastest first. The solver's choice (csrc/megasolve.cu::kK1MinBlocks,
ops/megasolve.py::K1_WARPS) is read from this table. Needs a card.
"""

from __future__ import annotations

import functools
import re
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from nmpc_tpu_torch.ops import cuda_build, megasolve
from nmpc_tpu_torch.solver.alilqr import ALILQRConfig

CAPS = (1, 4, 5, 6, 8)
WARPS = (1, 2, 4)
# one scenario per robot count at N=10, and its batch
SCENARIOS = {1: "single_robot", 2: "two_robot_swap", 3: "third_scenario", 4: "fourth_scenario",
             5: "five_robot", 6: "six_robot_antipodal", 8: "eight_robot", 10: "ten_robot"}


def batch_size(m: int) -> int:
    return 32768 if m <= 6 else 16384


def first_step(m: int, cfg: ALILQRConfig, seed: int = 0) -> tuple:
    """(ocp_b, lam, mu, U): the scenario of m robots at N=10 on the card,
    batch_size(m) starts jittered by numpy from `seed`, and the first outer
    step's inputs."""
    from nmpc_tpu_torch.parallel import batch_ocp
    from nmpc_tpu_torch.scenarios import get

    base = get(SCENARIOS[m]).make(N=10)
    B = batch_size(m)
    noise = 0.1 * np.random.default_rng(seed).standard_normal((B, base.nx))
    ob = batch_ocp(base, base.x0[None] + torch.from_numpy(noise.astype(np.float32)).to(base.device))
    kw = dict(dtype=torch.float32, device=base.device)
    return (ob, torch.zeros((B, base.N, base.n_con), **kw),
            torch.full((B,), cfg.mu_init, **kw), torch.zeros((B, base.N, base.nu), **kw))


def sweep(m: int, libs: dict, cfg: ALILQRConfig) -> tuple:
    """({(cap, warps): [ms, ms]}, every variant bit for bit equal) at m's
    first-step inputs; libs: {cap: library}."""
    from nmpc_tpu_torch.tools.exp_mega_phases import time_in_turns

    ob, lam, mu, U = first_step(m, cfg)
    runs = {(c, w): functools.partial(megasolve.warp_launch, ob, ob.x0, ob.xref, lam, mu, U, cfg,
                                      "inner_solve_fused", lambda _, lib=lib: lib, w)
            for c, lib in libs.items() for w in WARPS}
    outs = [f() for f in runs.values()]
    same = all(torch.equal(a, b) for o in outs[1:] for a, b in zip(o, outs[0]))
    order = list(runs) + list(runs)[::-1]
    return time_in_turns(runs, order, 1), same


def k1_ptxas(report: str) -> str:
    """K1's lines of an `nvcc -Xptxas -v` report: its frame and its
    registers and static shared memory."""
    lines = report.splitlines()
    at = next(i for i, line in enumerate(lines)
              if "Compiling entry function" in line and "inner_solve_kernel" in line)
    return "; ".join(re.sub(r"^\s*ptxas info\s*:\s*", "", line).strip()
                     for line in lines[at + 2:at + 4])


def main(argv=None) -> int:
    from nmpc_tpu_torch.tools.exp_mega_phases import summarize
    from nmpc_tpu_torch.tools.roofline import card, require_card

    require_card("k1_launch")
    args = sys.argv[1:] if argv is None else argv
    robots = [int(a) for a in args[0].split(",")] if args else sorted(SCENARIOS)
    cfg = ALILQRConfig(n_outer=6, n_inner=12, tol_con=1e-3, ls="adaptive")
    with ThreadPoolExecutor(max_workers=len(robots) * len(CAPS)) as pool:
        built = {(m, c): pool.submit(cuda_build.load_k1_variant, m, c) for m in robots for c in CAPS}
        built = {key: f.result() for key, f in built.items()}
    print(f"{torch.cuda.get_device_name(0)} [{card()}]")
    for m in robots:
        for c in CAPS:
            print(f"m={m} min blocks {c}: {k1_ptxas(built[m, c][1])}")
        times, same = sweep(m, {c: built[m, c][0] for c in CAPS}, cfg)
        print(f"m={m} {SCENARIOS[m]} N=10 B={batch_size(m)}, first-step inputs; every variant "
              f"bit for bit the same: {'yes' if same else 'NO'}")
        for (c, w), (lo, med) in sorted(summarize(times).items(), key=lambda kv: kv[1][1]):
            print(f"  min blocks {c}, {w} warps per block: min {lo:.2f} ms, median {med:.2f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
