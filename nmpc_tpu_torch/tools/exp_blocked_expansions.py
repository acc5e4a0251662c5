"""The expansion layout A/B inside the full K1 solve (K9). Port of
tools/exp_blocked_expansions.py.

On the TPU the choice was per-row against blocked vregs. In the port's
kernels the counterpart is where the stage Hessians live. On K1's warp
design (design "warp", the default: csrc/inner_warp.cuh, the solver's K1,
under its template flag kDense):

  structured  K1's own: lxx is never formed; the Q blocks read it from the
              slot's diagonal and pair table
  dense       lxx (n x n) and luu (nu x nu) materialized in the warp's
              shared-memory slot (1,872 B more at six robots), each lane
              filling its own 3x3 block, then read back by the Q blocks

and on K1's first design (design "first": csrc/megasolve.cuh, one thread
per scenario, the A/B baseline): K1's `Expansion` against `DenseExpansion`
(csrc/tools.cuh), lxx and luu in thread-local memory, as the reference's
per-row dense(He, n, n) assembles them (468 more floats per scenario at six
robots).

Both run K1's iteration (phase 'full' of K8) at a fixed count with no early
exit; the structured variant is exactly K8's 'full' of the same design. The
plain version is one function for both (the layout does not change what is
computed; the warp design's dense layout sums in the structured order, the
first design's rounds lxx's sums in another). CPU tensors take it whatever
the design.

    python -m nmpc_tpu_torch.tools.exp_blocked_expansions [--design first]

times both on the card at the reference's inputs (six_robot_antipodal N=10,
B=32768, n_inner=40, n_outer=1, lam = |0.1 N(0,1)|, mu = 10,
U = 0.01 N(0,1); numpy's generator from seeds 0, 7 and 3 where the reference
used jax.random keys) and prints max |dU| and max |dcost| between them.
"""

from __future__ import annotations

import dataclasses
import functools
import sys

import numpy as np
import torch

from nmpc_tpu_torch.ops import cuda_build, megasolve
from nmpc_tpu_torch.solver.alilqr import ALILQRConfig
from nmpc_tpu_torch.tools.exp_mega_phases import (DESIGNS, check_design, phase_ablation_plain,
                                                  summarize, time_in_turns, warp_variant)

LAYOUTS = ("structured", "dense")


def expansion_ab_plain(ocp, x0, xref, lam, mu, U, cfg: ALILQRConfig, n_iter: int):
    """Plain K9 (either layout): K1's full iteration at n_iter iterations on
    every scenario, the plain K8 mode 'full'."""
    return phase_ablation_plain(ocp, x0, xref, lam, mu, U, cfg, "full", n_iter)


def expansion_ab(ocp, x0, xref, lam, mu, U, cfg: ALILQRConfig, layout: str, n_iter: int,
                 design: str = "warp"):
    """K9 wrapper: the `layout` variant at n_iter iterations, the CUDA kernel
    of `design` ("warp" or "first", as K8's) for CUDA tensors, which it
    launches (counted as 'expansion_ab') or raises, and the plain version for
    CPU tensors. Arguments and results as `megasolve.inner_solve_plain`."""
    if layout not in LAYOUTS:
        raise ValueError(f"unknown layout {layout!r}; layouts are {LAYOUTS}")
    check_design(design)
    if x0.device.type == "cpu":
        return expansion_ab_plain(ocp, x0, xref, lam, mu, U, cfg, n_iter)
    cfg_n = dataclasses.replace(cfg, n_inner=n_iter)
    dense = LAYOUTS.index(layout)
    if design == "first":
        return megasolve.inner_launch(
            ocp, x0, xref, lam, mu, U, cfg_n, "expansion_ab", cuda_build.load_tools,
            lambda lib: functools.partial(lib.nmpc_expansion_ab, dense))
    return warp_variant(ocp, x0, xref, lam, mu, U, cfg_n, "expansion_ab",
                        lambda lib: (functools.partial(lib.nmpc_expansion_ab_warp, dense),
                                     lib.nmpc_warp_slot_bytes(dense)))


def ab_inputs(ocp_b):
    """The reference's A/B inputs on ocp_b's batch: nonzero duals so the
    activation branches do real work, mu = 10, small warm controls (numpy's
    generator from the reference's key numbers, 7 and 3)."""
    B, N = ocp_b.x0.shape[0], ocp_b.N
    dev = ocp_b.device
    lam = np.abs(0.1 * np.random.default_rng(7).standard_normal((B, N, ocp_b.n_con)))
    U = 0.01 * np.random.default_rng(3).standard_normal((B, N, ocp_b.nu))
    return (torch.from_numpy(lam.astype(np.float32)).to(dev),
            torch.full((B,), 10.0, dtype=torch.float32, device=dev),
            torch.from_numpy(U.astype(np.float32)).to(dev))


def time_layouts(ocp_b, lam, mu, U, cfg: ALILQRConfig, n_iter: int, design: str = "warp") -> dict:
    """Both layouts of `design` on the card in turns, two rounds of
    structured, dense, dense, structured: {layout: [ms, ...]}."""
    runs = {lay: functools.partial(expansion_ab, ocp_b, ocp_b.x0, ocp_b.xref, lam, mu, U,
                                   cfg, lay, n_iter, design) for lay in LAYOUTS}
    return time_in_turns(runs, ("structured", "dense", "dense", "structured"), 2)


def main(argv=None) -> int:
    import argparse

    from nmpc_tpu_torch.tools.roofline import bench_batch, card, require_card

    ap = argparse.ArgumentParser(prog="python -m nmpc_tpu_torch.tools.exp_blocked_expansions")
    ap.add_argument("--design", choices=DESIGNS, default="warp")
    design = ap.parse_args(argv).design
    require_card("exp_blocked_expansions")
    B = 32768
    cfg = ALILQRConfig(n_outer=1, n_inner=40, tol_con=1e-3, ls="adaptive")
    _, ob = bench_batch(B, seed=0)
    lam, mu, U = ab_inputs(ob)
    print(f"K1's {design} design, B={B}, {cfg.n_inner} fixed iterations, "
          f"{torch.cuda.get_device_name(0)} [{card()}]")
    for lay, (lo, med) in summarize(time_layouts(ob, lam, mu, U, cfg, cfg.n_inner,
                                                 design)).items():
        print(f"{lay:10s}: min {lo:8.1f} ms, median {med:8.1f} ms")
    out = {lay: expansion_ab(ob, ob.x0, ob.xref, lam, mu, U, cfg, lay, cfg.n_inner, design)
           for lay in LAYOUTS}
    dU = float((out["dense"][1] - out["structured"][1]).abs().max())
    dc = float((out["dense"][2] - out["structured"][2]).abs().max())
    print(f"max |dU| = {dU:.2e}, max |dcost| = {dc:.2e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
