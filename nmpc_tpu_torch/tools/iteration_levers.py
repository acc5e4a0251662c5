"""Iteration levers A/B at bench scale. Port of tools/exp_iteration_levers.py.

Throughput and quality of solver-config variants that cut iteration counts
on the bench shape (six_robot_antipodal N=10, B=32768 starts jittered by
0.1 N(0, 1), the megakernel route): the bench config `base_r4`
(ALILQRConfig(n_outer=6, n_inner=12, tol_con=1e-3, ls="adaptive")), `mu100`
(the same with mu_init=100) and `polar` (the same with cold_seed="polar",
the per-robot go-to-goal seed of solver/alilqr_batched._polar_seed). A
row: one solve's quality, then 3 timed solves of fresh starts (each from
its start to a synchronize): solves/s = B / min (tools/ls_ab.variant_row).

    python -m nmpc_tpu_torch.tools.iteration_levers [B] [--variants base_r4,mu100,polar]
        [--device cpu] [--json]

On the card it refuses to run without one; --device cpu runs the plain
kernels.
"""

from __future__ import annotations

import argparse
import json
import sys

from nmpc_tpu_torch.solver.alilqr import ALILQRConfig
from nmpc_tpu_torch.tools.ls_ab import bench_base, variant_row
from nmpc_tpu_torch.tools.roofline import device_label, resolve_device

B = 32768
BASE = dict(n_outer=6, n_inner=12, tol_con=1e-3, ls="adaptive")
VARIANTS = {"base_r4": BASE, "mu100": dict(BASE, mu_init=100.0),
            "polar": dict(BASE, cold_seed="polar")}


def run(device, b: int = B, variants=tuple(VARIANTS), iters: int = 3) -> dict:
    base = bench_base(device)
    rows = [dict(variant=v, **variant_row(base, ALILQRConfig(**VARIANTS[v]), b, iters))
            for v in variants]
    return dict(B=b, device=device_label(device), rows=rows)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m nmpc_tpu_torch.tools.iteration_levers")
    ap.add_argument("B", nargs="?", type=int, default=B)
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--json", action="store_true")
    a = ap.parse_args(argv)
    dev = resolve_device(a.device, "iteration_levers")
    out = run(dev, a.B, tuple(a.variants.split(",")), a.iters)
    print(f"six_robot_antipodal N=10 B={out['B']} [{out['device']}]")
    for r in out["rows"]:
        print(f"{r['variant']:8s} {r['solves_per_s']:8.1f} solves/s  conv {r['conv']:.4f}  "
              f"viol_p99 {r['viol_p99']:.2e}  mean_inner {r['mean_inner']:.2f}")
    if a.json:
        print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
