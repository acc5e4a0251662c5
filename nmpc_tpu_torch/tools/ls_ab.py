"""The megakernel's line searches A/B on the bench shape: throughput and
solution quality. Port of tools/bench_ls.py.

six_robot_antipodal at N=10, B=32768 starts jittered by 0.1 N(0, 1), the
bench config ALILQRConfig(n_outer=6, n_inner=12, tol_con=1e-3) with each
variant's line search: "cascade" (every alpha of the grid, in order; K1's
cascade arm, which the bench config never takes) and "adaptive-r1/r2/r3"
(ls="adaptive" with 1, 2 or 3 rounds an iteration; r2 is the bench's). A
variant's row: one solve's quality (converged share, mean cost, violation
p50/p99/max, mean inner iterations), then 4 solves of fresh starts, each
timed from its start to a synchronize: solves/s = B / min.

    python -m nmpc_tpu_torch.tools.ls_ab [B] [--variants cascade,adaptive-r2]
        [--iters 4] [--device cpu] [--json]

On the card it refuses to run without one and raises if a timed solve did
not launch K1 and K2; --device cpu runs the plain kernels.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

from nmpc_tpu_torch.bench import fleet, quality
from nmpc_tpu_torch.scenarios import get
from nmpc_tpu_torch.solver.alilqr import ALILQRConfig
from nmpc_tpu_torch.tools.roofline import device_label, resolve_device

B = 32768
BASE_CFG = ALILQRConfig(n_outer=6, n_inner=12, tol_con=1e-3)
VARIANTS = {"cascade": {}, "adaptive-r1": {"ls": "adaptive", "ls_rounds": 1},
            "adaptive-r2": {"ls": "adaptive", "ls_rounds": 2},
            "adaptive-r3": {"ls": "adaptive", "ls_rounds": 3}}


def bench_base(device):
    return get("six_robot_antipodal").make(N=10, device=device)


def variant_row(base, cfg: ALILQRConfig, b: int, iters: int, seed: int = 0) -> dict:
    """One config's quality (a solve of the seed's first starts) and
    throughput (B / min of `iters` timed solves of fresh starts), by
    bench.fleet; on the card each solve must launch K1 and K2."""
    res, times, _ = fleet(base, cfg, b, iters, seed=seed, what="ls_ab")
    return dict(quality(res), times_s=times, solves_per_s=b / min(times), B=b)


def run(device, b: int = B, variants=tuple(VARIANTS), iters: int = 4) -> dict:
    base = bench_base(device)
    rows = [dict(variant=v, **variant_row(base, dataclasses.replace(BASE_CFG, **VARIANTS[v]),
                                           b, iters)) for v in variants]
    return dict(B=b, device=device_label(device), rows=rows)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m nmpc_tpu_torch.tools.ls_ab")
    ap.add_argument("B", nargs="?", type=int, default=B)
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--iters", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--json", action="store_true")
    a = ap.parse_args(argv)
    dev = resolve_device(a.device, "ls_ab")
    out = run(dev, a.B, tuple(a.variants.split(",")), a.iters)
    print(f"six_robot_antipodal N=10 B={out['B']} [{out['device']}]")
    for r in out["rows"]:
        print(f"{r['variant']:11s} {r['solves_per_s']:10.1f} solves/s  conv={r['conv']:.4f} "
              f"meancost={r['mean_cost']:.4f} viol_p50={r['viol_p50']:.2e} "
              f"viol_p99={r['viol_p99']:.2e} viol_max={r['viol_max']:.2e} "
              f"mean_inner={r['mean_inner']:.1f}")
    if a.json:
        print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
