"""Decentralized-mode demo: four robots cross the intersection with no
central solver; each runs its own 3-state NMPC against the neighbours'
exchanged plans (the right-hand traffic rule breaks the symmetry). Port of
examples/decentralized_cross.py.

    python -m nmpc_tpu_torch.examples.decentralized_cross [--max-steps 250]
        [--device cpu] [--json]

parallel/decentralized.decentralized_closed_loop (N=30, T=0.1, dmin=0.3):
each step the four subproblems are one solve_batched (engine "fused": on
the card K1's obstacle variant with the neighbours as moving obstacles, and
K2). Prints arrival, the smallest inter-robot distance and the crossing
every 40 steps.
"""

from __future__ import annotations

import argparse
import json
import math
import sys

import torch

from nmpc_tpu_torch.parallel.decentralized import decentralized_closed_loop
from nmpc_tpu_torch.tools.roofline import device_label, resolve_device

X0 = (-0.8, 0, 0, 0.8, 0, math.pi, 0, -0.8, math.pi / 2, 0, 0.8, -math.pi / 2)
GOALS = ((0.8, 0, 0), (-0.8, 0, math.pi), (0, 0.8, math.pi / 2), (0, -0.8, -math.pi / 2))


def run(device, max_steps: int = 250, N: int = 30) -> tuple:
    """(X_hist [S+1, 12], U_hist, min_dist_hist, reached) of the crossing."""
    return decentralized_closed_loop(torch.tensor(X0), torch.tensor(GOALS), N=N, T=0.1, dmin=0.3,
                                     max_steps=max_steps, device=device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m nmpc_tpu_torch.examples.decentralized_cross")
    ap.add_argument("--max-steps", type=int, default=250)
    ap.add_argument("--N", type=int, default=30)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--json", action="store_true")
    a = ap.parse_args(argv)
    dev = resolve_device(a.device, "decentralized_cross")
    X, U, mind, done = run(dev, a.max_steps, a.N)
    print(f"all reached: {bool(done)}   min inter-robot distance: {float(mind.min()):.3f} "
          f"(dmin=0.3) [{device_label(dev)}]")
    Xn = X.cpu()
    for k in range(0, Xn.shape[0], 40):
        p = Xn[k].reshape(4, 3)
        print("  " + "  ".join(f"r{i}({float(p[i, 0]):+.2f},{float(p[i, 1]):+.2f})"
                               for i in range(4)))
    if a.json:
        print(json.dumps(dict(reached=bool(done), min_dist=float(mind.min()), steps=Xn.shape[0] - 1,
                              device=device_label(dev))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
