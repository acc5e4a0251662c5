"""Headline demo: six robots swap antipodally on the unit circle, collision-
and deadlock-free. Port of examples/six_robot_swap.py.

    python -m nmpc_tpu_torch.examples.six_robot_swap [--max-steps 120]
        [--save artifacts/six_robot_swap] [--device cpu] [--json]

The closed loop (mpc/driver.closed_loop: ALILQRConfig(n_outer=15,
n_inner=25, tol_con=1e-4), MPCConfig(max_steps=120, stop_tol, escape=True))
with solve_one as its engine: on the card the megakernel route at B=1, K1
and K2 (the reference example's per-scenario engine is one jitted program
on its TPU; the port's, solver/alilqr.solve, is host-bound on the card).
It prints the wall clock, arrival, the smallest pair distance and robots
1-3's crossing, and saves the run log (utils/runlog.py, the reference's
.npz layout) to --save.npz.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from nmpc_tpu_torch.mpc.driver import MPCConfig, closed_loop
from nmpc_tpu_torch.scenarios import get
from nmpc_tpu_torch.solver.alilqr import ALILQRConfig
from nmpc_tpu_torch.solver.alilqr_batched import solve_one
from nmpc_tpu_torch.tools.roofline import device_label, resolve_device
from nmpc_tpu_torch.utils import save_run
from nmpc_tpu_torch.utils.timing import sync

CFG = ALILQRConfig(n_outer=15, n_inner=25, tol_con=1e-4)


def run(device, max_steps: int = 120, N: int | None = None) -> tuple:
    """(scenario, MPCResult, wall seconds) of the swap on `device`."""
    sc = get("six_robot_antipodal")
    ocp = sc.make(device=device) if N is None else sc.make(device=device, N=N)
    sync(device)
    t0 = time.perf_counter()
    r = closed_loop(ocp, CFG, MPCConfig(max_steps=max_steps, stop_tol=sc.stop_tol, escape=True),
                    solve_fn=lambda o, w: solve_one(o, w, CFG))
    sync(device)
    return sc, r, time.perf_counter() - t0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m nmpc_tpu_torch.examples.six_robot_swap")
    ap.add_argument("--max-steps", type=int, default=120)
    ap.add_argument("--N", type=int, default=None)
    ap.add_argument("--save", default="artifacts/six_robot_swap")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--json", action="store_true")
    a = ap.parse_args(argv)
    dev = resolve_device(a.device, "six_robot_swap")
    sc, r, secs = run(dev, a.max_steps, a.N)
    steps = int(r.steps_used)
    min_dist = float(r.min_dist_hist.min())
    print(f"solved closed loop in {secs:.1f} s wall ({steps} MPC steps, {steps * sc.T:.1f} s sim) "
          f"[{device_label(dev)}]")
    print(f"reached={bool(r.reached)}  min pair distance={min_dist:.4f} (dmin={sc.dmin})")
    X = r.X_hist.cpu()
    for k in range(0, steps + 1, 15):
        p = X[k].reshape(6, 3)
        print(f"  t={k * sc.T:5.1f}s  " + "  ".join(
            f"r{i}({float(p[i, 0]):+.2f},{float(p[i, 1]):+.2f})" for i in range(3)))
    save_run(a.save, r, meta={"scenario": sc.name})
    print(f"trajectory artifact: {a.save}.npz")
    if a.json:
        print(json.dumps(dict(steps=steps, reached=bool(r.reached), min_dist=min_dist,
                              seconds=secs, device=device_label(dev))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
