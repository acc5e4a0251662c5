"""The sequential against the associative-scan backward sweep at the longest
horizon. Port of tools/bench_sweep.py.

The reference's longest-horizon configs are N=200
(AllScripts/mpc_online_casadi_tb3_1.py:57). This times `solve_batched` at
the tb3_1 shape (m=1, N=200) with ALILQRConfig(n_outer=6, n_inner=12,
tol_con=1e-3) and sweep="seq" (the megakernel route: K1 in its team
design, K2) against sweep="scan" (the hybrid route: K5 and K6 around the
associative-scan LQR of ops/assoc_lqr.py, plain PyTorch), at B=1 (K=16
solves of starts jittered by 0.05 N(0, 1), one after another, each ending in
a synchronize: ms a solve = the K solves' wall clock / K, min over the
iterations) and B=2048 (one batch, min over the iterations). The reference
took B=512 for scan (its combine tree's temporaries crashed the TPU worker
at 2048); the card holds 2048 for both.

    python -m nmpc_tpu_torch.tools.sweep [N] [iters] [--B 2048] [--device cpu] [--json]

On the card it refuses to run without one and raises if a seq solve did not
launch K1 or a scan solve launched it; --device cpu runs the plain kernels.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import torch

from nmpc_tpu_torch.ops import cuda_build
from nmpc_tpu_torch.parallel.batch import batch_ocp
from nmpc_tpu_torch.scenarios import get
from nmpc_tpu_torch.solver.alilqr import ALILQRConfig
from nmpc_tpu_torch.solver.alilqr_batched import route, solve_batched
from nmpc_tpu_torch.tools.roofline import device_label, resolve_device
from nmpc_tpu_torch.utils.timing import sync

CFG = ALILQRConfig(n_outer=6, n_inner=12, tol_con=1e-3)
FLEET_B = 2048
K_B1 = 16


def _starts(base, b: int, g: torch.Generator):
    noise = torch.randn((b, base.nx), generator=g, dtype=base.x0.dtype, device=base.device)
    return batch_ocp(base, base.x0[None] + 0.05 * noise)


def _check_route(cfg: ALILQRConfig, device, before: int) -> None:
    k1 = cuda_build.launch_counts["inner_solve_fused"] - before
    if device.type == "cuda" and (k1 > 0) != (cfg.sweep == "seq"):
        raise RuntimeError(f"sweep: sweep={cfg.sweep!r} launched K1 {k1} times")


def bench_b1(base, cfg: ALILQRConfig, K: int = K_B1, iters: int = 5) -> float:
    """Seconds a solve at B=1: K solves one after another, min over iters."""
    g = torch.Generator(device=base.device).manual_seed(0)
    solve_batched(_starts(base, 1, g), cfg=cfg)
    ts = []
    for _ in range(iters):
        obs = [_starts(base, 1, g) for _ in range(K)]
        before = cuda_build.launch_counts["inner_solve_fused"]
        sync(base.device)
        t0 = time.perf_counter()
        for ob in obs:
            solve_batched(ob, cfg=cfg)
        sync(base.device)
        ts.append(time.perf_counter() - t0)
        _check_route(cfg, base.device, before)
    return min(ts) / K


def bench_batch(base, cfg: ALILQRConfig, B: int = FLEET_B, iters: int = 4) -> tuple:
    """(seconds a batch of B, min over iters; the last batch's converged share)."""
    g = torch.Generator(device=base.device).manual_seed(1)
    solve_batched(_starts(base, B, g), cfg=cfg)
    ts = []
    for _ in range(iters):
        ob = _starts(base, B, g)
        before = cuda_build.launch_counts["inner_solve_fused"]
        sync(base.device)
        t0 = time.perf_counter()
        r = solve_batched(ob, cfg=cfg)
        sync(base.device)
        ts.append(time.perf_counter() - t0)
        _check_route(cfg, base.device, before)
    return min(ts), float(r.converged.float().mean())


def run(device, N: int = 200, iters: int = 4, B: int = FLEET_B, K: int = K_B1) -> dict:
    base = get("tb3_1").make(N=N, device=device)
    rows = []
    for sweep in ("seq", "scan"):
        cfg = dataclasses.replace(CFG, sweep=sweep)
        t1 = bench_b1(base, cfg, K=K, iters=iters)
        tb, conv = bench_batch(base, cfg, B=B, iters=iters)
        rows.append(dict(sweep=sweep, route=route(base, cfg), b1_ms=t1 * 1e3, B=B,
                         batch_s=tb, solves_per_s=B / tb, conv=conv))
    return dict(N=N, m=base.m, device=device_label(device), rows=rows)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m nmpc_tpu_torch.tools.sweep")
    ap.add_argument("N", nargs="?", type=int, default=200)
    ap.add_argument("iters", nargs="?", type=int, default=4)
    ap.add_argument("--B", type=int, default=FLEET_B)
    ap.add_argument("--K", type=int, default=K_B1, help="B=1 solves a timed run")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--json", action="store_true")
    a = ap.parse_args(argv)
    dev = resolve_device(a.device, "sweep")
    out = run(dev, a.N, a.iters, a.B, a.K)
    print(f"tb3_1 shape m=1 N={out['N']} [{out['device']}]")
    for r in out["rows"]:
        print(f"sweep={r['sweep']:4s} ({r['route']} route):  B=1 {r['b1_ms']:8.2f} ms/solve   "
              f"B={r['B']} {r['batch_s']:6.3f} s/batch ({r['solves_per_s']:9.1f} solves/s, "
              f"conv {r['conv']:.4f})")
    if a.json:
        print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
