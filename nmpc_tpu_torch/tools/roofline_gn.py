"""Roofline and phase accounting of the family-I condensed-GN fleet. Port of
tools/roofline_gn.py.

The published family-I config (obs_avoid_static_first_scenario_v4.py:59-75:
N=100, Nc=50, nx=13 = 3 pose + 10 rays, 1/d cost, move blocking) through
the port's solver/gn.py (plain PyTorch; the reference has no Pallas kernel
here), on the lidar_v4 scan fixture (tools/lidar_fleet.fixture), B starts
jittered by 0.05 N(0, 1) in pose, GNConfig(Nc=50, n_gn=10, n_outer=4,
tol_con=1e-3):

  1. the analytic FLOP model of one GN iteration (forward-sensitivity scan
     building H = J'J and g = J'r; dense Cholesky; the 7-alpha line
     search), the reference's formulas;
  2. measured end-to-end throughput (min of 3 solves, each to a
     synchronize) and the executed-iteration statistics;
  3. measured per-phase wall time at the fleet shape (normal equations
     `gn._normal_scan`, Cholesky and solve, the line-search merits
     `gn._merit` of 7 candidates), each as its own call, min of 5;
  4. the achieved FLOP/s against the card's roofs: f32 FMA peak (K7,
     tools/roofline.py, measured there) and a batched f32 GEMM at exactly
     the H-build shapes (torch.einsum, the yardstick; TF32 off).

    python -m nmpc_tpu_torch.tools.roofline_gn [B] [--N n] [--device cpu] [--json]

On the card it refuses to run without one; --device cpu (with --N small)
checks the path on the plain PyTorch ops, its times the CPU's.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from nmpc_tpu_torch.ocp import problem as P
from nmpc_tpu_torch.solver import gn
from nmpc_tpu_torch.tools.lidar_fleet import fixture, jittered
from nmpc_tpu_torch.tools.roofline import device_label, resolve_device
from nmpc_tpu_torch.utils.timing import sync


def _time(fn, reps: int = 5):
    """(min seconds over reps calls after one warm-up, the last output),
    each call ending in a synchronize."""
    out = fn()
    dev = _device_of(out)
    ts = []
    for _ in range(reps):
        sync(dev)
        t0 = time.perf_counter()
        out = fn()
        sync(dev)
        ts.append(time.perf_counter() - t0)
    return min(ts), out


def _device_of(out):
    while isinstance(out, (tuple, list)):
        out = out[0]
    return out.device if isinstance(out, torch.Tensor) else out.X.device


def flop_model(N: int, nx: int, nu: int, Nc: int, rows: int, n_alphas: int) -> dict:
    """FLOPs of one GN iteration per scenario, by part (the reference's
    model)."""
    nz = Nc * nu
    parts = dict(J=2 * rows * nz * (nx + nu) * N, H=2 * rows * nz * nz * N, g=2 * rows * nz * N,
                 S=(2 * nx * nx * nz + 2 * nx * nu * nz) * N, chol=nz ** 3 // 3 + 2 * nz ** 2,
                 ls=n_alphas * N * (rows * 6 + nx * 8))
    parts["iter"] = sum(parts.values())
    return parts


def run(device, B: int = 1024, N: int | None = None) -> dict:
    kw = {} if N is None else dict(N=N)
    base = fixture(device, **kw)
    Nc = min(50, base.N)
    cfg = gn.GNConfig(Nc=Nc, n_gn=10, n_outer=4, tol_con=1e-3)
    g = torch.Generator(device=device).manual_seed(0)
    ob = jittered(base, B, g)
    N, nx, nu = base.N, base.nx, base.nu
    nz, n_con = Nc * nu, base.n_con
    rows = nx + nu + base.num_rays + n_con
    out = dict(B=B, N=N, Nc=Nc, nx=nx, nu=nu, nz=nz, rows=rows, device=device_label(device))

    dt_e2e, res = _time(lambda: gn.solve_batched(ob, cfg=cfg), reps=3)
    ii = res.inner_iters.float().cpu().numpy()
    fl = flop_model(N, nx, nu, Nc, rows, len(cfg.alphas))
    it_exec, it_useful = float(ii.max()), float(ii.mean())
    out.update(e2e_s=dt_e2e, solves_per_s=B / dt_e2e, iters_mean=it_useful, iters_max=it_exec,
               flops=fl, tflops_exec=B * it_exec * fl["iter"] / dt_e2e / 1e12,
               tflops_useful=B * it_useful * fl["iter"] / dt_e2e / 1e12)

    kwf = dict(dtype=torch.float32, device=device)
    U0 = torch.zeros((B, Nc, nu), **kwf)
    lam0 = torch.zeros((B, N, n_con), **kwf)
    mu0 = torch.full((B,), 100.0, **kwf)
    dt_norm, (H, gv) = _time(lambda: gn._normal_scan(ob, U0, lam0, mu0, Nc))
    Hr = H + 1e-6 * torch.eye(nz, **kwf)[None]
    dt_chol, _ = _time(lambda: -torch.cholesky_solve(gv[..., None],
                                                     torch.linalg.cholesky(Hr))[..., 0])
    alphas = torch.tensor(cfg.alphas, **kwf)
    dt_ls, _ = _time(lambda: gn._merit(ob, U0[None] + 0.01 * alphas[:, None, None, None],
                                       lam0, mu0))
    out.update(normal_ms=dt_norm * 1e3, chol_ms=dt_chol * 1e3, ls_ms=dt_ls * 1e3,
               normal_tflops=B * (fl["J"] + fl["H"] + fl["g"] + fl["S"]) / dt_norm / 1e12,
               chol_tflops=B * fl["chol"] / dt_chol / 1e12,
               phase_sum_s=(dt_norm + dt_chol + dt_ls) * it_exec)

    gemm = []
    rng = np.random.default_rng(0)
    for Kc in (1, 4, 10):
        Jc = torch.as_tensor(rng.normal(size=(B, Kc * rows, nz)), **kwf)
        dt_g, _ = _time(lambda: torch.einsum("bkr,bks->brs", Jc, Jc))
        gemm.append(dict(Kc=Kc, ms=dt_g * 1e3,
                         tflops=2 * B * Kc * rows * nz * nz / dt_g / 1e12))
    out["gemm"] = gemm
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m nmpc_tpu_torch.tools.roofline_gn")
    ap.add_argument("B", nargs="?", type=int, default=1024)
    ap.add_argument("--N", type=int, default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--json", action="store_true")
    a = ap.parse_args(argv)
    dev = resolve_device(a.device, "roofline_gn")
    r = run(dev, a.B, a.N)
    fl = r["flops"]
    print(f"lidar_v4 B={r['B']}: N={r['N']} Nc={r['Nc']} nx={r['nx']} nu={r['nu']} nz={r['nz']} "
          f"rows/stage={r['rows']} [{r['device']}]")
    print(f"end-to-end: {r['e2e_s']:.3f} s/batch -> {r['solves_per_s']:.1f} solves/s | inner "
          f"iters mean {r['iters_mean']:.1f} max {r['iters_max']:.0f}")
    print(f"FLOP model/iteration: total {fl['iter'] / 1e6:.1f} MFLOP (H-build "
          f"{100 * fl['H'] / fl['iter']:.0f}%, J-build {100 * fl['J'] / fl['iter']:.0f}%, "
          f"S-prop {100 * fl['S'] / fl['iter']:.0f}%, chol {100 * fl['chol'] / fl['iter']:.0f}%, "
          f"LS {100 * fl['ls'] / fl['iter']:.0f}%)")
    print(f"achieved: executed {r['tflops_exec']:.3f} TFLOP/s, useful {r['tflops_useful']:.3f} "
          f"TFLOP/s (f32 FMA peak: tools/roofline.py's K7)")
    print(f"phase normal-eq (H,g): {r['normal_ms']:.1f} ms -> {r['normal_tflops']:.3f} TFLOP/s")
    print(f"phase cholesky+solve: {r['chol_ms']:.1f} ms -> {r['chol_tflops']:.4f} TFLOP/s")
    print(f"phase line-search merit x7: {r['ls_ms']:.1f} ms")
    print(f"phase sum x executed iters: {r['phase_sum_s']:.3f} s (vs end-to-end "
          f"{r['e2e_s']:.3f} s: the gap is the outer loop's rollouts, AL updates, dispatch)")
    for gm in r["gemm"]:
        print(f"batched GEMM [{r['nz']},{gm['Kc'] * r['rows']}]@[{gm['Kc'] * r['rows']},"
              f"{r['nz']}] x{r['B']}: {gm['ms']:.2f} ms -> {gm['tflops']:.2f} TFLOP/s")
    if a.json:
        print(json.dumps(r))
    return 0


if __name__ == "__main__":
    sys.exit(main())
