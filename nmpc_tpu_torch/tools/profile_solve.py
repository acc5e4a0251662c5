"""Where a batched solve's time goes, by kernel. Port of
tools/profile_solve.py (the reference times its inner iteration's stages,
expansions, Riccati sweep and line search, each as its own jitted call,
beside the end-to-end solve, and can write a jax.profiler trace).

At the bench shape (six_robot_antipodal N=10, B=4096 starts jittered by 0.1
N(0, 1), ALILQRConfig(n_outer=6, n_inner=12, tol_con=1e-3)):

- the staged route (mega=False), one solve split by CUDA events around
  each launch of its four kernels as the route calls them: K4
  (expansions_fused), K3 (riccati_lanes), K5 (linesearch_costs_lanes), K6
  (rollout_alpha_lanes), and the rest (the host loop's small PyTorch ops
  and syncs) = the solve's wall clock less their sum;
- the default (megakernel) route's solve split the same way into K1, K2 and
  the rest, and its solves/s;
- each staged kernel alone at the first inner iteration's inputs (U 0, lam
  0, mu mu_init), ms a launch by CUDA events over 10 launches.

    python -m nmpc_tpu_torch.tools.profile_solve [-B 4096] [--trace DIR] [--device cpu] [--json]

--trace DIR writes a torch.profiler trace (CPU and CUDA activities) of one
staged solve as DIR/staged_solve.json (chrome trace format) and prints its
kernels' summed device time. On the card it refuses to run without one;
--device cpu times the plain kernels on the host clock (not device times).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys
import time

import torch

from nmpc_tpu_torch.ocp import problem as P
from nmpc_tpu_torch.ops import rollout
from nmpc_tpu_torch.ops.cuda_build import lane
from nmpc_tpu_torch.parallel.batch import batch_ocp
from nmpc_tpu_torch.scenarios import get
from nmpc_tpu_torch.solver import alilqr_batched as AB
from nmpc_tpu_torch.solver.alilqr import ALILQRConfig
from nmpc_tpu_torch.tools.roofline import device_label, resolve_device
from nmpc_tpu_torch.utils.timing import cuda_ms, sync

CFG = ALILQRConfig(n_outer=6, n_inner=12, tol_con=1e-3)
STAGED = {(AB, "expansions_fused"): "K4", (AB, "riccati_lanes"): "K3",
          (rollout, "linesearch_costs_lanes"): "K5", (rollout, "rollout_alpha_lanes"): "K6"}
MEGA = {(AB, "inner_solve_fused"): "K1", (AB, "al_update_lanes"): "K2"}


@contextlib.contextmanager
def split(names: dict, device):
    """Within: each call of the wrappers `names` ({(module, attribute):
    label}) is timed, by CUDA events on the card, on the host clock on the
    CPU. Yields {label: ms}, filled when the block ends (after a
    synchronize); the wrappers are restored."""
    real = {k: getattr(*k) for k in names}
    marks = {label: [] for label in names.values()}
    on_card = torch.device(device).type == "cuda"

    def timed(key):
        def wrapped(*args, **kw):
            if on_card:
                e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                e0.record()
                out = real[key](*args, **kw)
                e1.record()
                marks[names[key]].append((e0, e1))
            else:
                t0 = time.perf_counter()
                out = real[key](*args, **kw)
                marks[names[key]].append((t0, time.perf_counter()))
            return out
        return wrapped

    ms = {}
    for (mod, attr) in names:
        setattr(mod, attr, timed((mod, attr)))
    try:
        yield ms
        sync(device)
    finally:
        for (mod, attr), f in real.items():
            setattr(mod, attr, f)
    for label, v in marks.items():
        ms[label] = sum(a.elapsed_time(b) if on_card else 1e3 * (b - a) for a, b in v)
        ms[f"{label} launches"] = len(v)


def solve_split(ob, cfg: ALILQRConfig, names: dict) -> dict:
    """One solve_batched of ob split by `names`: ms each and the rest."""
    dev = ob.device
    sync(dev)
    t0 = time.perf_counter()
    with split(names, dev) as ms:
        AB.solve_batched(ob, cfg=cfg)
    total = 1e3 * (time.perf_counter() - t0)
    kern = sum(ms[label] for label in names.values())
    return dict(ms, total_ms=total, rest_ms=total - kern)


def kernels_alone(ob, cfg: ALILQRConfig, reps: int = 10) -> dict:
    """ms a launch of K4, K3, K5 and K6 at the first inner iteration's
    inputs (U 0, lam 0, mu mu_init), on the card."""
    B, N, nu = ob.x0.shape[0], ob.N, ob.nu
    kw = dict(dtype=ob.x0.dtype, device=ob.device)
    U = torch.zeros((B, N, nu), **kw)
    lam_l = torch.zeros((N, ob.n_con, B), **kw)
    mu = torch.full((B,), cfg.mu_init, **kw)
    X = P.rollout(ob, U)
    x0_l, xref_l, U_l = lane(ob.x0), lane(ob.xref), lane(U)
    Xs_l = lane(X[:, :-1])
    exp = AB.expansions_fused(ob, Xs_l, U_l, xref_l, lam_l, mu, None)
    kff, Kfb, _ = AB.riccati_lanes(exp, cfg.reg)
    ls = (0.0,) + tuple(cfg.alphas)
    alpha = torch.full((B,), 0.5, **kw)
    return {
        "K4": cuda_ms(lambda: AB.expansions_fused(ob, Xs_l, U_l, xref_l, lam_l, mu, None), reps),
        "K3": cuda_ms(lambda: AB.riccati_lanes(exp, cfg.reg), reps),
        "K5": cuda_ms(lambda: rollout.linesearch_costs_lanes(ob, x0_l, Xs_l, U_l, kff, Kfb,
                                                             xref_l, lam_l, mu, ls, None), reps),
        "K6": cuda_ms(lambda: rollout.rollout_alpha_lanes(ob, x0_l, Xs_l, U_l, kff, Kfb, alpha),
                      reps),
    }


def run(device, B: int = 4096, trace: str | None = None) -> dict:
    base = get("six_robot_antipodal").make(N=10, device=device)
    g = torch.Generator(device=device).manual_seed(0)
    noise = torch.randn((B, base.nx), generator=g, dtype=base.x0.dtype, device=device)
    ob = batch_ocp(base, base.x0[None] + 0.1 * noise)
    staged_cfg = dataclasses.replace(CFG, mega=False)
    AB.solve_batched(ob, cfg=staged_cfg)                    # warm-up: builds the kernels
    AB.solve_batched(ob, cfg=CFG)
    out = dict(B=B, device=device_label(device), staged=solve_split(ob, staged_cfg, STAGED),
               mega=solve_split(ob, CFG, MEGA))
    out["mega"]["solves_per_s"] = B / (out["mega"]["total_ms"] / 1e3)
    if device.type == "cuda":
        out["alone_ms"] = kernels_alone(ob, CFG)
    if trace:
        out["trace"] = write_trace(ob, staged_cfg, trace)
    return out


def write_trace(ob, cfg: ALILQRConfig, directory: str) -> dict:
    """A torch.profiler trace of one staged solve into directory; returns
    its path and the device ms summed by kernel name (the top 8)."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if ob.device.type == "cuda" else [])
    os.makedirs(directory, exist_ok=True)
    with profile(activities=acts) as prof:
        AB.solve_batched(ob, cfg=cfg)
        sync(ob.device)
    path = os.path.join(directory, "staged_solve.json")
    prof.export_chrome_trace(path)
    attr = "device_time_total" if ob.device.type == "cuda" else "cpu_time_total"
    rows = sorted(prof.key_averages(), key=lambda e: getattr(e, attr, 0.0), reverse=True)[:8]
    return dict(path=path, top={e.key: getattr(e, attr, 0.0) / 1e3 for e in rows})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m nmpc_tpu_torch.tools.profile_solve")
    ap.add_argument("-B", type=int, default=4096)
    ap.add_argument("--trace", default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--json", action="store_true")
    a = ap.parse_args(argv)
    dev = resolve_device(a.device, "profile_solve")
    out = run(dev, a.B, a.trace)
    st, mg = out["staged"], out["mega"]
    print(f"six_robot_antipodal N=10 B={out['B']} [{out['device']}]")
    for k in ("K4", "K3", "K5", "K6"):
        print(f"staged {k}: {st[k]:9.2f} ms over {st[f'{k} launches']} launches"
              + (f" ({out['alone_ms'][k]:.3f} ms a launch alone)" if "alone_ms" in out else ""))
    print(f"staged rest: {st['rest_ms']:9.2f} ms; staged solve {st['total_ms']:.2f} ms")
    print(f"megakernel route: K1 {mg['K1']:.2f} ms ({mg['K1 launches']} launches), K2 "
          f"{mg['K2']:.2f} ms, rest {mg['rest_ms']:.2f} ms; solve {mg['total_ms']:.2f} ms "
          f"({mg['solves_per_s']:.0f} solves/s)")
    if "trace" in out:
        print(f"trace written to {out['trace']['path']}")
    if a.json:
        print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
