"""Decentralized NMPC rounds/s, engine "fused" against engine "xla". Port of
tools/bench_decentralized.py.

One decentralized round = every robot's 3-state subproblem solved against
the exchanged neighbour plans (parallel/decentralized.decentralized_step):
engine "fused" is `solve_batched` on the robots' batch (the megakernel
route: K1's obstacle variant with the m-1 neighbours as moving-obstacle
rows, in its team design at m=1, and K2), engine "xla" the per-scenario
engine (`batched_solve`, plain PyTorch), as the reference's vmapped solve.
m robots start on the unit circle facing inward, goals antipodal, N=30,
T=0.1, dmin=0.3, ALILQRConfig(n_outer=6, n_inner=12, tol_con=1e-4). A run
is K rounds (the reference's jitted scan body: the round, then U and lam
shifted one stage, mu reset to mu_init, the plans shifted; the state held),
timed from its start to a synchronize; ms a round = min over the runs / K,
each run from x0 + 1e-4 i.

    python -m nmpc_tpu_torch.tools.decentralized [m] [N] [iters] [--rounds 50]
        [--engines fused,xla] [--device cpu] [--json]

On the card it refuses to run without one and raises if engine "fused" did
not launch K1 and K2; --device cpu runs the plain kernels.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time

import torch

from nmpc_tpu_torch.ops import cuda_build
from nmpc_tpu_torch.parallel.decentralized import cold_warms, decentralized_step, robot_template
from nmpc_tpu_torch.solver.alilqr import ALILQRConfig, WarmStart
from nmpc_tpu_torch.tools.roofline import device_label, resolve_device
from nmpc_tpu_torch.utils.timing import sync

CFG = ALILQRConfig(n_outer=6, n_inner=12, tol_con=1e-4)
ROUNDS = 50


def setup(m: int, N: int, device) -> tuple:
    """(template, x0 [3m], goals [m, 3], plans [m, N+1, 2], cold warms)."""
    tpl = robot_template(N, 0.1, 0.3, m, device=device)
    ang = torch.arange(m, dtype=torch.float64) * 2 * math.pi / m
    x0 = torch.stack([ang.cos(), ang.sin(), ang + math.pi], -1).reshape(-1).float().to(device)
    goals = torch.stack([-ang.cos(), -ang.sin(), ang + math.pi], -1).float().to(device)
    plans = x0.reshape(m, 3)[:, None, :2].repeat(1, N + 1, 1)
    return tpl, x0, goals, plans, cold_warms(tpl, m, CFG)


def k_rounds(tpl, x0, goals, plans, warms: WarmStart, engine: str, K: int):
    """K rounds as the reference's scan body; returns the first robot's
    control of each round [K, 2]."""
    us = []
    for _ in range(K):
        res, u, plans_new = decentralized_step(tpl, x0, goals, plans, warms, CFG, engine=engine)
        warms = WarmStart(U=torch.cat([res.U[:, 1:], res.U[:, -1:]], dim=1),
                          lam=torch.cat([res.lam[:, 1:], res.lam[:, -1:]], dim=1),
                          mu=torch.full_like(res.mu, CFG.mu_init))
        plans = torch.cat([plans_new[:, 1:], plans_new[:, -1:]], dim=1)
        us.append(u[:2])
    return torch.stack(us)


def run(device, m: int = 6, N: int = 30, iters: int = 10, K: int = ROUNDS,
        engines=("fused", "xla")) -> dict:
    tpl, x0, goals, plans, w = setup(m, N, device)
    rows = []
    for engine in engines:
        k_rounds(tpl, x0, goals, plans, w, engine, 1)        # warm-up
        times = []
        for i in range(iters):
            x0_i = x0 + 1e-4 * i
            cuda_build.reset_launch_counts()
            sync(device)
            t0 = time.perf_counter()
            us = k_rounds(tpl, x0_i, goals, plans, w, engine, K)
            sync(device)
            times.append(time.perf_counter() - t0)
        c = dict(cuda_build.launch_counts)
        if device.type == "cuda" and engine == "fused" and not (
                c["inner_solve_fused"] > 0 and c["al_update_lanes"] > 0):
            raise RuntimeError(f"decentralized: engine 'fused' did not launch K1 and K2 ({c})")
        if not bool(torch.isfinite(us).all()):
            raise RuntimeError(f"decentralized: engine {engine!r} gave non-finite controls")
        t = min(times) / K
        rows.append(dict(engine=engine, ms_round=t * 1e3, rounds_per_s=1.0 / t, rounds=K,
                         runs=iters, K1_per_round=c["inner_solve_fused"] / K,
                         K2_per_round=c["al_update_lanes"] / K))
    return dict(m=m, N=N, device=device_label(device), rows=rows)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m nmpc_tpu_torch.tools.decentralized")
    ap.add_argument("m", nargs="?", type=int, default=6)
    ap.add_argument("N", nargs="?", type=int, default=30)
    ap.add_argument("iters", nargs="?", type=int, default=10)
    ap.add_argument("--rounds", type=int, default=ROUNDS)
    ap.add_argument("--engines", default="fused,xla")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--json", action="store_true")
    a = ap.parse_args(argv)
    dev = resolve_device(a.device, "decentralized")
    out = run(dev, a.m, a.N, a.iters, a.rounds, tuple(a.engines.split(",")))
    print(f"m={out['m']} N={out['N']} [{out['device']}]")
    for r in out["rows"]:
        print(f"{r['engine']:6s}: {r['ms_round']:8.2f} ms/round  ({r['rounds_per_s']:8.1f} "
              f"rounds/s)  [{r['rounds']} rounds a run; K1 {r['K1_per_round']:.2f} a round]")
    if a.json:
        print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
