"""Benchmark: NMPC solves/s on one card for the six-robot, N=10-horizon
problem. Port of bench.py (the JAX package's, whose problem, config,
timing and JSON line it keeps).

    python -m nmpc_tpu_torch bench

six_robot_antipodal at N=10, a batch of B=32768 starts x0 + 0.1 N(0, 1)
drawn from a seeded torch.Generator on the card, solved by `solve_batched`
with ALILQRConfig(n_outer=6, n_inner=12, tol_con=1e-3, ls="adaptive") on
the megakernel route: each AL outer step one launch of K1 (the fused inner
solve, csrc/inner_warp.cuh) and one of K2 (the multiplier update). One
warm-up solve (it builds the kernels), then 4 solves on fresh inputs, each
timed from its start to `torch.cuda.synchronize()`; the value is
B / min(times), vs_baseline value / 1000 (the north-star 1,000 solves/s).

Prints exactly one JSON line {"metric", "value", "unit", "vs_baseline",
"engine"}. No silent fallback: it raises without a card, if the problem no
longer takes the megakernel route, and if a timed solve did not launch K1
and K2.
"""

from __future__ import annotations

import dataclasses
import json
import time

import torch

from nmpc_tpu_torch.ocp.problem import OCP
from nmpc_tpu_torch.ops import cuda_build
from nmpc_tpu_torch.ops import rollout
from nmpc_tpu_torch.ops.megasolve import cuda_unsupported
from nmpc_tpu_torch.parallel.batch import batch_ocp
from nmpc_tpu_torch.scenarios import get
from nmpc_tpu_torch.solver.alilqr import ALILQRConfig, resolve_sweep
from nmpc_tpu_torch.solver.alilqr_batched import solve_batched
from nmpc_tpu_torch.utils.timing import sync

B = 32768
CFG = ALILQRConfig(n_outer=6, n_inner=12, tol_con=1e-3, ls="adaptive")
ITERS = 4
METRIC = "NMPC solves/s/chip (six-robot, N=10 horizon)"
ENGINE = "cuda-megakernel"


def route_refusal(ob: OCP, cfg: ALILQRConfig) -> str | None:
    """Why `solve_batched` would not take the megakernel route for this
    batch and config, or None (its rule: the staged kernels' problem class,
    sweep "seq", cfg.mega, and K1's)."""
    if not cfg.mega:
        return "cfg.mega is False"
    if resolve_sweep(cfg, ob.N) != "seq":
        return f"sweep {resolve_sweep(cfg, ob.N)!r}"
    return rollout.unsupported(ob) or cuda_unsupported(ob, cfg)


def measure(b: int = B, device=None, solve=solve_batched) -> dict:
    """The benchmark's record at batch b on `device` (default the card).
    `solve(ocp_b, warm, cfg)` is the solver under test. Raises RuntimeError
    if the batch does not take the megakernel route, or if a solve does not
    launch K1 and K2 (`cuda_build.launch_counts`)."""
    from nmpc_tpu_torch.device import DEVICE

    device = torch.device(device or DEVICE)
    base = get("six_robot_antipodal").make(N=10, device=device)
    g = torch.Generator(device=device).manual_seed(0)

    def starts():
        return base.x0[None] + 0.1 * torch.randn((b, base.nx), generator=g, device=device,
                                                 dtype=base.x0.dtype)

    ob = batch_ocp(base, starts())
    why = route_refusal(ob, CFG)
    if why is not None:
        raise RuntimeError(f"bench: the batch no longer takes the megakernel route: {why}")

    def launched(tag):
        c = dict(cuda_build.launch_counts)
        if not (c["inner_solve_fused"] > 0 and c["al_update_lanes"] > 0):
            raise RuntimeError(f"bench: the {tag} solve did not launch K1 and K2 ({c})")

    cuda_build.reset_launch_counts()
    res = solve(ob, None, CFG)
    float(res.cost[0])                    # builds the kernels, forces completion
    launched("warm-up")
    times = []
    for i in range(ITERS):
        ob_i = dataclasses.replace(ob, x0=starts())
        cuda_build.reset_launch_counts()
        sync(device)                      # inputs on the card before the clock starts
        t0 = time.perf_counter()
        solve(ob_i, None, CFG)
        sync(device)
        times.append(time.perf_counter() - t0)
        launched(f"timed ({i})")
    rate = b / min(times)
    return {"metric": METRIC, "value": round(rate, 1), "unit": "solves/s",
            "vs_baseline": round(rate / 1000.0, 3), "engine": ENGINE}


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("bench: no CUDA device (torch.cuda.is_available() is False); the "
                           "benchmark runs the hand-written kernels on the card only")
    print(json.dumps(measure()))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
