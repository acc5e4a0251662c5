"""Benchmark: NMPC solves/s on one card for the six-robot, N=10-horizon
problem. Port of bench.py (the JAX package's, whose problem, config,
timing and JSON line it keeps).

    python -m nmpc_tpu_torch bench

six_robot_antipodal at N=10, a batch of B=32768 starts x0 + 0.1 N(0, 1)
drawn from a seeded torch.Generator on the card (`jittered`), solved by
`solve_batched` with ALILQRConfig(n_outer=6, n_inner=12, tol_con=1e-3,
ls="adaptive") on the megakernel route: each AL outer step one launch of
K1 (the fused inner solve, csrc/inner_warp.cuh) and one of K2 (the
multiplier update). One warm-up solve (it builds the kernels), then 4
solves on fresh inputs, each timed from its start to
`torch.cuda.synchronize()` (`fleet`, which the fleet tools share); the
value is B / min(times), vs_baseline value / 1000 (the north-star 1,000
solves/s).

Prints exactly one JSON line {"metric", "value", "unit", "vs_baseline",
"engine"}. No silent fallback: it raises without a card, if the problem no
longer takes the megakernel route, and if a timed solve did not launch K1
and K2.
"""

from __future__ import annotations

import json
import time

import numpy as np
import torch

from nmpc_tpu_torch.ocp.problem import OCP
from nmpc_tpu_torch.ops import cuda_build
from nmpc_tpu_torch.ops.megasolve import cuda_unsupported
from nmpc_tpu_torch.parallel.batch import batch_ocp
from nmpc_tpu_torch.scenarios import get
from nmpc_tpu_torch.solver.alilqr import ALILQRConfig
from nmpc_tpu_torch.solver.alilqr_batched import route, solve_batched
from nmpc_tpu_torch.utils.timing import sync

B = 32768
CFG = ALILQRConfig(n_outer=6, n_inner=12, tol_con=1e-3, ls="adaptive")
ITERS = 4
SPREAD = 0.1
METRIC = "NMPC solves/s/chip (six-robot, N=10 horizon)"
ENGINE = "cuda-megakernel"


def route_refusal(ob: OCP, cfg: ALILQRConfig) -> str | None:
    """Why `solve_batched` would not take the megakernel route for this
    batch and config, or None (its rule, `alilqr_batched.route`, and K1's
    refusals of cfg)."""
    way = route(ob, cfg)
    if way != "mega":
        return f"it takes the {way} route (cfg.mega={cfg.mega}, sweep {cfg.sweep!r})"
    return cuda_unsupported(ob, cfg)


def jittered(base: OCP, b: int, g: torch.Generator, spread: float = SPREAD) -> OCP:
    """A batch of b problems from base's start jittered by spread N(0, 1),
    drawn from g (the reference tools' draw; parallel.batch.random_starts
    draws the uniform jitter of the fleet loop)."""
    noise = torch.randn((b, base.nx), generator=g, dtype=base.x0.dtype, device=base.device)
    return batch_ocp(base, base.x0[None] + spread * noise)


def quality(res) -> dict:
    """A batch solve's quality: converged share, mean cost, violation
    p50/p99/max and mean inner iterations."""
    viol = res.viol.double().cpu().numpy()
    return dict(conv=float(res.converged.float().mean()), mean_cost=float(res.cost.mean()),
                viol_p50=float(np.percentile(viol, 50)), viol_p99=float(np.percentile(viol, 99)),
                viol_max=float(viol.max()), mean_inner=float(res.inner_iters.float().mean()))


def fleet(base: OCP, cfg: ALILQRConfig, b: int, iters: int, solve=solve_batched, *,
          seed: int = 0, design: str | None = None, check: bool | None = None,
          what: str = "bench") -> tuple:
    """The fleet measurement of the benchmark and the fleet tools (tools/
    ten_robot.py, ls_ab.py, iteration_levers.py): one solve of b starts
    `jittered` from base (it builds the kernels; the tools read its
    quality), then `iters` solves of fresh starts, each timed from its start
    to a synchronize. `solve(ocp_b, warm, cfg)` is the solver under test.
    Returns (the first solve's result, the seconds of each timed solve, the
    last timed solve's launch counts). `check` (default: on the card)
    raises RuntimeError where a solve did not launch K1 and K2, or, with
    `design`, launched K1 in another design (cuda_build.k1_designs)."""
    dev = base.device
    check = dev.type == "cuda" if check is None else check
    g = torch.Generator(device=dev).manual_seed(seed)

    def launched(tag: str) -> dict:
        c, d = dict(cuda_build.launch_counts), dict(cuda_build.k1_designs)
        ok = (c["inner_solve_fused"] > 0 and c["al_update_lanes"] > 0
              and (design is None or d[design] == c["inner_solve_fused"]))
        if check and not ok:
            how = "" if design is None else f" (K1 in its {design} design)"
            raise RuntimeError(f"{what}: the {tag} solve did not launch K1 and K2{how} ({c}, {d})")
        return c

    cuda_build.reset_launch_counts()
    first = solve(jittered(base, b, g), None, cfg)
    sync(dev)
    launched("first")
    times = []
    for i in range(iters):
        ob = jittered(base, b, g)
        cuda_build.reset_launch_counts()
        sync(dev)                         # inputs on the card before the clock starts
        t0 = time.perf_counter()
        solve(ob, None, cfg)
        sync(dev)
        times.append(time.perf_counter() - t0)
        counts = launched(f"timed ({i})")
    return first, times, counts


def measure(b: int = B, device=None, solve=solve_batched) -> dict:
    """The benchmark's record at batch b on `device` (default the card):
    `fleet` of the bench problem and config, solves/s = b / min. Raises
    RuntimeError if the batch does not take the megakernel route, or if a
    solve does not launch K1 and K2 (`cuda_build.launch_counts`)."""
    from nmpc_tpu_torch.device import DEVICE

    device = torch.device(device or DEVICE)
    base = get("six_robot_antipodal").make(N=10, device=device)
    why = route_refusal(batch_ocp(base, base.x0[None].repeat(b, 1)), CFG)
    if why is not None:
        raise RuntimeError(f"bench: the batch no longer takes the megakernel route: {why}")
    _, times, _ = fleet(base, CFG, b, ITERS, solve, check=True)
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
