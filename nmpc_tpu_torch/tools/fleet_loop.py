"""Closed-loop fleet throughput, the serving metric. Port of
tools/bench_fleet_loop.py.

A fleet of MPC loops advancing in lockstep: each step is a warm-started
batched solve (shifted controls, carried duals and mu) -> first control ->
plant -> shift, all on the card. On pair-and-box problems every solve is the
megakernel route, at most RT_CFG.n_outer launches each of K1 and K2 a step.
Reported: fleet-steps/s (= warm solves/s, the number of loops one card
carries at one step per T, times 1/T), the largest planned violation, the
mean inner iterations a solve and the smallest realized pair distance over
the fleet.

Config: the bench shape (six_robot_antipodal, N=10) with starts jittered by
0.1, the rt-class budget per step (3x10, carried mu), seeded by one
SEED_CFG solve outside the clock; each timed chunk starts from fresh starts
and its own seed, so it measures the maneuver, not an arrived fleet.

    python -m nmpc_tpu_torch.tools.fleet_loop [B] [K] [chunks]

It runs on the card and refuses to time without one; `seed` and `chunk`
take tensors on any device.
"""

from __future__ import annotations

import dataclasses
import statistics
import sys
import time

import torch

from nmpc_tpu_torch.mpc.driver import _min_pair_dist, shift_warm
from nmpc_tpu_torch.ocp.problem import OCP
from nmpc_tpu_torch.parallel.batch import batch_ocp
from nmpc_tpu_torch.sim.plant import PlantConfig, plant_step
from nmpc_tpu_torch.solver.alilqr import ALILQRConfig, WarmStart
from nmpc_tpu_torch.solver.alilqr_batched import solve_batched

SEED_CFG = ALILQRConfig(n_outer=6, n_inner=12, tol_con=1e-3)
RT_CFG = ALILQRConfig(n_outer=3, n_inner=10, tol_con=1e-3)


@dataclasses.dataclass(frozen=True)
class Chunk:
    x: torch.Tensor          # [B, nx] fleet states after the chunk
    warm: WarmStart          # the next step's warm start
    max_viol: torch.Tensor   # largest planned violation over the chunk's solves
    mean_iters: torch.Tensor # mean inner iterations a solve
    min_dist: torch.Tensor   # smallest realized pair distance (start included)


def jittered(base: OCP, B: int, generator: torch.Generator, spread: float = 0.1) -> torch.Tensor:
    """B starts: base.x0 plus spread x N(0, 1) on every state."""
    noise = torch.randn((B, base.nx), generator=generator, dtype=base.x0.dtype,
                        device=base.device)
    return base.x0[None] + spread * noise


def seed(base: OCP, x0s: torch.Tensor, cfg: ALILQRConfig = SEED_CFG,
         rt_cfg: ALILQRConfig = RT_CFG) -> WarmStart:
    """The chunk's warm start: one full-strength batched solve from the
    starts, shifted with mu carried."""
    return shift_warm(solve_batched(batch_ocp(base, x0s), cfg=cfg), rt_cfg, mu_reset=False)


def chunk(base: OCP, x0s: torch.Tensor, warm: WarmStart, K: int,
          cfg: ALILQRConfig = RT_CFG, plant: PlantConfig = PlantConfig()) -> Chunk:
    """K lockstep steps of the B-wide fleet from x0s [B, nx]."""
    ob = batch_ocp(base, x0s)
    x, w = x0s, warm
    viols, iters, dists = [], [], [_min_pair_dist(base, x0s).amin()]
    for _ in range(K):
        res = solve_batched(dataclasses.replace(ob, x0=x), w, cfg)
        x, _ = plant_step(x, res.U[:, 0, :], base.T, plant)
        w = shift_warm(res, cfg, mu_reset=False)
        viols.append(res.viol.amax())
        iters.append(res.inner_iters.float().mean())
        dists.append(_min_pair_dist(base, x).amin())
    return Chunk(x=x, warm=w, max_viol=torch.stack(viols).amax(),
                 mean_iters=torch.stack(iters).mean(), min_dist=torch.stack(dists).amin())


@dataclasses.dataclass(frozen=True)
class TimedChunk:
    seconds: float           # the chunk on the host clock, synced at both ends
    x0: torch.Tensor         # [B, nx] its starts
    seed: WarmStart          # its warm start, solved outside the clock
    out: Chunk
    launches: dict           # kernel launches in the chunk (ops/cuda_build.launch_counts)


def timed_chunks(base: OCP, B: int, K: int, n: int, generator: torch.Generator) -> list:
    """n timed chunks on the card, each from fresh starts with its seed
    solved outside the clock; the launch counts are set to 0 just before
    each chunk's clock starts and read just after it stops."""
    from nmpc_tpu_torch.ops import cuda_build

    runs = []
    for _ in range(n):
        x0s = jittered(base, B, generator)
        w = seed(base, x0s)
        torch.cuda.synchronize()
        cuda_build.reset_launch_counts()
        t0 = time.perf_counter()
        out = chunk(base, x0s, w, K)
        torch.cuda.synchronize()
        runs.append(TimedChunk(time.perf_counter() - t0, x0s, w, out,
                               dict(cuda_build.launch_counts)))
    return runs


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    B = int(argv[0]) if len(argv) > 0 else 32768
    K = int(argv[1]) if len(argv) > 1 else 10
    n = int(argv[2]) if len(argv) > 2 else 3
    if not torch.cuda.is_available():
        raise RuntimeError("fleet_loop times the card: no CUDA device")
    from nmpc_tpu_torch.scenarios import get

    dev = torch.device("cuda", 0)
    base = get("six_robot_antipodal").make(N=10, device=dev)
    g = torch.Generator(device=dev).manual_seed(0)
    timed_chunks(base, B, K, 1, g)   # warm-up
    runs = timed_chunks(base, B, K, n, g)
    rate = [B * K / r.seconds for r in runs]
    print(f"fleet closed loop (six_robot_antipodal N=10) B={B} K={K} on "
          f"{torch.cuda.get_device_name(0)}: " + ", ".join(f"{r.seconds * 1e3:.1f}" for r in runs)
          + f" ms a chunk -> median {statistics.median(rate):.1f} fleet-steps/s; K1, K2 launches "
          f"a step " + ", ".join(f"{r.launches['inner_solve_fused'] / K:.1f}, "
                                 f"{r.launches['al_update_lanes'] / K:.1f}" for r in runs)
          + f"; max planned viol {max(float(r.out.max_viol) for r in runs):.3e}, mean iters a "
          f"solve {statistics.mean(float(r.out.mean_iters) for r in runs):.2f}, min realized pair "
          f"distance {min(float(r.out.min_dist) for r in runs):.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
