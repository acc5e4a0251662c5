"""Per-phase timers, latency statistics and device timing. Port of
nmpc_tpu/utils/timing.py.

`PhaseTimer` and `latency_stats` carry over unchanged. `time_fn` ends every
sample in `torch.cuda.synchronize()`, where the reference blocks on the
result (`jax.block_until_ready`): PyTorch returns before the device
finishes, so a host clock without it would time the enqueue. `cuda_ms` times
kernels with CUDA events. Both need a card; without one they fail with
torch's own error rather than time the CPU.
"""

from __future__ import annotations

import time
from collections import defaultdict
from contextlib import contextmanager

import numpy as np
import torch


class PhaseTimer:
    """Accumulates wall-clock per named phase; thread-unsafe by design (one
    per driver loop)."""

    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def summary(self) -> dict:
        return {
            k: {"total_s": self.totals[k], "count": self.counts[k],
                "mean_s": self.totals[k] / max(self.counts[k], 1)}
            for k in self.totals
        }


def sync(device) -> None:
    """Wait for the card when `device` is a CUDA device (no-op on the CPU)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def latency_stats(samples_s) -> dict:
    """p50/p90/p99/max of a latency sample list, in milliseconds."""
    a = np.asarray(samples_s, float) * 1e3
    if a.size == 0:
        return {}
    return {
        "p50_ms": float(np.percentile(a, 50)),
        "p90_ms": float(np.percentile(a, 90)),
        "p99_ms": float(np.percentile(a, 99)),
        "max_ms": float(a.max()),
        "mean_ms": float(a.mean()),
        "n": int(a.size),
    }


def time_fn(fn, *args, iters: int = 20, warmup: int = 2):
    """Time a callable on the card, each sample on the host clock ending in
    a device synchronize; returns (last_result, latency_stats dict)."""
    out = None
    for _ in range(warmup):
        out = fn(*args)
    torch.cuda.synchronize()
    samples = []
    for _ in range(iters):
        t0 = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        samples.append(time.perf_counter() - t0)
    return out, latency_stats(samples)


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean milliseconds of fn() on the card: CUDA events around `reps`
    back-to-back calls, after `warmup` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps
