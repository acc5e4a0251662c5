"""Scenario batching. Port of `batch_ocp`, `random_starts` and `batched_solve`
from nmpc_tpu/parallel/batch.py.

A batched OCP is the same dataclass with a leading [B] axis on the
per-scenario fields (x0, xref); everything else is shared.
"""

from __future__ import annotations

import dataclasses

import torch

from nmpc_tpu_torch.ocp.problem import OCP
from nmpc_tpu_torch.solver.alilqr import ALILQRConfig, SolveResult, WarmStart, _solve_scenarios


def batch_ocp(base: OCP, x0_batch: torch.Tensor,
              xref_batch: torch.Tensor | None = None) -> OCP:
    """Broadcast `base` into a batched OCP. x0_batch: [B, nx];
    xref_batch: [B, N, nx] (defaults to tiling base.xref)."""
    B = x0_batch.shape[0]
    if xref_batch is None:
        xref_batch = base.xref[None].expand(B, *base.xref.shape).contiguous()
    return dataclasses.replace(base, x0=x0_batch, xref=xref_batch)


def random_starts(base: OCP, generator: torch.Generator, B: int,
                  spread: float = 1.0) -> OCP:
    """Randomized-scenario batch: jitter every robot's start pose, uniform in
    [-spread, spread] on positions and half that on headings. `generator`
    lives on the device the noise is drawn on (base.x0's device)."""
    kw = dict(dtype=base.x0.dtype, device=base.x0.device)
    u01 = torch.rand((B, base.nx), generator=generator, **kw)
    noise = spread * (2.0 * u01 - 1.0)
    scale = torch.tensor([1.0, 1.0, 0.5], **kw).repeat(base.nx // 3)
    return batch_ocp(base, base.x0[None] + noise * scale[None])


def batched_solve(ocp_batch: OCP, cfg: ALILQRConfig = ALILQRConfig(),
                  warm: WarmStart | None = None) -> SolveResult:
    """The per-scenario engine over the batch axis of (x0, xref) [+ warm
    start]: each scenario's result is `solver.alilqr.solve` of it alone (the
    reference vmaps `solve`; here one loop with per-scenario done masks)."""
    return _solve_scenarios(ocp_batch, warm, cfg)
