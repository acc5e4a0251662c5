"""Scenario batching. Port of `batch_ocp`, `random_starts`, `batched_solve`
and `shard_ocp_batch` from nmpc_tpu/parallel/batch.py.

A batched OCP is the same dataclass with a leading [B] axis on the
per-scenario fields (x0, xref, and a per-scenario moving-obstacle schedule
[B, N, n_mov, 2]); everything else is shared.
"""

from __future__ import annotations

import dataclasses

import torch

from nmpc_tpu_torch.ocp.problem import OCP, batch_fields
from nmpc_tpu_torch.parallel.mesh import require_world, shard_rows
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


def shard_ocp_batch(ocp_batch: OCP, mesh, axis="data") -> OCP:
    """This rank's part of a batched OCP on the mesh (a DeviceMesh over the
    world, `parallel.mesh`): its rows of the batch fields, laid over `axis`
    (a name or a tuple of names), and every other field as it is, the same
    on every rank (replicated). The rows are copies of their own
    (`mesh.shard_rows`), so only local tensors reach a kernel.

    The reference's batch fields are x0 and xref. A per-scenario mov_obs
    [B, N, n_mov, 2], the port's layout of per-element schedules
    (solver/gn.py, solve_batched), is a batch field too and is sharded
    with them; the reference has no such layout to shard. Raises when B
    does not divide over the shards, and without a world."""
    require_world()
    return dataclasses.replace(ocp_batch, **{
        f: shard_rows(getattr(ocp_batch, f), mesh, axis) for f in batch_fields(ocp_batch)})
