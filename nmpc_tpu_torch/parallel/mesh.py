"""Device meshes over a torch.distributed world, and the collectives of the
sharded forms. Port of nmpc_tpu/parallel/mesh.py (`data_mesh`,
`batch_sharding`, `replicated`).

JAX runs one controller over a Mesh of devices; PyTorch runs one process a
rank. Here a mesh is a `torch.distributed.device_mesh.DeviceMesh` over the
ranks of an initialized world, and a sharded form is code that every rank
runs on its own rows:

* `shard_rows` takes this rank's rows of a global array (the batch axis
  laid over one mesh dimension, or over several flattened in row-major
  order, as JAX lays PartitionSpec(("hosts", "chips"))), and `gather_rows`
  puts the rows of every rank back together on every rank (`all_gather`
  with tiled=True);
* `all_reduce` is `pmax` (ReduceOp.MAX) and the sum behind a mean.

The collectives run on each mesh dimension's process group in turn, so a
tuple of axes needs no group of its own. A group on gloo gets host tensors:
a tensor on the card is copied to the host for the collective and back,
because the caller chose gloo (two ranks on one card, where NCCL refuses
the pair), never because NCCL failed. NCCL groups exchange the card's
tensors in place. Nothing here starts a world: `init_world` is for scripts
and tests that mean to.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Replicate, Shard

from nmpc_tpu_torch.device import DEVICE


def init_world(backend: str, rank: int, world_size: int, init_method: str) -> None:
    """Join a world of `world_size` processes as `rank` (backend "nccl" or
    "gloo"; init_method e.g. "file:///path/store" or "tcp://localhost:port")."""
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world_size)


def require_world() -> int:
    """The initialized world's size; raises without a world."""
    if not dist.is_initialized():
        raise RuntimeError("no torch.distributed process group is initialized: join a world "
                           "first (mesh.init_world or torch.distributed.init_process_group)")
    return dist.get_world_size()


def data_mesh(n_devices: int | None = None, axis: str = "data",
              device_type: str = DEVICE.type) -> DeviceMesh:
    """A 1-D mesh over the first n_devices ranks of the initialized world
    (all of them by default), its dimension named `axis`. Raises without a
    world and when n_devices exceeds the world size. A rank beyond the
    first n_devices is in no shard (its coordinate is None)."""
    world = require_world()
    n = world if n_devices is None else n_devices
    if not 1 <= n <= world:
        raise ValueError(f"data_mesh: {n} devices asked of a world of {world}")
    return DeviceMesh(device_type, torch.arange(n), mesh_dim_names=(axis,))


def hosts_chips_mesh(hosts: int, device_type: str = DEVICE.type) -> DeviceMesh:
    """The two-level mesh of the reference's multi-host layout: the world's
    ranks as [hosts, world / hosts], row-major, its dimensions named
    ("hosts", "chips")."""
    world = require_world()
    if world % hosts:
        raise ValueError(f"hosts_chips_mesh: a world of {world} does not split into {hosts} hosts")
    return DeviceMesh(device_type, torch.arange(world).reshape(hosts, world // hosts),
                      mesh_dim_names=("hosts", "chips"))


def _names(axis) -> tuple:
    return (axis,) if isinstance(axis, str) else tuple(axis)


def batch_sharding(mesh: DeviceMesh, axis="data") -> list:
    """The placements of an array whose leading axis is laid over `axis` (a
    name or a tuple of names) and replicated over the mesh's other
    dimensions: [Shard(0)] on a 1-D mesh."""
    names = _names(axis)
    return [Shard(0) if d in names else Replicate() for d in mesh.mesh_dim_names]


def replicated(mesh: DeviceMesh) -> list:
    """The placements of an array every rank holds whole."""
    return [Replicate()] * mesh.ndim


def axis_size(mesh: DeviceMesh, axis) -> int:
    """The number of shards along `axis` (a product over a tuple)."""
    return math.prod(mesh.size(mesh.mesh_dim_names.index(d)) for d in _names(axis))


def axis_index(mesh: DeviceMesh, axis) -> int:
    """This rank's shard along `axis`, the names flattened in row-major
    order (jax.lax.axis_index)."""
    require_world()
    if mesh.get_coordinate() is None:
        raise RuntimeError(f"rank {dist.get_rank()} is not in the mesh {mesh}")
    i = 0
    for d in _names(axis):
        i = i * mesh.size(mesh.mesh_dim_names.index(d)) + mesh.get_local_rank(d)
    return i


def shard_bounds(mesh: DeviceMesh, axis, n: int) -> tuple:
    """(start, stop) of this rank's rows of an axis of length n; raises when
    n does not divide into the shards (as NamedSharding does), and
    without a world."""
    require_world()
    d = axis_size(mesh, axis)
    if n % d:
        raise ValueError(f"{n} rows do not divide over {d} shards of {_names(axis)}")
    i = axis_index(mesh, axis)
    return i * (n // d), (i + 1) * (n // d)


def shard_rows(x: torch.Tensor, mesh: DeviceMesh, axis="data") -> torch.Tensor:
    """This rank's rows of the global x (its leading axis laid over `axis`),
    as a tensor of its own: the rows are copied into a fresh allocation, so
    a kernel's base pointer is an allocation's start and never an offset
    into the global array."""
    a, b = shard_bounds(mesh, axis, x.shape[0])
    return x[a:b].clone(memory_format=torch.contiguous_format)


def _gather(t: torch.Tensor, group) -> torch.Tensor:
    """all_gather(tiled=True) of t on one group: the members' t stacked
    along axis 0 in group-rank order."""
    t = t.contiguous()
    if dist.get_backend(group) == "gloo":
        host = t.cpu()
        parts = [torch.empty_like(host) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, host, group=group)
        return torch.cat(parts).to(t.device)
    out = t.new_empty((dist.get_world_size(group) * t.shape[0], *t.shape[1:]))
    dist.all_gather_into_tensor(out, t, group=group)
    return out


def gather_rows(x_local: torch.Tensor, mesh: DeviceMesh, axis="data") -> torch.Tensor:
    """The global array from every rank's rows along `axis`, on every rank
    (all_gather, tiled): the innermost name first, so the rows come back in
    shard_rows' row-major order."""
    require_world()
    out = x_local
    for d in reversed(_names(axis)):
        out = _gather(out, mesh.get_group(d))
    return out


def all_reduce(t: torch.Tensor, mesh: DeviceMesh, axis="data",
               op=dist.ReduceOp.SUM) -> torch.Tensor:
    """t reduced over the shards of `axis` (ReduceOp.MAX is pmax), returned
    on every rank as a new tensor."""
    require_world()
    out = t.detach().clone()
    for d in _names(axis):
        group = mesh.get_group(d)
        if dist.get_backend(group) == "gloo":
            host = out.cpu()
            dist.all_reduce(host, op=op, group=group)
            out = host.to(t.device)
        else:
            dist.all_reduce(out, op=op, group=group)
    return out
