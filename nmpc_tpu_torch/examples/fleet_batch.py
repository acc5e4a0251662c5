"""Scenario-fleet demo: thousands of randomized six-robot problems solved in
one shot. Port of examples/fleet_batch.py.

    python -m nmpc_tpu_torch.examples.fleet_batch [-B 4096] [--device cpu] [--json]

six_robot_antipodal at N=10, B starts from parallel/batch.random_starts
(spread 0.1), solve_batched with ALILQRConfig(n_outer=6, n_inner=12,
tol_con=1e-3): on the card the megakernel route (K1, K2). When a
torch.distributed world is initialized (the caller starts it, e.g. with
parallel/mesh.init_world; parallel/dryrun.run_world spawns one), the batch
is sharded over a data mesh of the whole world (parallel/mesh.data_mesh,
batch.shard_ocp_batch): each rank solves its rows, and the converged share
and violation are gathered; otherwise it solves on the one card. One
warm-up solve, then one timed solve of fresh starts (to a synchronize).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch
import torch.distributed as dist

from nmpc_tpu_torch.parallel import mesh as M
from nmpc_tpu_torch.parallel.batch import random_starts, shard_ocp_batch
from nmpc_tpu_torch.scenarios import get
from nmpc_tpu_torch.solver.alilqr import ALILQRConfig
from nmpc_tpu_torch.solver.alilqr_batched import solve_batched
from nmpc_tpu_torch.tools.roofline import device_label, resolve_device
from nmpc_tpu_torch.utils.timing import sync

CFG = ALILQRConfig(n_outer=6, n_inner=12, tol_con=1e-3)


def run(B: int, device, N: int = 10) -> dict:
    """The fleet's record: devices (ranks), solves/s of the timed solve,
    the converged share and the largest violation over all B scenarios."""
    device = torch.device(device)
    base = get("six_robot_antipodal").make(N=N, device=device)
    mesh = M.data_mesh(device_type=device.type) if dist.is_initialized() else None

    def batch(seed):
        ob = random_starts(base, torch.Generator(device=device).manual_seed(seed), B, spread=0.1)
        return ob if mesh is None else shard_ocp_batch(ob, mesh)

    float(solve_batched(batch(0), cfg=CFG).cost[0])      # warm-up: builds the kernels
    ob2 = batch(1)
    sync(device)
    t0 = time.perf_counter()
    res = solve_batched(ob2, cfg=CFG)
    sync(device)
    dt = time.perf_counter() - t0
    conv, viol = res.converged.float(), res.viol
    if mesh is not None:
        conv, viol = M.gather_rows(conv, mesh), M.gather_rows(viol, mesh)
        dt = float(M.all_reduce(torch.tensor([dt], device=device), mesh, op=dist.ReduceOp.MAX))
    return dict(devices=1 if mesh is None else dist.get_world_size(), B=B, solves_per_s=B / dt,
                converged=float(conv.mean()), max_viol=float(viol.max()))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m nmpc_tpu_torch.examples.fleet_batch")
    ap.add_argument("-B", type=int, default=4096)
    ap.add_argument("--N", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--json", action="store_true")
    a = ap.parse_args(argv)
    dev = resolve_device(a.device, "fleet_batch")
    r = run(a.B, dev, a.N)
    print(f"devices: {r['devices']}  batch: {r['B']}  [{device_label(dev)}]")
    print(f"{r['solves_per_s']:.0f} NMPC solves/s   converged {r['converged'] * 100:.0f}%   "
          f"max violation {r['max_viol']:.1e}")
    if a.json:
        print(json.dumps(r))
    return 0


if __name__ == "__main__":
    sys.exit(main())
