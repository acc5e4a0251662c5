"""The megakernel route's admission for one scenario, then a solve through
it. Port of tools/gate_check.py (the reference checks its VMEM gate,
`mega_fits`, and compiles and runs the megakernel).

For the scenario at its registry size: the route `solve_batched` takes
(`alilqr_batched.route`), and on the card K1's dynamic shared bytes a
block and its design (`megasolve.k1_block_bytes`) against the H100's 227
KB (staged_tiles.SMEM_BLOCK_MAX); then one solve at B=1 through that route
with ALILQRConfig(n_outer=2, n_inner=4, tol_con=1e-3), its cost finite,
and on the card K1 and K2 launched.

    python -m nmpc_tpu_torch.tools.gate_check <scenario> [--device cpu] [--json]

`SHAPES` are the seven registry shapes the reference's admission test
covers (tests/test_batched_solver.py:117-130). Without a card it refuses;
--device cpu checks the route and runs the plain kernels.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time

import torch

from nmpc_tpu_torch.ops import cuda_build
from nmpc_tpu_torch.ops.megasolve import k1_block_bytes
from nmpc_tpu_torch.ops.staged_tiles import SMEM_BLOCK_MAX
from nmpc_tpu_torch.parallel.batch import batch_ocp
from nmpc_tpu_torch.scenarios import get
from nmpc_tpu_torch.solver.alilqr import ALILQRConfig
from nmpc_tpu_torch.solver.alilqr_batched import route, solve_batched
from nmpc_tpu_torch.tools.roofline import resolve_device
from nmpc_tpu_torch.utils.timing import sync

CFG = ALILQRConfig(n_outer=2, n_inner=4, tol_con=1e-3)
SHAPES = ("single_robot", "tb3_1", "two_robot_swap", "five_robot", "six_robot_antipodal",
          "eight_robot", "ten_robot")


def check(name: str, device, cfg: ALILQRConfig = CFG) -> dict:
    """The gate's record for scenario `name` on `device`; raises if the
    route is not the megakernel route, if K1's block does not fit, if the
    cost is not finite, or (on the card) if K1 or K2 did not launch."""
    ocp = get(name).make(device=device)
    way = route(ocp, cfg)
    if way != "mega":
        raise RuntimeError(f"gate_check {name}: solve_batched takes the {way} route")
    smem = design = None
    if device.type == "cuda":
        smem, design = k1_block_bytes(ocp, cfg)
        if smem > SMEM_BLOCK_MAX:
            raise RuntimeError(f"gate_check {name}: K1's block takes {smem} B of shared memory, "
                               f"above the H100's {SMEM_BLOCK_MAX}")
    cuda_build.reset_launch_counts()
    t0 = time.perf_counter()
    res = solve_batched(batch_ocp(ocp, ocp.x0[None]), cfg=cfg)
    cost = float(res.cost[0])
    sync(device)
    secs = time.perf_counter() - t0
    counts = dict(cuda_build.launch_counts)
    if not math.isfinite(cost):
        raise RuntimeError(f"gate_check {name}: cost {cost}")
    if device.type == "cuda" and not (counts["inner_solve_fused"] > 0
                                       and counts["al_update_lanes"] > 0):
        raise RuntimeError(f"gate_check {name}: K1 and K2 did not launch ({counts})")
    return dict(name=name, m=ocp.m, N=ocp.N, route=way, k1_smem_bytes=smem,
                smem_limit=SMEM_BLOCK_MAX, k1_design=design, cost=cost, seconds=secs,
                K1=counts["inner_solve_fused"], K2=counts["al_update_lanes"])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m nmpc_tpu_torch.tools.gate_check")
    ap.add_argument("scenario")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--json", action="store_true")
    a = ap.parse_args(argv)
    dev = resolve_device(a.device, "gate_check")
    r = check(a.scenario, dev)
    smem = ("-" if r["k1_smem_bytes"] is None
            else f"{r['k1_smem_bytes']} B of {r['smem_limit']} ({r['k1_design']} design)")
    print(f"{r['name']}: OK route={r['route']} K1 shared a block {smem} cost={r['cost']:.3f} "
          f"build+run {r['seconds']:.1f}s")
    if a.json:
        print(json.dumps(r))
    return 0


if __name__ == "__main__":
    sys.exit(main())
