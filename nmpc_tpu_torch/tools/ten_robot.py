"""BASELINE config 5: ten-robot centralized collision avoidance, thousands of
randomized scenarios batched on one card. Port of tools/bench_ten_robot.py.

The ten-robot joint NLP is the reference's largest (1,030 variables, 1,575
IPOPT rows: mpc_online_casadi_tb3_ten_multi_centralized_collision_avoidance.py
:169-173, 270-361). This solves B ten_robot scenarios (the registry's line
formation, starts jittered by 0.1 N(0, 1)) a batch with `solve_batched`
at the bench config, ALILQRConfig(n_outer=6, n_inner=12, tol_con=1e-3,
ls="adaptive"): the megakernel route, K1 in its warp design at m=10 (one
warp a scenario) and K2. One solve reports quality (converged share,
violation p99 and max, mean inner iterations); then 4 solves of fresh
starts, each timed from its start to a synchronize; solves/s = B / min.

    python -m nmpc_tpu_torch.tools.ten_robot [B] [N] [--iters 4] [--device cpu] [--json]

On the card (the default) it refuses to run without one, and raises if a
timed solve did not launch K1 in its warp design and K2. --device cpu runs
the plain kernels (a small B to check the path; its times are the CPU's).
"""

from __future__ import annotations

import argparse
import json
import sys

from nmpc_tpu_torch.bench import fleet, quality
from nmpc_tpu_torch.ocp.problem import OCP
from nmpc_tpu_torch.scenarios import get
from nmpc_tpu_torch.solver.alilqr import ALILQRConfig
from nmpc_tpu_torch.solver.alilqr_batched import route
from nmpc_tpu_torch.tools.roofline import device_label, resolve_device

B = 4096
CFG = ALILQRConfig(n_outer=6, n_inner=12, tol_con=1e-3, ls="adaptive")
ITERS = 4


def base(device, N: int | None = None) -> OCP:
    sc = get("ten_robot")
    return sc.make(device=device) if N is None else sc.make(device=device, N=N)


def measure(device, b: int = B, N: int | None = None, iters: int = ITERS,
            cfg: ALILQRConfig = CFG) -> dict:
    """The fleet's record on `device` (bench.fleet): quality of one solve,
    then `iters` timed solves of fresh starts (seconds each), solves/s =
    b / min, and the launches of the last timed solve."""
    o = base(device, N)
    if route(o, cfg) != "mega":
        raise RuntimeError(f"ten_robot: N={o.N} takes the {route(o, cfg)} route, not the "
                           f"megakernel route")
    res, times, counts = fleet(o, cfg, b, iters, design="warp", what="ten_robot")
    t = min(times)
    return dict(quality(res), N=o.N, B=b, m=o.m, times_s=times, ms_batch=t * 1e3,
                solves_per_s=b / t, K1=counts["inner_solve_fused"], K2=counts["al_update_lanes"],
                device=device_label(device))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m nmpc_tpu_torch.tools.ten_robot")
    ap.add_argument("B", nargs="?", type=int, default=B)
    ap.add_argument("N", nargs="?", type=int, default=None)
    ap.add_argument("--iters", type=int, default=ITERS)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--json", action="store_true")
    a = ap.parse_args(argv)
    dev = resolve_device(a.device, "ten_robot")
    r = measure(dev, a.B, a.N, a.iters)
    print(f"conv={r['conv']:.4f} viol_p99={r['viol_p99']:.2e} viol_max={r['viol_max']:.2e} "
          f"mean_inner={r['mean_inner']:.1f}")
    print(f"ten-robot N={r['N']} B={r['B']}: {r['solves_per_s']:.1f} solves/s "
          f"({r['ms_batch']:.1f} ms/batch; K1 {r['K1']}, K2 {r['K2']} launches a solve) "
          f"[{r['device']}]")
    if a.json:
        print(json.dumps(r))
    return 0


if __name__ == "__main__":
    sys.exit(main())
