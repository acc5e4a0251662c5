"""Family-I (LiDAR v4) fleet throughput: lidar_v4 solves/s through the
batched condensed Gauss-Newton engine. Port of tools/bench_lidar.py.

The ray-augmented problem class is the condensed GN engine's
(solver/gn.py): per GN iteration one batched [B, Nc nu, Nc nu] Cholesky
plus the batched residuals and sensitivities, all plain PyTorch (the
reference has no Pallas kernel here). Config: the published v4 scenario
(N=100, Nc=50, 10 rays, 1/d cost) with a fixed scan fixture (every ray at
the 3.5 m cap but rays 1 and 2 at 0.9 and 1.1 m, the obstacle points frozen
from the registry start), the fleet recipe GNConfig(Nc=50, n_gn=10,
n_outer=4, tol_con=1e-3), and B starts jittered by 0.05 in pose. Each timed
batch draws fresh starts; the first call is the warm-up. Timed on the host
clock with a synchronize at both ends.

    python -m nmpc_tpu_torch.tools.lidar_fleet [B] [iters] [normal]
    python -m nmpc_tpu_torch.tools.lidar_fleet tour [max_steps]

`tour` runs the lidar_v4 closed loop at B=1 instead (`tour`): steps to
arrival, the smallest clearance, per-step latency.

It runs on the card and refuses to time without one; `fixture`, `scanned`
(a scenario's ray states from one raycast, the hybrid route's family-I
problem in chip_smoke.py) and `jittered` take any device.
"""

from __future__ import annotations

import dataclasses
import sys
import time

import torch

from nmpc_tpu_torch.ocp.problem import OCP
from nmpc_tpu_torch.sim.lidar import obstacle_points, ray_angles, raycast
from nmpc_tpu_torch.solver import gn

CFG = gn.GNConfig(Nc=50, n_gn=10, n_outer=4, tol_con=1e-3)


def fixture(device, **make_kw) -> OCP:
    """lidar_v4 at its registry size (make_kw: overrides, e.g. N) with the
    scan fixture: ray states and frozen obstacle points from one scan at the
    start pose."""
    from nmpc_tpu_torch.scenarios import get

    sc = get("lidar_v4")
    base = sc.make(device=device, **make_kw)
    R = sc.num_rays
    scan = torch.full((R,), 3.5, dtype=base.x0.dtype, device=device)
    scan[1], scan[2] = 0.9, 1.1
    p_obs = obstacle_points(base.x0[:3], scan, ray_angles(R, base.x0.dtype, device))
    return dataclasses.replace(base, p_obs=p_obs, x0=torch.cat([base.x0[:3], scan]))


def scanned(name: str, circles, device, **make_kw) -> OCP:
    """A LiDAR scenario of the registry (make_kw: its overrides) with its
    ray states and frozen obstacle points from one raycast of the circles
    [n, 3] at its start pose (the hybrid route's family-I fixture)."""
    from nmpc_tpu_torch.scenarios import get

    base = get(name).make(device=device, **make_kw)
    angles = ray_angles(base.num_rays, base.x0.dtype, device)
    pose = base.x0[:3]
    scan = raycast(pose, torch.as_tensor(circles, dtype=base.x0.dtype, device=device), angles)
    return dataclasses.replace(base, x0=torch.cat([pose, scan]),
                               p_obs=obstacle_points(pose, scan, angles))


def jittered(base: OCP, B: int, generator: torch.Generator, spread: float = 0.05) -> OCP:
    """A batch of B problems: base's pose plus spread x N(0, 1), its ray
    states and reference shared."""
    noise = spread * torch.randn((B, 3), generator=generator, dtype=base.x0.dtype,
                                 device=base.device)
    x0s = torch.cat([base.x0[None, :3] + noise, base.x0[None, 3:].expand(B, -1)], dim=1)
    return dataclasses.replace(base, x0=x0s, xref=base.xref[None].expand(B, *base.xref.shape))


def timed(base: OCP, B: int, iters: int, generator: torch.Generator,
          cfg: gn.GNConfig = CFG) -> list:
    """[(seconds, SolveResult)] of `iters` batches of fresh starts after one
    warm-up batch, on the card."""
    from nmpc_tpu_torch.tools.roofline import require_card

    require_card("lidar_fleet")
    gn.solve_batched(jittered(base, B, generator), cfg=cfg)
    runs = []
    for _ in range(iters):
        ob = jittered(base, B, generator)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = gn.solve_batched(ob, cfg=cfg)
        torch.cuda.synchronize()
        runs.append((time.perf_counter() - t0, res))
    return runs


# the CL_PARITY fixture of the lidar_v4 tour (tools/gen_cl_parity.py:251):
# one circle on the straight first leg, with the fleet recipe
TOUR_OBSTACLES = ((0.5, 0.25, 0.1),)


def tour(device, max_steps: int = 300, cfg: gn.GNConfig = CFG) -> dict:
    """The lidar_v4 closed loop at the published config (N=100, Nc=50) on
    the CL_PARITY fixture, B=1 through mpc/lidar.closed_loop_lidar: its
    histories, the steps to arrival (max_steps if it does not arrive), the
    smallest realized clearance over them, and each step's ms on the host
    clock (stamped after a device sync as each solve starts)."""
    from nmpc_tpu_torch.mpc.lidar import closed_loop_lidar
    from nmpc_tpu_torch.scenarios import get

    sc = get("lidar_v4")
    stamps = []

    def solve_fn(o, w):
        if o.device.type == "cuda":
            torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        return gn.solve(o, w, cfg)

    X, U, clr, gidx, done = closed_loop_lidar(
        sc.make(device=device), torch.tensor(TOUR_OBSTACLES, device=device),
        sc.waypoint_array.to(device), cfg=cfg, max_steps=max_steps, solve_fn=solve_fn)
    if X.device.type == "cuda":
        torch.cuda.synchronize()
    end = time.perf_counter()
    fin = torch.nonzero(gidx >= sc.waypoint_array.shape[0])
    steps = int(fin[0]) if len(fin) else max_steps
    return dict(X=X, U=U, clearance=clr, goal_idx=gidx, reached=bool(done), steps=steps,
                min_clearance=float(clr[:steps + 1].min()),
                step_ms=[1e3 * (b - a) for a, b in zip(stamps, stamps[1:] + [end])])


def main(argv=None) -> int:
    from nmpc_tpu_torch.tools.roofline import card, require_card

    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["tour"]:
        require_card("lidar_fleet tour")
        import numpy as np

        r = tour(torch.device("cuda", 0), int(argv[1]) if len(argv) > 1 else 300)
        ms = np.asarray(r["step_ms"])
        print(f"lidar_v4 tour (N=100, Nc={CFG.Nc}, CL_PARITY fixture) on "
              f"{torch.cuda.get_device_name(0)} [{card()}]: arrived {r['reached']} in "
              f"{r['steps']} steps, min clearance {r['min_clearance']:.4f}; {len(ms)} solves, "
              f"step p50 {np.percentile(ms, 50):.1f} ms, p99 {np.percentile(ms, 99):.1f} ms")
        return 0
    B = int(argv[0]) if len(argv) > 0 else 1024
    iters = int(argv[1]) if len(argv) > 1 else 4
    normal = argv[2] if len(argv) > 2 else CFG.normal
    require_card("lidar_fleet")
    dev = torch.device("cuda", 0)
    base = fixture(dev)
    g = torch.Generator(device=dev).manual_seed(0)
    runs = timed(base, B, iters, g, dataclasses.replace(CFG, normal=normal))
    t = min(s for s, _ in runs)
    res = runs[-1][1]
    print(f"lidar_v4 (N={base.N}, Nc={CFG.Nc}, {base.num_rays} rays) B={B} normal={normal} on "
          f"{torch.cuda.get_device_name(0)} [{card()}]: "
          + ", ".join(f"{s:.3f}" for s, _ in runs) + f" s a batch -> {B / t:.1f} solves/s (max "
          f"viol {float(res.viol.max()):.1e}, converged {float(res.converged.float().mean()):.4f})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
