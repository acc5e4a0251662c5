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
    python -m nmpc_tpu_torch.tools.lidar_fleet fuzz [B] [steps]

`tour` runs the lidar_v4 closed loop at B=1 instead (`tour`): steps to
arrival, the smallest clearance, per-step latency. `fuzz` times the batched
loop of the LiDAR fuzz (`fuzz_steps`: closed_loop_lidar_batched over the
single-obstacle fields of seeds 0..B-1 at the fuzz's N=40 and GN config,
tools/loop_suite.py) at B (default 10) and at B=1 (seed 0), in turns, a
few steps each (default 10): ms a step p50/p99 of each and their ratio.

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
# one circle dead on the straight line from the start to the first goal
TOUR_OBSTACLES = ((0.5, 0.25, 0.1),)


def tour_cfg(sc) -> gn.GNConfig:
    """The tour's engine config on scenario sc: the fleet recipe (CFG,
    10x4, tol_con 1e-3; tools/gen_cl_parity.py:259) at sc's Nc."""
    return dataclasses.replace(CFG, Nc=sc.Nc)


def tour(device, max_steps: int = 300, sc=None, move=None, solve_fn=None) -> dict:
    """The lidar_v4 closed loop of CL_PARITY (tools/gen_cl_parity.py:254-272):
    mpc/lidar.closed_loop_lidar at B=1 on the TOUR_OBSTACLES world through
    the condensed GN engine at tour_cfg(sc). sc is the scenario (default
    lidar_v4 at its published N=100, Nc=50; CL_PARITY's first leg passes its
    cut), move(x0) its start (default the scenario's). solve_fn(ocp, warm)
    stands in for the engine (a caller's wrapper around gn.solve at
    tour_cfg(sc)); by default each solve is stamped on the host clock,
    after a device sync, as it starts. Returns the histories, the steps to
    the last waypoint (max_steps if it does not arrive), reached, the
    smallest realized clearance over those steps, the final pose error,
    and with the default engine each step's ms."""
    import functools

    import numpy as np

    from nmpc_tpu_torch.mpc.lidar import closed_loop_lidar
    from nmpc_tpu_torch.scenarios import get
    from nmpc_tpu_torch.tools.loop_suite import StepClock

    sc = sc or get("lidar_v4")
    cfg = tour_cfg(sc)
    ocp = sc.make(device=device)
    if move is not None:
        ocp = dataclasses.replace(ocp, x0=move(ocp.x0))
    clock = None
    if solve_fn is None:
        clock = solve_fn = StepClock(functools.partial(gn.solve, cfg=cfg), device)
    wps = sc.waypoint_array.to(device)
    X, U, clr, gidx, done = closed_loop_lidar(
        ocp, torch.tensor(TOUR_OBSTACLES, device=device), wps, cfg=cfg, max_steps=max_steps,
        solve_fn=solve_fn)
    fin = torch.nonzero(gidx >= wps.shape[0]).flatten()
    steps = int(fin[0]) if fin.numel() else max_steps
    out = dict(X=X, U=U, clearance=clr, goal_idx=gidx, reached=bool(done), steps=steps,
               min_clearance=float(clr[:steps + 1].min()),
               final_err=float(np.linalg.norm(X[steps].double().cpu().numpy()
                                              - np.array(sc.waypoints[-1], float))))
    if clock is not None:
        clock.stop()
        out["step_ms"] = [1e3 * t for t in clock.seconds()]
    return out


def fuzz_steps(device, B: int, steps: int) -> tuple:
    """`steps` steps of the batched LiDAR fuzz loop over the single-obstacle
    fields of seeds 0..B-1 (tools/loop_suite.py: N=40, LIDAR_CFG) on
    `device`: (the loop's outputs, each step's ms on the host clock, stamped
    after a device sync as each solve starts)."""
    from nmpc_tpu_torch.mpc.lidar import closed_loop_lidar_batched
    from nmpc_tpu_torch.scenarios import get
    from nmpc_tpu_torch.tools import loop_suite as LS
    from nmpc_tpu_torch.utils.timing import sync

    obstacles, goals = LS.lidar_fields(tuple(range(B)), 1)
    stamps = []

    def solve_fn(o, w):
        sync(o.device)
        stamps.append(time.perf_counter())
        return gn.solve_batched(o, w, LS.LIDAR_CFG)

    out = closed_loop_lidar_batched(get("lidar_v4").make(N=LS.LIDAR_N, device=device), obstacles,
                                    goals, LS.LIDAR_CFG, steps, solve_fn=solve_fn)
    sync(torch.device(device))
    end = time.perf_counter()
    return out, [1e3 * (b - a) for a, b in zip(stamps, stamps[1:] + [end])]


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
    if argv[:1] == ["fuzz"]:
        import numpy as np

        require_card("lidar_fleet fuzz")
        B = int(argv[1]) if len(argv) > 1 else 10
        steps = int(argv[2]) if len(argv) > 2 else 10
        dev = torch.device("cuda", 0)
        ms = {B: [], 1: []}
        for b in (B, 1, 1, B):       # in turns
            ms[b].append(fuzz_steps(dev, b, steps)[1])
        p50 = {b: float(np.percentile(np.concatenate(v), 50)) for b, v in ms.items()}
        for b, v in ms.items():
            v = np.concatenate(v)
            print(f"LiDAR fuzz loop (N=40, Nc=20, GN 6x10) B={b}: {len(v)} steps, p50 "
                  f"{np.percentile(v, 50):.1f} ms, p99 {np.percentile(v, 99):.1f} ms a step")
        print(f"B={B} against B=1, p50: {p50[B] / p50[1]:.3f}x the time for {B}x the rows on "
              f"{torch.cuda.get_device_name(0)} [{card()}]")
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
