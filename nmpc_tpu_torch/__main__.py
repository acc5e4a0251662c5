"""CLI: run any registered scenario end to end on the port.

    python -m nmpc_tpu_torch list
    python -m nmpc_tpu_torch bench
    python -m nmpc_tpu_torch run six_robot_antipodal [--steps N] [--save out.npz]
        [--rt] [--mode central|decentralized|consensus]
        [--engine auto|ilqr|fused|gn] [--device cuda|cpu]

Port of nmpc_tpu/__main__.py (its `list` and `run`, branch for branch, with
the same configurations; `bench` runs nmpc_tpu_torch/bench.py, one JSON
line, on the card only). The closed loops are Python loops on the chosen
device (`--device`, default the card; `cpu` runs the plain PyTorch versions
of every kernel); the wall clock stops after a device sync. Exit codes: 0
if the run reached its goal, 1 if not, 2 on a mode the scenario does not
take.
"""

from __future__ import annotations

import argparse
import sys
import time


def cmd_list() -> int:
    from nmpc_tpu_torch.scenarios import REGISTRY

    for name, sc in sorted(REGISTRY.items(), key=lambda kv: (kv[1].family, kv[0])):
        kind = "waypoints" if sc.waypoints else "point-goal"
        print(f"{sc.family}  {name:26s} m={sc.m:<2d} N={sc.N:<4d} T={sc.T:<6g} {kind}   [{sc.source}]")
    return 0


def cmd_run(args) -> int:
    import numpy as np
    import torch

    from nmpc_tpu_torch.mpc import driver
    from nmpc_tpu_torch.scenarios import get
    from nmpc_tpu_torch.solver.alilqr import ALILQRConfig
    from nmpc_tpu_torch.utils import save_run
    from nmpc_tpu_torch.utils.timing import sync

    dev = torch.device(args.device)
    sc = get(args.scenario)
    ocp = sc.make(device=dev)
    solver_cfg = ALILQRConfig(n_outer=12, n_inner=20, tol_con=1e-4)

    if args.mode != "central":
        # robot-parallel architectures: per-robot subproblems and plan
        # exchange (decentralized: one stale-plan Jacobi round per period;
        # consensus: jointly converged rounds each period)
        if sc.m < 2 or sc.waypoints:
            print(f"--mode {args.mode} needs a multi-robot point-goal "
                  f"scenario; {args.scenario} is m={sc.m}"
                  f"{' waypoints' if sc.waypoints else ''}", file=sys.stderr)
            return 2
        from nmpc_tpu_torch.parallel import consensus, decentralized

        goals = ocp.xref[-1].reshape(sc.m, 3)
        kw = dict(N=ocp.N, T=float(ocp.T), dmin=sc.dmin, max_steps=args.steps,
                  stop_tol=sc.stop_tol, cfg=ALILQRConfig(n_outer=6, n_inner=12, tol_con=1e-4),
                  device=dev)
        t0 = time.time()
        loop = (decentralized.decentralized_closed_loop if args.mode == "decentralized"
                else consensus.consensus_closed_loop)
        X, U, mind, done = loop(ocp.x0, goals, **kw)
        sync(dev)
        wall = time.time() - t0
        print(f"scenario      {args.scenario} ({args.mode} mode, m={sc.m}, "
              f"N={ocp.N}, T={float(ocp.T):g})")
        print(f"reached       {bool(done)}")
        print(f"min pair dist {float(mind.min()):.4f} (dmin={sc.dmin})")
        print(f"wall clock    {wall:.1f} s ({args.steps} steps at most)")
        if args.save:
            np.savez(args.save, X_hist=X.cpu().numpy(), U_hist=U.cpu().numpy(),
                     min_dist_hist=mind.cpu().numpy())
            print(f"saved         {args.save}")
        return 0 if bool(done) else 1
    if sc.num_rays:
        # family I: the augmented-state model runs through the LiDAR loop
        # (the plant is the 3-state pose; the ray tail is re-seeded from a
        # fresh scan each period) against the standard ground-truth world:
        # one circle on the straight first leg, radius per version
        from nmpc_tpu_torch.mpc import lidar

        radius = {"lidar_v2": 0.15, "lidar_v3": 0.2}.get(args.scenario, 0.1)
        obstacles = torch.tensor([[0.5, 0.25, radius]], dtype=torch.float32, device=dev)
        if sc.Nc is not None:
            # v4 semantics: condensed GN with Nc move blocking
            from nmpc_tpu_torch.solver import gn

            lid_kw = dict(cfg=gn.GNConfig(Nc=sc.Nc, n_gn=10, n_outer=6, tol_con=1e-3))
        else:
            # v2/v3 semantics: full control horizon on the AL-iLQR engine,
            # with the ray-bound discretization margin (10 sparse rays
            # strike obliquely, so the planned ray distance overstates the
            # perpendicular clearance)
            from nmpc_tpu_torch.solver import alilqr

            ocp = sc.make(ray_lo=0.25 if args.scenario == "lidar_v3" else 0.3, device=dev)
            icfg = ALILQRConfig(n_outer=10, n_inner=20, tol_con=1e-3)
            lid_kw = dict(solve_fn=lambda o, w: alilqr.solve(o, w, icfg))
        t0 = time.time()
        X, U, clr, gidx, done = lidar.closed_loop_lidar(
            ocp, sim_obstacles=obstacles, waypoints=sc.waypoint_array.to(dev),
            max_steps=args.steps, **lid_kw)
        sync(dev)
        wall = time.time() - t0
        legs = int(gidx[-1])
        print(f"scenario      {args.scenario} (family I, {sc.num_rays} rays, "
              f"N={ocp.N}, T={float(ocp.T):g})")
        print(f"tour done     {bool(done)} ({legs}/{len(sc.waypoints)} legs)")
        # the ray bound the solve enforces (the ray states' lower box)
        print(f"min clearance {float(clr.min()):.4f} "
              f"(to the obstacle surface; ray bound {float(ocp.x_lo[3]):g})")
        print(f"wall clock    {wall:.1f} s ({args.steps} steps at most)")
        if args.save:
            np.savez(args.save, X_hist=X.cpu().numpy(), U_hist=U.cpu().numpy(),
                     clearance_hist=clr.cpu().numpy())
            print(f"saved         {args.save}")
        return 0 if bool(done) else 1
    solve_fn = None
    engine = args.engine
    if engine == "auto":
        if sc.Nc is not None and sc.num_rays == 0:
            engine = "gn"     # the scenario prescribes a control horizon
        else:
            from nmpc_tpu_torch.ops import megasolve

            # the megakernel at B=1 where it takes the problem at long
            # horizons, else the per-scenario engine (the reference's rule)
            engine = ("fused" if megasolve.cuda_unsupported(ocp, solver_cfg) is None
                      and ocp.N >= 64 else "ilqr")
    if engine == "gn":
        from nmpc_tpu_torch.solver import gn

        # B=1 deployment: the materialized-Jacobian normal equations
        gcfg = gn.GNConfig(Nc=sc.Nc or ocp.N, n_gn=20, n_outer=8, normal="dense")
        solve_fn = lambda o, w: gn.solve(o, w, gcfg)  # noqa: E731
    elif engine == "fused":
        # the batch-native megakernel route at B=1
        from nmpc_tpu_torch.solver import alilqr_batched

        solve_fn = lambda o, w: alilqr_batched.solve_one(o, w, solver_cfg)  # noqa: E731
    t0 = time.time()
    if sc.waypoints:
        mpc = driver.MPCConfig(max_steps=args.steps, advance_tol=sc.advance_tol, escape=True)
        r = driver.closed_loop_waypoints(ocp, waypoints=sc.waypoint_array.to(dev),
                                         solver_cfg=solver_cfg, mpc=mpc, solve_fn=solve_fn)
    elif args.rt:
        # the deployment recipe: one full-strength seed solve, then the
        # reduced-iteration rt config each period with carried mu on the
        # per-scenario engine (the rt budget defines the mode, so no engine
        # override)
        mpc = driver.MPCConfig(max_steps=args.steps, stop_tol=sc.stop_tol, escape=True)
        r = driver.rt_closed_loop(ocp, full_cfg=solver_cfg, mpc=mpc)
    else:
        mpc = driver.MPCConfig(max_steps=args.steps, stop_tol=sc.stop_tol, escape=True)
        r = driver.closed_loop(ocp, solver_cfg=solver_cfg, mpc=mpc, solve_fn=solve_fn)
    sync(dev)
    wall = time.time() - t0

    used = max(int(r.steps_used), 1)
    print(f"scenario      {args.scenario} (family {sc.family}, m={sc.m}, N={ocp.N}, T={float(ocp.T):g})")
    print(f"reached       {bool(r.reached)} in {int(r.steps_used)} steps "
          f"({int(r.steps_used) * float(ocp.T):.1f} s sim time)")
    print(f"final error   {float(r.err_hist[min(used, len(r.err_hist)) - 1]):.4f}")
    if sc.m > 1:
        print(f"min pair dist {float(r.min_dist_hist.min()):.4f} (dmin={sc.dmin})")
    print(f"mean iters    {float(r.iter_hist[:used].float().mean()):.1f} per solve")
    print(f"wall clock    {wall:.1f} s ({int(r.steps_used)} MPC steps)")
    if args.save:
        save_run(args.save, r, meta={"scenario": args.scenario})
        print(f"saved         {args.save}")
    return 0 if bool(r.reached) else 1


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="nmpc_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)
    sub.add_parser("list")
    runp = sub.add_parser("run")
    runp.add_argument("scenario")
    runp.add_argument("--steps", type=int, default=400)
    runp.add_argument("--save", default=None)
    runp.add_argument("--rt", action="store_true",
                      help="real-time mode: full-strength seed solve, then "
                           "reduced-iteration warm solves with carried mu each "
                           "period (point-goal scenarios)")
    runp.add_argument("--mode", choices=("central", "decentralized", "consensus"),
                      default="central",
                      help="multi-robot architecture: one joint NLP (central), "
                           "per-robot subproblems with one stale-plan exchange "
                           "round per period (decentralized), or robot-parallel "
                           "jointly converged rounds per period (consensus)")
    runp.add_argument("--engine", choices=("auto", "ilqr", "fused", "gn"), default="auto",
                      help="NLP engine: per-scenario AL-iLQR, the batch-native "
                           "megakernel route at B=1, or condensed Gauss-Newton "
                           "with move blocking")
    runp.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                      help="where the solves run: the card (the hand-written "
                           "kernels) or the CPU (their plain versions)")
    sub.add_parser("bench")
    args = p.parse_args(argv)
    if args.cmd == "list":
        return cmd_list()
    if args.cmd == "bench":
        from nmpc_tpu_torch import bench

        return bench.main()
    return cmd_run(args)


if __name__ == "__main__":
    sys.exit(main())
