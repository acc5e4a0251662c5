"""Closed-loop parity on the card: the engine side of tools/gen_cl_parity.py.

Runs each unicycle row of docs/CL_PARITY.md (the rows of
tools/gen_cl_parity.py:379-409) through the port's `solve_one` at the
reference's ENGINE_CFG (10x20, tol_con 1e-4, tools/gen_cl_parity.py:82), in
the loop its engine_loop runs (tools/gen_cl_parity.py:233-251:
`closed_loop`, or `closed_loop_waypoints` through the scenario's whole
tour; MPCConfig(max_steps, registry stop_tol, advance_tol=0.075, escape)
with the row's overrides: delay=1 on six_robot_impl, escape off on
eight_robot), and the family-I row lidar_v4 (500 steps) through
`lidar_fleet.tour` (`closed_loop_lidar` at the published config with the
fleet GN recipe; `lidar_engine_loop`, tools/gen_cl_parity.py:254-272; the
condensed GN engine is plain PyTorch: no hand kernel runs there, Run
engine "gn"). `lidar_oracle_loop`
is the reference's f64 oracle replica of that loop (tools/
gen_cl_parity.py:275-378: the oracle `tests/oracle.py::solve_oracle_lidar`
in the same step order, on the CPU). It reads the reference engine's
outcomes and the f64 oracle's from docs/cl_parity_state/rows.json (read
only) and prints one table: arrival, steps, min clearance and final error,
each for the port / the reference engine / the oracle, the port's
trajectory deviation from the reference engine's (informative: the
antipodal rows are symmetric and may mirror), ms a step (p50/p99) and K1/K2
launches a step, the card's name and power limit.

Each row is judged by outcome, as tests/test_cl_parity.py:31-84 judges
the reference engine (`judge`): arrival equals the oracle's (a standoff,
eight_robot's, also within 10% of the oracle's final error), min pair
distance >= dmin - 1e-2 (under delay the escape fuzz's delay bound,
loop_suite.DELAY_SLACK; for lidar_v4 the true clearance against the ray
bound 0.15), and the arrival steps of the two in one class, max <= 2 min +
20.

    python -m nmpc_tpu_torch.tools.cl_parity [names...] [--device cuda|cpu] [--json PATH]
        [--spread K]

Exit 0 when every row meets the rule, 1 if not, 2 without a card.
`--spread K` then runs each chosen row K more times from its start moved by
1e-7 x N(0, 1) (numpy seeds 0..K-1, loop_suite.Run.dx0_seed) and prints
the range of its steps and min clearance: how far rounding alone moves the
row's outcome on the port. A `--device cpu` run (every kernel's plain
version) takes only the rows of at most 600 steps.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from nmpc_tpu_torch.mpc.driver import MPCConfig, closed_loop, closed_loop_waypoints
from nmpc_tpu_torch.scenarios import get
from nmpc_tpu_torch.sim.lidar import obstacle_points, ray_angles, raycast
from nmpc_tpu_torch.solver import gn
from nmpc_tpu_torch.solver.alilqr import ALILQRConfig
from nmpc_tpu_torch.tools import lidar_fleet as LF
from nmpc_tpu_torch.tools import loop_suite as LS

ENGINE_CFG = ALILQRConfig(n_outer=10, n_inner=20, tol_con=1e-4)   # tools/gen_cl_parity.py:82
# name, max_steps, MPCConfig overrides (tools/gen_cl_parity.py:379-409)
ROWS = (
    ("single_robot", 2400, {}),
    ("two_robot_swap", 1300, {}),
    ("obstacle_scenario_1", 1400, {}),
    ("six_robot_antipodal", 220, {}),
    ("five_robot", 1600, {}),
    ("six_robot_impl", 220, {"delay": 1}),
    ("eight_robot", 600, {"escape": False}),
    ("lidar_v4", 500, {}),
)
# the family-I rows, run by lidar_engine_loop
LIDAR_ROWS = ("lidar_v4",)
ROWS_PATH = Path(__file__).resolve().parents[2] / "docs" / "cl_parity_state" / "rows.json"
CPU_MAX_STEPS = 600


def load_rows() -> dict:
    """The reference engine's and the oracle's outcomes per row
    (docs/cl_parity_state/rows.json: e_* and o_* keys, e_X the reference
    engine's trajectory)."""
    with open(ROWS_PATH) as f:
        return json.load(f)


def row_dmin(name: str) -> float:
    """The row's keep-out: the pairwise dmin (0 without pairs: m = 1), or a
    LiDAR row's ray bound d >= robot_radius (0.15 for lidar_v4)."""
    sc = get(name)
    if sc.num_rays:
        return float(sc.robot_radius)
    return float(sc.dmin) if sc.m > 1 else 0.0


def engine_loop(name: str, max_steps: int, mpc_kw: dict, run: LS.Run,
                cfg: ALILQRConfig = ENGINE_CFG) -> dict:
    """The row's loop through run's engine on run's device (tools/
    gen_cl_parity.py:233-251, with its MPCConfig), from the registry start
    moved as run.dx0_seed says. Returns steps, reached, min_dist,
    final_err, X (the realized states up to the last step run, as numpy),
    obs_clear (the smallest gap between the robot and an obstacle's
    keep-out circle r_obs + robot_radius, for scenarios with obstacles),
    and the loop's record (ms a step, launches)."""
    sc = get(name)
    ocp = sc.make(device=run.device)
    ocp = dataclasses.replace(ocp, x0=run.moved(ocp.x0))
    kw = dict(max_steps=max_steps, stop_tol=sc.stop_tol, advance_tol=0.075, escape=True)
    kw.update(mpc_kw)
    mpc = MPCConfig(**kw)
    if sc.waypoints:
        wps = sc.waypoint_array.to(run.device)
        call = lambda fn: closed_loop_waypoints(ocp, wps, cfg, mpc, solve_fn=fn)  # noqa: E731
    else:
        call = lambda fn: closed_loop(ocp, cfg, mpc, solve_fn=fn)  # noqa: E731
    r = run.drive(name, ocp.m, call, cfg)
    out = LS.summary(r)
    su = out["steps"]
    X = r.X_hist[: su + 1].detach().cpu().double().numpy()
    if ocp.n_obs:
        obs = ocp.obstacles.detach().cpu().double().numpy()
        gap = np.hypot(X[:, None, 0] - obs[None, :, 0], X[:, None, 1] - obs[None, :, 1])
        out["obs_clear"] = float((gap - obs[None, :, 2] - float(sc.robot_radius)).min())
    run.loops[-1].update(out)
    out["X"] = X
    out["record"] = run.loops[-1]
    return out


def lidar_engine_loop(sc, max_steps: int, run: LS.Run) -> dict:
    """The lidar_v4 tour (lidar_fleet.tour: the TOUR_OBSTACLES world, the
    fleet GN recipe at sc's Nc; tools/gen_cl_parity.py:254-272) on the
    scenario sc (the published lidar_v4 at N=100, Nc=50, or the first leg's
    cut), on run's device from the start moved as run.dx0_seed says. The
    condensed GN engine runs no hand kernel: the loop's record holds the
    reason, and every tensor of its result must live on run's device.
    Returns steps (to the last waypoint, else max_steps), reached,
    min_dist (the true clearance to the circle's surface over those
    steps), final_err, X (as numpy) and the loop's record."""
    res = run.drive(sc.name, 1, lambda fn: LF.tour(run.device, max_steps, sc, run.moved,
                                                    solve_fn=fn),
                    solve_fn=functools.partial(gn.solve, cfg=LF.tour_cfg(sc)))
    run.on_device(sc.name, (res["X"], res["U"], res["clearance"], res["goal_idx"]))
    steps = res["steps"]
    out = {"reached": res["reached"], "steps": steps, "min_dist": res["min_clearance"],
           "final_err": res["final_err"]}
    run.loops[-1].update(out)
    return out | {"X": res["X"][: steps + 1].detach().cpu().double().numpy(),
                  "record": run.loops[-1]}


def lidar_oracle_loop(sc, max_steps: int, maxiter: int = 150, solve_fn=None) -> dict:
    """The reference's f64 oracle replica of closed_loop_lidar
    (tools/gen_cl_parity.py:275-378) on the CPU, in the same step order:
    advance the goal (advance_tol 0.1), raycast the tour's world
    with the port's f32 `raycast` and freeze the points (the engine loop's
    sensing, bit for bit), solve, step the exact-Euler plant in f64, take
    the clearance from the next pose, shift the controls for the next
    start. The solver is tests/oracle.py::solve_oracle_lidar (f64 SLSQP,
    exact sensitivities; reached as tools/parity.py reaches the oracle),
    or solve_fn(pose, goal, scan, p_obs, U0) -> U [N, 2] (the replica's
    step-exactness pin). Returns X [S+1, 3], steps, reached, min_dist,
    final_err, wall_s."""
    import time

    R = sc.num_rays
    angles = ray_angles(R, torch.float32, "cpu")
    goals = np.array(sc.waypoints, float)
    G = goals.shape[0]
    pose = np.array(sc.x0, float)
    world = np.array(LF.TOUR_OBSTACLES)
    obstacles = torch.tensor(world, dtype=torch.float32)
    if solve_fn is None:
        from nmpc_tpu_torch.tools.parity import _oracle

        oracle = _oracle()

        def solve_fn(pose, goal, scan, p_obs, U0):
            return oracle.solve_oracle_lidar(
                pose, goal, sc.N, float(sc.T), p_obs, scan, ray_lo=float(sc.robot_radius),
                inv_dist_weight=float(sc.inv_dist_weight), Nc=sc.Nc, v_max=float(sc.v_max),
                omega_max=float(sc.omega_max), U0=U0, maxiter=maxiter)[0]
    U0, gidx, steps, reached = None, 0, 0, False
    X_hist, min_clr = [pose.copy()], np.inf
    t0 = time.perf_counter()
    for step in range(max_steps):
        goal = goals[min(gidx, G - 1)]
        if float(np.linalg.norm(pose - goal)) < 0.1:   # closed_loop_lidar's advance_tol
            gidx += 1
            if gidx >= G:
                reached, steps = True, step
                break
            goal = goals[gidx]
        pose32 = torch.tensor(pose, dtype=torch.float32)
        scan = raycast(pose32, obstacles, angles)
        p_obs = obstacle_points(pose32, scan, angles)
        U = solve_fn(pose, goal, scan.double().numpy(), p_obs.double().numpy(), U0)
        v, w = U[0]
        th = pose[2]
        pose = pose + float(sc.T) * np.array([v * np.cos(th), v * np.sin(th), w])
        X_hist.append(pose.copy())
        dc = np.sqrt(((pose[None, :2] - world[:, :2]) ** 2).sum(-1))
        min_clr = min(min_clr, float((dc - world[:, 2]).min()))
        U0 = np.concatenate([U[1:], U[-1:]], axis=0)
        steps = step + 1
    return dict(X=np.array(X_hist), steps=steps, reached=reached, min_dist=min_clr,
                final_err=float(np.linalg.norm(pose - goals[-1])),
                wall_s=time.perf_counter() - t0)


def row_engine(name: str) -> str:
    """The Run engine of a row: "gn" (the condensed GN engine, no hand
    kernel) for a family-I row, else "fused"."""
    return "gn" if name in LIDAR_ROWS else "fused"


def row_loop(name: str, max_steps: int, mpc_kw: dict, run: LS.Run) -> dict:
    """The row's engine loop: lidar_engine_loop for a family-I row, else
    engine_loop."""
    if name in LIDAR_ROWS:
        return lidar_engine_loop(get(name), max_steps, run)
    return engine_loop(name, max_steps, mpc_kw, run)


def judge(name: str, port: dict, row: dict) -> list:
    """The outcome rule of tests/test_cl_parity.py:31-84 for `port` (keys
    reached, steps, min_dist, final_err) against the oracle's outcomes in
    the rows.json row. Returns the failures (empty: the row holds)."""
    fails = []
    delay = bool(row.get("delay"))
    if bool(port["reached"]) != bool(row["o_reached"]):
        fails.append(f"{name}: arrived {port['reached']}, the oracle {row['o_reached']}")
    if not row["o_reached"]:
        # a standoff: both plateau at the same geometry
        if abs(port["final_err"] - row["o_err"]) > 0.1 * row["o_err"]:
            fails.append(f"{name}: final err {port['final_err']:.4f} not within 10% of the "
                         f"oracle's {row['o_err']:.4f}")
    dmin = row_dmin(name)
    if dmin > 0:
        floor = dmin - (LS.DELAY_SLACK if delay else 1e-2)
        if not port["min_dist"] >= floor:
            fails.append(f"{name}: min clearance {port['min_dist']:.4f} < {floor:.4f}")
    hi, lo = max(port["steps"], row["o_steps"]), min(port["steps"], row["o_steps"])
    if not hi <= 2 * lo + 20:
        fails.append(f"{name}: steps {port['steps']} against the oracle's {row['o_steps']} "
                     f"(max <= 2 min + 20)")
    return fails


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              check=True).stdout.splitlines()[0]
    except (OSError, subprocess.CalledProcessError, IndexError):
        return "nvidia-smi not available"


def _fmt(v, f="{:.4f}") -> str:
    return "-" if v is None else (f.format(v) if isinstance(v, float) and np.isfinite(v)
                                  else str(v))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m nmpc_tpu_torch.tools.cl_parity")
    p.add_argument("names", nargs="*", help=f"rows (default all): {', '.join(r[0] for r in ROWS)}")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--json", default=None, help="write the outcomes (without trajectories) here")
    p.add_argument("--spread", type=int, default=0,
                   help="rerun each row this many times from x0 moved by 1e-7 x N(0, 1)")
    args = p.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("cl_parity: no CUDA device (a --device cpu run takes the short rows only)",
              file=sys.stderr)
        return 2
    rows = load_rows()
    chosen = [r for r in ROWS if not args.names or r[0] in args.names]
    if args.device == "cpu":
        long = [r[0] for r in chosen if r[1] > CPU_MAX_STEPS]
        if long:
            raise ValueError(f"cl_parity: rows {long} take more than {CPU_MAX_STEPS} steps: run "
                             "them on the card")
    card = card_line() if args.device == "cuda" else "cpu"
    results, bad = [], 0
    print("| row | arrived (port/ref/oracle) | steps | min clearance | final err | traj dev vs "
          "ref | ms a step p50 / p99 | K1, K2 a step | holds |", flush=True)
    print("|---|---|---|---|---|---|---|---|---|", flush=True)
    for name, max_steps, mpc_kw in chosen:
        run = LS.Run(torch.device(args.device), row_engine(name))
        out = row_loop(name, max_steps, mpc_kw, run)
        ref = rows[name]
        eX = np.asarray(ref["e_X"], float)
        n, k = min(len(eX), len(out["X"])), 3 * get(name).m
        dev = float(np.abs(out["X"][:n, :k] - eX[:n, :k]).max())
        fails = judge(name, out, ref) + run.fails
        bad += bool(fails)
        rec = out["record"]
        tag = name + (" (delay=1)" if mpc_kw.get("delay") else "")
        print(f"| {tag} | {out['reached']}/{ref['e_reached']}/{ref['o_reached']} "
              f"| {out['steps']}/{ref['e_steps']}/{ref['o_steps']} "
              f"| {_fmt(out['min_dist'])}/{_fmt(ref['e_md'])}/{_fmt(ref['o_md'])}"
              + (f" (obstacle gap {out['obs_clear']:.4f})" if "obs_clear" in out else "") + " "
              f"| {_fmt(out['final_err'])}/{_fmt(ref['e_err'])}/{_fmt(ref['o_err'])} "
              f"| {dev:.3e} | {_fmt(rec['p50_ms'], '{:.2f}')} / {_fmt(rec['p99_ms'], '{:.2f}')} "
              f"| {rec['K1_per_step']:.2f}, {rec['K2_per_step']:.2f} "
              f"| {'yes' if not fails else 'NO: ' + '; '.join(fails)} |", flush=True)
        results.append({k_: v for k_, v in out.items() if k_ not in ("X", "record")}
                       | {"name": name, "traj_dev": dev, "fails": fails, "record": rec})
    for name, max_steps, mpc_kw in chosen if args.spread else ():
        runs = []
        for seed in range(args.spread):
            out = row_loop(name, max_steps, mpc_kw,
                           LS.Run(torch.device(args.device), row_engine(name), dx0_seed=seed))
            runs.append((out["steps"], out["min_dist"], out["reached"]))
        print(f"{name}, x0 moved by 1e-7 ({args.spread} draws): steps "
              f"{[r[0] for r in runs]}, min clearance {[round(r[1], 4) for r in runs]}, reached "
              f"{[r[2] for r in runs]}", flush=True)
        results.append({"name": name, "spread": runs})
    print(f"card: {card}", flush=True)
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        with open(args.json, "w") as f:
            json.dump({"card": card, "rows": results}, f, indent=1, default=str)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
