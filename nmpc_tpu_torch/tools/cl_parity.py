"""Closed-loop parity on the card: the engine side of tools/gen_cl_parity.py.

Runs each unicycle row of docs/CL_PARITY.md (the rows of
tools/gen_cl_parity.py:379-409; lidar_v4, family I, is not among them)
through the port's `solve_one` at the reference's ENGINE_CFG (10x20,
tol_con 1e-4, tools/gen_cl_parity.py:82), in the loop its engine_loop runs
(tools/gen_cl_parity.py:233-251: `closed_loop`, or `closed_loop_waypoints`
through the scenario's whole tour; MPCConfig(max_steps, registry stop_tol,
advance_tol=0.075, escape) with the row's overrides: delay=1 on
six_robot_impl, escape off on eight_robot). It reads the reference engine's
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
loop_suite.DELAY_SLACK), and the arrival steps of the two in one class,
max <= 2 min + 20.

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
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from nmpc_tpu_torch.mpc.driver import MPCConfig, closed_loop, closed_loop_waypoints
from nmpc_tpu_torch.scenarios import get
from nmpc_tpu_torch.solver.alilqr import ALILQRConfig
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
)
ROWS_PATH = Path(__file__).resolve().parents[2] / "docs" / "cl_parity_state" / "rows.json"
CPU_MAX_STEPS = 600


def load_rows() -> dict:
    """The reference engine's and the oracle's outcomes per row
    (docs/cl_parity_state/rows.json: e_* and o_* keys, e_X the reference
    engine's trajectory)."""
    with open(ROWS_PATH) as f:
        return json.load(f)


def row_dmin(name: str) -> float:
    """The row's pairwise keep-out (0 without pairs: m = 1)."""
    sc = get(name)
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
        run = LS.Run(torch.device(args.device))
        out = engine_loop(name, max_steps, mpc_kw, run)
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
            out = engine_loop(name, max_steps, mpc_kw,
                              LS.Run(torch.device(args.device), dx0_seed=seed))
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
