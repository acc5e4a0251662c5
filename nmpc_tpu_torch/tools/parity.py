"""Open-loop solver parity against the f64 oracle at the published horizons.
Port of tools/gen_parity.py: its cases, configs, oracle calls and table
columns; where the reference writes docs/PARITY.md this prints the table
(and, with --json, one JSON line of every row).

For each reference configuration the same multiple-shooting NLP is solved
by (a) the port's per-scenario engine `solver/alilqr.solve` (the condensed
GN engine `solver/gn.solve` for the Nc-blocked lidar_v4), best of the
deep- and standard-grid configs (TIGHT, TIGHT_STD), on the CPU as the
reference runs it; beside it `solve_one` (the megakernel route: K1 and K2
on the card) with the same best-of where that route takes the problem; and
(b) the oracle, tests/oracle.py (numpy and scipy only, float64, exact
hand-coded sensitivities, multi-started SLSQP; scipy's trust-constr, an
interior-point method, on the obstacle rows and on every row whose raw gap
exceeds 1e-4). Two gaps: raw (against the best cold oracle start) and
polished (against the oracle seeded at the port's solution: small = the
port's solution is a KKT point of the reference NLP at f64).

Families: E/C/G (pairwise collision, `CASES`), H (static obstacles,
`OBSTACLE_CASES`, trust-constr), I (LiDAR-augmented: lidar_v2/v3 on AL-iLQR,
lidar_v4 on the condensed GN engine, with the reference's synthetic scan).

    python -m nmpc_tpu_torch.tools.parity [--rows a,b] [--families E,H,I]
        [--workers W] [--N n] [--device cpu] [--json]

Each row's CPU side (the per-scenario engine, then the oracle) runs in a
process of its own (`--workers`, spawned, one thread each); the solve_one
column runs on `--device` (the card by default: it refuses to run without
one) meanwhile. A full run is 30-60 min of oracle CPU time; --rows picks
rows by scenario name. Engine times are warm (the second call of each
config), the CPU's for the per-scenario engine (beside the other workers),
to a synchronize for solve_one.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import multiprocessing
import sys
import time
from concurrent.futures import ProcessPoolExecutor, as_completed
from pathlib import Path

import numpy as np
import torch

from nmpc_tpu_torch.scenarios import get
from nmpc_tpu_torch.solver.alilqr import ALILQRConfig, solve
from nmpc_tpu_torch.solver.alilqr_batched import route, solve_one
from nmpc_tpu_torch.tools.roofline import device_label, resolve_device
from nmpc_tpu_torch.utils.timing import sync

TESTS_DIR = Path(__file__).resolve().parents[2] / "tests"

# the deep alpha grid (to 1e-5) the stiff AL cases need, and the standard
# grid the easy long-horizon ones prefer: the engine's best of two
DEEP_ALPHAS = (1.0, 0.5, 0.25, 0.1, 0.03, 0.01, 0.003, 0.001, 3e-4, 1e-4, 3e-5, 1e-5)
TIGHT = ALILQRConfig(tol_cost=1e-9, n_inner=60, n_outer=20, tol_con=1e-5, alphas=DEEP_ALPHAS)
TIGHT_STD = dataclasses.replace(TIGHT, alphas=ALILQRConfig().alphas)
TC_GAP_TRIGGER = 1e-4

# (scenario, N override or None = published horizon, oracle multi-starts)
CASES = [
    ("single_robot", None, 1),      # N=50   (mpc_online_casadi.py:57)
    ("tb3_2", None, 1),             # N=200  (mpc_online_casadi_tb3_2.py:57)
    ("two_robot_swap", None, 2),    # N=100  (...two_centralized...py:81)
    ("two_robot_centralized", None, 1),  # N=50
    ("five_robot", None, 2),        # N=70   (...multi_centralized...py:116)
    ("six_robot_antipodal", None, 4),    # N=35 (headline, :128)
    ("six_robot_impl", None, 2),    # family G (centralized_six_robots_implementation.py:197-205)
    ("eight_robot", None, 1),       # N=5
    ("ten_robot", None, 2),         # N=20   (...ten...py:170)
]
OBSTACLE_CASES = [
    ("obstacle_scenario_1", None, 1),
    ("obstacle_scenario_2", None, 1),
    ("obstacle_scenario_3", None, 1),
]
LIDAR_CASES = ("lidar_v2", "lidar_v3", "lidar_v4")
FAMILIES = {"E": [c[0] for c in CASES], "H": [c[0] for c in OBSTACLE_CASES],
            "I": list(LIDAR_CASES)}


def _oracle():
    if str(TESTS_DIR) not in sys.path:
        sys.path.insert(0, str(TESTS_DIR))
    import oracle

    return oracle


def best_of(ocp, engine, cfgs=(TIGHT, TIGHT_STD)):
    """The best feasible result over cfgs (key: (viol > 1e-5, cost)) and
    the summed warm seconds (each config run once, then timed)."""
    best, t_warm = None, 0.0
    for cfg in cfgs:
        engine(ocp, None, cfg)
        sync(ocp.device)
        t0 = time.perf_counter()
        r = engine(ocp, None, cfg)
        sync(ocp.device)
        t_warm += time.perf_counter() - t0
        key = (float(r.viol) > 1e-5, float(r.cost))
        if best is None or key < best[0]:
            best = (key, r)
    return best[1], t_warm


def lidar_problem(name: str, device):
    """A family-I scenario with the reference's synthetic scan: two rays
    struck a surface ahead-left (0.9 and 1.1 m), the rest at the 3.5 m cap;
    the obstacle points frozen from the start pose. Returns (ocp, scan)."""
    from nmpc_tpu_torch.sim.lidar import obstacle_points, ray_angles

    sc = get(name)
    ocp = sc.make(device=device)
    R = sc.num_rays
    scan = torch.full((R,), 3.5, dtype=torch.float32, device=device)
    scan[1], scan[2] = 0.9, 1.1
    p_obs = obstacle_points(ocp.x0[:3], scan, ray_angles(R, torch.float32, device))
    return dataclasses.replace(ocp, p_obs=p_obs, x0=torch.cat([ocp.x0[:3], scan])), scan


def problem(name: str, N: int | None, device):
    """The row's problem on `device` (family I: with its synthetic scan)
    and the scan (None elsewhere)."""
    if name in LIDAR_CASES:
        return lidar_problem(name, device)
    sc = get(name)
    return (sc.make(device=device) if N is None else sc.make(device=device, N=N)), None


def cpu_row(name: str, N: int | None, starts: int) -> dict:
    """A row's engine and oracle side, in a worker process on the CPU (the
    reference runs both there): the port's per-scenario engine (the
    condensed GN engine for lidar_v4), best of the row's configs, then the
    oracle's cold multi-start solve, its solve seeded at the port's U (the
    polish), and trust-constr where the raw gap exceeds TC_GAP_TRIGGER
    (family H: trust-constr is the primary oracle)."""
    from nmpc_tpu_torch.solver import gn

    torch.set_num_threads(1)
    oracle = _oracle()
    sc = get(name)
    ocp, scan = problem(name, N, torch.device("cpu"))
    if name in LIDAR_CASES:
        cfgs = ((gn.GNConfig(Nc=sc.Nc, n_gn=40, n_outer=12, tol_con=1e-5, tol_cost=1e-9),)
                if sc.Nc else (TIGHT,))
        res, t_ours = best_of(ocp, gn.solve if sc.Nc else solve, cfgs)
        fn = oracle.solve_oracle_lidar
        kw = dict(x0_pose=ocp.x0[:3].double().numpy(), xs_pose=ocp.xref[-1, :3].double().numpy(),
                  N=ocp.N, T=float(ocp.T), p_obs=ocp.p_obs.double().numpy(),
                  d0=scan.double().numpy(), ray_lo=float(ocp.x_lo[3]),
                  inv_dist_weight=float(ocp.inv_dist_weight), Nc=sc.Nc, v_max=sc.v_max,
                  omega_max=sc.omega_max)
        cold = kw
    else:
        res, t_ours = best_of(ocp, solve)
        fn = oracle.solve_oracle
        kw = dict(x0=ocp.x0.double().numpy(), xs=ocp.xref[-1].double().numpy(), N=ocp.N,
                  T=float(ocp.T), v_max=sc.v_max, omega_max=sc.omega_max, maxiter=400)
        if name in FAMILIES["H"]:
            kw.update(obstacles=[tuple(map(float, o)) for o in ocp.obstacles.numpy()],
                      robot_radius=float(ocp.robot_radius), obs_margin=float(ocp.obs_margin),
                      method="trust-constr", time_budget=900.0)
        else:
            kw["dmin"] = float(np.sqrt(float(ocp.dmin2))) if sc.collision else 0.0
        cold = dict(kw, n_starts=starts)
    U_ours, cost_ours = res.U.double().numpy(), float(res.cost)
    t0 = time.time()
    _, _, cost_o = fn(**cold)
    t_orc = time.time() - t0
    U_p, _, cost_p = fn(U0=U_ours, **kw)
    cost_tc = cost_o if name in FAMILIES["H"] else None
    if cost_tc is None and abs(cost_ours - cost_o) / (1 + abs(cost_o)) > TC_GAP_TRIGGER:
        tc = dict(kw, method="trust-constr")
        if name not in LIDAR_CASES:
            tc["time_budget"] = 420.0     # the m=6 N=35 KKT ran > 1 h unbudgeted
        _, _, cost_tc = fn(**tc)
    return dict(name=name, m=sc.m, N=ocp.N, cost_ours=cost_ours, viol=float(res.viol),
                t_ours=t_ours, cost_oracle=float(cost_o), cost_polished=float(cost_p),
                polish=float(np.abs(U_p - U_ours).max()), t_orc=t_orc,
                cost_tc=None if cost_tc is None else float(cost_tc))


def card_column(name: str, N: int | None, device) -> dict | None:
    """solve_one (the megakernel route: K1 and K2 on the card) on the row's
    problem, best of TIGHT and TIGHT_STD, where that route takes it."""
    ocp, _ = problem(name, N, device)
    if route(ocp, TIGHT) != "mega":
        return None
    r, t = best_of(ocp, solve_one)
    return dict(cost=float(r.cost), viol=float(r.viol), t=t)


def finish(r: dict, one: dict | None) -> dict:
    c_o, c_p = r["cost_oracle"], r["cost_polished"]
    r = dict(r, one=one, raw_gap=abs(r["cost_ours"] - c_o) / (1 + abs(c_o)),
             pol_gap=abs(r["cost_ours"] - c_p) / (1 + abs(c_p)), better=r["cost_ours"] < c_o - 1e-6)
    if one is not None:
        one["raw_gap"] = abs(one["cost"] - c_o) / (1 + abs(c_o))
    return r


def run(device, rows: list[str], workers: int = 4, N: int | None = None) -> list:
    """Every row: the CPU side in `workers` spawned processes, the
    solve_one column on `device` meanwhile in this one."""
    spec = {n: (N_over, starts) for n, N_over, starts in CASES + OBSTACLE_CASES}
    spec.update({n: (None, 1) for n in LIDAR_CASES})
    horizon = {n: (N if N is not None and n not in LIDAR_CASES else spec[n][0]) for n in rows}
    ctx = multiprocessing.get_context("spawn")
    out = []
    with ProcessPoolExecutor(max_workers=max(1, workers), mp_context=ctx) as pool:
        futs = [pool.submit(cpu_row, n, horizon[n], spec[n][1]) for n in rows]
        ones = {}
        for n in rows:
            ones[n] = card_column(n, horizon[n], device)
            if ones[n] is not None:
                print(f"{n}: solve_one {ones[n]['cost']:.4f} (viol {ones[n]['viol']:.1e}, "
                      f"{ones[n]['t']:.2f} s)", flush=True)
        for fut in as_completed(futs):       # each row's line as soon as it is done
            res = fut.result()
            r = finish(res, ones[res["name"]])
            out.append(r)
            print(f"{r['name']}: ours {r['cost_ours']:.4f} oracle {r['cost_oracle']:.4f} polished "
                  f"{r['cost_polished']:.4f} raw {r['raw_gap']:.1e} pol {r['pol_gap']:.1e} tc "
                  f"{r['cost_tc']} dU {r['polish']:.2e} viol {r['viol']:.1e} ({r['t_ours']:.1f}s "
                  f"vs {r['t_orc']:.1f}s)", flush=True)
    return sorted(out, key=lambda r: rows.index(r["name"]))


def table(rows: list, device: str) -> str:
    lines = [f"# Solver parity vs the reference NLP (SLSQP + trust-constr oracles; engine on "
             f"{device})", "",
             "| scenario | m | N | cost (ours) | cost (oracle) | raw gap | cost (polished) | pol "
             "gap | cost (ipm) | ours<orc | max viol | polish dU | warm solve s (ours/oracle) | "
             "solve_one cost (raw gap) |",
             "|---|---|---|---|---|---|---|---|---|---|---|---|---|---|"]
    for r in rows:
        one = ("-" if r["one"] is None
               else f"{r['one']['cost']:.4f} ({r['one']['raw_gap']:.1e})")
        lines.append(
            f"| {r['name']} | {r['m']} | {r['N']} | {r['cost_ours']:.4f} | {r['cost_oracle']:.4f} "
            f"| {r['raw_gap']:.1e} | {r['cost_polished']:.4f} | {r['pol_gap']:.1e} | "
            f"{'-' if r['cost_tc'] is None else format(r['cost_tc'], '.4f')} | "
            f"{'yes' if r['better'] else ''} | {r['viol']:.1e} | {r['polish']:.2e} | "
            f"{r['t_ours']:.2f} / {r['t_orc']:.1f} | {one} |")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m nmpc_tpu_torch.tools.parity")
    ap.add_argument("--rows", default=None, help="scenario names (default: the families')")
    ap.add_argument("--families", default="E,H,I")
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--N", type=int, default=None, help="override the non-LiDAR horizons")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--json", action="store_true")
    a = ap.parse_args(argv)
    dev = resolve_device(a.device, "parity")
    rows = (a.rows.split(",") if a.rows
            else [n for f in a.families.split(",") for n in FAMILIES[f]])
    out = run(dev, rows, a.workers, a.N)
    print(table(out, device_label(dev)))
    if a.json:
        print(json.dumps(dict(device=device_label(dev), rows=out)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
