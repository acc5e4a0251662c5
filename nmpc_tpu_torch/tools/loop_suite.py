"""The reference's closed-loop suite on the port.

One home for what tests/test_torch_loop_suite.py, chip_smoke.py and
tools/cl_parity.py share. Each entry of CASES is one `slow` closed-loop
test of the JAX package (`ref`, its file:line) with that test's scenario
and overrides, solver config, MPCConfig, driver, budget and bounds; the
engine is the port's `solve_one` (the megakernel route at B=1, K1 and K2:
K1's team design at m <= 2, its warp design at m >= 3, the obstacle
variant where the problem has obstacle rows), or for the robot-parallel
modes engine "fused" (one `solve_batched` over the robots, B = m).

`run_case(name, device)` runs a case and returns its outcome: per loop the
arrival, steps, clearance, ms a step (p50/p99, host clock after a device
sync at each solve's start) and K1/K2 launches. It raises AssertionError,
with every failed bound and the outcome, if a bound fails; on a CUDA device
it also raises if a loop did not launch K1 (the design for its m) and K2.
No bound, budget or seed differs from the reference test's.

The escape-law fuzz (tests/test_escape_fuzz.py) runs its seeds one after
another; the reference vmaps its whole loop over them, which changes no
seed's arithmetic. The noisy cases draw the plant's noise from a
torch.Generator seeded per seed (the reference draws from JAX keys), so
their noise is not the reference's: they are held to the same bounds.

    python -m nmpc_tpu_torch.tools.loop_suite [names...] [--device cuda|cpu] [--engine fused|ilqr]
        [--dx0-seed S]

prints one JSON line per case (`--summary JUNIT_XML`: the table of a
pytest run's outcomes instead). `--engine ilqr` (the per-scenario engine,
plain PyTorch; "xla" in the modes) runs on the CPU only: on the card a loop
that runs no hand kernel is refused.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import sys
import time
from typing import Callable, NamedTuple

import numpy as np
import torch

from nmpc_tpu_torch.mpc.driver import (MPCConfig, MPCResult, closed_loop, closed_loop_waypoints,
                                       rt_closed_loop, steady_warm)
from nmpc_tpu_torch.ocp.problem import make_ocp
from nmpc_tpu_torch.ops import cuda_build
from nmpc_tpu_torch.scenarios import get
from nmpc_tpu_torch.sim.plant import PlantConfig
from nmpc_tpu_torch.solver.alilqr import ALILQRConfig, solve
from nmpc_tpu_torch.solver.alilqr_batched import solve_one
from nmpc_tpu_torch.utils.timing import latency_stats, sync

# the reference tests' solver configs
FAST = ALILQRConfig(n_outer=10, n_inner=20, tol_con=1e-4)     # test_mpc.py:23
STRONG = ALILQRConfig(n_outer=15, n_inner=25, tol_con=1e-4)   # test_scenarios_closed_loop.py:19
FULL = ALILQRConfig(n_outer=6, n_inner=12, tol_con=1e-4)      # test_rt_mode.py:29, test_escape_fuzz.py:43
RT = ALILQRConfig(n_outer=2, n_inner=5, tol_con=1e-3)         # test_rt_mode.py:34
RT3 = ALILQRConfig(n_outer=3, n_inner=10, tol_con=1e-4)       # test_rt_mode.py:167
MODES = ALILQRConfig(n_outer=8, n_inner=15, tol_con=1e-4)     # test_consensus.py:24
CONSENSUS_LOOP = ALILQRConfig(n_outer=4, n_inner=10, tol_con=1e-4)   # test_consensus.py:167
# rt_closed_loop's defaults (the reference's rt tests that pass no config)
RT_FULL_DEFAULT = ALILQRConfig(n_outer=6, n_inner=12)
RT_DEFAULT = ALILQRConfig(n_outer=3, n_inner=10, tol_con=1e-3)
# test_f64_validation.py:21
F64 = ALILQRConfig(tol_cost=1e-12, n_inner=60, n_outer=30, tol_con=1e-8, mu_max=1e8)

DMIN = 0.3                                                    # test_escape_fuzz.py:44
# the fuzz's clearance slack under one period of uncompensated delay
# (test_escape_fuzz.py:114-126): two robots close at ~2 v_max T while the
# stale control is in flight, with 25% headroom
DELAY_SLACK = 3e-2 + 1.25 * (2 * 0.22 * 0.2)
# the fuzz tests' seeds, m -> seeds (tests/test_escape_fuzz.py:139-172,
# tests/test_parallel.py:173-176)
FUZZ_SEEDS = {
    "deterministic": {2: (0, 1, 2, 3), 3: (40, 41, 42), 4: (10, 11, 12), 5: (50, 51, 52),
                      6: (20, 21, 22)},
    "delay": {2: (0, 1, 2, 3), 4: (10, 11, 12), 6: (20, 21, 22)},
    "noisy": {4: (30, 31, 32)},
    "decentralized": {2: (0, 1, 2), 4: (10, 11, 12), 6: (20, 21, 22)},
}


def random_geometry(m: int, seed: int):
    """Jittered circle start, near-antipodal goals, random headings (a copy
    of tests/test_escape_fuzz.py:49-73 on numpy: the same float32 arrays).

    Starts: equally spaced angles +- 25% of the half-spacing, radius in
    [0.9, 1.3]. Goals: the antipodal point +- 8 cm. Headings uniform in
    [-pi, pi]. Returns (x0 [3m], x_goal [3m])."""
    rng = np.random.default_rng(seed)
    spacing = 2 * np.pi / m
    ang = np.arange(m) * spacing + rng.uniform(-0.25, 0.25, m) * spacing
    r = rng.uniform(0.9, 1.3)
    px, py = r * np.cos(ang), r * np.sin(ang)
    th = rng.uniform(-np.pi, np.pi, m)
    gx = -px + rng.uniform(-0.08, 0.08, m)
    gy = -py + rng.uniform(-0.08, 0.08, m)
    gth = rng.uniform(-np.pi, np.pi, m)
    x0 = np.stack([px, py, th], axis=1).reshape(-1)
    xg = np.stack([gx, gy, gth], axis=1).reshape(-1)
    return x0.astype(np.float32), xg.astype(np.float32)


def fuzz_ocp(m: int, seed: int, device):
    """The fuzz's problem (tests/test_escape_fuzz.py:73-75): N=12, T=0.2,
    pairwise keep-out DMIN."""
    x0, xg = random_geometry(m, seed)
    return make_ocp(m=m, N=12, T=0.2, x0=x0, x_goal=xg, dmin=DMIN, collision=True,
                    device=device)


def invariants(X, min_dist, reached: bool, m: int, slack: float, th_bound: float, tag,
               err: float | None = None) -> tuple[dict, list]:
    """The three loop invariants on one loop's realized history (X [S+1,
    3m], min_dist [S+1]): arrival, min pair distance >= DMIN - slack, every
    |theta| < th_bound. Returns (outcome, failures)."""
    X = torch.as_tensor(X).detach().cpu()
    md = float(torch.as_tensor(min_dist).detach().cpu().min())
    th = float(X.reshape(X.shape[0], m, 3)[:, :, 2].abs().max())
    out = {"reached": bool(reached), "min_dist": md, "max_theta": th}
    fails = []
    if not out["reached"]:
        fails.append(f"{tag}: no arrival" + ("" if err is None else f" (err {err:.3f})"))
    if not md >= DMIN - slack:
        fails.append(f"{tag}: clearance violated ({md:.3f} < {DMIN - slack:.3f})")
    if not th < th_bound:
        fails.append(f"{tag}: theta wound to {th:.2f}")
    return out, fails


def check_invariants(r: MPCResult, m: int, tag=None, noisy: bool = False,
                     delay: bool = False) -> dict:
    """tests/test_escape_fuzz.py:96-137 on one loop's history: arrival, the
    realized min pair distance >= DMIN - slack (3e-2, 4e-2 noisy, plus
    1.25 (2 v_max T) under delay) and |theta| < 2 pi + 0.5 (2.0 noisy).
    Returns the outcome; raises AssertionError naming each failed
    invariant."""
    su = int(r.steps_used)
    slack = (4e-2 if noisy else 3e-2) + (DELAY_SLACK - 3e-2 if delay else 0.0)
    th_bound = 2 * np.pi + (2.0 if noisy else 0.5)
    out, fails = invariants(r.X_hist[: su + 1], r.min_dist_hist[: su + 1], bool(r.reached), m,
                            slack, th_bound, tag, float(r.err_hist[su - 1]))
    out["steps"] = su
    if fails:
        raise AssertionError("; ".join(fails) + f" | {out}")
    return out


class StepClock:
    """A solve_fn(ocp, warm) that stamps the host clock, after a device
    sync, as each solve starts: a loop step runs from one stamp to the next
    (the last to `stop()`)."""

    def __init__(self, fn, device):
        self.fn, self.device, self.stamps, self.end = fn, torch.device(device), [], None

    def __call__(self, o, w):
        sync(self.device)
        self.stamps.append(time.perf_counter())
        return self.fn(o, w)

    def stop(self) -> None:
        sync(self.device)
        self.end = time.perf_counter()

    def seconds(self) -> list:
        return [b - a for a, b in zip(self.stamps, self.stamps[1:] + [self.end])]


def k1_design(m: int) -> str:
    """The design of K1 the solver's route launches at m robots."""
    return "team" if m in cuda_build.TEAM_ROBOTS else "warp"


def launches(device, m: int, tag, steps: int) -> tuple[dict, list]:
    """K1 and K2 launches since the last reset (per step too), and on a CUDA
    device the failures: K1 not launched, launched in another design than
    m's, or K2 not launched."""
    c, d = cuda_build.launch_counts, cuda_build.k1_designs
    k1, k2 = c["inner_solve_fused"], c["al_update_lanes"]
    out = {"K1": k1, "K2": k2, "K1_team": d["team"], "K1_warp": d["warp"],
           "K1_per_step": k1 / max(steps, 1), "K2_per_step": k2 / max(steps, 1)}
    fails = []
    if torch.device(device).type == "cuda":
        want = k1_design(m)
        if not (k1 > 0 and d[want] == k1):
            fails.append(f"{tag}: K1's {want} design did not run the loop ({out})")
        if not k2 > 0:
            fails.append(f"{tag}: K2 did not launch ({out})")
    return out, fails


@dataclasses.dataclass
class Run:
    """One case's run: the device, the engine ("fused": solve_one; "ilqr":
    the per-scenario solve, CPU only), each loop's record, the failures."""

    device: torch.device
    engine: str = "fused"
    loops: list = dataclasses.field(default_factory=list)
    fails: list = dataclasses.field(default_factory=list)
    # with a seed, every loop starts from x0 moved by 1e-7 x N(0, 1)
    # (numpy seed dx0_seed; the tools' --spread)
    dx0_seed: int | None = None

    def moved(self, x0):
        """x0 (a tensor or a numpy array), moved as dx0_seed says."""
        if self.dx0_seed is None:
            return x0
        dx = 1e-7 * np.random.default_rng(self.dx0_seed).standard_normal(tuple(x0.shape))
        dx = dx.astype(np.float32)
        return x0 + torch.as_tensor(dx, device=x0.device) if torch.is_tensor(x0) else x0 + dx

    def solver(self, cfg: ALILQRConfig):
        if self.engine == "fused":
            return lambda o, w: solve_one(o, w, cfg)
        return lambda o, w: solve(o, w, cfg)

    @property
    def modes_engine(self) -> str:
        return "fused" if self.engine == "fused" else "xla"

    def require(self, ok: bool, msg: str) -> None:
        if not ok:
            self.fails.append(msg)

    def drive(self, tag, m: int, call, cfg: ALILQRConfig | None = None):
        """Run one loop, call(solve_fn), with the launch counts set to 0
        just before and read just after; with cfg, solve_fn is the engine
        at cfg with a StepClock around it (else call(None)). Returns
        call's result; records the loop."""
        clock = StepClock(self.solver(cfg), self.device) if cfg is not None else None
        if self.device.type == "cuda" and self.engine == "fused":
            cuda_build.load(m)            # built before the clock starts, not in a step
        sync(self.device)
        cuda_build.reset_launch_counts()
        t0 = time.perf_counter()
        out = call(clock)
        sync(self.device)
        record = {"tag": tag, "wall_s": time.perf_counter() - t0}
        if clock is not None:
            clock.stop()
            record.update(solves=len(clock.stamps), **latency_stats(clock.seconds()))
        steps = record.get("solves", 1)
        counts, fails = launches(self.device, m, tag, steps)
        record.update(counts)
        self.fails.extend(fails)
        self.loops.append(record)
        return out


def summary(r: MPCResult) -> dict:
    """Arrival, steps used, min pair distance and final error of a loop
    (final error as tools/gen_cl_parity.py:233-251 reads it)."""
    su = int(r.steps_used)
    S = r.err_hist.shape[0]
    return {"reached": bool(r.reached), "steps": su,
            "min_dist": float(r.min_dist_hist[: su + 1].min()),
            "final_err": float(r.err_hist[min(su, S - 1)])}


def _dmin(ocp) -> float:
    return float(torch.sqrt(ocp.dmin2))


def _point(run: Run, tag, ocp, cfg, mpc: MPCConfig, driver="closed_loop", full_cfg=None,
           plant=PlantConfig(), seed: int | None = None) -> tuple[MPCResult, dict]:
    """One point-goal loop (closed_loop, or rt_closed_loop seeded with
    full_cfg's per-scenario solve) through the engine at cfg; a noisy plant
    draws from a generator seeded with `seed`."""
    gen = None if seed is None else torch.Generator(device=run.device).manual_seed(seed)
    ocp = dataclasses.replace(ocp, x0=run.moved(ocp.x0))
    if driver == "rt":
        call = lambda fn: rt_closed_loop(ocp, full_cfg, cfg, mpc, plant, generator=gen,  # noqa: E731
                                         solve_fn=fn)
    else:
        call = lambda fn: closed_loop(ocp, cfg, mpc, plant, generator=gen, solve_fn=fn)  # noqa: E731
    r = run.drive(tag, ocp.m, call, cfg)
    s = summary(r)
    run.loops[-1].update(s)
    return r, s


def _registry(run: Run, name, cfg, max_steps, driver="closed_loop", full_cfg=None, escape=True,
              **overrides):
    sc = get(name)
    ocp = sc.make(device=run.device, **overrides)
    mpc = MPCConfig(max_steps=max_steps, stop_tol=sc.stop_tol, escape=escape)
    r, s = _point(run, name, ocp, cfg, mpc, driver, full_cfg)
    return sc, ocp, r, s


# ---------------------------------------------------------------------------
# the cases, one function each: run(Run) records loops and failures
# ---------------------------------------------------------------------------


def _reached_and_clear(run: Run, s: dict, dmin: float, slack: float, tag) -> None:
    run.require(s["reached"], f"{tag}: not reached ({s})")
    run.require(s["min_dist"] >= dmin - slack, f"{tag}: clearance {s['min_dist']:.4f} < "
                                                f"{dmin - slack:.4f}")


def single_robot_reference_config(run: Run):
    """single_robot at its registry config (N=50, T=0.01), FAST, 2500 steps,
    stop_tol 5e-2, escape (K1's team design, m=1): reached."""
    sc = get("single_robot")
    ocp = sc.make(device=run.device)
    _, s = _point(run, "single_robot", ocp, FAST,
                  MPCConfig(max_steps=2500, stop_tol=5e-2, escape=True))
    run.require(s["reached"], f"single_robot: not reached ({s})")


def six_robot_antipodal_headline(run: Run):
    """six_robot_antipodal at the registry N=35, STRONG, 120 steps, stop_tol
    0.1, escape (warp design): clearance >= 0.3 - 1.5e-2, reached, every
    robot travels > 1.5."""
    ocp = get("six_robot_antipodal").make(device=run.device)
    r, s = _point(run, "six_robot_antipodal", ocp, STRONG,
                  MPCConfig(max_steps=120, stop_tol=1e-1, escape=True))
    X = r.X_hist.cpu()
    d = X[-1].reshape(6, 3)[:, :2] - X[0].reshape(6, 3)[:, :2]
    travel = float(torch.hypot(d[:, 0], d[:, 1]).min())
    run.loops[-1]["travel_min"] = travel
    _reached_and_clear(run, s, 0.3, 1.5e-2, "headline")
    run.require(travel > 1.5, f"headline: a robot travelled {travel:.3f} (<= 1.5)")


def closed_loop_fused_engine(run: Run):
    """two_robot_swap at N=25, T=0.1, FAST, 250 steps, stop_tol 0.1, escape
    (team design, m=2): reached, clearance >= dmin - 5e-3."""
    sc = get("two_robot_swap")
    ocp = sc.make(N=25, T=0.1, device=run.device)
    _, s = _point(run, "two_robot_swap N=25", ocp, FAST,
                  MPCConfig(max_steps=250, stop_tol=1e-1, escape=True))
    _reached_and_clear(run, s, sc.dmin, 5e-3, "two_robot_swap")


def _scenario_case(name, max_steps, cfg):
    """A registry scenario through closed_loop at cfg, max_steps, registry
    stop_tol, escape: reached, clearance >= dmin - 1e-2."""
    def case(run: Run):
        sc, ocp, r, s = _registry(run, name, cfg, max_steps)
        _reached_and_clear(run, s, sc.dmin, 1e-2, name)
    return case


def six_robot_hardware_config(run: Run):
    """six_robot_impl through rt_closed_loop's defaults (seed 6x12, then
    3x10 tol_con 1e-3), 120 steps, registry stop_tol, escape (warp
    design): reached, clearance >= dmin - 1.5e-2."""
    sc, ocp, r, s = _registry(run, "six_robot_impl", RT_DEFAULT, 120, driver="rt",
                              full_cfg=RT_FULL_DEFAULT)
    _reached_and_clear(run, s, sc.dmin, 1.5e-2, "six_robot_impl rt")


def ten_robot_line_crossing(run: Run):
    """ten_robot, STRONG, 250 steps (warp design, m=10): clearance >= dmin -
    1e-2, final err < 0.25 x initial."""
    sc, ocp, r, s = _registry(run, "ten_robot", STRONG, 250)
    e0, e1 = float(r.err_hist[0]), float(r.err_hist[-1])
    run.require(s["min_dist"] >= sc.dmin - 1e-2, f"ten_robot: clearance {s['min_dist']:.4f}")
    run.require(e1 < 0.25 * e0, f"ten_robot: final err {e1:.4f} >= 0.25 x {e0:.4f}")


def eight_robot_published_config(run: Run):
    """eight_robot at the published N=5, T=0.02, STRONG, 500 steps, escape
    off (warp design, m=8): a standoff, clearance >= dmin - 1e-2, final err
    < 0.7 x initial."""
    sc, ocp, r, s = _registry(run, "eight_robot", STRONG, 500, escape=False)
    e0, e1 = float(r.err_hist[0]), float(r.err_hist[-1])
    run.require(s["min_dist"] >= sc.dmin - 1e-2, f"eight_robot: clearance {s['min_dist']:.4f}")
    run.require(e1 < 0.7 * e0, f"eight_robot: final err {e1:.4f} >= 0.7 x {e0:.4f}")


def eight_robot_full_swap(run: Run):
    """eight_robot at N=25, T=0.1 through rt_closed_loop's defaults, 250
    steps, escape: reached, clearance >= dmin - 1e-2."""
    sc, ocp, r, s = _registry(run, "eight_robot", RT_DEFAULT, 250, driver="rt",
                              full_cfg=RT_FULL_DEFAULT, N=25, T=0.1)
    _reached_and_clear(run, s, sc.dmin, 1e-2, "eight_robot N=25 rt")


# the passive LiDAR monitor's map: obstacles parked off the tour's path
# (test_scenarios_closed_loop.py:139-145), 12 rays
MONITOR_OBSTACLES = ((1.8, -1.5, 0.3), (-1.6, 1.4, 0.25))


def decentralized_first_scenario_tour(run: Run):
    """decentralized_first_scenario's waypoint tour (N=200, T=0.05), FAST,
    1400 steps, advance_tol 0.075, escape (team design, m=1), with a
    passive LiDAR monitor (12 rays, two circles off the path): every
    waypoint in order, monitored ray clearance > robot radius."""
    from nmpc_tpu_torch.sim.lidar import ray_angles, raycast

    sc = get("decentralized_first_scenario")
    ocp = sc.make(device=run.device)
    ocp = dataclasses.replace(ocp, x0=run.moved(ocp.x0))
    wps = sc.waypoint_array.to(run.device)
    mpc = MPCConfig(max_steps=1400, advance_tol=0.075, escape=True)
    r = run.drive("decentralized_first_scenario tour", 1,
                  lambda fn: closed_loop_waypoints(ocp, wps, FAST, mpc, solve_fn=fn), FAST)
    steps = int(r.steps_used)
    obstacles = torch.tensor(MONITOR_OBSTACLES, dtype=torch.float32, device=run.device)
    scans = raycast(r.X_hist[: steps + 1, :3], obstacles, ray_angles(12, device=run.device))
    clear = float(scans.min())
    gmax = int(r.goal_idx_hist.max())
    run.loops[-1].update(reached=bool(r.reached), steps=steps, goal_idx_max=gmax,
                         monitor_clearance=clear)
    run.require(bool(r.reached), f"tour: did not complete in {steps} steps")
    run.require(gmax >= wps.shape[0] - 1, f"tour: waypoint index reached {gmax}")
    run.require(clear > sc.robot_radius, f"tour: monitored clearance {clear:.4f}")


def steady_warm_bounded_six_robot(run: Run):
    """six_robot_antipodal: a full 6x12 solve, then 12 steady-warm solves
    at 2x5 tol_con 1e-3 from x0 + 0.01 N(0, 1) (warp design): worst viol
    < 3 x max(full viol, 0.2)."""
    ocp = get("six_robot_antipodal").make(device=run.device)

    def call(fn):
        res = run.solver(FULL)(ocp, None)
        full_viol = float(res.viol)
        warm = steady_warm(res)
        gen = torch.Generator(device=run.device).manual_seed(0)
        worst = 0.0
        for _ in range(12):
            x0 = ocp.x0 + 0.01 * torch.randn(ocp.x0.shape, generator=gen, device=run.device,
                                             dtype=ocp.x0.dtype)
            res = fn(dataclasses.replace(ocp, x0=x0), warm)
            warm = steady_warm(res)
            worst = max(worst, float(res.viol))
        return worst, full_viol

    worst, full_viol = run.drive("steady_warm six_robot_antipodal", 6, call, RT)
    run.loops[-1].update(worst_viol=worst, full_viol=full_viol)
    run.require(worst < 3.0 * max(full_viol, 0.2), f"steady warm: worst viol {worst:.4f}, full "
                                                   f"{full_viol:.4f}")


def rt_closed_loop_two_robot_swap(run: Run):
    """two_robot_swap (registry N=100, T=0.02) through rt_closed_loop (seed
    6x12 tol_con 1e-4, then 3x10 tol_con 1e-3), 1600 steps (team design,
    m=2): reached, clearance >= dmin - 1e-2, planned viol < 1e-2."""
    sc, ocp, r, s = _registry(run, "two_robot_swap", RT_DEFAULT, 1600, driver="rt",
                              full_cfg=FULL)
    _reached_and_clear(run, s, _dmin(ocp), 1e-2, "rt two_robot_swap")
    vmax = float(r.viol_hist[: s["steps"]].max())
    run.loops[-1]["max_viol"] = vmax
    run.require(vmax < 1e-2, f"rt two_robot_swap: planned viol {vmax:.3e}")


def rt_closed_loop_six_robot(run: Run):
    """six_robot_antipodal through rt_closed_loop (seed 6x12 tol_con 1e-4,
    then 3x10 tol_con 1e-3), 120 steps (warp design): reached, clearance >=
    dmin - 1e-2, mean inner iterations < 25."""
    sc, ocp, r, s = _registry(run, "six_robot_antipodal", RT_DEFAULT, 120, driver="rt",
                              full_cfg=FULL)
    _reached_and_clear(run, s, _dmin(ocp), 1e-2, "rt six_robot_antipodal")
    it = float(r.iter_hist[: s["steps"]].float().mean())
    run.loops[-1]["mean_iters"] = it
    run.require(it < 25.0, f"rt six_robot_antipodal: mean inner iterations {it:.2f}")


def _noise_plant(m: int, device, v_max: float = 0.22, omega_max: float = 2.84) -> PlantConfig:
    """The Gazebo-plausible noise model of tests/test_rt_mode.py:166-174:
    ~5 mm / 0.01 rad process noise a 0.2 s step, 2 mm / 5 mrad odometry
    noise, actuator box saturation."""
    def tile(v):
        return torch.tensor(v, dtype=torch.float32, device=device).repeat(m)
    return PlantConfig(u_sat=tile([v_max, omega_max]), process_noise=tile([5e-3, 5e-3, 1e-2]),
                       odom_noise=tile([2e-3, 2e-3, 5e-3]))


def rt_closed_loop_six_robot_noise_and_delay(run: Run):
    """six_robot_antipodal through rt_closed_loop (seed 6x12, then 3x10
    tol_con 1e-4), 300 steps, noise seeds 0-2 (a torch.Generator each),
    solved with dmin + 3 cm and without: tightened reached, clearance >=
    dmin - 1e-2; untightened reached, >= dmin - 4e-2; then delay=1
    compensated without noise: reached, >= dmin - 3e-2."""
    sc = get("six_robot_antipodal")
    ocp = sc.make(device=run.device)
    dmin = _dmin(ocp)
    plant = _noise_plant(ocp.m, run.device, sc.v_max, sc.omega_max)
    mpc = MPCConfig(max_steps=300, stop_tol=sc.stop_tol, escape=True)
    # the controller solves with dmin + 3 cm; safety is judged on the true dmin
    ocp_tight = dataclasses.replace(ocp, dmin2=torch.tensor((dmin + 0.03) ** 2,
                                                            dtype=ocp.dmin2.dtype,
                                                            device=run.device))
    for seed in (0, 1, 2):
        _, s = _point(run, f"tightened, noise seed {seed}", ocp_tight, RT3, mpc, "rt", FULL,
                      plant, seed)
        _reached_and_clear(run, s, dmin, 1e-2, f"tightened seed {seed}")
        _, s2 = _point(run, f"untightened, noise seed {seed}", ocp, RT3, mpc, "rt", FULL,
                       plant, seed)
        _reached_and_clear(run, s2, dmin, 4e-2, f"untightened seed {seed}")
    mpc_d = dataclasses.replace(mpc, delay=1, delay_compensate=True)
    _, s = _point(run, "delay=1 compensated", ocp, RT3, mpc_d, "rt", FULL)
    _reached_and_clear(run, s, dmin, 3e-2, "delay compensated")


def delay_closed_loop_six_robot_hw_config(run: Run):
    """six_robot_impl at 6x12 tol_con 1e-4, 150 steps, registry stop_tol,
    escape (warp design): delay=1 reached, clearance >= 0.21; undelayed;
    delay=1 compensated reached, clearance >= the undelayed's - 1e-2 and >
    delay=1's."""
    sc = get("six_robot_impl")
    ocp = sc.make(device=run.device)
    base = dict(max_steps=150, stop_tol=sc.stop_tol, escape=True)
    _, raw = _point(run, "six_robot_impl delay=1", ocp, FULL, MPCConfig(delay=1, **base))
    run.require(raw["reached"], f"delay=1: not reached ({raw})")
    run.require(raw["min_dist"] >= 0.21, f"delay=1: {raw['min_dist']:.4f} < 0.21")
    _, und = _point(run, "six_robot_impl undelayed", ocp, FULL, MPCConfig(**base))
    _, cmp_ = _point(run, "six_robot_impl delay=1 compensated", ocp, FULL,
                     MPCConfig(delay=1, delay_compensate=True, **base))
    run.require(cmp_["reached"], f"compensated: not reached ({cmp_})")
    run.require(cmp_["min_dist"] >= und["min_dist"] - 1e-2,
                f"compensated {cmp_['min_dist']:.4f} < undelayed {und['min_dist']:.4f} - 1e-2")
    run.require(cmp_["min_dist"] > raw["min_dist"],
                f"compensated {cmp_['min_dist']:.4f} <= uncompensated {raw['min_dist']:.4f}")


def _fuzz_case(m: int, seeds, max_steps: int, delay: bool = False, noisy: bool = False):
    """The escape-law fuzz at m (random_geometry per seed) through
    closed_loop at 6x12 tol_con 1e-4, stop_tol 0.1, escape, optionally
    delay=1 or the noisy plant: check_invariants per seed."""
    def case(run: Run):
        mpc = MPCConfig(max_steps=max_steps, stop_tol=1e-1, escape=True, delay=int(delay))
        for seed in seeds:
            ocp = fuzz_ocp(m, seed, run.device)
            plant = (_noise_plant(m, run.device) if noisy else PlantConfig())
            r, _ = _point(run, (m, seed), ocp, FULL, mpc, plant=plant,
                          seed=seed if noisy else None)
            try:
                run.loops[-1].update(check_invariants(r, m, (m, seed), noisy, delay))
            except AssertionError as e:
                run.fails.append(str(e))
    return case


def _reached_step(X, goal, stop_tol: float) -> int:
    """The modes' loops stop at the first step that starts done: its index
    (the steps run), or the budget."""
    err = torch.linalg.norm(X - goal, dim=-1) <= stop_tol
    hit = torch.nonzero(err).flatten()
    return int(hit[0]) if hit.numel() else X.shape[0] - 1


def _decentralized(run: Run, tag, x0, goals, N, T, dmin, max_steps, cfg, slack, th_bound):
    from nmpc_tpu_torch.parallel.decentralized import decentralized_closed_loop

    m = goals.shape[0]
    x0 = run.moved(x0)
    X, U, mind, done = run.drive(tag, 1, lambda _: decentralized_closed_loop(
        x0, goals, N=N, T=T, dmin=dmin, max_steps=max_steps, cfg=cfg, engine=run.modes_engine,
        device=run.device))
    steps = _reached_step(X, torch.as_tensor(goals, device=X.device).reshape(-1), 1e-1)
    out, fails = invariants(X, mind, bool(done), m, slack, th_bound, tag)
    rec = run.loops[-1]
    rec.update(out, steps=steps, mean_ms=1e3 * rec["wall_s"] / max(steps, 1),
               K1_per_step=rec["K1"] / max(steps, 1), K2_per_step=rec["K2"] / max(steps, 1))
    run.fails.extend(fails)


def _antipodal_circle(m: int):
    ang = np.arange(m) * 2 * np.pi / m
    x0 = np.stack([np.cos(ang), np.sin(ang), ang + np.pi], -1).reshape(-1)
    goals = np.stack([-np.cos(ang), -np.sin(ang), ang + np.pi], -1)
    return x0.astype(np.float32), goals.astype(np.float32)


def decentralized_six_robot_antipodal(run: Run):
    """The antipodal circle m=6, N=30, T=0.1, dmin 0.3, default config, 500
    steps, engine "fused" (K1's team design with moving-obstacle rows,
    B=6): reached, clearance >= 0.3 - 1e-2."""
    x0, goals = _antipodal_circle(6)
    # test_parallel.py:102-122: arrival and the collision-free floor
    _decentralized(run, "decentralized six", x0, goals, 30, 0.1, 0.3, 500,
                   ALILQRConfig(), 1e-2, math.inf)


def decentralized_four_robot_cross(run: Run):
    """Four robots crossing at the origin, N=30, T=0.1, dmin 0.3, default
    config, 250 steps, engine "fused" (B=4): reached, clearance >= 0.3 -
    1e-2."""
    x0 = np.array([-0.8, 0, 0, 0.8, 0, np.pi, 0, -0.8, np.pi / 2, 0, 0.8, -np.pi / 2], np.float32)
    goals = np.array([[0.8, 0, 0], [-0.8, 0, np.pi], [0, 0.8, np.pi / 2],
                      [0, -0.8, -np.pi / 2]], np.float32)
    # test_parallel.py:60-69: arrival and the collision-free floor
    _decentralized(run, "decentralized four-robot cross", x0, goals, 30, 0.1, 0.3, 250,
                   ALILQRConfig(), 1e-2, math.inf)


def _decentralized_fuzz_case(m: int, seeds):
    """The fuzz geometry at m through decentralized_closed_loop (N=12,
    T=0.2, dmin 0.3, 6x12 tol_con 1e-4, 600 steps, engine "fused", B=m):
    reached, clearance >= 0.3 - 3e-2, |theta| < 2 pi + 0.7."""
    def case(run: Run):
        for seed in seeds:
            x0, xg = random_geometry(m, seed)
            _decentralized(run, (m, seed), x0, xg.reshape(m, 3), 12, 0.2, DMIN, 600, FULL,
                           3e-2, 2 * np.pi + 0.7)
    return case


def _stack_joint(X, U):
    """[m, N+1, 3], [m, N, 2] -> joint [N+1, 3m], [N, 2m]."""
    return (torch.swapaxes(X, 0, 1).reshape(X.shape[1], -1),
            torch.swapaxes(U, 0, 1).reshape(U.shape[1], -1))


def _joint_quad_cost(Xj, Uj, goal_j, Qd, Rd) -> float:
    """tests/test_consensus.py:27-32: sum_k (x_k-g)'Q(x_k-g) + u_k'Ru_k over
    stages 0..N-1, one formula for both solvers."""
    e = Xj[:-1] - goal_j[None]
    return float(torch.sum(e * e * Qd[None]) + torch.sum(Uj * Uj * Rd[None]))


def consensus_six_robot_joint_quality(run: Run):
    """six_robot_antipodal at N=20: the centralized solve (solve_one, warp
    design) against consensus_solve (8x15 tol_con 1e-4, 10 rounds, engine
    "fused"; the reference's "xla" is the per-scenario engine):
    centralized viol < 1e-3, consensus viol and joint pair violation <
    1e-3, joint cost <= 1.3 x centralized."""
    from nmpc_tpu_torch.parallel.consensus import (consensus_solve, joint_pair_violation,
                                                   robot_template)

    central = get("six_robot_antipodal").make(N=20, device=run.device)
    m, N = 6, 20
    goal_j = central.xref[-1]
    goals = goal_j.reshape(m, 3)
    res_c = run.drive("centralized six N=20", 6, lambda fn: fn(central, None), MODES)
    run.require(float(res_c.viol) < 1e-3, f"centralized viol {float(res_c.viol):.3e}")
    tpl = robot_template(N, float(central.T), _dmin(central), m=m, device=run.device)
    X, U, _, _, violh, _ = run.drive("consensus six N=20, 10 rounds", 1, lambda _: consensus_solve(
        tpl, central.x0, goals, cfg=MODES, rounds=10, damping=0.5, engine=run.modes_engine))
    pair = float(joint_pair_violation(X[:, :, :2], central.dmin2, N))
    Xj, Uj = _stack_joint(X, U)
    c_cons = _joint_quad_cost(Xj, Uj, goal_j, central.Qdiag, central.Rdiag)
    c_cent = _joint_quad_cost(res_c.X, res_c.U, goal_j, central.Qdiag, central.Rdiag)
    run.loops[-1].update(viol=float(violh[-1]), pair_viol=pair, cost=c_cons, central_cost=c_cent)
    run.require(float(violh[-1]) < 1e-3, f"consensus viol {float(violh[-1]):.3e}")
    run.require(pair < 1e-3, f"joint pair violation {pair:.3e}")
    run.require(c_cons <= 1.3 * c_cent + 1e-6, f"consensus cost {c_cons:.4f} > 1.3 x "
                                               f"{c_cent:.4f}")


def _consensus_loop(name, max_steps, **make):
    """consensus_closed_loop on a registry scenario (N=20, 3 rounds, 4x10
    tol_con 1e-4, engine "fused"; the reference's "xla" is the per-scenario
    engine): reached, clearance >= dmin - 1.5e-2."""
    def case(run: Run):
        from nmpc_tpu_torch.parallel.consensus import consensus_closed_loop

        sc = get(name)
        central = sc.make(device=run.device, **make)
        goals = central.xref[-1].reshape(sc.m, 3)
        dmin = _dmin(central)
        X, U, mind, done = run.drive(name, 1, lambda _: consensus_closed_loop(
            run.moved(central.x0), goals, N=20, T=float(central.T), dmin=dmin, rounds=3,
            max_steps=max_steps, engine=run.modes_engine, cfg=CONSENSUS_LOOP,
            device=run.device))
        steps = _reached_step(X, goals.reshape(-1), sc.stop_tol)
        md = float(mind.min())
        rec = run.loops[-1]
        rec.update(reached=bool(done), min_dist=md, steps=steps,
                   mean_ms=1e3 * rec["wall_s"] / max(steps, 1),
                   K1_per_step=rec["K1"] / max(steps, 1), K2_per_step=rec["K2"] / max(steps, 1))
        run.require(bool(done), f"{name}: not reached")
        run.require(md >= dmin - 1.5e-2, f"{name}: clearance {md:.4f} < {dmin - 1.5e-2:.4f}")
    return case


def _cl_parity_case(name, max_steps, escape):
    """A CL_PARITY row through cl_parity.engine_loop (10x20 tol_con 1e-4,
    advance_tol 0.075), judged by cl_parity.judge against the oracle's row
    in rows.json."""
    def case(run: Run):
        from nmpc_tpu_torch.tools import cl_parity

        rows = cl_parity.load_rows()
        out = cl_parity.engine_loop(name, max_steps, {"escape": escape}, run)
        run.fails.extend(cl_parity.judge(name, out, rows[name]))
    return case


def f64_solve(run: Run):
    """The per-scenario solve in float64 on the CPU
    (tests/test_f64_validation.py:13-29): U is f64 and the violation is far
    below the f32 floor."""
    ocp = make_ocp(m=2, N=30, T=0.1, x0=[-0.4, 0, 0, 0.4, 0, np.pi],
                   x_goal=[0.5, 0, 0, -0.5, 0, np.pi], dmin=0.3, collision=True,
                   dtype=torch.float64, device="cpu")
    t0 = time.perf_counter()
    res = solve(ocp, cfg=F64)
    viol = float(res.viol)
    run.loops.append({"tag": "f64 solve", "wall_s": time.perf_counter() - t0, "viol": viol,
                      "cost": float(res.cost), "dtype": str(res.U.dtype)})
    run.require(res.U.dtype == torch.float64, f"U is {res.U.dtype}")
    run.require(viol < 1e-6, f"f64 viol {viol:.3e}")


class Case(NamedTuple):
    """One reference test (`ref`, file:line) and the function that runs its
    port (`run(Run)`; its docstring says what the case runs and asserts)."""

    ref: str
    run: Callable


CASES: dict[str, Case] = {
    "single_robot_reference_config": Case("tests/test_mpc.py:49", single_robot_reference_config),
    "six_robot_antipodal_headline": Case("tests/test_mpc.py:70", six_robot_antipodal_headline),
    "closed_loop_fused_engine": Case("tests/test_mpc.py:182", closed_loop_fused_engine),
    "third_scenario": Case("tests/test_scenarios_closed_loop.py:31",
                           _scenario_case("third_scenario", 700, FAST)),
    "fourth_scenario": Case("tests/test_scenarios_closed_loop.py:38",
                            _scenario_case("fourth_scenario", 250, STRONG)),
    "fifth_scenario": Case("tests/test_scenarios_closed_loop.py:45",
                           _scenario_case("fifth_scenario", 250, STRONG)),
    "six_robot_hardware_config": Case("tests/test_scenarios_closed_loop.py:52",
                                      six_robot_hardware_config),
    "two_robot_hardware_config": Case("tests/test_scenarios_closed_loop.py:69",
                                      _scenario_case("two_robot_impl", 400, STRONG)),
    "ten_robot_line_crossing": Case("tests/test_scenarios_closed_loop.py:76",
                                    ten_robot_line_crossing),
    "eight_robot_published_config": Case("tests/test_scenarios_closed_loop.py:86",
                                         eight_robot_published_config),
    "eight_robot_full_swap": Case("tests/test_scenarios_closed_loop.py:102",
                                  eight_robot_full_swap),
    "decentralized_first_scenario_tour": Case("tests/test_scenarios_closed_loop.py:120",
                                              decentralized_first_scenario_tour),
    "steady_warm_bounded_six_robot": Case("tests/test_rt_mode.py:64",
                                          steady_warm_bounded_six_robot),
    "rt_closed_loop_two_robot_swap": Case("tests/test_rt_mode.py:72",
                                          rt_closed_loop_two_robot_swap),
    "rt_closed_loop_six_robot": Case("tests/test_rt_mode.py:119", rt_closed_loop_six_robot),
    "rt_closed_loop_six_robot_noise_and_delay": Case(
        "tests/test_rt_mode.py:144", rt_closed_loop_six_robot_noise_and_delay),
    "delay_closed_loop_six_robot_hw_config": Case("tests/test_rt_mode.py:213",
                                                  delay_closed_loop_six_robot_hw_config),
    **{f"escape_fuzz_deterministic_m{m}": Case("tests/test_escape_fuzz.py:146",
                                               _fuzz_case(m, seeds, 400))
       for m, seeds in FUZZ_SEEDS["deterministic"].items()},
    **{f"escape_fuzz_delay_m{m}": Case("tests/test_escape_fuzz.py:158",
                                       _fuzz_case(m, seeds, 600, delay=True))
       for m, seeds in FUZZ_SEEDS["delay"].items()},
    "escape_fuzz_noisy": Case("tests/test_escape_fuzz.py:172",
                              _fuzz_case(4, FUZZ_SEEDS["noisy"][4], 1100, noisy=True)),
    "decentralized_six_robot_antipodal": Case("tests/test_parallel.py:102",
                                              decentralized_six_robot_antipodal),
    "decentralized_four_robot_cross": Case("tests/test_parallel.py:60",
                                           decentralized_four_robot_cross),
    **{f"decentralized_fuzz_m{m}": Case("tests/test_parallel.py:176",
                                        _decentralized_fuzz_case(m, seeds))
       for m, seeds in FUZZ_SEEDS["decentralized"].items()},
    "consensus_six_robot_joint_quality": Case("tests/test_consensus.py:113",
                                              consensus_six_robot_joint_quality),
    "consensus_closed_loop_six_robot": Case("tests/test_consensus.py:156",
                                            _consensus_loop("six_robot_antipodal", 150, N=20)),
    "consensus_closed_loop_ten_robot": Case("tests/test_consensus.py:174",
                                            _consensus_loop("ten_robot", 250)),
    "cl_parity_six_robot_antipodal": Case("tests/test_cl_parity.py:31",
                                          _cl_parity_case("six_robot_antipodal", 220, True)),
    "cl_parity_eight_robot_standoff": Case("tests/test_cl_parity.py:55",
                                           _cl_parity_case("eight_robot", 300, False)),
    "f64_solve": Case("tests/test_f64_validation.py:35", f64_solve),
}

# the cases that run on the CPU (tier-1 size); every other case needs the card
CPU_CASES = ("f64_solve",)


def run_case(name: str, device=None, engine: str = "fused", dx0_seed: int | None = None) -> dict:
    """Run CASES[name] on `device` (default the card; f64_solve always on
    the CPU) through `engine` ("fused", or "ilqr" on the CPU), from starts
    moved as `dx0_seed` says (Run.dx0_seed). Returns the
    outcome {"name", "ref", "ok", "loops", "wall_s"}; raises AssertionError
    with the failures and the outcome if a bound or a launch check fails."""
    from nmpc_tpu_torch.device import DEVICE

    if engine not in ("fused", "ilqr"):
        raise ValueError(f"unknown engine {engine!r}")
    device = torch.device("cpu") if name in CPU_CASES else torch.device(device or DEVICE)
    if engine == "ilqr" and device.type == "cuda":
        raise ValueError("the per-scenario engine runs no hand kernel: on the card the loops "
                         "run engine 'fused'")
    case = CASES[name]
    run = Run(device, engine, dx0_seed=dx0_seed)
    t0 = time.perf_counter()
    case.run(run)
    out = {"name": name, "ref": case.ref, "ok": not run.fails, "loops": run.loops,
           "wall_s": time.perf_counter() - t0}
    if run.fails:
        err = AssertionError(f"{name} ({case.ref}): " + "; ".join(run.fails)
                             + f" | {json.dumps(out, default=str)}")
        err.outcome = out
        raise err
    return out


def summarize(junit_xml: str) -> str:
    """A markdown table of the suite's outcomes from a pytest junit file
    (the `outcome` property of tests/test_torch_loop_suite.py's card
    cases): per case its loops, arrivals, steps, min pair distance, ms a
    step (p50 range, p99 max), K1 launches a step and seconds."""
    import xml.etree.ElementTree as ET

    rows = ["| case | reference | loops | reached | steps | min pair distance | ms a step p50 "
            "/ p99 | K1 a step | s | result |", "|---|---|---|---|---|---|---|---|---|---|"]
    for tc in ET.parse(junit_xml).iter("testcase"):
        props = {p.get("name"): p.get("value") for p in tc.iter("property")}
        if "outcome" not in props or props["outcome"] == "null":
            continue
        out = json.loads(props["outcome"])
        loops = out["loops"]
        result = ("xfail" if tc.find("skipped") is not None else
                  "FAIL" if tc.find("failure") is not None else "pass")

        def span(key, fmt="{:.0f}"):
            v = [x[key] for x in loops if isinstance(x.get(key), (int, float))]
            if not v:
                return "-"
            lo, hi = min(v), max(v)
            return fmt.format(lo) if lo == hi else f"{fmt.format(lo)}-{fmt.format(hi)}"

        md = [x["min_dist"] for x in loops if isinstance(x.get("min_dist"), float)]
        p99 = [x["p99_ms"] for x in loops if isinstance(x.get("p99_ms"), float)]
        reached = [x["reached"] for x in loops if "reached" in x]
        ms = (f"{span('p50_ms', '{:.2f}')} / {max(p99):.2f}" if p99
              else f"mean {span('mean_ms', '{:.2f}')}")
        rows.append(
            f"| {out['name']} | {out['ref']} | {len(loops)} | {sum(reached)}/{len(reached)} | "
            f"{span('steps')} | {f'{min(md):.4f}' if md else '-'} | {ms} | "
            f"{span('K1_per_step', '{:.2f}')} | {out['wall_s']:.1f} | {result} |")
    return "\n".join(rows)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m nmpc_tpu_torch.tools.loop_suite")
    p.add_argument("names", nargs="*", help=f"cases (default all): {', '.join(CASES)}")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--engine", choices=("fused", "ilqr"), default="fused")
    p.add_argument("--dx0-seed", type=int, default=None,
                   help="start every loop from x0 moved by 1e-7 x N(0, 1), this numpy seed")
    p.add_argument("--summary", default=None, metavar="JUNIT_XML",
                   help="print the table of a suite run's outcomes and exit")
    args = p.parse_args(argv)
    if args.summary:
        print(summarize(args.summary))
        return 0
    if args.device == "cuda" and not torch.cuda.is_available():
        print("loop_suite: no CUDA device (pass --device cpu for the plain versions)",
              file=sys.stderr)
        return 2
    bad = 0
    for name in args.names or list(CASES):
        try:
            out = run_case(name, args.device, args.engine, args.dx0_seed)
        except AssertionError as e:
            bad += 1
            print(json.dumps({"name": name, "ok": False, "error": str(e)}), flush=True)
            continue
        print(json.dumps(out, default=str), flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
