"""K1's launch geometry on the card: its register cap and warps per block.

    python -m nmpc_tpu_torch.tools.k1_launch [M,...]
    python -m nmpc_tpu_torch.tools.k1_launch team [M,...]
    python -m nmpc_tpu_torch.tools.k1_launch loops

For each robot count M (default: every one of SCENARIOS; any 3 <= M <= 16,
past the registry's at scenarios/robot_counts.py's problem of M) builds
csrc/megasolve.cu once per register cap in CAPS (the blocks of 128 threads
per SM that the
registers must allow: 65,536 / (128 c) registers a thread) and times K1 at
the main path's first-step inputs (zero warm controls and duals, mu_init,
ALILQRConfig(n_outer=6, n_inner=12, tol_con=1e-3, ls="adaptive"), starts
jittered by 0.1 N(0, 1)) with each of WARPS scenarios per block, all
variants of one M in turns (forward, then backward). Prints each build's
ptxas line, whether every variant returns the same bits, and the times,
fastest first. The solver's choice (csrc/k1_variants.cuh::kK1MinBlocks,
ops/megasolve.py::K1_WARPS) is read from this table.

`team` sweeps K1's team design (csrc/inner_team.cuh) for each M of
cuda_build.TEAM_ROBOTS (default both): one build of megasolve.cu per
setting in team_variants(M) (TEAM_BASE[M], then one setting at a time: team
size T, ring depth D, register cap), each timed with
the warps per block of TEAM_WARPS, beside the warp design, all in turns
(forward, then backward), at path (b)'s first-step inputs at M=1
(obstacle_scenario_3, N=100, B=32768 starts jittered by 0.05, the cascade
of ALILQRConfig(n_outer=12, n_inner=25, tol_con=1e-3), zero warm controls
and duals, mu_init) and at the small batches of the modes at M=1 (the
consensus fleet's first round at 47 moving rows, B=48, and the six-robot
consensus loop's, 5 rows, B=6: `consensus_first_round`), and the main
path's at M=2. Prints each build's ptxas line, which variants return the
base's bits, and the times, fastest first. The solver's choice (the
defaults of csrc/inner_team.cuh and megasolve.cu::NMPC_K1_TEAM_MIN_BLOCKS,
ops/megasolve.py::K1_TEAM_WARPS) is read from this table.

`loops` runs the robot-parallel modes' closed loops of chip_smoke.py phase
23 at their full configurations (decentralized six robots N=30; consensus
six and ten robots N=20, 3 rounds, 4x10) with K1 at m = 1 the team design
(the route's) and the warp design (the solver's K1 call made through
`warp_k1`, megasolve.warp_launch, for the run), in turns (team, warp, warp,
team), and prints each run's steps and
per-step p50 (host clock at each step's first solve, after a sync). Needs a
card.
"""

from __future__ import annotations

import functools
import re
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from nmpc_tpu_torch.ops import cuda_build, megasolve
from nmpc_tpu_torch.solver.alilqr import ALILQRConfig

CAPS = (1, 4, 5, 6, 8)
WARPS = (1, 2, 4)
# one scenario per robot count at N=10, and its batch
SCENARIOS = {1: "single_robot", 2: "two_robot_swap", 3: "third_scenario", 4: "fourth_scenario",
             5: "five_robot", 6: "six_robot_antipodal", 8: "eight_robot", 10: "ten_robot"}


# the team design's settings (cuda_build.TEAM_SETTINGS) per m: the base (the
# defaults of csrc/inner_team.cuh and megasolve.cu), and the values tried one
# at a time around it
TEAM_BASE = {1: {"T": 8, "D": 3, "min_blocks": 4}, 2: {"T": 4, "D": 3, "min_blocks": 4}}
TEAM_VALUES = {"T": (4, 8, 16), "D": (2, 3, 4), "min_blocks": (2, 3, 4)}
TEAM_WARPS = (1, 2, 4)


def team_variants(m: int) -> list:
    """TEAM_BASE[m], then TEAM_BASE[m] with one setting changed, for each
    other value of TEAM_VALUES."""
    base = TEAM_BASE[m]
    out = [dict(base)]
    out += [{**base, key: v} for key, values in TEAM_VALUES.items() for v in values
            if v != base[key]]
    return out


def path_b_first_step(cfg: ALILQRConfig, B: int = 32768, seed: int = 0) -> tuple:
    """(ocp_b, lam, mu, U): path (b)'s problem (obstacle_scenario_3 at its
    registry horizon N=100) on the card, B starts jittered by 0.05 N(0, 1)
    from numpy's `seed`, and the first outer step's inputs."""
    from nmpc_tpu_torch.parallel import batch_ocp
    from nmpc_tpu_torch.scenarios import get

    base = get("obstacle_scenario_3").make()
    noise = 0.05 * np.random.default_rng(seed).standard_normal((B, base.nx))
    ob = batch_ocp(base, base.x0[None] + torch.from_numpy(noise.astype(np.float32)).to(base.device))
    kw = dict(dtype=torch.float32, device=base.device)
    return (ob, torch.zeros((B, base.N, base.n_con), **kw),
            torch.full((B,), cfg.mu_init, **kw), torch.zeros((B, base.N, base.nu), **kw))


def consensus_first_round(m: int = 48, N: int = 20, radius: float = 0.16, dev=None) -> tuple:
    """(ocp_b, lam, mu, U): the first round of the consensus loop of m
    robots on a circle of radius `radius` m a robot, each bound for its
    antipode (tools/bench_consensus.py: m=48 radius 0.16 is its largest
    fleet): m per-robot subproblems, the neighbours' cold plans in roll order
    as m - 1 moving-obstacle rows, the cold warm start."""
    import dataclasses
    import math

    from nmpc_tpu_torch.parallel import decentralized as TD

    tpl = TD.robot_template(N, 0.1, 0.3, m, **({} if dev is None else {"device": dev}))
    ang = torch.arange(m, dtype=torch.float64) * 2 * math.pi / m
    r = radius * m
    c, s = r * torch.cos(ang), r * torch.sin(ang)
    poses = torch.stack([c, s, ang + math.pi], -1).float().to(tpl.device)
    goals = torch.stack([-c, -s, ang + math.pi], -1).float().to(tpl.device)
    plans0 = poses[:, None, :2].repeat(1, N + 1, 1)
    mov = TD.rolled_neighbours(plans0, 0, m)[:, :, :N].transpose(1, 2).contiguous()
    ob = dataclasses.replace(tpl, x0=poses, xref=goals[:, None].repeat(1, N, 1), mov_obs=mov)
    w = TD.cold_warms(tpl, m, ALILQRConfig(n_outer=6, n_inner=12, tol_con=1e-4))
    return ob, w.lam, w.mu, w.U


def team_sweep(m: int, libs: dict, inputs: tuple, cfg: ALILQRConfig) -> tuple:
    """({name: [ms, ...]}, {name: returns the base build's bits}) of the
    team builds libs {variant key: library} with each warps per block (the
    base's with every TEAM_WARPS, the others with K1_TEAM_WARPS), and the
    warp design, in turns at `inputs` (ocp_b, lam, mu, U)."""
    from nmpc_tpu_torch.tools.exp_mega_phases import time_in_turns

    ob, lam, mu, U = inputs
    args = (ob, ob.x0, ob.xref, lam, mu, U, cfg, "inner_solve_fused")
    base = team_key(TEAM_BASE[m])
    runs = {}
    for key, lib in libs.items():
        for w in (TEAM_WARPS if key == base else (megasolve.K1_TEAM_WARPS,)):
            runs[f"team {key}, {w} warps"] = functools.partial(
                megasolve.team_launch, *args, lambda _, lib=lib: lib, w)
    runs["warp design"] = functools.partial(megasolve.warp_launch, *args, cuda_build.load,
                                            megasolve.K1_WARPS)
    outs = {name: f() for name, f in runs.items()}
    ref = outs[f"team {base}, {megasolve.K1_TEAM_WARPS} warps"]
    same = {name: all(torch.equal(a, b) for a, b in zip(o, ref)) for name, o in outs.items()}
    order = list(runs) + list(runs)[::-1]
    return time_in_turns(runs, order, 1), same


def team_key(variant: dict) -> str:
    return " ".join(f"{k}={v}" for k, v in variant.items())


def batch_size(m: int) -> int:
    return 32768 if m <= 6 else 16384


def problem_name(m: int) -> str:
    """SCENARIOS[m], or past the registry scenarios/robot_counts.py's
    builder and m."""
    from nmpc_tpu_torch.scenarios import robot_counts

    return SCENARIOS[m] if m in SCENARIOS else robot_counts.name(m)


def first_step(m: int, cfg: ALILQRConfig, seed: int = 0) -> tuple:
    """(ocp_b, lam, mu, U): the scenario of m robots at N=10 on the card
    (SCENARIOS[m], else scenarios/robot_counts.py's), batch_size(m) starts
    jittered by numpy from `seed`, and the first outer step's inputs."""
    from nmpc_tpu_torch.parallel import batch_ocp
    from nmpc_tpu_torch.scenarios import get, robot_counts

    base = get(SCENARIOS[m]).make(N=10) if m in SCENARIOS else robot_counts.make(m, N=10)
    B = batch_size(m)
    noise = 0.1 * np.random.default_rng(seed).standard_normal((B, base.nx))
    ob = batch_ocp(base, base.x0[None] + torch.from_numpy(noise.astype(np.float32)).to(base.device))
    kw = dict(dtype=torch.float32, device=base.device)
    return (ob, torch.zeros((B, base.N, base.n_con), **kw),
            torch.full((B,), cfg.mu_init, **kw), torch.zeros((B, base.N, base.nu), **kw))


def sweep(m: int, libs: dict, cfg: ALILQRConfig) -> tuple:
    """({(cap, warps): [ms, ms]}, every variant bit for bit equal) at m's
    first-step inputs; libs: {cap: library}."""
    from nmpc_tpu_torch.tools.exp_mega_phases import time_in_turns

    ob, lam, mu, U = first_step(m, cfg)
    runs = {(c, w): functools.partial(megasolve.warp_launch, ob, ob.x0, ob.xref, lam, mu, U, cfg,
                                      "inner_solve_fused", lambda _, lib=lib: lib, w)
            for c, lib in libs.items() for w in WARPS}
    outs = [f() for f in runs.values()]
    same = all(torch.equal(a, b) for o in outs[1:] for a, b in zip(o, outs[0]))
    order = list(runs) + list(runs)[::-1]
    return time_in_turns(runs, order, 1), same


def k1_ptxas(report: str, kernel: str = "inner_solve_kernel") -> str:
    """K1's lines of an `nvcc -Xptxas -v` report: its frame and its
    registers and static shared memory (kernel: its name in the report, the
    warp design's by default, `inner_team_kernel` for the team design's
    first instantiation)."""
    lines = report.splitlines()
    at = next(i for i, line in enumerate(lines)
              if "Compiling entry function" in line and kernel in line)
    return "; ".join(re.sub(r"^\s*ptxas info\s*:\s*", "", line).strip()
                     for line in lines[at + 2:at + 4])


def main(argv=None) -> int:
    from nmpc_tpu_torch.tools.exp_mega_phases import summarize
    from nmpc_tpu_torch.tools.roofline import card, require_card

    require_card("k1_launch")
    args = sys.argv[1:] if argv is None else argv
    if args and args[0] == "team":
        return team_main(args[1:])
    if args and args[0] == "loops":
        return loops_main()
    robots = [int(a) for a in args[0].split(",")] if args else sorted(SCENARIOS)
    cfg = ALILQRConfig(n_outer=6, n_inner=12, tol_con=1e-3, ls="adaptive")
    with ThreadPoolExecutor(max_workers=len(robots) * len(CAPS)) as pool:
        built = {(m, c): pool.submit(cuda_build.load_k1_variant, m, c) for m in robots for c in CAPS}
        built = {key: f.result() for key, f in built.items()}
    print(f"{torch.cuda.get_device_name(0)} [{card()}]")
    for m in robots:
        for c in CAPS:
            print(f"m={m} min blocks {c}: {k1_ptxas(built[m, c][1])}")
        times, same = sweep(m, {c: built[m, c][0] for c in CAPS}, cfg)
        print(f"m={m} {problem_name(m)} N=10 B={batch_size(m)}, first-step inputs; every variant "
              f"bit for bit the same: {'yes' if same else 'NO'}")
        for (c, w), (lo, med) in sorted(summarize(times).items(), key=lambda kv: kv[1][1]):
            print(f"  min blocks {c}, {w} warps per block: min {lo:.2f} ms, median {med:.2f} ms")
    return 0


def team_main(args: list) -> int:
    """`k1_launch team [M,...]`: the team design's sweep (module note)."""
    from nmpc_tpu_torch.tools.exp_mega_phases import summarize
    from nmpc_tpu_torch.tools.roofline import card

    robots = [int(a) for a in args[0].split(",")] if args else list(cuda_build.TEAM_ROBOTS)
    with ThreadPoolExecutor(max_workers=sum(len(team_variants(m)) for m in robots)) as pool:
        built = {(m, team_key(v)): pool.submit(cuda_build.load_k1_variant, m, team=v)
                 for m in robots for v in team_variants(m)}
        built = {key: f.result() for key, f in built.items()}
    print(f"{torch.cuda.get_device_name(0)} [{card()}]")
    for m in robots:
        variants = team_variants(m)
        for v in variants:
            key = team_key(v)
            print(f"m={m} team {key}: "
                  f"{k1_ptxas(built[m, key][1], 'inner_team_kernelILi%dELb%dE' % (m, m == 1))}")
        if m == 1:
            cfg = ALILQRConfig(n_outer=12, n_inner=25, tol_con=1e-3)
            cases = [("path (b) obstacle_scenario_3 N=100 B=32768 cascade", cfg,
                      path_b_first_step(cfg))]
            ccfg = ALILQRConfig(n_outer=6, n_inner=12, tol_con=1e-4)
            cases += [(f"consensus m={k} first round, {k - 1} moving rows, B={k}, N=20, cascade",
                       ccfg, consensus_first_round(k)) for k in (48, 6)]
        else:
            cfg = ALILQRConfig(n_outer=6, n_inner=12, tol_con=1e-3, ls="adaptive")
            cases = [(f"{SCENARIOS[m]} N=10 B={batch_size(m)} adaptive", cfg, first_step(m, cfg))]
        for what, cfg, inputs in cases:
            times, same = team_sweep(m, {team_key(v): built[m, team_key(v)][0] for v in variants},
                                     inputs, cfg)
            print(f"m={m} {what}, first-step inputs; the base build's bits "
                  f"(another T changes the obstacle rows' sum order):")
            for name, (lo, med) in sorted(summarize(times).items(), key=lambda kv: kv[1][1]):
                print(f"  {name}: min {lo:.3f} ms, median {med:.3f} ms; base bits: "
                      f"{'yes' if same[name] else 'no'}")
    return 0


def mode_loops(dev) -> list:
    """chip_smoke.py phase 23's loops: [(tag, solves a step, run)]."""
    import math

    from nmpc_tpu_torch.parallel import consensus_closed_loop, decentralized_closed_loop
    from nmpc_tpu_torch.scenarios import get

    def circle(m):
        ang = torch.arange(m, dtype=torch.float64) * 2 * math.pi / m
        x0 = torch.stack([torch.cos(ang), torch.sin(ang), ang + math.pi], -1).float()
        goals = torch.stack([-torch.cos(ang), -torch.sin(ang), ang + math.pi], -1).float()
        return x0.reshape(-1).to(dev), goals.to(dev)

    loop_cfg = ALILQRConfig(n_outer=4, n_inner=10, tol_con=1e-4)
    six, ten = get("six_robot_antipodal"), get("ten_robot")
    c6, c10 = six.make(N=20, device=dev), ten.make(device=dev)
    return [
        ("decentralized six robots N=30 (12x25)", 1,
         lambda: decentralized_closed_loop(*circle(6), N=30, T=0.1, dmin=0.3, max_steps=500,
                                           device=dev)),
        ("consensus six robots N=20 3 rounds (4x10)", 3,
         lambda: consensus_closed_loop(c6.x0, c6.xref[-1].reshape(6, 3), N=20, T=float(c6.T),
                                       dmin=float(torch.sqrt(c6.dmin2)), rounds=3, max_steps=150,
                                       cfg=loop_cfg, device=dev)),
        ("consensus ten robots N=20 3 rounds (4x10)", 3,
         lambda: consensus_closed_loop(c10.x0, c10.xref[-1].reshape(10, 3), N=20,
                                       T=float(c10.T), dmin=ten.dmin, rounds=3, max_steps=250,
                                       cfg=loop_cfg, device=dev)),
    ]


def step_p50(run, rounds: int) -> tuple:
    """(steps, per-step p50 ms, K1 launches) of one closed loop run(): the
    host clock at each step's first solve, after a sync."""
    import time

    from nmpc_tpu_torch.parallel import decentralized as TD

    real, stamps = TD.solve_batched, []

    def stamped(*a, **k):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        return real(*a, **k)

    TD.solve_batched = stamped
    cuda_build.reset_launch_counts()
    try:
        run()
        torch.cuda.synchronize()
        end = time.perf_counter()
    finally:
        TD.solve_batched = real
    starts = stamps[::rounds]
    ms = [1e3 * (b - a) for a, b in zip(starts, starts[1:] + [end])]
    return len(starts), float(np.percentile(ms, 50)), cuda_build.launch_counts["inner_solve_fused"]


def warp_k1(ocp, x0, xref, lam, mu, U, cfg):
    """K1 as the warp design (megasolve.warp_launch at K1_WARPS), with
    inner_solve_fused's arguments, results and launch count: the solver's K1
    call for the warp design's runs of `loops`."""
    return megasolve.warp_launch(ocp, x0, xref, lam, mu, U, cfg, "inner_solve_fused",
                                 cuda_build.load, megasolve.K1_WARPS)


def loops_main() -> int:
    """`k1_launch loops`: the modes' loops with K1 the team design and the
    warp design, in turns (module note)."""
    from unittest import mock

    from nmpc_tpu_torch.solver import alilqr_batched
    from nmpc_tpu_torch.tools.roofline import card

    dev = torch.device("cuda", 0)
    print(f"{torch.cuda.get_device_name(0)} [{card()}]")
    k1 = {"team": megasolve.inner_solve_fused, "warp": warp_k1}
    for tag, rounds, run in mode_loops(dev):
        run()   # warm-up
        out = {"team": [], "warp": []}
        for design in ("team", "warp", "warp", "team"):
            with mock.patch.object(alilqr_batched, "inner_solve_fused", k1[design]):
                out[design].append(step_p50(run, rounds))
        print(f"{tag}, in turns (team, warp, warp, team): " + "; ".join(
            f"{d} {n} steps, p50 {p:.2f} ms, {k} K1" for d, (n, p, k) in
            [("team", out["team"][0]), ("warp", out["warp"][0]), ("warp", out["warp"][1]),
             ("team", out["team"][1])]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
