"""Smoke run of the PyTorch + CUDA port (nmpc_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's two batched routes and its robot-parallel modes through
the hand-written CUDA kernels, after building them from nmpc_tpu_torch/csrc
and holding each against its plain PyTorch version on the card:

* the main path, the megakernel route: the six_robot_antipodal swap at
  N=10, B=32768 jittered starts, with the benchmark's ALILQRConfig(n_outer=6,
  n_inner=12, tol_con=1e-3, ls="adaptive"), through K1 (fused inner solve)
  and K2 (AL multiplier update), both one warp per scenario on the standard
  layout (csrc/inner_warp.cuh); K1's first design (one thread per scenario,
  csrc/megasolve.cuh) is timed beside it through the tools library;
* the staged route, through K4 (expansions), K3 (Riccati sweep), K5
  (line-search merits) and K6 (accepted rollout), at full width on three
  paths (each runs a tile of scenarios per block with its rows in shared
  memory, csrc/staged_tiles.cuh for K3 and K5,
  csrc/expansions_rollout_tiles.cuh for K4 and K6; their first designs, one
  thread per (stage and) scenario, are held against them bit for bit and
  timed beside them through tools/staged_launch.py), each with mega=False:
  (a) the main-path batch; (b) a family-H fleet, obstacle_scenario_3 (six
  static obstacles) at its registry horizon N=100, B=32768; (c) B=4096
  per-robot subproblems of one decentralized six-robot round (one robot,
  five moving obstacles, N=30); then line-search grids longer than one
  launch takes (K1's parameter block, K5's slices);
* the obstacle variant of K1 and K2 (static- and moving-obstacle rows):
  held against plain, then paths (b) and (c) on the megakernel route (the
  default mega=True) against the staged route on the same batch, in turns;
  at m <= 2 (paths (b), (c), the modes' subproblems, two_robot_swap) the
  route's K1 is its team design (csrc/inner_team.cuh: a team of lanes a
  scenario, the line-search candidates side by side), timed against the
  warp design in turns at (b), (c) and 47 moving-obstacle rows;
* the roofline path (nmpc_tpu_torch/tools), through K7 (FMA-peak probe), K8
  (K1 with one phase ablated at a fixed count) and K9 (K1 with the
  structured or the dense expansion layout), then the bound of every kernel;
* the closed loop (nmpc_tpu_torch/mpc, sim, tools/fleet_loop.py): the
  per-scenario engine on the card; the headline six_robot_antipodal loop
  (N=35) and the rt recipe through solve_one, every solve K1 and K2 at B=1;
  an obstacle_scenario_1 waypoint loop (N=100) on the staged route at B=1,
  every solve K4, K3, K5 and K6 (mega=False), and its first steps on the
  default route, K1's obstacle variant and K2 at B=1; the fleet loop, K1
  and K2 at B=32768 with warm duals;
* the robot-parallel modes (nmpc_tpu_torch/parallel): the decentralized
  six-robot antipodal loop and the consensus six- and ten-robot loops, each
  step's per-robot subproblems one solve_batched through K1's obstacle
  variant and K2;
* family I and the hybrid route: K3 at the ray-augmented stage shape
  (n, nu) = (13, 2) (csrc/riccati_shape.cu, the device code of
  staged_tiles.cuh); path (d), a lidar_v2 batch (N=100, B=4096) on
  solve_batched's hybrid route (plain expansions by jacfwd, K3, plain
  rollouts); sweep="scan" (the associative-scan LQR with K5 and K6) and
  compact=True on the main path's problem; the lidar_v4 fleet through the
  condensed GN engine (nmpc_tpu_torch/solver/gn.py, plain PyTorch) and the
  lidar_v4 closed loop at B=1 (nmpc_tpu_torch/mpc/lidar.py);
* the user-dynamics hook: K3 at the user models' stage shapes (2, 1) and
  (1, 1) (csrc/riccati_shape.cu at staged_tiles.k3_rule's geometry), and at
  staged_tiles.K3_SWEEP_SHAPES (every branch of the rule) against plain; the
  reference demo's Van der Pol OCP and the first-order process
  (make_generic_ocp, tools/user_models.py) at B=32768 on solve_batched's
  hybrid route through K3; the ADMM fleet (tools/admm_fleet.py, plain
  PyTorch); the real-time loop over the native runtime (io/robot.py's
  run_realtime, six_robot_impl, robots as a host thread over UDP) through
  K1 and K2 at B=1; `python -m nmpc_tpu_torch` in-process (list, a saved
  fused run, consensus, obstacle_scenario_1 on the default route);
* the sharded forms (nmpc_tpu_torch/parallel/mesh.py, shard_ocp_batch,
  consensus_solve_sharded, decentralized_step_sharded, parallel/dryrun.py):
  a one-rank NCCL world on the card, through which the main path's batch
  runs sharded (K1 and K2, bit for bit against the unsharded solve), the
  48-robot consensus fleet (K1's obstacle variant with 47 moving-obstacle
  rows, and K2; bit for bit against the single-program form where no row
  binds, within the spread of a 1e-7 move of x0 in the fleet packed to its
  keep-out, where they bind), K1 and K2 against plain with every slot
  binding, a decentralized round and the GN and ADMM fleets; then
  the dry run on a world of two ranks that share the card and exchange
  through gloo;
* the reference's closed-loop suite (nmpc_tpu_torch/tools/loop_suite.py,
  cl_parity.py), a bounded subset through solve_one: the escape-law fuzz's
  invariants at m=2 and m=6, obstacle_scenario_1's whole waypoint tour
  against CL_PARITY's outcome rule, and the benchmark's JSON line
  (nmpc_tpu_torch/bench.py, `python -m nmpc_tpu_torch bench`);
* the reference's measurement tools (nmpc_tpu_torch/tools/latency.py,
  ten_robot.py, gate_check.py, ls_ab.py): the latency tool's K-step MPC
  chunk (solve_one_graph, the megakernel route at B=1 with no host sync)
  captured as one CUDA graph and replayed, bit for bit the eager chunk;
  the ten-robot fleet (BASELINE config 5) at B=4096 through K1's warp
  design at m=10; the megakernel gate on the seven admission shapes; the
  line-search A/B's cascade arm at B=32768;
* family I's batched closed loop (nmpc_tpu_torch/mpc/lidar.py's
  closed_loop_lidar_batched, the reference fuzz's jax.vmap of its LiDAR
  loop): four fuzz fields a step in one gn.solve_batched, each scenario
  with its own scan, against the per-seed loop and the CPU;
* robot counts past the registry's (nmpc_tpu_torch/scenarios/
  robot_counts.py): the megakernel route at m = 7 and 9 (the antipodal
  circle) and 12 and 16 (ten_robot widened by columns; K1's lanes own two
  state rows and two right-hand sides), each library built at its first
  use, B=4096 at the bench config through K1 and K2, each held against
  plain, and at m=12 K1's and K2's obstacle variant; the staged route
  (mega=False) at m = 7, 9, 12 and 16 through K3-K6 (K3's register-tile
  design past ten robots: S scenarios a block, 4 x 4 register tiles of the
  products, the factor as one elimination over the block), held against
  plain; the hybrid route (sweep="scan") at m=12 through K5 and K6; K3's
  register-tile design at stage shapes past (30, 20) up to (80, 32), against
  plain.

Phases:

  0 device and toolchain            7 path (a), staged, launch counts checked
  1 build every kernel              8 path (b), obstacles, routing checked
  2 K2 vs plain, B=32768            9 path (c), moving obstacles (phases 7-9
                                      and 19 pin mega=False)
  3 K1 vs plain, B=1024, and a     10 K3-K6 vs plain at the shapes of (a)-(c);
    ragged B=33                       K3-K6 vs their first designs there
                                   11 staged timings (solves, also with K3's
                                      and K5's or K4's and K6's first designs,
                                      in turns; K3-K6 vs plain and vs their
                                      first designs in turns; a solve's split)
  4 main path at B=32768, no       12 K7: FMA peak over C chains, vs plain
    layout copies                     bit for bit (also at the timed shape)
  5 first 64 scenarios re-solved   13 K8: 'full' with the early exit is K1's
    on the CPU                        first design, vs plain and vs K1; the
  6 timings: solves/s, also with      undamped modes beside f64 at phase 3's
    K1's first design, in turns;      inputs; each mode vs plain; the six
    K1 vs its first design in         modes timed in turns; full vs plain at
    turns at two states, and vs       its timed shape
    plain there; K1 per outer      14 K9 vs plain (also at the timed shape),
    step; K2; the first design's      both layouts timed in turns; the
    layout copies                     roofline of K1-K9
                                   15 line-search grids of 33 and 64 alphas:
                                      K1 vs plain at m=6 and m=1 (the team
                                      design), the megakernel route; K5
                                      vs its first design; a staged solve
                                   16 the per-scenario engine: card vs CPU,
                                      vs solve_one; batched_solve vs solve
                                   17 headline loop through solve_one:
                                      arrival, clearance, per-step p50/p99,
                                      launches a step; the default engine
                                   18 rt recipe: per-step p50/p99 against T,
                                      a step's split into K1, K2, the rest
                                   19 obstacle waypoint loop, staged, B=1;
                                      its first steps on the default route
                                   20 fleet loop B=32768: fleet-steps/s, a
                                      step's split; its first step on the CPU
                                   21 K1's and K2's obstacle variant vs plain
                                      (path (b)'s problem B=1024 and 33, path
                                      (c) B=4096); its and K1's team
                                      design's ptxas lines
                                   22 paths (b) and (c) on the megakernel
                                      route vs the staged route, in turns;
                                      K1 per launch against its bound, vs
                                      plain and vs the warp design in
                                      turns (also at 47 rows), how often
                                      each leaves f64's path; (b)'s CPU
                                      re-solve and a control that drops an
                                      obstacle
                                   23 the modes: decentralized six-robot
                                      loop, consensus six- and ten-robot
                                      loops; K1/K2 vs plain at their shapes
                                   24 K3 at (13, 2): its ptxas line, vs
                                      plain at path (d)'s inputs, its time
                                   25 path (d): lidar_v2 N=100 B=4096 on the
                                      hybrid route, K3 launches and split;
                                      its first scenarios on the CPU
                                   26 sweep='scan' and compact=True on the
                                      main path's problem (compact bit for
                                      bit, in turns)
                                   27 the lidar_v4 GN fleet, B=1024 and
                                      4096 (scan), B=1024 dense against it
                                   28 the lidar_v4 closed loop (CL_PARITY
                                      fixture, B=1), its first 15 steps
                                   29 K3 at (2, 1) and (1, 1): ptxas, vs
                                      plain at the user models' inputs,
                                      times against the bound
                                   30 the generic path: Van der Pol and
                                      the process at B=32768, hybrid
                                      route; the first 8 on the CPU
                                   31 the ADMM fleet B=256: QPs/s; the
                                      first 4 on the CPU
                                   32 the real-time loop over the native
                                      runtime (six_robot_impl, UDP)
                                   33 the CLI: list, run (fused, saved;
                                      consensus; obstacle_scenario_1)
                                   34 the sharded forms: one rank on NCCL
                                      (the main path's batch bit for bit
                                      against unsharded, its solves/s and
                                      overhead; consensus m=48 against the
                                      single-program form at its spread,
                                      K1/K2 vs plain at its shape, K1's
                                      share; a decentralized round; the GN
                                      and ADMM fleets bit for bit); the dry
                                      run on two ranks over gloo
                                   35 the closed-loop suite: the escape-law
                                      fuzz at m=2 (team design) and m=6
                                      (warp design), the obstacle_scenario_1
                                      tour (obstacle variant), each held to
                                      the reference's bounds; bench's line
                                   36 the reference's tools: the latency
                                      chunk as one CUDA graph, bit for bit
                                      the eager chunk; ten_robot B=4096 and
                                      K1 vs plain at m=10; the gate on the
                                      seven admission shapes; ls_ab's
                                      cascade arm and its K1 vs plain
                                   37 the batched LiDAR loop at B=4 fuzz
                                      fields vs the per-seed loop on the
                                      card and vs the CPU; ms a step at
                                      B=4 and B=1
                                   38 m = 7, 9, 12, 16: the libraries'
                                      ptxas lines and slot sizes; bench-
                                      config solves B=4096 (quality, ms);
                                      K1/K2 vs plain (at 12 also their
                                      obstacle variant), their ms against
                                      plain and the bound; the staged
                                      route, K3-K6 vs plain, timed
                                   39 the hybrid route at m=12 (scan, K5
                                      and K6), B=1024; K3's register-tile
                                      design
                                      at (36, 24), (41, 7), (50, 13),
                                      (64, 32) and (80, 32): ptxas, vs
                                      plain, timed against the bound
                                   40 m = 20, 24, 32, past K1's sixteen
                                      robots: ptxas of K3's register-tile
                                      design and K4-K6 on their smaller
                                      tiles;
                                      bench-config solves on the default
                                      config's (staged) route B=4096,
                                      4096, 1024 (quality, ms, launches),
                                      the same as mega=False bit for bit;
                                      K3 timed at the solve's batch;
                                      K3-K6 vs plain at B=256, timed
                                      against the bound; the hybrid route
                                      at m=20 (and K5/K6 reading device
                                      memory, D = 0, bit for bit); K3 at
                                      (81, 33), (96, 64), (120, 40), (150,
                                      100) (nu > 32, a ring of one, the
                                      slot spilled, its products staged)
                                      vs plain, timed
                                   41 no shared-memory ceiling: m = 112's
                                      library (K4's and K5's device-memory
                                      forms alone) and every library's
                                      device-memory forms (ptxas); the
                                      m = 112 crossing B=64, 16 robots
                                      among 200 pillars B=1024, 20 among
                                      64 on the hybrid route B=256, one
                                      robot with 150 moving obstacles
                                      B=1024: the forms launched, the
                                      converged share, K3-K6 vs plain
                                      (B <= 64, 8 at m = 112), timed
                                      against the bound; both forms bit
                                      for bit where both take a problem

Phases 5, 7, 8, 9, 20, 22, 25, 30 and 31 re-solve the first scenarios with the plain path on
the CPU; phase 37 reruns its loop there. Any failed check raises, so the exit code is
non-zero. Without a CUDA
card, or without the package beside this script, it fails before printing
any result. Output: one line per phase; before the last line, the kernels'
JSON record and the nvidia-smi name/power-limit line; last line
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import math
import os
import re
import statistics
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH_B = 32768
K1_B = 1024
CROSS_B = 64
OBS_CROSS_B = 32
# phase 34: consensus's fleet (tools/bench_consensus.py's largest), the GN
# fleet's and the ADMM fleet's batches
SHARD_CONSENSUS_M = 48
SHARD_GN_B = 1024
SHARD_ADMM_B = 256
MOV_B = 4096
# path (d) (the hybrid route on family I), its CPU re-solve, and the lidar_v4
# loop's steps in phase 28
LIDAR_B = 4096
LIDAR_CROSS_B = 8
LIDAR_STEPS = 8
# phase 16's batch held scenario by scenario against the per-scenario solve
PER_SCENARIO_B = 32
# K3 at the stage shapes other than (3m, 2m) (csrc/riccati_shape.cu), as
# PERF.md records its line (regs, stack, spill stores, spill loads, dynamic
# shared bytes a block)
K3_SHAPE_PTXAS = {(13, 2): (56, 0, 0, 0, 47888), (2, 1): (80, 0, 0, 0, 17920),
                  (1, 1): (40, 0, 0, 0, 8192)}
# the user models' fleets (phases 29-30: B starts, the first re-solved on the
# CPU), the ADMM fleet's batch (phase 31, tools/bench_admm.py's), the
# real-time loop's periods (phase 32; its UDP port is picked free at run time)
USER_B = 32768
USER_CROSS_B = 8
ADMM_B = 256
RT_PERIODS = 80
# K1's `-Xptxas -v` line at each m as recorded in PERF.md (regs, stack, spill
# stores, spill loads, static shared bytes: none, its dynamic shared memory
# holds one slot of nmpc_k1_slot_bytes() a warp and then the parameter
# block): K1 does not change when the staged kernels or the tools are changed
K1_PTXAS = {1: (64, 32, 80, 72, 0), 2: (64, 72, 228, 220, 0),
            3: (80, 16, 40, 40, 0), 4: (96, 0, 0, 0, 0),
            5: (96, 0, 0, 0, 0), 6: (96, 8, 16, 12, 0),
            8: (128, 8, 16, 12, 0), 10: (168, 0, 0, 0, 0)}
# K1's first design (one thread per scenario) at m=6, as PERF.md records its
# line: the tools part `K8 full, early exit` is that design
FIRST_K1_PTXAS = (255, 4880, 156, 200)
# the tools' variants of K1's warp design at m=6 (csrc/tools.cu parts 9-16:
# K8's modes and K9's dense layout under inner_warp.cuh's template flags),
# as PERF.md records their lines (regs, stack, spill stores, spill loads);
# `K8 warp full, early exit` is K1's own code and carries K1_PTXAS[6]'s line
WARP_TOOLS_PTXAS = {"K8 warp full, early exit": (96, 8, 16, 12), "K8 warp full": (96, 0, 0, 0),
                    "K8 warp inv_solve": (96, 8, 4, 4), "K8 warp no_ls": (96, 8, 16, 12),
                    "K8 warp no_solve": (92, 0, 0, 0), "K8 warp no_expcon": (96, 8, 4, 4),
                    "K8 warp sweep_only": (96, 8, 16, 12), "K9 warp dense": (96, 8, 12, 8)}
# K2's first design (one thread per scenario on the lane-major layout, since
# removed) at the main path's shape, ms per launch as PERF.md records it
# (NVIDIA H100 80GB HBM3, 700.00 W)
FIRST_K2_MS = 0.844
# K3-K6's lines at each m as recorded in PERF.md (the tile designs, with a
# fifth entry: the dynamic shared bytes of a block, K4's and K5's at the main
# path's rows without obstacles and a parameter block with no alphas (K4) or
# nine (K5))
STAGED_PTXAS = {
    1: {"K3": (95, 0, 0, 0, 44032), "K4": (53, 32, 0, 0, 18000), "K5": (40, 56, 0, 0, 6768),
        "K6": (76, 56, 0, 0, 6656)},
    2: {"K3": (168, 0, 0, 0, 163840), "K4": (72, 32, 0, 0, 20096), "K5": (44, 80, 0, 0, 16816),
        "K6": (76, 80, 0, 0, 19456)},
    3: {"K3": (56, 0, 0, 0, 75152), "K4": (96, 32, 0, 0, 33472), "K5": (52, 104, 0, 0, 30176),
        "K6": (72, 32, 0, 0, 19968)},
    4: {"K3": (80, 0, 0, 0, 63296), "K4": (128, 32, 0, 0, 49152), "K5": (61, 128, 0, 0, 23584),
        "K6": (72, 32, 0, 0, 32768)},
    5: {"K3": (96, 0, 0, 0, 100128), "K4": (128, 32, 0, 0, 67136), "K5": (63, 152, 0, 0, 33632),
        "K6": (96, 32, 0, 0, 48640)},
    6: {"K3": (128, 0, 0, 0, 143184), "K4": (167, 32, 0, 0, 87408), "K5": (86, 176, 0, 0, 90272),
        "K6": (76, 176, 0, 0, 66048)},
    8: {"K3": (204, 0, 0, 0, 227328), "K4": (254, 32, 0, 0, 67696), "K5": (81, 224, 0, 0, 73744),
        "K6": (114, 32, 0, 0, 57344)},
    10: {"K3": (255, 0, 0, 0, 220800), "K4": (255, 32, 0, 0, 96096), "K5": (101, 400, 0, 0, 54736),
         "K6": (123, 32, 0, 0, 43520)},
}
# the staged kernels' first designs (csrc/staged_first.cu), as PERF.md
# records them
FIRST_STAGED_PTXAS = {1: {"K3": (32, 176, 0, 0), "K4": (64, 80, 0, 0), "K5": (72, 0, 0, 0),
                          "K6": (32, 56, 0, 0)},
                      6: {"K3": (255, 4384, 0, 0), "K4": (108, 1728, 0, 0), "K5": (72, 176, 0, 0),
                          "K6": (72, 176, 0, 0)}}
# K1's team design (csrc/inner_team.cuh, the route's K1 at m <= 2) as PERF.md
# records its lines (regs, stack, spill stores, spill loads), pair-only and
# the obstacle variant
K1_TEAM_PTXAS = {1: {"K1 team": (101, 32, 0, 0), "K1 team obs": (128, 48, 12, 12)},
                 2: {"K1 team": (128, 64, 56, 64), "K1 team obs": (128, 200, 312, 328)}}
KERNELS = {"inner_solve": "K1", "inner_team": "K1 team", "al_update": "K2", "riccati": "K3",
           "expansions_device": "K4 device", "linesearch_costs_device": "K5 device",
           "expansions": "K4", "linesearch_costs": "K5", "rollout_alpha": "K6"}
# the solver library's kernels: K1-K6, K1's and K2's obstacle variant (the
# instantiations with the template flag kObs = true), K4's and K5's
# device-memory forms; at m <= 2 also K1's team design in both
# instantiations
SOLVER_KERNELS = (set(KERNELS.values()) - {"K1 team"}) | {"K1 obs", "K2 obs"}
TEAM_KERNELS = {"K1 team", "K1 team obs"}


def kernel_name(line: str) -> str:
    """The kernel of a ptxas 'Compiling entry function' line: K1-K6, 'K1
    team' (K1's team design), 'K1 obs' / 'K2 obs' / 'K1 team obs' for the
    obstacle variant, 'K4 device' / 'K5 device' for K4's and K5's
    device-memory forms, else '?'."""
    name = next((k for key, k in KERNELS.items() if key in line), "?")
    return f"{name} obs" if name in ("K1", "K2", "K1 team") and "Lb1E" in line else name


def k1_merit_order(ob):
    """The plain merit summed in the order of the route's K1 for ob: the
    team design's at m <= 2, the warp design's above."""
    from nmpc_tpu_torch.ops import cuda_build, megasolve

    return (megasolve.al_merit_team_order if ob.m in cuda_build.TEAM_ROBOTS
            else megasolve.al_merit_warp_order)


T_START = time.perf_counter()


def log(msg: str) -> None:
    """A line of the run's log, after the seconds since the script started."""
    print(f"[{time.perf_counter() - T_START:6.1f} s] {msg}", flush=True)


def sh(cmd: list[str]) -> str:
    return subprocess.run(cmd, capture_output=True, text=True, check=True).stdout.strip()


def ptxas(text: str, part: str = "?") -> dict:
    """{'K1': (regs, stack, spill stores, spill loads), ...} of a build log.
    The tools' entries: K7's per chain count C ('K7 C=8'), a K1 variant by
    the name of the part of csrc/tools.cu that built it."""
    out, name, frame = {}, "?", (0, 0, 0)
    for line in text.splitlines():
        if "Compiling entry function" in line:
            c = re.search(r"fma_peak_kernelILi(\d+)E", line)
            name = (f"K7 C={c[1]}" if c else part if "variant_kernel" in line
                    else kernel_name(line))
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            frame = tuple(int(g) for g in m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[name] = (int(m[1]), *frame)
    return dict(sorted(out.items()))


def ptxas_smem(text: str) -> dict:
    """{'K1': static shared bytes, ...} of a solver library's build log."""
    out, name = {}, "?"
    for line in text.splitlines():
        if "Compiling entry function" in line:
            name = kernel_name(line)
        m = re.search(r"Used \d+ registers.*?(\d+) bytes smem", line)
        if m:
            out[name] = int(m[1])
    return out


def ptxas_summary(text: str, part: str = "?") -> str:
    """'K1 N regs, stack S B, spill stores a B, loads b B; K2 ...'"""
    return "; ".join(f"{k} {r} regs, stack {st} B, spill stores {a} B, loads {b} B"
                     for k, (r, st, a, b) in ptxas(text, part).items())


def cross_measure(res, ref, n: int) -> dict:
    """The first n scenarios of a solve on the card (res) against their
    re-solve by the plain path on the CPU (ref): scenarios with cost within
    rtol 1e-4 and U within atol 5e-3, the largest errors, converged shares
    and the mean cost ratio."""
    gc, gu = res.cost[:n].cpu(), res.U[:n].cpu()
    rel = (gc - ref.cost).abs() / ref.cost.abs()
    du = (gu - ref.U).abs().amax(dim=(1, 2))
    return dict(n_cost=int((rel <= 1e-4).sum()), n_u=int((du <= 5e-3).sum()),
                max_rel=float(rel.max()), max_du=float(du.max()),
                conv_g=float(res.converged[:n].float().mean()),
                conv_r=float(ref.converged.float().mean()),
                mean_ratio=float(gc.mean() / ref.cost.mean()))


def cross_misses(r: dict, n: int, u_share: float = 0.75, cost_share: float = 0.9,
                 ratio_tol: float = 1e-3) -> list:
    """The criteria of `cross_check` that the measure r misses (none: it
    passes)."""
    return [name for name, ok in (
        ("cost share", r["n_cost"] >= cost_share * n),
        ("U share", r["n_u"] >= u_share * n),
        ("converged", abs(r["conv_g"] - r["conv_r"]) <= 1.0 / n + 1e-9),
        ("mean cost ratio", abs(r["mean_ratio"] - 1.0) <= ratio_tol)) if not ok]


def cross_line(r: dict, n: int) -> str:
    return (f"cost within rtol 1e-4 on {r['n_cost']}/{n} (max rel {r['max_rel']:.3e}), U within "
            f"atol 5e-3 on {r['n_u']}/{n} (max {r['max_du']:.3e}); converged {r['conv_g']:.4f} vs "
            f"{r['conv_r']:.4f}; mean cost ratio {r['mean_ratio']:.6f}")


def cross_check(tag: str, res, sub, cfg, n: int, u_share: float = 0.75, warm=None,
                cost_share: float = 0.9, ratio_tol: float = 1e-3):
    """Re-solve the first n scenarios of a solve on the card (res) with the
    plain path on the CPU (sub: their problem on the CPU) and hold the two to
    phase 5's criteria. Per scenario the full solve is path-sensitive in f32:
    a near-tied alpha pick or a stop rule that flips moves a scenario to
    another point of a flat cost valley (the plain path alone, solving the
    same scenarios at two batch sizes, differs by 1e-3 in cost on some). So
    most scenarios must agree at the tight tolerances (cost on a share
    cost_share, U on a share u_share), and the batch at the aggregate ones
    of tests/test_batched_solver.py (mean cost ratio within ratio_tol).
    `warm`: the first n scenarios' warm start, on the CPU. Returns the CPU's
    re-solve."""
    from nmpc_tpu_torch.solver import solve_batched

    ref = solve_batched(sub, warm, cfg=cfg)
    r = cross_measure(res, ref, n)
    log(f"{tag}: first {n} scenarios re-solved by the plain path on the CPU: {cross_line(r, n)}")
    missed = cross_misses(r, n, u_share, cost_share, ratio_tol)
    assert not missed, (tag, missed, r)
    return ref


def timed(fn):
    """(result, seconds) of fn() on the host clock, ending in a synchronize."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def once(fn):
    """(fn(), its ms on CUDA events): one call, no warm-up."""
    from nmpc_tpu_torch.utils.timing import cuda_ms

    out = []
    ms = cuda_ms(lambda: out.append(fn()), 1, warmup=0)
    return out[0], ms


def agree(got, want) -> tuple:
    """K1-like results (Xs, U, cost, iters) against their plain version at
    phase 3's tolerances, per scenario: cost rtol 1e-4, U and Xs atol 5e-3.
    Returns (the scenarios that agree [B] bool, max cost rel, max |dU|,
    max |dXs|), the maxima over every scenario."""
    rel = (got[2] - want[2]).abs() / want[2].abs().clamp(min=1e-30)
    du = (got[1] - want[1]).abs().amax(dim=(1, 2))
    dx = (got[0] - want[0]).abs().amax(dim=(1, 2))
    return ((rel <= 1e-4) & (du <= 5e-3) & (dx <= 5e-3), float(rel.max()), float(du.max()),
            float(dx.max()))


def hold_solve(tag: str, got, want, allow: float = 0.0) -> tuple:
    """`agree`, where past a few iterations an f32 tie in the line search
    can send a scenario another way, so a share `allow` of the scenarios may
    miss (0: none). Returns (scenarios missed, max cost rel, max |dU|, max
    |dXs|)."""
    import torch

    ok, rel, du, dx = agree(got, want)
    missed = int((~ok).sum())
    assert all(torch.isfinite(t).all() for t in got[:3]), tag
    assert missed <= allow * ok.numel(), (tag, missed, ok.numel())
    return missed, rel, du, dx


def hold_k2(tag: str, ob, Xs, U, lam, mu, lam_max) -> None:
    """K2 against its plain version on the batch ob at (Xs, U, lam, mu), at
    phase 2's tolerances (rtol 1e-6, atol 1e-6 on lam and viol). Returns the
    largest |error|."""
    import torch

    from nmpc_tpu_torch.ops import megasolve

    got = megasolve.al_update_lanes(ob, Xs, U, lam, mu, lam_max)
    torch.cuda.synchronize()
    want = megasolve.al_update_plain(ob, Xs, U, lam, mu, lam_max)
    err = max(float((got[0] - want[0]).abs().max()), float((got[1] - want[1]).abs().max()))
    torch.testing.assert_close(got[0], want[0], rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(got[1], want[1], rtol=1e-6, atol=1e-6)
    log(f"{tag}, max |err| {err:.3e} (lam, viol; rtol 1e-6 atol 1e-6) ok")
    return err


def hold_k1(tag: str, obk, U, lam, mu, cfg, errs: list | None = None):
    """K1 against its plain version on the batch obk from (U, lam, mu) over
    cfg's n_inner iterations, at phase 3's tolerances: cost rtol 1e-4, U
    atol 5e-3, iteration counts equal on >= 99% of the scenarios (within
    the first iterations both follow the same path; past them, f32 rounding
    can flip a near-tied alpha or the rel < tol_cost stop and move a
    scenario along a flat valley of the merit). Returns K1's (Xs, U, cost,
    iters); appends the largest |U error| to `errs`."""
    import torch

    from nmpc_tpu_torch.ops import megasolve

    Bk = obk.x0.shape[0]
    got = megasolve.inner_solve_fused(obk, obk.x0, obk.xref, lam, mu, U, cfg)
    torch.cuda.synchronize()
    want = megasolve.inner_solve_plain(obk, obk.x0, obk.xref, lam, mu, U, cfg)
    rel = ((got[2] - want[2]).abs() / want[2].abs())
    du = (got[1] - want[1]).abs().amax(dim=(1, 2))
    same_it = int((got[3] == want[3]).sum())
    w = int(du.argmax())
    log(f"{tag}: cost rel max {float(rel.max()):.3e}, U max |err| {float(du.max()):.3e} (worst "
        f"scenario {w}: cost {float(got[2][w]):.6f} vs {float(want[2][w]):.6f}, iters "
        f"{int(got[3][w])} vs {int(want[3][w])}), iteration counts equal {same_it}/{Bk}")
    torch.testing.assert_close(got[2], want[2], rtol=1e-4, atol=0.0)
    torch.testing.assert_close(got[1], want[1], rtol=0.0, atol=5e-3)
    assert same_it >= 0.99 * Bk, same_it
    if errs is not None:
        errs.append(float(du.max()))
    assert torch.isfinite(got[0]).all()
    return got


def hold_at_loop_shape(tag: str, o, w, cfg) -> None:
    """K1 and K2 at a closed loop's own shape (B=1, the scenario's N) against
    their plain versions, from the warm start w the loop gave its solve of
    the latched problem o: K1 over 4 inner iterations at cfg's line search,
    K2 on K1's output."""
    import torch

    ob = dataclasses.replace(o, x0=o.x0[None], xref=o.xref[None])
    U, lam, mu = (torch.as_tensor(a, device=o.device)[None] for a in (w.U, w.lam, w.mu))
    c4 = dataclasses.replace(cfg, n_inner=4)
    got = hold_k1(f"{tag} K1 vs plain at the loop's shape (B=1, N={o.N}, m={o.nx // 3}, "
                  f"ls={cfg.ls}, n_inner=4, the second step's warm start: mu {float(mu[0]):.3g})",
                  ob, U, lam, mu, c4)
    hold_k2(f"{tag} K2 vs plain at the loop's shape on K1's output", ob, got[0], got[1], lam, mu,
            cfg.lam_max)


def hold_staged_kernels(tag: str, ocp_b, r, cfg, gen, first: bool = True,
                        diverged: float = 0.01, states=("i", "ii"), plain_ms=None) -> list:
    """K3-K6 against their plain versions (staged_vs_plain) and, with
    `first`, their first designs (first_vs_tiles) on the last iterate r of a
    staged solve of ocp_b: (i) with fresh multipliers of the CPU tests' kind
    (|N(0, 0.5)|, zero on the masked rows, mu in {10, 100}), where every
    unit must pass at the CPU tolerance without the f32 spread; (ii) with
    the solve's own multipliers and penalty weights (mu up to 1e4), where K3
    and K6 may need it. At most a share `diverged` of the units (1%; their
    f64 rollouts leave the arena, kernel_check's rule) may diverge at
    either; the first designs bit for bit. `states`: which of (i) and (ii)
    run; plain_ms, a dict: each plain version's ms of its call at state
    (ii) (kernel_check.staged_vs_plain). Returns [(state, verdicts, calls,
    first-design calls or None)]."""
    import torch

    from nmpc_tpu_torch.ocp import problem as P

    dev = r.X.device
    Bp = ocp_b.x0.shape[0]
    lam_i = 0.5 * torch.randn(r.lam.shape, generator=gen, device=dev).abs()
    lam_i = lam_i * (P.constraint_mask(ocp_b) > 0)
    mu_i = torch.tensor([10.0, 100.0], device=dev)[
        torch.randint(0, 2, (Bp,), generator=gen, device=dev)]
    out = []
    for state, lam_s, mu_s in (("i", lam_i, mu_i), ("ii", r.lam, r.mu)):
        if state not in states:
            continue
        v, calls = staged_vs_plain(ocp_b, r.X, r.U, lam_s, mu_s, cfg,
                                   plain_ms if state == "ii" else None)
        off, ab = (first_vs_tiles(ocp_b, r.X, r.U, lam_s, mu_s, cfg) if first
                   else ({"K3": 0, "K4": 0, "K5": 0, "K6": 0}, None))
        log(f"{tag} B={Bp} N={ocp_b.N}, state ({state}): "
            + "; ".join(f"{k} max |err| {x.err:.3e} (relative to max(1, |plain|) "
                        f"{x.rel:.3e}) on the held units, diverged "
                        f"{x.n_diverged}/{x.units}, passing by the f32 spread alone "
                        f"{x.n_widened}/{x.units}"
                        for k, x in v.items())
            + (f"; against the first designs, units that differ: K3 {off['K3']}/{Bp}, K4 "
               f"{off['K4']}/{Bp}, K5 {off['K5']}/{Bp * (len(cfg.alphas) + 1)}, K6 "
               f"{off['K6']}/{Bp} (bit for bit: 0)" if first else "") + " ok")
        assert off == {"K3": 0, "K4": 0, "K5": 0, "K6": 0}, (tag, state, off)
        for k, x in v.items():
            assert x.n_diverged <= diverged * x.units, (tag, state, k, x.n_diverged)
            assert state == "ii" or x.n_widened == 0, (tag, state, k, x.n_widened)
        out.append((state, v, calls, ab))
    return out


def k3_at_solve_batch(ob, r, cfg, reps: int = 2) -> tuple:
    """K3's ms at a staged solve's own batch: its inputs K4's expansions at
    the solve's last iterate r of ob, every scenario (the launches the
    solve made at that batch), on CUDA events after a warm-up; with the
    bound of that launch (tools/roofline.py::kernel_work). Returns (ms,
    bound ms, bound by)."""
    from nmpc_tpu_torch.ops.cuda_build import lane
    from nmpc_tpu_torch.ops.expansions import expansions_fused
    from nmpc_tpu_torch.ops.riccati import riccati_lanes
    from nmpc_tpu_torch.solver.alilqr_batched import _mov_lanes
    from nmpc_tpu_torch.tools import roofline as RL
    from nmpc_tpu_torch.utils.timing import cuda_ms

    B = ob.x0.shape[0]
    exp = expansions_fused(ob, lane(r.X[:, :-1]), lane(r.U), lane(ob.xref), lane(r.lam),
                           r.mu.contiguous(), _mov_lanes(ob, B))
    ms_ = cuda_ms(lambda: riccati_lanes(exp, cfg.reg), reps)
    b_ms, by = RL.bound(*RL.kernel_work("K3", ob, B))
    del exp
    return ms_, b_ms, by


def summary(res) -> str:
    import torch

    return (f"converged {float(res.converged.float().mean()):.4f}, viol p99 "
            f"{float(torch.quantile(res.viol, 0.99)):.3e}, max {float(res.viol.max()):.3e}, "
            f"mean inner iters {float(res.inner_iters.float().mean()):.2f}, "
            f"mean cost {float(res.cost.mean()):.4f}")


def check_staged(tag: str, counts: dict, res, cfg) -> None:
    """The staged route ran: no K1 or K2 launch; one K4, K3 and K5 launch per
    inner iteration run; K6 once more (the initial rollout); finite output."""
    import torch

    it = counts["riccati_lanes"]
    assert counts["inner_solve_fused"] == 0 and counts["al_update_lanes"] == 0, (tag, counts)
    assert counts["expansions_fused"] == it and counts["linesearch_costs_lanes"] == it, (tag, counts)
    assert counts["rollout_alpha_lanes"] == it + 1, (tag, counts)
    # every scenario counts each iteration run while it is not done, so the
    # largest count is at most the number run, at most n_inner per outer step
    assert int(res.inner_iters.max()) <= it <= cfg.n_inner * int(res.outer_iters.max()), (tag, counts)
    assert it > 0, (tag, counts)
    for name in ("X", "U", "cost", "viol", "lam"):
        assert torch.isfinite(getattr(res, name)).all(), (tag, name)


def decentralized_round(make_ocp, dev, gen, B: int):
    """B per-robot subproblems of one decentralized six-robot round, the
    shape of nmpc_tpu/parallel/decentralized.py::robot_template(30, 0.1, 0.3,
    6): one unicycle, N=30, T=0.1, dmin=0.3, its five neighbours' exchanged
    plans as moving obstacles ([B, N, 5, 2], one schedule per scenario). The
    robot crosses a unit circle to the antipodal point; each neighbour starts
    0.5-1.5 from it and drives straight at 0.2 m/s in a random direction."""
    import dataclasses

    import torch

    N, T, n_mov = 30, 0.1, 5
    kw = dict(device=dev)
    tpl = make_ocp(m=1, N=N, T=T, x0=[0.0, 0.0, 0.0], x_goal=[0.0, 0.0, 0.0], dmin=0.3,
                   mov_obs=torch.zeros((N, n_mov, 2), **kw), device=dev)
    u = lambda *shape: torch.rand(shape, generator=gen, **kw)  # noqa: E731
    ang = 2 * torch.pi * u(B)
    start = torch.stack([torch.cos(ang), torch.sin(ang), ang + torch.pi], -1)
    goal = torch.stack([-torch.cos(ang), -torch.sin(ang), ang + torch.pi], -1)
    r, psi, phi = 0.5 + u(B, n_mov), 2 * torch.pi * u(B, n_mov), 2 * torch.pi * u(B, n_mov)
    p0 = start[:, None, :2] + r[..., None] * torch.stack([torch.cos(psi), torch.sin(psi)], -1)
    vel = 0.2 * torch.stack([torch.cos(phi), torch.sin(phi)], -1)
    steps = T * torch.arange(1, N + 1, **kw).float()
    plans = p0[:, None] + steps[None, :, None, None] * vel[:, None]   # [B, N, 5, 2]
    return dataclasses.replace(tpl, x0=start, xref=goal[:, None].expand(B, N, 3).contiguous(),
                               mov_obs=plans.contiguous())


def staged_vs_plain(ocp_b, X, U, lam, mu, cfg, plain_ms=None):
    """K4, K3, K5 and K6 on the card against their plain versions at the
    state (X [B, N+1, n], U, lam, mu): K4 on it, K3 on K4's output, K5 (the
    merits of cfg's alpha grid) and K6 (one alpha of the grid per scenario)
    on K3's gains, by the rule of nmpc_tpu_torch/ops/kernel_check.py: the
    CPU tests' tolerances, relative to each scenario's largest magnitude,
    plus for K3 and K6 the scenario's f32 spread; a rollout that diverges (a
    position or control beyond 10 in f64) is left out and counted. Returns
    (verdicts, {kernel: (kernel call, plain call)})."""
    import torch

    from nmpc_tpu_torch.ops.cuda_build import lane
    from nmpc_tpu_torch.ops.kernel_check import staged_vs_plain as check
    from nmpc_tpu_torch.solver.alilqr_batched import _mov_lanes

    B = ocp_b.x0.shape[0]
    grid = torch.tensor(cfg.alphas, device=mu.device)
    alpha = grid[torch.arange(B, device=mu.device) % len(cfg.alphas)]
    return check(ocp_b, lane(X[:, :-1]), lane(U), lane(ocp_b.xref), lane(lam), mu.contiguous(),
                 _mov_lanes(ocp_b, B), (0.0,) + tuple(cfg.alphas), alpha, cfg.reg,
                 plain_ms=plain_ms)


def first_vs_tiles(ocp_b, X, U, lam, mu, cfg):
    """The tile designs against their first designs (tools/staged_launch.py)
    on the same inputs: K4 at the state, K3 on K4's output, K5 (the merits
    of cfg's grid) and K6 (one alpha of the grid per scenario, as
    staged_vs_plain draws it) on K3's gains. Returns ({'K3': units that
    differ, 'K4': ..., 'K5': ..., 'K6': ...}, {'K3': (tile call,
    first-design call), ...}); a unit is a scenario (K5: a merit)."""
    import torch

    from nmpc_tpu_torch.ops import rollout as R
    from nmpc_tpu_torch.ops.cuda_build import lane
    from nmpc_tpu_torch.ops.expansions import expansions_fused
    from nmpc_tpu_torch.ops.riccati import riccati_lanes
    from nmpc_tpu_torch.solver.alilqr_batched import _mov_lanes
    from nmpc_tpu_torch.tools import staged_launch as SL

    B = ocp_b.x0.shape[0]
    X_l, U_l, xref_l, lam_l = lane(X[:, :-1]), lane(U), lane(ocp_b.xref), lane(lam)
    mov_l, alphas = _mov_lanes(ocp_b, B), (0.0,) + tuple(cfg.alphas)
    k4 = (X_l, U_l, xref_l, lam_l, mu.contiguous(), mov_l)
    calls = {"K4": (lambda: expansions_fused(ocp_b, *k4), lambda: SL.expansions_first(ocp_b, *k4))}
    new4, first4 = calls["K4"][0](), calls["K4"][1]()
    calls["K3"] = (lambda: riccati_lanes(new4, cfg.reg), lambda: SL.riccati_first(new4, cfg.reg))
    new3, first3 = calls["K3"][0](), calls["K3"][1]()
    args = (X_l[0].contiguous(), X_l, U_l, new3[0], new3[1], xref_l, lam_l, mu.contiguous())
    calls["K5"] = (lambda: R.linesearch_costs_lanes(ocp_b, *args, alphas, mov_l),
                   lambda: SL.linesearch_costs_first(ocp_b, *args, alphas, mov_l))
    new5, first5 = calls["K5"][0](), calls["K5"][1]()
    grid = torch.tensor(cfg.alphas, device=mu.device)
    alpha = grid[torch.arange(B, device=mu.device) % len(cfg.alphas)]
    k6 = (*args[:5], alpha)
    calls["K6"] = (lambda: R.rollout_alpha_lanes(ocp_b, *k6),
                   lambda: SL.rollout_alpha_first(ocp_b, *k6))
    new6, first6 = calls["K6"][0](), calls["K6"][1]()
    differ = lambda a, b: ~((a == b) | (a.isnan() & b.isnan()))  # noqa: E731

    def units(new, first):   # scenarios with any output entry that differs
        off = torch.zeros(B, dtype=torch.bool, device=mu.device)
        for a, b in zip(new, first):
            off |= differ(a, b).reshape(-1, B).any(dim=0)
        return int(off.sum())

    return {"K3": units(new3, first3), "K4": units(new4, first4), "K5": int(differ(new5, first5).sum()),
            "K6": units(new6, first6)}, calls


def step_clock(solve_fn):
    """solve_fn wrapped to stamp the host clock, after a device sync, as each
    solve starts: a loop step runs from one stamp to the next (the last to
    the loop's end). Returns (wrapped, stamps, inputs): inputs keeps the
    (problem, warm start) of the first two solves."""
    import torch

    stamps, inputs = [], []

    def wrapped(o, w):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        if len(inputs) < 2:
            inputs.append((o, w))
        return solve_fn(o, w)
    return wrapped, stamps, inputs


def step_ms(stamps, end) -> list:
    return [1e3 * (b - a) for a, b in zip(stamps, stamps[1:] + [end])]


def pct(xs, q) -> float:
    import numpy as np

    return float(np.percentile(np.asarray(xs), q))


def kernel_ms(run, module, names: dict):
    """run() with CUDA events around each call of the wrappers `names`
    ({attribute of module: label}) as the code under run() calls them;
    returns (run(), {label: ms summed over the calls}). The wrappers are
    restored."""
    import torch

    real = {k: getattr(module, k) for k in names}
    events = {k: [] for k in names}

    def evented(name):
        def wrapped(*args, **kw):
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            out = real[name](*args, **kw)
            e1.record()
            events[name].append((e0, e1))
            return out
        return wrapped

    for k in names:
        setattr(module, k, evented(k))
    try:
        out = run()
        torch.cuda.synchronize()
    finally:
        for k, f in real.items():
            setattr(module, k, f)
    return out, {names[k]: sum(e0.elapsed_time(e1) for e0, e1 in v) for k, v in events.items()}


def k1_k2_ms(run):
    """run() with CUDA events around each call of the megakernel route's K1
    and K2 wrappers (as solve_batched calls them); returns (run(), {'K1':
    ms summed over the calls, 'K2': ...}). The wrappers are restored."""
    from nmpc_tpu_torch.solver import alilqr_batched as AB

    return kernel_ms(run, AB, {"inner_solve_fused": "K1", "al_update_lanes": "K2"})


def closed_loop_phases(dev, base, card: str) -> None:
    """Phases 16-20: the per-scenario engine, the headline closed loop, the
    rt recipe, the obstacle waypoint loop on the staged route (and its
    first steps on the default route) and the fleet loop, each through the entry points a user calls, with the
    launch counts set to 0 just before each loop and read just after."""
    import torch

    from nmpc_tpu_torch.mpc import MPCConfig, closed_loop, closed_loop_waypoints, rt_closed_loop
    from nmpc_tpu_torch.ops import cuda_build
    from nmpc_tpu_torch.parallel import batch_ocp, batched_solve
    from nmpc_tpu_torch.scenarios import get
    from nmpc_tpu_torch.solver import ALILQRConfig, WarmStart, solve, solve_batched, solve_one
    from nmpc_tpu_torch.tools import fleet_loop as FL

    cpu = torch.device("cpu")
    staged = ("riccati_lanes", "expansions_fused", "linesearch_costs_lanes", "rollout_alpha_lanes")
    strong = ALILQRConfig(n_outer=15, n_inner=25, tol_con=1e-4)   # tests/test_mpc.py:70-96
    sc6 = get("six_robot_antipodal")
    head = sc6.make(device=dev)                                    # registry N=35, T=0.2

    # ---- phase 16: the per-scenario engine (plain PyTorch) on the card ------
    # Cold at 15x25 this problem does not converge and is path-sensitive: on
    # the CPU a 1e-7 move of x0 moves its cost by 0.85% and U by 2.9, and the
    # reference's own two engines part by 1.66e-2 in cost. Over the first two
    # outer steps (2x10, mu <= 100) the same move changes the cost by 1.1e-7
    # (tests/reference_spread.py). So the card is held against the CPU and
    # against solve_one there; the gap to solve_one over 5 outer steps of
    # 15x25's inner budget is printed
    short = ALILQRConfig(n_outer=2, n_inner=10)
    r16, r16c = solve(head, cfg=short), solve(head.to(cpu), cfg=short)
    cuda_build.reset_launch_counts()
    r1s = solve_one(head, cfg=short)
    c1 = dict(cuda_build.launch_counts)
    rel = abs(float(r16.cost) - float(r16c.cost)) / abs(float(r16c.cost))
    du = float((r16.U.cpu() - r16c.U).abs().max())
    rel1 = abs(float(r1s.cost) - float(r16.cost)) / abs(float(r16.cost))
    log(f"phase 16 solve (per-scenario engine) six_robot_antipodal N={head.N} {short.n_outer}x"
        f"{short.n_inner} on the card: against the CPU cost rel {rel:.3e} (rtol 1e-4), U max |err| "
        f"{du:.3e} (atol 5e-2); against solve_one (cascade, K1 and K2 at B=1, launches {c1}) cost "
        f"rel {rel1:.3e} (rtol 5e-3), U max |err| {float((r1s.U - r16.U).abs().max()):.3e}")
    assert r16.U.device.type == "cuda" and torch.isfinite(r16.X).all()
    assert rel <= 1e-4 and du <= 5e-2, (rel, du)
    assert c1["inner_solve_fused"] > 0 and rel1 <= 5e-3, (c1, rel1)
    # the engine's time an iteration over the first 5 of the 15 outer steps
    # (cut from all 15, 24.4 s on an H100 80GB HBM3 at 700 W; phase 17's
    # default engine times a whole 15x25 solve as its step 0)
    timing16 = dataclasses.replace(strong, n_outer=5)
    r16, t16 = timed(lambda: solve(head, cfg=timing16))
    r1 = solve_one(head, cfg=timing16)
    log(f"phase 16 solve {timing16.n_outer}x{timing16.n_inner} on the card: cost {float(r16.cost):.4f}, "
        f"viol {float(r16.viol):.3e}, {int(r16.inner_iters)} inner / {int(r16.outer_iters)} outer "
        f"iterations, {t16 * 1e3:.1f} ms ({t16 * 1e3 / max(int(r16.inner_iters), 1):.2f} ms an "
        f"iteration) {card}; engine line (not held: path-sensitive, above): solve_one cost "
        f"{float(r1.cost):.4f}, rel {abs(float(r1.cost) - float(r16.cost)) / abs(float(r16.cost)):.3e}")
    g16 = torch.Generator(device=dev).manual_seed(16)
    x64 = base.x0[None] + 0.1 * torch.randn((PER_SCENARIO_B, base.nx), generator=g16, device=dev)
    cfg16 = FL.SEED_CFG
    rb = batched_solve(batch_ocp(base, x64), cfg16)
    worst = (0.0, 0.0)
    same = 0
    t0 = time.perf_counter()
    for i in range(PER_SCENARIO_B):    # scenario by scenario
        ri = solve(dataclasses.replace(base, x0=x64[i]), cfg=cfg16)
        worst = (max(worst[0], abs(float(rb.cost[i]) - float(ri.cost)) / abs(float(ri.cost))),
                 max(worst[1], float((rb.U[i] - ri.U).abs().max())))
        same += int(rb.inner_iters[i]) == int(ri.inner_iters)
    log(f"phase 16 batched_solve B={PER_SCENARIO_B} six_robot_antipodal N=10 ({cfg16.n_outer}x"
        f"{cfg16.n_inner}) against solve on each of its {PER_SCENARIO_B} scenarios "
        f"({time.perf_counter() - t0:.1f} s): cost rel max {worst[0]:.3e} (rtol 1e-4), U max "
        f"|err| {worst[1]:.3e} (atol 5e-2), inner counts equal on {same}/{PER_SCENARIO_B}; "
        f"converged {float(rb.converged.float().mean()):.4f}")
    assert worst[0] <= 1e-4 and worst[1] <= 5e-2, worst

    # ---- phase 17: the headline closed loop through solve_one ---------------
    lib = cuda_build.load(6)
    n, nu = 18, 12
    need = 4 * (2 * n * n + nu * n + nu * nu + 15 + 2 * nu + 2 * n)
    slot = lib.nmpc_k1_slot_bytes(0)
    log(f"phase 17 K1's slot at m=6: {slot} B >= {need} B needed (stage-local blocks; the "
        f"horizon's X, U, gains and duals are in device memory, so N={head.N} needs no more)")
    assert slot >= need and slot % 16 == 0
    mpc17 = MPCConfig(max_steps=120, stop_tol=0.1, escape=True)
    fn, stamps, seen = step_clock(lambda o, w: solve_one(o, w, strong))
    torch.cuda.synchronize()
    cuda_build.reset_launch_counts()
    r17, k17 = k1_k2_ms(lambda: closed_loop(head, strong, mpc17, solve_fn=fn))
    ms17 = step_ms(stamps, time.perf_counter())
    c17 = dict(cuda_build.launch_counts)
    mean17 = sum(ms17) / len(ms17)
    X = r17.X_hist.cpu()
    travel = torch.hypot(*(X[-1].reshape(6, 3)[:, :2] - X[0].reshape(6, 3)[:, :2]).T)
    mind = float(r17.min_dist_hist.min())
    su = int(r17.steps_used)
    log(f"phase 17 headline closed loop six_robot_antipodal N={head.N} T=0.2 through solve_one "
        f"({strong.n_outer}x{strong.n_inner}, cascade): reached {bool(r17.reached)} in {su} steps "
        f"(CL_PARITY's engine column: 85), {len(stamps)} solves run; min pair distance {mind:.4f} "
        f"(>= 0.285), travel min {float(travel.min()):.3f} (> 1.5); per step p50 "
        f"{pct(ms17, 50):.2f} ms, p99 {pct(ms17, 99):.2f} ms, mean {mean17:.2f} ms = K1 "
        f"{k17['K1'] / len(stamps):.2f} + K2 {k17['K2'] / len(stamps):.3f} + the rest "
        f"{mean17 - sum(k17.values()) / len(stamps):.2f} (CUDA events around the wrappers); K1 "
        f"{per_step(c17, 'inner_solve_fused', stamps)} and K2 "
        f"{per_step(c17, 'al_update_lanes', stamps)} launches a step {card}")
    assert c17["inner_solve_fused"] > 0 and c17["al_update_lanes"] > 0, c17
    assert all(c17[k] == 0 for k in staged), c17
    assert bool(r17.reached) and mind >= 0.3 - 1.5e-2 and float(travel.min()) > 1.5, (mind, travel)
    assert torch.isfinite(r17.X_hist).all()
    hold_at_loop_shape("phase 17", *seen[1], strong)

    # the default engine (solve_fn=None: the per-scenario solve, plain
    # PyTorch) on the card: its first 3 steps at phase 16's 2x10 against the
    # CPU, X_hist atol 5e-3 (a 1e-7 move of x0 changes rows 0-3 by at most
    # 1.4e-4 there and row 4 by up to 0.11; tests/reference_spread.py). Its
    # step at the headline's 15x25 (~18-20 s, host-bound; not held: the same
    # move moves row 1 of X_hist by 0.37 there) is no longer timed here
    mpc3 = dataclasses.replace(mpc17, max_steps=3)
    ra, t_card = timed(lambda: closed_loop(head, short, mpc3))
    t0 = time.perf_counter()
    rc = closed_loop(head.to(cpu), short, mpc3)
    t_cpu = time.perf_counter() - t0
    dx = float((ra.X_hist.cpu() - rc.X_hist).abs().max())
    its3 = int(ra.iter_hist.sum())
    log(f"phase 17 default engine at {short.n_outer}x{short.n_inner}, first 3 steps ({its3} "
        f"iterations): card "
        f"{t_card * 1e3 / 3:.1f} ms a step ({t_card * 1e3 / its3:.2f} ms an iteration), CPU "
        f"{t_cpu * 1e3 / 3:.1f} ms a step, X_hist max |err| {dx:.3e} (atol 5e-3)")
    assert dx <= 5e-3, dx

    # ---- phase 18: the rt recipe through solve_one ---------------------------
    full18 = ALILQRConfig(n_outer=6, n_inner=12, tol_con=1e-4)
    rt18 = ALILQRConfig(n_outer=3, n_inner=10, tol_con=1e-3)
    mpc18 = MPCConfig(max_steps=120, stop_tol=sc6.stop_tol, escape=True)
    fn, stamps, seen = step_clock(lambda o, w: solve_one(o, w, rt18))
    torch.cuda.synchronize()
    cuda_build.reset_launch_counts()
    t0 = time.perf_counter()
    r18, k18 = k1_k2_ms(lambda: rt_closed_loop(head, full18, rt18, mpc18, solve_fn=fn))
    t_end = time.perf_counter()
    c18 = dict(cuda_build.launch_counts)
    ms18 = step_ms(stamps, t_end)
    k_ms = {k: v / len(stamps) for k, v in k18.items()}
    mean18 = sum(ms18) / len(ms18)
    su = int(r18.steps_used)
    mind = float(r18.min_dist_hist[: su + 1].min())
    mean_it = float(r18.iter_hist[:su].float().mean())
    log(f"phase 18 rt recipe six_robot_antipodal N={head.N} (seed: the per-scenario solve "
        f"{full18.n_outer}x{full18.n_inner}, {1e3 * (stamps[0] - t0):.1f} ms; then solve_one "
        f"{rt18.n_outer}x{rt18.n_inner} carried mu): reached {bool(r18.reached)} in {su} steps, "
        f"{len(stamps)} solves run; min distance {mind:.4f} (>= dmin - 1e-2), mean inner iterations "
        f"{mean_it:.2f} (< 25); per step p50 {pct(ms18, 50):.2f} ms, p99 {pct(ms18, 99):.2f} ms "
        f"against T = 200 ms; K1 {per_step(c18, 'inner_solve_fused', stamps)} and K2 "
        f"{per_step(c18, 'al_update_lanes', stamps)} launches a step; a mean step {mean18:.2f} ms = K1 "
        f"{k_ms['K1']:.2f} + K2 {k_ms['K2']:.3f} + the rest "
        f"{mean18 - sum(k_ms.values()):.2f} (CUDA events around the wrappers) {card}")
    assert all(c18[k] == 0 for k in staged) and c18["inner_solve_fused"] > 0, c18
    assert bool(r18.reached) and mind >= float(torch.sqrt(head.dmin2)) - 1e-2, mind
    assert mean_it < 25.0, mean_it
    hold_at_loop_shape("phase 18", *seen[1], rt18)

    # ---- phase 19: an obstacle waypoint loop on the staged route at B=1 ------
    sco = get("obstacle_scenario_1")
    obs1 = sco.make(device=dev)                                    # registry N=100
    # tests/test_mpc.py:23, on the staged route (phase 23 drives K1's
    # obstacle variant in the loops of the modes)
    fast = ALILQRConfig(n_outer=10, n_inner=20, tol_con=1e-4, mega=False)
    mpc19 = MPCConfig(max_steps=250, advance_tol=sco.advance_tol)
    fn, stamps, seen = step_clock(lambda o, w: solve_one(o, w, fast))
    torch.cuda.synchronize()
    cuda_build.reset_launch_counts()
    r19 = closed_loop_waypoints(obs1, sco.waypoint_array[:2], fast, mpc19, solve_fn=fn)
    torch.cuda.synchronize()
    ms19 = step_ms(stamps, time.perf_counter())
    c19 = dict(cuda_build.launch_counts)
    X = r19.X_hist.cpu()
    clear = float(torch.hypot(X[:, 0] - 0.4, X[:, 1] - 1.1).min())
    gidx = int(r19.goal_idx_hist[-1])
    log(f"phase 19 obstacle_scenario_1 N={obs1.N} waypoints 1-2 through solve_one (staged route, "
        f"B=1, {fast.n_outer}x{fast.n_inner}): {int(r19.steps_used)} steps of {mpc19.max_steps}, "
        f"{len(stamps)} solves run, goal index {gidx} (>= 1), clearance {clear:.4f} (>= 0.29); "
        f"launches {c19}; per step p50 {pct(ms19, 50):.2f} ms, mean {sum(ms19) / len(ms19):.2f} ms, "
        f"total {sum(ms19) / 1e3:.1f} s {card}")
    assert c19["inner_solve_fused"] == 0 and c19["al_update_lanes"] == 0, c19
    assert all(c19[k] > 0 for k in staged), c19
    assert clear >= 0.15 + 0.15 - 1e-2 and gidx >= 1, (clear, gidx)
    assert torch.isfinite(r19.X_hist).all()
    # the same loop on the default route (mega=True: K1's obstacle variant
    # and K2 at B=1, N=100), its first steps against the staged route's
    n19 = 40
    dflt = dataclasses.replace(fast, mega=True)
    fn, stamps_m, _ = step_clock(lambda o, w: solve_one(o, w, dflt))
    torch.cuda.synchronize()
    cuda_build.reset_launch_counts()
    r19m = closed_loop_waypoints(obs1, sco.waypoint_array[:2], dflt,
                                 MPCConfig(max_steps=n19, advance_tol=sco.advance_tol),
                                 solve_fn=fn)
    torch.cuda.synchronize()
    ms19m = step_ms(stamps_m, time.perf_counter())
    c19m = dict(cuda_build.launch_counts)
    st19 = ms19[:len(ms19m)]
    log(f"phase 19 the same loop on the default route (megakernel, B=1): its first "
        f"{int(r19m.steps_used)} steps, {len(stamps_m)} solves run; K1 "
        f"{per_step(c19m, 'inner_solve_fused', stamps_m)} and K2 "
        f"{per_step(c19m, 'al_update_lanes', stamps_m)} launches a step; per step p50 "
        f"{pct(ms19m, 50):.2f} ms, mean {sum(ms19m) / len(ms19m):.2f} ms against the staged "
        f"route's first {len(st19)} steps' p50 {pct(st19, 50):.2f} ms, mean "
        f"{sum(st19) / len(st19):.2f} ms {card}")
    assert all(c19m[k] == 0 for k in staged) and c19m["inner_solve_fused"] > 0, c19m
    assert c19m["al_update_lanes"] == c19m["inner_solve_fused"], c19m
    assert torch.isfinite(r19m.X_hist).all()
    # K3-K6 at the loop's own shape (B=1, N=100, one obstacle row): the
    # second step's solve re-run to its last iterate, held as phase 10 holds
    # the paths
    o, w = seen[1]
    ob19 = dataclasses.replace(o, x0=o.x0[None], xref=o.xref[None])
    w19 = WarmStart(*(torch.as_tensor(a, device=dev)[None] for a in (w.U, w.lam, w.mu)))
    r19b = solve_batched(ob19, w19, fast)
    hold_staged_kernels("phase 19 K3-K6 vs plain at the loop's shape", ob19, r19b, fast,
                        torch.Generator(device=dev).manual_seed(19))

    # ---- phase 20: the fleet loop at full width -------------------------------
    B, K = BENCH_B, 10
    g20 = torch.Generator(device=dev).manual_seed(20)
    runs = FL.timed_chunks(base, B, K, 3, g20)     # each chunk's counts set to 0 at its start
    for r in runs:
        c20 = r.launches
        assert 0 < c20["inner_solve_fused"] <= FL.RT_CFG.n_outer * K, c20
        assert 0 < c20["al_update_lanes"] <= FL.RT_CFG.n_outer * K, c20
        assert all(c20[k] == 0 for k in staged), c20
        assert torch.isfinite(r.out.x).all() and torch.isfinite(r.out.warm.U).all()
    # a fourth chunk with CUDA events around K1's and K2's wrappers: the
    # split of a fleet step (not in the rate)
    x0s = FL.jittered(base, B, g20)
    w = FL.seed(base, x0s)
    (_, k20), t_split = timed(lambda: k1_k2_ms(lambda: FL.chunk(base, x0s, w, K)))
    k_ms = {k: v / K for k, v in k20.items()}
    step_split = t_split * 1e3 / K
    rate = [B * K / r.seconds for r in runs]
    log(f"phase 20 fleet loop six_robot_antipodal N=10 B={B} K={K} (seed {FL.SEED_CFG.n_outer}x"
        f"{FL.SEED_CFG.n_inner} outside the clock, then {FL.RT_CFG.n_outer}x{FL.RT_CFG.n_inner} "
        f"carried mu): " + ", ".join(f"{r.seconds * 1e3:.1f}" for r in runs) + f" ms a chunk -> "
        f"median {statistics.median(rate):.1f} fleet-steps/s; K1, K2 launches a chunk "
        f"{[(r.launches['inner_solve_fused'], r.launches['al_update_lanes']) for r in runs]}; max "
        f"planned viol {max(float(r.out.max_viol) for r in runs):.3e}, mean inner iterations "
        f"{statistics.mean(float(r.out.mean_iters) for r in runs):.2f}, min realized pair distance "
        f"{min(float(r.out.min_dist) for r in runs):.4f} {card}; a step of a fourth chunk "
        f"{step_split:.2f} ms = K1 {k_ms['K1']:.2f} + K2 {k_ms['K2']:.3f} + the rest "
        f"{step_split - sum(k_ms.values()):.2f} (CUDA events around the wrappers)")
    x0s, w = runs[0].x0, runs[0].seed
    res = solve_batched(batch_ocp(base, x0s), w, FL.RT_CFG)   # the chunk's first step again
    sub = batch_ocp(base.to(cpu), x0s[:CROSS_B].to(cpu))
    warm = WarmStart(*(t[:CROSS_B].to(cpu) for t in (w.U, w.lam, w.mu)))
    cross_check("phase 20 the fleet's first step", res, sub, FL.RT_CFG, CROSS_B, warm=warm)


STAGED_NAMES = ("riccati_lanes", "expansions_fused", "linesearch_costs_lanes", "rollout_alpha_lanes")


def fresh_warm(ocp_b, g):
    """Warm inputs of the CPU tests' kind for ocp_b: controls 0.05 N(0, 1),
    duals |N(0, 0.5)| (zero on the masked stage-0 rows), mu in {10, 100}."""
    import torch

    from nmpc_tpu_torch.ocp import problem as P

    dev, B = ocp_b.device, ocp_b.x0.shape[0]
    U = 0.05 * torch.randn((B, ocp_b.N, ocp_b.nu), generator=g, device=dev)
    lam = 0.5 * torch.randn((B, ocp_b.N, ocp_b.n_con), generator=g, device=dev).abs()
    lam = lam * (P.constraint_mask(ocp_b) > 0)
    mu = torch.tensor([10.0, 100.0], device=dev)[torch.randint(0, 2, (B,), generator=g, device=dev)]
    return U, lam, mu


def hold_k1_spread(tag: str, ob, U, lam, mu, cfg, g, got=None, want=None,
                   merit=None) -> tuple:
    """K1 against its plain version at phase 3's tolerances (cost rtol 1e-4,
    U and Xs atol 5e-3, iteration counts equal) by phase 6's rule for
    horizons where f32 alone parts scenarios: the plain version against
    itself with its inputs moved by about an ulp shows how many; K1 may miss
    on at most twice as many plus 0.1%, its cost rtol 1e-4 alone likewise,
    and its iteration counts may differ on at most twice as many plus 1%.
    got / want: K1's and the plain version's results on these inputs where
    the caller has them; merit: the plain version's merit (default
    `al_merit`). Returns (K1's results, the largest |U error|, the plain
    version's count against itself)."""
    import torch

    from nmpc_tpu_torch.ops import megasolve

    B = ob.x0.shape[0]
    kw = {} if merit is None else {"merit": merit}
    if got is None:
        got = megasolve.inner_solve_fused(ob, ob.x0, ob.xref, lam, mu, U, cfg)
        torch.cuda.synchronize()
    if want is None:
        want = megasolve.inner_solve_plain(ob, ob.x0, ob.xref, lam, mu, U, cfg, **kw)
    ulp = lambda t: t * (1.0 + 2.0 ** -23 * torch.randn(t.shape, generator=g, device=t.device))  # noqa: E731
    spread = megasolve.inner_solve_plain(ob, ulp(ob.x0), ob.xref, lam, mu, ulp(U), cfg, **kw)
    n_spread = hold_solve("plain vs itself", spread, want, allow=1.0)[0]
    missed, rel, du, dx = hold_solve(tag, got, want, allow=1e-3 + 2 * n_spread / B)
    off = lambda a: int(((a[2] - want[2]).abs() > 1e-4 * want[2].abs()).sum())  # noqa: E731
    cost_missed, cost_spread = off(got), off(spread)
    other_it = lambda a: int((a[3] != want[3]).sum())  # noqa: E731
    it_missed, it_spread = other_it(got), other_it(spread)
    log(f"{tag}: outside cost rtol 1e-4 / U, Xs atol 5e-3 on {missed}/{B} scenarios (cost alone "
        f"on {cost_missed}; the plain version against itself with inputs moved by 2^-23: "
        f"{n_spread}, cost alone {cost_spread}); cost rel max {rel:.3e}, U max |err| {du:.3e}, "
        f"Xs max |err| {dx:.3e}; iteration counts differ on {it_missed}/{B} (the plain version "
        f"against itself: {it_spread})")
    assert cost_missed <= 1e-3 * B + 2 * cost_spread, (tag, cost_missed, cost_spread)
    assert it_missed <= 1e-2 * B + 2 * it_spread, (tag, it_missed, it_spread)
    return got, du, n_spread


def obstacle_kernel_phase(dev, ob_b, ob_c) -> dict:
    """Phase 21: K1's and K2's obstacle variant against their plain versions
    at phase 3's and phase 2's tolerances (K1 by phase 6's rule,
    hold_k1_spread: at N=100 f32 alone parts a few scenarios), on path (b)'s
    problem (obstacle_scenario_3, N=100, six static obstacles) at B=1024 and
    a ragged B=33, and on path (c)'s (robot_template(30, 0.1, 0.3, 6): five
    moving obstacles, per-scenario schedules) at B=4096, from warm inputs of
    the CPU tests' kind; K2 on K1's output. K1 is the route's (at m = 1 the
    team design); the warp design's obstacle variant (the route's K1 at m >=
    3, the A/B baseline at m <= 2, megasolve.warp_launch) is held the same
    way on the same inputs. Prints the variant's ptxas lines and holds the
    pair-only K1's. Returns the largest errors {'K1', 'K2', 'K1 warp'}."""
    import dataclasses

    import torch

    from nmpc_tpu_torch.ops import cuda_build
    from nmpc_tpu_torch.solver import ALILQRConfig

    for m in cuda_build.ROBOT_COUNTS:
        got = ptxas(cuda_build.build_info[m]["ptxas"])
        same = (*got["K1"], 0) == K1_PTXAS[m]
        log(f"phase 21 ptxas m={m}: K1's obstacle variant {got['K1 obs']}, K2's {got['K2 obs']} "
            f"(regs, stack, spill stores, spill loads; dynamic shared memory a slot "
            f"{cuda_build.load(m).nmpc_k1_slot_bytes(6 * m)} B at 6 m obstacle rows); the "
            f"pair-only K1 {got['K1']} as recorded: {'yes' if same else 'NO'}")
        assert same, (m, got["K1"])
    from nmpc_tpu_torch.ops import megasolve

    for m in cuda_build.TEAM_ROBOTS:
        lib = cuda_build.load(m)
        got = ptxas(cuda_build.build_info[m]["ptxas"])
        team = {k: got[k] for k in TEAM_KERNELS}
        same = team == K1_TEAM_PTXAS[m]
        log(f"phase 21 ptxas m={m}: K1's team design (csrc/inner_team.cuh, "
            f"{cuda_build.team_geometry(lib)}) {team} (regs, stack, spill stores, spill loads; a "
            f"team's ring {lib.nmpc_k1_team_ring_bytes(6 * m, 0, int(m > 1))} B at 6 m obstacle "
            f"rows, {lib.nmpc_k1_team_ring_bytes(47, 47, 0)} B at 47 moving rows); as recorded: "
            f"{'yes' if same else 'NO'}")
        assert same, (m, team)
    g = torch.Generator(device=dev).manual_seed(21)

    def head(ob, B):
        fields = {"x0": ob.x0[:B], "xref": ob.xref[:B]}
        if ob.mov_obs.dim() == 4:
            fields["mov_obs"] = ob.mov_obs[:B].contiguous()
        return dataclasses.replace(ob, **fields)

    errs = {"K1": [], "K2": [], "K1 warp": []}
    for tag, ob, ls in ((f"obstacle_scenario_3 N={ob_b.N} B={K1_B}", head(ob_b, K1_B), "adaptive"),
                        (f"obstacle_scenario_3 N={ob_b.N} B={K1_B}", head(ob_b, K1_B), "cascade"),
                        (f"obstacle_scenario_3 N={ob_b.N} B=33", head(ob_b, 33), "adaptive"),
                        (f"path (c) N={ob_c.N} B={ob_c.x0.shape[0]}, {ob_c.n_mov} moving obstacles",
                         ob_c, "adaptive")):
        U, lam, mu = fresh_warm(ob, g)
        cfg = ALILQRConfig(n_inner=4, ls=ls)
        cuda_build.reset_launch_counts()
        got, du, _ = hold_k1_spread(f"phase 21 K1's obstacle variant vs plain: {tag} ls={ls} "
                                    f"n_inner=4", ob, U, lam, mu, cfg, g)
        errs["K1"].append(du)
        errs["K2"].append(hold_k2(f"phase 21 K2's obstacle variant vs plain: {tag}, on K1's "
                                  f"output", ob, got[0], got[1], lam, mu, cfg.lam_max))
        c = cuda_build.launch_counts
        assert c["inner_solve_fused"] == 1 and c["al_update_lanes"] == 1, c
        warp = megasolve.warp_launch(ob, ob.x0, ob.xref, lam, mu, U, cfg, "inner_solve_fused",
                                     cuda_build.load, megasolve.K1_WARPS)
        torch.cuda.synchronize()
        errs["K1 warp"].append(hold_k1_spread(
            f"phase 21 K1's warp design, obstacle variant, vs plain: {tag} ls={ls} n_inner=4",
            ob, U, lam, mu, cfg, g, got=warp)[1])
    return {k: max(v) for k, v in errs.items()}


def phase22_paths(ob_b, obs_cfg, ob_c, mov_cfg) -> tuple:
    """Phase 22's paths: (tag, batch, staged config, least converged share,
    CPU scenarios, cross_check's criteria)."""
    return (("b", ob_b, obs_cfg, 0.9, OBS_CROSS_B,
             dict(cost_share=0.8, u_share=0.4, ratio_tol=1e-2)),
            ("c", ob_c, mov_cfg, 0.0, OBS_CROSS_B, dict()))


def team_vs_warp(args) -> tuple:
    """K1 through the route (the team design at m <= 2) against the warp
    design (megasolve.warp_launch, the A/B baseline) on the same inputs
    args of inner_solve_plain, single calls in turns (team, warp, warp,
    team) after a warm-up of each, on CUDA events: (team ms, warp ms)
    medians, and each run's ms."""
    from nmpc_tpu_torch.ops import cuda_build, megasolve
    from nmpc_tpu_torch.utils.timing import cuda_ms

    runs = {"team": lambda: megasolve.inner_solve_fused(*args),
            "warp": lambda: megasolve.warp_launch(*args, "inner_solve_fused", cuda_build.load,
                                                  megasolve.K1_WARPS)}
    for f in runs.values():
        f()
    out = {"team": [], "warp": []}
    for name in ("team", "warp", "warp", "team"):
        out[name].append(cuda_ms(runs[name], 1, warmup=0))
    return statistics.median(out["team"]), statistics.median(out["warp"]), out


def megakernel_paths_phase(dev, card, paths) -> dict:
    """Phase 22: paths (b) and (c) at full width on the megakernel route
    (K1's obstacle variant, at m = 1 its team design, and K2, one launch
    each an outer step), against the staged route on the same batch in
    turns (mega, staged, staged, mega); converged, violation p99, the first
    scenarios re-solved on the CPU; K1 at the first outer step's inputs
    (zero warm controls and duals, mu_init) against its bound (the
    iterations and line-search candidates the plain version needs,
    tools/roofline.py::kernel_work), against the warp design in turns
    (`team_vs_warp`), against the plain version summed in K1's order by
    phase 6's spread rule (the warp design likewise, against the plain
    version summed in its order), and with the plain version in both orders and the
    warp design against f64 (`hold_against_f64`: how often each leaves
    f64's path); K2 at the solve's last state. Then K1 against the warp
    design in turns at 47 rows (the consensus fleet's first round,
    tools/k1_launch.py::consensus_first_round). paths: [(tag, batch, staged
    config, least converged share, CPU scenarios, cross_check's criteria)]. Returns path
    (b)'s K1 record {launches, ms, plain_ms, bound_ms, bound_by}.

    The CPU re-solve of path (b) is held by outcome (cost within rtol 1e-4
    on 80%, U within 5e-3 on 40%, mean cost within 1%): phase 21 holds K1
    per call at N=100 within the plain version's own f32 spread, but over
    12 outer steps the card's paths part from the CPU's in the slalom's flat
    turn rates (the CPU route against itself in f64 keeps U within 5e-3 on
    only 26 of these 32 scenarios: tests/reference_spread.py obstacles), and
    on another draw of the batch one scenario of 32 settled in another local
    minimum (12.6% lower in cost, the mean cost ratio 0.9955). A control
    shows that these limits still see a fault: the same scenarios solved on
    the card with the most binding obstacle left out must miss them
    (`dropped_obstacle_control`)."""
    import dataclasses

    import torch

    from nmpc_tpu_torch.ops import cuda_build, megasolve
    from nmpc_tpu_torch.solver import ALILQRConfig, solve_batched
    from nmpc_tpu_torch.tools import k1_launch as K1L
    from nmpc_tpu_torch.tools import roofline as RL
    from nmpc_tpu_torch.utils.timing import cuda_ms

    cpu = torch.device("cpu")
    record = {}
    for tag, ob, scfg, conv_min, n_cpu, held in paths:
        B = ob.x0.shape[0]
        mcfg = dataclasses.replace(scfg, mega=True)
        cuda_build.reset_launch_counts()
        res, t_first = timed(lambda: solve_batched(ob, cfg=mcfg))
        c = dict(cuda_build.launch_counts)
        steps = int(res.outer_iters.max())
        assert c["inner_solve_fused"] == c["al_update_lanes"] == steps > 0, (tag, c)
        assert sum(c.values()) == 2 * steps, (tag, c)
        for name in ("X", "U", "cost", "viol", "lam"):
            assert torch.isfinite(getattr(res, name)).all(), (tag, name)
        conv = float(res.converged.float().mean())
        turns = {"mega": [], "staged": []}
        for route in ("mega", "staged", "staged", "mega"):
            cfg = mcfg if route == "mega" else scfg
            turns[route].append(timed(lambda: solve_batched(ob, cfg=cfg))[1] * 1e3)
        staged = solve_batched(ob, cfg=scfg)
        # K1 alone at the first outer step's inputs, against plain and its bound
        kw = dict(dtype=torch.float32, device=dev)
        args = (ob, ob.x0, ob.xref, torch.zeros((B, ob.N, ob.n_con), **kw),
                torch.full((B,), mcfg.mu_init, **kw), torch.zeros((B, ob.N, ob.nu), **kw), mcfg)
        k1_ms = cuda_ms(lambda: megasolve.inner_solve_fused(*args), 3)
        team_ms, warp_ms, turns_k1 = team_vs_warp(args)
        got = megasolve.inner_solve_fused(*args)
        got_warp = megasolve.warp_launch(*args, "inner_solve_fused", cuda_build.load,
                                         megasolve.K1_WARPS)
        cand = torch.zeros(B, dtype=torch.int64, device=dev)
        want, plain_ms = once(lambda: megasolve.inner_solve_plain(*args, candidates=cand))
        # K1 sums the merit in its own order (the team design: each stage in
        # row order, the stages by a compensated sum); over 25 iterations at
        # N=100 an order alone parts scenarios from the plain version's, so
        # K1 is held against the plain version summed in its order
        # (k1_merit_order), and all of them against the plain one in f64
        korder = k1_merit_order(ob)
        want_w = megasolve.inner_solve_plain(*args, merit=korder)
        g22 = torch.Generator(device=dev).manual_seed(22)
        n_spread = hold_k1_spread(
            f"phase 22 path ({tag}) K1 vs plain in K1's summation order at B={B}, the first "
            f"outer step's inputs", ob, args[5], args[3], args[4], mcfg, g22, got=got,
            want=want_w, merit=korder)[2]
        # the warp design (the A/B baseline) against plain in its own order
        hold_k1_spread(f"phase 22 path ({tag}) the warp design vs plain in its summation order "
                       f"at B={B}, the first outer step's inputs", ob, args[5], args[3], args[4],
                       mcfg, g22, got=got_warp, merit=megasolve.al_merit_warp_order)
        hold_against_f64(f"phase 22 path ({tag})", args, got, want, want_w, n_spread,
                         extra={"the warp design": got_warp})
        del want_w, got_warp
        run = RL.k1_executed(want[3], mcfg.n_inner)
        work = RL.kernel_work("K1", ob, B, mcfg, iters=int(run.sum()), candidates=int(cand.sum()))
        k1_bound, k1_by = RL.bound(*work)
        Xs = res.X[:, :-1].contiguous()
        k2_args = (ob, Xs, res.U, res.lam, res.mu, mcfg.lam_max)
        k2_ms = cuda_ms(lambda: megasolve.al_update_lanes(*k2_args), 10)
        k2_plain_ms = cuda_ms(lambda: megasolve.al_update_plain(*k2_args), 3)
        k2_bound, k2_by = RL.bound(*RL.kernel_work("K2", ob, B))
        mega_ms, staged_ms = statistics.median(turns["mega"]), statistics.median(turns["staged"])
        log(f"phase 22 path ({tag}) B={B} N={ob.N} {mcfg.n_outer}x{mcfg.n_inner} on the megakernel "
            f"route: launches {c} over {steps} outer steps; {summary(res)}; in turns (mega, staged, "
            f"staged, mega) " + ", ".join(f"{t:.1f}" for t in turns["mega"][:1] + turns["staged"]
                                         + turns["mega"][1:]) + f" ms -> medians mega "
            f"{mega_ms:.1f} ms, staged {staged_ms:.1f} ms ({staged_ms / mega_ms:.2f}x); the "
            f"staged route on the batch: {summary(staged)} {card}")
        log(f"phase 22 path ({tag}) K1 at the first outer step's inputs: {k1_ms:.3f} ms per launch "
            f"(mean of 3; the team design against the warp design in turns (team, warp, warp, "
            f"team) " + ", ".join(f"{t:.3f}" for t in turns_k1["team"][:1] + turns_k1["warp"]
                                 + turns_k1["team"][1:]) + f" ms -> medians {team_ms:.3f} / "
            f"{warp_ms:.3f} ms, {warp_ms / team_ms:.2f}x), plain {plain_ms:.1f} ms; "
            f"{float(run.float().mean()):.2f} iterations and "
            f"{float(cand.float().mean()):.2f} candidates needed per scenario; bound {k1_bound:.4f} "
            f"ms ({k1_by}), {100 * k1_bound / k1_ms:.2f}% of it reached; K2 at the solve's last "
            f"state {k2_ms:.3f} ms, plain {k2_plain_ms:.3f} "
            f"ms, bound {k2_bound:.4f} ms ({k2_by}), {100 * k2_bound / k2_ms:.2f}% {card}")
        assert conv >= conv_min, (tag, conv)
        sub = dataclasses.replace(ob, x0=ob.x0[:n_cpu], xref=ob.xref[:n_cpu])
        if ob.mov_obs.dim() == 4:
            sub = dataclasses.replace(sub, mov_obs=ob.mov_obs[:n_cpu])
        ref = cross_check(f"phase 22 path ({tag}) megakernel route", res, sub.to(cpu), mcfg,
                          n_cpu, **held)
        if ob.n_obs:
            dropped_obstacle_control(f"phase 22 path ({tag})", sub, ref, mcfg, n_cpu, held)
        if tag == "b":
            record = {"launches": c["inner_solve_fused"], "ms": k1_ms, "plain_ms": plain_ms,
                      "bound_ms": k1_bound, "bound_by": k1_by}
        del res, staged, got, want
    # K1 at 47 rows: the consensus fleet's first round, team against warp
    obc, lam_c, mu_c, U_c = K1L.consensus_first_round(SHARD_CONSENSUS_M, dev=dev)
    ccfg = ALILQRConfig(n_outer=6, n_inner=12, tol_con=1e-4)
    args = (obc, obc.x0, obc.xref, lam_c, mu_c, U_c, ccfg)
    team_ms, warp_ms, turns_k1 = team_vs_warp(args)
    cand = torch.zeros(obc.x0.shape[0], dtype=torch.int64, device=dev)
    want = megasolve.inner_solve_plain(*args, candidates=cand)
    bound_47, by_47 = RL.bound(*RL.kernel_work(
        "K1", obc, obc.x0.shape[0], ccfg, iters=int(RL.k1_executed(want[3], ccfg.n_inner).sum()),
        candidates=int(cand.sum())))
    log(f"phase 22 K1 at {megasolve.obstacle_rows(obc)} moving-obstacle rows (the consensus "
        f"fleet's first round, B={obc.x0.shape[0]}, N={obc.N}, cold): the team design against "
        f"the warp design in turns (team, warp, warp, team) "
        + ", ".join(f"{t:.3f}" for t in turns_k1["team"][:1] + turns_k1["warp"]
                    + turns_k1["team"][1:]) + f" ms -> medians {team_ms:.3f} / {warp_ms:.3f} "
        f"ms, {warp_ms / team_ms:.2f}x; bound {bound_47:.5f} ms ({by_47}), "
        f"{100 * bound_47 / team_ms:.3f}% of it reached {card}")
    return record


def hold_against_f64(tag: str, args, got, want, want_w, n_spread: int,
                     extra: dict | None = None) -> None:
    """K1's results (got), the plain version's (want) and the plain
    version's summed in K1's order (want_w) at the inputs args of
    inner_solve_plain, each against the plain version in f64, at phase 3's
    tolerances (`agree`). K1 must part from f64 on at most as many
    scenarios as the plain version in its order does, plus that version's
    own spread under a 2^-23 move of its inputs (n_spread) and 0.1%, and
    keep its cost within rtol 1e-4 of f64 on all but 0.1%. `extra`: other
    results {name: results} counted beside them (the leave rate is
    printed, not held)."""
    import dataclasses

    import torch

    from nmpc_tpu_torch.ops import megasolve

    ob, B = args[0], args[0].x0.shape[0]
    o64 = dataclasses.replace(ob, **{
        f.name: getattr(ob, f.name).double() for f in dataclasses.fields(ob)
        if isinstance(getattr(ob, f.name), torch.Tensor) and getattr(ob, f.name).is_floating_point()})
    exact = megasolve.inner_solve_plain(o64, *(a.double() for a in args[1:6]), args[6])
    exact = tuple(e.float() if e.is_floating_point() else e for e in exact)
    seen = {}
    for name, r in (("K1", got), ("plain", want), ("plain in K1's order", want_w),
                    *(extra or {}).items()):
        ok, rel, du, _ = agree(r, exact)
        seen[name] = int((~ok).sum())
        cost_off = int(((r[2] - exact[2]).abs() > 1e-4 * exact[2].abs()).sum())
        log(f"{tag} {name} vs plain in f64: outside cost rtol 1e-4 / U, Xs atol 5e-3 on "
            f"{seen[name]}/{B} (cost alone on {cost_off}); cost rel max {rel:.3e}, U max |err| "
            f"{du:.3e}")
        if name == "K1":
            assert cost_off <= 1e-3 * B, (tag, cost_off)
    assert seen["K1"] <= seen["plain in K1's order"] + n_spread + 1e-3 * B, (tag, seen, n_spread)


def dropped_obstacle_control(tag: str, sub, ref, cfg, n: int, held: dict) -> None:
    """A control of a loosened CPU cross-check: the card solves the same
    scenarios (sub, on the card) with the static obstacle that binds most in
    the CPU's solve (ref: the largest sum of its duals) left out, as a K1
    that skipped that obstacle's rows would; held against the CPU's solve of
    the whole problem, it must miss at least one of the criteria `held`
    that the sound route meets."""
    import dataclasses

    from nmpc_tpu_torch.solver import solve_batched

    i0, m, k = sub.n_pairs, sub.m, sub.n_obs
    lam = ref.lam[:, :, i0:i0 + m * k].reshape(ref.lam.shape[0], sub.N, m, k)
    j = int(lam.sum(dim=(0, 1, 2)).argmax())
    keep = [i for i in range(k) if i != j]
    drop = dataclasses.replace(sub, obstacles=sub.obstacles[keep].contiguous(), n_obs=k - 1)
    r = cross_measure(solve_batched(drop, cfg=cfg), ref, n)
    missed = cross_misses(r, n, **held)
    log(f"{tag} control: the card's route with obstacle {j} of {k} left out, against the CPU's "
        f"solve of the whole problem: {cross_line(r, n)}; criteria missed: {missed}")
    assert missed, (tag, "the cross-check does not see a dropped obstacle", r)


def modes_phase(dev, card) -> None:
    """Phase 23: the robot-parallel modes at the reference's full
    configurations, their subproblems on the megakernel route (K1's
    obstacle variant and K2): the decentralized six-robot antipodal loop
    (N=30, T=0.1, dmin 0.3, up to 500 steps; tests/test_parallel.py:102-122)
    and the consensus loops on six_robot_antipodal and ten_robot (N=20, 3
    rounds, 4x10; tests/test_consensus.py:156-188): arrival, clearance,
    steps, per-step p50/p99 (host clock, a sync at each step's first
    solve), launches a step. Then K1 and K2 against plain at each loop's own
    shape (B = m robots): from the loop's first (cold) warm start at phase
    3's tolerances, and from two mid-loop warm starts (steps 2 and 5) on
    the scenarios f32 resolves there (hold_k1_resolved)."""
    import math

    import torch

    from nmpc_tpu_torch.ops import cuda_build
    from nmpc_tpu_torch.parallel import consensus_closed_loop, decentralized_closed_loop
    from nmpc_tpu_torch.parallel import decentralized as TD
    from nmpc_tpu_torch.scenarios import get
    from nmpc_tpu_torch.solver import ALILQRConfig

    def circle(m):
        ang = torch.arange(m, dtype=torch.float64) * 2 * math.pi / m
        x0 = torch.stack([torch.cos(ang), torch.sin(ang), ang + math.pi], -1).float()
        goals = torch.stack([-torch.cos(ang), -torch.sin(ang), ang + math.pi], -1).float()
        return x0.reshape(-1).to(dev), goals.to(dev)

    loop_cfg = ALILQRConfig(n_outer=4, n_inner=10, tol_con=1e-4)
    six, ten = get("six_robot_antipodal"), get("ten_robot")
    c6, c10 = six.make(N=20, device=dev), ten.make(device=dev)
    loops = (
        ("decentralized six_robot_antipodal N=30 T=0.1 dmin 0.3 (12x25)", 1, 0.29, ALILQRConfig(),
         lambda: decentralized_closed_loop(*circle(6), N=30, T=0.1, dmin=0.3, max_steps=500,
                                           device=dev)),
        (f"consensus six_robot_antipodal N=20 T={float(c6.T):.2f} 3 rounds (4x10)", 3,
         float(torch.sqrt(c6.dmin2)) - 1.5e-2, loop_cfg,
         lambda: consensus_closed_loop(c6.x0, c6.xref[-1].reshape(6, 3), N=20, T=float(c6.T),
                                       dmin=float(torch.sqrt(c6.dmin2)), rounds=3, max_steps=150,
                                       cfg=loop_cfg, device=dev)),
        (f"consensus ten_robot N=20 T={float(c10.T):.2f} 3 rounds (4x10)", 3, ten.dmin - 1.5e-2,
         loop_cfg,
         lambda: consensus_closed_loop(c10.x0, c10.xref[-1].reshape(10, 3), N=20,
                                       T=float(c10.T), dmin=ten.dmin, rounds=3, max_steps=250,
                                       cfg=loop_cfg, device=dev)),
    )
    real = TD.solve_batched
    for tag, rounds, floor, cfg, run in loops:
        stamps, seen = [], []

        def stamped(ocp_b, warm, cfg_):
            torch.cuda.synchronize()
            stamps.append(time.perf_counter())
            seen.append((ocp_b, warm))
            return real(ocp_b, warm, cfg_)

        TD.solve_batched = stamped
        torch.cuda.synchronize()
        cuda_build.reset_launch_counts()
        try:
            t0 = time.perf_counter()
            X, U, mind, done = run()
            torch.cuda.synchronize()
            t_end = time.perf_counter()
        finally:
            TD.solve_batched = real
        counts = dict(cuda_build.launch_counts)
        starts = stamps[::rounds]                 # a step's first solve
        ms = step_ms(starts, t_end)
        n_steps = len(starts)
        md = float(mind.min())
        log(f"phase 23 {tag}: reached {bool(done)} after {n_steps} steps ({len(stamps)} solves, "
            f"{t_end - t0:.1f} s); min pair distance {md:.4f} (>= {floor:.3f}); per step p50 "
            f"{pct(ms, 50):.2f} ms, p99 {pct(ms, 99):.2f} ms, mean {sum(ms) / len(ms):.2f} ms; K1 "
            f"{counts['inner_solve_fused'] / n_steps:.2f} and K2 "
            f"{counts['al_update_lanes'] / n_steps:.2f} launches a step {card}")
        assert counts["inner_solve_fused"] > 0 and counts["al_update_lanes"] > 0, counts
        assert all(counts[k] == 0 for k in STAGED_NAMES), counts
        assert bool(done) and md >= floor and torch.isfinite(X).all(), (tag, bool(done), md)
        c4 = dataclasses.replace(cfg, n_inner=4)
        g = torch.Generator(device=dev).manual_seed(23)
        for when, (ob, w) in (("the first step's cold", seen[0]),
                              ("step 2's", seen[min(len(seen) - 1, 2 * rounds)]),
                              ("step 5's", seen[min(len(seen) - 1, 5 * rounds)])):
            what = (f"phase 23 {tag} K1 vs plain at the loop's shape (B={ob.x0.shape[0]}, N={ob.N}, "
                    f"{ob.n_mov} moving obstacles, {when} warm start, mu max {float(w.mu.max()):.3g},"
                    f" lam max {float(w.lam.max()):.3g})")
            if when.startswith("the first"):
                got = hold_k1(what, ob, w.U, w.lam, w.mu, c4)
            else:
                got = hold_k1_resolved(what, ob, w.U, w.lam, w.mu, c4, g)
            hold_k2(f"phase 23 {tag} K2 vs plain at the loop's shape, {when} warm start, on K1's "
                    f"output", ob, got[0], got[1], w.lam, w.mu, cfg.lam_max)


def hold_k1_resolved(tag: str, ob, U, lam, mu, cfg, g, draws: int = 3):
    """K1 against its plain version at phase 3's tolerances on the scenarios
    that f32 resolves: those where the plain version agrees with itself
    under at least one of `draws` independent moves of its inputs by about
    an ulp (a warm start carried through a loop can make a scenario's 4
    iterations chaotic: carried duals at a reset mu weigh the penalty by up
    to 1e5). K1 must agree on every resolved scenario; the unresolved ones,
    where every draw parts, are counted. Returns K1's results."""
    import torch

    from nmpc_tpu_torch.ops import megasolve

    B = ob.x0.shape[0]
    got = megasolve.inner_solve_fused(ob, ob.x0, ob.xref, lam, mu, U, cfg)
    torch.cuda.synchronize()
    want = megasolve.inner_solve_plain(ob, ob.x0, ob.xref, lam, mu, U, cfg)
    ulp = lambda t: t * (1.0 + 2.0 ** -23 * torch.randn(t.shape, generator=g, device=t.device))  # noqa: E731
    resolved = torch.zeros(B, dtype=torch.bool, device=ob.device)
    for _ in range(draws):
        spread = megasolve.inner_solve_plain(ob, ulp(ob.x0), ob.xref, lam, mu, ulp(U), cfg)
        resolved |= agree(spread, want)[0]
    held, rel, du, _ = agree(got, want)
    missed = int((resolved & ~held).sum())
    log(f"{tag}: resolved by f32 (the plain version agrees with itself under one of {draws} "
        f"2^-23 moves of its inputs) {int(resolved.sum())}/{B}; K1 outside cost rtol 1e-4 / U, "
        f"Xs atol 5e-3 on {missed} of them ({int((~held).sum())}/{B} in all; cost rel max "
        f"{rel:.3e}, U max |err| {du:.3e})")
    assert missed == 0 and all(torch.isfinite(t).all() for t in got[:3]), (tag, missed)
    return got


def family_i_phases(dev, card: str, base, bench_cfg) -> dict:
    """Phases 24-28: K3 at the ray-augmented stage shape; path (d), the
    hybrid route on a family-I batch; the scan sweep and compaction on the
    main path's problem; the lidar_v4 GN fleet; the lidar_v4 closed loop.
    Each through the entry points a user calls, with the launch counts set
    to 0 just before and read just after. Returns the K3 (13, 2) entry of
    the kernels' record."""
    import torch

    from nmpc_tpu_torch.ocp import problem as P
    from nmpc_tpu_torch.ops import cuda_build, kernel_check as KC, staged_tiles
    from nmpc_tpu_torch.ops import riccati as RIC
    from nmpc_tpu_torch.ops.cuda_build import lane
    from nmpc_tpu_torch.parallel import batch_ocp
    from nmpc_tpu_torch.solver import ALILQRConfig, gn, solve_batched
    from nmpc_tpu_torch.solver import alilqr_batched as AB
    from nmpc_tpu_torch.tools import lidar_fleet as LF
    from nmpc_tpu_torch.tools import roofline as RL
    from nmpc_tpu_torch.utils.timing import cuda_ms

    cpu = torch.device("cpu")
    # ---- phase 24: K3 at (n, nu) = (13, 2) --------------------------------
    shape_lines = {}
    for shape in ((13, 2),):   # the user models' shapes: phase 29
        info = cuda_build.k3_shape_build_info[shape]
        got = ptxas(info["ptxas"])
        shape_lines[shape] = (*got.get("K3", ()), staged_tiles.k3_layout(shape)["smem_bytes"])
        log(f"phase 24 ptxas K3 at (n, nu) = {shape} (csrc/riccati_shape.cu, S, D, T, P = "
            f"{dataclasses.astuple(staged_tiles.k3_geometry(shape))[:4]}): {ptxas_summary(info['ptxas'])}, "
            f"dynamic shared {shape_lines[shape][-1]} B a block (as recorded in PERF.md: "
            f"{'yes' if shape_lines[shape] == K3_SHAPE_PTXAS[shape] else 'NO'}; the pair-only "
            f"K3's lines held in phase 1)")
    assert shape_lines[13, 2] == K3_SHAPE_PTXAS[13, 2], shape_lines
    # path (d)'s problem: lidar_v2 at its registry N=100, its rays from one
    # scan of the circle, starts jittered by 0.05 in pose
    g = torch.Generator(device=dev).manual_seed(24)
    lid = LF.scanned("lidar_v2", [[0.5, 0.25, 0.15]], dev, ray_lo=0.3)
    ob_d = LF.jittered(lid, LIDAR_B, g)
    cfg_d = ALILQRConfig(n_outer=10, n_inner=20, tol_con=1e-3)   # nmpc_tpu/__main__.py:113-114
    kw = dict(dtype=torch.float32, device=dev)
    B, N = LIDAR_B, lid.N
    U0, lam0 = torch.zeros((B, N, lid.nu), **kw), torch.zeros((B, N, lid.n_con), **kw)
    mu0 = torch.full((B,), cfg_d.mu_init, **kw)
    # K3 against plain at the path's first launch's inputs (the cold start)
    # and at a mid-solve state (controls off rest, duals on)
    U1 = 0.05 * torch.randn((B, N, lid.nu), generator=g, device=dev)
    lam1 = 0.5 * torch.randn((B, N, lid.n_con), generator=g, device=dev).abs()
    lam1 = lam1 * (P.constraint_mask(lid) > 0)
    k3_err, exps = 0.0, []
    for tag, (U, lam, mu) in (("cold start", (U0, lam0, mu0)),
                              ("mid-solve", (U1, lam1, torch.full((B,), 100.0, **kw)))):
        exp = tuple(map(lane, AB.hybrid_expansions(ob_d, P.rollout(ob_d, U), U, lam, mu)))
        got = RIC.riccati_lanes(exp, cfg_d.reg)
        torch.cuda.synchronize()
        v = KC.Verdict()
        for i, (a, w, atol) in enumerate(zip(got, RIC.riccati_plain(exp, cfg_d.reg), KC.K3_ATOL)):
            KC.hold(v, f"K3 (13, 2) output {i} ({tag})", a, w, atol)
        assert v.units == B and v.n_widened == 0 and v.n_diverged == 0, (tag, v)
        k3_err = max(k3_err, v.err)
        exps.append(exp)
        log(f"phase 24 K3 at (13, 2) vs plain at path (d)'s {tag} inputs (B={B}, N={N}): max "
            f"|err| {v.err:.3e}, rel {v.rel:.3e} over {v.units} scenarios (kernel_check's rule)")
    k3_ms = cuda_ms(lambda: RIC.riccati_lanes(exps[0], cfg_d.reg), 5)
    k3_plain_ms = cuda_ms(lambda: RIC.riccati_plain(exps[0], cfg_d.reg), 1, warmup=0)
    b_ms, by = RL.bound(*RL.kernel_work("K3", ob_d, B))
    log(f"phase 24 K3 at (13, 2): {k3_ms:.3f} ms a launch (mean of 5), plain {k3_plain_ms:.1f} ms, "
        f"bound {b_ms:.4f} ms ({by}), {100 * b_ms / k3_ms:.2f}% of the bound reached {card}")
    del exps

    # ---- phase 25: path (d), the hybrid route on family I ----------------
    # one solve, timed on the host clock, with CUDA events around each K3
    # launch for the split
    torch.cuda.synchronize()
    cuda_build.reset_launch_counts()
    (res_d, split), t_d = timed(lambda: kernel_ms(lambda: solve_batched(ob_d, cfg=cfg_d), RIC,
                                                  {"riccati_lanes": "K3"}))
    c_d = dict(cuda_build.launch_counts)
    assert c_d["riccati_lanes"] > 0 and sum(c_d.values()) == c_d["riccati_lanes"], c_d
    for name in ("X", "U", "cost", "viol", "lam"):
        assert torch.isfinite(getattr(res_d, name)).all(), name
    assert res_d.X.shape == (B, N + 1, lid.nx) and res_d.U.shape == (B, N, lid.nu)
    conv_d = float(res_d.converged.float().mean())
    log(f"phase 25 path (d): lidar_v2 N={N} R={lid.num_rays} B={B} 10x20 (hybrid route: "
        f"expansions by jacfwd, K3 at (13, 2), plain rollouts of the 8 candidates): "
        f"{t_d * 1e3:.1f} ms -> {B / t_d:.1f} solves/s; launches {c_d}; converged {conv_d:.4f}, "
        f"viol p99 {float(torch.quantile(res_d.viol, 0.99)):.3e}, max "
        f"{float(res_d.viol.max()):.3e}, mean inner iters "
        f"{float(res_d.inner_iters.float().mean()):.2f}, outer max "
        f"{int(res_d.outer_iters.max())}; split (CUDA events around K3): K3 {split['K3']:.1f} ms "
        f"over {c_d['riccati_lanes']} launches ({100 * split['K3'] / (t_d * 1e3):.2f}%), the rest "
        f"{t_d * 1e3 - split['K3']:.1f} ms {card}")
    # the first scenarios re-solved by the same route's plain versions on the
    # CPU. The 10x20 recipe converges about half of them, and the plain path
    # alone, with x0 moved by 1e-7, keeps the cost within 1e-4 on only 5-7
    # of 8 such scenarios, moves it by up to 9.3e-3, flips up to one
    # converged flag and moves the mean cost by 1.3e-3
    # (`tests/reference_spread.py gn`, two batches of 8); K3's rounding is a
    # larger move than 1e-7. Held:
    # converged share within 2 scenarios, mean cost ratio within 5e-3, costs
    # within 1e-4 on at least a quarter
    sub_d = dataclasses.replace(ob_d, x0=ob_d.x0[:LIDAR_CROSS_B],
                                xref=ob_d.xref[:LIDAR_CROSS_B]).to(cpu)
    r_cross = cross_measure(res_d, solve_batched(sub_d, cfg=cfg_d), LIDAR_CROSS_B)
    log(f"phase 25 path (d) CPU cross-check: first {LIDAR_CROSS_B} scenarios re-solved by the "
        f"plain path on the CPU: {cross_line(r_cross, LIDAR_CROSS_B)}")
    assert abs(r_cross["conv_g"] - r_cross["conv_r"]) <= 2 / LIDAR_CROSS_B + 1e-9, r_cross
    assert abs(r_cross["mean_ratio"] - 1.0) <= 5e-3, r_cross
    assert r_cross["n_cost"] >= LIDAR_CROSS_B // 4, r_cross

    # ---- phase 26: the scan sweep and compaction on the main path's problem
    ob = batch_ocp(base, base.x0[None] + 0.1 * torch.randn((BENCH_B, base.nx), generator=g,
                                                          device=dev))
    res_m, t_m = timed(lambda: solve_batched(ob, cfg=bench_cfg))
    scan_cfg = dataclasses.replace(bench_cfg, sweep="scan")
    cuda_build.reset_launch_counts()
    res_s, t_s = timed(lambda: solve_batched(ob, cfg=scan_cfg))
    c_s = dict(cuda_build.launch_counts)
    it = c_s["linesearch_costs_lanes"]
    assert it > 0 and c_s["rollout_alpha_lanes"] == it and sum(c_s.values()) == 2 * it, c_s
    assert torch.isfinite(res_s.cost).all() and torch.isfinite(res_s.X).all()
    log(f"phase 26 sweep='scan' on the main path's problem (six_robot_antipodal N=10 B={BENCH_B}, "
        f"6x12; hybrid route: analytic expansions, the associative-scan LQR, K5 and K6): "
        f"{t_s * 1e3:.1f} ms, launches {c_s}; {summary(res_s)}; beside the main path "
        f"(megakernel route) {t_m * 1e3:.1f} ms, {summary(res_m)} {card}")
    comp_cfg = dataclasses.replace(bench_cfg, compact=True)
    times = {"compact": [], "plain": []}
    for tag in ("compact", "plain", "plain", "compact"):   # in turns
        cuda_build.reset_launch_counts()
        r, t = timed(lambda: solve_batched(ob, cfg=comp_cfg if tag == "compact" else bench_cfg))
        times[tag].append(t * 1e3)
        if tag == "compact":
            c_c, res_c = dict(cuda_build.launch_counts), r
    same = {k: torch.equal(getattr(res_c, k), getattr(res_m, k)) for k in (
        "X", "U", "cost", "viol", "lam", "mu", "inner_iters", "outer_iters", "converged")}
    log(f"phase 26 compact=True on the main path: every output bit for bit as compact=False: "
        f"{all(same.values())} {same}; launches {c_c}; ms in turns (compact, plain, plain, "
        f"compact): compact {times['compact']}, plain {times['plain']} {card}")
    assert all(same.values()), same
    del ob, res_m, res_s, res_c

    # ---- phase 27: the lidar_v4 GN fleet (tools/lidar_fleet.py) ----------
    fix = LF.fixture(dev)
    gn_runs = {}
    for Bg, normal in ((1024, "scan"), (4096, "scan"), (1024, "dense")):
        cfg_g = dataclasses.replace(LF.CFG, normal=normal)
        g27 = torch.Generator(device=dev).manual_seed(27)
        cuda_build.reset_launch_counts()
        if normal == "scan":   # after a warm-up batch, a batch of fresh starts
            (t_g, r_g), = LF.timed(fix, Bg, 1, g27, cfg_g)
        else:                  # the scan's timed batch (its generator's second draw), once
            LF.jittered(fix, Bg, g27)
            ob_g = LF.jittered(fix, Bg, g27)
            r_g, t_g = timed(lambda: gn.solve_batched(ob_g, cfg=cfg_g))
        assert not any(cuda_build.launch_counts.values())   # plain PyTorch: no kernel
        for name in ("X", "U", "cost", "viol"):
            assert torch.isfinite(getattr(r_g, name)).all(), name
        gn_runs[Bg, normal] = r_g
        log(f"phase 27 lidar_v4 GN fleet (N={fix.N}, Nc={LF.CFG.Nc}, 10x4) B={Bg} normal={normal}: "
            f"{t_g * 1e3:.1f} ms -> {Bg / t_g:.1f} solves/s; converged "
            f"{float(r_g.converged.float().mean()):.4f}, max viol {float(r_g.viol.max()):.3e}, "
            f"mean GN iters {float(r_g.inner_iters.float().mean()):.2f}"
            f"{'' if normal == 'scan' else ' (one call, no warm-up)'} {card}")
    # dense against scan on the same batch (the same draw): the reference's
    # criterion for the two forms, cost at rtol 1e-3 (tests/test_gn_lidar.py:240)
    a, b = gn_runs[1024, "scan"], gn_runs[1024, "dense"]
    rel = float(((a.cost - b.cost).abs() / b.cost.abs()).max())
    log(f"phase 27 dense against scan, B=1024, the same starts: cost rel max {rel:.3e} (mean "
        f"ratio {float(a.cost.mean() / b.cost.mean()):.6f}), U max |diff| "
        f"{float((a.U - b.U).abs().max()):.3e}")
    assert abs(float(a.cost.mean() / b.cost.mean()) - 1.0) <= 1e-3, rel
    del gn_runs, a, b

    # ---- phase 28: the lidar_v4 closed loop, CL_PARITY fixture, B=1 ------
    cuda_build.reset_launch_counts()
    r28, t28 = timed(lambda: LF.tour(dev, LIDAR_STEPS))
    assert not any(cuda_build.launch_counts.values())
    ms = r28["step_ms"]
    clr = float(r28["clearance"].min())
    log(f"phase 28 lidar_v4 closed loop (N=100, Nc=50, GN 10x4, CL_PARITY fixture, B=1), first "
        f"{LIDAR_STEPS} steps in {t28:.1f} s: waypoint index {int(r28['goal_idx'][-1])}, min "
        f"clearance {clr:.4f} (>= 0.15 - 1e-2; CL_PARITY's whole tour 0.242 in 271 steps), step "
        f"p50 {pct(ms, 50):.1f} ms, p99 {pct(ms, 99):.1f} ms (the whole tour: `python -m "
        f"nmpc_tpu_torch.tools.lidar_fleet tour`) {card}")
    assert torch.isfinite(r28["X"]).all() and clr >= 0.15 - 1e-2, clr
    return {"name": "riccati_lanes (13, 2)", "route": "cuda",
            "source": "nmpc_tpu_torch/csrc/riccati_shape.cu", "replaces":
            "nmpc_tpu/ops/riccati_pallas.py:311", "launches": c_d["riccati_lanes"],
            "max_abs_err": k3_err, "ms": k3_ms, "plain_ms": k3_plain_ms, "bound_ms": b_ms,
            "bound_by": by, "library_ms": None}


def user_model_phases(dev, card: str) -> list:
    """Phases 29-33: K3 at the user models' stage shapes; the generic path
    (make_generic_ocp batches on solve_batched's hybrid route); the ADMM
    fleet; the real-time loop over the native runtime; the CLI. Each through
    the entry points a user calls, with the launch counts set to 0 just
    before and read just after. Returns the K3 (2, 1) and (1, 1) entries of
    the kernels' record."""
    import contextlib
    import io as stdio
    import tempfile
    import threading

    import numpy as np
    import torch

    import nmpc_tpu_torch.__main__ as cli
    from nmpc_tpu_torch.io import (Bus, RobotBridge, UdpPublisher, UdpSubscriber, free_udp_port,
                                   run_realtime)
    from nmpc_tpu_torch.io.robot import CMD_BASE
    from nmpc_tpu_torch.mpc.driver import shift_warm
    from nmpc_tpu_torch.ocp import problem as P
    from nmpc_tpu_torch.ops import cuda_build, kernel_check as KC, staged_tiles
    from nmpc_tpu_torch.ops import riccati as RIC
    from nmpc_tpu_torch.ops.cuda_build import lane
    from nmpc_tpu_torch.parallel.batch import batched_solve
    from nmpc_tpu_torch.scenarios import get
    from nmpc_tpu_torch.sim.frames import se2_global_to_local
    from nmpc_tpu_torch.sim.plant import plant_step
    from nmpc_tpu_torch.solver import ALILQRConfig, solve_batched, solve_one
    from nmpc_tpu_torch.solver import alilqr_batched as AB
    from nmpc_tpu_torch.tools import admm_fleet as AF
    from nmpc_tpu_torch.tools import roofline as RL
    from nmpc_tpu_torch.tools import user_models as UM
    from nmpc_tpu_torch.utils import load_run
    from nmpc_tpu_torch.utils.timing import cuda_ms

    t_start = time.perf_counter()
    cpu = torch.device("cpu")
    models = {(2, 1): ("Van der Pol", UM.vdp_ocp), (1, 1): ("first-order process", UM.process_ocp)}
    # ---- phase 29: K3 at (2, 1) and (1, 1) ---------------------------------
    k3 = {}
    for shape, (label, make) in models.items():
        info = cuda_build.k3_shape_build_info[shape]
        line = (*ptxas(info["ptxas"]).get("K3", ()), staged_tiles.k3_layout(shape)["smem_bytes"])
        g = staged_tiles.k3_geometry(shape)
        log(f"phase 29 ptxas K3 at (n, nu) = {shape} ({label}; csrc/riccati_shape.cu, S, D, T, P = "
            f"{dataclasses.astuple(g)[:4]} by staged_tiles.k3_rule): {ptxas_summary(info['ptxas'])}, "
            f"dynamic shared {line[-1]} B a block (as recorded in PERF.md: "
            f"{'yes' if line == K3_SHAPE_PTXAS.get(shape) else 'NO'})")
        ob = UM.jittered(make(dev), USER_B, torch.Generator(device=dev).manual_seed(29))
        B, N = USER_B, ob.N
        kw = dict(dtype=torch.float32, device=dev)
        gen = torch.Generator(device=dev).manual_seed(30)
        U1 = 0.3 * torch.randn((B, N, ob.nu), generator=gen, device=dev)
        lam1 = 0.5 * torch.randn((B, N, ob.n_con), generator=gen, device=dev).abs()
        lam1 = lam1 * (P.constraint_mask(ob) > 0)
        err, exps = 0.0, []
        for tag, (U, lam, mu) in (
                ("cold start", (torch.zeros((B, N, ob.nu), **kw),
                                torch.zeros((B, N, ob.n_con), **kw),
                                torch.full((B,), UM.CFG.mu_init, **kw))),
                ("mid-solve", (U1, lam1, torch.full((B,), 100.0, **kw)))):
            exp = tuple(map(lane, AB.hybrid_expansions(ob, P.rollout(ob, U), U, lam, mu)))
            got = RIC.riccati_lanes(exp, UM.CFG.reg)
            torch.cuda.synchronize()
            v = KC.Verdict()
            for i, (a, w, atol) in enumerate(zip(got, RIC.riccati_plain(exp, UM.CFG.reg),
                                                 KC.K3_ATOL)):
                KC.hold(v, f"K3 {shape} output {i} ({tag})", a, w, atol)
            assert v.units == B and v.n_widened == 0 and v.n_diverged == 0, (shape, tag, v)
            err = max(err, v.err)
            exps.append(exp)
            log(f"phase 29 K3 at {shape} vs plain at the {label} batch's {tag} inputs (B={B}, "
                f"N={N}): max |err| {v.err:.3e}, rel {v.rel:.3e} over {v.units} scenarios "
                f"(kernel_check's rule)")
        ms = cuda_ms(lambda: RIC.riccati_lanes(exps[0], UM.CFG.reg), 20)
        plain_ms = cuda_ms(lambda: RIC.riccati_plain(exps[0], UM.CFG.reg), 1, warmup=0)
        b_ms, by = RL.bound(*RL.kernel_work("K3", ob, B))
        log(f"phase 29 K3 at {shape}: {ms:.4f} ms a launch (mean of 20), plain {plain_ms:.1f} ms, "
            f"bound {b_ms:.5f} ms ({by}), {100 * b_ms / ms:.2f}% of the bound reached {card}")
        k3[shape] = {"name": f"riccati_lanes {shape}", "route": "cuda",
                     "source": "nmpc_tpu_torch/csrc/riccati_shape.cu",
                     "replaces": "nmpc_tpu/ops/riccati_pallas.py:311", "launches": 0,
                     "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                     "bound_by": by, "library_ms": None}
        del exps
    for shape in models:   # every line logged before any is held
        line = (*ptxas(cuda_build.k3_shape_build_info[shape]["ptxas"]).get("K3", ()),
                staged_tiles.k3_layout(shape)["smem_bytes"])
        assert line == K3_SHAPE_PTXAS[shape], (shape, line)
    # K3 at k3_rule's other branches (staged_tiles.K3_SWEEP_SHAPES), each from
    # its own riccati_shape.cu library, against plain on random well-posed
    # stage blocks: a ragged B (4-byte copies) and a multiple of 4 (16-byte)
    gen = torch.Generator(device=dev).manual_seed(29)
    for shape in staged_tiles.K3_SWEEP_SHAPES:
        lib, g = cuda_build.load_k3_shape(*shape), staged_tiles.k3_geometry(shape)
        errs = []
        for B in (33, 300):
            exp = KC.k3_inputs(*shape, B, 5, gen)
            RIC.check_lanes(exp)
            got = RIC.launch(exp, 1e-6, lib)
            torch.cuda.synchronize()
            v = KC.Verdict()
            for i, (a, w, atol) in enumerate(zip(got, RIC.riccati_plain(exp, 1e-6), KC.K3_ATOL)):
                KC.hold(v, f"K3 {shape} B={B} output {i}", a, w, atol)
            assert v.units == B and v.n_widened == 0 and v.n_diverged == 0, (shape, B, v)
            errs.append(f"B={B} max |err| {v.err:.3e}, rel {v.rel:.3e}")
        log(f"phase 29 K3 at the rule's shape {shape} (S, D, T, P, spill = "
            f"{dataclasses.astuple(g)}; {ptxas_summary(cuda_build.k3_shape_build_info[shape]['ptxas'])}) "
            f"vs plain at N=5: {'; '.join(errs)} (kernel_check's rule)")

    # ---- phase 30: the generic path: make_generic_ocp fleets on the hybrid route
    for shape, (label, make) in models.items():
        base = make(dev)
        ob = UM.jittered(base, USER_B, torch.Generator(device=dev).manual_seed(31))
        torch.cuda.synchronize()
        cuda_build.reset_launch_counts()
        (res, split), t = timed(lambda: kernel_ms(lambda: solve_batched(ob, cfg=UM.CFG), RIC,
                                                  {"riccati_lanes": "K3"}))
        c = dict(cuda_build.launch_counts)
        assert c["riccati_lanes"] > 0 and sum(c.values()) == c["riccati_lanes"], c
        for name in ("X", "U", "cost", "viol", "lam"):
            assert torch.isfinite(getattr(res, name)).all(), name
        assert res.X.shape == (USER_B, base.N + 1, base.nx) and res.U.shape == (USER_B, base.N, 1)
        k3[shape]["launches"] = c["riccati_lanes"]
        conv = float(res.converged.float().mean())
        log(f"phase 30 generic path: {label} (nx={base.nx}, nu={base.nu}, N={base.N}, "
            f"{base.integrator}{' x' + str(base.substeps) if base.substeps > 1 else ''}) "
            f"B={USER_B} {UM.CFG.n_outer}x{UM.CFG.n_inner} tol {UM.CFG.tol_con:g} on the hybrid "
            f"route (expansions by jacfwd, K3 at {shape}, plain rollouts of the "
            f"{len(UM.CFG.alphas)} candidates): {t * 1e3:.1f} ms -> {USER_B / t:.1f} solves/s; "
            f"launches {c}; converged {conv:.4f}, viol p99 "
            f"{float(torch.quantile(res.viol, 0.99)):.3e}, max {float(res.viol.max()):.3e}, mean "
            f"inner iters {float(res.inner_iters.float().mean()):.2f}, outer max "
            f"{int(res.outer_iters.max())}; split (CUDA events around K3): K3 {split['K3']:.1f} ms "
            f"over {c['riccati_lanes']} launches ({100 * split['K3'] / (t * 1e3):.2f}%), the rest "
            f"{t * 1e3 - split['K3']:.1f} ms {card}")
        assert conv >= 0.99, conv
        # the first scenarios re-solved by the per-scenario engine on the
        # CPU (batched_solve: `solve` of each scenario, done masks): on the
        # CPU the two engines agree to cost rel 7e-7 and U 2e-5 on 16 such
        # starts of each model, so the batched criteria hold per scenario
        sub = dataclasses.replace(ob, x0=ob.x0[:USER_CROSS_B], xref=ob.xref[:USER_CROSS_B])
        ref = batched_solve(sub.to(cpu), cfg=UM.CFG)
        r = cross_measure(res, ref, USER_CROSS_B)
        log(f"phase 30 {label}: first {USER_CROSS_B} scenarios re-solved by the per-scenario "
            f"engine on the CPU: {cross_line(r, USER_CROSS_B)}")
        assert r["n_cost"] == r["n_u"] == USER_CROSS_B, r
        assert r["conv_g"] == r["conv_r"], r
        del ob, res

    # ---- phase 31: the ADMM fleet (tools/admm_fleet.py) ---------------------
    g31 = torch.Generator(device=dev).manual_seed(31)
    consts = AF.fleet_problem(dev)
    AF.fleet(*consts, *AF.draw(ADMM_B, g31, dev))   # warm-up
    runs = []
    cuda_build.reset_launch_counts()
    for _ in range(3):
        args = AF.draw(ADMM_B, g31, dev)
        out, t = timed(lambda: AF.fleet(*consts, *args))
        runs.append((t, args, out))
    assert not any(cuda_build.launch_counts.values())   # plain PyTorch: no kernel
    t31 = statistics.median(r[0] for r in runs)
    _, args, (z, _, its, done, prim) = runs[-1]
    assert torch.isfinite(z).all()
    conv31 = float(done.float().mean())
    nz = consts[0].shape[0]
    log(f"phase 31 ADMM fleet (tools/admm_fleet.py: LTV-MPC QP N={AF.N}, nz={nz}, rows="
        f"{(AF.N + 1) * AF.NX + nz}, max_iter {AF.CFG.max_iter}) B={ADMM_B}: setup + solve "
        f"{t31 * 1e3:.1f} ms a batch (median of 3: {', '.join(f'{r[0] * 1e3:.1f}' for r in runs)}) "
        f"-> {ADMM_B / t31:.1f} QPs/s; converged {conv31:.4f}, mean iterations "
        f"{float(its.float().mean()):.1f}, max prim res {float(prim.max()):.2e} {card}")
    assert conv31 >= 0.9, conv31
    ref31 = AF.fleet(*(c.to(cpu) for c in consts), *(a[:4].to(cpu) for a in args))
    dz = float((z[:4].cpu() - ref31[0]).abs().max())
    dit = (its[:4].cpu() - ref31[2]).abs()
    log(f"phase 31 the first 4 QPs against the port on the CPU: z max |diff| {dz:.3e}, "
        f"iterations {its[:4].tolist()} vs {ref31[2].tolist()}, converged {done[:4].tolist()} vs "
        f"{ref31[3].tolist()}")
    assert dz <= 2e-3 and torch.equal(done[:4].cpu(), ref31[3]), dz
    assert bool((dit <= 0.05 * ref31[2] + 2).all()), dit

    # ---- phase 32: the real-time loop over the native runtime ---------------
    sc = get("six_robot_impl")
    ocp = sc.make(device=dev)
    m, T = sc.m, float(ocp.T)
    full32 = ALILQRConfig(n_outer=6, n_inner=12, tol_con=1e-4)       # rt_closed_loop's defaults
    rt32 = ALILQRConfig(n_outer=3, n_inner=10, tol_con=1e-3)
    x_true = torch.tensor(sc.x0, dtype=torch.float64).reshape(m, 3)
    origins = x_true.clone()            # each robot's power-on frame: its start pose
    bus = Bus(210)
    udp_port = free_udp_port()
    sub_udp = UdpSubscriber(udp_port, bus)
    pub = UdpPublisher("127.0.0.1", udp_port)
    stop, robot_err, poses, last = threading.Event(), [], [x_true.clone()], [0]

    def odometry():
        for r in range(m):
            pub.send(r, se2_global_to_local(x_true[r], origins[r]).numpy())

    def robots():
        """The robots: each new set of commands on the bus (the last robot's
        topic stamped anew) drives the plant one period; each robot's
        odometry goes out in its own power-on frame over UDP."""
        try:
            while not stop.is_set():
                _, stamp = bus.latch(CMD_BASE + m - 1, 2)
                if stamp == last[0]:
                    time.sleep(2e-4)
                    continue
                last[0] = stamp
                u = torch.stack([torch.as_tensor(bus.latch(CMD_BASE + r, 2)[0])
                                 for r in range(m)]).reshape(2 * m)
                x_true.copy_(plant_step(x_true.reshape(-1), u, T)[0].reshape(m, 3))
                poses.append(x_true.clone())
                odometry()
        except BaseException as e:  # noqa: BLE001 (reported below)
            robot_err.append(repr(e))

    solve_ms = []
    state = {}

    def solve_step(x_joint):
        t0 = time.perf_counter()
        o = dataclasses.replace(ocp, x0=torch.as_tensor(x_joint, dtype=torch.float32, device=dev))
        res = solve_one(o, state["warm"], rt32)
        state["warm"] = shift_warm(res, rt32, mu_reset=False)
        u0 = res.U[0].cpu()
        solve_ms.append(1e3 * (time.perf_counter() - t0))
        return u0

    odometry()
    deadline = time.time() + 2.0
    while sub_udp.received < m and time.time() < deadline:
        time.sleep(0.01)
    assert sub_udp.received >= m, sub_udp.received
    th = threading.Thread(target=robots)
    th.start()
    torch.cuda.synchronize()
    cuda_build.reset_launch_counts()
    try:
        seed = solve_one(ocp, None, full32)   # the full-strength seed solve
        state["warm"] = shift_warm(seed, rt32, mu_reset=False)
        c_seed = dict(cuda_build.launch_counts)
        bridge = RobotBridge(m, bus, frame_origins=origins.numpy())
        xs, us, missed = run_realtime(solve_step, bridge, np.asarray(sc.x0), T, RT_PERIODS,
                                      goal=np.asarray(sc.x_goal), stop_tol=sc.stop_tol)
        time.sleep(0.05)
    finally:
        stop.set()
        th.join()
        pub.close()
        sub_udp.close()
        bus.close()
    c32 = dict(cuda_build.launch_counts)
    assert not robot_err, robot_err
    traj = torch.stack(poses)                                      # [S, m, 3]
    d = torch.cdist(traj[..., :2], traj[..., :2]) + 1e9 * torch.eye(m, dtype=traj.dtype)
    min_pair = float(d.amin())
    final_err = float(torch.linalg.norm(traj[-1].reshape(-1)
                                        - torch.tensor(sc.x_goal, dtype=traj.dtype)))
    log(f"phase 32 real-time loop over the native runtime: six_robot_impl (m={m}, N={ocp.N}, "
        f"T={T:g} s, v_max {sc.v_max}) through RobotBridge and run_realtime, robots as a host "
        f"thread (the plant) sending odometry in their power-on frames over UDP to "
        f"127.0.0.1:{udp_port}; seed solve_one {full32.n_outer}x{full32.n_inner} (launches "
        f"{c_seed['inner_solve_fused']} K1, {c_seed['al_update_lanes']} K2), then solve_one "
        f"{rt32.n_outer}x{rt32.n_inner} carried mu each period: {len(us)} periods (at most "
        f"{RT_PERIODS}), solve p50 {pct(solve_ms, 50):.2f} ms, p99 {pct(solve_ms, 99):.2f} ms "
        f"against T = {T * 1e3:.0f} ms, missed deadlines {missed}; min pair distance "
        f"{min_pair:.4f} (dmin {sc.dmin}), final error {final_err:.4f}; K1 "
        f"{c32['inner_solve_fused']}, K2 {c32['al_update_lanes']} launches {card}")
    assert len(us) > 0 and np.isfinite(us).all(), us
    assert min_pair >= sc.dmin - 0.05, min_pair
    assert c32["inner_solve_fused"] > c_seed["inner_solve_fused"] > 0, c32
    assert sum(c32.values()) == c32["inner_solve_fused"] + c32["al_update_lanes"], c32

    # ---- phase 33: the CLI, in-process --------------------------------------
    def run_cli(argv):
        buf = stdio.StringIO()
        torch.cuda.synchronize()
        cuda_build.reset_launch_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(argv)
        wall = time.perf_counter() - t0
        return rc, buf.getvalue(), dict(cuda_build.launch_counts), wall

    rc, out, c, _ = run_cli(["list"])
    assert rc == 0 and len(out.splitlines()) == 35, out
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "run.npz")
        for argv, want_rc, kern in (
                (["run", "six_robot_antipodal", "--engine", "fused", "--save", path], 0,
                 ("inner_solve_fused", "al_update_lanes")),
                (["run", "six_robot_antipodal", "--mode", "consensus"], 0,
                 ("inner_solve_fused", "al_update_lanes")),
                (["run", "obstacle_scenario_1", "--steps", "40"], 1,
                 ("inner_solve_fused", "al_update_lanes"))):
            rc, out, c, wall = run_cli(argv)
            summary = " | ".join(" ".join(line.split()) for line in out.splitlines())
            log(f"phase 33 python -m nmpc_tpu_torch {' '.join(argv)}: rc {rc} (expected {want_rc}) "
                f"in {wall:.1f} s; launches {c}; {summary}")
            assert rc == want_rc, (argv, rc, out)
            assert all(c[k] > 0 for k in kern), (argv, c)
            assert sum(c.values()) == sum(c[k] for k in kern), (argv, c)
        saved = load_run(path)
        log(f"phase 33 load_run of the saved run: {saved.summary()}")
        assert saved.reached and saved.meta == {"scenario": "six_robot_antipodal"}
    log(f"phases 29-33 took {time.perf_counter() - t_start:.1f} s")
    return [k3[shape] for shape in models]


def circle_fleet(m: int, radius: float, dev):
    """m robots on a circle of the radius, each bound for its antipode
    (tools/bench_consensus.py:53-63): (poses [m, 3], goals [m, 3])."""
    import math

    import torch

    ang = torch.arange(m, dtype=torch.float64) * 2 * math.pi / m
    c, s = radius * torch.cos(ang), radius * torch.sin(ang)
    poses = torch.stack([c, s, ang + math.pi], -1).float().to(dev)
    goals = torch.stack([-c, -s, ang + math.pi], -1).float().to(dev)
    return poses, goals


def sharded_phase(dev, card: str, base, bench_cfg) -> None:
    """Phase 34: the sharded forms (nmpc_tpu_torch/parallel/mesh.py,
    shard_ocp_batch, consensus_solve_sharded, decentralized_step_sharded,
    parallel/dryrun.py).

    (i) A one-rank world on NCCL on the card, at full width: the
    data-parallel main path (shard_ocp_batch, solve_batched through K1 and
    K2, the first control through the plant, the all-reduced mean cost),
    bit for bit against the unsharded solve, and its time beside the
    unsharded step's (median of 3, in turns); consensus at the reference's
    largest documented fleet (m=48, N=20, 5 rounds, engine "fused": K1's
    obstacle variant with 47 moving-obstacle rows, and K2), where no row
    binds, bit for bit against the single-program form; the same fleet
    packed to its keep-out, where the rows bind and the sharded form's roll
    order sums them in another order than the single-program form's, held
    at a tolerance of 10x the spread a 1e-7 move of x0 gives the
    single-program form itself; K1 and K2 against plain at the first
    round's shape with K1's share of its bound, and at B=1024 with four
    neighbours on each robot's way, every slot binding somewhere; the
    decentralized round at m=6, N=30 against
    decentralized_step (rh_bias=0, the per-scenario engine); the GN fleet
    (tools/lidar_fleet.py, B=1024) and the ADMM fleet (tools/admm_fleet.py,
    B=256) sharded, bit for bit against unsharded.

    (ii) A two-rank world on the same card: NCCL refuses two ranks on one
    card, so the ranks exchange through gloo (the mesh helpers copy the
    plans to the host for it) while both solve on the card; the dry run
    (dryrun_multichip) in both ranks, with K1 and K2 launched in each. The
    card's compute mode must let two processes share it."""
    import tempfile

    import numpy as np
    import torch
    import torch.distributed as dist

    from nmpc_tpu_torch.ocp import problem as P
    from nmpc_tpu_torch.ops import cuda_build, megasolve
    from nmpc_tpu_torch.parallel import consensus as TC
    from nmpc_tpu_torch.parallel import decentralized as TD
    from nmpc_tpu_torch.parallel import dryrun
    from nmpc_tpu_torch.parallel import mesh as M
    from nmpc_tpu_torch.parallel.batch import batch_ocp, shard_ocp_batch
    from nmpc_tpu_torch.solver import ALILQRConfig, gn, solve_batched
    from nmpc_tpu_torch.tools import admm_fleet, lidar_fleet
    from nmpc_tpu_torch.tools import k1_launch as K1L
    from nmpc_tpu_torch.tools import roofline as RL
    from nmpc_tpu_torch.utils.timing import cuda_ms

    t_phase = time.perf_counter()
    M.init_world("nccl", 0, 1, "file://" + os.path.join(tempfile.mkdtemp(prefix="nmpc_world_"),
                                                         "store"))
    try:
        mesh = M.data_mesh()
        # ---- the data-parallel main path ----
        g = torch.Generator(device=dev).manual_seed(34)
        ob = batch_ocp(base, base.x0[None] + 0.1 * torch.randn((BENCH_B, base.nx), generator=g,
                                                               device=dev))

        def sharded():
            r, x_loc, mean = dryrun.mpc_step(shard_ocp_batch(ob, mesh), bench_cfg, solve_batched,
                                             mesh)
            return r, M.gather_rows(r.U, mesh), M.gather_rows(x_loc, mesh), mean

        def unsharded():
            return dryrun.mpc_step(ob, bench_cfg, solve_batched)

        torch.cuda.synchronize()
        cuda_build.reset_launch_counts()
        r_loc, U_sh, x_sh, mean_sh = sharded()
        torch.cuda.synchronize()
        counts = dict(cuda_build.launch_counts)
        steps = int(r_loc.outer_iters.max())
        assert counts["inner_solve_fused"] == steps and counts["al_update_lanes"] == steps, counts
        assert sum(counts.values()) == 2 * steps, counts
        r_un, x_un, mean_un = unsharded()
        same = {"U": torch.equal(U_sh, r_un.U), "cost": torch.equal(r_loc.cost, r_un.cost),
                "x_next": torch.equal(x_sh, x_un)}
        conv = float(r_loc.converged.float().mean())
        viol_p99 = float(torch.quantile(r_loc.viol, 0.99))
        turns = {"sharded": [], "unsharded": []}
        for which in ("sharded", "unsharded", "unsharded", "sharded", "sharded", "unsharded"):
            turns[which].append(timed(sharded if which == "sharded" else unsharded)[1])
        t_sh, t_un = (statistics.median(turns[k]) for k in ("sharded", "unsharded"))
        log(f"phase 34 (i) one-rank NCCL world, data-parallel main path: six_robot_antipodal N=10 "
            f"B={BENCH_B} {bench_cfg.ls}: launches {counts} over {steps} outer steps; converged "
            f"{conv:.4f}, viol p99 {viol_p99:.3e}; bit for bit against the unsharded solve "
            f"{same}; mean cost {float(mean_sh):.6f} (all-reduced) vs {float(mean_un):.6f}; "
            f"step (shard, solve, plant, all-reduce, gathers) median of 3 in turns "
            f"{t_sh * 1e3:.2f} ms = {BENCH_B / t_sh:.1f} solves/s, unsharded {t_un * 1e3:.2f} ms = "
            f"{BENCH_B / t_un:.1f} solves/s, sharding overhead {(t_sh - t_un) * 1e3:.2f} ms "
            f"({100 * (t_sh - t_un) / t_un:.2f}%) {card}")
        assert all(same.values()), same
        assert conv >= 0.995 and viol_p99 <= 1e-3, (conv, viol_p99)
        torch.testing.assert_close(mean_sh, mean_un, rtol=1e-6, atol=0.0)
        del ob, r_loc, r_un, U_sh

        # ---- consensus at m=48 (tools/bench_consensus.py:38,84-93) ----
        m, N = SHARD_CONSENSUS_M, 20
        tpl = TD.robot_template(N, 0.1, 0.3, m, device=dev)
        ccfg = ALILQRConfig(n_outer=6, n_inner=12, tol_con=1e-4)
        poses, goals = circle_fleet(m, 0.16 * m, dev)
        rmesh = M.data_mesh(axis="robots")
        run = TC.consensus_solve_sharded(rmesh, tpl, ccfg, rounds=5, damping=0.5)
        torch.cuda.synchronize()
        cuda_build.reset_launch_counts()
        out_s = run(poses, goals)
        X, U, _, _, violh, deltah = out_s
        torch.cuda.synchronize()
        counts = dict(cuda_build.launch_counts)
        assert counts["inner_solve_fused"] > 0 and counts["al_update_lanes"] > 0, counts
        assert all(counts[k] == 0 for k in STAGED_NAMES), counts
        assert megasolve.obstacle_rows(tpl) == m - 1
        times = [timed(lambda: run(poses, goals))[1] for _ in range(3)]

        def joint(X_, U_, viol_, delta_, goals_):
            """(viol_hist, delta_hist, the joint tracking cost) of a joint solve."""
            e = X_[:, :-1] - goals_[:, None]
            cost = (torch.sum(e * e * tpl.Qdiag) + torch.sum(U_ * U_ * tpl.Rdiag)).double()
            return torch.cat([viol_.double(), delta_.double(), cost[None]])

        def single(poses_, goals_, dx=0.0):
            return TC.consensus_solve(tpl, poses_.reshape(-1) + dx, goals_, ccfg, rounds=5,
                                      damping=0.5)

        def against_single(poses_, goals_, sharded_out):
            """The sharded joint solve against the single-program form:
            (|difference|, the spread of three 1e-7 moves of x0, the
            tolerance 10x that spread with a floor of 1e-6 relative, the
            single-program joint vector, whether X and U are equal bit for
            bit, the active moving-obstacle rows at the end)."""
            Xs_, Us_, ws_, _, vs_, ds_ = sharded_out
            X1, U1, _, _, v1, d1 = single(poses_, goals_)
            want_ = joint(X1, U1, v1, d1, goals_)
            rng = np.random.default_rng(0)
            spread_ = torch.zeros_like(want_)
            for _ in range(3):
                dx = torch.tensor(1e-7 * rng.standard_normal(3 * m), dtype=torch.float32,
                                  device=dev)
                Xd, Ud, _, _, vd, dd = single(poses_, goals_, dx)
                spread_ = torch.maximum(spread_, (joint(Xd, Ud, vd, dd, goals_) - want_).abs())
            scale = torch.maximum(want_.abs(), torch.ones_like(want_))
            diff_ = (joint(Xs_, Us_, vs_, ds_, goals_) - want_).abs()
            bits = torch.equal(Xs_, X1) and torch.equal(Us_, U1)
            active = int((ws_.lam[:, :, :m - 1] > 0).sum())
            return diff_, spread_, torch.maximum(10 * spread_, 1e-6 * scale), want_, bits, active

        def hist(d):
            return (f"viol {float(d[:5].max()):.3e}, delta {float(d[5:10].max()):.3e}, cost "
                    f"{float(d[-1]):.3e}")

        # the reference's fleet (neighbours ~1 m apart, at most 0.44 m of
        # travel in the horizon): no row binds, every row's multiplier stays
        # 0 and its penalty exactly 0, so the order of the rows' sum is moot
        # and the sharded form must equal the single-program form bit for bit
        diff, spread, tol, want, bits, active = against_single(poses, goals, out_s)
        jv = float(TC.joint_pair_violation(X[:, :, :2], tpl.dmin2, N))
        log(f"phase 34 (i) consensus m={m} N={N} 5 rounds {ccfg.n_outer}x{ccfg.n_inner} engine "
            f"fused ({m - 1} moving-obstacle rows a robot), radius {0.16 * m:.2f} m: launches "
            f"{counts}; {statistics.median(times) * 1e3:.2f} ms a joint solve (median of 3, "
            + ", ".join(f"{t * 1e3:.1f}" for t in times) + f"); final joint pair violation "
            f"{jv:.3e}; viol history " + ", ".join(f"{float(v):.3e}" for v in violh)
            + "; delta history " + ", ".join(f"{float(v):.3e}" for v in deltah)
            + f"; joint cost {float(want[-1]):.6f}; rows with a positive multiplier at the end "
            f"{active}; X and U bit for bit against the single-program form: {bits}, "
            f"|sharded - single-program| max {float(diff.max()):.3e} ({hist(diff)}); the "
            f"spread of a 1e-7 move of x0 (3 draws): {hist(spread)} {card}")
        assert active == 0 and bits and bool((diff == 0).all()), (active, bits, diff)
        assert torch.isfinite(X).all() and torch.isfinite(U).all()

        # the same fleet packed to its keep-out (radius 0.05 m a robot:
        # neighbours 0.314 m apart against dmin 0.3, closing as they head
        # inward): pair rows bind from the first rounds, the sharded form's
        # roll order sums them in another order than the single-program
        # form's ascending one, and the joint solve is as sensitive as a 1e-7
        # move of x0 shows: held at 10x that spread (floor 1e-6 relative)
        pposes, pgoals = circle_fleet(m, 0.05 * m, dev)
        cuda_build.reset_launch_counts()
        out_p = run(pposes, pgoals)
        torch.cuda.synchronize()
        pcounts = dict(cuda_build.launch_counts)
        assert pcounts["inner_solve_fused"] > 0 and pcounts["al_update_lanes"] > 0, pcounts
        diff, spread, tol, want, bits, active = against_single(pposes, pgoals, out_p)
        log(f"phase 34 (i) consensus m={m}, packed fleet radius {0.05 * m:.2f} m: launches "
            f"{pcounts}; viol history " + ", ".join(f"{float(v):.3e}" for v in out_p[4])
            + "; delta history " + ", ".join(f"{float(v):.3e}" for v in out_p[5])
            + f"; joint cost {float(want[-1]):.6f}; rows with a positive multiplier at the end "
            f"{active} of {m * N * (m - 1)}; X and U bit for bit: {bits}; |sharded - "
            f"single-program| {hist(diff)} against the spread of a 1e-7 move of x0 (3 draws) "
            f"{hist(spread)}, U spread not bounded by it (the fleet bifurcates) -> tolerance "
            f"10x spread, floor 1e-6 relative {card}")
        assert active > 0, active
        assert bool((diff <= tol).all()), (diff, tol)
        assert torch.isfinite(out_p[0]).all() and torch.isfinite(out_p[1]).all()

        # K1 and K2 at the first round's shape, against plain; K1's share
        obc, lam_c, mu_c, U_c = K1L.consensus_first_round(m, N, dev=dev)
        c4 = dataclasses.replace(ccfg, n_inner=4)
        # at 47 rows the merit's summation order alone flips the rel <
        # tol_cost stop of a few robots (46/48 equal counts against the plain
        # version in its own order, with the warp design): K1 is held against
        # the plain version summed in K1's order, by phase 22's spread rule
        worder = k1_merit_order(obc)
        got4 = hold_k1_spread(
            f"phase 34 consensus m={m} K1 vs plain (summed in K1's order) at the first round's "
            f"shape (B={m}, N={N}, {m - 1} moving obstacles, cold, n_inner=4)", obc, U_c, lam_c,
            mu_c, c4, torch.Generator(device=dev).manual_seed(34), merit=worder)[0]
        hold_k2(f"phase 34 consensus m={m} K2 vs plain on K1's output", obc, got4[0], got4[1],
                lam_c, mu_c, ccfg.lam_max)
        args = (obc, obc.x0, obc.xref, lam_c, mu_c, U_c, ccfg)
        k1_ms = cuda_ms(lambda: megasolve.inner_solve_fused(*args), 3)
        cand = torch.zeros(m, dtype=torch.int64, device=dev)
        want_k1, plain_ms = once(lambda: megasolve.inner_solve_plain(*args, candidates=cand))
        executed = RL.k1_executed(want_k1[3], ccfg.n_inner)
        k1_bound, k1_by = RL.bound(*RL.kernel_work("K1", obc, m, ccfg, iters=int(executed.sum()),
                                                   candidates=int(cand.sum())))
        ring = cuda_build.load(1).nmpc_k1_team_ring_bytes(m - 1, m - 1, 0)
        teams = megasolve.K1_TEAM_WARPS * 32 // cuda_build.team_geometry(cuda_build.load(1))["T"]
        log(f"phase 34 consensus m={m} K1 (the team design, kObs, {m - 1} rows) at the first "
            f"round's inputs: {k1_ms:.3f} ms a launch (mean of 3), plain {plain_ms:.1f} ms; "
            f"{float(executed.float().mean()):.2f} iterations and "
            f"{float(cand.float().mean()):.2f} candidates a robot; bound {k1_bound:.5f} ms "
            f"({k1_by}), {100 * k1_bound / k1_ms:.3f}% of it reached; ring {ring} B a team, "
            f"{teams * ring} B of rings a block {card}")

        # K1 and K2 where the rows bind, against plain: tests/obstacle_cases.py's
        # consensus48 draws (scenario b is robot b % m, x0 moved by 0.02
        # N(0, 1); the others in roll order at their starts, four slots drawn
        # per scenario moved 0.25 m ahead of the robot, 0.1 N(0, 1) apart),
        # warm inputs of the CPU tests' kind, at B=K1_B: every one of the m-1
        # slots binds in some scenario
        gk = torch.Generator(device=dev).manual_seed(341)
        i = torch.arange(K1_B, device=dev) % m
        x0w = poses[i].clone()
        x0w[:, :2] += 0.02 * torch.randn((K1_B, 2), generator=gk, device=dev)
        nbr = (i[:, None] + torch.arange(1, m, device=dev)) % m
        movw = poses[nbr, :2][:, None].repeat(1, N, 1, 1)                  # [B, N, m-1, 2]
        ahead = x0w[:, :2] + 0.25 * torch.stack([torch.cos(x0w[:, 2]), torch.sin(x0w[:, 2])], -1)
        way = ahead[:, None, None] + 0.1 * torch.randn((K1_B, N, 4, 2), generator=gk, device=dev)
        slots = torch.argsort(torch.rand((K1_B, m - 1), generator=gk, device=dev), 1)[:, :4]
        movw.scatter_(2, slots[:, None, :, None].expand(K1_B, N, 4, 2), way)
        obw = dataclasses.replace(tpl, x0=x0w, xref=goals[i][:, None].repeat(1, N, 1),
                                  mov_obs=movw)
        Uw, lamw, muw = fresh_warm(obw, gk)
        gotw = hold_k1_spread(
            f"phase 34 consensus m={m} K1 vs plain (summed in K1's order) where the rows bind "
            f"(B={K1_B}, N={N}, {m - 1} moving obstacles, four on each robot's way, warm, "
            f"n_inner=4)", obw, Uw, lamw, muw, c4, gk, merit=worder)[0]
        hold_k2(f"phase 34 consensus m={m} K2 vs plain on K1's output where the rows bind", obw,
                gotw[0], gotw[1], lamw, muw, ccfg.lam_max)
        # K2's rows at K1's output: stages 0..N-1, stage 0's masked
        cw = P.stage_constraints(obw, gotw[0], gotw[1], movw)[..., :m - 1]
        live = P.constraint_mask(obw)[:, :m - 1] > 0
        binds = ((lamw[..., :m - 1] - muw[:, None, None] * cw > 0) & live).any(1)  # [B, m-1]
        per_slot = binds.sum(0)
        log(f"phase 34 consensus m={m} rows that bind at K1's output (lam - mu c > 0 at some "
            f"stage): {float(binds.sum(1).float().mean()):.2f} of {m - 1} a robot; every slot in "
            f"{int(per_slot.min())}-{int(per_slot.max())} of {K1_B} scenarios; rows violated "
            f"(c < 0) {int(((cw < 0) & live).sum())} of {cw.numel()}")
        assert bool((per_slot > 0).all()), per_slot

        # ---- the decentralized round at m=6, N=30 (tests/test_parallel.py:125-147) ----
        m, N = 6, 30
        tpl = TD.robot_template(N, 0.1, 0.3, m, device=dev)
        dcfg = ALILQRConfig(n_outer=6, n_inner=12, tol_con=1e-4)
        poses, goals = circle_fleet(m, 1.0, dev)
        plans = poses[:, None, :2].repeat(1, N + 1, 1)
        w = TD.cold_warms(tpl, m, dcfg)
        step = TD.decentralized_step_sharded(rmesh, tpl, dcfg)
        cuda_build.reset_launch_counts()
        (u, p), t_dec = timed(lambda: step(poses, goals, plans, w.U, w.lam, w.mu))
        assert not any(cuda_build.launch_counts.values())   # the per-scenario engine
        _, u1, p1 = TD.decentralized_step(tpl, poses.reshape(-1), goals, plans, w, dcfg,
                                          rh_bias=0.0, engine="xla")
        du = float((u - u1.reshape(m, 2)).abs().max())
        dp = float((p - p1).abs().max())
        log(f"phase 34 (i) decentralized round m={m} N={N} {dcfg.n_outer}x{dcfg.n_inner} (the "
            f"per-scenario engine, plain PyTorch on the card): {t_dec * 1e3:.1f} ms; against "
            f"decentralized_step (rh_bias=0, engine xla, neighbours in ascending order): u max "
            f"|err| {du:.3e}, plans {dp:.3e} (atol 1e-4) {card}")
        assert du <= 1e-4 and dp <= 1e-4, (du, dp)

        # ---- the GN and ADMM fleets on the mesh ----
        gbase = lidar_fleet.fixture(dev)
        obl = lidar_fleet.jittered(gbase, SHARD_GN_B, torch.Generator(device=dev).manual_seed(27))
        (r_sh, t_gn) = timed(lambda: gn.solve_batched(shard_ocp_batch(obl, mesh),
                                                      cfg=lidar_fleet.CFG))
        r_gn = gn.solve_batched(obl, cfg=lidar_fleet.CFG)
        same_gn = {"U": torch.equal(M.gather_rows(r_sh.U, mesh), r_gn.U),
                   "cost": torch.equal(M.gather_rows(r_sh.cost, mesh), r_gn.cost)}
        consts = admm_fleet.fleet_problem(dev)
        draws = admm_fleet.draw(SHARD_ADMM_B, torch.Generator(device=dev).manual_seed(31), dev)
        (z_sh, t_admm) = timed(lambda: admm_fleet.fleet(*consts, *(M.shard_rows(a, mesh)
                                                                  for a in draws)))
        z_un = admm_fleet.fleet(*consts, *draws)
        same_admm = {"z": torch.equal(M.gather_rows(z_sh[0], mesh), z_un[0]),
                     "iters": torch.equal(z_sh[2], z_un[2])}
        log(f"phase 34 (i) GN fleet lidar_v4 B={SHARD_GN_B} sharded {t_gn * 1e3:.1f} ms, converged "
            f"{float(r_sh.converged.float().mean()):.4f}, bit for bit against unsharded "
            f"{same_gn}; ADMM fleet B={SHARD_ADMM_B} sharded {t_admm * 1e3:.1f} ms, converged "
            f"{float(z_sh[3].float().mean()):.4f}, bit for bit {same_admm} {card}")
        assert all(same_gn.values()) and all(same_admm.values()), (same_gn, same_admm)
    finally:
        dist.destroy_process_group()
    t_one = time.perf_counter() - t_phase

    # ---- (ii) two ranks on the one card, exchanging through gloo ----
    mode = sh(["nvidia-smi", "--query-gpu=compute_mode", "--format=csv,noheader"]).splitlines()[0]
    assert mode.strip() == "Default", f"the card's compute mode {mode!r} forbids two processes"
    t0 = time.perf_counter()
    outs = dryrun.run_world(dryrun.dryrun_rank, 2, "gloo", "cuda")
    for rank, o in enumerate(outs):
        log(f"phase 34 (ii) two-rank world (gloo exchange, both ranks on cuda:0, compute mode "
            f"{mode.strip()}), rank {rank} dryrun_multichip: " + ", ".join(
                f"{k} {v:.3e}" for k, v in o["errs"].items()) + f"; launches {o['launches']}")
        assert o["launches"]["inner_solve_fused"] > 0 and o["launches"]["al_update_lanes"] > 0, o
        assert o["errs"] == outs[0]["errs"], (o["errs"], outs[0]["errs"])
        assert "hosts x chips" in o["errs"]
    log(f"phase 34 sharded forms: {time.perf_counter() - t_phase:.1f} s ((i) {t_one:.1f} s, "
        f"(ii) {time.perf_counter() - t0:.1f} s with the ranks' start-up) {card}")


# phase 35: the reference's closed-loop suite's cases it runs
# (nmpc_tpu_torch/tools/loop_suite.py): the escape-law fuzz at m=2 (K1's
# team design) and m=6 (its warp design)
SUITE_CASES = ("escape_fuzz_deterministic_m2", "escape_fuzz_deterministic_m6")


def loop_suite_phase(dev, card: str) -> None:
    """Phase 35: a bounded subset of the reference's closed-loop suite at
    full width through solve_one on the card (tools/loop_suite.py,
    tools/cl_parity.py), the launch counts set to 0 just before each loop
    and read just after: the deterministic escape-law fuzz at m=2 (seeds
    0-3, K1's team design) and m=6 (seeds 20-22, the warp design), each
    seed held to tests/test_escape_fuzz.py's invariants; obstacle_scenario_1's
    whole waypoint tour (N=100, K1's obstacle variant on the team design),
    held to CL_PARITY's outcome rule; then the benchmark (`bench.main()`)
    once, its JSON line logged."""
    import contextlib
    import io

    import numpy as np
    import torch

    from nmpc_tpu_torch import bench
    from nmpc_tpu_torch.tools import cl_parity as CP
    from nmpc_tpu_torch.tools import loop_suite as LS

    for name in SUITE_CASES:
        out = LS.run_case(name, dev)       # raises on a failed invariant or launch check
        for rec in out["loops"]:
            m, seed = rec["tag"]
            design = LS.k1_design(m)
            log(f"phase 35 {name} seed {seed}: reached {rec['reached']} in {rec['steps']} steps "
                f"(of 400), min pair distance {rec['min_dist']:.4f} (>= 0.27), max |theta| "
                f"{rec['max_theta']:.2f} (< 2 pi + 0.5); per step p50 {rec['p50_ms']:.2f} ms, p99 "
                f"{rec['p99_ms']:.2f} ms; K1 ({design} design) {rec['K1_per_step']:.2f} and K2 "
                f"{rec['K2_per_step']:.2f} launches a step {card}")
            assert rec["reached"] and rec[f"K1_{design}"] == rec["K1"] > 0 and rec["K2"] > 0, rec
    run = LS.Run(dev)
    tour = CP.engine_loop("obstacle_scenario_1", 1400, {}, run)
    ref = CP.load_rows()["obstacle_scenario_1"]
    fails = CP.judge("obstacle_scenario_1", tour, ref) + run.fails
    rec = tour["record"]
    log(f"phase 35 obstacle_scenario_1 tour N=100 through solve_one ({CP.ENGINE_CFG.n_outer}x"
        f"{CP.ENGINE_CFG.n_inner}): reached {tour['reached']} in {tour['steps']} steps (reference "
        f"engine {ref['e_steps']}, oracle {ref['o_steps']}), obstacle keep-out gap "
        f"{tour['obs_clear']:.4f}, final err {tour['final_err']:.4f}; per step p50 "
        f"{rec['p50_ms']:.2f} ms, p99 {rec['p99_ms']:.2f} ms; K1 (team design, obstacle variant) "
        f"{rec['K1_per_step']:.2f} and K2 {rec['K2_per_step']:.2f} launches a step {card}")
    assert not fails and tour["reached"], fails
    assert rec["K1_team"] == rec["K1"] > 0 and rec["K2"] > 0, rec
    assert np.isfinite(tour["X"]).all()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = bench.main()
    line = buf.getvalue().strip()
    got = json.loads(line)
    assert rc == 0 and len(line.splitlines()) == 1, line
    assert set(got) == {"metric", "value", "unit", "vs_baseline", "engine"}, got
    assert got["value"] > 0 and torch.cuda.is_available()
    log(f"phase 35 bench (python -m nmpc_tpu_torch bench): {line} {card}")


# phase 36: the ten-robot fleet's batch (tools/ten_robot.py, BASELINE config
# 5) and the K1 sub-batches held against plain (the fleet's, m=10; the
# line-search A/B's cascade arm, m=6); the latency graph's replays
TEN_B = 4096
TEN_HOLD_B = 64
CASCADE_HOLD_B = 256
GRAPH_REPLAYS = 5


def ref_tools_phase(dev, card: str) -> None:
    """Phase 36: the reference's measurement tools on the port (tools/
    latency.py, ten_robot.py, gate_check.py, ls_ab.py), each driven with
    the launch counts set to 0 just before it and read just after.
    (a) The latency tool's chunk (K=20 MPC steps of solve_one_graph, first
    control, plant, shift) for six_robot_antipodal at CFG_RT captured as one
    CUDA graph and replayed GRAPH_REPLAYS times, each replay bit for bit
    the same steps run eagerly (K1 and K2 launched one by one), each eager
    step bit for bit solve_one; K1/K2 launches a replay counted at capture.
    (b) ten_robot N=20 at B=TEN_B once (bench config; K1's warp design at
    m=10 and K2), then K1 against inner_solve_plain on TEN_HOLD_B of its
    scenarios at the first outer step (U 0, lam 0, mu mu_init), as hold_k1.
    (c) The megakernel gate on the seven admission shapes (route, K1's
    shared bytes a block against 227 KB, a 2x4 solve through K1 and K2).
    (d) The line-search A/B's cascade arm (ls_ab, B=BENCH_B, one solve)
    and its K1 against plain on CASCADE_HOLD_B of its scenarios at the
    first outer step, by phase 6's spread rule (n_inner=12)."""
    import torch

    from nmpc_tpu_torch.bench import jittered
    from nmpc_tpu_torch.ops import cuda_build
    from nmpc_tpu_torch.scenarios import get
    from nmpc_tpu_torch.solver.alilqr_batched import solve_batched
    from nmpc_tpu_torch.tools import gate_check as GC
    from nmpc_tpu_torch.tools import latency as LT
    from nmpc_tpu_torch.tools import ls_ab as LA
    from nmpc_tpu_torch.tools import ten_robot as TR

    t0 = time.perf_counter()
    ocp = get("six_robot_antipodal").make(device=dev)
    cuda_build.reset_launch_counts()
    g = LT.graph_against_eager(ocp, LT.CFG_RT, replays=GRAPH_REPLAYS)
    pr = g["per_replay"]
    assert pr["inner_solve_fused"] == LT.K * LT.CFG_RT.n_outer == pr["al_update_lanes"], pr
    assert g["designs"]["warp"] == pr["inner_solve_fused"], g
    log(f"phase 36 (a) latency chunk six_robot_antipodal N={ocp.N} CFG_RT "
        f"({LT.CFG_RT.n_outer}x{LT.CFG_RT.n_inner}, tightened), K={LT.K}: one CUDA graph "
        f"replayed {GRAPH_REPLAYS} times from jittered starts, every replay bit for bit the eager "
        f"chunk and every eager step bit for bit solve_one; launches a replay (at capture): K1 "
        f"{pr['inner_solve_fused']} (warp design), K2 {pr['al_update_lanes']}; launches since the "
        f"reset (replays and eager runs) {cuda_build.launch_counts['inner_solve_fused']} K1 "
        f"{card}")

    r = TR.measure(dev, TEN_B, iters=1)
    assert r["K1"] > 0 and r["K2"] > 0 and r["conv"] > 0.5, r
    assert math.isfinite(r["viol_p99"]) and math.isfinite(r["mean_inner"])
    log(f"phase 36 (b) ten_robot N={r['N']} B={r['B']} bench config: conv {r['conv']:.4f}, viol "
        f"p99 {r['viol_p99']:.2e}, max {r['viol_max']:.2e}, mean inner {r['mean_inner']:.1f}; "
        f"{r['ms_batch']:.1f} ms a batch ({r['solves_per_s']:.1f} solves/s); K1 (warp design, "
        f"m=10) {r['K1']}, K2 {r['K2']} launches a solve {card}")
    o10 = TR.base(dev)
    sub = jittered(o10, TEN_HOLD_B, torch.Generator(device=dev).manual_seed(10))
    kw = dict(dtype=torch.float32, device=dev)
    U = torch.zeros((TEN_HOLD_B, o10.N, o10.nu), **kw)
    lam = torch.zeros((TEN_HOLD_B, o10.N, o10.n_con), **kw)
    mu = torch.full((TEN_HOLD_B,), TR.CFG.mu_init, **kw)
    hold_k1(f"phase 36 (b) K1 vs plain: ten_robot N={o10.N} B={TEN_HOLD_B} "
            f"ls={TR.CFG.ls} n_inner={TR.CFG.n_inner}, first outer step", sub, U, lam, mu, TR.CFG)

    for name in GC.SHAPES:
        c = GC.check(name, dev)
        log(f"phase 36 (c) gate {name} (m={c['m']}, N={c['N']}): route {c['route']}, K1 "
            f"({c['k1_design']} design) {c['k1_smem_bytes']} B of shared memory a block (<= "
            f"{c['smem_limit']}), a {GC.CFG.n_outer}x{GC.CFG.n_inner} solve: K1 {c['K1']}, K2 "
            f"{c['K2']} launches, cost {c['cost']:.3f}")

    base = LA.bench_base(dev)
    cas = dataclasses.replace(LA.BASE_CFG, **LA.VARIANTS["cascade"])
    assert cas.ls == "cascade"
    gen = torch.Generator(device=dev).manual_seed(36)
    ob = jittered(base, BENCH_B, gen)
    cuda_build.reset_launch_counts()
    res = solve_batched(ob, cfg=cas)
    torch.cuda.synchronize()
    c = dict(cuda_build.launch_counts)
    assert c["inner_solve_fused"] == int(res.outer_iters.max()) == c["al_update_lanes"] > 0, c
    log(f"phase 36 (d) ls_ab cascade arm: six_robot_antipodal N=10 B={BENCH_B}: converged "
        f"{float(res.converged.float().mean()):.4f}, viol p99 "
        f"{float(torch.quantile(res.viol, 0.99)):.2e}, mean inner "
        f"{float(res.inner_iters.float().mean()):.2f}; K1 {c['inner_solve_fused']}, K2 "
        f"{c['al_update_lanes']} launches {card}")
    subc = dataclasses.replace(ob, x0=ob.x0[:CASCADE_HOLD_B], xref=ob.xref[:CASCADE_HOLD_B])
    U = torch.zeros((CASCADE_HOLD_B, base.N, base.nu), **kw)
    lam = torch.zeros((CASCADE_HOLD_B, base.N, base.n_con), **kw)
    mu = torch.full((CASCADE_HOLD_B,), cas.mu_init, **kw)
    hold_k1_spread(f"phase 36 (d) cascade K1 vs plain: six_robot_antipodal N=10 "
                   f"B={CASCADE_HOLD_B} n_inner={cas.n_inner}, first outer step", subc, U, lam,
                   mu, cas, gen)
    log(f"phase 36 took {time.perf_counter() - t0:.1f} s")


# phase 37: the batched LiDAR loop (mpc/lidar.py::closed_loop_lidar_batched,
# the reference fuzz's jax.vmap(closed_loop_lidar)) at the single-obstacle
# fuzz fields of seeds 0-3, the fuzz's N=40 and GN config, 8 steps. X_hist
# rows held pointwise at 1e-4 per seed where the reference itself moves by
# <= 1e-5 under a 1e-7 move of the start (`JAX_PLATFORMS=cpu python
# tests/reference_spread.py lidar_fuzz`: seed 0 <= 5.5e-6 over all 9 rows,
# seed 2 3.4e-6 over rows 0-1 then up to 2.2e-5, seeds 1 and 3 1.5e-4 and
# 1.7e-4 at the first solve), and every row of every seed at
# LIDAR_FUZZ_ALL_ATOL: above the reference's own spread over all rows (8.9e-4,
# seed 1) and the largest all-rows reading of a sound run on the card (4.3e-4
# against the per-seed loop, NVIDIA H100 80GB HBM3, 700.00 W), and below how
# far rows with different fields part (> 1e-2 in U,
# tests/test_torch_gn.py::test_per_scenario_scans_match_reference_vmap), so
# that a row solved with another row's points fails it
LIDAR_FUZZ_B = 4
LIDAR_FUZZ_STEPS = 8
LIDAR_FUZZ_HELD = (9, 1, 2, 1)
LIDAR_FUZZ_ALL_ATOL = 5e-3


def lidar_batch_phase(dev, card: str) -> None:
    """Phase 37: closed_loop_lidar_batched on the card at B=4 (one
    gn.solve_batched a step over the four rows, each with its own scan),
    held against the per-seed closed_loop_lidar on the card and against its
    own CPU run: pointwise at atol 1e-4 over LIDAR_FUZZ_HELD's rows and at
    LIDAR_FUZZ_ALL_ATOL over every row, by outcome over every step (the
    same goal index and done flag, each step's clearance within 1e-2); the
    launch counts set to 0 just before
    and read just after (the GN engine is plain PyTorch: none). Logs ms a
    step at B=4 and at B=1."""
    import torch

    from nmpc_tpu_torch.mpc.lidar import closed_loop_lidar
    from nmpc_tpu_torch.ops import cuda_build
    from nmpc_tpu_torch.scenarios import get
    from nmpc_tpu_torch.solver import gn
    from nmpc_tpu_torch.tools import lidar_fleet as LF
    from nmpc_tpu_torch.tools import loop_suite as LS

    t0 = time.perf_counter()
    B, S = LIDAR_FUZZ_B, LIDAR_FUZZ_STEPS
    torch.cuda.synchronize()
    cuda_build.reset_launch_counts()
    got, ms_b = LF.fuzz_steps(dev, B, S)
    counts = dict(cuda_build.launch_counts)
    assert not any(counts.values()), counts
    X, U, clr, gidx, done = got
    assert all(t.device.type == torch.device(dev).type for t in got)
    assert X.shape == (B, S + 1, 3) and U.shape == (B, S, 2) and gidx.dtype == torch.int32
    assert torch.isfinite(X).all() and torch.isfinite(clr).all()
    assert float(U[:, :, 0].abs().max()) <= 0.15 + 1e-6
    assert float(U[:, :, 1].abs().max()) <= 1.5 + 1e-6
    obstacles, goals = LS.lidar_fields(tuple(range(B)), 1)
    ocp = get("lidar_v4").make(N=LS.LIDAR_N, device=dev)
    ms_1, singles = [], []
    for i in range(B):
        stamps = []

        def solve_fn(o, w):
            torch.cuda.synchronize()
            stamps.append(time.perf_counter())
            return gn.solve(o, w, LS.LIDAR_CFG)

        singles.append(closed_loop_lidar(ocp, obstacles[i], goals[i], LS.LIDAR_CFG, S,
                                         solve_fn=solve_fn))
        torch.cuda.synchronize()
        end = time.perf_counter()
        ms_1 += [1e3 * (b - a) for a, b in zip(stamps, stamps[1:] + [end])]
    cpu_out, _ = LF.fuzz_steps(torch.device("cpu"), B, S)

    def hold(tag, rows):
        worst_pt, worst_clr, apart = 0.0, 0.0, []
        for i, (Xi, clri, gi) in enumerate(rows):
            held = LIDAR_FUZZ_HELD[i]
            diff = (X[i].cpu() - Xi.cpu()).abs()
            pt, every = float(diff[:held].max()), float(diff.max())
            dclr = float((clr[i].cpu() - clri.cpu()).abs().max())
            assert pt <= 1e-4, (tag, i, pt)
            assert every <= LIDAR_FUZZ_ALL_ATOL, (tag, i, every)
            assert torch.equal(gidx[i].cpu(), gi.cpu()), (tag, i)
            assert dclr <= 1e-2, (tag, i, dclr)
            worst_pt, worst_clr = max(worst_pt, pt), max(worst_clr, dclr)
            apart.append(every)
        return worst_pt, worst_clr, ", ".join(f"{a:.1e}" for a in apart)

    pt_1, clr_1, all_1 = hold("per seed", [(r[0], r[2], r[3]) for r in singles])
    assert [bool(r[4]) for r in singles] == done.cpu().tolist()
    pt_c, clr_c, all_c = hold("cpu", [(cpu_out[0][i], cpu_out[2][i], cpu_out[3][i])
                                      for i in range(B)])
    assert torch.equal(cpu_out[4], done.cpu())
    log(f"phase 37 batched LiDAR loop (closed_loop_lidar_batched, single-obstacle fuzz fields "
        f"seeds 0-{B - 1}, N={LS.LIDAR_N}, Nc={LS.LIDAR_CFG.Nc}, GN {LS.LIDAR_CFG.n_outer}x"
        f"{LS.LIDAR_CFG.n_gn}, {S} steps): against the per-seed loop on the card, X_hist max "
        f"|diff| {pt_1:.3e} over the held rows {LIDAR_FUZZ_HELD} (<= 1e-4), {all_1} over all "
        f"rows a seed (<= {LIDAR_FUZZ_ALL_ATOL}), clearance within {clr_1:.3e} (<= 1e-2), goal "
        f"index equal; against its own CPU run {pt_c:.3e}, {all_c} over all rows a seed, and "
        f"{clr_c:.3e}; launches {counts} (the GN engine is plain PyTorch)")
    log(f"phase 37 ms a step: B={B} p50 {pct(ms_b, 50):.1f}, p99 {pct(ms_b, 99):.1f}; B=1 "
        f"(closed_loop_lidar, {B} seeds) p50 {pct(ms_1, 50):.1f}, p99 {pct(ms_1, 99):.1f}; "
        f"{time.perf_counter() - t0:.1f} s with the CPU run {card}")


# phase 38: robot counts past the registry's. The megakernel route at m = 7
# and 9 (K1's warp design as at m <= 10) and 12 and 16 (lanes that own two
# state rows and two right-hand sides, three and four pair rows), each
# library built from csrc at its first use; the staged route at every one
# (K3's register-tile design at 12 and 16). The problems are
# scenarios/robot_counts.py's: the antipodal circle at 7 and 9 (N=10,
# T=0.2), ten_robot widened by columns at 12 and 16 (N=20). Phase 39: the
# hybrid route at m=12 (B=WIDE_HYBRID_B) and K3 at WIDE_K3_SHAPES, stage
# shapes past the team design's (30, 20) that no robot stack has, up to
# (80, 32).
WIDE_ROBOTS = (7, 9, 12, 16)
WIDE_B = 4096
WIDE_HOLD_B = 256
WIDE_HYBRID_B = 1024
WIDE_K3_SHAPES = ((36, 24), (41, 7), (50, 13), (64, 32), (80, 32))
# a static obstacle (ox, oy, r) ahead of the start of the m=12 crossing's
# third column, where its rows bind (~5% of the entries on the CPU at N=10):
# K1's and K2's obstacle variant there (phase 38 (b))
WIDE_OBSTACLE = (-0.5, -0.7, 0.15)
# the share of K5's and K6's units whose f64 rollout may leave the arena
# (kernel_check's DIVERGED) in phase 38 (c): 5%, where phase 10 allows 1% on
# paths (a)-(c). At the circle's staged last iterate, m=7, B=4096, its own
# multipliers, 1.19% of K5's and 1.17% of K6's units diverge in f64, the
# plain version's inputs alone (NVIDIA H100 80GB HBM3, 700.00 W): the staged
# route converges 71% of that batch, and mu grows to 1e4 on the rest. The
# diverged units are still held to kernel_check's rule for them (finite where
# the plain version is; K5's merit above its alpha-0 merit where f64's is).
WIDE_DIVERGED = 0.05
# K1's and K2's `-Xptxas -v` lines at the new m (regs, stack, spill stores,
# spill loads), both instantiations, as PERF.md records them; K3-K6's at
# each m (K3's register-tile design at 12 and 16) and K3's at WIDE_K3_SHAPES with
# the dynamic shared bytes of a block, as STAGED_PTXAS has them
WIDE_PTXAS = {7: {"K1": (96, 0, 0, 0), "K1 obs": (96, 32, 0, 0), "K2": (28, 0, 0, 0),
                  "K2 obs": (30, 0, 0, 0)},
              9: {"K1": (124, 104, 0, 0), "K1 obs": (124, 104, 0, 0), "K2": (28, 0, 0, 0),
                  "K2 obs": (30, 0, 0, 0)},
              12: {"K1": (171, 0, 0, 0), "K1 obs": (167, 0, 0, 0), "K2": (28, 0, 0, 0),
                   "K2 obs": (30, 0, 0, 0)},
              16: {"K1": (185, 288, 0, 0), "K1 obs": (180, 288, 0, 0), "K2": (27, 0, 0, 0),
                   "K2 obs": (32, 0, 0, 0)}}
WIDE_STAGED_PTXAS = {
    7: {"K3": (172, 0, 0, 0, 180544), "K4": (168, 32, 0, 0, 110000), "K5": (95, 200, 0, 0, 58704),
        "K6": (123, 32, 0, 0, 44800)},
    9: {"K3": (253, 0, 0, 0, 179136), "K4": (255, 32, 0, 0, 81328), "K5": (107, 248, 0, 0, 90448),
        "K6": (128, 32, 0, 0, 71424)},
    12: {"K3": (77, 0, 0, 0, 59200), "K4": (254, 32, 0, 0, 64928), "K5": (127, 272, 0, 0, 75648),
         "K6": (126, 32, 0, 0, 61440)},
    16: {"K3": (73, 0, 0, 0, 52000), "K4": (254, 32, 0, 0, 104976),
         "K5": (128, 352, 0, 0, 127472), "K6": (141, 32, 0, 0, 106496)},
    (36, 24): {"K3": (77, 0, 0, 0, 59200)}, (41, 7): {"K3": (79, 0, 0, 0, 49472)},
    (50, 13): {"K3": (75, 0, 0, 0, 39968)}, (64, 32): {"K3": (71, 0, 0, 0, 79904)},
    (80, 32): {"K3": (73, 0, 0, 0, 114080)},
}


# the nice value of the threads that build phases 38-41's libraries after
# phase 1 (and of the nvcc processes they start): phases 2-22 run beside
# these builds, and at equal priority their host-bound work shares the
# host's 8 cores with ~15 nvcc processes; so the builds take the cores
# those phases leave idle
BACKGROUND_NICE = 19


def background(fn, *args):
    """fn(*args) on this pool thread at BACKGROUND_NICE (Linux keeps a nice
    value a thread; the threads and processes it starts inherit it)."""
    os.setpriority(os.PRIO_PROCESS, threading.get_native_id(), BACKGROUND_NICE)
    return fn(*args)


def start_wide_builds() -> list:
    """Phase 38's libraries, the solver libraries at WIDE_ROBOTS and K3 at
    WIDE_K3_SHAPES, each part its own nvcc process, all started now (right
    after phase 1's builds) in the background: phases 2-37 leave the host's
    cores mostly to them, and phase 38 finds them built (49.4 s of nvcc wall
    time on the H100 machine's host when phase 38 started them itself).
    Returns the futures, which wide_build reads."""
    from nmpc_tpu_torch.ops import cuda_build

    pool = ThreadPoolExecutor(max_workers=len(WIDE_ROBOTS) + len(WIDE_K3_SHAPES))
    futures = [pool.submit(background, cuda_build.load, m) for m in WIDE_ROBOTS]
    futures += [pool.submit(background, cuda_build.load_k3_shape, *shape)
                for shape in WIDE_K3_SHAPES]
    pool.shutdown(wait=False)
    return futures


def wide_build(card: str, pending: list) -> dict:
    """Phase 38 (a): the libraries start_wide_builds started (waited for
    here); every K1 slot size against its mirror (megasolve.slot_bytes, the
    route's admission) and K1's block within 227 KB. Returns {m: {kernel:
    ptxas line}} (K3-K6 with their dynamic shared bytes) and {shape: {"K3":
    its line}}."""
    from nmpc_tpu_torch.ops import cuda_build, megasolve, staged_tiles
    from nmpc_tpu_torch.ops import rollout as R
    from nmpc_tpu_torch.solver import ALILQRConfig

    t0 = time.perf_counter()
    for f in pending:   # a build that failed raises here
        f.result()
    libs = {m: cuda_build.load(m) for m in WIDE_ROBOTS}
    lines = {}
    for m, lib in libs.items():
        text = cuda_build.build_info[m]["ptxas"]
        got = ptxas(text)
        want = {"K1", "K2", "K1 obs", "K2 obs", "K3", "K4", "K5", "K6", "K4 device", "K5 device"}
        k4 = cuda_build.k4_geometry(lib, staged_tiles.k4_rows(m, True, 0, 0),
                                    R._P(3 * m, 2 * m, 0).size)["smem_bytes"]
        k5 = cuda_build.k5_geometry(lib, staged_tiles.k5_rows(m, True, 0, 0),
                                    R._P(3 * m, 2 * m, 9).size)["smem_bytes"]
        smem = {"K3": cuda_build.k3_geometry(lib)["smem_bytes"], "K4": k4, "K5": k5,
                "K6": cuda_build.k6_geometry(lib)["smem_bytes"]}
        assert set(got) == want, (m, sorted(got))
        got.update({k: (*got[k], smem[k]) for k in smem})
        for k in ("K4 device", "K5 device"):   # phase 41 holds them
            got.pop(k)
        for rows in (0, m, 5 * m, 47):
            assert lib.nmpc_k1_slot_bytes(rows) == megasolve.slot_bytes(m, rows), (m, rows)
        block = megasolve.K1_WARPS * lib.nmpc_k1_slot_bytes(0) + 4 * R._P(
            3 * m, 2 * m, len(ALILQRConfig().alphas)).size
        assert block <= staged_tiles.SMEM_BLOCK_MAX, (m, block)
        lines[m] = got
        log(f"phase 38 (a) ptxas m={m}: {ptxas_summary(text)}; K1 {megasolve.K1_WARPS} warps x "
            f"{lib.nmpc_k1_slot_bytes(0)} B slot + parameters = {block} B a block (the slot "
            f"mirror of the route's admission agrees at 0, m, 5m and 47 obstacle rows); built in "
            f"{cuda_build.build_info[m]['seconds']:.1f} s")
    for shape in WIDE_K3_SHAPES:
        info = cuda_build.k3_shape_build_info[shape]
        lines[shape] = {"K3": (*ptxas(info["ptxas"])["K3"],
                               staged_tiles.k3_layout(shape)["smem_bytes"])}
        log(f"phase 38 (a) ptxas K3 at {shape} (the register-tile design, "
            f"{staged_tiles.k3_geometry(shape)}):"
            f" {ptxas_summary(info['ptxas'])}, dynamic shared {lines[shape]['K3'][-1]} B; built in "
            f"{info['seconds']:.1f} s")
    log(f"phase 38 (a) built m in {WIDE_ROBOTS} and K3 at {WIDE_K3_SHAPES} in the background "
        f"since phase 1 (parallel nvcc); phase 38 waited {time.perf_counter() - t0:.1f} s for "
        f"them {card}")
    return lines


def wide_solves(dev, card: str) -> list:
    """Phase 38 (b)-(d) at each m of WIDE_ROBOTS, each driven with the launch
    counts set to 0 just before it and read just after:
    (b) solve_batched at the bench config on WIDE_B starts of
    scenarios/robot_counts.py's problem (bench.jittered, bench.fleet: one
    solve for quality, two timed), the megakernel route, K1 in its warp
    design and K2; K1 against plain at n_inner=4 on WIDE_HOLD_B scenarios
    from a mid-solve warm state at phase 3's tolerances, K2 on K1's output
    at phase 2's; K1's ms at the first outer step and at the solve's
    converged state beside the plain version's and the bound
    (tools/roofline.py::kernel_work on the iterations and candidates the
    plain version needed), K2's beside its plain version's and bound.
    At m=12 also K1's and K2's obstacle variant against plain, with a
    static obstacle (WIDE_OBSTACLE) on the same starts.
    (c) the staged route (mega=False) on the same starts (K3's register-tile design
    at 12 and 16), then K3-K6 against plain on its last iterate at the
    tolerances of phase 10 (kernel_check's rule, at fresh and at the solve's
    own multipliers), with at most WIDE_DIVERGED of the units left out as
    diverged, each timed beside its plain version and bound.
    Returns the kernel rows of the record."""
    import torch

    from nmpc_tpu_torch.bench import fleet, jittered, quality
    from nmpc_tpu_torch.ocp import problem as P
    from nmpc_tpu_torch.ops import cuda_build, megasolve
    from nmpc_tpu_torch.parallel import batch_ocp
    from nmpc_tpu_torch.scenarios import robot_counts
    from nmpc_tpu_torch.solver import ALILQRConfig, solve_batched
    from nmpc_tpu_torch.solver.alilqr_batched import route
    from nmpc_tpu_torch.tools import roofline as RL
    from nmpc_tpu_torch.utils.timing import cuda_ms

    cfg = ALILQRConfig(n_outer=6, n_inner=12, tol_con=1e-3, ls="adaptive")
    rows = []

    def row(name, src, where, launches, err, ms_, plain_ms, work):
        b_ms, by = RL.bound(*work)
        rows.append({"name": name, "route": "cuda", "source": src, "replaces": where,
                     "launches": launches, "max_abs_err": err, "ms": ms_, "plain_ms": plain_ms,
                     "bound_ms": b_ms, "bound_by": by, "library_ms": None})
        return b_ms, by

    for m in WIDE_ROBOTS:
        t0 = time.perf_counter()
        base = robot_counts.make(m, device=dev)
        assert route(base, cfg) == "mega", m
        first, times, counts = fleet(base, cfg, WIDE_B, 2, design="warp", what=f"m={m}")
        q = quality(first)
        k1_n, k2_n = counts["inner_solve_fused"], counts["al_update_lanes"]
        assert k1_n > 0 and k2_n > 0 and q["conv"] > 0.5, (m, counts, q)
        assert math.isfinite(q["viol_p99"]) and math.isfinite(q["mean_inner"]), q
        log(f"phase 38 (b) {robot_counts.name(m)} m={m} N={base.N} B={WIDE_B} bench config: "
            f"converged {q['conv']:.4f}, viol p99 {q['viol_p99']:.2e}, mean inner "
            f"{q['mean_inner']:.2f}; {1e3 * min(times):.1f} ms a solve "
            f"({WIDE_B / min(times):.1f} solves/s; timed {', '.join(f'{1e3 * t:.1f}' for t in times)}"
            f" ms); launches a solve K1 {k1_n} (warp design), K2 {k2_n} {card}")

        # K1 and K2 against plain from a mid-solve warm state
        g = torch.Generator(device=dev).manual_seed(38 + m)
        sub = jittered(base, WIDE_HOLD_B, g)
        U = 0.05 * torch.randn((WIDE_HOLD_B, base.N, base.nu), generator=g, device=dev)
        lam = 0.5 * torch.randn((WIDE_HOLD_B, base.N, base.n_con), generator=g, device=dev).abs()
        lam = lam * (P.constraint_mask(base) > 0)
        mu = torch.tensor([10.0, 100.0, 1e3, 1e4], device=dev)[
            torch.randint(0, 4, (WIDE_HOLD_B,), generator=g, device=dev)]
        c4 = dataclasses.replace(cfg, n_inner=4)
        errs = []
        got = hold_k1(f"phase 38 (b) K1 vs plain m={m} N={base.N} B={WIDE_HOLD_B} n_inner=4, "
                      f"mid-solve warm state", sub, U, lam, mu, c4, errs)
        k2_err = hold_k2(f"phase 38 (b) K2 vs plain m={m} on K1's output", sub, got[0], got[1],
                         lam, mu, cfg.lam_max)

        # K1's times at the first outer step and at the converged state of the
        # fleet's first solve (its batch drawn again from the same seed)
        ob = jittered(base, WIDE_B, torch.Generator(device=dev).manual_seed(0))
        kw = dict(dtype=torch.float32, device=dev)
        states = {"first step": (torch.zeros((WIDE_B, base.N, base.n_con), **kw),
                                 torch.full((WIDE_B,), cfg.mu_init, **kw),
                                 torch.zeros((WIDE_B, base.N, base.nu), **kw)),
                  "converged": (first.lam, first.mu, first.U)}
        k1 = {}
        for state, (lam_s, mu_s, U_s) in states.items():
            args = (ob, ob.x0, ob.xref, lam_s, mu_s, U_s, cfg)
            ms_ = cuda_ms(lambda: megasolve.inner_solve_fused(*args), 3)
            cand = torch.zeros(WIDE_B, dtype=torch.int64, device=dev)
            want, plain_ms = once(lambda: megasolve.inner_solve_plain(*args, candidates=cand))
            run = RL.k1_executed(want[3], cfg.n_inner)
            work = RL.kernel_work("K1", base, WIDE_B, cfg, iters=int(run.sum()),
                                  candidates=int(cand.sum()))
            k1[state] = (ms_, plain_ms, work, float(run.float().mean()),
                         float(cand.float().mean()))
            del want
        ms0, plain0, work0 = k1["first step"][:3]
        b0, by0 = row(f"inner_solve_fused m={m}", "nmpc_tpu_torch/csrc/inner_warp.cuh",
                      "nmpc_tpu/ops/megasolve_pallas.py:911", k1_n, errs[0], ms0, plain0, work0)
        b1, by1 = RL.bound(*k1["converged"][2])
        Xs1, U1 = first.X[:, :-1].contiguous(), first.U
        k2_args = (ob, Xs1, U1, first.lam, first.mu, cfg.lam_max)
        k2_ms = cuda_ms(lambda: megasolve.al_update_lanes(*k2_args), 20)
        k2_plain = cuda_ms(lambda: megasolve.al_update_plain(*k2_args), 3)
        b2, by2 = row(f"al_update_lanes m={m}", "nmpc_tpu_torch/csrc/inner_warp.cuh",
                      "nmpc_tpu/ops/megasolve_pallas.py:870", k2_n, k2_err, k2_ms, k2_plain,
                      RL.kernel_work("K2", base, WIDE_B))
        if m == 12:   # K1's and K2's obstacle variant, the route's K1 for any obstacle problem
            obase = P.make_ocp(**robot_counts.crossing(m), obstacles=[list(WIDE_OBSTACLE)],
                               device=dev)
            osub = batch_ocp(obase, sub.x0)
            lam_o = 0.5 * torch.randn((WIDE_HOLD_B, obase.N, obase.n_con), generator=g,
                                      device=dev).abs() * (P.constraint_mask(obase) > 0)
            oerrs = []
            got_o = hold_k1(f"phase 38 (b) K1's obstacle variant vs plain m={m} (a static "
                            f"obstacle {WIDE_OBSTACLE}, {megasolve.obstacle_rows(obase)} rows) "
                            f"B={WIDE_HOLD_B} n_inner=4", osub, U, lam_o, mu, c4, oerrs)
            k2o = hold_k2(f"phase 38 (b) K2's obstacle variant vs plain m={m} on K1's output",
                          osub, got_o[0], got_o[1], lam_o, mu, cfg.lam_max)
            lam_new = megasolve.al_update_plain(osub, got_o[0], got_o[1], lam_o, mu,
                                                cfg.lam_max)[0]
            i0 = obase.n_pairs
            bind = float((lam_new[:, 1:, i0:i0 + m] > 0).float().mean())
            log(f"phase 38 (b) m={m} obstacle rows with a positive multiplier after K2: "
                f"{100 * bind:.2f}% (the rows bind); K1 U max |err| {oerrs[0]:.3e}, K2 {k2o:.3e}")
            assert bind > 0.01, bind
            errs[0] = max(errs[0], oerrs[0])
        log(f"phase 38 (b) m={m} B={WIDE_B} K1: first step {ms0:.2f} ms (plain {plain0:.1f} ms, "
            f"{k1['first step'][3]:.2f} iterations and {k1['first step'][4]:.2f} candidates a "
            f"scenario, bound {b0:.4f} ms by {by0}, {100 * b0 / ms0:.2f}%), converged "
            f"{k1['converged'][0]:.2f} ms (plain {k1['converged'][1]:.1f} ms, "
            f"{k1['converged'][3]:.2f} iterations and {k1['converged'][4]:.2f} candidates, bound "
            f"{b1:.4f} ms by {by1}, {100 * b1 / k1['converged'][0]:.2f}%); K2 {k2_ms:.3f} ms "
            f"(plain {k2_plain:.3f} ms, bound {b2:.4f} ms by {by2}, {100 * b2 / k2_ms:.2f}%) {card}")

        scfg = dataclasses.replace(cfg, mega=False)
        assert route(base, scfg) == "staged"
        cuda_build.reset_launch_counts()
        res, t_s = timed(lambda: solve_batched(ob, cfg=scfg))
        sc = dict(cuda_build.launch_counts)
        check_staged(f"phase 38 (c) m={m}", sc, res, scfg)
        log(f"phase 38 (c) {robot_counts.name(m)} m={m} B={WIDE_B} staged route: launches "
            f"{sc}; {summary(res)}; {t_s * 1e3:.1f} ms a solve; the megakernel route on the "
            f"same starts (b): converged {q['conv']:.4f}, mean inner {q['mean_inner']:.2f} {card}")
        held = hold_staged_kernels(f"phase 38 (c) K3-K6 vs plain m={m}", ob, res, scfg,
                                   torch.Generator(device=dev).manual_seed(380 + m),
                                   first=False, diverged=WIDE_DIVERGED)
        _, v, calls, _ = held[1]   # state (ii): the solve's own multipliers
        names = {"K3": "riccati_lanes", "K4": "expansions_fused",
                 "K5": "linesearch_costs_lanes", "K6": "rollout_alpha_lanes"}
        srcs = {"K3": "staged_tiles.cuh", "K4": "expansions_rollout_tiles.cuh",
                "K5": "staged_tiles.cuh", "K6": "expansions_rollout_tiles.cuh"}
        where = {"K3": "nmpc_tpu/ops/riccati_pallas.py:311",
                 "K4": "nmpc_tpu/ops/expansions_pallas.py:212",
                 "K5": "nmpc_tpu/ops/rollout_pallas.py:287",
                 "K6": "nmpc_tpu/ops/rollout_pallas.py:360"}
        parts = []
        for k in ("K3", "K4", "K5", "K6"):
            k_ms, p_ms = cuda_ms(calls[k][0], 5), cuda_ms(calls[k][1], 1)
            err = max(x.err for _, vs, _, _ in held for key, x in vs.items() if key == k)
            b, by = row(f"{names[k]} m={m}", "nmpc_tpu_torch/csrc/" + srcs[k], where[k],
                        sc[names[k]], err, k_ms, p_ms,
                        RL.kernel_work(k, base, WIDE_B, n_alphas=len(scfg.alphas) + 1))
            parts.append(f"{k} {k_ms:.3f} ms (plain {p_ms:.3f} ms, bound {b:.4f} ms by {by}, "
                         f"{100 * b / k_ms:.2f}%)")
        log(f"phase 38 (c) m={m} B={WIDE_B} kernels at the staged solve's last iterate: "
            + "; ".join(parts) + f" {card}")
        log(f"phase 38 m={m} took {time.perf_counter() - t0:.1f} s")
    return rows


def robot_counts_phase(dev, card: str, pending: list) -> list:
    """Phase 38: robot counts past the registry's (wide_build on the builds
    `pending`, wide_solves), the ptxas lines held to WIDE_PTXAS and
    WIDE_STAGED_PTXAS. Returns the kernel rows of the record."""
    t0 = time.perf_counter()
    lines = wide_build(card, pending)
    for m in WIDE_ROBOTS:
        got = lines[m]
        k1k2 = {k: v for k, v in got.items() if k in ("K1", "K2", "K1 obs", "K2 obs")}
        staged = {k: v for k, v in got.items() if k not in k1k2}
        log(f"phase 38 (a) m={m}: K1/K2 {k1k2} (as recorded in PERF.md: "
            f"{'yes' if k1k2 == WIDE_PTXAS[m] else 'NO'}); K3-K6 {staged} (as recorded: "
            f"{'yes' if staged == WIDE_STAGED_PTXAS[m] else 'NO'})")
    for shape in WIDE_K3_SHAPES:
        log(f"phase 38 (a) K3 at {shape}: {lines[shape]['K3']} (as recorded in PERF.md: "
            f"{'yes' if lines[shape] == WIDE_STAGED_PTXAS[shape] else 'NO'})")
    for key, got in lines.items():   # every line logged before any is held
        if key in WIDE_PTXAS:
            assert {k: v for k, v in got.items() if k in WIDE_PTXAS[key]} == WIDE_PTXAS[key], \
                (key, got)
        assert {k: v for k, v in got.items() if k not in WIDE_PTXAS.get(key, {})} == \
            WIDE_STAGED_PTXAS[key], (key, got)
    rows = wide_solves(dev, card)
    log(f"phase 38 took {time.perf_counter() - t0:.1f} s")
    return rows


def wide_stage_shapes_phase(dev, card: str) -> list:
    """Phase 39: (a) the hybrid route (sweep="scan": plain expansions, the
    associative-scan LQR, K5 for the line-search merits and K6 for the
    accepted rollout) at m=12 on WIDE_HYBRID_B starts of phase 38's crossing
    at the bench config, with the launch counts set to 0 just before and
    read just after (K5 and K6 once an inner iteration, no K3 or K4),
    beside the staged route on the same starts; (b) K3's block
    design at WIDE_K3_SHAPES (its riccati_shape.cu libraries, built in phase
    38 (a)) against plain on random well-posed stage blocks at B = 33 and
    256, N=20, timed at 256 beside plain and the bound. Returns the kernel
    rows of the record."""
    import types

    import torch

    from nmpc_tpu_torch.bench import jittered
    from nmpc_tpu_torch.ops import cuda_build
    from nmpc_tpu_torch.ops import kernel_check as KC
    from nmpc_tpu_torch.ops import riccati as RIC
    from nmpc_tpu_torch.scenarios import robot_counts
    from nmpc_tpu_torch.solver import ALILQRConfig, solve_batched
    from nmpc_tpu_torch.solver.alilqr_batched import route
    from nmpc_tpu_torch.tools import roofline as RL
    from nmpc_tpu_torch.utils.timing import cuda_ms

    t0 = time.perf_counter()
    cfg = ALILQRConfig(n_outer=6, n_inner=12, tol_con=1e-3, ls="adaptive")
    m = 12
    ob = jittered(robot_counts.make(m, device=dev), WIDE_HYBRID_B,
                  torch.Generator(device=dev).manual_seed(39))
    out = {}
    for way, c in (("hybrid", dataclasses.replace(cfg, sweep="scan")),
                   ("staged", dataclasses.replace(cfg, mega=False))):
        assert route(ob, c) == way, way
        cuda_build.reset_launch_counts()
        res, t_s = timed(lambda: solve_batched(ob, cfg=c))
        out[way] = (res, dict(cuda_build.launch_counts), t_s)
    res, hc, t_h = out["hybrid"]
    it = hc["linesearch_costs_lanes"]
    assert it > 0 and hc["rollout_alpha_lanes"] == it, hc
    assert hc["riccati_lanes"] == hc["expansions_fused"] == hc["inner_solve_fused"] == 0, hc
    for name in ("X", "U", "cost", "viol", "lam"):
        assert torch.isfinite(getattr(res, name)).all(), name
    assert float(res.converged.float().mean()) > 0.5, summary(res)
    log(f"phase 39 (a) hybrid route (sweep='scan') {robot_counts.name(m)} m={m} N={ob.N} "
        f"B={WIDE_HYBRID_B} bench config: launches K5 {it}, K6 {hc['rollout_alpha_lanes']} (no K3, "
        f"K4, K1); {summary(res)}; {t_h * 1e3:.1f} ms a solve; the staged route on the same "
        f"starts: {summary(out['staged'][0])}, {out['staged'][2] * 1e3:.1f} ms {card}")
    rows = []
    gen = torch.Generator(device=dev).manual_seed(39)
    for shape in WIDE_K3_SHAPES:
        err = 0.0
        for B in (33, 256):
            exp = KC.k3_inputs(*shape, B, 20, gen)
            got = RIC.riccati_lanes(exp, cfg.reg)
            torch.cuda.synchronize()
            v = KC.Verdict()
            for i, (a, w, atol) in enumerate(zip(got, RIC.riccati_plain(exp, cfg.reg),
                                                 KC.K3_ATOL)):
                KC.hold(v, f"K3 {shape} output {i} B={B}", a, w, atol)
            assert v.units == B and v.n_widened == 0 and v.n_diverged == 0, (shape, B, v)
            err = max(err, v.err)
        ms_ = cuda_ms(lambda: RIC.riccati_lanes(exp, cfg.reg), 5)
        plain_ms = cuda_ms(lambda: RIC.riccati_plain(exp, cfg.reg), 1, warmup=0)
        dims = types.SimpleNamespace(m=0, nx=shape[0], nu=shape[1], n_pairs=0, n_con=0, N=20,
                                     n_obs=0, n_mov=0)
        b_ms, by = RL.bound(*RL.kernel_work("K3", dims, 256))
        log(f"phase 39 (b) K3's register-tile design at {shape} vs plain (B = 33 and 256, N=20): max "
            f"|err| {err:.3e} (kernel_check's rule); {ms_:.4f} ms a launch at B=256, plain "
            f"{plain_ms:.1f} ms, bound {b_ms:.5f} ms ({by}), {100 * b_ms / ms_:.2f}% {card}")
        rows.append({"name": f"riccati_lanes {shape}", "route": "cuda",
                     "source": "nmpc_tpu_torch/csrc/riccati_shape.cu",
                     "replaces": "nmpc_tpu/ops/riccati_pallas.py:311", "launches": 0,
                     "max_abs_err": err, "ms": ms_, "plain_ms": plain_ms, "bound_ms": b_ms,
                     "bound_by": by, "library_ms": None})
    log(f"phase 39 took {time.perf_counter() - t0:.1f} s")
    return rows


# phase 40: robot counts past the megakernel's sixteen, where the default
# config takes the staged route (K1 and K2 stop at
# cuda_build.MEGA_MAX_ROBOTS): K3's register-tile design and K4-K6 on the
# tiles of staged_tiles.k4_rule, k5_rule and k6_rule, at m = 20, 24 and 32 on
# scenarios/robot_counts.py's crossing (N=20) at the bench config; the
# hybrid route at m=20; K3's register-tile design at PAST_K3_SHAPES, stage
# shapes that take each of its branches past nu = 32.
PAST_ROBOTS = (20, 24, 32)
PAST_B = {20: 4096, 24: 4096, 32: 1024}
PAST_HOLD_B = 256
PAST_HYBRID_B = 256
PAST_K3_SHAPES = ((81, 33), (96, 64), (120, 40), (150, 100))
PAST_K3_B = 256
# K5 and K6 reading their stage rows from device memory (D = 0, the geometry
# of m >= 64), built at PAST_ROBOTS[0] and held bit for bit to the solver's
PAST_DIRECT = {"k5": (8, 0), "k6": (8, 0, 16)}
# K3-K6's `-Xptxas -v` lines at PAST_ROBOTS (regs, stack, spill stores,
# spill loads, dynamic shared bytes of a block) and K3's at PAST_K3_SHAPES,
# as PERF.md records them
PAST_STAGED_PTXAS = {
    20: {"K3": (71, 0, 0, 0, 80672), "K4": (254, 32, 0, 0, 154240),
         "K5": (176, 432, 0, 0, 192608), "K6": (166, 32, 0, 0, 163840)},
    24: {"K3": (64, 8, 16, 12, 115616), "K4": (255, 128, 96, 192, 107088),
         "K5": (254, 512, 0, 0, 136272), "K6": (179, 32, 0, 0, 116736)},
    32: {"K3": (87, 0, 0, 0, 204192), "K4": (255, 552, 588, 1304, 179632),
         "K5": (254, 672, 0, 0, 118448), "K6": (238, 32, 0, 0, 204800)},
    (81, 33): {"K3": (91, 0, 0, 0, 118944)}, (96, 64): {"K3": (87, 0, 0, 0, 204192)},
    (120, 40): {"K3": (128, 16, 20, 24, 16384)}, (150, 100): {"K3": (128, 24, 28, 40, 16384)},
}


def start_past_builds() -> list:
    """Phase 40's libraries, the staged solver libraries at PAST_ROBOTS
    (staged.cu alone) and K3 at PAST_K3_SHAPES, each its own nvcc process,
    started in the background right after phase 1's builds, as
    start_wide_builds' are. Returns the futures, which past_build reads."""
    from nmpc_tpu_torch.ops import cuda_build

    pool = ThreadPoolExecutor(max_workers=len(PAST_ROBOTS) + len(PAST_K3_SHAPES))
    futures = [pool.submit(background, cuda_build.load, m) for m in PAST_ROBOTS]
    futures += [pool.submit(background, cuda_build.load_k3_shape, *shape)
                for shape in PAST_K3_SHAPES]
    futures.append(pool.submit(background, past_direct_lib))
    pool.shutdown(wait=False)
    return futures


def past_direct_lib():
    """staged.cu at PAST_ROBOTS[0] with K5 and K6 at PAST_DIRECT."""
    from nmpc_tpu_torch.ops import cuda_build, staged_tiles

    return cuda_build.load_staged_variant(
        PAST_ROBOTS[0], k5=staged_tiles.K5Geometry(*PAST_DIRECT["k5"]),
        k6=staged_tiles.K6Geometry(*PAST_DIRECT["k6"]))


def direct_vs_ring(ob, r, cfg) -> tuple:
    """K5 and K6 of past_direct_lib against the solver's at the staged
    solve's last iterate r of ob (K4 there, K3 on K4's output): (merits that
    differ, scenarios whose rollout differs)."""
    import torch

    from nmpc_tpu_torch.ops import rollout as R
    from nmpc_tpu_torch.ops.cuda_build import lane
    from nmpc_tpu_torch.ops.expansions import expansions_fused
    from nmpc_tpu_torch.ops.riccati import riccati_lanes
    from nmpc_tpu_torch.solver.alilqr_batched import _mov_lanes

    lib = past_direct_lib()[0]
    B = ob.x0.shape[0]
    X_l, U_l, xref_l, lam_l = lane(r.X[:, :-1]), lane(r.U), lane(ob.xref), lane(r.lam)
    mov_l, mu = _mov_lanes(ob, B), r.mu.contiguous()
    kff, Kfb, _ = riccati_lanes(expansions_fused(ob, X_l, U_l, xref_l, lam_l, mu, mov_l), cfg.reg)
    args = (X_l[0].contiguous(), X_l, U_l, kff, Kfb, xref_l, lam_l, mu)
    alphas = (0.0,) + tuple(cfg.alphas)
    ring5 = R.linesearch_costs_lanes(ob, *args, alphas, mov_l)
    direct5 = R.costs_launch(ob, *args, alphas, mov_l, lib)
    grid = torch.tensor(cfg.alphas, device=mu.device)
    k6 = (*args[:5], grid[torch.arange(B, device=mu.device) % len(cfg.alphas)].contiguous())
    ring6, direct6 = R.rollout_alpha_lanes(ob, *k6), R.rollout_launch(ob, *k6, lib)
    off6 = torch.zeros(B, dtype=torch.bool, device=mu.device)
    for a, b in zip(ring6, direct6):
        off6 |= (a != b).reshape(-1, B).any(dim=0)
    return int((ring5 != direct5).sum()), int(off6.sum())


def past_build(card: str, pending: list) -> dict:
    """Phase 40 (a): the libraries start_past_builds started (waited for
    here): K1 and K2 absent, K3 in its register-tile design. Returns {m: {kernel:
    ptxas line with its dynamic shared bytes}} and {shape: {"K3": ...}}."""
    from nmpc_tpu_torch.ops import cuda_build, staged_tiles
    from nmpc_tpu_torch.ops import rollout as R

    t0 = time.perf_counter()
    for f in pending:   # a build that failed raises here
        f.result()
    lines = {}
    for m in PAST_ROBOTS:
        lib = cuda_build.load(m)
        assert not hasattr(lib, "nmpc_inner_solve") or m <= cuda_build.MEGA_MAX_ROBOTS, m
        assert cuda_build.k3_geometry(lib)["rtile"] == 1, m
        text = cuda_build.build_info[m]["ptxas"]
        got = ptxas(text)
        k4 = cuda_build.k4_geometry(lib, staged_tiles.k4_rows(m, True, 0, 0),
                                    R._P(3 * m, 2 * m, 0).size)["smem_bytes"]
        k5 = cuda_build.k5_geometry(lib, staged_tiles.k5_rows(m, True, 0, 0),
                                    R._P(3 * m, 2 * m, 9).size)["smem_bytes"]
        smem = {"K3": cuda_build.k3_geometry(lib)["smem_bytes"], "K4": k4, "K5": k5,
                "K6": cuda_build.k6_geometry(lib)["smem_bytes"]}
        assert set(got) == set(smem) | {"K4 device", "K5 device"}, (m, sorted(got))
        lines[m] = {k: (*got[k], smem[k]) for k in smem}
        log(f"phase 40 (a) ptxas m={m} (staged.cu alone; K3 {staged_tiles.k3_geometry(m)}, K4 "
            f"{staged_tiles.k4_geometry(m)}, K5 {staged_tiles.k5_geometry(m)}, K6 "
            f"{staged_tiles.k6_geometry(m)}): {ptxas_summary(text)}; built in "
            f"{cuda_build.build_info[m]['seconds']:.1f} s")
    for shape in PAST_K3_SHAPES:
        info = cuda_build.k3_shape_build_info[shape]
        lines[shape] = {"K3": (*ptxas(info["ptxas"])["K3"],
                               staged_tiles.k3_layout(shape)["smem_bytes"])}
        log(f"phase 40 (a) ptxas K3 at {shape} ({staged_tiles.k3_geometry(shape)}): "
            f"{ptxas_summary(info['ptxas'])}, dynamic shared {lines[shape]['K3'][-1]} B; built "
            f"in {info['seconds']:.1f} s")
    log(f"phase 40 (a) built m in {PAST_ROBOTS} and K3 at {PAST_K3_SHAPES} in the background "
        f"since phase 1 (parallel nvcc); phase 40 waited {time.perf_counter() - t0:.1f} s for "
        f"them {card}")
    for key, got in lines.items():
        log(f"phase 40 (a) {key}: {got} (as recorded in PERF.md: "
            f"{'yes' if got == PAST_STAGED_PTXAS.get(key) else 'NO'})")
    for key, got in lines.items():   # every line logged before any is held
        assert got == PAST_STAGED_PTXAS[key], (key, got)
    return lines


def past_sixteen_phase(dev, card: str, pending: list) -> list:
    """Phase 40 past the megakernel's sixteen robots, each solve driven with
    the launch counts set to 0 just before it and read just after:
    (a) past_build;
    (b) at each m of PAST_ROBOTS, solve_batched on PAST_B[m] starts of the
    crossing (bench.jittered) at the bench config, whose route is the
    staged one there (K1 and K2 refuse m > 16): K4, K3, K5 and K6 launched,
    no K1 or K2; the converged share at least 0.9 at m = 20 and 24 (m = 32
    recorded); the default config and mega=False bit for bit on the first
    PAST_HOLD_B starts; K3-K6 against plain on the solve's last iterate of
    those starts (kernel_check's rule at fresh and at the solve's own
    multipliers, as phase 38 (c)), each timed there beside its plain
    version and the bound;
    (c) the hybrid route (sweep="scan") at m=20 on PAST_HYBRID_B starts:
    K5 and K6 once an inner iteration, no K3 or K4;
    (d) K3's register-tile design at PAST_K3_SHAPES (each from its riccati_shape.cu
    library: a lone K3 at a robot stack's shape past sixteen robots does
    not build that robot count's K4-K6) against plain on random well-posed
    stage blocks at B=256, N=20, timed beside plain and the bound: nu > 32
    (a Cholesky across the block), a ring of one A-and-B tile, and the slot
    in device memory each run at least once (A and B read straight from
    device memory, D = 0, is held by tests/test_torch_cuda.py at (210,
    100)).
    Returns the kernel rows of the record."""
    import types

    import torch

    from nmpc_tpu_torch.bench import jittered
    from nmpc_tpu_torch.ops import cuda_build, megasolve, staged_tiles
    from nmpc_tpu_torch.ops import kernel_check as KC
    from nmpc_tpu_torch.ops import riccati as RIC
    from nmpc_tpu_torch.parallel import batch_ocp
    from nmpc_tpu_torch.scenarios import robot_counts
    from nmpc_tpu_torch.solver import ALILQRConfig, solve_batched
    from nmpc_tpu_torch.solver.alilqr_batched import route
    from nmpc_tpu_torch.tools import roofline as RL
    from nmpc_tpu_torch.utils.timing import cuda_ms

    t0 = time.perf_counter()
    past_build(card, pending)
    cfg = ALILQRConfig(n_outer=6, n_inner=12, tol_con=1e-3, ls="adaptive")
    scfg = dataclasses.replace(cfg, mega=False)
    names = {"K3": "riccati_lanes", "K4": "expansions_fused", "K5": "linesearch_costs_lanes",
             "K6": "rollout_alpha_lanes"}
    srcs = {"K3": "staged_tiles.cuh", "K4": "expansions_rollout_tiles.cuh",
            "K5": "staged_tiles.cuh", "K6": "expansions_rollout_tiles.cuh"}
    where = {"K3": "nmpc_tpu/ops/riccati_pallas.py:311",
             "K4": "nmpc_tpu/ops/expansions_pallas.py:212",
             "K5": "nmpc_tpu/ops/rollout_pallas.py:287",
             "K6": "nmpc_tpu/ops/rollout_pallas.py:360"}
    rows = []

    def row(name, src, at, launches, err, ms_, plain_ms, work):
        b_ms, by = RL.bound(*work)
        rows.append({"name": name, "route": "cuda", "source": src, "replaces": at,
                     "launches": launches, "max_abs_err": err, "ms": ms_, "plain_ms": plain_ms,
                     "bound_ms": b_ms, "bound_by": by, "library_ms": None})
        return b_ms, by

    for m in PAST_ROBOTS:
        t1 = time.perf_counter()
        base = robot_counts.make(m, device=dev)
        assert route(base, cfg) == route(base, scfg) == "staged", m
        assert f"m={m}" in megasolve.cuda_unsupported(base, cfg), m
        B = PAST_B[m]
        ob = jittered(base, B, torch.Generator(device=dev).manual_seed(40 + m))
        cuda_build.reset_launch_counts()
        res, t_s = timed(lambda: solve_batched(ob, cfg=cfg))
        sc = dict(cuda_build.launch_counts)
        check_staged(f"phase 40 (b) m={m}", sc, res, cfg)
        conv = float(res.converged.float().mean())
        log(f"phase 40 (b) {robot_counts.name(m)} m={m} N={base.N} B={B} bench config (the "
            f"staged route): launches {sc}; {summary(res)}; {t_s * 1e3:.1f} ms a solve "
            f"({B / t_s:.1f} solves/s) {card}")
        if m < 32:
            assert conv >= 0.9, (m, conv)
        k3_ms, k3_b, k3_by = k3_at_solve_batch(ob, res, cfg)
        log(f"phase 40 (b) m={m} K3 at the solve's batch B={B}, its last iterate: {k3_ms:.3f} ms "
            f"(bound {k3_b:.4f} ms by {k3_by}, {100 * k3_b / k3_ms:.2f}%) {card}")
        H = PAST_HOLD_B
        sub = batch_ocp(base, ob.x0[:H])
        got = {}
        for what, c in (("default", cfg), ("mega=False", scfg)):
            cuda_build.reset_launch_counts()
            got[what] = solve_batched(sub, cfg=c)
            check_staged(f"phase 40 (b) m={m} {what} B={H}", dict(cuda_build.launch_counts),
                         got[what], c)
        same = all(torch.equal(getattr(got["default"], k), getattr(got["mega=False"], k))
                   for k in ("X", "U", "cost", "lam", "mu", "converged"))
        log(f"phase 40 (b) m={m} B={H}: the default config and mega=False bit for bit: "
            f"{'yes' if same else 'NO'}")
        assert same, m
        plain = {}
        held = hold_staged_kernels(f"phase 40 (b) K3-K6 vs plain m={m}", sub, got["mega=False"],
                                   scfg, torch.Generator(device=dev).manual_seed(400 + m),
                                   first=False, diverged=WIDE_DIVERGED, plain_ms=plain)
        _, v, calls, _ = held[1]   # state (ii): the solve's own multipliers
        parts = []
        for k in ("K3", "K4", "K5", "K6"):
            k_ms, p_ms = cuda_ms(calls[k][0], 3), plain[k]   # plain: its one call in the hold
            err = max(x.err for _, vs, _, _ in held for key, x in vs.items() if key == k)
            b, by = row(f"{names[k]} m={m}", "nmpc_tpu_torch/csrc/" + srcs[k], where[k],
                        sc[names[k]], err, k_ms, p_ms,
                        RL.kernel_work(k, base, H, n_alphas=len(scfg.alphas) + 1))
            parts.append(f"{k} {k_ms:.3f} ms (plain {p_ms:.3f} ms, bound {b:.4f} ms by {by}, "
                         f"{100 * b / k_ms:.2f}%)")
        log(f"phase 40 (b) m={m} B={H} kernels at the staged solve's last iterate: "
            + "; ".join(parts) + f" {card}")
        if m == PAST_ROBOTS[0]:
            off5, off6 = direct_vs_ring(sub, got["mega=False"], scfg)
            log(f"phase 40 (b) m={m} B={H} K5 and K6 reading their stage rows from device "
                f"memory ({PAST_DIRECT}, the geometry of m >= 64) against the solver's: merits "
                f"that differ {off5}/{H * (len(scfg.alphas) + 1)}, rollouts {off6}/{H} (bit "
                f"for bit: 0)")
            assert off5 == off6 == 0, (off5, off6)
        del res, got, held, calls
        log(f"phase 40 m={m} took {time.perf_counter() - t1:.1f} s")

    m = PAST_ROBOTS[0]
    ob = jittered(robot_counts.make(m, device=dev), PAST_HYBRID_B,
                  torch.Generator(device=dev).manual_seed(41))
    c = dataclasses.replace(cfg, sweep="scan")
    assert route(ob, c) == "hybrid"
    cuda_build.reset_launch_counts()
    res, t_h = timed(lambda: solve_batched(ob, cfg=c))
    hc = dict(cuda_build.launch_counts)
    it = hc["linesearch_costs_lanes"]
    assert it > 0 and hc["rollout_alpha_lanes"] == it, hc
    assert hc["riccati_lanes"] == hc["expansions_fused"] == hc["inner_solve_fused"] == 0, hc
    for name in ("X", "U", "cost", "viol", "lam"):
        assert torch.isfinite(getattr(res, name)).all(), name
    log(f"phase 40 (c) hybrid route (sweep='scan') {robot_counts.name(m)} m={m} N={ob.N} "
        f"B={PAST_HYBRID_B} bench config: launches K5 {it}, K6 {hc['rollout_alpha_lanes']} (no "
        f"K3, K4, K1); {summary(res)}; {t_h * 1e3:.1f} ms a solve {card}")

    gen = torch.Generator(device=dev).manual_seed(40)
    branches = set()
    for shape in PAST_K3_SHAPES:
        g = staged_tiles.k3_geometry(shape)
        assert g.rtile, shape
        branches |= {b for b, on in (("nu > 32", shape[1] > 32), ("ring of one", g.D == 1),
                                     ("slot spilled", g.spill)) if on}
        exp = KC.k3_inputs(*shape, PAST_K3_B, 20, gen)
        got = RIC.riccati_lanes(exp, cfg.reg)
        torch.cuda.synchronize()
        want, plain_ms = once(lambda: RIC.riccati_plain(exp, cfg.reg))
        v = KC.Verdict()
        for i, (a, w, atol) in enumerate(zip(got, want, KC.K3_ATOL)):
            KC.hold(v, f"K3 {shape} output {i}", a, w, atol)
        assert v.units == PAST_K3_B and v.n_widened == 0 and v.n_diverged == 0, (shape, v)
        ms_ = cuda_ms(lambda: RIC.riccati_lanes(exp, cfg.reg), 2)
        dims = types.SimpleNamespace(m=0, nx=shape[0], nu=shape[1], n_pairs=0, n_con=0, N=20,
                                     n_obs=0, n_mov=0)
        b_ms, by = RL.bound(*RL.kernel_work("K3", dims, PAST_K3_B))
        log(f"phase 40 (d) K3's register-tile design at {shape} ({g}) vs plain (B={PAST_K3_B}, "
            f"N=20): "
            f"max |err| "
            f"{v.err:.3e} (kernel_check's rule); {ms_:.4f} ms a launch, plain {plain_ms:.1f} ms, "
            f"bound {b_ms:.5f} ms ({by}), {100 * b_ms / ms_:.2f}% {card}")
        rows.append({"name": f"riccati_lanes {shape}", "route": "cuda",
                     "source": "nmpc_tpu_torch/csrc/riccati_shape.cu",
                     "replaces": "nmpc_tpu/ops/riccati_pallas.py:311", "launches": 0,
                     "max_abs_err": v.err, "ms": ms_, "plain_ms": plain_ms, "bound_ms": b_ms,
                     "bound_by": by, "library_ms": None})
        del exp, got, want
    assert branches == {"nu > 32", "ring of one", "slot spilled"}, branches
    log(f"phase 40 took {time.perf_counter() - t0:.1f} s")
    return rows


# Phase 41, no shared-memory ceiling: problems whose rows overflow K4's or
# K5's tile take their device-memory forms (staged_tiles.k4_form, k5_form),
# at full width, each with the counts set to 0 just before its solve:
# (a) the crossing at ANY_M = 112 robots (N=10), past the last robot count
#     whose K4 tile holds one scenario: K4's device-memory form, K3's wide
#     design at (336, 224), K5's and K6's direct reads;
# (b) the crossing of 16 robots among 200 pillars (N=20; K1's block
#     overflows too, so the default route is the staged one): K4 and K5 on
#     their device-memory forms;
# (c) the crossing of 20 among 64 pillars on the hybrid route (sweep="scan"):
#     K5's device-memory form beside the scan LQR;
# (d) one robot with 150 moving obstacles (mega=False), the subproblem of a
#     151-robot decentralized fleet on a circle (robot_counts.
#     fleet_subproblem, N=30): K4's device-memory form, K5's tile.
ANY_M = 112
ANY_B = {"a": 64, "b": 1024, "c": 256, "d": 1024}
ANY_HOLD_B = {"a": 8, "b": 64, "c": 64, "d": 64}
ANY_SHARE = {"a": 0.99, "b": 0.9, "c": 0.9, "d": 0.9}
# the holds' states (hold_staged_kernels): at m = 112 the solve's last
# iterate alone, (ii), where a plain K3 at (336, 224) takes ~22 s a call
ANY_STATES = {"a": ("ii",), "b": ("i", "ii"), "c": ("i", "ii"), "d": ("i", "ii")}
ANY_FORMS = {"a": {"K4": "device", "K5": "device"}, "b": {"K4": "device", "K5": "device"},
             "c": {"K5": "device"}, "d": {"K4": "device", "K5": "tile"}}
# where both forms take the problem: the crossing of 20 robots among 16
# pillars, N=20, held bit for bit at these batches (a ragged tile; whole
# tiles of 16-byte rows)
ANY_BITS_B = (37, 256)
# the `-Xptxas -v` lines of K4's and K5's device-memory forms (regs, stack,
# spill stores, spill loads) in every solver library the script builds, and
# K3-K6's at ANY_M (K5's tile geometry there is its device-memory form, and
# its library holds no K4 tile), as PERF.md records them
DEVICE_PTXAS = {
    1: {"K4 device": (128, 40, 8, 8), "K5 device": (52, 40, 0, 0)},
    2: {"K4 device": (128, 64, 28, 28), "K5 device": (64, 48, 0, 0)},
    3: {"K4 device": (168, 32, 0, 0), "K5 device": (64, 56, 0, 0)},
    4: {"K4 device": (168, 32, 0, 0), "K5 device": (64, 64, 0, 0)},
    5: {"K4 device": (230, 32, 0, 0), "K5 device": (64, 72, 0, 0)},
    6: {"K4 device": (254, 32, 0, 0), "K5 device": (94, 80, 0, 0)},
    7: {"K4 device": (255, 72, 36, 36), "K5 device": (107, 88, 0, 0)},
    8: {"K4 device": (255, 40, 4, 4), "K5 device": (107, 96, 0, 0)},
    9: {"K4 device": (255, 32, 0, 0), "K5 device": (105, 208, 0, 0)},
    10: {"K4 device": (255, 72, 36, 36), "K5 device": (106, 240, 0, 0)},
    12: {"K4 device": (254, 32, 0, 0), "K5 device": (128, 272, 0, 0)},
    16: {"K4 device": (255, 32, 0, 0), "K5 device": (128, 352, 0, 0)},
    20: {"K4 device": (255, 208, 176, 720), "K5 device": (185, 432, 0, 0)},
    24: {"K4 device": (255, 328, 288, 1036), "K5 device": (255, 560, 40, 36)},
    32: {"K4 device": (255, 416, 0, 0), "K5 device": (255, 720, 56, 112)},
    112: {"K4 device": (168, 3552, 2208, 6080), "K5 device": (128, 8704, 14920, 19048)},
}
ANY_PTXAS = {ANY_M: {"K3": (128, 40, 44, 48), "K4 device": (168, 3552, 2208, 6080),
                     "K5 device": (128, 8704, 14920, 19048), "K6": (168, 2880, 5768, 8764)}}


def start_any_rows_build() -> list:
    """Phase 41's library, the staged solver library at ANY_M (staged.cu
    alone: K3's register-tile design, K4's device-memory form, K5's and K6's direct
    reads), started in the background right after phase 1's builds, as
    start_past_builds' are. Returns the future, which any_rows_phase reads."""
    from nmpc_tpu_torch.ops import cuda_build

    pool = ThreadPoolExecutor(max_workers=1)
    futures = [pool.submit(background, cuda_build.load, ANY_M)]
    pool.shutdown(wait=False)
    return futures


def any_rows_problem(case: str, dev, gen):
    """Phase 41's problem (a)-(d): (batched OCP at ANY_B[case] starts,
    config)."""
    from nmpc_tpu_torch.bench import jittered
    from nmpc_tpu_torch.ocp import problem as P
    from nmpc_tpu_torch.scenarios import robot_counts
    from nmpc_tpu_torch.solver import ALILQRConfig

    cfg = ALILQRConfig(n_outer=6, n_inner=12, tol_con=1e-3, ls="adaptive")
    B = ANY_B[case]
    if case == "a":
        return jittered(robot_counts.make(ANY_M, device=dev, N=10), B, gen), cfg
    if case in ("b", "c"):
        m, n_obs = (16, 200) if case == "b" else (20, 64)
        ob = jittered(P.make_ocp(**robot_counts.pillars(m, n_obs), device=dev), B, gen)
        return ob, (cfg if case == "b" else dataclasses.replace(cfg, sweep="scan"))
    return (jittered(P.make_ocp(**robot_counts.fleet_subproblem(150), device=dev), B, gen),
            dataclasses.replace(cfg, mega=False))


def device_vs_tile(dev, gen) -> tuple:
    """K4's and K5's device-memory forms against their tile forms on the
    same inputs where both take the problem: the crossing of 20 robots among
    16 pillars (N=20) at ANY_BITS_B, states around the starts, duals |N(0,
    0.5)|, mu in {10, 100}, random gains. Returns (K4 outputs that differ,
    K5 merits that differ, units)."""
    import torch

    from nmpc_tpu_torch.ocp import problem as P
    from nmpc_tpu_torch.ops import cuda_build, expansions, staged_tiles
    from nmpc_tpu_torch.ops import rollout as R
    from nmpc_tpu_torch.scenarios import robot_counts
    from nmpc_tpu_torch.solver import ALILQRConfig

    ocp = P.make_ocp(**robot_counts.pillars(20, 16), device=dev)
    assert not expansions.form(ocp).device, expansions.form(ocp)
    alphas = (0.0,) + tuple(ALILQRConfig().alphas)
    assert R.costs_form(ocp, len(alphas)) != staged_tiles.K5_DEVICE
    lib = cuda_build.load(ocp.m)
    off4 = off5 = units = 0
    for B in ANY_BITS_B:
        rnd = lambda *s: torch.randn(s, generator=gen, device=dev)  # noqa: E731
        N, n, nu = ocp.N, ocp.nx, ocp.nu
        X = (ocp.x0[None, None] + 0.4 * rnd(B, N, n)).movedim(0, -1).contiguous()
        lam = (0.5 * rnd(B, N, ocp.n_con).abs() * (P.constraint_mask(ocp) > 0))
        lam = lam.movedim(0, -1).contiguous()
        U = (0.1 * rnd(B, N, nu)).movedim(0, -1).contiguous()
        kff = (0.1 * rnd(B, N, nu)).movedim(0, -1).contiguous()
        Kfb = (0.1 * rnd(B, N, nu, n)).movedim(0, -1).contiguous()
        xref = ocp.xref[..., None].expand(N, n, B).contiguous()
        mu = torch.tensor([10.0, 100.0], device=dev)[
            torch.randint(0, 2, (B,), generator=gen, device=dev)]
        ins = (X, U, xref, lam, mu, None)
        tile = expansions.launch(ocp, *ins, lib)
        device = expansions.launch(ocp, *ins, lib, device=True)
        off4 += sum(int((a != b).reshape(-1, B).any(dim=0).sum()) for a, b in zip(tile, device))
        args = (X[0].contiguous(), X, U, kff, Kfb, xref, lam, mu)
        t5 = R.costs_launch(ocp, *args, alphas, None, lib)
        d5 = R.costs_launch(ocp, *args, alphas, None, lib, device=True)
        off5 += int((t5 != d5).sum())
        units += B
    return off4, off5, units


def any_rows_phase(dev, card: str, pending: list) -> list:
    """Phase 41, no shared-memory ceiling (the cases above ANY_M): the
    library at ANY_M (waited for here) and every library's device-memory
    forms against their recorded ptxas lines; each case's solve through
    the route's kernels in the forms ANY_FORMS names (the launch counts and
    the form counts), its converged share at least ANY_SHARE; K3-K6 against
    plain at the solve's last iterate of its first ANY_HOLD_B starts
    (kernel_check's rule at fresh and at the solve's own multipliers, as
    phase 40), each timed there beside its plain version and the bound; the
    device-memory forms against the tile forms bit for bit. Returns the
    kernel rows of the record."""
    import types

    import torch

    from nmpc_tpu_torch.ocp import problem as P
    from nmpc_tpu_torch.ops import cuda_build, staged_tiles
    from nmpc_tpu_torch.solver import solve_batched
    from nmpc_tpu_torch.solver.alilqr_batched import route
    from nmpc_tpu_torch.tools import roofline as RL
    from nmpc_tpu_torch.utils.timing import cuda_ms

    t0 = time.perf_counter()
    for f in pending:   # a build that failed raises here
        f.result()
    info = cuda_build.build_info[ANY_M]
    lib = cuda_build.load(ANY_M)
    assert not hasattr(lib, "nmpc_inner_solve") and cuda_build.k3_geometry(lib)["rtile"] == 1
    assert staged_tiles.k4_geometry(ANY_M) is None
    assert staged_tiles.k5_geometry(ANY_M) == staged_tiles.K5_DEVICE
    any_lines = {ANY_M: ptxas(info["ptxas"])}
    log(f"phase 41 (a) ptxas m={ANY_M} (staged.cu alone; K3 {staged_tiles.k3_geometry(ANY_M)}, "
        f"K4 {staged_tiles.K4_DEVICE} alone, K5 {staged_tiles.K5_DEVICE}, K6 "
        f"{staged_tiles.k6_geometry(ANY_M)}): {ptxas_summary(info['ptxas'])}; built in "
        f"{info['seconds']:.1f} s in the background since phase 1; phase 41 waited "
        f"{time.perf_counter() - t0:.1f} s for it {card}")
    device_lines = {}
    for m in sorted(cuda_build.build_info):
        got = ptxas(cuda_build.build_info[m]["ptxas"])
        device_lines[m] = {k: got[k] for k in ("K4 device", "K5 device") if k in got}
        log(f"phase 41 ptxas m={m}: K4's device-memory form {device_lines[m].get('K4 device')}, "
            f"K5's {device_lines[m].get('K5 device')} (regs, stack, spill stores, spill loads; as "
            f"recorded in PERF.md: "
            f"{'yes' if device_lines[m] == DEVICE_PTXAS.get(m) else 'NO'})")
    log(f"phase 41 ptxas m={ANY_M}: {any_lines[ANY_M]} (as recorded in PERF.md: "
        f"{'yes' if any_lines[ANY_M] == ANY_PTXAS.get(ANY_M) else 'NO'})")
    for m, got in device_lines.items():   # every line logged before any is held
        assert set(got) == {"K4 device", "K5 device"}, (m, got)
        assert got == DEVICE_PTXAS[m], (m, got)
    assert any_lines[ANY_M] == ANY_PTXAS[ANY_M], any_lines

    names = {"K3": "riccati_lanes", "K4": "expansions_fused", "K5": "linesearch_costs_lanes",
             "K6": "rollout_alpha_lanes"}
    srcs = {"K3": "staged_tiles.cuh", "K4": "expansions_rollout_tiles.cuh",
            "K5": "staged_tiles.cuh", "K6": "expansions_rollout_tiles.cuh"}
    where = {"K3": "nmpc_tpu/ops/riccati_pallas.py:311",
             "K4": "nmpc_tpu/ops/expansions_pallas.py:212",
             "K5": "nmpc_tpu/ops/rollout_pallas.py:287",
             "K6": "nmpc_tpu/ops/rollout_pallas.py:360"}
    rows = []
    gen = torch.Generator(device=dev).manual_seed(41)
    for case in "abcd":
        t1 = time.perf_counter()
        ob, cfg = any_rows_problem(case, dev, gen)
        way = route(ob, cfg)
        assert way == ("hybrid" if case == "c" else "staged"), (case, way)
        B = ob.x0.shape[0]
        cuda_build.reset_launch_counts()
        res, t_s = timed(lambda: solve_batched(ob, cfg=cfg))
        c, f = dict(cuda_build.launch_counts), dict(cuda_build.staged_forms)
        it = c["linesearch_costs_lanes"]
        if way == "staged":
            check_staged(f"phase 41 ({case})", c, res, cfg)
        else:
            assert it > 0 and c["rollout_alpha_lanes"] == it, c
            assert c["riccati_lanes"] == c["expansions_fused"] == c["inner_solve_fused"] == 0, c
            for name in ("X", "U", "cost", "viol", "lam"):
                assert torch.isfinite(getattr(res, name)).all(), name
        assert c["inner_solve_fused"] == c["al_update_lanes"] == 0, c
        for k, form in ANY_FORMS[case].items():
            other = "tile" if form == "device" else "device"
            n_k = c[names[k]]
            assert f[f"{k} {form}"] == n_k > 0 and f[f"{k} {other}"] == 0, (case, k, f)
        conv = float(res.converged.float().mean())
        log(f"phase 41 ({case}) m={ob.m} N={ob.N} B={B} n_obs={ob.n_obs} n_mov={ob.n_mov} "
            f"({way} route, {cfg.sweep}, mega={cfg.mega}): launches {c}; forms {f}; "
            f"{summary(res)}; {t_s * 1e3:.1f} ms a solve ({B / t_s:.1f} solves/s) {card}")
        assert conv >= ANY_SHARE[case], (case, conv)
        if case == "a":
            k3_ms, k3_b, k3_by = k3_at_solve_batch(ob, res, cfg)
            log(f"phase 41 (a) K3 at the solve's batch B={B}, its last iterate: {k3_ms:.3f} ms "
                f"(bound {k3_b:.4f} ms by {k3_by}, {100 * k3_b / k3_ms:.2f}%) {card}")
        H = ANY_HOLD_B[case]
        sub = dataclasses.replace(ob, **{k: getattr(ob, k)[:H] for k in P.batch_fields(ob)})
        r = types.SimpleNamespace(X=res.X[:H], U=res.U[:H], lam=res.lam[:H], mu=res.mu[:H])
        plain = {}
        held = hold_staged_kernels(f"phase 41 ({case}) K3-K6 vs plain m={ob.m}", sub, r, cfg,
                                   gen, first=False, diverged=WIDE_DIVERGED,
                                   states=ANY_STATES[case], plain_ms=plain)
        _, v, calls, _ = held[-1]   # state (ii): the solve's own multipliers
        parts = []
        for k in ("K3", "K4", "K5", "K6"):
            k_ms, p_ms = cuda_ms(calls[k][0], 2), plain[k]   # plain: its one call in the hold
            err = max(x.err for _, vs, _, _ in held for key, x in vs.items() if key == k)
            form = ANY_FORMS[case].get(k, "")
            b_ms, by = RL.bound(*RL.kernel_work(k, sub, H, n_alphas=len(cfg.alphas) + 1))
            rows.append({"name": f"{names[k]} {form} ({case}) m={ob.m}".replace("  ", " "),
                         "route": "cuda", "source": "nmpc_tpu_torch/csrc/" + srcs[k],
                         "replaces": where[k], "launches": c[names[k]], "max_abs_err": err,
                         "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": by,
                         "library_ms": None})
            parts.append(f"{k}{' ' + form if form else ''} {k_ms:.3f} ms (plain {p_ms:.3f} ms, "
                         f"bound {b_ms:.4f} ms by {by}, {100 * b_ms / k_ms:.2f}%)")
        log(f"phase 41 ({case}) B={H} kernels at the solve's last iterate: " + "; ".join(parts)
            + f" {card}")
        del res, held, calls, r, sub, ob
        log(f"phase 41 ({case}) took {time.perf_counter() - t1:.1f} s")
    off4, off5, units = device_vs_tile(dev, gen)
    log(f"phase 41 device-memory forms against the tile forms (the crossing of 20 robots among "
        f"16 pillars, B in {ANY_BITS_B}): K4 scenarios that differ {off4}/{units}, K5 merits "
        f"{off5}/{units * 9} (bit for bit: 0)")
    assert off4 == off5 == 0, (off4, off5)
    log(f"phase 41 took {time.perf_counter() - t0:.1f} s")
    return rows


def per_step(counts: dict, name: str, stamps) -> str:
    """Launches of a kernel a loop step (a solve run), as a string."""
    return f"{counts[name] / max(len(stamps), 1):.2f}"


def main() -> int:
    t_start = time.perf_counter()
    import torch

    # ---- phase 0: device ------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    import nmpc_tpu_torch

    pkg_dir = os.path.dirname(os.path.dirname(os.path.abspath(nmpc_tpu_torch.__file__)))
    if pkg_dir != HERE:
        raise RuntimeError(f"nmpc_tpu_torch imported from {pkg_dir}, not beside this script")
    from nmpc_tpu_torch.ocp import problem as P
    from nmpc_tpu_torch.ops import cuda_build, megasolve, staged_tiles
    from nmpc_tpu_torch.ops import rollout as rollout_ops
    from nmpc_tpu_torch.ops.cuda_build import lane, std
    from nmpc_tpu_torch.parallel import batch_ocp
    from nmpc_tpu_torch.solver import alilqr_batched as AB
    from nmpc_tpu_torch.scenarios import get
    from nmpc_tpu_torch.solver import ALILQRConfig, solve_batched
    from nmpc_tpu_torch.tools import exp_blocked_expansions as K9
    from nmpc_tpu_torch.tools import exp_mega_phases as K8
    from nmpc_tpu_torch.tools import k1_phases as K1P
    from nmpc_tpu_torch.tools import roofline as RL
    from nmpc_tpu_torch.utils.timing import cuda_ms

    assert "jax" not in sys.modules and "nmpc_tpu" not in sys.modules
    dev = torch.device("cuda", 0)
    smi = sh(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"]).splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    try:
        import triton  # noqa: F401

        triton_v = triton.__version__
    except ImportError:
        triton_v = "not importable"
    nvcc_v = sh([cuda_build.nvcc(), "--version"]).splitlines()[-1]
    card = f"[{smi}]"
    log(f"phase 0 device: {kind} x{torch.cuda.device_count()} {card}; torch "
        f"{torch.__version__} CUDA {torch.version.cuda}; nvcc {nvcc_v}; triton {triton_v}; "
        f"python {sys.version.split()[0]}")

    # ---- phase 1: build every kernel instantiation ------------------------
    t0 = time.perf_counter()
    # beside them K1 at m=6 with its clock64 phase probes (phase 13 sets
    # K8's savings beside its split)
    with ThreadPoolExecutor(max_workers=1) as pool:
        probes = pool.submit(cuda_build.load_k1_variant, cuda_build.BENCH_ROBOTS, probes=True)
        cuda_build.load_all(staged_tiles.K3_SHAPES + staged_tiles.K3_SWEEP_SHAPES)
        probe_lib = probes.result()[0]
    wall = time.perf_counter() - t0
    wide_builds = start_wide_builds()
    past_builds = start_past_builds()
    any_builds = start_any_rows_build()
    per_m = ", ".join(f"m={m} {cuda_build.build_info[m]['seconds']:.1f}s"
                      for m in cuda_build.ROBOT_COUNTS)
    tools = cuda_build.tools_build_info[cuda_build.BENCH_ROBOTS]
    log(f"phase 1 build: {len(cuda_build.ROBOT_COUNTS)} solver libraries, K3 at (n, nu) in "
        f"{staged_tiles.K3_SHAPES} and at k3_rule's sweep {staged_tiles.K3_SWEEP_SHAPES}, the "
        f"tools library "
        f"(m={cuda_build.BENCH_ROBOTS}, {len(cuda_build.TOOLS_PARTS)} parts), the staged "
        f"kernels' first designs (m in {cuda_build.FIRST_ROBOTS}) and K1 with its phase probes "
        f"(m={cuda_build.BENCH_ROBOTS}) in {wall:.1f}s wall "
        f"(parallel nvcc; {per_m}; tools {tools['seconds']:.1f}s)")
    lines = {}
    for m in cuda_build.ROBOT_COUNTS:   # every line logged before any is held
        text = cuda_build.build_info[m]["ptxas"]
        got = ptxas(text)
        k1 = (*got.get("K1", ()), ptxas_smem(text).get("K1", 0))
        lib = cuda_build.load(m)
        slot = lib.nmpc_k1_slot_bytes(0)
        # K1's dynamic shared memory: a slot a warp, then the parameter block
        # at the main path's eight alphas
        k1_prm = 4 * rollout_ops._P(3 * m, 2 * m, len(ALILQRConfig().alphas)).size
        block = k1[-1] + k1_prm + megasolve.K1_WARPS * slot
        k3g = cuda_build.k3_geometry(lib)
        k4g = cuda_build.k4_geometry(lib, staged_tiles.k4_rows(m, m > 1, 0, 0),
                                     rollout_ops._P(3 * m, 2 * m, 0).size)
        k5g = cuda_build.k5_geometry(lib, staged_tiles.k5_rows(m, m > 1, 0, 0),
                                     rollout_ops._P(3 * m, 2 * m, 9).size)
        k6g = cuda_build.k6_geometry(lib)
        staged = {"K3": (*got.get("K3", ()), k3g["smem_bytes"]),
                  "K4": (*got.get("K4", ()), k4g["smem_bytes"]),
                  "K5": (*got.get("K5", ()), k5g["smem_bytes"]),
                  "K6": (*got.get("K6", ()), k6g["smem_bytes"])}
        lines[m] = (got, k1, block, staged)
        log(f"  ptxas m={m}: {ptxas_summary(text)}; K1 static shared {k1[-1]} B + "
            f"{megasolve.K1_WARPS} warps x {slot} B slot + parameters {k1_prm} B = {block} B a block; "
            f"K3 {staged['K3']}, K4 {staged['K4']}, K5 {staged['K5']}, K6 {staged['K6']} (regs, "
            f"stack, spills, dynamic shared B a block; K3 S={k3g['S']} D={k3g['D']} T={k3g['T']} "
            f"P={k3g['P']} spill={k3g['spill']}, K4 S={k4g['S']} W={k4g['W']}, K5 S={k5g['S']} "
            f"D={k5g['D']}, K6 S={k6g['S']} D={k6g['D']} T={k6g['T']}) (K1 as recorded in "
            f"PERF.md: {'yes' if k1 == K1_PTXAS[m] else 'NO'}; K3-K6: "
            f"{'yes' if staged == STAGED_PTXAS[m] else 'NO'})")
    for m in cuda_build.FIRST_ROBOTS:
        first = ptxas(cuda_build.first_build_info[m]["ptxas"])
        log(f"  ptxas first designs m={m}: " + ", ".join(f"{k} {v}" for k, v in first.items())
            + f" (as recorded in PERF.md: {'yes' if first == FIRST_STAGED_PTXAS[m] else 'NO'})")
    for m in cuda_build.FIRST_ROBOTS:
        first = ptxas(cuda_build.first_build_info[m]["ptxas"])
        assert first == FIRST_STAGED_PTXAS[m], (m, first)
    for m, (got, k1, block, staged) in lines.items():
        assert k1 == K1_PTXAS[m], (m, k1)
        assert staged == STAGED_PTXAS[m], (m, staged)
        assert set(got) == SOLVER_KERNELS | (TEAM_KERNELS if m in cuda_build.TEAM_ROBOTS
                                             else set()), got
        assert block <= 227 * 1024, (m, block)   # the H100's shared memory per block
        assert all(v[-1] <= 227 * 1024 for v in staged.values()), (m, staged)
    tool_lines = {}
    for part, text in tools["ptxas"].items():
        log(f"  ptxas tools m={cuda_build.BENCH_ROBOTS} {part}: {ptxas_summary(text, part)}")
        tool_lines.update(ptxas(text, part))
    want_names = {f"K7 C={c}" for c in (4, 8, 16, 32)} | set(cuda_build.TOOLS_PARTS[1:])
    assert set(tool_lines) == want_names, sorted(tool_lines)
    log(f"  K8 'full, early exit' has K1's first design's recorded line {FIRST_K1_PTXAS}: "
        f"{'yes' if tool_lines['K8 full, early exit'] == FIRST_K1_PTXAS else 'NO'}")
    assert tool_lines["K8 full, early exit"] == FIRST_K1_PTXAS, tool_lines["K8 full, early exit"]
    warp_lines = {p: tool_lines[p] for p in cuda_build.TOOLS_PARTS if " warp " in p}
    tools6 = cuda_build.load_tools(cuda_build.BENCH_ROBOTS)
    slot_w, slot_d = tools6.nmpc_warp_slot_bytes(0), tools6.nmpc_warp_slot_bytes(1)
    n6, nu6 = 3 * cuda_build.BENCH_ROBOTS, 2 * cuda_build.BENCH_ROBOTS
    log(f"  the warp design's tools parts m={cuda_build.BENCH_ROBOTS} (regs, stack, spill stores, "
        f"spill loads): " + "; ".join(f"{k} {v}" for k, v in warp_lines.items())
        + f" (as recorded in PERF.md: {'yes' if warp_lines == WARP_TOOLS_PTXAS else 'NO'}; "
        f"'full, early exit' has K1's line: "
        f"{'yes' if warp_lines['K8 warp full, early exit'] == K1_PTXAS[6][:4] else 'NO'}); a "
        f"warp's slot {slot_w} B (K1's {cuda_build.load(6).nmpc_k1_slot_bytes(0)} B), K9's dense "
        f"slot {slot_d} B (+{slot_d - slot_w} B: lxx and luu)")
    assert warp_lines["K8 warp full, early exit"] == K1_PTXAS[6][:4], warp_lines
    assert warp_lines == WARP_TOOLS_PTXAS, warp_lines
    assert slot_w == cuda_build.load(6).nmpc_k1_slot_bytes(0), slot_w
    assert slot_d == slot_w + 4 * (n6 * n6 + nu6 * nu6), (slot_w, slot_d)

    gen = torch.Generator(device=dev).manual_seed(0)
    base = get("six_robot_antipodal").make(N=10, device=dev)
    bench_cfg = ALILQRConfig(n_outer=6, n_inner=12, tol_con=1e-3, ls="adaptive")

    def batch(ocp, B, spread=0.1, g=gen):
        noise = torch.randn((B, ocp.nx), generator=g, device=dev)
        return batch_ocp(ocp, ocp.x0[None] + spread * noise)

    def warm_state(ocp, B, g=gen):
        """A mid-solve warm state: small controls, nonnegative duals (zero
        on the masked stage-0 rows), mu across the whole schedule."""
        U = 0.05 * torch.randn((B, ocp.N, ocp.nu), generator=g, device=dev)
        lam = 0.5 * torch.randn((B, ocp.N, ocp.n_con), generator=g, device=dev).abs()
        lam = lam * (P.constraint_mask(ocp) > 0)
        mu = torch.tensor([10.0, 100.0, 1e3, 1e4], device=dev)[
            torch.randint(0, 4, (B,), generator=g, device=dev)]
        return U, lam, mu

    # ---- phase 2: K2 against its plain version ----------------------------
    ob = batch(base, BENCH_B)
    Xs = base.x0[None, None] + 0.3 * torch.randn(
        (BENCH_B, base.N, base.nx), generator=gen, device=dev)
    U, lam, mu = warm_state(base, BENCH_B)
    k2_err = hold_k2(f"phase 2 K2 vs plain: six_robot_antipodal N=10 B={BENCH_B}", ob, Xs, U, lam,
                     mu, bench_cfg.lam_max)

    # ---- phase 3: K1 against its plain version ----------------------------
    # n_inner=4 (hold_k1)
    # (B=33: a ragged last block of K1's warps, drawn from a generator of its
    # own so that the later phases draw the inputs they drew before it)
    g33 = torch.Generator(device=dev).manual_seed(33)
    for name, ls, Bk in (("six_robot_antipodal", "adaptive", K1_B),
                         ("six_robot_antipodal", "cascade", K1_B),
                         ("two_robot_swap", "adaptive", K1_B),
                         ("six_robot_antipodal", "cascade", 33)):
        ocp = get(name).make(N=10, device=dev)
        g = g33 if Bk == 33 else gen
        obk = batch(ocp, Bk, g=g)
        U, lam, mu = warm_state(ocp, Bk, g=g)
        cfg = ALILQRConfig(n_outer=6, n_inner=4, tol_con=1e-3, ls=ls)
        got = hold_k1(f"phase 3 K1 vs plain: {name} N=10 B={Bk} ls={ls} n_inner=4", obk, U, lam,
                      mu, cfg)
        if name == "six_robot_antipodal" and ls == "adaptive":
            k1_case = (obk, U, lam, mu, cfg, got)   # phase 13's first-design check

    # ---- phase 4: the main path ------------------------------------------
    ob = batch(base, BENCH_B)
    # the layout copies K1's and K2's wrappers make: counted (none expected)
    copies = {"lane": 0, "std": 0}

    def counting(name, fn):
        def wrapped(t):
            copies[name] += 1
            return fn(t)
        return wrapped

    real_copies = megasolve.lane, megasolve.std
    megasolve.lane, megasolve.std = counting("lane", megasolve.lane), counting("std", megasolve.std)
    torch.cuda.synchronize()
    cuda_build.reset_launch_counts()
    try:
        res = solve_batched(ob, cfg=bench_cfg)
        torch.cuda.synchronize()
    finally:
        megasolve.lane, megasolve.std = real_copies
    counts = dict(cuda_build.launch_counts)
    steps = int(res.outer_iters.max())
    assert counts["inner_solve_fused"] == steps, (counts, steps)
    assert counts["al_update_lanes"] == steps, (counts, steps)
    assert sum(counts.values()) == 2 * steps, counts  # no staged kernel on this route
    assert torch.isfinite(res.cost).all() and torch.isfinite(res.viol).all()
    assert torch.isfinite(res.X).all() and torch.isfinite(res.U).all()
    conv = float(res.converged.float().mean())
    viol_p99 = float(torch.quantile(res.viol, 0.99))
    mean_inner = float(res.inner_iters.float().mean())
    log(f"phase 4 main path: six_robot_antipodal N=10 B={BENCH_B} {bench_cfg.ls}: launches "
        f"{counts} over {steps} outer steps; converged {conv:.4f}, viol p99 {viol_p99:.3e}, "
        f"max {float(res.viol.max()):.3e}, mean inner iters {mean_inner:.2f}, "
        f"mean cost {float(res.cost.mean()):.4f}; layout copies in K1's and K2's wrappers {copies}")
    assert copies == {"lane": 0, "std": 0}, copies
    # at least the first design's level on such a batch (converged 0.9990,
    # viol p99 5.3e-4)
    assert conv >= 0.995 and viol_p99 <= 1e-3, (conv, viol_p99)

    # ---- phase 5: CPU cross-check of the first scenarios ------------------
    cpu = torch.device("cpu")
    cross_check("phase 5 CPU cross-check", res, batch_ocp(base.to(cpu), ob.x0[:CROSS_B].to(cpu)),
                bench_cfg, CROSS_B)

    # ---- phase 6: timings ---------------------------------------------------
    times = []
    for i in range(4):  # the first run is the warm-up
        obi = batch(base, BENCH_B)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = solve_batched(obi, cfg=bench_cfg)
        torch.cuda.synchronize()
        if i:
            times.append(time.perf_counter() - t0)
    assert torch.isfinite(r.cost).all()
    sps = [BENCH_B / t for t in times]
    log(f"phase 6 solve_batched B={BENCH_B}: {', '.join(f'{t * 1e3:.1f}' for t in times)} ms "
        f"-> median {statistics.median(sps):.1f} solves/s, best {max(sps):.1f} solves/s {card}")

    # the main path with K1 and, in turns, with K1's first design in its place
    # (the tools library's `K8 full, early exit`, layout copies included; K2
    # is the same in both), on phase 4's batch
    def first_design(ocp_b, x0, xref, lam, mu, U, cfg):
        return K8.phase_ablation(ocp_b, x0, xref, lam, mu, U, cfg, "full", cfg.n_inner,
                                 early_exit=True, design="first")

    def solve_with(**kernels):
        """solve_batched on phase 4's batch with the solver's K1 / K2 calls
        replaced; returns its ms on the host clock."""
        real = {k: getattr(AB, k) for k in kernels}
        for k, fn in kernels.items():
            setattr(AB, k, fn)
        try:
            return timed(lambda: solve_batched(ob, cfg=bench_cfg))[1] * 1e3
        finally:
            for k, fn in real.items():
                setattr(AB, k, fn)

    designs = {"K1": megasolve.inner_solve_fused, "first design": first_design}
    solve_ms = {k: [] for k in designs}
    for k in ("K1", "first design", "first design", "K1") * 2:
        solve_ms[k].append(solve_with(inner_solve_fused=designs[k]))
    solve_ms = {k: v[1:] for k, v in solve_ms.items()}   # the first of each: the warm-up
    sps_ab = {k: BENCH_B / (statistics.median(v) / 1e3) for k, v in solve_ms.items()}
    log(f"phase 6 main path on phase 4's batch, in turns (K1, first, first, K1, twice; the "
        f"first of each a warm-up): K1 "
        + ", ".join(f"{t:.1f}" for t in solve_ms["K1"]) + " ms, K1's first design "
        + ", ".join(f"{t:.1f}" for t in solve_ms["first design"]) + f" ms -> medians "
        f"{sps_ab['K1']:.1f} and {sps_ab['first design']:.1f} solves/s {card}")
    assert sps_ab["K1"] >= sps_ab["first design"], sps_ab

    # K1 per outer step, K2, and the rest of one main-path solve (CUDA events
    # around each wrapper)
    steps_ms = {"inner_solve_fused": [], "al_update_lanes": []}

    def evented(name):
        fn = getattr(megasolve, name)

        def wrapped(*args):
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            out = fn(*args)
            e1.record()
            steps_ms[name].append((e0, e1))
            return out
        return wrapped

    wall_ms = solve_with(**{k: evented(k) for k in steps_ms})
    steps_ms = {k: [e0.elapsed_time(e1) for e0, e1 in v] for k, v in steps_ms.items()}
    k1_tot, k2_tot = sum(steps_ms["inner_solve_fused"]), sum(steps_ms["al_update_lanes"])
    log(f"phase 6 one main-path solve: {wall_ms:.1f} ms; K1 per outer step "
        + ", ".join(f"{t:.2f}" for t in steps_ms["inner_solve_fused"]) + f" ms (sum {k1_tot:.1f}, "
        f"{100 * k1_tot / wall_ms:.1f}%), K2 {k2_tot:.2f} ms ({100 * k2_tot / wall_ms:.2f}%), the "
        f"rest {wall_ms - k1_tot - k2_tot:.1f} ms {card}")

    # K1 and its first design in turns at two states: the first outer step's
    # inputs (zero warm controls and duals, mu_init: every scenario runs all
    # iterations) and phase 4's converged state. At both the plain version is
    # timed, counts the work the bounds of phase 14 take (iterations run,
    # line-search candidates), and holds K1 and its first design at phase 3's
    # tolerances. Over 12 iterations f32 alone parts a share of the scenarios
    # (an alpha or a stop decided by a tie, U then differs by up to ~1): the
    # plain version against itself with its inputs moved by about an ulp
    # shows how many. K1 may miss on at most twice as many plus 0.1%, and its
    # cost must agree within rtol 1e-4 on all but 0.1%.
    kw = dict(dtype=torch.float32, device=dev)
    U0 = torch.zeros((BENCH_B, base.N, base.nu), **kw)
    lam0 = torch.zeros((BENCH_B, base.N, base.n_con), **kw)
    mu0 = torch.full((BENCH_B,), bench_cfg.mu_init, **kw)
    g_ulp = torch.Generator(device=dev).manual_seed(23)   # leaves `gen`'s draws as they were
    k1_at, k1_work = {}, {}
    for state, (lam_s, mu_s, U_s) in (("first step", (lam0, mu0, U0)),
                                      ("converged", (res.lam, res.mu, res.U))):
        runs = {k: functools.partial(fn, ob, ob.x0, ob.xref, lam_s, mu_s, U_s, bench_cfg)
                for k, fn in designs.items()}
        t = K8.time_in_turns(runs, ("K1", "first design", "first design", "K1"), 2)
        k1_at[state] = {k: statistics.median(v) for k, v in t.items()}
        got = runs["K1"]()
        it = RL.k1_executed(got[3], bench_cfg.n_inner).float()
        log(f"phase 6 K1 at B={BENCH_B}, {state} ({float(it.mean()):.2f} iterations run per "
            f"scenario), in turns, median of 4: {k1_at[state]['K1']:.2f} ms, first design "
            f"{k1_at[state]['first design']:.2f} ms ({k1_at[state]['first design'] / k1_at[state]['K1']:.2f}x) {card}")
        assert k1_at[state]["K1"] <= k1_at[state]["first design"], (state, k1_at[state])
        cand = torch.zeros(BENCH_B, dtype=torch.int64, device=dev)
        want, plain_ms = once(lambda: megasolve.inner_solve_plain(
            ob, ob.x0, ob.xref, lam_s, mu_s, U_s, bench_cfg, candidates=cand))
        ulp = lambda t: t * (1.0 + 2.0 ** -23 * torch.randn(t.shape, generator=g_ulp, device=dev))  # noqa: E731
        spread = megasolve.inner_solve_plain(ob, ulp(ob.x0), ob.xref, lam_s, mu_s, ulp(U_s), bench_cfg)
        n_spread = hold_solve("plain vs itself", spread, want, allow=1.0)[0]
        n_first = hold_solve("first design vs plain", runs["first design"](), want, allow=1.0)[0]
        missed, rel, du, dx = hold_solve(f"K1 vs plain, {state}", got, want,
                                         allow=1e-3 + 2 * n_spread / BENCH_B)
        cost_missed = int(((got[2] - want[2]).abs() > 1e-4 * want[2].abs()).sum())
        same = int((got[3] == want[3]).sum())
        run = RL.k1_executed(want[3], bench_cfg.n_inner)
        k1_work[state] = (int(run.sum()), int(cand.sum()))
        log(f"phase 6 K1 vs plain at B={BENCH_B}, {state}: outside cost rtol 1e-4 / U, Xs atol "
            f"5e-3 on {missed}/{BENCH_B} scenarios (cost alone on {cost_missed}; the plain "
            f"version against itself with inputs moved by 2^-23: {n_spread}; K1's first design: "
            f"{n_first}); over all, cost rel max {rel:.3e}, U max |err| {du:.3e}, Xs max |err| "
            f"{dx:.3e}; iteration counts equal {same}/{BENCH_B}; plain {plain_ms:.1f} ms, "
            f"{float(run.float().mean()):.2f} iterations and {float(cand.float().mean()):.2f} "
            f"line-search candidates needed per scenario")
        assert cost_missed <= 1e-3 * BENCH_B, (state, cost_missed)
        if state == "first step":
            k1_plain_ms, k1_err = plain_ms, du
        del want, got, spread
    k1_ms = k1_at["first step"]["K1"]
    Xs1, U1 = res.X[:, :-1].contiguous(), res.U
    k2_ms = cuda_ms(lambda: megasolve.al_update_lanes(ob, Xs1, U1, res.lam, res.mu, bench_cfg.lam_max), 20)
    k2_plain_ms = cuda_ms(lambda: megasolve.al_update_plain(ob, Xs1, U1, res.lam, res.mu, bench_cfg.lam_max), 20)
    # the layout copies the first design's wrappers made per outer step: K1's
    # inputs and outputs, K2's inputs and output
    N, nc = base.N, base.n_con
    Xs_l, Uo_l = torch.empty((N, base.nx, BENCH_B), **kw), torch.empty((N, base.nu, BENCH_B), **kw)
    lam_l, lam_o = torch.empty((N, nc, BENCH_B), **kw), torch.empty((BENCH_B, N, nc), **kw)

    def first_copies():
        for t in (ob.x0, ob.xref, res.lam, res.U, Xs1, res.U, res.lam):
            lane(t)
        std(Xs_l), std(Uo_l)
        lam_o.copy_(lam_l.movedim(-1, 0))

    copy_ms = cuda_ms(first_copies, 20)
    log(f"phase 6 kernels at B={BENCH_B}: K1 {k1_ms:.2f} ms vs plain {k1_plain_ms:.2f} ms; "
        f"K2 {k2_ms:.3f} ms vs plain {k2_plain_ms:.3f} ms (first design {FIRST_K2_MS} ms as "
        f"recorded); layout copies per outer step: the first design's wrappers {copy_ms:.3f} ms, "
        f"K1's and K2's none (phase 4) {card}")

    # ---- phase 7: path (a), the main-path batch on the staged route ----------
    staged_cfg = dataclasses.replace(bench_cfg, mega=False)
    cuda_build.reset_launch_counts()
    res_a, t_a = timed(lambda: solve_batched(ob, cfg=staged_cfg))
    counts_a = dict(cuda_build.launch_counts)
    check_staged("phase 7 path (a)", counts_a, res_a, staged_cfg)
    log(f"phase 7 path (a): six_robot_antipodal N=10 B={BENCH_B}, bench config with "
        f"mega=False: launches {counts_a}; {summary(res_a)}; {t_a * 1e3:.1f} ms")
    log(f"  main path on the same batch (phase 4): {summary(res)}")
    assert float(res_a.converged.float().mean()) >= 0.8  # gross-fault floor
    cross_check("  path (a)", res_a, batch_ocp(base.to(cpu), ob.x0[:CROSS_B].to(cpu)),
                staged_cfg, CROSS_B)

    # ---- phase 8: path (b), a family-H fleet: six static obstacles ---------
    obs_base = get("obstacle_scenario_3").make(device=dev)      # registry horizon N=100
    # mega=False: the staged route (phase 22 runs the megakernel route here)
    obs_cfg = ALILQRConfig(n_outer=12, n_inner=25, tol_con=1e-3, mega=False)
    ob_b = batch(obs_base, BENCH_B, spread=0.05)
    cuda_build.reset_launch_counts()
    res_b, t_b = timed(lambda: solve_batched(ob_b, cfg=obs_cfg))
    counts_b = dict(cuda_build.launch_counts)
    check_staged("phase 8 path (b)", counts_b, res_b, obs_cfg)
    log(f"phase 8 path (b): obstacle_scenario_3 N={obs_base.N} B={BENCH_B}, n_obs="
        f"{obs_base.n_obs}, mega=False: launches {counts_b}; {summary(res_b)}; "
        f"{t_b * 1e3:.1f} ms")
    assert float(res_b.converged.float().mean()) >= 0.9
    # U on 60%: the slalom's turn rates are flat in the cost, so U agrees to
    # 5e-3 on only ~69% of scenarios even between the plain path in f32 and
    # in f64 (22/32 on a CPU batch like this one, costs within 1.6e-5)
    cross_check("  path (b)", res_b, batch_ocp(obs_base.to(cpu), ob_b.x0[:OBS_CROSS_B].to(cpu)),
                obs_cfg, OBS_CROSS_B, u_share=0.6)

    # ---- phase 9: path (c), one decentralized six-robot round ---------------
    mov_cfg = ALILQRConfig(n_outer=6, n_inner=12, tol_con=1e-4, mega=False)
    ob_c = decentralized_round(P.make_ocp, dev, gen, MOV_B)
    cuda_build.reset_launch_counts()
    res_c, t_c = timed(lambda: solve_batched(ob_c, cfg=mov_cfg))
    counts_c = dict(cuda_build.launch_counts)
    check_staged("phase 9 path (c)", counts_c, res_c, mov_cfg)
    log(f"phase 9 path (c): one robot, {ob_c.n_mov} moving obstacles (per-scenario "
        f"schedules), N={ob_c.N} B={MOV_B}: launches {counts_c}; {summary(res_c)}; "
        f"{t_c * 1e3:.1f} ms")
    sub_c = dataclasses.replace(ob_c, x0=ob_c.x0[:OBS_CROSS_B], xref=ob_c.xref[:OBS_CROSS_B],
                                mov_obs=ob_c.mov_obs[:OBS_CROSS_B]).to(cpu)
    cross_check("  path (c)", res_c, sub_c, mov_cfg, OBS_CROSS_B)

    # ---- phase 10: K3-K6 against their plain versions -----------------------
    # at each path's shape, on its last iterate: (i) with fresh multipliers of
    # the CPU tests' kind (|N(0, 0.5)|, zero on the masked rows, mu in {10,
    # 100}), where every unit must pass at the CPU tolerance without the f32
    # spread; (ii) with the solve's own multipliers and penalty weights (mu
    # up to 1e4), where K3 and K6 may need it. At most 1% of the units may
    # diverge at either.
    errs, ms, turns_ab = {}, {}, {}
    for tag, ocp_b, r, cfg in (("a", ob, res_a, staged_cfg), ("b", ob_b, res_b, obs_cfg),
                               ("c", ob_c, res_c, mov_cfg)):
        for state, v, calls, ab in hold_staged_kernels(f"phase 10 K3-K6 vs plain at path ({tag})",
                                                       ocp_b, r, cfg, gen):
            if state == "ii" and tag in ("a", "b"):
                ms[tag] = {k: (cuda_ms(c[0], 5), cuda_ms(c[1], 1)) for k, c in calls.items()}
                turns_ab[tag] = ab
            for k, x in v.items():
                errs[k] = max(errs.get(k, 0.0), x.err)

    # ---- phase 11: staged timings --------------------------------------------
    turns = []
    for cfg in (bench_cfg, staged_cfg, staged_cfg, bench_cfg):
        turns.append(timed(lambda: solve_batched(ob, cfg=cfg))[1] * 1e3)
    log(f"phase 11 solve at B={BENCH_B} on the main-path batch, in turns: megakernel "
        f"{turns[0]:.1f}, {turns[3]:.1f} ms; staged {turns[1]:.1f}, {turns[2]:.1f} ms {card}")
    log(f"phase 11 staged solves (phases 7-9, one run each): (a) {t_a * 1e3:.1f} ms, (b) "
        f"{t_b * 1e3:.1f} ms, (c) {t_c * 1e3:.1f} ms {card}")
    for tag in ("a", "b"):
        log(f"phase 11 kernels at path ({tag}): " + "; ".join(
            f"{k} {v[0]:.3f} ms vs plain {v[1]:.3f} ms" for k, v in ms[tag].items()) + f" {card}")
    # K3-K6 against their first designs, in turns (tile, first, first, tile,
    # twice; median of 4) at phase 10's state (ii) of (a) and (b), each with
    # its share of the bound (tools/roofline.py::kernel_work on these
    # shapes); then the staged solves of (a) and (b) with K3's and K5's or
    # K4's and K6's first designs swapped in
    from nmpc_tpu_torch.tools import staged_launch as SL

    first_ms = {}
    for tag, ocp_p, cfg_p in (("a", base, staged_cfg), ("b", obs_base, obs_cfg)):
        shares = {}
        for k, (new_call, first_call) in turns_ab[tag].items():
            t = K8.time_in_turns({"tile": new_call, "first": first_call},
                                 ("tile", "first", "first", "tile"), 2)
            first_ms[tag, k] = {d: statistics.median(v) for d, v in t.items()}
            b_ms = RL.bound(*RL.kernel_work(k, ocp_p, BENCH_B, n_alphas=len(cfg_p.alphas) + 1))[0]
            shares[k] = (b_ms, b_ms / ms[tag][k][0], b_ms / first_ms[tag, k]["first"])
        log(f"phase 11 K3-K6 at path ({tag}), in turns, median of 4: " + "; ".join(
            f"{k} {v['tile']:.3f} ms, first design {v['first']:.3f} ms "
            f"({v['first'] / v['tile']:.2f}x)" for k in ("K3", "K4", "K5", "K6")
            for v in [first_ms[tag, k]]) + "; mean of 5 back-to-back launches against the bound: "
            + "; ".join(f"{k} {ms[tag][k][0]:.3f} ms, bound {sh[0]:.4f} ms, {100 * sh[1]:.1f}% "
                        f"(first design in turns {100 * sh[2]:.1f}%)" for k, sh in shares.items())
            + f" {card}")
        for k in ("K3", "K5"):
            assert first_ms[tag, k]["tile"] < first_ms[tag, k]["first"], (tag, k, first_ms[tag, k])

    firsts = {"K3/K5": {(AB, "riccati_lanes"): SL.riccati_first,
                        (rollout_ops, "linesearch_costs_lanes"): SL.linesearch_costs_first},
              "K4/K6": {(AB, "expansions_fused"): SL.expansions_first,
                        (rollout_ops, "rollout_alpha_lanes"): SL.rollout_alpha_first}}

    def staged_solve(ocp_b, cfg, swap):
        """solve_batched's ms with the tile designs or, swap naming a pair of
        `firsts`, that pair's first designs."""
        real = {key: getattr(*key) for key in firsts.get(swap, {})}
        for (mod, name), fn in firsts.get(swap, {}).items():
            setattr(mod, name, fn)
        try:
            return timed(lambda: solve_batched(ocp_b, cfg=cfg))[1] * 1e3
        finally:
            for (mod, name), fn in real.items():
                setattr(mod, name, fn)

    for tag, ocp_b, cfg in (("a", ob, staged_cfg), ("b", ob_b, obs_cfg)):
        sol = {"tiles": [], "K3/K5": [], "K4/K6": []}
        for swap in ("tiles", "K4/K6", "K3/K5", "K3/K5", "K4/K6", "tiles"):
            sol[swap].append(staged_solve(ocp_b, cfg, swap))
        log(f"phase 11 staged solve of path ({tag}) in turns (tiles, K4/K6 first, K3/K5 first, "
            f"K3/K5 first, K4/K6 first, tiles): the tile designs "
            f"{', '.join(f'{t:.1f}' for t in sol['tiles'])} ms; with K3's and K5's first designs "
            f"{', '.join(f'{t:.1f}' for t in sol['K3/K5'])} ms; with K4's and K6's first designs "
            f"{', '.join(f'{t:.1f}' for t in sol['K4/K6'])} ms {card}")

    # where one staged solve's time goes: CUDA events around each staged
    # kernel's wrapper (the wrappers' own host work included), the rest is
    # the host loop and the plain PyTorch ops between the kernels
    owners = {"expansions_fused": AB, "riccati_lanes": AB, "linesearch_costs_lanes": rollout_ops,
              "rollout_alpha_lanes": rollout_ops}
    names = {"expansions_fused": "K4", "riccati_lanes": "K3", "linesearch_costs_lanes": "K5",
             "rollout_alpha_lanes": "K6"}
    for tag, ocp_b, cfg in (("a", ob, staged_cfg), ("b", ob_b, obs_cfg)):
        events = {k: [] for k in owners}
        real = {k: getattr(mod, k) for k, mod in owners.items()}

        def evented_staged(name):
            def wrapped(*args):
                e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                e0.record()
                out = real[name](*args)
                e1.record()
                events[name].append((e0, e1))
                return out
            return wrapped

        for k, mod in owners.items():
            setattr(mod, k, evented_staged(k))
        try:
            wall = timed(lambda: solve_batched(ocp_b, cfg=cfg))[1] * 1e3
        finally:
            for k, mod in owners.items():
                setattr(mod, k, real[k])
        spent = {names[k]: sum(e0.elapsed_time(e1) for e0, e1 in v) for k, v in events.items()}
        rest = wall - sum(spent.values())
        log(f"phase 11 one staged solve of path ({tag}): {wall:.1f} ms; " + ", ".join(
            f"{k} {t:.1f} ms ({100 * t / wall:.1f}%)" for k, t in spent.items())
            + f"; the rest {rest:.1f} ms ({100 * rest / wall:.1f}%) {card}")

    # ---- phase 12: K7, the attainable FMA rate ------------------------------
    # bit for bit: each f64 step of the plain chain is exact for these
    # constants near 1 and rounds once to f32, as the FMA does
    a7, b7, R7 = RL.FMA_A, RL.FMA_B, RL.FMA_STEPS
    for C in RL.FMA_CHAINS:
        x0 = 1.0 + 1e-3 * torch.rand((C, 1000), generator=gen, device=dev)
        got = RL.fma_peak(x0, a7, b7, 64)
        torch.cuda.synchronize()
        want = RL.fma_chain_plain(x0, a7, b7, 64)
        assert torch.equal(got, want), (C, float((got - want).abs().max()))
    log(f"phase 12 K7 vs plain: C in {RL.FMA_CHAINS}, 1000 threads, 64 steps: bit for bit")
    cuda_build.reset_launch_counts()
    peak = RL.measure_fma_peak()
    k7_launches = cuda_build.launch_counts["fma_peak"]
    best = peak["best"]
    T7 = RL.FMA_THREADS
    x7 = RL.fma_inputs(best["chains"], T7, dev)
    # the card's clocks and power under the probe: ~1 s of it enqueued, sampled, then waited for
    for _ in range(max(1, int(1000 / (16 * best["ms"])))):
        RL.fma_peak(x7, a7, b7, 16 * R7)
    clocks = sh(["nvidia-smi", "--query-gpu=clocks.sm,power.draw,power.limit",
                 "--format=csv,noheader"]).splitlines()[0]
    torch.cuda.synchronize()
    # kernel and plain version at the timed shape, bit for bit
    want7, k7_plain_ms = once(lambda: RL.fma_chain_plain(x7, a7, b7, R7))
    got7 = RL.fma_peak(x7, a7, b7, R7)
    k7_err = float((got7 - want7).abs().max())
    assert torch.equal(got7, want7), k7_err
    log(f"phase 12 K7 vs plain at the timed shape (C={best['chains']}, {T7} threads, {R7} "
        f"steps): bit for bit")
    del want7, got7
    log(f"phase 12 K7 sweep, {T7} threads x C chains x {R7} steps: " + ", ".join(
        f"C={c} {peak[c]['tflops']:.2f} TFLOP/s ({peak[c]['ms']:.3f} ms)" for c in RL.FMA_CHAINS)
        + f"; best C={best['chains']}: {best['tflops']:.2f} TFLOP/s = "
        f"{best['tflops'] / RL.PUBLISHED_FMA_TFLOPS:.3f} of the published "
        f"{RL.PUBLISHED_FMA_TFLOPS:.0f}; plain {k7_plain_ms:.1f} ms; launches {k7_launches}; "
        f"under load: clocks.sm, power.draw, power.limit = {clocks} {card}")
    # above 1.05x the compiler removed work; below 0.5x the probe is latency-bound
    assert 0.5 * RL.PUBLISHED_FMA_TFLOPS <= best["tflops"] <= 1.05 * RL.PUBLISHED_FMA_TFLOPS, best

    # ---- phase 13: K8, K1 with one phase ablated -------------------------------
    # K8 runs on K1's warp design by default (the solver's K1 under the
    # template flags of inner_warp.cuh); its first design (megasolve.cuh, one
    # thread per scenario) is the A/B baseline (design="first").
    # Drift guard: the warp design's `full` with the early exit is the
    # solver's K1, bit for bit, on phase 3's batch
    obk, U3, lam3, mu3, cfg3, k1_out = k1_case
    full_ee_w = K8.phase_ablation(obk, obk.x0, obk.xref, lam3, mu3, U3, cfg3, "full", cfg3.n_inner,
                                  early_exit=True)
    same_bits = [torch.equal(a, b) for a, b in zip(full_ee_w, k1_out)]
    log(f"phase 13 K8 warp 'full' with the early exit against K1 on phase 3's batch "
        f"(six_robot_antipodal N=10 B={K1_B} adaptive, n_inner={cfg3.n_inner}): Xs, U, cost, iters "
        f"bit for bit {same_bits}")
    assert all(same_bits), same_bits
    # the first design's: held against plain at phase 3's tolerances, and K1
    # against it
    full_ee = K8.phase_ablation(obk, obk.x0, obk.xref, lam3, mu3, U3, cfg3, "full", cfg3.n_inner,
                                early_exit=True, design="first")
    want = megasolve.inner_solve_plain(obk, obk.x0, obk.xref, lam3, mu3, U3, cfg3)
    _, rel_f, du_f, _ = hold_solve("K1's first design vs plain", full_ee, want, allow=0.01)
    _, rel_k, du_k, _ = hold_solve("K1 vs its first design", k1_out, full_ee, allow=0.01)
    same_f = int((full_ee[3] == want[3]).sum())
    same_k = int((k1_out[3] == full_ee[3]).sum())
    assert min(same_f, same_k) >= 0.99 * K1_B, (same_f, same_k)
    log(f"phase 13 K8 first design 'full' with the early exit (K1's first design) on phase 3's "
        f"batch: vs plain cost rel max {rel_f:.3e}, U max |err| {du_f:.3e}, iteration counts "
        f"equal {same_f}/{K1_B}; K1 vs it cost rel max {rel_k:.3e}, U max |err| {du_k:.3e}, "
        f"iteration counts equal {same_k}/{K1_B}")
    # at phase 3's inputs (mu up to 1e4) the undamped alpha = 1 steps of the
    # modes without a line search diverge on many scenarios: there the plain
    # version in f32 parts from itself in f64 as far as from the kernel. The
    # kernel may miss the f64 run on no more scenarios than the plain f32
    # version does, plus 2% of those not diverged
    for design in K8.DESIGNS:
        for mode in ("inv_solve", "no_ls"):
            got = K8.phase_ablation(obk, obk.x0, obk.xref, lam3, mu3, U3, cfg3, mode, 4,
                                    design=design)
            w = K8.f64_witness(obk, obk.x0, obk.xref, lam3, mu3, U3, cfg3, mode, 4, got)
            held = w["scenarios"] - w["diverged"]
            log(f"phase 13 K8 {design} {mode} at phase 3's inputs (B={K1_B}, 4 fixed iterations, "
                f"mu up to 1e4): diverged in f64 {w['diverged']}/{w['scenarios']}; on the other "
                f"{held}, U parts from f64 by > 5e-3 on {w['plain_missed']} (plain f32) and "
                f"{w['kernel_missed']} (kernel); max |dU| kernel vs plain "
                f"{w['kernel_vs_plain']:.3e}, plain vs f64 {w['plain_vs_f64']:.3e}, kernel vs f64 "
                f"{w['kernel_vs_f64']:.3e}")
            assert w["kernel_missed"] <= w["plain_missed"] + max(2, 0.02 * held), (design, w)
    # each mode of each design at the ablation's own inputs (lam 0, mu 10,
    # U 0) on phase 3's starts, where no scenario diverges: Xs, U and cost at
    # phase 3's tolerances (every mode but full and sweep_only returns the
    # initial merit as its cost, so Xs and U are what test the ablated sweep)
    lam0k, mu10k, U0k = torch.zeros_like(lam3), torch.full_like(mu3, 10.0), torch.zeros_like(U3)
    for design in K8.DESIGNS:
        for mode in K8.MODES:
            got = K8.phase_ablation(obk, obk.x0, obk.xref, lam0k, mu10k, U0k, cfg3, mode, 4,
                                    design=design)
            torch.cuda.synchronize()
            want = K8.phase_ablation_plain(obk, obk.x0, obk.xref, lam0k, mu10k, U0k, cfg3, mode, 4)
            _, rel, du, dx = hold_solve(f"K8 {design} {mode}", got, want)
            log(f"phase 13 K8 {design} {mode} vs plain, B={K1_B}, 4 fixed iterations, lam 0, mu "
                f"10, U 0: cost rel max {rel:.3e}, U max |err| {du:.3e}, Xs max |err| {dx:.3e}, "
                f"mean cost {float(got[2].mean()):.4f}")
            assert (got[3] == 4).all()
    kw = dict(dtype=torch.float32, device=dev)
    n72 = bench_cfg.n_outer * bench_cfg.n_inner
    lam8 = torch.zeros((BENCH_B, base.N, base.n_con), **kw)
    mu8 = torch.full((BENCH_B,), 10.0, **kw)
    U8 = torch.zeros((BENCH_B, base.N, base.nu), **kw)
    cuda_build.reset_launch_counts()
    summ8 = K8.summarize(K8.time_modes(ob, lam8, mu8, U8, bench_cfg, n72))
    k8_launches = cuda_build.launch_counts["phase_ablation"]
    save8 = K8.savings(summ8)
    log(f"phase 13 K8 warp design at B={BENCH_B}, {n72} fixed iterations, lam 0, mu 10, U 0, in "
        f"turns (3 rounds, full first and last), min / median ms: " + "; ".join(
            f"{k} {v[0]:.1f} / {v[1]:.1f}" + ("" if k == "full" else f" (saves {save8[k]:.1f}%)")
            for k, v in summ8.items())
        + f"; inv_solve against no_ls saves {save8['inv_solve vs no_ls']:.1f}%; launches "
        f"{k8_launches} {card}")
    # each mode's saving beside K1's clock64 split at the same inputs
    # (tools/k1_phases.py: K1 built with its probes, the stop rule on): a
    # saving is what K1 loses with the phase gone, a share what the probes
    # count inside it
    cycles, executed = K1P.split(probe_lib, lambda: megasolve.warp_launch(
        ob, ob.x0, ob.xref, lam8, mu8, U8, bench_cfg, "inner_solve_fused", lambda _: probe_lib,
        megasolve.K1_WARPS), bench_cfg.n_inner)
    total = cycles["initial rollout"] + cycles["sweep"] + cycles["line search"]
    share = {k: 100 * v / total for k, v in cycles.items()}
    log(f"phase 13 K8 savings beside K1's clock64 split at these inputs (K1 with its probes, "
        f"{bench_cfg.n_inner} iterations at most, {executed / BENCH_B:.2f} run per scenario): "
        f"no_ls {save8['no_ls']:.1f}% | line search {share['line search']:.1f}%; sweep_only "
        f"{save8['sweep_only']:.1f}% | line search and initial rollout "
        f"{share['line search'] + share['initial rollout']:.1f}%; no_solve "
        f"{save8['no_solve']:.1f}% | Cholesky {share['Cholesky']:.1f}% and substitutions "
        f"{share['substitutions']:.1f}%; no_expcon {save8['no_expcon']:.1f}% | box rows "
        f"{share['box rows']:.1f}%, pairs and dynamics {share['pairs and dynamics']:.1f}%, with "
        f"no_ls's alpha = 1; inv_solve {save8['inv_solve']:.1f}%; the rest of the split: "
        + ", ".join(f"{k} {share[k]:.1f}%" for k in ("stage rows", "Q blocks", "gains out",
                                                       "value update")))
    # the warp design's `full` against the first design's, in turns
    ab8 = {d: functools.partial(K8.phase_ablation, ob, ob.x0, ob.xref, lam8, mu8, U8, bench_cfg,
                                "full", n72, design=d) for d in K8.DESIGNS}
    t8 = {k: statistics.median(v) for k, v in
          K8.time_in_turns(ab8, ("warp", "first", "first", "warp"), 2).items()}
    log(f"phase 13 K8 full at B={BENCH_B}, {n72} fixed iterations, in turns (2 rounds of warp, "
        f"first, first, warp), median ms: warp design {t8['warp']:.1f}, first design "
        f"{t8['first']:.1f} ({t8['first'] / t8['warp']:.2f}x) {card}")
    assert t8["warp"] < t8["first"], t8
    log(f"  (K1 itself, early exit, at the main path's first outer step: {k1_ms:.2f} ms for at "
        f"most {bench_cfg.n_inner} iterations; not a ratio with the fixed-count runs)")
    # the line search's candidates at these inputs over the 72 iterations, by
    # the plain version (the warp design's bound of `full` counts them)
    cand72 = torch.zeros(BENCH_B, dtype=torch.int64, device=dev)
    K8.phase_ablation_plain(ob, ob.x0, ob.xref, lam8, mu8, U8, bench_cfg, "full", n72,
                            candidates=cand72)
    cand72 = int(cand72.sum())
    # the kernels line's K8 and K9 entries: one shape and one set of inputs
    # for the check against plain, the kernel's time, the plain time and the bound
    lam9, mu9, U9 = K9.ab_inputs(ob)
    cand4 = torch.zeros(BENCH_B, dtype=torch.int64, device=dev)
    want89, k89_plain_ms = once(lambda: K8.phase_ablation_plain(ob, ob.x0, ob.xref, lam9, mu9, U9,
                                                                bench_cfg, "full", 4,
                                                                candidates=cand4))
    cand4 = int(cand4.sum())
    k8_ms = cuda_ms(lambda: K8.phase_ablation(ob, ob.x0, ob.xref, lam9, mu9, U9, bench_cfg,
                                              "full", 4), 3)
    k8_first_ms = cuda_ms(lambda: K8.phase_ablation(ob, ob.x0, ob.xref, lam9, mu9, U9, bench_cfg,
                                                    "full", 4, design="first"), 3)
    # at this batch f32 alone parts a few scenarios through line-search ties:
    # the plain version against itself with inputs moved by 2^-21 (4-8 ulp)
    # shows how many; the kernel may miss on at most 0.1% of the scenarios
    jitter = lambda t: t * (1.0 + 2.0 ** -21 * torch.randn(t.shape, generator=gen, device=dev))  # noqa: E731
    spread = K8.phase_ablation_plain(ob, jitter(ob.x0), ob.xref, lam9, mu9, jitter(U9), bench_cfg,
                                     "full", 4)
    n_spread = hold_solve("plain vs itself", spread, want89, allow=1.0)[0]
    got = K8.phase_ablation(ob, ob.x0, ob.xref, lam9, mu9, U9, bench_cfg, "full", 4)
    n8, rel, k8_err, dx = hold_solve("K8 full at the timed shape", got, want89, allow=1e-3)
    got = K8.phase_ablation(ob, ob.x0, ob.xref, lam9, mu9, U9, bench_cfg, "full", 4, design="first")
    n8f = hold_solve("K8 first design full at the timed shape", got, want89, allow=1e-3)[0]
    log(f"phase 13 K8 warp full vs plain at the timed shape (B={BENCH_B}, 4 fixed iterations, "
        f"lam |0.1 N(0,1)|, mu 10, U 0.01 N(0,1)): outside cost rtol 1e-4 / U, Xs atol 5e-3 on "
        f"{n8}/{BENCH_B} scenarios (the first design's {n8f}; the plain version against itself "
        f"under 2^-21 input noise: {n_spread}); over all, cost rel max {rel:.3e}, U max |err| "
        f"{k8_err:.3e}, Xs max |err| {dx:.3e}; {k8_ms:.2f} ms (first design {k8_first_ms:.2f} ms) "
        f"vs plain {k89_plain_ms:.1f} ms; {cand4 / BENCH_B:.2f} line-search candidates a scenario "
        f"by plain")
    del spread

    # ---- phase 14: K9, the expansion-layout A/B; the roofline of K1-K9 ----------
    lam9s, mu9s, U9s = K9.ab_inputs(obk)
    want = K9.expansion_ab_plain(obk, obk.x0, obk.xref, lam9s, mu9s, U9s, cfg3, 4)
    for design in K8.DESIGNS:
        outs, small_err = {}, 0.0
        for lay in K9.LAYOUTS:
            got = K9.expansion_ab(obk, obk.x0, obk.xref, lam9s, mu9s, U9s, cfg3, lay, 4, design)
            outs[lay] = got
            small_err = max(small_err, hold_solve(f"K9 {design} {lay}", got, want)[2])
            assert (got[3] == 4).all()
        full4 = K8.phase_ablation(obk, obk.x0, obk.xref, lam9s, mu9s, U9s, cfg3, "full", 4,
                                  design=design)
        assert all(torch.equal(a, b) for a, b in zip(outs["structured"], full4))
        dU = float((outs["dense"][1] - outs["structured"][1]).abs().max())
        dc = float(((outs["dense"][2] - outs["structured"][2]).abs()
                    / outs["structured"][2].abs()).max())
        assert dU <= 5e-3 and dc <= 1e-4, (design, dU, dc)
        log(f"phase 14 K9 {design} design vs plain, B={K1_B}, 4 fixed iterations, lam |0.1 "
            f"N(0,1)|, mu 10, U 0.01 N(0,1): U max |err| {small_err:.3e}; dense vs structured "
            f"max |dU| {dU:.3e}, cost rel {dc:.3e}; structured = K8 'full' bit for bit")
    cfg40 = ALILQRConfig(n_outer=1, n_inner=40, tol_con=1e-3, ls="adaptive")
    runs9 = {(d, lay): functools.partial(K9.expansion_ab, ob, ob.x0, ob.xref, lam9, mu9, U9,
                                         cfg40, lay, 40, d)
             for d in K8.DESIGNS for lay in K9.LAYOUTS}
    cuda_build.reset_launch_counts()
    order9 = (("warp", "structured"), ("warp", "dense"), ("warp", "dense"), ("warp", "structured"),
              ("first", "structured"), ("first", "dense"),
              ("warp", "structured"), ("warp", "dense"), ("warp", "dense"), ("warp", "structured"))
    summ9 = K8.summarize(K8.time_in_turns(runs9, order9, 1))
    k9_launches = cuda_build.launch_counts["expansion_ab"]
    ab = {lay: K9.expansion_ab(ob, ob.x0, ob.xref, lam9, mu9, U9, cfg40, lay, 40) for lay in K9.LAYOUTS}
    assert all(torch.isfinite(t).all() for r in ab.values() for t in r[:3])
    w9 = {lay: summ9["warp", lay] for lay in K9.LAYOUTS}
    log(f"phase 14 K9 at B={BENCH_B}, 40 fixed iterations, in turns (the warp design's layouts 2 "
        f"rounds of structured, dense, dense, structured, the first design's structured and dense "
        f"once between them), min / median ms: warp " + "; ".join(
            f"{k} {v[0]:.1f} / {v[1]:.1f}" for k, v in w9.items())
        + f" (dense / structured {w9['dense'][1] / w9['structured'][1]:.3f}); first design "
        + "; ".join(f"{lay} {summ9['first', lay][1]:.1f}" for lay in K9.LAYOUTS)
        + f" (first / warp structured "
        f"{summ9['first', 'structured'][1] / w9['structured'][1]:.2f}x, dense "
        f"{summ9['first', 'dense'][1] / w9['dense'][1]:.2f}x); warp max |dU| "
        f"{float((ab['dense'][1] - ab['structured'][1]).abs().max()):.3e}, max |dcost| "
        f"{float((ab['dense'][2] - ab['structured'][2]).abs().max()):.3e}; launches {k9_launches} {card}")
    assert w9["structured"][1] < summ9["first", "structured"][1], summ9
    cand40 = torch.zeros(BENCH_B, dtype=torch.int64, device=dev)
    K8.phase_ablation_plain(ob, ob.x0, ob.xref, lam9, mu9, U9, cfg40, "full", 40, candidates=cand40)
    cand40 = int(cand40.sum())
    k9_ms = cuda_ms(lambda: K9.expansion_ab(ob, ob.x0, ob.xref, lam9, mu9, U9, bench_cfg,
                                            "dense", 4), 3)
    k9_first_ms = cuda_ms(lambda: K9.expansion_ab(ob, ob.x0, ob.xref, lam9, mu9, U9, bench_cfg,
                                                  "dense", 4, "first"), 3)
    got = K9.expansion_ab(ob, ob.x0, ob.xref, lam9, mu9, U9, bench_cfg, "dense", 4)
    n9, rel, k9_err, dx = hold_solve("K9 dense at the timed shape", got, want89, allow=1e-3)
    got = K9.expansion_ab(ob, ob.x0, ob.xref, lam9, mu9, U9, bench_cfg, "dense", 4, "first")
    n9f = hold_solve("K9 first design dense at the timed shape", got, want89, allow=1e-3)[0]
    log(f"phase 14 K9 warp dense vs plain at K8's timed shape and inputs: outside the tolerances "
        f"on {n9}/{BENCH_B} scenarios (the first design's {n9f}; f32 spread {n_spread}, phase 13); "
        f"over all, cost rel max {rel:.3e}, U max |err| {k9_err:.3e}, Xs max |err| {dx:.3e}; "
        f"{k9_ms:.2f} ms (first design {k9_first_ms:.2f} ms)")
    del want89, got

    # the roofline: times from phases 6, 11, 12-14, work counted from this run's inputs
    staged = (("riccati_lanes", "K3", "nmpc_tpu/ops/riccati_pallas.py:311"),
              ("expansions_fused", "K4", "nmpc_tpu/ops/expansions_pallas.py:212"),
              ("linesearch_costs_lanes", "K5", "nmpc_tpu/ops/rollout_pallas.py:287"),
              ("rollout_alpha_lanes", "K6", "nmpc_tpu/ops/rollout_pallas.py:360"))
    peak_flops = best["tflops"] * 1e12
    bounds = {}

    def roof(key, what, ms_, launches, work):
        flops, nbytes = work
        b_ms, by = RL.bound(flops, nbytes)
        bounds[key] = (b_ms, by)
        log(f"phase 14 roofline {what}: {ms_:.3f} ms per launch, "
            f"{'-' if launches is None else launches} launches per solve, {flops / 1e9:.3f} GFLOP, "
            f"{nbytes / 1e6:.1f} MB, bound {b_ms:.4f} ms ({by}), {100 * b_ms / ms_:.2f}% of the bound "
            f"reached; FLOPs at K7's measured peak {flops / peak_flops * 1e3:.4f} ms")

    for state, key in (("first step", "K1"), ("converged", "K1 converged")):
        executed, cand = k1_work[state]
        work = RL.kernel_work("K1", base, BENCH_B, bench_cfg, iters=executed, candidates=cand)
        roof(key, f"K1 main path ({state}; per scenario {executed / BENCH_B:.2f} iterations and "
             f"{cand / BENCH_B:.2f} candidates needed, by the plain version)",
             k1_at[state]["K1"], counts["inner_solve_fused"], work)
        roof(f"{key} first design", f"K1's first design ({state})", k1_at[state]["first design"],
             None, work)
    roof("K2", "K2 main path", k2_ms, counts["al_update_lanes"], RL.kernel_work("K2", base, BENCH_B))
    log(f"phase 14 roofline K2's first design (as recorded): {FIRST_K2_MS:.3f} ms per launch, "
        f"{100 * bounds['K2'][0] / FIRST_K2_MS:.2f}% of the bound reached")
    for tag, ocp_p, cnt, cfg_p in (("a", base, counts_a, staged_cfg), ("b", obs_base, counts_b, obs_cfg)):
        for name, k, _ in staged:
            roof(f"{k} {tag}", f"{k} path ({tag})", ms[tag][k][0], cnt[name],
                 RL.kernel_work(k, ocp_p, BENCH_B, n_alphas=len(cfg_p.alphas) + 1))
    roof("K7", f"K7 (C={best['chains']}, {R7} steps)", best["ms"], None,
         RL.kernel_work("K7", base, 0, chains=best["chains"], R=R7, threads=T7))
    # K8 and K9 as each design runs them (the warp design's `full` from the
    # candidates the plain run needed, with no accepted rollout)
    for mode in K8.MODES:
        roof(f"K8 {mode}", f"K8 warp {mode} ({n72} iterations, median)", summ8[mode][1], None,
             RL.kernel_work("K8", base, BENCH_B, bench_cfg, iters=n72 * BENCH_B, phase=mode,
                            candidates=cand72, design="warp"))
    roof("K8 full first design", f"K8 first design full ({n72} iterations, in turns)",
         t8["first"], None, RL.kernel_work("K8", base, BENCH_B, bench_cfg, iters=n72 * BENCH_B))
    for d in K8.DESIGNS:
        for lay in K9.LAYOUTS:
            roof(f"K9 {d} {lay}", f"K9 {d} {lay} (40 iterations, median)", summ9[d, lay][1], None,
                 RL.kernel_work("K9", base, BENCH_B, cfg40, iters=40 * BENCH_B,
                                candidates=cand40, design=d))
    line_work = RL.kernel_work("K8", base, BENCH_B, bench_cfg, iters=4 * BENCH_B,
                               candidates=cand4, design="warp")
    roof("K8 line", "K8 warp full (4 iterations, lam |0.1 N|, U 0.01 N)", k8_ms, None, line_work)
    roof("K9 line", "K9 warp dense (the same inputs)", k9_ms, None, line_work)
    first_work = RL.kernel_work("K8", base, BENCH_B, bench_cfg, iters=4 * BENCH_B)
    roof("K8 line first design", "K8 first design full (the same inputs)", k8_first_ms, None,
         first_work)
    roof("K9 line first design", "K9 first design dense (the same inputs)", k9_first_ms, None,
         first_work)

    # ---- phase 15: line-search grids longer than one launch takes --------------
    # K1 keeps any number of alphas with its parameter block in dynamic
    # shared memory: the cascade (which tries every alpha) at 33 and 64 on
    # phase 3's inputs, against plain at phase 3's tolerances; the default
    # grid, then alphas below its last (a tie between two near-equal small
    # steps moves U by less than its tolerance)
    for n_al in (33, 64):
        grid = ALILQRConfig().alphas
        alphas = (grid + tuple(grid[-1] * 0.7 ** k for k in range(1, n_al)))[:n_al]
        cfg = ALILQRConfig(n_outer=6, n_inner=4, tol_con=1e-3, ls="cascade", alphas=alphas)
        got = megasolve.inner_solve_fused(obk, obk.x0, obk.xref, lam3, mu3, U3, cfg)
        torch.cuda.synchronize()
        want = megasolve.inner_solve_plain(obk, obk.x0, obk.xref, lam3, mu3, U3, cfg)
        _, rel, du, dx = hold_solve(f"K1 with {n_al} alphas", got, want)
        same_it = int((got[3] == want[3]).sum())
        assert same_it >= 0.99 * K1_B, (n_al, same_it)
        cuda_build.reset_launch_counts()
        r15 = solve_batched(obk, cfg=dataclasses.replace(cfg, n_inner=12))
        c15 = dict(cuda_build.launch_counts)
        steps15 = int(r15.outer_iters.max())
        assert c15["inner_solve_fused"] == c15["al_update_lanes"] == steps15, c15
        assert sum(c15.values()) == 2 * steps15 and torch.isfinite(r15.cost).all(), c15
        log(f"phase 15 K1 with {n_al} alphas (cascade, six_robot_antipodal N=10 B={K1_B}, "
            f"n_inner=4, phase 3's inputs) vs plain: cost rel max {rel:.3e}, U max |err| {du:.3e}, "
            f"Xs max |err| {dx:.3e}, iteration counts equal {same_it}/{K1_B}; the megakernel "
            f"route's solve at n_inner=12: {steps15} outer steps, launches {c15}, "
            f"{summary(r15)}")
    # the same grids at m = 1, where K1 is the team design: a cascade of 33
    # alphas runs in 9 passes of a team's 4 lanes, 64 in 16; on
    # obstacle_scenario_3 at N=10, phase 3's kind of inputs
    obs10 = get("obstacle_scenario_3").make(N=10, device=dev)
    g15 = torch.Generator(device=dev).manual_seed(15)
    ob15 = batch(obs10, K1_B, spread=0.05, g=g15)
    U15, lam15, mu15 = warm_state(obs10, K1_B, g=g15)
    for n_al in (33, 64):
        grid = ALILQRConfig().alphas
        alphas = (grid + tuple(grid[-1] * 0.7 ** k for k in range(1, n_al)))[:n_al]
        cfg = ALILQRConfig(n_outer=6, n_inner=4, tol_con=1e-3, ls="cascade", alphas=alphas)
        cuda_build.reset_launch_counts()
        hold_k1(f"phase 15 K1's team design with {n_al} alphas (cascade, obstacle_scenario_3 N=10 "
                f"B={K1_B}, n_inner=4) vs plain", ob15, U15, lam15, mu15, cfg)
        assert cuda_build.launch_counts["inner_solve_fused"] == 1
        r15 = solve_batched(ob15, cfg=dataclasses.replace(cfg, n_inner=12))
        assert torch.isfinite(r15.cost).all()
        log(f"phase 15 the megakernel route's solve at m=1 with {n_al} alphas, n_inner=12: "
            f"{summary(r15)}")
    # K5 at 33 candidates on path (b)'s problem (k5_max_alphas(1) a launch),
    # bit for bit its first design, at phase 10's state (ii) of (b)
    from nmpc_tpu_torch.ops.expansions import expansions_fused
    from nmpc_tpu_torch.ops.riccati import riccati_lanes

    cand33 = (0.0,) + tuple(0.8 ** k for k in range(32))
    X_l, U_l = lane(res_b.X[:, :-1]), lane(res_b.U)
    xref_l, lam_l, mov_l = lane(ob_b.xref), lane(res_b.lam), AB._mov_lanes(ob_b, BENCH_B)
    mu_b = res_b.mu.contiguous()
    gains = riccati_lanes(expansions_fused(ob_b, X_l, U_l, xref_l, lam_l, mu_b, mov_l), obs_cfg.reg)
    args15 = (X_l[0].contiguous(), X_l, U_l, gains[0], gains[1], xref_l, lam_l, mu_b)
    cuda_build.reset_launch_counts()
    got = rollout_ops.linesearch_costs_lanes(ob_b, *args15, cand33, mov_l)
    n_launch = cuda_build.launch_counts["linesearch_costs_lanes"]
    want = SL.linesearch_costs_first(ob_b, *args15, cand33, mov_l)
    off15 = int((~((got == want) | (got.isnan() & want.isnan()))).sum())
    top = staged_tiles.k5_max_alphas(obs_base.m)
    assert off15 == 0 and n_launch == -(-len(cand33) // top), (off15, n_launch)
    log(f"phase 15 K5 with {len(cand33)} candidates at path (b) B={BENCH_B} N={obs_base.N}: "
        f"{n_launch} launches of at most {top}; merits that differ from the first design "
        f"{off15}/{got.numel()} (bit for bit: 0) ok")
    del got, want, gains, args15
    # a staged solve of obstacle_scenario_3 with 33 alphas (34 candidates,
    # three K5 launches an iteration)
    cfg33 = dataclasses.replace(obs_cfg, alphas=tuple(0.8 ** k for k in range(33)))
    ob33 = batch(obs_base, K1_B, spread=0.05)
    cuda_build.reset_launch_counts()
    res33, t33 = timed(lambda: solve_batched(ob33, cfg=cfg33))
    c33 = dict(cuda_build.launch_counts)
    it33 = c33["riccati_lanes"]
    slices = -(-(len(cfg33.alphas) + 1) // top)
    assert it33 > 0 and c33["expansions_fused"] == it33, c33
    assert c33["linesearch_costs_lanes"] == slices * it33 and c33["rollout_alpha_lanes"] == it33 + 1, c33
    for name in ("X", "U", "cost", "viol", "lam"):
        assert torch.isfinite(getattr(res33, name)).all(), name
    log(f"phase 15 staged solve of obstacle_scenario_3 N={obs_base.N} B={K1_B} with "
        f"{len(cfg33.alphas)} alphas: launches {c33} ({slices} K5 launches an iteration); "
        f"{summary(res33)}; {t33 * 1e3:.1f} ms")

    # ---- phases 16-20: the closed loop ---------------------------------------
    closed_loop_phases(dev, base, card)

    # ---- phases 21-23: K1's and K2's obstacle variant; paths (b) and (c) on
    # the megakernel route; the robot-parallel modes ----------------------------
    obs_errs = obstacle_kernel_phase(dev, ob_b, ob_c)
    team_b = megakernel_paths_phase(dev, card, phase22_paths(ob_b, obs_cfg, ob_c, mov_cfg))
    log(f"phase 21-22 obstacle variant: K1 U max |err| {obs_errs['K1']:.3e} (the warp design's "
        f"{obs_errs['K1 warp']:.3e}), K2 max |err| {obs_errs['K2']:.3e} against plain")
    modes_phase(dev, card)

    # ---- phases 24-28: K3 at the ray shape; path (d); scan and compact; the
    # GN fleet; the LiDAR loop --------------------------------------------
    k3_shape_entry = family_i_phases(dev, card, base, bench_cfg)

    # ---- phases 29-33: K3 at the user models' shapes; the generic path; the
    # ADMM fleet; the real-time loop over the native runtime; the CLI ------
    user_entries = user_model_phases(dev, card)

    # ---- phase 34: the sharded forms on one- and two-rank worlds ---------
    sharded_phase(dev, card, base, bench_cfg)

    # ---- phase 35: the closed-loop suite's fuzz and obstacle tour; bench ---
    t35 = time.perf_counter()
    loop_suite_phase(dev, card)
    log(f"phase 35 took {time.perf_counter() - t35:.1f} s")

    # ---- phase 36: the reference's tools: the latency graph, the ten-robot
    # fleet, the gate, the cascade arm -----------------------------------
    ref_tools_phase(dev, card)

    # ---- phase 37: the batched LiDAR loop, per-scenario scans ------------
    lidar_batch_phase(dev, card)

    # ---- phase 38: robot counts past the registry's: the megakernel route
    # and the staged route at m = 7, 9, 12 and 16 --------------------------
    wide_rows = robot_counts_phase(dev, card, wide_builds)

    # ---- phase 39: the hybrid route at m=12; K3 at stage shapes past
    # (30, 20) ---------------------------------------------------------------
    wide_rows += wide_stage_shapes_phase(dev, card)

    # ---- phase 40: past the megakernel's sixteen robots: the staged route
    # at m = 20, 24, 32, the hybrid route at 20, K3 past nu = 32 ---------
    wide_rows += past_sixteen_phase(dev, card, past_builds)

    # ---- phase 41: no shared-memory ceiling: K4's and K5's device-memory
    # forms at m = 112, among 200 and 64 pillars, with 150 moving obstacles
    wide_rows += any_rows_phase(dev, card, any_builds)

    def entry(name, source, where, launches, err, ms_, plain_ms, key):
        return {"name": name, "route": "cuda", "source": source, "replaces": where,
                "launches": launches, "max_abs_err": err, "ms": ms_, "plain_ms": plain_ms,
                "bound_ms": bounds[key][0], "bound_by": bounds[key][1], "library_ms": None}

    record = {"kernels": [
        entry("inner_solve_fused", "nmpc_tpu_torch/csrc/inner_warp.cuh",
              "nmpc_tpu/ops/megasolve_pallas.py:911", counts["inner_solve_fused"], k1_err,
              k1_ms, k1_plain_ms, "K1"),
        entry("al_update_lanes", "nmpc_tpu_torch/csrc/inner_warp.cuh",
              "nmpc_tpu/ops/megasolve_pallas.py:870", counts["al_update_lanes"], k2_err,
              k2_ms, k2_plain_ms, "K2"),
        # K1 at m <= 2, path (b): launches of its megakernel-route solve
        # (counts set to 0 just before), times at its first outer step
        {"name": "K1 team (m<=2)", "route": "cuda", "source": "nmpc_tpu_torch/csrc/inner_team.cuh",
         "replaces": "nmpc_tpu/ops/megasolve_pallas.py:911", "launches": team_b["launches"],
         "max_abs_err": obs_errs["K1"], "ms": team_b["ms"], "plain_ms": team_b["plain_ms"],
         "bound_ms": team_b["bound_ms"], "bound_by": team_b["bound_by"], "library_ms": None},
    ] + [
        entry(name, "nmpc_tpu_torch/csrc/" + ("staged_tiles.cuh" if k in ("K3", "K5")
                                              else "expansions_rollout_tiles.cuh"),
              where, counts_a[name], errs[k], ms["a"][k][0], ms["a"][k][1], f"{k} a")
        for name, k, where in staged
    ] + [
        entry("fma_peak", "nmpc_tpu_torch/csrc/tools.cu", "tools/roofline.py:46", k7_launches,
              k7_err, best["ms"], k7_plain_ms, "K7"),
        entry("phase_ablation", "nmpc_tpu_torch/csrc/inner_warp.cuh",
              "tools/exp_mega_phases.py:298", k8_launches, k8_err, k8_ms, k89_plain_ms, "K8 line"),
        entry("expansion_ab", "nmpc_tpu_torch/csrc/inner_warp.cuh",
              "tools/exp_blocked_expansions.py:551", k9_launches, k9_err, k9_ms, k89_plain_ms,
              "K9 line"),
        k3_shape_entry,
        *user_entries,
        *wide_rows,
    ]}
    log(f"total wall time {time.perf_counter() - t_start:.1f} s")
    print(json.dumps(record))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
