"""Per-step MPC latency against the control period T. Port of
tools/gen_latency.py: its cases, configs, rows and printed fields; where
the reference writes docs/LATENCY.md this prints the tables (and, with
--json, one JSON line of every row).

The budget is the reference's control period T: the serial IPOPT solve
must fit inside it for the loop to run at rate (BASELINE: "p99 per-step
solve latency vs IPOPT").

1. On-device closed loop (the deployment claim). A chunk of K=20 MPC steps,
   each `solve_one_graph` (the megakernel route at B=1 with no host sync:
   every AL outer step one K1 and one K2 launch; the result is solve_one's
   bit for bit) -> first control -> sim/plant.plant_step ->
   mpc/driver.shift_warm(mu_reset=False), with the step's violation, inner
   iterations and smallest pair distance, is captured once as a
   torch.cuda.CUDAGraph: the counterpart of the reference's jitted
   lax.scan that never returns to the host. It is replayed M=40 times,
   each from the start jittered by 0.01 N(0, 1) (copied into the graph's
   input buffer) with the seeded warm start, so every replay times the
   manoeuvre's hard phase. Per-step time = replay wall clock / K, the
   clock stopped after torch.cuda.synchronize(); p50/p99 over the M
   replays. Rows: CFG (6x12) on the published OCP, CFG_RT (3x10, carried
   mu) and CFG_RT_AD (its adaptive line search) on the OCP tightened by
   3 cm, and the headline case with the delay-compensated rt recipe.
   The graph-safe form launches K1 cfg.n_outer times a step where
   solve_one stops once the solve is done; each row also records the share
   of K1 launches made after that, and the chunk's p50 run eagerly through
   solve_one and through solve_one_graph (`measure_ondevice`).
2. Per call: one solve a call on the host loop (solver/alilqr.solve at CFG
   and CFG_RT, the per-scenario engine; solve_one at CFG_RT where the
   megakernel route takes the problem), each timed from its start to a
   synchronize, warm-started from the last.
3. lidar_v4: the published v4 config through mpc/lidar.closed_loop_lidar
   (raycast, re-seed, frozen points, condensed GN, plant): the port's host
   loop, K steps a chunk, from poses jittered by 0.02.

    python -m nmpc_tpu_torch.tools.latency [--cases a,b] [--chunks M]
        [--steps K] [--calls C] [--lidar-chunks L] [--N n] [--no-percall]
        [--no-lidar] [--device cpu] [--json]

On the card (the default) it refuses to run without one. With --device cpu
the chunk runs eagerly (a CPU has no graphs) and every time is the CPU's,
labelled so: the CPU runs check the path, not its speed.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import math
import sys
import time

import numpy as np
import torch

from nmpc_tpu_torch.mpc.driver import shift_warm, steady_warm
from nmpc_tpu_torch.ocp import problem as P
from nmpc_tpu_torch.ocp.problem import OCP
from nmpc_tpu_torch.ops import cuda_build
from nmpc_tpu_torch.scenarios import get
from nmpc_tpu_torch.sim.plant import PlantConfig, plant_step
from nmpc_tpu_torch.solver.alilqr import ALILQRConfig, SolveResult, WarmStart, solve
from nmpc_tpu_torch.solver.alilqr_batched import route, solve_one, solve_one_graph
from nmpc_tpu_torch.tools.roofline import device_label, resolve_device
from nmpc_tpu_torch.utils.timing import latency_stats, sync

CASES = [
    ("single_robot", {}),          # T=0.01, N=50
    ("tb3_1", {}),                 # T=0.01, N=200 (longest horizon)
    ("two_robot_swap", {}),        # T=0.02, N=100
    ("five_robot", {}),            # T=0.02, N=70
    ("six_robot_antipodal", {}),   # T=0.2,  N=35 (headline)
    ("eight_robot", {}),           # T=0.02, N=5
    ("ten_robot", {}),             # T=0.1,  N=20
]

CFG = ALILQRConfig(n_outer=6, n_inner=12, tol_con=1e-4)
# the rt deployment recipe: 3x10 carried-mu solves on the OCP tightened by
# 3 cm (tol_con 1e-4, stricter than the driver's default rt config: the
# published noise-safe recipe, as the reference measures it)
CFG_RT = ALILQRConfig(n_outer=3, n_inner=10, tol_con=1e-4)
# the same recipe on the adaptive per-scenario line search
CFG_RT_AD = dataclasses.replace(CFG_RT, ls="adaptive")
TIGHTEN_M = 0.03  # tube margin [m] on dmin for the rt deployment solve

K = 20   # MPC steps a chunk
M = 40   # chunk replays (p99 tail resolution)
CALLS = 30  # per-call solves a row
EAGER = 5   # eager chunk runs a row (solve_one against solve_one_graph)
LIDAR_K, LIDAR_M = 20, 30


def tightened(ocp: OCP) -> OCP:
    """The rt deployment OCP: dmin tightened by the 3 cm tube margin (the
    controller solves the tightened problem; safety is judged on the true
    dmin)."""
    if not ocp.n_pairs:
        return ocp
    dmin = math.sqrt(float(ocp.dmin2))
    return dataclasses.replace(ocp, dmin2=torch.tensor((dmin + TIGHTEN_M) ** 2,
                                                       dtype=ocp.dmin2.dtype, device=ocp.device))


@dataclasses.dataclass
class Trace:
    """A chunk's per-step record: X [K+1, nx] true states, U0 [K, nu] the
    solves' first controls, viol [K], iters [K] (inner iterations), d2 [K]
    (smallest squared pair distance after the step; inf for one robot),
    outer [K] (AL outer steps each solve used: solve_one launches K1 that
    many times, solve_one_graph cfg.n_outer times)."""
    X: torch.Tensor
    U0: torch.Tensor
    viol: torch.Tensor
    iters: torch.Tensor
    d2: torch.Tensor
    outer: torch.Tensor

    NAMES = ("X", "U0", "viol", "iters", "d2", "outer")

    def fields(self) -> tuple:
        return tuple(getattr(self, n) for n in self.NAMES)


class Chunk:
    """K MPC steps with no host sync: solve -> U[0] -> plant -> shift.

    ocp_solve is what the controller solves (possibly tightened); ocp_true
    gives the plant's period and the realized clearance. delay_compensate
    runs the reference's deployment timing (the control lands one period
    late) with the latch predicted one period forward under the control in
    flight. `solve` is solve_one_graph (the graph-safe form); solve_one
    gives the same steps bit for bit with host syncs."""

    def __init__(self, ocp_solve: OCP, ocp_true: OCP, cfg: ALILQRConfig, steps: int = K,
                 delay_compensate: bool = False, solve_fn=solve_one_graph):
        self.ocp_solve, self.ocp_true, self.cfg = ocp_solve, ocp_true, cfg
        self.steps, self.delay = steps, delay_compensate
        self.solve_fn = solve_fn

    def min_d2(self, x):
        if not self.ocp_true.n_pairs:
            return torch.full((), math.inf, dtype=x.dtype, device=x.device)
        return torch.amin(P.pairwise_sq_distances(self.ocp_true, x))

    def step(self, x, w: WarmStart, u_prev, against=None):
        """One MPC step from the true state x: (x next, warm next, the
        solve's first control, its SolveResult). against(ocp, warm, cfg): a
        solver the step's solve is held against bit for bit (raises
        AssertionError at the first field that differs)."""
        T = self.ocp_true.T
        x_solve = plant_step(x, u_prev, T, PlantConfig())[0] if self.delay else x
        o = dataclasses.replace(self.ocp_solve, x0=x_solve)
        res = self.solve_fn(o, w, self.cfg)
        if against is not None:
            hold_bits(against(o, w, self.cfg), res)
        u_apply = u_prev if self.delay else res.U[0]
        xn, _ = plant_step(x, u_apply, T, PlantConfig())
        return xn, shift_warm(res, self.cfg, mu_reset=False), res.U[0], res

    def run(self, x0, warm: WarmStart, against=None) -> Trace:
        """The chunk from (x0, warm); `against` as `step`'s."""
        x, w = x0, warm
        u = torch.zeros((self.ocp_true.nu,), dtype=x0.dtype, device=x0.device)
        xs, us, viols, iters, d2s, outer = [x0], [], [], [], [], []
        for _ in range(self.steps):
            x, w, u, res = self.step(x, w, u, against)
            xs.append(x)
            us.append(u)
            viols.append(res.viol)
            iters.append(res.inner_iters)
            d2s.append(self.min_d2(x))
            outer.append(res.outer_iters)
        return Trace(torch.stack(xs), torch.stack(us), torch.stack(viols), torch.stack(iters),
                     torch.stack(d2s), torch.stack(outer))


def hold_bits(got: SolveResult, want: SolveResult) -> None:
    """Every field of two SolveResults equal bit for bit."""
    for f in dataclasses.fields(got):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if not torch.equal(a, b):
            raise AssertionError(f"{f.name} differs (max |diff| "
                                 f"{float((a.double() - b.double()).abs().max()):.3e})")


def summary(tr: Trace) -> dict:
    """The reference chunk's outputs: the final state, the largest
    violation, the summed inner iterations and the smallest pair distance;
    and the summed AL outer steps."""
    return dict(xF=tr.X[-1], viol=tr.viol.max(), iters=tr.iters.sum(), min_dist=tr.d2.min().sqrt(),
                outer=tr.outer.sum())


class GraphChunk:
    """A Chunk captured once as a CUDA graph from (x0, warm) and replayed
    from new starts. Before the capture the chunk runs once on a side
    stream (it builds and loads the kernels, opts their shared memory in
    and makes the cached device constants the capture reads: the line-search
    alphas, the pair indices, the stage-0 mask).
    `per_replay` holds the kernel launches the graph makes at each replay,
    counted at capture; each replay adds them to cuda_build.launch_counts
    (and k1_designs), the capture none. Raises if the graph holds no K1 or
    no K2 launch."""

    def __init__(self, chunk: Chunk, x0, warm: WarmStart):
        self.x_in = x0.clone()
        self.warm = WarmStart(*(t.clone() for t in (warm.U, warm.lam, warm.mu)))
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            chunk.run(self.x_in, self.warm)
        torch.cuda.current_stream().wait_stream(side)
        torch.cuda.synchronize()
        counts, designs = dict(cuda_build.launch_counts), dict(cuda_build.k1_designs)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.out = chunk.run(self.x_in, self.warm)
        self.per_replay = {k: cuda_build.launch_counts[k] - counts[k] for k in counts}
        self.designs = {k: cuda_build.k1_designs[k] - designs[k] for k in designs}
        cuda_build.launch_counts.update(counts)   # the capture ran nothing
        cuda_build.k1_designs.update(designs)
        if not (self.per_replay["inner_solve_fused"] > 0 and self.per_replay["al_update_lanes"] > 0):
            raise RuntimeError(f"GraphChunk: the captured chunk holds no K1 or no K2 launch "
                               f"({self.per_replay})")

    def replay(self, x0) -> Trace:
        """Replay from start x0; the Trace's tensors are the graph's own
        outputs, overwritten by the next replay."""
        self.x_in.copy_(x0)
        self.graph.replay()
        for k, n in self.per_replay.items():
            cuda_build.launch_counts[k] += n
        for k, n in self.designs.items():
            cuda_build.k1_designs[k] += n
        return self.out


def graph_against_eager(ocp: OCP, cfg: ALILQRConfig, tighten: bool = True, steps: int = K,
                        replays: int = 5) -> dict:
    """The chunk of `measure_ondevice` captured as a CUDA graph and replayed
    from `replays` starts jittered by 0.01, each replay held bit for bit
    (every Trace field) against the same steps run eagerly, K1 and K2
    launched one by one, each eager step's solve held bit for bit against
    solve_one. Raises AssertionError at a differing bit. Returns the
    launches a replay (counted at capture) and the replays held."""
    ocp_solve = tightened(ocp) if tighten else ocp
    warm = shift_warm(solve_one(ocp_solve, cfg=CFG), cfg, mu_reset=False)
    chunk = Chunk(ocp_solve, ocp, cfg, steps)
    gc = GraphChunk(chunk, ocp.x0, warm)
    g = torch.Generator(device=ocp.device).manual_seed(0)
    for r in range(replays):
        x0 = _jitter(ocp, g, 0.01)
        got = [t.clone() for t in gc.replay(x0).fields()]
        want = chunk.run(x0, warm, against=solve_one).fields()
        for name, a, b in zip(Trace.NAMES, got, want):
            if not torch.equal(a, b):
                raise AssertionError(f"graph replay {r}: {name} differs from the eager chunk "
                                     f"(max |diff| {float((a - b).abs().max()):.3e})")
    return dict(per_replay=dict(gc.per_replay), designs=dict(gc.designs), replays=replays)


def _jitter(ocp: OCP, g: torch.Generator, spread: float):
    return ocp.x0 + spread * torch.randn(ocp.x0.shape, generator=g, dtype=ocp.x0.dtype,
                                         device=ocp.device)


def _eager_p50_ms(chunk: Chunk, warm: WarmStart, starts, steps: int) -> float:
    """p50 over `starts` of the chunk run eagerly (each kernel launched from
    Python), ms a step, each run from its start to a synchronize."""
    out = []
    for x0 in starts:
        sync(x0.device)
        t0 = time.perf_counter()
        chunk.run(x0, warm)
        sync(x0.device)
        out.append((time.perf_counter() - t0) / steps * 1e3)
    return float(np.median(out))


def measure_ondevice(ocp: OCP, cfg: ALILQRConfig, tighten: bool = False,
                     delay_compensate: bool = False, seed_cfg: ALILQRConfig | None = None,
                     steps: int = K, chunks: int = M) -> dict:
    """Per-step latency stats over `chunks` jittered replays of a `steps`
    step chunk (eager on the CPU), with the worst violation, the mean inner
    iterations a step, the smallest realized pair distance, and the K1/K2
    launches a replay (on the card). The warm start is the seed solve's
    (solver/alilqr.solve at seed_cfg, default CFG), shifted.

    What the graph-safe form costs over solve_one, which stops once the
    solve is done: `noop_share`, the share of the chunks' K1 launches
    (cfg.n_outer a step) made after their solve was done (1 - the AL outer
    steps used / cfg.n_outer); and the same chunk run eagerly from the
    first EAGER starts, once through solve_one (`eager_one_p50_ms`: its
    early exit, a host sync an outer step) and once through
    solve_one_graph (`eager_graph_p50_ms`: every launch), p50 ms a step."""
    ocp_solve = tightened(ocp) if tighten else ocp
    seed = solve(ocp_solve, cfg=seed_cfg or CFG)
    warm = shift_warm(seed, cfg, mu_reset=False)
    chunk = Chunk(ocp_solve, ocp, cfg, steps, delay_compensate)
    on_card = ocp.device.type == "cuda"
    if on_card:
        gc = GraphChunk(chunk, ocp.x0, warm)
        run = gc.replay
    else:
        run = functools.partial(chunk.run, warm=warm)
    g = torch.Generator(device=ocp.device).manual_seed(0)
    samples, viols, iters, dists, outer, starts = [], [], [], [], 0.0, []
    for _ in range(chunks):
        x0 = _jitter(ocp, g, 0.01)
        starts.append(x0)
        sync(ocp.device)
        t0 = time.perf_counter()
        s = summary(run(x0))
        sync(ocp.device)
        samples.append((time.perf_counter() - t0) / steps)
        viols.append(float(s["viol"]))
        iters.append(float(s["iters"]) / steps)
        dists.append(float(s["min_dist"]))
        outer += float(s["outer"])
    st = latency_stats(samples)
    st.update(viol=float(np.max(viols)), iters=float(np.mean(iters)),
              min_dist=float(np.min(dists)), mode="graph" if on_card else "eager",
              noop_share=1.0 - outer / (chunks * steps * cfg.n_outer))
    one = Chunk(ocp_solve, ocp, cfg, steps, delay_compensate, solve_fn=solve_one)
    st.update(eager_one_p50_ms=_eager_p50_ms(one, warm, starts[:EAGER], steps),
              eager_graph_p50_ms=_eager_p50_ms(chunk, warm, starts[:EAGER], steps))
    if on_card:
        st.update(K1_per_replay=gc.per_replay["inner_solve_fused"],
                  K2_per_replay=gc.per_replay["al_update_lanes"],
                  K1_design=max(gc.designs, key=gc.designs.get))
    return st


def measure_percall(ocp: OCP, cfg: ALILQRConfig, engine=None, calls: int = CALLS) -> dict:
    """One solve a call from jittered starts, each warm-started from the
    last (steady_warm), timed from its start to a synchronize."""
    f = engine if engine is not None else functools.partial(solve, cfg=cfg)
    res = solve(ocp, cfg=CFG)
    f(ocp)                                    # warm-up
    warm = steady_warm(res)
    g = torch.Generator(device=ocp.device).manual_seed(0)
    samples, viols = [], []
    for _ in range(calls):
        ocp_i = dataclasses.replace(ocp, x0=_jitter(ocp, g, 0.01))
        sync(ocp.device)
        t0 = time.perf_counter()
        res = f(ocp_i, warm)
        sync(ocp.device)
        samples.append(time.perf_counter() - t0)
        viols.append(float(res.viol))
        warm = steady_warm(res)
    st = latency_stats(samples)
    st["viol"] = float(np.max(viols))
    return st


LIDAR_OBSTACLES = ((0.5, 0.25, 0.1), (0.4, -0.3, 0.12))


def measure_lidar(device, steps: int = LIDAR_K, chunks: int = LIDAR_M,
                  N: int | None = None) -> dict:
    """lidar_v4 (N=100, Nc=50, 10 rays, 1/d cost, budget 75 ms) through
    mpc/lidar.closed_loop_lidar, GNConfig(n_gn=10, n_outer=4, tol_con=1e-3,
    normal="dense"): `steps` steps a chunk on the host loop, p50/p99 of the
    chunk's wall clock / steps over `chunks` poses jittered by 0.02, and the
    smallest clearance. N overrides the horizon (Nc = min(50, N))."""
    from nmpc_tpu_torch.mpc.lidar import closed_loop_lidar
    from nmpc_tpu_torch.solver import gn

    sc = get("lidar_v4")
    ocp = sc.make(device=device) if N is None else sc.make(device=device, N=N)
    obstacles = torch.tensor(LIDAR_OBSTACLES, dtype=torch.float32, device=device)
    wps = sc.waypoint_array.to(device)
    cfg = gn.GNConfig(Nc=min(sc.Nc, ocp.N), n_gn=10, n_outer=4, tol_con=1e-3, normal="dense")
    run = functools.partial(closed_loop_lidar, sim_obstacles=obstacles, waypoints=wps, cfg=cfg,
                            max_steps=steps)
    run(ocp)                                  # warm-up
    g = torch.Generator(device=device).manual_seed(0)
    samples, clears = [], []
    for _ in range(chunks):
        pose = ocp.x0[:3] + 0.02 * torch.randn((3,), generator=g, dtype=ocp.x0.dtype,
                                               device=device)
        ocp_i = dataclasses.replace(ocp, x0=torch.cat([pose, ocp.x0[3:]]))
        sync(device)
        t0 = time.perf_counter()
        _, _, clr, _, _ = run(ocp_i)
        sync(device)
        samples.append((time.perf_counter() - t0) / steps)
        clears.append(float(clr.min()))
    st = latency_stats(samples)
    st["min_clearance"] = float(np.min(clears))
    return st


def dispatch_floor_ms(device) -> float:
    """The host's floor for one blocking call: median ms of a trivial kernel
    and a synchronize (the reference's 'tunnel RTT floor')."""
    x = torch.zeros(8, device=device)
    ts = []
    for _ in range(21):
        sync(device)
        t0 = time.perf_counter()
        x.add_(1.0)
        sync(device)
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts[1:]) * 1e3)


def _fmt(v: float) -> str:
    return f"{v:.2f}"


def tables(out: dict) -> str:
    """The reference's docs/LATENCY.md tables as text."""
    lines = [f"# Per-step MPC latency vs real-time budget ({out['device']})", "",
             f"## On-device closed loop ({out['mode']}: {out['K']} steps a chunk, "
             f"{out['M']} replays)", "",
             "| scenario | m | N | budget ms | full p50 | full p99 | rt p50 | rt p99 | rt-ad p50 "
             "| rt-ad p99 | rt iters/step | realized min dist (dmin) | rt p99<=budget |",
             "|---|---|---|---|---|---|---|---|---|---|---|---|---|"]
    for r in out["ondevice"]:
        full, rt, ad = r["full"], r["rt"], r["rt_ad"]
        md = ("inf" if not math.isfinite(rt["min_dist"])
              else f"{rt['min_dist']:.3f} ({r['dmin']:.2f})")
        lines.append(
            f"| {r['name']} | {r['m']} | {r['N']} | {r['budget_ms']:.0f} | {_fmt(full['p50_ms'])} "
            f"| {_fmt(full['p99_ms'])} | {_fmt(rt['p50_ms'])} | {_fmt(rt['p99_ms'])} | "
            f"{_fmt(ad['p50_ms'])} | {_fmt(ad['p99_ms'])} | {rt['iters']:.1f} | {md} | "
            f"{'yes' if rt['p99_ms'] <= r['budget_ms'] else 'no'} |")
    lines += ["", "## The graph-safe form against solve_one (no-op: K1 launches a chunk made "
              "after their solve was done; eager: the chunk with each kernel launched from Python, "
              f"p50 over {out['eager']} starts)", "",
              "| scenario | no-op K1 share full / rt / rt-ad | rt graph p50 | rt eager solve_one p50 "
              "| rt eager solve_one_graph p50 |", "|---|---|---|---|---|"]
    for r in out["ondevice"]:
        rt = r["rt"]
        lines.append(
            f"| {r['name']} | {r['full']['noop_share']:.3f} / {rt['noop_share']:.3f} / "
            f"{r['rt_ad']['noop_share']:.3f} | {_fmt(rt['p50_ms'])} | "
            f"{_fmt(rt['eager_one_p50_ms'])} | {_fmt(rt['eager_graph_p50_ms'])} |")
    d = out.get("delay")
    if d is not None:
        lines += ["", "| scenario | mode | p50 | p99 | realized min dist (dmin) |",
                  "|---|---|---|---|---|",
                  f"| six_robot_antipodal | rt + delay=1 compensated | {_fmt(d['p50_ms'])} | "
                  f"{_fmt(d['p99_ms'])} | {d['min_dist']:.3f} (0.30) |"]
    if out.get("percall"):
        lines += ["", f"## Per-call host-loop latency (dispatch floor {out['floor_ms']:.3f} ms)",
                  "", "| scenario | m | N | budget ms | full p50 | full p99 | rt p50 | rt p99 | "
                  "fused rt p50 | rt max viol |", "|---|---|---|---|---|---|---|---|---|---|"]
        for r in out["percall"]:
            fz = "-" if r["fused_rt"] is None else _fmt(r["fused_rt"]["p50_ms"])
            lines.append(
                f"| {r['name']} | {r['m']} | {r['N']} | {r['budget_ms']:.0f} | "
                f"{_fmt(r['full']['p50_ms'])} | {_fmt(r['full']['p99_ms'])} | "
                f"{_fmt(r['rt']['p50_ms'])} | {_fmt(r['rt']['p99_ms'])} | {fz} | "
                f"{r['rt']['viol']:.1e} |")
    lid = out.get("lidar")
    if lid is not None:
        lines += ["", "## Family I closed loop (LiDAR v4, host loop)", "",
                  "| scenario | budget ms | p50 | p99 | p99<=budget | min clearance |",
                  "|---|---|---|---|---|---|",
                  f"| lidar_v4 | 75 | {_fmt(lid['p50_ms'])} | {_fmt(lid['p99_ms'])} | "
                  f"{'yes' if lid['p99_ms'] <= 75.0 else 'no'} | {lid['min_clearance']:.3f} |"]
    return "\n".join(lines)


def run(device, cases=CASES, steps: int = K, chunks: int = M, calls: int = CALLS,
        lidar_chunks: int = LIDAR_M, N: int | None = None, percall: bool = True,
        lidar: bool = True) -> dict:
    """Every row of the reference's tables on `device`; `N` overrides the
    cases' horizons (a small run), percall / lidar drop those tables."""
    def make(name, over):
        kw = dict(over, device=device)
        if N is not None:
            kw["N"] = N
        return get(name).make(**kw)

    out = dict(device=device_label(device), mode="graph" if device.type == "cuda" else "eager",
               K=steps, M=chunks, eager=min(EAGER, chunks), ondevice=[], percall=[], delay=None, lidar=None,
               floor_ms=dispatch_floor_ms(device))
    meas = functools.partial(measure_ondevice, steps=steps, chunks=chunks)
    for name, over in cases:
        sc, ocp = get(name), make(name, over)
        row = dict(name=name, m=sc.m, N=ocp.N, budget_ms=float(ocp.T) * 1e3,
                   dmin=math.sqrt(float(ocp.dmin2)) if sc.m > 1 else 0.0,
                   full=meas(ocp, CFG), rt=meas(ocp, CFG_RT, tighten=True),
                   rt_ad=meas(ocp, CFG_RT_AD, tighten=True))
        out["ondevice"].append(row)
        full, rt, ad = row["full"], row["rt"], row["rt_ad"]
        print(f"{name}: on-device full p50/p99 {full['p50_ms']:.2f}/{full['p99_ms']:.2f} ms | rt "
              f"p50/p99 {rt['p50_ms']:.2f}/{rt['p99_ms']:.2f} ms ({rt['iters']:.1f} iters/step, "
              f"min dist {rt['min_dist']:.3f}) | rt-ad p50/p99 {ad['p50_ms']:.2f}/"
              f"{ad['p99_ms']:.2f} ms ({ad['iters']:.1f} iters/step) | budget "
              f"{row['budget_ms']:.0f} ms | K1 a replay {rt.get('K1_per_replay', '-')}, no-op "
              f"share {rt['noop_share']:.3f} | rt eager solve_one / solve_one_graph p50 "
              f"{rt['eager_one_p50_ms']:.2f} / {rt['eager_graph_p50_ms']:.2f} ms")
    if any(name == "six_robot_antipodal" for name, _ in cases):
        d = meas(make("six_robot_antipodal", {}), CFG_RT, tighten=True, delay_compensate=True)
        out["delay"] = d
        print(f"six_robot_antipodal (delay-compensated rt): p50/p99 {d['p50_ms']:.2f}/"
              f"{d['p99_ms']:.2f} ms | min dist {d['min_dist']:.3f}")
    if percall:
        for name, over in cases:
            sc, ocp = get(name), make(name, over)
            row = dict(name=name, m=sc.m, N=ocp.N, budget_ms=float(ocp.T) * 1e3,
                       full=measure_percall(ocp, CFG, calls=calls),
                       rt=measure_percall(ocp, CFG_RT, calls=calls),
                       fused_rt=(measure_percall(ocp, CFG_RT, calls=calls,
                                                 engine=functools.partial(solve_one, cfg=CFG_RT))
                                 if route(ocp, CFG_RT) == "mega" else None))
            out["percall"].append(row)
            fz = "-" if row["fused_rt"] is None else f"{row['fused_rt']['p50_ms']:.2f}"
            print(f"{name}: per-call full p50 {row['full']['p50_ms']:.2f} ms | rt p50 "
                  f"{row['rt']['p50_ms']:.2f} ms | fused rt p50 {fz} ms")
    if lidar:
        lid = measure_lidar(device, steps, lidar_chunks, N)
        out["lidar"] = lid
        print(f"lidar_v4: host-loop p50/p99 {lid['p50_ms']:.2f}/{lid['p99_ms']:.2f} ms | min "
              f"clearance {lid['min_clearance']:.3f} | budget 75 ms")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m nmpc_tpu_torch.tools.latency")
    ap.add_argument("--cases", default=",".join(n for n, _ in CASES))
    ap.add_argument("--steps", type=int, default=K, help="MPC steps a chunk (K)")
    ap.add_argument("--chunks", type=int, default=M, help="chunk replays (M)")
    ap.add_argument("--calls", type=int, default=CALLS, help="solves a per-call row")
    ap.add_argument("--lidar-chunks", type=int, default=LIDAR_M)
    ap.add_argument("--N", type=int, default=None, help="override every case's horizon")
    ap.add_argument("--no-percall", action="store_true")
    ap.add_argument("--no-lidar", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--json", action="store_true", help="print every row as one JSON line last")
    a = ap.parse_args(argv)
    dev = resolve_device(a.device, "latency")
    over = dict(CASES)
    cases = [(n, over[n]) for n in a.cases.split(",")]
    out = run(dev, cases, a.steps, a.chunks, a.calls, a.lidar_chunks, a.N, not a.no_percall,
              not a.no_lidar)
    print(tables(out))
    if a.json:
        print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
