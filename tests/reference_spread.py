"""How far f32 rounding alone moves the reference's solves and closed loops:
the measurements behind the tolerances and case choices of
tests/test_torch_solver.py, tests/test_torch_driver.py,
tests/test_torch_driver_modes.py, tests/test_torch_parallel.py,
tests/test_torch_consensus.py and chip_smoke.py phases 16 and 17.

Each line moves x0 by 1e-7 x N(0, 1) (numpy seed 0, a few draws) and
reports the largest change of the result, on the reference alone unless
it says "port", plus the escape law's largest control difference between
the two packages. CPU only, a few minutes:

    JAX_PLATFORMS=cpu python tests/reference_spread.py [modes | obstacles | gn]

(`modes`: only the robot-parallel modes' closed loops, ~1 min;
`fuzz`: only the escape-law fuzz loops of tests/test_torch_loop_suite.py,
~1 min; `cl_parity`: only CL_PARITY's six_robot_antipodal and
six_robot_impl engine rows, ~5 min; `loops [hw | dec [ENGINE [SEED]]]`: the suite's loops that part
between the card and the CPU, ~30 min for all; `rates [DRAWS [LOOP...]] [vmap]`:
how often the six_robot_impl loops miss their bounds from starts moved by
1e-7, ~15 min a loop at 64, ~50 for the CL_PARITY row;
`hw_start`: the spread of those loops' first solve, ~1 min;
`latency`: the latency chunk of tests/test_torch_latency.py, ~1 min;
`obstacles`: only the port's megakernel route on chip_smoke.py path (b)'s
problem, ~4 min; `gn`: only the cases of tests/test_torch_hybrid.py,
tests/test_torch_gn.py and tests/test_torch_lidar.py, ~1 min;
`lidar_fuzz`: the batched LiDAR fuzz loops (`jax.vmap(closed_loop_lidar)`
over tests/test_lidar_fuzz.py's fields) at tests/test_torch_lidar.py's
size and chip_smoke.py phase 37's, per row and step, ~2 min;
`lidar_fuzz classes [DRAWS]`: the fuzz's two classes at their full size
from the start and DRAWS starts moved by 1e-7, each seed's outcome, the
bounds of tests/test_lidar_fuzz.py::_check, ~15 min a draw;
`tally RUN.jsonl [K/N ...]`: the port's side of `rates`, read from a saved
`python -m nmpc_tpu_torch.tools.loop_diff CASE --every 0 --spread S` run:
per loop the starts that missed arrival, and with one K/N a loop (the
reference's misses of N starts, from `rates`) the two-sided Fisher exact p
of the port's count against it, instant.)
"""

import dataclasses
import functools
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from nmpc_tpu.mpc import driver as JD  # noqa: E402
from nmpc_tpu.ocp.problem import make_ocp  # noqa: E402
from nmpc_tpu.solver.alilqr import ALILQRConfig as JaxConfig  # noqa: E402
from nmpc_tpu.solver.alilqr import solve as jax_solve  # noqa: E402
from nmpc_tpu.solver.alilqr_batched import solve_one as jax_solve_one  # noqa: E402
from nmpc_tpu_torch.mpc import driver as TD  # noqa: E402
from nmpc_tpu_torch.solver import ALILQRConfig, solve  # noqa: E402
from test_torch_driver import FAST, _escape_inputs, _scenario, jax_get, port_ocp  # noqa: E402
from test_torch_driver_modes import SIDE_OBSTACLE  # noqa: E402

DRAWS = 4


def moved(o, draws=DRAWS):
    rng = np.random.default_rng(0)
    for _ in range(draws):
        dx = 1e-7 * rng.standard_normal(o.nx).astype(np.float32)
        yield dataclasses.replace(o, x0=o.x0 + jnp.asarray(dx))


def loop_spread(tag, o, mpc_kw, fn="closed_loop", **kw):
    run = jax.jit(functools.partial(getattr(JD, fn), solver_cfg=JaxConfig(**FAST),
                                    mpc=JD.MPCConfig(**mpc_kw), **kw))
    a = run(o)
    dX = dU = 0.0
    for b in map(run, moved(o)):
        dX = max(dX, float(jnp.abs(a.X_hist - b.X_hist).max()))
        dU = max(dU, float(jnp.abs(a.U_hist - b.U_hist).max()))
    print(f"{tag}: X_hist {dX:.3e}, U_hist {dU:.3e}", flush=True)
    return dX, dU


def modes():
    """The decentralized and consensus closed loops of
    tests/test_torch_parallel.py and tests/test_torch_consensus.py (three
    robots on a jittered circle, N=10): the loops they hold pointwise and
    one each they do not, per history row."""
    from nmpc_tpu.parallel.consensus import consensus_closed_loop
    from nmpc_tpu.parallel.decentralized import decentralized_closed_loop
    from test_torch_parallel import circle

    cases = (("decentralized, seed 2, 15 steps (held)", decentralized_closed_loop, 2, 15,
              dict(cfg=JaxConfig(n_outer=6, n_inner=12, tol_con=1e-4))),
             ("decentralized, seed 1, 20 steps (not held)", decentralized_closed_loop, 1, 20,
              dict(cfg=JaxConfig(n_outer=6, n_inner=12, tol_con=1e-4))),
             ("consensus, seed 1, 8 steps (held)", consensus_closed_loop, 1, 8,
              dict(rounds=3, cfg=JaxConfig(n_outer=4, n_inner=10, tol_con=1e-4))),
             ("consensus, seed 2, 15 steps (not held)", consensus_closed_loop, 2, 15,
              dict(rounds=3, cfg=JaxConfig(n_outer=4, n_inner=10, tol_con=1e-4))))
    for tag, fn, seed, steps, kw in cases:
        x0, goals = circle(3, 0.8, 0.3, seed)
        run = jax.jit(functools.partial(fn, N=10, T=0.1, dmin=0.3, max_steps=steps, **kw))
        a = run(jnp.asarray(x0), jnp.asarray(goals))
        rng = np.random.default_rng(0)
        rows, dU = np.zeros(steps + 1), 0.0
        for _ in range(DRAWS):
            b = run(jnp.asarray(x0 + 1e-7 * rng.standard_normal(x0.shape).astype(np.float32)),
                    jnp.asarray(goals))
            rows = np.maximum(rows, np.abs(np.asarray(a[0] - b[0])).max(axis=1))
            dU = max(dU, float(jnp.abs(a[1] - b[1]).max()))
        print(f"{tag}: X_hist {rows.max():.3e}, U_hist {dU:.3e}; X_hist by row: "
              + ", ".join(f"{r:.1e}" for r in rows), flush=True)


def fuzz():
    """The escape-law fuzz loops that tests/test_torch_loop_suite.py holds
    pointwise (tests/test_escape_fuzz.py's geometry and config, one seed at
    m=2 and one at m=6), per history row."""
    from test_escape_fuzz import CFG, DMIN, _random_geometry

    for m, seed, steps in ((2, 0, 40), (6, 20, 40)):
        x0, xg = _random_geometry(m, seed)
        o = make_ocp(m=m, N=12, T=0.2, x0=x0, x_goal=xg, dmin=DMIN, collision=True)
        run = jax.jit(functools.partial(JD.closed_loop, solver_cfg=CFG,
                                        mpc=JD.MPCConfig(max_steps=steps, stop_tol=1e-1,
                                                         escape=True)))
        a = run(o)
        rows, dU = np.zeros(steps + 1), 0.0
        for b in map(run, moved(o)):
            rows = np.maximum(rows, np.abs(np.asarray(a.X_hist - b.X_hist)).max(axis=1))
            dU = max(dU, float(jnp.abs(a.U_hist - b.U_hist).max()))
        print(f"fuzz m={m} seed {seed}, {steps} steps: X_hist {rows.max():.3e}, U_hist "
              f"{dU:.3e}, steps used {int(a.steps_used)}; X_hist by row: "
              + ", ".join(f"{r:.1e}" for r in rows), flush=True)


def cl_parity():
    """The reference engine's loops of docs/CL_PARITY.md's six_robot_antipodal
    and six_robot_impl (delay=1) rows (tools/gen_cl_parity.py's engine_loop:
    10x20, 220 steps) from their starts and from x0 moved by 1e-7: arrival,
    steps and min pair distance per draw."""
    for name, kw in (("six_robot_antipodal", {}), ("six_robot_impl", {"delay": 1})):
        sc = jax_get(name)
        o = sc.make()
        run = jax.jit(functools.partial(
            JD.closed_loop, solver_cfg=JaxConfig(n_outer=10, n_inner=20, tol_con=1e-4),
            mpc=JD.MPCConfig(max_steps=220, stop_tol=sc.stop_tol, advance_tol=0.075, escape=True,
                             **kw)))
        for tag, oo in [("start", o)] + [(f"moved {i}", b) for i, b in enumerate(moved(o))]:
            r = run(oo)
            su = int(r.steps_used)
            print(f"CL_PARITY {name}, {tag}: reached {bool(r.reached)} in {su} steps, min pair "
                  f"distance {float(jnp.min(r.min_dist_hist[: su + 1])):.4f} (dmin {sc.dmin})",
                  flush=True)


def loop_outcomes(which="all", engine=None, seed=None):
    """Outcomes of the suite's loops that part between the card and the
    CPU (tests/test_torch_loop_suite.py, tools/loop_suite.py), on the
    reference from its start and from x0 moved by 1e-7: arrival, steps and
    min pair distance per draw. `hw`: six_robot_impl at 6x12
    (tests/test_rt_mode.py:213), undelayed and delay=1; `dec`: the
    decentralized fuzz at m=6 (tests/test_parallel.py:176), engine "xla"
    and "fused" (the Pallas kernels in interpret mode), seeds 20-22."""
    from nmpc_tpu.parallel.decentralized import decentralized_closed_loop
    from test_escape_fuzz import DMIN, _random_geometry

    if which in ("all", "hw"):
        sc = jax_get("six_robot_impl")
        o = sc.make()
        full = JaxConfig(n_outer=6, n_inner=12, tol_con=1e-4)
        for tag, kw in (("undelayed", {}), ("delay=1", dict(delay=1))):
            run = jax.jit(functools.partial(JD.closed_loop, solver_cfg=full, mpc=JD.MPCConfig(
                max_steps=150, stop_tol=sc.stop_tol, escape=True, **kw)))
            for d, oo in enumerate([o] + list(moved(o))):
                r = run(oo)
                su = int(r.steps_used)
                print(f"six_robot_impl {tag}, draw {d} (0: the start): reached {bool(r.reached)} in "
                      f"{su} steps, min pair distance {float(jnp.min(r.min_dist_hist[: su + 1])):.4f}, "
                      f"final err {float(r.err_hist[min(su, 149)]):.4f}", flush=True)
    if which in ("all", "dec"):
        for eng in ([engine] if engine else ["xla", "fused"]):
            fn = jax.jit(functools.partial(decentralized_closed_loop, N=12, T=0.2, dmin=DMIN,
                                           max_steps=600, engine=eng,
                                           cfg=JaxConfig(n_outer=6, n_inner=12, tol_con=1e-4)))
            for s in ([seed] if seed is not None else [20, 21, 22]):
                x0, xg = _random_geometry(6, s)
                rng = np.random.default_rng(0)
                for d in range(DRAWS + 1):
                    dx = 0.0 if d == 0 else 1e-7 * rng.standard_normal(x0.shape).astype(np.float32)
                    X, U, mind, done = fn(jnp.asarray(x0 + dx), jnp.asarray(xg).reshape(6, 3))
                    print(f"decentralized fuzz m=6 seed {s} engine {eng}, draw {d} (0: the start): "
                          f"reached {bool(done)}, min pair distance {float(jnp.min(mind)):.4f} "
                          f"(bound {DMIN - 3e-2:.2f})", flush=True)


def hw_start():
    """The first solve of tests/test_rt_mode.py:213's loops (six_robot_impl
    at 6x12 from its start, whose robots all head for the centre): the
    reference's U from x0 moved by 1e-7 against its U from x0, and the
    port's per-scenario U against the reference's from the same x0."""
    o = jax_get("six_robot_impl").make()
    cfg = dict(n_outer=6, n_inner=12, tol_con=1e-4)
    run = jax.jit(functools.partial(jax_solve, cfg=JaxConfig(**cfg)))
    a = run(o)
    moves = [float(jnp.abs(run(b).U - a.U).max()) for b in moved(o)]
    port = solve(port_ocp(o), cfg=ALILQRConfig(**cfg))
    print(f"six_robot_impl first solve at 6x12: the reference's U moves by "
          f"{', '.join(f'{v:.3f}' for v in moves)} under 1e-7 moves of x0; the port's U is "
          f"{float(np.abs(port.U.numpy() - np.asarray(a.U)).max()):.3f} from the reference's "
          f"at x0", flush=True)


def loop_rates(draws=64, *which, batched=False):
    """How often the reference's loops fail their bounds from starts within
    1e-7 of the registry start: the three loops of tests/test_rt_mode.py:213
    (six_robot_impl at 6x12, 150 steps: delay=1, undelayed, delay=1
    compensated) and CL_PARITY's six_robot_impl row (tools/gen_cl_parity.py's
    engine_loop: 10x20, 220 steps, delay=1), each from the start and from
    draws - 1 starts moved by 1e-7 x N(0, 1) (numpy seed 0), one jitted loop
    a start: per loop the arrivals, the draws that miss with their final
    err, and the min pair distance's range. `which`: the loops' indices
    (0-3, default all; one process each runs them side by side). `batched`:
    one jitted loop vmapped over all starts, as tests/test_escape_fuzz.py
    runs its loops (the same mathematics, another rounding)."""
    sc = jax_get("six_robot_impl")
    o = sc.make()
    starts = [o.x0] + [b.x0 for b in moved(o, draws - 1)]
    base = dict(stop_tol=sc.stop_tol, escape=True)
    loops = (("test_rt_mode.py:213 delay=1", 6, 12, 150, dict(delay=1)),
             ("test_rt_mode.py:213 undelayed", 6, 12, 150, {}),
             ("test_rt_mode.py:213 delay=1 compensated", 6, 12, 150,
              dict(delay=1, delay_compensate=True)),
             ("CL_PARITY six_robot_impl (delay=1)", 10, 20, 220, dict(delay=1, advance_tol=0.075)))
    for tag, n_outer, n_inner, steps, kw in [loops[i] for i in which or range(len(loops))]:
        cfg = JaxConfig(n_outer=n_outer, n_inner=n_inner, tol_con=1e-4)
        mpc = JD.MPCConfig(max_steps=steps, **base, **kw)
        if batched:
            loop = lambda x0: JD.closed_loop(dataclasses.replace(o, x0=x0), cfg, mpc)  # noqa: E731
            r = jax.jit(jax.vmap(loop))(jnp.stack(starts))
            rs = [jax.tree.map(lambda a, d=d: a[d], r) for d in range(draws)]
        else:
            run = jax.jit(functools.partial(JD.closed_loop, solver_cfg=cfg, mpc=mpc))
            rs = (run(dataclasses.replace(o, x0=x0)) for x0 in starts)
        missed, mds = [], []
        for d, r in enumerate(rs):
            su = int(r.steps_used)
            mds.append(float(jnp.min(r.min_dist_hist[: su + 1])))
            if not bool(r.reached):
                missed.append(f"{d}: err {float(r.err_hist[min(su, steps - 1)]):.4f}")
        tag += " (vmapped)" if batched else ""
        print(f"{tag}: reached from {draws - len(missed)} of {draws} starts (0: the start; "
              f"missed {', '.join(missed) or 'none'}); min pair distance {min(mds):.4f}-"
              f"{max(mds):.4f}, below 0.21 on {sum(m < 0.21 for m in mds)}", flush=True)


def obstacles():
    """The port's megakernel route (plain K1 and K2 on the CPU) on
    chip_smoke.py path (b)'s problem: obstacle_scenario_3 at N=100, 32
    starts jittered by 0.05, 12x25. Its f32 solve against itself in f64
    and under 1e-7 moves of x0: the spread that chip_smoke phase 22's CPU
    re-solve of the card's solve is read against."""
    from nmpc_tpu_torch.ocp.problem import OCP_META
    from nmpc_tpu_torch.parallel import batch_ocp
    from nmpc_tpu_torch.scenarios import get
    from nmpc_tpu_torch.solver import solve_batched

    g = torch.Generator().manual_seed(22)
    base = get("obstacle_scenario_3").make(device="cpu")
    ob = batch_ocp(base, base.x0[None] + 0.05 * torch.randn((32, 3), generator=g))
    cfg = ALILQRConfig(n_outer=12, n_inner=25, tol_con=1e-3)
    a = solve_batched(ob, cfg=cfg)
    f64 = dataclasses.replace(ob, **{f.name: getattr(ob, f.name).double()
                                     for f in dataclasses.fields(ob) if f.name not in OCP_META})
    others = [("f64", solve_batched(f64, cfg=cfg))]
    for k in range(2):
        gm = torch.Generator().manual_seed(100 + k)
        moved = dataclasses.replace(ob, x0=ob.x0 + 1e-7 * torch.randn(ob.x0.shape, generator=gm))
        others.append((f"x0 moved by 1e-7 ({k})", solve_batched(moved, cfg=cfg)))
    for tag, b in others:
        rel = (a.cost.double() - b.cost.double()).abs() / b.cost.double().abs()
        du = (a.U.double() - b.U.double()).abs().amax(dim=(1, 2))
        print(f"port path (b) megakernel route, 32 scenarios, f32 against {tag}: cost within "
              f"rtol 1e-4 on {int((rel <= 1e-4).sum())}/32 (max rel {float(rel.max()):.3e}), U "
              f"within 5e-3 on {int((du <= 5e-3).sum())}/32, mean cost ratio "
              f"{float(a.cost.double().mean() / b.cost.double().mean()):.6f}", flush=True)


def gn_cases():
    """The solves and loops of tests/test_torch_hybrid.py (the hybrid
    route), tests/test_torch_gn.py (the condensed GN engine and its
    slsqp_multigoal waypoint loop) and tests/test_torch_lidar.py (the LiDAR
    loop, per history row)."""
    from nmpc_tpu.mpc.lidar import closed_loop_lidar
    from nmpc_tpu.solver import alilqr_batched as JB
    from nmpc_tpu.solver import gn as JG
    from test_torch_gn import CASES as GN_CASES
    from test_torch_hybrid import CASES as HYBRID_CASES
    from test_torch_hybrid import rk4_batch
    from test_torch_lidar import OBSTACLES

    def solve_spread(tag, fn, o):
        run = jax.jit(fn)
        a = run(o)
        rng = np.random.default_rng(0)
        du = dc = 0.0
        for _ in range(3):
            b = run(dataclasses.replace(o, x0=o.x0 + jnp.asarray(
                1e-7 * rng.standard_normal(o.x0.shape), jnp.float32)))
            du = max(du, float(jnp.abs(a.U - b.U).max()))
            dc = max(dc, float((jnp.abs(a.cost - b.cost) / jnp.abs(a.cost)).max()))
        print(f"{tag}: U {du:.3e}, cost rel {dc:.3e}", flush=True)

    cases = {k: (make(), kw) for k, (make, kw, _) in HYBRID_CASES.items()}
    cases["rk4 N=12"] = (rk4_batch(N=12), HYBRID_CASES["rk4"][1])
    # rays and user models with moving obstacles (the jacfwd constraint
    # Jacobians carrying the stage's schedule)
    from test_torch_generic import moving_generic
    from test_torch_hybrid import moving_ray_batch

    jo, _, jb, _ = moving_generic()
    for sweep in ("seq", "scan"):
        cases[f"rays + moving obstacle, {sweep}"] = (
            moving_ray_batch(), dict(n_outer=4, n_inner=8, tol_con=1e-3, sweep=sweep))
        cases[f"user unicycle + moving obstacle, {sweep}"] = (
            jb, dict(n_outer=4, n_inner=10, tol_con=1e-3, sweep=sweep))
    solve_spread("solve, user unicycle + moving obstacle", functools.partial(
        jax_solve, cfg=JaxConfig(n_outer=4, n_inner=10, tol_con=1e-3)), jo)
    for tag, (ob, kw) in cases.items():
        solve_spread(f"hybrid route, {tag}", functools.partial(
            JB.solve_batched, cfg=JaxConfig(**kw)), ob)
    for tag, (make, kw) in GN_CASES.items():
        solve_spread(f"gn.solve, {tag}", functools.partial(JG.solve, cfg=JG.GNConfig(**kw)), make())
    sc = jax_get("slsqp_multigoal")
    cfg = JG.GNConfig(Nc=sc.Nc, n_gn=15, n_outer=6)
    loop_spread("slsqp_multigoal GN waypoints, 40 steps", sc.make(),
                dict(max_steps=40, advance_tol=sc.advance_tol, escape=True),
                fn="closed_loop_waypoints", waypoints=sc.waypoint_array,
                solve_fn=lambda o, w: JG.solve(o, w, cfg))
    sc = jax_get("lidar_v4")
    o = sc.make(N=40)
    run = jax.jit(functools.partial(
        closed_loop_lidar, sim_obstacles=jnp.asarray(OBSTACLES),
        waypoints=jnp.asarray(sc.waypoints, jnp.float32), max_steps=20,
        cfg=JG.GNConfig(Nc=20, n_gn=10, n_outer=4, tol_con=1e-3)))
    a = run(o)
    rng = np.random.default_rng(0)
    rows = np.zeros(21)
    for _ in range(3):
        dx = np.zeros(o.nx, np.float32)
        dx[:3] = 1e-7 * rng.standard_normal(3)
        b = run(dataclasses.replace(o, x0=o.x0 + jnp.asarray(dx)))
        rows = np.maximum(rows, np.abs(np.asarray(a[0] - b[0])).max(axis=1))
    print("closed_loop_lidar lidar_v4 N=40 Nc=20, 20 steps: X_hist by row: "
          + ", ".join(f"{r:.1e}" for r in rows), flush=True)
    # chip_smoke.py phase 25's CPU re-solve: path (d)'s problem (lidar_v2
    # N=100, starts jittered by 0.05, 10x20) on the port's hybrid route,
    # the plain path against itself with x0 moved by 1e-7, 8 scenarios
    from nmpc_tpu_torch.solver import solve_batched
    from nmpc_tpu_torch.tools import lidar_fleet

    base = lidar_fleet.scanned("lidar_v2", [[0.5, 0.25, 0.15]], "cpu", ray_lo=0.3)
    cfg = ALILQRConfig(n_outer=10, n_inner=20, tol_con=1e-3)
    for seed in (0, 1):
        ob = lidar_fleet.jittered(base, 8, torch.Generator().manual_seed(seed))
        a = solve_batched(ob, cfg=cfg)
        for k in range(2):
            dx = torch.zeros_like(ob.x0)
            dx[:, :3] = 1e-7 * torch.randn((8, 3), generator=torch.Generator().manual_seed(100 + k))
            b = solve_batched(dataclasses.replace(ob, x0=ob.x0 + dx), cfg=cfg)
            rel = (a.cost - b.cost).abs() / b.cost.abs()
            print(f"port path (d) 8 starts (seed {seed}) against x0 moved by 1e-7 ({k}): cost "
                  f"within 1e-4 on {int((rel <= 1e-4).sum())}/8 (max rel {float(rel.max()):.3e}), "
                  f"converged flags that differ {int((a.converged != b.converged).sum())}, mean "
                  f"cost ratio {float(a.cost.mean() / b.cost.mean()):.6f}", flush=True)


def latency():
    """The reference's latency chunk (tools/gen_latency.py::make_chunk, K=3,
    CFG_RT, with and without delay compensation) from the starts of
    tests/test_torch_latency.py and from x0 moved by 1e-7: the change of its
    final state, per case (tb3_1 is the one held; two_robot_swap and
    eight_robot are not)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "reference_gen_latency", os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "tools", "gen_latency.py"))
    GL = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(GL)
    GL.K = 3
    from nmpc_tpu.scenarios import get as jget

    for name, N, jitter in (("tb3_1", 20, 0.2), ("two_robot_swap", 10, 0.0),
                            ("eight_robot", 5, 0.01)):
        for delay in (False, True):
            o = jget(name).make(N=N)
            # the seed solve at the registry start, the chunk from the moved one
            w = JD.shift_warm(jax.jit(functools.partial(jax_solve, cfg=GL.CFG))(o), GL.CFG_RT)
            f = GL.make_chunk(o, o, GL.CFG_RT, delay)
            x0 = np.asarray(o.x0) + jitter * np.random.default_rng(1).standard_normal(
                o.nx).astype(np.float32)
            o = dataclasses.replace(o, x0=jnp.asarray(x0))
            a = f(o.x0, w)
            dx = max(float(jnp.abs(f(b.x0, w)[0] - a[0]).max()) for b in moved(o))
            print(f"latency chunk {name} N={N} start moved by {jitter} (delay_compensate={delay}):"
                  f" final state {dx:.3e}", flush=True)


def lidar_fuzz(which="rows", draws=2):
    """The reference's batched LiDAR fuzz loop from its start and from the
    start pose moved by 1e-7 (the template's x0, shared by every row).
    "rows": at tests/test_torch_lidar.py's size (single-obstacle seeds 0-2,
    N=10, Nc=5, 15 steps) and at chip_smoke.py phase 37's (seeds 0-3, N=40,
    Nc=20, 8 steps), the largest move of each row's X_hist at each step.
    "classes": both classes of tests/test_lidar_fuzz.py at full size (N=40,
    600 steps), each seed's completion, min clearance and failed bounds per
    start."""
    from nmpc_tpu.mpc.lidar import closed_loop_lidar
    from nmpc_tpu.scenarios import get as get_sc
    from nmpc_tpu.solver import gn as JG
    from test_lidar_fuzz import CFG, MAX_STEPS, N, _random_field

    def run_fn(o, n_obs, seeds, cfg, steps):
        geoms = [_random_field(s, n_obs) for s in seeds]
        goals = jnp.stack([jnp.asarray(g[0])[None] for g in geoms])
        obst = jnp.stack([jnp.asarray(g[1]) for g in geoms])
        return jax.jit(jax.vmap(lambda ob, wps: closed_loop_lidar(
            o, sim_obstacles=ob, waypoints=wps, cfg=cfg, max_steps=steps)))(obst, goals)

    if which == "rows":
        for tag, n, seeds, cfg, steps in (
                ("tier-1 (test_torch_lidar.py)", 10, (0, 1, 2),
                 JG.GNConfig(Nc=5, n_gn=10, n_outer=6, tol_con=1e-3), 15),
                ("chip_smoke phase 37", N, (0, 1, 2, 3), CFG, 8)):
            o = get_sc("lidar_v4").make(N=n)
            a = run_fn(o, 1, seeds, cfg, steps)
            rows = np.zeros((len(seeds), steps + 1))
            for b in (run_fn(ob, 1, seeds, cfg, steps) for ob in moved(o, draws)):
                rows = np.maximum(rows, np.abs(np.asarray(a[0] - b[0])).max(axis=-1))
            for i, s in enumerate(seeds):
                print(f"lidar fuzz {tag} N={n} seed {s}: X_hist by step "
                      + ", ".join(f"{r:.1e}" for r in rows[i]), flush=True)
        return
    for n_obs, seeds in ((1, tuple(range(10))), (2, (0, 1, 2, 3, 4, 5))):
        o = get_sc("lidar_v4").make(N=N)
        for tag, oo in [("start", o)] + [(f"moved {i}", b) for i, b in enumerate(moved(o, draws))]:
            X, U, clr, gidx, done = (np.asarray(a) for a in run_fn(oo, n_obs, seeds, CFG,
                                                                    MAX_STEPS))
            outs = []
            for i, s in enumerate(seeds):
                bad = []
                if clr[i].min() < 0.10:
                    bad.append("clearance")
                if np.abs(U[i, :, 0]).max() > 0.15 + 1e-3 or np.abs(U[i, :, 1]).max() > 1.5 + 1e-3:
                    bad.append("box")
                drift = float(np.hypot(*(X[i, -1, :2] - X[i, -100, :2])))
                if not done[i] and drift <= 0.05 and clr[i, -1] < 0.15:
                    bad.append("stall inside")
                outs.append(f"{s}:{'done' if done[i] else 'open'} {clr[i].min():.3f}"
                            + (f" FAILS {'+'.join(bad)}" if bad else ""))
            print(f"lidar fuzz n_obs={n_obs} {tag}: {int(done.sum())}/{len(seeds)} complete; "
                  + ", ".join(outs), flush=True)


def tally(path, *versus):
    """Per loop tag, in the loops' order, the starts run and the starts that
    missed arrival over the JSON lines of a loop_diff run saved at `path`;
    with versus K/N (one a loop) the two-sided Fisher exact p against it."""
    import json

    from scipy.stats import fisher_exact

    tags, starts, missed = [], {}, {}
    with open(path) as f:
        for line in f:
            if not line.startswith("{"):
                continue
            for rec in json.loads(line)["loops"]:
                tag = str(rec["tag"])
                if tag not in starts:
                    tags.append(tag)
                    starts[tag] = missed[tag] = 0
                starts[tag] += 1
                missed[tag] += not rec["reached"]
    for i, tag in enumerate(tags):
        row = f"{tag}: missed {missed[tag]} of {starts[tag]} starts"
        if i < len(versus):
            k, n = (int(v) for v in versus[i].split("/"))
            _, p = fisher_exact([[missed[tag], starts[tag] - missed[tag]], [k, n - k]])
            row += f", the reference {k} of {n}: Fisher exact p {p:.3f}"
        print(row, flush=True)


def main():
    if sys.argv[1:2] == ["tally"]:
        tally(*sys.argv[2:])
        return
    if sys.argv[1:2] == ["lidar_fuzz"]:
        lidar_fuzz(*(sys.argv[2:3] or ["rows"]), *[int(a) for a in sys.argv[3:4]])
        return
    if sys.argv[1:] == ["latency"]:
        latency()
        return
    if sys.argv[1:] == ["gn"]:
        gn_cases()
        return
    if sys.argv[1:2] == ["loops"]:
        loop_outcomes(*(sys.argv[2:3] or ["all"]),
                      *(sys.argv[3:4] or [None]),
                      *([int(sys.argv[4])] if sys.argv[4:5] else []))
        return
    if sys.argv[1:] == ["cl_parity"]:
        cl_parity()
        return
    if sys.argv[1:] == ["hw_start"]:
        hw_start()
        return
    if sys.argv[1:2] == ["rates"]:
        loop_rates(*[int(a) for a in sys.argv[2:] if a != "vmap"], batched="vmap" in sys.argv)
        return
    if sys.argv[1:] == ["fuzz"]:
        fuzz()
        return
    if sys.argv[1:] == ["modes"]:
        modes()
        return
    if sys.argv[1:] == ["obstacles"]:
        obstacles()
        return
    heading = dict(N=25, T=0.1, x0=(0.0, 0.0, 0.98))
    # loops the tests hold pointwise, and the ones they do not
    loop_spread("single_robot registry start, 30 steps (not held past 2)",
                _scenario("single_robot", N=25, T=0.1),
                dict(max_steps=30, stop_tol=5e-2, escape=True))
    held = [
        loop_spread("single_robot heading at its goal, 30 steps",
                    _scenario("single_robot", **heading), dict(max_steps=30, stop_tol=5e-2, escape=True)),
        loop_spread("two_robot_swap, second robot facing its goal, 15 steps",
                    _scenario("two_robot_swap", N=25, T=0.1, x0=(-1.0, -1.0, 0.785, 1.0, 1.0, 3.9)),
                    dict(max_steps=15, escape=True)),
        loop_spread("delay=1, 15 steps", _scenario("single_robot", **heading),
                    dict(max_steps=15, stop_tol=5e-2, escape=True, delay=1)),
        loop_spread("delay=1 compensated, 15 steps", _scenario("single_robot", **heading),
                    dict(max_steps=15, stop_tol=5e-2, escape=True, delay=1, delay_compensate=True)),
        loop_spread("wrap_yaw, 15 steps",
                    _scenario("single_robot", N=25, T=0.1, x0=(0.0, 0.0, 0.98 - 2 * np.pi),
                              x_goal=(1.0, 1.5, 0.98)),
                    dict(max_steps=15, stop_tol=5e-2, wrap_yaw=True)),
    ]
    held.append(loop_spread(
        "waypoints past an obstacle beside the path, 25 steps", make_ocp(**SIDE_OBSTACLE),
        dict(max_steps=25), fn="closed_loop_waypoints",
        waypoints=jnp.asarray([[0.6, 0.0, 0.0], [0.6, 0.4, 1.57]], jnp.float32)))
    print(f"largest over the held loops: X_hist {max(h[0] for h in held):.3e}, "
          f"U_hist {max(h[1] for h in held):.3e}", flush=True)
    sc = jax_get("obstacle_scenario_1")
    wps = jnp.asarray(sc.waypoints[:2], jnp.float32)
    for steps in (1, 2, 10):
        loop_spread(f"obstacle_scenario_1 N=25 waypoints, {steps} steps (held: 1)", sc.make(N=25),
                    dict(max_steps=steps, advance_tol=sc.advance_tol), fn="closed_loop_waypoints",
                    waypoints=wps)

    # one solve
    o = jax_get("single_robot").make(N=25, T=0.1)
    run = jax.jit(functools.partial(jax_solve, cfg=JaxConfig()))
    a = run(o)
    for b in map(run, moved(o)):
        print(f"single_robot N=25 solve, default config: U {float(jnp.abs(a.U - b.U).max()):.3e}, "
              f"inner iterations {int(a.inner_iters)} -> {int(b.inner_iters)}", flush=True)
    head = jax_get("six_robot_antipodal").make()
    strong = dict(n_outer=15, n_inner=25, tol_con=1e-4)
    a = jax.jit(functools.partial(jax_solve, cfg=JaxConfig(**strong)))(head)
    b = jax.jit(lambda o: jax_solve_one(o, None, JaxConfig(**strong)))(head)
    print(f"six_robot_antipodal N=35 15x25 cold: solve {float(a.cost):.4f}, solve_one "
          f"{float(b.cost):.4f}, rel {abs(float(a.cost - b.cost)) / float(a.cost):.3e}", flush=True)
    t = port_ocp(head)
    for tag, cfg in (("15x25", ALILQRConfig(**strong)), ("2x10", ALILQRConfig(n_outer=2, n_inner=10))):
        ra = solve(t, cfg=cfg)
        for mo in moved(head, 2):
            rb = solve(dataclasses.replace(t, x0=torch.tensor(np.asarray(mo.x0))), cfg=cfg)
            print(f"port six_robot_antipodal N=35 {tag} cold: cost rel "
                  f"{abs(float(ra.cost - rb.cost)) / float(ra.cost):.3e}, U "
                  f"{float((ra.U - rb.U).abs().max()):.3e}", flush=True)
    # the headline loop through the port's per-scenario engine (chip_smoke
    # phase 17 holds the card against the CPU over the rows this leaves
    # stable), per history row
    for tag, cfg, steps in (("15x25", ALILQRConfig(**strong), 4),
                            ("2x10", ALILQRConfig(n_outer=2, n_inner=10), 10)):
        mpc = TD.MPCConfig(max_steps=steps, stop_tol=0.1, escape=True)
        ra = TD.closed_loop(t, cfg, mpc)
        for mo in moved(head, 3):
            rb = TD.closed_loop(dataclasses.replace(t, x0=torch.tensor(np.asarray(mo.x0))), cfg, mpc)
            rows = (ra.X_hist - rb.X_hist).abs().amax(dim=1)
            print(f"port six_robot_antipodal N=35 {tag} closed loop, X_hist by row: "
                  + ", ".join(f"{float(r):.1e}" for r in rows), flush=True)

    # the escape law, port against reference
    worst = 0.0
    mpc = JD.MPCConfig(escape=True)
    for name, kw in (("six_robot_antipodal", dict(N=5)), ("obstacle_scenario_1", dict(N=5)),
                     ("single_robot", dict(N=5, T=0.1))):
        o = jax_get(name).make(**kw)
        t = port_ocp(o)
        for seed in range(DRAWS):
            x, u, esc, done = _escape_inputs(np.random.default_rng(seed), o, 2048, mpc.escape_stall_steps)
            ju, _ = jax.vmap(lambda a, b, c, d: JD._escape_control(o, mpc, a, o.xref[-1], b, c, d))(
                jnp.asarray(x), jnp.asarray(u), jnp.asarray(esc), jnp.asarray(done))
            tu, _ = TD._escape_control(t, TD.MPCConfig(escape=True), torch.tensor(x), t.xref[-1],
                                       torch.tensor(u), torch.tensor(esc), torch.tensor(done))
            worst = max(worst, float(np.abs(tu.numpy() - np.asarray(ju)).max()))
    print(f"escape law, port against reference, {DRAWS} batches of 2048 per case: controls "
          f"{worst:.3e}", flush=True)
    modes()
    obstacles()


if __name__ == "__main__":
    main()
