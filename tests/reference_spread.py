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
`obstacles`: only the port's megakernel route on chip_smoke.py path (b)'s
problem, ~4 min; `gn`: only the cases of tests/test_torch_hybrid.py,
tests/test_torch_gn.py and tests/test_torch_lidar.py, ~1 min.)
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


def main():
    if sys.argv[1:] == ["gn"]:
        gn_cases()
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
