"""How far f32 rounding alone moves the reference's solves and closed loops:
the measurements behind the tolerances and case choices of
tests/test_torch_solver.py, tests/test_torch_driver.py,
tests/test_torch_driver_modes.py and chip_smoke.py phases 16 and 17.

Each line moves x0 by 1e-7 x N(0, 1) (numpy seed 0, a few draws) and
reports the largest change of the result, on the reference alone unless
it says "port", plus the escape law's largest control difference between
the two packages. CPU only, a few minutes:

    JAX_PLATFORMS=cpu python tests/reference_spread.py
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


def main():
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


if __name__ == "__main__":
    main()
