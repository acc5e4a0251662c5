"""Problems with static- and moving-obstacle rows for the K1/K2 tests: the
inputs as numpy arrays from a seed, so that the JAX package and the port
get the same ones, and the port's batched OCP built from them with torch
alone (the card's tests import no JAX).

Cases:
  obstacle_scenario_3  family H (one robot, six static obstacles), N=10,
                       starts drawn around the obstacles' keep-out circles
  robot_template       one robot with two moving-obstacle slots, N=8: the
                       decentralized subproblem of
                       nmpc_tpu/parallel/decentralized.py::robot_template(8,
                       0.1, 0.3, 3), per-scenario schedules with one slot
                       on the line to the goal (tests/test_batched_solver.py)
  all_rows             two robots with pair rows, two static obstacles and
                       two moving-obstacle slots, N=5

and, outside CASES (K1's widest row count, not the reference's kernel
tests): consensus48, the subproblem of one robot of the 48-robot consensus
fleet (tools/bench_consensus.py: robot_template(20, 0.1, 0.3, 48), the
antipodal circle of radius 0.16 m), 47 moving-obstacle slots: the other
robots in roll order on their cold plans, four of them (slots drawn per
scenario, so a batch puts every slot on some robot's way) moved onto the
robot's way.
"""

import numpy as np

CASES = ("obstacle_scenario_3", "robot_template", "all_rows")

# make_ocp keyword arguments of the cases that are not registry scenarios
TEMPLATE = dict(m=1, N=8, T=0.1, x0=[0.0, 0.0, 0.0], x_goal=[0.0, 0.0, 0.0], dmin=0.3)
ALL_ROWS = dict(m=2, N=5, T=0.1, x0=[0, 0, 0, 0.5, 0, 0], x_goal=[1, 1, 0, -1, 1, 0],
                dmin=0.3, collision=True, obstacles=[[0.2, 0.1, 0.1], [0.4, -0.2, 0.15]])


CONSENSUS48 = dict(m=1, N=20, T=0.1, x0=[0.0, 0.0, 0.0], x_goal=[0.0, 0.0, 0.0], dmin=0.3)
N_MOV = {"robot_template": 2, "all_rows": 2, "consensus48": 47}


def base_kwargs(name: str) -> dict:
    """make_ocp keyword arguments of a case (without mov_obs), or {} for a
    registry scenario made at N=10."""
    return {"robot_template": TEMPLATE, "all_rows": ALL_ROWS,
            "consensus48": CONSENSUS48}.get(name, {})


def draws(name: str, base, B: int, seed: int) -> dict:
    """Per-scenario inputs of a case as numpy float32 arrays: x0 [B, nx],
    xref [B, N, nx], mov [B, N, n_mov, 2] (None without moving obstacles),
    warm controls U, duals lam (|N(0, 0.5)|, zero on the masked stage-0
    rows) and mu in {10, 100}. `base` is the case's unbatched OCP of either
    package."""
    rng = np.random.default_rng(seed)
    N, nx, nu = base.N, base.nx, base.nu
    x0 = np.asarray(base.x0, np.float64)[None].repeat(B, 0)
    xref = np.asarray(base.xref, np.float64)[None].repeat(B, 0)
    if name == "obstacle_scenario_3":
        # around a random obstacle at 0.8-1.3 of its keep-out radius
        obs = np.asarray(base.obstacles, np.float64)
        o = rng.integers(0, len(obs), B)
        keep = obs[o, 2] + float(base.robot_radius) + float(base.obs_margin)
        ang = rng.uniform(0.0, 2 * np.pi, B)
        rad = keep * rng.uniform(0.8, 1.3, B)
        x0[:, 0] = obs[o, 0] + rad * np.cos(ang)
        x0[:, 1] = obs[o, 1] + rad * np.sin(ang)
        x0[:, 2] = rng.uniform(-np.pi, np.pi, B)
    elif name == "consensus48":
        # scenario b is robot b % 48 of the circle, bound for its antipode
        ang = 2 * np.pi * (np.arange(48) / 48)
        circ = 0.16 * 48 * np.stack([np.cos(ang), np.sin(ang)], -1)
        i = np.arange(B) % 48
        x0[:, :2] = circ[i] + 0.02 * rng.standard_normal((B, 2))
        x0[:, 2] = ang[i] + np.pi
        xref[:, :, :2] = -circ[i][:, None]
        xref[:, :, 2] = (ang[i] + np.pi)[:, None]
    elif name == "robot_template":
        x0[:, 0] = -0.5 + 0.1 * rng.standard_normal(B)
        x0[:, 1] = 0.2 * rng.standard_normal(B)
        xref[:] = np.array([0.6, 0.0, 0.0])
    else:
        x0 += 0.1 * rng.standard_normal((B, nx))
    mov = None
    if base.n_mov:
        if name == "consensus48":
            # the others in roll order at their starts; four slots, drawn
            # per scenario, on the way
            j = (i[:, None] + np.arange(1, 48)[None]) % 48                   # [B, 47]
            mov = circ[j][:, None].repeat(N, 1)                             # [B, N, 47, 2]
            ahead = x0[:, None, :2] + 0.25 * np.stack(
                [np.cos(x0[:, 2]), np.sin(x0[:, 2])], -1)[:, None]
            way = ahead[:, :, None] + 0.1 * rng.standard_normal((B, N, 4, 2))
            slots = np.argsort(rng.random((B, 47)), axis=1)[:, :4]
            for b in range(B):
                mov[b][:, slots[b]] = way[b]
        elif name == "robot_template":
            # one slot on the line to the goal, one far away
            mov = np.array([[0.05, 0.02], [5.0, 5.0]])[None, None].repeat(B, 0).repeat(N, 1)
            mov = mov + 0.01 * rng.standard_normal(mov.shape)
        else:
            # near robot 0's start
            mov = x0[:, None, None, :2] + 0.3 * rng.standard_normal((B, N, base.n_mov, 2))
        mov = mov.astype(np.float32)
    U = 0.05 * rng.standard_normal((B, N, nu))
    lam = 0.5 * np.abs(rng.standard_normal((B, N, base.n_con)))
    lam[:, 0, x_dependent(base)] = 0.0
    mu = rng.choice([10.0, 100.0], B)
    f32 = lambda a: a.astype(np.float32)  # noqa: E731
    return dict(x0=f32(x0), xref=f32(xref), mov=mov, U=f32(U), lam=f32(lam), mu=f32(mu))


def x_dependent(base) -> np.ndarray:
    """The rows of a stage that depend on the state (pairs, obstacles,
    moving obstacles, x box), in stage_constraints' order."""
    m = base.m
    return np.concatenate([np.ones(base.n_pairs, bool), np.ones(m * base.n_obs, bool),
                           np.ones(m * base.n_mov, bool), np.zeros(2 * base.nu, bool),
                           np.ones(2 * base.nx, bool)])


def port_case(name: str, B: int, seed: int, device="cpu"):
    """The port's batched OCP of a case and its warm state (U, lam, mu),
    as torch tensors on `device`."""
    import dataclasses

    import torch

    from nmpc_tpu_torch.ocp import problem as P
    from nmpc_tpu_torch.scenarios import get

    kw = base_kwargs(name)
    if kw:
        base = P.make_ocp(**kw, mov_obs=torch.zeros((kw["N"], N_MOV[name], 2)), device="cpu")
    else:
        base = get(name).make(N=10, device="cpu")
    d = draws(name, base, B, seed)
    ob = dataclasses.replace(base, x0=torch.as_tensor(d["x0"]), xref=torch.as_tensor(d["xref"]))
    if d["mov"] is not None:
        ob = dataclasses.replace(ob, mov_obs=torch.as_tensor(d["mov"]))
    return (ob.to(device), *(torch.as_tensor(d[k], device=device) for k in ("U", "lam", "mu")))
