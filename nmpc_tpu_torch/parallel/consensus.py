"""The joint multi-robot NMPC solve by Jacobi-AL consensus over robots, on
one device. Port of `joint_pair_violation`, `_plans_cold`,
`consensus_solve` and `consensus_closed_loop` from
nmpc_tpu/parallel/consensus.py.

The centralized joint NLP couples robots only through the pair keep-out
rows d_ij^2 - dmin^2 >= 0; with each pair row duplicated once per endpoint,
a block-Jacobi scheme over robots (each robot minimizes the joint augmented
Lagrangian over its own trajectory, the neighbours' fixed) has the joint
problem's KKT points as fixed points. One round:

  1. exchange position plans,
  2. every robot solves its own 3-state OCP with the neighbours' plans as
     stage-synchronous moving keep-outs (stage k against stage k, as the
     joint rows; `decentralized_step` offsets by one stage because its
     plans are a control period stale),
  3. under-relax the exchanged plans (`damping`) and carry the AL duals and
     penalty (lam, mu) across rounds.

The robots ride the batch axis of one solve a round, with the engines of
`decentralized.solve_robots`: engine="fused" is `solve_batched` (on CUDA
tensors K1, its obstacle variant, and K2), engine="xla" the per-scenario
engine. The closed loop stops as `decentralized_closed_loop` does. The
sharded form (`consensus_solve_sharded`) is not ported yet.
"""

from __future__ import annotations

import torch

from nmpc_tpu_torch.device import DEVICE
from nmpc_tpu_torch.mpc.driver import MPCConfig, _escape_control, escape_state0
from nmpc_tpu_torch.ocp.problem import OCP
from nmpc_tpu_torch.parallel.decentralized import (
    _neighbor_index,
    cold_warms,
    joint_template,
    right_hand_shift,
    robot_template,
    run_loop,
    shift,
    solve_robots,
)
from nmpc_tpu_torch.sim.plant import PlantConfig, plant_step
from nmpc_tpu_torch.solver.alilqr import ALILQRConfig, WarmStart

__all__ = ["consensus_closed_loop", "consensus_solve", "joint_pair_violation",
           "robot_template"]


def joint_pair_violation(plans, dmin2, N: int):
    """Max violation of the joint pair rows dmin^2 - d_ij^2 <= 0 over stages
    0..N-1 of the position plans [m, N+1, 2] (squared-distance units, as
    SolveResult.viol)."""
    m = plans.shape[0]
    P = plans[:, :N, :]
    d2 = torch.sum((P[:, None] - P[None, :]) ** 2, dim=-1)            # [m, m, N]
    off = ~torch.eye(m, dtype=torch.bool, device=plans.device)
    v = torch.clamp(dmin2 - d2, min=0.0) * off[:, :, None]
    return torch.max(v)


def _plans_cold(poses, N: int):
    return poses[:, None, :2].repeat(1, N + 1, 1)


def consensus_solve(template: OCP, x_joint, goals, cfg: ALILQRConfig = ALILQRConfig(),
                    rounds: int = 10, damping: float = 0.5, warms: WarmStart | None = None,
                    plans=None, engine: str = "fused", rh_bias: float = 0.0):
    """Joint solve with the robots on the batch axis (x_joint [3m] joint
    initial state, goals [m, 3]).

    Returns (X [m, N+1, 3], U [m, N, 2], warms, plans, viol_hist [rounds],
    delta_hist [rounds]). `warms`/`plans` warm-start from an earlier step;
    viol_hist is the joint pair violation of each round's raw (undamped)
    iterate, delta_hist the largest move of the damped plans.

    rh_bias > 0 applies the right-hand traffic rule (`decentralized.
    right_hand_shift`): exactly symmetric conflicts stall the symmetric
    Jacobi iteration on the reciprocal saddle. Leave 0 for joint-KKT parity;
    the caller must inflate the template's dmin by rh_bias."""
    m, N = goals.shape[0], template.N
    nbr = _neighbor_index(m, goals.device)
    poses = x_joint.reshape(m, 3)
    xref = goals[:, None, :].repeat(1, N, 1)
    if plans is None:
        plans = _plans_cold(poses, N)
    if warms is None:
        warms = cold_warms(template, m, cfg)
    X = poses[:, None, :].repeat(1, N + 1, 1)
    violh, deltah = [], []
    for _ in range(rounds):
        # stage-k keep-out = the neighbour's plan at stage k (joint-row semantics)
        mov = plans[nbr][:, :, :N, :].transpose(1, 2)                  # [m, N, m-1, 2]
        if rh_bias:
            mov = right_hand_shift(mov, poses, rh_bias)
        res = solve_robots(template, poses, xref, mov, warms, cfg, engine)
        raw = res.X[:, :, :2]
        plans_new = damping * raw + (1.0 - damping) * plans
        deltah.append(torch.max(torch.abs(plans_new - plans)))
        violh.append(joint_pair_violation(raw, template.dmin2, N))
        plans, X = plans_new, res.X
        warms = WarmStart(U=res.U, lam=res.lam, mu=res.mu)
    kw = dict(dtype=poses.dtype, device=poses.device)
    violh = torch.stack(violh) if violh else torch.zeros((0,), **kw)
    deltah = torch.stack(deltah) if deltah else torch.zeros((0,), **kw)
    return X, warms.U, warms, plans, violh, deltah


def consensus_closed_loop(x0_joint, goals, N: int, T: float, dmin: float, rounds: int = 3,
                          max_steps: int = 200, stop_tol: float = 1e-1,
                          cfg: ALILQRConfig = ALILQRConfig(), damping: float = 0.5,
                          v_max: float = 0.22, omega_max: float = 2.84, escape: bool = True,
                          engine: str = "fused", rh_bias: float = 0.1, device=DEVICE):
    """Closed-loop MPC with the robot-parallel joint solve each period:
    `rounds` consensus rounds warm-started from the previous step's shifted
    plans and duals (mu carried: resetting it under carried lam breaks the
    PHR activation band), the first joint control, the escape law, the
    plant.

    Returns (X_hist [S+1, 3m], U_hist [S, 2m], min_dist_hist [S+1],
    reached)."""
    x0_joint = torch.as_tensor(x0_joint, dtype=torch.float32, device=device)
    goals = torch.as_tensor(goals, dtype=torch.float32, device=device)
    m = goals.shape[0]
    # keep-out inflated by rh_bias so the perception shift cannot eat into
    # the true dmin margin (as decentralized_closed_loop)
    template = robot_template(N, T, dmin + rh_bias, m, v_max, omega_max, dtype=x0_joint.dtype,
                              device=device)
    goal_joint = goals.reshape(3 * m)
    joint = joint_template(template, m, x0_joint, goal_joint)   # the escape law reads no x0
    mpc_like = MPCConfig(stop_tol=stop_tol, escape=True)
    not_done = torch.zeros((), dtype=torch.bool, device=device)
    carry = {"plans": _plans_cold(x0_joint.reshape(m, 3), N), "warms": cold_warms(template, m, cfg),
             "esc": escape_state0(m, device)}

    def step(x):
        _, U, warms, plans_new, _, _ = consensus_solve(
            template, x, goals, cfg, rounds=rounds, damping=damping, warms=carry["warms"],
            plans=carry["plans"], engine=engine, rh_bias=rh_bias)
        u_joint = U[:, 0, :].reshape(2 * m)
        if escape:
            u_joint, carry["esc"] = _escape_control(joint, mpc_like, x, goal_joint, u_joint,
                                                    carry["esc"], not_done)
        x_next, _ = plant_step(x, u_joint, template.T, PlantConfig())
        carry["warms"] = WarmStart(U=shift(warms.U), lam=shift(warms.lam), mu=warms.mu)
        carry["plans"] = shift(plans_new)
        return x_next, u_joint

    return run_loop(x0_joint, goal_joint, m, max_steps, stop_tol, step)
