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
engine. The closed loop stops as `decentralized_closed_loop` does.

`consensus_solve_sharded` lays the robots over a mesh dimension
(parallel/mesh.py): a round is two all_gathers (the plans, then the raw
iterates for the joint violation) and one MAX all-reduce (the plans'
largest move), and each rank solves its whole shard of robots as one batch.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from nmpc_tpu_torch.device import DEVICE
from nmpc_tpu_torch.mpc.driver import MPCConfig, _escape_control, escape_state0
from nmpc_tpu_torch.ocp.problem import OCP
from nmpc_tpu_torch.parallel.decentralized import (
    _neighbor_index,
    cold_warms,
    joint_template,
    right_hand_shift,
    robot_template,
    rolled_neighbours,
    run_loop,
    shift,
    solve_robots,
)
from nmpc_tpu_torch.parallel.mesh import all_reduce, axis_index, gather_rows, shard_rows
from nmpc_tpu_torch.sim.plant import PlantConfig, plant_step
from nmpc_tpu_torch.solver.alilqr import ALILQRConfig, WarmStart

__all__ = ["consensus_closed_loop", "consensus_solve", "consensus_solve_sharded",
           "joint_pair_violation", "robot_template"]


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


def _rounds(template: OCP, poses, xref, plans, warms: WarmStart, cfg: ALILQRConfig,
            rounds: int, damping: float, engine: str, rh_bias: float, neighbours,
            gather=lambda t: t, pmax=lambda t: t):
    """The Jacobi-AL rounds over the robots given (poses [k, 3], xref, plans
    [k, N+1, 2], warms): all k robots, or one shard of them. neighbours(all
    plans) -> [k, m-1, N+1, 2] are the neighbours' plans of the k robots;
    gather collects the robots' rows of every shard and pmax the largest
    value over the shards (both the identity on one program). Returns (X,
    warms, plans, viol_hist [rounds], delta_hist [rounds]) of the k robots."""
    N = template.N
    X = poses[:, None, :].repeat(1, N + 1, 1)
    violh, deltah = [], []
    for _ in range(rounds):
        # stage-k keep-out = the neighbour's plan at stage k (joint-row semantics)
        mov = neighbours(gather(plans))[:, :, :N, :].transpose(1, 2)   # [k, N, m-1, 2]
        if rh_bias:
            mov = right_hand_shift(mov, poses, rh_bias)
        res = solve_robots(template, poses, xref, mov, warms, cfg, engine)
        raw = res.X[:, :, :2]
        plans_new = damping * raw + (1.0 - damping) * plans
        deltah.append(pmax(torch.max(torch.abs(plans_new - plans))))
        violh.append(joint_pair_violation(gather(raw), template.dmin2, N))
        plans, X = plans_new, res.X
        warms = WarmStart(U=res.U, lam=res.lam, mu=res.mu)
    kw = dict(dtype=poses.dtype, device=poses.device)
    violh = torch.stack(violh) if violh else torch.zeros((0,), **kw)
    deltah = torch.stack(deltah) if deltah else torch.zeros((0,), **kw)
    return X, warms, plans, violh, deltah


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
    if plans is None:
        plans = _plans_cold(poses, N)
    if warms is None:
        warms = cold_warms(template, m, cfg)
    X, warms, plans, violh, deltah = _rounds(
        template, poses, goals[:, None, :].repeat(1, N, 1), plans, warms, cfg, rounds, damping,
        engine, rh_bias, lambda p: p[nbr])
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


def consensus_solve_sharded(mesh, template: OCP, cfg: ALILQRConfig = ALILQRConfig(),
                            rounds: int = 10, damping: float = 0.5, axis="robots",
                            rh_bias: float = 0.0, engine: str = "fused"):
    """`consensus_solve` with the robots laid over the mesh dimension `axis`
    (nmpc_tpu/parallel/consensus.py:259-352). Returns a callable
      (poses [m, 3], goals [m, 3], plans=None, warms=None) ->
      (X [m, N+1, 3], U [m, N, 2], warms, plans, viol_hist [rounds],
       delta_hist [rounds])
    of global arrays on every rank: each rank takes its rows, the
    robot-carried outputs are gathered, and the histories are the same on
    every rank by construction. m must divide over the shards.

    A round: all_gather of the plans; the rank's robots' subproblems, the
    neighbours in roll order (`decentralized.rolled_neighbours`, the
    reference's sharded order; the single-program form takes them in
    ascending order, so the rows are summed in another order) with the
    stage-k schedule `others[:, :N]` and the right-hand bias as
    `consensus_solve`'s; the damped plans; all_gather of the raw iterates
    for `joint_pair_violation`; a MAX all-reduce of the plans' largest move.

    engine="fused" solves the rank's whole shard of robots as one
    `solve_batched` a round (on CUDA tensors K1's obstacle variant and K2,
    with m-1 moving-obstacle rows); engine="xla" the per-scenario engine.
    Where the kernels do not take the template, "fused" raises
    (`decentralized.solve_robots`); the reference gives way to `solve`."""
    N = template.N

    def run(poses, goals, plans=None, warms=None):
        m = poses.shape[0]
        if plans is None:
            plans = _plans_cold(poses, N)
        if warms is None:
            warms = cold_warms(template, m, cfg)
        poses_l, goals_l, plans_l, wU, wlam, wmu = (
            shard_rows(a, mesh, axis) for a in (poses, goals, plans, warms.U, warms.lam, warms.mu))
        k = poses_l.shape[0]
        first = axis_index(mesh, axis) * k
        X, w, plans_l, violh, deltah = _rounds(
            template, poses_l, goals_l[:, None, :].repeat(1, N, 1), plans_l,
            WarmStart(U=wU, lam=wlam, mu=wmu), cfg, rounds, damping, engine, rh_bias,
            lambda p: rolled_neighbours(p, first, k),
            gather=lambda t: gather_rows(t, mesh, axis),
            pmax=lambda t: all_reduce(t, mesh, axis, dist.ReduceOp.MAX))
        U, lam, mu, X, plans_f = (gather_rows(a, mesh, axis)
                                  for a in (w.U, w.lam, w.mu, X, plans_l))
        return X, U, WarmStart(U=U, lam=lam, mu=mu), plans_f, violh, deltah

    return run
