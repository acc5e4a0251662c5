"""Decentralized NMPC with neighbour-plan exchange, on one device. Port of
`robot_template`, `_neighbor_index`, `decentralized_step` and
`decentralized_closed_loop` from nmpc_tpu/parallel/decentralized.py.

Each robot solves its own 3-state OCP, the other robots' previously
exchanged plans as time-indexed moving obstacles, then publishes its new
plan. The robots' subproblems are one batch:

* engine="fused" (the default): `solve_batched` on the robots' batch, the
  neighbours' plans as per-scenario moving-obstacle schedules
  [m, N, m-1, 2]. On CUDA tensors that is the megakernel route: K1
  (csrc/inner_warp.cuh, its obstacle variant) and K2 per AL outer step.
  A template the kernels do not take raises (the reference's falls back
  to the per-scenario engine instead).
* engine="xla": the per-scenario engine over the robots
  (`parallel.batch.batched_solve`, plain PyTorch), the reference's vmap of
  `solve`; kept for verification.

The closed loop is a Python loop over control steps with the reference's
fixed-length histories. Its histories record the realized state, the
applied control and the realized clearance, never a solve's output: from
the first step that starts done the state is frozen and the control zero
(done is sticky), so every later row is that step's row, and the loop
stops there without solving again.

The sharded form, `decentralized_step_sharded`, lays the robots over a
mesh dimension (parallel/mesh.py): each rank solves its own robots and the
plan exchange is one all_gather of the plans over the mesh.
"""

from __future__ import annotations

import dataclasses

import torch

from nmpc_tpu_torch.device import DEVICE
from nmpc_tpu_torch.mpc.driver import MPCConfig, _escape_control, escape_state0
from nmpc_tpu_torch.ocp.problem import OCP, make_ocp
from nmpc_tpu_torch.ops import rollout
from nmpc_tpu_torch.parallel.batch import batched_solve
from nmpc_tpu_torch.parallel.mesh import axis_index, gather_rows, shard_rows
from nmpc_tpu_torch.sim.plant import PlantConfig, plant_step
from nmpc_tpu_torch.solver.alilqr import ALILQRConfig, WarmStart
from nmpc_tpu_torch.solver.alilqr_batched import solve_batched


def robot_template(N: int, T: float, dmin: float, m: int, v_max: float = 0.22,
                   omega_max: float = 2.84, pos_bound: float = 10.0, dtype=torch.float32,
                   device=DEVICE) -> OCP:
    """Single-robot OCP with m-1 moving-obstacle slots."""
    return make_ocp(m=1, N=N, T=T, x0=torch.zeros(3), x_goal=torch.zeros(3), v_max=v_max,
                    omega_max=omega_max, pos_bound=pos_bound, dmin=dmin,
                    mov_obs=torch.zeros((N, m - 1, 2)), dtype=dtype, device=device)


def _neighbor_index(m: int, device=None) -> torch.Tensor:
    """[m, m-1]: row i lists the other robots in order."""
    return torch.tensor([[j for j in range(m) if j != i] for i in range(m)], dtype=torch.long,
                        device=device)


def rolled_neighbours(plans, first: int, count: int):
    """The neighbours' plans of robots first .. first+count-1 in the
    sharded forms' order: robot i sees i+1, ..., m-1, 0, ..., i-1 (the
    reference's jnp.roll(plans, -i)[1:]), not `_neighbor_index`'s
    ascending order. plans [m, ...] -> [count, m-1, ...]."""
    m = plans.shape[0]
    i = torch.arange(first, first + count, device=plans.device)[:, None]
    j = torch.arange(1, m, device=plans.device)[None, :]
    return plans[(i + j) % m]


def cold_warms(template: OCP, m: int, cfg: ALILQRConfig = ALILQRConfig()) -> WarmStart:
    """The cold start of each of m robots' subproblems, batched."""
    kw = dict(dtype=template.x0.dtype, device=template.device)
    return WarmStart(U=torch.zeros((m, template.N, template.nu), **kw),
                     lam=torch.zeros((m, template.N, template.n_con), **kw),
                     mu=torch.full((m,), cfg.mu_init, **kw))


def right_hand_shift(mov, poses, rh_bias: float):
    """The right-hand traffic rule: each robot perceives its neighbours'
    positions mov [m, N, m-1, 2] shifted by rh_bias to its own left, seen
    from its pose (poses [m, 3]). The square root is taken in f64 and
    rounded once, so it is correctly rounded on every device (PyTorch's
    vectorized f32 sqrt on the CPU is off by an ulp on ~0.6% of inputs)."""
    rel = mov - poses[:, None, None, :2]
    d2 = torch.sum(rel * rel, dim=-1, keepdim=True) + 1e-9
    nrm = torch.sqrt(d2.double()).to(d2.dtype)
    left = torch.stack([-rel[..., 1], rel[..., 0]], dim=-1) / nrm
    return mov + rh_bias * left


def solve_robots(template: OCP, poses, xref, mov, warms: WarmStart, cfg: ALILQRConfig,
                 engine: str):
    """The robots' subproblems (x0 poses [m, 3], xref [m, N, 3], schedules
    mov [m, N, m-1, 2]) as one batch: `solve_batched` for engine "fused"
    on a template of the staged kernels' class, which they take at any
    fleet size (the reference's rule; elsewhere the reference gives way to
    the per-scenario engine, the port raises), and the per-scenario engine
    for engine "xla"."""
    ocp_b = dataclasses.replace(template, x0=poses, xref=xref, mov_obs=mov.contiguous())
    if engine == "fused":
        why = rollout.unsupported(template)
        if why is not None:
            raise NotImplementedError(f"solve_robots: engine 'fused' does not cover {why}")
        return solve_batched(ocp_b, warms, cfg)
    if engine == "xla":
        return batched_solve(ocp_b, cfg, warms)
    raise ValueError(f"solve_robots: unknown engine {engine!r}")


def decentralized_step(template: OCP, x_joint, goals, plans, warms: WarmStart,
                       cfg: ALILQRConfig = ALILQRConfig(), rh_bias: float = 0.03,
                       engine: str = "fused"):
    """One synchronous decentralized round: solve all robots' subproblems
    against the exchanged plans (x_joint [3m] latched joint measurement,
    goals [m, 3], plans [m, N+1, 2], warms batched over robots). Returns
    (results, u_joint [2m], new plans [m, N+1, 2]).

    The stage-k keep-out sees a neighbour at its plan's stage k+1 (plans are
    one control period stale after the shift). rh_bias > 0 applies the
    right-hand traffic rule (`right_hand_shift`), a deterministic tie-break
    for the exactly symmetric standoffs that deadlock plain reciprocal
    avoidance."""
    m, N = plans.shape[0], template.N
    poses = x_joint.reshape(m, 3)
    mov = plans[_neighbor_index(m, plans.device)][:, :, 1:N + 1, :].transpose(1, 2)
    if rh_bias:
        mov = right_hand_shift(mov, poses, rh_bias)
    xref = goals[:, None, :].expand(m, N, 3).contiguous()
    res = solve_robots(template, poses, xref, mov, warms, cfg, engine)
    return res, res.U[:, 0, :].reshape(2 * m), res.X[:, :, :2]


def joint_template(template: OCP, m: int, x, goal_joint) -> OCP:
    """The joint m-robot problem at the joint state x that the escape law
    reads (bounds, the period and the keep-out of pair rows), built from the
    single-robot template as the reference builds it."""
    N = template.N
    return dataclasses.replace(
        template, m=m, n_mov=0, collision=True,   # arms the escape clearance gate
        x0=x, xref=goal_joint[None].repeat(N, 1),
        Qdiag=template.Qdiag.repeat(m), Rdiag=template.Rdiag.repeat(m),
        u_lo=template.u_lo.repeat(m), u_hi=template.u_hi.repeat(m),
        x_lo=template.x_lo.repeat(m), x_hi=template.x_hi.repeat(m),
        mov_obs=torch.zeros((N, 0, 2), dtype=goal_joint.dtype, device=goal_joint.device))


def min_dist(x, m: int):
    """Smallest distance between two of the m robots of the joint state x."""
    p = x.reshape(m, 3)[:, :2]
    d2 = torch.sum((p[:, None, :] - p[None, :, :]) ** 2, dim=-1)
    d2 = d2 + torch.eye(m, dtype=x.dtype, device=x.device) * 1e9
    return torch.sqrt(torch.min(d2))


def shift(a):
    """The reference scripts' shift(): drop the first stage, repeat the
    last, along dim 1 of [m, N(+1), ...]."""
    return torch.cat([a[:, 1:], a[:, -1:]], dim=1)


def run_loop(x0_joint, goal_joint, m: int, max_steps: int, stop_tol: float, step):
    """The closed loop's steps: step(x) -> (x_next, u_joint) advances a step
    that does not start done. Returns (X_hist [S+1, 3m], U_hist [S, 2m],
    min_dist_hist [S+1], reached), S = max_steps. A step that starts done
    keeps the state and applies zero; it and every later row are the same,
    so they are filled in without stepping (module note)."""
    x = x0_joint
    done = torch.zeros((), dtype=torch.bool, device=x.device)
    xs, us, mind = [], [], []
    for _ in range(max_steps):
        done = done | (torch.linalg.norm(x - goal_joint) <= stop_tol)
        if bool(done):
            rest = max_steps - len(xs)
            xs += [x] * rest
            us += [torch.zeros(2 * m, dtype=x.dtype, device=x.device)] * rest
            mind += [min_dist(x, m)] * rest
            break
        x, u = step(x)
        xs.append(x)
        us.append(u)
        mind.append(min_dist(x, m))
    X_hist = torch.cat([x0_joint[None], torch.stack(xs)]) if xs else x0_joint[None]
    U_hist = torch.stack(us) if us else torch.zeros((0, 2 * m), dtype=x.dtype, device=x.device)
    mind = torch.stack([min_dist(x0_joint, m)] + mind)
    return X_hist, U_hist, mind, done


def decentralized_closed_loop(x0_joint, goals, N: int, T: float, dmin: float,
                              max_steps: int = 200, stop_tol: float = 1e-1,
                              cfg: ALILQRConfig = ALILQRConfig(),
                              plant: PlantConfig = PlantConfig(), v_max: float = 0.22,
                              omega_max: float = 2.84, rh_bias: float = 0.1,
                              escape: bool = True, engine: str = "fused", device=DEVICE):
    """Closed loop in decentralized mode: each control period one
    `decentralized_step` against the stale plans, the parking-saddle escape
    on the joint state, the plant, then the shift of the controls, duals
    and plans (mu reset to cfg.mu_init).

    Returns (X_hist [S+1, 3m], U_hist [S, 2m], min_dist_hist [S+1],
    reached). The keep-out radius is inflated by rh_bias so the right-hand
    perception shift cannot eat into the true dmin margin."""
    x0_joint = torch.as_tensor(x0_joint, dtype=torch.float32, device=device)
    goals = torch.as_tensor(goals, dtype=torch.float32, device=device)
    m = goals.shape[0]
    template = robot_template(N, T, dmin + rh_bias, m, v_max, omega_max, dtype=x0_joint.dtype,
                              device=device)
    goal_joint = goals.reshape(3 * m)
    joint = joint_template(template, m, x0_joint, goal_joint)   # the escape law reads no x0
    mpc_like = MPCConfig(stop_tol=stop_tol, escape=True)
    not_done = torch.zeros((), dtype=torch.bool, device=device)
    carry = {"plans": x0_joint.reshape(m, 3)[:, None, :2].repeat(1, N + 1, 1),
             "warms": cold_warms(template, m, cfg), "esc": escape_state0(m, device)}

    def step(x):
        res, u_joint, plans_new = decentralized_step(template, x, goals, carry["plans"],
                                                     carry["warms"], cfg, rh_bias=rh_bias,
                                                     engine=engine)
        if escape:
            u_joint, carry["esc"] = _escape_control(joint, mpc_like, x, goal_joint, u_joint,
                                                    carry["esc"], not_done)
        x_next, _ = plant_step(x, u_joint, template.T, plant)
        carry["warms"] = WarmStart(U=shift(res.U), lam=shift(res.lam),
                                   mu=torch.full_like(res.mu, cfg.mu_init))
        carry["plans"] = shift(plans_new)
        return x_next, u_joint

    return run_loop(x0_joint, goal_joint, m, max_steps, stop_tol, step)


def decentralized_step_sharded(mesh, template: OCP, cfg: ALILQRConfig = ALILQRConfig(),
                               axis="robots"):
    """The decentralized round with the robots laid over the mesh dimension
    `axis` (nmpc_tpu/parallel/decentralized.py:212-262): each rank solves its
    own robots' subproblems, and the plan exchange is one all_gather of the
    plans over the mesh. Returns a callable (poses [m, 3], goals [m, 3],
    plans [m, N+1, 2], warm_U [m, N, 2], warm_lam [m, N, n_con], warm_mu
    [m]) -> (u [m, 2], plans_new [m, N+1, 2]): global arrays in, global
    arrays out on every rank (each rank takes its rows, the outputs are
    gathered). m must divide over the shards.

    The stage-k keep-out is the neighbour's plan at stage k+1
    (`others[:, 1:N+1]`), as in `decentralized_step`. As the reference's
    sharded form, and unlike `decentralized_step`: the neighbours come in
    roll order (`rolled_neighbours`; the reference masks self to +1e6
    before its roll, and the roll drops that row, so the rows taken are the
    same), there is no right-hand bias, and the subproblems go to the
    per-scenario engine (`batched_solve`, the reference's vmap of `solve`;
    plain PyTorch)."""
    N = template.N

    def step(poses, goals, plans, warm_U, warm_lam, warm_mu):
        poses_l, goals_l, plans_l, wU, wlam, wmu = (
            shard_rows(a, mesh, axis) for a in (poses, goals, plans, warm_U, warm_lam, warm_mu))
        all_plans = gather_rows(plans_l, mesh, axis)                  # the exchange
        k = poses_l.shape[0]
        others = rolled_neighbours(all_plans, axis_index(mesh, axis) * k, k)
        mov = others[:, :, 1:N + 1, :].transpose(1, 2)                # [k, N, m-1, 2]
        xref = goals_l[:, None, :].expand(k, N, 3).contiguous()
        res = solve_robots(template, poses_l, xref, mov, WarmStart(U=wU, lam=wlam, mu=wmu), cfg,
                           "xla")
        return gather_rows(res.U[:, 0, :], mesh, axis), gather_rows(res.X[:, :, :2], mesh, axis)

    return step
