"""OCP definition: the multiple-shooting NMPC problem as a dataclass of tensors.

Port of nmpc_tpu/ocp/problem.py. Stage cost
sum_k (x_k - xref_k)' Q (x_k - xref_k) + u_k' R u_k, explicit-Euler dynamics,
and the inequality set canonicalized to c(x, u) >= 0, row order per stage:
pairs d12..d(m-1)m, static obstacles (robot-major), moving obstacles
(robot-major), u_lo, u_hi, x_lo, x_hi.

Kinks (abs, max) are written so that automatic differentiation takes JAX's
side at the kink: torch.where for |t| (+1 at 0) and torch.maximum for
max(a, b) (1/2 each at a tie; torch.clamp gives 1).

Batching: a batched OCP carries a leading [B] axis on x0 [B, nx], xref
[B, N, nx] and, for per-element neighbour plans, mov_obs [B, N, n_mov, 2];
every other field is shared. Every function below takes any number of
leading batch dimensions on its tensor arguments and broadcasts them against
the OCP's fields (the JAX package vmaps instead).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from nmpc_tpu_torch.device import DEVICE
from nmpc_tpu_torch.models.unicycle import discrete_dynamics

# A finite stand-in for +inf bounds: keeps AL arithmetic NaN-free while making
# the corresponding constraints permanently inactive.
BIG = 1e9

# Static fields (everything else is a tensor).
OCP_META = (
    "m", "N", "n_obs", "num_rays", "integrator", "collision", "n_mov",
    "dyn_fn", "nx_gen", "nu_gen", "substeps",
)


def num_pairs(m: int) -> int:
    return m * (m - 1) // 2


def pair_indices(m: int):
    """Static upper-triangle (i, j) index tuples, i < j, reference ordering
    d12, d13, ..., d1m, d23, ..."""
    ii, jj = [], []
    for i in range(m):
        for j in range(i + 1, m):
            ii.append(i)
            jj.append(j)
    return tuple(ii), tuple(jj)


@dataclasses.dataclass(frozen=True)
class OCP:
    """One NMPC problem instance (or a batch of them).

    Shapes: nx = 3m + num_rays, nu = 2m.
      T: scalar sampling time            Qdiag: [nx]      Rdiag: [nu]
      x0: [(B,) nx]                      xref: [(B,) N, nx] stage reference
      u_lo/u_hi: [nu]                    x_lo/x_hi: [nx]
      dmin2: scalar (squared min inter-robot distance)
      obstacles: [n_obs, 3] rows (ox, oy, r)
      p_obs: [num_rays, 2] frozen LiDAR obstacle points (augmented model)
      mov_obs: [(B,) N, n_mov, 2] per-stage moving obstacles
    """

    # --- static metadata ---
    m: int
    N: int
    n_obs: int
    num_rays: int
    integrator: str
    collision: bool
    n_mov: int

    # --- tensor data ---
    T: torch.Tensor
    Qdiag: torch.Tensor
    Rdiag: torch.Tensor
    x0: torch.Tensor
    xref: torch.Tensor
    u_lo: torch.Tensor
    u_hi: torch.Tensor
    x_lo: torch.Tensor
    x_hi: torch.Tensor
    dmin2: torch.Tensor
    obstacles: torch.Tensor
    robot_radius: torch.Tensor
    obs_margin: torch.Tensor
    inv_dist_weight: torch.Tensor
    p_obs: torch.Tensor
    mov_obs: torch.Tensor

    # --- generic-dynamics hook (static; defaults keep the unicycle class) ---
    dyn_fn: object = None
    nx_gen: int = 0
    nu_gen: int = 0
    substeps: int = 1

    @property
    def nx(self) -> int:
        if self.dyn_fn is not None:
            return self.nx_gen
        return 3 * self.m + self.num_rays

    @property
    def nu(self) -> int:
        if self.dyn_fn is not None:
            return self.nu_gen
        return 2 * self.m

    @property
    def n_pairs(self) -> int:
        return num_pairs(self.m) if self.collision else 0

    @property
    def n_con(self) -> int:
        """Inequality rows per stage (canonical c >= 0)."""
        return (
            self.n_pairs
            + self.m * self.n_obs
            + self.m * self.n_mov
            + 2 * self.nu
            + 2 * self.nx
        )

    @property
    def device(self) -> torch.device:
        return self.x0.device

    def to(self, device) -> "OCP":
        """The same problem with every tensor field on `device`."""
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self) if f.name not in OCP_META
        })


def default_weights(m: int, dtype=torch.float32, device=DEVICE):
    """Per-robot Q = diag(1, 5, 0.1), R = diag(0.5, 0.05)."""
    Q = torch.tensor([1.0, 5.0, 0.1], dtype=dtype, device=device).repeat(m)
    R = torch.tensor([0.5, 0.05], dtype=dtype, device=device).repeat(m)
    return Q, R


def make_ocp(
    *,
    m: int,
    N: int,
    T: float,
    x0,
    x_goal=None,
    xref=None,
    Qdiag=None,
    Rdiag=None,
    v_max: float = 0.22,
    omega_max: float = 2.84,
    pos_bound: float = 10.0,
    theta_bound: float = BIG,
    dmin: float = 0.0,
    collision: bool = False,
    obstacles=None,
    robot_radius: float = 0.1,
    obs_margin: float = 0.05,
    num_rays: int = 0,
    ray_lo: float = 0.15,
    ray_hi: float = 10.0,
    inv_dist_weight: float = 0.0,
    p_obs=None,
    mov_obs=None,
    integrator: str = "euler",
    dtype=torch.float32,
    device=DEVICE,
) -> OCP:
    """Convenience constructor mirroring the knobs of the reference scripts."""
    kw = dict(dtype=dtype, device=device)

    def t(a):
        return torch.as_tensor(a, **kw)

    nx_pose = 3 * m
    nx = nx_pose + num_rays
    nu = 2 * m
    x0 = t(x0).reshape(-1)
    if num_rays and x0.shape[0] == nx_pose:
        # seed ray states at the LiDAR range cap
        x0 = torch.cat([x0, torch.full((num_rays,), 3.5, **kw)])
    x0 = x0.reshape(nx)
    if xref is None:
        assert x_goal is not None, "need x_goal or xref"
        goal = t(x_goal).reshape(nx_pose)
        if num_rays:
            goal = torch.cat([goal, torch.zeros((num_rays,), **kw)])
        xref = goal[None, :].repeat(N, 1)
    else:
        xref = t(xref).reshape(N, nx)

    if Qdiag is None or Rdiag is None:
        Qd, Rd = default_weights(m, dtype, device)
        Qdiag = Qd if Qdiag is None else t(Qdiag)
        Rdiag = Rd if Rdiag is None else t(Rdiag)
    else:
        Qdiag, Rdiag = t(Qdiag), t(Rdiag)
    if num_rays and Qdiag.shape[0] == nx_pose:
        # ray states carry no tracking cost
        Qdiag = torch.cat([Qdiag, torch.zeros((num_rays,), **kw)])

    u_hi = t([v_max, omega_max]).repeat(m)
    x_hi_pose = t([pos_bound, pos_bound, theta_bound]).repeat(m)
    if num_rays:
        x_lo = torch.cat([-x_hi_pose, torch.full((num_rays,), ray_lo, **kw)])
        x_hi = torch.cat([x_hi_pose, torch.full((num_rays,), ray_hi, **kw)])
    else:
        x_lo, x_hi = -x_hi_pose, x_hi_pose

    n_obs = 0 if obstacles is None else len(obstacles)
    obstacles = (torch.zeros((0, 3), **kw) if obstacles is None
                 else t(obstacles).reshape(n_obs, 3))
    p_obs = (torch.zeros((num_rays, 2), **kw) if p_obs is None
             else t(p_obs).reshape(num_rays, 2))
    if mov_obs is None:
        n_mov = 0
        mov_obs = torch.zeros((N, 0, 2), **kw)
    else:
        mov_obs = t(mov_obs)
        n_mov = mov_obs.shape[1]

    return OCP(
        m=m,
        N=N,
        n_obs=n_obs,
        num_rays=num_rays,
        integrator=integrator,
        collision=collision and m > 1,
        n_mov=n_mov,
        T=t(T),
        Qdiag=Qdiag,
        Rdiag=Rdiag,
        x0=x0,
        xref=xref,
        u_lo=-u_hi,
        u_hi=u_hi,
        x_lo=x_lo,
        x_hi=x_hi,
        dmin2=t(dmin * dmin),
        obstacles=obstacles,
        robot_radius=t(robot_radius),
        obs_margin=t(obs_margin),
        inv_dist_weight=t(inv_dist_weight),
        p_obs=p_obs,
        mov_obs=mov_obs,
    )


def ocp_from_numpy(arrays: dict, device=DEVICE, **meta) -> OCP:
    """The port's OCP from the data fields of a reference OCP, each given as
    a numpy array, plus its static metadata (the OCP_META fields). This is
    how a problem built by `nmpc_tpu` crosses to the port unchanged."""
    data = {k: torch.as_tensor(np.array(v), device=device)
            for k, v in arrays.items()}
    return OCP(**data, **meta)


# ---------------------------------------------------------------------------
# Dynamics
# ---------------------------------------------------------------------------


def step_dynamics(ocp: OCP, x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """One discrete step of the (possibly LiDAR-augmented) model."""
    if ocp.dyn_fn is not None:
        raise NotImplementedError("user dynamics (make_generic_ocp) are not ported yet")
    if ocp.num_rays == 0:
        return discrete_dynamics(x, u, ocp.T, ocp.integrator)
    # Augmented model: pose evolves by Euler; ray distance d_m propagates as
    # the 1-norm distance from the next position to the frozen point p_obs[m].
    pose = x[..., :3]
    pose_next = discrete_dynamics(pose, u, ocp.T, "euler")
    delta = pose_next[..., None, :2] - ocp.p_obs  # [..., R, 2]
    # |t| with derivative +1 at t = 0, as JAX differentiates abs (torch.abs
    # has 0 there): a ray whose point sits on the pose's axis is the cold
    # start's normal case
    d_next = torch.sum(torch.where(delta >= 0, delta, -delta), dim=-1)
    return torch.cat([pose_next, d_next], dim=-1)


def rollout(ocp: OCP, U: torch.Tensor, x0=None) -> torch.Tensor:
    """Roll the controls through the dynamics: U [..., N, nu] -> X [..., N+1, nx]."""
    x = ocp.x0 if x0 is None else x0
    states = [x]
    for k in range(U.shape[-2]):
        x = step_dynamics(ocp, x, U[..., k, :])
        states.append(x)
    return torch.stack(torch.broadcast_tensors(*states), dim=-2)


# ---------------------------------------------------------------------------
# Cost
# ---------------------------------------------------------------------------


def stage_cost(ocp: OCP, x: torch.Tensor, u: torch.Tensor,
               xref_k: torch.Tensor) -> torch.Tensor:
    """(x - xref)' Q (x - xref) + u' R u  [+ (1/d)' L (1/d) for ray states]."""
    dx = x - xref_k
    c = torch.sum(dx * ocp.Qdiag * dx, dim=-1) + torch.sum(u * ocp.Rdiag * u, dim=-1)
    if ocp.num_rays:
        inv_d = 1.0 / torch.maximum(x[..., 3:], x.new_tensor(1e-3))
        c = c + ocp.inv_dist_weight * torch.sum(inv_d * inv_d, dim=-1)
    return c


# ---------------------------------------------------------------------------
# Inequality constraints (canonical c(x, u) >= 0)
# ---------------------------------------------------------------------------


def _positions(ocp: OCP, x: torch.Tensor) -> torch.Tensor:
    return x[..., : 3 * ocp.m].reshape(*x.shape[:-1], ocp.m, 3)[..., :2]


def pairwise_sq_distances(ocp: OCP, x: torch.Tensor) -> torch.Tensor:
    """All m(m-1)/2 squared planar distances, reference ordering."""
    ii, jj = pair_indices(ocp.m)
    pos = _positions(ocp, x)
    diff = pos[..., list(ii), :] - pos[..., list(jj), :]
    return torch.sum(diff * diff, dim=-1)


def stage_constraints(ocp: OCP, x: torch.Tensor, u: torch.Tensor,
                      mov_k: torch.Tensor | None = None) -> torch.Tensor:
    """Stack all per-stage inequalities as c >= 0; shape [..., n_con].

    mov_k: [..., n_mov, 2] positions of this stage's moving obstacles;
    defaults to stage 0's entries."""
    lead = torch.broadcast_shapes(x.shape[:-1], u.shape[:-1])
    x = x.expand(*lead, x.shape[-1])
    u = u.expand(*lead, u.shape[-1])
    parts = []
    if ocp.n_pairs:
        parts.append(pairwise_sq_distances(ocp, x) - ocp.dmin2)
    if ocp.n_obs or ocp.n_mov:
        pos = _positions(ocp, x)  # [..., m, 2]
    if ocp.n_obs:
        delta = pos[..., :, None, :] - ocp.obstacles[:, :2]  # [..., m, n_obs, 2]
        d2 = torch.sum(delta * delta, dim=-1)
        dist = torch.sqrt(torch.maximum(d2, d2.new_tensor(1e-12)))
        # the keep-out radius folded into one number, as the kernels'
        # parameter block holds it (ops/rollout.py::params)
        keepout = ocp.obstacles[:, 2] + ocp.robot_radius + ocp.obs_margin
        c_obs = dist - keepout
        parts.append(c_obs.reshape(*lead, -1))
    if ocp.n_mov:
        mov_k = ocp.mov_obs[..., 0, :, :] if mov_k is None else mov_k
        delta = pos[..., :, None, :] - mov_k[..., None, :, :]  # [..., m, n_mov, 2]
        d2 = torch.sum(delta * delta, dim=-1)
        parts.append((d2 - ocp.dmin2).reshape(*lead, -1))
    parts.append(u - ocp.u_lo)
    parts.append(ocp.u_hi - u)
    parts.append(x - ocp.x_lo)
    parts.append(ocp.x_hi - x)
    return torch.cat(parts, dim=-1)


def trajectory_constraints(ocp: OCP, X: torch.Tensor, U: torch.Tensor) -> torch.Tensor:
    """c_k for k = 0..N-1 evaluated at (X[k], U[k]); shape [..., N, n_con].
    Rows are enforced at stages 0..N-1 and not at the terminal state."""
    return stage_constraints(ocp, X[..., :-1, :], U,
                             ocp.mov_obs if ocp.n_mov else None)


def x_dependent_rows(ocp: OCP) -> np.ndarray:
    """Static bool [n_con]: rows that depend only on the state (not u).
    Order matches stage_constraints: pairs, obstacles, moving, u-box, x-box."""
    return np.concatenate([
        np.ones(ocp.n_pairs, bool),
        np.ones(ocp.m * ocp.n_obs, bool),
        np.ones(ocp.m * ocp.n_mov, bool),
        np.zeros(2 * ocp.nu, bool),
        np.ones(2 * ocp.nx, bool),
    ])


def constraint_mask(ocp: OCP) -> torch.Tensor:
    """[N, n_con] 1/0 mask. Stage-0 state-only rows are masked out: X[:,0] is
    pinned to the measurement, so those rows are constants."""
    row0 = torch.as_tensor(~x_dependent_rows(ocp), dtype=torch.float32,
                           device=ocp.device)
    mask = torch.ones((ocp.N, ocp.n_con), dtype=torch.float32, device=ocp.device)
    mask[0] = row0
    return mask


def masked_trajectory_constraints(ocp: OCP, X: torch.Tensor, U: torch.Tensor) -> torch.Tensor:
    """trajectory_constraints with masked rows forced far-feasible."""
    c = trajectory_constraints(ocp, X, U)
    return torch.where(constraint_mask(ocp) > 0, c, torch.full_like(c, BIG))


def al_penalty(c: torch.Tensor, lam: torch.Tensor, mu) -> torch.Tensor:
    """Powell-Hestenes-Rockafellar penalty for c >= 0, summed over the
    trailing [N, n_con] dims; mu has the batch shape ([] unbatched).

    The -lam^2 part of the conventional PHR term is constant in the decision
    variables and is dropped (same minimizer, full f32 resolution)."""
    mu = torch.as_tensor(mu, dtype=c.dtype, device=c.device)
    act = torch.clamp(lam - mu[..., None, None] * c, min=0.0)
    return torch.sum(act * act, dim=(-2, -1)) / (2.0 * mu)


def max_violation(ocp: OCP, X: torch.Tensor, U: torch.Tensor) -> torch.Tensor:
    c = masked_trajectory_constraints(ocp, X, U)
    return torch.clamp(-torch.amin(c, dim=(-2, -1)), min=0.0)


def total_cost(ocp: OCP, X: torch.Tensor, U: torch.Tensor) -> torch.Tensor:
    """Reference objective: sum over k = 0..N-1 of stage costs (no terminal
    term)."""
    return torch.sum(stage_cost(ocp, X[..., :-1, :], U, ocp.xref), dim=-1)


def al_total_cost(ocp: OCP, X: torch.Tensor, U: torch.Tensor,
                  lam: torch.Tensor, mu) -> torch.Tensor:
    c = masked_trajectory_constraints(ocp, X, U)
    return total_cost(ocp, X, U) + al_penalty(c, lam, mu)
