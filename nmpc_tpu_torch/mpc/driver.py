"""Receding-horizon MPC drivers (L4 of SURVEY.md §1). Port of
nmpc_tpu/mpc/driver.py.

Each control step: latch the measurement -> warm-start -> solve -> apply
the first control -> advance the plant -> shift the warm start. Convergence
is a mask: once the loop is done its control is zero and its state frozen,
like the reference scripts' stop-and-publish-zeros epilogue.

Modes (the reference families of SURVEY.md §2.2):
  closed_loop            point stabilization (families C/E/F/G)
  rt_closed_loop         closed_loop in the real-time recipe: one full seed
                         solve, then reduced-iteration solves with carried mu
  closed_loop_waypoints  goal-sequence state machine
  closed_loop_tracking   time-varying reference regenerated every step
  plan_then_replay       converge offline against the model, then replay the
                         stored controls through the plant

The reference's `lax.scan` over steps is a Python loop here, with the same
fixed-length histories ([max_steps] rows). The loop stops solving once its
carry repeats: when a step ends done with a carry bit for bit equal to the
one it started from, every later step would run the same solve on the same
inputs (after `done` the latched state, the warm start and the plant state
are frozen, and the noise the plant draws is discarded), so the remaining
rows are copies of that step's row, exactly what the scan records. Deciding
this costs one host sync a step; the tracking loop, which never finishes,
has none.

`solve_fn(ocp, warm)` picks the engine: by default the per-scenario
`solver.alilqr.solve` (plain PyTorch); `solver.alilqr_batched.solve_one`
runs each solve in the hand-written kernels on CUDA tensors (K1 and K2, or
K3-K6 with cfg.mega=False).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from nmpc_tpu_torch.ocp import problem as P
from nmpc_tpu_torch.ocp.problem import OCP
from nmpc_tpu_torch.sim.frames import wrap_to_2pi
from nmpc_tpu_torch.sim.plant import PlantConfig, plant_step
from nmpc_tpu_torch.solver.alilqr import ALILQRConfig, SolveResult, WarmStart, cold_start, solve


@dataclasses.dataclass(frozen=True)
class MPCConfig:
    """Driver options; fields, defaults and meaning as
    nmpc_tpu.mpc.driver.MPCConfig."""

    max_steps: int = 200
    stop_tol: float = 1e-1     # ||x - xs|| loop-exit threshold
    advance_tol: float = 0.075 # waypoint advance threshold
    mu_reset: bool = True      # reset the penalty weight each step (the
                               # multipliers are kept); reduced-iteration rt
                               # configs must set this False (see steady_warm)
    lam_decay: float = 1.0     # dual filtering on the shifted multipliers
    wrap_yaw: bool = False     # wrap the measured yaw to [0, 2pi) before each
                               # solve (the reference's modify() on odometry)
    # Parking-saddle escape (see _escape_control). Off = reference-faithful.
    escape: bool = False
    escape_u_tol: float = 0.02        # creep-stall trigger of the parking law
    escape_block_u_tol: float = 1e-3  # hard-stall trigger (the retreat's)
    escape_gain: float = 1.5
    escape_stall_steps: int = 10      # consecutive stall steps before the
                                      # retreat or creep parking engages
    # A solve whose plan is non-finite or whose violation exceeds this is
    # rejected: the previous shifted plan's controls and duals are kept.
    viol_fallback: float = 1e30
    # delay=1: the control applied over period k is the one computed from
    # the measurement latched at period k-1 (one period of actuation delay,
    # the reference deployment's timing).
    delay: int = 0
    # With delay=1: predict the latched measurement one period forward under
    # the in-flight control before solving.
    delay_compensate: bool = False

    def __post_init__(self):
        # the per-robot escape state packs the parking-latch sentinel and two
        # stall counters into one int32 with base-256 fields (_CNT_BASE); a
        # counter reaching the field width would alias into its neighbour
        if self.escape_stall_steps >= 255:
            raise ValueError(
                f"escape_stall_steps must be < 255 (escape-state counter "
                f"field width), got {self.escape_stall_steps}")


@dataclasses.dataclass(frozen=True)
class MPCResult:
    X_hist: torch.Tensor        # [S+1, nx] realized states
    U_hist: torch.Tensor        # [S, nu]  applied first controls
    err_hist: torch.Tensor      # [S] ||x - xs|| before each step
    cost_hist: torch.Tensor     # [S] OCP objective per solve
    viol_hist: torch.Tensor     # [S] max constraint violation per solve
    iter_hist: torch.Tensor     # [S] inner iterations per solve (int32)
    min_dist_hist: torch.Tensor # [S+1] min realized pairwise distance (inf if m==1)
    steps_used: torch.Tensor    # scalar int32
    reached: torch.Tensor       # scalar bool
    goal_idx_hist: torch.Tensor # [S] active waypoint index (zeros unless waypoint mode)


def shift_warm(res: SolveResult, cfg: ALILQRConfig, mu_reset: bool = False,
               lam_decay: float = 1.0) -> WarmStart:
    """The reference scripts' `shift()`: drop the first stage, repeat the
    last, on the controls and the per-stage multipliers (any leading batch
    dimensions). The states need no shift: the solver re-rolls them from the
    new measurement. `lam_decay` < 1 forgets a fraction of the carried
    multipliers each step (dual filtering for reduced-iteration rt modes)."""
    U = torch.cat([res.U[..., 1:, :], res.U[..., -1:, :]], dim=-2)
    lam = lam_decay * torch.cat([res.lam[..., 1:, :], res.lam[..., -1:, :]], dim=-2)
    mu = torch.full_like(res.mu, cfg.mu_init) if mu_reset else res.mu
    return WarmStart(U=U, lam=lam, mu=mu)


def steady_warm(res: SolveResult, lam_decay: float = 1.0) -> WarmStart:
    """Warm start for the reduced-iteration rt steady state: carry U, the
    (optionally decayed) multipliers, and the penalty weight mu they were
    learned at. Carrying lam while resetting mu is the rt drift failure: the
    PHR activation band is c < lam/mu, so multipliers built at mu=1e4
    re-applied at mu=10 push hard on well-satisfied constraints."""
    return WarmStart(U=res.U, lam=lam_decay * res.lam, mu=res.mu)


def _wrap_angle(a):
    return torch.atan2(torch.sin(a), torch.cos(a))


# escape-state encoding (int32 per robot): values >= _ESC_LATCH mean the
# parking latch is engaged; otherwise the value packs two counters,
# cnt_creep * _CNT_BASE + cnt_hard (the blocked-stall counter driving the
# retreat, and the creep-stall debounce driving delayed parking). Both
# saturate at escape_stall_steps < _CNT_BASE - 1 (MPCConfig's check).
_CNT_BASE = 256
_ESC_LATCH = 1 << 16


def escape_state0(m: int, device=None) -> torch.Tensor:
    """Initial per-robot escape state for the closed-loop carries."""
    return torch.zeros((m,), dtype=torch.int32, device=device)


def _escape_control(ocp: OCP, mpc: MPCConfig, x, goal, u0, esc_flags, done, tol=None):
    """Sticky per-robot parking mode (MPCConfig.escape), with any leading
    batch dimensions on x [..., nx], u0 [..., nu], esc_flags [..., m] and
    done [...]. Returns (blended control [..., nu], updated flags).

    A robot enters parking when the solver hands it a ~zero control while it
    still carries pose error (the nonholonomic saddle) and stays in it until
    the error clears; the parking law is the polar controller (align the
    axis to the goal bearing, drive with a signed, deadbeat-capped speed,
    then align the goal heading). A hard stall (u below escape_block_u_tol)
    parks at once; a creep stall (u below escape_u_tol) only after it
    persists escape_stall_steps steps, its counter holding in the dither band
    [tol, 2 tol). With pair or obstacle rows parking needs 1.5x the keep-out
    clearance, and a robot hard-stalled without it for escape_stall_steps
    steps retreats along the inverse-square repulsion bearing until the
    clearance gate opens. The reference's docstring and comments give the
    measurements behind each rule."""
    m = ocp.m
    lead = x.shape[:-1]
    pose = x[..., : 3 * m].reshape(*lead, m, 3)
    gpos = goal[..., : 3 * m].reshape(*goal.shape[:-1], m, 3)
    ex, ey = gpos[..., 0] - pose[..., 0], gpos[..., 1] - pose[..., 1]
    dist = torch.hypot(ex, ey)
    bearing = torch.atan2(ey, ex)
    delta = _wrap_angle(bearing - pose[..., 2])
    # the raw goal-heading error, deliberately unwrapped (the stop criterion
    # is the raw theta difference); the bearing error `delta` stays wrapped
    dth = gpos[..., 2] - pose[..., 2]
    err_i = torch.sqrt(dist * dist + dth * dth)

    tol = mpc.stop_tol if tol is None else tol
    thresh = tol / torch.sqrt(torch.tensor(float(m), dtype=x.dtype, device=x.device))
    u_mpc = u0.reshape(*lead, m, 2)
    not_done = ~done[..., None]
    latch_prev = esc_flags >= _ESC_LATCH
    raw_cnt = torch.where(latch_prev, 0, esc_flags)
    cnt_hard = torch.remainder(raw_cnt, _CNT_BASE)
    cnt_creep = torch.div(raw_cnt, _CNT_BASE, rounding_mode="floor")
    u_inf = torch.amax(torch.abs(u_mpc), dim=-1)
    K = mpc.escape_stall_steps
    stalled_hard = (u_inf < mpc.escape_block_u_tol) & (err_i > 0.7 * thresh)
    creep = (u_inf < mpc.escape_u_tol) & (err_i > 0.7 * thresh) & not_done
    persist = creep & (cnt_creep + 1 >= K)
    active = u_inf >= 2.0 * mpc.escape_u_tol
    cnt_creep_new = torch.where(creep, torch.clamp(cnt_creep + 1, max=K),
                                torch.where(active, 0, cnt_creep))
    cand = (latch_prev | stalled_hard | persist) & (err_i > 0.35 * thresh) & not_done

    v_hi = ocp.u_hi[0::2][:m]
    w_hi = ocp.u_hi[1::2][:m]
    # absolute 2 cm deadband on the bearing-chasing branch
    far = dist > torch.clamp(0.35 * thresh, min=0.02)
    T_e = ocp.T
    gear = torch.where(torch.abs(delta) <= 0.5 * math.pi, 1.0, -1.0)
    delta_ax = _wrap_angle(delta - (1.0 - gear) * 0.5 * math.pi)
    cosd = torch.cos(delta)
    v_cap = torch.minimum(v_hi, dist * torch.abs(cosd) / T_e)
    w_cap_d = torch.minimum(w_hi, torch.abs(delta_ax) / T_e)
    w_cap_t = torch.minimum(w_hi, torch.abs(dth) / T_e)
    v = torch.where(far, torch.clamp(mpc.escape_gain * dist * cosd, -v_cap, v_cap), 0.0)
    w = torch.where(far, torch.clamp(mpc.escape_gain * delta_ax, -w_cap_d, w_cap_d),
                    torch.clamp(mpc.escape_gain * dth, -w_cap_t, w_cap_t))
    u_esc = torch.stack([v, w], dim=-1)

    if ocp.n_pairs or ocp.n_obs:
        # the parking law ignores collision and obstacle rows, so it may only
        # drive a robot with 1.5x the keep-out clearance
        pos2 = pose[..., :2]
        kw = dict(dtype=x.dtype, device=x.device)
        if ocp.n_pairs:
            diff = pos2[..., :, None, :] - pos2[..., None, :, :]   # [..., m, m, 2]
            d2 = torch.sum(diff**2, dim=-1) + torch.eye(m, **kw) * 1e9
            gate = 1.5 * torch.sqrt(ocp.dmin2)
        else:
            diff = torch.zeros((*lead, m, 0, 2), **kw)
            d2 = torch.zeros((*lead, m, 0), **kw)
            gate = 1.5 * (ocp.robot_radius + ocp.obs_margin)
        if ocp.n_obs:
            # static obstacles join the gate and the repulsion sum as phantom
            # neighbours at their centres, at their surface distance
            odiff = pos2[..., :, None, :] - ocp.obstacles[:, :2]     # [..., m, n_obs, 2]
            od = torch.sqrt(torch.sum(odiff**2, dim=-1))
            od_eff = torch.clamp(od - ocp.obstacles[:, 2] - ocp.robot_radius, min=1e-3)
            diff = torch.cat([diff, odiff], dim=-2)
            d2 = torch.cat([d2, od_eff**2], dim=-1)
        mind_i = torch.sqrt(torch.amin(d2, dim=-1))
        clear = mind_i > gate
        esc = cand & clear
        blocked = stalled_hard & (err_i > 0.35 * thresh) & not_done & (~clear)
        retreating_prev = cnt_hard >= K
        retreat = ((~clear) & not_done & (err_i > 0.35 * thresh)
                   & (retreating_prev | (blocked & (cnt_hard + 1 >= K))))
        cnt_hard_new = torch.where(
            retreat, K, torch.where(blocked, torch.clamp(cnt_hard + 1, max=K - 1), 0))
        away = torch.sum(diff / (d2[..., None] ** 1.5), dim=-2)
        beta_away = torch.atan2(away[..., 1], away[..., 0])
        d_away = _wrap_angle(beta_away - pose[..., 2])
        v_ret = torch.clamp(mpc.escape_gain * (1.1 * gate - mind_i),
                            torch.zeros_like(v_hi), 0.5 * v_hi)
        w_cap_r = torch.minimum(w_hi, torch.abs(d_away) / ocp.T)
        u_ret = torch.stack(
            [v_ret * torch.cos(d_away),
             torch.clamp(mpc.escape_gain * d_away, -w_cap_r, w_cap_r)], dim=-1)
        u = torch.where(esc[..., None], u_esc, u_mpc)
        u = torch.where(retreat[..., None], u_ret, u).reshape(*lead, 2 * m)
        return u, torch.where(esc, _ESC_LATCH, cnt_creep_new * _CNT_BASE + cnt_hard_new)

    u = torch.where(cand[..., None], u_esc, u_mpc).reshape(*lead, 2 * m)
    return u, torch.where(cand, _ESC_LATCH, cnt_creep_new * _CNT_BASE)


def _wrap_yaw_state(ocp: OCP, x):
    """Wrap each robot's measured yaw to [0, 2pi) before the solve (the
    reference's modify()); ray states, if any, are untouched."""
    idx = torch.arange(ocp.nx, device=x.device)
    yaw = (idx < 3 * ocp.m) & (idx % 3 == 2)
    return torch.where(yaw, wrap_to_2pi(x), x)


def _min_pair_dist(ocp: OCP, x):
    if ocp.n_pairs == 0:
        return torch.full(x.shape[:-1], math.inf, dtype=x.dtype, device=x.device)
    return torch.sqrt(torch.amin(P.pairwise_sq_distances(ocp, x), dim=-1))


def _leaves(carry):
    out = []
    for c in carry:
        out.extend((c.U, c.lam, c.mu) if isinstance(c, WarmStart) else (c,))
    return out


_INT_OF_SIZE = {2: torch.int16, 4: torch.int32, 8: torch.int64}


def _bits(t):
    return t.view(_INT_OF_SIZE[t.element_size()]) if t.is_floating_point() else t


def _repeats(carry, new, done_idx) -> bool:
    """True when the step that turned `carry` into `new` ended done (every
    row of a batched done) and left every carried tensor bit for bit
    unchanged: every later step repeats it (one host sync)."""
    same = [new[done_idx].all()] + [(_bits(a) == _bits(b)).all()
                              for a, b in zip(_leaves(carry), _leaves(new))]
    return bool(torch.stack(same).all())


def _scan_loop(ocp: OCP, step_fn, carry0, mpc: MPCConfig, done_idx=2):
    """Run step_fn over max_steps control steps and stack its outputs
    (x_next, u, err, cost, viol, iters, min_dist, goal_idx) into an
    MPCResult. With done_idx, the loop stops stepping once the carry
    repeats (_repeats) and copies that step's outputs into the rows left."""
    carry, ys = carry0, []
    for k in range(mpc.max_steps):
        new, out = step_fn(carry, k)
        ys.append(out)
        stop = done_idx is not None and k + 1 < mpc.max_steps and _repeats(carry, new, done_idx)
        carry = new
        if stop:
            ys.extend([out] * (mpc.max_steps - len(ys)))
            break
    xs_hist, u_hist, err, cost, viol, iters, mind, goal_hist = (
        torch.stack(list(col)) for col in zip(*ys))
    x0 = carry0[0]
    di = 2 if done_idx is None else done_idx
    return MPCResult(
        X_hist=torch.cat([x0[None], xs_hist]),
        U_hist=u_hist,
        err_hist=err,
        cost_hist=cost,
        viol_hist=viol,
        iter_hist=iters,
        min_dist_hist=torch.cat([_min_pair_dist(ocp, x0)[None], mind]),
        steps_used=carry[di + 1],
        reached=carry[di],
        goal_idx_hist=goal_hist,
    )


def _freeze(done, w: WarmStart, w_new: WarmStart) -> WarmStart:
    return WarmStart(*(torch.where(done, a, b) for a, b in
                       zip((w.U, w.lam, w.mu), (w_new.U, w_new.lam, w_new.mu))))


def _zeros_i32(ocp: OCP):
    return torch.zeros((), dtype=torch.int32, device=ocp.device)


def closed_loop(
    ocp: OCP,
    solver_cfg: ALILQRConfig = ALILQRConfig(),
    mpc: MPCConfig = MPCConfig(),
    plant: PlantConfig = PlantConfig(),
    warm: WarmStart | None = None,
    generator: torch.Generator | None = None,
    solve_fn=None,
) -> MPCResult:
    """Point stabilization: run MPC until ||x - xs|| <= stop_tol (masked).
    Pass `generator` (on ocp's device) to enable the plant's noise models.
    solve_fn(ocp, warm) overrides the NLP engine; defaults to the
    per-scenario AL-iLQR `solve` with solver_cfg."""
    _solve = solve_fn or (lambda o, w: solve(o, w, solver_cfg))
    goal = ocp.xref[-1]
    warm0 = cold_start(ocp, solver_cfg) if warm is None else warm

    def step(carry, k):
        x, meas, w, done, steps, gidx, esc, u_prev = carry
        # measurement latch: the solve sees the latched odometry `meas`, the
        # plant advances the true state x, and min_dist reads the true state
        if mpc.wrap_yaw:
            meas = _wrap_yaw_state(ocp, meas)
            x = _wrap_yaw_state(ocp, x)
        err = torch.linalg.norm(meas - goal)
        done = done | (err <= mpc.stop_tol)
        meas_solve = meas
        if mpc.delay and mpc.delay_compensate:
            meas_solve = P.step_dynamics(ocp, meas, u_prev)
        res = _solve(dataclasses.replace(ocp, x0=meas_solve), w)
        # reject a non-finite or grossly infeasible plan: keep the previous
        # shifted plan's controls and duals (the rest stays the new solve's)
        ok = torch.isfinite(res.cost) & torch.isfinite(res.U).all() & (
            res.viol < mpc.viol_fallback)
        res = dataclasses.replace(res, U=torch.where(ok, res.U, w.U),
                                  lam=torch.where(ok, res.lam, w.lam))
        u0 = torch.where(done, 0.0, res.U[0])
        if mpc.escape:
            u0, esc = _escape_control(ocp, mpc, meas, goal, u0, esc, done)
        if mpc.delay:
            # the plant advances under the previous solve's control
            u_apply, u_prev = u_prev, u0
            u_apply = torch.where(done, 0.0, u_apply)
        else:
            u_apply = u0
        x_next, odom_next = plant_step(x, u_apply, ocp.T, plant, generator)
        x_next = torch.where(done, x, x_next)
        odom_next = torch.where(done, meas, odom_next)
        w_next = _freeze(done, w, shift_warm(res, solver_cfg, mpc.mu_reset, mpc.lam_decay))
        steps = steps + (~done).to(torch.int32)
        out = (x_next, u_apply, err, res.cost, res.viol, res.inner_iters,
               _min_pair_dist(ocp, x_next), gidx)
        return (x_next, odom_next, w_next, done, steps, gidx, esc, u_prev), out

    carry0 = (ocp.x0, ocp.x0, warm0, torch.zeros((), dtype=torch.bool, device=ocp.device),
              _zeros_i32(ocp), _zeros_i32(ocp), escape_state0(ocp.m, ocp.device),
              torch.zeros((ocp.nu,), dtype=ocp.x0.dtype, device=ocp.device))
    return _scan_loop(ocp, step, carry0, mpc, done_idx=3)


def rt_closed_loop(
    ocp: OCP,
    full_cfg: ALILQRConfig = ALILQRConfig(n_outer=6, n_inner=12),
    rt_cfg: ALILQRConfig = ALILQRConfig(n_outer=3, n_inner=10, tol_con=1e-3),
    mpc: MPCConfig = MPCConfig(),
    plant: PlantConfig = PlantConfig(),
    generator: torch.Generator | None = None,
    solve_fn=None,
) -> MPCResult:
    """Closed loop in the real-time recipe: one full-strength per-scenario
    solve seeds the multipliers and penalty, then every control period runs
    the reduced-iteration rt config warm-started with carried mu (mu_reset
    is forced off: resetting mu under carried lam is the drift failure, see
    steady_warm)."""
    res0 = solve(ocp, cold_start(ocp, full_cfg), full_cfg)
    warm = shift_warm(res0, rt_cfg, mu_reset=False, lam_decay=mpc.lam_decay)
    mpc_rt = dataclasses.replace(mpc, mu_reset=False)
    return closed_loop(ocp, solver_cfg=rt_cfg, mpc=mpc_rt, plant=plant,
                       warm=warm, generator=generator, solve_fn=solve_fn)


def closed_loop_waypoints(
    ocp: OCP,
    waypoints: torch.Tensor,  # [G, nx] goal sequence
    solver_cfg: ALILQRConfig = ALILQRConfig(),
    mpc: MPCConfig = MPCConfig(),
    plant: PlantConfig = PlantConfig(),
    solve_fn=None,
) -> MPCResult:
    """Goal-sequence tour: advance to the next waypoint when the full-pose
    error drops below advance_tol; stop after the last waypoint."""
    _solve = solve_fn or (lambda o, w: solve(o, w, solver_cfg))
    waypoints = waypoints.to(ocp.device)
    G = waypoints.shape[0]

    def goal_at(gidx):
        return waypoints[torch.clamp(gidx, max=G - 1).long()]

    def step(carry, _):
        x, w, done, steps, gidx, esc = carry
        err = torch.linalg.norm(x - goal_at(gidx))
        advance = (err < mpc.advance_tol) & (~done)
        gidx = gidx + advance.to(torch.int32)
        esc = torch.where(advance, 0, esc)  # new goal -> leave parking mode
        done = done | (gidx >= G)
        goal = goal_at(gidx)
        # waypoint goals are poses; pad ray states with zero reference
        if goal.shape[0] != ocp.nx:
            goal = torch.cat([goal, goal.new_zeros(ocp.nx - goal.shape[0])])
        res = _solve(dataclasses.replace(ocp, x0=x, xref=goal[None].repeat(ocp.N, 1)), w)
        u0 = torch.where(done, 0.0, res.U[0])
        if mpc.escape:
            u0, esc = _escape_control(ocp, mpc, x, goal, u0, esc, done, tol=mpc.advance_tol)
        x_next, _ = plant_step(x, u0, ocp.T, plant)
        x_next = torch.where(done, x, x_next)
        w_next = _freeze(done, w, shift_warm(res, solver_cfg, mpc.mu_reset, mpc.lam_decay))
        steps = steps + (~done).to(torch.int32)
        out = (x_next, u0, err, res.cost, res.viol, res.inner_iters,
               _min_pair_dist(ocp, x_next), gidx)
        return (x_next, w_next, done, steps, gidx, esc), out

    carry0 = (ocp.x0, cold_start(ocp, solver_cfg),
              torch.zeros((), dtype=torch.bool, device=ocp.device),
              _zeros_i32(ocp), _zeros_i32(ocp), escape_state0(ocp.m, ocp.device))
    return _scan_loop(ocp, step, carry0, mpc)


def closed_loop_tracking(
    ocp: OCP,
    ref_fn,  # t (0-d tensor) -> [N, nx] stage reference
    solver_cfg: ALILQRConfig = ALILQRConfig(),
    mpc: MPCConfig = MPCConfig(),
    plant: PlantConfig = PlantConfig(),
    solve_fn=None,
) -> MPCResult:
    """Trajectory tracking: the stage reference is regenerated every control
    period from `ref_fn(t)`. Runs for max_steps (no convergence exit;
    tracking never arrives)."""
    _solve = solve_fn or (lambda o, w: solve(o, w, solver_cfg))

    def step(carry, k):
        x, w, done, steps, gidx = carry
        t = torch.tensor(k, dtype=x.dtype, device=x.device) * ocp.T
        xref = ref_fn(t)
        res = _solve(dataclasses.replace(ocp, x0=x, xref=xref), w)
        u0 = res.U[0]
        x_next, _ = plant_step(x, u0, ocp.T, plant)
        err = torch.linalg.norm(x - xref[0])
        w_next = shift_warm(res, solver_cfg, mpc.mu_reset, mpc.lam_decay)
        out = (x_next, u0, err, res.cost, res.viol, res.inner_iters,
               _min_pair_dist(ocp, x_next), gidx)
        return (x_next, w_next, done, steps + 1, gidx), out

    carry0 = (ocp.x0, cold_start(ocp, solver_cfg),
              torch.zeros((), dtype=torch.bool, device=ocp.device),
              _zeros_i32(ocp), _zeros_i32(ocp))
    return _scan_loop(ocp, step, carry0, mpc, done_idx=None)


def plan_then_replay(
    ocp: OCP,
    solver_cfg: ALILQRConfig = ALILQRConfig(),
    mpc: MPCConfig = MPCConfig(),
    plant: PlantConfig = PlantConfig(),
):
    """Converge the MPC offline against the model, then replay the stored
    applied controls through the (possibly different) plant at period T.
    Returns (offline MPCResult, replayed X trajectory [S+1, nx])."""
    offline = closed_loop(ocp, solver_cfg, mpc, PlantConfig())
    x, xs = ocp.x0, [ocp.x0]
    for u in offline.U_hist:
        x, _ = plant_step(x, u, ocp.T, plant)
        xs.append(x)
    return offline, torch.stack(xs)
