"""The two kernels of the batched AL-iLQR main path, each with its plain
PyTorch version. Port of nmpc_tpu/ops/megasolve_pallas.py.

  K1 `inner_solve_fused`: the whole inner iLQR solve (n_inner iterations of
     backward Riccati sweep with on-the-fly expansions, line search and
     accepted rollout) per scenario, in one launch per AL outer step.
     CUDA: csrc/inner_team.cuh::inner_solve_team at m <= 2
     (cuda_build.TEAM_ROBOTS),
     csrc/inner_warp.cuh::inner_solve_warp above. Replaces the Pallas
     megakernel (megasolve_pallas.py:_make_megakernel / inner_solve_fused).
  K2 `al_update_lanes`: the AL multiplier update and the largest constraint
     violation. CUDA: csrc/inner_warp.cuh::al_update_warp. Replaces
     megasolve_pallas.py:_make_al_update_kernel / al_update_lanes.

Both wrappers take and return the standard layout [B, N, ...], which the
kernels read and write directly: no layout copies. On a CPU tensor they run
the plain version; on a CUDA tensor they launch the kernel on the current
stream or raise NotImplementedError naming what the kernel does not cover.
There is no fallback from a CUDA tensor to the plain version.

Design on an H100 (the notes of csrc/inner_warp.cuh and csrc/inner_team.cuh
say more): at m <= 2 a team of T lanes per scenario, 32 / T scenarios a
warp, the stage in every lane's registers and the line-search candidates
rolled out side by side, one a lane, from a ring of stage rows in shared
memory (`team_launch`); the warp design stays in those libraries for the
A/B (`warp_launch`) and no route takes it there. Above: one warp per
scenario; K1's stage-local blocks in a per-warp slot of shared memory whose
size depends on m and the obstacle rows m (n_obs + n_mov) (sized by the
library: `nmpc_k1_slot_bytes`), the N-proportional arrays in device memory.
Each kernel has a pair-only instantiation (the main path's) and an obstacle
variant, launched when the problem has static or moving obstacles; the
moving obstacles' schedule is read in the standard layout, per scenario
[B, N, n_mov, 2] or shared [N, n_mov, 2]. K1's first design, one thread per
scenario on the lane-major layout (csrc/megasolve.cuh::inner_solve_thread),
is launched by `inner_launch` for the roofline tools only (their
`design="first"`; K8 `full` with the early exit is that design). The tools'
default variants of K8 and K9 are the warp design's own, launched by
`warp_launch` with an `entry` of the tools library.

Admission (replaces the TPU's VMEM estimate `mega_fits`): the CUDA kernels
are built for m in cuda_build.ROBOT_COUNTS robots, any N, pair,
static-obstacle, moving-obstacle and box rows, Euler dynamics, any number of
alphas (K1 keeps its parameter block after the warps' slots in dynamic
shared memory) while a block's shared memory stays within the H100's 227 KB;
see `cuda_unsupported` and `warp_launch`.

Rounding of the static-obstacle rows: both kernels and their plain versions
take c = sqrt(max(d2, 1e-12)) - keepout with keepout = r_obs + r_rob +
margin folded as the parameter block holds it (P.stage_constraints), the
reference K2's form; the reference K1 takes sqrt(d2 + 1e-12), which differs
only for d below 1e-6.
"""

from __future__ import annotations

import dataclasses

import torch

from nmpc_tpu_torch.ocp import problem as P
from nmpc_tpu_torch.ocp.problem import OCP
from nmpc_tpu_torch.ops import cuda_build, rollout
from nmpc_tpu_torch.ops.cuda_build import check_arg, lane, ptr, std
from nmpc_tpu_torch.ops.staged_tiles import SMEM_BLOCK_MAX
from nmpc_tpu_torch.solver.alilqr import ALILQRConfig, _backward_pass

# K1's scenarios (warps) per block, picked with the register cap by
# `python -m nmpc_tpu_torch.tools.k1_launch` (PERF.md)
K1_WARPS = 2
# the warps per block of K1's team design (csrc/inner_team.cuh, the route's
# K1 at m in cuda_build.TEAM_ROBOTS), picked with its compile-time settings
# by k1_launch
K1_TEAM_WARPS = 2


def cuda_unsupported(ocp: OCP, cfg: ALILQRConfig | None = None) -> str | None:
    """Why K1 and K2 cannot take this problem/config, or None: the staged
    kernels' rule (rollout.unsupported: LiDAR rays, dynamics other than the
    Euler unicycle, m outside cuda_build.ROBOT_COUNTS), and of cfg's
    settings sweep='scan' (K1 runs its own sequential sweep) and an unknown
    line search. cfg.compact is the route's (a permutation of the batch
    between outer steps, solver/alilqr_batched._solve_mega), not K1's."""
    why = rollout.unsupported(ocp)
    if why is not None:
        return why
    if cfg is not None:
        if cfg.sweep == "scan":
            return "sweep='scan'"
        if cfg.ls not in ("cascade", "adaptive"):
            return f"line search {cfg.ls!r}"
    return None


def _require_cuda(ocp: OCP, cfg: ALILQRConfig | None, what: str) -> None:
    why = cuda_unsupported(ocp, cfg)
    if why is not None:
        raise NotImplementedError(f"{what}: the CUDA kernel does not cover {why}")


def obstacle_rows(ocp: OCP) -> int:
    """The obstacle rows of a stage, m (n_obs + n_mov): 0 takes the
    pair-only kernels."""
    return ocp.m * (ocp.n_obs + ocp.n_mov)


def _mov_args(ocp: OCP, B: int, dev) -> tuple:
    """The moving obstacles' schedule as the kernels read it: (tensor or
    None, floats between scenarios). Per scenario [B, N, n_mov, 2]; a shared
    [N, n_mov, 2] is read by every scenario (0)."""
    if not ocp.n_mov:
        return None, 0
    mov = ocp.mov_obs
    per = (B, ocp.N, ocp.n_mov, 2)
    if tuple(mov.shape) == per[1:]:
        check_arg("mov_obs", mov, per[1:], dev)
        return mov.contiguous(), 0
    check_arg("mov_obs", mov, per, dev)
    return mov.contiguous(), ocp.N * ocp.n_mov * 2


# ---------------------------------------------------------------------------
# K2: AL multiplier update
# ---------------------------------------------------------------------------


def al_update_plain(ocp: OCP, Xs, U, lam, mu, lam_max: float):
    """Plain PyTorch K2. Xs [B, N, nx] stage states 0..N-1, U [B, N, nu],
    lam [B, N, n_con], mu [B] -> (lam_new [B, N, n_con], viol [B]).

    c = masked_trajectory_constraints (stage-0 state rows set to BIG);
    lam_new = min(max(0, lam - mu c), lam_max); viol = max(0, -min c)."""
    mov = ocp.mov_obs if ocp.n_mov else None
    c = P.stage_constraints(ocp, Xs, U, mov)
    c = torch.where(P.constraint_mask(ocp) > 0, c, torch.full_like(c, P.BIG))
    # lam - mu c rounded once, as the kernel's fused multiply-add gives it
    act = torch.clamp(rollout.al_step(lam, mu[:, None, None], c), min=0.0)
    lam_new = torch.clamp(act, max=lam_max)
    viol = torch.clamp(-torch.amin(c, dim=(1, 2)), min=0.0)
    return lam_new, viol


def al_update_lanes(ocp: OCP, Xs, U, lam, mu, lam_max: float):
    """K2 wrapper: the CUDA kernel for CUDA tensors, the plain version for
    CPU tensors. Same arguments and results as `al_update_plain`."""
    if Xs.device.type == "cpu":
        return al_update_plain(ocp, Xs, U, lam, mu, lam_max)
    if Xs.device.type != "cuda":
        raise NotImplementedError(f"al_update_lanes: no kernel for {Xs.device}")
    _require_cuda(ocp, None, "al_update_lanes")
    B, N, n, nu, nc = Xs.shape[0], ocp.N, ocp.nx, ocp.nu, ocp.n_con
    dev = Xs.device
    for name, t, shape in (("Xs", Xs, (B, N, n)), ("U", U, (B, N, nu)),
                           ("lam", lam, (B, N, nc)), ("mu", mu, (B,))):
        check_arg(name, t, shape, dev)
    lam_new = torch.empty((B, N, nc), dtype=torch.float32, device=dev)
    viol = torch.empty((B,), dtype=torch.float32, device=dev)
    if B == 0:
        return lam_new, viol
    mov, mov_stride = _mov_args(ocp, B, dev)
    lib = cuda_build.load(ocp.m)
    prm = rollout.params(ocp, (), dev)
    Xs, U, lam, mu = Xs.contiguous(), U.contiguous(), lam.contiguous(), mu.contiguous()
    err = lib.nmpc_al_update(
        ptr(prm), ptr(Xs), ptr(U), ptr(lam), ptr(mu), ptr(lam_new), ptr(viol),
        B, N, int(ocp.n_pairs > 0), float(lam_max), None if mov is None else ptr(mov),
        ocp.n_obs, ocp.n_mov, mov_stride, cuda_build.stream(dev))
    cuda_build.check(lib, err, "al_update_lanes")
    cuda_build.launch_counts["al_update_lanes"] += 1
    return lam_new, viol


# ---------------------------------------------------------------------------
# K1: fused inner iLQR solve
# ---------------------------------------------------------------------------


def _forward(ocp: OCP, X, U, kff, Kfb, alpha):
    """Closed-loop rollout u = ubar + alpha kff + K (x - xbar) with a
    per-scenario alpha [B]: -> X [B, N+1, nx], U [B, N, nu]."""
    x = X[:, 0]
    xs, us = [x], []
    for k in range(ocp.N):
        u = (U[:, k] + alpha[:, None] * kff[:, k]
             + (Kfb[:, k] @ (x - X[:, k])[..., None])[..., 0])
        x = P.step_dynamics(ocp, x, u)
        xs.append(x)
        us.append(u)
    return torch.stack(xs, dim=1), torch.stack(us, dim=1)


def al_merit(o: OCP, X, U, lam, mu):
    """AL merit [B] of trajectories X [B, N+1, nx], U [B, N, nu] under duals
    lam [B, N, n_con] and penalty weights mu [B], with the stage-0 state rows
    masked hard (a NaN dual there must not leak into the merit)."""
    mask = P.constraint_mask(o) > 0
    c = P.trajectory_constraints(o, X, U)
    act = torch.clamp(lam - mu[:, None, None] * c, min=0.0)
    act = torch.where(mask, act, torch.zeros_like(act))
    return P.total_cost(o, X, U) + torch.sum(act * act, dim=(1, 2)) / (2.0 * mu)


def _fma(a, b, c):
    """a b + c rounded once (f32 products are exact in f64)."""
    return (a.double() * b.double() + c.double()).to(c.dtype)


def al_merit_warp_order(o: OCP, X, U, lam, mu):
    """`al_merit` summed in K1's order (csrc/inner_warp.cuh::merit_terms,
    rollout_warp): lane i adds, stage after stage, state row i's tracking
    term and squared activations, control row i's, pair rows i and i + 32
    and obstacle rows i, i + 32, ..., each by one fused multiply-add (lam -
    mu c too); then a butterfly over the 32 lanes. The terms of `al_merit`;
    at N = 100 this order alone moves the merit by ~1e-6 relative and its
    solves as far from f64 as K1's (PERF.md §6). For holding K1 against
    plain at long horizons."""
    B, N, n, nu, npr = X.shape[0], o.N, o.nx, o.nu, o.n_pairs
    mask = P.constraint_mask(o) > 0
    c = P.trajectory_constraints(o, X, U)
    act = torch.clamp(rollout.al_step(lam, mu[:, None, None], c), min=0.0)
    act = torch.where(mask, act, torch.zeros_like(act))
    R = o.m * (o.n_obs + o.n_mov)
    i_ulo = npr + R
    i_xlo = i_ulo + 2 * nu
    rows = [(i_xlo, n), (i_xlo + n, n), (i_ulo, nu), (i_ulo + nu, nu)]
    rows += [(i, min(32, npr - i)) for i in range(0, npr, 32)]
    rows += [(npr + e, min(32, R - e)) for e in range(0, R, 32)]
    track = X.new_zeros((B, 32))
    pen = X.new_zeros((B, 32))
    d = X[:, :-1] - o.xref.expand(B, N, n)
    for k in range(N):
        a = act[:, k]
        track[:, :n] = _fma(o.Qdiag * d[:, k], d[:, k], track[:, :n])
        for j, (i0, w) in enumerate(rows):
            if j == 2:
                track[:, :nu] = _fma(o.Rdiag * U[:, k], U[:, k], track[:, :nu])
            pen[:, :w] = _fma(a[:, i0:i0 + w], a[:, i0:i0 + w], pen[:, :w])
    lanes = torch.arange(32, device=X.device)
    for v in (track, pen):
        for m in (16, 8, 4, 2, 1):
            v += v[:, lanes ^ m]
    return track[:, 0] + pen[:, 0] / (2.0 * mu)


def _neumaier(terms):
    """Neumaier's compensated sum of terms [B, N] over the stages in order,
    in the terms' dtype (each operation rounded on its own): (sum, carry)."""
    s = torch.zeros_like(terms[:, 0])
    c = torch.zeros_like(s)
    for k in range(terms.shape[1]):
        v = terms[:, k]
        t = s + v
        c = c + torch.where(s.abs() >= v.abs(), (s - t) + v, (v - t) + s)
        s = t
    return s, c


def al_merit_team_order(o: OCP, X, U, lam, mu):
    """`al_merit` summed in the team design's order (csrc/inner_team.cuh::
    stage_terms, rollout_team): each stage's tracking terms (state rows,
    then control rows) and squared activations (every c >= 0 row in
    stage_constraints' order) by one fused multiply-add each (lam - mu c
    too), then each of the two over the stages by Neumaier's compensated
    sum; merit = (tracking) + (penalty) / (2 mu). For holding the team
    design against plain at long horizons."""
    B, N, n, nu = X.shape[0], o.N, o.nx, o.nu
    mask = P.constraint_mask(o) > 0
    c = P.trajectory_constraints(o, X, U)
    act = torch.clamp(rollout.al_step(lam, mu[:, None, None], c), min=0.0)
    act = torch.where(mask, act, torch.zeros_like(act))
    d = X[:, :-1] - o.xref.expand(B, N, n)
    track = X.new_zeros((B, N))
    for i in range(n):
        track = _fma(o.Qdiag[i] * d[..., i], d[..., i], track)
    for i in range(nu):
        track = _fma(o.Rdiag[i] * U[..., i], U[..., i], track)
    pen = X.new_zeros((B, N))
    for j in range(act.shape[-1]):
        pen = _fma(act[..., j], act[..., j], pen)
    ts, tc = _neumaier(track)
    ps, pc = _neumaier(pen)
    return (ts + tc) + (ps + pc) / (2.0 * mu)


def inner_solve_plain(ocp: OCP, x0, xref, lam, mu, U, cfg: ALILQRConfig, *,
                      candidates: torch.Tensor | None = None, merit=al_merit):
    """Plain PyTorch K1: n_inner iLQR iterations per scenario on the AL merit.

    x0 [B, nx], xref [B, N, nx], lam [B, N, n_con], mu [B], U [B, N, nu]
    (warm controls) -> (Xs [B, N, nx] stage states 0..N-1, U [B, N, nu],
    cost [B] merit of the returned iterate, iters [B] int32).

    candidates: an optional integer tensor [B] to which each scenario's
    line-search rollouts are added, those its iterations need: none once it
    is done; cascade every alpha; adaptive one a round until one passes.
    tools/roofline.py counts K1's work from them. merit: the AL merit,
    `al_merit` or `al_merit_warp_order`.

    Written from the dense formulation (Euler Jacobians, dense stage
    expansions, Cholesky of Quu + reg I: solver.alilqr._backward_pass) with
    the megakernel's control flow: its two line searches, done rules and
    iteration counting (an iteration counts only if the scenario is still
    not done after it)."""
    if cfg.ls not in ("adaptive", "cascade"):
        raise ValueError(f"unknown line search {cfg.ls!r}")
    adaptive = cfg.ls == "adaptive"
    o = dataclasses.replace(ocp, x0=x0, xref=xref)
    B = x0.shape[0]
    dev, dtype = x0.device, x0.dtype
    mask = P.constraint_mask(o) > 0  # [N, n_con]; False = stage-0 state rows

    def merit_of(X, U):
        return merit(o, X, U, lam, mu)

    # the masked rows only feed the stage-0 value function, which nothing
    # reads; zero their duals so a non-finite warm start cannot reach the gains
    lam_bp = torch.where(mask, lam, torch.zeros_like(lam))
    X = P.rollout(o, U)
    cost = merit_of(X, U)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    iters = torch.zeros(B, dtype=torch.int32, device=dev)
    trial = torch.ones(B, dtype=dtype, device=dev)
    zero = torch.zeros(B, dtype=dtype, device=dev)

    for _ in range(cfg.n_inner):
        if bool(done.all()):
            break
        kff, Kfb, dV1, _ = _backward_pass(o, cfg, X, U, lam_bp, mu)
        slope = torch.clamp(-dV1, min=0.0)

        def cost_of(alpha):
            return merit_of(*_forward(o, X, U, kff, Kfb, alpha))

        if adaptive:
            acc = torch.zeros(B, dtype=torch.bool, device=dev)
            best_cost, best_alpha = cost.clone(), zero.clone()
            for _ in range(cfg.ls_rounds):
                if bool(acc.all()):
                    break
                if candidates is not None:
                    candidates += (~done & ~acc).to(candidates.dtype)
                a = torch.where(acc, zero, trial)
                ca = cost_of(a)
                ok = (~acc) & ((cost - ca) >= cfg.armijo * a * slope) & (ca < cost)
                best_cost = torch.where(ok, ca, best_cost)
                best_alpha = torch.where(ok, a, best_alpha)
                acc = acc | ok
                trial = torch.where(acc, trial, trial * cfg.ls_beta)
            trial = torch.where(best_alpha > 0,
                                torch.clamp(best_alpha * cfg.ls_grow, max=1.0), trial)
        else:
            best_cost, best_alpha = cost, zero
            if candidates is not None:
                candidates += len(cfg.alphas) * (~done).to(candidates.dtype)
            for a in cfg.alphas:
                a_t = torch.full((B,), a, dtype=dtype, device=dev)
                ca = cost_of(a_t)
                ok = ((cost - ca) >= cfg.armijo * a_t * slope) & (ca < best_cost)
                best_cost = torch.where(ok, ca, best_cost)
                best_alpha = torch.where(ok, a_t, best_alpha)

        improved = best_alpha > 0
        X, U = _forward(o, X, U, kff, Kfb, torch.where(done, zero, best_alpha))
        cost_new = torch.where(done | ~improved, cost, best_cost)
        rel = (cost - cost_new) / (1.0 + torch.abs(cost))
        if adaptive:
            give_up = (~improved) & (trial <= cfg.ls_trial_min)
            stop = (improved & (rel < cfg.tol_cost)) | give_up
        else:
            stop = (~improved) | (rel < cfg.tol_cost)
        done = done | stop
        iters = iters + (~done).to(torch.int32)
        cost = cost_new
    return X[:, :-1].contiguous(), U, cost, iters


def inner_solve_fused(ocp: OCP, x0, xref, lam, mu, U, cfg: ALILQRConfig):
    """K1 wrapper: the CUDA kernel for CUDA tensors, the plain version for
    CPU tensors. Same arguments and results as `inner_solve_plain`."""
    if x0.device.type == "cpu":
        return inner_solve_plain(ocp, x0, xref, lam, mu, U, cfg)
    before = cuda_build.launch_counts["inner_solve_fused"]
    if ocp.m in cuda_build.TEAM_ROBOTS:
        design, out = "team", team_launch(ocp, x0, xref, lam, mu, U, cfg, "inner_solve_fused",
                                          cuda_build.load, K1_TEAM_WARPS)
    else:
        design, out = "warp", warp_launch(ocp, x0, xref, lam, mu, U, cfg, "inner_solve_fused",
                                          cuda_build.load, K1_WARPS)
    cuda_build.k1_designs[design] += cuda_build.launch_counts["inner_solve_fused"] - before
    return out


def _prm_bytes(ocp: OCP, cfg: ALILQRConfig) -> int:
    """Bytes of the parameter block K1 keeps in shared memory."""
    return 4 * rollout._P(ocp.nx, ocp.nu, len(cfg.alphas), ocp.n_obs).size


def _team_smem(lib, ocp: OCP, cfg: ALILQRConfig, warps: int) -> tuple:
    """(teams a block, dynamic shared bytes a block) of K1's team design:
    the teams' rings, then the parameter block."""
    teams = warps * 32 // cuda_build.team_geometry(lib)["T"]
    ring = lib.nmpc_k1_team_ring_bytes(obstacle_rows(ocp), ocp.n_mov, int(ocp.n_pairs > 0))
    return teams, teams * ring + _prm_bytes(ocp, cfg)


def k1_block_bytes(ocp: OCP, cfg: ALILQRConfig) -> tuple:
    """(dynamic shared bytes of one block of the route's K1, its design) for
    this problem and config: the team design (K1_TEAM_WARPS warps) at m in
    cuda_build.TEAM_ROBOTS, else the warp design (K1_WARPS slots); the
    solver library of ocp.m is built at first use. The launch refuses a
    block above staged_tiles.SMEM_BLOCK_MAX (the H100's 227 KB)."""
    lib = cuda_build.load(ocp.m)
    if ocp.m in cuda_build.TEAM_ROBOTS:
        return _team_smem(lib, ocp, cfg, K1_TEAM_WARPS)[1], "team"
    return K1_WARPS * lib.nmpc_k1_slot_bytes(obstacle_rows(ocp)) + _prm_bytes(ocp, cfg), "warp"


def team_launch(ocp: OCP, x0, xref, lam, mu, U, cfg: ALILQRConfig, what: str, load,
                warps: int):
    """Launch K1's team design (csrc/inner_team.cuh, T lanes per scenario;
    m in cuda_build.TEAM_ROBOTS) from the library load(ocp.m) with `warps`
    warps per block on CUDA tensors in the standard layout: checks the
    arguments, raises if the launch failed and counts it under `what`.
    Returns (Xs, U, cost, iters)."""
    x0, xref, lam, mu, U = _checked(ocp, cfg, what, x0, xref, lam, mu, U)
    if ocp.m not in cuda_build.TEAM_ROBOTS:
        raise NotImplementedError(f"{what}: K1's team design is built for m in "
                                  f"{cuda_build.TEAM_ROBOTS}, not m={ocp.m}")
    B, N, n, nu = x0.shape[0], ocp.N, ocp.nx, ocp.nu
    f32 = dict(dtype=torch.float32, device=x0.device)
    mov, mov_stride = _mov_args(ocp, B, x0.device)
    Xs = torch.empty((B, N, n), **f32)
    cost = torch.empty((B,), **f32)
    iters = torch.empty((B,), dtype=torch.int32, device=x0.device)
    if B == 0:
        return Xs, U.clone(), cost, iters
    lib = load(ocp.m)
    pairs = int(ocp.n_pairs > 0)
    teams, smem = _team_smem(lib, ocp, cfg, warps)
    if smem > SMEM_BLOCK_MAX:
        raise NotImplementedError(
            f"{what}: {smem} B of shared memory a block ({teams} teams' rings for "
            f"{obstacle_rows(ocp)} obstacle rows and the parameter block) exceed the H100's "
            f"{SMEM_BLOCK_MAX} B")
    Uo = torch.empty((B, N, nu), **f32)
    kff = torch.empty((B, N, nu), **f32)        # scratch: the gains
    Kfb = torch.empty((B, N, nu, n), **f32)
    Xw = torch.empty((B, N, n), **f32)          # scratch: the accepted step
    Uw = torch.empty((B, N, nu), **f32)
    err = lib.nmpc_inner_solve_team(
        ptr(rollout.params(ocp, cfg.alphas, x0.device)), ptr(x0), ptr(xref), ptr(lam), ptr(mu),
        ptr(U), ptr(Xs), ptr(Uo), ptr(cost), ptr(iters), ptr(kff), ptr(Kfb), ptr(Xw), ptr(Uw),
        B, N, cfg.n_inner, int(cfg.ls == "adaptive"), len(cfg.alphas), cfg.ls_rounds,
        pairs, warps, cfg.reg, cfg.armijo, cfg.tol_cost, cfg.ls_beta,
        cfg.ls_grow, cfg.ls_trial_min, None if mov is None else ptr(mov), ocp.n_obs, ocp.n_mov,
        mov_stride, cuda_build.stream(x0.device))
    cuda_build.check(lib, err, what)
    cuda_build.launch_counts[what] += 1
    return Xs, Uo, cost, iters


def warp_launch(ocp: OCP, x0, xref, lam, mu, U, cfg: ALILQRConfig, what: str, load,
                warps: int, entry=None):
    """Launch K1's warp design (csrc/inner_warp.cuh, one warp per scenario;
    the solver's K1 at m >= 3, the A/B baseline below) from the
    library load(ocp.m) with `warps` scenarios per block on CUDA tensors in
    the standard layout: checks the arguments, raises if the launch failed
    and counts it under `what`. Returns (Xs, U, cost, iters).

    entry(lib) -> (launch function, a warp's slot bytes): a variant of the
    design with `nmpc_inner_solve`'s arguments (the roofline tools' K8 and
    K9, csrc/tools.cu); None is K1 itself, its slot at the problem's
    obstacle rows."""
    x0, xref, lam, mu, U = _checked(ocp, cfg, what, x0, xref, lam, mu, U)
    B, N, n, nu = x0.shape[0], ocp.N, ocp.nx, ocp.nu
    f32 = dict(dtype=torch.float32, device=x0.device)
    mov, mov_stride = _mov_args(ocp, B, x0.device)
    Xs = torch.empty((B, N, n), **f32)
    cost = torch.empty((B,), **f32)
    iters = torch.empty((B,), dtype=torch.int32, device=x0.device)
    if B == 0:
        return Xs, U.clone(), cost, iters
    lib = load(ocp.m)
    launch, slot = ((lib.nmpc_inner_solve, lib.nmpc_k1_slot_bytes(obstacle_rows(ocp)))
                    if entry is None else entry(lib))
    # dynamic shared memory a block: the warps' slots, then the parameter block
    smem = warps * slot + _prm_bytes(ocp, cfg)
    if smem > SMEM_BLOCK_MAX:
        raise NotImplementedError(
            f"{what}: {smem} B of shared memory a block ({warps} warps' slots for "
            f"{obstacle_rows(ocp)} obstacle rows and the parameter block) exceed the H100's "
            f"{SMEM_BLOCK_MAX} B")
    Uo = torch.empty((B, N, nu), **f32)
    kff = torch.empty((B, N, nu), **f32)        # scratch: the gains, K transposed
    Kfb = torch.empty((B, N, n, nu), **f32)
    Xw = torch.empty((2, B, N, n), **f32)       # scratch: candidate trajectories
    Uw = torch.empty((2, B, N, nu), **f32)
    err = launch(
        ptr(rollout.params(ocp, cfg.alphas, x0.device)), ptr(x0), ptr(xref), ptr(lam), ptr(mu),
        ptr(U), ptr(Xs), ptr(Uo), ptr(cost), ptr(iters), ptr(kff), ptr(Kfb), ptr(Xw), ptr(Uw),
        B, N, cfg.n_inner, int(cfg.ls == "adaptive"), len(cfg.alphas), cfg.ls_rounds,
        int(ocp.n_pairs > 0), warps, cfg.reg, cfg.armijo, cfg.tol_cost, cfg.ls_beta,
        cfg.ls_grow, cfg.ls_trial_min, None if mov is None else ptr(mov), ocp.n_obs, ocp.n_mov,
        mov_stride, cuda_build.stream(x0.device))
    cuda_build.check(lib, err, what)
    cuda_build.launch_counts[what] += 1
    return Xs, Uo, cost, iters


def _checked(ocp: OCP, cfg: ALILQRConfig, what: str, x0, xref, lam, mu, U) -> tuple:
    """K1's arguments on a CUDA device, checked and contiguous, or raise."""
    if x0.device.type != "cuda":
        raise NotImplementedError(f"{what}: no kernel for {x0.device}")
    _require_cuda(ocp, cfg, what)
    B, N, n, nu, nc = x0.shape[0], ocp.N, ocp.nx, ocp.nu, ocp.n_con
    for name, t, shape in (("x0", x0, (B, n)), ("xref", xref, (B, N, n)),
                           ("lam", lam, (B, N, nc)), ("mu", mu, (B,)),
                           ("U", U, (B, N, nu))):
        check_arg(name, t, shape, x0.device)
    return tuple(t.contiguous() for t in (x0, xref, lam, mu, U))


def inner_launch(ocp: OCP, x0, xref, lam, mu, U, cfg: ALILQRConfig, what: str,
                 load, entry):
    """Launch a variant of K1's first design (csrc/megasolve.cuh, one thread
    per scenario on the lane-major layout: the first design's phase ablation
    and layout A/B of the roofline tools, `design="first"`) on CUDA tensors:
    checks the arguments, moves them
    to the lane-major layout, calls entry(load(ocp.m))(*the first design's
    arguments), raises if the launch failed and counts it under `what`.
    Returns (Xs, U, cost, iters) in the standard layout. The first design
    takes pair and box rows only."""
    if obstacle_rows(ocp):
        raise NotImplementedError(f"{what}: K1's first design takes no obstacle rows")
    x0, xref, lam, mu, U = _checked(ocp, cfg, what, x0, xref, lam, mu, U)
    B, N, n, nu = x0.shape[0], ocp.N, ocp.nx, ocp.nu
    dev = x0.device
    f32 = dict(dtype=torch.float32, device=dev)
    cost = torch.empty((B,), **f32)
    iters = torch.empty((B,), dtype=torch.int32, device=dev)
    if B == 0:
        return torch.empty((B, N, n), **f32), U.clone(), cost, iters
    lib = load(ocp.m)
    prm = rollout.params(ocp, cfg.alphas, dev)
    x0_l, xref_l, lam_l, U_l = lane(x0), lane(xref), lane(lam), lane(U)
    Xs_l = torch.empty((N, n, B), **f32)
    Uo_l = torch.empty((N, nu, B), **f32)
    kff_l = torch.empty((N, nu, B), **f32)       # scratch: gains
    Kfb_l = torch.empty((N, nu, n, B), **f32)
    err = entry(lib)(
        ptr(prm), ptr(x0_l), ptr(xref_l), ptr(lam_l), ptr(mu),
        ptr(U_l), ptr(Xs_l), ptr(Uo_l), ptr(cost), ptr(iters),
        ptr(kff_l), ptr(Kfb_l),
        B, N, cfg.n_inner, int(cfg.ls == "adaptive"), len(cfg.alphas),
        cfg.ls_rounds, int(ocp.n_pairs > 0),
        cfg.reg, cfg.armijo, cfg.tol_cost, cfg.ls_beta, cfg.ls_grow,
        cfg.ls_trial_min, cuda_build.stream(dev))
    cuda_build.check(lib, err, what)
    cuda_build.launch_counts[what] += 1
    return std(Xs_l), std(Uo_l), cost, iters
