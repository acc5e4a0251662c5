"""The kernels' parameter block and the staged path's two rollout kernels,
each with its plain PyTorch version. Port of nmpc_tpu/ops/rollout_pallas.py.

  K5 `linesearch_costs_lanes`: for every alpha of a line-search grid, the
     closed-loop rollout u = U + alpha kff + Kfb (x - X) from x0 and its
     summed AL merit -> costs [A, B]; pass alpha 0 first and row 0 is the
     current iterate's merit. CUDA: csrc/staged_tiles.cuh::linesearch_tiles,
     a block per tile of S scenarios running its candidates (one thread per
     (alpha, scenario)) on stage tiles fetched once through a ring in shared
     memory; any number of candidates, as launches of at most
     staged_tiles.k5_max_alphas(m, form) each. Where the problem's rows
     overflow that block's shared memory (staged_tiles.k5_form), and at m
     >= 64, the device-memory form reads every stage row and the parameter
     block from device memory (D = 0), the same sums. Bit for bit its first
     design,
     csrc/staged.cuh::linesearch_cost_thread (one thread per (alpha,
     scenario) reading device memory, the A/B baseline of
     tools/staged_launch.py). Replaces rollout_pallas.py::_make_cost_kernel /
     linesearch_costs_lanes.
  K6 `rollout_alpha_lanes`: the accepted rollout under one alpha per
     scenario -> states 1..N and the controls. CUDA: csrc/
     expansions_rollout_tiles.cuh::rollout_tiles, a block per tile of S
     scenarios streaming the stages through a ring in shared memory, a team
     of T threads a scenario; bit for bit its first design, csrc/staged.cuh::
     rollout_thread (one thread per scenario, the A/B baseline of
     tools/staged_launch.py). Replaces _make_rollout_kernel /
     rollout_alpha_lanes.

The `_lanes` wrappers take and return the lane-major layout of the staged
path ([N, rows, B], batch innermost; x0 [n, B], alpha and mu [B]); the
standard-layout wrappers `linesearch_costs` and `rollout_alpha` transpose
once around them. On a CPU tensor a wrapper runs the plain version; on a
CUDA tensor it launches the kernel or raises. There is no fallback.

The numeric problem data shared by every scenario of a batch (weights,
bounds, dmin^2, dt, obstacle rows, line-search alphas) is packed into one
small f32 vector that the CUDA kernels copy to shared memory; the offsets are
mirrored by `nmpc::Dims` in csrc/rollout.cuh. The plain versions read the
same block, so kernel and plain version see the same folded obstacle radii.
"""

from __future__ import annotations

import functools

import torch

from nmpc_tpu_torch.ocp.problem import OCP, pair_indices
from nmpc_tpu_torch.ops import cuda_build, staged_tiles
from nmpc_tpu_torch.ops.cuda_build import check_arg, lane, ptr, std


def supports(ocp: OCP) -> bool:
    """The problem class of the fused kernels, the reference's rule
    (rollout_pallas.py::supports): stacked Euler unicycles with pair,
    static-obstacle, moving-obstacle and box rows, no LiDAR rays, no
    user-supplied dynamics, any robot count. The routes read it
    (solver/alilqr_batched.route); what the card's kernels are built for is
    `unsupported`'s and megasolve.cuda_unsupported's."""
    return ocp.num_rays == 0 and ocp.integrator == "euler" and ocp.dyn_fn is None


def unsupported(ocp: OCP) -> str | None:
    """Why the staged kernels (K3-K6) cannot take this problem on the card,
    or None. They cover `supports`' class at any robot count and any number
    of obstacle rows: K3 takes any stage shape, K4 and K5 take their
    device-memory forms where the problem's rows overflow their tiles
    (staged_tiles.k4_form, k5_form), and K6 reads its stage rows from
    device memory where its ring does not fit; device memory is the only
    bound."""
    if ocp.dyn_fn is not None or ocp.integrator != "euler":
        return "dynamics other than the Euler unicycle (dyn_fn or rk4)"
    if ocp.num_rays:
        return "LiDAR ray states (num_rays > 0)"
    return None


def require(ocp: OCP, what: str) -> None:
    why = unsupported(ocp)
    if why is not None:
        raise NotImplementedError(f"{what}: the CUDA kernel does not cover {why}")


class _P:
    """Static offsets into the parameter block."""

    def __init__(self, n, mc, n_alphas, n_obs=0):
        self.q = 0
        self.r = self.q + n
        self.u_lo = self.r + mc
        self.u_hi = self.u_lo + mc
        self.x_lo = self.u_hi + mc
        self.x_hi = self.x_lo + n
        self.dmin2 = self.x_hi + n
        self.dt = self.dmin2 + 1
        self.obs = self.dt + 1           # n_obs rows of (ox, oy, keepout)
        self.alphas = self.obs + 3 * n_obs
        self.size = self.alphas + n_alphas


def _pack_params(ocp: OCP, alphas) -> torch.Tensor:
    """[P.size] f32 parameter block on the OCP's device."""
    kw = dict(dtype=ocp.Qdiag.dtype, device=ocp.device)
    if ocp.n_obs:
        # obstacle rows pre-fold the radii: keepout = r_obs + r_rob + margin
        keepout = ocp.obstacles[:, 2] + ocp.robot_radius + ocp.obs_margin
        obs = torch.cat([ocp.obstacles[:, :2], keepout[:, None]], dim=1).reshape(-1)
    else:
        obs = torch.zeros((0,), **kw)
    return torch.cat([
        ocp.Qdiag, ocp.Rdiag, ocp.u_lo, ocp.u_hi, ocp.x_lo, ocp.x_hi,
        ocp.dmin2.reshape(1), ocp.T.reshape(1), obs,
        _alphas_on(tuple(float(a) for a in alphas), kw["dtype"], kw["device"]),
    ])


@functools.lru_cache(maxsize=None)
def _alphas_on(alphas: tuple, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """The line-search alphas as a tensor on `device`, made once (a copy
    from the host at every pack is one a CUDA graph's capture refuses)."""
    return torch.tensor(alphas, dtype=dtype, device=device)


def params(ocp: OCP, alphas, device) -> torch.Tensor:
    """The parameter block on `device`, contiguous f32, checked against the
    layout the kernels read."""
    prm = _pack_params(ocp, alphas).to(device=device, dtype=torch.float32).contiguous()
    want = _P(ocp.nx, ocp.nu, len(alphas), ocp.n_obs).size
    if prm.numel() != want:
        raise ValueError(f"parameter block has {prm.numel()} entries, the kernels expect {want}")
    return prm


# ---------------------------------------------------------------------------
# Plain building blocks (lane-major: rows on dim -2, batch on dim -1)
# ---------------------------------------------------------------------------


def al_step(lam, mu, c):
    """lam - mu c with one rounding, as the kernels' fused multiply-add
    gives it (the product of two f32 is exact in f64); two roundings would
    differ by ~1 ulp of mu c, which can flip an activation's sign."""
    return (lam.double() - mu.double() * c.double()).to(lam.dtype)


def _feedback_u(x, xbar, ubar, kff, K, alpha):
    """u = ubar + alpha kff + K (x - xbar), the sum over the state taken in
    the kernels' order. x, xbar [..., n, B], ubar, kff [..., nu, B],
    K [nu, n, B], alpha broadcastable to [..., 1, B]."""
    dx = x - xbar
    u = ubar + alpha * kff
    for j in range(x.shape[-2]):
        u = u + K[:, j] * dx[..., j:j + 1, :]
    return u


def _euler_rows(m: int, x, u, dt):
    """x_{k+1} = x + dt f(x, u) for m stacked unicycles, lane-major."""
    rows = []
    for r in range(m):
        th = x[..., 3 * r + 2, :]
        v = u[..., 2 * r, :]
        w = u[..., 2 * r + 1, :]
        rows += [x[..., 3 * r, :] + dt * v * torch.cos(th),
                 x[..., 3 * r + 1, :] + dt * v * torch.sin(th),
                 th + dt * w]
    return torch.stack(rows, dim=-2)


def _positions(m: int, x, reps: int):
    """Robot-major, obstacle-minor position rows [..., m reps, B] (x, y)."""
    px = x[..., 0:3 * m:3, :].repeat_interleave(reps, dim=-2)
    py = x[..., 1:3 * m:3, :].repeat_interleave(reps, dim=-2)
    return px, py


def _obs_c(ocp: OCP, prm, x):
    """Static-obstacle rows of the parameter block's obstacles at the
    states x [..., n, B]: (c, dx, dy, dist), each [..., m n_obs, B]."""
    P = _P(ocp.nx, ocp.nu, 0, ocp.n_obs)
    ob = prm[P.obs:P.alphas].reshape(ocp.n_obs, 3).repeat(ocp.m, 1)
    px, py = _positions(ocp.m, x, ocp.n_obs)
    dx, dy = px - ob[:, 0:1], py - ob[:, 1:2]
    dist = torch.sqrt(dx * dx + dy * dy + 1e-12)
    return dist - ob[:, 2:3], dx, dy, dist


def _mov_d(ocp: OCP, x, mov):
    """Moving-obstacle offsets (dx, dy) [..., m n_mov, B] of the states x
    [..., n, B] from this stage's schedule mov [..., 2 n_mov, B]."""
    px, py = _positions(ocp.m, x, ocp.n_mov)
    mx = mov[..., 0::2, :].repeat(*([1] * (mov.dim() - 2)), ocp.m, 1)
    my = mov[..., 1::2, :].repeat(*([1] * (mov.dim() - 2)), ocp.m, 1)
    return px - mx, py - my


def _stage_merit(ocp: OCP, prm, k: int, x, u, xr, lam, mu, mov):
    """AL merit of stage k, lane-major, in the row blocks and order of
    rollout_pallas._stage_merit: tracking cost, then the PHR penalty of the
    pair, obstacle, moving-obstacle, u-box and x-box blocks, each summed
    before it is added. The state-dependent rows of stage 0 are masked hard
    (a NaN activation there must not leak into the merit)."""
    P = _P(ocp.nx, ocp.nu, 0, ocp.n_obs)
    m = ocp.m
    col = lambda a, b: prm[a:b, None]  # noqa: E731
    dxr = x - xr
    cost = (torch.sum(col(P.q, P.r) * dxr * dxr, dim=-2)
            + torch.sum(col(P.r, P.u_lo) * u * u, dim=-2))
    pen = torch.zeros_like(cost)
    row = 0

    def block(c, x_dep):
        nonlocal row
        act = torch.clamp(al_step(lam[..., row:row + c.shape[-2], :], mu, c), min=0.0)
        row += c.shape[-2]
        if x_dep and k == 0:
            act = torch.zeros_like(act)
        return torch.sum(act * act, dim=-2)

    if ocp.n_pairs:
        I, J = pair_indices(m)
        dx = x[..., [3 * i for i in I], :] - x[..., [3 * j for j in J], :]
        dy = x[..., [3 * i + 1 for i in I], :] - x[..., [3 * j + 1 for j in J], :]
        pen = pen + block(dx * dx + dy * dy - prm[P.dmin2], True)
    if ocp.n_obs:
        pen = pen + block(_obs_c(ocp, prm, x)[0], True)
    if ocp.n_mov:
        dx, dy = _mov_d(ocp, x, mov)
        pen = pen + block(dx * dx + dy * dy - prm[P.dmin2], True)
    pen = pen + block(u - col(P.u_lo, P.u_hi), False)
    pen = pen + block(col(P.u_hi, P.x_lo) - u, False)
    pen = pen + block(x - col(P.x_lo, P.x_hi), True)
    pen = pen + block(col(P.x_hi, P.dmin2) - x, True)
    return cost + pen / (2.0 * mu)


# ---------------------------------------------------------------------------
# K5: line-search merits
# ---------------------------------------------------------------------------


def linesearch_costs_plain(ocp: OCP, x0_l, X_l, U_l, kff_l, Kfb_l, xref_l,
                           lam_l, mu, alphas, mov_l=None):
    """Plain PyTorch K5. x0_l [n, B], X_l [N, n, B] (stage states), U_l
    [N, nu, B], kff_l [N, nu, B], Kfb_l [N, nu, n, B], xref_l [N, n, B],
    lam_l [N, nc, B], mu [B], alphas (A floats), mov_l [N, 2 n_mov, B]
    when ocp.n_mov > 0 -> costs [A, B]."""
    prm = _pack_params(ocp, ()).to(x0_l)
    dt = prm[_P(ocp.nx, ocp.nu, 0, ocp.n_obs).dt]
    al = torch.as_tensor(alphas, dtype=x0_l.dtype, device=x0_l.device)[:, None, None]
    x = x0_l.expand(len(alphas), *x0_l.shape)
    acc = torch.zeros((len(alphas), x0_l.shape[-1]), dtype=x0_l.dtype, device=x0_l.device)
    for k in range(ocp.N):
        u = _feedback_u(x, X_l[k], U_l[k], kff_l[k], Kfb_l[k], al)
        acc = acc + _stage_merit(ocp, prm, k, x, u, xref_l[k], lam_l[k], mu,
                                 None if mov_l is None else mov_l[k])
        x = _euler_rows(ocp.m, x, u, dt)
    return acc


def check_costs(ocp: OCP, x0_l, X_l, U_l, kff_l, Kfb_l, xref_l, lam_l, mu, mov_l=None) -> None:
    """Raise unless K5's kernels take these CUDA inputs."""
    if x0_l.device.type != "cuda":
        raise NotImplementedError(f"linesearch_costs_lanes: no kernel for {x0_l.device}")
    require(ocp, "linesearch_costs_lanes")
    N, n, nu, nc, B = ocp.N, ocp.nx, ocp.nu, ocp.n_con, x0_l.shape[-1]
    args = [("x0_l", x0_l, (n, B)), ("X_l", X_l, (N, n, B)), ("U_l", U_l, (N, nu, B)),
            ("kff_l", kff_l, (N, nu, B)), ("Kfb_l", Kfb_l, (N, nu, n, B)),
            ("xref_l", xref_l, (N, n, B)), ("lam_l", lam_l, (N, nc, B)), ("mu", mu, (B,))]
    if ocp.n_mov:
        args.append(("mov_l", mov_l, (N, 2 * ocp.n_mov, B)))
    for name, t, shape in args:
        check_arg(name, t, shape, x0_l.device)


def costs_form(ocp: OCP, n_alphas: int) -> staged_tiles.K5Geometry:
    """The K5 form this problem launches at n_alphas candidates
    (staged_tiles.k5_form on its rows): the library's tile, or
    staged_tiles.K5_DEVICE."""
    return staged_tiles.k5_form(ocp.m, ocp.n_pairs > 0, ocp.n_obs, ocp.n_mov,
                                _P(ocp.nx, ocp.nu, 0, ocp.n_obs).size, n_alphas)


def costs_launch(ocp: OCP, x0_l, X_l, U_l, kff_l, Kfb_l, xref_l, lam_l, mu, alphas, mov_l,
                 lib, first: bool = False, device: bool = False):
    """K5 from library `lib` on checked inputs (`check_costs`): the tile
    design, with device=True its device-memory form, or with first=True the
    first design of a `cuda_build.load_first` library."""
    B, dev = x0_l.shape[-1], x0_l.device
    costs = torch.empty((len(alphas), B), dtype=torch.float32, device=dev)
    if B == 0 or not len(alphas):
        return costs
    prm = params(ocp, alphas, dev)
    entry = (lib.nmpc_linesearch_costs_first if first else
             lib.nmpc_linesearch_costs_device if device else lib.nmpc_linesearch_costs)
    err = entry(ptr(prm), prm.numel(), ptr(x0_l), ptr(X_l), ptr(U_l), ptr(kff_l), ptr(Kfb_l),
                ptr(xref_l), ptr(lam_l), ptr(mu), ptr(mov_l if ocp.n_mov else None), ptr(costs),
                B, ocp.N, len(alphas), int(ocp.n_pairs > 0), ocp.n_obs, ocp.n_mov,
                cuda_build.stream(dev))
    cuda_build.check(lib, err, "linesearch_costs_lanes")
    return costs


def linesearch_costs_lanes(ocp: OCP, x0_l, X_l, U_l, kff_l, Kfb_l, xref_l,
                           lam_l, mu, alphas, mov_l=None):
    """K5 wrapper: the CUDA kernel for CUDA tensors, in the form
    `costs_form` picks, the plain version for CPU tensors. Same arguments
    and result as `linesearch_costs_plain`. One block runs at most
    staged_tiles.k5_max_alphas(m, form) candidates of its scenarios, so a
    longer grid goes as consecutive slices of that many, one launch each
    with its own parameter block, and their rows are stacked: each merit is
    one thread's own sum, so the result does not depend on the slicing or
    the form."""
    if x0_l.device.type == "cpu":
        return linesearch_costs_plain(ocp, x0_l, X_l, U_l, kff_l, Kfb_l, xref_l,
                                      lam_l, mu, alphas, mov_l)
    check_costs(ocp, x0_l, X_l, U_l, kff_l, Kfb_l, xref_l, lam_l, mu, mov_l)
    alphas = tuple(float(a) for a in alphas)
    if not alphas:
        return torch.empty((0, x0_l.shape[-1]), dtype=torch.float32, device=x0_l.device)
    g = costs_form(ocp, len(alphas))
    device = g == staged_tiles.K5_DEVICE
    top = staged_tiles.k5_max_alphas(ocp.m, g)
    lib = cuda_build.load(ocp.m)
    parts = []
    for i in range(0, len(alphas), top):
        parts.append(costs_launch(ocp, x0_l, X_l, U_l, kff_l, Kfb_l, xref_l, lam_l, mu,
                                  alphas[i:i + top], mov_l, lib, device=device))
        if x0_l.shape[-1]:
            cuda_build.launch_counts["linesearch_costs_lanes"] += 1
            cuda_build.staged_forms["K5 device" if device else "K5 tile"] += 1
    return parts[0] if len(parts) == 1 else torch.cat(parts)


def linesearch_costs(ocp: OCP, x0, X, U, kff, Kfb, xref, lam, mu, alphas, mov=None):
    """AL merit for every alpha, standard layout: x0 [B, n], X [B, N+1, n],
    U [B, N, nu], kff [B, N, nu], Kfb [B, N, nu, n], xref [B, N, n],
    lam [B, N, nc], mu [B], mov [B, N, n_mov, 2] per-scenario moving-obstacle
    plans when ocp.n_mov > 0 -> costs [A, B]."""
    B = x0.shape[0]
    mov_l = None if mov is None else lane(mov.reshape(B, ocp.N, 2 * ocp.n_mov))
    return linesearch_costs_lanes(
        ocp, lane(x0), lane(X[:, :-1]), lane(U), lane(kff), lane(Kfb), lane(xref),
        lane(lam), mu.contiguous(), alphas, mov_l)


# ---------------------------------------------------------------------------
# K6: accepted rollout
# ---------------------------------------------------------------------------


def rollout_alpha_plain(ocp: OCP, x0_l, X_l, U_l, kff_l, Kfb_l, alpha):
    """Plain PyTorch K6. x0_l [n, B], X_l [N, n, B] (stage states), U_l
    [N, nu, B], kff_l [N, nu, B], Kfb_l [N, nu, n, B], alpha [B] ->
    (Xtail_l [N, n, B] states 1..N, U_new [N, nu, B])."""
    dt = _pack_params(ocp, ()).to(x0_l)[_P(ocp.nx, ocp.nu, 0, ocp.n_obs).dt]
    x, xs, us = x0_l, [], []
    for k in range(ocp.N):
        u = _feedback_u(x, X_l[k], U_l[k], kff_l[k], Kfb_l[k], alpha)
        x = _euler_rows(ocp.m, x, u, dt)
        xs.append(x)
        us.append(u)
    return torch.stack(xs), torch.stack(us)


def check_rollout(ocp: OCP, x0_l, X_l, U_l, kff_l, Kfb_l, alpha) -> None:
    """Raise unless K6's kernels take these CUDA inputs."""
    if x0_l.device.type != "cuda":
        raise NotImplementedError(f"rollout_alpha_lanes: no kernel for {x0_l.device}")
    require(ocp, "rollout_alpha_lanes")
    N, n, nu, B = ocp.N, ocp.nx, ocp.nu, x0_l.shape[-1]
    for name, t, shape in (("x0_l", x0_l, (n, B)), ("X_l", X_l, (N, n, B)),
                           ("U_l", U_l, (N, nu, B)), ("kff_l", kff_l, (N, nu, B)),
                           ("Kfb_l", Kfb_l, (N, nu, n, B)), ("alpha", alpha, (B,))):
        check_arg(name, t, shape, x0_l.device)


def rollout_launch(ocp: OCP, x0_l, X_l, U_l, kff_l, Kfb_l, alpha, lib, first: bool = False):
    """K6 from library `lib` on checked inputs (`check_rollout`): the tile
    design, or with first=True the first design of a `cuda_build.load_first`
    library."""
    N, n, nu, B, dev = ocp.N, ocp.nx, ocp.nu, x0_l.shape[-1], x0_l.device
    Xout = torch.empty((N, n, B), dtype=torch.float32, device=dev)
    Uout = torch.empty((N, nu, B), dtype=torch.float32, device=dev)
    if B == 0:
        return Xout, Uout
    prm = params(ocp, (), dev)
    entry = lib.nmpc_rollout_alpha_first if first else lib.nmpc_rollout_alpha
    err = entry(ptr(prm), ptr(x0_l), ptr(X_l), ptr(U_l), ptr(kff_l), ptr(Kfb_l), ptr(alpha),
                ptr(Xout), ptr(Uout), B, N, cuda_build.stream(dev))
    cuda_build.check(lib, err, "rollout_alpha_lanes")
    return Xout, Uout


def rollout_alpha_lanes(ocp: OCP, x0_l, X_l, U_l, kff_l, Kfb_l, alpha):
    """K6 wrapper: the CUDA kernel for CUDA tensors, the plain version for
    CPU tensors. Same arguments and results as `rollout_alpha_plain`."""
    if x0_l.device.type == "cpu":
        return rollout_alpha_plain(ocp, x0_l, X_l, U_l, kff_l, Kfb_l, alpha)
    check_rollout(ocp, x0_l, X_l, U_l, kff_l, Kfb_l, alpha)
    out = rollout_launch(ocp, x0_l, X_l, U_l, kff_l, Kfb_l, alpha, cuda_build.load(ocp.m))
    if x0_l.shape[-1]:
        cuda_build.launch_counts["rollout_alpha_lanes"] += 1
    return out


def rollout_alpha(ocp: OCP, x0, X, U, kff, Kfb, alpha):
    """Accepted rollout with a per-scenario alpha [B], standard layout ->
    (X_new [B, N+1, n], U_new [B, N, nu])."""
    Xl, Ul = rollout_alpha_lanes(ocp, lane(x0), lane(X[:, :-1]), lane(U), lane(kff),
                                 lane(Kfb), alpha.contiguous())
    return torch.cat([x0[:, None], std(Xl)], dim=1), std(Ul)
