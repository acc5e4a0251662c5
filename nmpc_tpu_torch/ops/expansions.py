"""K4 `expansions_fused`: the AL-iLQR stage expansions of the staged path,
with its plain PyTorch version. Port of nmpc_tpu/ops/expansions_pallas.py.

For every stage and scenario: the dynamics Jacobians A, B (Euler unicycle,
closed form), the AL-merit gradients lx, lu and the Gauss-Newton Hessians
lxx, luu, with lux = 0 (this problem class has no x-u constraint coupling).
Constraint rows: pairs, static obstacles, moving obstacles, the u box and
the x box; every state-dependent row is masked hard at stage 0.

CUDA: csrc/expansions_rollout_tiles.cuh::expansion_tiles, a block per
(tile of S scenarios, stage): the stage's input rows copied into shared
memory, each scenario's thread adding its Hessian terms into a shared tile,
then every output row stored as 16-byte chunks of the tile (its structure
from constants); bit for bit its first design, csrc/staged.cuh::
expansion_thread (one thread per (stage, scenario), the A/B baseline of
tools/staged_launch.py). Where a problem's rows overflow that block's
shared memory (staged_tiles.k4_form: many obstacle rows, or m >= 109,
where the Hessian's position block alone does), the device-memory form runs
the same code with both tiles in a slot of a scratch the wrapper allocates
(staged_tiles.k4_device_slots blocks, each taking (tile, stage) work items
in turn) and the parameter block read from device memory: bit for bit the
tile form, bounded by device memory alone. Stages are independent, so the
TPU kernel's horizon chunking (there only to bound VMEM) does not carry
over. Replaces expansions_pallas.py::_make_expansion_kernel /
expansions_fused.

Layout (lane-major, batch innermost, as the staged path keeps it): X_l
[N, n, B] stage states, U_l [N, nu, B], xref_l [N, n, B], lam_l [N, nc, B],
mu [B], mov_l [N, 2 n_mov, B] when ocp.n_mov > 0 -> (A [N, n, n, B],
B [N, n, nu, B], lx [N, n, B], lu [N, nu, B], lxx [N, n, n, B],
luu [N, nu, nu, B], lux [N, nu, n, B]), which K3 (ops/riccati.py) reads as
they are.
"""

from __future__ import annotations

import torch

from nmpc_tpu_torch.ocp.problem import OCP, pair_indices
from nmpc_tpu_torch.ops import cuda_build, staged_tiles
from nmpc_tpu_torch.ops.cuda_build import check_arg, ptr
from nmpc_tpu_torch.ops.rollout import _P, _mov_d, _obs_c, _pack_params, al_step, params, require


def _ind(a):
    """1 where an activation is positive, else 0."""
    return (a > 0.0).to(a.dtype)


def expansions_plain(ocp: OCP, X_l, U_l, xref_l, lam_l, mu, mov_l=None):
    """Plain PyTorch K4, in the kernels' row order and rounding of c and of
    the activations. Same arguments and results as `expansions_fused`."""
    P = _P(ocp.nx, ocp.nu, 0, ocp.n_obs)
    prm = _pack_params(ocp, ()).to(X_l)
    N, n, nu, m = ocp.N, ocp.nx, ocp.nu, ocp.m
    Bsz = X_l.shape[-1]
    dt = prm[P.dt]
    kw = dict(dtype=X_l.dtype, device=X_l.device)
    gate = (torch.arange(N, device=X_l.device) > 0)[:, None]  # [N, 1]

    def masked(act):  # hard stage-0 mask of a state-dependent row [N, ..., B]
        g = gate.reshape(N, *([1] * (act.dim() - 1)))
        return torch.where(g, act, torch.zeros_like(act))

    def act_of(row, c):
        return torch.clamp(al_step(lam_l[:, row], mu, c), min=0.0)

    # dynamics Jacobians
    A = torch.zeros((N, n, n, Bsz), **kw)
    Bm = torch.zeros((N, n, nu, Bsz), **kw)
    for i in range(n):
        A[:, i, i] = 1.0
    for r in range(m):
        th, v = X_l[:, 3 * r + 2], U_l[:, 2 * r]
        c, s = torch.cos(th), torch.sin(th)
        A[:, 3 * r, 3 * r + 2] = -dt * v * s
        A[:, 3 * r + 1, 3 * r + 2] = dt * v * c
        Bm[:, 3 * r, 2 * r] = dt * c
        Bm[:, 3 * r + 1, 2 * r] = dt * s
        Bm[:, 3 * r + 2, 2 * r + 1] = dt

    lx = [2.0 * prm[P.q + i] * (X_l[:, i] - xref_l[:, i]) for i in range(n)]
    lu = [2.0 * prm[P.r + i] * U_l[:, i] for i in range(nu)]
    H = {}

    def add(a, b, v):
        H[(a, b)] = H[(a, b)] + v if (a, b) in H else v

    row = 0
    pair_terms, obs_terms, mov_terms = [], [], []
    for i, j in (zip(*pair_indices(m)) if ocp.n_pairs else ()):
        dx = X_l[:, 3 * i] - X_l[:, 3 * j]
        dy = X_l[:, 3 * i + 1] - X_l[:, 3 * j + 1]
        act = masked(act_of(row, dx * dx + dy * dy - prm[P.dmin2]))
        gx, gy = 2.0 * dx, 2.0 * dy
        lx[3 * i] = lx[3 * i] - gx * act
        lx[3 * i + 1] = lx[3 * i + 1] - gy * act
        lx[3 * j] = lx[3 * j] + gx * act
        lx[3 * j + 1] = lx[3 * j + 1] + gy * act
        pair_terms.append((i, j, gx, gy, mu * _ind(act)))
        row += 1
    if ocp.n_obs:
        c, dx, dy, dist = _obs_c(ocp, prm, X_l)  # [N, m n_obs, B]
        act = masked(torch.clamp(al_step(lam_l[:, row:row + m * ocp.n_obs], mu, c), min=0.0))
        ux, uy = dx / dist, dy / dist
        for q in range(m * ocp.n_obs):
            i = q // ocp.n_obs
            lx[3 * i] = lx[3 * i] - ux[:, q] * act[:, q]
            lx[3 * i + 1] = lx[3 * i + 1] - uy[:, q] * act[:, q]
            obs_terms.append((i, ux[:, q], uy[:, q], mu * _ind(act[:, q])))
        row += m * ocp.n_obs
    if ocp.n_mov:
        dx, dy = _mov_d(ocp, X_l, mov_l)  # [N, m n_mov, B]
        act = masked(torch.clamp(
            al_step(lam_l[:, row:row + m * ocp.n_mov], mu, dx * dx + dy * dy - prm[P.dmin2]),
            min=0.0))
        for q in range(m * ocp.n_mov):
            i = q // ocp.n_mov
            gx, gy = 2.0 * dx[:, q], 2.0 * dy[:, q]
            lx[3 * i] = lx[3 * i] - gx * act[:, q]
            lx[3 * i + 1] = lx[3 * i + 1] - gy * act[:, q]
            mov_terms.append((i, gx, gy, mu * _ind(act[:, q])))
        row += m * ocp.n_mov

    luu = torch.zeros((N, nu, nu, Bsz), **kw)
    for i in range(nu):
        a_lo = act_of(row + i, U_l[:, i] - prm[P.u_lo + i])
        a_hi = act_of(row + nu + i, prm[P.u_hi + i] - U_l[:, i])
        lu[i] = lu[i] - a_lo + a_hi
        luu[:, i, i] = 2.0 * prm[P.r + i] + mu * (_ind(a_lo) + _ind(a_hi))
    row += 2 * nu
    for i in range(n):
        a_lo = masked(act_of(row + i, X_l[:, i] - prm[P.x_lo + i]))
        a_hi = masked(act_of(row + n + i, prm[P.x_hi + i] - X_l[:, i]))
        lx[i] = lx[i] - a_lo + a_hi
        H[(i, i)] = 2.0 * prm[P.q + i] + mu * (_ind(a_lo) + _ind(a_hi))

    for i, j, gx, gy, w in pair_terms:
        xi, yi, xj, yj = 3 * i, 3 * i + 1, 3 * j, 3 * j + 1
        wxx, wyy, wxy = w * gx * gx, w * gy * gy, w * gx * gy
        add(xi, xi, wxx); add(yi, yi, wyy)  # noqa: E702
        add(xj, xj, wxx); add(yj, yj, wyy)  # noqa: E702
        add(xi, yi, wxy); add(yi, xi, wxy)  # noqa: E702
        add(xj, yj, wxy); add(yj, xj, wxy)  # noqa: E702
        add(xi, xj, -wxx); add(xj, xi, -wxx)  # noqa: E702
        add(yi, yj, -wyy); add(yj, yi, -wyy)  # noqa: E702
        add(xi, yj, -wxy); add(yj, xi, -wxy)  # noqa: E702
        add(yi, xj, -wxy); add(xj, yi, -wxy)  # noqa: E702
    for i, ux, uy, w in obs_terms:
        add(3 * i, 3 * i, w * ux * ux)
        add(3 * i + 1, 3 * i + 1, w * uy * uy)
        add(3 * i, 3 * i + 1, w * ux * uy)
        add(3 * i + 1, 3 * i, w * ux * uy)
    for i, gx, gy, w in mov_terms:
        add(3 * i, 3 * i, w * gx * gx)
        add(3 * i + 1, 3 * i + 1, w * gy * gy)
        add(3 * i, 3 * i + 1, w * gx * gy)
        add(3 * i + 1, 3 * i, w * gx * gy)
    lxx = torch.zeros((N, n, n, Bsz), **kw)
    for (a, b), v in H.items():
        lxx[:, a, b] = v
    return (A, Bm, torch.stack(lx, 1), torch.stack(lu, 1), lxx, luu,
            torch.zeros((N, nu, n, Bsz), **kw))


def check_lanes(ocp: OCP, X_l, U_l, xref_l, lam_l, mu, mov_l=None) -> None:
    """Raise unless K4's kernels take these CUDA inputs."""
    if X_l.device.type != "cuda":
        raise NotImplementedError(f"expansions_fused: no kernel for {X_l.device}")
    require(ocp, "expansions_fused")
    N, n, nu, nc, B = ocp.N, ocp.nx, ocp.nu, ocp.n_con, X_l.shape[-1]
    args = [("X_l", X_l, (N, n, B)), ("U_l", U_l, (N, nu, B)), ("xref_l", xref_l, (N, n, B)),
            ("lam_l", lam_l, (N, nc, B)), ("mu", mu, (B,))]
    if ocp.n_mov:
        args.append(("mov_l", mov_l, (N, 2 * ocp.n_mov, B)))
    for name, t, shape in args:
        check_arg(name, t, shape, X_l.device)


def form(ocp: OCP) -> staged_tiles.K4Geometry:
    """The K4 form this problem launches (staged_tiles.k4_form on its rows):
    the library's tile, or staged_tiles.K4_DEVICE."""
    return staged_tiles.k4_form(ocp.m, ocp.n_pairs > 0, ocp.n_obs, ocp.n_mov,
                                _P(ocp.nx, ocp.nu, 0, ocp.n_obs).size)


def launch(ocp: OCP, X_l, U_l, xref_l, lam_l, mu, mov_l, lib, first: bool = False,
           device: bool = False) -> tuple:
    """K4 from library `lib` on checked inputs (`check_lanes`): the tile
    design, with device=True its device-memory form, or with first=True the
    first design of a `cuda_build.load_first` library."""
    N, n, nu, B, dev = ocp.N, ocp.nx, ocp.nu, X_l.shape[-1], X_l.device
    outs = [torch.empty(s, dtype=torch.float32, device=dev) for s in (
        (N, n, n, B), (N, n, nu, B), (N, n, B), (N, nu, B), (N, n, n, B), (N, nu, nu, B),
        (N, nu, n, B))]
    if B == 0:
        return tuple(outs)
    prm = params(ocp, (), dev)
    ins = (ptr(X_l), ptr(U_l), ptr(xref_l), ptr(lam_l), ptr(mu), ptr(mov_l if ocp.n_mov else None))
    tail = (B, N, int(ocp.n_pairs > 0), ocp.n_obs, ocp.n_mov, cuda_build.stream(dev))
    if device:
        rows = staged_tiles.k4_rows(ocp.m, ocp.n_pairs > 0, ocp.n_obs, ocp.n_mov)
        slots = staged_tiles.k4_device_slots(B, N, cuda_build.sm_count(dev))
        scratch = torch.empty(slots * staged_tiles.k4_scratch_floats(
            ocp.m, rows, staged_tiles.K4_DEVICE), dtype=torch.float32, device=dev)
        err = lib.nmpc_expansions_device(ptr(prm), *ins, *map(ptr, outs), ptr(scratch), slots,
                                         *tail)
    else:
        entry = lib.nmpc_expansions_first if first else lib.nmpc_expansions
        err = entry(ptr(prm), prm.numel(), *ins, *map(ptr, outs), *tail)
    cuda_build.check(lib, err, "expansions_fused")
    return tuple(outs)


def expansions_fused(ocp: OCP, X_l, U_l, xref_l, lam_l, mu, mov_l=None):
    """K4 wrapper: the CUDA kernel for CUDA tensors, in the form `form`
    picks, the plain version for CPU tensors (see the module docstring for
    the layout)."""
    if X_l.device.type == "cpu":
        return expansions_plain(ocp, X_l, U_l, xref_l, lam_l, mu, mov_l)
    check_lanes(ocp, X_l, U_l, xref_l, lam_l, mu, mov_l)
    device = form(ocp).device
    outs = launch(ocp, X_l, U_l, xref_l, lam_l, mu, mov_l, cuda_build.load(ocp.m), device=device)
    if X_l.shape[-1]:
        cuda_build.launch_counts["expansions_fused"] += 1
        cuda_build.staged_forms["K4 device" if device else "K4 tile"] += 1
    return outs
