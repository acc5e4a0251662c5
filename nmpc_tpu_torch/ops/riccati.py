"""K3 `riccati_lanes`: the batched backward Riccati sweep of the staged path,
with its plain PyTorch version. Port of nmpc_tpu/ops/riccati_pallas.py.

From the dense stage blocks (A, B, lx, lu, lxx, luu, lux; K4's outputs, or
any general blocks through `riccati_fused`) and a zero terminal value, per
stage k = N-1..0:
  Qx = lx + A'Vx, Qu = lu + B'Vx, Qxx = lxx + A'Vxx A, Qux = lux + B'Vxx A,
  Quu = luu + B'Vxx B; [kff | Kfb] = -(Quu + reg I)^-1 [Qu | Qux] by the
  left-looking Cholesky of the lower triangle (reg added to the diagonal in
  the square root); dV1 += kff . Qu;
  Vx' = Qx + Qux' kff, Vxx' = Qxx + Qux' Kfb (no symmetrisation: Qux' Kfb =
  -Qux' Quu^-1 Qux is symmetric by construction).
This is K3's own recursion, not solver.alilqr._backward_pass (which
symmetrises and uses the full value update).

CUDA: csrc/staged_tiles.cuh::riccati_tiles, a block per tile of S
scenarios streaming the stages backwards through a ring of stage tiles in
shared memory, a team of T lanes per scenario (geometry per m:
ops/staged_tiles.py); bit for bit its first design, csrc/staged.cuh::
riccati_thread (one thread per scenario), which tools/staged_launch.py
launches as the A/B baseline. Past (30, 20) (m >= 11 and the wider stage
shapes) the register-tile design: S consecutive scenarios a block, the
three products as 4 x 4 register tiles over rows kept in shared memory, the
factor and the forward substitution as one elimination over the block, the
backward substitutions one right-hand side a thread, every sum in
riccati_thread's order; where one scenario's slot does not fit a block, the
slot in a device-memory scratch and the products staged through shared
memory (ops/staged_tiles.py::k3_rule). Replaces riccati_pallas.py::
_make_kernel / riccati_lanes (its horizon chunking exists only to fit VMEM
and does not carry over).

Layout: `riccati_lanes` takes and returns the lane-major layout of the
staged path: A [N, n, n, B], B [N, n, nu, B], lx [N, n, B], lu [N, nu, B],
lxx [N, n, n, B], luu [N, nu, nu, B], lux [N, nu, n, B] -> kff [N, nu, B],
Kfb [N, nu, n, B], dV1 [B]. `riccati_fused` is the standard-layout wrapper.
The kernels are built for n = 3m, nu = 2m at any m (in the solver library
of m robots) and for any other stage shape (csrc/riccati_shape.cu, a
library per shape at its first use: the ray-augmented stage of family I,
n = 13, nu = 2, and the user models of make_generic_ocp, which the hybrid
route of solver/alilqr_batched.py sends here): device memory bounds them,
through the inputs and the spilled slot's scratch.
"""

from __future__ import annotations

import torch

from nmpc_tpu_torch.ops import cuda_build, staged_tiles
from nmpc_tpu_torch.ops.cuda_build import check_arg, lane, ptr, std


def _chol(Quu, reg):
    """Lower Cholesky factor of Quu + reg I ([B, m, m]) by the kernels'
    left-looking column recursion; reads only the lower triangle. Returns
    (L, the reciprocals of its diagonal [B, m])."""
    m = Quu.shape[-1]
    L = torch.zeros_like(Quu)
    invs = []
    for i in range(m):
        v = Quu[..., :, i]
        for k in range(i):
            v = v - L[..., :, k] * L[..., i, k:k + 1]
        d = torch.sqrt(v[..., i] + reg)
        inv = 1.0 / d
        invs.append(inv)
        L[..., i, i] = d
        L[..., i + 1:, i] = v[..., i + 1:] * inv[..., None]
    return L, torch.stack(invs, -1)


def _chol_solve(L, inv, rhs):
    """Solve (L L') X = rhs, rhs [B, m, r], by the kernels' substitutions."""
    m = L.shape[-1]
    y = []
    for i in range(m):
        s = rhs[..., i, :]
        for k in range(i):
            s = s - L[..., i, k:k + 1] * y[k]
        y.append(s * inv[..., i:i + 1])
    x = [None] * m
    for i in reversed(range(m)):
        s = y[i]
        for k in range(i + 1, m):
            s = s - L[..., k, i:i + 1] * x[k]
        x[i] = s * inv[..., i:i + 1]
    return torch.stack(x, -2)


def riccati_plain(exp, reg: float = 1e-6):
    """Plain PyTorch K3. Same arguments and results as `riccati_lanes`."""
    A, Bm, lx, lu, lxx, luu, lux = exp
    N, n, _, B = A.shape
    nu = Bm.shape[2]
    kw = dict(dtype=A.dtype, device=A.device)
    bf = lambda t: t.movedim(-1, 0)  # noqa: E731  [..., B] -> [B, ...]
    Vx = torch.zeros((B, n, 1), **kw)
    Vxx = torch.zeros((B, n, n), **kw)
    dV1 = torch.zeros((B,), **kw)
    kff = torch.empty((N, nu, B), **kw)
    Kfb = torch.empty((N, nu, n, B), **kw)
    for k in reversed(range(N)):
        Ak, Bk = bf(A[k]), bf(Bm[k])
        At, Bt = Ak.mT, Bk.mT
        VA = Vxx @ Ak
        Qx = bf(lx[k])[..., None] + At @ Vx
        Qu = bf(lu[k])[..., None] + Bt @ Vx
        Qxx = bf(lxx[k]) + At @ VA
        Qux = bf(lux[k]) + Bt @ VA
        Quu = bf(luu[k]) + Bt @ (Vxx @ Bk)
        L, inv = _chol(Quu, reg)
        sol = -_chol_solve(L, inv, torch.cat([Qu, Qux], dim=-1))
        kk, KK = sol[..., :1], sol[..., 1:]
        kff[k] = kk[..., 0].T
        Kfb[k] = KK.movedim(0, -1)
        dV1 = dV1 + torch.sum(kk * Qu, dim=(-2, -1))
        Vx = Qx + Qux.mT @ kk
        Vxx = Qxx + Qux.mT @ KK
    return kff, Kfb, dV1


def check_lanes(exp) -> tuple:
    """(N, n, nu, B, m) of CUDA inputs the kernels take (m = n // 3); raises
    otherwise."""
    A = exp[0]
    if A.device.type != "cuda":
        raise NotImplementedError(f"riccati_lanes: no kernel for {A.device}")
    N, n, _, B = A.shape
    nu = exp[1].shape[2]
    m = n // 3
    staged_tiles.k3_rule(n, nu)   # raises for a shape no geometry takes
    for name, t, shape in zip(("A", "B", "lx", "lu", "lxx", "luu", "lux"), exp, (
            (N, n, n, B), (N, n, nu, B), (N, n, B), (N, nu, B), (N, n, n, B),
            (N, nu, nu, B), (N, nu, n, B))):
        check_arg(name, t, shape, A.device)
    return N, n, nu, B, m


def launch(exp, reg: float, lib, first: bool = False):
    """K3 from library `lib` on checked inputs (`check_lanes`): the tile
    design (its device-memory scratch sized from the library's geometry) or,
    with first=True, the first design of a `cuda_build.load_first` library."""
    N, n, _, B = exp[0].shape
    nu = exp[1].shape[2]
    kw = dict(dtype=torch.float32, device=exp[0].device)
    kff = torch.empty((N, nu, B), **kw)
    Kfb = torch.empty((N, nu, n, B), **kw)
    dV1 = torch.empty((B,), **kw)
    if B == 0:
        return kff, Kfb, dV1
    stream = cuda_build.stream(exp[0].device)
    if first:
        err = lib.nmpc_riccati_first(*map(ptr, exp), ptr(kff), ptr(Kfb), ptr(dV1), B, N,
                                     float(reg), stream)
    else:
        g = cuda_build.k3_geometry(lib)
        scratch = (torch.empty(((B + g["S"] - 1) // g["S"]) * g["scratch_floats"], **kw)
                   if g["spill"] else None)
        err = lib.nmpc_riccati(*map(ptr, exp), ptr(kff), ptr(Kfb), ptr(dV1), ptr(scratch), B, N,
                               float(reg), stream)
    cuda_build.check(lib, err, "riccati_lanes")
    return kff, Kfb, dV1


def riccati_lanes(exp, reg: float = 1e-6):
    """K3 wrapper: the CUDA kernel for CUDA tensors, the plain version for
    CPU tensors. exp = (A, B, lx, lu, lxx, luu, lux), lane-major."""
    if exp[0].device.type == "cpu":
        return riccati_plain(exp, reg)
    _, n, nu, _, _ = check_lanes(exp)
    out = launch(exp, reg, cuda_build.load_k3(n, nu))
    if exp[0].shape[-1]:
        cuda_build.launch_counts["riccati_lanes"] += 1
    return out


def riccati_fused(A, B, lx, lu, lxx, luu, lux, reg: float = 1e-6):
    """The sweep in the standard layout: A [B, N, n, n], B [B, N, n, nu],
    lx [B, N, n], lu [B, N, nu], lxx [B, N, n, n], luu [B, N, nu, nu],
    lux [B, N, nu, n] -> kff [B, N, nu], Kfb [B, N, nu, n], dV1 [B]."""
    kff, Kfb, dV1 = riccati_lanes(tuple(map(lane, (A, B, lx, lu, lxx, luu, lux))), reg)
    return std(kff), std(Kfb), dV1
