"""Horizon-parallel LQR via associative scan. Port of nmpc_tpu/ops/assoc_lqr.py
(plain PyTorch: the reference has no Pallas kernel here).

The Riccati backward recursion is reformulated as an associative operation
on conditional-value-function elements (Sarkka & Garcia-Fernandez, "Temporal
Parallelization of Dynamic Programming and Linear Quadratic Control"), so
all N value functions come out of a scan of O(log N) depth. `_assoc_scan` is
the recursive odd/even scan of `jax.lax.associative_scan`, with the same
combination tree.

Element e = (A, b, C, eta, J) encodes the optimal cost-to-go between two
stages as V(x_i | x_j) with value form V(x) = 0.5 x'Jx - eta'x and endpoint
map x_j = (I + C J)^{-1}(A x_i + b + C eta).

Shapes: the horizon is the leading axis of every input; any batch axes sit
between it and the matrix axes (A [N, ..., n, n], qx [N, ..., n]).
"""

from __future__ import annotations

import torch


def _mv(M, v):
    return (M @ v[..., None])[..., 0]


def _combine(ei, ej):
    """Associative composition of conditional-value elements (ei covers the
    earlier interval, ej the later)."""
    Ai, bi, Ci, etai, Ji = ei
    Aj, bj, Cj, etaj, Jj = ej
    n = Ai.shape[-1]
    I = torch.eye(n, dtype=Ai.dtype, device=Ai.device)
    M1 = torch.linalg.solve(I + Ci @ Jj, torch.cat([Ai, bi[..., None], Ci], dim=-1))
    M1A, M1C = M1[..., :n], M1[..., n + 1:]
    M2 = torch.linalg.solve(
        I + Jj @ Ci, torch.cat([(etaj - _mv(Jj, bi))[..., None], Jj @ Ai], dim=-1))
    M2e, M2JA = M2[..., 0], M2[..., 1:]
    M1bC = torch.linalg.solve(I + Ci @ Jj, (bi + _mv(Ci, etaj))[..., None])[..., 0]
    A = Aj @ M1A
    b = _mv(Aj, M1bC) + bj
    C = Aj @ M1C @ Aj.mT + Cj
    eta = _mv(Ai.mT, M2e) + etai
    J = Ai.mT @ M2JA + Ji
    return A, b, 0.5 * (C + C.mT), eta, 0.5 * (J + J.mT)


def _interleave(a, b):
    """a[0], b[0], a[1], b[1], ... along axis 0 (len(a) = len(b) or +1)."""
    out = torch.empty((a.shape[0] + b.shape[0], *a.shape[1:]), dtype=a.dtype, device=a.device)
    out[0::2] = a
    out[1::2] = b
    return out


def _assoc_scan(fn, elems):
    """Inclusive scan of `fn` along axis 0 of every tensor of `elems`
    (jax.lax.associative_scan's recursion)."""
    num = elems[0].shape[0]
    if num < 2:
        return elems
    reduced = fn([e[0:-1:2] for e in elems], [e[1::2] for e in elems])
    odd = _assoc_scan(fn, reduced)
    if num % 2 == 0:
        even = fn([e[:-1] for e in odd], [e[2::2] for e in elems])
    else:
        even = fn(list(odd), [e[2::2] for e in elems])
    even = [torch.cat([e[0:1], r]) for e, r in zip(elems, even)]
    return [_interleave(e, o) for e, o in zip(even, odd)]


def _eliminate_cross(A, B, c, Qxx, qx, Quu, qu, Qux):
    """Complete the square in u to remove cross terms: u = ubar - Quu^{-1}
    (Qux x + qu). Returns pure-form (Abar, cbar, Cbar, Qxxbar, qxbar) plus
    the recovery pieces (Kc = Quu^{-1} Qux, kc = Quu^{-1} qu)."""
    sol = torch.linalg.solve(Quu, torch.cat([Qux, qu[..., None], B.mT], dim=-1))
    n = Qux.shape[-1]
    Kc, kc, QiBt = sol[..., :n], sol[..., n], sol[..., n + 1:]
    Abar = A - B @ Kc
    cbar = c - _mv(B, kc)
    Cbar = B @ QiBt
    Cbar = 0.5 * (Cbar + Cbar.mT)
    Qxxbar = Qxx - Qux.mT @ Kc
    qxbar = qx - _mv(Qux.mT, kc)
    return Abar, cbar, Cbar, Qxxbar, qxbar, Kc, kc


def parallel_lqr_gains(A, B, c, Qxx, qx, Quu, qu, Qux, QxxN=None, qxN=None):
    """All-stage LQR gains in O(log N) depth.

    Inputs (delta-coordinate LQ subproblem, stage k = 0..N-1):
      A [N,...,n,n], B [N,...,n,m], c [N,...,n], Qxx [N,...,n,n], qx [N,...,n],
      Quu [N,...,m,m] (PD), qu [N,...,m], Qux [N,...,m,n]; terminal QxxN
      [...,n,n], qxN [...,n] (default zero: the OCP has no terminal cost).
    Returns (kff [N,...,m], K [N,...,m,n], S [N+1,...,n,n], v [N+1,...,n])
    with V_k(x) = 0.5 x'S_k x - v_k'x.
    """
    n = A.shape[-1]
    kw = dict(dtype=A.dtype, device=A.device)
    batch = A.shape[1:-2]
    if QxxN is None:
        QxxN = torch.zeros((*batch, n, n), **kw)
    if qxN is None:
        qxN = torch.zeros((*batch, n), **kw)
    Abar, cbar, Cbar, Qxxbar, qxbar, Kc, kc = _eliminate_cross(A, B, c, Qxx, qx, Quu, qu, Qux)
    zm = torch.zeros((1, *batch, n, n), **kw)
    elems = [torch.cat([Abar, zm]), torch.cat([cbar, torch.zeros((1, *batch, n), **kw)]),
             torch.cat([Cbar, zm]), torch.cat([-qxbar, -qxN.expand(*batch, n)[None]]),
             torch.cat([Qxxbar, QxxN.expand(*batch, n, n)[None]])]
    # inclusive right-to-left scan: out[k] = e_k (x) ... (x) e_N, as the
    # reference's associative_scan(reverse=True): flip, scan with the
    # arguments swapped (the accumulated later element comes first), flip
    out = _assoc_scan(lambda a, b: _combine(b, a), [e.flip(0) for e in elems])
    S, v = out[4].flip(0), out[3].flip(0)

    # gains from the k+1 value function (delta coordinates: x evaluated at 0)
    S1, v1 = S[1:], v[1:]
    H = Quu + B.mT @ S1 @ B
    rhs_k = _mv(B.mT, _mv(S1, cbar) - v1)
    rhs_K = B.mT @ S1 @ Abar
    sol = torch.linalg.solve(H, torch.cat([rhs_k[..., None], rhs_K], dim=-1))
    return -sol[..., 0] - kc, -sol[..., 1:] - Kc, S, v


def sequential_lqr_gains(A, B, c, Qxx, qx, Quu, qu, Qux, QxxN=None, qxN=None):
    """Reference O(N) Riccati sweep over the same inputs (for validation and
    short horizons where the scan's combine overhead dominates)."""
    N, n = A.shape[0], A.shape[-1]
    kw = dict(dtype=A.dtype, device=A.device)
    batch = A.shape[1:-2]
    S = torch.zeros((*batch, n, n), **kw) if QxxN is None else QxxN
    v = torch.zeros((*batch, n), **kw) if qxN is None else -qxN
    kffs, Ks = [None] * N, [None] * N
    for k in reversed(range(N)):
        A_k, B_k, c_k = A[k], B[k], c[k]
        w = _mv(S, c_k) - v
        Qx = qx[k] + _mv(A_k.mT, w)
        Qu = qu[k] + _mv(B_k.mT, w)
        Qxx_h = Qxx[k] + A_k.mT @ S @ A_k
        Quu_h = Quu[k] + B_k.mT @ S @ B_k
        Qux_h = Qux[k] + B_k.mT @ S @ A_k
        sol = torch.linalg.solve(Quu_h, torch.cat([Qu[..., None], Qux_h], dim=-1))
        kff, K = -sol[..., 0], -sol[..., 1:]
        S = Qxx_h + K.mT @ Quu_h @ K + K.mT @ Qux_h + Qux_h.mT @ K
        v = -(Qx + _mv(K.mT @ Quu_h, kff) + _mv(K.mT, Qu) + _mv(Qux_h.mT, kff))
        S = 0.5 * (S + S.mT)
        kffs[k], Ks[k] = kff, K
    return torch.stack(kffs), torch.stack(Ks)
