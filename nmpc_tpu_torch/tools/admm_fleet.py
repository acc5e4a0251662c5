"""The OSQP-capability fleet: batched LTV-MPC QP setup and solve through
the port's ADMM engine (solver/admm.py, plain PyTorch). Port of
tools/bench_admm.py.

The reference's OSQP prototype re-linearizes the unicycle around the
current yaw and turn rate with the exact-discretization input matrix
(gamma(w, Ts) = sin(Ts w / 2) / w), re-assembles the sparse QP and re-runs
OSQP setup and solve every Ts = 0.01 s control period at N = 100 (nz = 503
decision variables, 806 rows). This runs the same per-period work batched:
B linearizations, B dense KKT Cholesky factorizations (one batched call),
B ADMM solves. Budget: one setup and solve per 10 ms period per robot, 100
QPs/s per robot.

    python -m nmpc_tpu_torch.tools.admm_fleet [B] [iters]

Timed on the host clock with a synchronize at both ends; each timed batch
draws fresh linearizations. It refuses to time without a card; `assemble`,
`fleet_problem` and `draw` take any device.
"""

from __future__ import annotations

import math
import statistics
import sys
import time

import torch

from nmpc_tpu_torch.solver.admm import ADMMConfig, qp_setup_batched, qp_solve_batched

NX, NU, N = 3, 2, 100
TS = 0.01
BIG = 1e9
CFG = ADMMConfig(max_iter=400)


def gamma(w, Ts):
    """The exact-discretization weight."""
    return torch.where(torch.abs(w) < 1e-9, torch.full_like(w, Ts / 2),
                       torch.sin((Ts / 2) * w) / w)


def assemble(theta, w):
    """B linearizations (theta, w [B]) -> A [B, 806, 503]: the reference's
    kron layout with Ad = I."""
    dev, kw = theta.device, dict(dtype=torch.float32, device=theta.device)
    B = theta.shape[0]
    g = gamma(w, TS)
    Bd = torch.zeros((B, NX, NU), **kw)
    Bd[:, 0, 0], Bd[:, 1, 0] = 2 * g * torch.cos(theta), 2 * g * torch.sin(theta)
    Bd[:, 0, 1] = Bd[:, 1, 1] = TS / 2
    Bd[:, 2, 1] = TS
    eye_x = torch.eye(NX, **kw)
    Ax = (-torch.eye((N + 1) * NX, **kw)
          + torch.kron(torch.diag(torch.ones(N, **kw), -1), eye_x))
    sel = torch.cat([torch.zeros((1, N), **kw), torch.eye(N, **kw)])           # [N+1, N]
    Bu = torch.einsum("kj,bxu->bkxju", sel, Bd).reshape(B, (N + 1) * NX, N * NU)
    Aeq = torch.cat([Ax.expand(B, -1, -1), Bu], dim=2)
    nz = (N + 1) * NX + N * NU
    return torch.cat([Aeq, torch.eye(nz, device=dev).expand(B, -1, -1)], dim=1)


def fleet_problem(device):
    """The constant pieces: P (Q = diag(1, 5, 0.1), R = diag(0.5, 0.05)),
    the box rows' bounds and the linear cost toward the goal (1, 1, 0)."""
    kw = dict(dtype=torch.float32, device=device)
    Qd, Rd = torch.tensor([1.0, 5.0, 0.1], **kw), torch.tensor([0.5, 0.05], **kw)
    P = torch.diag(torch.cat([Qd.repeat(N + 1), Rd.repeat(N)]))
    xmin = torch.tensor([-BIG, -BIG, -2 * math.pi], **kw)
    umin = torch.tensor([-0.22, -1.0], **kw)
    box_lo = torch.cat([xmin.repeat(N + 1), umin.repeat(N)])
    box_hi = -box_lo
    xr = torch.tensor([1.0, 1.0, 0.0], **kw)
    q = torch.cat([(-Qd * xr).repeat(N + 1), torch.zeros(N * NU, **kw)])
    return P, box_lo, box_hi, q


def draw(B: int, g: torch.Generator, device):
    """B linearization points and starts: theta U(0, 2 pi), w U(-1, 1), x0
    0.3 N(0, 1)."""
    kw = dict(generator=g, device=device)
    thetas = 2 * math.pi * torch.rand(B, **kw)
    ws = 2 * torch.rand(B, **kw) - 1
    return thetas, ws, 0.3 * torch.randn((B, NX), **kw)


def fleet(P, box_lo, box_hi, q, thetas, ws, x0s, cfg: ADMMConfig = CFG):
    """One period of the fleet: assemble, set up (B factorizations) and
    solve B QPs. Returns (z [B, nz], y, iters, converged, prim)."""
    B, nz, n_eq = thetas.shape[0], P.shape[0], (N + 1) * NX
    A = assemble(thetas, ws)
    zeros = torch.zeros((B, n_eq - NX), dtype=P.dtype, device=P.device)
    l = torch.cat([-x0s, zeros, box_lo.expand(B, nz)], dim=1)
    u = torch.cat([-x0s, zeros, box_hi.expand(B, nz)], dim=1)
    fac = qp_setup_batched(P, A, cfg, l=l, u=u)
    return qp_solve_batched(fac, q.expand(B, nz), l, u, cfg)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        print("admm_fleet: needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    B = int(argv[0]) if argv else 256
    iters = int(argv[1]) if len(argv) > 1 else 3
    g = torch.Generator(device=dev).manual_seed(0)
    consts = fleet_problem(dev)
    fleet(*consts, *draw(B, g, dev))   # warm-up
    times = []
    for _ in range(iters):
        args = draw(B, g, dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        z, _, its, done, prim = fleet(*consts, *args)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    t = statistics.median(times)
    print(f"LTV-MPC QP (N={N}, nz={consts[0].shape[0]}, rows={(N + 1) * NX + consts[0].shape[0]}) "
          f"B={B}: {t * 1e3:.1f} ms a batch (median of {iters}) -> {B / t:.1f} setup+solves/s, "
          f"converged {float(done.float().mean()):.4f}, mean iters {float(its.float().mean()):.1f} "
          f"({torch.cuda.get_device_name(0)})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
