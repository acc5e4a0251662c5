"""The reference's two user models on the generic-dynamics hook
(make_generic_ocp), as tests/test_generic_dynamics.py builds them, and
their fleets: solve_batched's hybrid route at B jittered starts through K3
at the user model's stage shape.

* Van der Pol (nx=2, nu=1): x1' = (1 - x2^2) x1 - x2 + u, x2' = x1; N=20
  intervals of dt 0.5 with 4 RK4 substeps, x0 = (0, 1), u in [-1, 1],
  x1 >= -0.25, solved with ALILQRConfig(n_outer=10, n_inner=40,
  tol_con=1e-5).
* The first-order process (nx=1, nu=1): y' = (-y + K u)/tau with K=3,
  tau=5; N=30, dt 0.5, Euler, setpoint 10, Q=1, R=0.01, u in [0, 5].

    python -m nmpc_tpu_torch.tools.user_models [B]

times both fleets on the card (solves/s, convergence, K3's launches) and
refuses to time without one; the builders take any device.
"""

from __future__ import annotations

import dataclasses
import sys
import time

import torch

from nmpc_tpu_torch.ocp.problem import BIG, OCP, make_generic_ocp
from nmpc_tpu_torch.parallel import batch_ocp
from nmpc_tpu_torch.solver.alilqr import ALILQRConfig

CFG = ALILQRConfig(n_outer=10, n_inner=40, tol_con=1e-5)   # the reference demo's
K_GAIN, TAU = 3.0, 5.0


def vdp(x, u):
    """Van der Pol RHS at one point (x [2], u [1])."""
    x1, x2 = x[0], x[1]
    return torch.stack([(1.0 - x2 * x2) * x1 - x2 + u[0], x1])


def process(x, u):
    """First-order process RHS: dy/dt = (-y + K u) / tau."""
    return (-x + K_GAIN * u) / TAU


def vdp_ocp(device, **overrides) -> OCP:
    kw = dict(nx=2, nu=1, N=20, T=0.5, x0=[0.0, 1.0], x_goal=[0.0, 0.0], u_lo=[-1.0],
              u_hi=[1.0], x_lo=[-0.25, -BIG], integrator="rk4", substeps=4)
    return make_generic_ocp(vdp, device=device, **{**kw, **overrides})


def process_ocp(device, **overrides) -> OCP:
    kw = dict(nx=1, nu=1, N=30, T=0.5, x0=[0.0], x_goal=[10.0], Qdiag=[1.0], Rdiag=[0.01],
              u_lo=[0.0], u_hi=[5.0], integrator="euler")
    return make_generic_ocp(process, device=device, **{**kw, **overrides})


def jittered(ocp: OCP, B: int, g: torch.Generator, spread: float = 0.05) -> OCP:
    """B copies of ocp with their starts moved by spread N(0, 1) each."""
    noise = torch.randn((B, ocp.nx), generator=g, device=ocp.device)
    return batch_ocp(ocp, ocp.x0[None] + spread * noise)


def main(argv=None) -> int:
    from nmpc_tpu_torch.ops import cuda_build
    from nmpc_tpu_torch.solver import solve_batched

    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        print("user_models: needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    B = int(argv[0]) if argv else 32768
    for name, make in (("vdp", vdp_ocp), ("process", process_ocp)):
        ob = jittered(make(dev), B, torch.Generator(device=dev).manual_seed(0))
        solve_batched(ob, cfg=dataclasses.replace(CFG, n_outer=1, n_inner=1))   # warm-up
        cuda_build.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = solve_batched(ob, cfg=CFG)
        torch.cuda.synchronize()
        t = time.perf_counter() - t0
        print(f"{name} B={B}: {t * 1e3:.1f} ms -> {B / t:.1f} solves/s, converged "
              f"{float(res.converged.float().mean()):.4f}, K3 launches "
              f"{cuda_build.launch_counts['riccati_lanes']} ({torch.cuda.get_device_name(0)})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
