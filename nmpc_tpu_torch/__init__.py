"""nmpc_tpu_torch — the PyTorch + CUDA port of `nmpc_tpu`.

The same multiple-shooting NMPC engine (batched augmented-Lagrangian iLQR for
1..10 unicycle robots with pairwise collision and box constraints), written
for PyTorch on an NVIDIA Hopper GPU. The JAX package `nmpc_tpu` is the
reference: each module here has one counterpart there with the same
subpackage path and module name, and the tests hold each against it.

Layer map (mirrors nmpc_tpu), from the entry points down:
    mpc/       receding-horizon drivers: closed_loop, rt_closed_loop,
               waypoints, tracking, plan-then-replay; the escape law
    sim/       plant (substeps, saturation, noise from a torch.Generator),
               SE(2) frames, LiDAR ray casting
    solver/    AL-iLQR: the per-scenario engine `solve` (plain PyTorch, the
               drivers' default) and the batched main path `solve_batched`
               / `solve_one` (the hand-written kernels on CUDA tensors)
    parallel/  batch construction (batch_ocp, random_starts) and
               batched_solve (the per-scenario engine over a batch)
    ops/       the hand-written CUDA kernels (csrc/) with their plain
               PyTorch versions, build and ctypes binding
    ocp/       OCP dataclass, costs, c >= 0 constraints, constraint Jacobians
    models/    unicycle dynamics and analytic Euler Jacobians
    scenarios/ frozen registry of every reference configuration (own copy)
    tools/     the closed-loop fleet (fleet_loop) and the roofline tools:
               FMA-peak probe, K1's phase ablation and expansion-layout A/B
               (their kernels in csrc/tools.cu), the work model and bound of
               every kernel
    utils/     timing (host clock with device sync, CUDA events)
    device.py  DEVICE, every builder's default: the card

Precision: every contraction runs in full f32. TF32 keeps ~3 decimal digits,
and a Riccati recursion iterated at reduced precision diverges (the JAX
package pins f32 matmuls for the same reason, nmpc_tpu/__init__.py).
"""

__version__ = "0.1.0"

import torch as _torch

_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision("highest")

from nmpc_tpu_torch.ocp.problem import OCP, default_weights  # noqa: E402,F401
from nmpc_tpu_torch.solver.alilqr import ALILQRConfig, SolveResult, WarmStart  # noqa: E402,F401
from nmpc_tpu_torch.solver.alilqr_batched import solve_batched, solve_one  # noqa: E402,F401
