"""Batched plant simulator: the stand-in for Gazebo or a real TurtleBot3.

Port of nmpc_tpu/sim/plant.py. The plant integrates the model with
`substeps` finer steps per control period (Gazebo's higher-rate physics),
saturates the actuators, and optionally adds process and odometry noise.
Every function takes any number of leading batch dimensions.

Noise comes from an explicit `torch.Generator` on the state's device (the
reference splits a JAX key); a generator cannot reproduce JAX's streams, so
the two packages agree on noise-free steps element by element and on noisy
ones in distribution.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from nmpc_tpu_torch.device import DEVICE
from nmpc_tpu_torch.models.unicycle import discrete_dynamics


@dataclasses.dataclass(frozen=True)
class PlantConfig:
    substeps: int = 1
    integrator: str = "euler"
    u_sat: torch.Tensor | None = None          # [nu] actuator saturation, None = off
    process_noise: torch.Tensor | None = None  # [nx] std-dev, None = off
    odom_noise: torch.Tensor | None = None     # [nx] measurement std-dev, None = off


def plant_from_numpy(substeps: int = 1, integrator: str = "euler", u_sat=None,
                     process_noise=None, odom_noise=None, device=DEVICE) -> PlantConfig:
    """The port's PlantConfig from a reference PlantConfig's fields, the
    arrays given as numpy arrays (None stays None)."""
    def t(a):
        return None if a is None else torch.as_tensor(np.array(a), device=device)

    return PlantConfig(substeps=substeps, integrator=integrator, u_sat=t(u_sat),
                       process_noise=t(process_noise), odom_noise=t(odom_noise))


def plant_step(x: torch.Tensor, u: torch.Tensor, dt, cfg: PlantConfig = PlantConfig(),
               generator: torch.Generator | None = None):
    """Advance the true state one control period; returns (x_next, odom).
    Noise is drawn only with a generator (process first, then odometry), on
    x's device."""
    if cfg.u_sat is not None:
        u = torch.maximum(torch.minimum(u, cfg.u_sat), -cfg.u_sat)
    h = dt / cfg.substeps
    for _ in range(cfg.substeps):
        x = discrete_dynamics(x, u, h, cfg.integrator)

    def noise(std):
        return std * torch.randn(x.shape, generator=generator, dtype=x.dtype, device=x.device)

    if generator is not None and cfg.process_noise is not None:
        x = x + noise(cfg.process_noise)
    odom = x
    if generator is not None and cfg.odom_noise is not None:
        odom = x + noise(cfg.odom_noise)
    return x, odom
