"""The kernels' parameter block. Port of `_P`, `_pack_params` and `supports`
from nmpc_tpu/ops/rollout_pallas.py.

The numeric problem data shared by every scenario of a batch (weights,
bounds, dmin^2, dt, obstacle rows, line-search alphas) is packed into one
small f32 vector that the CUDA kernels copy to shared memory; the offsets are
mirrored by `nmpc::Dims` in csrc/rollout.cuh. The rollout, feedback and merit
helpers of the TPU module are CUDA device functions in csrc/rollout.cuh.
"""

from __future__ import annotations

import torch

from nmpc_tpu_torch.ocp.problem import OCP


def supports(ocp: OCP) -> bool:
    """Problem class of the fused kernels' family: stacked-unicycle Euler
    dynamics without LiDAR rays or user-supplied dynamics."""
    return ocp.num_rays == 0 and ocp.integrator == "euler" and ocp.dyn_fn is None


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
        torch.as_tensor(alphas, **kw).reshape(-1),
    ])
