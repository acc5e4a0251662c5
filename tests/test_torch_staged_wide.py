"""The staged route (mega=False) and the hybrid route (sweep="scan") at
twelve robots, past the registry's, against the reference's own routes,
whose Pallas kernels run in interpret mode on the CPU; and K3's plain
version at a stage shape past (30, 20) against the reference's Pallas
kernel. On the card these routes run K3's register-tile design and K4-K6 at m = 12
(chip_smoke.py phase 39); here the plain versions, which the host
rehearsal (tests/test_torch_staged_wide_host.py) and the card hold the
kernels to.

The problem is scenarios/robot_counts.py's circle at m=12, N=2, built by
the reference's make_ocp and carried to the port by ocp_from_numpy; two
starts jittered by 0.01 N(0, 1), made with numpy from a seed; one outer
step of two inner iterations. That is the smallest size with more than one
stage: the reference's Pallas kernels at m=12 in interpret mode take ~75 s
to compile and run at N=1 and ~110 s at N=2 on the staged route (K3 at
nu = 24 alone ~40 s a stage), ~15 s on the hybrid route, so this file is one
xdist worker's. Tolerances are tests/test_torch_solve_lanes.py's: cost rtol
1e-4 and U atol 5e-3, and the counts within one outer step and two inner
iterations of the reference (its stop rule decides at the f32 rounding
level near convergence). The reference's own spread under a 1e-7 move of
the starts (`JAX_PLATFORMS=cpu python tests/reference_spread.py
staged_wide`) is far inside them.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nmpc_tpu.ocp import problem as JP
from nmpc_tpu.ops.riccati_pallas import riccati_fused as jax_riccati
from nmpc_tpu.parallel.batch import batch_ocp as jax_batch_ocp
from nmpc_tpu.solver.alilqr import ALILQRConfig as JaxConfig
from nmpc_tpu.solver.alilqr_batched import solve_batched as jax_solve_batched
from nmpc_tpu_torch.ocp import problem as TP
from nmpc_tpu_torch.ops import cuda_build, rollout
from nmpc_tpu_torch.ops.riccati import riccati_plain
from nmpc_tpu_torch.scenarios import robot_counts
from nmpc_tpu_torch.solver import ALILQRConfig
from nmpc_tpu_torch.solver.alilqr_batched import route, solve_batched

M, N, B = 12, 2, 2
SOLVE = dict(n_outer=1, n_inner=2)
ROUTES = {"staged": {"mega": False}, "hybrid": {"sweep": "scan"}}


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def port_ocp(o):
    data = {f.name: np.asarray(getattr(o, f.name))
            for f in dataclasses.fields(o) if f.name not in JP.OCP_META}
    return TP.ocp_from_numpy(data, device="cpu", **{k: getattr(o, k) for k in JP.OCP_META})


def batch(seed=0, dx=0.0):
    """The reference's batch of B starts of the m=12 circle (moved by dx)."""
    base = JP.make_ocp(**robot_counts.circle(M, N=N))
    rng = np.random.default_rng(seed)
    x0 = (np.asarray(base.x0)[None] + 0.01 * rng.standard_normal((B, base.nx))).astype(np.float32)
    return jax_batch_ocp(base, jnp.asarray(x0 + dx))


def reference(ob, kw):
    cfg = JaxConfig(**SOLVE, **kw)
    return jax.jit(functools.partial(jax_solve_batched, cfg=cfg))(ob)


@pytest.mark.parametrize("way", sorted(ROUTES))
def test_route_at_twelve_robots_matches_the_reference(way):
    ob = batch()
    cfg = ALILQRConfig(**SOLVE, **ROUTES[way])
    t = port_ocp(ob)
    assert route(t, cfg) == way and rollout.unsupported(t) is None
    cuda_build.reset_launch_counts()
    tr = solve_batched(t, cfg=cfg)
    assert not any(cuda_build.launch_counts.values())   # the plain versions on the CPU
    jr = reference(ob, ROUTES[way])
    np.testing.assert_allclose(tr.cost.numpy(), np.asarray(jr.cost), rtol=1e-4)
    np.testing.assert_allclose(tr.U.numpy(), np.asarray(jr.U), atol=5e-3)
    np.testing.assert_array_equal(tr.converged.numpy(), np.asarray(jr.converged))
    assert np.abs(tr.outer_iters.numpy() - np.asarray(jr.outer_iters)).max() <= 1
    assert np.abs(tr.inner_iters.numpy() - np.asarray(jr.inner_iters)).max() <= 2
    np.testing.assert_allclose(tr.viol.numpy(), np.asarray(jr.viol), atol=1e-4)
    assert tr.U.shape == (B, N, 2 * M) and torch.isfinite(tr.X).all()


def test_riccati_plain_past_the_team_shapes_matches_the_pallas_kernel():
    """K3's plain version at (41, 7), a stage shape past (30, 20) (the block
    design's on the card), against riccati_pallas.py::riccati_fused in
    interpret mode, N=3 on one 128-lane tile (the reference's wrapper takes
    multiples of 128; at m=12's (36, 24) its interpret mode takes ~40 s a
    stage, and the route tests above run it there): general dense blocks of
    tests/test_torch_staged_tiles.py's kind."""
    from test_torch_staged_tiles import _riccati_inputs

    exp = _riccati_inputs((41, 7), 128, 3, seed=41)
    kr, Kr, dr = jax_riccati(*[jnp.asarray(np.moveaxis(t.numpy(), -1, 0)) for t in exp],
                             interpret=True)
    kff, Kfb, dV1 = riccati_plain(exp, 1e-6)
    np.testing.assert_allclose(np.moveaxis(kff.numpy(), -1, 0), np.asarray(kr), atol=5e-5)
    np.testing.assert_allclose(np.moveaxis(Kfb.numpy(), -1, 0), np.asarray(Kr), atol=5e-5)
    np.testing.assert_allclose(dV1.numpy(), np.asarray(dr), rtol=1e-5, atol=5e-4)
