"""The staged route (mega=False) at seven robots against the reference's own
staged route: whether its low converged share on the card (0.7078 at m = 7,
B = 4096, the bench config) is the reference's staged semantics or a fault
of the port.

The problem is scenarios/robot_counts.py's antipodal circle at m=7, N=10,
built by the reference's make_ocp and carried to the port by
ocp_from_numpy; B=8 starts jittered by bench.SPREAD N(0, 1), made with
numpy from a seed; the bench config (n_outer=6, n_inner=12, tol_con=1e-3,
ls="adaptive"). The reference runs as its own tests run it on the CPU (its
Pallas kernels in interpret mode under jax.jit, ~45 s here), the port on
the plain versions of its kernels (~10 s). Both converge the same half of
the batch: the same scenarios converge, their costs agree to 1e-4, the outer
counts within one and the inner counts within two (the staged route's stop
rule and line-search ties decide at the f32 rounding level near
convergence, tests/test_torch_solve_lanes.py)."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nmpc_tpu.ocp import problem as JP
from nmpc_tpu.parallel.batch import batch_ocp as jax_batch_ocp
from nmpc_tpu.solver.alilqr import ALILQRConfig as JaxConfig
from nmpc_tpu.solver.alilqr_batched import solve_batched as jax_solve_batched
from nmpc_tpu_torch.bench import SPREAD
from nmpc_tpu_torch.ocp import problem as TP
from nmpc_tpu_torch.ops import cuda_build
from nmpc_tpu_torch.scenarios import robot_counts
from nmpc_tpu_torch.solver import ALILQRConfig
from nmpc_tpu_torch.solver.alilqr_batched import route, solve_batched

M, N, B = 7, 10, 8
BENCH = dict(n_outer=6, n_inner=12, tol_con=1e-3, ls="adaptive", mega=False)


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


def test_staged_route_at_seven_robots_converges_as_the_reference():
    base = JP.make_ocp(**robot_counts.circle(M, N=N))
    rng = np.random.default_rng(7)
    x0 = (np.asarray(base.x0)[None] + SPREAD * rng.standard_normal((B, base.nx)))
    ob = jax_batch_ocp(base, jnp.asarray(x0.astype(np.float32)))
    jr = jax.jit(functools.partial(jax_solve_batched, cfg=JaxConfig(**BENCH)))(ob)
    t = port_ocp(ob)
    cfg = ALILQRConfig(**BENCH)
    assert route(t, cfg) == "staged"
    cuda_build.reset_launch_counts()
    tr = solve_batched(t, cfg=cfg)
    assert not any(cuda_build.launch_counts.values())   # the plain versions on the CPU
    conv = np.asarray(jr.converged)
    np.testing.assert_array_equal(tr.converged.numpy(), conv)
    assert 0.0 < conv.mean() < 1.0   # neither route converges the whole batch
    np.testing.assert_allclose(tr.cost.numpy(), np.asarray(jr.cost), rtol=1e-4)
    np.testing.assert_allclose(tr.viol.numpy(), np.asarray(jr.viol), atol=1e-4)
    assert np.abs(tr.outer_iters.numpy() - np.asarray(jr.outer_iters)).max() <= 1
    assert np.abs(tr.inner_iters.numpy() - np.asarray(jr.inner_iters)).max() <= 2
    assert torch.isfinite(tr.X).all() and tr.U.shape == (B, N, 2 * M)
