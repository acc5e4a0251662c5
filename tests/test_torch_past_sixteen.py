"""Robot counts past the megakernel's sixteen, on the CPU against the JAX
package: the route, the staged route's solves and K3's plain version at
stage shapes past nu = 32. On the card these run K3's register-tile design and K4-K6
on their smaller tiles (chip_smoke.py phase 40,
tests/test_torch_cuda.py); here the plain versions, which the host
rehearsal (tests/test_torch_staged_wide_host.py) and the card hold the
kernels to. The problems are nmpc_tpu_torch/scenarios/robot_counts.py's
(the antipodal circle, ten_robot's crossing widened by columns), built by
the reference's make_ocp and carried to the port by ocp_from_numpy.

* `route` is the reference's rule (alilqr_batched.py:492-500) at m = 17,
  18, 20, 24 and 32 (the pair-only circle at N = 1, 2, 3, 4 and 10), but
  where the reference's TPU VMEM estimate `mega_fits` still admits the
  megakernel route: m = 17 at N <= 3 and m = 18 at N = 1. K1 and K2 stop at
  sixteen robots on the card, so the port takes the staged route there (the
  recorded divergence, ROADMAP Queue 3; the mirror of m = 14-16 at N=10,
  tests/test_torch_robot_counts.py).
* The port's staged route (mega=False) at m = 18 and 20 (the crossing,
  N=3, B=4, starts jittered by 0.01 N(0, 1) from a numpy seed, n_outer=2,
  n_inner=4) against the reference's per-scenario XLA `solve`, vmapped, as
  test_solve_batched_matches_the_reference_solve holds the megakernel route
  at m = 16: by cost (rtol 1e-4), violation (atol 1e-4), convergence and
  the mean control gap (below 1e-3), since the staged route counts its
  inner iterations its own way and its stop rule decides at the f32
  rounding level near convergence.
* K3's plain version `riccati_plain` at (96, 64) (m = 32's stage) and
  (150, 100) against the recursion of the JAX package's own plain
  reference (tests/test_ops.py:61-77, `ref_one`: jnp.linalg.solve of the
  regularised Quu, the value Hessian symmetrised), vmapped over the batch,
  at atol 5e-5 as the (41, 7) case of tests/test_torch_staged_wide.py. The
  reference's Pallas K3 in interpret mode takes ~40 s a stage at m = 12's
  (36, 24) and is not run at these shapes.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nmpc_tpu.ocp import problem as JP
from nmpc_tpu.ops.megasolve_pallas import mega_fits as jax_mega_fits
from nmpc_tpu.ops.rollout_pallas import supports as jax_supports
from nmpc_tpu.solver.alilqr import ALILQRConfig as JaxConfig
from nmpc_tpu.solver.alilqr import solve as jax_solve
from nmpc_tpu.solver.alilqr_batched import _resolve_sweep
from nmpc_tpu_torch.ocp import problem as TP
from nmpc_tpu_torch.ops import megasolve
from nmpc_tpu_torch.ops.riccati import riccati_plain
from nmpc_tpu_torch.parallel import batch_ocp
from nmpc_tpu_torch.scenarios import robot_counts
from nmpc_tpu_torch.solver import ALILQRConfig
from nmpc_tpu_torch.solver.alilqr_batched import route, solve_batched
from test_torch_staged_tiles import _riccati_inputs

CONFIGS = {"default": {}, "staged": {"mega": False}, "scan": {"sweep": "scan"}}
SOLVE = dict(n_outer=2, n_inner=4)
# (m, N) where the reference's megakernel route admits the problem and the
# port's K1 does not
DIVERGENCE = {(17, 1), (17, 2), (17, 3), (18, 1)}


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


def reference_route(o, cfg) -> str:
    """The reference's route (alilqr_batched.py:492-500)."""
    if jax_supports(o) and _resolve_sweep(cfg, o.N, 1) != "scan":
        return "mega" if cfg.mega and jax_mega_fits(o) else "staged"
    return "hybrid"


@pytest.mark.parametrize("m", [17, 18, 20, 24, 32])
def test_route_past_sixteen_robots(m):
    """The reference's route at every (m, N), but at DIVERGENCE: there the
    reference takes the megakernel route and the port the staged one, whose
    kernels take any m; K1 and K2 refuse every m here."""
    for N in (1, 2, 3, 4, 10):
        o = JP.make_ocp(**robot_counts.circle(m, N=N))
        t = port_ocp(o)
        assert not megasolve.mega_fits(t) and "m=" in megasolve.cuda_unsupported(t)
        for what, kw in CONFIGS.items():
            want = reference_route(o, JaxConfig(**kw))
            got = route(t, ALILQRConfig(**kw))
            if (m, N) in DIVERGENCE and what == "default":
                assert (got, want) == ("staged", "mega"), (m, N)
            else:
                assert got == want, (m, N, what)


@pytest.mark.parametrize("m", [18, 20])
def test_staged_route_matches_the_reference_solve(m):
    o = JP.make_ocp(**robot_counts.crossing(m, N=3))
    t = port_ocp(o)
    rng = np.random.default_rng(m)
    x0 = (np.asarray(o.x0)[None] + 0.01 * rng.standard_normal((4, o.nx))).astype(np.float32)
    jr = jax.jit(jax.vmap(lambda x: jax_solve(dataclasses.replace(o, x0=x),
                                              cfg=JaxConfig(**SOLVE))))(jnp.asarray(x0))
    ob = batch_ocp(t, torch.from_numpy(x0))
    cfg = ALILQRConfig(**SOLVE, mega=False)
    assert route(ob, cfg) == "staged"
    tr = solve_batched(ob, cfg=cfg)
    np.testing.assert_allclose(tr.cost.numpy(), np.asarray(jr.cost), rtol=1e-4)
    np.testing.assert_allclose(tr.viol.numpy(), np.asarray(jr.viol), atol=1e-4)
    np.testing.assert_array_equal(tr.converged.numpy(), np.asarray(jr.converged))
    assert float(np.abs(tr.U.numpy() - np.asarray(jr.U)).mean()) < 1e-3
    assert tr.U.shape == (4, 3, 2 * m) and torch.isfinite(tr.X).all()


def _ref_one(nu):
    """tests/test_ops.py:61-77's recursion for one scenario."""
    def ref_one(A, Bm, lx, lu, lxx, luu, lux, reg=1e-6):
        n = A.shape[-1]

        def body(carry, inp):
            Vx, Vxx, dV1 = carry
            A_k, B_k, lx_k, lu_k, lxx_k, luu_k, lux_k = inp
            Qu = lu_k + B_k.T @ Vx
            Qux = lux_k + B_k.T @ Vxx @ A_k
            Quu = luu_k + B_k.T @ Vxx @ B_k + reg * jnp.eye(nu)
            kff = -jnp.linalg.solve(Quu, Qu)
            Kfb = -jnp.linalg.solve(Quu, Qux)
            Vx_n = lx_k + A_k.T @ Vx + Qux.T @ kff
            Vxx_n = lxx_k + A_k.T @ Vxx @ A_k + Qux.T @ Kfb
            return (Vx_n, 0.5 * (Vxx_n + Vxx_n.T), dV1 + kff @ Qu), (kff, Kfb)

        (_, _, dV1), (kf, Kf) = jax.lax.scan(
            body, (jnp.zeros(n), jnp.zeros((n, n)), 0.0),
            (A, Bm, lx, lu, lxx, luu, lux), reverse=True)
        return kf, Kf, dV1
    return ref_one


@pytest.mark.parametrize("shape", [(96, 64), (150, 100)])
def test_riccati_plain_past_nu_32_matches_the_reference_recursion(shape):
    exp = _riccati_inputs(shape, 4, 3, seed=sum(shape))
    kr, Kr, dr = jax.jit(jax.vmap(_ref_one(shape[1])))(
        *[jnp.asarray(np.moveaxis(t.numpy(), -1, 0)) for t in exp])
    kff, Kfb, dV1 = riccati_plain(exp, 1e-6)
    np.testing.assert_allclose(np.moveaxis(kff.numpy(), -1, 0), np.asarray(kr), atol=5e-5)
    np.testing.assert_allclose(np.moveaxis(Kfb.numpy(), -1, 0), np.asarray(Kr), atol=5e-5)
    np.testing.assert_allclose(dV1.numpy(), np.asarray(dr), rtol=1e-5, atol=5e-4)
