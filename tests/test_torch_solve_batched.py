"""The port's batched main path (nmpc_tpu_torch.solver.alilqr_batched) against
the reference nmpc_tpu.solver.alilqr_batched.solve_batched, whose kernels run
in interpret mode on the CPU. Inputs are made with numpy from a seed and
handed to both packages.

Tolerances are those of tests/test_batched_solver.py: cost rtol 1e-4 and U
atol 5e-3 element by element (merits summed in another order can flip
near-tied alpha picks), and at B=128 the aggregates of its adaptive-vs-
cascade test (convergence rate within 1/128, max violation within 1e-4,
mean cost within 0.1%). One exception: on the six-robot swap, U is held at
atol 5e-2. Its converged controls sit in a flat valley of the cost, and f32
paths that stop an iteration apart land at different points of it: on the
batch below the costs agree to 5e-7 but U differs by up to 1.6e-2, and the
reference's own per-scenario and batched engines differ there by up to
4.1e-2 in U (and 2.3e-3 in cost).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nmpc_tpu.ocp import problem as JP
from nmpc_tpu.parallel.batch import batch_ocp as jax_batch_ocp
from nmpc_tpu.scenarios import get as jax_get
from nmpc_tpu.solver.alilqr import ALILQRConfig as JaxConfig
from nmpc_tpu.solver.alilqr import WarmStart as JaxWarm
from nmpc_tpu.solver.alilqr_batched import solve_batched as jax_solve_batched
from nmpc_tpu_torch.ocp import problem as TP
from nmpc_tpu_torch.ops import cuda_build
from nmpc_tpu_torch.parallel import batch_ocp
from nmpc_tpu_torch.solver.alilqr import ALILQRConfig, warm_from_numpy
from nmpc_tpu_torch.solver.alilqr_batched import solve_batched, solve_one

CFG = dict(n_outer=8, n_inner=15, tol_con=1e-4)                    # test_batched_solver.py:16
BENCH = dict(n_outer=6, n_inner=12, tol_con=1e-3, ls="adaptive")   # bench.py


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs six workers on the CPU's cores,
    where more threads a worker only wait on each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def port_ocp(o):
    data = {f.name: np.asarray(getattr(o, f.name))
            for f in dataclasses.fields(o) if f.name not in JP.OCP_META}
    return TP.ocp_from_numpy(data, device="cpu", **{k: getattr(o, k) for k in JP.OCP_META})


def _batch(name, B, spread, seed, N=10):
    base = jax_get(name).make(N=N)
    rng = np.random.default_rng(seed)
    x0 = (np.asarray(base.x0)[None]
          + spread * rng.standard_normal((B, base.nx))).astype(np.float32)
    return jax_batch_ocp(base, jnp.asarray(x0))


def _both(ob, cfg_kw, warm=None):
    jr = jax.jit(functools.partial(jax_solve_batched, cfg=JaxConfig(**cfg_kw)))(
        ob, None if warm is None else JaxWarm(*(jnp.asarray(a) for a in warm)))
    tr = solve_batched(port_ocp(ob), None if warm is None else warm_from_numpy(*warm, device="cpu"),
                       ALILQRConfig(**cfg_kw))
    return jr, tr


def _close(jr, tr, u_atol=5e-3):
    np.testing.assert_allclose(tr.cost.numpy(), np.asarray(jr.cost), rtol=1e-4)
    np.testing.assert_allclose(tr.U.numpy(), np.asarray(jr.U), atol=u_atol)
    np.testing.assert_array_equal(tr.converged.numpy(), np.asarray(jr.converged))
    np.testing.assert_array_equal(tr.outer_iters.numpy(), np.asarray(jr.outer_iters))


def test_two_robot_swap_matches_reference():
    jr, tr = _both(_batch("two_robot_swap", 4, 0.05, seed=0), CFG)
    _close(jr, tr)
    assert bool(tr.converged.all())
    assert tr.X.shape == (4, 11, 6) and tr.lam.shape == (4, 10, 21)


def test_six_robot_bench_config_matches_reference():
    jr, tr = _both(_batch("six_robot_antipodal", 8, 0.1, seed=1), BENCH)
    _close(jr, tr, u_atol=5e-2)
    np.testing.assert_allclose(tr.viol.numpy(), np.asarray(jr.viol), atol=1e-4)


def test_six_robot_bench_config_aggregates_at_b128():
    jr, tr = _both(_batch("six_robot_antipodal", 128, 0.1, seed=2), BENCH)
    conv_j, conv_t = float(jr.converged.mean()), float(tr.converged.float().mean())
    assert abs(conv_t - conv_j) <= 1.0 / 128 + 1e-9
    assert abs(float(tr.viol.max()) - float(jr.viol.max())) <= 1e-4
    assert abs(float(tr.cost.mean()) / float(jr.cost.mean()) - 1.0) <= 1e-3
    assert conv_t >= 0.9


def test_unpadded_batch_of_three():
    # the reference pads B=3 to a 128-lane tile; the port does not pad
    ob = _batch("two_robot_swap", 3, 0.05, seed=3)
    jr, tr = _both(ob, CFG)
    assert tr.U.shape == (3, 10, 4) and tr.inner_iters.shape == (3,)
    _close(jr, tr)


def test_solve_one_matches_reference():
    from nmpc_tpu.solver.alilqr_batched import solve_one as jax_solve_one

    ref = jax_get("two_robot_swap").make(N=12)
    jr = jax.jit(functools.partial(jax_solve_one, cfg=JaxConfig(**CFG)))(ref)
    tr = solve_one(port_ocp(ref), cfg=ALILQRConfig(**CFG))
    assert tr.U.shape == (12, 4) and tr.cost.shape == ()
    np.testing.assert_allclose(float(tr.cost), float(jr.cost), rtol=1e-4)
    np.testing.assert_allclose(tr.U.numpy(), np.asarray(jr.U), atol=5e-3)
    assert bool(tr.converged) and bool(jr.converged)
    assert int(tr.outer_iters) == int(jr.outer_iters)


def test_warm_started_element_needs_fewer_inner_iterations():
    """An element warm-started at its own solution records strictly fewer
    inner iterations than the cold elements of the same batch, as in the
    reference (tests/test_batched_solver.py:155-180)."""
    ob = _batch("two_robot_swap", 3, 0.05, seed=4)
    o = port_ocp(ob)
    cfg = ALILQRConfig(**CFG)
    r1 = solve_batched(o, cfg=cfg)
    assert int(r1.inner_iters.min()) >= 1
    warm = (np.stack([r1.U[0].numpy(), np.zeros((10, 4), np.float32),
                      np.zeros((10, 4), np.float32)]),
            np.stack([r1.lam[0].numpy(), np.zeros((10, 21), np.float32),
                      np.zeros((10, 21), np.float32)]),
            np.array([float(r1.mu[0]), cfg.mu_init, cfg.mu_init], np.float32))
    jr, tr = _both(ob, CFG, warm)
    assert int(tr.inner_iters[0]) < int(tr.inner_iters[1])
    assert int(tr.inner_iters[0]) < int(tr.inner_iters[2])
    np.testing.assert_array_equal(tr.outer_iters.numpy(), np.asarray(jr.outer_iters))
    np.testing.assert_allclose(tr.cost.numpy(), np.asarray(jr.cost), rtol=1e-4)


def test_cpu_main_path_launches_no_kernel():
    cuda_build.reset_launch_counts()
    ob = port_ocp(_batch("two_robot_swap", 2, 0.05, seed=5))
    res = solve_batched(ob, cfg=ALILQRConfig(n_outer=2, n_inner=3))
    assert torch.isfinite(res.cost).all()
    assert cuda_build.launch_counts == {
        "inner_solve_fused": 0, "al_update_lanes": 0, "expansions_fused": 0,
        "riccati_lanes": 0, "linesearch_costs_lanes": 0, "rollout_alpha_lanes": 0,
        "fma_peak": 0, "phase_ablation": 0, "expansion_ab": 0}


def test_unported_options_raise():
    """compact, sweep='scan' and cold_seed='polar' are ported
    (tests/test_torch_hybrid.py); so are user dynamics (dyn_fn): a generic
    problem solves on the hybrid route (tests/test_torch_generic.py holds it
    against the reference). A setting no route knows raises ValueError."""
    ob = port_ocp(_batch("two_robot_swap", 2, 0.05, seed=6))
    gen = TP.make_generic_ocp(lambda x, u: -x + u, nx=1, nu=1, N=5, T=0.1, x0=[1.0],
                              u_lo=[-1.0], u_hi=[1.0], integrator="euler", device="cpu")
    res = solve_batched(batch_ocp(gen, torch.tensor([[1.0], [0.5]])),
                        cfg=ALILQRConfig(n_outer=2, n_inner=5))
    assert res.U.shape == (2, 5, 1) and torch.isfinite(res.cost).all()
    assert bool(res.converged.all()) and float(res.cost[1]) < float(res.cost[0])
    for kw in (dict(sweep="dense"), dict(cold_seed="random"), dict(ls="exact")):
        with pytest.raises(ValueError):
            solve_batched(ob, cfg=ALILQRConfig(**kw))
