"""The port's closed-loop fleet (nmpc_tpu_torch.tools.fleet_loop) against
the step of tools/bench_fleet_loop.py on the reference, on the same numpy
starts."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nmpc_tpu.mpc.driver import shift_warm as jax_shift
from nmpc_tpu.parallel.batch import batch_ocp as jax_batch_ocp
from nmpc_tpu.scenarios import get as jax_get
from nmpc_tpu.sim.plant import PlantConfig as JaxPlant
from nmpc_tpu.sim.plant import plant_step as jax_plant_step
from nmpc_tpu.solver.alilqr import ALILQRConfig as JaxConfig
from nmpc_tpu.solver.alilqr_batched import solve_batched as jax_solve_batched
from nmpc_tpu_torch.tools import fleet_loop as FL

from test_torch_driver import port_ocp


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Eager loops of small ops: one intra-op thread (more only spin)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_fleet_loop_matches_reference():
    """nmpc_tpu_torch.tools.fleet_loop's seed and chunk against the step of
    tools/bench_fleet_loop.py on the reference (seed solve, then K warm
    solve_batched -> first control -> plant -> shift with mu carried), at
    B=4, K=3 on two_robot_swap N=10 (the megakernel route's plain versions
    here): states atol 5e-3, mu equal, the chunk's aggregates. The carried
    plans are not held: ten iterations at the carried mu leave their tails
    path-dependent (up to 0.06 apart after 3 steps). One difference on purpose: the reference tool calls
    shift_warm on the batched result, which shifts along its first axis,
    the batch (scenario i is warm-started with scenario i+1's unshifted
    plan); the port shifts each scenario's plan in time, as the reference's
    closed loops do. The reference step below shifts per scenario."""
    base = jax_get("two_robot_swap").make(N=10)
    rng = np.random.default_rng(3)
    x0s = (np.asarray(base.x0)[None] + 0.1 * rng.standard_normal((4, base.nx))).astype(np.float32)
    jseed, jrt = (JaxConfig(**dataclasses.asdict(c)) for c in (FL.SEED_CFG, FL.RT_CFG))
    shift = jax.vmap(lambda r: jax_shift(r, jrt, mu_reset=False))
    ob = jax_batch_ocp(base, jnp.asarray(x0s))
    w = shift(jax.jit(functools.partial(jax_solve_batched, cfg=jseed))(ob))
    x, viols, iters = jnp.asarray(x0s), [], []
    step = jax.jit(lambda o, w: jax_solve_batched(o, w, jrt))
    for _ in range(3):
        res = step(dataclasses.replace(ob, x0=x), w)
        x, _ = jax.vmap(lambda a, b: jax_plant_step(a, b, base.T, JaxPlant()))(x, res.U[:, 0])
        w = shift(res)
        viols.append(float(res.viol.max()))
        iters.append(float(res.inner_iters.mean()))
    tbase = port_ocp(base)
    tx0 = torch.tensor(x0s)
    out = FL.chunk(tbase, tx0, FL.seed(tbase, tx0), 3)
    np.testing.assert_allclose(out.x.numpy(), np.asarray(x), atol=5e-3)
    np.testing.assert_array_equal(out.warm.mu.numpy(), np.asarray(w.mu))
    assert abs(float(out.max_viol) - max(viols)) <= 1e-4
    assert abs(float(out.mean_iters) - np.mean(iters)) <= 0.5
    assert 0 < float(out.min_dist) <= float(torch.sqrt(((tx0[:, :2] - tx0[:, 3:5]) ** 2).sum(-1)).min())
