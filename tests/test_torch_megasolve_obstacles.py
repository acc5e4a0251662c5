"""The plain versions of K1 and K2 with static- and moving-obstacle rows
against the JAX Pallas kernels they replace (inner_solve_fused,
al_update_lanes, run in interpret mode on the lane layout, as the
reference's own CPU tests run them), and solve_batched on a moving-obstacle
batch against the reference's solve_batched, which runs its megakernel
there. The problems are those of tests/obstacle_cases.py.

Tolerances:
  * K2: lam and viol at rtol 1e-5; lam also at atol 1e-6 per 10 of mu (the
    reference's XLA may contract dx^2 + dy^2 into an FMA, which moves c by
    an f32 ulp, and lam - mu c multiplies it by mu).
  * K1: cost rtol 1e-4, U atol 5e-3 (the tolerances of
    tests/test_batched_solver.py: merits summed in another order can flip a
    near-tied alpha pick), inner-iteration counts equal.
  * solve_batched: cost rtol 1e-4, U atol 5e-3.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import obstacle_cases as OC
from nmpc_tpu.ocp import problem as JP
from nmpc_tpu.ops.megasolve_pallas import al_update_lanes as jax_al_update
from nmpc_tpu.ops.megasolve_pallas import inner_solve_fused as jax_inner_solve
from nmpc_tpu.ops.riccati_pallas import _from_lane, _to_lane
from nmpc_tpu.scenarios import get as jax_get
from nmpc_tpu.solver.alilqr import ALILQRConfig as JaxConfig
from nmpc_tpu.solver.alilqr_batched import solve_batched as jax_solve_batched
from nmpc_tpu_torch.ocp import problem as TP
from nmpc_tpu_torch.ops import megasolve
from nmpc_tpu_torch.solver import ALILQRConfig, solve_batched

B = 16
LANES = 128


@pytest.fixture(autouse=True)
def _one_thread():
    # small ops: more intra-op threads only spin
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def port_ocp(o):
    data = {f.name: np.asarray(getattr(o, f.name))
            for f in dataclasses.fields(o) if f.name not in JP.OCP_META}
    return TP.ocp_from_numpy(data, device="cpu", **{k: getattr(o, k) for k in JP.OCP_META})


def jax_case(name: str, nb: int, seed: int):
    """The reference's batched OCP of a case and the case's numpy draws."""
    kw = OC.base_kwargs(name)
    if kw:
        base = JP.make_ocp(**kw, mov_obs=jnp.zeros((kw["N"], 2, 2), jnp.float32))
    else:
        base = jax_get(name).make(N=10)
    d = OC.draws(name, base, nb, seed)
    ob = dataclasses.replace(base, x0=jnp.asarray(d["x0"]), xref=jnp.asarray(d["xref"]))
    if d["mov"] is not None:
        ob = dataclasses.replace(ob, mov_obs=jnp.asarray(d["mov"]))
    return ob, d


def _pad(a):
    """[B, ...] -> [128, ...], the last scenario repeated (the reference's
    own padding to its lane tile)."""
    a = np.asarray(a)
    return np.concatenate([a, np.repeat(a[-1:], LANES - a.shape[0], 0)])


def _lane(a, *trail):
    return _to_lane(jnp.asarray(_pad(a)).reshape(LANES, *trail), 1)


def _back(a_l):
    return np.asarray(_from_lane(a_l, LANES))[:B]


def _mov_l(ob):
    return _lane(np.asarray(ob.mov_obs).reshape(B, ob.N, 2 * ob.n_mov), ob.N, 2 * ob.n_mov)


@pytest.mark.parametrize("name", OC.CASES)
def test_al_update_plain_matches_pallas_kernel(name):
    ob, d = jax_case(name, B, seed=3)
    rng = np.random.default_rng(4)
    # states around the starts, where obstacle, pair and box rows are active
    Xs = (d["x0"][:, None] + 0.2 * rng.standard_normal((B, ob.N, ob.nx))).astype(np.float32)
    U = (0.2 * rng.standard_normal((B, ob.N, ob.nu))).astype(np.float32)
    lam, mu = d["lam"], d["mu"]
    lam_l, viol_l = jax_al_update(
        ob, _lane(Xs, ob.N, ob.nx), _lane(U, ob.N, ob.nu), _lane(lam, ob.N, ob.n_con),
        _lane(mu, 1), lam_max=1e6, mov_l=_mov_l(ob) if ob.n_mov else None, interpret=True)
    want_lam = _back(lam_l)
    want_viol = _back(viol_l[:, None])[:, 0, 0]

    got_lam, got_viol = megasolve.al_update_plain(
        port_ocp(ob), _t(Xs), _t(U), _t(lam), _t(mu), 1e6)
    atol = 1e-6 * np.maximum(1.0, mu / 10.0)[:, None, None]
    err = np.abs(got_lam.numpy() - want_lam)
    assert np.all(err <= atol + 1e-5 * np.abs(want_lam)), float(err.max())
    np.testing.assert_allclose(got_viol.numpy(), want_viol, rtol=1e-5, atol=1e-7)
    # the obstacle rows are active on some scenarios
    rows = slice(ob.n_pairs, ob.n_pairs + ob.m * (ob.n_obs + ob.n_mov))
    assert (want_lam[:, 1:, rows] > 0).mean() > 0.01


@pytest.mark.parametrize("ls", ["adaptive", "cascade"])
@pytest.mark.parametrize("name", OC.CASES)
def test_inner_solve_plain_matches_pallas_megakernel(name, ls):
    ob, d = jax_case(name, B, seed=1)
    kw = dict(n_outer=6, n_inner=4, tol_con=1e-3, ls=ls)
    Xs_l, U_l, cost_l, iters_l = jax_inner_solve(
        ob, _lane(d["x0"], 1, ob.nx), _lane(d["xref"], ob.N, ob.nx),
        _lane(d["lam"], ob.N, ob.n_con), _lane(d["mu"], 1), _lane(d["U"], ob.N, ob.nu),
        JaxConfig(**kw), mov_l=_mov_l(ob) if ob.n_mov else None, interpret=True)
    want_U, want_X = _back(U_l), _back(Xs_l)
    want_cost = _back(cost_l[:, None])[:, 0, 0]
    want_iters = _back(iters_l[:, None])[:, 0, 0].astype(np.int32)

    o = port_ocp(ob)
    Xs, Uo, cost, iters = megasolve.inner_solve_plain(
        o, o.x0, o.xref, _t(d["lam"]), _t(d["mu"]), _t(d["U"]), ALILQRConfig(**kw))
    np.testing.assert_allclose(cost.numpy(), want_cost, rtol=1e-4)
    np.testing.assert_allclose(Uo.numpy(), want_U, atol=5e-3)
    np.testing.assert_allclose(Xs.numpy(), want_X, atol=5e-3)
    np.testing.assert_array_equal(iters.numpy(), want_iters)
    assert want_iters.max() >= 2  # the solve really iterated


def _double(o):
    return dataclasses.replace(o, **{
        f.name: getattr(o, f.name).double() for f in dataclasses.fields(o)
        if isinstance(getattr(o, f.name), torch.Tensor) and getattr(o, f.name).is_floating_point()})


@pytest.mark.parametrize("name", OC.CASES)
def test_warp_order_merit_sums_the_terms_of_al_merit(name):
    """`al_merit_warp_order` (K1's summation order) against `al_merit`: in
    f32 within a few ulps of the sum, in f64 (where the order leaves
    nothing to see) to 1e-12."""
    ob, U, lam, mu = OC.port_case(name, B, seed=2)
    X = TP.rollout(ob, U)
    np.testing.assert_allclose(megasolve.al_merit_warp_order(ob, X, U, lam, mu).numpy(),
                               megasolve.al_merit(ob, X, U, lam, mu).numpy(), rtol=2e-6)
    o64, U64, lam64, mu64 = _double(ob), U.double(), lam.double(), mu.double()
    X64 = TP.rollout(o64, U64)
    np.testing.assert_allclose(megasolve.al_merit_warp_order(o64, X64, U64, lam64, mu64).numpy(),
                               megasolve.al_merit(o64, X64, U64, lam64, mu64).numpy(), rtol=1e-12)


@pytest.mark.parametrize("name", OC.CASES)
def test_inner_solve_plain_in_warp_order_matches_pallas_megakernel(name):
    """The plain K1 with the merit summed in K1's order, against the
    reference's megakernel at the tolerances of the default order."""
    ob, d = jax_case(name, B, seed=1)
    kw = dict(n_outer=6, n_inner=4, tol_con=1e-3, ls="adaptive")
    Xs_l, U_l, cost_l, iters_l = jax_inner_solve(
        ob, _lane(d["x0"], 1, ob.nx), _lane(d["xref"], ob.N, ob.nx),
        _lane(d["lam"], ob.N, ob.n_con), _lane(d["mu"], 1), _lane(d["U"], ob.N, ob.nu),
        JaxConfig(**kw), mov_l=_mov_l(ob) if ob.n_mov else None, interpret=True)
    o = port_ocp(ob)
    Xs, Uo, cost, iters = megasolve.inner_solve_plain(
        o, o.x0, o.xref, _t(d["lam"]), _t(d["mu"]), _t(d["U"]), ALILQRConfig(**kw),
        merit=megasolve.al_merit_warp_order)
    np.testing.assert_allclose(cost.numpy(), _back(cost_l[:, None])[:, 0, 0], rtol=1e-4)
    np.testing.assert_allclose(Uo.numpy(), _back(U_l), atol=5e-3)
    np.testing.assert_allclose(Xs.numpy(), _back(Xs_l), atol=5e-3)
    np.testing.assert_array_equal(iters.numpy(), _back(iters_l[:, None])[:, 0, 0].astype(np.int32))


def test_solve_batched_with_moving_obstacles_matches_reference():
    """The moving-obstacle batch of tests/test_batched_solver.py (one slot
    parked on the line to the goal, per-scenario schedules): the port's
    solve_batched, which now takes the megakernel route (K1 and K2; their
    plain versions on the CPU), against the reference's megakernel."""
    cfg_kw = dict(n_outer=8, n_inner=15, tol_con=1e-4)
    ob, _ = jax_case("robot_template", 3, seed=2)
    want = jax.jit(functools.partial(jax_solve_batched, cfg=JaxConfig(**cfg_kw)))(ob)
    got = solve_batched(port_ocp(ob), cfg=ALILQRConfig(**cfg_kw))
    np.testing.assert_allclose(got.cost.numpy(), np.asarray(want.cost), rtol=1e-4)
    np.testing.assert_allclose(got.U.numpy(), np.asarray(want.U), atol=5e-3)
    assert float(got.viol.max()) < 1e-3
    # the parked slot shaped the solution: clearance at stages 1..N-1
    mov = np.asarray(ob.mov_obs)
    dist = np.sqrt(np.sum((got.X.numpy()[:, 1:-1, :2] - mov[:, 1:, 0, :]) ** 2, -1))
    assert dist.min() > 0.3 - 1e-2
