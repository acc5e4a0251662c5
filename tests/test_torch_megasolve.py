"""The plain versions of the port's two main-path kernels against the JAX
Pallas kernels they replace (run in interpret mode, as the reference's own
CPU tests run them), plus the CUDA wrappers' admission rule and launch
counters.

Inputs are made with numpy from a seed and handed to both packages.
Tolerances:
  * K2 (al_update): lam and viol at rtol 1e-6 / atol 1e-6 — elementwise
    math in the same order (atol scaled with mu at large mu, see the test).
  * K1 (inner solve): cost rtol 1e-4 and U atol 5e-3 (the tolerances of
    tests/test_batched_solver.py: merits summed in a different order can
    flip near-tied alpha picks), inner-iteration counts equal on at least
    126 of 128 scenarios.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nmpc_tpu.ocp import problem as JP
from nmpc_tpu.ops.megasolve_pallas import al_update_lanes as jax_al_update
from nmpc_tpu.ops.megasolve_pallas import inner_solve_fused as jax_inner_solve
from nmpc_tpu.ops.riccati_pallas import _from_lane, _to_lane
from nmpc_tpu.parallel.batch import batch_ocp as jax_batch_ocp
from nmpc_tpu.scenarios import get as jax_get
from nmpc_tpu.solver.alilqr import ALILQRConfig as JaxConfig
from nmpc_tpu_torch.ocp import problem as TP
from nmpc_tpu_torch.ops import cuda_build, megasolve
from nmpc_tpu_torch.parallel import batch_ocp
from nmpc_tpu_torch.scenarios import get
from nmpc_tpu_torch.solver.alilqr import ALILQRConfig
from nmpc_tpu_torch.tools.k1_launch import SCENARIOS
from nmpc_tpu_torch.tools.roofline import k1_executed

B = 128


def port_ocp(o):
    data = {f.name: np.asarray(getattr(o, f.name))
            for f in dataclasses.fields(o) if f.name not in JP.OCP_META}
    return TP.ocp_from_numpy(data, device="cpu", **{k: getattr(o, k) for k in JP.OCP_META})


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _problem(name, seed):
    """A batched reference OCP and a warm state (U, lam, mu) mid-solve:
    nonnegative duals with the masked stage-0 rows at zero, as the AL update
    leaves them."""
    rng = np.random.default_rng(seed)
    base = jax_get(name).make(N=10)
    x0 = (np.asarray(base.x0)[None]
          + 0.1 * rng.standard_normal((B, base.nx))).astype(np.float32)
    ob = jax_batch_ocp(base, jnp.asarray(x0))
    U = (0.05 * rng.standard_normal((B, base.N, base.nu))).astype(np.float32)
    lam = (0.5 * np.abs(rng.standard_normal((B, base.N, base.n_con)))).astype(np.float32)
    lam[:, 0, JP.x_dependent_rows(base)] = 0.0
    mu = rng.choice([10.0, 100.0], B).astype(np.float32)
    return ob, U, lam, mu


@pytest.mark.parametrize("mu_hi", [10.0, 1e4])
def test_al_update_plain_matches_pallas_kernel(mu_hi):
    """mu_hi = 10 (mu_init, the first outer step) at rtol/atol 1e-6. Up to
    mu_max = 1e4 the absolute tolerance grows with mu: the reference's XLA
    contracts the pair row dx^2 + dy^2 into an FMA, which moves c by an f32
    ulp, and lam - mu c multiplies that by mu (atol 1e-6 per 10 of mu)."""
    rng = np.random.default_rng(3)
    base = jax_get("six_robot_antipodal").make(N=10)
    Xs = (np.asarray(base.x0)[None, None]
          + 0.3 * rng.standard_normal((B, base.N, base.nx))).astype(np.float32)
    U = (0.2 * rng.standard_normal((B, base.N, base.nu))).astype(np.float32)
    lam = np.abs(rng.standard_normal((B, base.N, base.n_con))).astype(np.float32)
    mu = rng.uniform(1.0, mu_hi, B).astype(np.float32)

    lam_l, viol_l = jax_al_update(
        base, _to_lane(jnp.asarray(Xs), 1), _to_lane(jnp.asarray(U), 1),
        _to_lane(jnp.asarray(lam), 1), _to_lane(jnp.asarray(mu)[:, None], 1),
        lam_max=1e6, interpret=True)
    want_lam = np.asarray(_from_lane(lam_l, B))
    want_viol = np.asarray(_from_lane(viol_l[:, None], B))[:, 0, 0]

    got_lam, got_viol = megasolve.al_update_plain(
        port_ocp(base), _t(Xs), _t(U), _t(lam), _t(mu), 1e6)
    atol = 1e-6 * np.maximum(1.0, mu / 10.0)[:, None, None]
    err = np.abs(got_lam.numpy() - want_lam)
    assert np.all(err <= atol + 1e-6 * np.abs(want_lam)), float(err.max())
    np.testing.assert_allclose(got_viol.numpy(), want_viol, rtol=1e-6, atol=1e-6)
    assert want_viol.max() > 0.0  # the random states do violate rows
    assert (want_lam > 0).mean() > 0.01  # and rows are active


@pytest.mark.parametrize("ls", ["adaptive", "cascade"])
@pytest.mark.parametrize("name", ["six_robot_antipodal", "two_robot_swap"])
def test_inner_solve_plain_matches_pallas_megakernel(name, ls):
    ob, U, lam, mu = _problem(name, seed=1)
    kw = dict(n_outer=6, n_inner=4, tol_con=1e-3, ls=ls)
    jax_cfg, cfg = JaxConfig(**kw), ALILQRConfig(**kw)
    tiles = B // 128
    Xs_l, U_l, cost_l, iters_l = jax_inner_solve(
        ob, _to_lane(ob.x0[:, None], tiles), _to_lane(ob.xref, tiles),
        _to_lane(jnp.asarray(lam), tiles), _to_lane(jnp.asarray(mu)[:, None], tiles),
        _to_lane(jnp.asarray(U), tiles), jax_cfg, interpret=True)
    want_U = np.asarray(_from_lane(U_l, B))
    want_X = np.asarray(_from_lane(Xs_l, B))
    want_cost = np.asarray(_from_lane(cost_l[:, None], B))[:, 0, 0]
    want_iters = np.asarray(_from_lane(iters_l[:, None], B))[:, 0, 0].astype(np.int32)

    o = port_ocp(ob)
    Xs, Uo, cost, iters = megasolve.inner_solve_plain(
        o, o.x0, o.xref, _t(lam), _t(mu), _t(U), cfg)
    assert Xs.shape == want_X.shape and Uo.shape == want_U.shape
    np.testing.assert_allclose(cost.numpy(), want_cost, rtol=1e-4)
    np.testing.assert_allclose(Uo.numpy(), want_U, atol=5e-3)
    np.testing.assert_allclose(Xs.numpy(), want_X, atol=5e-3)
    assert int((iters.numpy() == want_iters).sum()) >= 126
    assert want_iters.max() >= 2  # the solve really iterated


def test_cpu_wrappers_take_the_plain_versions():
    ob, U, lam, mu = _problem("two_robot_swap", seed=2)
    o = port_ocp(ob)
    cfg = ALILQRConfig(n_inner=2, ls="adaptive")
    cuda_build.reset_launch_counts()
    got = megasolve.inner_solve_fused(o, o.x0, o.xref, _t(lam), _t(mu), _t(U), cfg)
    want = megasolve.inner_solve_plain(o, o.x0, o.xref, _t(lam), _t(mu), _t(U), cfg)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    megasolve.al_update_lanes(o, got[0], got[1], _t(lam), _t(mu), 1e6)
    assert cuda_build.launch_counts == {
        "inner_solve_fused": 0, "al_update_lanes": 0, "expansions_fused": 0,
        "riccati_lanes": 0, "linesearch_costs_lanes": 0, "rollout_alpha_lanes": 0,
        "fma_peak": 0, "phase_ablation": 0, "expansion_ab": 0}


def test_cuda_admission_rule():
    """K1 and K2 take pair, static-obstacle, moving-obstacle and box rows at
    every robot count of the library; they refuse LiDAR rays, robot counts
    the library is not built for, compact and sweep='scan'."""
    cfg = ALILQRConfig(ls="adaptive")
    assert megasolve.cuda_unsupported(get("six_robot_antipodal").make(N=10, device="cpu"), cfg) is None
    assert megasolve.cuda_unsupported(get("ten_robot").make(device="cpu"), cfg) is None
    assert megasolve.cuda_unsupported(get("two_robot_centralized").make(device="cpu"), cfg) is None
    assert megasolve.cuda_unsupported(get("obstacle_scenario_1").make(device="cpu"), cfg) is None
    assert megasolve.cuda_unsupported(get("obstacle_scenario_3").make(device="cpu"), cfg) is None
    assert "num_rays" in megasolve.cuda_unsupported(get("lidar_v4").make(device="cpu"), cfg)
    six = get("six_robot_antipodal").make(N=10, device="cpu")
    assert "compact" in megasolve.cuda_unsupported(six, dataclasses.replace(cfg, compact=True))
    assert "scan" in megasolve.cuda_unsupported(six, dataclasses.replace(cfg, sweep="scan"))
    seven = dataclasses.replace(six, m=7)
    assert "m=7" in megasolve.cuda_unsupported(seven, cfg)
    mov = dataclasses.replace(six, n_mov=1, mov_obs=torch.zeros((10, 1, 2)))
    assert megasolve.cuda_unsupported(mov, cfg) is None
    assert megasolve.obstacle_rows(mov) == 6 and megasolve.obstacle_rows(six) == 0
    ten = get("ten_robot").make(device="cpu")
    assert megasolve.obstacle_rows(dataclasses.replace(ten, n_mov=3)) == 30


@pytest.mark.parametrize("mega", [True, False])
@pytest.mark.parametrize("name", ["obstacle_scenario_3", "robot_template"])
def test_obstacle_batches_take_the_route_cfg_mega_picks(monkeypatch, name, mega):
    """With the default mega=True a family-H batch and a per-robot
    moving-obstacle batch take the megakernel route (K1 and K2; their plain
    versions on CPU tensors), as the reference sends them to its megakernel;
    mega=False takes the staged route. The first design of K1 (the roofline
    tools') takes no obstacle rows."""
    import obstacle_cases as OC
    from nmpc_tpu_torch.solver import alilqr_batched as AB

    ob, U, lam, mu = OC.port_case(name, 4, seed=9)
    routed = []
    for route in ("_solve_mega", "_solve_lanes"):
        real = getattr(AB, route)
        monkeypatch.setattr(AB, route, lambda *a, _r=route, _f=real, **k: routed.append(_r)
                            or _f(*a, **k))
    res = AB.solve_batched(ob, cfg=ALILQRConfig(n_outer=2, n_inner=3, mega=mega))
    assert routed == ["_solve_mega" if mega else "_solve_lanes"]
    assert torch.isfinite(res.cost).all() and res.X.shape == (4, ob.N + 1, ob.nx)
    with pytest.raises(NotImplementedError, match="first design"):
        megasolve.inner_launch(ob, ob.x0, ob.xref, lam, mu, U, ALILQRConfig(), "phase_ablation",
                               cuda_build.load, None)


@pytest.mark.parametrize("ls", ["adaptive", "cascade"])
@pytest.mark.parametrize("m", cuda_build.ROBOT_COUNTS)
def test_inner_solve_plain_counts_the_candidates_it_needs(m, ls):
    """The line-search rollouts the plain K1 counts for the bound of
    tools/roofline.py: none once a scenario is done, every alpha of a
    cascade iteration, one to ls_rounds an adaptive one; counting leaves
    the results as they are."""
    rng = np.random.default_rng(7)
    base = get(SCENARIOS[m]).make(N=10, device="cpu")
    nb = 32
    noise = (0.1 * rng.standard_normal((nb, base.nx))).astype(np.float32)
    o = batch_ocp(base, base.x0[None] + _t(noise))
    U = _t((0.05 * rng.standard_normal((nb, base.N, base.nu))).astype(np.float32))
    lam = _t((0.5 * np.abs(rng.standard_normal((nb, base.N, base.n_con)))).astype(np.float32))
    lam = lam * (TP.constraint_mask(base) > 0)
    mu = _t(rng.choice([10.0, 100.0], nb).astype(np.float32))
    cfg = ALILQRConfig(n_inner=4, ls=ls)
    cand = torch.zeros(nb, dtype=torch.int64)
    got = megasolve.inner_solve_plain(o, o.x0, o.xref, lam, mu, U, cfg, candidates=cand)
    want = megasolve.inner_solve_plain(o, o.x0, o.xref, lam, mu, U, cfg)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    run = k1_executed(got[3], cfg.n_inner)
    if ls == "cascade":
        assert torch.equal(cand, len(cfg.alphas) * run)
    else:
        assert (run <= cand).all() and (cand <= cfg.ls_rounds * run).all()
    assert int(run.min()) >= 1
