"""Robot counts past the registry's: the route, the megakernel route's
admission and its solves at m = 7, 12 and 16, against the JAX package on the
CPU (K1 and K2 as their plain versions). The problems are
nmpc_tpu_torch/scenarios/robot_counts.py's (the antipodal circle, ten_robot
widened by columns), built by the reference's make_ocp and carried to the
port by ocp_from_numpy.

* `route` is the reference's rule (alilqr_batched.py:492-500) on every
  registry scenario and at m = 7, 9, 12 and 13 (N=10, pair-only). Its
  admission `mega_fits` is the card's, K1's block against 227 KB, not the
  reference's TPU VMEM estimate: at N=10 the reference's admits m <= 13,
  the port's m <= 16, so m = 14-16 take the megakernel route here and the
  staged route in the reference (the recorded divergence).
* The port's solve_batched at B=8, N=10, n_outer=2, n_inner=4 from starts
  jittered by 0.01 N(0, 1) against the reference's per-scenario `solve`
  (vmapped): at m = 7 and 12 at tests/test_batched_solver.py:30-34's
  tolerances (cost rtol 1e-4, U atol 5e-3) with equal iteration counts; at
  m = 16 (the crossing) the two stop an iteration apart on some scenarios,
  whose controls then part by more than 5e-3 along a flat valley of the
  cost, so by cost (rtol 1e-4) and aggregates. The reference's own
  megakernel at these m takes minutes in interpret mode and is not run here.
* K1's slot and team-ring mirrors (megasolve.slot_bytes, team_ring_bytes)
  against the device code compiled on the host (tests/inner_warp_host.cpp,
  tests/inner_team_host.cpp; skipped without g++).
"""

import ctypes
import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import host_build
from nmpc_tpu.ocp import problem as JP
from nmpc_tpu.ops.megasolve_pallas import mega_fits as jax_mega_fits
from nmpc_tpu.ops.rollout_pallas import supports as jax_supports
from nmpc_tpu.scenarios.registry import REGISTRY as JAX_REGISTRY
from nmpc_tpu.solver.alilqr import ALILQRConfig as JaxConfig
from nmpc_tpu.solver.alilqr import solve as jax_solve
from nmpc_tpu.solver.alilqr_batched import _resolve_sweep
from nmpc_tpu_torch.ocp import problem as TP
from nmpc_tpu_torch.ops import cuda_build, expansions, megasolve, rollout, staged_tiles
from nmpc_tpu_torch.parallel import batch_ocp
from nmpc_tpu_torch.scenarios import REGISTRY, robot_counts
from nmpc_tpu_torch.solver import ALILQRConfig
from nmpc_tpu_torch.solver.alilqr_batched import route, solve_batched

CONFIGS = {"default": {}, "staged": {"mega": False}, "scan": {"sweep": "scan"}}
SOLVE = dict(n_outer=2, n_inner=4)


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


def wide(m: int, kind=robot_counts.circle, N: int = 10):
    """(reference OCP, port OCP) of a robot_counts problem."""
    o = JP.make_ocp(**kind(m, N=N))
    return o, port_ocp(o)


@pytest.mark.parametrize("name", sorted(JAX_REGISTRY))
def test_route_is_the_reference_s_on_every_registry_scenario(name):
    o = JAX_REGISTRY[name].make()
    t = REGISTRY[name].make(device="cpu")
    assert rollout.supports(t) == jax_supports(o)
    for kw in CONFIGS.values():
        assert route(t, ALILQRConfig(**kw)) == reference_route(o, JaxConfig(**kw)), kw
    assert route(t, ALILQRConfig()) == ("hybrid" if o.num_rays else "mega")


@pytest.mark.parametrize("m", [7, 9, 12, 13, 14, 16])
def test_route_at_robot_counts_past_the_registry(m):
    """The reference's route at m = 7-13 (N=10, pair-only circle); at 14-16
    the megakernel route where the reference, whose VMEM estimate grows
    with N, takes the staged route."""
    o, t = wide(m)
    for what, kw in CONFIGS.items():
        want = reference_route(o, JaxConfig(**kw))
        got = route(t, ALILQRConfig(**kw))
        if m >= 14 and what == "default":
            assert (got, want) == ("mega", "staged")
        else:
            assert got == want, what
    assert megasolve.mega_fits(t) and megasolve.cuda_unsupported(t, ALILQRConfig()) is None


def test_nothing_past_the_ceiling():
    """m <= 16 takes the megakernel route and solves on the CPU; past 16 K1
    and K2 refuse the problem (cuda_build.MEGA_MAX_ROBOTS), and so do K1's
    variants and the staged kernels' first designs (the A/B baselines),
    raising naming the ceiling before they build anything; the route is the
    staged one, whose kernels (K3-K6) take the problem on the card at every
    robot count: past m = 108, where K4's tile no longer holds one scenario
    (its Hessian's position block alone is 4 m^2 floats), K4 takes its
    device-memory form; on the CPU the plain versions run."""
    for m in range(1, 17):
        assert route(wide(m)[1], ALILQRConfig()) == "mega", m
    t = wide(16)[1]
    ob = batch_ocp(t, t.x0[None].repeat(2, 1))
    res = solve_batched(ob, cfg=ALILQRConfig(n_outer=1, n_inner=2))
    assert torch.isfinite(res.cost).all() and res.U.shape == (2, 10, 32)
    assert cuda_build.MEGA_MAX_ROBOTS == 16
    for m in (0, 17):
        with pytest.raises(NotImplementedError, match="16"):
            cuda_build.load_k1_variant(m)
    with pytest.raises(NotImplementedError, match="16"):
        cuda_build.load_first(17)
    for load in (cuda_build.load, cuda_build.load_staged_variant):
        with pytest.raises(NotImplementedError, match="m >= 1"):
            load(0)
    t17 = wide(17)[1]
    assert "m=17" in megasolve.cuda_unsupported(t17, ALILQRConfig())
    assert not megasolve.mega_fits(t17)
    assert route(t17, ALILQRConfig()) == "staged"
    for m in (9, 12, 16, 17, 20, 24, 32, 63, 64, 108, 109, 112):
        assert rollout.unsupported(robot_counts.make(m, device="cpu", N=2)) is None, m
    for m in (109, 112):
        ocp = robot_counts.make(m, device="cpu", N=2)
        assert staged_tiles.k4_geometry(m) is None and expansions.form(ocp).device, m


def _starts(o, B=8, seed=0):
    rng = np.random.default_rng(seed)
    return (np.asarray(o.x0)[None] + 0.01 * rng.standard_normal((B, o.nx))).astype(np.float32)


@pytest.mark.parametrize("m,kind", [(7, "circle"), (12, "circle"), (16, "crossing")])
def test_solve_batched_matches_the_reference_solve(m, kind):
    o, t = wide(m, getattr(robot_counts, kind))
    x0 = _starts(o)
    jr = jax.jit(jax.vmap(lambda x: jax_solve(dataclasses.replace(o, x0=x),
                                              cfg=JaxConfig(**SOLVE))))(jnp.asarray(x0))
    ob = batch_ocp(t, torch.from_numpy(x0))
    assert route(ob, ALILQRConfig(**SOLVE)) == "mega"
    tr = solve_batched(ob, cfg=ALILQRConfig(**SOLVE))
    np.testing.assert_allclose(tr.cost.numpy(), np.asarray(jr.cost), rtol=1e-4)
    np.testing.assert_array_equal(tr.converged.numpy(), np.asarray(jr.converged))
    np.testing.assert_array_equal(tr.outer_iters.numpy(), np.asarray(jr.outer_iters))
    np.testing.assert_allclose(tr.viol.numpy(), np.asarray(jr.viol), atol=1e-4)
    du = np.abs(tr.U.numpy() - np.asarray(jr.U))
    if kind == "circle":
        np.testing.assert_allclose(tr.U.numpy(), np.asarray(jr.U), atol=5e-3)
        np.testing.assert_array_equal(tr.inner_iters.numpy(), np.asarray(jr.inner_iters))
    else:   # an iteration apart on some scenarios: cost and aggregates
        apart = np.abs(tr.inner_iters.numpy() - np.asarray(jr.inner_iters))
        assert apart.max() <= 1 and float(du.mean()) < 1e-3


def test_merit_in_k1_order_at_two_state_rows_a_lane():
    """al_merit_warp_order at m=12 (two state rows a lane, three pair rows):
    al_merit's value, within f32 rounding, and exactly it in f64."""
    _, t = wide(12)
    g = torch.Generator().manual_seed(3)
    B = 4
    X = t.x0[None, None] + 0.3 * torch.randn((B, t.N + 1, t.nx), generator=g)
    U = 0.1 * torch.randn((B, t.N, t.nu), generator=g)
    lam = torch.rand((B, t.N, t.n_con), generator=g)
    mu = torch.full((B,), 100.0)
    ob = batch_ocp(t, X[:, 0])
    got = megasolve.al_merit_warp_order(ob, X, U, lam, mu)
    want = megasolve.al_merit(ob, X, U, lam, mu)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=0.0)


HOSTS = {"inner_warp": (Path(__file__).resolve().parent / "inner_warp_host.cpp", (1, 6, 11, 16)),
         "inner_team": (Path(__file__).resolve().parent / "inner_team_host.cpp", (1, 2))}


@pytest.fixture(scope="module")
def host_libs():
    """{(harness, m): the device code compiled on the host at m robots}
    (tests/host_build.py)."""
    libs = {}
    for name, (path, ms) in HOSTS.items():
        built = host_build.build_all(path.name, {m: [f"-DNMPC_NR={m}"] for m in ms})
        for m, lib in built.items():
            fn = lib.host_k1_slot_bytes if name == "inner_warp" else lib.host_k1_team_ring_bytes
            fn.argtypes = [ctypes.c_int] * (1 if name == "inner_warp" else 3)
            fn.restype = ctypes.c_int
            libs[name, m] = lib
    return libs


def test_mega_fits_mirrors_the_built_slot_sizes(host_libs):
    """megasolve.slot_bytes is Slot<m>::floats_obs as the compiler sizes it,
    team_ring_bytes TeamSlot<m>::ring_floats at the team design's defaults,
    at obstacle rows up to the consensus fleet's 47."""
    for (name, m), lib in host_libs.items():
        for rows in (0, 1, m, 5 * m, 47):
            if name == "inner_warp":
                assert lib.host_k1_slot_bytes(rows) == megasolve.slot_bytes(m, rows), (m, rows)
                continue
            for n_mov, pairs in ((0, 1), (rows // m, 0), (rows // m, 1)):
                assert (lib.host_k1_team_ring_bytes(rows, n_mov, pairs)
                        == megasolve.team_ring_bytes(m, rows, n_mov, bool(pairs))), (m, rows)
    # K1's block at m=16 with the default eight alphas: two slots of 41,440 B
    t = wide(16)[1]
    need, design = megasolve.k1_block_bytes(t, ALILQRConfig())
    assert design == "warp" and need == 2 * 41440 + megasolve._prm_bytes(t, ALILQRConfig())
