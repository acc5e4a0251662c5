"""Problems whose rows overflow K4's or K5's tile, on the CPU against the JAX
package: the rule that picks K4's and K5's form (ops/staged_tiles.py::
k4_form, k5_form), the route past m = 108, and the staged route's solves
at such problems. On the card these run K4's and K5's device-memory forms
(chip_smoke.py phase 41, tests/test_torch_cuda.py); here the plain
versions, which the host rehearsal (tests/test_torch_any_rows_host.py) and
the card hold both forms to. The problems are built by the reference's
make_ocp from plain Python numbers and numpy draws (scenarios/
robot_counts.py: the crossing widened by columns, `pillars`) and carried
to the port by ocp_from_numpy.

* The rule, for m in ROBOTS, static obstacles in N_OBS and moving ones in
  N_MOV: rollout.unsupported is None (the staged kernels take every
  problem of the class); the picked form's block fits the card's shared
  memory (the device-memory forms take none); wherever the library's tile
  fits the problem's rows the pick is that tile, and it is the tile the
  solver library of m is built with (K4_GEOMETRY / k4_rule, K5_GEOMETRY /
  k5_rule, as before the device-memory forms existed).
* The route at m = 109 and 112 is the reference's (test_route_past_
  sixteen_robots' rule): the staged route, or the hybrid one under scan.
* The port's staged route (plain versions) against the reference's
  per-scenario XLA `solve`, vmapped, as test_staged_route_matches_the_
  reference_solve holds it (cost rtol 1e-4, violation atol 1e-4,
  convergence equal, mean control gap below 1e-3), at the m = 112 crossing
  (N=2, B=2, n_outer=1, n_inner=2), the crossing of 4 robots among 40
  pillars (N=3, B=4) and one robot with 150 moving obstacles (N=3, B=4;
  robot_counts.fleet_subproblem, the subproblem of a 151-robot
  decentralized fleet on a circle, one schedule shared by the batch),
  starts jittered by 0.01 N(0, 1) from a numpy seed.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nmpc_tpu.ocp import problem as JP
from nmpc_tpu.solver.alilqr import ALILQRConfig as JaxConfig
from nmpc_tpu.solver.alilqr import solve as jax_solve
from nmpc_tpu_torch.ocp import problem as TP
from nmpc_tpu_torch.ops import expansions, rollout, staged_tiles
from nmpc_tpu_torch.parallel import batch_ocp
from nmpc_tpu_torch.scenarios import robot_counts
from nmpc_tpu_torch.solver import ALILQRConfig
from nmpc_tpu_torch.solver.alilqr_batched import route, solve_batched
from test_torch_past_sixteen import CONFIGS, port_ocp, reference_route

ROBOTS = (1, 6, 10, 16, 20, 32, 64, 108, 109, 112, 128)
N_OBS = (0, 31, 64, 200, 410)
N_MOV = (0, 150)
ALPHAS = 1 + len(ALILQRConfig().alphas)   # the line search's candidates, alpha 0 first


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _discs(n, seed):
    """n static discs (x, y, r) over the arena from a numpy seed."""
    rng = np.random.default_rng(seed)
    return np.concatenate([rng.uniform(-9.0, 9.0, (n, 2)), rng.uniform(0.05, 0.3, (n, 1))],
                          axis=1).tolist()


@pytest.mark.parametrize("m", ROBOTS)
def test_the_rule_takes_every_problem(m):
    for n_obs in N_OBS:
        for n_mov in N_MOV:
            ocp = TP.make_ocp(**robot_counts.builder(m)(m, N=2),
                              obstacles=_discs(n_obs, m) if n_obs else None,
                              mov_obs=torch.zeros((2, n_mov, 2)) if n_mov else None, device="cpu")
            assert (ocp.n_obs, ocp.n_mov) == (n_obs, n_mov)
            assert rollout.unsupported(ocp) is None, (m, n_obs, n_mov)
            prm = rollout._P(ocp.nx, ocp.nu, 0, n_obs).size
            pairs = ocp.n_pairs > 0
            # K4: the library's tile wherever it holds the rows, else the
            # device-memory form; either's block fits the card
            g4, tile4 = expansions.form(ocp), staged_tiles.k4_geometry(m)
            rows4 = staged_tiles.k4_rows(m, pairs, n_obs, n_mov)
            assert staged_tiles.k4_layout(m, rows4, prm, g4)["smem_bytes"] <= \
                staged_tiles.SMEM_BLOCK_MAX
            fits4 = tile4 is not None and staged_tiles.k4_layout(
                m, rows4, prm, tile4)["smem_bytes"] <= staged_tiles.SMEM_BLOCK_MAX
            assert g4 == (tile4 if fits4 else staged_tiles.K4_DEVICE), (m, n_obs, n_mov)
            # K5 at the solver's candidates, one launch
            g5, tile5 = rollout.costs_form(ocp, ALPHAS), staged_tiles.k5_geometry(m)
            rows5 = staged_tiles.k5_rows(m, pairs, n_obs, n_mov)
            assert staged_tiles.k5_max_alphas(m, g5) >= ALPHAS
            assert staged_tiles.k5_layout(m, rows5, prm + ALPHAS, ALPHAS, g5)["smem_bytes"] <= \
                staged_tiles.SMEM_BLOCK_MAX
            fits5 = staged_tiles.k5_layout(m, rows5, prm + ALPHAS, ALPHAS,
                                           tile5)["smem_bytes"] <= staged_tiles.SMEM_BLOCK_MAX
            assert g5 == (tile5 if fits5 else staged_tiles.K5_DEVICE), (m, n_obs, n_mov)
            if n_obs == n_mov == 0:   # pair rows alone: the tiles wherever one exists
                assert g4 == (tile4 or staged_tiles.K4_DEVICE) and g5 == tile5
    # the tiles the libraries are built with: the sweep's picks up to sixteen
    # robots, the rule's of m past them; K4 has none past m = 108, and K5's
    # past m = 63 is its device-memory form
    if m in staged_tiles.K4_GEOMETRY:
        assert staged_tiles.k4_geometry(m) == staged_tiles.K4_GEOMETRY[m]
        assert staged_tiles.k5_geometry(m) == staged_tiles.K5_GEOMETRY[m]
    assert (staged_tiles.k4_geometry(m) is None) == (m >= 109)
    assert (staged_tiles.k5_geometry(m) == staged_tiles.K5_DEVICE) == (m >= 64)


@pytest.mark.parametrize("m", [109, 112])
def test_route_past_the_last_k4_tile(m):
    for N in (2, 10):
        for builder in (robot_counts.circle, robot_counts.crossing):
            if m % 2 and builder is robot_counts.crossing:
                continue
            o = JP.make_ocp(**builder(m, N=N))
            t = port_ocp(o)
            assert rollout.unsupported(t) is None
            for what, kw in CONFIGS.items():
                want = reference_route(o, JaxConfig(**kw))
                got = route(t, ALILQRConfig(**kw))
                assert got == want == ("hybrid" if what == "scan" else "staged"), (m, N, what)


CASES = {
    "crossing112": (lambda: robot_counts.crossing(112, N=2), 2, dict(n_outer=1, n_inner=2)),
    "pillars4x40": (lambda: robot_counts.pillars(4, 40, N=3), 4, dict(n_outer=2, n_inner=4)),
    "moving150": (lambda: robot_counts.fleet_subproblem(150, N=3), 4, dict(n_outer=2, n_inner=4)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_staged_route_matches_the_reference_solve(case):
    kwargs, B, solve = CASES[case]
    o = JP.make_ocp(**kwargs())
    t = port_ocp(o)
    rng = np.random.default_rng(len(case))
    x0 = (np.asarray(o.x0)[None] + 0.01 * rng.standard_normal((B, o.nx))).astype(np.float32)
    jr = jax.jit(jax.vmap(lambda x: jax_solve(dataclasses.replace(o, x0=x),
                                              cfg=JaxConfig(**solve))))(jnp.asarray(x0))
    ob = batch_ocp(t, torch.from_numpy(x0))
    cfg = ALILQRConfig(**solve, mega=False)
    assert route(ob, cfg) == "staged"
    tr = solve_batched(ob, cfg=cfg)
    np.testing.assert_allclose(tr.cost.numpy(), np.asarray(jr.cost), rtol=1e-4)
    np.testing.assert_allclose(tr.viol.numpy(), np.asarray(jr.viol), atol=1e-4)
    np.testing.assert_array_equal(tr.converged.numpy(), np.asarray(jr.converged))
    assert float(np.abs(tr.U.numpy() - np.asarray(jr.U)).mean()) < 1e-3
    assert tr.U.shape == (B, o.N, o.nu) and torch.isfinite(tr.X).all()
