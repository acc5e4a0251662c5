"""The staged kernels past ten robots and K3 past (30, 20), their device code
compiled as host C++ (tests/staged_tiles_host.cpp, the harness and helpers
of tests/test_torch_staged_tiles.py; a block's threads as the lanes of
tests/host_lanes.h), at the solver libraries' geometry:

* K3's block design (csrc/staged_tiles.cuh::riccati_block: a block of eight
  warps a scenario, its slot in shared memory, the Cholesky in warp 0) at
  m = 12 and 16 against the plain version at K3's tolerances
  (ops/kernel_check.py) and the first design (riccati_thread) bit for bit,
  at the stage shapes no robot stack has, (36, 24), (41, 7), (50, 13),
  (64, 32) and the limit (80, 32), against plain, and at the ray shape
  (13, 2) built in the block design against the team design there bit for
  bit: the same sums in the same order.
* K3's wide design (riccati_wide: the Cholesky across the block, a ring of
  A-and-B tiles or none, the slot in shared memory or in the scratch) at
  m = 17 and 24 against plain and the first design bit for bit, at (54,
  36) (nu > 32, a ring of two), (96, 64) (a ring of one) and (120, 40) (the
  slot in the scratch) at k3_rule's geometry, at (54, 36) with A and B read
  from the arrays (D = 0), against plain; and at (64, 32) against the block
  design bit for bit.
* K4, K5 and K6 at m = 12, 16, 17 and 24 (K4 with lx and lu summed in its
  output tile, K5 reading xbar, ubar and kff from its stage tile, K6 in
  teams of 16; past sixteen robots on k4_rule's, k5_rule's and k6_rule's
  smaller tiles: at 24 K4 on 8 scenarios, K5 and K6 on 4) against plain
  and their first designs bit for bit, on scenarios/robot_counts.py's
  widened crossing with its pair rows; K5 and K6 reading their stage rows
  from the arrays (D = 0, the geometry of m >= 64) at m = 17 against the
  ring design bit for bit.

Batches of 3 (a ragged tile: 4-byte copies) and 16 (K4's whole tile of 16
and two of K5's and K6's eight: 16-byte copies); horizons of 1 and 3.
Skipped where g++ is missing.
"""

import ctypes

import pytest
import torch

import host_build
from nmpc_tpu_torch.ops import kernel_check as KC
from nmpc_tpu_torch.ops import rollout as R
from nmpc_tpu_torch.ops import staged_tiles as ST
from nmpc_tpu_torch.ops.expansions import expansions_plain
from nmpc_tpu_torch.ops.riccati import riccati_plain
from nmpc_tpu_torch.scenarios import robot_counts
from test_torch_staged_tiles import (ALPHAS, HOST, _cost_inputs, _host_costs, _host_expansions,
                                     _host_riccati, _host_rollout, _riccati_inputs, bind,
                                     host_flags, host_libs_at)

WIDE_ROBOTS = (12, 16)
WIDE_SHAPES = ((36, 24), (41, 7), (50, 13), (64, 32), (80, 32))
RAY_SHAPE = (13, 2)
# past sixteen robots, and K3's wide design at k3_rule's geometry; beside
# them the wide design with A and B read from the arrays at (54, 36), and
# at the block design's (64, 32)
PAST_ROBOTS = (17, 24)
PAST_SHAPES = ((54, 36), (96, 64), (120, 40))
WIDE_D0 = ST.K3Geometry(1, 0, 256, 1, True, wide=True)
WIDE_AT_BLOCK = ST.K3Geometry(1, 2, 256, 1, wide=True)
# K5 and K6 reading their stage rows from the arrays (the geometry of m >=
# 64), built at m = 17
DIRECT = (17, ST.K5Geometry(8, 0), ST.K6Geometry(8, 0, 16))
SIZES = [(3, 1), (3, 3), (16, 3)]


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def host_libs():
    """{m or stage shape: the harness at the library's geometry}, and
    "ray block": the ray shape built in the block design."""
    libs = host_libs_at((*WIDE_ROBOTS, *WIDE_SHAPES, RAY_SHAPE, *PAST_ROBOTS, *PAST_SHAPES))

    def at(shape, g):
        flags = [f for f in host_flags(shape) if not f.startswith("-DNMPC_K3_")]
        return bind(host_build.build(HOST.name, [*flags, *ST.k3_shape_flags(shape, g)]))

    libs["ray block"] = at(RAY_SHAPE, ST.K3_GEOMETRY[16])
    libs["D=0"] = at(PAST_SHAPES[0], WIDE_D0)
    libs["wide at block"] = at((64, 32), WIDE_AT_BLOCK)
    m, k5, k6 = DIRECT
    libs["direct"] = bind(host_build.build(HOST.name, [f"-DNMPC_NR={m}",
                                                       *ST.nvcc_flags(m, k5=k5, k6=k6)]))
    for lib in libs.values():
        lib.host_k3_wide.restype = ctypes.c_int
    return libs


def _hold_k3(got, exp, tag):
    v = KC.Verdict()
    for i, (g, w, atol) in enumerate(zip(got, riccati_plain(exp, 1e-6), KC.K3_ATOL)):
        KC.hold(v, f"K3 {tag} output {i}", g, w, atol)
    assert v.n_widened == 0 and v.units == exp[0].shape[-1]
    assert all(torch.isfinite(t).all() for t in got)


@pytest.mark.parametrize("B,N", SIZES)
@pytest.mark.parametrize("m", WIDE_ROBOTS)
def test_host_k3_block_design_matches_plain_and_first_design(host_libs, m, B, N):
    assert ST.k3_geometry(m).S == 1
    exp = _riccati_inputs(m, B, N, seed=m + B + N)
    got = _host_riccati(host_libs[m], exp, tiles=True)
    first = _host_riccati(host_libs[m], exp, tiles=False)
    assert all(torch.equal(a, b) for a, b in zip(got, first))   # no sum reordered
    _hold_k3(got, exp, f"m={m}")


@pytest.mark.parametrize("B,N", SIZES[:2])
@pytest.mark.parametrize("shape", WIDE_SHAPES)
def test_host_k3_block_design_at_wide_shapes_matches_plain(host_libs, shape, B, N):
    assert ST.k3_geometry(shape).S == 1
    exp = _riccati_inputs(shape, B, N, seed=sum(shape) + B + N)
    _hold_k3(_host_riccati(host_libs[shape], exp, tiles=True), exp, str(shape))


@pytest.mark.parametrize("B,N", SIZES)
def test_host_k3_block_design_is_the_team_design_at_the_ray_shape(host_libs, B, N):
    exp = _riccati_inputs(RAY_SHAPE, B, N, seed=B + N)
    block = _host_riccati(host_libs["ray block"], exp, tiles=True)
    team = _host_riccati(host_libs[RAY_SHAPE], exp, tiles=True)
    assert all(torch.equal(a, b) for a, b in zip(block, team))


@pytest.mark.parametrize("B,N", SIZES[:2])
@pytest.mark.parametrize("m", PAST_ROBOTS)
def test_host_k3_wide_design_matches_plain_and_first_design(host_libs, m, B, N):
    assert ST.k3_geometry(m).wide and host_libs[m].host_k3_wide() == 1
    exp = _riccati_inputs(m, B, N, seed=m + B + N)
    got = _host_riccati(host_libs[m], exp, tiles=True)
    first = _host_riccati(host_libs[m], exp, tiles=False)
    assert all(torch.equal(a, b) for a, b in zip(got, first))   # no sum reordered
    _hold_k3(got, exp, f"m={m}")


@pytest.mark.parametrize("B,N", SIZES[:2])
@pytest.mark.parametrize("key", [*PAST_SHAPES, "D=0"])
def test_host_k3_wide_design_at_wide_shapes_matches_plain(host_libs, key, B, N):
    shape, g = (PAST_SHAPES[0], WIDE_D0) if key == "D=0" else (key, ST.k3_geometry(key))
    lib = host_libs[key]
    got = (ctypes.c_int * 8)()
    lib.host_k3_geometry(got)
    lay = ST.k3_layout(shape, g)
    assert list(got) == [g.S, g.D, g.T, g.P, int(g.spill), lay["threads"], lay["smem_bytes"],
                         lay["scratch_floats"]] and lib.host_k3_wide() == 1
    exp = _riccati_inputs(shape, B, N, seed=sum(shape) + B + N)
    _hold_k3(_host_riccati(lib, exp, tiles=True), exp, f"{shape} {g}")


@pytest.mark.parametrize("B,N", SIZES)
def test_host_k3_wide_design_is_the_block_design(host_libs, B, N):
    exp = _riccati_inputs((64, 32), B, N, seed=64 + B + N)
    wide = _host_riccati(host_libs["wide at block"], exp, tiles=True)
    block = _host_riccati(host_libs[(64, 32)], exp, tiles=True)
    assert all(torch.equal(a, b) for a, b in zip(wide, block))


@pytest.mark.parametrize("B,N", SIZES)
def test_host_k5_k6_direct_reads_are_the_ring_design(host_libs, B, N):
    m = DIRECT[0]
    lib, ring, ocp = host_libs["direct"], host_libs[m], _problem(m, N)
    d = _cost_inputs(ocp, B, seed=50 * m + B + N)
    costs = _host_costs(lib, ocp, d, ALPHAS, tiles=True)
    assert torch.equal(costs, _host_costs(ring, ocp, d, ALPHAS, tiles=True))
    torch.testing.assert_close(costs, R.linesearch_costs_plain(
        ocp, d["x0"], d["X"], d["U"], d["kff"], d["Kfb"], d["xref"], d["lam"], d["mu"], ALPHAS,
        d["mov"]), rtol=KC.K5_RTOL, atol=KC.K5_ATOL)
    alpha = torch.tensor(ALPHAS)[torch.arange(B) % len(ALPHAS)].contiguous()
    roll = _host_rollout(lib, ocp, d, alpha, tiles=True)
    assert all(torch.equal(a, b) for a, b in zip(roll, _host_rollout(ring, ocp, d, alpha,
                                                                     tiles=True)))


def _problem(m, N):
    ocp = robot_counts.make(m, device="cpu", N=N)
    assert ocp.n_pairs == m * (m - 1) // 2
    return ocp


@pytest.mark.parametrize("B,N", SIZES)
@pytest.mark.parametrize("m", WIDE_ROBOTS + PAST_ROBOTS)
def test_host_k4_k5_k6_past_ten_robots_match_plain_and_first_design(host_libs, m, B, N):
    lib, ocp = host_libs[m], _problem(m, N)
    d = _cost_inputs(ocp, B, seed=40 * m + B + N)
    # K4
    got = _host_expansions(lib, ocp, d, tiles=True)
    assert all(torch.equal(a, b) for a, b in zip(got, _host_expansions(lib, ocp, d, tiles=False)))
    want = expansions_plain(ocp, d["X"], d["U"], d["xref"], d["lam"], d["mu"], d["mov"])
    v = KC.Verdict()
    for j, (g, w, atol) in enumerate(zip(got, want, KC.K4_ATOL)):
        KC.hold(v, f"K4 output {j}", g, w, atol)
    assert v.units == B and v.n_widened == 0
    # K5
    costs = _host_costs(lib, ocp, d, ALPHAS, tiles=True)
    assert torch.equal(costs, _host_costs(lib, ocp, d, ALPHAS, tiles=False))
    torch.testing.assert_close(costs, R.linesearch_costs_plain(
        ocp, d["x0"], d["X"], d["U"], d["kff"], d["Kfb"], d["xref"], d["lam"], d["mu"], ALPHAS,
        d["mov"]), rtol=KC.K5_RTOL, atol=KC.K5_ATOL)
    assert torch.isfinite(costs).all()
    # K6
    alpha = torch.tensor(ALPHAS)[torch.arange(B) % len(ALPHAS)].contiguous()
    roll = _host_rollout(lib, ocp, d, alpha, tiles=True)
    assert all(torch.equal(a, b)
               for a, b in zip(roll, _host_rollout(lib, ocp, d, alpha, tiles=False)))
    want6 = R.rollout_alpha_plain(ocp, d["x0"], d["X"], d["U"], d["kff"], d["Kfb"], alpha)
    v = KC.Verdict()
    for j, (g, w) in enumerate(zip(roll, want6)):
        KC.hold(v, f"K6 output {j}", g, w, KC.K6_ATOL)
    assert v.units == B and v.n_widened == 0 and torch.isfinite(roll[0]).all()
