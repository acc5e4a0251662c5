"""The staged kernels past ten robots and K3 past (30, 20), their device code
compiled as host C++ (tests/staged_tiles_host.cpp, the harness and helpers
of tests/test_torch_staged_tiles.py; a block's threads as the lanes of
tests/host_lanes.h), at the solver libraries' geometry:

* K3's register-tile design (csrc/staged_tiles.cuh::riccati_rtile: S
  scenarios a block, 4 x 4 register tiles of the products, the factor and
  forward substitution as one elimination over the block, the backward
  substitutions one right-hand side a thread) at m = 12, 16, 17 and 24
  against the plain version at K3's tolerances (ops/kernel_check.py) and
  the first design (riccati_thread) bit for bit; at the stage shapes no
  robot stack has, (36, 24), (41, 7), (50, 13), (64, 32), (80, 32), (54,
  36) and (96, 64) (nu > 32), and (120, 40) (the slot spilled to the
  scratch, the products staged through shared memory), against plain; at
  the edges of its tiles (nu = 1, n and nu odd, nu > 32 at one scenario a
  block, n of 2, the most scenarios a block) against plain; at the ray
  shape (13, 2) against the team design bit for bit; and at m = 12 built
  at other geometries (one scenario a block, four at a ring of one, 128
  and 512 threads, the slot spilled) against k3_rule's bit for bit: the
  same sums in the same order.
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
PAST_ROBOTS = (17, 24)
# K3's register-tile design at stage shapes past (30, 20) that no robot
# stack has (k3_rule's geometry: one to four scenarios a block, rings of one
# and two, nu > 32, the slot spilled at (120, 40))
WIDE_SHAPES = ((36, 24), (41, 7), (50, 13), (64, 32), (80, 32), (54, 36), (96, 64), (120, 40))
# the edges of its tiles: nu = 1 at eight scenarios a block, n and nu odd,
# nu > 32 past a warp's rows with n a multiple of 4, n = 2 under a wide nu,
# n past 30 with nu = 3
EDGE_SHAPES = ((31, 1), (33, 21), (80, 33), (2, 25), (45, 3))
RAY_SHAPE = (13, 2)
# m = 12 at other geometries than k3_rule's: one scenario a block, four at
# a ring of one, 128 and 512 threads, the slot spilled (its products staged)
OTHER_GEOMETRIES = {"S=1": ST.K3Geometry(1, 2, 256, 1, rtile=True),
                    "S=4 D=1": ST.K3Geometry(4, 1, 256, 1, rtile=True),
                    "T=128": ST.K3Geometry(2, 2, 128, 1, rtile=True),
                    "T=512": ST.K3Geometry(2, 1, 512, 1, rtile=True),
                    "spill": ST.K3Geometry(1, 0, 256, 1, True, rtile=True)}
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
    """{m or stage shape: the harness at the library's geometry}, "ray
    rtile": the ray shape built in the register-tile design, the m = 12
    builds at OTHER_GEOMETRIES by their names, and "direct"."""
    libs = host_libs_at((*WIDE_ROBOTS, *PAST_ROBOTS, *WIDE_SHAPES, *EDGE_SHAPES, RAY_SHAPE))

    def at(shape, g):
        flags = [f for f in host_flags(shape) if not f.startswith("-DNMPC_K3_")]
        return bind(host_build.build(HOST.name, [*flags, *ST.k3_shape_flags(shape, g)]))

    libs["ray rtile"] = at(RAY_SHAPE, ST.K3Geometry(8, 2, 256, 1, rtile=True))
    for name, g in OTHER_GEOMETRIES.items():
        libs[name] = at((36, 24), g)
    m, k5, k6 = DIRECT
    libs["direct"] = bind(host_build.build(HOST.name, [f"-DNMPC_NR={m}",
                                                       *ST.nvcc_flags(m, k5=k5, k6=k6)]))
    for lib in libs.values():
        lib.host_k3_rtile.restype = ctypes.c_int
    return libs


def _hold_k3(got, exp, tag):
    v = KC.Verdict()
    for i, (g, w, atol) in enumerate(zip(got, riccati_plain(exp, 1e-6), KC.K3_ATOL)):
        KC.hold(v, f"K3 {tag} output {i}", g, w, atol)
    assert v.n_widened == 0 and v.units == exp[0].shape[-1]
    assert all(torch.isfinite(t).all() for t in got)


def _geometry_of(lib) -> list:
    got = (ctypes.c_int * 8)()
    lib.host_k3_geometry(got)
    return list(got)


def _want_geometry(key, g) -> list:
    lay = ST.k3_layout(key, g)
    return [g.S, g.D, g.T, g.P, int(g.spill), lay["threads"], lay["smem_bytes"],
            lay["scratch_floats"]]


@pytest.mark.parametrize("B,N", SIZES)
@pytest.mark.parametrize("m", WIDE_ROBOTS + PAST_ROBOTS)
def test_host_k3_rtile_design_matches_plain_and_first_design(host_libs, m, B, N):
    g = ST.k3_geometry(m)
    assert g.rtile and host_libs[m].host_k3_rtile() == 1
    assert _geometry_of(host_libs[m]) == _want_geometry(m, g)
    exp = _riccati_inputs(m, B, N, seed=m + B + N)
    got = _host_riccati(host_libs[m], exp, tiles=True)
    first = _host_riccati(host_libs[m], exp, tiles=False)
    assert all(torch.equal(a, b) for a, b in zip(got, first))   # no sum reordered
    _hold_k3(got, exp, f"m={m}")


@pytest.mark.parametrize("B,N", SIZES[:2])
@pytest.mark.parametrize("shape", WIDE_SHAPES)
def test_host_k3_rtile_design_at_wide_shapes_matches_plain(host_libs, shape, B, N):
    g = ST.k3_geometry(shape)
    assert g.rtile and g.spill == (shape == (120, 40))
    assert _geometry_of(host_libs[shape]) == _want_geometry(shape, g)
    exp = _riccati_inputs(shape, B, N, seed=sum(shape) + B + N)
    _hold_k3(_host_riccati(host_libs[shape], exp, tiles=True), exp, str(shape))


@pytest.mark.parametrize("B,N", SIZES[1:])
@pytest.mark.parametrize("shape", EDGE_SHAPES)
def test_host_k3_rtile_design_at_its_tiles_edges_matches_plain(host_libs, shape, B, N):
    g = ST.k3_geometry(shape)
    assert g.rtile and _geometry_of(host_libs[shape]) == _want_geometry(shape, g)
    exp = _riccati_inputs(shape, B, N, seed=sum(shape) + B + N)
    _hold_k3(_host_riccati(host_libs[shape], exp, tiles=True), exp, str(shape))


@pytest.mark.parametrize("B,N", SIZES)
def test_host_k3_rtile_design_is_the_team_design_at_the_ray_shape(host_libs, B, N):
    exp = _riccati_inputs(RAY_SHAPE, B, N, seed=B + N)
    rtile = _host_riccati(host_libs["ray rtile"], exp, tiles=True)
    team = _host_riccati(host_libs[RAY_SHAPE], exp, tiles=True)
    assert host_libs["ray rtile"].host_k3_rtile() == 1 and host_libs[RAY_SHAPE].host_k3_rtile() == 0
    assert all(torch.equal(a, b) for a, b in zip(rtile, team))


@pytest.mark.parametrize("B,N", SIZES[1:])
@pytest.mark.parametrize("name", sorted(OTHER_GEOMETRIES))
def test_host_k3_rtile_geometries_give_the_same_bits(host_libs, name, B, N):
    """m = 12's stage shape at other geometries, bit for bit k3_rule's."""
    exp = _riccati_inputs((36, 24), B, N, seed=36 + B + N)
    want = _host_riccati(host_libs[(36, 24)], exp, tiles=True)
    lib, g = host_libs[name], OTHER_GEOMETRIES[name]
    assert _geometry_of(lib) == _want_geometry((36, 24), g)
    got = _host_riccati(lib, exp, tiles=True)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


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
