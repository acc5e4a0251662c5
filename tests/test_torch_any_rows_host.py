"""K4's and K5's device-memory forms (csrc/expansions_rollout_tiles.cuh::
K4Device, csrc/staged_tiles.cuh::K5Device: nothing in shared memory), their
device code compiled as host C++ (tests/staged_tiles_host.cpp, `tiles` = 2;
a block's threads as the lanes of tests/host_lanes.h), at the library's
geometry for m = 3 and 17, on problems with pair rows, 40 static and 12
moving obstacles (rows that both tiles still hold on the card, so that the
two forms run side by side here):

* the forms' geometry as the harness reports it against ops/staged_tiles.py
  (K4_DEVICE, K5_DEVICE, the scratch a block's slot takes);
* K4's device-memory form (its input and output tiles in a scratch of three
  slots, so that blocks take further work items in turn) and K5's (every
  stage row and the parameter block read from the arrays) against the tile
  forms bit for bit, and against the plain versions at ops/kernel_check.py's
  tolerances.

Batches of 3 (a ragged tile: 4-byte stores), 16 (K4's whole tile of 16:
16-byte stores) and 33 (three tiles); horizons of 1 and 3. Skipped where
g++ is missing.
"""

import ctypes

import numpy as np
import pytest
import torch

from nmpc_tpu_torch.ocp import problem as P
from nmpc_tpu_torch.ops import kernel_check as KC
from nmpc_tpu_torch.ops import rollout as R
from nmpc_tpu_torch.ops import staged_tiles as ST
from nmpc_tpu_torch.ops.expansions import expansions_plain
from nmpc_tpu_torch.scenarios import robot_counts
from test_torch_staged_tiles import (ALPHAS, _cost_inputs, _host_costs, _host_expansions,
                                     host_libs_at)

ROBOTS = (3, 17)
N_OBS, N_MOV = 40, 12
SIZES = [(3, 1), (3, 3), (16, 3), (33, 3)]


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def host_libs():
    libs = host_libs_at(ROBOTS)
    for lib in libs.values():
        lib.host_k4_device_geometry.argtypes = [ctypes.c_int, ctypes.c_void_p]
        lib.host_k5_device_geometry.argtypes = [ctypes.c_void_p]
    return libs


def _problem(m, N):
    """The antipodal circle of m robots (pair rows) among N_OBS static discs
    and N_MOV moving-obstacle slots, drawn from a numpy seed."""
    rng = np.random.default_rng(m)
    obs = np.concatenate([rng.uniform(-2.0, 2.0, (N_OBS, 2)), rng.uniform(0.05, 0.2, (N_OBS, 1))],
                         axis=1)
    ocp = P.make_ocp(**robot_counts.circle(m, N=N), obstacles=obs.tolist(),
                     mov_obs=torch.zeros((N, N_MOV, 2)), device="cpu")
    assert ocp.n_pairs == m * (m - 1) // 2 and (ocp.n_obs, ocp.n_mov) == (N_OBS, N_MOV)
    return ocp


@pytest.mark.parametrize("m", ROBOTS)
def test_host_device_forms_geometry(host_libs, m):
    lib = host_libs[m]
    rows = ST.k4_rows(m, True, N_OBS, N_MOV)
    g4 = (ctypes.c_int * 4)()
    lib.host_k4_device_geometry(rows, g4)
    d4 = ST.K4_DEVICE
    assert list(g4) == [d4.S, d4.W, 32 * d4.W, ST.k4_scratch_floats(m, rows, d4)]
    assert ST.k4_layout(m, rows, 100, d4)["smem_bytes"] == 0
    g5 = (ctypes.c_int * 4)()
    lib.host_k5_device_geometry(g5)
    d5 = ST.K5_DEVICE
    assert list(g5) == [d5.S, d5.D, ST.k5_max_alphas(m, d5), 0]
    # on the card both tiles still hold these rows, and ten times as many
    # static obstacles overflow both: the rule picks the device-memory forms
    for n_obs, k4, k5 in ((N_OBS, ST.k4_geometry(m), ST.k5_geometry(m)), (10 * N_OBS, d4, d5)):
        prm = R._P(3 * m, 2 * m, 0, n_obs).size
        assert ST.k4_form(m, True, n_obs, N_MOV, prm) == k4
        assert ST.k5_form(m, True, n_obs, N_MOV, prm, len(ALPHAS)) == k5


@pytest.mark.parametrize("B,N", SIZES)
@pytest.mark.parametrize("m", ROBOTS)
def test_host_device_forms_are_the_tile_forms_and_match_plain(host_libs, m, B, N):
    lib, ocp = host_libs[m], _problem(m, N)
    d = _cost_inputs(ocp, B, seed=60 * m + B + N)
    # K4: outputs start as NaN, so an entry the form leaves unwritten shows
    got = _host_expansions(lib, ocp, d, tiles=2)
    assert all(torch.equal(a, b) for a, b in zip(got, _host_expansions(lib, ocp, d, tiles=1)))
    want = expansions_plain(ocp, d["X"], d["U"], d["xref"], d["lam"], d["mu"], d["mov"])
    v = KC.Verdict()
    for j, (g, w, atol) in enumerate(zip(got, want, KC.K4_ATOL)):
        KC.hold(v, f"K4 output {j}", g, w, atol)
    assert v.units == B and v.n_widened == 0
    if N > 1:   # past stage 0 the obstacle rows bite
        assert float(got[4].abs().sum()) > float(torch.diagonal(got[4], 0, 1, 2).abs().sum())
    # K5
    costs = _host_costs(lib, ocp, d, ALPHAS, tiles=2)
    assert torch.equal(costs, _host_costs(lib, ocp, d, ALPHAS, tiles=1))
    torch.testing.assert_close(costs, R.linesearch_costs_plain(
        ocp, d["x0"], d["X"], d["U"], d["kff"], d["Kfb"], d["xref"], d["lam"], d["mu"], ALPHAS,
        d["mov"]), rtol=KC.K5_RTOL, atol=KC.K5_ATOL)
    assert torch.isfinite(costs).all()
