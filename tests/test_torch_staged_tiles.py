"""The tile designs of K3 and K5 (csrc/staged_tiles.cuh) and of K4 and K6
(csrc/expansions_rollout_tiles.cuh) on the CPU.

* Their launch geometry (ops/staged_tiles.py) per robot count: S a power of
  two >= 8, a K5 block of the line search's candidates within K5_THREADS,
  every block within the H100's 227 KB of shared memory, and the blocks
  each SM holds as the table records them (K3).
* Their device code compiled as host C++ (tests/staged_tiles_host.cpp; a
  block's threads are std::threads with a std::barrier for __syncthreads,
  the copies plain loads), at the library's geometry for m in {1, 2, 6}:
  K3-K6 against the plain PyTorch versions at the CPU tests' tolerances
  (those of tests/test_torch_staged_ops.py, by the rule of
  ops/kernel_check.py), against the first designs (staged.cuh, compiled
  beside them) bit for bit, and K3 at m=2 against the JAX package's Pallas
  kernel in interpret mode; K3 also at the stage shapes of ST.K3_SHAPES (the
  ray stage, the user models' (2, 1) and (1, 1)) and ST.K3_SWEEP_SHAPES
  (every branch of k3_rule) against plain. Batches of 32 (16-byte rows) and 33 (4-byte
  copies, a ragged last tile); horizons of 1 and 5 (not a multiple of the
  ring depth); at m=1 with static-obstacle and with moving-obstacle rows.
  Skipped where g++ is missing.
"""

import ctypes
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nmpc_tpu.ops.riccati_pallas import riccati_fused as jax_riccati
from nmpc_tpu_torch.ocp import problem as P
from nmpc_tpu_torch.ops import kernel_check as KC
from nmpc_tpu_torch.ops import rollout as R
from nmpc_tpu_torch.ops import staged_tiles as ST
from nmpc_tpu_torch.ops.cuda_build import ROBOT_COUNTS, SRC_DIR
from nmpc_tpu_torch.ops.riccati import riccati_plain
from nmpc_tpu_torch.scenarios import get

HOST = Path(__file__).resolve().parent / "staged_tiles_host.cpp"
HOST_ROBOTS = (1, 2, 6)
RAY_SHAPE = (13, 2)   # one robot with the registry's 10 LiDAR rays (ST.K3_SHAPES)
# the reference's user models: Van der Pol (2, 1), the first-order process (1, 1)
USER_SHAPES = ((2, 1), (1, 1))
ALPHAS = (0.0, 1.0, 0.5, 0.25, 0.1, 0.03, 0.01, 0.003, 0.001)   # the solver's grid


@pytest.mark.parametrize("m", ROBOT_COUNTS)
def test_geometry_fits_the_card(m):
    g3, g5 = ST.K3_GEOMETRY[m], ST.K5_GEOMETRY[m]
    for S in (g3.S, g5.S):
        assert S >= 8 and S & (S - 1) == 0
    lay = ST.k3_layout(m)
    assert lay["smem_bytes"] <= ST.SMEM_BLOCK_MAX and lay["threads"] <= 1024
    assert lay["blocks_per_sm"] == ST.K3_BLOCKS_PER_SM[m], lay
    assert lay["scratch_floats"] == 0 or g3.spill
    # K5 at the solver's grid, with pairs and at path (b)'s six obstacles
    assert ST.k5_max_alphas(m) >= len(ALPHAS) and ST.k5_max_alphas(m) * g5.S <= ST.K5_THREADS
    rows = ST.k5_rows(m, m > 1, 6, 0)
    lay5 = ST.k5_layout(m, rows, 12288, ST.k5_max_alphas(m))
    assert lay5["threads"] <= ST.K5_THREADS and lay5["smem_bytes"] <= ST.SMEM_BLOCK_MAX
    assert ST.k5_layout(m, rows, 200, len(ALPHAS))["blocks_per_sm"] >= 2
    # K4 at the largest input tile the registry gives (pairs, six obstacles,
    # five moving-obstacle slots) and the largest parameter block; K6
    lay4 = ST.k4_layout(m, ST.k4_rows(m, m > 1, 6, 5), 12288)
    assert lay4["smem_bytes"] <= ST.SMEM_BLOCK_MAX and lay4["threads"] <= 1024
    assert ST.k4_layout(m, ST.k4_rows(m, m > 1, 0, 0), 200)["blocks_per_sm"] >= 2
    g6, lay6 = ST.K6_GEOMETRY[m], ST.k6_layout(m)
    assert g6.S >= 8 and g6.S & (g6.S - 1) == 0 and 1 <= g6.T <= 2 * m
    assert lay6["smem_bytes"] <= ST.SMEM_BLOCK_MAX and lay6["threads"] <= 1024
    assert lay6["blocks_per_sm"] >= 2


def test_geometry_refuses_what_the_kernels_do_not_take():
    for bad in (ST.K3Geometry(12, 2, 32, 13), ST.K3Geometry(8, 2, 24, 9),
                ST.K3Geometry(8, 1, 32, 9), ST.K3Geometry(8, 2, 32, 12)):
        with pytest.raises(ValueError):
            ST.k3_layout(6, bad)
    with pytest.raises(ValueError):
        ST.k5_layout(1, 32, 100, 9, ST.K5Geometry(24, 2))
    for bad in (ST.K4Geometry(12, 4), ST.K4Geometry(32, 0), ST.K4Geometry(32, 33)):
        with pytest.raises(ValueError):
            ST.k4_layout(6, 124, 100, bad)
    for bad in (ST.K6Geometry(12, 2, 1), ST.K6Geometry(16, 1, 1), ST.K6Geometry(16, 2, 13),
                ST.K6Geometry(128, 2, 12)):
        with pytest.raises(ValueError):
            ST.k6_layout(6, bad)
    assert ST.nvcc_flags(6)[:3] == ["-DNMPC_K3_S=8", "-DNMPC_K3_D=2", "-DNMPC_K3_T=32"]
    g4, g6 = ST.K4_GEOMETRY[6], ST.K6_GEOMETRY[6]
    assert ST.nvcc_flags(6)[7:] == [f"-DNMPC_K4_S={g4.S}", f"-DNMPC_K4_W={g4.W}",
                                    f"-DNMPC_K6_S={g6.S}", f"-DNMPC_K6_D={g6.D}",
                                    f"-DNMPC_K6_T={g6.T}"]


@pytest.fixture(scope="module")
def host_libs(tmp_path_factory):
    """{m: the harness built with the library's geometry for m}."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed: the host rehearsal cannot be built")
    out = tmp_path_factory.mktemp("staged_tiles")

    def build(m):
        if isinstance(m, tuple):   # K3 at that stage shape, the rest at m=1
            flags = [f"-DNMPC_NR=1", *(f for f in ST.nvcc_flags(1) if not f.startswith("-DNMPC_K3_")),
                     *ST.k3_shape_flags(m)]
        else:
            flags = [f"-DNMPC_NR={m}", *ST.nvcc_flags(m)]
        so = out / f"staged_tiles_{'_'.join(map(str, m)) if isinstance(m, tuple) else m}.so"
        subprocess.run([gxx, "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread",
                        "-ffp-contract=off", *flags,
                        f"-I{SRC_DIR}", str(HOST), "-o", str(so)], check=True,
                       capture_output=True, text=True)
        lib = ctypes.CDLL(str(so))
        V, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.host_k3_geometry.argtypes = [V]
        lib.host_k5_geometry.argtypes = [I, I, V]
        lib.host_k5_rows.argtypes = [I, I, I]
        lib.host_k5_rows.restype = I
        lib.host_riccati.argtypes = [V] * 10 + [I, I, F, I]
        lib.host_linesearch_costs.argtypes = [V, I] + [V] * 10 + [I] * 7
        lib.host_k4_geometry.argtypes = [I, I, V]
        lib.host_k4_rows.argtypes = [I, I, I]
        lib.host_k4_rows.restype = I
        lib.host_k6_geometry.argtypes = [V]
        lib.host_expansions.argtypes = [V, I] + [V] * 13 + [I] * 6
        lib.host_rollout_alpha.argtypes = [V] * 9 + [I] * 3
        return lib

    keys = (*HOST_ROBOTS, *ST.K3_SHAPES, *ST.K3_SWEEP_SHAPES)
    with ThreadPoolExecutor(len(keys)) as pool:
        return dict(zip(keys, pool.map(build, keys)))


def _p(t):
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def _riccati_inputs(m, B, N, seed):
    """General dense blocks (tests/test_ops.py's kind, the off-diagonal
    scales divided by sqrt(n) so that the value function stays positive
    definite over the horizon at every m), lane-major. m: a robot count or
    a stage shape (n, nu)."""
    rng = np.random.default_rng(seed)
    n, nu = ST.k3_dims(m)
    r = 1.0 / np.sqrt(n)
    A = rng.normal(size=(N, n, n, B)) * 0.2 * r + np.eye(n)[None, :, :, None]
    Bm = rng.normal(size=(N, n, nu, B)) * 0.3 * r
    M = rng.normal(size=(N, n, n, B))
    lxx = np.einsum("kijb,kljb->kilb", M, M) * 0.3 / n + np.eye(n)[None, :, :, None]
    M = rng.normal(size=(N, nu, nu, B))
    luu = np.einsum("kijb,kljb->kilb", M, M) * 0.3 / nu + np.eye(nu)[None, :, :, None]
    ins = (A, Bm, rng.normal(size=(N, n, B)), rng.normal(size=(N, nu, B)), lxx, luu,
           rng.normal(size=(N, nu, n, B)) * 0.2 * r)
    return tuple(torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)) for a in ins)


def _host_riccati(lib, exp, tiles, reg=1e-6):
    N, n, _, B = exp[0].shape
    nu = exp[1].shape[2]
    kff, Kfb, dV1 = torch.empty((N, nu, B)), torch.empty((N, nu, n, B)), torch.empty((B,))
    lib.host_riccati(*map(_p, exp), _p(kff), _p(Kfb), _p(dV1), B, N, reg, int(tiles))
    return kff, Kfb, dV1


@pytest.mark.parametrize("m", HOST_ROBOTS)
def test_host_geometry_matches_python(host_libs, m):
    lib = host_libs[m]
    g = (ctypes.c_int * 8)()
    lib.host_k3_geometry(g)
    g3, lay = ST.K3_GEOMETRY[m], ST.k3_layout(m)
    assert list(g) == [g3.S, g3.D, g3.T, g3.P, int(g3.spill), lay["threads"], lay["smem_bytes"],
                       lay["scratch_floats"]]
    for pairs, n_obs, n_mov in ((True, 0, 0), (False, 6, 0), (False, 0, 5), (True, 2, 3)):
        rows = ST.k5_rows(m, pairs, n_obs, n_mov)
        assert lib.host_k5_rows(int(pairs), n_obs, n_mov) == rows
        g5 = (ctypes.c_int * 4)()
        lib.host_k5_geometry(rows, 217, g5)
        assert list(g5) == [ST.K5_GEOMETRY[m].S, ST.K5_GEOMETRY[m].D, ST.k5_max_alphas(m),
                            ST.k5_layout(m, rows, 217, 9)["smem_bytes"]]
        rows4 = ST.k4_rows(m, pairs, n_obs, n_mov)
        assert lib.host_k4_rows(int(pairs), n_obs, n_mov) == rows4
        g4 = (ctypes.c_int * 4)()
        lib.host_k4_geometry(rows4, 217, g4)
        lay4 = ST.k4_layout(m, rows4, 217)
        assert list(g4) == [ST.K4_GEOMETRY[m].S, ST.K4_GEOMETRY[m].W, lay4["threads"],
                            lay4["smem_bytes"]]
    g6 = (ctypes.c_int * 5)()
    lib.host_k6_geometry(g6)
    k6, lay6 = ST.K6_GEOMETRY[m], ST.k6_layout(m)
    assert list(g6) == [k6.S, k6.D, k6.T, lay6["threads"], lay6["smem_bytes"]]


@pytest.mark.parametrize("B,N", [(32, 5), (33, 5), (33, 1)])
@pytest.mark.parametrize("m", HOST_ROBOTS)
def test_host_riccati_tiles_match_plain_and_first_design(host_libs, m, B, N):
    exp = _riccati_inputs(m, B, N, seed=m + B + N)
    got = _host_riccati(host_libs[m], exp, tiles=True)
    first = _host_riccati(host_libs[m], exp, tiles=False)
    assert all(torch.equal(a, b) for a, b in zip(got, first))   # no sum reordered
    v = KC.Verdict()
    for i, (g, w, atol) in enumerate(zip(got, riccati_plain(exp, 1e-6), KC.K3_ATOL)):
        KC.hold(v, f"K3 output {i}", g, w, atol)
    assert v.n_widened == 0 and v.units == B


@pytest.mark.parametrize("B,N", [(32, 5), (33, 5), (33, 1)])
def test_host_riccati_tiles_at_the_ray_shape_match_plain(host_libs, B, N):
    """K3 at (n, nu) = (13, 2), csrc/riccati_shape.cu's instantiation, held
    against riccati_plain at K3's tolerances (ops/kernel_check.py): every
    entry of the 409-row stage tile and the 544-float team slot read where
    the plain version reads it."""
    lib = host_libs[RAY_SHAPE]
    g = (ctypes.c_int * 8)()
    lib.host_k3_geometry(g)
    g3, lay = ST.K3_GEOMETRY[RAY_SHAPE], ST.k3_layout(RAY_SHAPE)
    assert list(g) == [g3.S, g3.D, g3.T, g3.P, int(g3.spill), lay["threads"], lay["smem_bytes"],
                       lay["scratch_floats"]]
    exp = _riccati_inputs(RAY_SHAPE, B, N, seed=13 + B + N)
    got = _host_riccati(lib, exp, tiles=True)
    v = KC.Verdict()
    for i, (gv, w, atol) in enumerate(zip(got, riccati_plain(exp, 1e-6), KC.K3_ATOL)):
        KC.hold(v, f"K3 (13, 2) output {i}", gv, w, atol)
    assert v.n_widened == 0 and v.units == B
    assert all(torch.isfinite(t).all() for t in got)


@pytest.mark.parametrize("B,N", [(32, 5), (33, 5), (33, 1)])
@pytest.mark.parametrize("shape", USER_SHAPES + ST.K3_SWEEP_SHAPES)
def test_host_riccati_tiles_at_user_model_shapes_match_plain(host_libs, shape, B, N):
    """K3 at the user models' stage shapes (csrc/riccati_shape.cu's
    instantiations at k3_rule's geometry: a thread a scenario, every block
    in registers, stage tiles of 7-16 rows in the ring's 16-byte copies and
    4-byte copies of a ragged tile) and at ST.K3_SWEEP_SHAPES (every branch
    of k3_rule: teams of 16 and 32 with nu = 1, odd nu and nu > T, both
    pitches, the spilled slots at a shape no robot stack has) against
    riccati_plain at K3's tolerances."""
    lib = host_libs[shape]
    g = (ctypes.c_int * 8)()
    lib.host_k3_geometry(g)
    g3, lay = ST.k3_geometry(shape), ST.k3_layout(shape)
    assert g3 == ST.k3_rule(*shape) and (g3.T == 1 or shape not in USER_SHAPES)
    assert list(g) == [g3.S, g3.D, g3.T, g3.P, int(g3.spill), lay["threads"], lay["smem_bytes"],
                       lay["scratch_floats"]]
    exp = _riccati_inputs(shape, B, N, seed=sum(shape) + B + N)
    got = _host_riccati(lib, exp, tiles=True)
    v = KC.Verdict()
    for i, (gv, w, atol) in enumerate(zip(got, riccati_plain(exp, 1e-6), KC.K3_ATOL)):
        KC.hold(v, f"K3 {shape} output {i}", gv, w, atol)
    assert v.n_widened == 0 and v.units == B
    assert all(torch.isfinite(t).all() for t in got)


def test_k3_rule_gives_the_picks_and_bounds_the_shapes():
    """k3_rule reproduces every pick of K3_GEOMETRY (the sweep's, and the
    ray shape's), fits every shape of its range in a block, and refuses
    shapes beyond it."""
    for key, g in ST.K3_GEOMETRY.items():
        assert ST.k3_rule(*ST.k3_dims(key)) == g, key
    for key in ST.K3_SHAPES:
        assert ST.k3_layout(key)["blocks_per_sm"] == ST.K3_BLOCKS_PER_SM[key], key
    for n in range(1, ST.K3_MAX_N + 1):
        for nu in range(1, ST.K3_MAX_NU + 1):
            lay = ST.k3_layout((n, nu))
            assert lay["smem_bytes"] <= ST.SMEM_BLOCK_MAX and lay["threads"] <= 1024, (n, nu)
    for bad in ((ST.K3_MAX_N + 1, 2), (3, ST.K3_MAX_NU + 1), (0, 1)):
        with pytest.raises(NotImplementedError):
            ST.k3_rule(*bad)
    assert ST.k3_shape_flags((2, 1))[:2] == ["-DNMPC_K3_N=2", "-DNMPC_K3_NU=1"]


def test_host_riccati_tiles_match_pallas_kernel(host_libs):
    exp = _riccati_inputs(2, 128, 5, seed=7)   # the Pallas wrapper takes 128-lane tiles
    kr, Kr, dr = jax_riccati(*[jnp.asarray(np.moveaxis(t.numpy(), -1, 0)) for t in exp],
                             interpret=True)
    kff, Kfb, dV1 = _host_riccati(host_libs[2], exp, tiles=True)
    np.testing.assert_allclose(np.moveaxis(kff.numpy(), -1, 0), np.asarray(kr), atol=5e-5)
    np.testing.assert_allclose(np.moveaxis(Kfb.numpy(), -1, 0), np.asarray(Kr), atol=5e-5)
    np.testing.assert_allclose(dV1.numpy(), np.asarray(dr), atol=5e-4)


def _cost_problem(m, N):
    """An OCP of m robots whose rows the merits exercise: m=1 at
    obstacle_scenario_3 (six static obstacles) or with two moving-obstacle
    slots; m >= 2 with pair rows."""
    if m == 1:
        return [get("obstacle_scenario_3").make(N=N, device="cpu"),
                P.make_ocp(m=1, N=N, T=0.1, x0=[0.0, 0.0, 0.0], x_goal=[0.6, 0.0, 0.0], dmin=0.3,
                           mov_obs=torch.zeros((N, 2, 2)), device="cpu")]
    return [get({2: "two_robot_swap", 6: "six_robot_antipodal"}[m]).make(N=N, device="cpu")]


def _cost_inputs(ocp, B, seed):
    rng = np.random.default_rng(seed)
    N, n, nu = ocp.N, ocp.nx, ocp.nu
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))  # noqa: E731
    X = ocp.x0.numpy()[None, :, None] + 0.4 * rng.standard_normal((N, n, B))
    if ocp.n_obs:
        X[:, 0:n:3] = ocp.obstacles[0, 0].item() + 0.3 * rng.standard_normal((N, ocp.m, B))
        X[:, 1:n:3] = ocp.obstacles[0, 1].item() + 0.3 * rng.standard_normal((N, ocp.m, B))
    lam = 0.5 * np.abs(rng.standard_normal((N, ocp.n_con, B)))
    lam *= P.constraint_mask(ocp).numpy()[..., None] > 0
    d = dict(X=t(X), U=t(0.1 * rng.standard_normal((N, nu, B))),
             kff=t(0.1 * rng.standard_normal((N, nu, B))),
             Kfb=t(0.1 * rng.standard_normal((N, nu, n, B))),
             xref=t(np.broadcast_to(ocp.xref.numpy()[..., None], (N, n, B))), lam=t(lam),
             mu=t(rng.choice([10.0, 100.0], B)), mov=None)
    d["x0"] = d["X"][0].contiguous()
    if ocp.n_mov:
        mov = np.repeat(X[:, None, 0:2], ocp.n_mov, axis=1).reshape(N, 2 * ocp.n_mov, B)
        d["mov"] = t(mov + 0.3 * rng.standard_normal(mov.shape))
    return d


def _host_costs(lib, ocp, d, alphas, tiles):
    prm = R.params(ocp, alphas, "cpu")
    B = d["x0"].shape[-1]
    costs = torch.empty((len(alphas), B))
    lib.host_linesearch_costs(
        _p(prm), prm.numel(), *(_p(d[k]) for k in ("x0", "X", "U", "kff", "Kfb", "xref", "lam",
                                                     "mu", "mov")),
        _p(costs), B, ocp.N, len(alphas), int(ocp.n_pairs > 0), ocp.n_obs, ocp.n_mov, int(tiles))
    return costs


@pytest.mark.parametrize("B,N", [(32, 5), (33, 5), (33, 1)])
@pytest.mark.parametrize("m", HOST_ROBOTS)
def test_host_linesearch_tiles_match_plain_and_first_design(host_libs, m, B, N):
    for i, ocp in enumerate(_cost_problem(m, N)):
        d = _cost_inputs(ocp, B, seed=10 * m + B + N + i)
        got = _host_costs(host_libs[m], ocp, d, ALPHAS, tiles=True)
        assert torch.equal(got, _host_costs(host_libs[m], ocp, d, ALPHAS, tiles=False))
        want = R.linesearch_costs_plain(ocp, d["x0"], d["X"], d["U"], d["kff"], d["Kfb"],
                                        d["xref"], d["lam"], d["mu"], ALPHAS, d["mov"])
        torch.testing.assert_close(got, want, rtol=KC.K5_RTOL, atol=KC.K5_ATOL)
        assert torch.isfinite(got).all()


def _host_expansions(lib, ocp, d, tiles):
    """K4 on the harness; outputs start as NaN, so an entry left unwritten
    shows."""
    prm = R.params(ocp, (), "cpu")
    N, n, nu, B = ocp.N, ocp.nx, ocp.nu, d["x0"].shape[-1]
    outs = [torch.full(s, float("nan")) for s in (
        (N, n, n, B), (N, n, nu, B), (N, n, B), (N, nu, B), (N, n, n, B), (N, nu, nu, B),
        (N, nu, n, B))]
    lib.host_expansions(_p(prm), prm.numel(), *(_p(d[k]) for k in ("X", "U", "xref", "lam", "mu",
                                                                     "mov")),
                        *map(_p, outs), B, N, int(ocp.n_pairs > 0), ocp.n_obs, ocp.n_mov,
                        int(tiles))
    return outs


@pytest.mark.parametrize("B,N", [(32, 5), (33, 5), (33, 1)])
@pytest.mark.parametrize("m", HOST_ROBOTS)
def test_host_expansion_tiles_match_plain_and_first_design(host_libs, m, B, N):
    from nmpc_tpu_torch.ops.expansions import expansions_plain

    for i, ocp in enumerate(_cost_problem(m, N)):
        d = _cost_inputs(ocp, B, seed=20 * m + B + N + i)
        got = _host_expansions(host_libs[m], ocp, d, tiles=True)
        first = _host_expansions(host_libs[m], ocp, d, tiles=False)
        assert all(torch.equal(a, b) for a, b in zip(got, first))   # every term in its order
        want = expansions_plain(ocp, d["X"], d["U"], d["xref"], d["lam"], d["mu"], d["mov"])
        v = KC.Verdict()
        for j, (g, w, atol) in enumerate(zip(got, want, KC.K4_ATOL)):
            KC.hold(v, f"K4 output {j}", g, w, atol)
        assert v.units == B and v.n_widened == 0
        if N > 1 and (ocp.n_obs or ocp.n_mov):   # past stage 0 the obstacle rows bite
            assert float(got[4].abs().sum()) > float(torch.diagonal(got[4], 0, 1, 2).abs().sum())


def _host_rollout(lib, ocp, d, alpha, tiles):
    prm = R.params(ocp, (), "cpu")
    N, n, nu, B = ocp.N, ocp.nx, ocp.nu, d["x0"].shape[-1]
    Xout, Uout = torch.full((N, n, B), float("nan")), torch.full((N, nu, B), float("nan"))
    lib.host_rollout_alpha(_p(prm), *(_p(d[k]) for k in ("x0", "X", "U", "kff", "Kfb")),
                           _p(alpha), _p(Xout), _p(Uout), B, N, int(tiles))
    return Xout, Uout


@pytest.mark.parametrize("B,N", [(32, 5), (33, 5), (33, 1)])
@pytest.mark.parametrize("m", HOST_ROBOTS)
def test_host_rollout_tiles_match_plain_and_first_design(host_libs, m, B, N):
    ocp = _cost_problem(m, N)[0]
    d = _cost_inputs(ocp, B, seed=30 * m + B + N)
    alpha = torch.tensor(ALPHAS)[torch.arange(B) % len(ALPHAS)].contiguous()
    got = _host_rollout(host_libs[m], ocp, d, alpha, tiles=True)
    assert all(torch.equal(a, b)
               for a, b in zip(got, _host_rollout(host_libs[m], ocp, d, alpha, tiles=False)))
    want = R.rollout_alpha_plain(ocp, d["x0"], d["X"], d["U"], d["kff"], d["Kfb"], alpha)
    v = KC.Verdict()
    for j, (g, w) in enumerate(zip(got, want)):
        KC.hold(v, f"K6 output {j}", g, w, KC.K6_ATOL)
    assert v.units == B and v.n_widened == 0 and torch.isfinite(got[0]).all()


def test_staged_launch_sweeps_the_picks_and_reads_the_report():
    """The sweep's first candidate per m is the solver's pick, every
    candidate is a geometry the kernels take and that fits a block; its
    report parser finds K3's and K5's lines; without a card it refuses."""
    from nmpc_tpu_torch.tools import staged_launch as SL

    assert set(SL.CANDIDATES) == set(SL.CANDIDATES46) == set(SL.SCENARIOS) == set(ROBOT_COUNTS)
    for m, cands in SL.CANDIDATES.items():
        assert cands[0] == (ST.K3_GEOMETRY[m], ST.K5_GEOMETRY[m])
        for k3, k5 in cands:
            assert ST.k3_layout(m, k3)["smem_bytes"] <= ST.SMEM_BLOCK_MAX
            assert ST.k5_layout(m, 32, 100, len(ALPHAS), k5)["threads"] <= ST.K5_THREADS
    for m, cands in SL.CANDIDATES46.items():
        assert cands[0] == (ST.K4_GEOMETRY[m], ST.K6_GEOMETRY[m])
        assert len(set(cands)) == len(cands)
        for k4, k6 in cands:
            assert ST.k4_layout(m, ST.k4_rows(m, m > 1, 6, 0), 200, k4)["smem_bytes"] <= ST.SMEM_BLOCK_MAX
            assert ST.k6_layout(m, k6)["smem_bytes"] <= ST.SMEM_BLOCK_MAX
    assert all(get(name).make(device="cpu").m == m for m, name in SL.SCENARIOS.items())
    report = """ptxas info    : Compiling entry function '_ZN4nmpc14riccati_kernelILi6EEEvNS_11RiccatiArgsEPfi' for 'sm_90a'
ptxas info    : Function properties for _ZN4nmpc14riccati_kernelILi6EEEvNS_11RiccatiArgsEPfi
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN4nmpc23linesearch_costs_kernelILi6EEEvNS_8CostArgsEii' for 'sm_90a'
ptxas info    : Function properties for _ZN4nmpc23linesearch_costs_kernelILi6EEEvNS_8CostArgsEii
    176 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 86 registers, used 1 barriers, 176 bytes cumulative stack size
"""
    report += """ptxas info    : Compiling entry function '_ZN4nmpc17expansions_kernelILi6EEEvNS_7ExpArgsEii' for 'sm_90a'
ptxas info    : Function properties for _ZN4nmpc17expansions_kernelILi6EEEvNS_7ExpArgsEii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 90 registers, used 1 barriers
"""
    lines = SL.staged_ptxas(report)
    assert lines["K3"].endswith("Used 128 registers, used 1 barriers")
    assert lines["K5"].startswith("176 bytes stack frame")
    assert lines["K4"].endswith("Used 90 registers, used 1 barriers") and "K6" not in lines
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA card"):
            SL.main([])
