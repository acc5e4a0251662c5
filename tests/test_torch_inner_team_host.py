"""The device code of K1's team design (csrc/inner_team.cuh, a team of T
lanes per scenario, the line-search candidates side by side) compiled as
host C++ (tests/inner_team_host.cpp: a team's lanes are T std::threads with
a std::barrier for __syncwarp, a width-T shuffle an exchange through
memory, the ring of stage rows NaN-filled), against the plain PyTorch
version, at m=1 and m=2 in both instantiations: pair and box rows only
(slsqp_pose, two_robot_swap) and the obstacle variant at the problems of
tests/obstacle_cases.py (static obstacles, per-scenario moving-obstacle
schedules, pairs with obstacles and moving obstacles), at consensus48's 47
moving-obstacle rows, at path (b)'s horizon N=100, with grids of more
candidates than a team has lanes (passes) and ragged batches. A second
build at other compile-time settings (T=4, a ring of 2 slots) is held the
same way, and bit for bit against the default build (T=8 at m=1, a ring of
3) where T does not change the order of a sum (no obstacle rows). The
default builds' settings are tools/k1_launch.py's TEAM_BASE.

Tolerances: chip_smoke.py phase 3's (cost rtol 1e-4, U and Xs atol 5e-3,
iteration counts equal); the merit is summed in another order (each stage
in row order, the stages by a compensated sum), so not bit for bit.
Skipped where g++ is missing.
"""

import ctypes
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import pytest
import torch

import obstacle_cases as OC
from nmpc_tpu_torch.ocp import problem as P
from nmpc_tpu_torch.ops import megasolve, rollout
from nmpc_tpu_torch.ops import cuda_build
from nmpc_tpu_torch.ops.cuda_build import SRC_DIR
from nmpc_tpu_torch.parallel import batch_ocp
from nmpc_tpu_torch.scenarios import get
from nmpc_tpu_torch.solver import ALILQRConfig

HOST = Path(__file__).resolve().parent / "inner_team_host.cpp"
# (m, compile-time settings): the defaults at m = 1, 2, and one other build
BUILDS = {"m1": (1, {}), "m2": (2, {}),
          "m1 T=4 D=2": (1, {"NMPC_K1_TEAM": 4, "NMPC_K1_TEAM_RING": 2})}
B = 12   # not a multiple of 32 / T (4 teams a warp at T=8, 8 at T=4)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def host_libs(tmp_path_factory):
    """{build name: the harness built at its robot count and settings}."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed: the host rehearsal cannot be built")
    out = tmp_path_factory.mktemp("inner_team")

    def build(item):
        name, (m, flags) = item
        so = out / f"inner_team_{name.replace(' ', '_').replace('=', '')}.so"
        subprocess.run([gxx, "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread",
                        "-ffp-contract=off", "-fno-strict-aliasing", f"-DNMPC_NR={m}",
                        *(f"-D{k}={v}" for k, v in flags.items()), f"-I{SRC_DIR}", str(HOST),
                        "-o", str(so)], check=True, capture_output=True, text=True)
        lib = ctypes.CDLL(str(so))
        V, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.host_k1_team_geometry.argtypes = [V]
        lib.host_k1_team_ring_bytes.argtypes = [I, I, I]
        lib.host_k1_team_ring_bytes.restype = I
        lib.host_inner_solve_team.argtypes = [V] * 14 + [I] * 7 + [F] * 6 + [V] + [I] * 3
        return lib

    with ThreadPoolExecutor(len(BUILDS)) as pool:
        return dict(zip(BUILDS, pool.map(build, BUILDS.items())))


def _p(t):
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def geometry(lib) -> dict:
    g = (ctypes.c_int * 3)()
    lib.host_k1_team_geometry(g)
    return dict(zip(("T", "D", "min_blocks"), g))


def host_team(lib, ocp, x0, xref, lam, mu, U, cfg):
    """K1's team design on the host, with the wrapper's arguments and
    scratch (NaN-filled)."""
    nb, N, n, nu = x0.shape[0], ocp.N, ocp.nx, ocp.nu
    mov, stride = megasolve._mov_args(ocp, nb, x0.device)
    nan = lambda *s: torch.full(s, float("nan"))  # noqa: E731
    Xs, Uo, cost = nan(nb, N, n), nan(nb, N, nu), nan(nb)
    scratch = (nan(nb, N, nu), nan(nb, N, nu, n), nan(nb, N, n), nan(nb, N, nu))
    iters = torch.full((nb,), -1, dtype=torch.int32)
    prm = rollout.params(ocp, cfg.alphas, "cpu")
    args = [t.contiguous() for t in (x0, xref, lam, mu, U)]
    lib.host_inner_solve_team(
        _p(prm), *map(_p, args), _p(Xs), _p(Uo), _p(cost), _p(iters), *map(_p, scratch),
        nb, N, cfg.n_inner, int(cfg.ls == "adaptive"), len(cfg.alphas), cfg.ls_rounds,
        int(ocp.n_pairs > 0), cfg.reg, cfg.armijo, cfg.tol_cost, cfg.ls_beta, cfg.ls_grow,
        cfg.ls_trial_min, _p(mov), ocp.n_obs, ocp.n_mov, stride)
    return Xs, Uo, cost, iters


def _registry_case(name, nb, N, seed):
    """A registry scenario at horizon N, nb starts jittered by 0.1, warm
    inputs of the CPU tests' kind."""
    g = torch.Generator().manual_seed(seed)
    base = get(name).make(N=N, device="cpu")
    ob = batch_ocp(base, base.x0[None] + 0.1 * torch.randn((nb, base.nx), generator=g))
    U = 0.05 * torch.randn((nb, N, base.nu), generator=g)
    lam = 0.5 * torch.randn((nb, N, base.n_con), generator=g).abs()
    lam = lam * (P.constraint_mask(base) > 0)
    mu = torch.tensor([10.0, 100.0, 1e3, 1e4])[torch.randint(0, 4, (nb,), generator=g)]
    return ob, U, lam, mu


def _case(name):
    if name in OC.CASES or name == "consensus48":
        return OC.port_case(name, 5 if name == "consensus48" else B, seed=5)
    if name == "obstacle_scenario_3 N=100":
        ob, U, lam, mu = _registry_case("obstacle_scenario_3", 3, 100, seed=6)
        return ob, U, lam, mu
    return _registry_case(name, B, 10, seed=5)


def _hold(got, want):
    torch.testing.assert_close(got[2], want[2], rtol=1e-4, atol=0.0)
    torch.testing.assert_close(got[1], want[1], rtol=0.0, atol=5e-3)
    torch.testing.assert_close(got[0], want[0], rtol=0.0, atol=5e-3)
    assert torch.equal(got[3], want[3])


CASES = ("slsqp_pose", "two_robot_swap") + OC.CASES + ("consensus48",)


@pytest.mark.parametrize("ls", ["adaptive", "cascade"])
@pytest.mark.parametrize("name", CASES)
def test_host_team_matches_plain(host_libs, name, ls):
    """The default build (and the other build at m=1) against the plain
    version at n_inner=4; the obstacle rows bind on some scenarios."""
    ob, U, lam, mu = _case(name)
    cfg = ALILQRConfig(n_inner=4, ls=ls)
    want = megasolve.inner_solve_plain(ob, ob.x0, ob.xref, lam, mu, U, cfg)
    assert int(want[3].max()) >= 2
    got = host_team(host_libs[f"m{ob.m}"], ob, ob.x0, ob.xref, lam, mu, U, cfg)
    _hold(got, want)
    if ob.m == 1:
        other = host_team(host_libs["m1 T=4 D=2"], ob, ob.x0, ob.xref, lam, mu, U, cfg)
        _hold(other, want)
        if not megasolve.obstacle_rows(ob):
            assert all(torch.equal(a, b) for a, b in zip(other, got))
    rows = megasolve.obstacle_rows(ob)
    if rows:
        w2 = megasolve.al_update_plain(ob, got[0], got[1], lam, mu, 1e6)
        i0 = ob.n_pairs
        active = (w2[0][:, 1:, i0:i0 + rows] > 0).any(1)
        assert active.float().mean() > 0.01
        if name == "consensus48":   # slots past the fifth bind too
            assert bool(active[:, 5:].any())


@pytest.mark.parametrize("n_alphas", [9, 33])
def test_host_team_with_more_alphas_than_lanes(host_libs, n_alphas):
    """A cascade of more alphas than the team has lanes runs in passes of T
    in the grid's order (33: five passes at T=8, nine at T=4), and an
    adaptive search of more rounds than lanes likewise."""
    ob, U, lam, mu = _case("obstacle_scenario_3")
    grid = ALILQRConfig().alphas
    alphas = (grid + tuple(grid[-1] * 0.7 ** k for k in range(1, n_alphas)))[:n_alphas]
    for cfg in (ALILQRConfig(n_inner=4, ls="cascade", alphas=alphas),
                ALILQRConfig(n_inner=4, ls="adaptive", ls_rounds=n_alphas, ls_beta=0.5)):
        want = megasolve.inner_solve_plain(ob, ob.x0, ob.xref, lam, mu, U, cfg)
        for name in ("m1", "m1 T=4 D=2"):
            _hold(host_team(host_libs[name], ob, ob.x0, ob.xref, lam, mu, U, cfg), want)


def test_host_team_at_path_b_horizon(host_libs):
    """obstacle_scenario_3 at its registry horizon N=100 (path (b)'s
    problem), two iterations, both line searches, against the plain version
    summed in the team's order (al_merit_team_order: at N=100 the summation
    order alone moves the merit by ~1e-6 relative)."""
    ob, U, lam, mu = _case("obstacle_scenario_3 N=100")
    for ls in ("cascade", "adaptive"):
        cfg = ALILQRConfig(n_inner=2, ls=ls)
        want = megasolve.inner_solve_plain(ob, ob.x0, ob.xref, lam, mu, U, cfg,
                                           merit=megasolve.al_merit_team_order)
        _hold(host_team(host_libs["m1"], ob, ob.x0, ob.xref, lam, mu, U, cfg), want)


def test_team_order_merit_is_the_merit():
    """al_merit_team_order computes al_merit (to f32 rounding) and keeps a
    non-finite activation on a stage-0 state row out, as al_merit does."""
    ob, U, lam, mu = _case("all_rows")
    X = P.rollout(ob, U)
    lam = lam.clone()
    lam[:, 0, :ob.n_pairs] = float("nan")
    torch.testing.assert_close(megasolve.al_merit_team_order(ob, X, U, lam, mu),
                               megasolve.al_merit(ob, X, U, lam, mu), rtol=1e-6, atol=0.0)


def test_host_defaults_are_the_sweeps_base(host_libs):
    """The header's default settings at m = 1, 2 are the base that
    tools/k1_launch.py's team sweep times the others against."""
    from nmpc_tpu_torch.tools.k1_launch import TEAM_BASE

    for m in (1, 2):
        geo = geometry(host_libs[f"m{m}"])
        assert {k: geo[k] for k in ("T", "D")} == {k: TEAM_BASE[m][k] for k in ("T", "D")}


@pytest.mark.parametrize("name", list(BUILDS))
def test_host_team_ring_sizes(host_libs, name):
    """A team's ring: D slots of the stage's rows (nominal state and
    control, kff, K, reference, nc duals, 2 n_mov schedule floats), padded
    so that consecutive teams start T floats apart modulo 32 banks; the
    block of K1_TEAM_WARPS warps' rings at 47 moving rows within the H100's
    227 KB."""
    m, _ = BUILDS[name]
    lib = host_libs[name]
    geo = geometry(lib)
    n, nu = 3 * m, 2 * m
    for R, n_mov in ((0, 0), (m, 0), (5 * m, 5), (47, 47)):
        ring = lib.host_k1_team_ring_bytes(R, n_mov, int(m > 1)) // 4
        nc = m * (m - 1) // 2 + R + 2 * nu + 2 * n
        assert ring >= geo["D"] * (2 * n + 2 * nu + nu * n + nc + 2 * n_mov)
        assert ring % 32 == geo["T"] % 32
    teams = megasolve.K1_TEAM_WARPS * 32 // geo["T"]
    smem = teams * lib.host_k1_team_ring_bytes(47, 47, 0) + 4 * rollout._P(3, 2, 8, 0).size
    assert smem <= megasolve.SMEM_BLOCK_MAX


def test_team_route_on_the_cpu():
    """On CPU tensors K1's wrapper runs the plain version (no kernel, no
    fallback); the team launcher refuses them."""
    assert cuda_build.TEAM_ROBOTS == (1, 2)
    ob, U, lam, mu = _case("two_robot_swap")
    cfg = ALILQRConfig(n_inner=2)
    got = megasolve.inner_solve_fused(ob, ob.x0, ob.xref, lam, mu, U, cfg)
    want = megasolve.inner_solve_plain(ob, ob.x0, ob.xref, lam, mu, U, cfg)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    with pytest.raises(NotImplementedError, match="no kernel for cpu"):
        megasolve.team_launch(ob, ob.x0, ob.xref, lam, mu, U, cfg, "K1", None, 2)
