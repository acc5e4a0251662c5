"""The device code of K1 and K2 (csrc/inner_warp.cuh, one warp per
scenario) compiled as host C++ (tests/inner_warp_host.cpp: a warp's lanes
are 32 coroutines of tests/host_lanes.h with a barrier for __syncwarp, a
shuffle an exchange through memory), against the plain PyTorch versions, in both
instantiations: the pair-only kernels of the main path
(six_robot_antipodal) and of robot counts past the registry's
(scenarios/robot_counts.py at N=10: the circle at m=7, one state row a
lane; the widened crossing at m=12 and 16, where a lane owns two state rows
and two right-hand sides, and three and four pair rows), and the obstacle
variant at the problems of
tests/obstacle_cases.py (static obstacles, per-scenario moving-obstacle
schedules, and pairs, obstacles and a shared schedule together). The slot
starts as NaN, so an entry read before the kernel writes it shows.

Tolerances: K1 at n_inner=4 as chip_smoke.py phase 3 holds the card's
kernel (cost rtol 1e-4, U and Xs atol 5e-3, iteration counts equal); the
merit is summed in another order, so not bit for bit. K2 at phase 2's rtol
and atol 1e-6 (each row rounded as the plain version rounds it). Also the
slot sizing per obstacle rows.

The roofline tools' variants of K1's warp design are held in
tests/test_torch_inner_warp_variants_host.py (a file of their own, so that
xdist's loadfile gives them their own worker). Skipped where g++ is
missing.
"""

import ctypes
from pathlib import Path

import pytest
import torch

import host_build
import obstacle_cases as OC
from nmpc_tpu_torch.ocp import problem as P
from nmpc_tpu_torch.ops import megasolve, rollout
from nmpc_tpu_torch.parallel import batch_ocp
from nmpc_tpu_torch.scenarios import get, robot_counts
from nmpc_tpu_torch.solver import ALILQRConfig

HOST = Path(__file__).resolve().parent / "inner_warp_host.cpp"
HOST_ROBOTS = (1, 2, 6, 7, 12, 16)
B = 16


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def bind(lib):
    """The harness's entry points' argument types."""
    V, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.host_k1_slot_bytes.argtypes = [I]
    lib.host_k1_slot_bytes.restype = I
    lib.host_inner_solve.argtypes = [V] * 14 + [I] * 7 + [F] * 6 + [V] + [I] * 3
    lib.host_al_update.argtypes = [V] * 7 + [I] * 3 + [F] + [V] + [I] * 3
    lib.host_warp_slot_bytes.argtypes = [I]
    lib.host_warp_slot_bytes.restype = I
    lib.host_phase_ablation.argtypes = [I] * 3 + [V] * 14 + [I] * 7 + [F] * 6
    lib.host_phase_ablation.restype = I
    return lib


def host_libs_at(robots) -> dict:
    """{m: the harness built for m robots} (tests/host_build.py)."""
    libs = host_build.build_all(HOST.name, {m: [f"-DNMPC_NR={m}"] for m in robots})
    return {m: bind(lib) for m, lib in libs.items()}


@pytest.fixture(scope="module")
def host_libs():
    return host_libs_at(HOST_ROBOTS)


def _p(t):
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def host_k1(lib, ocp, x0, xref, lam, mu, U, cfg):
    """K1's device code on the host, with the wrapper's arguments."""
    nb, N, n, nu = x0.shape[0], ocp.N, ocp.nx, ocp.nu
    mov, stride = megasolve._mov_args(ocp, nb, x0.device)
    nan = lambda *s: torch.full(s, float("nan"))  # noqa: E731
    Xs, Uo, cost = nan(nb, N, n), nan(nb, N, nu), nan(nb)
    scratch = (nan(nb, N, nu), nan(nb, N, n, nu), nan(2, nb, N, n), nan(2, nb, N, nu))
    iters = torch.full((nb,), -1, dtype=torch.int32)
    prm = rollout.params(ocp, cfg.alphas, "cpu")
    args = [t.contiguous() for t in (x0, xref, lam, mu, U)]
    lib.host_inner_solve(
        _p(prm), *map(_p, args), _p(Xs), _p(Uo), _p(cost), _p(iters), *map(_p, scratch),
        nb, N, cfg.n_inner, int(cfg.ls == "adaptive"), len(cfg.alphas), cfg.ls_rounds,
        int(ocp.n_pairs > 0), cfg.reg, cfg.armijo, cfg.tol_cost, cfg.ls_beta, cfg.ls_grow,
        cfg.ls_trial_min, _p(mov), ocp.n_obs, ocp.n_mov, stride)
    return Xs, Uo, cost, iters


def host_k2(lib, ocp, Xs, U, lam, mu, lam_max):
    """K2's device code on the host, with the wrapper's arguments."""
    nb = Xs.shape[0]
    mov, stride = megasolve._mov_args(ocp, nb, Xs.device)
    lam_new = torch.full((nb, ocp.N, ocp.n_con), float("nan"))
    viol = torch.full((nb,), float("nan"))
    args = [t.contiguous() for t in (Xs, U, lam, mu)]
    prm = rollout.params(ocp, (), "cpu")     # held: the call reads it
    lib.host_al_update(_p(prm), *map(_p, args), _p(lam_new),
                       _p(viol), nb, ocp.N, int(ocp.n_pairs > 0), lam_max, _p(mov), ocp.n_obs,
                       ocp.n_mov, stride)
    return lam_new, viol


# the robot counts past the registry's: (builder of scenarios/robot_counts.py, m)
WIDE = {"circle7": (robot_counts.circle, 7), "crossing12": (robot_counts.crossing, 12),
        "crossing16": (robot_counts.crossing, 16)}


def _case(name):
    if name != "six_robot_antipodal" and name not in WIDE:
        return OC.port_case(name, B, seed=5)
    g = torch.Generator().manual_seed(5)
    if name in WIDE:
        build, m = WIDE[name]
        base = P.make_ocp(**build(m, N=10), device="cpu")
    else:
        base = get(name).make(N=10, device="cpu")
    ob = batch_ocp(base, base.x0[None] + 0.1 * torch.randn((B, base.nx), generator=g))
    U = 0.05 * torch.randn((B, base.N, base.nu), generator=g)
    lam = 0.5 * torch.randn((B, base.N, base.n_con), generator=g).abs()
    lam = lam * (P.constraint_mask(base) > 0)
    mu = torch.tensor([10.0, 100.0, 1e3, 1e4])[torch.randint(0, 4, (B,), generator=g)]
    return ob, U, lam, mu


CASES = ("six_robot_antipodal", *WIDE) + OC.CASES


@pytest.mark.parametrize("ls", ["adaptive", "cascade"])
@pytest.mark.parametrize("name", CASES)
def test_host_k1_and_k2_match_plain(host_libs, name, ls):
    ob, U, lam, mu = _case(name)
    lib = host_libs[ob.m]
    cfg = ALILQRConfig(n_inner=4, ls=ls)
    got = host_k1(lib, ob, ob.x0, ob.xref, lam, mu, U, cfg)
    want = megasolve.inner_solve_plain(ob, ob.x0, ob.xref, lam, mu, U, cfg)
    torch.testing.assert_close(got[2], want[2], rtol=1e-4, atol=0.0)
    torch.testing.assert_close(got[1], want[1], rtol=0.0, atol=5e-3)
    torch.testing.assert_close(got[0], want[0], rtol=0.0, atol=5e-3)
    assert torch.equal(got[3], want[3])
    assert int(want[3].max()) >= 2
    # K2 on K1's output
    g2 = host_k2(lib, ob, got[0], got[1], lam, mu, 1e6)
    w2 = megasolve.al_update_plain(ob, got[0], got[1], lam, mu, 1e6)
    torch.testing.assert_close(g2[0], w2[0], rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(g2[1], w2[1], rtol=1e-6, atol=1e-6)
    rows = megasolve.obstacle_rows(ob)
    if rows:   # the obstacle rows are active on some scenarios
        i0 = ob.n_pairs
        assert (w2[0][:, 1:, i0:i0 + rows] > 0).float().mean() > 0.01


@pytest.mark.parametrize("m", HOST_ROBOTS)
def test_host_slot_takes_the_obstacle_rows(host_libs, m):
    """The slot grows with the obstacle rows R: room for Vxx twice, Qux,
    Quu, the stage's np + R + 2 nu + 2 n duals and the rows' [5, R] table,
    16-byte aligned, the pair-only slot at R = 0."""
    lib = host_libs[m]
    n, nu = 3 * m, 2 * m
    for R in (0, 1, m, 5 * m, 37):
        slot = lib.host_k1_slot_bytes(R)
        n_con = m * (m - 1) // 2 + R + 2 * nu + 2 * n
        assert slot % 16 == 0
        assert slot >= 4 * (2 * n * n + nu * n + nu * nu + n_con + 5 * R)
        assert R == 0 or slot >= lib.host_k1_slot_bytes(R - 1)


def test_host_k1_at_the_consensus_width(host_libs):
    """K1's and K2's obstacle variant at the widest row count a port path
    gives it: one robot of the 48-robot consensus fleet, 47 moving-obstacle
    rows, N=20 (tests/obstacle_cases.py consensus48), at the tolerances
    above; and the block's dynamic shared memory at 47 rows (K1_WARPS
    slots and the parameter block) within the H100's 227 KB."""
    ob, U, lam, mu = OC.port_case("consensus48", 4, seed=7)
    assert (ob.n_mov, ob.N, megasolve.obstacle_rows(ob)) == (47, 20, 47)
    lib = host_libs[1]
    cfg = ALILQRConfig(n_inner=4, ls="adaptive")
    got = host_k1(lib, ob, ob.x0, ob.xref, lam, mu, U, cfg)
    want = megasolve.inner_solve_plain(ob, ob.x0, ob.xref, lam, mu, U, cfg)
    torch.testing.assert_close(got[2], want[2], rtol=1e-4, atol=0.0)
    torch.testing.assert_close(got[1], want[1], rtol=0.0, atol=5e-3)
    torch.testing.assert_close(got[0], want[0], rtol=0.0, atol=5e-3)
    assert torch.equal(got[3], want[3])
    g2 = host_k2(lib, ob, got[0], got[1], lam, mu, 1e6)
    w2 = megasolve.al_update_plain(ob, got[0], got[1], lam, mu, 1e6)
    torch.testing.assert_close(g2[0], w2[0], rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(g2[1], w2[1], rtol=1e-6, atol=1e-6)
    # slots on the way are active, and not only among the first five
    active = (w2[0][:, 1:, :47] > 0).any(1)                     # [B, 47]
    assert active.float().mean() > 0.01 and bool(active[:, 5:].any())
    smem = (megasolve.K1_WARPS * lib.host_k1_slot_bytes(47)
            + 4 * rollout._P(ob.nx, ob.nu, len(cfg.alphas), ob.n_obs).size)
    assert smem <= megasolve.SMEM_BLOCK_MAX == 227 * 1024
