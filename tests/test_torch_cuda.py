"""The CUDA kernels on the card against their plain PyTorch versions, and the
wrappers' refusals. Needs a CUDA device; skipped without one. Run on a GPU
machine with

    python -m pytest tests/test_torch_cuda.py -m gpu --noconftest -q

(--noconftest: the suite's conftest.py configures JAX, which these tests
neither need nor import.)

Tolerances: K2 rtol/atol 1e-6 (the kernel rounds each row as the plain
version does); K1 at n_inner=4 cost rtol 1e-4, U atol 5e-3 and equal
iteration counts on 99% of scenarios (past the first iterations f32
rounding can flip near-tied alpha picks), at every robot count and at the
edges of its launch geometry (a ragged last block, B=1, N=1, N=20); K1's
team design at m <= 2 (the route's K1 there) likewise, with the route
shown to launch it and never the warp design, which stays launchable for
the A/B; K1's and K2's obstacle variant at the same tolerances on the problems of
tests/obstacle_cases.py (static obstacles, per-scenario moving-obstacle
schedules, every row kind with a shared schedule). K3-K6:
the CPU tests' tolerances (tests/test_torch_staged_ops.py), relative to each
scenario's largest magnitude of an output where that exceeds 1, by the rule
of nmpc_tpu_torch/ops/kernel_check.py that chip_smoke.py phase 10 applies too;
at these inputs no scenario may diverge or pass by the f32 spread alone.
K3-K6 against their first designs (tools/staged_launch.py) bit for bit,
at the edges of the tile designs; K5 also at line-search grids longer than
one launch takes, and K1 with 33 alphas against plain as above. K7 bit for bit (the plain chain rounds each
exact f64 step once, as the FMA); K8's modes and K9's layouts at 4 fixed iterations as K1; K8 `full`
with the early exit (K1's first design) against plain as K1, and K1 against
it at the same tolerances; K9 structured against K8 `full`, bit for bit
(the same device code).
"""

import dataclasses

import pytest
import torch

import obstacle_cases as OC
from nmpc_tpu_torch.ocp import problem as P
from nmpc_tpu_torch.ops import cuda_build, megasolve, staged_tiles
from nmpc_tpu_torch.ops import rollout as R
from nmpc_tpu_torch.ops.expansions import expansions_fused
from nmpc_tpu_torch.ops.kernel_check import staged_vs_plain
from nmpc_tpu_torch.ops.riccati import riccati_lanes
from nmpc_tpu_torch.parallel import batch_ocp
from nmpc_tpu_torch.scenarios import get
from nmpc_tpu_torch.solver import ALILQRConfig, solve_batched

pytestmark = pytest.mark.gpu


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _case(name, B, dev, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    base = get(name).make(N=10, device=dev)
    ob = batch_ocp(base, base.x0[None] + 0.1 * torch.randn((B, base.nx), generator=g, device=dev))
    U = 0.05 * torch.randn((B, base.N, base.nu), generator=g, device=dev)
    lam = 0.5 * torch.randn((B, base.N, base.n_con), generator=g, device=dev).abs()
    lam = lam * (P.constraint_mask(base) > 0)
    mu = torch.tensor([10.0, 100.0, 1e3, 1e4], device=dev)[
        torch.randint(0, 4, (B,), generator=g, device=dev)]
    return ob, U, lam, mu


# one scenario per robot count of cuda_build.ROBOT_COUNTS, with pair rows
# where m > 1, and two_robot_centralized without them. One robot:
# slsqp_pose (T=0.5). At single_robot's T=0.01 the controls barely move the
# 10-stage cost, and U at equal cost differs by ~1.5e-2 between any two of
# the kernel, its plain version and the reference
BY_ROBOTS = ["slsqp_pose", "two_robot_swap", "third_scenario", "fourth_scenario", "five_robot",
             "six_robot_antipodal", "eight_robot", "ten_robot"]


def _hold_k1(got, want, B):
    torch.testing.assert_close(got[2], want[2], rtol=1e-4, atol=0.0)
    torch.testing.assert_close(got[1], want[1], rtol=0.0, atol=5e-3)
    torch.testing.assert_close(got[0], want[0], rtol=0.0, atol=5e-3)
    assert int((got[3] == want[3]).sum()) >= 0.99 * B


@pytest.mark.parametrize("name", BY_ROBOTS + ["two_robot_centralized"])
def test_al_update_kernel_matches_plain(dev, name):
    ob, U, lam, mu = _case(name, 300, dev)  # 300: a ragged last block
    Xs = ob.x0[:, None] + 0.3 * torch.randn((300, ob.N, ob.nx), device=dev)
    got = megasolve.al_update_lanes(ob, Xs, U, lam, mu, 1e6)
    want = megasolve.al_update_plain(ob, Xs, U, lam, mu, 1e6)
    torch.testing.assert_close(got[0], want[0], rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(got[1], want[1], rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("ls", ["adaptive", "cascade"])
@pytest.mark.parametrize("name", BY_ROBOTS)
def test_inner_solve_kernel_matches_plain(dev, name, ls):
    B = 300
    ob, U, lam, mu = _case(name, B, dev, seed=1)
    cfg = ALILQRConfig(n_inner=4, ls=ls)
    before = cuda_build.launch_counts["inner_solve_fused"]
    got = megasolve.inner_solve_fused(ob, ob.x0, ob.xref, lam, mu, U, cfg)
    assert cuda_build.launch_counts["inner_solve_fused"] == before + 1
    want = megasolve.inner_solve_plain(ob, ob.x0, ob.xref, lam, mu, U, cfg)
    _hold_k1(got, want, B)


@pytest.mark.parametrize("case", ["ragged B=33", "B=1", "N=1", "ten_robot N=20",
                                  "NaN duals on masked rows"])
def test_inner_solve_kernel_at_the_edges(dev, case):
    """K1's launch geometry at its edges: a batch that fills no whole block,
    one scenario, one stage, a long ten-robot horizon (the largest slot);
    and non-finite warm duals on the stage-0 rows that constraint_mask
    drops, which must reach neither merit nor gains."""
    name, B, N = {"ragged B=33": ("six_robot_antipodal", 33, 10), "B=1": ("six_robot_antipodal", 1, 10),
                  "N=1": ("six_robot_antipodal", 64, 1), "ten_robot N=20": ("ten_robot", 64, 20),
                  "NaN duals on masked rows": ("six_robot_antipodal", 64, 10)}[case]
    g = torch.Generator(device=dev).manual_seed(5)
    base = get(name).make(N=N, device=dev)
    ob = batch_ocp(base, base.x0[None] + 0.1 * torch.randn((B, base.nx), generator=g, device=dev))
    U = 0.05 * torch.randn((B, N, base.nu), generator=g, device=dev)
    keep = P.constraint_mask(base) > 0
    lam = 0.5 * torch.randn((B, N, base.n_con), generator=g, device=dev).abs() * keep
    if case.startswith("NaN"):
        lam = torch.where(keep, lam, torch.full_like(lam, float("nan")))
    mu = torch.full((B,), 100.0, device=dev)
    for ls in ("adaptive", "cascade"):
        cfg = ALILQRConfig(n_inner=4, ls=ls)
        got = megasolve.inner_solve_fused(ob, ob.x0, ob.xref, lam, mu, U, cfg)
        want = megasolve.inner_solve_plain(ob, ob.x0, ob.xref, lam, mu, U, cfg)
        assert all(torch.isfinite(t).all() for t in got[:3])
        _hold_k1(got, want, B)


def test_inner_solve_kernel_with_33_alphas(dev):
    """K1 keeps its parameter block in dynamic shared memory, so a cascade
    of 33 alphas (the default grid, then smaller steps) runs and agrees with
    the plain version as at the default grid."""
    B = 300
    ob, U, lam, mu = _case("six_robot_antipodal", B, dev, seed=8)
    grid = ALILQRConfig().alphas
    alphas = (grid + tuple(grid[-1] * 0.7 ** k for k in range(1, 33)))[:33]
    cfg = ALILQRConfig(n_inner=4, ls="cascade", alphas=alphas)
    got = megasolve.inner_solve_fused(ob, ob.x0, ob.xref, lam, mu, U, cfg)
    _hold_k1(got, megasolve.inner_solve_plain(ob, ob.x0, ob.xref, lam, mu, U, cfg), B)


@pytest.mark.parametrize("case", ["slsqp_pose", "two_robot_swap", "obstacle_scenario_3",
                                  "robot_template", "all_rows", "consensus48",
                                  "33 alphas", "B=1", "N=1"])
def test_team_kernel_matches_plain(dev, case):
    """K1's team design (csrc/inner_team.cuh, m <= 2) through the route
    against the plain version at phase 3's tolerances: pair-only and
    obstacle problems of one and two robots, 47 moving-obstacle rows, a
    cascade of 33 alphas (five passes of a team's lanes), one scenario and
    one stage; both line searches."""
    grid = ALILQRConfig().alphas
    alphas = grid
    if case in OC.CASES or case == "consensus48":
        ob, U, lam, mu = OC.port_case(case, 48 if case == "consensus48" else 300, seed=6,
                                      device=dev)
    else:
        name = {"33 alphas": "obstacle_scenario_3"}.get(case, case)
        if case == "33 alphas":
            alphas = (grid + tuple(grid[-1] * 0.7 ** k for k in range(1, 33)))[:33]
        B = 1 if case == "B=1" else 300
        ob, U, lam, mu = _case(name if case not in ("B=1", "N=1") else "slsqp_pose", B, dev,
                               seed=6)
        if case == "N=1":
            ob = dataclasses.replace(ob, N=1, xref=ob.xref[:, :1].contiguous())
            U, lam = U[:, :1].contiguous(), lam[:, :1].contiguous()
    B = ob.x0.shape[0]
    assert ob.m in cuda_build.TEAM_ROBOTS
    for ls in ("adaptive", "cascade"):
        cfg = ALILQRConfig(n_inner=4, ls=ls, alphas=alphas)
        cuda_build.reset_launch_counts()
        got = megasolve.inner_solve_fused(ob, ob.x0, ob.xref, lam, mu, U, cfg)
        assert cuda_build.launch_counts["inner_solve_fused"] == 1
        _hold_k1(got, megasolve.inner_solve_plain(ob, ob.x0, ob.xref, lam, mu, U, cfg), B)


def test_route_takes_the_team_design_at_m_up_to_two(dev, monkeypatch):
    """At m <= 2 solve_batched's K1 launches are the team design's, never
    the warp design's; at m = 6 the warp design's."""
    seen = {"team": 0, "warp": 0}

    def counted(kind, fn):
        def launch(*a, **k):
            seen[kind] += 1
            return fn(*a, **k)
        return launch

    monkeypatch.setattr(megasolve, "team_launch", counted("team", megasolve.team_launch))
    monkeypatch.setattr(megasolve, "warp_launch", counted("warp", megasolve.warp_launch))
    cfg = ALILQRConfig(n_outer=3, n_inner=6, tol_con=1e-3)
    for name, B in (("obstacle_scenario_3", 64), ("robot_template", 64), ("all_rows", 64)):
        ob, _, _, _ = OC.port_case(name, B, seed=2, device=dev)
        cuda_build.reset_launch_counts()
        res = solve_batched(ob, cfg=cfg)
        assert torch.isfinite(res.cost).all()
        assert cuda_build.launch_counts["inner_solve_fused"] == seen["team"] > 0
        assert seen["warp"] == 0
        seen["team"] = 0
    ob, _, _, _ = _case("two_robot_swap", 64, dev)
    solve_batched(ob, cfg=cfg)
    assert seen["team"] > 0 and seen["warp"] == 0
    ob, _, _, _ = _case("six_robot_antipodal", 64, dev)
    seen["team"] = 0
    solve_batched(ob, cfg=cfg)
    assert seen["warp"] > 0 and seen["team"] == 0


@pytest.mark.parametrize("name", ["slsqp_pose", "two_robot_swap", "obstacle_scenario_3"])
def test_warp_design_stays_launchable_at_m_up_to_two(dev, name):
    """The warp design is still in the m <= 2 libraries, through
    warp_launch only (the A/B baseline), and agrees with plain."""
    if name in OC.CASES:
        ob, U, lam, mu = OC.port_case(name, 300, seed=7, device=dev)
    else:
        ob, U, lam, mu = _case(name, 300, dev, seed=7)
    cfg = ALILQRConfig(n_inner=4, ls="cascade")
    got = megasolve.warp_launch(ob, ob.x0, ob.xref, lam, mu, U, cfg, "inner_solve_fused",
                                cuda_build.load, megasolve.K1_WARPS)
    _hold_k1(got, megasolve.inner_solve_plain(ob, ob.x0, ob.xref, lam, mu, U, cfg), 300)


def test_team_geometry_and_rings(dev):
    """The m <= 2 libraries report the team design's settings (T divides a
    warp, the ring's depth, the register cap) and a ring that holds D stage
    slots, T floats apart modulo 32 banks."""
    for m in cuda_build.TEAM_ROBOTS:
        lib = cuda_build.load(m)
        geo = cuda_build.team_geometry(lib)
        assert 32 % geo["T"] == 0 and geo["D"] >= 2 and geo["min_blocks"] >= 1
        n, nu = 3 * m, 2 * m
        for R, n_mov in ((0, 0), (m, 0), (47, 47)):
            ring = lib.nmpc_k1_team_ring_bytes(R, n_mov, int(m > 1)) // 4
            nc = m * (m - 1) // 2 + R + 2 * nu + 2 * n
            assert ring >= geo["D"] * (2 * n + 2 * nu + nu * n + nc + 2 * n_mov)
            assert ring % 32 == geo["T"] % 32


def test_k1_slot_fits_the_block(dev):
    """K1's per-warp slot, sized by the library from the robot count and the
    obstacle rows R = m (n_obs + n_mov): 16-byte aligned, room for Vxx
    twice, Qux, Quu, the stage's duals and (R > 0) the rows' [5, R] table,
    and K1_WARPS slots within the H100's 227 KB of shared memory a block
    (R up to ten robots with six obstacles and nine moving ones); one lane
    per right-hand side of the gain solve (n + 1 <= 32)."""
    for m in cuda_build.ROBOT_COUNTS:
        lib = cuda_build.load(m)
        n, nu = 3 * m, 2 * m
        for R in (0, m, m * 15):
            slot = lib.nmpc_k1_slot_bytes(R)
            n_con = m * (m - 1) // 2 + R + 2 * nu + 2 * n
            assert n + 1 <= 32 and slot % 16 == 0
            assert slot >= 4 * (2 * n * n + nu * n + nu * nu + n_con + 5 * R)
            assert megasolve.K1_WARPS * slot <= 227 * 1024


def test_k1_phase_probes_count_every_phase(dev):
    """K1 built with its phase probes (tools/k1_phases.py) still agrees with
    the plain version, and every phase it runs gets cycles."""
    from nmpc_tpu_torch.tools import k1_phases as K1P

    B = 64
    ob, U, lam, mu = _case("two_robot_swap", B, dev, seed=4)
    cfg = ALILQRConfig(n_inner=4, ls="adaptive")
    lib, _ = cuda_build.load_k1_variant(ob.m, probes=True)

    def run():
        return megasolve.warp_launch(ob, ob.x0, ob.xref, lam, mu, U, cfg, "inner_solve_fused",
                                     lambda _: lib, megasolve.K1_WARPS)

    cycles, executed = K1P.split(lib, run, cfg.n_inner)
    assert executed >= B and all(c > 0 for c in cycles.values()), cycles
    _hold_k1(run(), megasolve.inner_solve_plain(ob, ob.x0, ob.xref, lam, mu, U, cfg), B)


def test_team_phase_probes_count_every_phase(dev):
    """K1's team design built with its phase probes still agrees with the
    plain version, and every phase it runs gets cycles."""
    from nmpc_tpu_torch.tools import k1_phases as K1P

    B = 64
    ob, U, lam, mu = OC.port_case("obstacle_scenario_3", B, seed=4, device=dev)
    cfg = ALILQRConfig(n_inner=4, ls="cascade")
    lib, _ = cuda_build.load_k1_variant(ob.m, probes=True, team={})

    def run():
        return megasolve.team_launch(ob, ob.x0, ob.xref, lam, mu, U, cfg, "inner_solve_fused",
                                     lambda _: lib, megasolve.K1_TEAM_WARPS)

    cycles, executed = K1P.split(lib, run, cfg.n_inner, K1P.TEAM_PHASES)
    assert executed >= B and all(c > 0 for c in cycles.values()), cycles
    _hold_k1(run(), megasolve.inner_solve_plain(ob, ob.x0, ob.xref, lam, mu, U, cfg), B)


def test_solve_batched_on_the_card(dev):
    ob, _, _, _ = _case("six_robot_antipodal", 512, dev)
    cfg = ALILQRConfig(n_outer=6, n_inner=12, tol_con=1e-3, ls="adaptive")
    cuda_build.reset_launch_counts()
    res = solve_batched(ob, cfg=cfg)
    steps = int(res.outer_iters.max())
    assert cuda_build.launch_counts == {
        "inner_solve_fused": steps, "al_update_lanes": steps, "expansions_fused": 0,
        "riccati_lanes": 0, "linesearch_costs_lanes": 0, "rollout_alpha_lanes": 0,
        "fma_peak": 0, "phase_ablation": 0, "expansion_ab": 0}
    assert torch.isfinite(res.cost).all() and res.X.shape == (512, 11, 18)
    assert float(res.converged.float().mean()) >= 0.9


def test_wrappers_refuse_what_the_kernels_do_not_cover(dev):
    ob, U, lam, mu = _case("six_robot_antipodal", 64, dev)
    cfg = ALILQRConfig(n_inner=2)
    # compact is the route's permutation, not K1's: the same launch
    got = megasolve.inner_solve_fused(ob, ob.x0, ob.xref, lam, mu, U,
                                      dataclasses.replace(cfg, compact=True))
    want = megasolve.inner_solve_fused(ob, ob.x0, ob.xref, lam, mu, U, cfg)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    with pytest.raises(TypeError):
        megasolve.inner_solve_fused(ob, ob.x0.double(), ob.xref, lam, mu, U, cfg)
    with pytest.raises(ValueError):
        megasolve.inner_solve_fused(ob, ob.x0, ob.xref, lam[:, :5], mu, U, cfg)
    seven = dataclasses.replace(ob, m=7)
    with pytest.raises(NotImplementedError, match="m=7"):
        megasolve.inner_solve_fused(seven, ob.x0, ob.xref, lam, mu, U, cfg)
    with pytest.raises(NotImplementedError, match="scan"):
        megasolve.inner_solve_fused(ob, ob.x0, ob.xref, lam, mu, U,
                                    dataclasses.replace(cfg, sweep="scan"))
    lid = get("lidar_v4").make(N=10, device=dev)
    lid_b = batch_ocp(lid, lid.x0[None].repeat(4, 1))
    z = torch.zeros
    with pytest.raises(NotImplementedError, match="num_rays"):
        megasolve.inner_solve_fused(
            lid_b, lid_b.x0, lid_b.xref, z((4, 10, lid.n_con), device=dev),
            torch.full((4,), 10.0, device=dev), z((4, 10, lid.nu), device=dev), cfg)
    with pytest.raises(NotImplementedError, match="num_rays"):
        megasolve.al_update_lanes(lid_b, z((4, 10, lid.nx), device=dev),
                                  z((4, 10, lid.nu), device=dev),
                                  z((4, 10, lid.n_con), device=dev),
                                  torch.full((4,), 10.0, device=dev), 1e6)
    # a schedule of the wrong shape, and a block beyond the H100's shared memory
    mo, Um, lm, mm = OC.port_case("robot_template", 4, seed=1, device=dev)
    with pytest.raises(ValueError):
        megasolve.inner_solve_fused(dataclasses.replace(mo, mov_obs=mo.mov_obs[:, :3]), mo.x0,
                                    mo.xref, lm, mm, Um, cfg)
    big = dataclasses.replace(mo, n_mov=6000, mov_obs=torch.zeros((4, 8, 6000, 2), device=dev))
    with pytest.raises(NotImplementedError, match="232448"):
        megasolve.inner_solve_fused(big, mo.x0, mo.xref, z((4, 8, big.n_con), device=dev), mm,
                                    Um, cfg)


@pytest.mark.parametrize("B", [300, 33])
@pytest.mark.parametrize("name", OC.CASES)
def test_obstacle_kernels_match_plain(dev, name, B):
    """K1's and K2's obstacle variant against their plain versions on the
    problems of tests/obstacle_cases.py (300 and 33: ragged last blocks),
    both line searches, K2 on K1's output; one launch of each counted."""
    ob, U, lam, mu = OC.port_case(name, B, seed=3, device=dev)
    for ls in ("adaptive", "cascade"):
        cfg = ALILQRConfig(n_inner=4, ls=ls)
        cuda_build.reset_launch_counts()
        got = megasolve.inner_solve_fused(ob, ob.x0, ob.xref, lam, mu, U, cfg)
        g2 = megasolve.al_update_lanes(ob, got[0], got[1], lam, mu, 1e6)
        assert cuda_build.launch_counts["inner_solve_fused"] == 1
        assert cuda_build.launch_counts["al_update_lanes"] == 1
        want = megasolve.inner_solve_plain(ob, ob.x0, ob.xref, lam, mu, U, cfg)
        _hold_k1(got, want, B)
        w2 = megasolve.al_update_plain(ob, got[0], got[1], lam, mu, 1e6)
        torch.testing.assert_close(g2[0], w2[0], rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(g2[1], w2[1], rtol=1e-6, atol=1e-6)
        rows = megasolve.obstacle_rows(ob)
        assert (w2[0][:, 1:, ob.n_pairs:ob.n_pairs + rows] > 0).float().mean() > 0.01


@pytest.mark.parametrize("name", ["obstacle_scenario_3", "robot_template"])
def test_obstacle_batches_take_the_megakernel_route_on_the_card(dev, name):
    """With the default mega=True a family-H batch and a per-robot
    moving-obstacle batch run K1 and K2 only, one of each per outer step."""
    ob, _, _, _ = OC.port_case(name, 512, seed=4, device=dev)
    cfg = ALILQRConfig(n_outer=6, n_inner=12, tol_con=1e-3, ls="adaptive")
    cuda_build.reset_launch_counts()
    res = solve_batched(ob, cfg=cfg)
    steps = int(res.outer_iters.max())
    assert cuda_build.launch_counts == {
        "inner_solve_fused": steps, "al_update_lanes": steps, "expansions_fused": 0,
        "riccati_lanes": 0, "linesearch_costs_lanes": 0, "rollout_alpha_lanes": 0,
        "fma_peak": 0, "phase_ablation": 0, "expansion_ab": 0}
    assert torch.isfinite(res.cost).all() and torch.isfinite(res.X).all()


def _staged_problem(name, dev):
    if name == "moving":  # one robot, two moving-obstacle slots, per-scenario
        return P.make_ocp(m=1, N=8, T=0.1, x0=[0.0, 0.0, 0.0], x_goal=[0.6, 0.0, 0.0],
                          dmin=0.3, mov_obs=torch.zeros((8, 2, 2), device=dev), device=dev)
    if name == "all rows":  # two robots: pairs, obstacles and moving obstacles
        return P.make_ocp(m=2, N=5, T=0.1, x0=[0, 0, 0, 0.5, 0, 0], x_goal=[1, 1, 0, -1, 1, 0],
                          dmin=0.3, collision=True, obstacles=[[0.2, 0.1, 0.1], [0.4, -0.2, 0.15]],
                          mov_obs=torch.zeros((5, 2, 2), device=dev), device=dev)
    return get(name).make(N=10 if name != "obstacle_scenario_3" else 20, device=dev)


def _lanes(ocp, B, dev, seed=0):
    """Lane-major inputs [N, rows, B] near the constraints, duals |N(0, 0.5)|
    (zero on the masked rows), mu in {10, 100}."""
    g = torch.Generator(device=dev).manual_seed(seed)
    rnd = lambda *s: torch.randn(s, generator=g, device=dev)  # noqa: E731
    N, n, nu = ocp.N, ocp.nx, ocp.nu
    X = ocp.x0[None, None] + 0.4 * rnd(B, N, n)
    if ocp.n_obs:
        X[..., 0::3] = ocp.obstacles[0, 0] + 0.3 * rnd(B, N, ocp.m)
        X[..., 1::3] = ocp.obstacles[0, 1] + 0.3 * rnd(B, N, ocp.m)
    lam = 0.5 * rnd(B, N, ocp.n_con).abs() * (P.constraint_mask(ocp) > 0)
    d = dict(X=X, U=0.1 * rnd(B, N, nu), xref=ocp.xref[None].expand(B, N, n), lam=lam,
             kff=0.1 * rnd(B, N, nu), Kfb=0.1 * rnd(B, N, nu, n))
    if ocp.n_mov:
        d["mov"] = (X[..., :2].reshape(B, N, 1, 2).repeat(1, 1, ocp.n_mov, 1)
                    + 0.3 * rnd(B, N, ocp.n_mov, 2)).reshape(B, N, 2 * ocp.n_mov)
    L = {k: v.movedim(0, -1).contiguous() for k, v in d.items()}
    L["x0"] = L["X"][0].contiguous()
    L["mu"] = torch.tensor([10.0, 100.0], device=dev)[torch.randint(0, 2, (B,), generator=g, device=dev)]
    L["alpha"] = torch.rand(B, generator=g, device=dev)
    return L


@pytest.mark.parametrize("name", ["two_robot_swap", "six_robot_antipodal", "ten_robot",
                                  "obstacle_scenario_3", "moving", "all rows"])
def test_staged_kernels_match_plain(dev, name):
    ocp = _staged_problem(name, dev)
    L = _lanes(ocp, 300, dev)  # 300: a ragged last block
    cuda_build.reset_launch_counts()
    verdicts, _ = staged_vs_plain(ocp, L["X"], L["U"], L["xref"], L["lam"], L["mu"], L.get("mov"),
                                  (0.0, 1.0, 0.5, 0.25, 0.1), L["alpha"], 1e-6,
                                  gains=(L["kff"], L["Kfb"]))
    for k, v in verdicts.items():
        assert v.units > 0 and v.n_diverged == 0 and v.n_widened == 0, k
    assert cuda_build.launch_counts == {
        "inner_solve_fused": 0, "al_update_lanes": 0, "expansions_fused": 1,
        "riccati_lanes": 1, "linesearch_costs_lanes": 1, "rollout_alpha_lanes": 1,
        "fma_peak": 0, "phase_ablation": 0, "expansion_ab": 0}


@pytest.mark.parametrize("name", ["six_robot_antipodal", "obstacle_scenario_3"])
def test_staged_route_on_the_card(dev, name):
    """six_robot_antipodal and an obstacle problem with mega=False: both take
    the staged route, one K4, K3 and K5 launch per inner iteration and one
    more K6."""
    ob, _, _, _ = _case(name, 512, dev)
    cfg = ALILQRConfig(n_outer=6, n_inner=12, tol_con=1e-3, ls="adaptive", mega=False)
    cuda_build.reset_launch_counts()
    res = solve_batched(ob, cfg=cfg)
    c = dict(cuda_build.launch_counts)
    it = c["riccati_lanes"]
    assert c["inner_solve_fused"] == c["al_update_lanes"] == 0
    assert c["expansions_fused"] == c["linesearch_costs_lanes"] == it > 0
    assert c["rollout_alpha_lanes"] == it + 1
    assert int(res.inner_iters.max()) <= it <= cfg.n_inner * int(res.outer_iters.max())
    assert torch.isfinite(res.cost).all() and torch.isfinite(res.X).all()
    assert float(res.converged.float().mean()) >= 0.8


def test_staged_wrappers_refuse_what_the_kernels_do_not_cover(dev):
    ocp = _staged_problem("two_robot_swap", dev)
    L = _lanes(ocp, 64, dev)
    with pytest.raises(TypeError):
        R.rollout_alpha_lanes(ocp, L["x0"].double(), L["X"], L["U"], L["kff"], L["Kfb"],
                              L["alpha"])
    with pytest.raises(ValueError):
        expansions_fused(ocp, L["X"], L["U"], L["xref"], L["lam"][:, :3], L["mu"])
    seven = dataclasses.replace(ocp, m=7)
    with pytest.raises(NotImplementedError, match="m=7"):
        R.linesearch_costs_lanes(seven, L["x0"], L["X"], L["U"], L["kff"], L["Kfb"],
                                 L["xref"], L["lam"], L["mu"], (0.0, 1.0))
    # K3 takes any stage shape up to the largest robot stack's (30, 20)
    bad = tuple(torch.zeros(s, device=dev) for s in (
        (5, 31, 31, 64), (5, 31, 4, 64), (5, 31, 64), (5, 4, 64), (5, 31, 31, 64),
        (5, 4, 4, 64), (5, 4, 31, 64)))
    with pytest.raises(NotImplementedError, match="up to n=30"):
        riccati_lanes(bad)


# ---------------------------------------------------------------------------
# K3 and K5: the tile design against its first design
# ---------------------------------------------------------------------------


def _first_vs_tiles(ocp, L, alphas):
    """K4 at the state, K3 on K4's output, K5 and K6 on K3's gains, the tile
    designs against the first designs (tools/staged_launch.py) on the same
    inputs: every one bit for bit, every output finite."""
    from nmpc_tpu_torch.tools import staged_launch as SL

    k4 = (L["X"], L["U"], L["xref"], L["lam"], L["mu"], L.get("mov"))
    exp = expansions_fused(ocp, *k4)
    assert all(torch.equal(a, b) for a, b in zip(exp, SL.expansions_first(ocp, *k4)))
    assert all(torch.isfinite(t).all() for t in exp)
    got3, first3 = riccati_lanes(exp, 1e-6), SL.riccati_first(exp, 1e-6)
    assert all(torch.equal(a, b) for a, b in zip(got3, first3))
    assert all(torch.isfinite(t).all() for t in got3)
    args = (L["x0"], L["X"], L["U"], got3[0], got3[1], L["xref"], L["lam"], L["mu"])
    got5 = R.linesearch_costs_lanes(ocp, *args, alphas, L.get("mov"))
    assert torch.equal(got5, SL.linesearch_costs_first(ocp, *args, alphas, L.get("mov")))
    assert torch.isfinite(got5).all()
    k6 = (*args[:5], L["alpha"])
    got6 = R.rollout_alpha_lanes(ocp, *k6)
    assert all(torch.equal(a, b) for a, b in zip(got6, SL.rollout_alpha_first(ocp, *k6)))
    assert all(torch.isfinite(t).all() for t in got6)


@pytest.mark.parametrize("case", ["B=33", "N=1", "N=5", "ten_robot", "moving", "all rows",
                                  "obstacle_scenario_3"])
def test_staged_tiles_match_first_design(dev, case):
    """The edges of the tile design: unaligned rows and a ragged last tile
    (B=33), one stage, a horizon that is no multiple of the ring depth, the
    largest shared footprint (m=10), per-scenario moving-obstacle schedules,
    every row kind at once, path (b)'s problem at N=20."""
    name, B, N = {"B=33": ("six_robot_antipodal", 33, 10), "N=1": ("two_robot_swap", 64, 1),
                  "N=5": ("six_robot_antipodal", 64, 5), "ten_robot": ("ten_robot", 300, 10),
                  "moving": ("moving", 300, 8), "all rows": ("all rows", 33, 5),
                  "obstacle_scenario_3": ("obstacle_scenario_3", 33, 20)}[case]
    ocp = _staged_problem(name, dev)
    if ocp.N != N:
        ocp = get(name).make(N=N, device=dev)
    _first_vs_tiles(ocp, _lanes(ocp, B, dev, seed=6), (0.0,) + ALILQRConfig().alphas)


@pytest.mark.parametrize("name", ["six_robot_antipodal", "obstacle_scenario_3"])
def test_k5_takes_the_most_candidates_a_block_takes(dev, name):
    """The most candidates one K5 launch takes, one more (two launches) and
    33 (three at m=1 and m=6): the merits are the first design's bit for
    bit, one launch counted per slice."""
    from nmpc_tpu_torch.ops import staged_tiles

    ocp = _staged_problem(name, dev)
    L = _lanes(ocp, 40, dev, seed=7)
    top = staged_tiles.k5_max_alphas(ocp.m)
    for count in (top, top + 1, 33):
        alphas = tuple(float(a) for a in torch.linspace(1.0, 0.0, count))
        cuda_build.reset_launch_counts()
        _first_vs_tiles(ocp, L, alphas)
        assert cuda_build.launch_counts["linesearch_costs_lanes"] == -(-count // top)


def test_staged_geometry_of_every_library(dev):
    """Each solver library reports the K3 and K5 geometry that
    ops/staged_tiles.py asked for (cuda_build checks it when it loads), and
    a K3 block's shared memory fits the H100's 227 KB."""
    from nmpc_tpu_torch.ops import staged_tiles

    for m in cuda_build.ROBOT_COUNTS:
        g = cuda_build.k3_geometry(cuda_build.load(m))
        lay = staged_tiles.k3_layout(m)
        assert g["smem_bytes"] == lay["smem_bytes"] <= staged_tiles.SMEM_BLOCK_MAX
        assert g["S"] == staged_tiles.K3_GEOMETRY[m].S


# ---------------------------------------------------------------------------
# The roofline tools (K7-K9) and the default device
# ---------------------------------------------------------------------------


def test_builders_put_tensors_on_the_card(dev):
    ocp = get("six_robot_antipodal").make(N=10)
    assert all(t.device.type == "cuda" for t in (ocp.x0, ocp.xref, ocp.Qdiag, ocp.u_hi))
    assert P.make_ocp(m=1, N=3, T=0.1, x0=[0, 0, 0], x_goal=[1, 0, 0]).x0.device.type == "cuda"
    assert P.default_weights(2)[0].device.type == "cuda"


def test_fma_peak_kernel_matches_plain(dev):
    from nmpc_tpu_torch.tools import roofline as RL

    for C in RL.FMA_CHAINS:
        x0 = 1.0 + 1e-3 * torch.rand((C, 300), device=dev)
        got = RL.fma_peak(x0, 1.0000001, 1e-7, 64)
        want = RL.fma_chain_plain(x0, 1.0000001, 1e-7, 64)
        assert torch.equal(got, want), C


@pytest.mark.parametrize("mode", ["full", "inv_solve", "no_ls", "no_solve", "no_expcon",
                                  "sweep_only"])
def test_phase_ablation_kernel_matches_plain(dev, mode):
    from nmpc_tpu_torch.tools import exp_mega_phases as K8

    # the ablation's own inputs: lam 0, mu 10, U 0 (at mu up to 1e4 the
    # modes' undamped alpha = 1 steps diverge, and kernel and plain part)
    ob, U, lam, mu = _case("six_robot_antipodal", 256, dev, seed=2)
    U, lam, mu = torch.zeros_like(U), torch.zeros_like(lam), torch.full_like(mu, 10.0)
    cfg = ALILQRConfig(ls="adaptive")
    got = K8.phase_ablation(ob, ob.x0, ob.xref, lam, mu, U, cfg, mode, 4)
    want = K8.phase_ablation_plain(ob, ob.x0, ob.xref, lam, mu, U, cfg, mode, 4)
    torch.testing.assert_close(got[2], want[2], rtol=1e-4, atol=0.0)
    torch.testing.assert_close(got[1], want[1], rtol=0.0, atol=5e-3)
    assert (got[3] == 4).all() and torch.isfinite(got[0]).all()


def test_phase_ablation_with_the_early_exit_is_k1(dev):
    """K8 `full` with the early exit is K1's first design (one thread per
    scenario, csrc/megasolve.cuh): it agrees with the plain K1 at K1's
    tolerances, and K1 (one warp per scenario) agrees with it."""
    from nmpc_tpu_torch.tools import exp_mega_phases as K8

    B = 256
    ob, U, lam, mu = _case("six_robot_antipodal", B, dev, seed=3)
    cfg = ALILQRConfig(n_inner=6, ls="adaptive")
    first = K8.phase_ablation(ob, ob.x0, ob.xref, lam, mu, U, cfg, "full", 6, early_exit=True)
    want = megasolve.inner_solve_plain(ob, ob.x0, ob.xref, lam, mu, U, cfg)
    _hold_k1(first, want, B)
    k1 = megasolve.inner_solve_fused(ob, ob.x0, ob.xref, lam, mu, U, cfg)
    _hold_k1(k1, first, B)


@pytest.mark.parametrize("layout", ["structured", "dense"])
def test_expansion_ab_kernel_matches_plain(dev, layout):
    from nmpc_tpu_torch.tools import exp_blocked_expansions as K9
    from nmpc_tpu_torch.tools import exp_mega_phases as K8

    ob, _, _, _ = _case("six_robot_antipodal", 256, dev, seed=4)
    lam, mu, U = K9.ab_inputs(ob)
    cfg = ALILQRConfig(ls="adaptive")
    got = K9.expansion_ab(ob, ob.x0, ob.xref, lam, mu, U, cfg, layout, 4)
    want = K9.expansion_ab_plain(ob, ob.x0, ob.xref, lam, mu, U, cfg, 4)
    torch.testing.assert_close(got[2], want[2], rtol=1e-4, atol=0.0)
    torch.testing.assert_close(got[1], want[1], rtol=0.0, atol=5e-3)
    if layout == "structured":   # K8's full mode, bit for bit
        full = K8.phase_ablation(ob, ob.x0, ob.xref, lam, mu, U, cfg, "full", 4)
        assert all(torch.equal(a, b) for a, b in zip(got, full))


# ---------------------------------------------------------------------------
# the closed loop on the card
# ---------------------------------------------------------------------------


def test_closed_loop_through_solve_one(dev):
    """tests/test_mpc.py:181-196 on the card: the two_robot_swap N=25 loop
    with solve_fn = solve_one (K1 and K2 at B=1) reaches its goal with the
    realized pair distance >= dmin - 5e-3, and no staged kernel runs."""
    from nmpc_tpu_torch.mpc import MPCConfig, closed_loop
    from nmpc_tpu_torch.solver import solve_one

    sc = get("two_robot_swap")
    fast = ALILQRConfig(n_outer=10, n_inner=20, tol_con=1e-4)
    cuda_build.reset_launch_counts()
    r = closed_loop(sc.make(N=25, T=0.1, device=dev), fast,
                    MPCConfig(max_steps=250, stop_tol=1e-1, escape=True),
                    solve_fn=lambda o, w: solve_one(o, w, fast))
    counts = dict(cuda_build.launch_counts)
    assert bool(r.reached)
    assert float(r.min_dist_hist.min()) >= sc.dmin - 5e-3
    assert counts["inner_solve_fused"] > 0 and counts["al_update_lanes"] > 0
    assert counts["riccati_lanes"] == 0 and counts["expansions_fused"] == 0
    assert r.X_hist.device.type == "cuda"


def test_plant_step_with_a_cuda_generator_stays_on_the_card(dev):
    from nmpc_tpu_torch.sim import PlantConfig, plant_step

    noise = torch.full((6,), 0.01, device=dev)
    cfg = PlantConfig(substeps=2, u_sat=torch.tensor([0.22, 2.84] * 2, device=dev),
                      process_noise=noise, odom_noise=noise)
    x = torch.zeros((64, 6), device=dev)
    u = torch.ones((64, 4), device=dev)
    outs = [plant_step(x, u, 0.1, cfg, torch.Generator(device=dev).manual_seed(1)) for _ in range(2)]
    for t in outs[0]:
        assert t.device.type == "cuda" and torch.isfinite(t).all()
    assert torch.equal(outs[0][0], outs[1][0]) and torch.equal(outs[0][1], outs[1][1])
    clean, _ = plant_step(x, u, 0.1, cfg)
    assert 0.003 < float((outs[0][0] - clean).std()) < 0.03


def test_per_scenario_solve_on_the_card_matches_the_cpu(dev):
    """The per-scenario engine (plain PyTorch) on CUDA tensors against the
    same call on the CPU: cost rtol 1e-4, U atol 5e-3 (5e-2 on six
    robots, tests/test_torch_solve_batched.py's exception)."""
    from nmpc_tpu_torch.solver import solve

    cfg = ALILQRConfig(tol_cost=1e-5)
    for name, kw, u_atol in (("two_robot_swap", dict(N=25, T=0.1), 5e-3),
                             ("six_robot_antipodal", dict(N=10), 5e-2)):
        ocp = get(name).make(device=dev, **kw)
        got = solve(ocp, cfg=cfg)
        want = solve(ocp.to("cpu"), cfg=cfg)
        assert got.U.device.type == "cuda"
        torch.testing.assert_close(got.cost.cpu(), want.cost, rtol=1e-4, atol=0)
        torch.testing.assert_close(got.U.cpu(), want.U, rtol=0, atol=u_atol)


# ---------------------------------------------------------------------------
# K3 at the ray-augmented stage shape (n, nu) = (13, 2) and the hybrid route
# ---------------------------------------------------------------------------


def _ray_batch(dev, B, N=20, seed=0):
    """lidar_v2 (ray_lo=0.3) with its ray states from one scan of the
    (0.5, 0.25, 0.15) circle, B starts jittered by 0.05 in pose."""
    from nmpc_tpu_torch.tools import lidar_fleet

    base = lidar_fleet.scanned("lidar_v2", [[0.5, 0.25, 0.15]], dev, N=N, ray_lo=0.3)
    return lidar_fleet.jittered(base, B, torch.Generator(device=dev).manual_seed(seed))


@pytest.mark.parametrize("B", [300, 33])
def test_riccati_kernel_at_the_ray_shape_matches_plain(dev, B):
    """K3 at (13, 2) (csrc/riccati_shape.cu) on the hybrid route's own stage
    blocks of a family-I batch, mid-solve (controls off rest, duals on),
    against its plain version by ops/kernel_check.py's rule; one launch."""
    from nmpc_tpu_torch.ops import kernel_check as KC
    from nmpc_tpu_torch.ops.cuda_build import lane
    from nmpc_tpu_torch.ops.riccati import riccati_plain
    from nmpc_tpu_torch.solver import alilqr_batched as AB

    ob = _ray_batch(dev, B)
    g = torch.Generator(device=dev).manual_seed(1)
    U = 0.05 * torch.randn((B, ob.N, ob.nu), generator=g, device=dev)
    lam = 0.5 * torch.randn((B, ob.N, ob.n_con), generator=g, device=dev).abs()
    lam = lam * (P.constraint_mask(ob) > 0)
    mu = torch.full((B,), 100.0, device=dev)
    exp = tuple(map(lane, AB.hybrid_expansions(ob, P.rollout(ob, U), U, lam, mu)))
    cuda_build.reset_launch_counts()
    got = riccati_lanes(exp, 1e-6)
    assert cuda_build.launch_counts["riccati_lanes"] == 1
    v = KC.Verdict()
    for i, (a, w, atol) in enumerate(zip(got, riccati_plain(exp, 1e-6), KC.K3_ATOL)):
        KC.hold(v, f"K3 (13, 2) output {i}", a, w, atol)
    assert v.units == B and v.n_widened == 0 and v.n_diverged == 0


def test_hybrid_route_on_the_card_launches_k3(dev):
    """A family-I batch on the card takes the hybrid route: K3 at (13, 2)
    every inner iteration, no other kernel (rays: plain rollouts), and the
    batch agrees with the same route's plain versions on the CPU in
    aggregate (cost ratio within 1e-3, convergence equal)."""
    ob = _ray_batch(dev, 64)
    cfg = ALILQRConfig(n_outer=4, n_inner=8, tol_con=1e-3)
    cuda_build.reset_launch_counts()
    res = solve_batched(ob, cfg=cfg)
    c = dict(cuda_build.launch_counts)
    assert c["riccati_lanes"] >= int(res.inner_iters.max()) > 0
    assert sum(c.values()) == c["riccati_lanes"], c
    ref = solve_batched(ob.to("cpu"), cfg=cfg)
    assert abs(float(res.cost.mean().cpu() / ref.cost.mean()) - 1.0) <= 1e-3
    assert torch.equal(res.converged.cpu(), ref.converged)
    with pytest.raises(NotImplementedError, match="up to n=30"):
        riccati_lanes(tuple(torch.zeros(s, device=dev) for s in (
            (5, 14, 14, 8), (5, 14, 21, 8), (5, 14, 8), (5, 21, 8), (5, 14, 14, 8),
            (5, 21, 21, 8), (5, 21, 14, 8))))


# ---------------------------------------------------------------------------
# K3 at the user models' stage shapes (2, 1) and (1, 1), the generic hybrid
# route
# ---------------------------------------------------------------------------


def _user_batch(dev, model, B, seed=0):
    from nmpc_tpu_torch.tools import user_models as UM

    make = UM.vdp_ocp if model == "vdp" else UM.process_ocp
    return UM.jittered(make(dev), B, torch.Generator(device=dev).manual_seed(seed))


@pytest.mark.parametrize("B", [300, 33])
@pytest.mark.parametrize("model", ["vdp", "process"])
def test_riccati_kernel_at_user_model_shapes_matches_plain(dev, model, B):
    """K3 at (2, 1) (Van der Pol) and (1, 1) (the first-order process),
    csrc/riccati_shape.cu at staged_tiles.k3_rule's geometry, on the hybrid
    route's own stage blocks mid-solve, against its plain version by
    ops/kernel_check.py's rule; one launch. B=33: a ragged tile, 4-byte
    copies."""
    from nmpc_tpu_torch.ops import kernel_check as KC
    from nmpc_tpu_torch.ops.cuda_build import lane
    from nmpc_tpu_torch.ops.riccati import riccati_plain
    from nmpc_tpu_torch.solver import alilqr_batched as AB

    ob = _user_batch(dev, model, B)
    g = torch.Generator(device=dev).manual_seed(1)
    U = 0.3 * torch.randn((B, ob.N, ob.nu), generator=g, device=dev)
    lam = 0.5 * torch.randn((B, ob.N, ob.n_con), generator=g, device=dev).abs()
    lam = lam * (P.constraint_mask(ob) > 0)
    mu = torch.full((B,), 100.0, device=dev)
    exp = tuple(map(lane, AB.hybrid_expansions(ob, P.rollout(ob, U), U, lam, mu)))
    cuda_build.reset_launch_counts()
    got = riccati_lanes(exp, 1e-6)
    assert cuda_build.launch_counts["riccati_lanes"] == 1
    assert (ob.nx, ob.nu) in cuda_build.k3_shape_build_info
    v = KC.Verdict()
    for i, (a, w, atol) in enumerate(zip(got, riccati_plain(exp, 1e-6), KC.K3_ATOL)):
        KC.hold(v, f"K3 ({ob.nx}, {ob.nu}) output {i}", a, w, atol)
    assert v.units == B and v.n_widened == 0 and v.n_diverged == 0


@pytest.mark.parametrize("shape", staged_tiles.K3_SWEEP_SHAPES)
def test_riccati_kernel_at_rule_shapes_matches_plain(dev, shape):
    """K3 from csrc/riccati_shape.cu at every branch of staged_tiles.k3_rule
    (K3_SWEEP_SHAPES: teams of 16 and 32 with nu = 1, odd nu and nu > T, both
    pitches, the spilled slots) against its plain version on random
    well-posed stage blocks, by ops/kernel_check.py's rule, at B = 33 and
    300."""
    from nmpc_tpu_torch.ops import kernel_check as KC
    from nmpc_tpu_torch.ops import riccati as RIC

    lib = cuda_build.load_k3_shape(*shape)
    g = torch.Generator(device=dev).manual_seed(sum(shape))
    for B in (33, 300):
        exp = KC.k3_inputs(*shape, B, 5, g)
        RIC.check_lanes(exp)
        got = RIC.launch(exp, 1e-6, lib)
        v = KC.Verdict()
        for i, (a, w, atol) in enumerate(zip(got, RIC.riccati_plain(exp, 1e-6), KC.K3_ATOL)):
            KC.hold(v, f"K3 {shape} B={B} output {i}", a, w, atol)
        assert v.units == B and v.n_widened == 0 and v.n_diverged == 0


def test_generic_hybrid_route_on_the_card_launches_k3(dev):
    """A Van der Pol batch on the card takes the hybrid route: K3 at (2, 1)
    every inner iteration and no other kernel (plain rollouts of every
    candidate), converging as the same route's plain versions on the CPU
    (cost ratio within 1e-3, convergence equal)."""
    ob = _user_batch(dev, "vdp", 64)
    cfg = ALILQRConfig(n_outer=6, n_inner=20, tol_con=1e-4)
    cuda_build.reset_launch_counts()
    res = solve_batched(ob, cfg=cfg)
    c = dict(cuda_build.launch_counts)
    assert c["riccati_lanes"] >= int(res.inner_iters.max()) > 0
    assert sum(c.values()) == c["riccati_lanes"], c
    ref = solve_batched(ob.to("cpu"), cfg=cfg)
    assert abs(float(res.cost.mean().cpu() / ref.cost.mean()) - 1.0) <= 1e-3
    assert torch.equal(res.converged.cpu(), ref.converged)


def test_dryrun_on_a_one_rank_nccl_world(dev, tmp_path):
    """The port's dry run (parallel/dryrun.py) on a one-rank NCCL world on
    the card: every block holds sharded = single-program, and the
    data-parallel step's solve_batched and consensus's fused engine launch
    K1 and K2."""
    from nmpc_tpu_torch.parallel import dryrun
    from nmpc_tpu_torch.parallel import mesh as M

    M.init_world("nccl", 0, 1, f"file://{tmp_path / 'store'}")
    try:
        cuda_build.reset_launch_counts()
        errs = dryrun.dryrun_multichip(M.data_mesh())
        counts = dict(cuda_build.launch_counts)
    finally:
        torch.distributed.destroy_process_group()
    assert counts["inner_solve_fused"] > 0 and counts["al_update_lanes"] > 0, counts
    assert {"consensus", "GN fleet", "ADMM fleet"} <= set(errs)
