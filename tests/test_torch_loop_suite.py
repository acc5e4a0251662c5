"""The reference's closed-loop suite on the port (nmpc_tpu_torch/tools/
loop_suite.py, tools/cl_parity.py) and the port's benchmark
(nmpc_tpu_torch/bench.py).

On the CPU (tier-1): the suite's geometry against the reference's bit for
bit; the invariant check and CL_PARITY's outcome rule with teeth (doctored
histories fail, the reference engine's own rows pass); one escape-law fuzz
seed at m=2 and one at m=6 for 30 steps against the reference's
closed_loop; the f64 solve; the per-design K1 counter; bench's refusals.

On the card (`gpu` and `slow`, one test per reference test of
loop_suite.CASES, each with the reference's budget, config and bounds):

    python -m pytest tests/test_torch_loop_suite.py -m "gpu and slow" --noconftest -q

(--noconftest: tests/conftest.py configures JAX, which the card's host
lacks; the CPU tests import JAX inside their bodies.) Each case's outcome
(steps, clearance, ms a step, launches) is recorded as the junit property
`outcome` (`--junitxml=...`).

Fuzz loops held pointwise only as far as the reference is stable: the
fuzz's random headings make its loops bifurcate within a few steps. With
x0 moved by 1e-7 and by 1e-6 (the size of the port's gap to the
reference after its first solve), the reference's own X_hist moves by at
most 1.1e-3 over rows 0-5 of m=2 seed 2 and 2.9e-6 over rows 0-2 of m=6
seed 22 (then 7.5e-2 and 0.56): those rows are held at X_hist atol 5e-3,
U_hist atol 2e-2 (tests/test_torch_driver.py's loop tolerances); every row
of both loops is held to the invariants that bind at any step (clearance
>= DMIN - 3e-2, |theta| < 2 pi + 0.5, finite). Each seed is the suite's
own (m=2 seeds 0-3, m=6 seeds 20-22) with the longest stable prefix
(`JAX_PLATFORMS=cpu python tests/reference_spread.py fuzz`).
"""

import dataclasses
import json
import math

import numpy as np
import pytest
import torch

from nmpc_tpu_torch import bench
from nmpc_tpu_torch.mpc import driver as TD
from nmpc_tpu_torch.ops import cuda_build, megasolve
from nmpc_tpu_torch.tools import cl_parity as CP
from nmpc_tpu_torch.tools import loop_suite as LS

# every (m, seeds) the suite's fuzz cases draw
SUITE_GEOMETRY = {}
for _kind in LS.FUZZ_SEEDS.values():
    for _m, _seeds in _kind.items():
        SUITE_GEOMETRY.setdefault(_m, set()).update(_seeds)
# fuzz loops held pointwise: (m, seed, steps, rows held) (module note)
POINTWISE = ((2, 2, 30, 6), (6, 22, 30, 3))


@pytest.fixture
def one_thread():
    """Eager loops of small ops: one intra-op thread (more only spin)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# the suite's pieces
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("m", sorted(SUITE_GEOMETRY))
def test_random_geometry_matches_reference(m):
    from test_escape_fuzz import _random_geometry

    for seed in SUITE_GEOMETRY[m]:
        for got, want in zip(LS.random_geometry(m, seed), _random_geometry(m, seed)):
            assert got.dtype == want.dtype == np.float32
            np.testing.assert_array_equal(got, want)


def test_suite_covers_its_geometry():
    """The suite's fuzz seeds are the reference tests' own, and each fuzz
    test has a case for each of its m."""
    import test_escape_fuzz
    import test_parallel

    def params(fn):
        mark = next(mk for mk in fn.pytestmark if mk.name == "parametrize")
        return {m: tuple(seeds) for m, seeds in mark.args[1]}

    assert LS.FUZZ_SEEDS["deterministic"] == params(
        test_escape_fuzz.test_escape_law_fuzz_deterministic)
    assert LS.FUZZ_SEEDS["delay"] == params(test_escape_fuzz.test_escape_law_fuzz_delay)
    assert LS.FUZZ_SEEDS["decentralized"] == params(
        test_parallel.test_decentralized_fuzz_random_antipodal)
    assert LS.FUZZ_SEEDS["noisy"] == {4: (30, 31, 32)}     # test_escape_fuzz.py:172
    names = {f"{prefix}{m}" for kind, prefix in (("deterministic", "escape_fuzz_deterministic_m"),
                                                 ("delay", "escape_fuzz_delay_m"),
                                                 ("decentralized", "decentralized_fuzz_m"))
             for m in LS.FUZZ_SEEDS[kind]} | {"escape_fuzz_noisy"}
    # and the LiDAR fuzz's two classes (tests/test_lidar_fuzz.py:120, 128)
    names |= {"lidar_fuzz_single_obstacle", "lidar_fuzz_two_obstacle_gauntlet"}
    assert names == {n for n in LS.CASES if "fuzz" in n}


def _lidar_class(name):
    """A LiDAR fuzz test's seeds and completion floor, read from its body
    (tests/test_lidar_fuzz.py:118-131: `seeds = ...`, `min_complete=`)."""
    import ast
    import inspect

    import test_lidar_fuzz

    tree = ast.parse(inspect.getsource(getattr(test_lidar_fuzz, name)))
    seeds = next(n.value for n in ast.walk(tree) if isinstance(n, ast.Assign)
                 and getattr(n.targets[0], "id", None) == "seeds")
    floor = next(k.value for n in ast.walk(tree) if isinstance(n, ast.Call)
                 for k in n.keywords if k.arg == "min_complete")
    n_obs = next(k.value for n in ast.walk(tree) if isinstance(n, ast.Call)
                 for k in n.keywords if k.arg == "n_obs")
    return (eval(ast.unparse(seeds), {"range": range, "tuple": tuple}),
            ast.literal_eval(floor), ast.literal_eval(n_obs))


@pytest.mark.parametrize("n_obs", [1, 2])
def test_lidar_field_matches_reference(n_obs):
    from test_lidar_fuzz import _random_field

    for seed in LS.LIDAR_SEEDS[n_obs]:
        for got, want in zip(LS.lidar_field(seed, n_obs), _random_field(seed, n_obs)):
            assert got.dtype == want.dtype == np.float32
            np.testing.assert_array_equal(got, want)
    obs, goals = LS.lidar_fields(LS.LIDAR_SEEDS[n_obs], n_obs)
    assert obs.shape == (len(LS.LIDAR_SEEDS[n_obs]), 2, 3) and goals.shape[1:] == (1, 3)


def test_lidar_cases_carry_the_reference_constants():
    """The LiDAR cases' N, GN config, step budget, far slot, seeds and
    floors are tests/test_lidar_fuzz.py's, and the first leg's is
    tests/test_cl_parity.py:240-261's."""
    import inspect

    import test_cl_parity
    import test_lidar_fuzz

    assert LS.LIDAR_N == test_lidar_fuzz.N and LS.LIDAR_MAX_STEPS == test_lidar_fuzz.MAX_STEPS
    assert dataclasses.asdict(LS.LIDAR_CFG) == dataclasses.asdict(test_lidar_fuzz.CFG)
    np.testing.assert_array_equal(LS.LIDAR_FAR, test_lidar_fuzz.FAR)
    for name, case in (("test_lidar_fuzz_single_obstacle", "lidar_fuzz_single_obstacle"),
                       ("test_lidar_fuzz_two_obstacle_gauntlet",
                        "lidar_fuzz_two_obstacle_gauntlet")):
        seeds, floor, n_obs = _lidar_class(name)
        assert LS.LIDAR_SEEDS[n_obs] == seeds and LS.LIDAR_FLOORS[n_obs] == floor
        with open(test_lidar_fuzz.__file__) as f:
            line = next(i + 1 for i, text in enumerate(f) if text.startswith(f"def {name}("))
        assert LS.CASES[case].ref == f"tests/test_lidar_fuzz.py:{line}"
    src = inspect.getsource(test_cl_parity.test_cl_parity_lidar_first_leg)
    assert "N=40, Nc=20, waypoints=(sc.waypoints[0],)" in src and "max_steps=400" in src
    assert "maxiter=100" in src and "0.15 - 1e-2" in src and "2 * lo + 20" in src
    mine = inspect.getsource(LS.cl_parity_lidar_first_leg)
    assert "N=40, Nc=20, waypoints=(sc.waypoints[0],)" in mine and "400" in mine
    assert "maxiter=100" in mine and "0.15 - 1e-2" in mine and "2 * lo + 20" in mine


def _lidar_history(B=2, S=150, done=(True, False), clr=0.2, v=0.15, stall=False):
    """Batched LiDAR histories: row 0 completes, row 1 is en route (or, with
    stall, stationary for its last 100 steps at clearance `clr`)."""
    X = torch.zeros(B, S + 1, 3)
    X[:, :, 0] = torch.linspace(0, 1, S + 1)
    if stall:
        X[1, -120:, 0] = X[1, -120, 0]
    U = torch.zeros(B, S, 2)
    U[:, :, 0] = v
    return X, U, torch.full((B, S), clr), torch.tensor(done)


@pytest.mark.parametrize("doctor,match", [
    (None, None),
    (dict(done=(False, False)), "only 0/2"),
    (dict(clr=0.099), "surface clearance"),
    (dict(v=0.1511), "outside the box"),
    (dict(stall=True, clr=0.149), "INSIDE the keep-out"),
    (dict(stall=True, clr=0.15), None),
])
def test_lidar_fuzz_check_has_teeth(doctor, match):
    """tests/test_lidar_fuzz.py::_check's bounds on the port: a healthy
    history passes, a doctored one fails the bound it breaks, and a
    stationary stall at the ray bound is a legitimate outcome."""
    outs, fails = LS.lidar_fuzz_check((0, 1), *_lidar_history(**(doctor or {})), min_complete=1)
    assert [o["seed"] for o in outs] == [0, 1]
    if match is None:
        assert fails == []
    else:
        assert fails and all(match in f for f in fails), fails


def test_gn_cases_are_not_refused_and_record_no_kernel(monkeypatch, one_thread):
    """The family-I cases (Case.kernels False) run engine "gn" whatever the
    engine flag says (the card's refusal of the plain engine skips them;
    a case with kernels is refused), and a LiDAR loop through
    cl_parity.lidar_engine_loop records K1/K2 at 0 beside the reason, its
    result on the run's device."""
    assert [n for n, c in LS.CASES.items() if not c.kernels] == [
        "lidar_fuzz_single_obstacle", "lidar_fuzz_two_obstacle_gauntlet",
        "cl_parity_lidar_first_leg"]
    seen = []
    monkeypatch.setitem(LS.CASES, "lidar_fuzz_single_obstacle",
                        LS.Case("tests/test_lidar_fuzz.py", lambda run: seen.append(run),
                                kernels=False))
    LS.run_case("lidar_fuzz_single_obstacle", "cuda", engine="ilqr")
    assert seen[0].device.type == "cuda" and seen[0].engine == "gn"
    with pytest.raises(ValueError, match="no hand kernel"):
        LS.run_case("single_robot_reference_config", "cuda", engine="ilqr")
    assert CP.row_engine("lidar_v4") == "gn" and CP.row_engine("eight_robot") == "fused"
    sc = dataclasses.replace(CP.get("lidar_v4"), N=8, Nc=4)
    run = LS.Run(torch.device("cpu"), "gn")
    out = CP.lidar_engine_loop(sc, 3, run)
    rec = out["record"]
    assert rec["K1"] == rec["K2"] == 0 and rec["kernels"] == LS.GN_NO_KERNEL
    assert rec["solves"] == 3 and out["X"].shape == (4, 3) and not run.fails
    run.on_device("t", (torch.zeros(1),))
    assert not run.fails
    LS.Run(torch.device("cuda")).on_device("t", (torch.zeros(1),))
    bad = LS.Run(torch.device("cuda"))
    bad.on_device("t", (torch.zeros(1),))
    assert "lives on ['cpu']" in bad.fails[0]


def test_lidar_oracle_loop_reaches_the_oracle():
    """The replica with its own solver (tests/oracle.py's f64 SLSQP) at a
    tiny size: three steps toward the first goal."""
    sc = dataclasses.replace(CP.get("lidar_v4"), N=6, Nc=3)
    o = CP.lidar_oracle_loop(sc, 3, maxiter=20)
    assert o["steps"] == 3 and o["X"].shape == (4, 3) and np.isfinite(o["X"]).all()
    assert o["X"][-1, 0] > 0 and o["min_dist"] > 0.15


def _history(m=2, steps=20, reached=True, dip=0.0, wind=0.0):
    """A healthy straight-line swap history of m robots (MPCResult), with
    the clearance dipped by `dip` below DMIN at one row and a heading wound
    to 2 pi + `wind` at one row when those are nonzero."""
    x0, xg = LS.random_geometry(m, 0)
    a = torch.linspace(0, 1, steps + 1)[:, None]
    X = torch.tensor(x0)[None] * (1 - a) + torch.tensor(xg)[None] * a
    X[:, 2::3] = 0.0
    mind = torch.full((steps + 1,), 0.8)
    if dip:
        mind[steps // 2] = LS.DMIN - dip
    if wind:
        X[steps // 3, 2] = 2 * math.pi + wind
    err = torch.linalg.norm(X[:-1] - torch.tensor(xg), dim=1)
    z = torch.zeros(steps)
    return TD.MPCResult(X_hist=X, U_hist=torch.zeros(steps, 2 * m), err_hist=err, cost_hist=z,
                        viol_hist=z, iter_hist=z.int(), min_dist_hist=mind,
                        steps_used=torch.tensor(steps, dtype=torch.int32),
                        reached=torch.tensor(reached), goal_idx_hist=z.int())


def test_check_invariants_passes_a_healthy_history():
    out = LS.check_invariants(_history(), 2, "healthy")
    assert out["reached"] and out["steps"] == 20 and out["min_dist"] == pytest.approx(0.8)
    assert out["max_theta"] == 0.0


@pytest.mark.parametrize("doctor,match", [
    (dict(reached=False), "no arrival"),
    (dict(dip=0.031), "clearance violated"),
    (dict(wind=0.6), "theta wound"),
])
def test_check_invariants_fails_each_invariant(doctor, match):
    with pytest.raises(AssertionError, match=match):
        LS.check_invariants(_history(**doctor), 2, "doctored")


def test_check_invariants_slack_follows_noise_and_delay():
    """The bounds widen exactly as the reference's do: a 3.1e-2 dip passes
    noisy (4e-2) and delayed (3e-2 + 0.11); a 0.6 rad wind passes noisy
    (2 pi + 2.0); past those they fail."""
    LS.check_invariants(_history(dip=0.031), 2, noisy=True)
    LS.check_invariants(_history(dip=0.135), 2, delay=True)
    LS.check_invariants(_history(wind=0.6), 2, noisy=True)
    with pytest.raises(AssertionError, match="clearance"):
        LS.check_invariants(_history(dip=0.041), 2, noisy=True)
    with pytest.raises(AssertionError, match="clearance"):
        LS.check_invariants(_history(dip=LS.DELAY_SLACK + 1e-3), 2, delay=True)
    with pytest.raises(AssertionError, match="theta"):
        LS.check_invariants(_history(wind=2.01), 2, noisy=True)


@pytest.mark.parametrize("name", [r[0] for r in CP.ROWS])
def test_cl_parity_judge_passes_the_reference_engine(name):
    """The reference engine's own rows in rows.json meet the outcome rule
    against the oracle's."""
    row = CP.load_rows()[name]
    port = dict(reached=row["e_reached"], steps=row["e_steps"], min_dist=row["e_md"],
                final_err=row["e_err"])
    assert CP.judge(name, port, row) == []


def test_cl_parity_judge_has_teeth():
    rows = CP.load_rows()
    row = rows["six_robot_antipodal"]
    good = dict(reached=True, steps=row["o_steps"], min_dist=0.3, final_err=0.09)
    assert CP.judge("six_robot_antipodal", good, row) == []
    for bad, match in ((dict(reached=False), "arrived"), (dict(min_dist=0.289), "clearance"),
                       (dict(steps=2 * row["o_steps"] + 21), "steps")):
        fails = CP.judge("six_robot_antipodal", good | bad, row)
        assert len(fails) == 1 and match in fails[0], fails
    # the delay row takes the fuzz's delay bound, the standoff row the error
    impl = rows["six_robot_impl"]
    port = dict(reached=True, steps=impl["o_steps"], min_dist=0.4 - LS.DELAY_SLACK + 1e-4,
                final_err=0.09)
    assert CP.judge("six_robot_impl", port, impl) == []
    assert CP.judge("six_robot_impl", port | dict(min_dist=0.4 - LS.DELAY_SLACK - 1e-3), impl)
    eight = rows["eight_robot"]
    port = dict(reached=False, steps=600, min_dist=0.25, final_err=1.11 * eight["o_err"])
    assert "10%" in CP.judge("eight_robot", port, eight)[0]
    assert CP.judge("eight_robot", port | dict(final_err=0.95 * eight["o_err"]), eight) == []


@pytest.mark.parametrize("m,seed,steps,held", POINTWISE)
def test_fuzz_loop_matches_reference(m, seed, steps, held, one_thread):
    """One fuzz seed's loop, the port's per-scenario engine on the CPU
    against the reference's closed_loop, at the fuzz's config: pointwise
    over the rows where the reference is stable, by the invariants that
    bind at any step over all 30 (module note)."""
    import functools

    import jax

    from nmpc_tpu.mpc import driver as JD
    from nmpc_tpu.ocp.problem import make_ocp as jax_make_ocp
    from test_escape_fuzz import CFG, DMIN

    x0, xg = LS.random_geometry(m, seed)
    mpc = dict(max_steps=steps, stop_tol=1e-1, escape=True)
    jr = jax.jit(functools.partial(JD.closed_loop, solver_cfg=CFG, mpc=JD.MPCConfig(**mpc)))(
        jax_make_ocp(m=m, N=12, T=0.2, x0=x0, x_goal=xg, dmin=DMIN, collision=True))
    tr = TD.closed_loop(LS.fuzz_ocp(m, seed, "cpu"), LS.FULL, TD.MPCConfig(**mpc))
    np.testing.assert_allclose(tr.X_hist[:held].numpy(), np.asarray(jr.X_hist)[:held], atol=5e-3)
    np.testing.assert_allclose(tr.U_hist[:held - 1].numpy(), np.asarray(jr.U_hist)[:held - 1],
                               atol=2e-2)
    for r in (tr, jr):
        X, mind = np.asarray(r.X_hist), np.asarray(r.min_dist_hist)
        assert np.isfinite(X).all() and mind.min() >= DMIN - 3e-2, mind.min()
        assert np.abs(X.reshape(-1, m, 3)[:, :, 2]).max() < 2 * np.pi + 0.5


def test_f64_solve():
    out = LS.run_case("f64_solve")
    assert out["ok"] and out["loops"][0]["dtype"] == "torch.float64"
    assert out["loops"][0]["viol"] < 1e-6


# ---------------------------------------------------------------------------
# launch accounting
# ---------------------------------------------------------------------------


def test_k1_design_counter(monkeypatch):
    """inner_solve_fused counts each launch under the design it ran (the
    team design at m <= 2, the warp design elsewhere); a launch-less call
    (B=0) counts none; reset clears both; `launches` refuses a loop whose K1
    ran in the other design or whose K2 did not run."""
    def fake(ocp, x0, *args):
        if x0.shape[0]:
            cuda_build.launch_counts["inner_solve_fused"] += 1
        return "ran"

    monkeypatch.setattr(megasolve, "team_launch", fake)
    monkeypatch.setattr(megasolve, "warp_launch", fake)
    cuda_build.reset_launch_counts()
    cuda = torch.empty(1, 3, device="meta")   # any non-CPU tensor takes the kernel branch
    for m in (1, 2, 6, 6, 10):
        ocp = type("O", (), {"m": m})()
        assert megasolve.inner_solve_fused(ocp, cuda, None, None, None, None, None) == "ran"
    megasolve.inner_solve_fused(type("O", (), {"m": 6})(), torch.empty(0, 3, device="meta"),
                                None, None, None, None, None)
    assert cuda_build.k1_designs == {"team": 2, "warp": 3}
    assert cuda_build.launch_counts["inner_solve_fused"] == 5
    cuda_build.launch_counts["al_update_lanes"] += 5
    assert LS.launches(torch.device("cuda"), 6, "t", 5)[1]     # 2 of 5 in the team design
    cuda_build.reset_launch_counts()
    assert cuda_build.k1_designs == {"team": 0, "warp": 0}
    assert not any(cuda_build.launch_counts.values())
    megasolve.inner_solve_fused(type("O", (), {"m": 1})(), cuda, None, None, None, None, None)
    assert LS.launches(torch.device("cuda"), 1, "t", 1)[1]     # no K2
    cuda_build.launch_counts["al_update_lanes"] += 1
    out, fails = LS.launches(torch.device("cuda"), 1, "t", 1)
    assert not fails and out["K1_team"] == out["K1"] == 1
    assert LS.launches(torch.device("cpu"), 6, "t", 1)[1] == []   # plain versions: no check
    cuda_build.reset_launch_counts()


def _tiny_case(run):
    """Three steps of the m=2 fuzz loop at 2x3 (tools/loop_diff.py's test)."""
    LS._point(run, (2, 0), LS.fuzz_ocp(2, 0, run.device), LS.ALILQRConfig(n_outer=2, n_inner=3),
              TD.MPCConfig(max_steps=3, escape=True))


def test_loop_diff_holds_without_moving_the_loop(monkeypatch, one_thread):
    """The hold runs the plain version beside every `every`-th K1 call and
    counts, and leaves the loop's outcome as it was; --spread's start moves
    x0 by 1e-7 (numpy seed) and nothing else."""
    from nmpc_tpu_torch.tools import loop_diff as LD

    monkeypatch.setitem(LS.CASES, "tiny", LS.Case("tests/test_torch_loop_suite.py", _tiny_case))
    held = LD.diff_case("tiny", "cpu", every=2)
    plain = LD.diff_case("tiny", "cpu", hold=False)
    h = held["hold"]
    assert h["launches"] > 2 and h["held"] == (h["launches"] + 1) // 2 == h["scenarios"]
    assert h["k1_apart"] <= h["held"] and h["plain_vs_itself_apart"] <= h["held"]
    strip = lambda out: [{k: v for k, v in rec.items()  # noqa: E731
                          if k != "wall_s" and "_ms" not in k} for rec in out["loops"]]
    assert strip(held) == strip(plain) and plain["hold"] is None
    run = LS.Run(torch.device("cpu"), dx0_seed=3)
    x0 = torch.zeros(6)
    dx = run.moved(x0)
    assert 0 < float(dx.abs().max()) < 1e-6 and torch.equal(dx, run.moved(x0))
    assert LS.Run(torch.device("cpu")).moved(x0) is x0


def test_cl_parity_spread_moves_the_start(one_thread):
    """A CL_PARITY row's loop starts where Run.dx0_seed moves it (the
    tools' --spread), and from the registry start without a seed."""
    x0 = CP.get("six_robot_antipodal").make(device="cpu").x0
    tiny = LS.ALILQRConfig(n_outer=1, n_inner=1)
    starts = [CP.engine_loop("six_robot_antipodal", 1, {}, LS.Run(torch.device("cpu"), dx0_seed=s),
                             cfg=tiny)["X"][0] for s in (None, 0, 1)]
    np.testing.assert_array_equal(starts[0], x0.double().numpy())
    for seed, got in zip((0, 1), starts[1:]):
        want = LS.Run(torch.device("cpu"), dx0_seed=seed).moved(x0)
        np.testing.assert_array_equal(got, want.double().numpy())
        assert 0 < np.abs(got - starts[0]).max() < 1e-6
    assert np.abs(starts[1] - starts[2]).max() > 0


def test_card_refuses_the_plain_engine():
    with pytest.raises(ValueError, match="no hand kernel"):
        LS.run_case("six_robot_antipodal_headline", "cuda", engine="ilqr")


# ---------------------------------------------------------------------------
# bench
# ---------------------------------------------------------------------------


def test_bench_refuses_without_a_card(monkeypatch):
    from nmpc_tpu_torch import __main__ as cli

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["bench"])


def _stub(launch: bool):
    def solve(ob, warm, cfg):
        assert warm is None and cfg == bench.CFG and ob.x0.shape == (4, 18)
        if launch:
            cuda_build.launch_counts["inner_solve_fused"] += cfg.n_outer
            cuda_build.launch_counts["al_update_lanes"] += cfg.n_outer
        return type("R", (), {"cost": torch.zeros(ob.x0.shape[0])})()
    return solve


def test_bench_raises_when_k1_does_not_launch():
    with pytest.raises(RuntimeError, match="did not launch K1 and K2"):
        bench.measure(4, "cpu", _stub(False))


def test_bench_line(capsys):
    got = bench.measure(4, "cpu", _stub(True))
    assert list(got) == ["metric", "value", "unit", "vs_baseline", "engine"]
    assert got["metric"] == "NMPC solves/s/chip (six-robot, N=10 horizon)"
    assert got["unit"] == "solves/s" and got["engine"] == "cuda-megakernel"
    assert got["value"] > 0 and got["vs_baseline"] == round(got["value"] / 1000.0, 3)
    ob = bench.batch_ocp(bench.get("six_robot_antipodal").make(N=10, device="cpu"),
                         torch.zeros(4, 18))
    assert bench.route_refusal(ob, bench.CFG) is None
    assert "mega" in bench.route_refusal(ob, dataclasses.replace(bench.CFG, mega=False))
    assert "scan" in bench.route_refusal(ob, dataclasses.replace(bench.CFG, sweep="scan"))


# ---------------------------------------------------------------------------
# on the card: one case per reference test
# ---------------------------------------------------------------------------


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


# Cases that fail their bound on the card where the reference, run on the
# CPU from its start or from x0 moved by 1e-7 (tests/reference_spread.py),
# fails the same bound: findings about the reference's bounds (ROADMAP
# Queue 3), measured on an NVIDIA H100 80GB HBM3 at 700 W.
REFERENCE_FINDINGS = {
    "cl_parity_six_robot_antipodal":
        "reached in 84 steps at min pair distance 0.2885 < dmin - 1e-2 = 0.29; from 4 starts "
        "moved by 1e-7 the port gives 0.2898-0.2990; the reference's engine loop gives "
        "0.2876-0.2992 over its start and 4 moved starts (`reference_spread.py cl_parity`)",
    "delay_closed_loop_six_robot_hw_config":
        "from six_robot_impl's own start the undelayed and the compensated loops stall at final "
        "err 2.8149 and 2.9468 after 150 steps (delay=1: 121 steps, min 0.2867). The start is a "
        "bifurcation: the reference's first solve moves by 0.825-1.558 in U under 1e-7 moves of "
        "x0, the port's lies 0.675 from it (`reference_spread.py hw_start`). Arrival missed over "
        "the start and 40 starts moved by 1e-7 on the card: delay=1 14, undelayed 2, compensated "
        "4 of 41 (`loop_diff --every 0 --spread 40`); the reference: 13, 0 and 2 of 64 "
        "(`reference_spread.py rates`); the port's per-scenario engine on the CPU: 8, 0 and 0 of "
        "25 (`loop_suite --device cpu --engine ilqr --dx0-seed`)",
    "decentralized_fuzz_m6":
        "seed 20 reaches at min pair distance 0.2166 < DMIN - 3e-2 = 0.27 (seeds 21, 22: "
        "0.3440, 0.3335); the reference on the CPU gives 0.2476 at seed 21's own start with "
        "its default engine and 0.1875-0.3614 over 5 starts a seed (`reference_spread.py "
        "loops dec`)",
}


@pytest.mark.gpu
@pytest.mark.slow
@pytest.mark.parametrize("name", [
    pytest.param(n, marks=pytest.mark.xfail(strict=True, reason=REFERENCE_FINDINGS[n]))
    if n in REFERENCE_FINDINGS else n
    for n in LS.CASES if n not in LS.CPU_CASES])
def test_case_on_the_card(name, dev, record_property):
    try:
        out = LS.run_case(name, dev)
    except AssertionError as e:
        record_property("outcome", json.dumps(getattr(e, "outcome", None), default=str))
        raise
    record_property("outcome", json.dumps(out, default=str))
    assert out["ok"]
