"""The port's roofline tools (nmpc_tpu_torch/tools, nmpc_tpu_torch/utils)
against the JAX package's tools/ they replace, on the CPU; and the port's
default device.

The reference tools are imported by path (they put the repository root on
sys.path themselves); their Pallas kernels run in interpret mode, as the
JAX package's own CPU tests run them. Inputs are made with numpy from a seed
and handed to both.

Tolerances: the K8 modes and K9 at three fixed iterations, cost rtol 1e-4
and U atol 5e-3 (the tolerances of tests/test_batched_solver.py: the port's
plain version sums in another order than the Pallas kernel); the analytic
FLOP and byte models exactly; K7's chain bit for bit (each f64 step of the
plain version is exact for these constants, so it rounds once, as the FMA).
"""

import dataclasses
import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nmpc_tpu.ocp import problem as JP
from nmpc_tpu.parallel.batch import batch_ocp as jax_batch_ocp
from nmpc_tpu.scenarios import get as jax_get
from nmpc_tpu.solver.alilqr import ALILQRConfig as JaxConfig
from nmpc_tpu.utils import timing as jax_timing
from nmpc_tpu_torch.ocp import problem as TP
from nmpc_tpu_torch.ops import cuda_build, megasolve
from nmpc_tpu_torch.parallel import batch_ocp
from nmpc_tpu_torch.scenarios import get
from nmpc_tpu_torch.solver.alilqr import ALILQRConfig, warm_from_numpy
from nmpc_tpu_torch.tools import exp_blocked_expansions as K9
from nmpc_tpu_torch.tools import exp_mega_phases as K8
from nmpc_tpu_torch.tools import k1_launch as K1L
from nmpc_tpu_torch.tools import k1_phases as K1P
from nmpc_tpu_torch.tools import roofline as RL
from nmpc_tpu_torch.tools import sass_diff as SD
from nmpc_tpu_torch.utils import timing

ROOT = Path(__file__).resolve().parent.parent
B = 128


def _reference_tool(name):
    spec = importlib.util.spec_from_file_location(f"reference_{name}", ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _lanes(a):
    """[B, ...] -> the reference's one-tile lane layout [1, ..., 128]."""
    return jnp.asarray(np.moveaxis(np.asarray(a), 0, -1)[None])


def _from_lanes(a):
    return np.moveaxis(np.asarray(a)[0], -1, 0)


def _problem(duals: bool, seed=0):
    """two_robot_swap N=6, B=128 jittered starts; lam = 0, U = 0 (the
    ablation's inputs) or lam = |0.1 N(0,1)|, U = 0.01 N(0,1) (the A/B's);
    mu = 10. Returns the reference batch, the port's (on the CPU) and the
    numpy inputs."""
    base = jax_get("two_robot_swap").make(N=6)
    rng = np.random.default_rng(seed)
    x0 = (np.asarray(base.x0)[None] + 0.1 * rng.standard_normal((B, base.nx))).astype(np.float32)
    ob = jax_batch_ocp(base, jnp.asarray(x0))
    if duals:
        lam = np.abs(0.1 * rng.standard_normal((B, base.N, base.n_con))).astype(np.float32)
        U = (0.01 * rng.standard_normal((B, base.N, base.nu))).astype(np.float32)
    else:
        lam = np.zeros((B, base.N, base.n_con), np.float32)
        U = np.zeros((B, base.N, base.nu), np.float32)
    mu = np.full((B,), 10.0, np.float32)
    port = dataclasses.replace(get("two_robot_swap").make(N=6, device="cpu"),
                               x0=torch.from_numpy(x0), xref=torch.from_numpy(np.array(ob.xref)))
    return base, ob, port, lam, mu, U


def _reference_inputs(ob, lam, mu, U):
    return (_lanes(np.asarray(ob.x0)[:, None]), _lanes(ob.xref), _lanes(lam),
            jnp.asarray(mu)[None, None], _lanes(U))


def _check_against_reference(ref_out, got, U):
    want_U, want_X = _from_lanes(ref_out[0]), _from_lanes(ref_out[1])
    want_cost = np.asarray(ref_out[2])[0, 0]
    Xs, Uo, cost, iters = (t.numpy() for t in got)
    assert Xs.shape == want_X.shape and Uo.shape == want_U.shape
    np.testing.assert_allclose(cost, want_cost, rtol=1e-4)
    np.testing.assert_allclose(Uo, want_U, atol=5e-3)
    np.testing.assert_allclose(Xs, want_X, atol=5e-3)
    assert np.isfinite(Xs).all()
    return want_cost


@pytest.mark.parametrize("mode", K8.MODES)
def test_phase_ablation_plain_matches_reference(mode):
    ref = _reference_tool("exp_mega_phases")
    base, ob, port, lam, mu, U = _problem(duals=False)
    kw = dict(n_outer=1, n_inner=3, ls="adaptive")
    out = ref.run_mode(base, *_reference_inputs(ob, lam, mu, U), JaxConfig(**kw), mode)
    got = K8.phase_ablation(port, port.x0, port.xref, torch.from_numpy(lam), torch.from_numpy(mu),
                            torch.from_numpy(U), ALILQRConfig(**kw), mode, n_iter=3)
    want_cost = _check_against_reference(out, got, U)
    assert (got[3] == 3).all()
    if mode == "sweep_only":
        assert (got[2] == 0).all() and np.all(want_cost == 0)
        assert torch.equal(got[1], torch.from_numpy(U))   # U never changes
    else:
        assert (got[1] != 0).any()                        # the controls moved


@pytest.mark.parametrize("blocked", [False, True])
def test_expansion_ab_plain_matches_reference(blocked):
    """Both reference layouts (per-row and blocked) against the port's plain
    K9, with nonzero duals so the activation branches do real work."""
    ref = _reference_tool("exp_blocked_expansions")
    base, ob, port, lam, mu, U = _problem(duals=True, seed=1)
    kw = dict(n_outer=1, n_inner=3, ls="adaptive")
    out = ref.run(base, *_reference_inputs(ob, lam, mu, U), JaxConfig(**kw), blocked)
    for layout in K9.LAYOUTS:
        got = K9.expansion_ab(port, port.x0, port.xref, torch.from_numpy(lam), torch.from_numpy(mu),
                              torch.from_numpy(U), ALILQRConfig(**kw), layout, n_iter=3)
        _check_against_reference(out, got, U)


def test_cpu_wrappers_take_the_plain_versions():
    _, _, port, lam, mu, U = _problem(duals=True, seed=2)
    lam, mu, U = torch.from_numpy(lam), torch.from_numpy(mu), torch.from_numpy(U)
    cfg = ALILQRConfig(n_inner=7, ls="adaptive")
    cuda_build.reset_launch_counts()
    # K8 'full' with the early exit is K1: the plain K1 at n_inner = n_iter
    got = K8.phase_ablation(port, port.x0, port.xref, lam, mu, U, cfg, "full", 2, early_exit=True)
    want = megasolve.inner_solve_plain(port, port.x0, port.xref, lam, mu, U,
                                       ALILQRConfig(n_inner=2, ls="adaptive"))
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    a = K9.expansion_ab(port, port.x0, port.xref, lam, mu, U, cfg, "dense", 2)
    b = K8.phase_ablation(port, port.x0, port.xref, lam, mu, U, cfg, "full", 2)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    x0 = RL.fma_inputs(4, 16, "cpu")
    assert torch.equal(RL.fma_peak(x0, 1.5, 0.25, 3), RL.fma_chain_plain(x0, 1.5, 0.25, 3))
    assert sum(cuda_build.launch_counts.values()) == 0
    with pytest.raises(ValueError, match="mode"):
        K8.phase_ablation(port, port.x0, port.xref, lam, mu, U, cfg, "no_such", 2)
    with pytest.raises(ValueError, match="early exit"):
        K8.phase_ablation(port, port.x0, port.xref, lam, mu, U, cfg, "no_ls", 2, early_exit=True)
    with pytest.raises(ValueError, match="layout"):
        K9.expansion_ab(port, port.x0, port.xref, lam, mu, U, cfg, "blocked", 2)


def test_f64_witness_shows_the_undamped_modes_diverge():
    """At K1's phase-3 inputs (warm duals, mu up to 1e4) the undamped steps
    of the modes without a line search diverge in f64 on many scenarios,
    `full` on none; a result that is the plain f32 run misses f64 exactly
    where that run does (some scenarios that do not diverge too), and one
    moved by 1e-2 misses it everywhere else."""
    base = get("six_robot_antipodal").make(N=10, device="cpu")
    rng = np.random.default_rng(0)
    x0 = torch.from_numpy((base.x0.numpy()[None] + 0.1 * rng.standard_normal((B, base.nx))).astype(np.float32))
    ob = batch_ocp(base, x0)
    U = torch.from_numpy((0.05 * rng.standard_normal((B, base.N, base.nu))).astype(np.float32))
    lam = torch.from_numpy((0.5 * np.abs(rng.standard_normal((B, base.N, base.n_con)))).astype(np.float32))
    lam = lam * (TP.constraint_mask(ob) > 0)
    mu = torch.from_numpy(np.array([10.0, 100.0, 1e3, 1e4], np.float32)[rng.integers(0, 4, B)])
    cfg = ALILQRConfig(n_inner=4, ls="adaptive")
    for mode in ("inv_solve", "full"):
        plain = K8.phase_ablation_plain(ob, ob.x0, ob.xref, lam, mu, U, cfg, mode, 4)
        w = K8.f64_witness(ob, ob.x0, ob.xref, lam, mu, U, cfg, mode, 4, plain)
        assert w["scenarios"] == B
        assert (w["diverged"] > B // 4) if mode == "inv_solve" else (w["diverged"] == 0), w
        assert w["kernel_missed"] == w["plain_missed"] and w["kernel_vs_plain"] == 0.0
        moved = (plain[0], plain[1] + 1e-2, *plain[2:])
        m = K8.f64_witness(ob, ob.x0, ob.xref, lam, mu, U, cfg, mode, 4, moved)
        assert m["kernel_missed"] >= B - w["diverged"] - w["plain_missed"], (w, m)


def test_sass_listing_parsed_and_compared():
    listing = """
	code for sm_90a
		Function : _Z2k1v
	.headerflags	@"EF_CUDA_TEXMODE_UNIFIED"
        /*0000*/                   LDC R1, c[0x0][0x28] ;           /* 0x00000a00ff017b82 */
                                                                   /* 0x000fe20000000800 */
        /*0010*/                   EXIT ;                           /* 0x000000000000794d */
                                                                   /* 0x000fea0003800000 */
		Function : _Z2k2v
        /*0000*/                   EXIT ;                           /* 0x000000000000794d */
                                                                   /* 0x000fea0003800000 */
"""
    a = SD.functions(listing)
    assert list(a) == ["_Z2k1v", "_Z2k2v"] and len(a["_Z2k1v"]) == 4
    assert SD.instructions(a["_Z2k1v"]) == 2 and SD.instructions(a["_Z2k2v"]) == 1
    b = SD.functions(listing.replace("c[0x0][0x28]", "c[0x0][0x30]").replace("_Z2k2v", "_Z2k3v"))
    assert SD.compare(a, a) == {"_Z2k1v": (2, 2, 0), "_Z2k2v": (1, 1, 0)}
    assert SD.compare(a, b) == {"_Z2k1v": (2, 2, 2), "_Z2k2v": (1, 0, None), "_Z2k3v": (0, 1, None)}
    assert SD.main([]) == 2


def test_solve_diff_counts_entries_that_differ():
    """tools/solve_diff.py: NaN equals NaN, a changed entry or a flipped
    flag counts, a shape change shows as -1; its solves read only outputs
    SolveResult has; without a checkout to compare it prints its usage."""
    from nmpc_tpu_torch.solver.alilqr import SolveResult
    from nmpc_tpu_torch.tools import solve_diff as SV

    a = torch.tensor([1.0, float("nan"), 3.0])
    assert SV.differ(a, a.clone()) == 0
    assert SV.differ(a, torch.tensor([1.0, float("nan"), 3.5])) == 1
    assert SV.differ(a, torch.tensor([float("nan"), 2.0, 3.0])) == 2
    assert SV.differ(torch.tensor([True, False]), torch.tensor([True, True])) == 1
    assert SV.differ(a, a[:2]) == -1
    assert set(SV.OUTPUTS) <= {f.name for f in dataclasses.fields(SolveResult)}
    compile(SV.SOLVES, "solve_diff.SOLVES", "exec")
    compile(SV.TIMES, "solve_diff.TIMES", "exec")
    assert SV.main([]) == 2


def test_k1_launch_reads_the_report():
    report = """ptxas info    : Compiling entry function '_ZN4nmpc16al_update_kernelILi6EEEvNS_6ALArgsE' for 'sm_90a'
ptxas info    : Function properties for _ZN4nmpc16al_update_kernelILi6EEEvNS_6ALArgsE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 28 registers, used 1 barriers, 368 bytes smem
ptxas info    : Compiling entry function '_ZN4nmpc18inner_solve_kernelILi6EEEvNS_8WarpArgsE' for 'sm_90a'
ptxas info    : Function properties for _ZN4nmpc18inner_solve_kernelILi6EEEvNS_8WarpArgsE
    152 bytes stack frame, 348 bytes spill stores, 568 bytes spill loads
ptxas info    : Used 80 registers, used 1 barriers, 152 bytes cumulative stack size, 496 bytes smem
"""
    assert K1L.k1_ptxas(report) == (
        "152 bytes stack frame, 348 bytes spill stores, 568 bytes spill loads; Used 80 "
        "registers, used 1 barriers, 152 bytes cumulative stack size, 496 bytes smem")
    assert set(K1L.SCENARIOS) == set(cuda_build.ROBOT_COUNTS)
    assert all(get(name).make(N=10, device="cpu").m == m for m, name in K1L.SCENARIOS.items())
    assert K1L.batch_size(6) == 32768 and K1L.batch_size(10) == 16384


def test_k1_launch_team_sweep_settings():
    """The team design's sweep: the base first (the solver's settings), then
    one setting changed at a time, every key a -D macro of cuda_build; the
    report's team kernel line found by its name; the phase split's probes
    (csrc/inner_team.cuh marks 0-6 and 10-13)."""
    assert set(K1L.TEAM_BASE) == set(cuda_build.TEAM_ROBOTS)
    for m, base in K1L.TEAM_BASE.items():
        variants = K1L.team_variants(m)
        assert variants[0] == base and set(base) == set(cuda_build.TEAM_SETTINGS)
        for v in variants[1:]:
            assert sum(v[k] != base[k] for k in v) == 1
        assert len(variants) == 1 + sum(len(x) - 1 for x in K1L.TEAM_VALUES.values())
    assert K1L.team_key(K1L.TEAM_BASE[1]) == "T=8 D=3 min_blocks=4"
    report = """ptxas info    : Compiling entry function '_ZN4nmpc17inner_team_kernelILi1ELb1EEEvNS_8WarpArgsE' for 'sm_90a'
ptxas info    : Function properties for _ZN4nmpc17inner_team_kernelILi1ELb1EEEvNS_8WarpArgsE
    96 bytes stack frame, 44 bytes spill stores, 68 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers, 96 bytes cumulative stack size
"""
    assert K1L.k1_ptxas(report, "inner_team_kernelILi1ELb1E") == (
        "96 bytes stack frame, 44 bytes spill stores, 68 bytes spill loads; Used 128 "
        "registers, used 1 barriers, 96 bytes cumulative stack size")
    assert sorted(K1P.TEAM_PHASES) == [0, 1, 2, 3, 4, 5, 6, 10, 11, 12, 13]
    assert cuda_build.TEAM_ROBOTS == (1, 2) and not hasattr(megasolve, "TEAM_ROBOTS")
    assert K1L.warp_k1.__code__.co_varnames[:7] == (
        "ocp", "x0", "xref", "lam", "mu", "U", "cfg")


@pytest.mark.parametrize("m", [1, 2, 6, 10])
def test_analytic_model_matches_reference(m):
    ref = _reference_tool("roofline")
    pairs = m * (m - 1) // 2
    for kw in (dict(), dict(n_obs=3), dict(n_mov=5, merit_evals=3.0)):
        assert RL.iteration_flops(m, 10, pairs, **kw) == ref.iteration_flops(m, 10, pairs, **kw)
    for kw in (dict(), dict(n_obs=2, n_outer=12)):
        assert RL.hbm_bytes_per_solve(m, 20, pairs, **kw) == ref.hbm_bytes_per_solve(m, 20, pairs, **kw)


def test_kernel_work_hand_counted():
    six = get("six_robot_antipodal").make(N=10, device="cpu")  # n=18, nu=12, nc=75
    cfg = ALILQRConfig(n_outer=6, n_inner=12, tol_con=1e-3, ls="adaptive")
    Bs = 32768
    # K4 writes A 324, B 216, lx 18, lu 12, lxx 324, luu 144, lux 216 = 1,254
    # floats per stage and scenario and reads X 18, U 12, xref 18, lam 75
    _, k4 = RL.kernel_work("K4", six, Bs)
    assert k4 == 4 * Bs * (10 * (1254 + 18 + 12 + 18 + 75) + 1)
    # K3 reads them and writes kff 12, Kfb 216 per stage, dV1 once
    _, k3 = RL.kernel_work("K3", six, Bs)
    assert k3 == 4 * Bs * (10 * (1254 + 12 + 216) + 1)
    # K1 reads x0, xref, lam, mu, U and writes Xs, U, cost, iters
    f1, k1 = RL.kernel_work("K1", six, Bs, cfg, iters=12 * Bs, candidates=14 * Bs)
    assert k1 == 4 * Bs * (18 + 10 * (18 + 75 + 12) + 1 + 10 * (18 + 12) + 2)
    # K2: Xs, U, lam, mu in; lam, viol out
    _, k2 = RL.kernel_work("K2", six, Bs)
    assert k2 == 4 * Bs * (10 * (18 + 12 + 75) + 1 + 10 * 75 + 1)
    # K6 at one robot: per stage the feedback (3 dx + 2 controls x (2 + 6))
    # and the Euler step (sin, cos, 8)
    one = get("slsqp_pose").make(N=5, device="cpu")
    f6, k6 = RL.kernel_work("K6", one, 7)
    assert f6 == 7 * 5 * ((3 + 2 * 8) + 10)
    assert k6 == 4 * 7 * (3 + 5 * (3 + 2 + 2 + 6) + 1 + 5 * (3 + 2))
    # K7: an FMA is two FLOPs
    assert RL.kernel_work("K7", six, 0, chains=8, R=100, threads=1000) == (1.6e6, 4 * 1000 * 8 * 2)
    # K1's FLOPs follow the iterations run and the candidates its line
    # search needed; it rolls no accepted step out again, so an iteration
    # with one candidate is less work than the first design's (K8 full: two
    # candidates and the accepted rollout); K8's ablations do less than full
    f1b, _ = RL.kernel_work("K1", six, Bs, cfg, iters=6 * Bs, candidates=7 * Bs)
    sweep, cand = RL.sweep_flops(six), RL.candidate_flops(six)
    assert f1 - f1b == pytest.approx(6 * Bs * sweep + 7 * Bs * cand)
    per_it = RL.inner_iteration_flops(six, cfg)
    assert sweep + cand < sweep + 2 * cand < per_it
    f8, _ = RL.kernel_work("K8", six, Bs, cfg, iters=6 * Bs)
    assert f8 - f1b == pytest.approx(6 * Bs * per_it - 6 * Bs * sweep - 7 * Bs * cand)
    flops = {mode: RL.inner_iteration_flops(six, cfg, mode) for mode in K8.MODES}
    assert flops["sweep_only"] < flops["no_ls"] < flops["full"]
    assert flops["no_solve"] < flops["no_ls"] < flops["inv_solve"]
    assert flops["no_expcon"] < flops["no_ls"]
    # and the port's count lands near the reference's model of the same kernel
    assert per_it == pytest.approx(RL.iteration_flops(6, 10, 15)["per_iteration"], rel=0.15)
    executed = RL.k1_executed(torch.tensor([0, 3, 12], dtype=torch.int32), 12)
    assert executed.tolist() == [1, 4, 12]
    assert RL.bound(67e9, 1.0) == (pytest.approx(1.0), "operations")
    assert RL.bound(1.0, 3.35e9) == (pytest.approx(1.0), "bytes")


def test_fma_chain_plain_matches_numpy():
    """The plain K7 against a numpy recurrence: each step's exact result
    (f64 holds it for these constants) rounded once to f32, as an FMA."""
    rng = np.random.default_rng(0)
    x0 = (1.0 + 1e-3 * rng.random((4, 64))).astype(np.float32)
    a, b, R = np.float32(1.0000001), np.float32(1e-7), 200
    want = x0.copy()
    for _ in range(R):
        want = (want.astype(np.float64) * np.float64(a) + np.float64(b)).astype(np.float32)
    got = RL.fma_chain_plain(torch.from_numpy(x0), float(a), float(b), R).numpy()
    np.testing.assert_array_equal(got, want)
    # two roundings per step (multiply, then add) part by at most an ulp a step
    two = x0.copy()
    for _ in range(R):
        two = two * a + b
    assert np.max(np.abs(two - got) / np.spacing(got)) <= R


def test_timing_matches_reference():
    samples = np.random.default_rng(1).random(37) * 1e-2
    assert timing.latency_stats(samples) == jax_timing.latency_stats(samples)
    assert timing.latency_stats([]) == jax_timing.latency_stats([]) == {}
    port, ref = timing.PhaseTimer(), jax_timing.PhaseTimer()
    for t in (port, ref):
        for name in ("solve", "step", "solve"):
            with t.phase(name):
                pass
    assert {k: v["count"] for k, v in port.summary().items()} == {"solve": 2, "step": 1}
    assert port.summary().keys() == ref.summary().keys()


def test_measurements_refuse_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the tools measure")
    with pytest.raises(RuntimeError, match="CUDA card"):
        RL.measure_fma_peak()
    from nmpc_tpu_torch.tools import solve_diff as SV

    for main in (RL.main, K8.main, K9.main, K1L.main, K1P.main):
        with pytest.raises(RuntimeError, match="CUDA card"):
            main([])
    with pytest.raises(RuntimeError, match="CUDA card"):
        SV.main(["."])


def test_builders_default_to_the_card():
    """Every builder puts its tensors on the card unless asked otherwise;
    without a card a default call fails with torch's error, never on the
    CPU. The card side is also asserted by tests/test_torch_cuda.py."""
    arrays = {"U": np.zeros((4, 2), np.float32), "lam": np.zeros((4, 3), np.float32),
              "mu": np.float32(10.0)}
    ref = jax_get("two_robot_swap").make(N=4)
    fields = {f.name: np.asarray(getattr(ref, f.name))
              for f in dataclasses.fields(ref) if f.name not in JP.OCP_META}
    meta = {k: getattr(ref, k) for k in JP.OCP_META}
    calls = {
        "Scenario.make": lambda **kw: get("two_robot_swap").make(**kw).x0,
        "make_ocp": lambda **kw: TP.make_ocp(m=1, N=3, T=0.1, x0=[0, 0, 0], x_goal=[1, 0, 0], **kw).xref,
        "default_weights": lambda **kw: TP.default_weights(2, **kw)[0],
        "ocp_from_numpy": lambda **kw: TP.ocp_from_numpy(fields, **kw, **meta).x0,
        "warm_from_numpy": lambda **kw: warm_from_numpy(*arrays.values(), **kw).U,
    }
    for name, call in calls.items():
        assert call(device="cpu").device.type == "cpu", name
        if torch.cuda.is_available():
            assert call().device.type == "cuda", name
        else:
            with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
                call()
