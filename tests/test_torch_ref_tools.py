"""The reference's measurement tools and examples on the port
(nmpc_tpu_torch/tools: gate_check, ten_robot, sweep, decentralized, ls_ab,
iteration_levers, profile_solve, roofline_gn, rt_drift_experiment, parity;
nmpc_tpu_torch/examples), on the CPU at a tiny size with --device cpu: each
runs its path through the port's engines (the kernels' plain versions) and
prints its fields, checked here; each tool that measures the card refuses
to run without one.

The megakernel route's admission: every shape of the reference's
admission test (tests/test_batched_solver.py:117-130) takes the
megakernel route (a static check, here). On the card (`gpu`, skipped
without one; the port of the TPU-marked
tests/test_batched_solver.py:133): five_robot, ten_robot and
six_robot_antipodal at B=1 with n_outer=2, n_inner=4 through K1 and K2,
K1's block within the H100's shared memory, the cost finite:

    python -m pytest tests/test_torch_ref_tools.py -m gpu --noconftest -q

No JAX here: the card's host has none.
"""

import json
import math

import pytest
import torch

from nmpc_tpu_torch.examples import decentralized_cross, fleet_batch, six_robot_swap
from nmpc_tpu_torch.ops.megasolve import cuda_unsupported
from nmpc_tpu_torch.scenarios import get
from nmpc_tpu_torch.solver.alilqr import ALILQRConfig
from nmpc_tpu_torch.solver.alilqr_batched import route
from nmpc_tpu_torch.tools import (decentralized, gate_check, iteration_levers, ls_ab, parity,
                                  profile_solve, roofline_gn, rt_drift_experiment, sweep,
                                  ten_robot)

CPU = ["--device", "cpu", "--json"]


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _json(capsys) -> dict:
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("name", gate_check.SHAPES)
def test_every_admission_shape_takes_the_megakernel_route(name):
    ocp = get(name).make(device="cpu")
    assert cuda_unsupported(ocp, gate_check.CFG) is None
    assert route(ocp, gate_check.CFG) == "mega"


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["five_robot", "ten_robot", "six_robot_antipodal"])
def test_mega_gate_admission_runs_on_the_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    r = gate_check.check(name, torch.device("cuda", 0))
    assert r["route"] == "mega" and r["K1"] > 0 and r["K2"] > 0
    assert 0 < r["k1_smem_bytes"] <= r["smem_limit"]
    assert r["k1_design"] == ("team" if get(name).m <= 2 else "warp")


def test_gate_check_on_the_cpu(one_thread, capsys):
    assert gate_check.main(["eight_robot", *CPU]) == 0
    r = _json(capsys)
    assert r["route"] == "mega" and r["k1_smem_bytes"] is None and r["N"] == 5
    assert math.isfinite(r["cost"]) and r["cost"] > 0 and r["K1"] == r["K2"] == 0


def test_ten_robot_on_the_cpu(one_thread, capsys):
    assert ten_robot.main(["4", "3", "--iters", "2", *CPU]) == 0
    r = _json(capsys)
    assert (r["B"], r["N"], r["m"], len(r["times_s"])) == (4, 3, 10, 2)
    assert 0 <= r["conv"] <= 1 and r["viol_max"] >= r["viol_p99"] >= 0 and r["mean_inner"] > 0
    assert r["solves_per_s"] == pytest.approx(4 / min(r["times_s"]))
    assert r["device"].startswith("cpu")


def test_sweep_on_the_cpu(one_thread, capsys):
    assert sweep.main(["6", "1", "--B", "3", "--K", "2", *CPU]) == 0
    r = _json(capsys)
    assert [(x["sweep"], x["route"]) for x in r["rows"]] == [("seq", "mega"), ("scan", "hybrid")]
    assert all(x["b1_ms"] > 0 and x["B"] == 3 and 0 <= x["conv"] <= 1 for x in r["rows"])


def test_decentralized_on_the_cpu(one_thread, capsys):
    assert decentralized.main(["3", "6", "1", "--rounds", "2", *CPU]) == 0
    r = _json(capsys)
    assert [x["engine"] for x in r["rows"]] == ["fused", "xla"]
    assert all(x["rounds"] == 2 and x["ms_round"] > 0 for x in r["rows"])


def test_ls_ab_on_the_cpu(one_thread, capsys):
    assert ls_ab.main(["4", "--variants", "cascade,adaptive-r1", "--iters", "1", *CPU]) == 0
    r = _json(capsys)
    assert [x["variant"] for x in r["rows"]] == ["cascade", "adaptive-r1"]
    for x in r["rows"]:
        assert {"conv", "mean_cost", "viol_p50", "viol_p99", "viol_max", "mean_inner",
                "solves_per_s"} <= set(x)


def test_iteration_levers_on_the_cpu(one_thread, capsys):
    assert iteration_levers.main(["4", "--iters", "1", *CPU]) == 0
    r = _json(capsys)
    assert [x["variant"] for x in r["rows"]] == ["base_r4", "mu100", "polar"]
    assert all(x["mean_inner"] > 0 for x in r["rows"])


def test_profile_solve_on_the_cpu(one_thread, capsys, tmp_path, monkeypatch):
    # one outer step of two inner iterations: the CPU profiler's trace of a
    # whole solve's plain ops takes minutes to write
    monkeypatch.setattr(profile_solve, "CFG", ALILQRConfig(n_outer=1, n_inner=2, tol_con=1e-3))
    assert profile_solve.main(["-B", "4", "--trace", str(tmp_path), *CPU]) == 0
    r = _json(capsys)
    st, mg = r["staged"], r["mega"]
    n = st["K3 launches"]
    assert n > 0 and st["K4 launches"] == st["K5 launches"] == n and st["K6 launches"] == n + 1
    assert mg["K1 launches"] == mg["K2 launches"] > 0
    assert st["total_ms"] >= st["K3"] > 0 and "alone_ms" not in r
    assert (tmp_path / "staged_solve.json").exists() and r["trace"]["top"]


def test_roofline_gn_on_the_cpu(one_thread, capsys):
    assert roofline_gn.main(["2", "--N", "6", *CPU]) == 0
    r = _json(capsys)
    assert (r["N"], r["Nc"], r["nx"], r["nz"]) == (6, 6, 13, 12)
    assert r["flops"]["iter"] == sum(v for k, v in r["flops"].items() if k != "iter")
    assert r["solves_per_s"] > 0 and len(r["gemm"]) == 3


def test_roofline_gn_flop_model_at_the_published_config():
    """The reference's model at lidar_v4 (N=100, Nc=50, nx=13, nu=2, 7
    alphas): its H-build dominates."""
    o = get("lidar_v4").make(device="cpu")
    rows = o.nx + o.nu + o.num_rays + o.n_con
    fl = roofline_gn.flop_model(o.N, o.nx, o.nu, 50, rows, 7)
    assert fl["H"] == 2 * rows * 100 * 100 * 100 and fl["chol"] == 100 ** 3 // 3 + 2 * 100 ** 2
    assert fl["H"] > fl["iter"] / 2


def test_rt_drift_experiment_on_the_cpu(one_thread, capsys):
    assert rt_drift_experiment.main(["--steps", "2", "--scenarios", "two_robot_swap", "--N", "5",
                                     "--json"]) == 0
    r = _json(capsys)
    assert [x["label"] for x in r["runs"]] == ["mu-carry", "mu-carry+decay0.9", "mu-rt-1e3"]
    assert all(len(x["steps"]) == 2 and x["worst_viol"] >= 0 for x in r["runs"])


def test_parity_on_the_cpu(one_thread, capsys):
    assert parity.main(["--rows", "single_robot,two_robot_swap,obstacle_scenario_1", "--N", "6",
                        "--workers", "2", *CPU]) == 0
    r = _json(capsys)
    rows = {x["name"]: x for x in r["rows"]}
    assert list(rows) == ["single_robot", "two_robot_swap", "obstacle_scenario_1"]
    for x in rows.values():
        assert x["N"] == 6 and x["raw_gap"] < 1e-2 and x["pol_gap"] < 1e-2
        assert x["one"] is not None and x["one"]["raw_gap"] < 1e-2
    assert rows["obstacle_scenario_1"]["cost_tc"] == rows["obstacle_scenario_1"]["cost_oracle"]


def test_parity_family_i_problems():
    cpu = torch.device("cpu")
    for name in parity.LIDAR_CASES:
        ocp, scan = parity.problem(name, None, cpu)
        assert ocp.p_obs.shape == (10, 2) and ocp.x0.shape == (13,)
        assert float(scan[1]) == pytest.approx(0.9) and float(scan[0]) == pytest.approx(3.5)
        assert parity.card_column(name, None, cpu) is None      # the hybrid route


def test_six_robot_swap_on_the_cpu(one_thread, capsys, tmp_path):
    assert six_robot_swap.main(["--max-steps", "3", "--N", "5", "--save",
                                str(tmp_path / "swap"), *CPU]) == 0
    r = _json(capsys)
    assert r["steps"] == 3 and r["min_dist"] > 0.3
    assert (tmp_path / "swap.npz").exists()


def test_decentralized_cross_on_the_cpu(one_thread, capsys):
    assert decentralized_cross.main(["--max-steps", "3", "--N", "6", *CPU]) == 0
    r = _json(capsys)
    assert r["steps"] == 3 and r["min_dist"] > 0.3 and not r["reached"]


def test_fleet_batch_on_one_device(one_thread, capsys):
    assert fleet_batch.main(["-B", "4", "--N", "5", *CPU]) == 0
    r = _json(capsys)
    assert r["devices"] == 1 and r["B"] == 4 and 0 <= r["converged"] <= 1


@pytest.mark.parametrize("tool, argv", [
    (gate_check, ["six_robot_antipodal"]), (ten_robot, []), (sweep, []), (decentralized, []),
    (ls_ab, []), (iteration_levers, []), (profile_solve, []), (roofline_gn, []),
    (parity, ["--rows", "single_robot"]), (rt_drift_experiment, ["--device", "cuda"]),
    (six_robot_swap, []), (decentralized_cross, []), (fleet_batch, [])])
def test_card_tools_refuse_without_a_card(monkeypatch, tool, argv):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a CUDA card"):
        tool.main(argv)
