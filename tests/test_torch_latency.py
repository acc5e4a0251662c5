"""The graph-safe megakernel route and the latency tool
(nmpc_tpu_torch/solver/alilqr_batched.py `solve_batched_graph`,
`solve_one_graph`; nmpc_tpu_torch/tools/latency.py), on the CPU.

- The graph-safe form runs all n_outer AL steps with no host sync and
  equals `solve_batched` (at B=3, where the scenarios finish at different
  outer steps, all before n_outer) and `solve_one` (B=1) bit for bit, on
  the plain kernels.
- The latency chunk (K MPC steps: solve_one_graph, first control, plant,
  shift) equals solve_one's steps bit for bit, and holds against the
  reference's `make_chunk` (tools/gen_latency.py, JAX on the CPU, its
  Pallas megakernel in interpret mode) at K=3 on tb3_1 (N=20, the start
  moved by 0.2 N(0, 1), numpy seed 1), with and without delay
  compensation: the final state at atol 2e-5, the iterations, violation
  and clearance as the reference's. Under a 1e-7 move of x0 the
  reference's own chunk moves its final state by 2.2e-6 there
  (`JAX_PLATFORMS=cpu python tests/reference_spread.py latency`), which
  sets the tolerance at about ten times the spread. single_robot and
  six_robot_antipodal bifurcate, and two_robot_swap's (N=10) and
  eight_robot's (N=5) chunks move by 2.6e-4 and 7.9e-5 under the same
  move: not held there.
- The tool at a tiny size with --device cpu (its JSON fields), and its
  refusal without a card.

The JAX package is imported inside the test that uses it.
"""

import dataclasses
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from nmpc_tpu_torch.mpc.driver import shift_warm
from nmpc_tpu_torch.parallel import batch_ocp
from nmpc_tpu_torch.scenarios import get
from nmpc_tpu_torch.solver import alilqr_batched as AB
from nmpc_tpu_torch.solver.alilqr import ALILQRConfig, solve, warm_from_numpy
from nmpc_tpu_torch.tools import latency as L

ROOT = Path(__file__).resolve().parent.parent
# six_robot_antipodal N=6 from starts moved by 0.1 N(0, 1) (numpy seed 0):
# the three scenarios finish at outer steps 4, 3 and 3 of 8
GRAPH_CFG = ALILQRConfig(n_outer=8, n_inner=6, tol_con=1e-3)


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def k1_calls(monkeypatch):
    """K1 calls on the route (its wrapper as alilqr_batched calls it)."""
    calls = [0]
    orig = AB.inner_solve_fused

    def counted(*a, **k):
        calls[0] += 1
        return orig(*a, **k)

    monkeypatch.setattr(AB, "inner_solve_fused", counted)
    return calls


def _fields_equal(a, b) -> None:
    for f in dataclasses.fields(a):
        assert torch.equal(getattr(a, f.name), getattr(b, f.name)), f.name


def _batch(B: int):
    base = get("six_robot_antipodal").make(N=6, device="cpu")
    rng = np.random.default_rng(0)
    x0 = base.x0[None] + torch.as_tensor(0.1 * rng.standard_normal((B, base.nx)),
                                         dtype=torch.float32)
    return batch_ocp(base, x0)


@pytest.mark.parametrize("ls", ["cascade", "adaptive"])
def test_graph_form_equals_solve_batched_at_b3(one_thread, k1_calls, ls):
    ob, cfg = _batch(3), dataclasses.replace(GRAPH_CFG, ls=ls)
    want = AB.solve_batched(ob, cfg=cfg)
    early = k1_calls[0]
    k1_calls[0] = 0
    got = AB.solve_batched_graph(ob, cfg=cfg)
    _fields_equal(got, want)
    # every step launched K1; the early-exit loop stopped before n_outer,
    # and some scenario was done before the last step it ran
    assert k1_calls[0] == cfg.n_outer and early < cfg.n_outer
    assert int(want.outer_iters.min()) < int(want.outer_iters.max()) == early
    assert bool(want.converged.all())


def test_graph_form_equals_solve_one_at_b1(one_thread, k1_calls):
    ob = _batch(1)
    ocp = dataclasses.replace(ob, x0=ob.x0[0], xref=ob.xref[0])
    want = AB.solve_one(ocp, cfg=GRAPH_CFG)
    early = k1_calls[0]
    k1_calls[0] = 0
    got = AB.solve_one_graph(ocp, cfg=GRAPH_CFG)
    _fields_equal(got, want)
    assert k1_calls[0] == GRAPH_CFG.n_outer > early
    # from a warm start (the chunk's case)
    warm = shift_warm(want, GRAPH_CFG)
    _fields_equal(AB.solve_one_graph(ocp, warm, GRAPH_CFG), AB.solve_one(ocp, warm, GRAPH_CFG))


def test_graph_form_refuses_what_it_cannot_capture():
    ob = _batch(2)
    with pytest.raises(ValueError, match="compact"):
        AB.solve_batched_graph(ob, cfg=dataclasses.replace(GRAPH_CFG, compact=True))
    with pytest.raises(NotImplementedError, match="staged route"):
        AB.solve_batched_graph(ob, cfg=dataclasses.replace(GRAPH_CFG, mega=False))
    with pytest.raises(NotImplementedError, match="hybrid route"):
        AB.solve_batched_graph(ob, cfg=dataclasses.replace(GRAPH_CFG, sweep="scan"))
    assert AB.route(ob, GRAPH_CFG) == "mega"


@pytest.mark.parametrize("delay", [False, True])
def test_chunk_equals_solve_one_steps(one_thread, delay):
    ocp = get("six_robot_antipodal").make(N=5, device="cpu")
    o2 = L.tightened(ocp)
    assert float(o2.dmin2) > float(ocp.dmin2)
    warm = shift_warm(solve(o2, cfg=L.CFG), L.CFG_RT)
    chunk = L.Chunk(o2, ocp, L.CFG_RT, 3, delay_compensate=delay)
    tr = chunk.run(ocp.x0, warm, against=AB.solve_one)   # raises at a differing bit
    again = L.Chunk(o2, ocp, L.CFG_RT, 3, delay_compensate=delay, solve_fn=AB.solve_one)
    for a, b in zip(tr.fields(), again.run(ocp.x0, warm).fields()):
        assert torch.equal(a, b)
    assert tr.X.shape == (4, ocp.nx) and tr.U0.shape == (3, ocp.nu) and tr.iters.shape == (3,)
    assert tr.outer.shape == (3,) and bool(((tr.outer >= 1) & (tr.outer <= L.CFG_RT.n_outer)).all())


@pytest.mark.parametrize("delay", [False, True])
def test_chunk_matches_reference_make_chunk(one_thread, delay):
    import jax
    import jax.numpy as jnp

    from nmpc_tpu.mpc.driver import shift_warm as jax_shift_warm
    from nmpc_tpu.scenarios import get as jax_get
    from nmpc_tpu.solver.alilqr import solve as jax_solve

    spec = importlib.util.spec_from_file_location("reference_gen_latency",
                                                  ROOT / "tools" / "gen_latency.py")
    GL = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(GL)
    GL.K = 3
    jocp = jax_get("tb3_1").make(N=20)
    x0 = np.asarray(jocp.x0) + 0.2 * np.random.default_rng(1).standard_normal(jocp.nx).astype(
        np.float32)
    jw = jax_shift_warm(jax.jit(lambda o: jax_solve(o, cfg=GL.CFG))(jocp), GL.CFG_RT)
    xF, viol, iters, dmin = GL.make_chunk(jocp, jocp, GL.CFG_RT, delay)(jnp.asarray(x0), jw)

    ocp = get("tb3_1").make(N=20, device="cpu")
    warm = warm_from_numpy(np.asarray(jw.U), np.asarray(jw.lam), np.asarray(jw.mu), device="cpu")
    s = L.summary(L.Chunk(ocp, ocp, L.CFG_RT, 3, delay_compensate=delay).run(
        torch.as_tensor(x0), warm))
    np.testing.assert_allclose(s["xF"].numpy(), np.asarray(xF), rtol=0, atol=2e-5)
    assert int(s["iters"]) == int(iters) > 0
    assert abs(float(s["viol"]) - float(viol)) <= 1e-6
    assert np.isinf(float(s["min_dist"])) and np.isinf(float(dmin))


def test_latency_tool_on_the_cpu(one_thread, capsys):
    assert L.main(["--device", "cpu", "--cases", "six_robot_antipodal,single_robot", "--N", "5",
                   "--steps", "2", "--chunks", "2", "--calls", "2", "--no-lidar", "--json"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    out = json.loads(lines[-1])
    assert out["mode"] == "eager" and out["device"].startswith("cpu") and out["K"] == 2
    assert [r["name"] for r in out["ondevice"]] == ["six_robot_antipodal", "single_robot"]
    for r in out["ondevice"]:
        for key in ("full", "rt", "rt_ad"):
            st = r[key]
            assert st["n"] == 2 and st["p50_ms"] > 0 and st["iters"] >= 0
            assert {"p99_ms", "viol", "min_dist", "mode"} <= set(st)
            assert 0.0 <= st["noop_share"] < 1.0
            assert st["eager_one_p50_ms"] > 0 and st["eager_graph_p50_ms"] > 0
    assert out["delay"]["n"] == 2 and out["delay"]["min_dist"] > 0.3
    assert out["ondevice"][0]["dmin"] == pytest.approx(0.3)
    assert [r["fused_rt"] is not None for r in out["percall"]] == [True, True]
    assert all(r["rt"]["n"] == 2 for r in out["percall"])
    assert out["lidar"] is None
    text = "\n".join(lines[:-1])
    assert "rt p99<=budget" in text and "rt + delay=1 compensated" in text
    assert "no-op K1 share full / rt / rt-ad" in text and out["eager"] == 2


def test_latency_lidar_row_on_the_cpu(one_thread):
    st = L.measure_lidar(torch.device("cpu"), steps=2, chunks=1, N=10)
    assert st["n"] == 1 and st["min_clearance"] > 0 and st["p50_ms"] > 0


def test_latency_refuses_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a CUDA card"):
        L.main(["--cases", "single_robot"])
