"""`python -m nmpc_tpu_torch` (nmpc_tpu_torch/__main__.py) against the JAX
package's CLI (nmpc_tpu/__main__.py):

* `list` prints exactly the reference's lines;
* each branch of `run` calls the same driver with the same configuration:
  both CLIs run with their drivers replaced by stubs that record their
  arguments (the reference's jax.jit made the identity), and the records
  are compared field by field, engines included (each CLI's solve_fn is
  called once with its engines replaced by recorders);
* a bad mode exits 2;
* one real short run on the CPU with --save, read back by `load_run`.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nmpc_tpu.__main__ as JM
import nmpc_tpu_torch.__main__ as TM
from nmpc_tpu_torch.utils import load_run


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Eager loops of small ops: one intra-op thread (more only spin)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_list_prints_the_reference_lines(capsys):
    assert JM.main(["list"]) == 0
    want = capsys.readouterr().out
    assert TM.main(["list"]) == 0
    assert capsys.readouterr().out == want and len(want.splitlines()) == 35


def _plain(v):
    """A comparable form of a recorded argument: configs and OCPs as dicts,
    arrays as float32 numpy."""
    if dataclasses.is_dataclass(v) and not isinstance(v, type):
        return {f.name: _plain(getattr(v, f.name)) for f in dataclasses.fields(v)}
    if isinstance(v, torch.Tensor):
        return np.asarray(v.cpu().numpy(), np.float32)
    if isinstance(v, (jax.Array, np.ndarray)):
        return np.asarray(v, np.float32)
    if isinstance(v, (list, tuple)):
        return [_plain(a) for a in v]
    return v


def _same(a, b, path="") -> None:
    if isinstance(a, dict):
        assert set(a) == set(b), (path, set(a) ^ set(b))
        for k in a:
            _same(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, np.ndarray):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6, err_msg=path)
    elif isinstance(a, list):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{path}[{i}]")
    else:
        assert a == b, (path, a, b)


class _Recorder:
    """Stubs for one CLI's drivers and engines; `calls` holds (driver name,
    its arguments) and, once its solve_fn ran, (engine name, config)."""

    def __init__(self, xp):
        self.calls, self.xp = [], xp

    def result(self, kind):
        xp, S = self.xp, 3
        if kind == "loop":
            return types.SimpleNamespace(
                X_hist=xp.zeros((S + 1, 3)), U_hist=xp.zeros((S, 2)), err_hist=xp.ones(S),
                cost_hist=xp.ones(S), viol_hist=xp.zeros(S), iter_hist=xp.ones(S),
                min_dist_hist=xp.ones(S + 1), steps_used=S, reached=True)
        if kind == "modes":
            return xp.zeros((S + 1, 6)), xp.zeros((S, 4)), xp.ones(S + 1), True
        return xp.zeros((S + 1, 3)), xp.zeros((S, 2)), xp.ones(S), xp.ones(S), True

    def driver(self, name, kind):
        def stub(*args, **kw):
            # the port's loops also take the device the CLI runs on
            self.calls.append((name, {"args": _plain(list(args)), **{
                k: _plain(v) for k, v in kw.items() if k not in ("solve_fn", "device")}}))
            if kw.get("solve_fn") is not None:
                kw["solve_fn"](None, None)
            return self.result(kind)
        return stub

    def engine(self, name):
        def stub(o, w, cfg=None):
            self.calls.append((name, _plain(cfg)))
        return stub


@pytest.fixture
def recorders(monkeypatch):
    """Both CLIs with recording stubs in place of their drivers/engines."""
    import nmpc_tpu.mpc.driver as JD
    import nmpc_tpu.mpc.lidar as JL
    import nmpc_tpu.parallel.consensus as JC
    import nmpc_tpu.parallel.decentralized as JDc
    import nmpc_tpu.solver.alilqr as JS
    import nmpc_tpu.solver.alilqr_batched as JB
    import nmpc_tpu.solver.gn as JG
    import nmpc_tpu_torch.mpc.driver as TD
    import nmpc_tpu_torch.mpc.lidar as TL
    import nmpc_tpu_torch.parallel.consensus as TC
    import nmpc_tpu_torch.parallel.decentralized as TDc
    import nmpc_tpu_torch.solver.alilqr as TS
    import nmpc_tpu_torch.solver.alilqr_batched as TB
    import nmpc_tpu_torch.solver.gn as TG

    monkeypatch.setattr(jax, "jit", lambda f, **kw: f)
    out = {}
    jax_xp = types.SimpleNamespace(zeros=jnp.zeros, ones=jnp.ones)
    for tag, mods, xp in (("ref", (JD, JL, JC, JDc, JS, JB, JG), jax_xp),
                          ("port", (TD, TL, TC, TDc, TS, TB, TG), torch)):
        D, L, C, Dc, S, B, G = mods
        rec = _Recorder(xp)
        for mod, name, kind in ((D, "closed_loop", "loop"), (D, "closed_loop_waypoints", "loop"),
                                (D, "rt_closed_loop", "loop"), (L, "closed_loop_lidar", "lidar"),
                                (C, "consensus_closed_loop", "modes"),
                                (Dc, "decentralized_closed_loop", "modes")):
            monkeypatch.setattr(mod, name, rec.driver(name, kind))
        for mod, name in ((S, "solve"), (B, "solve_one"), (G, "solve")):
            monkeypatch.setattr(mod, name, rec.engine(f"{mod.__name__.split('.')[-1]}.{name}"))
        out[tag] = rec
    return out


RUNS = [
    ["six_robot_antipodal"],                        # auto -> the per-scenario engine
    ["six_robot_antipodal", "--engine", "fused"],
    ["six_robot_antipodal", "--engine", "gn"],
    ["six_robot_antipodal", "--rt", "--steps", "7"],
    ["slsqp_pose_nc"],                              # auto -> gn (the scenario has Nc)
    ["obstacle_scenario_1"],                        # auto -> fused (N=100), waypoints
    ["slsqp_multigoal", "--engine", "ilqr"],
    ["six_robot_antipodal", "--mode", "decentralized", "--steps", "9"],
    ["ten_robot", "--mode", "consensus"],
    ["lidar_v2"], ["lidar_v3"], ["lidar_v4"],
]


@pytest.mark.parametrize("argv", RUNS, ids=lambda a: "-".join(a))
def test_run_builds_the_reference_configuration(recorders, argv, capsys):
    assert JM.main(["run", *argv]) == 0
    ref_out = capsys.readouterr().out
    assert TM.main(["run", *argv, "--device", "cpu"]) == 0
    port_out = capsys.readouterr().out
    ref, port = recorders["ref"].calls, recorders["port"].calls
    assert port and [c[0] for c in port] == [c[0] for c in ref], (port, ref)
    assert (len(port) == 2) == ("fused" in argv or "gn" in argv or argv[0] in (
        "slsqp_pose_nc", "obstacle_scenario_1", "lidar_v2", "lidar_v3"))   # engine recorded
    for (name, a), (_, b) in zip(port, ref):
        _same(a, b, name)
    assert port_out.splitlines()[0] == ref_out.splitlines()[0]


def test_ray_bound_is_the_one_the_solve_enforces(recorders, capsys):
    """The port prints the ray states' lower bound of the solved problem
    (0.3 for lidar_v2, 0.25 for lidar_v3), not the robot radius."""
    for name, bound in (("lidar_v2", "0.3"), ("lidar_v3", "0.25")):
        assert TM.main(["run", name, "--device", "cpu"]) == 0
        assert f"ray bound {bound})" in capsys.readouterr().out


def test_bad_mode_exits_2(capsys):
    assert TM.main(["run", "single_robot", "--mode", "consensus", "--device", "cpu"]) == 2
    assert "needs a multi-robot point-goal" in capsys.readouterr().err
    assert TM.main(["run", "first_scenario", "--mode", "decentralized", "--device", "cpu"]) == 2


def test_real_run_on_the_cpu_saves_a_run_log(tmp_path, capsys):
    path = tmp_path / "run.npz"
    rc = TM.main(["run", "slsqp_pose", "--steps", "40", "--device", "cpu", "--save", str(path)])
    out = capsys.readouterr().out
    log = load_run(path)
    assert rc == (0 if log.reached else 1) and log.reached
    assert log.meta == {"scenario": "slsqp_pose"} and f"saved         {path}" in out
    assert log.X_hist.shape == (41, 3) and np.isfinite(log.X_hist).all()
    assert log.summary()["final_err"] <= 0.075 + 0.05
