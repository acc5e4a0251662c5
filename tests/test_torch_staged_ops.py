"""The plain versions of the staged path's four kernels (K3 riccati, K4
expansions, K5 line-search merits, K6 accepted rollout) against the JAX
Pallas kernels they replace, run in interpret mode as the reference's own
CPU tests run them. Inputs are made with numpy from a seed and handed to
both packages in their lane-major layouts (the port's [N, rows, B] is the
reference's [tiles=1, N, rows, 128]).

Three problem classes, each with its constraint rows active:
  * two_robot_swap: robots drawn close together, so pair rows bite;
  * obstacle_scenario_3 (six static obstacles): the robot drawn within 0.5
    of an obstacle centre;
  * a two-slot robot_template (the decentralized mode's subproblem) with a
    per-scenario moving-obstacle schedule drawn around the robot.
Duals are positive, with the masked stage-0 state rows at zero, and mu in
{10, 100}.

Tolerances: those of the reference's own kernel tests. K3: kff and Kfb atol
5e-5, dV1 atol 5e-4 (tests/test_ops.py). K4: A, B atol 1e-5, lx, lu 1e-4,
lxx 1e-3, luu 1e-4, lux 1e-6 (tests/test_expansions_pallas.py). K5: rtol
2e-4, atol 2e-3 (tests/test_rollout_pallas.py). K6: atol 1e-5.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nmpc_tpu.ocp import problem as JP
from nmpc_tpu.ops import rollout_pallas as jax_rollout
from nmpc_tpu.ops.expansions_pallas import expansions_fused as jax_expansions
from nmpc_tpu.ops.riccati_pallas import riccati_fused as jax_riccati
from nmpc_tpu.parallel.decentralized import robot_template
from nmpc_tpu.scenarios import get as jax_get
from nmpc_tpu.solver.alilqr import ALILQRConfig
from nmpc_tpu_torch.ocp import problem as TP
from nmpc_tpu_torch.ops import rollout
from nmpc_tpu_torch.ops.expansions import expansions_plain
from nmpc_tpu_torch.ops.riccati import riccati_fused, riccati_plain

B = 128
PROBLEMS = ["pairs", "obstacles", "moving"]


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs six workers on the CPU's cores,
    where more threads a worker only wait on each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def port_ocp(o):
    data = {f.name: np.asarray(getattr(o, f.name))
            for f in dataclasses.fields(o) if f.name not in JP.OCP_META}
    return TP.ocp_from_numpy(data, device="cpu", **{k: getattr(o, k) for k in JP.OCP_META})


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _j(a):
    """Port lane-major [N, ..., B] -> reference [1, N, ..., 128]."""
    return jnp.asarray(a)[None]


def _inputs(kind, seed=0):
    """(reference OCP, lane-major numpy inputs) with active constraint rows."""
    rng = np.random.default_rng(seed)
    if kind == "pairs":
        ocp = jax_get("two_robot_swap").make(N=6)
        centres = np.zeros((B, ocp.m, 2))
        spread = 0.4
    elif kind == "obstacles":
        ocp = jax_get("obstacle_scenario_3").make(N=6)
        obs = np.asarray(ocp.obstacles)[:, :2]
        centres = obs[rng.integers(0, len(obs), (B, ocp.m))]
        spread = 0.5
    else:
        ocp = robot_template(8, 0.1, 0.3, 3)
        centres = np.zeros((B, ocp.m, 2))
        spread = 0.5
    N, n, nu, nc = ocp.N, ocp.nx, ocp.nu, ocp.n_con
    # positions uniform in a disc of radius `spread` around the centres
    r = spread * np.sqrt(rng.uniform(size=(B, N, ocp.m)))
    phi = rng.uniform(-np.pi, np.pi, (B, N, ocp.m))
    pos = centres[:, None] + np.stack([r * np.cos(phi), r * np.sin(phi)], -1)
    th = rng.uniform(-np.pi, np.pi, (B, N, ocp.m, 1))
    X = np.concatenate([pos, th], -1).reshape(B, N, n)
    lam = rng.uniform(0.0, 0.5, (B, N, nc))
    lam[:, 0, JP.x_dependent_rows(ocp)] = 0.0
    inp = {
        "X": X, "x0": X[:, 0],
        "U": 0.1 * rng.standard_normal((B, N, nu)),
        "xref": np.broadcast_to(np.asarray(ocp.xref), (B, N, n)),
        "lam": lam,
        "mu": rng.choice([10.0, 100.0], B),
        "kff": 0.1 * rng.standard_normal((B, N, nu)),
        "Kfb": 0.1 * rng.standard_normal((B, N, nu, n)),
        "alpha": rng.choice([0.0, 0.25, 1.0], B),
    }
    if ocp.n_mov:
        inp["mov"] = (pos[:, :, :1] + rng.uniform(-0.4, 0.4, (B, N, ocp.n_mov, 2))
                      ).reshape(B, N, 2 * ocp.n_mov)
    # lane-major float32: [N, ..., B] (x0, mu, alpha: [..., B])
    lanes = {k: np.ascontiguousarray(np.moveaxis(v, 0, -1)).astype(np.float32)
             for k, v in inp.items()}
    return ocp, lanes


def test_riccati_plain_matches_pallas_kernel():
    """The inputs of tests/test_ops.py:49-60 (general A, B and a random
    lux; n=6, m=4)."""
    rng = np.random.default_rng(0)
    Bt, N, n, m = 128, 6, 6, 4
    A = rng.normal(size=(Bt, N, n, n)) * 0.2 + np.eye(n)
    Bm = rng.normal(size=(Bt, N, n, m)) * 0.3
    lx = rng.normal(size=(Bt, N, n))
    lu = rng.normal(size=(Bt, N, m))
    M = rng.normal(size=(Bt, N, n, n))
    lxx = np.einsum("bnij,bnkj->bnik", M, M) * 0.3 + np.eye(n)
    M = rng.normal(size=(Bt, N, m, m))
    luu = np.einsum("bnij,bnkj->bnik", M, M) * 0.3 + np.eye(m)
    lux = rng.normal(size=(Bt, N, m, n)) * 0.2
    ins = [a.astype(np.float32) for a in (A, Bm, lx, lu, lxx, luu, lux)]
    kr, Kr, dr = jax_riccati(*map(jnp.asarray, ins), interpret=True)
    kp, Kp, dp = riccati_fused(*map(_t, ins))
    np.testing.assert_allclose(kp.numpy(), np.asarray(kr), atol=5e-5)
    np.testing.assert_allclose(Kp.numpy(), np.asarray(Kr), atol=5e-5)
    np.testing.assert_allclose(dp.numpy(), np.asarray(dr), atol=5e-4)


@pytest.mark.parametrize("kind", PROBLEMS)
def test_expansions_plain_matches_pallas_kernel(kind):
    ocp, a = _inputs(kind)
    mov = a.get("mov")
    want = jax_expansions(ocp, _j(a["X"]), _j(a["U"]), _j(a["xref"]), _j(a["lam"]),
                          jnp.asarray(a["mu"])[None, None],
                          None if mov is None else _j(mov), interpret=True)
    got = expansions_plain(port_ocp(ocp), _t(a["X"]), _t(a["U"]), _t(a["xref"]),
                           _t(a["lam"]), _t(a["mu"]), None if mov is None else _t(mov))
    names = ("A", "B", "lx", "lu", "lxx", "luu", "lux")
    atols = (1e-5, 1e-5, 1e-4, 1e-4, 1e-3, 1e-4, 1e-6)
    for name, g, w, atol in zip(names, got, want, atols):
        w = np.asarray(w)[0]
        w = w[..., 0, :] if name in ("lx", "lu") else w
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g.numpy(), w, atol=atol, err_msg=name)
    # the rows under test are active: some Gauss-Newton weight reached lxx
    # off the diagonal (pairs, obstacles) or beyond 2Q on it (moving)
    lxx = np.asarray(want[4])[0]
    q2 = 2.0 * np.asarray(ocp.Qdiag)[None, :, None]
    diag = np.diagonal(lxx, axis1=1, axis2=2).transpose(0, 2, 1)
    assert np.abs(diag - q2).max() > 1.0


def _costs_args(ocp, a):
    return [a["x0"], a["X"], a["U"], a["kff"], a["Kfb"], a["xref"], a["lam"], a["mu"]]


@pytest.mark.parametrize("kind", PROBLEMS)
def test_linesearch_costs_plain_matches_pallas_kernel(kind):
    ocp, a = _inputs(kind, seed=1)
    alphas = (0.0,) + tuple(ALILQRConfig().alphas)
    mov = a.get("mov")
    x0, X, U, kff, Kfb, xref, lam, mu = _costs_args(ocp, a)
    want = jax_rollout.linesearch_costs_lanes(
        ocp, _j(x0[None]), _j(X), _j(U), _j(kff[:, :, None]), _j(Kfb), _j(xref),
        _j(lam), jnp.asarray(mu)[None, None], alphas, None if mov is None else _j(mov),
        interpret=True)
    got = rollout.linesearch_costs_plain(
        port_ocp(ocp), _t(x0), _t(X), _t(U), _t(kff), _t(Kfb), _t(xref), _t(lam), _t(mu),
        alphas, None if mov is None else _t(mov))
    assert got.shape == (len(alphas), B)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-3)
    assert np.isfinite(np.asarray(want)).all()


@pytest.mark.parametrize("kind", PROBLEMS)
def test_rollout_alpha_plain_matches_pallas_kernel(kind):
    ocp, a = _inputs(kind, seed=2)
    x0, X, U, kff, Kfb = a["x0"], a["X"], a["U"], a["kff"], a["Kfb"]
    Xw, Uw = jax_rollout.rollout_alpha_lanes(
        ocp, _j(x0[None]), _j(X), _j(U), _j(kff[:, :, None]), _j(Kfb),
        jnp.asarray(a["alpha"])[None, None], interpret=True)
    Xg, Ug = rollout.rollout_alpha_plain(port_ocp(ocp), _t(x0), _t(X), _t(U), _t(kff),
                                         _t(Kfb), _t(a["alpha"]))
    np.testing.assert_allclose(Xg.numpy(), np.asarray(Xw)[0], atol=1e-5)
    np.testing.assert_allclose(Ug.numpy(), np.asarray(Uw)[0], atol=1e-5)


@pytest.mark.parametrize("kind", PROBLEMS)
def test_riccati_plain_on_expansions_matches_pallas_kernel(kind):
    """K3 on what K4 gives it in the staged path (lane-major, lux = 0)."""
    from nmpc_tpu.ops.riccati_pallas import riccati_lanes as jax_riccati_lanes

    ocp, a = _inputs(kind, seed=3)
    exp = expansions_plain(port_ocp(ocp), _t(a["X"]), _t(a["U"]), _t(a["xref"]),
                           _t(a["lam"]), _t(a["mu"]),
                           None if "mov" not in a else _t(a["mov"]))
    kp, Kp, dp = riccati_plain(exp, 1e-6)
    ins = [e.numpy() for e in exp]
    ins[2], ins[3] = ins[2][:, :, None], ins[3][:, :, None]  # lx, lu: [N, n, 1, B]
    kr, Kr, dr = jax_riccati_lanes(tuple(map(_j, ins)), ocp.N, ocp.nx, ocp.nu, 1e-6,
                                   interpret=True)
    np.testing.assert_allclose(kp.numpy(), np.asarray(kr)[0, :, :, 0], atol=5e-5)
    np.testing.assert_allclose(Kp.numpy(), np.asarray(Kr)[0], atol=5e-5)
    np.testing.assert_allclose(dp.numpy(), np.asarray(dr)[0, 0], atol=5e-4)


def test_standard_layout_wrappers_match_lane_versions():
    """linesearch_costs / rollout_alpha transpose once around the lane
    versions and agree with them exactly."""
    ocp, a = _inputs("pairs", seed=4)
    o = port_ocp(ocp)
    std = {k: _t(np.moveaxis(v, -1, 0)) for k, v in a.items()}
    X = torch.cat([std["x0"][:, None], std["X"][:, 1:],
                   std["X"][:, -1:]], dim=1)  # [B, N+1, n]; the last state unused
    alphas = (0.0, 1.0, 0.5)
    got = rollout.linesearch_costs(o, std["x0"], X, std["U"], std["kff"], std["Kfb"],
                                   std["xref"], std["lam"], std["mu"], alphas)
    want = rollout.linesearch_costs_plain(
        o, _t(a["x0"]), _t(np.moveaxis(X[:, :-1].numpy(), 0, -1)), _t(a["U"]), _t(a["kff"]),
        _t(a["Kfb"]), _t(a["xref"]), _t(a["lam"]), _t(a["mu"]), alphas)
    assert torch.equal(got, want)
    Xn, Un = rollout.rollout_alpha(o, std["x0"], X, std["U"], std["kff"], std["Kfb"],
                                   std["alpha"])
    assert Xn.shape == X.shape and torch.equal(Xn[:, 0], std["x0"])
    Xl, Ul = rollout.rollout_alpha_plain(
        o, _t(a["x0"]), _t(np.moveaxis(X[:, :-1].numpy(), 0, -1)), _t(a["U"]), _t(a["kff"]),
        _t(a["Kfb"]), _t(a["alpha"]))
    assert torch.equal(Xn[:, 1:], Xl.movedim(-1, 0)) and torch.equal(Un, Ul.movedim(-1, 0))
