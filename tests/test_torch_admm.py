"""The port's ADMM QP engine (nmpc_tpu_torch/solver/admm.py) against the JAX
package's on the same numpy-seeded inputs: tests/test_admm.py's five cases,
each holding x and y (atol 1e-4: two f32 implementations of 400-2000
iterations of the same splitting), iterations and the converged flag per
element, and the batched entry against per-element solves of the port
itself (atol 1e-6, iterations and flags equal), as the reference holds its
own."""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nmpc_tpu.solver import admm as JA
from nmpc_tpu_torch.solver import admm as TA

XY_ATOL = 1e-4


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))


def _j(a):
    return jnp.asarray(np.asarray(a, dtype=np.float32))


def _hold(got, want, iters_slack=0):
    x, y, it, done, prim = got
    xj, yj, itj, donej, primj = want
    np.testing.assert_allclose(x.numpy(), np.asarray(xj), atol=XY_ATOL)
    np.testing.assert_allclose(y.numpy(), np.asarray(yj), atol=XY_ATOL * 10)
    assert np.all(np.abs(it.numpy() - np.asarray(itj)) <= iters_slack), (it, itj)
    np.testing.assert_array_equal(done.numpy(), np.asarray(donej))
    np.testing.assert_allclose(prim.numpy(), np.asarray(primj), atol=1e-4)


def test_box_qp_matches_reference():
    rng = np.random.default_rng(0)
    n, mrows = 12, 8
    M = rng.normal(size=(n, n))
    P, q = M @ M.T + np.eye(n), rng.normal(size=n)
    A = rng.normal(size=(mrows, n))
    l, u = -0.5 * np.ones(mrows), 0.5 * np.ones(mrows)
    got = TA.qp_solve(TA.qp_setup(_t(P), _t(A)), _t(q), _t(l), _t(u))
    want = jax.jit(JA.qp_solve)(JA.qp_setup(_j(P), _j(A)), _j(q), _j(l), _j(u))
    assert bool(got[3])
    _hold(got, want, iters_slack=2)
    # the upper factor, as the reference's cho_factor(lower=False)
    fac = TA.qp_setup(_t(P), _t(A))
    K = fac.P + 1e-6 * torch.eye(n) + fac.A.T @ fac.A
    torch.testing.assert_close(fac.chol.T @ fac.chol, K, rtol=1e-5, atol=1e-4)
    assert torch.equal(fac.chol, torch.triu(fac.chol))


def test_qp_batched_matches_reference_vmap():
    rng = np.random.default_rng(1)
    n, mrows, B = 6, 4, 16
    M = rng.normal(size=(n, n))
    P, A = M @ M.T + np.eye(n), rng.normal(size=(mrows, n))
    qs = rng.normal(size=(B, n))
    ls, us = np.full((B, mrows), -1.0), np.full((B, mrows), 1.0)
    got = TA.qp_solve_batched(TA.qp_setup(_t(P), _t(A)), _t(qs), _t(ls), _t(us))
    want = jax.jit(jax.vmap(JA.qp_solve, in_axes=(None, 0, 0, 0)))(
        JA.qp_setup(_j(P), _j(A)), _j(qs), _j(ls), _j(us))
    assert got[0].shape == (B, n) and bool(got[3].all())
    _hold(got, want, iters_slack=2)


def test_ltv_mpc_qp_structure_matches_reference():
    Ts, N = 0.1, 20
    Ad = np.array([[1.0, Ts], [0.0, 1.0]])
    Bd = np.array([[0.5 * Ts * Ts], [Ts]])
    Qd, Rd = np.diag([10.0, 1.0]), np.array([[0.1]])
    box = (np.array([-5.0, -2.0]), np.array([5.0, 2.0]), np.array([-1.0]), np.array([1.0]))
    tP, tA, tl, tu, tpack = TA.build_ltv_mpc_qp(*map(_t, (Ad, Bd, Qd, Rd, Qd)), N,
                                                *map(_t, box), device="cpu")
    jP, jA, jl, ju, jpack = JA.build_ltv_mpc_qp(*map(_j, (Ad, Bd, Qd, Rd, Qd)), N,
                                                *map(_j, box))
    for a, b in ((tP, jP), (tA, jA), (tl, jl), (tu, ju)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    cfg = TA.ADMMConfig(max_iter=2000)
    x_init = np.array([2.0, 0.0])
    got = TA.qp_solve(TA.qp_setup(tP, tA, l=tl, u=tu), torch.zeros(tP.shape[0]),
                      *tpack(_t(x_init)), cfg)
    want = jax.jit(lambda f, q, l, u: JA.qp_solve(f, q, l, u, JA.ADMMConfig(max_iter=2000)))(
        JA.qp_setup(jP, jA, l=jl, u=ju), jnp.zeros(jP.shape[0]), *jpack(_j(x_init)))
    assert bool(got[3])
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=2e-3)
    assert abs(int(got[2]) - int(want[2])) <= 0.05 * int(want[2]) + 2
    X = got[0][: (N + 1) * 2].reshape(N + 1, 2).numpy()
    U = got[0][(N + 1) * 2:].reshape(N, 1).numpy()
    np.testing.assert_allclose(X[0], [2.0, 0.0], atol=1e-2)
    assert abs(X[-1][0]) < 0.75 * 2.0 and np.abs(U).max() <= 1.0 + 1e-3
    np.testing.assert_allclose(X[1:], (Ad @ X[:-1].T + Bd @ U.T).T, atol=5e-3)


def test_ltv_mpc_qp_defaults_to_the_card():
    """build_ltv_mpc_qp called as the reference's is, with numpy data and no
    device, builds on the port's default device: the card where there is
    one, and on a host without CUDA torch's own error, never the CPU."""
    from nmpc_tpu_torch.device import DEVICE

    assert inspect.signature(TA.build_ltv_mpc_qp).parameters["device"].default == DEVICE
    args = (np.array([[0.9]]), np.array([[0.2]]), np.eye(1), np.eye(1), np.eye(1), 4,
            np.array([-1.0]), np.array([1.0]), np.array([-1.0]), np.array([1.0]))
    if torch.cuda.is_available():
        P, A, l, u, pack = TA.build_ltv_mpc_qp(*args)
        assert all(t.device.type == DEVICE.type for t in (P, A, l, u, *pack([0.5])))
    else:
        with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
            TA.build_ltv_mpc_qp(*args)


def test_siso_process_mpc_closed_loop_matches_reference():
    """The first-order process in closed loop through the port's ADMM (40
    periods) against the reference's loop on the same plant."""
    K_g, tau, Ts, N = 2.0, 1.5, 0.2, 25
    a = float(np.exp(-Ts / tau))
    mats = (np.array([[a]]), np.array([[K_g * (1.0 - a)]]), np.array([[5.0]]),
            np.array([[0.1]]), np.array([[5.0]]))
    box = (np.array([-10.0]), np.array([10.0]), np.array([-1.5]), np.array([1.5]))
    q = np.concatenate([np.full((N + 1,), -5.0), np.zeros(N)])
    tP, tA, tl, tu, tpack = TA.build_ltv_mpc_qp(*map(_t, mats), N, *map(_t, box), device="cpu")
    jP, jA, jl, ju, jpack = JA.build_ltv_mpc_qp(*map(_j, mats), N, *map(_j, box))
    tfac, jfac = TA.qp_setup(tP, tA, l=tl, u=tu), JA.qp_setup(jP, jA, l=jl, u=ju)
    cfg = TA.ADMMConfig(max_iter=1500)
    jstep = jax.jit(lambda f, q, l, u: JA.qp_solve(f, q, l, u, JA.ADMMConfig(max_iter=1500)))
    xt = xj = 0.0
    ut, uj = [], []
    for _ in range(40):
        zt = TA.qp_solve(tfac, _t(q), *tpack(_t([xt])), cfg)[0]
        zj = jstep(jfac, _j(q), *jpack(_j([xj])))[0]
        ut.append(float(zt[N + 1]))
        uj.append(float(zj[N + 1]))
        xt = a * xt + K_g * (1.0 - a) * ut[-1]
        xj = a * xj + K_g * (1.0 - a) * uj[-1]
    assert abs(xt - 1.0) < 5e-2 and abs(ut[-1] - 0.5) < 5e-2
    assert max(abs(v) for v in ut) <= 1.5 + 1e-3
    np.testing.assert_allclose(ut, uj, atol=5e-3)
    assert abs(xt - xj) < 5e-3


@pytest.mark.parametrize("per_element", [False, True])
def test_qp_batched_entry_matches_per_element(per_element):
    """qp_setup_batched + qp_solve_batched against per-element qp_setup /
    qp_solve of the port (x and y to 1e-6, iterations and flags equal) and
    against the reference's batched entry, for a shared and a per-element
    (LTV) factorization."""
    rng = np.random.default_rng(2)
    n, mrows, B = 6, 9, 4
    M = rng.normal(size=(n, n))
    P, A0 = M @ M.T + np.eye(n), rng.normal(size=(mrows, n))
    qs = rng.normal(size=(B, n))
    ls, us = np.full((B, mrows), -1.0), np.full((B, mrows), 1.0)
    tcfg, jcfg = TA.ADMMConfig(max_iter=500), JA.ADMMConfig(max_iter=500)
    if per_element:
        As = np.stack([A0 + 0.01 * i for i in range(B)])
        tfac = TA.qp_setup_batched(_t(P), _t(As), tcfg, l=_t(ls), u=_t(us))
        jfac = JA.qp_setup_batched(_j(P), _j(As), jcfg, l=_j(ls), u=_j(us))
        facs = [TA.qp_setup(_t(P), _t(As[i]), tcfg, l=_t(ls[i]), u=_t(us[i])) for i in range(B)]
    else:
        tfac, jfac = TA.qp_setup(_t(P), _t(A0), tcfg), JA.qp_setup(_j(P), _j(A0), jcfg)
        facs = [tfac] * B
    got = TA.qp_solve_batched(tfac, _t(qs), _t(ls), _t(us), tcfg)
    want = jax.jit(lambda f, q, l, u: JA.qp_solve_batched(f, q, l, u, jcfg))(
        jfac, _j(qs), _j(ls), _j(us))
    assert bool(got[3].all())
    for i in range(B):
        xi, yi, iti, donei, _ = TA.qp_solve(facs[i], _t(qs[i]), _t(ls[i]), _t(us[i]), tcfg)
        torch.testing.assert_close(got[0][i], xi, rtol=0, atol=1e-6)
        torch.testing.assert_close(got[1][i], yi, rtol=0, atol=1e-6)
        assert int(got[2][i]) == int(iti) and bool(got[3][i]) == bool(donei)
    _hold(got, want, iters_slack=2)


def test_fleet_matches_reference_bench(monkeypatch):
    """tools/admm_fleet.py, the port of tools/bench_admm.py: its assembly
    (806 x 503 per linearization) equals the reference's bit for bit, and
    two of its QPs (reference configuration, max_iter 400) agree with the
    reference's solves of the same data."""
    from pathlib import Path

    monkeypatch.syspath_prepend(str(Path(__file__).resolve().parent.parent / "tools"))
    import bench_admm as BA

    from nmpc_tpu_torch.tools import admm_fleet as AF

    th = np.array([0.3, 5.0], np.float32)
    w = np.array([0.5, 0.0], np.float32)
    x0 = np.array([[0.1, -0.2, 0.05], [-0.3, 0.0, 0.2]], np.float32)
    A = AF.assemble(_t(th), _t(w))
    Aj = np.stack([np.asarray(BA.assemble(jnp.asarray(a), jnp.asarray(b))) for a, b in zip(th, w)])
    np.testing.assert_array_equal(A.numpy(), Aj)
    P, lo, hi, q = AF.fleet_problem("cpu")
    got = AF.fleet(P, lo, hi, q, _t(th), _t(w), _t(x0))
    nz, n_eq = P.shape[0], (AF.N + 1) * AF.NX
    l = np.concatenate([-x0, np.zeros((2, n_eq - AF.NX)), np.repeat(lo.numpy()[None], 2, 0)], 1)
    u = np.concatenate([-x0, np.zeros((2, n_eq - AF.NX)), np.repeat(hi.numpy()[None], 2, 0)], 1)
    jcfg = JA.ADMMConfig(max_iter=400)
    fac = JA.qp_setup_batched(_j(P.numpy()), _j(Aj), jcfg, l=_j(l), u=_j(u))
    want = jax.jit(lambda f, q, l, u: JA.qp_solve_batched(f, q, l, u, jcfg))(
        fac, _j(np.repeat(q.numpy()[None], 2, 0)), _j(l), _j(u))
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=2e-3)
    assert np.all(np.abs(got[2].numpy() - np.asarray(want[2])) <= 0.05 * np.asarray(want[2]) + 2)
