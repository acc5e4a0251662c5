"""The port's horizon-parallel LQR (nmpc_tpu_torch.ops.assoc_lqr) against
the reference nmpc_tpu.ops.assoc_lqr on the same numpy inputs
(tests/test_ops.py's `_rand_lqr`), and against the port's own sequential
sweep.

Tolerances: the reference holds its two sweeps to atol 2e-3
(tests/test_ops.py:28-46); the port's functions against the reference's
same function to 1e-4 (the scan runs the reference's combination tree, so
the two differ only by the rounding of torch's and XLA's small solves),
and a batch axis against the unbatched calls to 1e-5.
"""

import jax
import numpy as np
import pytest
import torch

from nmpc_tpu.ops import assoc_lqr as JA
from nmpc_tpu_torch.ops import assoc_lqr as TA


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs six workers on the CPU's cores,
    where more threads a worker only wait on each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rand_lqr(key, N, n, m, batch=()):
    """tests/test_ops.py's draw (numpy, f32), with optional batch axes
    after the horizon."""
    rng = np.random.default_rng(key)
    s = (N, *batch)
    A = rng.normal(size=(*s, n, n)) * 0.3 + np.eye(n)
    B = rng.normal(size=(*s, n, m)) * 0.3
    c = rng.normal(size=(*s, n)) * 0.1
    M = rng.normal(size=(*s, n, n))
    Qxx = np.einsum("...ij,...kj->...ik", M, M) + 0.5 * np.eye(n)
    M = rng.normal(size=(*s, m, m))
    Quu = np.einsum("...ij,...kj->...ik", M, M) + 0.5 * np.eye(m)
    qx = rng.normal(size=(*s, n))
    qu = rng.normal(size=(*s, m))
    Qux = rng.normal(size=(*s, m, n)) * 0.2
    return tuple(np.asarray(a, np.float32) for a in (A, B, c, Qxx, qx, Quu, qu, Qux))


def _terminal(n):
    rng = np.random.default_rng(1)
    M = rng.normal(size=(n, n))
    return (np.asarray(M @ M.T + 0.5 * np.eye(n), np.float32),
            np.asarray(rng.normal(size=(n,)), np.float32))


def _t(arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


@pytest.mark.parametrize("N,n,m,terminal", [(32, 6, 3, True), (16, 4, 2, False), (7, 13, 2, False)])
def test_parallel_lqr_matches_reference(N, n, m, terminal):
    ins = _rand_lqr(N + n, N, n, m)
    term = _terminal(n) if terminal else (None, None)
    jk, jK, jS, jv = jax.jit(JA.parallel_lqr_gains)(*ins, *term)
    tk, tK, tS, tv = TA.parallel_lqr_gains(*_t(ins), *(None if a is None else torch.from_numpy(a)
                                                       for a in term))
    for got, want in ((tk, jk), (tK, jK), (tS, jS), (tv, jv)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("N,n,m,terminal", [(32, 6, 3, True), (16, 4, 2, False)])
def test_sequential_lqr_matches_reference_and_parallel(N, n, m, terminal):
    ins = _rand_lqr(N, N, n, m)
    term = _terminal(n) if terminal else (None, None)
    tterm = tuple(None if a is None else torch.from_numpy(a) for a in term)
    jk, jK = jax.jit(JA.sequential_lqr_gains)(*ins, *term)
    tk, tK = TA.sequential_lqr_gains(*_t(ins), *tterm)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tK.numpy(), np.asarray(jK), rtol=1e-4, atol=1e-4)
    pk, pK, _, _ = TA.parallel_lqr_gains(*_t(ins), *tterm)   # the reference's own criterion
    np.testing.assert_allclose(pK.numpy(), tK.numpy(), atol=2e-3)
    np.testing.assert_allclose(pk.numpy(), tk.numpy(), atol=2e-3)


def test_batch_axes_match_unbatched_calls():
    """A batch of 3 problems on the axis after the horizon gives each
    problem's unbatched result (the solver's hybrid route passes
    [N, B, ...])."""
    ins = _rand_lqr(5, 12, 4, 2, batch=(3,))
    got = TA.parallel_lqr_gains(*_t(ins))
    seq = TA.sequential_lqr_gains(*_t(ins))
    for b in range(3):
        one = TA.parallel_lqr_gains(*(torch.from_numpy(np.ascontiguousarray(a[:, b])) for a in ins))
        for g, w in zip(got, one):
            np.testing.assert_allclose(g[:, b].numpy(), w.numpy(), rtol=1e-5, atol=1e-5)
        one_seq = TA.sequential_lqr_gains(*(torch.from_numpy(np.ascontiguousarray(a[:, b]))
                                            for a in ins))
        for g, w in zip(seq, one_seq):
            np.testing.assert_allclose(g[:, b].numpy(), w.numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("num", [1, 2, 5, 8, 13])
def test_assoc_scan_is_the_inclusive_scan(num):
    """The recursion is an inclusive scan for every length, odd and even:
    with addition it gives the cumulative sums."""
    x = torch.arange(1.0, num + 1.0)
    (got,) = TA._assoc_scan(lambda a, b: [a[0] + b[0]], [x])
    assert torch.equal(got, torch.cumsum(x, 0))
