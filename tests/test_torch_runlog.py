"""The port's run logs (nmpc_tpu_torch/utils/runlog.py) against the JAX
package's: a run and a warm start saved by either package load in the
other with every field equal, and the port's load_warm gives its own
WarmStart on the device asked for."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nmpc_tpu.solver.alilqr import WarmStart as JaxWarm
from nmpc_tpu.utils import runlog as JR
from nmpc_tpu_torch.solver.alilqr import WarmStart
from nmpc_tpu_torch.utils import runlog as TR


@dataclasses.dataclass
class _Result:
    """An MPCResult's fields, as either package's driver returns them."""
    X_hist: object
    U_hist: object
    err_hist: object
    cost_hist: object
    viol_hist: object
    iter_hist: object
    min_dist_hist: object
    steps_used: object
    reached: object


def _arrays(seed=0, S=7, m=2):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return dict(X_hist=f(S + 1, 3 * m), U_hist=f(S, 2 * m), err_hist=np.abs(f(S)),
                cost_hist=np.abs(f(S)), viol_hist=np.abs(f(S)) * 1e-4,
                iter_hist=rng.integers(1, 30, S).astype(np.int32),
                min_dist_hist=np.abs(f(S + 1)) + 0.3, steps_used=np.int32(5),
                reached=np.bool_(True))


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_run_crosses_between_packages(tmp_path, writer):
    a = _arrays()
    meta = {"scenario": "two_robot_swap", "N": 10}
    path = tmp_path / "run.npz"
    if writer == "port":
        res = _Result(**{k: torch.as_tensor(v) for k, v in a.items()})
        saved = TR.save_run(path, res, meta)
        got = JR.load_run(path)
    else:
        res = _Result(**{k: jnp.asarray(v) for k, v in a.items()})
        saved = JR.save_run(path, res, meta)
        got = TR.load_run(path)
    for k, v in a.items():
        np.testing.assert_array_equal(np.asarray(getattr(got, k)), v, err_msg=k)
        if k.endswith("_hist"):
            assert getattr(got, k).dtype == v.dtype, k
    assert got.meta == meta and got.summary() == saved.summary()
    assert TR.load_run(path).summary() == JR.load_run(path).summary()


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_warm_start_crosses_between_packages(tmp_path, writer):
    rng = np.random.default_rng(1)
    U = rng.standard_normal((10, 4)).astype(np.float32)
    lam = np.abs(rng.standard_normal((10, 21))).astype(np.float32)
    mu = np.float32(100.0)
    path = tmp_path / "warm"
    if writer == "port":
        TR.save_warm(path, WarmStart(torch.from_numpy(U), torch.from_numpy(lam), torch.tensor(mu)))
    else:
        JR.save_warm(path, JaxWarm(jnp.asarray(U), jnp.asarray(lam), jnp.asarray(mu)))
    tw, jw = TR.load_warm(path, device="cpu"), JR.load_warm(path)
    assert isinstance(tw, WarmStart) and tw.U.device.type == "cpu"
    for got, want, ref in ((tw.U, U, jw.U), (tw.lam, lam, jw.lam), (tw.mu, mu, jw.mu)):
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(np.asarray(ref), want)
