"""Structured run records and artifact persistence. Port of
nmpc_tpu/utils/runlog.py: a closed-loop run dumped to one .npz artifact
(trajectories, per-step solver diagnostics, config metadata) and reloaded
for regression comparison. The .npz layout is the reference's exactly, so a
run or warm start saved by either package loads in the other.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import numpy as np
import torch

from nmpc_tpu_torch.device import DEVICE


@dataclasses.dataclass
class RunLog:
    X_hist: np.ndarray
    U_hist: np.ndarray
    err_hist: np.ndarray
    cost_hist: np.ndarray
    viol_hist: np.ndarray
    iter_hist: np.ndarray
    min_dist_hist: np.ndarray
    steps_used: int
    reached: bool
    meta: dict

    def summary(self) -> dict:
        used = max(int(self.steps_used), 1)
        return {
            "reached": bool(self.reached),
            "steps_used": int(self.steps_used),
            "final_err": float(self.err_hist[min(used, len(self.err_hist)) - 1]),
            "min_pair_dist": float(np.min(self.min_dist_hist)),
            "max_violation": float(np.max(self.viol_hist[:used])),
            "mean_inner_iters": float(np.mean(self.iter_hist[:used])),
            **{k: self.meta[k] for k in ("scenario",) if k in self.meta},
        }


def _np(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def save_run(path, result, meta: dict | None = None) -> RunLog:
    """Persist an MPCResult (or duck-typed equivalent) to `path`.npz."""
    log = RunLog(
        X_hist=_np(result.X_hist),
        U_hist=_np(result.U_hist),
        err_hist=_np(result.err_hist),
        cost_hist=_np(result.cost_hist),
        viol_hist=_np(result.viol_hist),
        iter_hist=_np(result.iter_hist),
        min_dist_hist=_np(result.min_dist_hist),
        steps_used=int(result.steps_used),
        reached=bool(result.reached),
        meta=meta or {},
    )
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(
        path,
        meta=json.dumps(log.meta),
        **{f.name: getattr(log, f.name) for f in dataclasses.fields(log) if f.name != "meta"},
    )
    return log


def save_warm(path, warm) -> None:
    """Persist solver warm-start state (U, lam, mu): resuming MPC is
    warm-start persistence."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(path, U=_np(warm.U), lam=_np(warm.lam), mu=_np(warm.mu))


def load_warm(path, device=DEVICE):
    """The port's WarmStart from a saved warm start, on `device`."""
    from nmpc_tpu_torch.solver.alilqr import warm_from_numpy

    with np.load(path if str(path).endswith(".npz") else str(path) + ".npz") as z:
        return warm_from_numpy(z["U"], z["lam"], z["mu"], device=device)


def load_run(path) -> RunLog:
    with np.load(Path(path).with_suffix(".npz") if not str(path).endswith(".npz") else path,
                 allow_pickle=False) as z:
        return RunLog(
            X_hist=z["X_hist"],
            U_hist=z["U_hist"],
            err_hist=z["err_hist"],
            cost_hist=z["cost_hist"],
            viol_hist=z["viol_hist"],
            iter_hist=z["iter_hist"],
            min_dist_hist=z["min_dist_hist"],
            steps_used=int(z["steps_used"]),
            reached=bool(z["reached"]),
            meta=json.loads(str(z["meta"])),
        )
