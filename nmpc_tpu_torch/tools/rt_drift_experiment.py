"""Reproduce and diagnose the rt-mode dual drift: warm-started
reduced-iteration AL solves lose feasibility on tight-collision configs
unless the penalty weight mu is carried with the multipliers. Port of
tools/rt_drift_experiment.py; it runs on the CPU, as the reference's does
(`--device cuda` runs the same solves on the card).

For two_robot_swap and six_robot_antipodal at their registry sizes: one
full solve (ALILQRConfig(n_outer=6, n_inner=12, tol_con=1e-4), the
per-scenario engine solver/alilqr.solve), then `steps` rt solves
(n_outer=2, n_inner=5, tol_con=1e-3) from starts jittered by 0.01 N(0, 1),
each warm-started from the last with U, lam (times lam_decay) and mu set by
the variant: "mu-carry" (mu carried), "mu-carry+decay0.9", "mu-rt-1e3" (mu
set to 1e3). Prints the violation, cost and largest multiplier every 10
steps and the worst violation over the run.

    python -m nmpc_tpu_torch.tools.rt_drift_experiment [--steps 30]
        [--scenarios two_robot_swap,six_robot_antipodal] [--N n] [--device cpu] [--json]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

import torch

from nmpc_tpu_torch.scenarios import get
from nmpc_tpu_torch.solver.alilqr import ALILQRConfig, WarmStart, solve
from nmpc_tpu_torch.tools.roofline import resolve_device

CFG = ALILQRConfig(n_outer=6, n_inner=12, tol_con=1e-4)
RT = ALILQRConfig(n_outer=2, n_inner=5, tol_con=1e-3)
VARIANTS = (dict(label="mu-carry", mu_carry=True),
            dict(label="mu-carry+decay0.9", mu_carry=True, lam_decay=0.9),
            dict(label="mu-rt-1e3", mu_rt=1e3))


def run(name: str, rt_cfg: ALILQRConfig, device, steps: int = 30, label: str = "",
        mu_carry: bool = False, lam_decay: float = 1.0, mu_rt: float | None = None,
        N: int | None = None) -> dict:
    ocp = get(name).make(device=device) if N is None else get(name).make(device=device, N=N)
    res = solve(ocp, cfg=CFG)

    def mk_warm(r):
        if mu_carry:
            mu = r.mu
        else:
            mu = torch.tensor(mu_rt if mu_rt is not None else rt_cfg.mu_init,
                              dtype=ocp.x0.dtype, device=device)
        return WarmStart(U=r.U, lam=lam_decay * r.lam, mu=mu)

    warm = mk_warm(res)
    g = torch.Generator(device=device).manual_seed(0)
    print(f"== {name} [{label}]: full viol={float(res.viol):.2e} cost={float(res.cost):.3f} "
          f"maxlam={float(res.lam.max()):.1f} mu_final={float(res.mu):.0f}")
    worst, trace = 0.0, []
    for i in range(steps):
        x0 = ocp.x0 + 0.01 * torch.randn(ocp.x0.shape, generator=g, dtype=ocp.x0.dtype,
                                          device=device)
        res = solve(dataclasses.replace(ocp, x0=x0), warm, rt_cfg)
        warm = mk_warm(res)
        worst = max(worst, float(res.viol))
        trace.append(dict(step=i, viol=float(res.viol), cost=float(res.cost),
                          maxlam=float(res.lam.max())))
        if i % 10 == 0 or i == steps - 1:
            print(f"  step {i:2d}: viol={float(res.viol):.2e} cost={float(res.cost):.3f} "
                  f"maxlam={float(res.lam.max()):.1f}")
    print(f"  WORST viol over run: {worst:.2e}")
    return dict(name=name, label=label, worst_viol=worst, steps=trace)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m nmpc_tpu_torch.tools.rt_drift_experiment")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--scenarios", default="two_robot_swap,six_robot_antipodal")
    ap.add_argument("--N", type=int, default=None)
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--json", action="store_true")
    a = ap.parse_args(argv)
    dev = resolve_device(a.device, "rt_drift_experiment")
    runs = [run(nm, RT, dev, a.steps, N=a.N, **v)
            for nm in a.scenarios.split(",") for v in VARIANTS]
    if a.json:
        print(json.dumps(dict(device=str(dev), runs=runs)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
