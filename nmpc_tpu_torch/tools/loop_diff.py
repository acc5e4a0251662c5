"""A case of tools/loop_suite.py on the card with K1 held against its plain
version at the loops' own inputs, and the case's spread under rounding.

    python -m nmpc_tpu_torch.tools.loop_diff CASE [CASE ...] [--every K] [--spread K]

Every K-th K1 launch of the megakernel route (default every one; `--every
0`: none, the case as the suite runs it) is also run by
`megasolve.inner_solve_plain` on the same inputs (CUDA tensors; the merit
summed in the launched design's order, `al_merit_team_order` or
`al_merit_warp_order`) and again from inputs moved by about an ulp. The
tool counts the scenarios on which K1 parts from plain at chip_smoke phase
3's tolerances (cost rtol 1e-4, U and Xs atol 5e-3; iteration counts
apart) beside those on which plain parts from itself, phase 6's yardstick:
K1 parting far more often than that is a fault, as often is f32's own
spread. The plain version takes ~1 s a launch at B=1. `--spread K`: the
case K more times, every loop from x0 moved by 1e-7 x N(0, 1) (numpy seeds
0..K-1; loop_suite.Run.dx0_seed), without the hold: how far rounding alone
moves the case's outcome. Prints one JSON line a run (the loops' records,
the failed bounds, the hold's counts).
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from nmpc_tpu_torch.ops import cuda_build, megasolve
from nmpc_tpu_torch.solver import alilqr_batched as AB
from nmpc_tpu_torch.tools import loop_suite as LS


def _apart(a, b):
    """Per scenario: outside cost rtol 1e-4 or U, Xs atol 5e-3; iteration
    counts that differ; the cost's relative and U's absolute gap."""
    rel = (a[2] - b[2]).abs() / b[2].abs().clamp(min=1e-30)
    du = (a[1] - b[1]).abs().amax(dim=(1, 2))
    dx = (a[0] - b[0]).abs().amax(dim=(1, 2))
    return (rel > 1e-4) | (du > 5e-3) | (dx > 5e-3), a[3] != b[3], rel, du


class Hold:
    """Wraps K1's wrapper as the megakernel route calls it: every
    `every`-th launch is also run by the plain version on the same inputs
    and from inputs moved by about an ulp, and compared."""

    def __init__(self, fused, every: int = 1):
        self.fused, self.every, self.calls, self.held = fused, every, 0, 0
        self.n = self.k1_apart = self.k1_iters = self.self_apart = self.self_iters = 0
        self.first, self.worst_rel, self.worst_du, self.gen = None, 0.0, 0.0, None

    def __call__(self, ocp, x0, xref, lam, mu, U, cfg):
        got = self.fused(ocp, x0, xref, lam, mu, U, cfg)
        self.calls += 1
        if (self.calls - 1) % self.every:
            return got
        if self.gen is None:
            self.gen = torch.Generator(device=x0.device).manual_seed(0)
        merit = (megasolve.al_merit_team_order if ocp.m in cuda_build.TEAM_ROBOTS
                 else megasolve.al_merit_warp_order)
        want = megasolve.inner_solve_plain(ocp, x0, xref, lam, mu, U, cfg, merit=merit)
        ulp = lambda t: t * (1.0 + 2.0 ** -23 * torch.randn(  # noqa: E731
            t.shape, generator=self.gen, device=t.device))
        spread = megasolve.inner_solve_plain(ocp, ulp(x0), xref, lam, mu, ulp(U), cfg,
                                             merit=merit)
        apart, iters, rel, du = _apart(got, want)
        s_apart, s_iters, _, _ = _apart(spread, want)
        self.held += 1
        self.n += int(apart.numel())
        self.k1_apart += int(apart.sum())
        self.k1_iters += int(iters.sum())
        self.self_apart += int(s_apart.sum())
        self.self_iters += int(s_iters.sum())
        if bool(apart.any()) and self.first is None:
            self.first = {"launch": self.calls - 1, "cost_rel": float(rel.max()),
                          "du": float(du.max()), "iters": [got[3].tolist(), want[3].tolist()]}
        self.worst_rel = max(self.worst_rel, float(rel.max()))
        self.worst_du = max(self.worst_du, float(du.max()))
        return got

    def summary(self) -> dict:
        return {"launches": self.calls, "held": self.held, "scenarios": self.n,
                "k1_apart": self.k1_apart, "plain_vs_itself_apart": self.self_apart,
                "k1_iters_differ": self.k1_iters, "plain_vs_itself_iters_differ": self.self_iters,
                "worst_cost_rel": self.worst_rel, "worst_du": self.worst_du,
                "first_apart": self.first}


def diff_case(name: str, device=None, every: int = 1, dx0_seed: int | None = None,
              hold: bool = True) -> dict:
    """Run loop_suite.CASES[name] on `device` (default the card), with the
    hold of every `every`-th K1 launch unless hold is False, from x0 moved
    as dx0_seed says (loop_suite.Run); return {"name", "dx0_seed", "loops",
    "fails", "hold"}."""
    from nmpc_tpu_torch.device import DEVICE

    run = LS.Run(torch.device(device or DEVICE), dx0_seed=dx0_seed)
    real = AB.inner_solve_fused
    held = Hold(real, every) if hold else None
    if held is not None:
        AB.inner_solve_fused = held
    try:
        LS.CASES[name].run(run)
    finally:
        AB.inner_solve_fused = real
    return {"name": name, "dx0_seed": dx0_seed, "loops": run.loops, "fails": run.fails,
            "hold": None if held is None else held.summary()}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m nmpc_tpu_torch.tools.loop_diff")
    p.add_argument("names", nargs="+", help="cases of tools/loop_suite.py")
    p.add_argument("--every", type=int, default=1,
                   help="hold every K-th K1 launch (0: run the case without the hold)")
    p.add_argument("--spread", type=int, default=0,
                   help="then K runs from x0 moved by 1e-7 x N(0, 1), without the hold")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("loop_diff: no CUDA device", file=sys.stderr)
        return 2
    for name in args.names:
        print(json.dumps(diff_case(name, every=max(args.every, 1), hold=args.every > 0),
                         default=str), flush=True)
        for seed in range(args.spread):
            print(json.dumps(diff_case(name, dx0_seed=seed, hold=False), default=str),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
