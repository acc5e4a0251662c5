"""Compare the solver's results between two checkouts, bit for bit: does a
change of the sources change what solve_batched returns?

    python -m nmpc_tpu_torch.tools.solve_diff OTHER_CHECKOUT
    python -m nmpc_tpu_torch.tools.solve_diff OTHER_CHECKOUT --time

solves chip_smoke.py's five full-width batches, each drawn from a fixed
seed: the main path (six_robot_antipodal N=10 B=32768, the benchmark's
config, megakernel route), path (a) (the same batch with mega=False), path
(b) (obstacle_scenario_3 N=100 B=32768), path (c) (B=4096 moving-obstacle
subproblems of one decentralized round), (b) and (c) on the staged route
(mega=False) as chip_smoke.py phases 8 and 9 run them, and path (d)
(lidar_v2 N=100 B=4096 on the hybrid route, K3 at (13, 2), as phase 25), in this checkout and in
OTHER_CHECKOUT, each in a subprocess with its own package and chip_smoke.py,
and prints per batch and output how many entries differ (NaN equals NaN).
A redesign that must keep the solver's bits (a kernel held bit for bit to
its first design) shows 0 everywhere.

--time instead times the main path's solve_batched in each checkout, in
turns (OTHER_CHECKOUT, this, this, OTHER_CHECKOUT), each turn a subprocess
with its own package: a warm-up solve, then the median of 3 timed solves of
fresh draws (host clock to torch.cuda.synchronize(), as chip_smoke.py phase
6), in solves/s. Needs a card.
"""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import torch

from nmpc_tpu_torch.ops.cuda_build import BUILD_DIR

ROOT = Path(__file__).resolve().parents[2]
OUTPUTS = ("X", "U", "cost", "lam", "mu", "viol", "converged", "inner_iters", "outer_iters")

# run in each checkout: only the API both sides have (solve_batched, the
# registry, batch_ocp, chip_smoke.decentralized_round, tools/lidar_fleet)
SOLVES = """
import dataclasses, sys, torch
from chip_smoke import decentralized_round
from nmpc_tpu_torch.ocp import problem as P
from nmpc_tpu_torch.parallel import batch_ocp
from nmpc_tpu_torch.scenarios import get
from nmpc_tpu_torch.solver import ALILQRConfig, solve_batched
from nmpc_tpu_torch.tools import lidar_fleet as LF

dev = torch.device("cuda", 0)
g = torch.Generator(device=dev).manual_seed(0)
base = get("six_robot_antipodal").make(N=10, device=dev)
ob = batch_ocp(base, base.x0[None] + 0.1 * torch.randn((32768, base.nx), generator=g, device=dev))
cfg = ALILQRConfig(n_outer=6, n_inner=12, tol_con=1e-3, ls="adaptive")
obs = get("obstacle_scenario_3").make(device=dev)
ob_b = batch_ocp(obs, obs.x0[None] + 0.05 * torch.randn((32768, obs.nx), generator=g, device=dev))
runs = {"main path": (ob, cfg), "path (a)": (ob, dataclasses.replace(cfg, mega=False)),
        "path (b)": (ob_b, ALILQRConfig(n_outer=12, n_inner=25, tol_con=1e-3, mega=False)),
        "path (c)": (decentralized_round(P.make_ocp, dev, g, 4096),
                     ALILQRConfig(n_outer=6, n_inner=12, tol_con=1e-4, mega=False)),
        "path (d)": (LF.jittered(LF.scanned("lidar_v2", [[0.5, 0.25, 0.15]], dev, ray_lo=0.3),
                                 4096, g), ALILQRConfig(n_outer=10, n_inner=20, tol_con=1e-3))}
out = {}
for tag, (o, c) in runs.items():
    r = solve_batched(o, cfg=c)
    out[tag] = {k: getattr(r, k).cpu() for k in OUTPUTS}
torch.save(out, sys.argv[1])
"""


# run in each checkout: the main path's solves/s, as chip_smoke.py phase 6
TIMES = """
import statistics, sys, time, torch
from nmpc_tpu_torch.parallel import batch_ocp
from nmpc_tpu_torch.scenarios import get
from nmpc_tpu_torch.solver import ALILQRConfig, solve_batched

dev = torch.device("cuda", 0)
g = torch.Generator(device=dev).manual_seed(0)
base = get("six_robot_antipodal").make(N=10, device=dev)
cfg = ALILQRConfig(n_outer=6, n_inner=12, tol_con=1e-3, ls="adaptive")
times = []
for i in range(4):   # the first is the warm-up
    ob = batch_ocp(base, base.x0[None] + 0.1 * torch.randn((32768, base.nx), generator=g, device=dev))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    solve_batched(ob, cfg=cfg)
    torch.cuda.synchronize()
    if i:
        times.append(time.perf_counter() - t0)
print(32768 / statistics.median(times))
"""


def solves_per_s(root: Path) -> float:
    """The main path's median solves/s as root's own sources run it."""
    env = dict(os.environ, PYTHONPATH=str(root))
    out = subprocess.run([sys.executable, "-c", TIMES], cwd=root, env=env, check=True,
                         capture_output=True, text=True).stdout
    return float(out.split()[-1])


def solve(root: Path, path: str) -> dict:
    """The five batches' results as root's own sources compute them."""
    env = dict(os.environ, PYTHONPATH=str(root))
    subprocess.run([sys.executable, "-c", f"OUTPUTS = {OUTPUTS!r}\n" + SOLVES, path], cwd=root,
                   env=env, check=True)
    return torch.load(path)


def differ(a: torch.Tensor, b: torch.Tensor) -> int:
    """Entries of a and b that differ, NaN equal to NaN (-1: shapes differ)."""
    if a.shape != b.shape:
        return -1
    same = a == b
    if a.is_floating_point():
        same |= a.isnan() & b.isnan()
    return int((~same).sum())


def main(argv=None) -> int:
    from nmpc_tpu_torch.tools.roofline import card, require_card

    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    require_card("solve_diff")
    other = Path(argv[0]).resolve()
    if argv[1:] == ["--time"]:
        turns = [(name, solves_per_s(root)) for name, root in
                 (("other", other), ("this", ROOT), ("this", ROOT), ("other", other))]
        print(f"{torch.cuda.get_device_name(0)} [{card()}]: the main path's solves/s in turns "
              f"(other = {other}): " + ", ".join(f"{n} {v:.1f}" for n, v in turns))
        this = [v for n, v in turns if n == "this"]
        theirs = [v for n, v in turns if n == "other"]
        print(f"this / other: {sum(this) / sum(theirs):.4f}")
        return 0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    mine = solve(ROOT, str(BUILD_DIR / "solve_diff_this.pt"))
    theirs = solve(other, str(BUILD_DIR / "solve_diff_other.pt"))
    print(f"{torch.cuda.get_device_name(0)} [{card()}]: solve_batched's results, this checkout "
          f"against {other}, entries that differ")
    same = True
    for tag, res in mine.items():
        counts = {k: differ(v, theirs[tag][k]) for k, v in res.items()}
        same &= not any(counts.values())
        print(f"  {tag}: {counts}")
    print(f"bit for bit the same: {'yes' if same else 'no'}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
