"""K3's and K5's launch geometry on the card, against their first designs.

    python -m nmpc_tpu_torch.tools.staged_launch [M,...]

For each robot count M (default: every one of SCENARIOS) builds
csrc/staged.cu once per geometry of CANDIDATES[M] (K3's S, D, T, P and
spill with K5's S and D, ops/staged_tiles.py; the first pair is the
solver's pick) and the first designs (csrc/staged_first.cu), and runs K3
and K5 of every variant and of the first designs at the stage inputs of
`inputs(M)`: K4's expansions of a random mid-solve state of SCENARIOS[M]
(obstacle_scenario_3 at N=100 for one robot, path (b); N=10 otherwise) at
B=32768 (16384 from m=8), K5 on the gains of K3 with the solver's
line-search grid. Prints each variant's shared bytes, resident warps per SM
and ptxas lines, whether every variant gives the first design's bits, and
the times in turns (forward, then backward; min and median of 2 samples,
each the mean of REPEAT launches in a row), fastest first. The picks in
ops/staged_tiles.py (K3_GEOMETRY, K5_GEOMETRY) are read from this table.
Needs a card.

`riccati_first` and `linesearch_costs_first` launch the first designs, the
A/B baselines that chip_smoke.py times in turns with the solver's kernels;
nothing in the solver reaches them.
"""

from __future__ import annotations

import functools
import re
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

from nmpc_tpu_torch.ops import cuda_build, riccati, rollout
from nmpc_tpu_torch.ops import staged_tiles as ST
from nmpc_tpu_torch.ops.staged_tiles import K3Geometry as G3
from nmpc_tpu_torch.ops.staged_tiles import K5Geometry as G5

SCENARIOS = {1: "obstacle_scenario_3", 2: "two_robot_swap", 3: "third_scenario",
             4: "fourth_scenario", 5: "five_robot", 6: "six_robot_antipodal", 8: "eight_robot",
             10: "ten_robot"}
# (K3, K5) geometries per m, the solver's pick first
# launches per timed sample: their mean is the sample, so a wrapper's host
# work overlaps the previous launch as it does in a solve
REPEAT = 5
CANDIDATES = {
    1: [(G3(128, 2, 1, 128), G5(32, 2)), (G3(64, 4, 1, 64), G5(32, 4))],
    2: [(G3(128, 2, 1, 128), G5(32, 2)), (G3(64, 2, 1, 64), G5(16, 2))],
    3: [(G3(16, 2, 16, 17), G5(32, 2)), (G3(8, 2, 16, 9), G5(16, 2)),
        (G3(8, 2, 32, 9), G5(32, 4))],
    4: [(G3(8, 2, 16, 9), G5(16, 2)), (G3(8, 2, 32, 9), G5(32, 2)),
        (G3(8, 2, 32, 8), G5(16, 4))],
    5: [(G3(8, 2, 16, 9), G5(16, 2)), (G3(8, 2, 32, 9), G5(32, 4)),
        (G3(8, 2, 32, 8), G5(32, 2))],
    6: [(G3(8, 2, 32, 9), G5(32, 2)), (G3(8, 2, 32, 8), G5(16, 4)),
        (G3(8, 2, 16, 9), G5(16, 2)), (G3(8, 2, 32, 8, True), G5(8, 2))],
    8: [(G3(8, 2, 32, 8), G5(16, 2)), (G3(8, 2, 16, 8), G5(32, 2)),
        (G3(8, 2, 32, 8, True), G5(8, 2))],
    10: [(G3(8, 2, 32, 8, True), G5(8, 2)), (G3(8, 2, 16, 8, True), G5(16, 2))],
}


def riccati_first(exp, reg: float = 1e-6):
    """K3's first design (one thread per scenario) on CUDA inputs: the
    arguments and results of riccati.riccati_lanes."""
    m = riccati.check_lanes(exp)[-1]
    return riccati.launch(exp, reg, cuda_build.load_first(m), first=True)


def linesearch_costs_first(ocp, x0_l, X_l, U_l, kff_l, Kfb_l, xref_l, lam_l, mu, alphas,
                           mov_l=None):
    """K5's first design (one thread per (alpha, scenario)) on CUDA inputs:
    the arguments and result of rollout.linesearch_costs_lanes."""
    rollout.check_costs(ocp, x0_l, X_l, U_l, kff_l, Kfb_l, xref_l, lam_l, mu, mov_l)
    return rollout.costs_launch(ocp, x0_l, X_l, U_l, kff_l, Kfb_l, xref_l, lam_l, mu, alphas,
                                mov_l, cuda_build.load_first(ocp.m), first=True)


def batch_size(m: int) -> int:
    return 32768 if m <= 6 else 16384


def inputs(m: int, seed: int = 0) -> dict:
    """Stage inputs of SCENARIOS[m] on the card at batch_size(m): starts
    jittered by 0.05 N(0, 1), stage states 0.3 N(0, 1) about the start,
    controls 0.05 N(0, 1), duals |0.5 N(0, 1)| (zero on the masked rows), mu
    in {10, 100}; K4's expansions there (`exp`), K3's gains on them, and K5's
    arguments (`k5`, without the alphas)."""
    from nmpc_tpu_torch.ocp import problem as P
    from nmpc_tpu_torch.ops.expansions import expansions_fused
    from nmpc_tpu_torch.parallel import batch_ocp
    from nmpc_tpu_torch.scenarios import get
    from nmpc_tpu_torch.solver.alilqr_batched import _mov_lanes

    base = get(SCENARIOS[m]).make(**({} if m == 1 else {"N": 10}))
    B, dev = batch_size(m), base.device
    g = torch.Generator(device=dev).manual_seed(seed)
    rnd = lambda *s: torch.randn(s, generator=g, device=dev)  # noqa: E731
    ob = batch_ocp(base, base.x0[None] + 0.05 * rnd(B, base.nx))
    N, n, nu = base.N, base.nx, base.nu
    X_l = (base.x0[None, :, None] + 0.3 * rnd(N, n, B)).contiguous()
    U_l = 0.05 * rnd(N, nu, B)
    lam_l = 0.5 * rnd(N, base.n_con, B).abs() * (P.constraint_mask(base) > 0)[..., None]
    mu = torch.tensor([10.0, 100.0], device=dev)[torch.randint(0, 2, (B,), generator=g, device=dev)]
    xref_l = ob.xref.movedim(0, -1).contiguous()
    mov_l = _mov_lanes(ob, B)
    exp = expansions_fused(ob, X_l, U_l, xref_l, lam_l, mu, mov_l)
    kff_l, Kfb_l, _ = riccati.riccati_lanes(exp)
    k5 = (X_l[0].contiguous(), X_l, U_l, kff_l, Kfb_l, xref_l, lam_l, mu)
    return {"ocp": ob, "exp": exp, "k5": k5, "mov": mov_l}


def staged_ptxas(report: str) -> dict:
    """{'K3': 'N registers, ...', 'K5': ...} of staged.cu's `-Xptxas -v`
    report: each kernel's frame, registers and shared memory."""
    lines, out = report.splitlines(), {}
    for i, line in enumerate(lines):
        if "Compiling entry function" not in line:
            continue
        name = ("K3" if "riccati" in line else "K5" if "linesearch_costs" in line else None)
        if name:
            out[name] = "; ".join(re.sub(r"^\s*ptxas info\s*:\s*", "", x).strip()
                                  for x in lines[i + 2:i + 4])
    return out


def sweep(m: int, libs: list, alphas) -> tuple:
    """({(kernel, variant): [ms, ms]}, every variant bit for bit the first
    design) at inputs(m); libs: the variants' libraries, in CANDIDATES order."""
    from nmpc_tpu_torch.tools.exp_mega_phases import time_in_turns

    d = inputs(m)
    ob, exp, k5, mov = d["ocp"], d["exp"], d["k5"], d["mov"]
    first = cuda_build.load_first(m)
    runs = {("K3", "first"): functools.partial(riccati.launch, exp, 1e-6, first, True),
            ("K5", "first"): functools.partial(rollout.costs_launch, ob, *k5, alphas, mov, first,
                                               True)}
    for i, lib in enumerate(libs):
        runs["K3", i] = functools.partial(riccati.launch, exp, 1e-6, lib)
        runs["K5", i] = functools.partial(rollout.costs_launch, ob, *k5, alphas, mov, lib)
    outs = {k: f() for k, f in runs.items()}
    tup = lambda o: o if isinstance(o, tuple) else (o,)  # noqa: E731
    same = all(torch.equal(a, b) for (kern, _), o in outs.items()
               for a, b in zip(tup(o), tup(outs[kern, "first"])))
    order = list(runs) + list(runs)[::-1]
    repeated = {k: functools.partial(_repeat, f) for k, f in runs.items()}
    return {k: [t / REPEAT for t in v]
            for k, v in time_in_turns(repeated, order, 1).items()}, same


def _repeat(fn):
    for _ in range(REPEAT):
        fn()


def main(argv=None) -> int:
    from nmpc_tpu_torch.solver.alilqr import ALILQRConfig
    from nmpc_tpu_torch.tools.exp_mega_phases import summarize
    from nmpc_tpu_torch.tools.roofline import card, require_card

    require_card("staged_launch")
    args = sys.argv[1:] if argv is None else argv
    robots = [int(a) for a in args[0].split(",")] if args else sorted(SCENARIOS)
    alphas = (0.0,) + tuple(ALILQRConfig().alphas)
    jobs = sum(len(CANDIDATES[m]) for m in robots) + len(robots)
    with ThreadPoolExecutor(max_workers=jobs) as pool:
        built = {(m, i): pool.submit(cuda_build.load_staged_variant, m, *CANDIDATES[m][i])
                 for m in robots for i in range(len(CANDIDATES[m]))}
        firsts = [pool.submit(cuda_build.load_first, m) for m in robots]
        built = {key: f.result() for key, f in built.items()}
        for f in firsts:
            f.result()
    print(f"{torch.cuda.get_device_name(0)} [{card()}]")
    for m in robots:
        for i, (k3, k5) in enumerate(CANDIDATES[m]):
            lay = ST.k3_layout(m, k3)
            print(f"m={m} variant {i}: K3 {k3} {lay['smem_bytes']} B shared, {lay['warps_per_sm']} "
                  f"warps/SM by shared memory; K5 {k5}; ptxas {staged_ptxas(built[m, i][1])}")
        print(f"m={m} first design ptxas {staged_ptxas(cuda_build.first_build_info[m]['ptxas'])}")
        times, same = sweep(m, [built[m, i][0] for i in range(len(CANDIDATES[m]))], alphas)
        print(f"m={m} {SCENARIOS[m]} B={batch_size(m)}: every variant bit for bit the first "
              f"design: {'yes' if same else 'NO'}")
        rows = sorted(summarize(times).items(), key=lambda kv: (kv[0][0], kv[1][1]))
        for (k, v), (lo, med) in rows:
            print(f"  {k} variant {v}: min {lo:.3f} ms, median {med:.3f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
