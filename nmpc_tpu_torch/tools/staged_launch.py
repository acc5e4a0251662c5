"""The staged kernels' launch geometry on the card, against their first
designs.

    python -m nmpc_tpu_torch.tools.staged_launch [M,...] [k35|k46|k3]
    python -m nmpc_tpu_torch.tools.staged_launch NxNU,... k3

For each robot count M (default: every one of CANDIDATES) builds
csrc/staged.cu once per geometry of a candidate list and the first designs
(csrc/staged_first.cu, up to sixteen robots), and times the kernels of
every variant and of the first designs at the stage inputs of `inputs(M)`:
a random mid-solve state of SCENARIOS[M] (obstacle_scenario_3 at N=100 for
one robot, path (b); N=10 otherwise; past the registry,
scenarios/robot_counts.py's problem: the circle at M = 7 and 9, the widened
crossing from 11) at B=32768 (16384 from m=7, 4096 past sixteen robots).
Past sixteen robots, where no first design is built, every variant is held
bit for bit to the rule's pick (variant 0): the variants differ in tiles
and threads, never in a sum's order. `k35` (CANDIDATES: K3's S, D, T, P
and spill with K5's S and D, ops/staged_tiles.py) times K3 on K4's
expansions there and K5 on K3's gains with the solver's line-search grid;
`k46` (CANDIDATES46: K4's S and W with K6's S, D and T) times K4 on the
state and K6 on K3's gains with one alpha of the grid per scenario; both
without the argument. `k3` (CANDIDATES3, past ten robots: the register-tile
design's scenarios a block, ring depth, threads and the spilled slot)
builds K3 alone (csrc/riccati_shape.cu at (3M, 2M), a few seconds of nvcc a
variant) and times it as k35 does; a key NxNU (a stage shape past (30, 20))
takes k3_rule's pick and every other S of a ring of one and 256 threads
that fits (shape_candidates), on kernel_check.k3_inputs at SHAPE_B
scenarios and SHAPE_N stages (chip_smoke.py phase 39's). The first pair of each list is the solver's pick, the
other kernels of a variant are at theirs. Prints each variant's shared
bytes, resident warps per SM and ptxas lines, the output entries in which
each variant differs from the first design (variant 0 where there is
none), and the times in turns (forward, then backward; min
and median of 2 samples, each the mean of REPEAT launches in a row), fastest
first. The picks in ops/staged_tiles.py (K3_GEOMETRY, ..., K6_GEOMETRY) are
read from this table. Needs a card.

`expansions_first`, `riccati_first`, `linesearch_costs_first` and
`rollout_alpha_first` launch the first designs, the A/B baselines that
chip_smoke.py times in turns with the solver's kernels; nothing in the
solver reaches them.
"""

from __future__ import annotations

import functools
import re
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

from nmpc_tpu_torch.ops import cuda_build, expansions, riccati, rollout
from nmpc_tpu_torch.ops import staged_tiles as ST
from nmpc_tpu_torch.ops.staged_tiles import K3Geometry as G3
from nmpc_tpu_torch.ops.staged_tiles import K4Geometry as G4
from nmpc_tpu_torch.ops.staged_tiles import K5Geometry as G5
from nmpc_tpu_torch.ops.staged_tiles import K6Geometry as G6

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
    7: [(G3(8, 2, 32, 8), G5(16, 2)), (G3(8, 2, 16, 8), G5(32, 2)),
        (G3(8, 2, 32, 8, True), G5(8, 2))],
    9: [(G3(8, 2, 32, 8, True), G5(16, 2)), (G3(8, 2, 16, 8, True), G5(8, 2))],
    # past ten robots K3's register-tile design at k3_rule's pick (its own
    # variants: CANDIDATES3, the `k3` family) with K5's tiles by k5_rule;
    # other K5 tiles beside them at 12-32
    12: [(ST.k3_geometry(12), G5(8, 2)), (ST.k3_geometry(12), G5(16, 2))],
    16: [(ST.k3_geometry(16), G5(8, 2))],
    **{m: [(ST.k3_geometry(m), G5(8, 2))] for m in (11, 13, 14, 15)},
    20: [(ST.k3_geometry(20), G5(8, 2)), (ST.k3_geometry(20), G5(4, 2))],
    24: [(ST.k3_geometry(24), G5(4, 2)), (ST.k3_geometry(24), G5(2, 2))],
    32: [(ST.k3_geometry(32), G5(2, 2)), (ST.k3_geometry(32), G5(1, 2))],
}
# K3's register-tile design per m past ten robots, k3_rule's pick first:
# scenarios a block (S), ring depth (D), threads a block (T), the slot
# spilled (its products staged through shared memory)
RT = functools.partial(G3, P=1, rtile=True)
CANDIDATES3 = {
    12: [RT(2, 1, 256), RT(1, 1, 256), RT(3, 1, 256), RT(2, 2, 256), RT(2, 1, 512)],
    16: [RT(1, 1, 256), RT(2, 1, 256), RT(1, 2, 256), RT(1, 1, 128), RT(1, 1, 512)],
    20: [RT(1, 1, 256), RT(1, 2, 256), RT(2, 1, 256), RT(1, 1, 128), RT(1, 1, 512)],
    24: [RT(1, 1, 256), RT(1, 2, 256), RT(1, 1, 128), RT(1, 1, 512),
         RT(1, 0, 256, spill=True)],
    32: [RT(1, 1, 512), RT(1, 1, 256), RT(1, 1, 1024), RT(1, 0, 256, spill=True)],
}
# a stage shape's batch and horizon in the `k3` family
SHAPE_B, SHAPE_N = 256, 20


def shape_candidates(shape: tuple) -> list:
    """K3 at a stage shape past (30, 20): k3_rule's pick, then every other
    S (8, 4, 2, 1) that fits a block at a ring of one and 256 threads."""
    pick = ST.k3_geometry(shape)
    others = [RT(S, 1, 256) for S in (8, 4, 2, 1)
              if RT(S, 1, 256) != pick and ST.k3_layout(shape, RT(S, 1, 256))["smem_bytes"]
              <= ST.SMEM_BLOCK_MAX]
    return [pick, *others]


# (K4, K6) geometries per m, the solver's pick first
CANDIDATES46 = {
    1: [(G4(128, 4), G6(32, 4, 1)), (G4(128, 8), G6(64, 4, 1)), (G4(64, 4), G6(32, 2, 1)),
        (G4(256, 8), G6(128, 4, 1))],
    2: [(G4(64, 2), G6(32, 4, 1)), (G4(128, 4), G6(64, 2, 1)), (G4(64, 4), G6(32, 2, 2)),
        (G4(128, 8), G6(16, 4, 1))],
    3: [(G4(64, 4), G6(32, 2, 2)), (G4(64, 8), G6(32, 2, 1)), (G4(128, 8), G6(64, 2, 2)),
        (G4(32, 8), G6(32, 4, 2))],
    4: [(G4(64, 8), G6(32, 2, 2)), (G4(64, 4), G6(32, 2, 1)), (G4(32, 8), G6(16, 2, 2)),
        (G4(128, 8), G6(32, 3, 2))],
    5: [(G4(64, 4), G6(32, 2, 2)), (G4(32, 2), G6(16, 2, 2)), (G4(64, 8), G6(32, 2, 1)),
        (G4(32, 4), G6(16, 2, 1))],
    6: [(G4(64, 4), G6(32, 2, 1)), (G4(64, 8), G6(16, 2, 1)), (G4(32, 8), G6(32, 3, 1)),
        (G4(64, 16), G6(16, 2, 2)), (G4(128, 8), G6(32, 2, 2))],
    8: [(G4(32, 2), G6(16, 2, 4)), (G4(16, 2), G6(16, 2, 2)), (G4(32, 4), G6(32, 2, 1)),
        (G4(64, 4), G6(16, 2, 1))],
    10: [(G4(32, 4), G6(8, 2, 4)), (G4(16, 2), G6(16, 2, 2)), (G4(32, 2), G6(8, 2, 2)),
         (G4(16, 1), G6(16, 2, 1))],
    7: [(G4(64, 4), G6(16, 2, 4)), (G4(32, 2), G6(16, 2, 2)), (G4(16, 2), G6(16, 2, 1)),
        (G4(32, 4), G6(32, 2, 1))],
    9: [(G4(32, 4), G6(16, 2, 4)), (G4(32, 2), G6(8, 2, 4)), (G4(16, 2), G6(16, 2, 2)),
        (G4(32, 2), G6(8, 2, 2))],
    12: [(G4(16, 4), G6(8, 2, 16)), (G4(16, 8), G6(8, 2, 8)), (G4(32, 4), G6(16, 2, 8)),
         (G4(8, 4), G6(8, 2, 24))],
    16: [(G4(16, 4), G6(8, 2, 16)), (G4(16, 8), G6(8, 2, 8)), (G4(8, 4), G6(8, 2, 32)),
         (G4(8, 2), G6(8, 3, 16))],
    **{m: [(G4(16, 4), G6(8, 2, 16))] for m in (11, 13, 14, 15)},
    20: [(G4(16, 4), G6(8, 2, 16)), (G4(8, 4), G6(8, 2, 32)), (G4(16, 8), G6(4, 2, 16))],
    24: [(G4(8, 4), G6(4, 2, 16)), (G4(8, 8), G6(4, 2, 32)), (G4(4, 4), G6(2, 2, 32))],
    32: [(G4(8, 4), G6(4, 2, 16)), (G4(8, 8), G6(4, 2, 32)), (G4(4, 4), G6(2, 2, 32))],
}


def expansions_first(ocp, X_l, U_l, xref_l, lam_l, mu, mov_l=None):
    """K4's first design (one thread per (stage, scenario)) on CUDA inputs:
    the arguments and results of expansions.expansions_fused."""
    expansions.check_lanes(ocp, X_l, U_l, xref_l, lam_l, mu, mov_l)
    return expansions.launch(ocp, X_l, U_l, xref_l, lam_l, mu, mov_l,
                             cuda_build.load_first(ocp.m), first=True)


def rollout_alpha_first(ocp, x0_l, X_l, U_l, kff_l, Kfb_l, alpha):
    """K6's first design (one thread per scenario) on CUDA inputs: the
    arguments and results of rollout.rollout_alpha_lanes."""
    rollout.check_rollout(ocp, x0_l, X_l, U_l, kff_l, Kfb_l, alpha)
    return rollout.rollout_launch(ocp, x0_l, X_l, U_l, kff_l, Kfb_l, alpha,
                                  cuda_build.load_first(ocp.m), first=True)


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
    return 32768 if m <= 6 else 16384 if m <= cuda_build.MEGA_MAX_ROBOTS else 4096


def problem(m: int):
    """The problem the sweep times at m: SCENARIOS[m] (obstacle_scenario_3
    at N=100 for one robot, N=10 otherwise) or, past the registry,
    scenarios/robot_counts.py's at N=10; and its name."""
    from nmpc_tpu_torch.scenarios import get, robot_counts

    if m in SCENARIOS:
        return get(SCENARIOS[m]).make(**({} if m == 1 else {"N": 10})), SCENARIOS[m]
    return robot_counts.make(m, N=10), robot_counts.name(m)


def inputs(m: int, seed: int = 0) -> dict:
    """Stage inputs of `problem(m)` on the card at batch_size(m): starts
    jittered by 0.05 N(0, 1), stage states 0.3 N(0, 1) about the start,
    controls 0.05 N(0, 1), duals |0.5 N(0, 1)| (zero on the masked rows), mu
    in {10, 100}; K4's arguments (`k4`) and expansions there (`exp`), K3's
    gains on them, K5's arguments (`k5`, without the alphas) and K6's (`k6`:
    one alpha of the solver's grid per scenario)."""
    from nmpc_tpu_torch.ocp import problem as P
    from nmpc_tpu_torch.ops.expansions import expansions_fused
    from nmpc_tpu_torch.parallel import batch_ocp
    from nmpc_tpu_torch.solver.alilqr import ALILQRConfig
    from nmpc_tpu_torch.solver.alilqr_batched import _mov_lanes

    base = problem(m)[0]
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
    k4 = (X_l, U_l, xref_l, lam_l, mu, mov_l)
    exp = expansions_fused(ob, *k4)
    kff_l, Kfb_l, _ = riccati.riccati_lanes(exp)
    k5 = (X_l[0].contiguous(), X_l, U_l, kff_l, Kfb_l, xref_l, lam_l, mu)
    grid = torch.tensor(ALILQRConfig().alphas, device=dev)
    alpha = grid[torch.arange(B, device=dev) % len(grid)].contiguous()
    k6 = (X_l[0].contiguous(), X_l, U_l, kff_l, Kfb_l, alpha)
    return {"ocp": ob, "k4": k4, "exp": exp, "k5": k5, "k6": k6, "mov": mov_l}


KERNEL_NAMES = {"expansions": "K4", "riccati": "K3", "linesearch_costs": "K5",
                "rollout_alpha": "K6"}


def staged_ptxas(report: str) -> dict:
    """{'K3': 'N registers, ...', 'K4': ...} of staged.cu's `-Xptxas -v`
    report: each kernel's frame, registers and shared memory."""
    lines, out = report.splitlines(), {}
    for i, line in enumerate(lines):
        if "Compiling entry function" not in line:
            continue
        name = next((k for key, k in KERNEL_NAMES.items() if key in line), None)
        if name:
            out[name] = "; ".join(re.sub(r"^\s*ptxas info\s*:\s*", "", x).strip()
                                  for x in lines[i + 2:i + 4])
    return out


def _launches(d: dict, alphas) -> dict:
    """{kernel: launch(lib, first)} at the inputs d of `inputs`."""
    ob, exp, k5, mov = d["ocp"], d["exp"], d["k5"], d["mov"]
    return {"K3": lambda lib, first=False: riccati.launch(exp, 1e-6, lib, first),
            "K5": lambda lib, first=False: rollout.costs_launch(ob, *k5, alphas, mov, lib, first),
            "K4": lambda lib, first=False: expansions.launch(ob, *d["k4"], lib, first),
            "K6": lambda lib, first=False: rollout.rollout_launch(ob, *d["k6"], lib, first)}


def sweep(m, libs: list, alphas, kernels=("K3", "K5")) -> tuple:
    """({(kernel, variant): [ms, ms]}, {variant: output entries that differ
    from the first design, or past sixteen robots and at a stage shape from
    variant 0}) at inputs(m) (a stage shape m: K3 on kernel_check.k3_inputs
    at SHAPE_B, SHAPE_N); libs: the variants' libraries, in candidate
    order."""
    from nmpc_tpu_torch.ops import kernel_check
    from nmpc_tpu_torch.tools.exp_mega_phases import time_in_turns

    if isinstance(m, tuple):
        gen = torch.Generator(device="cuda").manual_seed(sum(m))
        exp = kernel_check.k3_inputs(*m, SHAPE_B, SHAPE_N, gen)
        launch = {"K3": lambda lib, first=False: riccati.launch(exp, 1e-6, lib, first)}
    else:
        launch = _launches(inputs(m), alphas)
    runs, ref = {}, 0
    if isinstance(m, int) and m <= cuda_build.MEGA_MAX_ROBOTS:
        first, ref = cuda_build.load_first(m), "first"
        runs = {(k, "first"): functools.partial(launch[k], first, True) for k in kernels}
    for i, lib in enumerate(libs):
        for k in kernels:
            runs[k, i] = functools.partial(launch[k], lib)
    outs = {k: f() for k, f in runs.items()}
    tup = lambda o: o if isinstance(o, tuple) else (o,)  # noqa: E731
    differ = {}
    for (kern, v), o in outs.items():
        differ[v] = differ.get(v, 0) + sum(int((a != b).sum())
                                           for a, b in zip(tup(o), tup(outs[kern, ref])))
    del outs
    order = list(runs) + list(runs)[::-1]
    repeated = {k: functools.partial(_repeat, f) for k, f in runs.items()}
    return {k: [t / REPEAT for t in v]
            for k, v in time_in_turns(repeated, order, 1).items()}, differ


def _repeat(fn):
    for _ in range(REPEAT):
        fn()


def main(argv=None) -> int:
    from nmpc_tpu_torch.solver.alilqr import ALILQRConfig
    from nmpc_tpu_torch.tools.exp_mega_phases import summarize
    from nmpc_tpu_torch.tools.roofline import card, require_card

    require_card("staged_launch")
    args = sys.argv[1:] if argv is None else argv
    families = [a for a in args if a in ("k35", "k46", "k3")] or ["k35", "k46"]
    args = [a for a in args if a not in ("k35", "k46", "k3")]
    robots = ([tuple(map(int, a.split("x"))) if "x" in a else int(a) for a in args[0].split(",")]
              if args else sorted(CANDIDATES))
    if any(isinstance(m, tuple) for m in robots) and families != ["k3"]:
        raise SystemExit("staged_launch: a stage shape NxNU takes the k3 family alone")
    alphas = (0.0,) + tuple(ALILQRConfig().alphas)
    k3_cands = {**CANDIDATES3, **{m: shape_candidates(m) for m in robots if isinstance(m, tuple)}}

    def variant(m, fam, i):
        if fam == "k3":
            g = k3_cands[m][i]
            shape = ST.k3_dims(m)
            lib = cuda_build.load_k3_shape(*shape, g=g)
            info = cuda_build.k3_shape_build_info[shape if g == ST.k3_geometry(shape)
                                                  else (shape, g)]
            return lib, info["ptxas"]
        if fam == "k35":
            k3, k5 = CANDIDATES[m][i]
            return cuda_build.load_staged_variant(m, k3=k3, k5=k5)
        k4, k6 = CANDIDATES46[m][i]
        return cuda_build.load_staged_variant(m, k4=k4, k6=k6)

    cands = {"k35": CANDIDATES, "k46": CANDIDATES46,
             "k3": {m: [(g,) for g in v] for m, v in k3_cands.items()}}
    keys = [(m, fam, i) for m in robots for fam in families for i in range(len(cands[fam][m]))]
    with ThreadPoolExecutor(max_workers=len(keys) + len(robots)) as pool:
        built = {key: pool.submit(variant, *key) for key in keys}
        firsts = [pool.submit(cuda_build.load_first, m) for m in robots
                  if isinstance(m, int) and m <= cuda_build.MEGA_MAX_ROBOTS]
        built = {key: f.result() for key, f in built.items()}
        for f in firsts:
            f.result()
    print(f"{torch.cuda.get_device_name(0)} [{card()}]")
    for m in robots:
        if m in cuda_build.first_build_info:
            print(f"m={m} first design ptxas "
                  f"{staged_ptxas(cuda_build.first_build_info[m]['ptxas'])}")
        for fam in families:
            kernels = {"k35": ("K3", "K5"), "k46": ("K4", "K6"), "k3": ("K3",)}[fam]
            for i, geoms in enumerate(cands[fam][m]):
                if fam == "k3":
                    lay = ST.k3_layout(m, geoms[0])
                    what = (f"K3 {geoms[0]} {lay['smem_bytes']} B shared, {lay['blocks_per_sm']} "
                            f"blocks/SM by shared memory and threads")
                elif fam == "k35":
                    lay = ST.k3_layout(m, geoms[0])
                    what = (f"K3 {geoms[0]} {lay['smem_bytes']} B shared, {lay['warps_per_sm']} "
                            f"warps/SM by shared memory; K5 {geoms[1]}")
                else:
                    lay4 = ST.k4_layout(m, ST.k4_rows(m, m > 1, 6 if m == 1 else 0, 0), 120,
                                        geoms[0])
                    lay6 = ST.k6_layout(m, geoms[1])
                    what = (f"K4 {geoms[0]} {lay4['smem_bytes']} B shared, {lay4['warps_per_sm']} "
                            f"warps/SM; K6 {geoms[1]} {lay6['smem_bytes']} B shared, "
                            f"{lay6['warps_per_sm']} warps/SM")
                report = built[m, fam, i][1]
                ptx = ({"K3": "; ".join(x.strip() for x in report.splitlines()
                                        if "registers" in x or "stack frame" in x)}
                       if fam == "k3" else
                       {k: v for k, v in staged_ptxas(report).items() if k in kernels})
                print(f"m={m} {fam} variant {i}: {what}; ptxas {ptx}")
            times, differ = sweep(m, [built[m, fam, i][0] for i in range(len(cands[fam][m]))],
                                  alphas, kernels)
            first = isinstance(m, int) and m <= cuda_build.MEGA_MAX_ROBOTS
            what = (f"{problem(m)[1]} B={batch_size(m)}" if isinstance(m, int) else
                    f"kernel_check.k3_inputs B={SHAPE_B} N={SHAPE_N}")
            print(f"m={m} {what} {fam}: output entries that differ from "
                  f"{'the first design' if first else 'variant 0'}: "
                  + ", ".join(f"variant {v} {d}" for v, d in differ.items()))
            rows = sorted(summarize(times).items(), key=lambda kv: (kv[0][0], kv[1][1]))
            for (k, v), (lo, med) in rows:
                print(f"  {k} variant {v}: min {lo:.3f} ms, median {med:.3f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
