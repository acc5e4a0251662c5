"""Smoke run of the PyTorch + CUDA port (nmpc_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's two batched routes through the hand-written CUDA kernels,
after building them from nmpc_tpu_torch/csrc and holding each against its
plain PyTorch version on the card:

* the main path, the megakernel route: the six_robot_antipodal swap at
  N=10, B=32768 jittered starts, with the benchmark's ALILQRConfig(n_outer=6,
  n_inner=12, tol_con=1e-3, ls="adaptive"), through K1 (fused inner solve)
  and K2 (AL multiplier update), both one warp per scenario on the standard
  layout (csrc/inner_warp.cuh); K1's first design (one thread per scenario,
  csrc/megasolve.cuh) is timed beside it through the tools library;
* the staged route, through K4 (expansions), K3 (Riccati sweep), K5
  (line-search merits) and K6 (accepted rollout), at full width on three
  paths (each runs a tile of scenarios per block with its rows in shared
  memory, csrc/staged_tiles.cuh for K3 and K5,
  csrc/expansions_rollout_tiles.cuh for K4 and K6; their first designs, one
  thread per (stage and) scenario, are held against them bit for bit and
  timed beside them through tools/staged_launch.py): (a) the main-path
  batch with mega=False; (b) a family-H fleet, obstacle_scenario_3 (six
  static obstacles) at its registry horizon N=100, B=32768, which K1
  refuses; (c) B=4096 per-robot subproblems of one decentralized six-robot
  round (one robot, five moving obstacles, N=30); then line-search grids
  longer than one launch takes (K1's parameter block, K5's slices);
* the roofline path (nmpc_tpu_torch/tools), through K7 (FMA-peak probe), K8
  (K1 with one phase ablated at a fixed count) and K9 (K1 with the
  structured or the dense expansion layout), then the bound of every kernel.

Phases:

  0 device and toolchain            7 path (a), staged, launch counts checked
  1 build every kernel              8 path (b), obstacles, routing checked
  2 K2 vs plain, B=32768            9 path (c), moving obstacles
  3 K1 vs plain, B=1024, and a     10 K3-K6 vs plain at the shapes of (a)-(c);
    ragged B=33                       K3-K6 vs their first designs there
                                   11 staged timings (solves, also with K3's
                                      and K5's or K4's and K6's first designs,
                                      in turns; K3-K6 vs plain and vs their
                                      first designs in turns; a solve's split)
  4 main path at B=32768, no       12 K7: FMA peak over C chains, vs plain
    layout copies                     bit for bit (also at the timed shape)
  5 first 64 scenarios re-solved   13 K8: 'full' with the early exit is K1's
    on the CPU                        first design, vs plain and vs K1; the
  6 timings: solves/s, also with      undamped modes beside f64 at phase 3's
    K1's first design, in turns;      inputs; each mode vs plain; the six
    K1 vs its first design in         modes timed in turns; full vs plain at
    turns at two states, and vs       its timed shape
    plain there; K1 per outer      14 K9 vs plain (also at the timed shape),
    step; K2; the first design's      both layouts timed in turns; the
    layout copies                     roofline of K1-K9
                                   15 line-search grids of 33 and 64 alphas:
                                      K1 vs plain, the megakernel route; K5
                                      vs its first design; a staged solve

Phases 5, 7, 8 and 9 re-solve the first scenarios with the plain path on the
CPU. Any failed check raises, so the exit code is non-zero. Without a CUDA
card, or without the package beside this script, it fails before printing
any result. Output: one line per phase; before the last line, the kernels'
JSON record and the nvidia-smi name/power-limit line; last line
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import os
import re
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH_B = 32768
K1_B = 1024
CROSS_B = 64
OBS_CROSS_B = 32
MOV_B = 4096
# K1's `-Xptxas -v` line at each m as recorded in PERF.md (regs, stack, spill
# stores, spill loads, static shared bytes: none, its dynamic shared memory
# holds one slot of nmpc_k1_slot_bytes() a warp and then the parameter
# block): K1 does not change when the staged kernels or the tools are changed
K1_PTXAS = {1: (64, 32, 80, 72, 0), 2: (64, 72, 228, 220, 0),
            3: (80, 16, 40, 40, 0), 4: (96, 0, 0, 0, 0),
            5: (96, 0, 0, 0, 0), 6: (96, 8, 16, 12, 0),
            8: (128, 8, 16, 12, 0), 10: (168, 0, 0, 0, 0)}
# K1's first design (one thread per scenario) at m=6, as PERF.md records its
# line: the tools part `K8 full, early exit` is that design
FIRST_K1_PTXAS = (255, 4880, 156, 200)
# K2's first design (one thread per scenario on the lane-major layout, since
# removed) at the main path's shape, ms per launch as PERF.md records it
# (NVIDIA H100 80GB HBM3, 700.00 W)
FIRST_K2_MS = 0.844
# K3-K6's lines at each m as recorded in PERF.md (the tile designs, with a
# fifth entry: the dynamic shared bytes of a block, K4's and K5's at the main
# path's rows without obstacles and a parameter block with no alphas (K4) or
# nine (K5))
STAGED_PTXAS = {
    1: {"K3": (95, 0, 0, 0, 44032), "K4": (53, 32, 0, 0, 18000), "K5": (40, 56, 0, 0, 6768),
        "K6": (76, 56, 0, 0, 6656)},
    2: {"K3": (168, 0, 0, 0, 163840), "K4": (72, 32, 0, 0, 20096), "K5": (44, 80, 0, 0, 16816),
        "K6": (76, 80, 0, 0, 19456)},
    3: {"K3": (56, 0, 0, 0, 75152), "K4": (96, 32, 0, 0, 33472), "K5": (52, 104, 0, 0, 30176),
        "K6": (72, 32, 0, 0, 19968)},
    4: {"K3": (80, 0, 0, 0, 63296), "K4": (128, 32, 0, 0, 49152), "K5": (61, 128, 0, 0, 23584),
        "K6": (72, 32, 0, 0, 32768)},
    5: {"K3": (96, 0, 0, 0, 100128), "K4": (128, 32, 0, 0, 67136), "K5": (63, 152, 0, 0, 33632),
        "K6": (96, 32, 0, 0, 48640)},
    6: {"K3": (128, 0, 0, 0, 143184), "K4": (167, 32, 0, 0, 87408), "K5": (86, 176, 0, 0, 90272),
        "K6": (76, 176, 0, 0, 66048)},
    8: {"K3": (204, 0, 0, 0, 227328), "K4": (254, 32, 0, 0, 67696), "K5": (81, 224, 0, 0, 73744),
        "K6": (114, 32, 0, 0, 57344)},
    10: {"K3": (255, 0, 0, 0, 220800), "K4": (255, 32, 0, 0, 96096), "K5": (101, 400, 0, 0, 54736),
         "K6": (123, 32, 0, 0, 43520)},
}
# the staged kernels' first designs (csrc/staged_first.cu), as PERF.md
# records them
FIRST_STAGED_PTXAS = {1: {"K3": (32, 176, 0, 0), "K4": (64, 80, 0, 0), "K5": (72, 0, 0, 0),
                          "K6": (32, 56, 0, 0)},
                      6: {"K3": (255, 4384, 0, 0), "K4": (108, 1728, 0, 0), "K5": (72, 176, 0, 0),
                          "K6": (72, 176, 0, 0)}}
KERNELS = {"inner_solve": "K1", "al_update": "K2", "riccati": "K3", "expansions": "K4",
           "linesearch_costs": "K5", "rollout_alpha": "K6"}


def log(msg: str) -> None:
    print(msg, flush=True)


def sh(cmd: list[str]) -> str:
    return subprocess.run(cmd, capture_output=True, text=True, check=True).stdout.strip()


def ptxas(text: str, part: str = "?") -> dict:
    """{'K1': (regs, stack, spill stores, spill loads), ...} of a build log.
    The tools' entries: K7's per chain count C ('K7 C=8'), a K1 variant by
    the name of the part of csrc/tools.cu that built it."""
    out, name, frame = {}, "?", (0, 0, 0)
    for line in text.splitlines():
        if "Compiling entry function" in line:
            c = re.search(r"fma_peak_kernelILi(\d+)E", line)
            name = (f"K7 C={c[1]}" if c else part if "variant_kernel" in line
                    else next((k for key, k in KERNELS.items() if key in line), "?"))
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            frame = tuple(int(g) for g in m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[name] = (int(m[1]), *frame)
    return dict(sorted(out.items()))


def ptxas_smem(text: str) -> dict:
    """{'K1': static shared bytes, ...} of a solver library's build log."""
    out, name = {}, "?"
    for line in text.splitlines():
        if "Compiling entry function" in line:
            name = next((k for key, k in KERNELS.items() if key in line), "?")
        m = re.search(r"Used \d+ registers.*?(\d+) bytes smem", line)
        if m:
            out[name] = int(m[1])
    return out


def ptxas_summary(text: str, part: str = "?") -> str:
    """'K1 N regs, stack S B, spill stores a B, loads b B; K2 ...'"""
    return "; ".join(f"{k} {r} regs, stack {st} B, spill stores {a} B, loads {b} B"
                     for k, (r, st, a, b) in ptxas(text, part).items())


def cross_check(tag: str, res, sub, cfg, n: int, u_share: float = 0.75) -> None:
    """Re-solve the first n scenarios of a solve on the card (res) with the
    plain path on the CPU (sub: their problem on the CPU) and hold the two to
    phase 5's criteria. Per scenario the full solve is path-sensitive in f32:
    a near-tied alpha pick or a stop rule that flips moves a scenario to
    another point of a flat cost valley (the plain path alone, solving the
    same scenarios at two batch sizes, differs by 1e-3 in cost on some). So
    most scenarios must agree at the tight tolerances (U on a share u_share),
    and the batch at the aggregate ones of tests/test_batched_solver.py."""
    from nmpc_tpu_torch.solver import solve_batched

    ref = solve_batched(sub, cfg=cfg)
    gc, gu = res.cost[:n].cpu(), res.U[:n].cpu()
    rel = (gc - ref.cost).abs() / ref.cost.abs()
    du = (gu - ref.U).abs().amax(dim=(1, 2))
    n_cost, n_u = int((rel <= 1e-4).sum()), int((du <= 5e-3).sum())
    conv_g = float(res.converged[:n].float().mean())
    conv_r = float(ref.converged.float().mean())
    mean_ratio = float(gc.mean() / ref.cost.mean())
    log(f"{tag}: first {n} scenarios re-solved by the plain path on the CPU: cost within "
        f"rtol 1e-4 on {n_cost}/{n} (max rel {float(rel.max()):.3e}), U within atol 5e-3 on "
        f"{n_u}/{n} (max {float(du.max()):.3e}); converged {conv_g:.4f} vs {conv_r:.4f}; "
        f"mean cost ratio {mean_ratio:.6f}")
    assert n_cost >= 0.9 * n, n_cost
    assert n_u >= u_share * n, n_u
    assert abs(conv_g - conv_r) <= 1.0 / n + 1e-9, (conv_g, conv_r)
    assert abs(mean_ratio - 1.0) <= 1e-3, mean_ratio


def timed(fn):
    """(result, seconds) of fn() on the host clock, ending in a synchronize."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def once(fn):
    """(fn(), its ms on CUDA events): one call, no warm-up."""
    from nmpc_tpu_torch.utils.timing import cuda_ms

    out = []
    ms = cuda_ms(lambda: out.append(fn()), 1, warmup=0)
    return out[0], ms


def hold_solve(tag: str, got, want, allow: float = 0.0) -> tuple:
    """K1-like results (Xs, U, cost, iters) against their plain version at
    phase 3's tolerances, per scenario: cost rtol 1e-4, U and Xs atol 5e-3.
    Past a few iterations an f32 tie in the line search can send a scenario
    another way, so a share `allow` of the scenarios may miss them (0: none).
    Returns (scenarios missed, max cost rel, max |dU|, max |dXs|), the
    maxima over every scenario."""
    import torch

    rel = (got[2] - want[2]).abs() / want[2].abs().clamp(min=1e-30)
    du = (got[1] - want[1]).abs().amax(dim=(1, 2))
    dx = (got[0] - want[0]).abs().amax(dim=(1, 2))
    missed = int((~((rel <= 1e-4) & (du <= 5e-3) & (dx <= 5e-3))).sum())
    assert all(torch.isfinite(t).all() for t in got[:3]), tag
    assert missed <= allow * rel.numel(), (tag, missed, rel.numel())
    return missed, float(rel.max()), float(du.max()), float(dx.max())


def summary(res) -> str:
    import torch

    return (f"converged {float(res.converged.float().mean()):.4f}, viol p99 "
            f"{float(torch.quantile(res.viol, 0.99)):.3e}, max {float(res.viol.max()):.3e}, "
            f"mean inner iters {float(res.inner_iters.float().mean()):.2f}, "
            f"mean cost {float(res.cost.mean()):.4f}")


def check_staged(tag: str, counts: dict, res, cfg) -> None:
    """The staged route ran: no K1 or K2 launch; one K4, K3 and K5 launch per
    inner iteration run; K6 once more (the initial rollout); finite output."""
    import torch

    it = counts["riccati_lanes"]
    assert counts["inner_solve_fused"] == 0 and counts["al_update_lanes"] == 0, (tag, counts)
    assert counts["expansions_fused"] == it and counts["linesearch_costs_lanes"] == it, (tag, counts)
    assert counts["rollout_alpha_lanes"] == it + 1, (tag, counts)
    # every scenario counts each iteration run while it is not done, so the
    # largest count is at most the number run, at most n_inner per outer step
    assert int(res.inner_iters.max()) <= it <= cfg.n_inner * int(res.outer_iters.max()), (tag, counts)
    assert it > 0, (tag, counts)
    for name in ("X", "U", "cost", "viol", "lam"):
        assert torch.isfinite(getattr(res, name)).all(), (tag, name)


def decentralized_round(make_ocp, dev, gen, B: int):
    """B per-robot subproblems of one decentralized six-robot round, the
    shape of nmpc_tpu/parallel/decentralized.py::robot_template(30, 0.1, 0.3,
    6): one unicycle, N=30, T=0.1, dmin=0.3, its five neighbours' exchanged
    plans as moving obstacles ([B, N, 5, 2], one schedule per scenario). The
    robot crosses a unit circle to the antipodal point; each neighbour starts
    0.5-1.5 from it and drives straight at 0.2 m/s in a random direction."""
    import dataclasses

    import torch

    N, T, n_mov = 30, 0.1, 5
    kw = dict(device=dev)
    tpl = make_ocp(m=1, N=N, T=T, x0=[0.0, 0.0, 0.0], x_goal=[0.0, 0.0, 0.0], dmin=0.3,
                   mov_obs=torch.zeros((N, n_mov, 2), **kw), device=dev)
    u = lambda *shape: torch.rand(shape, generator=gen, **kw)  # noqa: E731
    ang = 2 * torch.pi * u(B)
    start = torch.stack([torch.cos(ang), torch.sin(ang), ang + torch.pi], -1)
    goal = torch.stack([-torch.cos(ang), -torch.sin(ang), ang + torch.pi], -1)
    r, psi, phi = 0.5 + u(B, n_mov), 2 * torch.pi * u(B, n_mov), 2 * torch.pi * u(B, n_mov)
    p0 = start[:, None, :2] + r[..., None] * torch.stack([torch.cos(psi), torch.sin(psi)], -1)
    vel = 0.2 * torch.stack([torch.cos(phi), torch.sin(phi)], -1)
    steps = T * torch.arange(1, N + 1, **kw).float()
    plans = p0[:, None] + steps[None, :, None, None] * vel[:, None]   # [B, N, 5, 2]
    return dataclasses.replace(tpl, x0=start, xref=goal[:, None].expand(B, N, 3).contiguous(),
                               mov_obs=plans.contiguous())


def staged_vs_plain(ocp_b, X, U, lam, mu, cfg):
    """K4, K3, K5 and K6 on the card against their plain versions at the
    state (X [B, N+1, n], U, lam, mu): K4 on it, K3 on K4's output, K5 (the
    merits of cfg's alpha grid) and K6 (one alpha of the grid per scenario)
    on K3's gains, by the rule of nmpc_tpu_torch/ops/kernel_check.py: the
    CPU tests' tolerances, relative to each scenario's largest magnitude,
    plus for K3 and K6 the scenario's f32 spread; a rollout that diverges (a
    position or control beyond 10 in f64) is left out and counted. Returns
    (verdicts, {kernel: (kernel call, plain call)})."""
    import torch

    from nmpc_tpu_torch.ops.cuda_build import lane
    from nmpc_tpu_torch.ops.kernel_check import staged_vs_plain as check
    from nmpc_tpu_torch.solver.alilqr_batched import _mov_lanes

    B = ocp_b.x0.shape[0]
    grid = torch.tensor(cfg.alphas, device=mu.device)
    alpha = grid[torch.arange(B, device=mu.device) % len(cfg.alphas)]
    return check(ocp_b, lane(X[:, :-1]), lane(U), lane(ocp_b.xref), lane(lam), mu.contiguous(),
                 _mov_lanes(ocp_b, B), (0.0,) + tuple(cfg.alphas), alpha, cfg.reg)


def first_vs_tiles(ocp_b, X, U, lam, mu, cfg):
    """The tile designs against their first designs (tools/staged_launch.py)
    on the same inputs: K4 at the state, K3 on K4's output, K5 (the merits
    of cfg's grid) and K6 (one alpha of the grid per scenario, as
    staged_vs_plain draws it) on K3's gains. Returns ({'K3': units that
    differ, 'K4': ..., 'K5': ..., 'K6': ...}, {'K3': (tile call,
    first-design call), ...}); a unit is a scenario (K5: a merit)."""
    import torch

    from nmpc_tpu_torch.ops import rollout as R
    from nmpc_tpu_torch.ops.cuda_build import lane
    from nmpc_tpu_torch.ops.expansions import expansions_fused
    from nmpc_tpu_torch.ops.riccati import riccati_lanes
    from nmpc_tpu_torch.solver.alilqr_batched import _mov_lanes
    from nmpc_tpu_torch.tools import staged_launch as SL

    B = ocp_b.x0.shape[0]
    X_l, U_l, xref_l, lam_l = lane(X[:, :-1]), lane(U), lane(ocp_b.xref), lane(lam)
    mov_l, alphas = _mov_lanes(ocp_b, B), (0.0,) + tuple(cfg.alphas)
    k4 = (X_l, U_l, xref_l, lam_l, mu.contiguous(), mov_l)
    calls = {"K4": (lambda: expansions_fused(ocp_b, *k4), lambda: SL.expansions_first(ocp_b, *k4))}
    new4, first4 = calls["K4"][0](), calls["K4"][1]()
    calls["K3"] = (lambda: riccati_lanes(new4, cfg.reg), lambda: SL.riccati_first(new4, cfg.reg))
    new3, first3 = calls["K3"][0](), calls["K3"][1]()
    args = (X_l[0].contiguous(), X_l, U_l, new3[0], new3[1], xref_l, lam_l, mu.contiguous())
    calls["K5"] = (lambda: R.linesearch_costs_lanes(ocp_b, *args, alphas, mov_l),
                   lambda: SL.linesearch_costs_first(ocp_b, *args, alphas, mov_l))
    new5, first5 = calls["K5"][0](), calls["K5"][1]()
    grid = torch.tensor(cfg.alphas, device=mu.device)
    alpha = grid[torch.arange(B, device=mu.device) % len(cfg.alphas)]
    k6 = (*args[:5], alpha)
    calls["K6"] = (lambda: R.rollout_alpha_lanes(ocp_b, *k6),
                   lambda: SL.rollout_alpha_first(ocp_b, *k6))
    new6, first6 = calls["K6"][0](), calls["K6"][1]()
    differ = lambda a, b: ~((a == b) | (a.isnan() & b.isnan()))  # noqa: E731

    def units(new, first):   # scenarios with any output entry that differs
        off = torch.zeros(B, dtype=torch.bool, device=mu.device)
        for a, b in zip(new, first):
            off |= differ(a, b).reshape(-1, B).any(dim=0)
        return int(off.sum())

    return {"K3": units(new3, first3), "K4": units(new4, first4), "K5": int(differ(new5, first5).sum()),
            "K6": units(new6, first6)}, calls


def main() -> int:
    t_start = time.perf_counter()
    import torch

    # ---- phase 0: device ------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    import nmpc_tpu_torch

    pkg_dir = os.path.dirname(os.path.dirname(os.path.abspath(nmpc_tpu_torch.__file__)))
    if pkg_dir != HERE:
        raise RuntimeError(f"nmpc_tpu_torch imported from {pkg_dir}, not beside this script")
    from nmpc_tpu_torch.ocp import problem as P
    from nmpc_tpu_torch.ops import cuda_build, megasolve, staged_tiles
    from nmpc_tpu_torch.ops import rollout as rollout_ops
    from nmpc_tpu_torch.ops.cuda_build import lane, std
    from nmpc_tpu_torch.parallel import batch_ocp
    from nmpc_tpu_torch.solver import alilqr_batched as AB
    from nmpc_tpu_torch.scenarios import get
    from nmpc_tpu_torch.solver import ALILQRConfig, solve_batched
    from nmpc_tpu_torch.tools import exp_blocked_expansions as K9
    from nmpc_tpu_torch.tools import exp_mega_phases as K8
    from nmpc_tpu_torch.tools import roofline as RL
    from nmpc_tpu_torch.utils.timing import cuda_ms

    assert "jax" not in sys.modules and "nmpc_tpu" not in sys.modules
    dev = torch.device("cuda", 0)
    smi = sh(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"]).splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    try:
        import triton  # noqa: F401

        triton_v = triton.__version__
    except ImportError:
        triton_v = "not importable"
    nvcc_v = sh([cuda_build.nvcc(), "--version"]).splitlines()[-1]
    card = f"[{smi}]"
    log(f"phase 0 device: {kind} x{torch.cuda.device_count()} {card}; torch "
        f"{torch.__version__} CUDA {torch.version.cuda}; nvcc {nvcc_v}; triton {triton_v}; "
        f"python {sys.version.split()[0]}")

    # ---- phase 1: build every kernel instantiation ------------------------
    t0 = time.perf_counter()
    cuda_build.load_all()
    wall = time.perf_counter() - t0
    per_m = ", ".join(f"m={m} {cuda_build.build_info[m]['seconds']:.1f}s"
                      for m in cuda_build.ROBOT_COUNTS)
    tools = cuda_build.tools_build_info[cuda_build.BENCH_ROBOTS]
    log(f"phase 1 build: {len(cuda_build.ROBOT_COUNTS)} solver libraries, the tools library "
        f"(m={cuda_build.BENCH_ROBOTS}, {len(cuda_build.TOOLS_PARTS)} parts) and the staged "
        f"kernels' first designs (m in {cuda_build.FIRST_ROBOTS}) in {wall:.1f}s wall "
        f"(parallel nvcc; {per_m}; tools {tools['seconds']:.1f}s)")
    lines = {}
    for m in cuda_build.ROBOT_COUNTS:   # every line logged before any is held
        text = cuda_build.build_info[m]["ptxas"]
        got = ptxas(text)
        k1 = (*got.get("K1", ()), ptxas_smem(text).get("K1", 0))
        lib = cuda_build.load(m)
        slot = lib.nmpc_k1_slot_bytes()
        # K1's dynamic shared memory: a slot a warp, then the parameter block
        # at the main path's eight alphas
        k1_prm = 4 * rollout_ops._P(3 * m, 2 * m, len(ALILQRConfig().alphas)).size
        block = k1[-1] + k1_prm + megasolve.K1_WARPS * slot
        k3g = cuda_build.k3_geometry(lib)
        k4g = cuda_build.k4_geometry(lib, staged_tiles.k4_rows(m, m > 1, 0, 0),
                                     rollout_ops._P(3 * m, 2 * m, 0).size)
        k5g = cuda_build.k5_geometry(lib, staged_tiles.k5_rows(m, m > 1, 0, 0),
                                     rollout_ops._P(3 * m, 2 * m, 9).size)
        k6g = cuda_build.k6_geometry(lib)
        staged = {"K3": (*got.get("K3", ()), k3g["smem_bytes"]),
                  "K4": (*got.get("K4", ()), k4g["smem_bytes"]),
                  "K5": (*got.get("K5", ()), k5g["smem_bytes"]),
                  "K6": (*got.get("K6", ()), k6g["smem_bytes"])}
        lines[m] = (got, k1, block, staged)
        log(f"  ptxas m={m}: {ptxas_summary(text)}; K1 static shared {k1[-1]} B + "
            f"{megasolve.K1_WARPS} warps x {slot} B slot + parameters {k1_prm} B = {block} B a block; "
            f"K3 {staged['K3']}, K4 {staged['K4']}, K5 {staged['K5']}, K6 {staged['K6']} (regs, "
            f"stack, spills, dynamic shared B a block; K3 S={k3g['S']} D={k3g['D']} T={k3g['T']} "
            f"P={k3g['P']} spill={k3g['spill']}, K4 S={k4g['S']} W={k4g['W']}, K5 S={k5g['S']} "
            f"D={k5g['D']}, K6 S={k6g['S']} D={k6g['D']} T={k6g['T']}) (K1 as recorded in "
            f"PERF.md: {'yes' if k1 == K1_PTXAS[m] else 'NO'}; K3-K6: "
            f"{'yes' if staged == STAGED_PTXAS[m] else 'NO'})")
    for m in cuda_build.FIRST_ROBOTS:
        first = ptxas(cuda_build.first_build_info[m]["ptxas"])
        log(f"  ptxas first designs m={m}: " + ", ".join(f"{k} {v}" for k, v in first.items())
            + f" (as recorded in PERF.md: {'yes' if first == FIRST_STAGED_PTXAS[m] else 'NO'})")
    for m in cuda_build.FIRST_ROBOTS:
        first = ptxas(cuda_build.first_build_info[m]["ptxas"])
        assert first == FIRST_STAGED_PTXAS[m], (m, first)
    for m, (got, k1, block, staged) in lines.items():
        assert k1 == K1_PTXAS[m], (m, k1)
        assert staged == STAGED_PTXAS[m], (m, staged)
        assert set(got) == set(KERNELS.values()), got
        assert block <= 227 * 1024, (m, block)   # the H100's shared memory per block
        assert all(v[-1] <= 227 * 1024 for v in staged.values()), (m, staged)
    tool_lines = {}
    for part, text in tools["ptxas"].items():
        log(f"  ptxas tools m={cuda_build.BENCH_ROBOTS} {part}: {ptxas_summary(text, part)}")
        tool_lines.update(ptxas(text, part))
    want_names = {f"K7 C={c}" for c in (4, 8, 16, 32)} | set(cuda_build.TOOLS_PARTS[1:])
    assert set(tool_lines) == want_names, sorted(tool_lines)
    log(f"  K8 'full, early exit' has K1's first design's recorded line {FIRST_K1_PTXAS}: "
        f"{'yes' if tool_lines['K8 full, early exit'] == FIRST_K1_PTXAS else 'NO'}")
    assert tool_lines["K8 full, early exit"] == FIRST_K1_PTXAS, tool_lines["K8 full, early exit"]

    gen = torch.Generator(device=dev).manual_seed(0)
    base = get("six_robot_antipodal").make(N=10, device=dev)
    bench_cfg = ALILQRConfig(n_outer=6, n_inner=12, tol_con=1e-3, ls="adaptive")

    def batch(ocp, B, spread=0.1, g=gen):
        noise = torch.randn((B, ocp.nx), generator=g, device=dev)
        return batch_ocp(ocp, ocp.x0[None] + spread * noise)

    def warm_state(ocp, B, g=gen):
        """A mid-solve warm state: small controls, nonnegative duals (zero
        on the masked stage-0 rows), mu across the whole schedule."""
        U = 0.05 * torch.randn((B, ocp.N, ocp.nu), generator=g, device=dev)
        lam = 0.5 * torch.randn((B, ocp.N, ocp.n_con), generator=g, device=dev).abs()
        lam = lam * (P.constraint_mask(ocp) > 0)
        mu = torch.tensor([10.0, 100.0, 1e3, 1e4], device=dev)[
            torch.randint(0, 4, (B,), generator=g, device=dev)]
        return U, lam, mu

    # ---- phase 2: K2 against its plain version ----------------------------
    ob = batch(base, BENCH_B)
    Xs = base.x0[None, None] + 0.3 * torch.randn(
        (BENCH_B, base.N, base.nx), generator=gen, device=dev)
    U, lam, mu = warm_state(base, BENCH_B)
    got = megasolve.al_update_lanes(ob, Xs, U, lam, mu, bench_cfg.lam_max)
    torch.cuda.synchronize()
    want = megasolve.al_update_plain(ob, Xs, U, lam, mu, bench_cfg.lam_max)
    k2_err = max(float((got[0] - want[0]).abs().max()), float((got[1] - want[1]).abs().max()))
    torch.testing.assert_close(got[0], want[0], rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(got[1], want[1], rtol=1e-6, atol=1e-6)
    log(f"phase 2 K2 vs plain: six_robot_antipodal N=10 B={BENCH_B}, max |err| "
        f"{k2_err:.3e} (lam, viol; rtol 1e-6 atol 1e-6) ok")

    # ---- phase 3: K1 against its plain version ----------------------------
    # n_inner=4: within the first iterations both follow the same path; past
    # them, f32 rounding can flip a near-tied alpha or the rel < tol_cost
    # stop and move a scenario along a flat valley of the merit
    # (B=33: a ragged last block of K1's warps, drawn from a generator of its
    # own so that the later phases draw the inputs they drew before it)
    g33 = torch.Generator(device=dev).manual_seed(33)
    for name, ls, Bk in (("six_robot_antipodal", "adaptive", K1_B),
                         ("six_robot_antipodal", "cascade", K1_B),
                         ("two_robot_swap", "adaptive", K1_B),
                         ("six_robot_antipodal", "cascade", 33)):
        ocp = get(name).make(N=10, device=dev)
        g = g33 if Bk == 33 else gen
        obk = batch(ocp, Bk, g=g)
        U, lam, mu = warm_state(ocp, Bk, g=g)
        cfg = ALILQRConfig(n_outer=6, n_inner=4, tol_con=1e-3, ls=ls)
        got = megasolve.inner_solve_fused(obk, obk.x0, obk.xref, lam, mu, U, cfg)
        torch.cuda.synchronize()
        want = megasolve.inner_solve_plain(obk, obk.x0, obk.xref, lam, mu, U, cfg)
        rel = ((got[2] - want[2]).abs() / want[2].abs())
        du = (got[1] - want[1]).abs().amax(dim=(1, 2))
        same_it = int((got[3] == want[3]).sum())
        w = int(du.argmax())
        log(f"phase 3 K1 vs plain: {name} N=10 B={Bk} ls={ls} n_inner=4: cost rel max "
            f"{float(rel.max()):.3e}, U max |err| {float(du.max()):.3e} (worst scenario {w}: "
            f"cost {float(got[2][w]):.6f} vs {float(want[2][w]):.6f}, iters "
            f"{int(got[3][w])} vs {int(want[3][w])}), iteration counts equal {same_it}/{Bk}")
        torch.testing.assert_close(got[2], want[2], rtol=1e-4, atol=0.0)
        torch.testing.assert_close(got[1], want[1], rtol=0.0, atol=5e-3)
        assert same_it >= 0.99 * Bk, same_it
        assert torch.isfinite(got[0]).all()
        if name == "six_robot_antipodal" and ls == "adaptive":
            k1_case = (obk, U, lam, mu, cfg, got)   # phase 13's first-design check

    # ---- phase 4: the main path ------------------------------------------
    ob = batch(base, BENCH_B)
    # the layout copies K1's and K2's wrappers make: counted (none expected)
    copies = {"lane": 0, "std": 0}

    def counting(name, fn):
        def wrapped(t):
            copies[name] += 1
            return fn(t)
        return wrapped

    real_copies = megasolve.lane, megasolve.std
    megasolve.lane, megasolve.std = counting("lane", megasolve.lane), counting("std", megasolve.std)
    torch.cuda.synchronize()
    cuda_build.reset_launch_counts()
    try:
        res = solve_batched(ob, cfg=bench_cfg)
        torch.cuda.synchronize()
    finally:
        megasolve.lane, megasolve.std = real_copies
    counts = dict(cuda_build.launch_counts)
    steps = int(res.outer_iters.max())
    assert counts["inner_solve_fused"] == steps, (counts, steps)
    assert counts["al_update_lanes"] == steps, (counts, steps)
    assert sum(counts.values()) == 2 * steps, counts  # no staged kernel on this route
    assert torch.isfinite(res.cost).all() and torch.isfinite(res.viol).all()
    assert torch.isfinite(res.X).all() and torch.isfinite(res.U).all()
    conv = float(res.converged.float().mean())
    viol_p99 = float(torch.quantile(res.viol, 0.99))
    mean_inner = float(res.inner_iters.float().mean())
    log(f"phase 4 main path: six_robot_antipodal N=10 B={BENCH_B} {bench_cfg.ls}: launches "
        f"{counts} over {steps} outer steps; converged {conv:.4f}, viol p99 {viol_p99:.3e}, "
        f"max {float(res.viol.max()):.3e}, mean inner iters {mean_inner:.2f}, "
        f"mean cost {float(res.cost.mean()):.4f}; layout copies in K1's and K2's wrappers {copies}")
    assert copies == {"lane": 0, "std": 0}, copies
    # at least the first design's level on such a batch (converged 0.9990,
    # viol p99 5.3e-4)
    assert conv >= 0.995 and viol_p99 <= 1e-3, (conv, viol_p99)

    # ---- phase 5: CPU cross-check of the first scenarios ------------------
    cpu = torch.device("cpu")
    cross_check("phase 5 CPU cross-check", res, batch_ocp(base.to(cpu), ob.x0[:CROSS_B].to(cpu)),
                bench_cfg, CROSS_B)

    # ---- phase 6: timings ---------------------------------------------------
    times = []
    for i in range(4):  # the first run is the warm-up
        obi = batch(base, BENCH_B)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = solve_batched(obi, cfg=bench_cfg)
        torch.cuda.synchronize()
        if i:
            times.append(time.perf_counter() - t0)
    assert torch.isfinite(r.cost).all()
    sps = [BENCH_B / t for t in times]
    log(f"phase 6 solve_batched B={BENCH_B}: {', '.join(f'{t * 1e3:.1f}' for t in times)} ms "
        f"-> median {statistics.median(sps):.1f} solves/s, best {max(sps):.1f} solves/s {card}")

    # the main path with K1 and, in turns, with K1's first design in its place
    # (the tools library's `K8 full, early exit`, layout copies included; K2
    # is the same in both), on phase 4's batch
    def first_design(ocp_b, x0, xref, lam, mu, U, cfg):
        return K8.phase_ablation(ocp_b, x0, xref, lam, mu, U, cfg, "full", cfg.n_inner,
                                 early_exit=True)

    def solve_with(**kernels):
        """solve_batched on phase 4's batch with the solver's K1 / K2 calls
        replaced; returns its ms on the host clock."""
        real = {k: getattr(AB, k) for k in kernels}
        for k, fn in kernels.items():
            setattr(AB, k, fn)
        try:
            return timed(lambda: solve_batched(ob, cfg=bench_cfg))[1] * 1e3
        finally:
            for k, fn in real.items():
                setattr(AB, k, fn)

    designs = {"K1": megasolve.inner_solve_fused, "first design": first_design}
    solve_ms = {k: [] for k in designs}
    for k in ("K1", "first design", "first design", "K1") * 2:
        solve_ms[k].append(solve_with(inner_solve_fused=designs[k]))
    solve_ms = {k: v[1:] for k, v in solve_ms.items()}   # the first of each: the warm-up
    sps_ab = {k: BENCH_B / (statistics.median(v) / 1e3) for k, v in solve_ms.items()}
    log(f"phase 6 main path on phase 4's batch, in turns (K1, first, first, K1, twice; the "
        f"first of each a warm-up): K1 "
        + ", ".join(f"{t:.1f}" for t in solve_ms["K1"]) + " ms, K1's first design "
        + ", ".join(f"{t:.1f}" for t in solve_ms["first design"]) + f" ms -> medians "
        f"{sps_ab['K1']:.1f} and {sps_ab['first design']:.1f} solves/s {card}")
    assert sps_ab["K1"] >= sps_ab["first design"], sps_ab

    # K1 per outer step, K2, and the rest of one main-path solve (CUDA events
    # around each wrapper)
    steps_ms = {"inner_solve_fused": [], "al_update_lanes": []}

    def evented(name):
        fn = getattr(megasolve, name)

        def wrapped(*args):
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            out = fn(*args)
            e1.record()
            steps_ms[name].append((e0, e1))
            return out
        return wrapped

    wall_ms = solve_with(**{k: evented(k) for k in steps_ms})
    steps_ms = {k: [e0.elapsed_time(e1) for e0, e1 in v] for k, v in steps_ms.items()}
    k1_tot, k2_tot = sum(steps_ms["inner_solve_fused"]), sum(steps_ms["al_update_lanes"])
    log(f"phase 6 one main-path solve: {wall_ms:.1f} ms; K1 per outer step "
        + ", ".join(f"{t:.2f}" for t in steps_ms["inner_solve_fused"]) + f" ms (sum {k1_tot:.1f}, "
        f"{100 * k1_tot / wall_ms:.1f}%), K2 {k2_tot:.2f} ms ({100 * k2_tot / wall_ms:.2f}%), the "
        f"rest {wall_ms - k1_tot - k2_tot:.1f} ms {card}")

    # K1 and its first design in turns at two states: the first outer step's
    # inputs (zero warm controls and duals, mu_init: every scenario runs all
    # iterations) and phase 4's converged state. At both the plain version is
    # timed, counts the work the bounds of phase 14 take (iterations run,
    # line-search candidates), and holds K1 and its first design at phase 3's
    # tolerances. Over 12 iterations f32 alone parts a share of the scenarios
    # (an alpha or a stop decided by a tie, U then differs by up to ~1): the
    # plain version against itself with its inputs moved by about an ulp
    # shows how many. K1 may miss on at most twice as many plus 0.1%, and its
    # cost must agree within rtol 1e-4 on all but 0.1%.
    kw = dict(dtype=torch.float32, device=dev)
    U0 = torch.zeros((BENCH_B, base.N, base.nu), **kw)
    lam0 = torch.zeros((BENCH_B, base.N, base.n_con), **kw)
    mu0 = torch.full((BENCH_B,), bench_cfg.mu_init, **kw)
    g_ulp = torch.Generator(device=dev).manual_seed(23)   # leaves `gen`'s draws as they were
    k1_at, k1_work = {}, {}
    for state, (lam_s, mu_s, U_s) in (("first step", (lam0, mu0, U0)),
                                      ("converged", (res.lam, res.mu, res.U))):
        runs = {k: functools.partial(fn, ob, ob.x0, ob.xref, lam_s, mu_s, U_s, bench_cfg)
                for k, fn in designs.items()}
        t = K8.time_in_turns(runs, ("K1", "first design", "first design", "K1"), 2)
        k1_at[state] = {k: statistics.median(v) for k, v in t.items()}
        got = runs["K1"]()
        it = RL.k1_executed(got[3], bench_cfg.n_inner).float()
        log(f"phase 6 K1 at B={BENCH_B}, {state} ({float(it.mean()):.2f} iterations run per "
            f"scenario), in turns, median of 4: {k1_at[state]['K1']:.2f} ms, first design "
            f"{k1_at[state]['first design']:.2f} ms ({k1_at[state]['first design'] / k1_at[state]['K1']:.2f}x) {card}")
        assert k1_at[state]["K1"] <= k1_at[state]["first design"], (state, k1_at[state])
        cand = torch.zeros(BENCH_B, dtype=torch.int64, device=dev)
        want, plain_ms = once(lambda: megasolve.inner_solve_plain(
            ob, ob.x0, ob.xref, lam_s, mu_s, U_s, bench_cfg, candidates=cand))
        ulp = lambda t: t * (1.0 + 2.0 ** -23 * torch.randn(t.shape, generator=g_ulp, device=dev))  # noqa: E731
        spread = megasolve.inner_solve_plain(ob, ulp(ob.x0), ob.xref, lam_s, mu_s, ulp(U_s), bench_cfg)
        n_spread = hold_solve("plain vs itself", spread, want, allow=1.0)[0]
        n_first = hold_solve("first design vs plain", runs["first design"](), want, allow=1.0)[0]
        missed, rel, du, dx = hold_solve(f"K1 vs plain, {state}", got, want,
                                         allow=1e-3 + 2 * n_spread / BENCH_B)
        cost_missed = int(((got[2] - want[2]).abs() > 1e-4 * want[2].abs()).sum())
        same = int((got[3] == want[3]).sum())
        run = RL.k1_executed(want[3], bench_cfg.n_inner)
        k1_work[state] = (int(run.sum()), int(cand.sum()))
        log(f"phase 6 K1 vs plain at B={BENCH_B}, {state}: outside cost rtol 1e-4 / U, Xs atol "
            f"5e-3 on {missed}/{BENCH_B} scenarios (cost alone on {cost_missed}; the plain "
            f"version against itself with inputs moved by 2^-23: {n_spread}; K1's first design: "
            f"{n_first}); over all, cost rel max {rel:.3e}, U max |err| {du:.3e}, Xs max |err| "
            f"{dx:.3e}; iteration counts equal {same}/{BENCH_B}; plain {plain_ms:.1f} ms, "
            f"{float(run.float().mean()):.2f} iterations and {float(cand.float().mean()):.2f} "
            f"line-search candidates needed per scenario")
        assert cost_missed <= 1e-3 * BENCH_B, (state, cost_missed)
        if state == "first step":
            k1_plain_ms, k1_err = plain_ms, du
        del want, got, spread
    k1_ms = k1_at["first step"]["K1"]
    Xs1, U1 = res.X[:, :-1].contiguous(), res.U
    k2_ms = cuda_ms(lambda: megasolve.al_update_lanes(ob, Xs1, U1, res.lam, res.mu, bench_cfg.lam_max), 20)
    k2_plain_ms = cuda_ms(lambda: megasolve.al_update_plain(ob, Xs1, U1, res.lam, res.mu, bench_cfg.lam_max), 20)
    # the layout copies the first design's wrappers made per outer step: K1's
    # inputs and outputs, K2's inputs and output
    N, nc = base.N, base.n_con
    Xs_l, Uo_l = torch.empty((N, base.nx, BENCH_B), **kw), torch.empty((N, base.nu, BENCH_B), **kw)
    lam_l, lam_o = torch.empty((N, nc, BENCH_B), **kw), torch.empty((BENCH_B, N, nc), **kw)

    def first_copies():
        for t in (ob.x0, ob.xref, res.lam, res.U, Xs1, res.U, res.lam):
            lane(t)
        std(Xs_l), std(Uo_l)
        lam_o.copy_(lam_l.movedim(-1, 0))

    copy_ms = cuda_ms(first_copies, 20)
    log(f"phase 6 kernels at B={BENCH_B}: K1 {k1_ms:.2f} ms vs plain {k1_plain_ms:.2f} ms; "
        f"K2 {k2_ms:.3f} ms vs plain {k2_plain_ms:.3f} ms (first design {FIRST_K2_MS} ms as "
        f"recorded); layout copies per outer step: the first design's wrappers {copy_ms:.3f} ms, "
        f"K1's and K2's none (phase 4) {card}")

    # ---- phase 7: path (a), the main-path batch on the staged route ----------
    staged_cfg = dataclasses.replace(bench_cfg, mega=False)
    cuda_build.reset_launch_counts()
    res_a, t_a = timed(lambda: solve_batched(ob, cfg=staged_cfg))
    counts_a = dict(cuda_build.launch_counts)
    check_staged("phase 7 path (a)", counts_a, res_a, staged_cfg)
    log(f"phase 7 path (a): six_robot_antipodal N=10 B={BENCH_B}, bench config with "
        f"mega=False: launches {counts_a}; {summary(res_a)}; {t_a * 1e3:.1f} ms")
    log(f"  main path on the same batch (phase 4): {summary(res)}")
    assert float(res_a.converged.float().mean()) >= 0.8  # gross-fault floor
    cross_check("  path (a)", res_a, batch_ocp(base.to(cpu), ob.x0[:CROSS_B].to(cpu)),
                staged_cfg, CROSS_B)

    # ---- phase 8: path (b), a family-H fleet: six static obstacles ---------
    obs_base = get("obstacle_scenario_3").make(device=dev)      # registry horizon N=100
    obs_cfg = ALILQRConfig(n_outer=12, n_inner=25, tol_con=1e-3)  # mega=True: K1 refuses n_obs
    ob_b = batch(obs_base, BENCH_B, spread=0.05)
    cuda_build.reset_launch_counts()
    res_b, t_b = timed(lambda: solve_batched(ob_b, cfg=obs_cfg))
    counts_b = dict(cuda_build.launch_counts)
    check_staged("phase 8 path (b)", counts_b, res_b, obs_cfg)
    log(f"phase 8 path (b): obstacle_scenario_3 N={obs_base.N} B={BENCH_B}, n_obs="
        f"{obs_base.n_obs}, default mega=True: launches {counts_b}; {summary(res_b)}; "
        f"{t_b * 1e3:.1f} ms")
    assert float(res_b.converged.float().mean()) >= 0.9
    # U on 60%: the slalom's turn rates are flat in the cost, so U agrees to
    # 5e-3 on only ~69% of scenarios even between the plain path in f32 and
    # in f64 (22/32 on a CPU batch like this one, costs within 1.6e-5)
    cross_check("  path (b)", res_b, batch_ocp(obs_base.to(cpu), ob_b.x0[:OBS_CROSS_B].to(cpu)),
                obs_cfg, OBS_CROSS_B, u_share=0.6)

    # ---- phase 9: path (c), one decentralized six-robot round ---------------
    mov_cfg = ALILQRConfig(n_outer=6, n_inner=12, tol_con=1e-4)
    ob_c = decentralized_round(P.make_ocp, dev, gen, MOV_B)
    cuda_build.reset_launch_counts()
    res_c, t_c = timed(lambda: solve_batched(ob_c, cfg=mov_cfg))
    counts_c = dict(cuda_build.launch_counts)
    check_staged("phase 9 path (c)", counts_c, res_c, mov_cfg)
    log(f"phase 9 path (c): one robot, {ob_c.n_mov} moving obstacles (per-scenario "
        f"schedules), N={ob_c.N} B={MOV_B}: launches {counts_c}; {summary(res_c)}; "
        f"{t_c * 1e3:.1f} ms")
    sub_c = dataclasses.replace(ob_c, x0=ob_c.x0[:OBS_CROSS_B], xref=ob_c.xref[:OBS_CROSS_B],
                                mov_obs=ob_c.mov_obs[:OBS_CROSS_B]).to(cpu)
    cross_check("  path (c)", res_c, sub_c, mov_cfg, OBS_CROSS_B)

    # ---- phase 10: K3-K6 against their plain versions -----------------------
    # at each path's shape, on its last iterate: (i) with fresh multipliers of
    # the CPU tests' kind (|N(0, 0.5)|, zero on the masked rows, mu in {10,
    # 100}), where every unit must pass at the CPU tolerance without the f32
    # spread; (ii) with the solve's own multipliers and penalty weights (mu
    # up to 1e4), where K3 and K6 may need it. At most 1% of the units may
    # diverge at either.
    errs, ms, turns_ab = {}, {}, {}
    for tag, ocp_b, r, cfg in (("a", ob, res_a, staged_cfg), ("b", ob_b, res_b, obs_cfg),
                               ("c", ob_c, res_c, mov_cfg)):
        Bp = ocp_b.x0.shape[0]
        lam_i = 0.5 * torch.randn(r.lam.shape, generator=gen, device=dev).abs()
        lam_i = lam_i * (P.constraint_mask(ocp_b) > 0)
        mu_i = torch.tensor([10.0, 100.0], device=dev)[
            torch.randint(0, 2, (Bp,), generator=gen, device=dev)]
        for state, lam_s, mu_s in (("i", lam_i, mu_i), ("ii", r.lam, r.mu)):
            v, calls = staged_vs_plain(ocp_b, r.X, r.U, lam_s, mu_s, cfg)
            off, ab = first_vs_tiles(ocp_b, r.X, r.U, lam_s, mu_s, cfg)
            if state == "ii" and tag in ("a", "b"):
                ms[tag] = {k: (cuda_ms(c[0], 5), cuda_ms(c[1], 1)) for k, c in calls.items()}
                turns_ab[tag] = ab
            log(f"phase 10 K3-K6 vs plain at path ({tag}) B={Bp} N={ocp_b.N}, state ({state}): "
                + "; ".join(f"{k} max |err| {x.err:.3e} (relative to max(1, |plain|) "
                            f"{x.rel:.3e}) on the held units, diverged "
                            f"{x.n_diverged}/{x.units}, passing by the f32 spread alone "
                            f"{x.n_widened}/{x.units}"
                            for k, x in v.items())
                + f"; against the first designs, units that differ: K3 {off['K3']}/{Bp}, K4 "
                f"{off['K4']}/{Bp}, K5 {off['K5']}/{Bp * (len(cfg.alphas) + 1)}, K6 "
                f"{off['K6']}/{Bp} (bit for bit: 0) ok")
            assert off == {"K3": 0, "K4": 0, "K5": 0, "K6": 0}, (tag, state, off)
            for k, x in v.items():
                errs[k] = max(errs.get(k, 0.0), x.err)
                assert x.n_diverged <= 0.01 * x.units, (tag, state, k, x.n_diverged)
                assert state == "ii" or x.n_widened == 0, (tag, state, k, x.n_widened)

    # ---- phase 11: staged timings --------------------------------------------
    turns = []
    for cfg in (bench_cfg, staged_cfg, staged_cfg, bench_cfg):
        turns.append(timed(lambda: solve_batched(ob, cfg=cfg))[1] * 1e3)
    log(f"phase 11 solve at B={BENCH_B} on the main-path batch, in turns: megakernel "
        f"{turns[0]:.1f}, {turns[3]:.1f} ms; staged {turns[1]:.1f}, {turns[2]:.1f} ms {card}")
    log(f"phase 11 staged solves (phases 7-9, one run each): (a) {t_a * 1e3:.1f} ms, (b) "
        f"{t_b * 1e3:.1f} ms, (c) {t_c * 1e3:.1f} ms {card}")
    for tag in ("a", "b"):
        log(f"phase 11 kernels at path ({tag}): " + "; ".join(
            f"{k} {v[0]:.3f} ms vs plain {v[1]:.3f} ms" for k, v in ms[tag].items()) + f" {card}")
    # K3-K6 against their first designs, in turns (tile, first, first, tile,
    # twice; median of 4) at phase 10's state (ii) of (a) and (b), each with
    # its share of the bound (tools/roofline.py::kernel_work on these
    # shapes); then the staged solves of (a) and (b) with K3's and K5's or
    # K4's and K6's first designs swapped in
    from nmpc_tpu_torch.tools import staged_launch as SL

    first_ms = {}
    for tag, ocp_p, cfg_p in (("a", base, staged_cfg), ("b", obs_base, obs_cfg)):
        shares = {}
        for k, (new_call, first_call) in turns_ab[tag].items():
            t = K8.time_in_turns({"tile": new_call, "first": first_call},
                                 ("tile", "first", "first", "tile"), 2)
            first_ms[tag, k] = {d: statistics.median(v) for d, v in t.items()}
            b_ms = RL.bound(*RL.kernel_work(k, ocp_p, BENCH_B, n_alphas=len(cfg_p.alphas) + 1))[0]
            shares[k] = (b_ms, b_ms / ms[tag][k][0], b_ms / first_ms[tag, k]["first"])
        log(f"phase 11 K3-K6 at path ({tag}), in turns, median of 4: " + "; ".join(
            f"{k} {v['tile']:.3f} ms, first design {v['first']:.3f} ms "
            f"({v['first'] / v['tile']:.2f}x)" for k in ("K3", "K4", "K5", "K6")
            for v in [first_ms[tag, k]]) + "; mean of 5 back-to-back launches against the bound: "
            + "; ".join(f"{k} {ms[tag][k][0]:.3f} ms, bound {sh[0]:.4f} ms, {100 * sh[1]:.1f}% "
                        f"(first design in turns {100 * sh[2]:.1f}%)" for k, sh in shares.items())
            + f" {card}")
        for k in ("K3", "K5"):
            assert first_ms[tag, k]["tile"] < first_ms[tag, k]["first"], (tag, k, first_ms[tag, k])

    firsts = {"K3/K5": {(AB, "riccati_lanes"): SL.riccati_first,
                        (rollout_ops, "linesearch_costs_lanes"): SL.linesearch_costs_first},
              "K4/K6": {(AB, "expansions_fused"): SL.expansions_first,
                        (rollout_ops, "rollout_alpha_lanes"): SL.rollout_alpha_first}}

    def staged_solve(ocp_b, cfg, swap):
        """solve_batched's ms with the tile designs or, swap naming a pair of
        `firsts`, that pair's first designs."""
        real = {key: getattr(*key) for key in firsts.get(swap, {})}
        for (mod, name), fn in firsts.get(swap, {}).items():
            setattr(mod, name, fn)
        try:
            return timed(lambda: solve_batched(ocp_b, cfg=cfg))[1] * 1e3
        finally:
            for (mod, name), fn in real.items():
                setattr(mod, name, fn)

    for tag, ocp_b, cfg in (("a", ob, staged_cfg), ("b", ob_b, obs_cfg)):
        sol = {"tiles": [], "K3/K5": [], "K4/K6": []}
        for swap in ("tiles", "K4/K6", "K3/K5", "K3/K5", "K4/K6", "tiles"):
            sol[swap].append(staged_solve(ocp_b, cfg, swap))
        log(f"phase 11 staged solve of path ({tag}) in turns (tiles, K4/K6 first, K3/K5 first, "
            f"K3/K5 first, K4/K6 first, tiles): the tile designs "
            f"{', '.join(f'{t:.1f}' for t in sol['tiles'])} ms; with K3's and K5's first designs "
            f"{', '.join(f'{t:.1f}' for t in sol['K3/K5'])} ms; with K4's and K6's first designs "
            f"{', '.join(f'{t:.1f}' for t in sol['K4/K6'])} ms {card}")

    # where one staged solve's time goes: CUDA events around each staged
    # kernel's wrapper (the wrappers' own host work included), the rest is
    # the host loop and the plain PyTorch ops between the kernels
    owners = {"expansions_fused": AB, "riccati_lanes": AB, "linesearch_costs_lanes": rollout_ops,
              "rollout_alpha_lanes": rollout_ops}
    names = {"expansions_fused": "K4", "riccati_lanes": "K3", "linesearch_costs_lanes": "K5",
             "rollout_alpha_lanes": "K6"}
    for tag, ocp_b, cfg in (("a", ob, staged_cfg), ("b", ob_b, obs_cfg)):
        events = {k: [] for k in owners}
        real = {k: getattr(mod, k) for k, mod in owners.items()}

        def evented_staged(name):
            def wrapped(*args):
                e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                e0.record()
                out = real[name](*args)
                e1.record()
                events[name].append((e0, e1))
                return out
            return wrapped

        for k, mod in owners.items():
            setattr(mod, k, evented_staged(k))
        try:
            wall = timed(lambda: solve_batched(ocp_b, cfg=cfg))[1] * 1e3
        finally:
            for k, mod in owners.items():
                setattr(mod, k, real[k])
        spent = {names[k]: sum(e0.elapsed_time(e1) for e0, e1 in v) for k, v in events.items()}
        rest = wall - sum(spent.values())
        log(f"phase 11 one staged solve of path ({tag}): {wall:.1f} ms; " + ", ".join(
            f"{k} {t:.1f} ms ({100 * t / wall:.1f}%)" for k, t in spent.items())
            + f"; the rest {rest:.1f} ms ({100 * rest / wall:.1f}%) {card}")

    # ---- phase 12: K7, the attainable FMA rate ------------------------------
    # bit for bit: each f64 step of the plain chain is exact for these
    # constants near 1 and rounds once to f32, as the FMA does
    a7, b7, R7 = RL.FMA_A, RL.FMA_B, RL.FMA_STEPS
    for C in RL.FMA_CHAINS:
        x0 = 1.0 + 1e-3 * torch.rand((C, 1000), generator=gen, device=dev)
        got = RL.fma_peak(x0, a7, b7, 64)
        torch.cuda.synchronize()
        want = RL.fma_chain_plain(x0, a7, b7, 64)
        assert torch.equal(got, want), (C, float((got - want).abs().max()))
    log(f"phase 12 K7 vs plain: C in {RL.FMA_CHAINS}, 1000 threads, 64 steps: bit for bit")
    cuda_build.reset_launch_counts()
    peak = RL.measure_fma_peak()
    k7_launches = cuda_build.launch_counts["fma_peak"]
    best = peak["best"]
    T7 = RL.FMA_THREADS
    x7 = RL.fma_inputs(best["chains"], T7, dev)
    # the card's clocks and power under the probe: ~1 s of it enqueued, sampled, then waited for
    for _ in range(max(1, int(1000 / (16 * best["ms"])))):
        RL.fma_peak(x7, a7, b7, 16 * R7)
    clocks = sh(["nvidia-smi", "--query-gpu=clocks.sm,power.draw,power.limit",
                 "--format=csv,noheader"]).splitlines()[0]
    torch.cuda.synchronize()
    # kernel and plain version at the timed shape, bit for bit
    want7, k7_plain_ms = once(lambda: RL.fma_chain_plain(x7, a7, b7, R7))
    got7 = RL.fma_peak(x7, a7, b7, R7)
    k7_err = float((got7 - want7).abs().max())
    assert torch.equal(got7, want7), k7_err
    log(f"phase 12 K7 vs plain at the timed shape (C={best['chains']}, {T7} threads, {R7} "
        f"steps): bit for bit")
    del want7, got7
    log(f"phase 12 K7 sweep, {T7} threads x C chains x {R7} steps: " + ", ".join(
        f"C={c} {peak[c]['tflops']:.2f} TFLOP/s ({peak[c]['ms']:.3f} ms)" for c in RL.FMA_CHAINS)
        + f"; best C={best['chains']}: {best['tflops']:.2f} TFLOP/s = "
        f"{best['tflops'] / RL.PUBLISHED_FMA_TFLOPS:.3f} of the published "
        f"{RL.PUBLISHED_FMA_TFLOPS:.0f}; plain {k7_plain_ms:.1f} ms; launches {k7_launches}; "
        f"under load: clocks.sm, power.draw, power.limit = {clocks} {card}")
    # above 1.05x the compiler removed work; below 0.5x the probe is latency-bound
    assert 0.5 * RL.PUBLISHED_FMA_TFLOPS <= best["tflops"] <= 1.05 * RL.PUBLISHED_FMA_TFLOPS, best

    # ---- phase 13: K8, K1 with one phase ablated -------------------------------
    # `full` with the early exit is K1's first design (phase 1: its recorded
    # line): held against plain at phase 3's tolerances, and K1 against it
    obk, U3, lam3, mu3, cfg3, k1_out = k1_case
    full_ee = K8.phase_ablation(obk, obk.x0, obk.xref, lam3, mu3, U3, cfg3, "full", cfg3.n_inner,
                                early_exit=True)
    want = megasolve.inner_solve_plain(obk, obk.x0, obk.xref, lam3, mu3, U3, cfg3)
    _, rel_f, du_f, _ = hold_solve("K1's first design vs plain", full_ee, want, allow=0.01)
    _, rel_k, du_k, _ = hold_solve("K1 vs its first design", k1_out, full_ee, allow=0.01)
    same_f = int((full_ee[3] == want[3]).sum())
    same_k = int((k1_out[3] == full_ee[3]).sum())
    assert min(same_f, same_k) >= 0.99 * K1_B, (same_f, same_k)
    log(f"phase 13 K8 'full' with the early exit (K1's first design) on phase 3's batch "
        f"(six_robot_antipodal N=10 B={K1_B} adaptive, n_inner={cfg3.n_inner}): vs plain cost "
        f"rel max {rel_f:.3e}, U max |err| {du_f:.3e}, iteration counts equal {same_f}/{K1_B}; "
        f"K1 vs it cost rel max {rel_k:.3e}, U max |err| {du_k:.3e}, iteration counts equal "
        f"{same_k}/{K1_B}")
    # at phase 3's inputs (mu up to 1e4) the undamped alpha = 1 steps of the
    # modes without a line search diverge on many scenarios: there the plain
    # version in f32 parts from itself in f64 as far as from the kernel. The
    # kernel may miss the f64 run on no more scenarios than the plain f32
    # version does, plus 2% of those not diverged
    for mode in ("inv_solve", "no_ls"):
        got = K8.phase_ablation(obk, obk.x0, obk.xref, lam3, mu3, U3, cfg3, mode, 4)
        w = K8.f64_witness(obk, obk.x0, obk.xref, lam3, mu3, U3, cfg3, mode, 4, got)
        held = w["scenarios"] - w["diverged"]
        log(f"phase 13 K8 {mode} at phase 3's inputs (B={K1_B}, 4 fixed iterations, mu up to "
            f"1e4): diverged in f64 {w['diverged']}/{w['scenarios']}; on the other {held}, U "
            f"parts from f64 by > 5e-3 on {w['plain_missed']} (plain f32) and "
            f"{w['kernel_missed']} (kernel); max |dU| kernel vs plain {w['kernel_vs_plain']:.3e}, "
            f"plain vs f64 {w['plain_vs_f64']:.3e}, kernel vs f64 {w['kernel_vs_f64']:.3e}")
        assert w["kernel_missed"] <= w["plain_missed"] + max(2, 0.02 * held), w
    # each mode at the ablation's own inputs (lam 0, mu 10, U 0) on phase 3's
    # starts, where no scenario diverges: Xs, U and cost at phase 3's
    # tolerances (every mode but full returns the initial merit as its cost,
    # so Xs and U are what test the ablated sweep)
    lam0k, mu10k, U0k = torch.zeros_like(lam3), torch.full_like(mu3, 10.0), torch.zeros_like(U3)
    for mode in K8.MODES:
        got = K8.phase_ablation(obk, obk.x0, obk.xref, lam0k, mu10k, U0k, cfg3, mode, 4)
        torch.cuda.synchronize()
        want = K8.phase_ablation_plain(obk, obk.x0, obk.xref, lam0k, mu10k, U0k, cfg3, mode, 4)
        _, rel, du, dx = hold_solve(f"K8 {mode}", got, want)
        log(f"phase 13 K8 {mode} vs plain, B={K1_B}, 4 fixed iterations, lam 0, mu 10, U 0: cost "
            f"rel max {rel:.3e}, U max |err| {du:.3e}, Xs max |err| {dx:.3e}, mean cost "
            f"{float(got[2].mean()):.4f}")
        assert (got[3] == 4).all()
    kw = dict(dtype=torch.float32, device=dev)
    n72 = bench_cfg.n_outer * bench_cfg.n_inner
    lam8 = torch.zeros((BENCH_B, base.N, base.n_con), **kw)
    mu8 = torch.full((BENCH_B,), 10.0, **kw)
    U8 = torch.zeros((BENCH_B, base.N, base.nu), **kw)
    cuda_build.reset_launch_counts()
    summ8 = K8.summarize(K8.time_modes(ob, lam8, mu8, U8, bench_cfg, n72))
    k8_launches = cuda_build.launch_counts["phase_ablation"]
    save8 = K8.savings(summ8)
    log(f"phase 13 K8 at B={BENCH_B}, {n72} fixed iterations, lam 0, mu 10, U 0, in turns "
        f"(3 rounds, full first and last), min / median ms: " + "; ".join(
            f"{k} {v[0]:.1f} / {v[1]:.1f}" + ("" if k == "full" else f" (saves {save8[k]:.1f}%)")
            for k, v in summ8.items())
        + f"; inv_solve against no_ls saves {save8['inv_solve vs no_ls']:.1f}%; launches "
        f"{k8_launches} {card}")
    log(f"  (K1 itself, early exit, at the main path's first outer step: {k1_ms:.2f} ms for at "
        f"most {bench_cfg.n_inner} iterations; not a ratio with the fixed-count runs)")
    # the kernels line's K8 and K9 entries: one shape and one set of inputs
    # for the check against plain, the kernel's time, the plain time and the bound
    lam9, mu9, U9 = K9.ab_inputs(ob)
    want89, k89_plain_ms = once(lambda: K8.phase_ablation_plain(ob, ob.x0, ob.xref, lam9, mu9, U9,
                                                                bench_cfg, "full", 4))
    k8_ms = cuda_ms(lambda: K8.phase_ablation(ob, ob.x0, ob.xref, lam9, mu9, U9, bench_cfg,
                                              "full", 4), 3)
    # at this batch f32 alone parts a few scenarios through line-search ties:
    # the plain version against itself with inputs moved by 2^-21 (4-8 ulp)
    # shows how many; the kernel may miss on at most 0.1% of the scenarios
    jitter = lambda t: t * (1.0 + 2.0 ** -21 * torch.randn(t.shape, generator=gen, device=dev))  # noqa: E731
    spread = K8.phase_ablation_plain(ob, jitter(ob.x0), ob.xref, lam9, mu9, jitter(U9), bench_cfg,
                                     "full", 4)
    n_spread = hold_solve("plain vs itself", spread, want89, allow=1.0)[0]
    got = K8.phase_ablation(ob, ob.x0, ob.xref, lam9, mu9, U9, bench_cfg, "full", 4)
    n8, rel, k8_err, dx = hold_solve("K8 full at the timed shape", got, want89, allow=1e-3)
    log(f"phase 13 K8 full vs plain at the timed shape (B={BENCH_B}, 4 fixed iterations, lam "
        f"|0.1 N(0,1)|, mu 10, U 0.01 N(0,1)): outside cost rtol 1e-4 / U, Xs atol 5e-3 on "
        f"{n8}/{BENCH_B} scenarios (the plain version against itself under 2^-21 input noise: "
        f"{n_spread}); over all, cost rel max {rel:.3e}, U max |err| {k8_err:.3e}, Xs max |err| "
        f"{dx:.3e}; {k8_ms:.2f} ms vs plain {k89_plain_ms:.1f} ms")
    del spread

    # ---- phase 14: K9, the expansion-layout A/B; the roofline of K1-K9 ----------
    lam9s, mu9s, U9s = K9.ab_inputs(obk)
    want = K9.expansion_ab_plain(obk, obk.x0, obk.xref, lam9s, mu9s, U9s, cfg3, 4)
    outs, small_err = {}, 0.0
    for lay in K9.LAYOUTS:
        got = K9.expansion_ab(obk, obk.x0, obk.xref, lam9s, mu9s, U9s, cfg3, lay, 4)
        outs[lay] = got
        small_err = max(small_err, hold_solve(f"K9 {lay}", got, want)[2])
    full4 = K8.phase_ablation(obk, obk.x0, obk.xref, lam9s, mu9s, U9s, cfg3, "full", 4)
    assert all(torch.equal(a, b) for a, b in zip(outs["structured"], full4))
    dU = float((outs["dense"][1] - outs["structured"][1]).abs().max())
    dc = float(((outs["dense"][2] - outs["structured"][2]).abs() / outs["structured"][2].abs()).max())
    assert dU <= 5e-3 and dc <= 1e-4, (dU, dc)
    log(f"phase 14 K9 vs plain, B={K1_B}, 4 fixed iterations, lam |0.1 N(0,1)|, mu 10, U 0.01 "
        f"N(0,1): U max |err| {small_err:.3e}; dense vs structured max |dU| {dU:.3e}, cost rel "
        f"{dc:.3e}; structured = K8 'full' bit for bit")
    cfg40 = ALILQRConfig(n_outer=1, n_inner=40, tol_con=1e-3, ls="adaptive")
    cuda_build.reset_launch_counts()
    summ9 = K8.summarize(K9.time_layouts(ob, lam9, mu9, U9, cfg40, 40))
    k9_launches = cuda_build.launch_counts["expansion_ab"]
    ab = {lay: K9.expansion_ab(ob, ob.x0, ob.xref, lam9, mu9, U9, cfg40, lay, 40) for lay in K9.LAYOUTS}
    assert all(torch.isfinite(t).all() for r in ab.values() for t in r[:3])
    log(f"phase 14 K9 at B={BENCH_B}, 40 fixed iterations, in turns (2 rounds of structured, "
        f"dense, dense, structured), min / median ms: " + "; ".join(
            f"{k} {v[0]:.1f} / {v[1]:.1f}" for k, v in summ9.items())
        + f" (dense / structured {summ9['dense'][1] / summ9['structured'][1]:.3f}); max |dU| "
        f"{float((ab['dense'][1] - ab['structured'][1]).abs().max()):.3e}, max |dcost| "
        f"{float((ab['dense'][2] - ab['structured'][2]).abs().max()):.3e}; launches {k9_launches} {card}")
    k9_ms = cuda_ms(lambda: K9.expansion_ab(ob, ob.x0, ob.xref, lam9, mu9, U9, bench_cfg,
                                            "dense", 4), 3)
    got = K9.expansion_ab(ob, ob.x0, ob.xref, lam9, mu9, U9, bench_cfg, "dense", 4)
    n9, rel, k9_err, dx = hold_solve("K9 dense at the timed shape", got, want89, allow=1e-3)
    log(f"phase 14 K9 dense vs plain at K8's timed shape and inputs: outside the tolerances on "
        f"{n9}/{BENCH_B} scenarios (f32 spread {n_spread}, phase 13); over all, cost rel max "
        f"{rel:.3e}, U max |err| {k9_err:.3e}, Xs max |err| {dx:.3e}; {k9_ms:.2f} ms")
    del want89, got

    # the roofline: times from phases 6, 11, 12-14, work counted from this run's inputs
    staged = (("riccati_lanes", "K3", "nmpc_tpu/ops/riccati_pallas.py:311"),
              ("expansions_fused", "K4", "nmpc_tpu/ops/expansions_pallas.py:212"),
              ("linesearch_costs_lanes", "K5", "nmpc_tpu/ops/rollout_pallas.py:287"),
              ("rollout_alpha_lanes", "K6", "nmpc_tpu/ops/rollout_pallas.py:360"))
    peak_flops = best["tflops"] * 1e12
    bounds = {}

    def roof(key, what, ms_, launches, work):
        flops, nbytes = work
        b_ms, by = RL.bound(flops, nbytes)
        bounds[key] = (b_ms, by)
        log(f"phase 14 roofline {what}: {ms_:.3f} ms per launch, "
            f"{'-' if launches is None else launches} launches per solve, {flops / 1e9:.3f} GFLOP, "
            f"{nbytes / 1e6:.1f} MB, bound {b_ms:.4f} ms ({by}), {100 * b_ms / ms_:.2f}% of the bound "
            f"reached; FLOPs at K7's measured peak {flops / peak_flops * 1e3:.4f} ms")

    for state, key in (("first step", "K1"), ("converged", "K1 converged")):
        executed, cand = k1_work[state]
        work = RL.kernel_work("K1", base, BENCH_B, bench_cfg, iters=executed, candidates=cand)
        roof(key, f"K1 main path ({state}; per scenario {executed / BENCH_B:.2f} iterations and "
             f"{cand / BENCH_B:.2f} candidates needed, by the plain version)",
             k1_at[state]["K1"], counts["inner_solve_fused"], work)
        roof(f"{key} first design", f"K1's first design ({state})", k1_at[state]["first design"],
             None, work)
    roof("K2", "K2 main path", k2_ms, counts["al_update_lanes"], RL.kernel_work("K2", base, BENCH_B))
    log(f"phase 14 roofline K2's first design (as recorded): {FIRST_K2_MS:.3f} ms per launch, "
        f"{100 * bounds['K2'][0] / FIRST_K2_MS:.2f}% of the bound reached")
    for tag, ocp_p, cnt, cfg_p in (("a", base, counts_a, staged_cfg), ("b", obs_base, counts_b, obs_cfg)):
        for name, k, _ in staged:
            roof(f"{k} {tag}", f"{k} path ({tag})", ms[tag][k][0], cnt[name],
                 RL.kernel_work(k, ocp_p, BENCH_B, n_alphas=len(cfg_p.alphas) + 1))
    roof("K7", f"K7 (C={best['chains']}, {R7} steps)", best["ms"], None,
         RL.kernel_work("K7", base, 0, chains=best["chains"], R=R7, threads=T7))
    for mode in K8.MODES:
        roof(f"K8 {mode}", f"K8 {mode} ({n72} iterations, median)", summ8[mode][1], None,
             RL.kernel_work("K8", base, BENCH_B, bench_cfg, iters=n72 * BENCH_B, phase=mode))
    for lay in K9.LAYOUTS:
        roof(f"K9 {lay}", f"K9 {lay} (40 iterations, median)", summ9[lay][1], None,
             RL.kernel_work("K9", base, BENCH_B, cfg40, iters=40 * BENCH_B))
    line_work = RL.kernel_work("K8", base, BENCH_B, bench_cfg, iters=4 * BENCH_B)
    roof("K8 line", "K8 full (4 iterations, lam |0.1 N|, U 0.01 N)", k8_ms, None, line_work)
    roof("K9 line", "K9 dense (the same inputs)", k9_ms, None, line_work)

    # ---- phase 15: line-search grids longer than one launch takes --------------
    # K1 keeps any number of alphas with its parameter block in dynamic
    # shared memory: the cascade (which tries every alpha) at 33 and 64 on
    # phase 3's inputs, against plain at phase 3's tolerances; the default
    # grid, then alphas below its last (a tie between two near-equal small
    # steps moves U by less than its tolerance)
    for n_al in (33, 64):
        grid = ALILQRConfig().alphas
        alphas = (grid + tuple(grid[-1] * 0.7 ** k for k in range(1, n_al)))[:n_al]
        cfg = ALILQRConfig(n_outer=6, n_inner=4, tol_con=1e-3, ls="cascade", alphas=alphas)
        got = megasolve.inner_solve_fused(obk, obk.x0, obk.xref, lam3, mu3, U3, cfg)
        torch.cuda.synchronize()
        want = megasolve.inner_solve_plain(obk, obk.x0, obk.xref, lam3, mu3, U3, cfg)
        _, rel, du, dx = hold_solve(f"K1 with {n_al} alphas", got, want)
        same_it = int((got[3] == want[3]).sum())
        assert same_it >= 0.99 * K1_B, (n_al, same_it)
        cuda_build.reset_launch_counts()
        r15 = solve_batched(obk, cfg=dataclasses.replace(cfg, n_inner=12))
        c15 = dict(cuda_build.launch_counts)
        steps15 = int(r15.outer_iters.max())
        assert c15["inner_solve_fused"] == c15["al_update_lanes"] == steps15, c15
        assert sum(c15.values()) == 2 * steps15 and torch.isfinite(r15.cost).all(), c15
        log(f"phase 15 K1 with {n_al} alphas (cascade, six_robot_antipodal N=10 B={K1_B}, "
            f"n_inner=4, phase 3's inputs) vs plain: cost rel max {rel:.3e}, U max |err| {du:.3e}, "
            f"Xs max |err| {dx:.3e}, iteration counts equal {same_it}/{K1_B}; the megakernel "
            f"route's solve at n_inner=12: {steps15} outer steps, launches {c15}, "
            f"{summary(r15)}")
    # K5 at 33 candidates on path (b)'s problem (k5_max_alphas(1) a launch),
    # bit for bit its first design, at phase 10's state (ii) of (b)
    from nmpc_tpu_torch.ops.expansions import expansions_fused
    from nmpc_tpu_torch.ops.riccati import riccati_lanes

    cand33 = (0.0,) + tuple(0.8 ** k for k in range(32))
    X_l, U_l = lane(res_b.X[:, :-1]), lane(res_b.U)
    xref_l, lam_l, mov_l = lane(ob_b.xref), lane(res_b.lam), AB._mov_lanes(ob_b, BENCH_B)
    mu_b = res_b.mu.contiguous()
    gains = riccati_lanes(expansions_fused(ob_b, X_l, U_l, xref_l, lam_l, mu_b, mov_l), obs_cfg.reg)
    args15 = (X_l[0].contiguous(), X_l, U_l, gains[0], gains[1], xref_l, lam_l, mu_b)
    cuda_build.reset_launch_counts()
    got = rollout_ops.linesearch_costs_lanes(ob_b, *args15, cand33, mov_l)
    n_launch = cuda_build.launch_counts["linesearch_costs_lanes"]
    want = SL.linesearch_costs_first(ob_b, *args15, cand33, mov_l)
    off15 = int((~((got == want) | (got.isnan() & want.isnan()))).sum())
    top = staged_tiles.k5_max_alphas(obs_base.m)
    assert off15 == 0 and n_launch == -(-len(cand33) // top), (off15, n_launch)
    log(f"phase 15 K5 with {len(cand33)} candidates at path (b) B={BENCH_B} N={obs_base.N}: "
        f"{n_launch} launches of at most {top}; merits that differ from the first design "
        f"{off15}/{got.numel()} (bit for bit: 0) ok")
    del got, want, gains, args15
    # a staged solve of obstacle_scenario_3 with 33 alphas (34 candidates,
    # three K5 launches an iteration)
    cfg33 = dataclasses.replace(obs_cfg, alphas=tuple(0.8 ** k for k in range(33)))
    ob33 = batch(obs_base, K1_B, spread=0.05)
    cuda_build.reset_launch_counts()
    res33, t33 = timed(lambda: solve_batched(ob33, cfg=cfg33))
    c33 = dict(cuda_build.launch_counts)
    it33 = c33["riccati_lanes"]
    slices = -(-(len(cfg33.alphas) + 1) // top)
    assert it33 > 0 and c33["expansions_fused"] == it33, c33
    assert c33["linesearch_costs_lanes"] == slices * it33 and c33["rollout_alpha_lanes"] == it33 + 1, c33
    for name in ("X", "U", "cost", "viol", "lam"):
        assert torch.isfinite(getattr(res33, name)).all(), name
    log(f"phase 15 staged solve of obstacle_scenario_3 N={obs_base.N} B={K1_B} with "
        f"{len(cfg33.alphas)} alphas: launches {c33} ({slices} K5 launches an iteration); "
        f"{summary(res33)}; {t33 * 1e3:.1f} ms")

    def entry(name, source, where, launches, err, ms_, plain_ms, key):
        return {"name": name, "route": "cuda", "source": source, "replaces": where,
                "launches": launches, "max_abs_err": err, "ms": ms_, "plain_ms": plain_ms,
                "bound_ms": bounds[key][0], "bound_by": bounds[key][1], "library_ms": None}

    record = {"kernels": [
        entry("inner_solve_fused", "nmpc_tpu_torch/csrc/inner_warp.cuh",
              "nmpc_tpu/ops/megasolve_pallas.py:911", counts["inner_solve_fused"], k1_err,
              k1_ms, k1_plain_ms, "K1"),
        entry("al_update_lanes", "nmpc_tpu_torch/csrc/inner_warp.cuh",
              "nmpc_tpu/ops/megasolve_pallas.py:870", counts["al_update_lanes"], k2_err,
              k2_ms, k2_plain_ms, "K2"),
    ] + [
        entry(name, "nmpc_tpu_torch/csrc/" + ("staged_tiles.cuh" if k in ("K3", "K5")
                                              else "expansions_rollout_tiles.cuh"),
              where, counts_a[name], errs[k], ms["a"][k][0], ms["a"][k][1], f"{k} a")
        for name, k, where in staged
    ] + [
        entry("fma_peak", "nmpc_tpu_torch/csrc/tools.cu", "tools/roofline.py:46", k7_launches,
              k7_err, best["ms"], k7_plain_ms, "K7"),
        entry("phase_ablation", "nmpc_tpu_torch/csrc/tools.cu", "tools/exp_mega_phases.py:298",
              k8_launches, k8_err, k8_ms, k89_plain_ms, "K8 line"),
        entry("expansion_ab", "nmpc_tpu_torch/csrc/tools.cuh",
              "tools/exp_blocked_expansions.py:551", k9_launches, k9_err, k9_ms, k89_plain_ms,
              "K9 line"),
    ]}
    log(f"total wall time {time.perf_counter() - t_start:.1f} s")
    print(json.dumps(record))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
