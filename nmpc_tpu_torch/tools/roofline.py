"""Roofline accounting of the port on an NVIDIA H100. Port of tools/roofline.py.

1. K7, the measured FMA peak: C independent f32 FMA chains per thread in
   registers (csrc/tools.cuh::fma_chain), the counterpart of the TPU's
   pure-FMA probe `measure_vpu_peak`. The port's kernels run one thread per
   scenario on the FP32 pipes, never on the tensor cores, so the roof is the
   card's f32 rate outside the tensor cores: 67 TFLOP/s published for the
   H100 SXM at 700 W. K7 measures how much of it a kernel can reach.
2. The reference's analytic model (`iteration_flops`, `hbm_bytes_per_solve`,
   copied unchanged) and the port's own work model of every kernel
   (`kernel_work`), counted from csrc/inner_warp.cuh, csrc/megasolve.cuh,
   csrc/staged.cuh and csrc/tools.cu at their shapes: each input byte read
   once, each output byte written once (scratch such as K1's gains is
   neither); a
   multiply, add, compare, select, sqrt, division, sine or cosine is one
   FLOP and a fused multiply-add two (so the count is a lower bound on
   issued work, as the reference's is). Where the work depends on the data,
   the count follows the run's own iteration counts; line-search candidate
   rollouts follow the reference's `merit_evals` convention (2 per adaptive
   iteration, every alpha for the cascade), plus the accepted rollout.
3. `bound_ms`: the least time the card could take for that work, the larger
   of FLOPs over 67 TFLOP/s and bytes over 3.35 TB/s (the H100 SXM data
   sheet at 700 W), and which of the two sets it.
4. `measure_bench`: the main path's solves/s with per-scenario and per-warp
   iteration counts (a warp lasts as long as its slowest scenario, the
   counterpart of the reference's 128-lane tile maximum).

    python -m nmpc_tpu_torch.tools.roofline [B]

runs on the card and prints the reference's JSON keys (renamed where a TPU
word no longer fits). Without a card it refuses to measure.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

from nmpc_tpu_torch.ops import cuda_build
from nmpc_tpu_torch.ops.cuda_build import check_arg, ptr

# H100 SXM data sheet, dense rates at the full 700 W power limit
PUBLISHED_FMA_TFLOPS = 67.0     # f32 outside the tensor cores
HBM_TBPS = 3.35                 # HBM3
WARP = 32
SMS = 132
# K7's probe: C chains per thread swept over FMA_CHAINS, FMA_STEPS steps of
# x = x FMA_A + FMA_B from ones (the reference's constants), FMA_THREADS
# threads: blocks of 256 (csrc/tools.cu::kFmaThreads), 8 resident per SM,
# the grid filling the card's 132 SMs four times over
FMA_CHAINS = (4, 8, 16, 32)
FMA_STEPS = 4096
FMA_A, FMA_B = 1.0000001, 1e-7
FMA_THREADS = SMS * 8 * 256 * 4


def require_card(what: str) -> None:
    """Measurements run on the card only: refuse, never time the CPU."""
    if not torch.cuda.is_available():
        raise RuntimeError(f"{what}: needs a CUDA card (torch.cuda.is_available() is False)")


def resolve_device(name: str, what: str) -> torch.device:
    """A tool's device: the card unless the caller asks for another ("cpu":
    every kernel's plain version); refuses the card without one."""
    dev = torch.device(name)
    if dev.type == "cuda":
        require_card(what)
    return dev


def device_label(device) -> str:
    """Where a tool's numbers were taken: the card's name and power limit,
    or the CPU, whose times are not device metrics."""
    if torch.device(device).type != "cuda":
        return "cpu (plain kernels; not a device time)"
    return f"{torch.cuda.get_device_name(device)} [{card()}]"


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


# ---------------------------------------------------------------- K7: FMA peak
def fma_chain_plain(x0: torch.Tensor, a: float, b: float, R: int) -> torch.Tensor:
    """Plain K7: R steps of x = x a + b on every element of x0 [C, T] f32.
    Each step is taken in f64 and rounded once to f32, as the kernel's FMA
    rounds it (for |x| near 1 and these a, b the f64 step is exact, so the
    two agree bit for bit; in general within 1 ulp per step)."""
    x = x0.clone()
    a64, b64 = float(np.float32(a)), float(np.float32(b))
    for _ in range(R):
        x = (x.double() * a64 + b64).to(torch.float32)
    return x


def fma_peak(x0: torch.Tensor, a: float, b: float, R: int) -> torch.Tensor:
    """K7 wrapper: x0 [C, T] f32, C in FMA_CHAINS chains of T threads ->
    the chains after R steps. The CUDA kernel for a CUDA tensor, the plain
    version for a CPU tensor."""
    if x0.device.type == "cpu":
        return fma_chain_plain(x0, a, b, R)
    if x0.device.type != "cuda":
        raise NotImplementedError(f"fma_peak: no kernel for {x0.device}")
    C, T = x0.shape
    if C not in FMA_CHAINS:
        raise NotImplementedError(f"fma_peak: the kernel is built for C in {FMA_CHAINS}, not {C}")
    check_arg("x0", x0, (C, T), x0.device)
    out = torch.empty_like(x0)
    lib = cuda_build.load_tools(cuda_build.BENCH_ROBOTS)
    err = lib.nmpc_fma_peak(ptr(x0), ptr(out), float(a), float(b), int(R), C, T,
                            cuda_build.stream(x0.device))
    cuda_build.check(lib, err, "fma_peak")
    cuda_build.launch_counts["fma_peak"] += 1
    return out


def fma_inputs(C: int, T: int, device) -> torch.Tensor:
    """The probe's starting values [C, T]: all ones, as the reference's."""
    return torch.ones((C, T), dtype=torch.float32, device=device)


def measure_fma_peak() -> dict:
    """Sweep K7 over C chains per thread (the reference sweeps its rows),
    each the mean of 10 launches after a warm-up. Returns {C: {"ms",
    "flops", "tflops"}} and "best"."""
    from nmpc_tpu_torch.utils.timing import cuda_ms

    require_card("measure_fma_peak")
    dev = torch.device("cuda", torch.cuda.current_device())
    out = {}
    for C in FMA_CHAINS:
        x0 = fma_inputs(C, FMA_THREADS, dev)
        ms = cuda_ms(lambda: fma_peak(x0, FMA_A, FMA_B, FMA_STEPS), 10)
        flops = 2.0 * FMA_THREADS * C * FMA_STEPS
        out[C] = {"ms": ms, "flops": flops, "tflops": flops / ms / 1e9}
    best = max(FMA_CHAINS, key=lambda c: out[c]["tflops"])
    out["best"] = {"chains": best, **out[best]}
    return out


# ------------------------------------------- the reference's analytic model
def iteration_flops(m, N, n_pairs, n_obs=0, n_mov=0, merit_evals=2.0):
    """FLOPs per lane per fused inner iteration (megasolve_pallas kernel).

    Counts multiplies/adds/compares/selects as 1, sqrt/div/sin/cos as 1
    (they cost more cycles — the model is therefore a *lower* bound on VPU
    work). Phases keyed to the kernel: expansions + structured V-propagation
    + Cholesky/solve + gain products (backward sweep, per stage), merit
    rollouts (line search + accept), per-iteration bookkeeping."""
    n, mc = 3 * m, 2 * m
    nc = n_pairs + m * n_obs + m * n_mov + 2 * mc + 2 * n

    # -- _expansion_regs (per stage)
    exp = (m * 6                      # e1/e2/bc/bs (+ sin/cos)
           + n * 3 + mc * 2           # lx/lu quadratic rows
           + n_pairs * 44             # pair rows: c, act, grads, 16 Hessian adds
           + m * n_obs * 40           # obstacle rows (sqrt + unit vector)
           + m * n_mov * 30           # keep-out rows (one-sided pair)
           + mc * 14 + n * 16         # u-box / x-box rows + diag curvature
           + n * 2 + mc * 2)          # He/Ue diagonals
    # -- structured V-propagation (per stage)
    vprop = (m * 4 * n                # VA column corrections
             + n + m * 4              # Qx rows + corrections
             + n * n + m * 4 * n      # Qxx adds + row corrections
             + m * 4 + mc            # bt_rows(Vx) + Qu add
             + m * 4 * n              # Qux = bt_rows(VA)
             + m * 4 * n + m * 4 * mc + mc * mc)  # VB, bt_rows(VB), Quu add
    # -- Cholesky + solve (per stage)
    chol = (mc * mc * (mc - 1)              # column updates (sum_i i * 2*mc)
            + mc * 3                         # sqrt + recip + scale
            + 2 * (mc * (mc - 1) * (1 + n))  # fwd+bwd substitution, r = 1+n
            + 2 * mc * (1 + n))              # divisions
    # -- gain products (per stage)
    gains = (2 * mc * n               # Qux' kff
             + 2 * mc * n * n         # Qux' Kfb  (the single largest term)
             + n + n * n              # Vx/Vxx adds
             + 2 * mc)                # dV1
    sweep = (exp + vprop + chol + gains) * N

    # -- one merit rollout (line search candidate / accept / init)
    fb = 2 * mc * n + 3 * mc          # _feedback_u
    merit = (n * 3 + mc * 3           # quadratic cost
             + n_pairs * 12 + m * n_obs * 12 + m * n_mov * 12
             + mc * 10 + n * 10       # box PHR blocks
             + nc * 3 + 6)            # act^2 reduce + combine
    euler = m * 8
    rollout = (fb + merit + euler) * N

    # merit_evals candidate rollouts + 1 accept rollout per iteration
    ls = (merit_evals + 1.0) * rollout
    return {"sweep": sweep, "line_search": ls,
            "per_iteration": sweep + ls, "rollout_one": rollout,
            "dims": dict(n=n, mc=mc, nc=nc, N=N, n_pairs=n_pairs)}


def hbm_bytes_per_solve(m, N, n_pairs, n_obs=0, n_mov=0, n_outer=6):
    """HBM traffic per solve: problem blocks in/out once per outer call
    (the megakernel keeps everything else VMEM-resident)."""
    n, mc = 3 * m, 2 * m
    nc = n_pairs + m * n_obs + m * n_mov + 2 * mc + 2 * n
    per_call = (n + N * n + N * nc + 1 + N * mc          # in
                + N * mc + N * n + 2                      # out
                + N * nc + 1)                             # AL update lam/viol
    return per_call * 4 * n_outer


# ------------------------------------------------- the port's work model
def _dims(ocp) -> dict:
    m = ocp.m
    return dict(m=m, n=ocp.nx, nu=ocp.nu, np=ocp.n_pairs, nc=ocp.n_con, N=ocp.N,
                n_obs=ocp.n_obs, n_mov=ocp.n_mov)


def _feedback(d) -> int:
    """rollout.cuh::feedback_u: dx, then per control ubar + alpha kff and n FMAs."""
    return d["n"] + d["nu"] * (2 + 2 * d["n"])


def _euler(d) -> int:
    """rollout.cuh::euler_rows: sin, cos and 8 per robot."""
    return 10 * d["m"]


def _merit(d) -> int:
    """rollout.cuh::stage_merit: tracking cost, the PHR rows, the combine."""
    n, nu, m = d["n"], d["nu"], d["m"]
    return (4 * n + 3 * nu + 1             # tracking cost
            + 12 * d["np"]                 # pair rows: dx, dy, c, lam - mu c, relu, gate, act^2
            + 14 * m * d["n_obs"]          # obstacle rows (with the sqrt)
            + 12 * m * d["n_mov"]          # moving-obstacle rows
            + 12 * nu + 14 * n             # u-box and x-box rows
            + 10)                          # block sums, / (2 mu), add


def _chol(M: int) -> int:
    """riccati.cuh::chol: left-looking column updates, sqrt, reciprocal, scale."""
    return sum(2 * i * (M - i) + 2 + (M - i - 1) for i in range(M))


def _chol_solve(M: int) -> int:
    """riccati.cuh::chol_solve (or inv_solve) for one right-hand side."""
    return 2 * M * M


def _chol_inverse(M: int) -> int:
    """riccati.cuh::chol_inverse."""
    return sum(2 + 2 * (i - j - 1) for j in range(M) for i in range(j + 1, M))


def _expansion(d, constraints: bool = True) -> int:
    """megasolve.cuh::stage_expansion (K1's structured expansion)."""
    m, n, nu = d["m"], d["n"], d["nu"]
    base = 9 * m + 3 * n + 2 * nu          # Jacobian entries (sin, cos), lx, lu
    if not constraints:
        return base + n + nu               # the cost's curvature only
    return (base + 16 * nu + 18 * n + 31 * d["np"]
            + 31 * m * d["n_obs"] + 29 * m * d["n_mov"])   # obstacle rows, as K4 counts them


def _sweep_stage(d, phase: str = "full") -> int:
    """megasolve.cuh::backward_sweep for one stage, without its expansion:
    the structured V-propagation, the gains and the value update."""
    m, n, nu = d["m"], d["n"], d["nu"]
    quu = sum((9 if i % 2 == 0 else 3) + (3 if j % 2 == 0 else 1) + 1
              for j in range(nu) for i in range(j + 1))
    vprop = (n + 4 * m) + 6 * m + quu + 12 * m * m + 4 * n * m + 10 * n * m
    if phase == "no_solve":
        gains = 2 * nu + nu * (1 + n)
    elif phase == "inv_solve":
        gains = _chol(nu) + _chol_inverse(nu) + (1 + n) * _chol_solve(nu)
    else:
        gains = _chol(nu) + (1 + n) * _chol_solve(nu)
    value = 2 * nu * n + 2 * nu * n * n + 2 * nu
    return vprop + gains + value


def sweep_flops(ocp, phase: str = "full") -> float:
    """FLOPs per scenario of one backward sweep: the expansions and the
    sweep (of a K8 phase ablation: `phase`) over the N stages."""
    d = _dims(ocp)
    return d["N"] * (_expansion(d, phase != "no_expcon") + _sweep_stage(d, phase))


def candidate_flops(ocp) -> float:
    """FLOPs per scenario of one line-search candidate: a closed-loop
    rollout over the N stages with its AL merit."""
    d = _dims(ocp)
    return d["N"] * (_feedback(d) + _merit(d) + _euler(d))


def inner_iteration_flops(ocp, cfg, phase: str = "full") -> float:
    """FLOPs per scenario of one iteration of K1's first design (phase
    'full') or of a K8 phase ablation, as that design runs it: the sweep,
    then the candidates (2 an adaptive iteration, every alpha of a cascade)
    and the accepted rollout, or the alpha = 1 rollout without a line
    search."""
    d = _dims(ocp)
    sweep = sweep_flops(ocp, phase)
    if phase == "sweep_only":
        return sweep
    accepted = d["N"] * (_feedback(d) + _euler(d))
    if phase != "full":
        return sweep + accepted
    evals = 2.0 if cfg.ls == "adaptive" else len(cfg.alphas)
    return sweep + evals * candidate_flops(ocp) + accepted


def k1_executed(iters: torch.Tensor, n_inner: int) -> torch.Tensor:
    """Iterations K1 ran per scenario from its counted ones: an iteration
    counts only if the scenario is still not done after it, so a scenario
    that stopped ran one more than it counted."""
    return torch.clamp(iters.long() + 1, max=n_inner)


def kernel_work(kernel: str, ocp, B: int, cfg=None, *, iters=None, candidates=None,
                n_alphas=None, phase: str = "full", chains=None, R=None,
                threads=None, design: str = "first") -> tuple:
    """(FLOPs, bytes) of one launch of `kernel` ('K1' ... 'K9') at the
    problem `ocp` (N stages, m robots, its rows) and batch B.

    K1, K8, K9: `iters` = iterations run, summed over the scenarios (K1:
    `k1_executed(...).sum()`; K8 and K9 at a fixed count: B n_iter), `cfg`
    the config, `phase` the K8 mode. K1: `candidates` = the line-search
    rollouts its iterations needed, summed over the scenarios
    (`megasolve.inner_solve_plain(..., candidates=)`); it needs no
    accepted rollout (the accepted trajectory is its candidate's). K8 and
    K9 count as `design` runs them: "first" per iteration as K1's first
    design does (`inner_iteration_flops`: the reference's merit_evals
    candidates and the accepted rollout); "warp" as K1's count, the mode
    `full` from `candidates` (`exp_mega_phases.phase_ablation_plain(...,
    candidates=)`) with no accepted rollout, the modes without a line search
    one alpha = 1 rollout without a merit an iteration, sweep_only none.
    K5: `n_alphas` candidates. K7: `chains`, `R`, `threads`. f32 and int32
    are 4 bytes."""
    d = _dims(ocp)
    n, nu, nc, N = d["n"], d["nu"], d["nc"], d["N"]
    mov = 2 * d["n_mov"]
    f = 4.0
    if design not in ("first", "warp"):
        raise ValueError(f"unknown design {design!r}")
    if kernel in ("K1", "K8", "K9"):
        init = N * ((0 if phase == "sweep_only" else _merit(d)) + _euler(d))
        if kernel == "K1" or (design == "warp" and phase == "full"):
            step = float(iters) * sweep_flops(ocp) + float(candidates) * candidate_flops(ocp)
        else:   # the modes without a line search roll alpha = 1 out alike in both designs
            step = float(iters) * inner_iteration_flops(ocp, cfg, phase)
        flops = B * init + step
        read = n + N * n + N * nc + 1 + N * nu + N * mov  # x0, xref, lam, mu, U, schedule
        write = N * n + N * nu + 1 + 1                   # Xs, U, cost, iters
        return flops, f * B * (read + write)
    if kernel == "K2":
        flops = N * (11 * d["np"] + 13 * d["m"] * d["n_obs"] + 11 * d["m"] * d["n_mov"]
                     + 6 * (2 * nu + 2 * n)) + 1
        return float(B * flops), f * B * (N * (n + nu + nc + mov) + 1 + N * nc + 1)
    blocks = n * n + n * nu + n + nu + n * n + nu * nu + nu * n   # A, B, lx, lu, lxx, luu, lux
    if kernel == "K4":
        m = d["m"]
        stage = (9 * m + 3 * n + 2 * nu + 16 * n + 16 * nu + 2 * n + 43 * d["np"]
                 + 31 * m * d["n_obs"] + 29 * m * d["n_mov"])
        return float(B * N * stage), f * B * N * (n + nu + n + nc + mov + blocks) + f * B
    if kernel == "K3":
        stage = (n * 2 * n + n * n * (2 * n - 1)           # A'Vx, Vxx A
                 + nu * (2 * n + n * (2 * n - 1))          # B'Vx, Vxx B
                 + nu * nu * 2 * n                          # Quu
                 + n * n * 2 * n + nu * n * 2 * n           # Qxx, Qux
                 + _chol(nu) + (1 + n) * _chol_solve(nu)    # gains
                 + 2 * nu + 2 * nu * n + 2 * nu * n * n)    # dV1, value update
        return float(B * N * stage), f * B * (N * blocks + N * nu + N * nu * n + 1)
    if kernel == "K5":
        A = n_alphas
        flops = A * N * (_feedback(d) + _merit(d) + _euler(d))
        read = n + N * (n + nu + nu + nu * n + n + nc + mov) + 1
        return float(B * flops), f * B * (read + A)
    if kernel == "K6":
        flops = N * (_feedback(d) + _euler(d))
        read = n + N * (n + nu + nu + nu * n) + 1
        return float(B * flops), f * B * (read + N * (n + nu))
    if kernel == "K7":
        return 2.0 * threads * chains * R, f * threads * chains * 2
    raise ValueError(f"unknown kernel {kernel!r}")


def bound(flops: float, nbytes: float) -> tuple:
    """(bound_ms, 'operations' or 'bytes'): the least time the card could
    take for the work, at the published f32 and HBM peaks."""
    t_ops = flops / (PUBLISHED_FMA_TFLOPS * 1e12)
    t_mem = nbytes / (HBM_TBPS * 1e12)
    return max(t_ops, t_mem) * 1e3, ("operations" if t_ops >= t_mem else "bytes")


# ---------------------------------------------------------------- measured
def bench_batch(B: int, seed: int = 0):
    """The main path's batch: six_robot_antipodal N=10 on the card with
    starts jittered by 0.1 N(0, 1) drawn by numpy from `seed` (the
    reference draws from jax.random keys, which numpy cannot reproduce)."""
    from nmpc_tpu_torch.parallel import batch_ocp
    from nmpc_tpu_torch.scenarios import get

    base = get("six_robot_antipodal").make(N=10)
    rng = np.random.default_rng(seed)
    noise = torch.from_numpy((0.1 * rng.standard_normal((B, base.nx))).astype(np.float32))
    return base, batch_ocp(base, base.x0[None] + noise.to(base.device))


def measure_bench(B: int = 32768) -> dict:
    """solves/s of the main path (bench config) at B, min of 3 after a
    warm-up, with the mean counted inner iterations per scenario and the
    mean over warps of the largest count among their 32 scenarios."""
    from nmpc_tpu_torch.solver import ALILQRConfig, solve_batched

    require_card("measure_bench")
    if B % WARP:
        raise ValueError(f"B={B} is not a multiple of the warp width {WARP}")
    cfg = ALILQRConfig(n_outer=6, n_inner=12, tol_con=1e-3, ls="adaptive")
    res = solve_batched(bench_batch(B, seed=0)[1], cfg=cfg)
    ts = []
    for seed in (1, 2, 3):
        ob = bench_batch(B, seed)[1]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = solve_batched(ob, cfg=cfg)
        torch.cuda.synchronize()
        ts.append(time.perf_counter() - t0)
    t = min(ts)
    iters = res.inner_iters.cpu().numpy()
    return {"B": B, "s_per_batch": t, "solves_per_s": B / t,
            "mean_scenario_iters": float(iters.mean()),
            "mean_warp_executed_iters": float(iters.reshape(-1, WARP).max(axis=1).mean()),
            "converged": float(res.converged.float().mean())}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    B = int(argv[0]) if argv else 32768
    require_card("roofline")
    print(f"device: {torch.cuda.get_device_name(0)} [{card()}]")
    peak = measure_fma_peak()
    for C in FMA_CHAINS:
        print(f"K7 C={C}: {peak[C]['tflops']:.2f} TFLOP/s ({peak[C]['ms']:.3f} ms)")
    fma = peak["best"]["tflops"] * 1e12
    mb = measure_bench(B)
    fl = iteration_flops(6, 10, 15)
    useful = fl["per_iteration"] * mb["mean_scenario_iters"]
    executed = fl["per_iteration"] * mb["mean_warp_executed_iters"]
    hbm = hbm_bytes_per_solve(6, 10, 15)
    ach_useful = useful * mb["solves_per_s"]
    ach_exec = executed * mb["solves_per_s"]
    hbm_rate = hbm * mb["solves_per_s"]
    out = {
        "device": {"kind": torch.cuda.get_device_name(0), "smi": card()},
        "bench": mb,
        "flops_per_iteration": {k: v for k, v in fl.items() if k != "dims"},
        "useful_flops_per_solve": useful,
        "executed_flops_per_solve": executed,
        "hbm_bytes_per_solve": hbm,
        "fma_peak_measured_tflops": fma / 1e12,
        "fma_peak_published_tflops": PUBLISHED_FMA_TFLOPS,
        "achieved_useful_tflops": ach_useful / 1e12,
        "achieved_executed_tflops": ach_exec / 1e12,
        "pct_published_peak_useful": 100 * ach_useful / (PUBLISHED_FMA_TFLOPS * 1e12),
        "pct_published_peak_executed": 100 * ach_exec / (PUBLISHED_FMA_TFLOPS * 1e12),
        "pct_measured_peak_useful": 100 * ach_useful / fma,
        "pct_measured_peak_executed": 100 * ach_exec / fma,
        "hbm_gbps": hbm_rate / 1e9,
        "pct_hbm_bw": 100 * hbm_rate / (HBM_TBPS * 1e12),
        "arith_intensity_flop_per_byte": useful / hbm,
    }
    print(json.dumps(out, indent=2, default=float))
    return 0


if __name__ == "__main__":
    sys.exit(main())
