"""Smoke run of the PyTorch + CUDA port (nmpc_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main path — the batched AL-iLQR solve of the
six_robot_antipodal swap at N=10, B=32768 jittered starts, with the
benchmark's ALILQRConfig(n_outer=6, n_inner=12, tol_con=1e-3,
ls="adaptive") — through the hand-written CUDA kernels K1 (fused inner
solve) and K2 (AL multiplier update), after building them from
nmpc_tpu_torch/csrc and holding each against its plain PyTorch version on
the card. Phases:

  0 device and toolchain        4 main path at B=32768 (launch counts checked)
  1 build every kernel          5 first 64 scenarios re-solved on the CPU
  2 K2 vs plain, B=32768        6 timings (solve, K1, K2 vs plain versions)
  3 K1 vs plain, B=1024

Any failed check raises, so the exit code is non-zero. Without a CUDA card,
or without the package beside this script, it fails before printing any
result. Output: one line per phase; before the last line, the kernels'
JSON record and the nvidia-smi name/power-limit line; last line
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import re
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH_B = 32768
K1_B = 1024
CROSS_B = 64


def log(msg: str) -> None:
    print(msg, flush=True)


def sh(cmd: list[str]) -> str:
    return subprocess.run(cmd, capture_output=True, text=True, check=True).stdout.strip()


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of fn() on the card (CUDA events, after one warm-up)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def ptxas_summary(text: str) -> str:
    """'kernel: N regs, S B stack, spill a/b B' for each kernel of a build log."""
    out, name, frame = [], "?", ""
    for line in text.splitlines():
        if "Compiling entry function" in line:
            name = "K1" if "inner_solve" in line else "K2" if "al_update" in line else "?"
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            frame = f"stack {m[1]} B, spill stores {m[2]} B, loads {m[3]} B"
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out.append(f"{name} {m[1]} regs, {frame}")
    return "; ".join(out) or text.strip().replace("\n", " | ")


def main() -> int:
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
    from nmpc_tpu_torch.ops import cuda_build, megasolve
    from nmpc_tpu_torch.parallel import batch_ocp
    from nmpc_tpu_torch.scenarios import get
    from nmpc_tpu_torch.solver import ALILQRConfig, solve_batched

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
    log(f"phase 1 build: {len(cuda_build.ROBOT_COUNTS)} libraries in {wall:.1f}s wall "
        f"(parallel nvcc; {per_m})")
    for m in cuda_build.ROBOT_COUNTS:
        log(f"  ptxas m={m}: {ptxas_summary(cuda_build.build_info[m]['ptxas'])}")

    gen = torch.Generator(device=dev).manual_seed(0)
    base = get("six_robot_antipodal").make(N=10, device=dev)
    bench_cfg = ALILQRConfig(n_outer=6, n_inner=12, tol_con=1e-3, ls="adaptive")

    def batch(ocp, B, spread=0.1):
        noise = torch.randn((B, ocp.nx), generator=gen, device=dev)
        return batch_ocp(ocp, ocp.x0[None] + spread * noise)

    def warm_state(ocp, B):
        """A mid-solve warm state: small controls, nonnegative duals (zero
        on the masked stage-0 rows), mu across the whole schedule."""
        U = 0.05 * torch.randn((B, ocp.N, ocp.nu), generator=gen, device=dev)
        lam = 0.5 * torch.randn((B, ocp.N, ocp.n_con), generator=gen, device=dev).abs()
        lam = lam * (P.constraint_mask(ocp) > 0)
        mu = torch.tensor([10.0, 100.0, 1e3, 1e4], device=dev)[
            torch.randint(0, 4, (B,), generator=gen, device=dev)]
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
    k1_err = 0.0
    for name, ls in (("six_robot_antipodal", "adaptive"), ("six_robot_antipodal", "cascade"),
                     ("two_robot_swap", "adaptive")):
        ocp = get(name).make(N=10, device=dev)
        obk = batch(ocp, K1_B)
        U, lam, mu = warm_state(ocp, K1_B)
        cfg = ALILQRConfig(n_outer=6, n_inner=4, tol_con=1e-3, ls=ls)
        got = megasolve.inner_solve_fused(obk, obk.x0, obk.xref, lam, mu, U, cfg)
        torch.cuda.synchronize()
        want = megasolve.inner_solve_plain(obk, obk.x0, obk.xref, lam, mu, U, cfg)
        rel = ((got[2] - want[2]).abs() / want[2].abs())
        du = (got[1] - want[1]).abs().amax(dim=(1, 2))
        same_it = int((got[3] == want[3]).sum())
        w = int(du.argmax())
        log(f"phase 3 K1 vs plain: {name} N=10 B={K1_B} ls={ls} n_inner=4: cost rel max "
            f"{float(rel.max()):.3e}, U max |err| {float(du.max()):.3e} (worst scenario {w}: "
            f"cost {float(got[2][w]):.6f} vs {float(want[2][w]):.6f}, iters "
            f"{int(got[3][w])} vs {int(want[3][w])}), iteration counts equal {same_it}/{K1_B}")
        torch.testing.assert_close(got[2], want[2], rtol=1e-4, atol=0.0)
        torch.testing.assert_close(got[1], want[1], rtol=0.0, atol=5e-3)
        assert same_it >= 0.99 * K1_B, same_it
        assert torch.isfinite(got[0]).all()
        k1_err = max(k1_err, float(du.max()))

    # ---- phase 4: the main path ------------------------------------------
    ob = batch(base, BENCH_B)
    torch.cuda.synchronize()
    megasolve.reset_launch_counts()
    res = solve_batched(ob, cfg=bench_cfg)
    torch.cuda.synchronize()
    counts = dict(megasolve.launch_counts)
    steps = int(res.outer_iters.max())
    assert counts["inner_solve_fused"] == steps, (counts, steps)
    assert counts["al_update_lanes"] == steps, (counts, steps)
    assert torch.isfinite(res.cost).all() and torch.isfinite(res.viol).all()
    assert torch.isfinite(res.X).all() and torch.isfinite(res.U).all()
    conv = float(res.converged.float().mean())
    viol_p99 = float(torch.quantile(res.viol, 0.99))
    mean_inner = float(res.inner_iters.float().mean())
    log(f"phase 4 main path: six_robot_antipodal N=10 B={BENCH_B} {bench_cfg.ls}: launches "
        f"{counts} over {steps} outer steps; converged {conv:.4f}, viol p99 {viol_p99:.3e}, "
        f"max {float(res.viol.max()):.3e}, mean inner iters {mean_inner:.2f}, "
        f"mean cost {float(res.cost.mean()):.4f}")
    assert conv >= 0.9, conv

    # ---- phase 5: CPU cross-check of the first scenarios ------------------
    cpu = torch.device("cpu")
    sub = batch_ocp(base.to(cpu), ob.x0[:CROSS_B].to(cpu))
    ref = solve_batched(sub, cfg=bench_cfg)
    gc, gu = res.cost[:CROSS_B].cpu(), res.U[:CROSS_B].cpu()
    rel = (gc - ref.cost).abs() / ref.cost.abs()
    du = (gu - ref.U).abs().amax(dim=(1, 2))
    n_cost, n_u = int((rel <= 1e-4).sum()), int((du <= 5e-3).sum())
    conv_g = float(res.converged[:CROSS_B].float().mean())
    conv_r = float(ref.converged.float().mean())
    mean_ratio = float(gc.mean() / ref.cost.mean())
    log(f"phase 5 CPU cross-check: first {CROSS_B} scenarios re-solved by the plain path: "
        f"cost within rtol 1e-4 on {n_cost}/{CROSS_B} (max rel {float(rel.max()):.3e}), "
        f"U within atol 5e-3 on {n_u}/{CROSS_B} (max {float(du.max()):.3e}); converged "
        f"{conv_g:.4f} vs {conv_r:.4f}; mean cost ratio {mean_ratio:.6f}")
    # Per scenario the full solve is path-sensitive in f32: a near-tied
    # alpha pick or a rel < tol_cost stop that flips moves a scenario to
    # another point of a flat cost valley (the plain path alone, solving the
    # same scenarios at two batch sizes, differs by 1e-3 in cost on some).
    # So most scenarios must agree at the tight tolerances, and the batch
    # at the aggregate ones of tests/test_batched_solver.py.
    assert n_cost >= 0.9 * CROSS_B, n_cost
    assert n_u >= 0.75 * CROSS_B, n_u
    assert abs(conv_g - conv_r) <= 1.0 / CROSS_B + 1e-9, (conv_g, conv_r)
    assert abs(mean_ratio - 1.0) <= 1e-3, mean_ratio

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
    # one K1 and one K2 call at the bench shape (the first outer step's
    # inputs: zero warm controls, zero duals, mu_init), kernel vs plain
    kw = dict(dtype=torch.float32, device=dev)
    U0 = torch.zeros((BENCH_B, base.N, base.nu), **kw)
    lam0 = torch.zeros((BENCH_B, base.N, base.n_con), **kw)
    mu0 = torch.full((BENCH_B,), bench_cfg.mu_init, **kw)
    before = dict(megasolve.launch_counts)
    k1_ms = cuda_ms(lambda: megasolve.inner_solve_fused(ob, ob.x0, ob.xref, lam0, mu0, U0, bench_cfg), 3)
    k1_plain_ms = cuda_ms(lambda: megasolve.inner_solve_plain(ob, ob.x0, ob.xref, lam0, mu0, U0, bench_cfg), 1)
    Xs1, U1 = res.X[:, :-1].contiguous(), res.U
    k2_ms = cuda_ms(lambda: megasolve.al_update_lanes(ob, Xs1, U1, res.lam, res.mu, bench_cfg.lam_max), 20)
    k2_plain_ms = cuda_ms(lambda: megasolve.al_update_plain(ob, Xs1, U1, res.lam, res.mu, bench_cfg.lam_max), 20)
    assert megasolve.launch_counts["inner_solve_fused"] > before["inner_solve_fused"]
    log(f"phase 6 kernels at B={BENCH_B}: K1 {k1_ms:.2f} ms vs plain {k1_plain_ms:.2f} ms; "
        f"K2 {k2_ms:.3f} ms vs plain {k2_plain_ms:.3f} ms {card}")

    record = {"kernels": [
        {"name": "inner_solve_fused", "route": "cuda",
         "source": "nmpc_tpu_torch/csrc/megasolve.cuh",
         "replaces": "nmpc_tpu/ops/megasolve_pallas.py:911",
         "launches": counts["inner_solve_fused"], "max_abs_err": k1_err,
         "ms": k1_ms, "plain_ms": k1_plain_ms},
        {"name": "al_update_lanes", "route": "cuda",
         "source": "nmpc_tpu_torch/csrc/megasolve.cuh",
         "replaces": "nmpc_tpu/ops/megasolve_pallas.py:870",
         "launches": counts["al_update_lanes"], "max_abs_err": k2_err,
         "ms": k2_ms, "plain_ms": k2_plain_ms},
    ]}
    print(json.dumps(record))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
