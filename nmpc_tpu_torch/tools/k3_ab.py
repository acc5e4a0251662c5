"""K3 past (30, 20) against another checkout's K3, on the card: the same
inputs through both, timed in turns.

    python -m nmpc_tpu_torch.tools.k3_ab OTHER_CHECKOUT [KEY ...] [--phases] [--json F]

KEY is a robot count m (the stage shape (3m, 2m)) or N,NU; without keys,
every one of KEYS, each at the batch and horizon of the solves that run it
(the staged solves of chip_smoke.py phases 38, 40 and 41, and phase 39's
and 40's stage shapes). For each key csrc/riccati_shape.cu is built at that
stage shape from this checkout and from OTHER_CHECKOUT (its own csrc and its
own ops/staged_tiles.py's k3_shape_flags), by cuda_build.k3_library into
_build/. Both run on kernel_check.k3_inputs; the tool counts the output
entries in which they differ (and, at m <= 16, in which this checkout's
differs from the first design, riccati_thread of csrc/staged_first.cu),
holds this checkout's against the plain version on the first HOLD_B
scenarios (kernel_check's rule), and times both in turns (other, this,
this, other; CUDA events, each sample the mean of back-to-back launches),
beside the bound (tools/roofline.py::kernel_work). It prints each build's
ptxas line.

--phases splits a stage of both by phase at PHASE_KEYS with clock64 probes
(-DNMPC_K3_PROBES: csrc/staged_tiles.cuh's NMPC_K3_PROBE marks, thread 0 of
each block adding the cycles of each phase of each stage), both built from
copies of their csrc made anew each run; a checkout without the marks (the
block and wide designs) gets them in its copy before each phase
comment of its stage functions, OTHER_STAGES. The probes cost time, so the
shares are the result, not the cycles.

Needs a card; unpack the other checkout with `git archive` into a
git-ignored directory (_snapshot/parent).
"""

from __future__ import annotations

import ctypes
import importlib.util
import json
import re
import shutil
import subprocess
import sys
import types
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from nmpc_tpu_torch.ops import cuda_build, staged_tiles
from nmpc_tpu_torch.ops import kernel_check as KC
from nmpc_tpu_torch.ops.cuda_build import ptr
from nmpc_tpu_torch.ops.riccati import riccati_plain
from nmpc_tpu_torch.tools import roofline as RL
from nmpc_tpu_torch.tools.staged_launch import riccati_first
from nmpc_tpu_torch.utils.timing import cuda_ms

ROOT = Path(__file__).resolve().parents[2]
OUT = cuda_build.BUILD_DIR / "k3_ab"
REG = 1e-6
# key: (B, N) of the solves that run K3 there
KEYS = {12: (4096, 20), 16: (4096, 20), 20: (4096, 20), 24: (4096, 20), 32: (1024, 20),
        (36, 24): (256, 20), (41, 7): (256, 20), (50, 13): (256, 20), (64, 32): (256, 20),
        (80, 32): (256, 20), (81, 33): (256, 20), (96, 64): (256, 20), (120, 40): (256, 20),
        (150, 100): (256, 20), 112: (64, 10)}
PHASE_KEYS = (16, 24)
# scenarios held against the plain version (fewer where plain takes seconds)
HOLD_B = 32
HOLD_B_LARGE = 8
# the phases the probes mark: the cycles of a stage from its start (after its
# stage tile has landed) up to each mark
PHASES = {1: "phase 1 products", 2: "phase 2 products", 3: "Qux copy",
          4: "factor (and forward substitution)", 5: "substitutions (backward)",
          6: "value update"}
# the other checkout's stage functions and, per phase comment that opens a
# phase, the mark put before it (the phase it closes); the function's end
# closes its last phase
OTHER_STAGES = ("riccati_block_stage", "riccati_wide_stage")
OTHER_MARKS = {"  // 2: ": 1, "  // 3: ": 2, "  // 4: ": 4, "  // 5: ": 5}
PROBE_READER = """
#ifdef NMPC_K3_PROBES
extern "C" int nmpc_k3_phases(unsigned long long* out, int reset) {
  if (reset) {
    const unsigned long long zero[8] = {};
    return static_cast<int>(cudaMemcpyToSymbol(nmpc::g_k3_phase, zero, sizeof zero));
  }
  return static_cast<int>(cudaMemcpyFromSymbol(out, nmpc::g_k3_phase, sizeof(nmpc::g_k3_phase)));
}
#endif
"""


def shape_of(key) -> tuple:
    return staged_tiles.k3_dims(key)


def other_tiles(other: Path):
    """The other checkout's ops/staged_tiles.py, loaded under its own name
    (it imports nothing of the package)."""
    path = other / "nmpc_tpu_torch" / "ops" / "staged_tiles.py"
    spec = importlib.util.spec_from_file_location("k3_ab_other_staged_tiles", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod   # its dataclasses look their module up
    spec.loader.exec_module(mod)
    return mod


def probe_source(text: str, marks_exist: bool) -> str:
    """staged_tiles.cuh with the probes: as it is where it has its own marks,
    else with the macros of this checkout's header and a mark before each
    phase comment of OTHER_STAGES."""
    if marks_exist:
        return text
    mine = (cuda_build.SRC_DIR / "staged_tiles.cuh").read_text()
    a = mine.index("#if defined(NMPC_K3_PROBES)")
    b = mine.index("#endif", a) + len("#endif")
    text = text.replace("namespace nmpc {\n", "namespace nmpc {\n" + mine[a:b] + "\n", 1)
    for name in OTHER_STAGES:
        start = text.index(f"NMPC_DEV void {name}(")
        body = text.index("{\n", start) + 2
        end = text.index("\n}\n", body)
        part = "  NMPC_K3_PROBE_START();\n" + text[body:end]
        for comment, i in OTHER_MARKS.items():
            part = part.replace("\n" + comment, f"\n  NMPC_K3_PROBE({i});\n" + comment, 1)
        text = text[:body] + part + "\n  NMPC_K3_PROBE(6);" + text[end:]
    return text


def make_probe_copies(other: Path) -> None:
    """OUT/<tag>_probes_src: a fresh copy of each checkout's csrc with the
    probes (the other's patched by probe_source where it has no marks, and
    given the reader nmpc_k3_phases where its riccati_shape.cu lacks it)."""
    for tag, root in (("this", ROOT), ("other", other)):
        src, pdir = root / "nmpc_tpu_torch" / "csrc", OUT / f"{tag}_probes_src"
        shutil.rmtree(pdir, ignore_errors=True)
        shutil.copytree(src, pdir)
        text = (src / "staged_tiles.cuh").read_text()
        (pdir / "staged_tiles.cuh").write_text(probe_source(text, "NMPC_K3_PROBE(" in text))
        rs = (src / "riccati_shape.cu").read_text()
        if "nmpc_k3_phases" not in rs:
            (pdir / "riccati_shape.cu").write_text(rs + PROBE_READER)


_BUILT: dict = {}


def build(root: Path, tiles, shape: tuple, tag: str, probes: bool = False) -> tuple:
    """`_build`'s library, built once a (checkout, shape, probes)."""
    key = (tag, shape, probes)
    if key not in _BUILT:
        _BUILT[key] = _build(root, tiles, shape, tag, probes)
    return _BUILT[key]


def _build(root: Path, tiles, shape: tuple, tag: str, probes: bool = False) -> tuple:
    """csrc/riccati_shape.cu of checkout `root` at `shape` with its
    staged_tiles module's flags (with the probes: from its probe copy).
    Returns (the bound library, its ptxas line, its geometry)."""
    flags = list(tiles.k3_shape_flags(shape))
    src = root / "nmpc_tpu_torch" / "csrc"
    if probes:
        flags.append("-DNMPC_K3_PROBES")
        src = OUT / f"{tag}_probes_src"
    lib, _, _, text = cuda_build.k3_library(shape, flags, src)
    g = (ctypes.c_int * 8)()
    lib.nmpc_k3_geometry(g)
    geom = dict(zip(("S", "D", "T", "P", "spill", "threads", "smem_bytes", "scratch_floats"), g))
    line = re.findall(r"Used (\d+) registers.*", text)
    frame = re.findall(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill "
                       r"loads", text)
    ptx = (int(line[-1]), *map(int, frame[-1])) if line and frame else None
    return lib, ptx, geom


def launch(lib, geom: dict, exp) -> tuple:
    """K3 of a library of `build` on lane-major inputs."""
    N, n, _, B = exp[0].shape
    nu = exp[1].shape[2]
    kw = dict(dtype=torch.float32, device=exp[0].device)
    kff, Kfb, dV1 = (torch.empty((N, nu, B), **kw), torch.empty((N, nu, n, B), **kw),
                     torch.empty((B,), **kw))
    S = geom["S"]
    scratch = (torch.empty(((B + S - 1) // S) * geom["scratch_floats"], **kw)
               if geom["spill"] else None)
    err = lib.nmpc_riccati(*map(ptr, exp), ptr(kff), ptr(Kfb), ptr(dV1), ptr(scratch), B, N,
                           REG, cuda_build.stream(exp[0].device))
    cuda_build.check(lib, err, "k3_ab")
    return kff, Kfb, dV1


def in_turns(fa, fb, target_ms: float = 100.0) -> tuple:
    """(a's two samples, b's two samples) in ms, a, b, b, a; each the mean of
    back-to-back launches filling about target_ms."""
    est = cuda_ms(fa, 1)
    reps = max(1, int(target_ms / max(est, 1e-3)))
    a1, b1, b2, a2 = (cuda_ms(f, reps, warmup=0) for f in (fa, fb, fb, fa))
    return (a1, a2), (b1, b2)


def compare(key, other: Path, tiles_other, gen, card: str) -> dict:
    shape = shape_of(key)
    B, N = KEYS.get(key, (256, 20))
    mine, ptx_m, g_m = build(ROOT, staged_tiles, shape, "this")
    theirs, ptx_o, g_o = build(other, tiles_other, shape, "other")
    exp = KC.k3_inputs(*shape, B, N, gen)
    got_m, got_o = launch(mine, g_m, exp), launch(theirs, g_o, exp)
    first = (riccati_first(exp, REG)
             if isinstance(key, int) and key <= cuda_build.MEGA_MAX_ROBOTS else None)
    torch.cuda.synchronize()
    differ = sum(int((a != b).sum()) for a, b in zip(got_m, got_o))
    differ_first = (None if first is None else
                    sum(int((a != b).sum()) for a, b in zip(got_m, first)))
    del got_o, first
    H = min(B, HOLD_B_LARGE if shape[0] > 150 else HOLD_B)
    sub = tuple(t[..., :H].contiguous() for t in exp)
    v = KC.Verdict()
    for i, (a, w, atol) in enumerate(zip(launch(mine, g_m, sub), riccati_plain(sub, REG),
                                         KC.K3_ATOL)):
        KC.hold(v, f"K3 {shape} output {i}", a, w, atol)
    assert v.units == H and v.n_widened == 0 and v.n_diverged == 0, (shape, v)
    (o1, o2), (t1, t2) = in_turns(lambda: launch(theirs, g_o, exp),
                                  lambda: launch(mine, g_m, exp))
    dims = types.SimpleNamespace(m=0, nx=shape[0], nu=shape[1], n_pairs=0, n_con=0, N=N,
                                 n_obs=0, n_mov=0)
    b_ms, by = RL.bound(*RL.kernel_work("K3", dims, B))
    row = {"key": str(key), "shape": shape, "B": B, "N": N, "this_geometry": g_m,
           "other_geometry": g_o, "this_ptxas": ptx_m, "other_ptxas": ptx_o,
           "this_ms": [t1, t2], "other_ms": [o1, o2], "bound_ms": b_ms, "bound_by": by,
           "entries_differ": differ, "entries_differ_first": differ_first,
           "max_abs_err": v.err, "held": H}
    print(f"k3_ab {key} {shape} B={B} N={N}: this {t1:.4f} / {t2:.4f} ms "
          f"({100 * b_ms / min(t1, t2):.2f}% of {b_ms:.4f} ms, {by}), other {o1:.4f} / "
          f"{o2:.4f} ms ({100 * b_ms / min(o1, o2):.2f}%), {min(o1, o2) / min(t1, t2):.2f}x; "
          f"entries that differ {differ}"
          + ("" if differ_first is None else f" (this vs the first design {differ_first})")
          + f"; this vs plain max |err| {v.err:.3e} on {H}; ptxas this "
          f"{ptx_m} other {ptx_o}; geometry this {g_m} other {g_o} {card}", flush=True)
    return row


def phases(key, other: Path, tiles_other, gen, card: str) -> dict:
    shape = shape_of(key)
    B, N = KEYS.get(key, (256, 20))
    exp = KC.k3_inputs(*shape, B, N, gen)
    out = {}
    for tag, root, tiles in (("this", ROOT, staged_tiles), ("other", other, tiles_other)):
        lib, _, g = build(root, tiles, shape, tag, probes=True)
        launch(lib, g, exp)
        torch.cuda.synchronize()
        cuda_build.check(lib, lib.nmpc_k3_phases(None, 1), "k3_ab phases reset")
        launch(lib, g, exp)
        torch.cuda.synchronize()
        c = (ctypes.c_ulonglong * 8)()
        cuda_build.check(lib, lib.nmpc_k3_phases(c, 0), "k3_ab phases read")
        total = sum(c) or 1
        out[tag] = {PHASES[i]: c[i] / total for i in PHASES if c[i]}
        print(f"k3_ab phases {key} {shape} B={B} N={N} {tag}: " + ", ".join(
            f"{name} {100 * share:.1f}%" for name, share in out[tag].items())
            + f" of {total} block-stage cycles {card}", flush=True)
    return out


def main(argv: list[str]) -> int:
    if not torch.cuda.is_available():
        print("k3_ab: needs a CUDA device", file=sys.stderr)
        return 2
    args = [a for a in argv if not a.startswith("--")]
    jpath = argv[argv.index("--json") + 1] if "--json" in argv else None
    if jpath in args:
        args.remove(jpath)
    other = Path(args[0]).resolve()
    keys = [tuple(map(int, a.split(","))) if "," in a else int(a) for a in args[1:]] or list(KEYS)
    OUT.mkdir(parents=True, exist_ok=True)
    tiles_other = other_tiles(other)
    if "--phases" in argv:
        make_probe_copies(other)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()[0]
    card = f"[{smi}]"
    jobs = [(root, tiles, shape_of(k), tag, False) for k in keys
            for root, tiles, tag in ((ROOT, staged_tiles, "this"), (other, tiles_other, "other"))]
    if "--phases" in argv:
        jobs += [(root, tiles, shape_of(k), tag, True) for k in PHASE_KEYS
                 for root, tiles, tag in ((ROOT, staged_tiles, "this"),
                                          (other, tiles_other, "other"))]
    firsts = sorted({k for k in keys if isinstance(k, int) and k <= cuda_build.MEGA_MAX_ROBOTS})
    with ThreadPoolExecutor(max_workers=8) as pool:   # every nvcc at once
        for f in ([pool.submit(build, *job) for job in jobs]
                  + [pool.submit(cuda_build.load_first, m) for m in firsts]):
            f.result()
    gen = torch.Generator(device="cuda").manual_seed(21)
    rows = [compare(key, other, tiles_other, gen, card) for key in keys]
    split = ({str(k): phases(k, other, tiles_other, gen, card) for k in PHASE_KEYS}
             if "--phases" in argv else {})
    if jpath:
        Path(jpath).write_text(json.dumps({"card": smi, "rows": rows, "phases": split},
                                          indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
