"""Build and bind the CUDA kernels of csrc/ (nvcc into a shared library with
a plain C interface, loaded with ctypes), and what every kernel wrapper
shares: the launch counters, argument checks, pointers and the lane-major
layout.

The solver's kernels: one library per robot count m, `csrc/megasolve.cu`
(K1, K2; device code in `csrc/inner_warp.cuh`) and `csrc/staged.cu` (K3-K6;
K3's and K5's device code in `csrc/staged_tiles.cuh`), each compiled by its
own nvcc process with
-DNMPC_NR=m (staged.cu also with K3's and K5's launch geometry from
ops/staged_tiles.py), linked together (`load`, any m >= 1: past
MEGA_MAX_ROBOTS staged.cu alone, as K1 and K2 stop there;
`load_all` builds the registry's ROBOT_COUNTS ahead). K3's
and K5's first designs (`csrc/staged_first.cu`, the A/B baselines of
tools/staged_launch.py) are a library of their own per m (`load_first`),
and so is staged.cu at another geometry (`load_staged_variant`, the sweep's).
The roofline tools' K7-K9
(`csrc/tools.cu`: K8 and K9 on K1's warp design, `csrc/inner_warp.cuh`, and
on its first design, `csrc/megasolve.cuh`) are a library of their own
(`load_tools`), so the solver library's kernel set, build time and code
generation stay as they are: seventeen nvcc processes, one per part of
tools.cu. A library is built at its first use
from the sources in the checkout into `nmpc_tpu_torch/_build/`, named by a
hash of the sources (the headers they include too) and flags so a stale build
is never loaded, and reused from there afterwards. Nothing here runs at
import time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from nmpc_tpu_torch.ops import staged_tiles

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
UNITS = ("megasolve.cu", "staged.cu")       # one nvcc process each
SOURCES = (*UNITS, "inner_warp.cuh", "inner_team.cuh", "k1_variants.cuh", "staged.cuh",
           "staged_tiles.cuh", "expansions_rollout_tiles.cuh", "riccati.cuh", "rollout.cuh")
# K3 at a stage shape other than (3m, 2m), a library per shape
K3_SHAPE_SOURCES = ("riccati_shape.cu", "staged_tiles.cuh", "staged.cuh", "riccati.cuh",
                    "rollout.cuh")
FIRST_SOURCES = ("staged_first.cu", "staged.cuh", "riccati.cuh", "rollout.cuh")
TOOLS_SOURCES = ("tools.cu", "tools.cuh", "megasolve.cuh", "inner_warp.cuh", "k1_variants.cuh",
                 "riccati.cuh", "rollout.cuh")
# the parts of tools.cu (-DNMPC_TOOLS_PART=i), one nvcc process each: K7, the
# first design's K8 and K9 variants (1-8), the warp design's (9-16)
TOOLS_PARTS = ("K7", "K8 full, early exit", "K8 full", "K8 inv_solve", "K8 no_ls",
               "K8 no_solve", "K8 no_expcon", "K8 sweep_only", "K9 dense",
               "K8 warp full, early exit", "K8 warp full", "K8 warp inv_solve", "K8 warp no_ls",
               "K8 warp no_solve", "K8 warp no_expcon", "K8 warp sweep_only", "K9 warp dense")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# robot counts of the scenario registry: the solver libraries load_all
# builds ahead (any other m is built at its first use)
ROBOT_COUNTS = (1, 2, 3, 4, 5, 6, 8, 10)
# the most robots K1 and K2 take (csrc/inner_warp.cuh: a control row and a
# row of Quu's factor a lane, nu = 2m <= 32; lanes own several state rows
# and right-hand sides past m = 10), and the staged kernels' first designs
# (csrc/staged_first.cu, the A/B baselines). K3-K6 take any m: past it the
# solver library is staged.cu alone (K3's register-tile design, K4-K6 on the tiles of
# staged_tiles.k4_rule, ..., and K4's and K5's device-memory forms).
MEGA_MAX_ROBOTS = 16
# robot count of the main path (six_robot_antipodal): the tools library
# that load_all builds
BENCH_ROBOTS = 6
# robot counts whose staged first designs load_all builds: the main path's
# (path (a)) and one robot (paths (b) and (c))
FIRST_ROBOTS = (1, 6)

# Kernel launches since the last reset: each wrapper adds one where it
# launches its CUDA kernel, and nowhere else.
launch_counts = {"inner_solve_fused": 0, "al_update_lanes": 0,
                 "expansions_fused": 0, "riccati_lanes": 0,
                 "linesearch_costs_lanes": 0, "rollout_alpha_lanes": 0,
                 "fma_peak": 0, "phase_ablation": 0, "expansion_ab": 0}
# K1's launches on the solver's route (`inner_solve_fused`) by design: the
# team design at m in TEAM_ROBOTS, the warp design elsewhere. Reset with
# launch_counts.
k1_designs = {"team": 0, "warp": 0}
# K4's and K5's launches (`expansions_fused`, `linesearch_costs_lanes`) by
# form: the tile form, or the device-memory form (staged_tiles.k4_form,
# k5_form). Reset with launch_counts.
staged_forms = {"K4 tile": 0, "K4 device": 0, "K5 tile": 0, "K5 device": 0}

_locks: dict[tuple, threading.Lock] = {}
_locks_guard = threading.Lock()   # creates the lock of a new library
_libs: dict[tuple[str, int], ctypes.CDLL] = {}
# per m: {"path", "seconds" (0.0 when reused), "ptxas" (compiler report)}
build_info: dict[int, dict] = {}
# per m: the same for the tools library, "ptxas" per part {TOOLS_PARTS[i]: report}
tools_build_info: dict[int, dict] = {}
# per m: the same for the first designs' library
first_build_info: dict[int, dict] = {}
# per stage shape (n, nu): the same for K3's library at that shape
k3_shape_build_info: dict[tuple, dict] = {}


def reset_launch_counts() -> None:
    for counts in (launch_counts, k1_designs, staged_forms):
        for k in counts:
            counts[k] = 0


def nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/bin/nvcc as PyTorch resolves it, else PATH."""
    from torch.utils.cpp_extension import CUDA_HOME

    cand = os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME else None
    if cand and os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if not found:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def _key(sources: tuple, m: int, flags: tuple = (), src: Path = SRC_DIR) -> str:
    h = hashlib.sha256()
    for name in sources:
        h.update(name.encode())
        h.update((src / name).read_bytes())
    h.update(" ".join((*NVCC_FLAGS, *flags)).encode())
    h.update(str(m).encode())
    return h.hexdigest()[:16]


def _bind_mega(lib: ctypes.CDLL) -> ctypes.CDLL:
    """The entry points of megasolve.cu (K1, K2)."""
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    _bind_errors(lib)
    lib.nmpc_k1_slot_bytes.argtypes = [I]
    lib.nmpc_k1_slot_bytes.restype = I
    lib.nmpc_inner_solve.argtypes = [P] * 14 + [I] * 8 + [F] * 6 + [P] + [I] * 3 + [P]
    lib.nmpc_inner_solve.restype = I
    lib.nmpc_al_update.argtypes = [P] * 7 + [I] * 3 + [F] + [P] + [I] * 3 + [P]
    lib.nmpc_al_update.restype = I
    return lib


# the robot counts whose megasolve.cu holds K1's team design (inner_team.cuh)
TEAM_ROBOTS = (1, 2)


def _bind_team(lib: ctypes.CDLL) -> ctypes.CDLL:
    """The team design's entry points of megasolve.cu (m in TEAM_ROBOTS)."""
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.nmpc_k1_team_geometry.argtypes = [P]
    lib.nmpc_k1_team_geometry.restype = None
    lib.nmpc_k1_team_ring_bytes.argtypes = [I, I, I]
    lib.nmpc_k1_team_ring_bytes.restype = I
    lib.nmpc_inner_solve_team.argtypes = [P] * 14 + [I] * 8 + [F] * 6 + [P] + [I] * 3 + [P]
    lib.nmpc_inner_solve_team.restype = I
    return lib


def team_geometry(lib: ctypes.CDLL) -> dict:
    """K1's team design as a library was built: team size T, ring depth D,
    register cap (blocks of 128 threads an SM)."""
    g = (ctypes.c_int * 3)()
    lib.nmpc_k1_team_geometry(g)
    return dict(zip(("T", "D", "min_blocks"), g))


def _bind_errors(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.nmpc_robots.argtypes = []
    lib.nmpc_robots.restype = ctypes.c_int
    lib.nmpc_error_string.argtypes = [ctypes.c_int]
    lib.nmpc_error_string.restype = ctypes.c_char_p
    return lib


def _bind_staged(lib: ctypes.CDLL) -> ctypes.CDLL:
    """The entry points of staged.cu (K3-K6)."""
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.nmpc_expansions.argtypes = [P, I] + [P] * 13 + [I] * 5 + [P]
    lib.nmpc_expansions.restype = I
    lib.nmpc_expansions_device.argtypes = [P] * 15 + [I] * 6 + [P]
    lib.nmpc_expansions_device.restype = I
    lib.nmpc_k4_device_geometry.argtypes = [I, P]
    lib.nmpc_k4_device_geometry.restype = None
    lib.nmpc_k5_device_geometry.argtypes = [P]
    lib.nmpc_k5_device_geometry.restype = None
    lib.nmpc_k3_geometry.argtypes = [P]
    lib.nmpc_k3_geometry.restype = None
    lib.nmpc_k3_rtile.argtypes = []
    lib.nmpc_k3_rtile.restype = I
    lib.nmpc_k5_geometry.argtypes = [I, I, P]
    lib.nmpc_k5_geometry.restype = None
    lib.nmpc_k4_geometry.argtypes = [I, I, P]
    lib.nmpc_k4_geometry.restype = None
    lib.nmpc_k6_geometry.argtypes = [P]
    lib.nmpc_k6_geometry.restype = None
    lib.nmpc_riccati.argtypes = [P] * 11 + [I] * 2 + [F] + [P]
    lib.nmpc_riccati.restype = I
    lib.nmpc_linesearch_costs.argtypes = [P, I] + [P] * 10 + [I] * 6 + [P]
    lib.nmpc_linesearch_costs.restype = I
    lib.nmpc_linesearch_costs_device.argtypes = [P, I] + [P] * 10 + [I] * 6 + [P]
    lib.nmpc_linesearch_costs_device.restype = I
    lib.nmpc_rollout_alpha.argtypes = [P] * 9 + [I] * 2 + [P]
    lib.nmpc_rollout_alpha.restype = I
    return lib


def _bind_first(lib: ctypes.CDLL) -> ctypes.CDLL:
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    _bind_errors(lib)
    lib.nmpc_riccati_first.argtypes = [P] * 10 + [I] * 2 + [F] + [P]
    lib.nmpc_riccati_first.restype = I
    lib.nmpc_linesearch_costs_first.argtypes = [P, I] + [P] * 10 + [I] * 6 + [P]
    lib.nmpc_linesearch_costs_first.restype = I
    lib.nmpc_expansions_first.argtypes = [P, I] + [P] * 13 + [I] * 5 + [P]
    lib.nmpc_expansions_first.restype = I
    lib.nmpc_rollout_alpha_first.argtypes = [P] * 9 + [I] * 2 + [P]
    lib.nmpc_rollout_alpha_first.restype = I
    return lib


def _bind_tools(lib: ctypes.CDLL) -> ctypes.CDLL:
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    inner = [P] * 12 + [I] * 7 + [F] * 6 + [P]   # K1's argument list
    _bind_errors(lib)
    lib.nmpc_fma_peak.argtypes = [P, P, F, F, I, I, ctypes.c_longlong, P]
    lib.nmpc_fma_peak.restype = I
    lib.nmpc_phase_ablation.argtypes = [I, I] + inner
    lib.nmpc_phase_ablation.restype = I
    lib.nmpc_expansion_ab.argtypes = [I] + inner
    lib.nmpc_expansion_ab.restype = I
    warp = [P] * 14 + [I] * 8 + [F] * 6 + [P] + [I] * 3 + [P]   # nmpc_inner_solve's list
    lib.nmpc_warp_slot_bytes.argtypes = [I]
    lib.nmpc_warp_slot_bytes.restype = I
    lib.nmpc_phase_ablation_warp.argtypes = [I, I] + warp
    lib.nmpc_phase_ablation_warp.restype = I
    lib.nmpc_expansion_ab_warp.argtypes = [I] + warp
    lib.nmpc_expansion_ab_warp.restype = I
    return lib


def _run(cmd: list[str], what: str) -> str:
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {what} (exit {proc.returncode}):\n"
                           f"{proc.stdout}\n{proc.stderr}")
    return proc.stdout + proc.stderr


def _build(stem: str, jobs: list, what: str, src: Path = SRC_DIR) -> tuple:
    """Compile each (source in `src`, extra nvcc flags) job in its own nvcc
    process, all at once, and link the objects into BUILD_DIR/<stem>.so,
    unless that exists. Returns (path, seconds (0.0 when reused), the
    compiler report of each job)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    path = BUILD_DIR / f"{stem}.so"
    logs = [BUILD_DIR / f"{stem}.{i}.log" for i in range(len(jobs))]
    seconds = 0.0
    if not path.exists():
        tmp = f"{stem}.{os.getpid()}.{threading.get_ident()}"
        objs = [BUILD_DIR / f"{tmp}.{i}.o" for i in range(len(jobs))]
        t0 = time.perf_counter()

        def compile_one(obj, job):
            name, flags = job
            return _run([nvcc(), *NVCC_FLAGS, *flags, "-c", "-o", str(obj), str(src / name)],
                        f"{name} {' '.join(flags)} ({what})")

        try:
            with ThreadPoolExecutor(max_workers=len(jobs)) as pool:
                texts = list(pool.map(compile_one, objs, jobs))
            so = BUILD_DIR / f"{tmp}.so"
            _run([nvcc(), "-shared", "-gencode", "arch=compute_90a,code=sm_90a",
                  "-o", str(so), *map(str, objs)], f"linking {what}")
        finally:
            for o in objs:
                o.unlink(missing_ok=True)
        seconds = time.perf_counter() - t0
        for log, text in zip(logs, texts):
            log.write_text(text)
        os.replace(so, path)  # atomic: a concurrent loader sees all or nothing
    return path, seconds, [log.read_text() if log.exists() else "" for log in logs]


def _lock(kind: str, key) -> threading.Lock:
    """The lock of library (kind, key), made at its first use."""
    with _locks_guard:
        return _locks.setdefault((kind, key), threading.Lock())


def _require_robots(m: int, top: int | None, what: str) -> None:
    """Raise NotImplementedError unless 1 <= m (<= top, where given)."""
    if m < 1 or (top is not None and m > top):
        span = f"1 <= m <= {top}" if top is not None else "m >= 1"
        raise NotImplementedError(f"{what} are built for {span} robots, not m={m}")


def _check_robots(lib: ctypes.CDLL, path, m: int) -> None:
    if lib.nmpc_robots() != m:
        raise RuntimeError(f"{path} was built for m={lib.nmpc_robots()}, not {m}")


def k3_geometry(lib: ctypes.CDLL) -> dict:
    """K3's geometry as a library was built with (nmpc_k3_geometry,
    nmpc_k3_rtile)."""
    g = (ctypes.c_int * 8)()
    lib.nmpc_k3_geometry(g)
    keys = ("S", "D", "T", "P", "spill", "threads", "smem_bytes", "scratch_floats")
    return {**dict(zip(keys, g)), "rtile": lib.nmpc_k3_rtile()}


def _k3_want(key, g) -> dict:
    """k3_geometry's dict as ops/staged_tiles.py computes it for K3 key
    `key` at geometry g."""
    lay = staged_tiles.k3_layout(key, g)
    return {"S": g.S, "D": g.D, "T": g.T, "P": g.P, "spill": int(g.spill),
            "threads": lay["threads"], "smem_bytes": lay["smem_bytes"],
            "scratch_floats": lay["scratch_floats"], "rtile": int(g.rtile)}


def k5_geometry(lib: ctypes.CDLL, rows: int, prm_size: int, device: bool = False) -> dict:
    """K5's geometry as a library was built with (device: its device-memory
    form's), and its shared bytes at `rows` stage rows and a parameter block
    of prm_size floats."""
    g = (ctypes.c_int * 4)()
    if device:
        lib.nmpc_k5_device_geometry(g)
    else:
        lib.nmpc_k5_geometry(rows, prm_size, g)
    return dict(zip(("S", "D", "max_alphas", "smem_bytes"), g))


def k4_geometry(lib: ctypes.CDLL, rows: int, prm_size: int) -> dict:
    """K4's geometry as a library was built with, and its shared bytes at
    `rows` input rows and a parameter block of prm_size floats (zeros: the
    library holds no K4 tile form)."""
    g = (ctypes.c_int * 4)()
    lib.nmpc_k4_geometry(rows, prm_size, g)
    return dict(zip(("S", "W", "threads", "smem_bytes"), g))


def k4_device_geometry(lib: ctypes.CDLL, rows: int) -> dict:
    """K4's device-memory form as a library was built with, and the floats
    of a block's slot of its scratch at `rows` input rows."""
    g = (ctypes.c_int * 4)()
    lib.nmpc_k4_device_geometry(rows, g)
    return dict(zip(("S", "W", "threads", "scratch_floats"), g))


@functools.lru_cache(maxsize=None)
def sm_count(device) -> int:
    """The streaming multiprocessors of a CUDA device."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def k6_geometry(lib: ctypes.CDLL) -> dict:
    """K6's geometry as a library was built with (nmpc_k6_geometry)."""
    g = (ctypes.c_int * 5)()
    lib.nmpc_k6_geometry(g)
    return dict(zip(("S", "D", "T", "threads", "smem_bytes"), g))


def _check_geometry(lib: ctypes.CDLL, path, m: int, k3, k5, k4, k6) -> None:
    """Raise unless the library's K3-K6 constants are the ones
    ops/staged_tiles.py asked for and sizes."""
    want = {"K3": _k3_want(m, k3)}
    rows = staged_tiles.k5_rows(m, True, 1, 1)
    for key, g in (("K5", k5), ("K5 device", staged_tiles.K5_DEVICE)):
        want[key] = {"S": g.S, "D": g.D, "max_alphas": staged_tiles.k5_max_alphas(m, g),
                     "smem_bytes": staged_tiles.k5_layout(m, rows, 100, 1, g)["smem_bytes"]}
    rows4 = staged_tiles.k4_rows(m, True, 1, 1)
    lay4, lay6 = (staged_tiles.k4_layout(m, rows4, 100, k4) if k4 is not None
                  else {"threads": 0, "smem_bytes": 0}), staged_tiles.k6_layout(m, k6)
    want["K4"] = {"S": k4.S if k4 else 0, "W": k4.W if k4 else 0, "threads": lay4["threads"],
                  "smem_bytes": lay4["smem_bytes"]}
    dm = staged_tiles.K4_DEVICE
    want["K4 device"] = {"S": dm.S, "W": dm.W, "threads": 32 * dm.W,
                         "scratch_floats": staged_tiles.k4_scratch_floats(m, rows4, dm)}
    want["K6"] = {"S": k6.S, "D": k6.D, "T": k6.T, "threads": lay6["threads"],
                  "smem_bytes": lay6["smem_bytes"]}
    got = {"K3": k3_geometry(lib), "K5": k5_geometry(lib, rows, 100),
           "K5 device": k5_geometry(lib, rows, 100, device=True),
           "K4": k4_geometry(lib, rows4, 100), "K4 device": k4_device_geometry(lib, rows4),
           "K6": k6_geometry(lib)}
    if got != want:
        raise RuntimeError(f"{path}: staged kernels' geometry {got}, expected {want}")


def load(m: int) -> ctypes.CDLL:
    """The solver's kernel library for m robots, built first if needed:
    K1-K6 up to MEGA_MAX_ROBOTS, past it K3-K6 alone (staged.cu built with
    -DNMPC_STAGED_ALONE; megasolve.cuda_unsupported refuses K1 and K2
    there); K4 and K5 in their tile and device-memory forms (K4's device-
    memory form alone where its tile cannot hold one scenario, m >= 109).
    Raises NotImplementedError for m < 1."""
    _require_robots(m, None, "the solver's kernels")
    with _lock("solver", m):
        if ("solver", m) in _libs:
            return _libs["solver", m]
        geom = staged_tiles.nvcc_flags(m)
        mega = m <= MEGA_MAX_ROBOTS
        jobs = ([("megasolve.cu", [f"-DNMPC_NR={m}"]), ("staged.cu", [f"-DNMPC_NR={m}", *geom])]
                if mega else [("staged.cu", [f"-DNMPC_NR={m}", "-DNMPC_STAGED_ALONE", *geom])])
        path, seconds, texts = _build(f"libnmpc_m{m}_{_key(SOURCES, m, tuple(geom))}", jobs,
                                      f"m={m}")
        lib = ctypes.CDLL(str(path))
        lib = _bind_staged(_bind_mega(lib) if mega else _bind_errors(lib))
        if m in TEAM_ROBOTS:
            _bind_team(lib)
        _check_robots(lib, path, m)
        _check_geometry(lib, path, m, staged_tiles.k3_geometry(m), staged_tiles.k5_geometry(m),
                        staged_tiles.k4_geometry(m), staged_tiles.k6_geometry(m))
        build_info[m] = {"path": str(path), "seconds": seconds, "ptxas": "".join(texts)}
        _libs["solver", m] = lib
        return lib


def bind_k3(lib: ctypes.CDLL) -> ctypes.CDLL:
    """The entry points of a csrc/riccati_shape.cu library: nmpc_riccati,
    nmpc_k3_shape, nmpc_k3_geometry, and where built in nmpc_k3_rtile and
    (-DNMPC_K3_PROBES) nmpc_k3_phases."""
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.nmpc_error_string.argtypes = [I]
    lib.nmpc_error_string.restype = ctypes.c_char_p
    lib.nmpc_k3_shape.argtypes = [P]
    lib.nmpc_k3_shape.restype = None
    lib.nmpc_k3_geometry.argtypes = [P]
    lib.nmpc_k3_geometry.restype = None
    lib.nmpc_riccati.argtypes = [P] * 11 + [I] * 2 + [F] + [P]
    lib.nmpc_riccati.restype = I
    if hasattr(lib, "nmpc_k3_rtile"):
        lib.nmpc_k3_rtile.argtypes = []
        lib.nmpc_k3_rtile.restype = I
    if hasattr(lib, "nmpc_k3_phases"):
        lib.nmpc_k3_phases.argtypes = [P, I]
        lib.nmpc_k3_phases.restype = I
    return lib


def k3_library(shape: tuple, flags: list, src: Path = SRC_DIR) -> tuple:
    """riccati_shape.cu of the source directory `src` (this package's csrc,
    or another checkout's: tools/k3_ab.py) at the stage shape `shape` with
    K3's -D flags `flags`, built into BUILD_DIR unless there (its name keyed
    by those sources and flags) and bound. Returns (library, path, seconds,
    compiler report)."""
    n, nu = shape
    stem = f"libnmpc_k3_n{n}_nu{nu}_{_key(K3_SHAPE_SOURCES, 0, tuple(flags), src)}"
    path, seconds, texts = _build(stem, [("riccati_shape.cu", flags)], f"K3, n={n} nu={nu}", src)
    return bind_k3(ctypes.CDLL(str(path))), path, seconds, texts[0]


def load_k3_shape(n: int, nu: int, g=None) -> ctypes.CDLL:
    """K3's library at the stage shape (n, nu) (csrc/riccati_shape.cu at
    staged_tiles.k3_geometry's pick, or at the K3 geometry g: the K3 sweep
    of tools/staged_launch.py; the entry points nmpc_riccati and
    nmpc_k3_geometry as the solver library's), built first if needed; its
    build in k3_shape_build_info[(n, nu)] (at another geometry than the
    pick [(n, nu), g]). Any n, nu >= 1 (others raise)."""
    shape = (n, nu)
    pick = staged_tiles.k3_geometry(shape)   # raises outside the range
    g = pick if g is None else g
    key = shape if g == pick else (shape, g)
    with _lock("k3", key):
        if ("k3", key) in _libs:
            return _libs["k3", key]
        lib, path, seconds, text = k3_library(shape, staged_tiles.k3_shape_flags(shape, g))
        got = (ctypes.c_int * 2)()
        lib.nmpc_k3_shape(got)
        want = _k3_want(shape, g)
        if tuple(got) != shape or k3_geometry(lib) != want:
            raise RuntimeError(f"{path}: built for {tuple(got)} with {k3_geometry(lib)}, "
                               f"expected {shape} with {want}")
        k3_shape_build_info[key] = {"path": str(path), "seconds": seconds, "ptxas": text}
        _libs["k3", key] = lib
        return lib


def load_k3(n: int, nu: int) -> ctypes.CDLL:
    """The library whose nmpc_riccati takes stage blocks of (n, nu): the
    solver library of m robots at (3m, 2m) (past MEGA_MAX_ROBOTS where it is
    loaded already, as the staged route's K4 loads it), else K3's at that
    shape: a K3 alone at a wide robot stack's shape does not build K4-K6,
    whose pair rows take minutes to compile there."""
    m = n // 3
    if n == 3 * m and nu == 2 * m and (1 <= m <= MEGA_MAX_ROBOTS or ("solver", m) in _libs):
        return load(m)
    return load_k3_shape(n, nu)


def load_tools(m: int) -> ctypes.CDLL:
    """The roofline tools' kernel library (K7-K9) for m robots, built first
    if needed: the parts of csrc/tools.cu (TOOLS_PARTS), one nvcc process
    each. m in ROBOT_COUNTS (the tools ablate the registry's fleets)."""
    if m not in ROBOT_COUNTS:
        raise NotImplementedError(
            f"the roofline tools' kernels are built for m in {ROBOT_COUNTS}, not m={m}")
    with _lock("tools", m):
        if ("tools", m) in _libs:
            return _libs["tools", m]
        path, seconds, texts = _build(
            f"libnmpc_tools_m{m}_{_key(TOOLS_SOURCES, m)}",
            [("tools.cu", [f"-DNMPC_NR={m}", f"-DNMPC_TOOLS_PART={i}"])
             for i in range(len(TOOLS_PARTS))], f"tools, m={m}")
        lib = _bind_tools(ctypes.CDLL(str(path)))
        _check_robots(lib, path, m)
        tools_build_info[m] = {"path": str(path), "seconds": seconds,
                               "ptxas": dict(zip(TOOLS_PARTS, texts))}
        _libs["tools", m] = lib
        return lib


def load_first(m: int) -> ctypes.CDLL:
    """The library of the staged kernels' first designs (csrc/staged_first.cu)
    for m robots (m <= MEGA_MAX_ROBOTS: the A/B baselines of the robot
    counts the megakernel route takes), built first if needed."""
    _require_robots(m, MEGA_MAX_ROBOTS, "the staged kernels' first designs")
    with _lock("first", m):
        if ("first", m) in _libs:
            return _libs["first", m]
        path, seconds, texts = _build(f"libnmpc_first_m{m}_{_key(FIRST_SOURCES, m)}",
                                      [("staged_first.cu", [f"-DNMPC_NR={m}"])], f"first, m={m}")
        lib = _bind_first(ctypes.CDLL(str(path)))
        _check_robots(lib, path, m)
        first_build_info[m] = {"path": str(path), "seconds": seconds, "ptxas": texts[0]}
        _libs["first", m] = lib
        return lib


def load_staged_variant(m: int, k3=None, k5=None, k4=None, k6=None) -> tuple:
    """staged.cu alone for m robots at K3-K6 geometries k3, k5, k4, k6
    (staged_tiles.K3Geometry, ...; the solver's pick where None; the sweep of
    tools/staged_launch.py; any m >= 1). Returns (library, compiler report)."""
    _require_robots(m, None, "K3-K6")
    k3 = staged_tiles.k3_geometry(m) if k3 is None else k3
    k5 = staged_tiles.k5_geometry(m) if k5 is None else k5
    k4 = staged_tiles.k4_geometry(m) if k4 is None else k4
    k6 = staged_tiles.k6_geometry(m) if k6 is None else k6
    flags = [f"-DNMPC_NR={m}", "-DNMPC_STAGED_ALONE",
             *staged_tiles.nvcc_flags(m, k3, k5, k4, k6)]
    tag = "_".join(f.split("=")[1] for f in flags[2:])
    path, _, texts = _build(f"libnmpc_staged_m{m}_{tag}_{_key(SOURCES, m)}",
                            [("staged.cu", flags)], f"staged, m={m} {' '.join(flags[2:])}")
    lib = _bind_staged(_bind_errors(ctypes.CDLL(str(path))))
    _check_robots(lib, path, m)
    _check_geometry(lib, path, m, k3, k5, k4, k6)
    return lib, texts[0]


# the team design's compile-time settings (csrc/inner_team.cuh, megasolve.cu)
# that load_k1_variant takes, by their -D macro
TEAM_SETTINGS = {"T": "NMPC_K1_TEAM", "D": "NMPC_K1_TEAM_RING",
                 "min_blocks": "NMPC_K1_TEAM_MIN_BLOCKS"}


def load_k1_variant(m: int, min_blocks: int | None = None, probes: bool = False,
                    team: dict | None = None) -> tuple:
    """megasolve.cu alone for m robots, built with K1's register cap set to
    `min_blocks` blocks of 128 threads per SM (-DNMPC_K1_MIN_BLOCKS; the
    launch-geometry sweep of tools/k1_launch.py), with the team design's
    settings `team` ({"T": 4, "D": 2, ...}, keys of TEAM_SETTINGS; m in
    TEAM_ROBOTS) and/or with K1's phase probes (-DNMPC_K1_PROBES, which adds
    `nmpc_phases`; tools/k1_phases.py). Returns (library, compiler report)."""
    _require_robots(m, MEGA_MAX_ROBOTS, "K1 and K2")
    flags = [f"-DNMPC_NR={m}"]
    tag = ""
    if min_blocks is not None:
        flags.append(f"-DNMPC_K1_MIN_BLOCKS={min_blocks}")
        tag += f"_c{min_blocks}"
    for key, value in sorted((team or {}).items()):
        if m not in TEAM_ROBOTS:
            raise NotImplementedError(f"K1's team design is built for m in {TEAM_ROBOTS}")
        flags.append(f"-D{TEAM_SETTINGS[key]}={int(value)}")
        tag += f"_{key}{int(value)}"
    if probes:
        flags.append("-DNMPC_K1_PROBES")
        tag += "_probes"
    path, _, texts = _build(f"libnmpc_k1_m{m}{tag}_{_key(SOURCES, m)}",
                            [("megasolve.cu", flags)], f"K1, m={m} {' '.join(flags[1:])}")
    lib = _bind_mega(ctypes.CDLL(str(path)))
    if m in TEAM_ROBOTS:
        _bind_team(lib)
    if probes:
        lib.nmpc_phases.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.nmpc_phases.restype = ctypes.c_int
    _check_robots(lib, path, m)
    return lib, texts[0]


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a launch reported a CUDA error (cudaGetLastError != 0)."""
    if err != 0:
        msg = lib.nmpc_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA launch failed with error {err}: {msg}")


def load_all(k3_shapes: tuple = staged_tiles.K3_SHAPES) -> dict[int, ctypes.CDLL]:
    """Build (every source of every instantiation in its own nvcc process,
    all started together) and load every solver instantiation, K3 at each
    stage shape of k3_shapes, the tools library for the main path's
    BENCH_ROBOTS and the first designs' for FIRST_ROBOTS. Returns the
    solver libraries by m."""
    workers = len(ROBOT_COUNTS) + 1 + len(FIRST_ROBOTS) + len(k3_shapes)
    with ThreadPoolExecutor(max_workers=workers) as pool:
        others = [pool.submit(load_tools, BENCH_ROBOTS)]
        others += [pool.submit(load_first, m) for m in FIRST_ROBOTS]
        others += [pool.submit(load_k3_shape, *shape) for shape in k3_shapes]
        libs = list(pool.map(load, ROBOT_COUNTS))
        for f in others:
            f.result()
    return dict(zip(ROBOT_COUNTS, libs))


# ---------------------------------------------------------------------------
# What the wrappers share
# ---------------------------------------------------------------------------


def check_arg(name: str, t: torch.Tensor, shape: tuple, device) -> None:
    """Raise unless t is a float32 tensor of `shape` on `device`."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} has dtype {t.dtype}, the kernels take float32")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")


def lane(t: torch.Tensor) -> torch.Tensor:
    """Standard [B, ...] -> lane-major [..., B], contiguous."""
    return t.movedim(0, -1).contiguous()


def std(t: torch.Tensor) -> torch.Tensor:
    """Lane-major [..., B] -> standard [B, ...], contiguous."""
    return t.movedim(-1, 0).contiguous()


def ptr(t: torch.Tensor | None) -> ctypes.c_void_p:
    """The data pointer of a contiguous tensor (None: a null pointer)."""
    if t is None:
        return ctypes.c_void_p(None)
    if not t.is_contiguous():
        raise ValueError("the kernels take contiguous tensors")
    return ctypes.c_void_p(t.data_ptr())


def stream(device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
