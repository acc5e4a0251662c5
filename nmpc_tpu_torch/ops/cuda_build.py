"""Build and bind the CUDA kernels of csrc/ (nvcc into a shared library with
a plain C interface, loaded with ctypes), and what every kernel wrapper
shares: the launch counters, argument checks, pointers and the lane-major
layout.

The solver's kernels: one library per robot count m, `csrc/megasolve.cu`
(K1, K2; device code in `csrc/inner_warp.cuh`) and `csrc/staged.cu`
(K3-K6; K3's and K5's device code in `csrc/staged_tiles.cuh`), each compiled
by its own nvcc process with -DNMPC_NR=m (staged.cu also with K3's and K5's
launch geometry from ops/staged_tiles.py), linked together (`load`). K3's
and K5's first designs (`csrc/staged_first.cu`, the A/B baselines of
tools/staged_launch.py) are a library of their own per m (`load_first`),
and so is staged.cu at another geometry (`load_staged_variant`, the sweep's).
The roofline tools' K7-K9
(`csrc/tools.cu`) are a library of their own (`load_tools`), so the solver
library's kernel set, build time and code generation stay as they are: nine
nvcc processes, one per part of tools.cu. A library is built at its first use
from the sources in the checkout into `nmpc_tpu_torch/_build/`, named by a
hash of the sources (the headers they include too) and flags so a stale build
is never loaded, and reused from there afterwards. Nothing here runs at
import time.
"""

from __future__ import annotations

import ctypes
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
SOURCES = (*UNITS, "inner_warp.cuh", "inner_team.cuh", "staged.cuh", "staged_tiles.cuh",
           "expansions_rollout_tiles.cuh", "riccati.cuh", "rollout.cuh")
# K3 at a stage shape other than (3m, 2m), a library per shape
K3_SHAPE_SOURCES = ("riccati_shape.cu", "staged_tiles.cuh", "staged.cuh", "riccati.cuh",
                    "rollout.cuh")
FIRST_SOURCES = ("staged_first.cu", "staged.cuh", "riccati.cuh", "rollout.cuh")
TOOLS_SOURCES = ("tools.cu", "tools.cuh", "megasolve.cuh", "riccati.cuh", "rollout.cuh")
# the parts of tools.cu (-DNMPC_TOOLS_PART=i), one nvcc process each
TOOLS_PARTS = ("K7", "K8 full, early exit", "K8 full", "K8 inv_solve", "K8 no_ls",
               "K8 no_solve", "K8 no_expcon", "K8 sweep_only", "K9 dense")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# robot counts of the scenario registry; one library each
ROBOT_COUNTS = (1, 2, 3, 4, 5, 6, 8, 10)
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

_locks = {(kind, m): threading.Lock() for kind in ("solver", "tools", "first")
          for m in ROBOT_COUNTS}
_locks_guard = threading.Lock()   # creates the lock of a new K3 shape
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
    for k in launch_counts:
        launch_counts[k] = 0


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


def _key(sources: tuple, m: int, flags: tuple = ()) -> str:
    h = hashlib.sha256()
    for name in sources:
        h.update(name.encode())
        h.update((SRC_DIR / name).read_bytes())
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
    lib.nmpc_k3_geometry.argtypes = [P]
    lib.nmpc_k3_geometry.restype = None
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
    lib.nmpc_rollout_alpha.argtypes = [P] * 9 + [I] * 2 + [P]
    lib.nmpc_rollout_alpha.restype = I
    return lib


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    return _bind_staged(_bind_mega(lib))


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
    return lib


def _run(cmd: list[str], what: str) -> str:
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {what} (exit {proc.returncode}):\n"
                           f"{proc.stdout}\n{proc.stderr}")
    return proc.stdout + proc.stderr


def _build(stem: str, jobs: list, what: str) -> tuple:
    """Compile each (source, extra nvcc flags) job in its own nvcc process,
    all at once, and link the objects into BUILD_DIR/<stem>.so, unless that
    exists. Returns (path, seconds (0.0 when reused), the compiler report of
    each job)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    path = BUILD_DIR / f"{stem}.so"
    logs = [BUILD_DIR / f"{stem}.{i}.log" for i in range(len(jobs))]
    seconds = 0.0
    if not path.exists():
        tmp = f"{stem}.{os.getpid()}.{threading.get_ident()}"
        objs = [BUILD_DIR / f"{tmp}.{i}.o" for i in range(len(jobs))]
        t0 = time.perf_counter()

        def compile_one(obj, job):
            src, flags = job
            return _run([nvcc(), *NVCC_FLAGS, *flags, "-c", "-o", str(obj), str(SRC_DIR / src)],
                        f"{src} {' '.join(flags)} ({what})")

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


def _check_robots(lib: ctypes.CDLL, path, m: int) -> None:
    if lib.nmpc_robots() != m:
        raise RuntimeError(f"{path} was built for m={lib.nmpc_robots()}, not {m}")


def k3_geometry(lib: ctypes.CDLL) -> dict:
    """K3's geometry as a library was built with (nmpc_k3_geometry)."""
    g = (ctypes.c_int * 8)()
    lib.nmpc_k3_geometry(g)
    return dict(zip(("S", "D", "T", "P", "spill", "threads", "smem_bytes", "scratch_floats"), g))


def k5_geometry(lib: ctypes.CDLL, rows: int, prm_size: int) -> dict:
    """K5's geometry as a library was built with, and its shared bytes at
    `rows` stage rows and a parameter block of prm_size floats."""
    g = (ctypes.c_int * 4)()
    lib.nmpc_k5_geometry(rows, prm_size, g)
    return dict(zip(("S", "D", "max_alphas", "smem_bytes"), g))


def k4_geometry(lib: ctypes.CDLL, rows: int, prm_size: int) -> dict:
    """K4's geometry as a library was built with, and its shared bytes at
    `rows` input rows and a parameter block of prm_size floats."""
    g = (ctypes.c_int * 4)()
    lib.nmpc_k4_geometry(rows, prm_size, g)
    return dict(zip(("S", "W", "threads", "smem_bytes"), g))


def k6_geometry(lib: ctypes.CDLL) -> dict:
    """K6's geometry as a library was built with (nmpc_k6_geometry)."""
    g = (ctypes.c_int * 5)()
    lib.nmpc_k6_geometry(g)
    return dict(zip(("S", "D", "T", "threads", "smem_bytes"), g))


def _check_geometry(lib: ctypes.CDLL, path, m: int, k3, k5, k4, k6) -> None:
    """Raise unless the library's K3-K6 constants are the ones
    ops/staged_tiles.py asked for and sizes."""
    lay = staged_tiles.k3_layout(m, k3)
    want = {"K3": {"S": k3.S, "D": k3.D, "T": k3.T, "P": k3.P, "spill": int(k3.spill),
                   "threads": lay["threads"], "smem_bytes": lay["smem_bytes"],
                   "scratch_floats": lay["scratch_floats"]}}
    rows = staged_tiles.k5_rows(m, True, 1, 1)
    want["K5"] = {"S": k5.S, "D": k5.D, "max_alphas": staged_tiles.K5_THREADS // k5.S,
                  "smem_bytes": staged_tiles.k5_layout(m, rows, 100, 1, k5)["smem_bytes"]}
    rows4 = staged_tiles.k4_rows(m, True, 1, 1)
    lay4, lay6 = staged_tiles.k4_layout(m, rows4, 100, k4), staged_tiles.k6_layout(m, k6)
    want["K4"] = {"S": k4.S, "W": k4.W, "threads": lay4["threads"],
                  "smem_bytes": lay4["smem_bytes"]}
    want["K6"] = {"S": k6.S, "D": k6.D, "T": k6.T, "threads": lay6["threads"],
                  "smem_bytes": lay6["smem_bytes"]}
    got = {"K3": k3_geometry(lib), "K5": k5_geometry(lib, rows, 100),
           "K4": k4_geometry(lib, rows4, 100), "K6": k6_geometry(lib)}
    if got != want:
        raise RuntimeError(f"{path}: staged kernels' geometry {got}, expected {want}")


def load(m: int) -> ctypes.CDLL:
    """The solver's kernel library (K1-K6) for m robots, built first if
    needed."""
    if m not in ROBOT_COUNTS:
        raise NotImplementedError(
            f"CUDA kernels are instantiated for m in {ROBOT_COUNTS}, not m={m}")
    with _locks["solver", m]:
        if ("solver", m) in _libs:
            return _libs["solver", m]
        geom = staged_tiles.nvcc_flags(m)
        path, seconds, texts = _build(
            f"libnmpc_m{m}_{_key(SOURCES, m, tuple(geom))}",
            [("megasolve.cu", [f"-DNMPC_NR={m}"]), ("staged.cu", [f"-DNMPC_NR={m}", *geom])],
            f"m={m}")
        lib = _bind(ctypes.CDLL(str(path)))
        if m in TEAM_ROBOTS:
            _bind_team(lib)
        _check_robots(lib, path, m)
        _check_geometry(lib, path, m, staged_tiles.k3_geometry(m), staged_tiles.K5_GEOMETRY[m],
                        staged_tiles.K4_GEOMETRY[m], staged_tiles.K6_GEOMETRY[m])
        build_info[m] = {"path": str(path), "seconds": seconds, "ptxas": "".join(texts)}
        _libs["solver", m] = lib
        return lib


def load_k3_shape(n: int, nu: int) -> ctypes.CDLL:
    """K3's library at the stage shape (n, nu) (csrc/riccati_shape.cu at
    staged_tiles.k3_geometry's pick; the entry points nmpc_riccati and
    nmpc_k3_geometry as the solver library's), built first if needed. Any
    n <= staged_tiles.K3_MAX_N and nu <= K3_MAX_NU; others raise."""
    shape = (n, nu)
    g = staged_tiles.k3_geometry(shape)   # raises outside the range
    with _locks_guard:
        lock = _locks.setdefault(("k3", shape), threading.Lock())
    with lock:
        if ("k3", shape) in _libs:
            return _libs["k3", shape]
        flags = staged_tiles.k3_shape_flags(shape)
        path, seconds, texts = _build(f"libnmpc_k3_n{n}_nu{nu}_{_key(K3_SHAPE_SOURCES, 0, tuple(flags))}",
                                      [("riccati_shape.cu", flags)], f"K3, n={n} nu={nu}")
        lib = ctypes.CDLL(str(path))
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.nmpc_error_string.argtypes = [I]
        lib.nmpc_error_string.restype = ctypes.c_char_p
        lib.nmpc_k3_shape.argtypes = [P]
        lib.nmpc_k3_shape.restype = None
        lib.nmpc_k3_geometry.argtypes = [P]
        lib.nmpc_k3_geometry.restype = None
        lib.nmpc_riccati.argtypes = [P] * 11 + [I] * 2 + [F] + [P]
        lib.nmpc_riccati.restype = I
        got = (ctypes.c_int * 2)()
        lib.nmpc_k3_shape(got)
        lay = staged_tiles.k3_layout(shape)
        want = {"S": g.S, "D": g.D, "T": g.T, "P": g.P, "spill": int(g.spill),
                "threads": lay["threads"], "smem_bytes": lay["smem_bytes"],
                "scratch_floats": lay["scratch_floats"]}
        if tuple(got) != shape or k3_geometry(lib) != want:
            raise RuntimeError(f"{path}: built for {tuple(got)} with {k3_geometry(lib)}, "
                               f"expected {shape} with {want}")
        k3_shape_build_info[shape] = {"path": str(path), "seconds": seconds, "ptxas": texts[0]}
        _libs["k3", shape] = lib
        return lib


def load_k3(n: int, nu: int) -> ctypes.CDLL:
    """The library whose nmpc_riccati takes stage blocks of (n, nu): the
    solver library of m robots at (3m, 2m), else K3's at that shape."""
    m = n // 3
    if n == 3 * m and nu == 2 * m and m in ROBOT_COUNTS:
        return load(m)
    return load_k3_shape(n, nu)


def load_tools(m: int) -> ctypes.CDLL:
    """The roofline tools' kernel library (K7-K9) for m robots, built first
    if needed: the nine parts of csrc/tools.cu, one nvcc process each."""
    if m not in ROBOT_COUNTS:
        raise NotImplementedError(
            f"CUDA kernels are instantiated for m in {ROBOT_COUNTS}, not m={m}")
    with _locks["tools", m]:
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
    for m robots, built first if needed."""
    if m not in ROBOT_COUNTS:
        raise NotImplementedError(
            f"CUDA kernels are instantiated for m in {ROBOT_COUNTS}, not m={m}")
    with _locks["first", m]:
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
    tools/staged_launch.py). Returns (library, compiler report)."""
    if m not in ROBOT_COUNTS:
        raise NotImplementedError(
            f"CUDA kernels are instantiated for m in {ROBOT_COUNTS}, not m={m}")
    k3 = staged_tiles.k3_geometry(m) if k3 is None else k3
    k5 = staged_tiles.K5_GEOMETRY[m] if k5 is None else k5
    k4 = staged_tiles.K4_GEOMETRY[m] if k4 is None else k4
    k6 = staged_tiles.K6_GEOMETRY[m] if k6 is None else k6
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
    if m not in ROBOT_COUNTS:
        raise NotImplementedError(
            f"CUDA kernels are instantiated for m in {ROBOT_COUNTS}, not m={m}")
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
