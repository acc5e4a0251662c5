"""Build and bind the CUDA kernels of csrc/ (nvcc into a shared library with
a plain C interface, loaded with ctypes), and what every kernel wrapper
shares: the launch counters, argument checks, pointers and the lane-major
layout.

One library per robot count m: `csrc/megasolve.cu` (K1, K2) and
`csrc/staged.cu` (K3-K6), each compiled by its own nvcc process with
-DNMPC_NR=m, linked together. A library is built at its first use from the
sources in the checkout into `nmpc_tpu_torch/_build/`, named by a hash of
the sources and flags so a stale build is never loaded, and reused from
there afterwards. Nothing here runs at import time.
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

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
UNITS = ("megasolve.cu", "staged.cu")       # one nvcc process each
SOURCES = (*UNITS, "megasolve.cuh", "staged.cuh", "riccati.cuh", "rollout.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# robot counts of the scenario registry; one library each
ROBOT_COUNTS = (1, 2, 3, 4, 5, 6, 8, 10)

# Kernel launches since the last reset: each wrapper adds one where it
# launches its CUDA kernel, and nowhere else.
launch_counts = {"inner_solve_fused": 0, "al_update_lanes": 0,
                 "expansions_fused": 0, "riccati_lanes": 0,
                 "linesearch_costs_lanes": 0, "rollout_alpha_lanes": 0}

_locks = {m: threading.Lock() for m in ROBOT_COUNTS}
_libs: dict[int, ctypes.CDLL] = {}
# per m: {"path", "seconds" (0.0 when reused), "ptxas" (compiler report)}
build_info: dict[int, dict] = {}


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


def _key(m: int) -> str:
    h = hashlib.sha256()
    for name in SOURCES:
        h.update(name.encode())
        h.update((SRC_DIR / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    h.update(str(m).encode())
    return h.hexdigest()[:16]


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.nmpc_robots.argtypes = []
    lib.nmpc_robots.restype = I
    lib.nmpc_error_string.argtypes = [I]
    lib.nmpc_error_string.restype = ctypes.c_char_p
    lib.nmpc_inner_solve.argtypes = [P] * 12 + [I] * 7 + [F] * 6 + [P]
    lib.nmpc_inner_solve.restype = I
    lib.nmpc_al_update.argtypes = [P] * 7 + [I] * 3 + [F] + [P]
    lib.nmpc_al_update.restype = I
    lib.nmpc_expansions.argtypes = [P, I] + [P] * 13 + [I] * 5 + [P]
    lib.nmpc_expansions.restype = I
    lib.nmpc_riccati.argtypes = [P] * 10 + [I] * 2 + [F] + [P]
    lib.nmpc_riccati.restype = I
    lib.nmpc_linesearch_costs.argtypes = [P, I] + [P] * 10 + [I] * 6 + [P]
    lib.nmpc_linesearch_costs.restype = I
    lib.nmpc_rollout_alpha.argtypes = [P] * 9 + [I] * 2 + [P]
    lib.nmpc_rollout_alpha.restype = I
    return lib


def _run(cmd: list[str], what: str) -> str:
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {what} (exit {proc.returncode}):\n"
                           f"{proc.stdout}\n{proc.stderr}")
    return proc.stdout + proc.stderr


def load(m: int) -> ctypes.CDLL:
    """The kernel library for m robots, built first if needed."""
    if m not in ROBOT_COUNTS:
        raise NotImplementedError(
            f"CUDA kernels are instantiated for m in {ROBOT_COUNTS}, not m={m}")
    with _locks[m]:
        if m in _libs:
            return _libs[m]
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        stem = f"libnmpc_m{m}_{_key(m)}"
        path = BUILD_DIR / f"{stem}.so"
        log = BUILD_DIR / f"{stem}.log"
        seconds = 0.0
        if not path.exists():
            tmp = f"{stem}.{os.getpid()}.{threading.get_ident()}"
            objs = [BUILD_DIR / f"{tmp}.{unit}.o" for unit in UNITS]
            t0 = time.perf_counter()
            try:
                with ThreadPoolExecutor(max_workers=len(UNITS)) as pool:
                    logs = list(pool.map(
                        lambda uo: _run([nvcc(), *NVCC_FLAGS, f"-DNMPC_NR={m}", "-c",
                                         "-o", str(uo[1]), str(SRC_DIR / uo[0])],
                                        f"{uo[0]}, m={m}"),
                        zip(UNITS, objs)))
                so = BUILD_DIR / f"{tmp}.so"
                _run([nvcc(), "-shared", "-gencode", "arch=compute_90a,code=sm_90a",
                      "-o", str(so), *map(str, objs)], f"linking m={m}")
            finally:
                for o in objs:
                    o.unlink(missing_ok=True)
            seconds = time.perf_counter() - t0
            log.write_text("".join(logs))
            os.replace(so, path)  # atomic: a concurrent loader sees all or nothing
        lib = _bind(ctypes.CDLL(str(path)))
        if lib.nmpc_robots() != m:
            raise RuntimeError(f"{path} was built for m={lib.nmpc_robots()}, not {m}")
        build_info[m] = {"path": str(path), "seconds": seconds,
                         "ptxas": log.read_text() if log.exists() else ""}
        _libs[m] = lib
        return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a launch reported a CUDA error (cudaGetLastError != 0)."""
    if err != 0:
        msg = lib.nmpc_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA launch failed with error {err}: {msg}")


def load_all() -> dict[int, ctypes.CDLL]:
    """Build (every source of every instantiation in its own nvcc process,
    all started together) and load every instantiation."""
    with ThreadPoolExecutor(max_workers=len(ROBOT_COUNTS)) as pool:
        libs = list(pool.map(load, ROBOT_COUNTS))
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
