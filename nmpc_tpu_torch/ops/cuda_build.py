"""Build and bind the CUDA kernels of csrc/ (nvcc into a shared library with
a plain C interface, loaded with ctypes).

One library per robot count m: `csrc/megasolve.cu` compiled with
-DNMPC_NR=m holds K1 and K2 for that m. A library is built at its first use
from the sources in the checkout into `nmpc_tpu_torch/_build/`, named by a
hash of the sources and flags so a stale build is never loaded, and reused
from there afterwards. Nothing here runs at import time.
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

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("megasolve.cu", "megasolve.cuh", "riccati.cuh", "rollout.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# robot counts of the scenario registry; one library each
ROBOT_COUNTS = (1, 2, 3, 4, 5, 6, 8, 10)

_locks = {m: threading.Lock() for m in ROBOT_COUNTS}
_libs: dict[int, ctypes.CDLL] = {}
# per m: {"path", "seconds" (0.0 when reused), "ptxas" (compiler report)}
build_info: dict[int, dict] = {}


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
    return lib


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
            tmp = BUILD_DIR / f"{stem}.{os.getpid()}.tmp.so"
            cmd = [nvcc(), *NVCC_FLAGS, f"-DNMPC_NR={m}", "-o", str(tmp),
                   str(SRC_DIR / "megasolve.cu")]
            t0 = time.perf_counter()
            proc = subprocess.run(cmd, capture_output=True, text=True)
            seconds = time.perf_counter() - t0
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(
                    f"nvcc failed for m={m} (exit {proc.returncode}):\n"
                    f"{proc.stdout}\n{proc.stderr}")
            log.write_text(proc.stdout + proc.stderr)
            os.replace(tmp, path)  # atomic: a concurrent loader sees all or nothing
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
    """Build (in parallel nvcc processes) and load every instantiation."""
    with ThreadPoolExecutor(max_workers=len(ROBOT_COUNTS)) as pool:
        libs = list(pool.map(load, ROBOT_COUNTS))
    return dict(zip(ROBOT_COUNTS, libs))
