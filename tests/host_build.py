"""g++ builds of the host rehearsals (tests/*_host.cpp: the device code of
nmpc_tpu_torch/csrc compiled as host C++, the threads of a warp or block
run by tests/host_lanes.h), shared by every test file and xdist worker that
asks for the same one: a library is built once into
nmpc_tpu_torch/_build/host/ (git-ignored), named by a hash of the harness,
the headers it can include and the flags, and loaded from there while they
are unchanged. A build is written under a name of its own and renamed into
place, so two workers never load a half-written file."""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import pytest

from nmpc_tpu_torch.ops.cuda_build import BUILD_DIR, SRC_DIR

TESTS = Path(__file__).resolve().parent
FLAGS = ("-std=c++20", "-O1", "-shared", "-fPIC", "-ffp-contract=off", "-fno-strict-aliasing")
# seconds a build may take before the test that needs it fails
TIMEOUT = 600


def _key(harness: str, flags) -> str:
    h = hashlib.sha256()
    for path in (TESTS / harness, TESTS / "host_lanes.h", *sorted(SRC_DIR.glob("*.cuh"))):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    h.update(" ".join((*FLAGS, *flags)).encode())
    return h.hexdigest()[:16]


def build(harness: str, flags) -> ctypes.CDLL:
    """tests/<harness> built with `flags` (-D...), loaded; skips the test
    where g++ is missing."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed: the host rehearsal cannot be built")
    out = BUILD_DIR / "host"
    out.mkdir(parents=True, exist_ok=True)
    so = out / f"{Path(harness).stem}_{_key(harness, flags)}.so"
    if not so.exists():
        tmp = out / f"{so.stem}.{os.getpid()}.{threading.get_ident()}.tmp"
        try:
            subprocess.run([gxx, *FLAGS, *flags, f"-I{SRC_DIR}", str(TESTS / harness), "-o",
                            str(tmp)], check=True, capture_output=True, text=True,
                           timeout=TIMEOUT)
            os.replace(tmp, so)
        finally:
            tmp.unlink(missing_ok=True)
    return ctypes.CDLL(str(so))


def build_all(harness: str, flag_sets: dict) -> dict:
    """{key: build(harness, flags)} for {key: flags}, the builds in parallel."""
    with ThreadPoolExecutor(len(flag_sets)) as pool:
        return dict(zip(flag_sets, pool.map(lambda f: build(harness, f), flag_sets.values())))
