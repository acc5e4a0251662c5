"""ctypes bindings for the native host runtime (native/nmpc_rt.cpp). Port of
nmpc_tpu/io/bridge.py.

The C++ layer replaces rospy/TCPROS: a seqlock topic bus with tear-free
latching, a UDP transport for real robots, and a drift-free monotonic rate
keeper replacing time.sleep(T) pacing.

The shared library is built on first use with g++ from the checkout's
native/nmpc_rt.cpp into nmpc_tpu_torch/_build/ (named by a hash of the
source and flags), under a file lock, so that processes running at once
(pytest workers, the JAX package's own build in native/build/) never write
the same file.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import socket
import subprocess
import threading
from pathlib import Path

import numpy as np

_NATIVE_SRC = Path(__file__).resolve().parents[2] / "native" / "nmpc_rt.cpp"
_BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
_CXXFLAGS = ("-O2", "-std=c++17", "-fPIC", "-Wall", "-shared", "-pthread")
_lock = threading.Lock()
_lib = None


def _so_path() -> Path:
    h = hashlib.sha256(_NATIVE_SRC.read_bytes())
    h.update(" ".join(_CXXFLAGS).encode())
    return _BUILD_DIR / f"libnmpc_rt_{h.hexdigest()[:16]}.so"


def ensure_built() -> ctypes.CDLL:
    """Build (if needed) and load the native runtime."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        so = _so_path()
        if not so.exists():
            _BUILD_DIR.mkdir(parents=True, exist_ok=True)
            with open(_BUILD_DIR / "libnmpc_rt.lock", "w") as lock:
                fcntl.flock(lock, fcntl.LOCK_EX)
                if not so.exists():
                    tmp = so.with_suffix(f".{os.getpid()}.tmp")
                    subprocess.run([os.environ.get("CXX", "g++"), *_CXXFLAGS, "-o", str(tmp),
                                    str(_NATIVE_SRC)], check=True)
                    os.replace(tmp, so)
        lib = ctypes.CDLL(str(so))
        P, I, D = ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_double)
        lib.nmpc_bus_create.restype = P
        lib.nmpc_bus_create.argtypes = [I]
        lib.nmpc_bus_destroy.argtypes = [P]
        lib.nmpc_bus_publish.restype = I
        lib.nmpc_bus_publish.argtypes = [P, I, D, I]
        lib.nmpc_bus_latch.restype = I
        lib.nmpc_bus_latch.argtypes = [P, I, D, I, ctypes.POINTER(ctypes.c_uint64)]
        lib.nmpc_udp_pub_open.restype = I
        lib.nmpc_udp_pub_open.argtypes = [ctypes.c_char_p, I]
        lib.nmpc_udp_send.restype = I
        lib.nmpc_udp_send.argtypes = [I, I, D, I]
        lib.nmpc_udp_close.argtypes = [I]
        lib.nmpc_udp_sub_open.restype = P
        lib.nmpc_udp_sub_open.argtypes = [I, P]
        lib.nmpc_udp_sub_received.restype = ctypes.c_uint64
        lib.nmpc_udp_sub_received.argtypes = [P]
        lib.nmpc_udp_sub_close.argtypes = [P]
        lib.nmpc_rate_create.restype = P
        lib.nmpc_rate_create.argtypes = [ctypes.c_double]
        lib.nmpc_rate_sleep.restype = ctypes.c_uint64
        lib.nmpc_rate_sleep.argtypes = [P]
        lib.nmpc_rate_destroy.argtypes = [P]
        lib.nmpc_now_ns.restype = ctypes.c_uint64
        _lib = lib
        return lib


def _dptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


class Bus:
    """Latched topic bus: one slot of up to 64 doubles per topic id."""

    def __init__(self, num_topics: int):
        self._lib = ensure_built()
        self._h = self._lib.nmpc_bus_create(num_topics)
        self.num_topics = num_topics

    def publish(self, topic: int, values) -> None:
        a = np.ascontiguousarray(values, dtype=np.float64).reshape(-1)
        rc = self._lib.nmpc_bus_publish(self._h, topic, _dptr(a), a.size)
        if rc != 0:
            raise ValueError(f"publish failed (topic {topic}, n={a.size})")

    def latch(self, topic: int, count: int):
        """Tear-free read of the latest value; returns (array|None, stamp_ns)."""
        out = np.empty(count, np.float64)
        stamp = ctypes.c_uint64(0)
        n = self._lib.nmpc_bus_latch(self._h, topic, _dptr(out), count, ctypes.byref(stamp))
        if n < 0:
            raise RuntimeError(f"latch failed rc={n}")
        if n == 0:
            return None, 0
        return out[:n], stamp.value

    def close(self):
        if self._h:
            self._lib.nmpc_bus_destroy(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def free_udp_port() -> int:
    """A UDP port on 127.0.0.1 that no socket holds now, for a subscriber
    that must not share its port with another run's (the native subscriber
    binds with SO_REUSEADDR, so two of them on one fixed number would read
    each other's datagrams)."""
    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class UdpPublisher:
    def __init__(self, host: str, port: int):
        self._lib = ensure_built()
        self._fd = self._lib.nmpc_udp_pub_open(host.encode(), port)
        if self._fd < 0:
            raise OSError(f"udp pub open failed {host}:{port}")

    def send(self, topic: int, values) -> None:
        a = np.ascontiguousarray(values, dtype=np.float64).reshape(-1)
        if self._lib.nmpc_udp_send(self._fd, topic, _dptr(a), a.size) != 0:
            raise OSError("udp send failed")

    def close(self):
        if self._fd >= 0:
            self._lib.nmpc_udp_close(self._fd)
            self._fd = -1


class UdpSubscriber:
    """Background receiver latching datagrams into a Bus."""

    def __init__(self, port: int, bus: Bus):
        self._lib = ensure_built()
        self._h = self._lib.nmpc_udp_sub_open(port, bus._h)
        if not self._h:
            raise OSError(f"udp sub open failed on port {port}")

    @property
    def received(self) -> int:
        return int(self._lib.nmpc_udp_sub_received(self._h))

    def close(self):
        if self._h:
            self._lib.nmpc_udp_sub_close(self._h)
            self._h = None


class Rate:
    """Absolute-deadline rate keeper (no drift; counts missed deadlines)."""

    def __init__(self, period_s: float):
        self._lib = ensure_built()
        self._h = self._lib.nmpc_rate_create(period_s)

    def sleep(self) -> int:
        return int(self._lib.nmpc_rate_sleep(self._h))

    def close(self):
        if self._h:
            self._lib.nmpc_rate_destroy(self._h)
            self._h = None
