"""ctypes bindings for the native real-time executor (counterpart of
``runtime/native.py``): the dual-rate loop runner and the SPSC sensor ring
the reference implements with std::threads and a UDP receive thread
(MainHardware.cpp:85-130, HardwareA1ROS.cpp:89,245-378).

The port keeps its own copy of the C++ source, ``native/rt_executor.cc``.
It is compiled at first use with g++ into
``build/native/<source hash>/librt_executor.so`` at the repository root
(the CUDA sources' build, ``ops/kernels.py``, does the same with nvcc)."""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Callable, Optional

import numpy as np

_SOURCE = Path(__file__).resolve().parent.parent / "native" / "rt_executor.cc"
_BUILD = Path(__file__).resolve().parents[2] / "build" / "native"
CXX_FLAGS = ("-O3", "-Wall", "-std=c++17", "-fPIC", "-pthread", "-shared")

_CALLBACK = ctypes.CFUNCTYPE(None, ctypes.c_void_p, ctypes.c_int64)


def build() -> Path:
    """Compile ``native/rt_executor.cc`` unless a library of the current
    source and flags exists; returns its path."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(_SOURCE.read_bytes())
    out_dir = _BUILD / h.hexdigest()[:16]
    lib_path = out_dir / "librt_executor.so"
    if lib_path.exists():
        return lib_path
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f"librt_executor.{os.getpid()}.tmp"
    cxx = os.environ.get("CXX", "g++")
    out = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(_SOURCE)],
                         capture_output=True, text=True)
    if out.returncode != 0:
        raise RuntimeError(f"{cxx} failed for {_SOURCE.name}:\n"
                           f"{out.stdout}{out.stderr}")
    os.replace(tmp, lib_path)
    return lib_path


def _load() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    lib.rt_ring_create.restype = ctypes.c_void_p
    lib.rt_ring_create.argtypes = [ctypes.c_size_t, ctypes.c_size_t]
    lib.rt_ring_destroy.restype = None
    lib.rt_ring_destroy.argtypes = [ctypes.c_void_p]
    lib.rt_ring_push.restype = None
    lib.rt_ring_push.argtypes = [ctypes.c_void_p,
                                 ctypes.POINTER(ctypes.c_float)]
    lib.rt_ring_pop_latest.restype = ctypes.c_int
    lib.rt_ring_pop_latest.argtypes = [ctypes.c_void_p,
                                       ctypes.POINTER(ctypes.c_float)]
    lib.rt_ring_dropped.restype = ctypes.c_uint64
    lib.rt_ring_dropped.argtypes = [ctypes.c_void_p]
    lib.rt_loop_create.restype = ctypes.c_void_p
    lib.rt_loop_create.argtypes = [ctypes.c_int64, _CALLBACK,
                                   ctypes.c_void_p, ctypes.c_int]
    for name in ("rt_loop_start", "rt_loop_stop", "rt_loop_destroy"):
        getattr(lib, name).restype = None
        getattr(lib, name).argtypes = [ctypes.c_void_p]
    lib.rt_loop_stats.restype = None
    lib.rt_loop_stats.argtypes = [ctypes.c_void_p,
                                  ctypes.POINTER(ctypes.c_double)]
    return lib


_lib: Optional[ctypes.CDLL] = None


def lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        _lib = _load()
    return _lib


class SensorRing:
    """Lock-free SPSC ring of fixed-size float32 sensor frames. The producer
    (an I/O thread) pushes; the control loop pops the latest frame, the
    freshest-wins semantics of the reference's callbacks overwriting the
    blackboard."""

    def __init__(self, frame_len: int, capacity_pow2: int = 6):
        self.frame_len = frame_len
        self._h = lib().rt_ring_create(frame_len, capacity_pow2)

    def push(self, frame: np.ndarray) -> None:
        f = np.ascontiguousarray(frame, dtype=np.float32)
        if f.size != self.frame_len:
            raise ValueError(f"frame of {f.size} floats, ring takes "
                             f"{self.frame_len}")
        lib().rt_ring_push(
            self._h, f.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))

    def pop_latest(self) -> Optional[np.ndarray]:
        out = np.empty(self.frame_len, np.float32)
        n = lib().rt_ring_pop_latest(
            self._h, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
        return out if n > 0 else None

    @property
    def dropped(self) -> int:
        return int(lib().rt_ring_dropped(self._h))

    def __del__(self):
        if _lib is not None and getattr(self, "_h", None):
            _lib.rt_ring_destroy(self._h)


class RtLoop:
    """Fixed-period executor running ``fn(tick)`` on a native thread.

    ``compensate=True`` reproduces the hardware main's solve-time
    compensation (sleep = period - work, MainHardware.cpp:85-87);
    ``False`` is the sim mains' fixed schedule.

    An exception that ``fn`` raises fails the loop: the first one is kept,
    ``fn`` is not called again (the loop keeps its schedule and counts the
    ticks that do nothing), and :meth:`stop` raises it once the thread has
    joined."""

    def __init__(self, period_s: float, fn: Callable[[int], None],
                 compensate: bool = True):
        # the trampoline holds fn and this list, not self: a cycle through
        # self could let the collector run __del__ (a join) on the loop's
        # own thread
        errors: list = []

        def trampoline(_ctx, tick):
            if errors:
                return
            try:
                fn(int(tick))
            except BaseException as e:  # re-raised by stop()
                errors.append(e)

        self._errors = errors
        self._cb = _CALLBACK(trampoline)  # the native thread calls it
        self._h = lib().rt_loop_create(int(period_s * 1e9), self._cb, None,
                                       1 if compensate else 0)
        self._running = False

    def start(self) -> None:
        lib().rt_loop_start(self._h)
        self._running = True

    def stop(self) -> None:
        """Join the loop's thread; raise the first exception ``fn``
        raised, if any."""
        if self._running:
            lib().rt_loop_stop(self._h)
            self._running = False
        if self._errors:
            raise self._errors[0]

    @property
    def error(self) -> Optional[BaseException]:
        """The first exception ``fn`` raised, or None."""
        return self._errors[0] if self._errors else None

    def stats(self) -> dict:
        out = (ctypes.c_double * 7)()
        lib().rt_loop_stats(self._h, out)
        return {
            "iterations": int(out[0]),
            "missed_deadlines": int(out[1]),
            "last_work_ms": out[2] / 1e6,
            "max_work_ms": out[3] / 1e6,
            "mean_work_ms": out[4] / 1e6,
            "max_jitter_ms": out[5] / 1e6,
            "mean_jitter_ms": out[6] / 1e6,
        }

    def __del__(self):
        if _lib is not None and getattr(self, "_h", None):
            _lib.rt_loop_destroy(self._h)   # joins a running thread first
