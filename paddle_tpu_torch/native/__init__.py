"""Host C++ runtime of the port, built at first use with ``g++``.

The counterpart of ``paddle_tpu/native``: ``ps_core.cc`` (the sparse
table: sharded directory, pull, fused push, q8 pull, checkpoint export,
TTL lifecycle, the zero-copy pull wire)
and ``cache_dir.cc`` (the device cache's directory: id -> slot, LRU, pins,
admission planning) are copies of the reference's sources, the same code
line for line (only comments differ), compiled with the same flags
(``-ffp-contract=off`` keeps every ``a * b + c`` unfused), so on one
machine the port's rows are bitwise the reference's.  The ABI is plain
C, loaded with ``ctypes`` under its default ``RTLD_LOCAL``: the
reference's build of the same source can live in the same process
without symbol clashes.

Libraries go to ``_build/<name>-<hash>.so`` beside this file; the hash
covers the source and the flags.  A failed build raises
:class:`NativeBuildError`; there is no Python fallback.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Dict

__all__ = ["load_library", "ps_core", "NativeBuildError", "BUILD_DIR",
           "CXX_FLAGS"]

SRC_DIR = Path(__file__).resolve().parent
BUILD_DIR = SRC_DIR / "_build"
CXX_FLAGS = ("-O3", "-march=native", "-ffp-contract=off", "-std=c++17",
             "-shared", "-fPIC", "-pthread")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


class NativeBuildError(RuntimeError):
    pass


def load_library(name: str) -> ctypes.CDLL:
    """Compile ``<name>.cc`` if its library is missing, and load it."""
    with _lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        src = SRC_DIR / f"{name}.cc"
        digest = hashlib.sha256(
            src.read_bytes() + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
        out = BUILD_DIR / f"{name}-{digest}.so"
        if not out.is_file():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            # a per-process temporary name: concurrent test workers with a
            # cold build directory must not rename half-written files over
            # each other
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cxx = os.environ.get("CXX", "g++")
            try:
                r = subprocess.run([cxx, *CXX_FLAGS, str(src), "-o", str(tmp)],
                                   capture_output=True, text=True,
                                   timeout=300)
            except (OSError, subprocess.TimeoutExpired) as e:
                raise NativeBuildError(
                    f"building {name}.cc: {cxx} did not run: {e}") from e
            if r.returncode != 0:
                raise NativeBuildError(
                    f"building {name}.cc failed:\n{r.stderr[-4000:]}")
            os.replace(tmp, out)
        lib = ctypes.CDLL(str(out))
        _libs[name] = lib
        return lib


def ps_core() -> ctypes.CDLL:
    """The sparse-table core with argtypes declared for the symbols the
    port calls."""
    lib = load_library("ps_core")
    if getattr(lib, "_pts_ready", False):
        return lib
    c = ctypes
    i64p = c.POINTER(c.c_int64)
    f32p = c.POINTER(c.c_float)
    i8p = c.POINTER(c.c_int8)
    lib.pts_create.restype = c.c_void_p
    lib.pts_create.argtypes = [c.c_int, c.c_int, c.c_float, c.c_float,
                               c.c_float, c.c_float, c.c_float, c.c_uint64,
                               c.c_int]
    lib.pts_free.argtypes = [c.c_void_p]
    lib.pts_version.restype = c.c_uint64
    lib.pts_version.argtypes = [c.c_void_p]
    lib.pts_set_version.argtypes = [c.c_void_p, c.c_uint64]
    lib.pts_pull.argtypes = [c.c_void_p, i64p, c.c_int64, f32p]
    lib.pts_push.argtypes = [c.c_void_p, i64p, c.c_int64, f32p]
    lib.pts_push_delta.argtypes = [c.c_void_p, i64p, c.c_int64, f32p]
    lib.pts_pull_q8.argtypes = [c.c_void_p, i64p, c.c_int64, i8p, f32p]
    lib.pts_size.restype = c.c_int64
    lib.pts_size.argtypes = [c.c_void_p]
    lib.pts_stride.restype = c.c_int
    lib.pts_stride.argtypes = [c.c_void_p]
    lib.pts_export.restype = c.c_int64
    lib.pts_export.argtypes = [c.c_void_p, i64p, f32p, c.c_int64]
    lib.pts_export_full.restype = c.c_int64
    lib.pts_export_full.argtypes = [c.c_void_p, i64p, f32p, c.c_int64]
    lib.pts_import.argtypes = [c.c_void_p, i64p, c.c_int64, f32p]
    lib.pts_import_full.argtypes = [c.c_void_p, i64p, c.c_int64, f32p]
    lib.pts_clear.argtypes = [c.c_void_p]
    lib.ps_segsum_inv.argtypes = [i64p, c.c_int64, c.c_int, f32p, f32p]
    # feature lifecycle
    lib.pts_set_clock.argtypes = [c.c_void_p, c.c_uint64]
    lib.pts_touch_all.argtypes = [c.c_void_p, c.c_uint64]
    lib.pts_admitted_total.restype = c.c_uint64
    lib.pts_admitted_total.argtypes = [c.c_void_p]
    lib.pts_evicted_total.restype = c.c_uint64
    lib.pts_evicted_total.argtypes = [c.c_void_p]
    lib.pts_slots.restype = c.c_int64
    lib.pts_slots.argtypes = [c.c_void_p]
    lib.pts_ttl_sweep.restype = c.c_int64
    lib.pts_ttl_sweep.argtypes = [c.c_void_p, c.c_uint64, i64p, c.c_int64]
    lib.pts_evict.restype = c.c_int64
    lib.pts_evict.argtypes = [c.c_void_p, i64p, c.c_int64]
    # the zero-copy pull wire
    u64p = c.POINTER(c.c_uint64)
    i32p = c.POINTER(c.c_int32)
    lib.pts_pin_read.argtypes = [c.c_void_p]
    lib.pts_unpin_read.argtypes = [c.c_void_p]
    lib.pts_pull_plan.restype = c.c_int64
    lib.pts_pull_plan.argtypes = [c.c_void_p, i64p, c.c_int64, i32p, u64p]
    lib.pts_sendv_addrs.restype = c.c_int64
    lib.pts_sendv_addrs.argtypes = [
        c.c_int, u64p, c.c_int64, c.c_int64, c.c_void_p, c.c_int64,
        c.c_void_p, c.c_int64, c.c_int64]
    lib._pts_ready = True
    return lib
