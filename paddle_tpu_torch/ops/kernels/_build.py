"""Build the CUDA sources under ``csrc/`` at first use and load them.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on its
own by ``nvcc`` into ``_build/<name>-<hash>.so`` (the hash covers the
source, the ``csrc/`` headers it includes and the flags, so an edited
source or header rebuilds), then loaded with ``ctypes``.  ``nvcc``'s
output (``ptxas -v``: registers, shared memory, spills) is kept beside
the library as ``<name>-<hash>.log`` and read
back into :data:`build_logs` when the library is already built.  No
PyTorch header is included: a build takes seconds, not the minutes a
``torch.utils.cpp_extension`` build takes.

Every C entry point returns ``cudaGetLastError()`` after its launch;
:func:`check` raises on a non-zero code with the CUDA error string.

Importing this module needs no ``nvcc``.  A missing ``nvcc`` raises only
when a CUDA tensor actually needs a kernel.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, List

__all__ = ["SOURCES", "CSRC", "BUILD_DIR", "build", "load", "check",
           "nvcc_path", "build_logs", "build_seconds"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
SOURCES = ("flash_attention_fwd.cu", "flash_attention_bwd.cu",
           "int8_kv_attention.cu", "int8_matmul.cu", "segment_sum.cu",
           "pull_dequant.cu", "opt_apply.cu", "conv_bn_stats.cu")

DEFAULT_NVCC = Path("/usr/local/cuda/bin/nvcc")   # the toolkit's default
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
build_logs: Dict[str, str] = {}       # source -> nvcc's output (ptxas -v)
build_seconds: Dict[str, float] = {}  # source -> wall seconds of its nvcc


def nvcc_path() -> str:
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        cands.append(Path(found))
    cands.append(DEFAULT_NVCC)
    for c in cands:
        if c.is_file():
            return str(c)
    raise RuntimeError(
        "nvcc not found (looked at $CUDA_HOME/bin, PATH and the default "
        "CUDA install): the port's CUDA kernels cannot be built")


_INCLUDE = re.compile(rb'^[ \t]*#[ \t]*include[ \t]+"([^"]+)"', re.M)


def _source_bytes(source: str, seen=None) -> bytes:
    """The bytes of ``csrc/<source>`` followed by those of every
    ``csrc/`` header it includes (``#include "..."``), each once."""
    seen = set() if seen is None else seen
    seen.add(source)
    text = (CSRC / source).read_bytes()
    out = [text]
    for name in _INCLUDE.findall(text):
        name = name.decode()
        if name not in seen:
            out.append(_source_bytes(name, seen))
    return b"".join(out)


def _target(source: str) -> Path:
    text = _source_bytes(source)
    h = hashlib.sha256(text + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{Path(source).stem}-{h[:16]}.so"


def build(sources: Iterable[str] = SOURCES) -> List[Path]:
    """Compile every source whose library is missing, one ``nvcc`` per
    source, all started together.  Returns the library paths."""
    sources = list(sources)
    targets = [_target(s) for s in sources]
    todo = [(s, t) for s, t in zip(sources, targets) if not t.is_file()]
    for s, t in zip(sources, targets):
        if t.is_file() and t.with_suffix(".log").is_file():
            build_logs.setdefault(s, t.with_suffix(".log").read_text())
    if todo:
        nvcc = nvcc_path()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = []
        for s, t in todo:
            tmp = t.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / s)]
            procs.append((s, t, tmp, time.perf_counter(), subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)))
        failed = []
        for s, t, tmp, t0, p in procs:
            out, err = p.communicate()
            build_seconds[s] = time.perf_counter() - t0
            build_logs[s] = (out or "") + (err or "")
            if p.returncode != 0:
                failed.append(f"{s} (rc {p.returncode}):\n{build_logs[s]}")
            else:
                # the log first: a library on disk has its log beside it
                log = tmp.with_suffix(".log")
                log.write_text(build_logs[s])
                os.replace(log, t.with_suffix(".log"))
                os.replace(tmp, t)
        if failed:
            raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return targets


def load(source: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<source>``, built on first use."""
    with _lock:
        lib = _libs.get(source)
        if lib is None:
            (path,) = build([source])
            lib = ctypes.CDLL(str(path))
            lib.kernel_error_string.argtypes = [ctypes.c_int]
            lib.kernel_error_string.restype = ctypes.c_char_p
            _libs[source] = lib
        return lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    if rc != 0:
        msg = lib.kernel_error_string(rc).decode(errors="replace")
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")
