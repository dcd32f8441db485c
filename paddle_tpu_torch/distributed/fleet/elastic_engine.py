"""Device engine of the elastic data plane (counterpart of
``paddle_tpu/distributed/fleet/elastic_engine.py``).

:class:`DeviceZeroEngine` runs a generation's math on the card and is
REBUILT on every membership transition (``ElasticTrainer`` calls
:meth:`~DeviceZeroEngine.rebuild` right after ``mesh.reform_mesh()``,
inside the reshard window):

* ``reduce`` -- the slot-ordered gradient reduction in f32 on the
  device, ``acc = s0; acc = acc + s_k`` for k = 1..G-1.  Every rank runs
  the same additions over the byte-identical wire copies and the world
  size never enters them, so the full ``gsum`` is bitwise identical
  across ranks AND across world sizes.  Plain PyTorch adds: the
  reference runs this step as plain ``jax.jit`` with no Pallas kernel.
* the fused optimizer apply -- through the ``opt_apply`` kernel
  (``dist_step.fused_optimizer_apply``), one pass reading
  grad+param+moments and writing param+moments.  ``rebuild`` warms it
  at the new shard length, so the reshard window, not a training step,
  pays for the kernel's first build and launch.

The port's kernel and its plain version are bitwise the host numpy
engine (``ops/kernels/opt_apply.py``), and f32 additions are bitwise
the host loop's, so the two engines give the same bits; the JAX
package's engines differ by about 1 ulp (XLA's FMA contraction).

:class:`ReshardMeter` is the accounting side of the O(max shard)
guarantee: every transient staging buffer the reshard/checkpoint
machinery holds (exchange rounds, streamed-writer chunks, ranged
reads) registers with the owning trainer's meter
(``ElasticTrainer.reshard_meter``, per trainer so in-process multi-rank
runs account per host), and the observed peak stays a small multiple of
one shard -- the machinery never materializes the global flat vector.
"""
from __future__ import annotations

import contextlib
import threading
import time
from typing import List

import numpy as np

from ... import resolve_device
from ...observability import flight_recorder as _flight
from .dist_step import _to_device, fused_optimizer_apply

__all__ = ["DeviceZeroEngine", "ReshardMeter", "reshard_meter"]


class ReshardMeter:
    """Tracks transient host staging held by the reshard/checkpoint
    machinery: ``hold(buf)`` is a context manager bracketing a
    buffer's lifetime; ``peak_bytes`` is the high-water mark of
    concurrently held staging, ``total_bytes`` everything that ever
    moved through.  Thread-safe (exchange rounds run per rank in
    threads in the in-process tests)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._live = 0
        self.peak_bytes = 0
        self.total_bytes = 0

    def reset(self):
        with self._lock:
            self._live = 0
            self.peak_bytes = 0
            self.total_bytes = 0

    @contextlib.contextmanager
    def hold(self, buf):
        n = int(getattr(buf, "nbytes", buf))
        with self._lock:
            self._live += n
            self.total_bytes += n
            if self._live > self.peak_bytes:
                self.peak_bytes = self._live
        try:
            yield buf
        finally:
            with self._lock:
                self._live -= n


#: process-wide meter for ad-hoc use (trainers keep their own)
reshard_meter = ReshardMeter()


class DeviceZeroEngine:
    """Device-side math for one elastic trainer (see module docstring).
    ``micro`` and ``numel`` are run constants; everything
    world-dependent is (re)built by :meth:`rebuild`.  ``device``:
    ``None`` means ``cuda``."""

    def __init__(self, micro: int, numel: int, device=None):
        self._micro = int(micro)
        self._numel = int(numel)
        self.device = resolve_device(device)
        self.world = None
        self.rank = None
        self.compiles = 0

    def rebuild(self, opt, world: int, rank: int, lo: int, hi: int,
                gen: int = -1):
        """Per-generation rebuild: warm the fused apply for the NEW
        shard length (one ``opt_apply`` call on zeros) inside the
        reshard window, timed and flight-recorded as
        ``elastic.reshard.compile``."""
        t0 = time.perf_counter()
        z = np.zeros(max(hi - lo, 1), np.float32)
        fused_optimizer_apply(
            opt.KIND, z, z, {k: z for k in opt.SLOTS},
            t=max(int(opt.t), 1), device=self.device, **opt._hyper())
        self.world, self.rank = int(world), int(rank)
        self.compiles += 1
        _flight.record(
            "elastic.reshard.compile",
            ms=round((time.perf_counter() - t0) * 1e3, 3),
            gen=int(gen), world=int(world), rank=int(rank),
            shard_len=int(hi - lo))

    def reduce(self, slot_grads: List[np.ndarray]) -> np.ndarray:
        """Slot-ordered reduction of the G wire copies -> the full f32
        gsum, summed on the device in slot order."""
        acc = None
        for g in slot_grads:
            t = _to_device(g, self.device)
            acc = t if acc is None else acc + t
        return acc.cpu().numpy()
