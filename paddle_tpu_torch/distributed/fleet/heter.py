"""Heterogeneous PS training: host sparse embeddings, dense compute on the
card, overlapped.

Counterpart of ``paddle_tpu/distributed/fleet/heter.py``.  Two pieces:

- :class:`DeviceCachedTable`, a device-resident cache over a host
  :class:`~.ps.SparseTable`.  Hot rows live in one buffer ``[capacity + 1,
  dim]`` on the card; the directory (id -> slot, LRU order, pins, the
  admission plan) is native (``paddle_tpu_torch/native/cache_dir.cc``,
  the reference's source), one C call per transaction.  ``pull`` is one
  gather on the card; misses are pulled through from the host table (on
  the ``q8`` wire as int8 codes rebuilt by the ``pull_dequant`` kernel);
  ``push`` merges duplicate ids' gradients (the ``segment_sum`` kernel for
  gradients on the card, the native ``ps_segsum_inv`` for numpy ones) and
  applies SGD or AdaGrad on the card; evicted or flushed rows go back to
  the host exactly, as the value delta since admission (``push_delta``).
- :class:`HeterTrainer`, the pipelined loop: in async mode pull(i+1) on
  pool threads overlaps the dense step on batch i and pushes run on pool
  threads behind it; ``sync_mode=True`` is pull, step, push per batch.

Device work goes to PyTorch's default stream from whichever thread holds
the cache lock, so the card runs it in the order the lock serialises it;
the cache updates its buffers in place (the reference's arrays were
immutable and were replaced on every update).  Variable-length device
operations pad their index vectors to power-of-2 buckets aimed at a
scratch row (index ``capacity``), which takes duplicate writes and is
never read as data, as in the reference.

:class:`RemoteTable` puts a table behind the PS service
(:class:`~.ps_service.PSClient`) under either piece.

Not ported: the Python directory fallback and its environment switch.
"""
from __future__ import annotations

import ctypes
import threading
from collections import OrderedDict
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Iterable, Optional

import numpy as np
import torch

from ... import resolve_device
from ...native import load_library, ps_core
from ...ops.kernels import registry
from .ps import SparseTable, dequantize_rows_q8

__all__ = ["HeterTrainer", "DeviceCachedTable", "RemoteTable"]


class RemoteTable:
    """A table behind the PS service with the local ``SparseTable``
    surface (pull, q8 pull, push, push_delta), so :class:`HeterTrainer`
    and :class:`DeviceCachedTable` train against a remote PS cluster.
    The wrapped :class:`~.ps_service.PSClient` owns retries, idempotent
    seq numbers and replica failover; this adapter pins the table name
    and dim."""

    def __init__(self, client, name: str, dim: int):
        self._client = client
        self.name = name
        self.dim = dim

    def pull(self, ids: np.ndarray) -> np.ndarray:
        return self._client.pull(self.name, ids)

    def pull_q8(self, ids: np.ndarray):
        """Rows on the int8 wire: ``(codes int8 [n, dim], scales f32
        [n])`` in ``ids`` order, for a q8 cache's miss fill."""
        return self._client.pull_q8(self.name, ids)

    def push(self, ids: np.ndarray, grads: np.ndarray):
        ids = np.asarray(ids).reshape(-1)
        self._client.push(self.name, ids,
                          np.asarray(grads, np.float32).reshape(
                              ids.size, self.dim))

    def push_delta(self, ids: np.ndarray, deltas: np.ndarray):
        self._client.push_delta(self.name, ids, deltas)


class _NativeCacheDir:
    """ctypes wrapper over ``native/cache_dir.cc``: the cache directory
    (id -> slot, LRU, pins, admission planning), one C call per
    transaction.  The caller serialises calls under its lock."""

    def __init__(self, capacity: int):
        lib = load_library("cache_dir")
        i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        c = ctypes
        lib.cache_dir_create.restype = c.c_void_p
        lib.cache_dir_create.argtypes = [c.c_int64]
        lib.cache_dir_destroy.argtypes = [c.c_void_p]
        lib.cache_dir_pull.restype = c.c_int64
        lib.cache_dir_pull.argtypes = [c.c_void_p, i64p, c.c_int64,
                                       c.c_int32] + [i64p] * 7
        lib.cache_dir_lookup.restype = c.c_int64
        lib.cache_dir_lookup.argtypes = [c.c_void_p, i64p, c.c_int64,
                                         c.c_int32] + [i64p] * 4
        lib.cache_dir_ids_of.argtypes = [c.c_void_p, i64p, c.c_int64, i64p]
        lib.cache_dir_unpin_slots.argtypes = [c.c_void_p, i64p, c.c_int64]
        lib.cache_dir_unpin_ids.argtypes = [c.c_void_p, i64p, c.c_int64]
        lib.cache_dir_load.restype = c.c_int64
        lib.cache_dir_load.argtypes = [c.c_void_p]
        self._lib = lib
        self._h = lib.cache_dir_create(capacity)

    def __del__(self):
        if getattr(self, "_h", None) is not None:
            self._lib.cache_dir_destroy(self._h)
            self._h = None

    def pull(self, ids: np.ndarray, pin: bool):
        """``(uniq, inverse, slots, miss_pos, evicted slots, evicted ids),
        n_uniq, n_miss``; the first is None when the batch plus the pinned
        rows do not fit (the directory is then unchanged)."""
        n = len(ids)
        uniq, inverse, slots, miss_pos, ev_slots, ev_ids = (
            np.empty(n, np.int64) for _ in range(6))
        counts = np.empty(3, np.int64)
        rc = self._lib.cache_dir_pull(
            self._h, np.ascontiguousarray(ids), n, 1 if pin else 0,
            uniq, inverse, slots, miss_pos, ev_slots, ev_ids, counts)
        u, nm, ne = (int(x) for x in counts)
        if rc != 0:
            return None, u, nm
        return (uniq[:u], inverse, slots[:u], miss_pos[:nm],
                ev_slots[:ne], ev_ids[:ne]), u, nm

    def lookup(self, ids: np.ndarray, unpin: bool):
        """``(uniq, inverse, slots)`` when every id is resident, else
        None."""
        n = len(ids)
        uniq, inverse, slots = (np.empty(n, np.int64) for _ in range(3))
        counts = np.empty(1, np.int64)
        rc = self._lib.cache_dir_lookup(
            self._h, np.ascontiguousarray(ids), n, 1 if unpin else 0,
            uniq, inverse, slots, counts)
        if rc != 0:
            return None
        u = int(counts[0])
        return uniq[:u], inverse, slots[:u]

    def unpin_slots(self, slots: np.ndarray):
        self._lib.cache_dir_unpin_slots(
            self._h, np.ascontiguousarray(slots, dtype=np.int64), len(slots))

    def unpin_ids(self, ids: np.ndarray):
        """Tolerant unpin: ids no longer resident are skipped."""
        self._lib.cache_dir_unpin_ids(
            self._h, np.ascontiguousarray(ids, dtype=np.int64), len(ids))

    def ids_of(self, slots: np.ndarray) -> np.ndarray:
        out = np.empty(len(slots), np.int64)
        self._lib.cache_dir_ids_of(
            self._h, np.ascontiguousarray(slots, dtype=np.int64),
            len(slots), out)
        return out

    def load(self) -> int:
        return int(self._lib.cache_dir_load(self._h))


_THRASH = ("device cache thrashing: current batch plus in-flight "
           "(unpushed) batches pin more unique rows than capacity={}")


class DeviceCachedTable:
    """Device-resident cache over a host :class:`~.ps.SparseTable` (the
    reference's GPU embedding cache, heter_ps/hashtable.h, with
    PSGPUWrapper's EndPass as :meth:`flush`).

    ``optimizer`` is ``sgd`` or ``adagrad`` (its accumulator lives in the
    cache and restarts when a row is admitted again, as in the reference).
    ``wire="q8"`` fills misses from the host table's int8 pull and
    rebuilds the rows on the card with ``pull_dequant``; it is lossy by
    design, so training keeps the exact ``f32`` default.  ``device``
    defaults to ``cuda`` (:func:`~paddle_tpu_torch.resolve_device`);
    ``kernel_mode="torch_ref"`` routes the cache's two kernels to their
    plain versions, to compare the two routes.
    """

    def __init__(self, table: SparseTable, capacity: int,
                 optimizer: str = "sgd", lr: float = 0.01,
                 eps: float = 1e-6, wire: str = "f32", device=None,
                 kernel_mode: Optional[str] = None):
        if optimizer not in ("sgd", "adagrad"):
            raise ValueError(f"device cache optimizer must be sgd|adagrad, "
                             f"got {optimizer!r}")
        if wire not in ("f32", "q8"):
            raise ValueError(f"wire must be f32|q8, got {wire!r}")
        if wire == "q8" and not hasattr(table, "pull_q8"):
            raise ValueError(f"wire='q8' needs a table with pull_q8 (got "
                             f"{type(table).__name__})")
        if kernel_mode not in (None, "torch_ref"):
            raise ValueError(f"kernel_mode must be None or 'torch_ref', got "
                             f"{kernel_mode!r}")
        self._device = resolve_device(device)
        self._kmode = kernel_mode
        self._wire = wire
        self._table = table
        self._cap = int(capacity)
        self._dim = table.dim
        self._opt = optimizer
        self._lr = lr
        self._eps = eps
        # one extra scratch row at index cap: padded index vectors aim at it
        self._buf = torch.zeros((self._cap + 1, self._dim),
                                dtype=torch.float32, device=self._device)
        self._acc = (torch.zeros_like(self._buf) if optimizer == "adagrad"
                     else None)
        self._orig = np.zeros((self._cap, self._dim), np.float32)
        self._dirty = np.zeros(self._cap, bool)
        self.hits = self.misses = self.evictions = 0
        # the async trainer pulls batch i+1 on one pool thread while push(i)
        # runs on another: every state change and device op holds the lock
        self._lock = threading.RLock()
        # recent pull plans keyed by raw-id bytes, popped by the matching
        # push; dropped when one of their slots is evicted (a stale plan
        # would scatter gradients into rows another id now owns)
        self._plans: "OrderedDict[bytes, tuple]" = OrderedDict()
        self._ndir = _NativeCacheDir(self._cap)
        # the native merge for numpy gradients
        self._pslib = ps_core()

    @staticmethod
    def _bucket(n: int) -> int:
        b = 1
        while b < n:
            b <<= 1
        return b

    def _pad_slots(self, slots: np.ndarray) -> np.ndarray:
        """``slots`` padded to its power-of-2 bucket with the scratch row."""
        out = np.full(self._bucket(max(len(slots), 1)), self._cap, np.int64)
        out[:len(slots)] = slots
        return out

    def _on_device(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(arr)).to(self._device)

    def _invalidate_plans(self, evicted_slots):
        if not self._plans:
            return
        ev = set(np.asarray(evicted_slots).tolist())
        for key in [k for k, (_, _, slots) in self._plans.items()
                    if not ev.isdisjoint(slots.tolist())]:
            del self._plans[key]

    def _fill_rows(self, miss_ids: np.ndarray, nsp: int):
        """Miss rows padded to ``nsp``: (device install payload, host rows
        for the write-back baseline).  On the q8 wire the payload is
        rebuilt on the card by ``pull_dequant`` and the host copy by the
        numpy dequant: bitwise equal, so write-back deltas stay exact."""
        k = len(miss_ids)
        if self._wire == "q8":
            codes, scales = self._table.pull_q8(miss_ids)
            out = torch.zeros((nsp, self._dim), dtype=torch.float32,
                              device=self._device)
            out[:k] = registry.dispatch(
                "pull_dequant", self._on_device(codes),
                self._on_device(scales), mode=self._kmode)
            return out, dequantize_rows_q8(codes, scales)
        rows = self._table.pull(miss_ids)
        rows_p = np.zeros((nsp, self._dim), np.float32)
        rows_p[:k] = rows
        return self._on_device(rows_p), rows

    def _write_back_rows(self, slots: np.ndarray, ids: np.ndarray):
        """Push the value delta since admission of the dirty rows among
        ``slots`` (owned by ``ids``) to the host table."""
        m = self._dirty[slots]
        d = slots[m]
        if d.size == 0:
            return
        vals = self._buf[self._on_device(self._pad_slots(d))][:d.size]
        vals = vals.cpu().numpy()
        self._table.push_delta(np.asarray(ids)[m], vals - self._orig[d])
        self._orig[d] = vals
        self._dirty[d] = False

    # -- the SparseTable surface ----------------------------------------
    def pull(self, ids: np.ndarray, pin: bool = False) -> torch.Tensor:
        """Device rows for ``ids`` (duplicates allowed): one gather.

        ``pin=True`` (the async trainer) keeps the batch's slots from
        eviction until the matching :meth:`push` or :meth:`release`."""
        ids = np.ascontiguousarray(np.asarray(ids, np.int64)).reshape(-1)
        with self._lock:
            ret, n_uniq, n_miss = self._ndir.pull(ids, pin)
            if ret is None:
                self.hits += n_uniq - n_miss
                self.misses += n_miss
                raise RuntimeError(_THRASH.format(self._cap))
            uniq, inverse, slots, miss_pos, ev_slots, ev_ids = ret
            self.hits += len(uniq) - len(miss_pos)
            self.misses += len(miss_pos)
            self.evictions += len(ev_slots)
            if ev_slots.size:
                # the directory entries are gone: write the dirty values
                # back under the ids the native call reported
                self._invalidate_plans(ev_slots)
                self._write_back_rows(ev_slots, ev_ids)
            if miss_pos.size:
                miss_slots = slots[miss_pos]
                sp = self._on_device(self._pad_slots(miss_slots))
                rows_p, rows = self._fill_rows(uniq[miss_pos], len(sp))
                self._buf[sp] = rows_p
                if self._acc is not None:
                    self._acc[sp] = 0.0
                self._orig[miss_slots] = rows
                self._dirty[miss_slots] = False
            # one-shot plan for the push of exactly these raw ids
            self._plans[ids.tobytes()] = (uniq, inverse, slots)
            while len(self._plans) > 8:
                self._plans.popitem(last=False)
            return self._buf[self._on_device(slots[inverse])]

    def push(self, ids: np.ndarray, grads):
        """Apply the optimizer on the card to the rows of ``ids``;
        duplicate ids' gradients are summed first."""
        ids = np.ascontiguousarray(np.asarray(ids, np.int64)).reshape(-1)
        with self._lock:
            # one-shot: a second push of the same raw ids without a fresh
            # pull must not reuse the plan (it would unpin another
            # in-flight batch's shared slot)
            plan = self._plans.pop(ids.tobytes(), None)
            if plan is not None:
                uniq, inverse, slots = plan
                self._ndir.unpin_slots(slots)
            else:
                plan = self._ndir.lookup(ids, unpin=True)
                if plan is None:
                    raise KeyError("push() of ids not resident in the "
                                   "device cache")
                uniq, inverse, slots = plan
            self._push_rows(uniq, inverse, slots, grads)

    def _push_rows(self, uniq, inverse, slots, grads):
        """Segment-sum the gradients into the bucket of unique ids, then
        the optimizer apply on the card.  Numpy gradients take the native
        merge (one C call, no copy of the unmerged rows to the card);
        tensors take the ``segment_sum`` kernel where they lie."""
        nseg = self._bucket(max(len(uniq), 1))
        if isinstance(grads, np.ndarray):
            inv = np.ascontiguousarray(inverse, np.int64)
            gr = np.ascontiguousarray(grads.reshape(-1, self._dim),
                                      np.float32)
            sums = np.zeros((nseg, self._dim), np.float32)
            self._pslib.ps_segsum_inv(
                inv.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                inv.size, self._dim,
                gr.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                sums.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
            g = self._on_device(sums)
        else:
            g = torch.as_tensor(grads).to(self._device, torch.float32)
            g = registry.dispatch("segment_sum", g.reshape(-1, self._dim),
                                  inverse, nseg, mode=self._kmode)
        sl = self._on_device(self._pad_slots(slots))
        self._apply(sl, g)
        self._dirty[slots] = True

    def _apply(self, sl: torch.Tensor, g: torch.Tensor):
        if self._acc is not None:
            self._acc.index_add_(0, sl, g * g)
            step = g / (torch.sqrt(self._acc[sl]) + self._eps)
        else:
            step = g
        self._buf.index_add_(0, sl, -self._lr * step)

    def release(self, ids: np.ndarray):
        """Release the pin of a ``pull(..., pin=True)`` whose push will
        never come (frozen table, failed step)."""
        ids = np.ascontiguousarray(np.asarray(ids, np.int64)).reshape(-1)
        with self._lock:
            self._plans.pop(ids.tobytes(), None)
            self._ndir.unpin_ids(ids)

    def flush(self):
        """Write every dirty row back to the host table (EndPass)."""
        with self._lock:
            dirty = np.flatnonzero(self._dirty).astype(np.int64)
            self._write_back_rows(dirty, self._ndir.ids_of(dirty))

    end_pass = flush

    def prime(self, max_ids: Optional[int] = None):
        """Run every bucketed device step once on the scratch row, for
        each power-of-2 bucket up to ``max_ids`` (default: capacity):
        install, gather, segment-sum, apply (and on the q8 wire a
        dequant), so kernel builds and first launches happen here and not
        in a timed loop.  No real row changes."""
        raw = int(max_ids or self._cap)
        buckets = [1]
        while buckets[-1] < raw:
            buckets.append(buckets[-1] << 1)
        dev = self._device
        with self._lock:
            _ = self._buf[torch.full((raw,), self._cap, device=dev)]
            grads = torch.zeros((raw, self._dim), dtype=torch.float32,
                                device=dev)
            if self._wire == "q8":
                registry.dispatch(
                    "pull_dequant",
                    torch.zeros((raw, self._dim), dtype=torch.int8,
                                device=dev),
                    torch.zeros(raw, dtype=torch.float32, device=dev),
                    mode=self._kmode)
            for n in buckets:
                sp = torch.full((n,), self._cap, device=dev)
                self._buf[sp] = torch.zeros((n, self._dim), device=dev)
                if self._acc is not None:
                    self._acc[sp] = 0.0
                _ = self._buf[sp]
                g = registry.dispatch(
                    "segment_sum", grads, np.arange(raw, dtype=np.int64) % n,
                    n, mode=self._kmode)
                self._apply(sp, g)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

    def has(self, id_) -> bool:
        """Whether ``id_`` is resident."""
        with self._lock:
            return self._ndir.lookup(np.asarray([int(id_)], np.int64),
                                     unpin=False) is not None

    @property
    def load(self) -> float:
        """Share of the capacity holding rows."""
        return self._ndir.load() / self._cap


def _host(g) -> np.ndarray:
    if isinstance(g, torch.Tensor):
        return g.detach().cpu().numpy()
    return np.asarray(g)


class HeterTrainer:
    def __init__(self, tables: Dict[str, SparseTable],
                 dense_step: Callable, sync_mode: bool = False,
                 pull_threads: int = 2, push_lag: int = 0):
        """``dense_step(embeddings: dict[str, rows], batch) -> (result,
        grads: dict[str, rows])``: grads are d(loss)/d(rows), one row per
        pulled id (duplicates are summed by the table's push).  Rows come
        as numpy from a host table and as tensors from a
        :class:`DeviceCachedTable`; gradients may be either, and a tensor
        given to a device cache stays on the card.

        ``push_lag`` (async mode): how many pushes may remain in flight
        when the next batch's pull is submitted.  0 is the lockstep
        schedule (a cache must hold 2 batches' unique rows); 1 lets
        push(i) overlap compute(i) and pull(i+1) (3 batches pinned).  The
        device values stay exact either way (each cache op runs under the
        cache lock on one stream); the lag widens the host table's
        staleness for miss rows to ``1 + push_lag`` batches."""
        self._tables = tables
        self._dense_step = dense_step
        self._sync = sync_mode
        self._push_lag = max(0, int(push_lag))
        self._pool = ThreadPoolExecutor(max_workers=pull_threads,
                                        thread_name_prefix="heter_ps")
        self._pending_push = []

    # -- lanes ---------------------------------------------------------
    def _pull(self, ids_map):
        out = {}
        for name, ids in ids_map.items():
            t = self._tables[name]
            ids = np.ascontiguousarray(np.asarray(ids), np.int64)
            # async: pin cached rows until this batch's push lands, so
            # pull(i+1)'s eviction cannot claim batch i's slots
            if not self._sync and isinstance(t, DeviceCachedTable):
                out[name] = t.pull(ids, pin=True)
            else:
                out[name] = t.pull(ids)
        return out

    def _push(self, ids_map, grads):
        for name, g in grads.items():
            t = self._tables[name]
            if not (isinstance(t, DeviceCachedTable)
                    and isinstance(g, torch.Tensor)):
                g = _host(g)
            t.push(np.ascontiguousarray(np.asarray(ids_map[name]), np.int64),
                   g)
        for name in ids_map.keys() - grads.keys():
            # pulled but no gradient (a frozen table): the async pull's
            # pin must still come off
            self._release(name, ids_map[name])

    def _release(self, name, ids):
        t = self._tables[name]
        if isinstance(t, DeviceCachedTable):
            t.release(np.ascontiguousarray(np.asarray(ids), np.int64))

    def _release_all(self, ids_map):
        if not self._sync:
            for name, ids in ids_map.items():
                self._release(name, ids)

    def _drain_pushes(self, keep: int = 0):
        while len(self._pending_push) > keep:
            self._pending_push.pop(0).result()

    # -- run loop ------------------------------------------------------
    def run(self, batches: Iterable, ids_fn: Callable,
            on_result: Optional[Callable] = None) -> int:
        """Train over ``batches``; ``ids_fn(batch) -> {table: int64 ids}``.
        Returns the step count.

        Async mode pulls batch i+1 on a pool thread while the dense step
        runs on batch i and pushes behind it; over a device cache its
        capacity must cover ``2 + push_lag`` consecutive batches' unique
        rows (a tighter cache raises the thrashing error).  Sync mode is
        pull, step, push per batch: the reference's loop also prefetched
        pull(i+1) in sync mode, which then raced push(i) for the table
        lock, so a row shared by two batches could reach batch i+1 with or
        without batch i's update; here the next pull waits for the push,
        and a sync run is deterministic."""
        it = iter(batches)
        try:
            batch = next(it)
        except StopIteration:
            return 0
        ids = ids_fn(batch)
        pull_f = self._pool.submit(self._pull, ids)
        steps = 0
        while True:
            try:
                nxt = next(it)
            except StopIteration:
                nxt = None
            nxt_ids = ids_fn(nxt) if nxt is not None else None
            emb = pull_f.result()
            if nxt is not None and not self._sync:   # prefetch lane
                self._drain_pushes(keep=self._push_lag)
                pull_f = self._pool.submit(self._pull, nxt_ids)
            try:
                result, grads = self._dense_step(emb, batch)
            except BaseException:
                self._release_all(ids)   # a retry must not inherit pins
                raise
            if self._sync:
                # the next pull starts only after this push has landed:
                # every batch sees every earlier update
                self._push(ids, grads)
                if nxt is not None:
                    pull_f = self._pool.submit(self._pull, nxt_ids)
            else:
                self._pending_push.append(
                    self._pool.submit(self._push, ids, grads))
            if on_result is not None:
                on_result(steps, result)
            steps += 1
            if nxt is None:
                break
            batch, ids = nxt, nxt_ids
        self._drain_pushes(keep=0)
        return steps

    def shutdown(self):
        self._drain_pushes(keep=0)
        self._pool.shutdown(wait=True)
