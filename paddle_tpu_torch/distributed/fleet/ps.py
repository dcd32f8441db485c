"""Host-RAM sparse embedding table of the parameter-server path.

Counterpart of ``paddle_tpu/distributed/fleet/ps.py``: ``SparseTable``
on the native C++ core (``paddle_tpu_torch/native/ps_core.cc``, the
reference's source), its pure-Python backend, the q8 wire helpers and
``PSRuntime``.  Rows materialise on first touch with a deterministic
per-id initialisation (seed, init_std), so a table with the same config
gives the reference's rows bit for bit; a push is one fused C pass
(dedup + segment-sum + optimizer apply, once per unique id); the
checkpoint format is the reference's npz layout, so either package loads
the other's ``save()`` / ``state_bytes()``, admission state and all.

Also on the same core: feature admission (``entry=``: the stock
``CountFilterEntry`` / ``ProbabilityEntry`` evaluated inside the
directory probe), the feature lifecycle (``set_clock`` / ``touch_all`` /
``ttl_sweep`` / ``evict_ids``), the tiered table (``enable_spill``:
cold rows demote to per-shard mmap spill files and promote back on
touch, ``recover_spill`` re-attaches them after a crash), the geo stamp
directory of ``geo_policy="lww"`` tables (``geo_get`` / ``geo_put`` /
``geo_export``) and the zero-copy pull wire's hooks (``pin_read`` /
``pull_plan`` / :func:`sendv_addrs`).  ``backend="python"`` (or
``use_native=False``, or a custom ``initializer``) selects the Python
dict backend, bitwise the reference's own Python backend; a failed
native build raises instead of falling back.
"""
from __future__ import annotations

import ctypes
import io
import os
import threading
from typing import Dict, Optional

import numpy as np

__all__ = ["SparseTable", "PSRuntime", "quantize_rows_q8",
           "dequantize_rows_q8", "sendv_addrs"]

_OPT_CODES = {"sgd": 0, "adagrad": 1, "adam": 2}
# the native core's admission modes (0: none)
_ENTRY_COUNT, _ENTRY_PROB = 1, 2


def quantize_rows_q8(rows: np.ndarray):
    """Per-row symmetric int8 quantization, bitwise what the native
    ``pts_pull_q8`` ships: float32 ``amax / 127`` scale, float32 division,
    ties-to-even rounding, clip to +-127.  All-zero rows get scale 0 and
    codes 0.  Returns ``(codes int8, scales float32)``."""
    rows = np.ascontiguousarray(rows, np.float32)
    amax = np.abs(rows).max(axis=1) if rows.size else \
        np.zeros(rows.shape[0], np.float32)
    scales = (amax / np.float32(127.0)).astype(np.float32)
    codes = np.zeros(rows.shape, np.int8)
    nz = scales > 0
    if nz.any():
        codes[nz] = np.clip(np.rint(rows[nz] / scales[nz, None]),
                            -127, 127).astype(np.int8)
    return codes, scales


def dequantize_rows_q8(codes: np.ndarray, scales: np.ndarray):
    """Host dequant: one float32 multiply per element, the arithmetic the
    ``pull_dequant`` kernel does on the card."""
    return codes.astype(np.float32) * np.asarray(
        scales, np.float32)[:, None]


def _ptr(arr: np.ndarray, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def sendv_addrs(fd: int, addrs: np.ndarray, row_bytes: int, hdr: bytes,
                inv: np.ndarray, timeout_ms: int = -1) -> int:
    """Native scatter-gather send of a zero-copy pull reply: ``hdr`` and
    the ``inv`` bytes, then one iovec per contiguous run of the
    address-sorted rows (address 0 ships a zeros row), looping
    ``sendmsg`` in IOV_MAX windows with EINTR retry, partial-send advance
    and poll on EAGAIN.  Returns the bytes sent, or ``-errno``."""
    from ...native import ps_core
    lib = ps_core()
    addrs = np.ascontiguousarray(addrs, np.uint64)
    inv = np.ascontiguousarray(inv, np.int32)
    return int(lib.pts_sendv_addrs(
        int(fd), _ptr(addrs, ctypes.c_uint64), addrs.size, int(row_bytes),
        hdr, len(hdr), inv.ctypes.data_as(ctypes.c_void_p), inv.nbytes,
        int(timeout_ms)))


class SparseTable:
    """Unbounded host table of ``dim``-wide f32 rows keyed by int64 id;
    rows materialise on first touch.

    The native C++ sharded core backs it unless ``backend="python"``,
    ``use_native=False`` or a custom ``initializer`` asks for the Python
    dict backend: lock-sharded pull and push, a fused push (dedup +
    segment-sum + optimizer apply in one C pass), the stock admission
    policies inside the directory probe, and deterministic per-id row
    init (independent of insertion order and shard count).  The Python
    backend draws its init from one seeded generator in
    materialisation order, so its rows equal the native backend's only
    at ``init_std=0``.

    Push semantics (both backends): duplicate ids' gradients are summed
    first and the optimizer (``sgd``, ``adagrad`` or ``adam``) applies
    once per unique id."""

    def __init__(self, dim: int, initializer=None, optimizer: str = "sgd",
                 lr: float = 0.01, seed: int = 0, init_std: float = 0.01,
                 backend: str = "auto", n_shards: int = 32,
                 beta1: float = 0.9, beta2: float = 0.999,
                 epsilon: float = 1e-10, entry=None,
                 use_native: Optional[bool] = None,
                 geo_policy: str = "add"):
        if optimizer not in _OPT_CODES:
            raise ValueError(f"optimizer must be one of {sorted(_OPT_CODES)}"
                             f", got {optimizer!r}")
        self.dim = int(dim)
        self._seed = int(seed)
        self._init_std = float(init_std)
        # geo conflict policy: how concurrent writes from two
        # geo-bridged clusters resolve on THIS table — "add" merges
        # deltas additively per slot, "lww" resolves whole rows to the
        # last writer per (lamport seq, site) stamp (PSServer keeps the
        # stamp directory; the table only declares the policy)
        if geo_policy not in ("add", "lww"):
            raise ValueError(f"geo_policy must be 'add' or 'lww', "
                             f"got {geo_policy!r}")
        self.geo_policy = geo_policy
        # feature admission (reference entry_attr.py): ids the entry has
        # not admitted pull zeros and drop their grads — no row memory
        self._entry = entry
        self._admitted: set = set()
        self._admitted_arr = None   # np.int64 snapshot for np.isin
        self._seen: Dict[int, int] = {}
        self._opt = optimizer
        self._lr = lr
        self._native = None
        self._native_entry = False  # admission evaluated inside C
        self._lib = None
        if use_native is None:
            use_native = backend != "python"
        if use_native and initializer is None:
            # a failed build raises: there is no silent Python fallback
            from ...native import ps_core
            lib = self._lib = ps_core()
            self._native = lib.pts_create(
                self.dim, _OPT_CODES[optimizer], lr, beta1, beta2, epsilon,
                init_std, self._seed, n_shards)
            if entry is not None:
                # only the two stock policies have C twins; a custom
                # entry object keeps Python admission over native rows
                from ..entry import CountFilterEntry, ProbabilityEntry
                if type(entry) is CountFilterEntry:
                    lib.pts_set_entry(self._native, _ENTRY_COUNT,
                                      float(entry.count_filter))
                    self._native_entry = True
                elif type(entry) is ProbabilityEntry:
                    lib.pts_set_entry(self._native, _ENTRY_PROB,
                                      float(entry.probability))
                    self._native_entry = True
        # python fallback state
        self._version = 0   # applied mutating batches (native: in C)
        self._rows: Dict[int, np.ndarray] = {}
        self._moments: Dict[int, np.ndarray] = {}
        self._moments2: Dict[int, np.ndarray] = {}
        self._steps: Dict[int, int] = {}
        # feature lifecycle (python mirror of the native clock/touched/
        # churn state)
        self._clock = 0
        self._touched: Dict[int, int] = {}
        # geo LWW stamp fallback (native tables keep stamps in the slot
        # directory); values are (lamport seq, site idx)
        self._geo_stamps: Dict[int, tuple] = {}
        self._py_admitted_total = 0
        self._py_evicted_total = 0
        self._beta1, self._beta2, self._eps = beta1, beta2, epsilon
        self._rng = np.random.default_rng(seed)
        self._init = initializer or (
            lambda: self._rng.normal(0, init_std,
                                     size=(dim,)).astype(np.float32))
        self._lock = threading.Lock()

    @property
    def is_native(self) -> bool:
        return self._native is not None

    def __del__(self):
        if getattr(self, "_native", None) is not None:
            self._lib.pts_free(self._native)
            self._native = None

    def _c(self, arr, ctype):
        return arr.ctypes.data_as(ctypes.POINTER(ctype))

    def _filter_admitted(self, ids: np.ndarray, counting: bool):
        """Boolean admitted-mask for ``ids`` (Python/hybrid path only —
        native-entry tables evaluate admission inside C). Each pull
        counts as ONE sighting per unique id (a batch with an id
        repeated k times is one show, and every occurrence gets the same
        admission verdict so one forward never mixes zeros with a real
        row for one id). Steady state (all ids admitted) is one
        vectorized np.isin."""
        with self._lock:
            arr = self._admitted_arr
            if arr is None or arr.size != len(self._admitted):
                arr = self._admitted_arr = np.fromiter(
                    self._admitted, np.int64, len(self._admitted))
        mask = np.isin(ids, arr)
        if mask.all():
            return mask
        # count-independent entries (ProbabilityEntry) must not leave
        # per-id counters behind for permanently rejected ids
        counting = counting and getattr(self._entry, "needs_count", True)
        newly = False
        miss = np.flatnonzero(~mask)
        uniq = np.unique(ids[miss])
        verdict = {}
        with self._lock:
            for k in uniq.tolist():
                k = int(k)
                if k in self._admitted:    # raced in since isin snapshot
                    verdict[k] = True
                    continue
                if counting:
                    self._seen[k] = self._seen.get(k, 0) + 1
                    self._touched[k] = self._clock
                if self._entry.admit(k, self._seen.get(k, 0)):
                    self._admitted.add(k)
                    self._seen.pop(k, None)
                    verdict[k] = True
                    newly = True
                else:
                    verdict[k] = False
            if newly:
                self._admitted_arr = None  # rebuild fast-path snapshot
        for i in miss:
            mask[i] = verdict[int(ids[i])]
        return mask

    def pull(self, ids: np.ndarray) -> np.ndarray:
        ids = np.ascontiguousarray(np.asarray(ids).reshape(-1), np.int64)
        if self._native is not None and (self._entry is None
                                         or self._native_entry):
            # one C transaction: dedup + admission + gather (non-admitted
            # positions come back zeroed)
            out = np.empty((ids.size, self.dim), np.float32)
            self._lib.pts_pull(self._native, self._c(ids, ctypes.c_int64),
                               ids.size, self._c(out, ctypes.c_float))
            return out
        if self._entry is not None:
            mask = self._filter_admitted(ids, counting=True)
            out = np.zeros((ids.size, self.dim), np.float32)
            if mask.any():
                out[mask] = self._pull_admitted(ids[mask])
            return out
        return self._pull_admitted(ids)

    def _pull_admitted(self, ids: np.ndarray) -> np.ndarray:
        ids = np.ascontiguousarray(ids, np.int64)
        out = np.empty((ids.size, self.dim), np.float32)
        if self._native is not None:
            self._lib.pts_pull(self._native, self._c(ids, ctypes.c_int64),
                               ids.size, self._c(out, ctypes.c_float))
            return out
        with self._lock:
            for i, k in enumerate(ids.tolist()):
                row = self._rows.get(k)
                if row is None:
                    row = self._rows[k] = self._init()
                    self._py_admitted_total += 1
                self._touched[k] = self._clock
                out[i] = row
        return out

    def push(self, ids: np.ndarray, grads: np.ndarray):
        ids = np.ascontiguousarray(np.asarray(ids).reshape(-1), np.int64)
        grads = np.ascontiguousarray(
            np.asarray(grads, np.float32).reshape(ids.size, self.dim))
        if self._native is not None and (self._entry is None
                                         or self._native_entry):
            # fused C pass: dedup + segment-sum + admission + apply
            self._lib.pts_push(self._native, self._c(ids, ctypes.c_int64),
                               ids.size, self._c(grads, ctypes.c_float))
            return
        if self._entry is not None:
            # grads for never-admitted ids are dropped (their pulled
            # zeros carried no signal anyway) — reference show-click
            # filter semantics; pushes do not count as sightings
            mask = self._filter_admitted(ids, counting=False)
            if not mask.any():
                return
            if not mask.all():
                ids = np.ascontiguousarray(ids[mask])
                grads = np.ascontiguousarray(grads[mask])
        if self._native is not None:
            self._lib.pts_push(self._native, self._c(ids, ctypes.c_int64),
                               ids.size, self._c(grads, ctypes.c_float))
            return
        # python reference path: same fused semantics — duplicate ids'
        # grads sum first, optimizer applies once per unique id
        uniq, inverse = np.unique(ids, return_inverse=True)
        sums = np.zeros((uniq.size, self.dim), np.float32)
        np.add.at(sums, inverse, grads)
        with self._lock:
            self._version += 1
            for k, g in zip(uniq.tolist(), sums):
                row = self._rows.get(k)
                if row is None:
                    row = self._rows[k] = self._init()
                    self._py_admitted_total += 1
                self._touched[k] = self._clock
                if self._opt == "adagrad":
                    m = self._moments.get(k)
                    if m is None:
                        m = self._moments[k] = np.zeros(self.dim, np.float32)
                    m += g * g
                    row -= self._lr * g / (np.sqrt(m) + self._eps)
                elif self._opt == "adam":
                    m = self._moments.setdefault(
                        k, np.zeros(self.dim, np.float32))
                    v = self._moments2.setdefault(
                        k, np.zeros(self.dim, np.float32))
                    t = self._steps[k] = self._steps.get(k, 0) + 1
                    m[:] = self._beta1 * m + (1 - self._beta1) * g
                    v[:] = self._beta2 * v + (1 - self._beta2) * g * g
                    mh = m / (1 - self._beta1 ** t)
                    vh = v / (1 - self._beta2 ** t)
                    row -= self._lr * mh / (np.sqrt(vh) + self._eps)
                else:  # sgd
                    row -= self._lr * g

    def push_delta(self, ids: np.ndarray, deltas: np.ndarray):
        """Geo-async raw delta add (reference: GeoCommunicator delta-push,
        distributed/service/communicator.h:495) — no optimizer applied."""
        ids = np.ascontiguousarray(np.asarray(ids).reshape(-1), np.int64)
        deltas = np.ascontiguousarray(
            np.asarray(deltas, np.float32).reshape(ids.size, self.dim))
        if self._native is not None and (self._entry is None
                                         or self._native_entry):
            self._lib.pts_push_delta(
                self._native, self._c(ids, ctypes.c_int64), ids.size,
                self._c(deltas, ctypes.c_float))
            return
        if self._entry is not None:
            # the admission invariant holds on every write path: deltas
            # for never-admitted ids are dropped, no orphan rows
            mask = self._filter_admitted(ids, counting=False)
            if not mask.any():
                return
            if not mask.all():
                ids = np.ascontiguousarray(ids[mask])
                deltas = np.ascontiguousarray(deltas[mask])
        if self._native is not None:
            self._lib.pts_push_delta(
                self._native, self._c(ids, ctypes.c_int64), ids.size,
                self._c(deltas, ctypes.c_float))
            return
        with self._lock:
            self._version += 1
            for k, d in zip(ids.tolist(), deltas):
                row = self._rows.get(k)
                if row is None:
                    row = self._rows[k] = self._init()
                    self._py_admitted_total += 1
                self._touched[k] = self._clock
                row += d

    def _entry_state(self):
        """Admission state for checkpoints: without it a warm-start would
        hide every trained row behind re-admission (pull zeros, drop
        grads) until the entry re-admits the id."""
        with self._lock:
            return self._entry_state_locked()

    def _native_entry_state(self):
        """Admission state straight from the C directory (two-phase
        export like pts_export, capped against concurrent growth)."""
        lib, h = self._lib, self._native
        n_adm = int(lib.pts_entry_export(h, 0, None, None, 0))
        adm = np.empty(max(n_adm, 1), np.int64)
        w = int(lib.pts_entry_export(h, 0, self._c(adm, ctypes.c_int64),
                                     None, n_adm)) if n_adm else 0
        n_seen = int(lib.pts_entry_export(h, 1, None, None, 0))
        sid = np.empty(max(n_seen, 1), np.int64)
        cnt = np.empty(max(n_seen, 1), np.int64)
        ws = int(lib.pts_entry_export(h, 1, self._c(sid, ctypes.c_int64),
                                      self._c(cnt, ctypes.c_int64),
                                      n_seen)) if n_seen else 0
        return {"admitted": adm[:w], "seen_ids": sid[:ws],
                "seen_counts": cnt[:ws]}

    def _entry_state_locked(self):
        if self._entry is None:
            return {}
        if self._native_entry:
            return self._native_entry_state()
        adm = np.fromiter(self._admitted, np.int64, len(self._admitted))
        seen_ids = np.fromiter(self._seen, np.int64, len(self._seen))
        seen_cnt = np.asarray([self._seen[int(i)] for i in seen_ids],
                              np.int64)
        return {"admitted": adm, "seen_ids": seen_ids,
                "seen_counts": seen_cnt}

    def _restore_entry_state_locked(self, d, row_ids):
        if self._entry is None:
            return
        if "admitted" in d:
            adm = np.ascontiguousarray(d["admitted"], np.int64)
            sid = np.ascontiguousarray(d["seen_ids"], np.int64)
            cnt = np.ascontiguousarray(d["seen_counts"], np.int64)
        else:
            # legacy checkpoint without admission state: every saved
            # row was trained, therefore admitted
            adm = np.ascontiguousarray(np.asarray(row_ids), np.int64)
            sid = cnt = np.zeros(0, np.int64)
        if self._native_entry:
            self._lib.pts_entry_import(
                self._native, self._c(adm, ctypes.c_int64), adm.size,
                self._c(sid, ctypes.c_int64),
                self._c(cnt, ctypes.c_int64), sid.size)
            return
        self._admitted = set(adm.tolist())
        self._seen = dict(zip(sid.tolist(), cnt.tolist()))
        self._admitted_arr = None

    def _restore_entry_state(self, d, row_ids):
        with self._lock:
            self._restore_entry_state_locked(d, row_ids)

    def __len__(self):
        if self._native is not None:
            return int(self._lib.pts_size(self._native))
        return len(self._rows)

    @property
    def version(self) -> int:
        """Count of applied mutating batches (push/push_delta calls) —
        the native core's last-seq counter, exposed alongside the id
        directory.  A primary and a caught-up replica report the same
        version; the chaos harness audits it."""
        if self._native is not None:
            return int(self._lib.pts_version(self._native))
        return self._version

    # -- feature lifecycle ---------------------------------------------
    def set_clock(self, now: int):
        """Advance the table's lifecycle clock (the TTL sweeper stamps
        wall seconds once per tick).  Every pull/push/push_delta touch
        of an id copies the current clock into its last-sighting stamp;
        sightings are therefore timestamped at tick granularity."""
        if self._native is not None:
            self._lib.pts_set_clock(self._native, int(now))
        else:
            self._clock = int(now)

    def touch_all(self, now: int):
        """Grandfather pass: stamp every known id (and the clock) to
        ``now`` — rows of unknown age (created before any lifecycle
        sweeper ran, or restored from a checkpoint) age from here
        instead of being evicted as tick-0 ancients."""
        if self._native is not None:
            self._lib.pts_touch_all(self._native, int(now))
            return
        with self._lock:
            self._clock = int(now)
            keys = (set(self._rows) | set(self._seen)
                    | set(self._admitted))
            self._touched = {k: int(now) for k in keys}

    def ttl_sweep(self, cutoff: int) -> np.ndarray:
        """Evict every id whose last sighting predates ``cutoff``
        (materialised rows AND pre-admission counters — a stale feature
        fully expires and must re-earn admission).  Surviving rows keep
        their exact bits (values, optimizer moments, step counters).
        Returns the evicted ids (sorted); counts as one applied
        mutating batch iff anything was evicted."""
        if self._native is not None:
            cap = int(self._lib.pts_slots(self._native))
            out = np.empty(max(cap, 1), np.int64)
            n = int(self._lib.pts_ttl_sweep(
                self._native, int(cutoff),
                self._c(out, ctypes.c_int64), cap))
            return np.sort(out[:n])
        with self._lock:
            keys = (set(self._rows) | set(self._seen)
                    | set(self._admitted) | set(self._touched))
            evict = sorted(k for k in keys
                           if self._touched.get(k, 0) < cutoff)
            if evict:
                self._drop_ids_locked(evict)
                self._version += 1
                self._py_evicted_total += len(evict)
        return np.asarray(evict, np.int64)

    def evict_ids(self, ids) -> int:
        """Exact-id eviction — the replica-side replay of a primary's
        TTL sweep (the streamed ``evict`` record names the swept ids).
        ALWAYS counts as one applied mutating batch: the primary sweep
        that produced the record did, and version parity is the audited
        catch-up invariant.  Returns how many ids were present."""
        ids = np.ascontiguousarray(np.asarray(ids).reshape(-1), np.int64)
        if self._native is not None:
            return int(self._lib.pts_evict(
                self._native, self._c(ids, ctypes.c_int64), ids.size))
        with self._lock:
            present = [k for k in ids.tolist()
                       if k in self._rows or k in self._seen
                       or k in self._admitted or k in self._touched]
            self._drop_ids_locked(present)
            self._version += 1
            if present:
                self._py_evicted_total += len(present)
        return len(present)

    def _drop_ids_locked(self, keys):
        for k in keys:
            self._rows.pop(k, None)
            self._moments.pop(k, None)
            self._moments2.pop(k, None)
            self._steps.pop(k, None)
            self._seen.pop(k, None)
            self._touched.pop(k, None)
            # geo stamps live and die with the slot (native parity)
            self._geo_stamps.pop(k, None)
            self._admitted.discard(k)
        self._admitted_arr = None

    def set_vals(self, ids, vals):
        """LWW geo row replacement: overwrite the VALUE part of each
        id's row wholesale — existing rows keep their optimizer
        moments, fresh rows materialise with zeroed state (the incoming
        value IS the row, no deterministic init).  Bypasses admission
        but marks the id admitted (the origin cluster admitted it).
        One applied mutating batch per call, empty calls included (the
        replica replay of a geo_set record must tick version exactly
        like the primary's apply of its winning subset)."""
        ids = np.ascontiguousarray(np.asarray(ids).reshape(-1), np.int64)
        vals = np.ascontiguousarray(
            np.asarray(vals, np.float32).reshape(ids.size, self.dim))
        if self._native is not None:
            self._lib.pts_set_vals(self._native,
                                   self._c(ids, ctypes.c_int64), ids.size,
                                   self._c(vals, ctypes.c_float))
            return
        with self._lock:
            self._version += 1
            # geo-replicated rows do NOT count toward admitted_total
            # (matching the native import-style materialisation): they
            # were admitted at the origin cluster, not sighted here
            for k, v in zip(ids.tolist(), vals):
                self._rows[k] = v.copy()
                self._touched[k] = self._clock
                if self._entry is not None:
                    self._admitted.add(k)
            if ids.size and self._entry is not None:
                self._admitted_arr = None

    @property
    def admitted_total(self) -> int:
        """Features newly materialised via admission since construction
        (imports/restores excluded) — the ``ps_feature_admitted``
        churn-metric source."""
        if self._native is not None:
            return int(self._lib.pts_admitted_total(self._native))
        return self._py_admitted_total

    @property
    def evicted_total(self) -> int:
        """Ids removed by TTL sweeps / evict replays — the
        ``ps_feature_evicted`` churn-metric source."""
        if self._native is not None:
            return int(self._lib.pts_evicted_total(self._native))
        return self._py_evicted_total

    # -- tiered hot/cold spill storage ---------------------------------
    def enable_spill(self, spill_dir: str) -> bool:
        """Attach per-shard mmap spill files under ``spill_dir`` (created
        fresh, truncating leftovers).  Once enabled, :meth:`spill_sweep`
        demotes cold rows out of the RAM arena instead of evicting them,
        and pulls transparently promote them back.  Native backend only —
        the Python dict fallback stays RAM-resident (returns False)."""
        if self._native is None:
            return False
        os.makedirs(str(spill_dir), exist_ok=True)
        return int(self._lib.pts_enable_spill(
            self._native, str(spill_dir).encode())) == 0

    def recover_spill(self, spill_dir: str) -> int:
        """Re-attach EXISTING spill files (crash recovery): every
        committed cold row re-seats as a spilled slot, admitted, aging
        from the current clock.  Records whose commit mark never landed
        (SIGKILL mid-demote) are reclaimed as free space — the
        payload-before-id write order makes this safe.  Returns rows
        recovered (-1 when unavailable)."""
        if self._native is None:
            return -1
        return int(self._lib.pts_spill_recover(
            self._native, str(spill_dir).encode()))

    def spill_sweep(self, cutoff: int) -> int:
        """Demote-instead-of-evict: move every row whose last sighting
        predates ``cutoff`` (same temperature signal as
        :meth:`ttl_sweep`: the lifecycle ticks) from the RAM
        arena to the shard's spill file.  Pure placement, no value
        change: not a mutating batch, nothing to replicate.  Returns
        rows demoted (-1 when spill is not enabled)."""
        if self._native is None:
            return -1
        return int(self._lib.pts_spill_sweep(self._native, int(cutoff)))

    def spill_advise(self):
        """Flush spill pages and drop them from this process's resident
        set (msync + MADV_DONTNEED) — cold rows stop counting against
        RSS, which is what makes rows-beyond-RAM honest."""
        if self._native is not None:
            self._lib.pts_spill_advise(self._native)

    @property
    def spill_enabled(self) -> bool:
        return (self._native is not None
                and int(self._lib.pts_spill_enabled(self._native)) == 1)

    def spill_stats(self) -> dict:
        """``{hot, cold, promoted, demoted}`` row counts — hot/cold are
        the live split, promoted/demoted are lifetime tier-crossing
        totals (the churn signal tools/profile_ps.py --tier reports)."""
        if self._native is None:
            return dict(hot=len(self._rows), cold=0, promoted=0,
                        demoted=0)
        out = np.zeros(4, np.uint64)
        self._lib.pts_spill_stats(self._native,
                                  self._c(out, ctypes.c_uint64))
        return dict(hot=int(out[0]), cold=int(out[1]),
                    promoted=int(out[2]), demoted=int(out[3]))

    # -- SIMD fused push -----------------------------------------------
    @staticmethod
    def simd_available() -> bool:
        """True when the native core compiled with AVX2 on this host."""
        from ...native import ps_core
        return int(ps_core().pts_simd_available()) == 1

    @staticmethod
    def set_simd(on: bool):
        """Process-wide toggle between the AVX2 and scalar optimizer
        paths — bit-exact by construction (same evaluation order, FP
        contraction disabled), which the parity suite asserts."""
        from ...native import ps_core
        ps_core().pts_set_simd(1 if on else 0)

    # -- int8 wire rows ------------------------------------------------
    def pull_q8(self, ids: np.ndarray):
        """Pull with per-row symmetric int8 quantization: returns
        ``(codes[n, dim] int8, scales[n] float32)`` where
        ``codes * scale`` reconstructs the row to ~0.4% of its amax.
        Same admission/sighting semantics as :meth:`pull`; all-zero and
        non-admitted rows ship ``scale == 0``.  Native and Python
        backends are bit-identical (ties-to-even rounding both sides)."""
        ids = np.ascontiguousarray(np.asarray(ids).reshape(-1), np.int64)
        if self._native is not None and (self._entry is None
                                         or self._native_entry):
            codes = np.empty((ids.size, self.dim), np.int8)
            scales = np.empty(ids.size, np.float32)
            self._lib.pts_pull_q8(
                self._native, self._c(ids, ctypes.c_int64), ids.size,
                self._c(codes, ctypes.c_int8),
                self._c(scales, ctypes.c_float))
            return codes, scales
        rows = self.pull(ids)
        return quantize_rows_q8(rows)

    # -- geo LWW stamp directory ---------------------------------------
    # The per-id (lamport seq, site) stamps that order geo "lww" writes
    # used to live in a server-side Python dict; at spill scale that
    # dict is a second vocabulary-sized index, so the native core keeps
    # the stamps inside the slot directory itself.  Sites are interned
    # to int32 indices by the caller (PSServer owns idx <-> site-string;
    # the string order is what tiebreaks, so interning preserves it only
    # through the caller's comparison — the table just stores ints).
    def geo_get(self, ids: np.ndarray):
        """Per-id stamps as ``(seqs int64, site_idx int32)``; unstamped
        ids report ``(-1, -1)``.  Never materialises rows."""
        ids = np.ascontiguousarray(np.asarray(ids).reshape(-1), np.int64)
        seqs = np.empty(ids.size, np.int64)
        sites = np.empty(ids.size, np.int32)
        if self._native is not None:
            self._lib.pts_geo_get(
                self._native, self._c(ids, ctypes.c_int64), ids.size,
                self._c(seqs, ctypes.c_int64),
                self._c(sites, ctypes.c_int32))
            return seqs, sites
        with self._lock:
            for i, k in enumerate(ids.tolist()):
                seqs[i], sites[i] = self._geo_stamps.get(k, (-1, -1))
        return seqs, sites

    def geo_put(self, ids: np.ndarray, seqs: np.ndarray,
                sites: np.ndarray):
        """Commit WINNING stamps (the LWW comparison already happened in
        the caller, where site strings live).  Stamps survive demotion
        (the slot stays) and drop with eviction, like the row."""
        ids = np.ascontiguousarray(np.asarray(ids).reshape(-1), np.int64)
        seqs = np.ascontiguousarray(np.asarray(seqs).reshape(-1), np.int64)
        sites = np.ascontiguousarray(
            np.asarray(sites).reshape(-1), np.int32)
        if self._native is not None:
            self._lib.pts_geo_put(
                self._native, self._c(ids, ctypes.c_int64), ids.size,
                self._c(seqs, ctypes.c_int64),
                self._c(sites, ctypes.c_int32))
            return
        with self._lock:
            for k, sq, st in zip(ids.tolist(), seqs.tolist(),
                                 sites.tolist()):
                self._geo_stamps[k] = (sq, st)

    def geo_export(self):
        """All stamped ids as ``(ids, seqs, site_idx)`` — the replica
        attach handshake ships these so a promoted standby keeps
        resolving geo conflicts exactly where the primary left off."""
        if self._native is not None:
            n = int(self._lib.pts_geo_export(self._native, None, None,
                                             None, 0))
            ids = np.empty(max(n, 1), np.int64)
            seqs = np.empty(max(n, 1), np.int64)
            sites = np.empty(max(n, 1), np.int32)
            w = int(self._lib.pts_geo_export(
                self._native, self._c(ids, ctypes.c_int64),
                self._c(seqs, ctypes.c_int64),
                self._c(sites, ctypes.c_int32), n)) if n else 0
            return ids[:w], seqs[:w], sites[:w]
        with self._lock:
            ids = np.fromiter(self._geo_stamps, np.int64,
                              len(self._geo_stamps))
            seqs = np.asarray([self._geo_stamps[int(k)][0] for k in ids],
                              np.int64)
            sites = np.asarray(
                [self._geo_stamps[int(k)][1] for k in ids], np.int32)
        return ids, seqs, sites

    # -- zero-copy pull service hooks ----------------------------------
    def pin_read(self) -> bool:
        """Take the table's shared read pin: until :meth:`unpin_read`,
        no mutator may move or rewrite row bytes, so addresses from
        :meth:`resolve` stay valid and torn-free for a scatter-gather
        send.  Pin and unpin MUST happen on the same thread."""
        if self._native is None:
            return False
        self._lib.pts_pin_read(self._native)
        return True

    def unpin_read(self):
        if self._native is not None:
            self._lib.pts_unpin_read(self._native)

    def resolve(self, ids: np.ndarray):
        """Raw arena addresses (uint64; 0 = not admitted) for PRE-DEDUPED
        ids — pull admission/sighting semantics, spilled rows promote.
        Caller holds the read pin.  None on the Python backend."""
        if self._native is None:
            return None
        ids = np.ascontiguousarray(np.asarray(ids).reshape(-1), np.int64)
        addrs = np.empty(ids.size, np.uint64)
        self._lib.pts_resolve(self._native,
                              self._c(ids, ctypes.c_int64), ids.size,
                              self._c(addrs, ctypes.c_uint64))
        return addrs

    def pull_plan(self, ids: np.ndarray):
        """One-call send plan for the zc wire: dedup the RAW id batch,
        resolve uniques (promoting spilled rows), sort by arena address
        (non-admitted 0s first).  Returns ``(inv int32[n], addrs
        uint64[m])`` with ``inv`` mapping each input position to its
        row's rank in ``addrs`` — everything the service layer needs to
        scatter-gather the reply with zero staging.  Caller holds the
        read pin.  None on the Python backend."""
        if self._native is None:
            return None
        ids = np.ascontiguousarray(np.asarray(ids).reshape(-1), np.int64)
        inv = np.empty(ids.size, np.int32)
        addrs = np.empty(ids.size, np.uint64)
        m = self._lib.pts_pull_plan(self._native,
                                    self._c(ids, ctypes.c_int64), ids.size,
                                    self._c(inv, ctypes.c_int32),
                                    self._c(addrs, ctypes.c_uint64))
        return inv, addrs[:m]

    def config_arrays(self) -> dict:
        """The table's construction config as npz-storable scalars —
        rides in every snapshot so a replica (or warm start) can
        recreate a table it was not configured with, byte-compatible:
        same optimizer math AND the same deterministic per-id init
        (seed/init_std) for rows that first materialise after a
        failover."""
        return dict(opt=np.str_(self._opt), lr=np.float64(self._lr),
                    beta1=np.float64(self._beta1),
                    beta2=np.float64(self._beta2),
                    eps=np.float64(self._eps),
                    init_std=np.float64(self._init_std),
                    seed=np.int64(self._seed),
                    policy=np.str_(self.geo_policy))

    def clone_config(self) -> "SparseTable":
        """A NEW empty table with this table's exact construction
        config (dim, optimizer math, deterministic init seed) — the
        geo tier's mirror primitive: a remote cluster built from the
        same config materialises byte-identical rows for ids it first
        sees via ``push_delta``, so state can converge by shipping
        deltas only.  Custom Python initializers are not clonable
        (their state is opaque); use the stock seeded init for
        geo-replicated tables."""
        return SparseTable(self.dim, optimizer=self._opt, lr=self._lr,
                           seed=self._seed, init_std=self._init_std,
                           beta1=self._beta1, beta2=self._beta2,
                           epsilon=self._eps,
                           use_native=self._native is not None,
                           geo_policy=self.geo_policy)

    @staticmethod
    def from_config(d) -> "SparseTable":
        """Build a table from a snapshot's npz dict: exact dim even for
        an empty table (vals is always (0, dim)-shaped), and the saved
        optimizer/init config when present (older checkpoints fall back
        to defaults)."""
        vals = d["vals"]
        dim = int(vals.shape[1]) if getattr(vals, "ndim", 0) == 2 else 1
        kw = {}
        if "opt" in d:
            kw = dict(optimizer=str(d["opt"]), lr=float(d["lr"]),
                      beta1=float(d["beta1"]), beta2=float(d["beta2"]),
                      epsilon=float(d["eps"]),
                      init_std=float(d["init_std"]),
                      seed=int(d["seed"]))
            if "policy" in d:
                kw["geo_policy"] = str(d["policy"])
        return SparseTable(dim, **kw)

    def _opt_state_width(self) -> int:
        """Floats of optimizer state per row in the REPLICATION snapshot
        layout (mirrors the native arena stride minus the value):
        sgd ``[step]``, adagrad ``[acc(dim), step]``, adam
        ``[m(dim), v(dim), step]`` — identical for both backends so a
        python replica of a native primary (or vice versa) inherits the
        exact optimizer trajectory."""
        if self._native is not None:
            return int(self._lib.pts_stride(self._native)) - self.dim
        return {"adam": 2 * self.dim + 1,
                "adagrad": self.dim + 1}.get(self._opt, 1)

    def _snapshot_arrays(self, full_state: bool = False):
        """The checkpoint payload (ids/vals/entry state/config/version)
        as one consistent dict — shared by file save and replication
        snapshots.  ``full_state`` additionally exports the per-row
        optimizer state (``opt_state``, layout per
        :meth:`_opt_state_width`): the DISK format deliberately keeps
        the reference's values-only semantics (state rebuilds on warm
        start), but a hot replica of a stateful optimizer MUST inherit
        the moments or its post-snapshot applies diverge from the
        primary's trajectory."""
        if self._native is not None:
            stride = int(self._lib.pts_stride(self._native))
            with self._lock:
                # entry state FIRST, then rows: an id admitted during the
                # export window is then missing from the admitted set
                # (safe: brief re-admission) instead of admitted with no
                # row (unsafe: trained id serving fresh-init forever)
                entry = self._entry_state_locked()
                n = int(self._lib.pts_size(self._native))
                ids = np.empty(n, np.int64)
                if full_state:
                    rows = np.empty((n, stride), np.float32)
                    if n:
                        w = self._lib.pts_export_full(
                            self._native, self._c(ids, ctypes.c_int64),
                            self._c(rows, ctypes.c_float), n)
                        ids, rows = ids[:w], rows[:w]
                    vals = np.ascontiguousarray(rows[:, :self.dim])
                    opt_state = np.ascontiguousarray(rows[:, self.dim:])
                else:
                    vals = np.empty((n, self.dim), np.float32)
                    opt_state = None
                    if n:
                        # cap=n: the table may grow concurrently; export
                        # writes at most n rows (the snapshot is
                        # whatever fit)
                        w = self._lib.pts_export(
                            self._native, self._c(ids, ctypes.c_int64),
                            self._c(vals, ctypes.c_float), n)
                        ids, vals = ids[:w], vals[:w]
                ver = int(self._lib.pts_version(self._native))
            out = dict(ids=ids, vals=vals, version=np.int64(ver),
                       **self.config_arrays(), **entry)
            if opt_state is not None:
                out["opt_state"] = opt_state
            return out
        with self._lock:
            # one lock section: the rows snapshot and the admission
            # state must agree (and concurrent push must not mutate the
            # dict mid-iteration)
            ids = np.fromiter(self._rows, np.int64, len(self._rows))
            vals = np.stack([self._rows[int(i)] for i in ids]) \
                if len(ids) else np.zeros((0, self.dim), np.float32)
            opt_state = None
            if full_state:
                w = self._opt_state_width()
                opt_state = np.zeros((ids.size, w), np.float32)
                for i, k in enumerate(ids.tolist()):
                    if self._opt in ("adagrad", "adam"):
                        m = self._moments.get(k)
                        if m is not None:
                            opt_state[i, :self.dim] = m
                    if self._opt == "adam":
                        v = self._moments2.get(k)
                        if v is not None:
                            opt_state[i, self.dim:2 * self.dim] = v
                    opt_state[i, -1] = float(self._steps.get(k, 0))
            entry = self._entry_state_locked()
            ver = self._version
        out = dict(ids=ids, vals=vals, version=np.int64(ver),
                   **self.config_arrays(), **entry)
        if opt_state is not None:
            out["opt_state"] = opt_state
        return out

    # checkpoint (reference: servers persist their shard,
    # the_one_ps.py:758 warm-start)
    def save(self, path: str):
        np.savez(path, **self._snapshot_arrays())
        # checkpoint writes are postmortem anchors: "did the table
        # persist before it died" is the first question after a crash
        from ...observability import flight_recorder as _flight
        _flight.record("ps.save", path=str(path), rows=len(self),
                       version=int(self.version))

    def state_bytes(self) -> bytes:
        """The whole table as npz bytes — what a hot standby or read
        replica catches up from.  Extends the on-disk checkpoint format
        with ``opt_state`` (per-row optimizer moments + step counters):
        a replica attaching MID-RUN to a stateful-optimizer table must
        inherit the moments, or every post-snapshot apply diverges
        (fresh zero moments take bigger adagrad/adam steps — caught by
        the read-replica re-attach drive)."""
        buf = io.BytesIO()
        np.savez(buf, **self._snapshot_arrays(full_state=True))
        return buf.getvalue()

    def load(self, path: str):
        self._load_npz(
            np.load(path if path.endswith(".npz") else path + ".npz"))
        from ...observability import flight_recorder as _flight
        _flight.record("ps.load", path=str(path), rows=len(self),
                       version=int(self.version))

    def load_state_bytes(self, data: bytes):
        """Restore from :meth:`state_bytes` (replication snapshot)."""
        self._load_npz(np.load(io.BytesIO(data)))

    def _load_npz(self, d):
        ids = np.ascontiguousarray(d["ids"], np.int64)
        vals = np.ascontiguousarray(d["vals"], np.float32)
        if vals.ndim != 2 or vals.shape[0] != ids.size or (
                ids.size and vals.shape[1] != self.dim):
            raise ValueError(
                f"checkpoint layout {vals.shape} does not match table "
                f"(rows={ids.size}, dim={self.dim}); was it saved from a "
                f"table with a different embedding dim?")
        ver = int(d["version"]) if "version" in d else 0
        opt_state = None
        if "opt_state" in d:
            opt_state = np.ascontiguousarray(d["opt_state"], np.float32)
            if opt_state.shape != (ids.size, self._opt_state_width()):
                raise ValueError(
                    f"snapshot opt_state layout {opt_state.shape} does "
                    f"not match optimizer {self._opt!r} (want "
                    f"({ids.size}, {self._opt_state_width()})) — was it "
                    f"taken from a table with a different optimizer?")
        if self._native is not None:
            # restore REPLACES (reference warm-start semantics,
            # the_one_ps.py:758) — never merges into existing rows
            self._lib.pts_clear(self._native)
            if opt_state is not None:
                rows = np.ascontiguousarray(
                    np.concatenate([vals, opt_state], axis=1))
                self._lib.pts_import_full(
                    self._native, self._c(ids, ctypes.c_int64),
                    ids.size, self._c(rows, ctypes.c_float))
            else:
                self._lib.pts_import(self._native,
                                     self._c(ids, ctypes.c_int64),
                                     ids.size,
                                     self._c(vals, ctypes.c_float))
            self._lib.pts_set_version(self._native, ver)
            self._restore_entry_state(d, ids)
            return
        with self._lock:
            # rows and admission state become visible atomically: a
            # concurrent pull must never see new rows with the stale
            # admitted set (it would serve zeros for trained ids)
            self._rows = {int(i): v.copy() for i, v in zip(ids, vals)}
            self._moments.clear()
            self._moments2.clear()
            self._steps.clear()
            # restored rows start a fresh TTL epoch (the native path
            # stamps touched=clock at import-insert time identically)
            self._touched = {int(i): self._clock for i in ids}
            if opt_state is not None:
                for i, k in enumerate(ids.tolist()):
                    if self._opt in ("adagrad", "adam"):
                        self._moments[k] = opt_state[i, :self.dim].copy()
                    if self._opt == "adam":
                        self._moments2[k] = \
                            opt_state[i, self.dim:2 * self.dim].copy()
                    step = int(opt_state[i, -1])
                    if step:
                        self._steps[k] = step
            self._version = ver
            self._restore_entry_state_locked(d, ids)


class PSRuntime:
    """Server/worker lifecycle (parity: fleet/runtime/the_one_ps.py:399
    TheOnePSRuntime).  Single-host: tables in-process.  Multi-host: serves
    tables over the socket service."""

    def __init__(self, strategy=None):
        self._strategy = strategy
        self._tables: Dict[str, SparseTable] = {}
        self._server = None

    def table(self, name: str, dim: int, **kw) -> SparseTable:
        if name not in self._tables:
            self._tables[name] = SparseTable(dim, **kw)
        return self._tables[name]

    def init_server(self, dirname: Optional[str] = None, var_names=None,
                    **kwargs):
        if dirname:
            for f in os.listdir(dirname):
                if f.endswith(".npz"):
                    name = f[:-4]
                    # dim + optimizer/init config recovered from the
                    # file (exact dim even for an empty table)
                    d = np.load(os.path.join(dirname, f))
                    t = SparseTable.from_config(d)
                    t.load(os.path.join(dirname, f))
                    self._tables[name] = t

    def run_server(self, expected_workers: Optional[int] = None,
                   replica_of: Optional[str] = None,
                   port: Optional[int] = None):
        """Serve this runtime's tables.  ``replica_of="host:port"``
        starts a hot standby of that primary instead of a fresh
        primary (fleet.run_server derives it from this server's
        position in its ``|``-separated replica group)."""
        from .ps_service import PSServer
        kw = {}
        cfg = getattr(self._strategy, "a_sync_configs", None)
        if cfg:
            kw = dict(heartbeat_timeout=cfg.get("heartbeat_timeout", 10.0),
                      on_dead=cfg.get("on_dead", "evict"))
        self._server = PSServer(self._tables,
                                port=port or 0,
                                expected_workers=expected_workers,
                                replica_of=replica_of, **kw)
        self._server.start()

    def init_worker(self, endpoints=None, worker_id=None):
        """Connect this trainer to the PS cluster (parity:
        the_one_ps.py _init_worker — builds the communicator).

        Picks the Communicator mode from the strategy (sync by default,
        async when ``a_sync``, geo when ``geo_sgd_mode``) and starts
        heartbeats at a third of the server's liveness timeout.
        """
        if endpoints is None:  # single-host in-process tables: no client
            self._client = None
            return None
        from .ps_service import PSClient
        cfg = dict(getattr(self._strategy, "a_sync_configs", None) or {})
        mode = "sync"
        if getattr(self._strategy, "a_sync", False):
            mode = "geo" if cfg.get("geo_sgd_mode") else "async"
        self._client = PSClient(
            endpoints, mode=mode,
            send_queue_size=cfg.get("send_queue_size", 16),
            geo_k_steps=cfg.get("geo_sgd_need_push_nums", 100),
            worker_id=worker_id,
            heartbeat_interval=(cfg.get("heartbeat_timeout", 10.0) / 3.0
                                if worker_id is not None else 0.0))
        return self._client

    def worker_barrier(self, timeout=None):
        if getattr(self, "_client", None) is None:
            return []
        return self._client.worker_barrier(timeout=timeout)

    def stop_worker(self):
        cli = getattr(self, "_client", None)
        if cli is not None:
            cli.leave()
            cli.close()
            self._client = None

    def stop(self):
        self.stop_worker()
        if self._server is not None:
            self._server.stop()

    def save_persistables(self, dirname: str):
        os.makedirs(dirname, exist_ok=True)
        for name, t in self._tables.items():
            t.save(os.path.join(dirname, name))
