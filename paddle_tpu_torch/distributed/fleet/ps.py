"""Host-RAM sparse embedding table of the parameter-server path.

Counterpart of ``paddle_tpu/distributed/fleet/ps.py``: ``SparseTable``
on the native C++ core (``paddle_tpu_torch/native/ps_core.cc``, the
reference's source), with the q8 wire helpers.  Rows materialise on
first touch with a deterministic per-id initialisation (seed, init_std),
so a table with the same config gives the reference's rows bit for bit;
a push is one fused C pass (dedup + segment-sum + optimizer apply, once
per unique id); the checkpoint format is the reference's npz layout, so
either package loads the other's ``save()`` / ``state_bytes()``.  The
feature lifecycle (``set_clock`` / ``touch_all`` / ``ttl_sweep`` /
``evict_ids``) and the zero-copy pull wire's hooks (``pin_read`` /
``pull_plan`` / :func:`sendv_addrs`) run on the same native core.

Not ported (each raises ``NotImplementedError`` naming ROADMAP.md item
6): feature admission (``entry=``), a custom ``initializer``, the Python
backend, spill tiers and the geo stamp directory.
"""
from __future__ import annotations

import ctypes
import io
import threading

import numpy as np

__all__ = ["SparseTable", "quantize_rows_q8", "dequantize_rows_q8",
           "sendv_addrs"]

_OPT_CODES = {"sgd": 0, "adagrad": 1, "adam": 2}
_ITEM6 = "not ported yet (ROADMAP.md item 6: PS, recsys, online tier)"


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
    """Unbounded host table of ``dim``-wide f32 rows keyed by int64 id.

    Push semantics: duplicate ids' gradients are summed first and the
    optimizer (``sgd``, ``adagrad`` or ``adam``) applies once per unique
    id, inside the native core.  Pull and push are thread-safe (the core
    locks per shard)."""

    def __init__(self, dim: int, initializer=None, optimizer: str = "sgd",
                 lr: float = 0.01, seed: int = 0, init_std: float = 0.01,
                 backend: str = "auto", n_shards: int = 32,
                 beta1: float = 0.9, beta2: float = 0.999,
                 epsilon: float = 1e-10, entry=None,
                 use_native=None, geo_policy: str = "add"):
        if entry is not None:
            raise NotImplementedError(f"SparseTable(entry=...): {_ITEM6}")
        if initializer is not None:
            raise NotImplementedError(
                f"SparseTable(initializer=...): {_ITEM6}")
        if backend == "python" or use_native is False:
            raise NotImplementedError(
                f"SparseTable's Python backend: {_ITEM6}")
        if geo_policy != "add":
            raise NotImplementedError(
                f"SparseTable(geo_policy={geo_policy!r}): {_ITEM6}")
        if optimizer not in _OPT_CODES:
            raise ValueError(f"optimizer must be one of {sorted(_OPT_CODES)}"
                             f", got {optimizer!r}")
        from ...native import ps_core
        self.dim = int(dim)
        self.geo_policy = geo_policy
        self._opt = optimizer
        self._lr = lr
        self._seed = int(seed)
        self._init_std = float(init_std)
        self._beta1, self._beta2, self._eps = beta1, beta2, epsilon
        self._lib = ps_core()
        self._native = self._lib.pts_create(
            self.dim, _OPT_CODES[optimizer], lr, beta1, beta2, epsilon,
            init_std, self._seed, n_shards)
        # orders checkpoint export against the load that replaces rows
        self._lock = threading.Lock()

    @property
    def is_native(self) -> bool:
        return True

    def __del__(self):
        if getattr(self, "_native", None) is not None:
            self._lib.pts_free(self._native)
            self._native = None

    def _ids(self, ids) -> np.ndarray:
        return np.ascontiguousarray(np.asarray(ids).reshape(-1), np.int64)

    def _rows(self, rows, n: int) -> np.ndarray:
        return np.ascontiguousarray(
            np.asarray(rows, np.float32).reshape(n, self.dim))

    def pull(self, ids: np.ndarray) -> np.ndarray:
        """Rows of ``ids`` (duplicates allowed), materialising new ids."""
        ids = self._ids(ids)
        out = np.empty((ids.size, self.dim), np.float32)
        self._lib.pts_pull(self._native, _ptr(ids, ctypes.c_int64),
                           ids.size, _ptr(out, ctypes.c_float))
        return out

    def push(self, ids: np.ndarray, grads: np.ndarray):
        """One fused pass: dedup, segment-sum, optimizer apply."""
        ids = self._ids(ids)
        grads = self._rows(grads, ids.size)
        self._lib.pts_push(self._native, _ptr(ids, ctypes.c_int64),
                           ids.size, _ptr(grads, ctypes.c_float))

    def push_delta(self, ids: np.ndarray, deltas: np.ndarray):
        """Raw delta add, no optimizer (the device cache's write-back)."""
        ids = self._ids(ids)
        deltas = self._rows(deltas, ids.size)
        self._lib.pts_push_delta(self._native, _ptr(ids, ctypes.c_int64),
                                 ids.size, _ptr(deltas, ctypes.c_float))

    def pull_q8(self, ids: np.ndarray):
        """Pull on the int8 wire: ``(codes [n, dim] int8, scales [n]
        float32)``, bitwise :func:`quantize_rows_q8` of :meth:`pull`."""
        ids = self._ids(ids)
        codes = np.empty((ids.size, self.dim), np.int8)
        scales = np.empty(ids.size, np.float32)
        self._lib.pts_pull_q8(self._native, _ptr(ids, ctypes.c_int64),
                              ids.size, _ptr(codes, ctypes.c_int8),
                              _ptr(scales, ctypes.c_float))
        return codes, scales

    def __len__(self):
        return int(self._lib.pts_size(self._native))

    @property
    def version(self) -> int:
        """Count of applied mutating batches (push / push_delta calls)."""
        return int(self._lib.pts_version(self._native))

    # -- feature lifecycle ---------------------------------------------
    def set_clock(self, now: int):
        """Advance the lifecycle clock (milliseconds): every later touch of
        an id (pull, push, push_delta) stamps it as the id's last
        sighting."""
        self._lib.pts_set_clock(self._native, int(now))

    def touch_all(self, now: int):
        """Stamp every known id (and the clock) with ``now``: rows of
        unknown age start ageing from here."""
        self._lib.pts_touch_all(self._native, int(now))

    def ttl_sweep(self, cutoff: int) -> np.ndarray:
        """Evict every id last sighted before ``cutoff``; survivors keep
        their bits.  Returns the evicted ids, sorted; one applied batch
        (``version`` + 1) iff anything was evicted."""
        cap = int(self._lib.pts_slots(self._native))
        out = np.empty(max(cap, 1), np.int64)
        n = int(self._lib.pts_ttl_sweep(self._native, int(cutoff),
                                        _ptr(out, ctypes.c_int64), cap))
        return np.sort(out[:n])

    def evict_ids(self, ids) -> int:
        """Evict exactly ``ids`` (a replica's replay of the primary's
        sweep); always one applied batch.  Returns how many were
        present."""
        ids = self._ids(ids)
        return int(self._lib.pts_evict(self._native,
                                       _ptr(ids, ctypes.c_int64), ids.size))

    @property
    def admitted_total(self) -> int:
        """Ids materialised since construction (restores excluded)."""
        return int(self._lib.pts_admitted_total(self._native))

    @property
    def evicted_total(self) -> int:
        """Ids removed by sweeps and evict replays."""
        return int(self._lib.pts_evicted_total(self._native))

    # -- the zero-copy pull wire ---------------------------------------
    def pin_read(self) -> bool:
        """Take the shared read pin: until :meth:`unpin_read` (on the same
        thread) no mutator moves or rewrites row bytes, so the addresses
        of :meth:`pull_plan` stay valid for a scatter-gather send."""
        self._lib.pts_pin_read(self._native)
        return True

    def unpin_read(self):
        self._lib.pts_unpin_read(self._native)

    def pull_plan(self, ids: np.ndarray):
        """Dedup ``ids``, resolve the unique ids' arena addresses (pull
        semantics: new ids materialise) and sort them by address.  Returns
        ``(inv int32[n], addrs uint64[m])``, ``inv`` mapping each input
        position to its row's rank in ``addrs``.  The caller holds the
        read pin."""
        ids = self._ids(ids)
        inv = np.empty(ids.size, np.int32)
        addrs = np.empty(ids.size, np.uint64)
        m = self._lib.pts_pull_plan(self._native, _ptr(ids, ctypes.c_int64),
                                    ids.size, _ptr(inv, ctypes.c_int32),
                                    _ptr(addrs, ctypes.c_uint64))
        return inv, addrs[:m]

    @staticmethod
    def from_config(d) -> "SparseTable":
        """A table built from a snapshot's npz dict: its dim (``vals`` is
        always ``(n, dim)``) and, when saved, its optimizer and init
        config, so a replica recreates a table it was not configured
        with."""
        vals = d["vals"]
        dim = int(vals.shape[1]) if getattr(vals, "ndim", 0) == 2 else 1
        kw = {}
        if "opt" in d:
            kw = dict(optimizer=str(d["opt"]), lr=float(d["lr"]),
                      beta1=float(d["beta1"]), beta2=float(d["beta2"]),
                      epsilon=float(d["eps"]),
                      init_std=float(d["init_std"]), seed=int(d["seed"]))
            if "policy" in d:
                kw["geo_policy"] = str(d["policy"])
        return SparseTable(dim, **kw)

    def config_arrays(self) -> dict:
        """The construction config as npz-storable scalars, as the
        reference writes them into every snapshot."""
        return dict(opt=np.str_(self._opt), lr=np.float64(self._lr),
                    beta1=np.float64(self._beta1),
                    beta2=np.float64(self._beta2),
                    eps=np.float64(self._eps),
                    init_std=np.float64(self._init_std),
                    seed=np.int64(self._seed),
                    policy=np.str_(self.geo_policy))

    def _opt_state_width(self) -> int:
        """Floats of optimizer state per row in a full snapshot: sgd
        ``[step]``, adagrad ``[acc(dim), step]``, adam ``[m(dim), v(dim),
        step]`` (the native arena stride minus the value)."""
        return int(self._lib.pts_stride(self._native)) - self.dim

    def _snapshot_arrays(self, full_state: bool = False) -> dict:
        """ids, vals (and with ``full_state`` the per-row optimizer state),
        version and config: the reference's checkpoint payload."""
        lib, h = self._lib, self._native
        with self._lock:
            n = int(lib.pts_size(h))
            ids = np.empty(n, np.int64)
            opt_state = None
            if full_state:
                rows = np.empty((n, int(lib.pts_stride(h))), np.float32)
                # cap n: the table may grow concurrently; the snapshot is
                # what fit
                w = lib.pts_export_full(h, _ptr(ids, ctypes.c_int64),
                                        _ptr(rows, ctypes.c_float), n) if n \
                    else 0
                ids, rows = ids[:w], rows[:w]
                vals = np.ascontiguousarray(rows[:, :self.dim])
                opt_state = np.ascontiguousarray(rows[:, self.dim:])
            else:
                vals = np.empty((n, self.dim), np.float32)
                w = lib.pts_export(h, _ptr(ids, ctypes.c_int64),
                                   _ptr(vals, ctypes.c_float), n) if n else 0
                ids, vals = ids[:w], vals[:w]
            ver = int(lib.pts_version(h))
        out = dict(ids=ids, vals=vals, version=np.int64(ver),
                   **self.config_arrays())
        if opt_state is not None:
            out["opt_state"] = opt_state
        return out

    def save(self, path: str):
        """Values-only checkpoint (the reference's disk format)."""
        np.savez(path, **self._snapshot_arrays())

    def state_bytes(self) -> bytes:
        """The whole table, optimizer state included, as npz bytes."""
        buf = io.BytesIO()
        np.savez(buf, **self._snapshot_arrays(full_state=True))
        return buf.getvalue()

    def load(self, path: str):
        self._load_npz(
            np.load(path if path.endswith(".npz") else path + ".npz"))

    def load_state_bytes(self, data: bytes):
        self._load_npz(np.load(io.BytesIO(data)))

    def _load_npz(self, d):
        """Replace the table's rows (never merge) with a snapshot's."""
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
                    f"snapshot opt_state layout {opt_state.shape} does not "
                    f"match optimizer {self._opt!r} (want ({ids.size}, "
                    f"{self._opt_state_width()})): was it taken from a "
                    f"table with a different optimizer?")
        lib, h = self._lib, self._native
        with self._lock:
            lib.pts_clear(h)
            if opt_state is not None:
                rows = np.ascontiguousarray(
                    np.concatenate([vals, opt_state], axis=1))
                lib.pts_import_full(h, _ptr(ids, ctypes.c_int64), ids.size,
                                    _ptr(rows, ctypes.c_float))
            else:
                lib.pts_import(h, _ptr(ids, ctypes.c_int64), ids.size,
                               _ptr(vals, ctypes.c_float))
            lib.pts_set_version(h, ver)


def _not_ported(name: str):
    def method(self, *args, **kwargs):
        raise NotImplementedError(f"SparseTable.{name}: {_ITEM6}")
    method.__name__ = name
    return method


# spill tiers and the geo stamp directory
for _name in ("enable_spill", "recover_spill", "spill_sweep", "geo_get",
              "geo_put", "geo_export"):
    setattr(SparseTable, _name, _not_ported(_name))
del _name
