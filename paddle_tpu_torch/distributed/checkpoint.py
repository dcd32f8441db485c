"""Checkpoints in the JAX package's on-disk format (counterpart of
``paddle_tpu/distributed/checkpoint.py``).

A checkpoint is a directory of per-shard ``.npy`` files plus a JSON index
(``checkpoint.index.json``) that records each array's global shape, dtype
and saved shard slices.  The port writes the same bytes as
``paddle_tpu`` for the same state (same file names, ``np.save`` payloads,
index layout), so either package restores the other's checkpoints.
Reads are lazy (``np.load(mmap_mode="r")``), and a 1-D entry can be read
by range without touching the rest.

- ``save_state_dict(state, path, async_save=...)``: writes every leaf (a
  numpy array, a torch tensor -- brought to the host -- or a
  :class:`StreamedArray`); ``async_save=True`` writes in a background
  thread, ``wait_until_finished()`` joins.
- ``load_state_dict(path, names=None)``: host numpy arrays, nested as
  they were saved.

One process writes and reads: the port has no multi-host runtime yet,
so there is no cross-process index merge or barrier, and
``shardings=`` (restoring straight into a device layout) raises
``NotImplementedError`` naming ROADMAP queue item 4.
"""
from __future__ import annotations

import json
import os
import threading
from collections.abc import Mapping as _AbcMapping
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

__all__ = ["save_state_dict", "load_state_dict", "CheckpointManager",
           "StreamedArray", "load_entry_range", "entry_meta",
           "wait_until_finished"]

_INDEX = "checkpoint.index.json"
_pending: list = []


class StreamedArray:
    """A lazy leaf for :func:`save_state_dict`: a
    ``(shape, dtype)`` promise whose bytes arrive as contiguous
    leading-axis chunks from a generator.

    The writer streams each chunk straight into the ``.npy`` file, so
    the full array is NEVER materialized in host memory — yet the
    on-disk bytes are identical to ``np.save`` of the concatenated
    array (same header, same payload), and the index entry identical
    to a plain ndarray leaf's.  This is what lets the elastic trainer
    checkpoint a global flat vector shard-by-shard within one shard's
    memory headroom while keeping the world-invariant format
    bit-for-bit.

    ``chunks`` is a zero-arg callable returning an iterable of arrays
    that concatenate (axis 0) to the full array.  It is invoked at
    WRITE time — for the elastic trainer that is what couples the
    coordinator exchange rounds to the file write.  An exception
    raised from the generator propagates out of the save with the
    ``.tmp`` file unpublished and the index unwritten: the torn step
    stays invisible, exactly like a mid-save crash.
    """

    def __init__(self, shape, dtype, chunks):
        self.shape = tuple(int(d) for d in shape)
        self.dtype = np.dtype(dtype)
        self._chunks = chunks

    def chunks(self):
        return self._chunks()


def _write_npy_streamed(fp, sa: StreamedArray):
    """Write ``sa`` chunk-by-chunk, bit-identical to ``np.save`` of
    the concatenated array, holding at most one chunk at a time."""
    np.lib.format.write_array_header_1_0(
        fp, {"descr": np.lib.format.dtype_to_descr(sa.dtype),
             "fortran_order": False, "shape": sa.shape})
    lead = sa.shape[0] if sa.shape else 1
    seen = 0
    for chunk in sa.chunks():
        c = np.ascontiguousarray(np.asarray(chunk, sa.dtype))
        if sa.shape and c.shape[1:] != sa.shape[1:]:
            raise IOError(
                f"streamed chunk trailing dims {c.shape[1:]} do not "
                f"match the promised shape {sa.shape}")
        fp.write(c.data if c.flags.c_contiguous else c.tobytes())
        seen += c.shape[0] if c.ndim else 1
    if seen != lead:
        # publishing a short file would hand _read_region's coverage
        # check a torn array later; fail the save here instead
        raise IOError(
            f"streamed array produced {seen} leading-axis rows, "
            f"promised {lead}")


def _leaf_value(v):
    """A torch tensor leaf comes to the host as numpy."""
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().numpy()
    return v


# state-dict keys legitimately contain dots ("0.weight") and slashes, so
# nested-dict flattening needs a separator no key can contain
_NEST_SEP = "||"
_EMPTY_DICT = "__empty_dict__"   # keeps empty sub-dicts round-tripping
_PY_SCALAR = "__pyscalar__"      # key suffix: leaf was a python scalar


def _flatten_state(state, prefix=""):
    """Nested dicts (model/opt/scheduler state_dicts as the user holds
    them) flatten to one name->leaf mapping; python scalars ride as 0-d
    arrays and come back as scalars."""
    out = {}
    for k, v in state.items():
        k = str(k)
        if _NEST_SEP in k:
            raise ValueError(
                f"state key {k!r} contains the reserved nesting "
                f"separator {_NEST_SEP!r}")
        if k.endswith(_PY_SCALAR):
            raise ValueError(
                f"state key {k!r} ends with the reserved scalar "
                f"marker {_PY_SCALAR!r}")
        key = f"{prefix}{_NEST_SEP}{k}" if prefix else k
        if isinstance(v, _AbcMapping):
            if v:
                out.update(_flatten_state(v, key))
            else:
                # an empty state_dict is still a key the restore script
                # will index; dropping it would turn save-ok into a
                # restore-time KeyError
                out[f"{key}{_NEST_SEP}{_EMPTY_DICT}"] = np.zeros(
                    0, np.int8)
        elif isinstance(v, (bool, int, float)) and not isinstance(
                v, np.generic):
            # python scalar (step counts, lr values): tagged at save so
            # restore converts ONLY these back — a genuine 0-d array
            # (learnable scalar param) stays an array with its dtype and
            # sharding-aware layout intact
            out[f"{key}{_PY_SCALAR}"] = np.asarray(v)
        else:
            out[key] = v
    return out


def _place_leaf(cur, last, v, legacy_scalars=False):
    if last.endswith(_PY_SCALAR):
        cur[last[:-len(_PY_SCALAR)]] = np.asarray(v).item()
    elif legacy_scalars and getattr(v, "ndim", None) == 0:
        # v1 checkpoints stored python scalars as untagged 0-d arrays
        cur[last] = np.asarray(v).item()
    else:
        cur[last] = v


def _unflatten_state(flat, legacy_scalars=False):
    if not any(_NEST_SEP in k for k in flat):
        out: Dict[str, Any] = {}
        for k, v in flat.items():
            _place_leaf(out, k, v, legacy_scalars)
        return out
    out = {}
    for k, v in flat.items():
        parts = k.split(_NEST_SEP)
        cur = out
        for p in parts[:-1]:
            cur = cur.setdefault(p, {})
        if parts[-1] == _EMPTY_DICT:
            continue   # marker: the setdefault walk already made the {}
        _place_leaf(cur, parts[-1], v, legacy_scalars)
    return out


def save_state_dict(state: Mapping[str, Any], path: str,
                    async_save: bool = False, _on_complete=None):
    """Write a name->array mapping — or an arbitrarily nested dict of
    state_dicts (``{"model": ..., "opt": ...}``) — as a sharded
    checkpoint directory; ``load_state_dict`` restores the nesting."""
    state = _flatten_state(state)
    os.makedirs(path, exist_ok=True)
    entries: Dict[str, dict] = {}
    writes = []  # (filename, host ndarray) — device->host done up front

    for name, v in state.items():
        v = _leaf_value(v)
        safe = name.replace("/", "__")
        fname = f"{safe}.shard0.npy"
        if not isinstance(v, StreamedArray):
            # the generator of a StreamedArray runs inside _do_write (not
            # here), so an async_save streams in the writer thread
            v = np.asarray(v)
        writes.append((fname, v))
        entries[name] = {
            "shape": list(v.shape), "dtype": str(v.dtype),
            "shards": [{"file": fname,
                        "slice": [[0, d] for d in v.shape]}],
        }

    def _do_write():
        for fname, arr in writes:
            tmp = os.path.join(path, fname + ".tmp")
            with open(tmp, "wb") as f:
                if isinstance(arr, StreamedArray):
                    _write_npy_streamed(f, arr)
                else:
                    np.save(f, arr)  # handle: np.save(path) appends .npy
            os.replace(tmp, os.path.join(path, fname))
        tmp = os.path.join(path, _INDEX + ".tmp")
        with open(tmp, "w") as f:
            # version 2: python scalars are tagged with _PY_SCALAR;
            # v1 loaders stored them as untagged 0-d arrays
            json.dump({"version": 2, "entries": entries}, f, indent=1)
        os.replace(tmp, os.path.join(path, _INDEX))
        if _on_complete is not None:
            _on_complete()

    if async_save:
        t = threading.Thread(daemon=True, target=_run_capturing, args=(_do_write,))
        t.start()
        _pending.append(t)
        return t
    _do_write()


def _run_capturing(fn):
    try:
        fn()
    except BaseException as e:  # surfaced by wait_until_finished
        _errors.append(e)


_errors: list = []


def wait_until_finished():
    """Join outstanding async saves and re-raise any writer failure
    (orbax AsyncCheckpointer.wait_until_finished / check_for_errors
    parity — a swallowed write error would mean a checkpoint the training
    loop believes exists)."""
    while _pending:
        _pending.pop().join()
    if _errors:
        first, rest = _errors[0], _errors[1:]
        _errors.clear()  # drain: stale errors must not blame later saves
        if rest:
            first.add_note(f"({len(rest)} further async save error(s) "
                           f"were also recorded)")
        raise first


def _read_region(path, entry, region):
    """Assemble the ndarray for ``region`` (tuple of slices in global
    coords) from the saved shards intersecting it."""
    shape = entry["shape"]
    starts = [0 if s.start is None else s.start for s in region]
    stops = [shape[d] if s.stop is None else s.stop
             for d, s in enumerate(region)]
    out = np.empty([b - a for a, b in zip(starts, stops)],
                   dtype=np.dtype(entry["dtype"]))
    covered = 0
    for sh in entry["shards"]:
        lo = [a for a, _ in sh["slice"]]
        hi = [b for _, b in sh["slice"]]
        ilo = [max(a, c) for a, c in zip(lo, starts)]
        ihi = [min(b, d) for b, d in zip(hi, stops)]
        if any(a >= b for a, b in zip(ilo, ihi)):
            continue  # shard does not intersect the requested region
        data = np.load(os.path.join(path, sh["file"]), mmap_mode="r")
        if data.dtype != out.dtype and data.dtype.itemsize == \
                out.dtype.itemsize:
            # np.save stores extension dtypes (bfloat16, fp8) as raw
            # void bytes; reinterpret against the manifest's dtype
            data = data.view(out.dtype)
        src = tuple(slice(a - l, b - l) for a, b, l in zip(ilo, ihi, lo))
        dst = tuple(slice(a - s, b - s) for a, b, s in zip(ilo, ihi, starts))
        out[dst] = data[src]
        covered += int(np.prod([b - a for a, b in zip(ilo, ihi)])) \
            if ilo else 1
    # saved shards tile the array disjointly, so covered volume must equal
    # the region volume — a shortfall means lost/partial shards and
    # np.empty garbage would otherwise become "weights" silently
    want = int(np.prod(out.shape)) if out.ndim else 1
    if covered != want:
        raise IOError(
            f"checkpoint entry covers {covered}/{want} elements of the "
            f"requested region — missing or partially-synced shard files "
            f"under {path}")
    return out


def _entry_name(name) -> str:
    """Accept a nested key as a tuple/list (("opt", "m")) or a flat
    string; callers never spell the internal separator."""
    if isinstance(name, (tuple, list)):
        return _NEST_SEP.join(str(p) for p in name)
    return str(name)


def _load_index(path):
    with open(os.path.join(path, _INDEX)) as f:
        return json.load(f)["entries"]


def entry_meta(path: str, name):
    """``(shape, dtype)`` of one entry, read from the index alone —
    no array bytes touched."""
    e = _load_index(path)[_entry_name(name)]
    return tuple(e["shape"]), np.dtype(e["dtype"])


def load_entry_range(path: str, name, lo: int, hi: int) -> np.ndarray:
    """Read the flat range ``[lo, hi)`` of a 1-D entry without
    materializing the rest (mmap ranged read) — the restore
    half of the streamed-checkpoint contract: peak host bytes for a
    reshard restore stay O(range), not O(array)."""
    entry = _load_index(path)[_entry_name(name)]
    if len(entry["shape"]) != 1:
        raise ValueError(
            f"load_entry_range reads 1-D entries; "
            f"{_entry_name(name)!r} has shape {entry['shape']}")
    return _read_region(path, entry, (slice(int(lo), int(hi)),))


def load_state_dict(path: str,
                    shardings: Optional[Mapping[str, Any]] = None,
                    names=None) -> Dict[str, Any]:
    """Read a checkpoint as host numpy arrays.  ``names`` selects
    entries (a top-level group name selects its whole sub-dict).
    Checkpoints written from nested state dicts come back nested."""
    if shardings is not None:
        raise NotImplementedError(
            "restoring into a device layout (shardings=) is not ported "
            "yet (ROADMAP queue item 4); restore to the host and move "
            "the arrays")
    with open(os.path.join(path, _INDEX)) as f:
        manifest = json.load(f)
    index = manifest["entries"]
    legacy_scalars = manifest.get("version", 1) < 2
    out: Dict[str, Any] = {}
    for name, entry in index.items():
        if names is not None and name not in names and \
                name.split(_NEST_SEP)[0] not in names:
            # nested checkpoints: a top-level group name selects the
            # whole sub-dict (callers never see the internal separator)
            continue
        out[name] = _read_region(
            path, entry, tuple(slice(0, d) for d in entry["shape"]))
    return _unflatten_state(out, legacy_scalars=legacy_scalars)


class CheckpointManager:
    """Step-numbered checkpoint rotation with pinned steps (the
    reference's ``CheckpointManager``)."""

    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = directory
        self.max_to_keep = max_to_keep
        # steps rotation must never delete — e.g. train_guard's
        # last-healthy rewind target (losing it would turn a recoverable
        # loss spike into an unrecoverable NumericalDivergence)
        self._pinned: set = set()
        os.makedirs(directory, exist_ok=True)

    def pin(self, step: int):
        """Exempt ``step`` from max_to_keep rotation."""
        self._pinned.add(int(step))

    def unpin(self, step: int):
        self._pinned.discard(int(step))

    def pinned_steps(self):
        return sorted(self._pinned)

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step}")

    def all_steps(self):
        steps = []
        for d in os.listdir(self.directory):
            if d.startswith("step_") and os.path.exists(
                    os.path.join(self.directory, d, _INDEX)):
                steps.append(int(d.split("_", 1)[1]))
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        s = self.all_steps()
        return s[-1] if s else None

    def save(self, step: int, state: Mapping[str, Any],
             async_save: bool = False):
        # rotation runs after the write lands — for async saves inside the
        # writer thread, otherwise max_to_keep would be ignored there
        save_state_dict(state, self._step_dir(step), async_save=async_save,
                        _on_complete=self._gc)

    def restore(self, step: Optional[int] = None, shardings=None,
                names=None):
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.directory}")
        return load_state_dict(self._step_dir(step), shardings=shardings,
                               names=names)

    def restore_range(self, step: int, name, lo: int, hi: int):
        """Ranged read of one 1-D entry (nested key as a tuple):
        the O(range) restore primitive streamed checkpoints pair with."""
        return load_entry_range(self._step_dir(step), name, lo, hi)

    def entry_meta(self, step: int, name):
        return entry_meta(self._step_dir(step), name)

    def _gc(self):
        import shutil
        # pinned steps neither rotate out NOR consume max_to_keep slots:
        # the newest max_to_keep UNPINNED steps survive alongside them
        steps = [s for s in self.all_steps() if s not in self._pinned]
        for s in steps[:-self.max_to_keep] if self.max_to_keep else []:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)
