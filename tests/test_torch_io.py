"""The port's data loader cursor and checkpoint format against the JAX
package's.

- ``paddle_tpu_torch.io.DataLoader`` yields the same batch values as
  ``paddle_tpu.io.DataLoader`` for the same dataset and seed (f64 narrowed
  to f32, int64 to int32, as the reference narrows them), and its seeded
  cursor (``state_dict`` / ``load_state_dict``) resumes an interrupted
  iteration element-wise: the in-process cases of
  ``tests/test_dataloader_cursor.py``, run against the port.
- ``paddle_tpu_torch.distributed.checkpoint`` writes files and an index
  byte-identical to ``paddle_tpu``'s for the same state, and each
  package restores the other's directory, ranged reads included.
"""
import os
import threading
import time

import numpy as np
import pytest
import torch

from paddle_tpu.distributed import checkpoint as jckpt
from paddle_tpu.io.dataloader import DataLoader as JDataLoader

from paddle_tpu_torch.distributed import checkpoint as ckpt
from paddle_tpu_torch.io import DataLoader, Dataset, IterableDataset


class Idx(Dataset):
    def __init__(self, n=23):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return np.asarray([i, i * 10], np.float32)


class Stream(IterableDataset):
    def __init__(self, n=20):
        self.n = n

    def __iter__(self):
        for i in range(self.n):
            yield np.asarray([i], np.float32)


class Mixed(Dataset):
    """Samples whose leaves the loaders narrow: f64 rows, int64 labels,
    python floats."""

    def __init__(self, n=30):
        rng = np.random.default_rng(3)
        self.x = rng.standard_normal((n, 3))
        self.y = rng.integers(0, 9, n)

    def __len__(self):
        return len(self.x)

    def __getitem__(self, i):
        return self.x[i], self.y[i], float(i) / 3.0


def _collect(loader, k=None):
    out = []
    it = iter(loader)
    for b in it:
        assert isinstance(b, torch.Tensor) and b.device.type == "cpu"
        out.append(b.numpy())
        if k is not None and len(out) == k:
            break
    return out


def _ml(**kw):
    kw.setdefault("batch_size", 4)
    kw.setdefault("drop_last", True)
    return DataLoader(Idx(), **kw)


@pytest.mark.parametrize("num_workers", [0, 2])
def test_same_batches_as_jax_loader_for_the_same_seed(num_workers):
    mk = dict(batch_size=4, shuffle=True, seed=11, drop_last=True,
              num_workers=num_workers)
    ours, theirs = DataLoader(Mixed(), **mk), JDataLoader(Mixed(), **mk)
    for _ in range(2):                         # two epochs
        got, want = list(ours), list(theirs)
        assert len(got) == len(want) == 7
        for a, b in zip(got, want):
            for x, y in zip(a, b):
                y = np.asarray(y._value)
                assert x.numpy().dtype == y.dtype
                assert np.array_equal(x.numpy(), y)
    assert got[0][0].dtype == torch.float32      # f64 narrowed
    assert got[0][1].dtype == torch.int32        # int64 narrowed
    assert ours.state_dict() == theirs.state_dict()


@pytest.mark.parametrize("num_workers", [0, 2])
def test_cursor_resume_matches_uninterrupted(num_workers):
    """Interrupt after k batches, resume on a FRESH loader: the
    concatenated stream equals the uninterrupted run element-wise,
    through the end of the epoch AND the following epoch."""
    mk = lambda: _ml(shuffle=True, seed=41, num_workers=num_workers)
    ref = mk()
    full = _collect(ref) + _collect(ref)        # two epochs
    run = mk()
    head = _collect(run, k=3)
    cursor = run.state_dict()
    assert cursor == {"epoch": 0, "batch": 3, "seed": 41}
    resumed = mk()
    resumed.load_state_dict(cursor)
    tail = _collect(resumed) + _collect(resumed)
    got = head + tail
    assert len(got) == len(full)
    for a, b in zip(got, full):
        assert np.array_equal(a, b)


def test_cursor_resume_mid_second_epoch_and_across_packages():
    """Resume 2 batches into epoch 1, on the port's loader and on the
    JAX one from the port's cursor: both continue the same stream."""
    mk = lambda: _ml(shuffle=True, seed=9)
    ref = mk()
    full = _collect(ref) + _collect(ref)
    n_epoch = len(_collect(mk()))
    run = mk()
    _collect(run)                        # epoch 0 done
    _collect(run, k=2)                   # 2 batches into epoch 1
    cur = run.state_dict()
    assert cur["epoch"] == 1 and cur["batch"] == 2
    resumed = mk()
    resumed.load_state_dict(cur)
    tail = _collect(resumed)
    got = full[:n_epoch + 2] + tail
    for a, b in zip(got, full):
        assert np.array_equal(a, b)
    jres = JDataLoader(Idx(), batch_size=4, drop_last=True, shuffle=True,
                       seed=9)
    jres.load_state_dict(cur)
    jtail = [np.asarray(b._value) for b in jres]
    assert len(jtail) == len(tail)
    for a, b in zip(jtail, tail):
        assert np.array_equal(a, b)


def test_epoch_permutations_differ_but_reproduce():
    a = _ml(shuffle=True, seed=5)
    e0, e1 = _collect(a), _collect(a)
    assert not all(np.array_equal(x, y) for x, y in zip(e0, e1)), \
        "per-epoch permutations must differ"
    b = _ml(shuffle=True, seed=5)
    f0, f1 = _collect(b), _collect(b)
    for x, y in zip(e0 + e1, f0 + f1):
        assert np.array_equal(x, y)


def test_state_dict_without_seed_on_shuffle_raises():
    loader = _ml(shuffle=True)
    with pytest.raises(ValueError, match="seed"):
        loader.state_dict()
    loader = _ml(shuffle=False)
    head = _collect(loader, k=2)
    cur = loader.state_dict()
    resumed = _ml(shuffle=False)
    resumed.load_state_dict(cur)
    ref = _collect(_ml(shuffle=False))
    got = head + _collect(resumed)
    for a, b in zip(got, ref):
        assert np.array_equal(a, b)


def test_load_state_dict_seed_mismatch_raises():
    loader = _ml(shuffle=True, seed=1)
    with pytest.raises(ValueError, match="seed"):
        loader.load_state_dict({"epoch": 0, "batch": 1, "seed": 2})


def test_iterable_dataset_cursor_resume():
    mk = lambda: DataLoader(Stream(), batch_size=3, drop_last=True)
    ref = mk()
    full = _collect(ref)
    run = mk()
    head = _collect(run, k=2)
    cur = run.state_dict()
    assert cur["batch"] == 2
    resumed = mk()
    resumed.load_state_dict(cur)
    got = head + _collect(resumed)
    assert len(got) == len(full)
    for a, b in zip(got, full):
        assert np.array_equal(a, b)


class Unbounded(IterableDataset):
    def __iter__(self):
        i = 0
        while True:
            yield np.asarray([i], np.float32)
            i += 1


def test_unbounded_stream_kill_resume_no_dup_no_drop():
    mk = lambda: DataLoader(Unbounded(), batch_size=3, drop_last=True)
    got = []
    cur = None
    for k in (4, 7, 5):          # three incarnations, killed mid-flight
        loader = mk()
        if cur is not None:
            loader.load_state_dict(cur)
        it = iter(loader)
        for _ in range(k):
            got.append(next(it).numpy())
        it.close()               # the kill: iterator abandoned
        cur = loader.state_dict()
        assert cur["epoch"] == 0 and cur["batch"] == len(got)
    stream = np.concatenate([b.reshape(-1) for b in got])
    assert np.array_equal(stream, np.arange(len(stream), dtype=np.float32))


def test_unbounded_stream_resume_replays_nothing_under_prefetch():
    mk = lambda: DataLoader(Unbounded(), batch_size=2, drop_last=True,
                            prefetch_factor=4)
    loader = mk()
    it = iter(loader)
    for _ in range(5):
        next(it)
    it.close()
    cur = loader.state_dict()
    assert cur["batch"] == 5     # prefetched-undelivered don't count
    resumed = mk()
    resumed.load_state_dict(cur)
    it2 = iter(resumed)
    assert np.array_equal(next(it2).numpy().reshape(-1),
                          np.asarray([10.0, 11.0], np.float32))
    it2.close()


class _SlowUnbounded(IterableDataset):
    """An endless feed whose items take a while to make, so the prefetch
    thread is mid-item when its consumer stops."""

    def __iter__(self):
        i = 0
        while True:
            time.sleep(0.05)
            yield np.asarray([i], np.float32)
            i += 1


def test_closing_an_iterator_ends_its_prefetch_thread():
    """Closing the iterator (a `break` or `return` out of the loop) waits
    for the prefetch thread: a daemon thread left inside torch when the
    interpreter exits aborts the process."""
    before = set(threading.enumerate())
    loader = DataLoader(_SlowUnbounded(), batch_size=1)
    for i, _ in enumerate(loader):
        if i == 2:
            break
    # no thread the loop started is left (threads of earlier tests may
    # end meanwhile: they are not this loader's)
    assert not set(threading.enumerate()) - before


def test_legacy_unseeded_behaviour_untouched():
    np.random.seed(123)
    e0 = _collect(_ml(shuffle=True))
    np.random.seed(123)
    f0 = _collect(_ml(shuffle=True))
    for x, y in zip(e0, f0):
        assert np.array_equal(x, y)


def test_process_workers_raise_naming_the_roadmap_item():
    with pytest.raises(NotImplementedError, match="ROADMAP queue item 4"):
        DataLoader(Idx(), batch_size=4, num_workers=2, use_process=True)


# ---------------------------------------------------------------------
# the checkpoint format
# ---------------------------------------------------------------------

def _state(seed=0, n=37):
    rng = np.random.default_rng(seed)
    return {"model": {"flat": rng.standard_normal(n).astype(np.float32),
                      "0.weight": rng.standard_normal((3, 4)).astype(
                          np.float32)},
            "opt": {"m": rng.standard_normal(n).astype(np.float32),
                    "v": np.abs(rng.standard_normal(n)).astype(np.float32)},
            "meta": {"step": 12, "opt_t": 12, "epoch": 1, "batch": 3,
                     "lr": 0.5},
            "empty": {},
            "ids": np.arange(5, dtype=np.int64)}


def _dir_bytes(d):
    return {f: open(os.path.join(d, f), "rb").read()
            for f in sorted(os.listdir(d))}


def _assert_state_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], dict):
            _assert_state_equal(a[k], b[k])
        elif isinstance(a[k], np.ndarray):
            assert a[k].dtype == np.asarray(b[k]).dtype
            assert np.array_equal(a[k], b[k])
        else:
            assert type(a[k]) is type(b[k]) and a[k] == b[k]


def test_checkpoint_files_and_index_byte_identical(tmp_path):
    st = _state()
    ckpt.save_state_dict(st, str(tmp_path / "port"))
    jckpt.save_state_dict(st, str(tmp_path / "jax"))
    got, want = _dir_bytes(tmp_path / "port"), _dir_bytes(tmp_path / "jax")
    assert sorted(got) == sorted(want)
    assert "checkpoint.index.json" in got
    for f in want:
        assert got[f] == want[f], f
    # a torch tensor leaf writes the bytes of its numpy value
    tst = dict(st, model={k: torch.from_numpy(v)
                          for k, v in st["model"].items()})
    ckpt.save_state_dict(tst, str(tmp_path / "tensors"))
    assert _dir_bytes(tmp_path / "tensors") == want


def test_each_package_restores_the_others_checkpoint(tmp_path):
    st = _state(1)
    ckpt.save_state_dict(st, str(tmp_path / "port"))
    jckpt.save_state_dict(st, str(tmp_path / "jax"))
    _assert_state_equal(jckpt.load_state_dict(str(tmp_path / "port")), st)
    _assert_state_equal(ckpt.load_state_dict(str(tmp_path / "jax")), st)
    only = ckpt.load_state_dict(str(tmp_path / "jax"), names=["meta"])
    assert only == {"meta": st["meta"]}
    with pytest.raises(NotImplementedError, match="ROADMAP queue item 4"):
        ckpt.load_state_dict(str(tmp_path / "jax"), shardings={})


def test_streamed_save_is_the_plain_save_and_ranges_cross_restore(
        tmp_path):
    """A StreamedArray written chunk by chunk is byte-identical to the
    plain array; CheckpointManager.restore_range reads any [lo, hi) of
    the other package's directory."""
    st = _state(2, n=101)
    flat = st["model"]["flat"]
    chunks = lambda: (flat[a:b] for a, b in ((0, 40), (40, 41), (41, 101)))
    streamed = dict(st, model=dict(st["model"], flat=ckpt.StreamedArray(
        (101,), np.float32, chunks)))
    mgr = ckpt.CheckpointManager(str(tmp_path / "port"), max_to_keep=1)
    jmgr = jckpt.CheckpointManager(str(tmp_path / "jax"), max_to_keep=1)
    mgr.save(4, streamed)
    jmgr.save(4, st)
    assert _dir_bytes(tmp_path / "port" / "step_4") == \
        _dir_bytes(tmp_path / "jax" / "step_4")
    for lo, hi in ((0, 101), (17, 18), (40, 90), (100, 101)):
        for m, other in ((mgr, jmgr), (jmgr, mgr)):
            got = m.restore_range(4, ("model", "flat"), lo, hi)
            want = other.restore_range(4, ("model", "flat"), lo, hi)
            assert np.array_equal(got, flat[lo:hi])
            assert np.array_equal(got, want)
    assert mgr.entry_meta(4, ("opt", "m")) == ((101,), np.dtype("float32"))
    # pins survive rotation, unpinned steps rotate out (max_to_keep=1)
    mgr.pin(4)
    mgr.save(6, st)
    mgr.save(8, st)
    assert mgr.all_steps() == [4, 8] and mgr.pinned_steps() == [4]
    mgr.unpin(4)
    mgr.save(10, st)
    assert mgr.all_steps() == [10]
    _assert_state_equal(jmgr.restore(4), st)
    _assert_state_equal(jckpt.CheckpointManager(
        str(tmp_path / "port")).restore(), st)
