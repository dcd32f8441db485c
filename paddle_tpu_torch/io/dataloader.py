"""DataLoader (counterpart of ``paddle_tpu/io/dataloader.py``).

Parity: reference python/paddle/fluid/reader.py:149 DataLoader +
fluid/dataloader/dataloader_iter.py (:265 single-process).

Pipeline:
  in-process or thread workers (numpy batches) -> prefetch thread ->
  torch CPU tensors
Batches come out as torch tensors on the CPU, with the JAX package's
narrowing of f64 arrays to f32 and int64 to int32, so the same seed gives
the same batch values as ``paddle_tpu``'s loader.  The caller moves a
batch to the card.  The seeded batch cursor (``state_dict`` /
``load_state_dict``) resumes an interrupted iteration element-wise.

Not ported yet: forked process workers (``use_process=True`` raises
``NotImplementedError`` naming ROADMAP queue item 4).
"""
from __future__ import annotations

import itertools
import queue
import threading
from typing import Any, List

import numpy as np
import torch

from ..framework import monitor as _monitor
from .dataset import Dataset, IterableDataset
from .sampler import BatchSampler

__all__ = ["DataLoader", "default_collate_fn", "get_worker_info"]

_worker_info = threading.local()
# how long closing an iterator waits for its prefetch thread to end
_FEEDER_JOIN_S = 30.0


def get_worker_info():
    return getattr(_worker_info, "info", None)


class WorkerInfo:
    def __init__(self, id, num_workers, dataset):
        self.id = id
        self.num_workers = num_workers
        self.dataset = dataset


def default_collate_fn(batch: List[Any]):
    """Stack samples into batched numpy arrays (device transfer happens in
    the loader, once per batch)."""
    sample = batch[0]
    if isinstance(sample, torch.Tensor):
        return np.stack([s.detach().cpu().numpy() for s in batch])
    if isinstance(sample, np.ndarray):
        return np.stack(batch)
    if isinstance(sample, (int, np.integer)):
        return np.asarray(batch, np.int32)
    if isinstance(sample, (float, np.floating)):
        return np.asarray(batch, np.float32)
    if isinstance(sample, (list, tuple)):
        transposed = list(zip(*batch))
        return type(sample)(default_collate_fn(list(t)) for t in transposed)
    if isinstance(sample, dict):
        return {k: default_collate_fn([d[k] for d in batch]) for k in sample}
    return batch


def _to_tensor(batch):
    """numpy leaves -> torch CPU tensors, f64 narrowed to f32 and int64
    to int32 as the JAX package's loader narrows them."""
    def conv(x):
        if isinstance(x, np.ndarray):
            if x.dtype == np.float64:
                x = x.astype(np.float32)
            if x.dtype == np.int64:
                x = x.astype(np.int32)
            return torch.from_numpy(np.ascontiguousarray(x))
        if isinstance(x, (list, tuple)):
            return type(x)(conv(v) for v in x)
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        return x
    return conv(batch)


class DataLoader:
    def __init__(self, dataset: Dataset, feed_list=None, places=None,
                 return_list=True, batch_sampler=None, batch_size=1,
                 shuffle=False, drop_last=False, collate_fn=None,
                 num_workers=0, use_buffer_reader=True, prefetch_factor=2,
                 use_shared_memory=True, timeout=0, worker_init_fn=None,
                 persistent_workers=False, use_process=False,
                 mp_start_method="fork", seed=None):
        self.dataset = dataset
        # batch-cursor resume: ``seed`` makes every epoch's
        # shuffle permutation a pure function of (seed, epoch) so
        # ``state_dict()/load_state_dict()`` can resume mid-epoch
        # bit-exactly.  None keeps the legacy global-RNG behaviour
        # (and state_dict() on a shuffling loader then raises).
        self.seed = seed
        self._pos_epoch = 0   # epoch the live/next iteration runs
        self._pos_batch = 0   # batches already yielded within it
        self._resume = None   # (epoch, batch) pending from load_state_dict
        self.collate_fn = collate_fn or default_collate_fn
        self.num_workers = num_workers
        self.prefetch_factor = max(prefetch_factor, 2)
        self.worker_init_fn = worker_init_fn
        self.places = places
        self.timeout = timeout
        # use_process=True (forked OS workers, the reference's default
        # multi-process mode) is not ported yet; threads serve
        # numpy-bound collate, which releases the GIL.
        if use_process and num_workers > 0:
            raise NotImplementedError(
                "DataLoader process workers (use_process=True) are not "
                "ported yet (ROADMAP queue item 4); use thread workers")
        self._iterable_mode = isinstance(dataset, IterableDataset)
        if self._iterable_mode:
            self.batch_size = batch_size
            self.batch_sampler = None
            self.drop_last = drop_last
        elif batch_sampler is not None:
            self.batch_sampler = batch_sampler
        else:
            if batch_size is None:
                raise ValueError("batch_size or batch_sampler required")
            self.batch_sampler = BatchSampler(dataset, shuffle=shuffle,
                                              batch_size=batch_size,
                                              drop_last=drop_last)

    def __len__(self):
        if self._iterable_mode:
            raise TypeError("IterableDataset has no len()")
        return len(self.batch_sampler)

    # -- exact batch-cursor resume --------------------------------------
    def state_dict(self) -> dict:
        """The loader's exact batch cursor: ``{"epoch", "batch",
        "seed"}`` where ``batch`` counts batches already YIELDED to the
        consumer this epoch (prefetched-but-undelivered batches do not
        count).  Feeding it to :meth:`load_state_dict` on a freshly
        constructed identical loader resumes the stream element-wise —
        no sample skipped, none double-seen.  A shuffling loader must
        be constructed with ``seed=`` (or a seeded sampler): a
        global-RNG permutation cannot be reproduced on resume."""
        if self.seed is None and not self._iterable_mode:
            from .sampler import RandomSampler
            s = getattr(self.batch_sampler, "sampler", None)
            if isinstance(s, RandomSampler) and s.generator is None:
                raise ValueError(
                    "state_dict() on a shuffling DataLoader requires "
                    "seed=... (an unseeded global-RNG epoch permutation "
                    "cannot be reproduced when resuming)")
        return {"epoch": int(self._pos_epoch),
                "batch": int(self._pos_batch), "seed": self.seed}

    def load_state_dict(self, state: dict):
        """Arm the cursor: the NEXT ``iter()`` resumes at
        ``state["epoch"]`` with ``state["batch"]`` batches skipped.
        Map-style loaders fast-forward at the sampler-index level (the
        dataset is never touched for skipped batches); iterable-style
        loaders consume and discard the skipped batches' raw items."""
        if state.get("seed") is not None and self.seed is not None \
                and state["seed"] != self.seed:
            raise ValueError(
                f"checkpoint cursor was taken under seed="
                f"{state['seed']!r} but this loader has seed="
                f"{self.seed!r}; the shuffle streams would diverge")
        self._resume = (int(state["epoch"]), int(state["batch"]))
        self._pos_epoch, self._pos_batch = self._resume

    def _setup_epoch(self, epoch: int):
        """Per-epoch RNG derivation (only when ``seed`` is set, so
        legacy loaders keep their exact global-RNG behaviour):
        epoch-aware samplers get ``set_epoch``; an internally created
        RandomSampler draws from ``default_rng([seed, epoch])`` — the
        permutation is a pure function of (seed, epoch)."""
        if self.seed is None or self._iterable_mode:
            return
        bs = self.batch_sampler
        if hasattr(bs, "set_epoch"):
            bs.set_epoch(epoch)
        from .sampler import RandomSampler
        s = getattr(bs, "sampler", None)
        if isinstance(s, RandomSampler):
            s.generator = np.random.default_rng(
                [int(self.seed) & 0xFFFFFFFF, int(epoch)])

    # ------------------------------------------------------------------
    def _iter_batches_sync(self, sampler_iter=None, skip=0):
        if self._iterable_mode:
            it = iter(self.dataset)
            if skip:
                # cursor resume: an arbitrary iterable cannot be
                # fast-forwarded — consume the skipped batches' raw
                # items (only full batches can precede the cursor, so
                # skip * batch_size is exact)
                for _ in itertools.islice(it, skip * self.batch_size):
                    pass
            while True:
                chunk = list(itertools.islice(it, self.batch_size))
                if not chunk:
                    return
                if len(chunk) < self.batch_size and self.drop_last:
                    return
                yield self.collate_fn(chunk)
        else:
            for idxs in sampler_iter:
                yield self.collate_fn([self.dataset[i] for i in idxs])

    def _iter_batches_workers(self, sampler_iter):
        """Thread-pool workers.

        The reference forks OS processes and ships batches through shared
        memory because CPython + its C++ core hold the GIL during decode;
        here batch assembly is numpy-bound (releases the GIL), so threads
        deliver the same overlap without process startup / serialization.
        """
        from concurrent.futures import ThreadPoolExecutor

        wid_counter = itertools.count()

        def init_worker():
            wid = next(wid_counter)
            _worker_info.info = WorkerInfo(wid, self.num_workers,
                                           self.dataset)
            if self.worker_init_fn is not None:
                self.worker_init_fn(wid)

        pool = ThreadPoolExecutor(max_workers=self.num_workers,
                                  initializer=init_worker)
        try:
            def make(idxs):
                return self.collate_fn([self.dataset[i] for i in idxs])

            pending = []
            it = sampler_iter
            depth = self.num_workers * self.prefetch_factor
            for idxs in itertools.islice(it, depth):
                pending.append(pool.submit(make, idxs))
            while pending:
                fut = pending.pop(0)
                nxt = next(it, None)
                if nxt is not None:
                    pending.append(pool.submit(make, nxt))
                yield fut.result()
        finally:
            pool.shutdown(wait=False, cancel_futures=True)

    def __iter__(self):
        # batch cursor: a pending load_state_dict resumes at its
        # (epoch, batch); otherwise continue from the live position
        # (a fresh pass of epoch N, or epoch N+1 after exhaustion)
        resume = self._resume
        self._resume = None
        epoch = resume[0] if resume else self._pos_epoch
        skip = resume[1] if resume else 0
        self._pos_epoch, self._pos_batch = epoch, skip
        self._setup_epoch(epoch)
        if not self._iterable_mode:
            sampler_iter = iter(self.batch_sampler)
            if skip:
                # fast-forward at the index level: skipped batches cost
                # sampler draws only, never a dataset __getitem__
                for _ in itertools.islice(sampler_iter, skip):
                    pass
            if self.num_workers > 0:
                gen = self._iter_batches_workers(sampler_iter)
            else:
                gen = self._iter_batches_sync(sampler_iter=sampler_iter)
        else:
            gen = self._iter_batches_sync(skip=skip)

        # prefetch pipeline (double buffering). The feeder checks
        # ``abandoned`` around every blocking put so an early `break` in the
        # consumer releases the thread (and closes the worker pool) instead
        # of leaking it; closing the iterator then waits for the feeder to
        # end (a daemon thread still inside torch when the interpreter
        # exits aborts the process: "terminate called without an active
        # exception").
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch_factor)
        stop = object()
        abandoned = threading.Event()

        def feeder():
            try:
                for b in gen:
                    item = _to_tensor(b)
                    while not abandoned.is_set():
                        try:
                            q.put(item, timeout=0.1)
                            break
                        except queue.Full:
                            continue
                    if abandoned.is_set():
                        gen.close()
                        return
            except Exception as e:
                if not abandoned.is_set():
                    q.put(e)
            while not abandoned.is_set():
                try:
                    q.put(stop, timeout=0.1)
                    return
                except queue.Full:
                    continue

        t = threading.Thread(target=feeder, daemon=True)
        t.start()
        try:
            import time as _time
            while True:
                if _monitor.metrics_enabled():
                    # data-wait: how long the consumer blocks on the
                    # prefetch queue — nonzero p50 here means the input
                    # pipeline, not the device, bounds the step
                    _monitor.gauge_set("dataloader_queue_depth",
                                       q.qsize())
                    t0 = _time.perf_counter()
                    item = q.get()
                    _monitor.hist_observe(
                        "dataloader_wait_ms",
                        (_time.perf_counter() - t0) * 1e3)
                else:
                    item = q.get()
                if item is stop:
                    # clean exhaustion: the cursor rolls to the next
                    # epoch (an abandoned iterator keeps its position)
                    self._pos_epoch += 1
                    self._pos_batch = 0
                    break
                if isinstance(item, Exception):
                    raise item
                self._pos_batch += 1
                yield item
        finally:
            abandoned.set()
            # drain so a blocked put wakes immediately
            try:
                while True:
                    q.get_nowait()
            except queue.Empty:
                pass
            # the feeder ends after the batch it is making; bounded, for a
            # dataset whose next item never comes
            t.join(timeout=_FEEDER_JOIN_S)

    # reference-compat constructors
    @staticmethod
    def from_generator(feed_list=None, capacity=None, use_double_buffer=True,
                       iterable=True, return_list=False,
                       use_multiprocess=False, drop_last=True):
        raise NotImplementedError(
            "from_generator is the legacy fluid reader API; wrap your "
            "generator in an IterableDataset instead")

    @staticmethod
    def from_dataset(dataset, places=None, drop_last=True):
        return DataLoader(dataset, places=places, drop_last=drop_last)
