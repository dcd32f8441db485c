"""Streaming trainer: the unbounded-event-feed half of the online loop
(counterpart of ``paddle_tpu/online/streaming.py``).

The trainer consumes an endless stream of events through the iterable
:class:`~paddle_tpu_torch.io.DataLoader` path and pushes sparse gradient
updates to the PS primary while read replicas serve the same tables.

Exactly-once across kill and resume, with no coordination:

- the DataLoader cursor counts batches yielded; the trainer checkpoints
  it (write-then-rename) every ``ckpt_every`` batches, so a restarted
  trainer resumes the stream element-exact;
- the push idempotency stamp is a pure function of the cursor: ``seq ==
  global batch index`` under a fixed ``src``
  (:meth:`PSClient.push_stamped`).  A batch replayed after a crash
  re-sends the same ``(src, seq)`` and the server acks it as a duplicate
  without applying it again.  The server's dedup window (4096 seqs)
  bounds how far the cursor checkpoint may lag: keep ``ckpt_every`` well
  under it.

Freshness: every event batch carries its ingest timestamp (from the
source, or the dequeue time); the push stamps it as the mutation's
``iwm`` watermark, and replicas applying the record observe
event-ingested -> servable latency into the ``ps_freshness_ms``
histogram.

Client-side pre-merge: duplicate ids inside a batch are summed before
the RPC (the table would do the same; this ships fewer rows).  With
``device_merge=True`` a batch of at least 4,096 rows merges on the card
through :func:`~paddle_tpu_torch.ops.kernels.segment_sum.merge_segments`
(kernel 7 below 4,096 unique ids, the sorted kernel 8 at or above);
smaller host batches merge in numpy.  A ``step_fn`` may return its
gradients as a CUDA tensor: they are merged where they are, at any batch
size, and copied to the host once, for the RPC.
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import Callable, Optional

import numpy as np
import torch

from .. import resolve_device
from ..framework import monitor as _monitor
from ..observability import flight_recorder as _flight

__all__ = ["StreamingTrainer"]

# below this many rows a device dispatch costs more than the merge
_DEVICE_MERGE_MIN_ROWS = 4096


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).cpu().numpy()
    return np.asarray(x, np.float32)


class StreamingTrainer:
    """Consume an unbounded event feed and push sparse updates.

    ``loader``: an iterable-dataset DataLoader over the event stream;
    each batch is passed to ``step_fn``.

    ``step_fn(batch, pull) -> (ids, grads)``: the training step.  It may
    call ``pull(ids)`` to fetch current rows from the primary and returns
    the sparse ids and their gradients (numpy, or a torch tensor on the
    CPU or the card).

    ``client``: a sync-mode :class:`PSClient` at the primary group;
    ``table``: the sparse table's name.

    ``ingest_ts_fn(batch) -> float | None``: the batch's event ingest
    timestamp (default: the max of ``batch["ingest_ts"]`` when the batch
    is a dict carrying one, else the dequeue time).

    ``src``: the stable idempotency source id; two incarnations of one
    logical trainer must share it.  Defaults to ``stream-<table>``.

    ``state_path``: where the cursor checkpoint lives (None: no
    checkpoint; a restart replays from the stream head).

    ``dense_step(batch)``: the dense half of the model, called once per
    consumed batch after the sparse push.  At-least-once across a kill
    and resume: dense updates carry no idempotency stamp.

    ``device_merge`` / ``device``: merge host batches of at least
    4,096 rows on ``device`` (default ``cuda``; asking for it without a
    card raises), and CUDA gradients on their own card at any size.
    ``kernel_mode``: ``None`` routes the merge by the tensors' device,
    ``"torch_ref"`` runs the kernels' plain versions (for comparison).
    """

    def __init__(self, loader, client, table: str,
                 step_fn: Callable,
                 src: Optional[str] = None,
                 state_path: Optional[str] = None,
                 ckpt_every: int = 64,
                 ingest_ts_fn: Optional[Callable] = None,
                 merge_duplicates: bool = True,
                 device_merge: bool = False,
                 dense_step: Optional[Callable] = None,
                 device=None, kernel_mode: Optional[str] = None):
        self._loader = loader
        self._client = client
        self._table = str(table)
        self._step_fn = step_fn
        self.src = src or f"stream-{table}"
        self._state_path = state_path
        self._ckpt_every = max(int(ckpt_every), 1)
        self._ingest_ts_fn = ingest_ts_fn
        self._merge = bool(merge_duplicates)
        if kernel_mode not in (None, "torch_ref"):
            raise ValueError(f"kernel_mode must be None or 'torch_ref', got "
                             f"{kernel_mode!r}")
        self._device_merge = bool(device_merge)
        self.device = resolve_device(device) if self._device_merge else None
        self._kernel_mode = kernel_mode
        self._dense_step = dense_step
        self.dense_steps = 0     # dense steps this process
        self._stop_evt = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        # global batch index == the push idempotency seq (+1: server
        # seqs start at 1), restored from the cursor checkpoint
        self.events = 0          # events (rows) consumed this process
        self.batches = 0         # batches pushed this process
        self.seq = 0             # global batch cursor (all incarnations)
        self.dup_acks = 0        # replayed batches acked as duplicates
        if state_path is not None and os.path.exists(state_path):
            self._restore(state_path)

    # -- cursor checkpoint ----------------------------------------------
    def _restore(self, path: str):
        with open(path) as f:
            st = json.load(f)
        self._loader.load_state_dict(st["loader"])
        self.seq = int(st["seq"])

    def _checkpoint(self):
        if self._state_path is None:
            return
        st = {"loader": self._loader.state_dict(),
              "seq": int(self.seq), "src": self.src}
        tmp = f"{self._state_path}.{os.getpid()}.tmp"
        with open(tmp, "w") as f:
            f.write(json.dumps(st))
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self._state_path)

    # -- the loop ---------------------------------------------------------
    def run(self, max_batches: Optional[int] = None):
        """Consume the stream (forever, or ``max_batches``).  Re-raises
        the first error."""
        pull = lambda ids: self._client.pull(self._table, ids)  # noqa: E731
        for batch in self._loader:
            if self._stop_evt.is_set():
                return
            t0 = time.perf_counter()
            iwm = self._ingest_ts(batch)
            ids, grads = self._step_fn(batch, pull)
            ids = np.ascontiguousarray(
                np.asarray(ids).reshape(-1), np.int64)
            if isinstance(grads, torch.Tensor):
                grads = grads.detach().to(torch.float32).reshape(
                    ids.size, -1)
            else:
                grads = np.asarray(grads, np.float32).reshape(ids.size, -1)
            n_events = int(ids.size)
            if self._merge and ids.size:
                ids, grads = self._merge_batch(ids, grads)
            grads = np.ascontiguousarray(_host(grads))
            self.seq += 1
            applied = self._client.push_stamped(
                self._table, ids, grads, seq=self.seq, src=self.src,
                wm=iwm)
            if not applied:
                # a replayed batch (cursor behind the last pre-crash
                # push): acked without being applied again
                self.dup_acks += 1
                _monitor.stat_add("online_replayed_batches")
            if self._dense_step is not None:
                self._dense_step(batch)
                self.dense_steps += 1
                _monitor.stat_add("online_dense_steps")
            self.batches += 1
            self.events += n_events
            _monitor.stat_add("online_events", n_events)
            _monitor.stat_add("online_batches")
            if _monitor.metrics_enabled():
                _monitor.hist_observe(
                    "online_step_ms", (time.perf_counter() - t0) * 1e3)
                if iwm is not None:
                    _monitor.hist_observe(
                        "online_ingest_to_push_ms",
                        max((time.time() - iwm) * 1e3, 0.0))
            # stall-watchdog progress: a wedged feed or push shows up as
            # this kind going silent
            _flight.record("online.ingest", seq=int(self.seq),
                           n=int(ids.size), dup=not applied, iwm=iwm)
            if self.seq % self._ckpt_every == 0:
                self._checkpoint()
            if max_batches is not None and self.batches >= max_batches:
                self._checkpoint()
                return
        # a finite feed ran dry: persist the final cursor
        self._checkpoint()

    def _ingest_ts(self, batch) -> Optional[float]:
        if self._ingest_ts_fn is not None:
            v = self._ingest_ts_fn(batch)
            return None if v is None else float(v)
        if isinstance(batch, dict) and "ingest_ts" in batch:
            a = np.asarray(batch["ingest_ts"])
            if a.dtype == np.float32 and float(np.max(np.abs(a))) > 2**24:
                # an f32 epoch-second stamp has lost its sub-second
                # precision (the loader narrows float64 arrays; carry the
                # stamp as a python float): use the dequeue time instead
                return time.time()
            return float(np.max(a))
        return time.time()

    def _merge_batch(self, ids: np.ndarray, grads):
        """Sum duplicate ids' gradients (the table's own merge: push
        applies the optimizer once per unique id either way).  Returns
        ``(unique ids, sums)``, the sums on the merge's device."""
        uniq, inverse = np.unique(ids, return_inverse=True)
        if uniq.size == ids.size:
            return ids, grads
        on_card = isinstance(grads, torch.Tensor) and grads.is_cuda
        # the row threshold only spares host gradients a copy to the
        # card: gradients already there merge there at any size
        if self._device_merge and (
                on_card or ids.size >= _DEVICE_MERGE_MIN_ROWS):
            from ..ops.kernels.segment_sum import merge_segments
            g = grads if on_card else torch.as_tensor(grads).to(self.device)
            return uniq, merge_segments(g, inverse, int(uniq.size),
                                        mode=self._kernel_mode)
        sums = np.zeros((uniq.size, grads.shape[1]), np.float32)
        np.add.at(sums, inverse, _host(grads))
        return uniq, sums

    # -- background lifecycle ------------------------------------------
    def start(self, max_batches: Optional[int] = None
              ) -> "StreamingTrainer":
        def _run():
            try:
                self.run(max_batches=max_batches)
            except BaseException as e:   # surfaced by stop()/join()
                self._error = e
        self._thread = threading.Thread(target=_run,
                                        name="online-trainer",
                                        daemon=True)
        self._thread.start()
        return self

    def join(self, timeout: Optional[float] = None):
        if self._thread is not None:
            self._thread.join(timeout=timeout)
            if self._thread.is_alive():
                raise TimeoutError("streaming trainer did not finish")
        if self._error is not None:
            raise self._error

    def stop(self, timeout: float = 30.0):
        self._stop_evt.set()
        if self._thread is not None:
            self._thread.join(timeout=timeout)
        if self._error is not None:
            raise self._error
