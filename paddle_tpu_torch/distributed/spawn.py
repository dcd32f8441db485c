"""``spawn``: start one process per rank (counterpart of
``paddle_tpu/distributed/spawn.py``).

This is the port's design, where the reference runs one controller per
host that drives every local chip: here each rank is a process of its
own (``torch.multiprocessing``, start method ``spawn``), as in Paddle's
collective mode on GPUs and in PyTorch.  Every process gets the
launcher's variables (rank, world, endpoints on a free local port,
``PADDLE_RANK_IN_NODE``, ``PADDLE_LOCAL_SIZE`` and, with cards,
``FLAGS_selected_gpus`` = rank mod the card count), calls
``init_parallel_env(backend, timeout)`` and then ``func(*args)``; its
stdout and stderr go to ``<log_dir>/rank.<r>.log``.

``spawn(..., join=True)`` returns the ranks' return values in rank
order.  Every wait is bounded: ranks that have not all returned within
``join_timeout`` seconds are killed, and a rank that raises or dies ends
the others; either way ``spawn`` raises, with every rank's log tail.
``func`` must be importable by name (a module-level function).
"""
from __future__ import annotations

import os
import queue as _queue
import tempfile
import time
import traceback
from typing import Optional

__all__ = ["spawn", "SpawnError", "SpawnContext"]


class SpawnError(RuntimeError):
    """A rank raised, died or did not finish in time; the message carries
    every rank's log tail."""


def _tail(path, n=30) -> str:
    try:
        with open(path, errors="replace") as f:
            return "".join(f.readlines()[-n:])
    except OSError:
        return "(no log)"


def _worker(rank, world, port, func, args, backend, timeout, log_path,
            results):
    fd = os.open(log_path, os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644)
    os.dup2(fd, 1)
    os.dup2(fd, 2)
    os.close(fd)
    import sys
    sys.stdout = os.fdopen(1, "w", buffering=1, closefd=False)
    sys.stderr = os.fdopen(2, "w", buffering=1, closefd=False)
    os.environ.update({
        "PADDLE_TRAINER_ID": str(rank), "PADDLE_TRAINERS_NUM": str(world),
        "PADDLE_TRAINER_ENDPOINTS": ",".join(
            f"127.0.0.1:{port}" for _ in range(world)),
        "PADDLE_CURRENT_ENDPOINT": f"127.0.0.1:{port}",
        "PADDLE_RANK_IN_NODE": str(rank), "PADDLE_LOCAL_SIZE": str(world)})
    import torch
    if torch.cuda.is_available() and torch.cuda.device_count() > 0:
        os.environ["FLAGS_selected_gpus"] = str(
            rank % torch.cuda.device_count())
    try:
        from .parallel import init_parallel_env
        init_parallel_env(backend=backend, timeout=timeout)
        out = func(*args)
        results.put((rank, True, out))
    except BaseException:
        msg = traceback.format_exc()
        results.put((rank, False, msg))
        raise
    finally:
        import torch.distributed as dist
        if dist.is_available() and dist.is_initialized():
            try:
                dist.destroy_process_group()
            except Exception:
                pass


class SpawnContext:
    """The started ranks: ``processes``, ``log_paths``, :meth:`join` and
    :meth:`close`."""

    def __init__(self, procs, results, log_paths):
        self.processes = procs
        self._results = results
        self.log_paths = log_paths

    def _tails(self) -> str:
        return "\n".join(f"--- rank {r} ({p}) ---\n{_tail(p)}"
                         for r, p in enumerate(self.log_paths))

    def _kill(self):
        for p in self.processes:
            if p.is_alive():
                p.terminate()
        deadline = time.monotonic() + 5.0
        for p in self.processes:
            p.join(max(0.0, deadline - time.monotonic()))
            if p.is_alive():
                p.kill()
                p.join(5.0)

    def close(self):
        """Kill every rank still running."""
        self._kill()

    def join(self, timeout: float):
        """Every rank's return value, in rank order; raises
        :class:`SpawnError` (after killing the rest) when a rank raises,
        dies, or the ranks are not all done within ``timeout`` s."""
        n = len(self.processes)
        out, deadline = {}, time.monotonic() + float(timeout)
        try:
            while len(out) < n:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise SpawnError(
                        f"ranks {sorted(set(range(n)) - set(out))} not done "
                        f"within {timeout:.0f} s; log tails:\n"
                        + self._tails())
                try:
                    rank, ok, val = self._results.get(
                        timeout=min(left, 0.5))
                except _queue.Empty:
                    dead = [r for r, p in enumerate(self.processes)
                            if r not in out and not p.is_alive()
                            and p.exitcode is not None]
                    if dead:
                        try:    # a result may still be in the pipe
                            rank, ok, val = self._results.get(timeout=1.0)
                        except _queue.Empty:
                            raise SpawnError(
                                f"rank {dead[0]} exited with code "
                                f"{self.processes[dead[0]].exitcode} and "
                                "no result; log tails:\n"
                                + self._tails()) from None
                    else:
                        continue
                if not ok:
                    raise SpawnError(f"rank {rank} raised:\n{val}\nlog "
                                     "tails:\n" + self._tails())
                out[rank] = val
            grace = time.monotonic() + min(
                30.0, max(1.0, deadline - time.monotonic()))
            for p in self.processes:        # teardown: a short grace
                p.join(max(0.1, grace - time.monotonic()))
        finally:
            self._kill()
        return [out[r] for r in range(n)]


def spawn(func, args=(), nprocs: int = -1, join: bool = True,
          daemon: bool = False, backend: Optional[str] = None,
          timeout: Optional[float] = None, join_timeout: float = 600.0,
          log_dir: Optional[str] = None, **options):
    """Run ``func(*args)`` in ``nprocs`` rank processes (-1: one per
    card, or 1 without a card) over ``backend`` (``init_parallel_env``'s
    rule when None); ``timeout`` bounds each collective, ``join_timeout``
    the whole run."""
    import torch
    import torch.multiprocessing as mp
    from .parallel import _free_port
    if nprocs in (-1, None):
        nprocs = (torch.cuda.device_count() if torch.cuda.is_available()
                  else 1) or 1
    log_dir = log_dir or tempfile.mkdtemp(prefix="paddle_spawn_")
    os.makedirs(log_dir, exist_ok=True)
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = _free_port()
    logs = [os.path.join(log_dir, f"rank.{r}.log") for r in range(nprocs)]
    procs = []
    for r in range(nprocs):
        p = ctx.Process(target=_worker, daemon=daemon,
                        args=(r, nprocs, port, func, tuple(args), backend,
                              timeout, logs[r], results))
        p.start()
        procs.append(p)
    sc = SpawnContext(procs, results, logs)
    return sc.join(join_timeout) if join else sc
