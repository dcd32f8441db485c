"""Cross-process tracing: spans, trace-id propagation, JSONL sinks
(counterpart of ``paddle_tpu/observability/trace.py``, the same code).

- a :class:`Span` is a named ``[start, end)`` interval carrying a
  ``trace_id`` (one per causal chain, minted at the root span) and a
  ``span_id``/``parent_id`` pair; spans nest through a thread-local
  stack, so ``with span("a"): with span("b"): ...`` parents b under a;
- :func:`propagation_ctx` / the ``ctx=`` argument let a context cross a
  process boundary: the PS client stamps ``(trace_id, span_id)`` into
  the RPC frame header and the server opens its handler span with that
  parent, so the merged trace shows the client's ``ps.client.push``
  span containing the server's ``ps.server.push`` apply span;
- every process appends records to its own JSONL sink file
  (``<dir>/trace-<role>-<pid>.jsonl``), with no cross-process locking;
- clock correction: span timestamps are wall-clock microseconds
  (``time.time_ns``), and :func:`record_clock` persists peer clock
  offsets measured over RPC round trips (the PS register handshake) so
  a merger can shift every sink onto one timeline.

Everything is off by default.  ``PADDLE_TRACE=1`` (or :func:`enable`)
turns it on; when off, :func:`span` returns a shared no-op object and
the only cost at an instrumentation site is one attribute check.

Env knobs::

    PADDLE_TRACE=1            enable tracing
    PADDLE_TRACE_DIR=path     sink directory   (default ./paddle_trace)
    PADDLE_TRACE_ROLE=name    role tag in the sink file name + records
                              (default "proc"; e.g. trainer / ps / serve)
    PADDLE_TRACE_EVERY=N      step-timeline sampling period

Standard library only.
"""
from __future__ import annotations

import itertools
import json
import os
import threading
import time
from typing import Dict, List, Optional, Tuple

__all__ = ["Span", "span", "server_span", "enable", "disable", "enabled",
           "current_ctx", "propagation_ctx", "record_clock", "sink_id",
           "sink_path", "trace_every", "flush", "new_id", "emit_span"]

_lock = threading.Lock()
_tls = threading.local()

_enabled = os.environ.get("PADDLE_TRACE", "0") == "1"
_dir = os.environ.get("PADDLE_TRACE_DIR", "paddle_trace")
_role = os.environ.get("PADDLE_TRACE_ROLE", "proc")
try:
    _every = max(1, int(os.environ.get("PADDLE_TRACE_EVERY", "1")))
except ValueError:
    _every = 1

_fh = None           # sink file handle
_fh_pid = None       # pid the handle was opened under (fork safety)

# span/trace id scheme: unique across processes without touching the
# global `random` stream (tracing must never perturb seeded training
# RNG) — pid + 4 urandom bytes prefix, per-process counter suffix
_id_prefix = f"{os.getpid():x}{int.from_bytes(os.urandom(4), 'big'):08x}"
_id_counter = itertools.count(1)


def _new_id() -> str:
    return f"{_id_prefix}-{next(_id_counter):x}"


def enabled() -> bool:
    return _enabled


def trace_every() -> int:
    return _every


def sink_id() -> str:
    return f"{_role}-{os.getpid()}"


def sink_path() -> str:
    return os.path.join(_dir, f"trace-{sink_id()}.jsonl")


def enable(dir: Optional[str] = None, role: Optional[str] = None,
           every: Optional[int] = None):
    """Turn tracing on (programmatic alternative to ``PADDLE_TRACE=1``).
    A changed dir/role closes the current sink; the next record opens
    the new one."""
    global _enabled, _dir, _role, _every
    with _lock:
        if dir is not None and dir != _dir:
            _close_locked()
            _dir = dir
        if role is not None and role != _role:
            _close_locked()
            _role = role
        if every is not None:
            _every = max(1, int(every))
        _enabled = True


def disable():
    """Turn tracing off and close the sink (tests must call this so one
    test's sink never leaks into the next)."""
    global _enabled
    with _lock:
        _enabled = False
        _close_locked()


def _close_locked():
    global _fh, _fh_pid
    if _fh is not None:
        try:
            _fh.close()
        except OSError:
            pass
        _fh = None
        _fh_pid = None


def flush():
    with _lock:
        if _fh is not None:
            _fh.flush()


def _write(rec: dict):
    """Append one record to this process's sink (opened lazily; reopened
    after fork — a forked DataLoader worker must not interleave writes
    into its parent's stream)."""
    global _fh, _fh_pid
    pid = os.getpid()
    line = json.dumps(rec, separators=(",", ":"))
    with _lock:
        if not _enabled:
            # a span finishing after disable() must not resurrect the
            # sink (tests would leak files into the next test's dir)
            return
        if _fh is None or _fh_pid != pid:
            if _fh is not None:     # inherited handle from a fork
                _fh = None
            os.makedirs(_dir, exist_ok=True)
            # line-buffered: a SIGKILLed process (chaos crash plans,
            # failover tests) keeps every completed span on disk
            _fh = open(os.path.join(
                _dir, f"trace-{_role}-{pid}.jsonl"), "a", buffering=1)
            _fh_pid = pid
            _fh.write(json.dumps(
                {"t": "meta", "sink": f"{_role}-{pid}", "role": _role,
                 "pid": pid, "start_us": time.time_ns() // 1000},
                separators=(",", ":")) + "\n")
        _fh.write(line + "\n")


def _stack() -> List[Tuple[str, str]]:
    s = getattr(_tls, "stack", None)
    if s is None:
        s = _tls.stack = []
    return s


def current_ctx() -> Optional[Tuple[str, str]]:
    """(trace_id, span_id) of the innermost live span on this thread."""
    s = getattr(_tls, "stack", None)
    return s[-1] if s else None


def propagation_ctx() -> Optional[List[str]]:
    """The context to stamp into an outgoing RPC frame header (a plain
    json/pickle-able 2-list), or None when there is nothing to
    propagate."""
    if not _enabled:
        return None
    ctx = current_ctx()
    return [ctx[0], ctx[1]] if ctx else None


class _NullSpan:
    """Shared no-op stand-in when tracing is off: the instrumentation
    site costs one call + one attribute check, no allocation."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **args):
        return self


_NULL = _NullSpan()


class Span:
    """One named interval in the trace.  Context manager::

        with span("ps.client.push", cat="rpc", shard=0):
            ...

    ``ctx=(trace_id, span_id)`` parents this span under a REMOTE span
    (server side of an RPC); otherwise the parent is the innermost live
    span on this thread, and a span with no parent mints a fresh
    trace_id (it is the root of a new causal chain).
    """

    __slots__ = ("name", "cat", "args", "trace", "span_id", "parent",
                 "_ts_us", "_t0")

    def __init__(self, name: str, cat: str = "host",
                 ctx: Optional[Tuple[str, str]] = None, **args):
        self.name = name
        self.cat = cat
        self.args = args or None
        if ctx is not None:
            self.trace, self.parent = str(ctx[0]), str(ctx[1])
        else:
            cur = current_ctx()
            if cur is not None:
                self.trace, self.parent = cur
            else:
                self.trace, self.parent = _new_id(), None
        self.span_id = _new_id()
        self._ts_us = 0
        self._t0 = 0

    def set(self, **args):
        if self.args is None:
            self.args = {}
        self.args.update(args)
        return self

    def __enter__(self):
        self._ts_us = time.time_ns() // 1000
        self._t0 = time.perf_counter_ns()
        _stack().append((self.trace, self.span_id))
        return self

    def __exit__(self, exc_type, exc, tb):
        dur_us = (time.perf_counter_ns() - self._t0) // 1000
        s = _stack()
        if s and s[-1] == (self.trace, self.span_id):
            s.pop()
        if exc_type is not None:
            self.set(error=exc_type.__name__)
        rec = {"t": "span", "name": self.name, "cat": self.cat,
               "ts_us": self._ts_us, "dur_us": dur_us,
               "pid": os.getpid(), "tid": threading.get_ident(),
               "trace": self.trace, "span": self.span_id}
        if self.parent is not None:
            rec["parent"] = self.parent
        if self.args:
            rec["args"] = self.args
        _write(rec)
        return False


def span(name: str, cat: str = "host", **args):
    """Factory used at every instrumentation site: a real :class:`Span`
    while tracing is on, the shared no-op otherwise."""
    if not _enabled:
        return _NULL
    return Span(name, cat=cat, **args)


def server_span(name: str, ctx, cat: str = "rpc", **args):
    """Server-side child span of a remote parent context (the 2-list a
    client stamped into the frame header; None opens a local root)."""
    if not _enabled:
        return _NULL
    if ctx is not None:
        return Span(name, cat=cat, ctx=(ctx[0], ctx[1]), **args)
    return Span(name, cat=cat, **args)


def new_id() -> str:
    """Mint a fresh trace/span id (public for :mod:`.request_trace`,
    which manages its own id chains instead of the thread-local
    stack)."""
    return _new_id()


def emit_span(name: str, ts_us: int, dur_us: int, trace_id: str,
              span_id: str, parent: Optional[str] = None,
              cat: str = "req", tid: Optional[int] = None,
              args: Optional[Dict] = None):
    """Write one span record with EXPLICIT ids, timestamps and lane.

    The :class:`Span` context manager parents through the thread-local
    stack — correct for code that nests on one thread, wrong for a
    scheduler thread interleaving many requests per iteration: a request's queue phase opens on the submitting thread and
    closes on the scheduler thread, and two requests' phases overlap
    arbitrarily.  This function bypasses the stack entirely; the
    caller supplies the chain.  ``tid`` overrides the thread ident in
    the record (one virtual lane id per request renders one lane per
    request).
    """
    if not _enabled:
        return
    rec = {"t": "span", "name": name, "cat": cat,
           "ts_us": int(ts_us), "dur_us": int(dur_us),
           "pid": os.getpid(),
           "tid": int(tid) if tid is not None
           else threading.get_ident(),
           "trace": trace_id, "span": span_id}
    if parent is not None:
        rec["parent"] = parent
    if args:
        rec["args"] = args
    _write(rec)


def record_clock(peer_sink: str, offset_us: float, rtt_us: float):
    """Persist one clock-offset sample: ``offset_us`` is (peer clock −
    this process's clock) estimated at the midpoint of a round trip of
    ``rtt_us``.  trace_merge uses these edges to shift every sink onto
    the root process's timeline."""
    if not _enabled:
        return
    _write({"t": "clock", "peer": str(peer_sink),
            "offset_us": float(offset_us), "rtt_us": float(rtt_us),
            "pid": os.getpid(), "ts_us": time.time_ns() // 1000})
