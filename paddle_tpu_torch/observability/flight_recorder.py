"""Flight recorder — always-on postmortem telemetry (a copy of
``paddle_tpu/observability/flight_recorder.py``; it holds no device
logic).

A tracing/metrics stack is opt-in and forward-looking: you must
enable it BEFORE the interesting step happens.  The reference ships a
dedicated profiler layer (platform/profiler.h, SURVEY L0) because the
question that actually pages people — "why did the run die/stall/slow
down at step N" — must be answerable *after the fact*.  This module is
that layer:

1. **Ring buffer** (:class:`FlightRecorder`): a bounded-memory,
   no-I/O-on-the-hot-path event ring (~O(1k) events, fixed byte
   budget, oldest-first eviction).  Recording sites all over the repo
   (train step, TrainGuard health verdicts, PS RPC begin/end, serving
   queue events, chaos fault firings, compile events) append ~one
   small dict each; with the recorder on this costs one json encode +
   deque append, with
   ``PADDLE_FLIGHT=0`` it is one attribute check (~0.2 us).  Nothing
   ever touches disk until a dump is triggered.

2. **Compile observatory** (:func:`note_compile` / :func:`compile_log`):
   every lowering/compile in ``DistributedTrainStep`` and the AOT
   ``Predictor`` logs its retrace cause (first build vs. a new shape
   bucket vs. an AVOIDABLE retrace — same shapes, different dtypes),
   compile wall time, and, where the caller hands over an object with
   a ``memory_analysis()``, its argument/output/temp/peak bytes.
   Memory analysis needs an extra AOT compile on the training-step
   call path, so it resolves only in full mode (dumps enabled) or on
   demand via ``compile_log(resolve=True)``; the serving path holds
   its executables and logs it for free.

3. **Dump triggers**: a postmortem bundle is written on
   - typed failures — ``NumericalDivergence``, ``PSUnavailable``,
     ``ServerOverloaded`` call :func:`maybe_dump` at their raise sites;
   - unhandled exceptions — ``sys.excepthook`` +
     ``threading.excepthook`` chains (the previous hook still runs);
   - ``SIGUSR2`` — dump on demand, process continues;
   - fatal-but-dumpable signals — SIGTERM/SIGABRT write the bundle,
     then restore the default handler and re-raise; ``faulthandler``
     covers SIGSEGV-grade deaths with raw stacks in a sidecar file;
   - the **stall watchdog** — a daemon thread that fires when no
     step/RPC progress has been observed for ``PADDLE_FLIGHT_STALL_S``
     seconds (a SIGKILLed peer wedging this process in a recv is the
     canonical trigger; the bundle's in-flight op table names the
     stalled RPC).

4. **Bundle** (``$PADDLE_TRACE_DIR/flight-<role>-<pid>-<n>.jsonl``):
   meta + reason, the ring (JSONL), in-flight ops, all-thread stacks,
   the last metrics snapshot, the compile log, and the exception (when
   one triggered).  ``tools/postmortem.py`` merges bundles from
   trainer + PS primary + replica onto one clock-corrected Perfetto
   timeline (clock edges ride the ring — the PS register reply carries
   the server clock whether or not tracing is on) and renders the
   "last 50 events per process, first divergence first" report.

Enablement::

    PADDLE_FLIGHT unset   ring records in memory; dumps/handlers OFF
    PADDLE_FLIGHT=1       full mode: + dump triggers, signal handlers,
                          faulthandler, excepthooks, watchdog (when
                          PADDLE_FLIGHT_STALL_S > 0)
    PADDLE_FLIGHT=0       everything off (kill switch)
    PADDLE_TRACE_DIR      bundle directory (default ./paddle_trace)
    PADDLE_TRACE_ROLE     role tag in bundle names (shared with trace)
    PADDLE_FLIGHT_STALL_S stall watchdog deadline, seconds (0 = off)

Imports nothing but the standard library at module level.
"""
from __future__ import annotations

import collections
import itertools
import json
import os
import sys
import threading
import time
import traceback
from typing import Callable, Dict, List, Optional

__all__ = ["FlightRecorder", "Watchdog", "enabled", "dumps_enabled",
           "enable", "disable", "record", "begin", "end", "progress",
           "progress_age", "note_compile", "compile_log", "dump",
           "maybe_dump", "events", "in_flight", "clear",
           "install_handlers", "bundle_paths", "enable_from_env",
           "recorder", "MEM_SCHEMA_VERSION", "MEM_SCHEMA_KEYS"]

_lock = threading.Lock()

# ring on unless explicitly killed; dumps only in full mode
_env = os.environ.get("PADDLE_FLIGHT", "")
_ring_on = _env != "0"
_dumps_on = _env == "1"

_DEFAULT_CAPACITY = 1024
_DEFAULT_MAX_BYTES = 256 * 1024

# progress kinds: recording one of these proves the process is alive
# (the stall watchdog measures the age of the newest one).
# serve.decode/serve.admit: the generation scheduler's per-step and
# per-admission heartbeats — decode mostly ticks via
# progress(), but its sampled ring events count too
# elastic.join/reshard/resume: a membership transition can
# legitimately stall the step stream for seconds (restore + reshard
# from the pinned checkpoint) — these events tell the watchdog the
# transition itself is making progress.  elastic.leave is deliberately
# NOT progress: a worker loss with no reshard following it is exactly
# the stall worth dumping.
# ps.replica.attach / ps.promote / ps.geo.push / elastic.promote:
# a failover or a geo catch-up legitimately pauses the
# data stream while the serving tier reorganises — these events ARE
# the recovery making progress; ps.replica_error and the client's
# read_stale_exhausted stay bad kinds (tools/postmortem.py).
# serve.spec_verify: a speculative-decode verify step IS
# decode progress — the gateway ticks serve.decode every iteration and
# additionally samples verify events into the ring
# online.ingest / ps.ttl_sweep: the streaming trainer's
# event loop and the TTL sweeper ARE the online loop making progress —
# either going silent is exactly the stall a bundle should autopsy
# (online.freshness_breach stays a bad kind in tools/postmortem.py).
# elastic.reshard.exchange/load/compile: the reshard
# decomposition — range-wise slot exchange, ranged checkpoint reads,
# per-mesh recompile.  Each sub-phase can individually dominate a
# transition (a big model's compile, a cold disk's load), so each is
# its own heartbeat with byte counts for the postmortem to apportion.
# gw.route: every gateway placement — initial routes,
# failover re-routes and drain re-homes all pass through it, so a
# router that stops placing IS the stall a bundle should autopsy
# (gw.failover / gw.drain stay bad kinds in tools/postmortem.py).
_PROGRESS_KINDS = frozenset({"step", "rpc", "serve.batch", "ps.apply",
                             "gw.route",
                             "serve.decode", "serve.admit",
                             "serve.spec_verify",
                             "elastic.join", "elastic.reshard",
                             "elastic.reshard.exchange",
                             "elastic.reshard.load",
                             "elastic.reshard.compile",
                             "elastic.resume", "elastic.promote",
                             "ps.replica.attach", "ps.promote",
                             "ps.geo.push", "online.ingest",
                             "ps.ttl_sweep"})

# typed-failure dumps are rate limited per reason (a retry storm must
# not turn every PSUnavailable into a bundle) and capped per process
_DUMP_MIN_INTERVAL_S = 5.0
_DUMP_MAX_BUNDLES = 32

_COMPILE_LOG_CAP = 256

# memory-analysis attributes worth logging (bytes)
_MEM_ATTRS = ("argument_size_in_bytes", "output_size_in_bytes",
              "temp_size_in_bytes", "alias_size_in_bytes",
              "generated_code_size_in_bytes")

# ---- compile-log memory schema ------------------
# Machine-readable contract for the byte counts a compile-log record
# carries.  Consumers (the planner's calibration hook,
# distributed/planner/calibrate.py) key on MEM_SCHEMA_KEYS and check
# ``mem_schema == MEM_SCHEMA_VERSION`` — a field rename or semantics
# change MUST bump the version so downstream readers fail loudly
# instead of silently zeroing their calibration (shape-drift test:
# tests/test_flight_recorder.py).  Every record that carries ANY byte
# count carries ALL of MEM_SCHEMA_KEYS (absent analysis attrs emit 0).
MEM_SCHEMA_VERSION = 1
MEM_SCHEMA_KEYS = ("argument_bytes", "output_bytes", "temp_bytes",
                   "alias_bytes", "peak_bytes")


def _dir() -> str:
    return os.environ.get("PADDLE_TRACE_DIR", "paddle_trace")


def _role() -> str:
    return os.environ.get("PADDLE_TRACE_ROLE", "proc")


def enabled() -> bool:
    """Is the ring recording?  (The default; ``PADDLE_FLIGHT=0`` kills
    it.)"""
    return _ring_on


def dumps_enabled() -> bool:
    """Are dump triggers live?  (Full mode: ``PADDLE_FLIGHT=1`` or
    :func:`enable`.)"""
    return _dumps_on


class FlightRecorder:
    """Bounded ring of recent events: capped by count AND by the total
    serialized byte size, evicting oldest-first.  An event's cost is
    the length of its JSONL line — exactly what a dump would write, so
    the byte bound is the bound on bundle size too."""

    def __init__(self, capacity: int = _DEFAULT_CAPACITY,
                 max_bytes: int = _DEFAULT_MAX_BYTES):
        self.capacity = int(capacity)
        self.max_bytes = int(max_bytes)
        self._lock = threading.Lock()
        self._ring: collections.deque = collections.deque()
        self._bytes = 0
        self.dropped = 0      # events evicted since process start

    def record(self, kind: str, **fields):
        rec = {"t": "event", "kind": str(kind),
               "ts_us": time.time_ns() // 1000}
        rec.update(fields)
        try:
            line = json.dumps(rec, separators=(",", ":"))
        except (TypeError, ValueError):
            rec = {k: (v if isinstance(v, (int, float, str, bool,
                                           type(None))) else str(v))
                   for k, v in rec.items()}
            line = json.dumps(rec, separators=(",", ":"))
        n = len(line) + 1
        with self._lock:
            self._ring.append((rec, n))
            self._bytes += n
            while self._ring and (len(self._ring) > self.capacity
                                  or self._bytes > self.max_bytes):
                _, m = self._ring.popleft()
                self._bytes -= m
                self.dropped += 1
        return rec

    def events(self) -> List[dict]:
        with self._lock:
            return [r for r, _ in self._ring]

    def nbytes(self) -> int:
        with self._lock:
            return self._bytes

    def clear(self):
        with self._lock:
            self._ring.clear()
            self._bytes = 0


_rec = FlightRecorder()

# in-flight op table: begin() without a matching end() means the op is
# still running — a dump lists them so a stall names its wedged RPC
_open_lock = threading.Lock()
_open: Dict[int, dict] = {}
_op_ids = itertools.count(1)

# stall-watchdog progress clock (monotonic; one float write per event)
_progress_mono = time.monotonic()

# latest clock-offset sample per peer, kept OUTSIDE the ring: a clock
# edge is what lets tools/postmortem.py fuse this process's bundle
# onto the run timeline, so it must survive ring eviction no matter
# how many events a long run churned through
_clock_lock = threading.Lock()
_sticky_clocks: Dict[str, dict] = {}

# dump bookkeeping
_dump_lock = threading.Lock()
_dump_seq = itertools.count(1)
_last_dump_by_reason: Dict[str, float] = {}
_bundle_paths: List[str] = []

# compile observatory log
_compile_lock = threading.Lock()
_compile_log: List[dict] = []

_watchdog: Optional["Watchdog"] = None
_handlers_installed = False


def recorder() -> FlightRecorder:
    return _rec


def record(kind: str, **fields):
    """Append one event to the ring (no-op when the recorder is off).
    Kinds in the progress set additionally feed the stall watchdog;
    ``clock`` events are additionally pinned per peer so a dump can
    always be clock-corrected."""
    if not _ring_on:
        return None
    if kind in _PROGRESS_KINDS:
        global _progress_mono
        _progress_mono = time.monotonic()
    rec = _rec.record(kind, **fields)
    if kind == "clock":
        with _clock_lock:
            _sticky_clocks[str(fields.get("peer"))] = rec
    return rec


def begin(kind: str, **fields) -> Optional[int]:
    """Mark the START of a long-running op (an RPC, a serve batch).
    Registers the op in the in-flight table only — NO ring write, so
    the completed-op hot path pays one event, not two.  Returns a
    token for :func:`end`; until then every dump lists the op as in
    flight — the watchdog's bundle names a stalled RPC through exactly
    this."""
    if not _ring_on:
        return None
    tok = next(_op_ids)
    rec = {"kind": str(kind), "ts_us": time.time_ns() // 1000}
    rec.update(fields)
    with _open_lock:
        _open[tok] = rec
    return tok


def end(tok: Optional[int], **fields):
    """Close a :func:`begin` op: writes ONE ring event spanning the op
    (the begin timestamp + duration + merged begin/end fields)."""
    if tok is None or not _ring_on:
        return
    with _open_lock:
        b = _open.pop(tok, None)
    if b is None:
        return
    dur_us = time.time_ns() // 1000 - b["ts_us"]
    global _progress_mono
    _progress_mono = time.monotonic()
    merged = {k: v for k, v in b.items() if k != "kind"}
    merged.update(fields)
    merged["dur_us"] = dur_us      # ts_us from begin rides in merged
    _rec.record(b["kind"], **merged)


def progress(what: str = ""):
    """Mark forward progress without recording an event (hot loops that
    already record elsewhere)."""
    global _progress_mono
    _progress_mono = time.monotonic()


def progress_age() -> float:
    """Seconds since the last observed progress event."""
    return time.monotonic() - _progress_mono


def events() -> List[dict]:
    return _rec.events()


def in_flight() -> List[dict]:
    with _open_lock:
        return [dict(v) for v in _open.values()]


def clear():
    """Tests: empty the ring + in-flight table + compile log + dump
    bookkeeping (rate limits and the per-process bundle cap must not
    leak across tests in a long suite run)."""
    _rec.clear()
    with _open_lock:
        _open.clear()
    with _compile_lock:
        _compile_log.clear()
    with _clock_lock:
        _sticky_clocks.clear()
    with _dump_lock:
        _bundle_paths.clear()
        _last_dump_by_reason.clear()


# ----------------------------------------------------------------------
# compile observatory
# ----------------------------------------------------------------------

def _mem_stats(compiled) -> Optional[dict]:
    """Extract the memory-analysis byte counts from an object with a
    ``memory_analysis()`` method (or the analysis itself).  ``peak_bytes`` is the
    standard estimate: arguments + outputs + temps − aliased (donated
    buffers count once)."""
    try:
        ma = (compiled.memory_analysis()
              if hasattr(compiled, "memory_analysis") else compiled)
    except Exception:
        return None
    if ma is None:
        return None
    out = {}
    for a in _MEM_ATTRS:
        v = getattr(ma, a, None)
        if v is not None:
            out[a.replace("_size_in_bytes", "_bytes")] = int(v)
    if not out:
        return None
    out["peak_bytes"] = (out.get("argument_bytes", 0)
                         + out.get("output_bytes", 0)
                         + out.get("temp_bytes", 0)
                         - out.get("alias_bytes", 0))
    # stable schema (MEM_SCHEMA_KEYS): every byte-carrying record has
    # the full key set + version stamp, so calibration readers can
    # detect drift instead of silently reading zeros
    for k in MEM_SCHEMA_KEYS:
        out.setdefault(k, 0)
    out["mem_schema"] = MEM_SCHEMA_VERSION
    return out


def note_compile(program: str, cause: str, wall_ms: float,
                 key=None, compiled=None,
                 mem_cb: Optional[Callable] = None, **extra):
    """Log one lowering/compile event.

    ``cause``: ``first_build`` | ``new_shape_bucket`` |
    ``avoidable_retrace`` (same shapes re-traced for a dtype change) |
    ``load`` / ``prewarm`` (AOT serving) | ``abstract``.

    ``compiled``: an object with ``memory_analysis()`` — read off it
    directly (free).  ``mem_cb``: a thunk producing one (the training
    step's call path, where reaching the executable costs an AOT
    compile) — resolved immediately in full mode, else only on an
    explicit :func:`compile_log` ``resolve=True`` (dumps never
    compile).
    """
    ent = {"program": str(program), "cause": str(cause),
           "wall_ms": round(float(wall_ms), 3),
           "ts_us": time.time_ns() // 1000}
    if key is not None:
        ent["key"] = str(key)
    ent.update(extra)
    mem = _mem_stats(compiled) if compiled is not None else None
    if mem is None and mem_cb is not None:
        if _dumps_on:
            mem = _resolve_mem(mem_cb)
        else:
            ent["_mem_cb"] = mem_cb     # lazy; stripped from dumps
    if mem:
        ent.update(mem)
    with _compile_lock:
        _compile_log.append(ent)
        while len(_compile_log) > _COMPILE_LOG_CAP:
            _compile_log.pop(0)
    if _ring_on:
        _rec.record("compile", **{k: v for k, v in ent.items()
                                  if not k.startswith("_")
                                  and k != "ts_us"})
    try:
        from ..framework import monitor as _monitor
        if _monitor.metrics_enabled():
            _monitor.hist_observe("compile_ms", float(wall_ms))
    except Exception:
        pass
    return ent


def _resolve_mem(cb) -> Optional[dict]:
    try:
        return _mem_stats(cb())
    except Exception:
        return None


def compile_log(resolve: bool = False) -> List[dict]:
    """The per-process compile trajectory (capped FIFO).  With
    ``resolve=True`` pending memory-analysis thunks are evaluated (one
    cached AOT compile each) and folded in."""
    with _compile_lock:
        entries = list(_compile_log)
    out = []
    for e in entries:
        cb = e.get("_mem_cb")
        if cb is not None and resolve:
            mem = _resolve_mem(cb)
            e.pop("_mem_cb", None)
            if mem:
                e.update(mem)
        out.append({k: v for k, v in e.items() if not k.startswith("_")})
    return out


# ----------------------------------------------------------------------
# dumps
# ----------------------------------------------------------------------

def _thread_stacks() -> dict:
    names = {t.ident: t.name for t in threading.enumerate()}
    out = {}
    for tid, frame in sys._current_frames().items():
        out[str(tid)] = {
            "name": names.get(tid, "?"),
            "frames": [ln.rstrip() for ln in
                       traceback.format_stack(frame)][-40:],
        }
    return out


def dump(reason: str, exc_info=None, path: Optional[str] = None,
         force: bool = True) -> Optional[str]:
    """Write one postmortem bundle now.  Returns the path (None when
    skipped: recorder killed, rate-limited non-forced dump, or bundle
    cap reached).  Safe to call from signal handlers and excepthooks —
    never raises."""
    if not _ring_on:
        return None
    try:
        now = time.monotonic()
        with _dump_lock:
            if len(_bundle_paths) >= _DUMP_MAX_BUNDLES:
                return None
            last = _last_dump_by_reason.get(reason)
            if not force and last is not None \
                    and now - last < _DUMP_MIN_INTERVAL_S:
                return None
            _last_dump_by_reason[reason] = now
            seq = next(_dump_seq)
        if path is None:
            d = _dir()
            os.makedirs(d, exist_ok=True)
            path = os.path.join(
                d, f"flight-{_role()}-{os.getpid()}-{seq}.jsonl")
        recs: List[dict] = [{
            "t": "meta", "sink": f"{_role()}-{os.getpid()}",
            "role": _role(), "pid": os.getpid(), "reason": str(reason),
            "seq": seq, "ts_us": time.time_ns() // 1000,
            "dropped": _rec.dropped,
            "progress_age_s": round(progress_age(), 3),
        }]
        if exc_info is not None and exc_info[0] is not None:
            recs.append({
                "t": "exc", "type": exc_info[0].__name__,
                "value": str(exc_info[1]),
                "tb": [ln.rstrip() for ln in
                       traceback.format_exception(*exc_info)][-40:]})
        ring = _rec.events()
        recs.extend(ring)
        # pinned clock samples whose ring copy was evicted ride along
        have = {(r.get("peer"), r.get("ts_us")) for r in ring
                if r.get("kind") == "clock"}
        with _clock_lock:
            recs.extend(r for r in _sticky_clocks.values()
                        if (r.get("peer"), r.get("ts_us")) not in have)
        fl = in_flight()
        if fl:
            now_us = time.time_ns() // 1000
            for op in fl:
                op["open_us"] = now_us - op["ts_us"]
            recs.append({"t": "inflight", "ops": fl})
        recs.append({"t": "stacks", "threads": _thread_stacks()})
        try:
            from ..framework import monitor as _monitor
            recs.append({"t": "metrics",
                         **_monitor.metrics_snapshot()})
        except Exception:
            pass
        # resolve=False: a dump must never COMPILE (a lazy mem thunk
        # costs an AOT compile each — a long default-mode run can hold
        # hundreds, turning a crash dump into minutes of compile work).
        # Full mode resolved memory analysis eagerly at note_compile
        # time, so its entries already carry the bytes.
        cl = compile_log(resolve=False)
        if cl:
            recs.append({"t": "compiles", "entries": cl})
        with open(path, "w") as f:
            for r in recs:
                try:
                    f.write(json.dumps(r, separators=(",", ":")) + "\n")
                except (TypeError, ValueError):
                    pass
        with _dump_lock:
            _bundle_paths.append(path)
        return path
    except Exception:
        return None


def maybe_dump(reason: str) -> Optional[str]:
    """Typed-failure dump site (PSUnavailable / NumericalDivergence /
    ServerOverloaded raise paths): dumps only in full mode, rate
    limited per reason."""
    if not _dumps_on:
        return None
    return dump(reason, exc_info=sys.exc_info(), force=False)


def bundle_paths() -> List[str]:
    with _dump_lock:
        return list(_bundle_paths)


# ----------------------------------------------------------------------
# triggers: excepthooks, signals, watchdog
# ----------------------------------------------------------------------

class Watchdog(threading.Thread):
    """Fires one dump when no progress event lands for ``deadline_s``;
    re-arms once progress resumes."""

    def __init__(self, deadline_s: float, poll_s: Optional[float] = None):
        super().__init__(name="paddle-flight-watchdog", daemon=True)
        self.deadline_s = float(deadline_s)
        self.poll_s = (poll_s if poll_s is not None
                       else max(0.05, min(1.0, self.deadline_s / 4)))
        self._stop = threading.Event()
        self._fired = False
        self.stalls = 0

    def run(self):
        # the watchdog's own start counts as progress: a process that
        # never steps at all (still initializing) is not "stalled"
        # until a full deadline has passed since here
        progress("watchdog_start")
        while not self._stop.wait(self.poll_s):
            age = progress_age()
            if age > self.deadline_s:
                if not self._fired:
                    self._fired = True
                    record("stall", age_s=round(age, 3),
                           deadline_s=self.deadline_s)
                    dump("stall")
                    # publish LAST: a caller polling `stalls` must
                    # find the bundle already on disk (a dump takes
                    # ~ms once many threads' stacks need formatting)
                    self.stalls += 1
            else:
                self._fired = False

    def stop(self):
        self._stop.set()


_prev_excepthook = None
_prev_threading_hook = None


def _excepthook(exc_type, exc, tb):
    dump("unhandled", exc_info=(exc_type, exc, tb))
    if _prev_excepthook is not None:
        _prev_excepthook(exc_type, exc, tb)


def _threading_hook(args):
    dump("thread_unhandled",
         exc_info=(args.exc_type, args.exc_value, args.exc_traceback))
    if _prev_threading_hook is not None:
        _prev_threading_hook(args)


def install_handlers(stall_s: Optional[float] = None):
    """Install the dump triggers: excepthooks, SIGUSR2 on-demand dump,
    SIGTERM/SIGABRT dump-then-die, faulthandler, and (when
    ``stall_s``/``PADDLE_FLIGHT_STALL_S`` > 0) the stall watchdog.
    Idempotent; signal handlers are skipped off the main thread."""
    global _handlers_installed, _prev_excepthook, _prev_threading_hook
    global _watchdog
    if not _handlers_installed:
        _handlers_installed = True
        _prev_excepthook = sys.excepthook
        sys.excepthook = _excepthook
        _prev_threading_hook = threading.excepthook
        threading.excepthook = _threading_hook
        try:
            import faulthandler
            import signal as _signal
            d = _dir()
            os.makedirs(d, exist_ok=True)
            # sidecar for signals Python code cannot survive (SEGV/FPE)
            fh = open(os.path.join(
                d, f"faulthandler-{_role()}-{os.getpid()}.txt"), "w")
            faulthandler.enable(file=fh)
            globals()["_faulthandler_file"] = fh  # keep fd alive

            def _fatal(signum, frame):
                dump(f"signal_{_signal.Signals(signum).name}")
                _signal.signal(signum, _signal.SIG_DFL)
                os.kill(os.getpid(), signum)

            def _usr2(signum, frame):
                dump("SIGUSR2")

            for sig, h in ((getattr(_signal, "SIGUSR2", None), _usr2),
                           (getattr(_signal, "SIGTERM", None), _fatal),
                           (getattr(_signal, "SIGABRT", None), _fatal)):
                if sig is None:
                    continue
                try:
                    _signal.signal(sig, h)
                except (ValueError, OSError):
                    pass        # not the main thread / platform limit
        except Exception:
            pass
    if stall_s is None:
        try:
            stall_s = float(os.environ.get("PADDLE_FLIGHT_STALL_S",
                                           "0") or 0)
        except ValueError:
            stall_s = 0.0
    if stall_s and stall_s > 0 and _watchdog is None:
        _watchdog = Watchdog(stall_s)
        _watchdog.start()


def enable(stall_s: Optional[float] = None, dumps: bool = True):
    """Programmatic full enable (tests; the env path is
    ``PADDLE_FLIGHT=1``)."""
    global _ring_on, _dumps_on
    _ring_on = True
    if dumps:
        _dumps_on = True
        install_handlers(stall_s=stall_s)


def disable(ring: bool = False):
    """Turn dump triggers (and optionally the ring) off.  Installed
    signal/except hooks stay installed but :func:`dump` becomes a
    no-op when the ring is off."""
    global _ring_on, _dumps_on, _watchdog
    _dumps_on = False
    if ring:
        _ring_on = False
    if _watchdog is not None:
        _watchdog.stop()
        _watchdog = None


def enable_from_env():
    """Honour ``PADDLE_FLIGHT`` (called at package import;
    idempotent)."""
    if _dumps_on:
        install_handlers()


# package-__init__ re-export names (record/dump/enabled are too generic
# to put on the observability package surface unprefixed)
flight_record = record
flight_dump = dump
flight_enabled = enabled
