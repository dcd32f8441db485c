"""Socket RPC of the parameter server (counterpart of
``paddle_tpu/distributed/fleet/ps_service.py``).

The transport: length-prefixed binary frames (a small pickled header;
numpy payloads ride out of band as raw buffers, never pickled) over TCP,
a thread per connection on the server, and a client with a background
push thread for the async modes.  Server-side, pull and push land on
the native sparse-table core (``native/ps_core.cc``): one batched C
gather or one fused C dedup + segment-sum + apply per RPC.  The wire is
the reference's byte for byte, so either package's client talks to the
other's server.  Client modes:

  sync       push blocks until applied
  half_async push enqueues; a drain thread sends the queue
  async      the same queue, no barrier coupling
  read       pull-only, fanned out over read replicas (below)

Fault tolerance:

  * every mutating RPC (push / push_delta / register / barrier) carries
    a per-client increasing sequence number; the server keeps a
    per-client window of applied seqs and acks a duplicate without
    applying it again, so retries are safe although a push is additive;
  * the client retries with connect/send/recv timeouts, bounded
    exponential backoff with seeded jitter and reconnection (a failed
    socket is always dropped: a partial frame is never resumed), and
    raises a typed :class:`PSUnavailable` at its deadline;
  * async pushes are one-way frames; the client tracks every unacked
    seq and ``barrier()`` checks the whole set against the server's
    window, raising :class:`PSUnavailable` when a push was lost;
  * an un-promoted standby refuses data RPCs with a retryable reply, so
    writes never land on a standby and diverge; handler errors (an
    unknown table, a bad payload) come back as a non-retryable
    :class:`PSError`;
  * a server can run as a hot standby (``replica_of=primary``): it
    catches up from an npz snapshot of every table, then applies a
    streamed log of acked mutations (the primary forwards each applied
    push before it acks the client, so an acked push survives the loss
    of one server); clients take an endpoint list per shard
    (``"host:p1|host:p2"``) and fail over;
  * every frame passes through the chaos plan, when one is installed
    (:mod:`.chaos`), so all of the above can be shown under injected
    faults.

Read tier:

  * a **read replica** (``replica_of=..., replica_mode="read"``) catches
    up from a snapshot like the standby, but the primary feeds it
    through a bounded per-sink queue drained by a sender thread, so a
    slow replica link never stalls a commit.  Read replicas never
    promote; on stream EOF they re-resolve the primary group and attach
    again from a fresh snapshot;
  * every streamed record carries the primary's commit seq (``cs``) and
    head (``head``); idle links carry ``wm`` heartbeats.  A replica
    serves a **bounded-staleness read**: a pull carrying ``max_lag`` is
    answered iff the stream is live, heard within ``stale_after_s``, and
    ``head - watermark <= max_lag``; otherwise the reply is a retryable
    ``stale`` refusal, never a stale row.  Plain pulls on an un-promoted
    replica stay refused;
  * :class:`PSClient` fans a read-mode pull across a shard's replicas by
    consistent hashing (64 virtual nodes per replica); a stale or dead
    replica is skipped per call and the rest falls through ring order,
    then to the primary group with the full retry layer;
  * a push stamped with an event's ingest time (``iwm``) feeds the
    replica-side ``ps_freshness_ms`` histogram, and every stream frame
    updates the ``ps_replica_lag_seconds`` gauge.

Worker liveness: clients register a worker id and may beat every
``heartbeat_interval``; the server's monitor marks a worker dead once
its beat is older than ``heartbeat_timeout`` and wakes blocked
barriers.  ``worker_barrier`` is a rendezvous across live workers:
under ``on_dead="evict"`` it completes without the dead, under
``on_dead="fail"`` it raises on the survivors.

Not ported yet (each raises ``NotImplementedError`` naming ROADMAP.md
item 6): the ``geo`` client mode, ``geo_set`` and the geo stamps
(``geo_site``), commit listeners, and replica-side read coalescing
(``read_coalesce_ms > 0``).
"""
from __future__ import annotations

import errno
import itertools
import os
import pickle
import queue
import random
import socket
import struct
import sys
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from . import chaos as _chaos
from . import ps as _ps
from ...framework import monitor as _monitor
from ...observability import flight_recorder as _flight
from ...observability import trace as _trace

__all__ = ["PSServer", "PSClient", "PSError", "PSConnectError",
           "PSUnavailable"]

_HDR = struct.Struct("!I")
_ITEM6 = "not ported yet (ROADMAP.md item 6: PS, recsys, online tier)"
# pre-pickled pull2 reply headers keyed by (n_ids, n_unique, dim)
_PULL2_HDR_CACHE = {}

# every RPC carries an optional trace context under this header key —
# [trace_id, span_id] of the client-side span — so the server's handler
# span parents correctly in the merged trace.
_TRACE_KEY = "tr"


def _note_clock(rep, t0_ns: int, t1_ns: int):
    """Clock-offset sample from a register round trip: the server's
    reply carries its wall clock (``srv_us``) + sink identity; the
    midpoint of [t0, t1] estimates when that clock was read on OUR
    timeline, so ``offset = srv_us - midpoint`` maps the server's span
    timestamps into this process's clock."""
    if not isinstance(rep, dict) or "srv_us" not in rep:
        return
    t0_us, t1_us = t0_ns // 1000, t1_ns // 1000
    off = rep["srv_us"] - (t0_us + t1_us) / 2.0
    _trace.record_clock(rep.get("srv_sink", "?"), off, t1_us - t0_us)
    # the flight ring keeps the same sample, so a postmortem merge can
    # clock-correct bundles even when tracing was never enabled
    _flight.record("clock", peer=str(rep.get("srv_sink", "?")),
                   offset_us=float(off), rtt_us=float(t1_us - t0_us))


class PSError(RuntimeError):
    """Base class for parameter-server transport errors."""


class PSConnectError(PSError):
    """Could not establish a connection to any endpoint of a shard."""


class PSUnavailable(PSError):
    """An RPC exhausted its retry budget / hard deadline."""


class _StandbyReply(PSError):
    """Internal: the endpoint answered "I am an un-promoted standby".
    The retry loop treats it like a down endpoint (drop the socket,
    back off, rotate) — it must never be surfaced as success."""


class _StaleRead(PSError):
    """Internal: a read replica answered "too stale for this bound".
    The read fan-out falls through to a fresher replica / the primary;
    it must never surface as a failed read while anything fresher is
    reachable."""


class _ReplicaDown(PSError):
    """Internal: a read replica's transport died mid-RPC.  The replica
    is marked down (bounded backoff) and the ids retry elsewhere."""


# RPCs with server-side effects: they carry (src, seq) so a retry can be
# acked without re-applying (additive pushes would double-apply;
# geo_set, which the port refuses, stays listed for the wire's sake)
_MUTATING_OPS = ("push", "push_delta", "geo_set", "register", "barrier")

# RPCs an un-promoted standby must refuse: serving pulls would return
# rows the snapshot/stream has not caught up to, and applying writes
# would diverge from the primary (split brain).  stats/stop/heartbeat/
# replicate stay allowed.
_GATED_OPS = ("pull", "pull2", "pull_q8", "push", "push_delta",
              "geo_set", "barrier", "register", "unregister",
              "worker_barrier")

# pull variants: "pull2" answers with deduped rows + an
# inverse map, streamed zero-copy straight out of the native arena;
# "pull_q8" ships int8 codes + per-row scales (the client or the
# device dequantizes).  Both obey the same staleness gate as "pull".
_PULL_OPS = ("pull", "pull2", "pull_q8")


def _expects_reply(msg) -> bool:
    """Whether the protocol answers this request frame.  An error reply
    to a one-way frame would desynchronise the request/reply stream."""
    op = msg.get("op")
    if op in ("push", "push_delta", "geo_set"):
        return bool(msg.get("sync"))
    return op in ("pull", "pull2", "pull_q8", "barrier", "register",
                  "unregister", "worker_barrier", "stats", "stop")


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, default))
    except ValueError:
        return default


def _parse_ep(e) -> Tuple[str, int]:
    h, p = str(e).rsplit(":", 1)
    return h, int(p)


def _extract_arrays(obj):
    """Split top-level ndarray values out of a dict message: returns
    (picklable header object, list of contiguous arrays)."""
    arrays = []
    if isinstance(obj, dict) and any(isinstance(v, np.ndarray)
                                     for v in obj.values()):
        plain, meta = {}, []
        for k, v in obj.items():
            if isinstance(v, np.ndarray) and v.dtype != object:
                v = np.ascontiguousarray(v)
                meta.append((k, v.dtype.str, v.shape))
                arrays.append(v)
            else:
                plain[k] = v
        plain["__arrays__"] = meta
        obj = plain
    return obj, arrays


def _send_msg_raw(sock: socket.socket, obj):
    """Frame: [!I header_len][pickled header][raw array payloads...].

    Top-level numpy values in a dict message ride OUT OF BAND: the
    header pickles only their (key, dtype, shape) metadata and the
    buffers follow as raw bytes via scatter-gather ``sendmsg`` — the
    data plane (ids / grads / pulled rows) is never pickled or copied
    into an intermediate frame, so a pull/push RPC against the native
    table costs one small header pickle plus direct buffer writes."""
    obj, arrays = _extract_arrays(obj)
    data = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    parts = [memoryview(_HDR.pack(len(data)) + data)]
    parts += [memoryview(a).cast("B") for a in arrays if a.nbytes]
    _sendall_vec(sock, parts)


def _send_msg(sock: socket.socket, obj):
    """Chaos-aware framing entry point: when a fault plan is installed
    (tests, ``PADDLE_CHAOS``) every frame passes through it."""
    plan = _chaos.active()
    if plan is not None:
        return plan.send(sock, obj, _send_msg_raw)
    _send_msg_raw(sock, obj)


def _frame_bytes(obj) -> bytes:
    """The exact wire bytes of a frame, as one buffer — the chaos
    harness uses this to sever connections mid-frame."""
    obj, arrays = _extract_arrays(obj)
    data = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    return b"".join([_HDR.pack(len(data)), data]
                    + [a.tobytes() for a in arrays if a.nbytes])


# sendmsg is limited to IOV_MAX iovecs per call (1024 on Linux) — a
# bigger batch fails with EMSGSIZE, which the zero-copy pull path (one
# iovec per arena row) would hit on any large pull
_IOV_MAX = 1024


def _sendall_vec(sock, views):
    """sendall for a list of buffers without concatenating them (one
    syscall per <=IOV_MAX sendmsg window, zero staging copies).

    Capability is probed ONCE up front: the no-``sendmsg`` fallback is
    a per-view ``sendall`` — byte-identical wire output, since the
    frame is defined as the concatenation of the views either way.
    Partial sends (full socket buffer) consume from the front of the
    view list and re-enter; EINTR retries the same window (PEP 475
    covers most of it, but a handler that swallows the signal can
    still surface InterruptedError here)."""
    views = [v for v in views if len(v)]   # a 0-length view would make
    if not hasattr(sock, "sendmsg"):       # the consume loop spin
        for v in views:
            sock.sendall(v)
        return
    i, n = 0, len(views)
    while i < n:
        try:
            sent = sock.sendmsg(views[i:i + _IOV_MAX])
        except InterruptedError:
            continue
        # consume by CURSOR, not pop(0): a fully-sent window advances
        # in O(window), where popping each view from the front of a
        # long list would be quadratic in the iovec count
        while sent > 0:
            lv = len(views[i])
            if sent >= lv:
                sent -= lv
                i += 1
            else:
                # partial view: memoryview first so slicing a bytes /
                # ctypes part re-references instead of copying
                views[i] = memoryview(views[i])[sent:]
                sent = 0


def _recv_msg(sock: socket.socket):
    hdr = _recv_exact(sock, _HDR.size)
    if hdr is None:
        return None
    (n,) = _HDR.unpack(hdr)
    data = _recv_exact(sock, n)
    if data is None:
        return None
    msg = pickle.loads(data)
    if isinstance(msg, dict) and "__arrays__" in msg:
        for k, dt, shape in msg.pop("__arrays__"):
            dtype = np.dtype(dt)
            count = int(np.prod(shape)) if shape else 1
            buf = _recv_exact(sock, count * dtype.itemsize)
            if buf is None:
                return None
            # bytearray-backed: the receiver may mutate in place
            msg[k] = np.frombuffer(buf, dtype=dtype).reshape(shape)
    return msg


def _recv_exact(sock, n):
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        r = sock.recv_into(view[got:])
        if r == 0:
            return None
        got += r
    return buf


class _SeqWindow:
    """Per-client duplicate detector: last-applied-seq high-water mark
    plus the set of seqs seen inside a sliding window.  A seq at or
    below ``max_seq - WINDOW`` is treated as an ancient duplicate —
    the client's bounded retry budget cannot legitimately be that far
    behind its own high-water mark."""

    WINDOW = 4096
    __slots__ = ("max_seq", "seen")

    def __init__(self, max_seq: int = 0, seen=()):
        self.max_seq = int(max_seq)
        self.seen = set(int(s) for s in seen)

    def check_and_record(self, seq) -> bool:
        """True when ``seq`` is a duplicate (already applied); records
        it as applied otherwise."""
        seq = int(seq)
        if seq <= self.max_seq - self.WINDOW:
            return True
        if seq in self.seen:
            return True
        self.seen.add(seq)
        if seq > self.max_seq:
            self.max_seq = seq
        if len(self.seen) > 2 * self.WINDOW:
            floor = self.max_seq - self.WINDOW
            self.seen = {s for s in self.seen if s > floor}
        return False

    def export(self):
        return [self.max_seq, sorted(self.seen)[-self.WINDOW:]]

    @classmethod
    def from_export(cls, x):
        return cls(x[0], x[1])


# -- consistent-hash read ring ------------------------------------------
#
# The read fan-out must pick the same replica for the same id in every
# client process (cache affinity; the serving fleet shares row working
# sets), and adding/removing a replica must remap ~1/N of the id space,
# not reshuffle it.  Ring points come from blake2b over the endpoint
# string (stable across processes/pythons — hash() is salted); id
# placement uses a vectorized splitmix64 so a serving-batch lookup is
# numpy, not a per-id digest.

_RING_VNODES = 64


def _mix64(x: np.ndarray) -> np.ndarray:
    """splitmix64 finalizer over a uint64 array (wrapping arithmetic)."""
    x = x + np.uint64(0x9E3779B97F4A7C15)
    x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return x ^ (x >> np.uint64(31))


def _build_ring(endpoints) -> Tuple[np.ndarray, np.ndarray]:
    """(sorted ring points uint64, owner replica index per point)."""
    import hashlib
    pts, owners = [], []
    for j, ep in enumerate(endpoints):
        for v in range(_RING_VNODES):
            d = hashlib.blake2b(f"{ep}#{v}".encode(),
                                digest_size=8).digest()
            pts.append(int.from_bytes(d, "big"))
            owners.append(j)
    pts = np.asarray(pts, np.uint64)
    owners = np.asarray(owners, np.int64)
    order = np.argsort(pts, kind="stable")
    return pts[order], owners[order]


def _ring_positions(ring, ids: np.ndarray) -> np.ndarray:
    """Each id's position on the ring (index of its successor point)."""
    pts, _ = ring
    h = _mix64(np.ascontiguousarray(ids, np.int64).astype(np.uint64))
    return np.searchsorted(pts, h, side="left") % len(pts)


def _ring_owner_from(ring, pos: int, excluded) -> Optional[int]:
    """First owner clockwise from ``pos`` not in ``excluded`` (None when
    every replica is excluded — the caller falls to the primary)."""
    pts, owners = ring
    n = len(pts)
    for k in range(n):
        o = int(owners[(pos + k) % n])
        if o not in excluded:
            return o
    return None


class HeartBeatMonitor:
    """Tracks trainer liveness on the server.

    Reference: paddle/fluid/operators/distributed/heart_beat_monitor.cc —
    a LonelyMonitor thread walks UnderMonitoredWorker timestamps and
    declares workers lost after a timeout.  Here eviction additionally
    wakes blocked sync barriers so they can re-evaluate membership.
    """

    def __init__(self, timeout: float = 10.0, interval: float = 0.5):
        self.timeout = timeout
        self._interval = interval
        self.cond = threading.Condition()
        self.registered: Dict[str, float] = {}   # worker id -> last beat
        self.dead: set = set()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self):
        self._thread = threading.Thread(target=self._watch, daemon=True)
        self._thread.start()

    def stop(self):
        self._stop.set()
        with self.cond:
            self.cond.notify_all()

    def beat(self, worker: str):
        with self.cond:
            is_new = (worker not in self.registered
                      or worker in self.dead)
            self.registered[worker] = time.monotonic()
            self.dead.discard(worker)
            if is_new:   # registration / resurrection changes barrier
                self.cond.notify_all()   # membership; a refresh doesn't

    def touch(self, worker: str):
        """Timestamp-only refresh for the data hot path: no notify (a
        pull/push from a live worker never unblocks a barrier)."""
        with self.cond:
            if worker in self.registered and worker not in self.dead:
                self.registered[worker] = time.monotonic()
            else:
                self.beat(worker)

    def leave(self, worker: str):
        """Graceful exit — stop counting this worker toward barriers."""
        with self.cond:
            self.registered.pop(worker, None)
            self.dead.discard(worker)
            self.cond.notify_all()

    def live_workers(self) -> set:
        with self.cond:
            return set(self.registered) - self.dead

    def _watch(self):
        while not self._stop.wait(self._interval):
            now = time.monotonic()
            with self.cond:
                newly_dead = [w for w, t in self.registered.items()
                              if w not in self.dead
                              and now - t > self.timeout]
                if newly_dead:
                    self.dead.update(newly_dead)
                    self.cond.notify_all()


class PSServer:
    """Serves SparseTable pull/push (parity: brpc_ps_server.cc).

    ``replica_of="host:port"`` starts this server as a hot standby of a
    running primary: it pulls an npz snapshot of every table + the
    primary's seq windows, then applies the primary's streamed log of
    acked mutations.  When the primary connection dies the standby
    promotes itself (``promoted``/``role``) and keeps serving — clients
    holding an endpoint list fail over to it transparently.

    ``replica_mode="read"`` makes this a READ replica
    instead: ``replica_of`` may name the primary's whole failover group
    (``"h:p1|h:p2"``), the mutation stream is fed asynchronously
    (bounded per-sink queue on the primary — a slow link can't stall
    commits; overflow detaches the sink and this replica re-attaches
    from a fresh snapshot), it NEVER promotes, and it serves
    bounded-staleness pulls (``max_lag`` + ``stale_after_s``, module
    docstring) while un-promoted.  A hot standby serves bounded reads
    too (its synchronous stream keeps it at lag ~0); plain pulls stay
    refused on any un-promoted replica (split-brain guard).
    """

    def __init__(self, tables: Dict[str, "SparseTable"],
                 host: str = "0.0.0.0", port: int = 0,
                 heartbeat_timeout: float = 10.0,
                 on_dead: str = "evict",
                 expected_workers: Optional[int] = None,
                 replica_of: Optional[str] = None,
                 replica_mode: str = "standby",
                 serve_reads: bool = True,
                 stale_after_s: float = 2.0,
                 wm_interval_s: float = 0.25,
                 sink_queue: int = 8192,
                 read_coalesce_ms: float = 0.0,
                 read_coalesce_batch: int = 64,
                 geo_site: Optional[str] = None):
        if read_coalesce_ms > 0:
            raise NotImplementedError(
                f"PSServer(read_coalesce_ms>0): read coalescing {_ITEM6}")
        if geo_site is not None:
            raise NotImplementedError(f"PSServer(geo_site=...): {_ITEM6}")
        if on_dead not in ("evict", "fail"):
            raise ValueError(f"on_dead must be 'evict' or 'fail', "
                             f"got {on_dead!r}")
        self._tables = tables
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(64)
        self.port = self._sock.getsockname()[1]
        self._stop = threading.Event()
        self._threads = []
        self._conns: set = set()       # live client connections
        self._conns_lock = threading.Lock()
        self._on_dead = on_dead
        self.monitor = HeartBeatMonitor(timeout=heartbeat_timeout)
        # rendezvous state: barrier generation -> set of arrived workers
        self._barrier_gen = 0
        self._arrived: set = set()
        self._barrier_results: Dict[int, dict] = {}
        # launch-skew guard: the first barrier must not complete before
        # expected_workers distinct workers have ever registered
        self._expected = expected_workers
        self._ever_registered: set = set()
        # idempotency + replication state.  _apply_lock serializes
        # mutations so (dedup check, table apply, replica forward) is
        # one atomic commit with a total order the replica replays.
        # INTENDED LOCK ORDER: a replica sink's stream lock
        # (rep["lock"]) nests INSIDE the apply lock, never the reverse
        # — _attach_replica's failure path must release the sink lock
        # BEFORE re-taking the apply lock.
        # lint: lock-order: PSServer._apply_lock -> rep[lock]
        self._apply_lock = threading.Lock()
        self._seqs: Dict[str, _SeqWindow] = {}
        self._replicas: List[dict] = []
        self.applied = 0      # mutations committed
        self.dup_acks = 0     # duplicates acked without re-applying
        self.replica_of = replica_of
        if replica_mode not in ("standby", "read"):
            raise ValueError(f"replica_mode must be 'standby' or "
                             f"'read', got {replica_mode!r}")
        self.replica_mode = replica_mode
        self.role = "replica" if replica_of else "primary"
        self.promoted = False
        self.replica_error: Optional[Exception] = None
        self.replica_ready = threading.Event()
        self._repl_sock: Optional[socket.socket] = None
        # bounded-staleness read state (replica side): watermark = last
        # applied commit seq, head = newest primary commit seq heard on
        # the stream (records + wm heartbeats), _last_stream = when.
        # All written by the single replica-loop thread; int/float reads
        # elsewhere are atomic under the GIL.
        self._serve_reads = bool(serve_reads)
        self._stale_after = float(stale_after_s)
        self._wm_interval = float(wm_interval_s)
        self._sink_queue = int(sink_queue)
        self._watermark = 0
        self._head = 0
        self._stream_live = False
        self._last_stream = 0.0
        # TIME-based lag: every stream frame (wm
        # heartbeats included) carries the primary's wall clock ``ts``;
        # _head_time = newest primary clock heard, _wm_time = primary
        # clock of the last APPLIED record (or of a heartbeat heard
        # while fully caught up) — their difference is
        # ``ps_replica_lag_seconds``, the freshness SLO's gauge.
        self._head_time = 0.0
        self._wm_time = 0.0
        # ingest watermark: highest event-ingest timestamp
        # applied here — pushes stamped with ``iwm`` feed the
        # event-ingested -> servable freshness histogram on replicas
        self._ingest_wm = 0.0
        # admitted-churn publication cursor (PSServer.ttl_sweep)
        self._admitted_published: Dict[str, int] = {}
        if replica_of is None:
            self.replica_ready.set()
    def start(self, block: bool = False):
        self.monitor.start()
        t = threading.Thread(target=self._accept_loop, daemon=True)
        t.start()
        self._threads.append(t)
        if self.replica_of is not None:
            rt = threading.Thread(target=self._replica_loop, daemon=True)
            rt.start()
            self._threads.append(rt)
        # watermark heartbeats keep SYNC standbys' freshness clocks
        # ticking through write silence (no mutations != stale); read
        # sinks heartbeat from their own sender threads
        wt = threading.Thread(target=self._wm_loop, daemon=True)
        wt.start()
        self._threads.append(wt)
        if block:
            t.join()

    def _accept_loop(self):
        self._sock.settimeout(0.2)
        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                break
            with self._conns_lock:
                self._conns.add(conn)
            th = threading.Thread(target=self._serve, args=(conn,),
                                  daemon=True)
            th.start()
            self._threads.append(th)

    def _serve(self, conn):
        handed_off = False
        plan = _chaos.active()
        try:
            while not self._stop.is_set():
                try:
                    msg = _recv_msg(conn)
                except (OSError, ConnectionError):
                    break   # client gone (or chaos severed the stream)
                if msg is None:
                    break
                op = msg["op"]
                tctx = msg.pop(_TRACE_KEY, None)
                if plan is not None:
                    plan.on_serve(msg)       # may crash the process
                    plan.set_context(op)     # replies match "<op>_reply"
                # any RPC that names its worker is proof of life, so a
                # client doing only pull/push (no beat thread) stays live
                w = msg.get("worker")
                if w is not None and op not in ("register", "heartbeat",
                                                "unregister"):
                    if w not in self._ever_registered:
                        with self.monitor.cond:
                            self._ever_registered.add(w)
                    self.monitor.touch(w)
                # a pull carrying max_lag is a BOUNDED read: an
                # un-promoted replica may serve it iff fresh enough
                # (checked in the handler); anything else gated stays
                # refused — the split-brain guard is unchanged
                bounded_read = (op in _PULL_OPS
                                and msg.get("max_lag") is not None
                                and self._serve_reads)
                if (self.role == "replica" and not self.promoted
                        and op in _GATED_OPS and not bounded_read):
                    # split-brain guard: a client that rotated here too
                    # eagerly (slow-but-alive primary) gets a retryable
                    # refusal and keeps rotating until it reaches the
                    # promoted server — this standby must neither apply
                    # writes nor serve rows it has not caught up to
                    if _expects_reply(msg):
                        _send_msg(conn, {
                            "ok": False, "retryable": True,
                            "error": f"standby of {self.replica_of} "
                                     f"is not promoted"})
                    if plan is not None:
                        plan.set_context(None)
                    continue
                # handler span: a child of the client's RPC span when
                # the frame carried a trace context — the merged trace
                # shows this apply INSIDE the client's push/pull span
                srv_sp = (_trace.server_span(f"ps.server.{op}", tctx,
                                             table=msg.get("table"))
                          if _trace.enabled() else None)
                if srv_sp is not None:
                    srv_sp.__enter__()
                try:
                    if op in _PULL_OPS:
                        stale = None
                        if self.role == "replica" and not self.promoted:
                            lag, fresh = self._read_lag()
                            bound = int(msg.get("max_lag") or 0)
                            if not fresh or lag > bound:
                                stale = {"ok": False, "retryable": True,
                                         "stale": True, "lag": int(lag),
                                         "fresh": bool(fresh),
                                         "error": f"replica lag {lag} "
                                                  f"exceeds bound {bound}"
                                         if fresh else
                                         "replica stream is not fresh"}
                        if stale is not None:
                            _send_msg(conn, stale)
                        elif op == "pull2":
                            self._send_pull2(conn, msg)
                        elif op == "pull_q8":
                            self._send_pull_q8(conn, msg)
                        else:
                            t = self._table(msg["table"])
                            _send_msg(conn, {"vals": t.pull(msg["ids"])})
                        if stale is None and _monitor.metrics_enabled():
                            # per-pull progress counter: the fleet
                            # aggregator's straggler detection rates
                            # this across primary + replicas
                            _monitor.stat_add("ps_server_pulls")
                    elif op in ("push", "push_delta", "geo_set"):
                        applied = self._apply_mutation(msg)
                        if msg.get("sync"):
                            _send_msg(conn, {"ok": True,
                                             "dup": not applied})
                    elif op == "barrier":
                        self._record_seq(msg)
                        rep = {"ok": True}
                        conf = msg.get("confirm")
                        if conf:
                            rep["missing"] = self._unapplied(
                                msg.get("src"), conf)
                        _send_msg(conn, rep)
                    elif op == "register" or op == "heartbeat":
                        self._record_seq(msg)
                        self.monitor.beat(msg["worker"])
                        with self.monitor.cond:
                            self._ever_registered.add(msg["worker"])
                        if op == "register":
                            # reply carries this server's wall clock +
                            # sink identity: the client derives the
                            # clock-offset sample a trace merge uses to
                            # fuse the two processes' timelines
                            _send_msg(conn, {
                                "ok": True,
                                "srv_us": time.time_ns() // 1000,
                                "srv_sink": _trace.sink_id()})
                    elif op == "unregister":
                        self.monitor.leave(msg["worker"])
                        _send_msg(conn, {"ok": True})
                    elif op == "worker_barrier":
                        _send_msg(conn, self._worker_barrier(
                            msg["worker"], msg.get("timeout")))
                    elif op == "replicate":
                        if self.role == "replica" and not self.promoted:
                            # an un-promoted replica is not authoritative
                            # — a read replica attaching mid-failover
                            # must keep resolving until it reaches the
                            # promoted server, never chain off a peer
                            _send_msg(conn, {
                                "ok": False, "retryable": True,
                                "error": "un-promoted replica cannot "
                                         "seed a replica"})
                        else:
                            handed_off = self._attach_replica(
                                conn, mode=msg.get("mode", "standby"))
                            return
                    elif op == "stats":
                        _send_msg(conn, self._stats())
                    elif op == "stop":
                        _send_msg(conn, {"ok": True})
                        self._stop.set()
                        break
                except (OSError, ConnectionError):
                    raise   # transport death ends this connection
                except Exception as e:
                    # handler failure (unknown table, bad payload): a
                    # typed NON-retryable error reply instead of a dead
                    # serve thread — otherwise the client only sees
                    # connection-closed and burns its whole retry
                    # budget into PSUnavailable, masking the real error
                    if _expects_reply(msg):
                        _send_msg(conn, {
                            "ok": False, "fatal": True,
                            "error": f"{type(e).__name__}: {e}"})
                finally:
                    if srv_sp is not None:
                        srv_sp.__exit__(None, None, None)
                if plan is not None:
                    plan.set_context(None)
        except (OSError, ConnectionError):
            # a reply send failing (client died mid-RPC, or chaos cut
            # the frame) ends this connection, not the server
            pass
        finally:
            if plan is not None:
                plan.set_context(None)
            with self._conns_lock:
                self._conns.discard(conn)
            if not handed_off:
                conn.close()

    # -- batched pull wire paths -----------------------------------------
    def _send_pull2(self, conn, msg):
        """Zero-copy batched pull reply: dedup the requested ids, pin
        the table against row movement, resolve each unique id to its
        raw arena address, and scatter-gather the rows straight onto
        the socket — the reply frame is ``{inv, vals_uniq}`` in the
        standard out-of-band array format (the receiver cannot tell it
        was never staged).  A pull of N rows costs O(unique-rows /
        IOV_MAX) syscalls and ZERO staging copies server-side.

        The shared read pin (held across plan + send) is what makes
        the raw addresses safe: mutators that move or rewrite row bytes
        take the pin exclusively, so the bytes on the wire are a
        consistent snapshot.  Non-admitted ids resolve to address 0 and
        ship a zeros row.  Python-backend tables (and chaos runs, whose
        fault plans intercept whole frames) fall back to a staged copy
        with the IDENTICAL wire format.

        The fast path is two native calls: ``pull_plan`` (dedup +
        resolve + address-sort + rank, one pass in C — rows ship in
        ARENA order with ``inv`` remapped to match, so physically
        adjacent rows coalesce into one iovec) and ``sendv_addrs``
        (iovec build + the sendmsg loop).  Doing the plan and the
        gather list in python costs more than the row copy it avoids
        at serving batch sizes."""
        t = self._table(msg["table"])
        ids = np.ascontiguousarray(
            np.asarray(msg["ids"]).reshape(-1), np.int64)
        dim = int(t.dim)

        def _staged():
            uniq, inv = np.unique(ids, return_inverse=True)
            _send_msg(conn, {"inv": np.ascontiguousarray(inv, np.int32),
                             "vals_uniq": t.pull(uniq)})

        if _chaos.active() is not None or not getattr(
                t, "pin_read", lambda: False)():
            _staged()
            return
        try:
            plan = t.pull_plan(ids)
            if plan is None:        # native plan unavailable: stage
                _staged()
                return
            inv2, addrs = plan
            m = int(addrs.size)
            # the reply header depends only on (n, m, dim); serving
            # traffic repeats those shapes constantly, so the pickled
            # bytes are cached (bounded: shapes are few)
            key = (int(inv2.size), m, dim)
            pre = _PULL2_HDR_CACHE.get(key)
            if pre is None:
                hdr = {"__arrays__": [("inv", "<i4", (key[0],)),
                                      ("vals_uniq", "<f4", (m, dim))]}
                data = pickle.dumps(hdr,
                                    protocol=pickle.HIGHEST_PROTOCOL)
                pre = _HDR.pack(len(data)) + data
                if len(_PULL2_HDR_CACHE) > 4096:
                    _PULL2_HDR_CACHE.clear()
                _PULL2_HDR_CACHE[key] = pre
            to = conn.gettimeout()
            sent = _ps.sendv_addrs(
                conn.fileno(), addrs, dim * 4,
                pre, inv2,
                -1 if to is None else int(to * 1000))
            if sent is not None and sent < 0:
                if -sent in (errno.EAGAIN, errno.EWOULDBLOCK):
                    raise socket.timeout("pull2 sendv timed out")
                raise OSError(-sent, os.strerror(-sent))
        finally:
            t.unpin_read()
        _monitor.stat_add("ps_server_pull2")

    def _send_pull_q8(self, conn, msg):
        """int8 wire pull reply: ``{inv, codes, scales}`` — per-row
        symmetrically quantized unique rows (scale = amax/127, codes
        int8).  ~4x fewer payload bytes per unique row than the f32
        row path; the client (or the device, via the ops/pallas
        pull-dequant kernel) reconstructs ``codes * scale``."""
        t = self._table(msg["table"])
        ids = np.ascontiguousarray(
            np.asarray(msg["ids"]).reshape(-1), np.int64)
        uniq, inv = np.unique(ids, return_inverse=True)
        codes, scales = t.pull_q8(uniq)
        _send_msg(conn, {"inv": np.ascontiguousarray(inv, np.int32),
                         "codes": codes, "scales": scales})
        _monitor.stat_add("ps_server_pull_q8")

    # -- idempotency + replication --------------------------------------
    def _record_seq(self, msg) -> bool:
        """Record (src, seq) of a non-table mutating RPC (register /
        barrier); returns True when it was a duplicate.  Both are
        idempotent anyway — recording keeps the window an exact log of
        what this server acked."""
        src, seq = msg.get("src"), msg.get("seq")
        if src is None or seq is None:
            return False
        with self._apply_lock:
            w = self._seqs.get(src)
            if w is None:
                w = self._seqs[src] = _SeqWindow()
            dup = w.check_and_record(seq)
            if dup:
                self.dup_acks += 1
            return dup

    def _apply_mutation(self, msg) -> bool:
        """Commit one push/push_delta exactly once: dedup by (src, seq),
        apply to the table, and forward to every attached replica —
        all under the apply lock, BEFORE the client is acked.  Returns
        False when the seq was already applied (retry: ack only)."""
        src, seq = msg.get("src"), msg.get("seq")
        op = msg["op"]
        if op not in ("push", "push_delta", "evict"):
            # refused before the seq is recorded: a refusal is no apply
            raise NotImplementedError(f"PS op {op!r}: {_ITEM6}")
        with self._apply_lock:
            if src is not None and seq is not None:
                w = self._seqs.get(src)
                if w is None:
                    w = self._seqs[src] = _SeqWindow()
                if w.check_and_record(seq):
                    self.dup_acks += 1
                    _monitor.stat_add("ps_server_dup_acks")
                    return False
            t = self._table(msg["table"])
            if op == "push":
                t.push(msg["ids"], msg["grads"])
            elif op == "push_delta":
                t.push_delta(msg["ids"], msg["deltas"])
            else:
                # evict: a replica's replay of a primary TTL sweep (it
                # only ever arrives on the replication stream)
                t.evict_ids(msg["ids"])
            self.applied += 1
            # ingest watermark: a push stamped with the
            # event's ingest time makes end-to-end freshness measurable
            # — a replica applying it observes event-ingested ->
            # servable-at-THIS-replica latency off the real data path
            iwm = msg.get("iwm")
            if iwm is not None:
                iwm = float(iwm)
                if iwm > self._ingest_wm:
                    self._ingest_wm = iwm
                if _monitor.metrics_enabled():
                    lat_ms = max((time.time() - iwm) * 1e3, 0.0)
                    if self.role == "replica" and not self.promoted:
                        _monitor.hist_observe("ps_freshness_ms", lat_ms)
                    else:
                        _monitor.hist_observe("ps_ingest_apply_ms",
                                              lat_ms)
                    _monitor.gauge_set("ps_ingest_wm", self._ingest_wm)
            if _monitor.metrics_enabled():
                # per-mutation gauge: a scrape of primary + replica
                # reads replica lag as the difference of the two
                _monitor.gauge_set("ps_applied_total", self.applied)
            # ring event doubles as server-side progress: a primary
            # that stops applying trips ITS watchdog too, not only the
            # wedged client's
            _flight.record("ps.apply", op=op,
                           table=msg.get("table"), src=src, seq=seq,
                           applied=self.applied)
            if self._replicas:
                self._forward(msg)
        return True

    def add_commit_listener(self, fn):
        raise NotImplementedError(f"PSServer.add_commit_listener: {_ITEM6}")

    def _forward(self, msg):
        """Stream one committed mutation to every replica (called under
        the apply lock).  Sync sinks (hot standby) are sent inline and
        awaited — an acked write survives primary loss.  Read sinks get
        a copy queued for their sender thread — a slow replica link
        never stalls the commit path; a sink whose queue overflows has
        fallen too far behind and is detached (it re-attaches from a
        fresh snapshot).  Every record carries the commit seq ``cs``
        (this server's applied count) the replicas' staleness bound is
        measured in."""
        rec = {k: msg[k] for k in ("op", "table", "ids", "grads",
                                   "deltas", "iwm", "src", "seq")
               if k in msg}
        rec["cs"] = self.applied
        # primary commit wall clock ``ts`` + head clock ``hts``: the
        # replica's TIME-based lag gauge differences the newest head
        # clock HEARD against the commit clock of the last record
        # APPLIED.  They coincide here; the read-sink sender refreshes
        # ``hts`` at send time (mirroring ``head``) so a replica
        # draining a backlog of old records still learns how far the
        # primary's clock has moved.
        rec["ts"] = rec["hts"] = time.time()
        # the forward span is a child of the server's apply span (tls),
        # and its context rides the record so the REPLICA's apply span
        # parents here — client -> primary -> replica is one chain in
        # the merged trace
        with _trace.span("ps.replica.forward", cat="rpc",
                         op=rec.get("op")):
            ctx = _trace.propagation_ctx()
            if ctx is not None:
                rec[_TRACE_KEY] = ctx
            for rep in list(self._replicas):
                if rep.get("mode") == "read":
                    try:
                        rep["q"].put_nowait(dict(rec))
                    except queue.Full:
                        self._replicas.remove(rep)
                        try:
                            rep["conn"].close()
                        except OSError:
                            pass
                    continue
                with rep["lock"]:
                    try:
                        _send_msg_raw(rep["conn"], rec)
                        ack = _recv_msg(rep["conn"])
                        if ack is None or not ack.get("ok"):
                            raise ConnectionError(
                                "replica closed mid-stream")
                    except (OSError, ConnectionError):
                        self._replicas.remove(rep)
                        try:
                            rep["conn"].close()
                        except OSError:
                            pass

    def _attach_replica(self, conn, mode: str = "standby") -> bool:
        """Handshake for ``op=replicate``: under the apply lock snapshot
        every table (npz bytes — the checkpoint format) plus the
        seq windows, register the connection as a stream sink, then send
        the snapshot.  The sink's lock is held until the snapshot is on
        the wire so a concurrent mutation's forward cannot overtake it
        (read sinks buffer concurrent records in their queue instead —
        their sender thread only starts after the snapshot is acked, so
        stream order still holds).  Returns True when the connection was
        handed off to the stream.
        """
        rep = {"conn": conn, "lock": threading.Lock(), "mode": mode}
        if mode == "read":
            rep["q"] = queue.Queue(maxsize=self._sink_queue)
        with self._apply_lock:
            names = sorted(self._tables)
            blobs = [(n, self._tables[n].state_bytes()) for n in names]
            seqs = {s: w.export() for s, w in self._seqs.items()}
            head = self.applied
            rep["lock"].acquire()
            self._replicas.append(rep)
        try:
            conn.settimeout(30.0)
            _send_msg_raw(conn, {"op": "snapshot", "tables": names,
                                 "seqs": seqs, "head": head, "geo": None,
                                 "srv_us": time.time_ns() // 1000,
                                 "srv_sink": _trace.sink_id()})
            for n, b in blobs:
                _send_msg_raw(conn, {"table": n,
                                     "blob": np.frombuffer(b, np.uint8)})
            ack = _recv_msg(conn)
            if ack is None or not ack.get("ok"):
                raise ConnectionError("replica rejected snapshot")
        except (OSError, ConnectionError):
            # lock ORDER matters: a concurrent _forward holds the apply
            # lock and blocks on this sink's lock, so taking the apply
            # lock while still holding rep["lock"] here would deadlock
            # every mutation behind a failed attach.  Close the conn
            # first (a waiting _forward then fails fast instead of
            # streaming to a rejected replica), release the sink lock,
            # THEN detach under the apply lock.
            try:
                conn.close()
            except OSError:
                pass
            rep["lock"].release()
            with self._apply_lock:
                if rep in self._replicas:
                    self._replicas.remove(rep)
            return False
        rep["lock"].release()
        _flight.record("ps.replica.attach", mode=mode, head=int(head),
                       tables=len(names))
        if mode == "read":
            st = threading.Thread(target=self._sink_sender, args=(rep,),
                                  daemon=True)
            st.start()
            self._threads.append(st)
        return True

    def _sink_sender(self, rep):
        """Per-read-sink sender: drains the sink's record queue onto the
        wire; on queue silence it sends ``wm`` watermark heartbeats so
        the replica's freshness clock keeps ticking through write
        silence.  Every outgoing frame is stamped with the CURRENT
        commit head — an in-order consumer always knows how far behind
        it is.  Frames go through the chaos-aware ``_send_msg`` so a
        delayed/lossy replica link is injectable."""
        conn, q = rep["conn"], rep["q"]
        last_wm = 0.0
        try:
            while not self._stop.is_set():
                # wm heartbeats flow on cadence even while the record
                # queue is BUSY: they are how a backlogged replica
                # learns the primary's current head/clock (its lag)
                # without waiting to drain — the pump consumes them
                # out of band of the apply queue
                now = time.monotonic()
                if now - last_wm >= self._wm_interval:
                    _send_msg(conn, {"op": "wm", "head": self.applied,
                                     "hts": time.time()})
                    last_wm = now
                try:
                    rec = q.get(timeout=self._wm_interval)
                except queue.Empty:
                    continue
                rec["head"] = self.applied
                rec["hts"] = time.time()
                _send_msg(conn, rec)
        except (OSError, ConnectionError):
            pass
        finally:
            self._detach_sink(rep)

    def _detach_sink(self, rep):
        """Close + deregister a sink from a context that holds NO locks
        (sender/wm threads) — conn first, then the apply lock, per the
        declared order."""
        try:
            rep["conn"].close()
        except OSError:
            pass
        with self._apply_lock:
            if rep in self._replicas:
                self._replicas.remove(rep)

    def _wm_loop(self):
        """Watermark heartbeats to SYNC sinks (read sinks heartbeat from
        their sender threads).  wm frames generate no ack, so they can
        interleave the forward/ack stream freely; the replica side
        updates its head + freshness clock and does not reply."""
        while not self._stop.wait(self._wm_interval):
            dead = []
            for rep in list(self._replicas):
                if rep.get("mode") == "read":
                    continue
                with rep["lock"]:
                    try:
                        _send_msg_raw(rep["conn"],
                                      {"op": "wm", "head": self.applied,
                                       "hts": time.time()})
                    except (OSError, ConnectionError):
                        dead.append(rep)
            for rep in dead:
                self._detach_sink(rep)

    def _lag_gauges(self, mx: bool):
        """Publish both replica-lag gauges (seq- and time-based) —
        called on every stream frame.  ``ps_replica_lag_seconds`` is
        the freshness SLO's input: how far behind the primary's wall
        clock this replica's applied state is."""
        if not mx:
            return
        _monitor.gauge_set("ps_replica_lag_seq",
                           max(0, self._head - self._watermark))
        _monitor.gauge_set("ps_replica_lag_seconds",
                           max(0.0, self._head_time - self._wm_time))

    def lag_seconds(self) -> float:
        """Current time-based replica lag (0.0 on a primary)."""
        if self.role != "replica" or self.promoted:
            return 0.0
        return max(0.0, self._head_time - self._wm_time)

    def _read_lag(self) -> Tuple[int, bool]:
        """(seq lag, fresh?) for the bounded-read gate.  A primary (or
        promoted standby) is trivially lag-0 fresh; a replica is fresh
        iff its stream is attached and heard from within
        ``stale_after_s`` — stream EOF (primary death) makes it unfresh
        IMMEDIATELY, so the failover window can never serve a
        beyond-bound answer."""
        if self.role != "replica" or self.promoted:
            return 0, True
        lag = max(0, self._head - self._watermark)
        if not self._stream_live:
            return lag, False
        return lag, (time.monotonic() - self._last_stream
                     <= self._stale_after)

    def _replica_loop(self):
        """Replica side: attach to the primary (first reachable member
        of the ``replica_of`` group), load the snapshot, then apply the
        mutation stream.  A hot STANDBY promotes itself when the stream
        dies after a successful catch-up; a READ replica never promotes
        — it re-resolves the group (the promoted standby after a
        failover) and re-attaches from a fresh snapshot, forever."""
        group = [x for x in str(self.replica_of).split("|") if x]
        read_mode = self.replica_mode == "read"
        deadline = time.monotonic() + 60.0
        while not self._stop.is_set():
            streamed = False
            for ep in group:
                try:
                    sock = socket.create_connection(_parse_ep(ep),
                                                    timeout=5.0)
                except OSError:
                    continue
                self._repl_sock = sock
                try:
                    streamed = self._attach_and_stream(sock, ep)
                finally:
                    try:
                        sock.close()
                    except OSError:
                        pass
                    self._repl_sock = None
                if self.replica_error is not None:
                    return   # out of sync: never promote, never serve
                if streamed or self._stop.is_set():
                    break
            if self._stop.is_set():
                return
            if streamed and not read_mode:
                # standby semantics: the primary died after we
                # were caught up — take over
                self.promote()
                return
            if not streamed and not read_mode \
                    and time.monotonic() > deadline:
                return   # never attached: stay a mute standby
            time.sleep(0.2)

    def _attach_and_stream(self, sock, ep: str) -> bool:
        """One attach + stream session.  Returns True iff the snapshot
        was fully applied (the stream ending afterwards is the signal a
        standby promotes on)."""
        read_mode = self.replica_mode == "read"
        caught_up = False
        try:
            sock.settimeout(60.0)
            t0 = time.time_ns()
            _send_msg_raw(sock, {"op": "replicate",
                                 "mode": self.replica_mode})
            head = _recv_msg(sock)
            if head is None or head.get("ok") is False \
                    or "tables" not in head:
                return False   # refused (un-promoted peer) or dead
            # clock edge replica -> primary (the primary snapshots
            # under its apply lock before answering, so the rtt is
            # inflated and the midpoint estimate coarse — good enough
            # to fuse same-rack timelines; a trace merge takes the
            # median over all samples)
            _note_clock(head, t0, time.time_ns())
            for _ in head.get("tables", []):
                fr = _recv_msg(sock)
                if fr is None:
                    return False
                self._load_snapshot_table(fr["table"],
                                          fr["blob"].tobytes())
            if head.get("geo"):
                # a primary holding geo stamps: this replica could not
                # decide conflicts as it does, so it must never serve
                self.replica_error = NotImplementedError(
                    f"replicating geo stamps: {_ITEM6}")
                return False
            with self._apply_lock:
                self._seqs = {s: _SeqWindow.from_export(x)
                              for s, x in head.get("seqs", {}).items()}
            self._watermark = self._head = int(head.get("head", 0))
            self._last_stream = time.monotonic()
            # snapshot == caught up as of the primary's clock in the
            # handshake; the time-lag gauge starts at zero from here
            self._head_time = self._wm_time = \
                head.get("srv_us", time.time_ns() // 1000) / 1e6
            self._stream_live = True
            _send_msg_raw(sock, {"ok": True})
            caught_up = True
            self.replica_ready.set()
            _flight.record("ps.replica.attach", primary=str(ep),
                           mode=self.replica_mode, head=self._head)
            sock.settimeout(None)
            mx = _monitor.metrics_enabled()
            if read_mode:
                # transport PUMP: a read replica receives
                # stream frames EAGERLY on a dedicated thread while
                # this thread applies them in order.  Without the
                # split, head/freshness information is stuck in the
                # TCP stream BEHIND the unapplied records, so a
                # replica slow at APPLYING could never see (or refuse
                # on) more than one frame of its own lag — the lag
                # gauges and the bounded-read gate would both
                # under-report the true backlog.
                inq: "queue.Queue" = queue.Queue()
                pump = threading.Thread(target=self._stream_pump,
                                        args=(sock, inq, mx),
                                        daemon=True)
                pump.start()
                self._threads.append(pump)
            while not self._stop.is_set():
                if read_mode:
                    rec = inq.get()
                    if rec is None:
                        break   # pump hit EOF: primary is gone
                else:
                    rec = _recv_msg(sock)
                    if rec is None:
                        break   # primary is gone
                    self._note_stream_frame(rec, mx)
                    if rec.get("op") == "wm":
                        continue
                ts = rec.get("ts")
                tctx = rec.pop(_TRACE_KEY, None)
                rep_sp = (_trace.server_span("ps.replica.apply", tctx,
                                             table=rec.get("table"))
                          if _trace.enabled() else None)
                if rep_sp is not None:
                    rep_sp.__enter__()
                try:
                    self._apply_mutation(rec)
                except Exception as e:
                    # a record this replica cannot apply means it is
                    # OUT OF SYNC (config mismatch, bug): it must never
                    # promote and serve diverged state.  Dropping the
                    # connection (no ack) also detaches it primary-side.
                    self.replica_error = e
                    self._stream_live = False
                    _flight.record("ps.replica_error",
                                   err=type(e).__name__, detail=str(e))
                    _flight.maybe_dump("replica_error")
                    print(f"paddle_tpu_torch PSServer replica: replication "
                          f"stream failed, NOT promoting: {e!r}",
                          file=sys.stderr)
                    return caught_up
                finally:
                    if rep_sp is not None:
                        rep_sp.__exit__(None, None, None)
                if read_mode:
                    # the record's head/clock stamps land together
                    # with its apply (see _stream_pump)
                    self._note_stream_frame(rec, False)
                if "cs" in rec:
                    cs = int(rec["cs"])
                    if cs > self._watermark:
                        self._watermark = cs
                    if cs > self._head:
                        self._head = cs
                if ts is not None and float(ts) > self._wm_time:
                    # the record is applied: this replica is now as
                    # fresh as the primary's clock at ITS commit
                    self._wm_time = float(ts)
                self._lag_gauges(mx)
                if not read_mode:
                    _send_msg_raw(sock, {"ok": True})
        except (OSError, ConnectionError):
            pass
        finally:
            # the stream is gone: bounded reads must refuse from THIS
            # instant — the primary may be dead and a new one taking
            # writes this replica cannot see yet
            self._stream_live = False
        return caught_up

    def _note_stream_frame(self, rec, mx: bool):
        """Per-frame bookkeeping at RECEIVE time: freshness clock,
        head (seq + time), caught-up watermark-time advance on
        heartbeats, and the lag gauges.  Called by the replica loop
        (sync sinks) or the transport pump (read sinks)."""
        self._last_stream = time.monotonic()
        if "head" in rec:
            h = int(rec["head"])
            if h > self._head:
                self._head = h
        ts = rec.get("ts")
        hts = rec.get("hts", ts)
        if hts is not None and float(hts) > self._head_time:
            self._head_time = float(hts)
        if rec.get("op") == "wm" and self._watermark >= self._head:
            # heartbeat while fully caught up: write silence is not
            # lag — the time-lag clock advances with the heartbeat
            self._wm_time = self._head_time
        self._lag_gauges(mx)

    def _stream_pump(self, sock, inq, mx: bool):
        """READ-replica transport pump (see _attach_and_stream): recv
        frames eagerly, note head/freshness per frame, queue records
        for the applier (wm heartbeats are consumed here).  EOF or
        transport death makes bounded reads refuse INSTANTLY and wakes
        the applier with the None sentinel."""
        try:
            while not self._stop.is_set():
                rec = _recv_msg(sock)
                if rec is None:
                    break
                if rec.get("op") == "wm":
                    self._note_stream_frame(rec, mx)
                    continue
                # records advance ONLY the freshness clock here: their
                # head/clock stamps take effect atomically WITH their
                # apply (the applier), so the bounded-read gate never
                # counts a record this replica has heard but not yet
                # served — eager head knowledge comes from the wm
                # heartbeats the sender interleaves even mid-backlog
                self._last_stream = time.monotonic()
                inq.put(rec)
        except (OSError, ConnectionError):
            pass
        finally:
            self._stream_live = False
            inq.put(None)

    def _load_snapshot_table(self, name: str, blob: bytes):
        t = self._tables.get(name)
        if t is None:
            # table the replica was not configured with (e.g. an
            # auto-vivified __util accumulator): recover it from the
            # snapshot itself — dim AND optimizer/init config, so
            # streamed pushes apply the identical math and rows that
            # first materialise after failover use the identical
            # deterministic init
            if name.startswith("__util"):
                t = self._table(name)
            else:
                import io
                from .ps import SparseTable
                t = self._tables[name] = SparseTable.from_config(
                    np.load(io.BytesIO(blob)))
        t.load_state_bytes(blob)

    def _unapplied(self, src, seqs) -> list:
        """Of ``seqs`` (mutations ``src`` sent with no reply expected),
        the ones this server never applied — barrier()'s delivery check
        for fire-and-forget async pushes.  Seqs below the dedup window
        count as applied, exactly as the window itself would treat
        them."""
        with self._apply_lock:
            w = self._seqs.get(src)
            if w is None:
                return [int(s) for s in seqs]
            floor = w.max_seq - w.WINDOW
            return [int(s) for s in seqs
                    if s > floor and s not in w.seen]

    # -- feature lifecycle ----------------------------------------------
    def ttl_sweep(self, cutoff: int, now: Optional[int] = None,
                  tables=None) -> Dict[str, int]:
        """One TTL pass: advance every table's lifecycle clock to
        ``now`` (wall seconds by default), evict ids whose last
        sighting predates ``cutoff`` ATOMICALLY with the mutation
        stream (under the apply lock), and forward each table's evicted
        ids as an ``evict`` record so replicas drop the exact same
        rows.  Publishes the ``ps_feature_admitted`` /
        ``ps_feature_evicted`` churn counters.  Returns
        ``{table: evicted_count}``.  ``cutoff``/``now`` are wall
        SECONDS (table ticks are milliseconds internally).  The sweep
        driver is :class:`paddle_tpu_torch.online.FeatureLifecycle`."""
        now = time.time() if now is None else float(now)
        out: Dict[str, int] = {}
        names = sorted(tables) if tables is not None \
            else sorted(self._tables)
        for name in names:
            t = self._tables.get(name)
            if t is None or not hasattr(t, "ttl_sweep"):
                continue
            t.set_clock(int(now * 1000.0))
            with self._apply_lock:
                ev = t.ttl_sweep(int(float(cutoff) * 1000.0))
                n = int(ev.size)
                if n:
                    self.applied += 1
                    if self._replicas:
                        self._forward({"op": "evict", "table": name,
                                       "ids": np.ascontiguousarray(
                                           ev, np.int64)})
            if n:
                _monitor.stat_add("ps_feature_evicted", n)
            adm = int(getattr(t, "admitted_total", 0))
            delta = adm - self._admitted_published.get(name, 0)
            if delta > 0:
                _monitor.stat_add("ps_feature_admitted", delta)
            self._admitted_published[name] = adm
            _flight.record("ps.ttl_sweep", table=name, evicted=n,
                           cutoff=float(cutoff), rows=len(t))
            out[name] = n
        return out

    def promote(self):
        """Become the primary (the standby's stream ended)."""
        _flight.record("ps.promote", was_replica_of=self.replica_of,
                       applied=self.applied)
        self.promoted = True
        self.role = "primary"

    def _stats(self) -> dict:
        lag, fresh = self._read_lag()
        with self._apply_lock:
            return {"ok": True, "role": self.role,
                    "promoted": self.promoted,
                    "applied": self.applied,
                    "dup_acks": self.dup_acks,
                    "n_replicas": len(self._replicas),
                    "replica_mode": (self.replica_mode
                                     if self.replica_of else None),
                    "watermark": int(self._watermark),
                    "head": int(self._head),
                    "read_lag": int(lag),
                    "read_fresh": bool(fresh),
                    "lag_seconds": self.lag_seconds(),
                    "ingest_wm": float(self._ingest_wm),
                    "versions": {n: t.version
                                 for n, t in self._tables.items()
                                 if hasattr(t, "version")}}

    def _table(self, name: str):
        """Reserved "__util" tables auto-vivify as zero-initialized
        dim-1 accumulators — the reduction scratch space UtilBase's
        PS-backed all_reduce/all_gather ride (base/util_factory.py's
        Gloo worlds collapse onto the PS service here)."""
        t = self._tables.get(name)
        if t is None and name.startswith("__util"):
            from .ps import SparseTable
            t = self._tables.setdefault(
                name, SparseTable(1, init_std=0.0, optimizer="sgd",
                                  lr=0.0))
        if t is None:
            raise KeyError(name)
        return t

    def _worker_barrier(self, worker: str, timeout: Optional[float]):
        """Block this connection thread until every live worker arrives.

        Completion advances a generation counter; every waiter of that
        generation returns the same result dict.  Dead workers (per the
        monitor) are excluded from membership under ``on_dead="evict"``
        and fail the whole barrier under ``on_dead="fail"``.
        """
        mon = self.monitor
        deadline = None if timeout is None else time.monotonic() + timeout
        # a waiter can't heartbeat (its client blocks on this RPC), so it
        # refreshes its own beat each wakeup; wake at least this often
        poll = min(1.0, mon.timeout / 4)
        with mon.cond:
            # arriving at a barrier is itself proof of life
            mon.registered[worker] = time.monotonic()
            mon.dead.discard(worker)
            self._ever_registered.add(worker)
            gen = self._barrier_gen
            self._arrived.add(worker)
            mon.cond.notify_all()

            def _complete(result):
                # results are per-generation: a slow waiter from gen g
                # must not read gen g+1's outcome
                self._barrier_results[gen] = result
                for g in list(self._barrier_results):
                    if g < gen - 8:
                        del self._barrier_results[g]
                self._barrier_gen += 1
                self._arrived = set()
                mon.cond.notify_all()
                return result

            while True:
                if self._barrier_gen != gen:
                    return self._barrier_results.get(
                        gen, {"ok": True, "evicted": []})
                if mon.dead and self._on_dead == "fail":
                    return _complete({
                        "ok": False,
                        "error": f"workers lost: {sorted(mon.dead)}",
                        "evicted": sorted(mon.dead)})
                live = set(mon.registered) - mon.dead
                # launch skew: never complete before the full expected
                # membership has shown up at least once (dead included —
                # the monitor, not absence, decides who is gone)
                roster_full = (self._expected is None
                               or len(self._ever_registered) >= self._expected)
                if roster_full and live and self._arrived >= live:
                    result = _complete({"ok": True,
                                        "evicted": sorted(mon.dead)})
                    # purge the evicted: out of the job now, not to be
                    # re-reported at every later barrier (a returning
                    # worker re-registers via its next beat)
                    for w in mon.dead:
                        mon.registered.pop(w, None)
                    mon.dead.clear()
                    return result
                mon.registered[worker] = time.monotonic()
                if deadline is not None:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        self._arrived.discard(worker)
                        return {"ok": False, "error": "barrier timeout"}
                    mon.cond.wait(min(remaining, poll))
                else:
                    mon.cond.wait(poll)

    def stop(self):
        self._stop.set()
        self.monitor.stop()
        with self._conns_lock:
            conns = list(self._conns)
            self._conns.clear()
        # sever live client connections too: a stopped server must look
        # DOWN (clients fail over to a standby), not half-alive
        for s in ([self._sock, self._repl_sock] + conns
                  + [r["conn"] for r in self._replicas]):
            if s is None:
                continue
            try:
                s.close()
            except OSError:
                pass


_UNSET = object()


class PSClient:
    """Worker-side client (parity: brpc_ps_client.cc + Communicator modes).

    ``endpoints`` names one entry per SHARD; each entry is either a
    single ``"host:port"`` or a failover list — ``"h:p1|h:p2"`` or an
    actual list/tuple — ordered primary first.  Ids shard by
    ``id % n_shards`` exactly as before; within a shard the client
    talks to the active endpoint and rotates on repeated failure.

    Retry/backoff knobs (constructor args override the environment):

    ==========================  =============================  =======
    arg                         env                            default
    ==========================  =============================  =======
    ``connect_timeout``         ``PADDLE_PS_CONNECT_TIMEOUT``  10 s
    ``rpc_timeout``             ``PADDLE_PS_RPC_TIMEOUT``      20 s
    ``max_retries``             ``PADDLE_PS_MAX_RETRIES``      8
    ``backoff_base``            ``PADDLE_PS_BACKOFF_BASE``     0.05 s
    ``rpc_deadline``            ``PADDLE_PS_RPC_DEADLINE``     60 s
    ==========================  =============================  =======

    Every mutating RPC carries a monotonically increasing seq number
    (``src`` scoped), so the bounded retry loop is exactly-once on the
    server even for additive pushes; exhausting the budget raises
    :class:`PSUnavailable` naming the shard's endpoints.

    Delivery semantics by mode: sync pushes are acked
    before returning — exactly-once.  Async/half-async pushes are
    one-way frames, at-most-once in flight; :meth:`barrier` then
    confirms every sent seq against the server's applied-seq window
    and raises :class:`PSUnavailable` if any was lost, so a barrier
    that returns cleanly proves exactly-once delivery of everything
    pushed before it.

    Serving read mode: ``mode="read"`` makes the client
    pull-only (mutating calls raise), and ``read_replicas`` (one
    endpoint group per shard, same ``"h:p1|h:p2"`` format) +
    ``max_lag`` fan every pull out across the shard's read replicas by
    consistent hashing with bounded-staleness semantics — see the
    module docstring.  Ids a replica answers stale (or whose replica is
    down) fall through ring-order, then to the primary endpoint group
    through the normal retry layer, so a read only fails when NOTHING
    within the bound is reachable.  ``max_lag`` alone (no replicas)
    marks pulls as bounded reads, which also lets an un-promoted hot
    standby serve them during a failover window.
    """

    def __init__(self, endpoints, mode: str = "sync", send_queue_size=16,
                 worker_id: Optional[str] = None,
                 heartbeat_interval: float = 0.0,
                 connect_timeout: Optional[float] = None,
                 rpc_timeout: Optional[float] = None,
                 max_retries: Optional[int] = None,
                 backoff_base: Optional[float] = None,
                 rpc_deadline: Optional[float] = None,
                 read_replicas=None, max_lag: Optional[int] = None,
                 pull_wire: Optional[str] = None):
        if mode == "geo":
            raise NotImplementedError(f"PSClient(mode='geo'): {_ITEM6}")
        self._ep_lists: List[List[Tuple[str, int]]] = []
        for e in endpoints:
            if isinstance(e, (list, tuple)):
                group = [_parse_ep(x) for x in e]
            else:
                group = [_parse_ep(x) for x in str(e).split("|") if x]
            if not group:
                raise ValueError(f"empty endpoint entry {e!r}")
            self._ep_lists.append(group)
        self._active = [0] * len(self._ep_lists)
        self._connect_timeout = (connect_timeout if connect_timeout
                                 is not None else
                                 _env_float("PADDLE_PS_CONNECT_TIMEOUT", 10.0))
        self._rpc_timeout = (rpc_timeout if rpc_timeout is not None else
                             _env_float("PADDLE_PS_RPC_TIMEOUT", 20.0))
        self._max_retries = int(max_retries if max_retries is not None else
                                _env_float("PADDLE_PS_MAX_RETRIES", 8))
        self._backoff = (backoff_base if backoff_base is not None else
                         _env_float("PADDLE_PS_BACKOFF_BASE", 0.05))
        self._deadline = (rpc_deadline if rpc_deadline is not None else
                          _env_float("PADDLE_PS_RPC_DEADLINE", 60.0))
        self.worker_id = worker_id
        # seq numbers are scoped by src so even anonymous clients (no
        # worker_id) get idempotent retries
        self._src = worker_id or f"cli-{os.getpid()}-{id(self):x}"
        self._seq = itertools.count(1)
        # INTENDED LOCK ORDER: the per-shard data-socket lock may take
        # the seq lock (re-register inside _reconnect_locked stamps a
        # fresh seq), never the reverse.
        # lint: lock-order: PSClient._lock[] -> PSClient._seq_lock
        self._seq_lock = threading.Lock()
        self._jitter = random.Random(
            hash(self._src) & 0xFFFFFFFF)   # deterministic per client
        self.retries = 0     # RPC attempts beyond the first
        self.failovers = 0   # active-endpoint rotations
        self._mode = mode
        self._socks: List[Optional[socket.socket]] = []
        self._lock = [threading.Lock() for _ in self._ep_lists]
        for r in range(len(self._ep_lists)):
            self._socks.append(self._connect_rank(r))
        self._q: "queue.Queue" = queue.Queue(maxsize=send_queue_size)
        self._stop = threading.Event()
        self._push_err: "Exception | None" = None
        self._push_err_later = 0   # failures after the first (masked)
        # per-shard seqs of mutations sent with no reply expected
        # (async pushes): "sent" only means the kernel buffered the
        # frame, so barrier() verifies the whole set against the
        # server's applied-seq window before reporting success
        self._unconfirmed: List[set] = [set() for _ in self._ep_lists]
        self._unconf_lock = threading.Lock()
        self._beat_stop = threading.Event()
        self._beat_socks = []
        if worker_id is not None:
            for r in range(len(self._socks)):
                self._rpc(r, {"op": "register", "worker": worker_id},
                          reply=True)
            if heartbeat_interval > 0:
                # beats ride dedicated sockets: the data sockets' locks
                # are held for the whole duration of a blocking
                # worker_barrier, which would starve heartbeats to every
                # other server and get this live worker evicted there
                for r in range(len(self._ep_lists)):
                    s = socket.create_connection(
                        self._ep(r), timeout=self._connect_timeout)
                    # bound sendall: a frozen-but-connected server must
                    # not wedge the beater once the send buffer fills
                    s.settimeout(2.0)
                    self._beat_socks.append(s)
                self._beater = threading.Thread(
                    target=self._beat, args=(heartbeat_interval,),
                    daemon=True)
                self._beater.start()
        # pull wire format: "row" = classic per-request f32
        # rows; "zc" = deduped {inv, vals_uniq} answered by the
        # server's zero-copy scatter-gather path; "q8" = deduped int8
        # codes + per-row scales (~4x fewer payload bytes per unique
        # row).  All three return identical f32 values from pull()
        # except q8, which is lossy by design (serving tier).
        wire = (pull_wire if pull_wire is not None
                else os.environ.get("PADDLE_PS_PULL_WIRE", "row"))
        if wire not in ("row", "zc", "q8"):
            raise ValueError(f"pull_wire must be row|zc|q8, got {wire!r}")
        self._pull_wire = wire
        # serving read tier: per-shard replica sets + rings
        self._max_lag = None if max_lag is None else int(max_lag)
        self._read_sets: Optional[List[List[dict]]] = None
        self._read_rings: Optional[List] = None
        self.read_fanout = 0      # replica sub-pulls issued
        self.stale_retries = 0    # stale/refused answers fallen through
        self.replica_failures = 0  # replica transport deaths
        if read_replicas is not None:
            groups = []
            for e in read_replicas:
                if isinstance(e, (list, tuple)):
                    g = [str(x) for x in e]
                else:
                    g = [x for x in str(e).split("|") if x]
                groups.append(g)
            if len(groups) != len(self._ep_lists):
                raise ValueError(
                    f"read_replicas must name one group per shard "
                    f"({len(self._ep_lists)}), got {len(groups)}")
            self._read_sets = [
                [{"ep": _parse_ep(x), "name": x, "sock": None,
                  "lock": threading.Lock(), "down_until": 0.0,
                  "fails": 0} for x in g] for g in groups]
            self._read_rings = [_build_ring(g) for g in groups]
            if self._max_lag is None:
                self._max_lag = 0
        if mode in ("async", "half_async"):
            self._drainer = threading.Thread(target=self._drain, daemon=True)
            self._drainer.start()

    # -- connection management -----------------------------------------
    def _ep(self, rank: int) -> Tuple[str, int]:
        return self._ep_lists[rank][self._active[rank]]

    def _eps_str(self, rank: int) -> str:
        return "|".join(f"{h}:{p}" for h, p in self._ep_lists[rank])

    def _connect_rank(self, rank: int) -> socket.socket:
        """Connect to the shard's active endpoint, rotating through the
        failover list; every attempt is bounded by the connect timeout.
        Raises :class:`PSConnectError` naming the endpoints when none
        accepts."""
        group = self._ep_lists[rank]
        plan = _chaos.active()
        last_err: Optional[Exception] = None
        for k in range(len(group)):
            idx = (self._active[rank] + k) % len(group)
            ep = group[idx]
            try:
                if plan is not None:
                    plan.check_connect(ep)
                s = socket.create_connection(
                    ep, timeout=self._connect_timeout)
                if idx != self._active[rank]:
                    self._active[rank] = idx
                    self.failovers += 1
                    _monitor.stat_add("ps_client_failovers")
                return s
            except OSError as e:
                last_err = e
        raise PSConnectError(
            f"could not connect to PS shard {rank} "
            f"({self._eps_str(rank)}) within {self._connect_timeout}s: "
            f"{last_err}") from last_err

    def _reconnect_locked(self, rank: int) -> socket.socket:
        """(Re)establish the shard's data socket and re-register this
        worker on it — the new endpoint may be a freshly promoted
        standby that has never seen us.  Caller holds the rank lock.

        The socket is installed in ``_socks`` only once the register
        round trip has fully succeeded: a half-used socket (register
        sent, reply timed out) must never be reused by the next retry
        or a late register reply would be read as that RPC's reply,
        desyncing the request/reply stream."""
        sock = self._connect_rank(rank)
        try:
            if self.worker_id is not None:
                reg = {"op": "register", "worker": self.worker_id,
                       "src": self._src}
                with self._seq_lock:
                    reg["seq"] = next(self._seq)
                sock.settimeout(self._rpc_timeout)
                t_reg = time.time_ns()
                _send_msg(sock, reg)
                rep = _recv_msg(sock)
                if rep is None:
                    raise ConnectionError(
                        "server closed during re-register")
                self._raise_flagged(rep, rank, "register")
                _note_clock(rep, t_reg, time.time_ns())
        except BaseException:
            self._socks[rank] = None
            try:
                sock.close()
            except OSError:
                pass
            raise
        self._socks[rank] = sock
        return sock

    @staticmethod
    def _raise_flagged(rep, rank: int, op):
        """Raise on a flagged server error reply: ``fatal`` (handler
        error, e.g. unknown table) becomes a typed NON-retryable
        :class:`PSError`; ``retryable`` (un-promoted standby) becomes
        :class:`_StandbyReply` so the retry loop rotates endpoints."""
        if isinstance(rep, dict) and rep.get("ok") is False:
            if rep.get("fatal"):
                raise PSError(f"PS shard {rank} rejected {op!r}: "
                              f"{rep.get('error')}")
            if rep.get("retryable"):
                raise _StandbyReply(rep.get("error")
                                    or "standby not promoted")

    def _beat(self, interval: float):
        while not self._beat_stop.wait(interval):
            if self._stop.is_set():
                return
            for i, s in enumerate(self._beat_socks):
                if s is None:   # broken last beat: fresh connection
                    try:
                        s = socket.create_connection(self._ep(i),
                                                     timeout=2.0)
                        s.settimeout(2.0)
                        self._beat_socks[i] = s
                    except OSError:
                        continue
                try:
                    _send_msg(s, {"op": "heartbeat",
                                  "worker": self.worker_id})
                except (OSError, socket.timeout, ConnectionError):
                    # a timed-out sendall may have left a PARTIAL frame:
                    # reusing this socket would garble the length-prefixed
                    # stream and get a live worker falsely evicted. Drop
                    # it; reconnect on the next beat. One dead server must
                    # not stop beats to the healthy ones either.
                    try:
                        s.close()
                    except OSError:
                        pass
                    self._beat_socks[i] = None

    def _shard(self, ids: np.ndarray) -> np.ndarray:
        return np.asarray(ids) % len(self._socks)

    def pull(self, table: str, ids) -> np.ndarray:
        ids = np.asarray(ids).reshape(-1)
        if self._read_sets is not None and ids.size:
            ids = np.ascontiguousarray(ids, np.int64)
            if len(self._socks) == 1:
                return self._read_pull_shard(0, table, ids)
            shard = self._shard(ids)
            vals = None
            for r in range(len(self._socks)):
                m = shard == r
                if not m.any():
                    continue
                v = self._read_pull_shard(r, table,
                                          np.ascontiguousarray(ids[m]))
                if vals is None:
                    vals = np.empty((ids.size, v.shape[1]), np.float32)
                vals[m] = v
            return vals
        if len(self._socks) == 1 or ids.size == 0:
            # empty pulls still round-trip so the (0, dim) shape comes back
            return self._pull_post(self._rpc(0, self._pull_msg(table, ids),
                                             reply=True))
        shard = self._shard(ids)
        vals = None
        for r in range(len(self._socks)):
            m = shard == r
            if not m.any():
                continue
            v = self._pull_post(self._rpc(r, self._pull_msg(table, ids[m]),
                                          reply=True))
            if vals is None:
                vals = np.empty((ids.size, v.shape[1]), np.float32)
            vals[m] = v
        return vals

    def _pull_msg(self, table: str, ids) -> dict:
        """A bounded-read client stamps max_lag on EVERY pull — on the
        primary it is a no-op, and during a failover window it lets the
        caught-up-but-unpromoted standby answer instead of refusing."""
        op = {"row": "pull", "zc": "pull2", "q8": "pull_q8"}[
            self._pull_wire]
        msg = {"op": op, "table": table, "ids": ids}
        if self._max_lag is not None:
            msg["max_lag"] = self._max_lag
        return msg

    def _pull_post(self, rep: dict) -> np.ndarray:
        """Decode one pull reply into dense f32 rows, whatever the wire
        format: classic ``vals``; zero-copy ``{inv, vals_uniq}`` (the
        server shipped unique rows once, scatter back out); or int8
        ``{inv, codes, scales}`` (dequantize ``codes * scale`` —
        on-device serving paths dispatch the same math through the
        ops/pallas pull_dequant kernel instead)."""
        if "vals" in rep:
            return rep["vals"]
        inv = np.asarray(rep["inv"]).reshape(-1)
        if "vals_uniq" in rep:
            u = np.asarray(rep["vals_uniq"], np.float32)
        else:
            codes = np.asarray(rep["codes"], np.int8)
            scales = np.asarray(rep["scales"], np.float32)
            u = codes.astype(np.float32) * scales[:, None]
        return np.ascontiguousarray(u[inv])

    def pull_q8(self, table: str, ids):
        """Raw int8 wire pull: ``(codes int8 [n, dim], scales f32 [n])``
        aligned to ``ids`` order, WITHOUT dequantizing — for consumers
        that reconstruct on device (the heter cache's pull_dequant
        kernel), so the 4x byte saving survives past this client."""
        ids = np.ascontiguousarray(np.asarray(ids).reshape(-1), np.int64)
        msg = {"op": "pull_q8", "table": table, "ids": ids}
        if self._max_lag is not None:
            msg["max_lag"] = self._max_lag
        if len(self._socks) == 1 or ids.size == 0:
            rep = self._rpc(0, msg, reply=True)
            inv = np.asarray(rep["inv"]).reshape(-1)
            return (np.ascontiguousarray(
                        np.asarray(rep["codes"], np.int8)[inv]),
                    np.ascontiguousarray(
                        np.asarray(rep["scales"], np.float32)[inv]))
        shard = self._shard(ids)
        codes = None
        scales = np.empty(ids.size, np.float32)
        for r in range(len(self._socks)):
            m = shard == r
            if not m.any():
                continue
            rep = self._rpc(r, dict(msg, ids=ids[m]), reply=True)
            inv = np.asarray(rep["inv"]).reshape(-1)
            c = np.asarray(rep["codes"], np.int8)[inv]
            if codes is None:
                codes = np.empty((ids.size, c.shape[1]), np.int8)
            codes[m] = c
            scales[m] = np.asarray(rep["scales"], np.float32)[inv]
        return codes, scales

    # -- read fan-out ----------------------------------------------------
    def _read_pull_shard(self, rank: int, table: str,
                         ids: np.ndarray) -> np.ndarray:
        """Bounded-staleness pull of one shard's ids across its read
        replicas: partition by consistent hash, sub-pull each replica,
        fall through ring-order on stale/dead answers, and answer the
        residue from the primary group (full retry layer).  Never
        raises while anything within the bound is reachable."""
        ents = self._read_sets[rank]
        ring = self._read_rings[rank]
        n = ids.size
        result: Optional[np.ndarray] = None
        pending = np.arange(n)
        if ents:
            pos = _ring_positions(ring, ids)
            tried: set = set()
            while pending.size:
                now = time.monotonic()
                excluded = set(tried)
                excluded.update(j for j, e in enumerate(ents)
                                if e["down_until"] > now)
                if len(excluded) >= len(ents):
                    break
                own = np.empty(pending.size, np.int64)
                for i, p in enumerate(pending):
                    o = _ring_owner_from(ring, int(pos[p]), excluded)
                    own[i] = -1 if o is None else o
                leftover = []
                for j in np.unique(own):
                    j = int(j)
                    sel = pending[own == j]
                    if j < 0:
                        leftover.append(sel)
                        continue
                    try:
                        rep = self._replica_rpc(rank, j, {
                            "op": "pull", "table": table, "ids": ids[sel],
                            "max_lag": self._max_lag})
                    except _StaleRead:
                        self.stale_retries += 1
                        _monitor.stat_add("ps_read_stale_retry")
                        tried.add(j)
                        leftover.append(sel)
                        continue
                    except _ReplicaDown:
                        tried.add(j)
                        leftover.append(sel)
                        continue
                    v = rep["vals"]
                    if result is None:
                        result = np.empty((n, v.shape[1]), np.float32)
                    result[sel] = v
                pending = (np.concatenate(leftover) if leftover
                           else np.empty(0, np.int64))
        if pending.size:
            # every replica stale/down for these ids: the primary group
            # answers through the normal retry/failover layer
            try:
                rep = self._rpc(rank, self._pull_msg(table, ids[pending]),
                                reply=True)
            except PSUnavailable:
                # a bounded read found NOTHING within the bound — the
                # one outcome the serving tier treats as an incident
                _flight.record("ps.read_stale_exhausted", table=table,
                               shard=rank, n=int(pending.size),
                               stale_retries=self.stale_retries)
                _flight.maybe_dump("read_stale_exhausted")
                raise
            v = rep["vals"]
            if result is None:
                result = np.empty((n, v.shape[1]), np.float32)
            result[pending] = v
        return result

    def _replica_rpc(self, rank: int, j: int, msg) -> dict:
        """One-shot RPC to read replica ``j`` of shard ``rank`` — no
        internal retries: a failure marks the replica down (bounded
        backoff) and raises so the caller's fan-out falls through to
        the next ring member.  That fall-through IS the retry, which is
        what lets a reader pinned to a dead replica rotate without ever
        surfacing a failed read."""
        ent = self._read_sets[rank][j]
        plan = _chaos.active()
        self.read_fanout += 1
        _monitor.stat_add("ps_read_fanout")
        with ent["lock"]:
            sock = ent["sock"]
            try:
                if sock is None:
                    if plan is not None:
                        plan.check_connect(ent["ep"])
                    sock = socket.create_connection(
                        ent["ep"], timeout=self._connect_timeout)
                    ent["sock"] = sock
                sock.settimeout(self._rpc_timeout)
                _send_msg(sock, msg)
                rep = _recv_msg(sock)
                if rep is None:
                    raise ConnectionError("replica closed the connection")
            except (OSError, ConnectionError, socket.timeout) as e:
                ent["sock"] = None
                if sock is not None:
                    try:
                        sock.close()
                    except OSError:
                        pass
                ent["fails"] += 1
                ent["down_until"] = time.monotonic() + min(
                    0.25 * (2 ** min(ent["fails"] - 1, 5)), 5.0)
                self.replica_failures += 1
                _monitor.stat_add("ps_read_replica_failures")
                raise _ReplicaDown(
                    f"read replica {ent['name']} (shard {rank}): "
                    f"{e}") from e
            ent["fails"] = 0
            if isinstance(rep, dict) and rep.get("ok") is False:
                if rep.get("fatal"):
                    raise PSError(
                        f"read replica {ent['name']} rejected pull: "
                        f"{rep.get('error')}")
                # stale (beyond bound / unfresh stream) or un-promoted
                # refusal: a fresher source must answer instead
                raise _StaleRead(rep.get("error") or "stale")
            return rep

    def push(self, table: str, ids, grads):
        if self._mode == "read":
            raise PSError("read-mode PSClient is pull-only")
        ids = np.asarray(ids).reshape(-1)
        grads = np.asarray(grads, np.float32)
        if self._mode in ("async", "half_async"):
            self._q.put((table, ids, grads))
            return
        self._push_now(table, ids, grads, sync=True)

    def push_delta(self, table: str, ids, deltas, sync: bool = True,
                   wm: Optional[float] = None):
        """Raw additive push (server-side push_delta), sharded like
        pull — the primitive UtilBase's collectives build on.  ``wm``
        stamps the payload with its event-ingest time (``iwm``) so
        replicas can measure end-to-end freshness."""
        if self._mode == "read":
            raise PSError("read-mode PSClient is pull-only")
        ids = np.asarray(ids).reshape(-1)
        if ids.size == 0:
            # nothing to add: skip the RPC instead of shipping a
            # degenerate (0, 1)-reshaped payload that forgets the
            # table's true trailing dim
            return
        deltas = np.asarray(deltas, np.float32).reshape(len(ids), -1)

        def _msg(i, d):
            m = {"op": "push_delta", "table": table, "ids": i,
                 "deltas": d, "sync": sync}
            if wm is not None:
                m["iwm"] = float(wm)
            return m

        if len(self._socks) == 1:
            self._rpc(0, _msg(ids, deltas), reply=sync)
            return
        shard = self._shard(ids)
        for r in range(len(self._socks)):
            m = shard == r
            if not m.any():
                continue
            self._rpc(r, _msg(ids[m], deltas[m]), reply=sync)

    def push_stamped(self, table: str, ids, grads, seq: int,
                     src: Optional[str] = None,
                     wm: Optional[float] = None) -> bool:
        """Sync push carrying an EXPLICIT ``(src, seq)`` idempotency
        stamp instead of the client's internal counter.  A caller whose
        seq is a pure function of its input cursor (the streaming
        trainer: seq == event-batch index) gets exactly-once semantics
        ACROSS PROCESS RESTARTS: a replayed batch re-sends the same
        stamp and the server acks it as a duplicate without
        re-applying.  ``wm`` stamps the event-ingest watermark
        (``iwm``) through to the mutation stream.  Returns True when
        at least one shard actually applied (False == full replay)."""
        if self._mode == "read":
            raise PSError("read-mode PSClient is pull-only")
        ids = np.asarray(ids).reshape(-1)
        grads = np.asarray(grads, np.float32).reshape(len(ids), -1)
        src = src or self._src

        def _msg(i, g):
            m = {"op": "push", "table": table, "ids": i, "grads": g,
                 "sync": True, "src": src, "seq": int(seq)}
            if wm is not None:
                m["iwm"] = float(wm)
            return m

        applied = False
        if len(self._socks) == 1:
            rep = self._rpc(0, _msg(ids, grads), reply=True)
            return not (rep or {}).get("dup", False)
        shard = self._shard(ids)
        for r in range(len(self._socks)):
            m = shard == r
            if not m.any():
                continue
            rep = self._rpc(r, _msg(ids[m], grads[m]), reply=True)
            applied = applied or not (rep or {}).get("dup", False)
        return applied

    def geo_set(self, table: str, ids, vals, seqs, sites):
        raise NotImplementedError(f"PSClient.geo_set: {_ITEM6}")

    def _push_now(self, table, ids, grads, sync):
        if len(self._socks) == 1:
            self._rpc(0, {"op": "push", "table": table, "ids": ids,
                          "grads": grads, "sync": sync}, reply=sync)
            return
        shard = self._shard(ids)
        for r in range(len(self._socks)):
            m = shard == r
            if m.any():
                self._rpc(r, {"op": "push", "table": table, "ids": ids[m],
                              "grads": grads[m], "sync": sync}, reply=sync)

    def _drain(self):
        while not self._stop.is_set():
            try:
                table, ids, grads = self._q.get(timeout=0.1)
            except queue.Empty:
                continue
            try:
                # fire-and-forget frames (async contract); their seq
                # stamp still makes a send-path retry or a duplicated
                # delivery apply exactly once server-side, and
                # barrier() verifies the whole sent set against the
                # server's applied-seq window (a frame the kernel
                # buffered but a dying connection swallowed is LOST,
                # not retried — at-most-once until the barrier check
                # turns silent loss into an error)
                self._push_now(table, ids, grads, sync=False)
            except Exception as e:  # keep draining; surface at barrier()
                # keep the FIRST error — later cascade errors (every
                # queued push failing the same dead server) would mask
                # the root cause
                if self._push_err is None:
                    self._push_err = e
                else:
                    self._push_err_later += 1
            finally:
                self._q.task_done()

    def _note_sent(self, rank: int, seq: int):
        """Record an async mutation as sent-but-unconfirmed.  Bounded
        like the server's dedup window: seqs that old are unverifiable
        there anyway (they count as applied)."""
        with self._unconf_lock:
            s = self._unconfirmed[rank]
            s.add(seq)
            if len(s) > 2 * _SeqWindow.WINDOW:
                for old in sorted(s)[:len(s) - _SeqWindow.WINDOW]:
                    s.discard(old)

    def barrier(self):
        # flush the async queue (join waits for task_done, so in-flight
        # pushes count — q.empty() would race the drainer) then round-trip
        # every server
        self._q.join()
        if self._push_err is not None:
            err, self._push_err = self._push_err, None
            later, self._push_err_later = self._push_err_later, 0
            raise RuntimeError(
                f"async push failed before barrier"
                + (f" ({later} subsequent push failure(s) suppressed)"
                   if later else "")) from err
        for r in range(len(self._socks)):
            # fire-and-forget pushes only prove the kernel buffered
            # them; ask the server which of them it actually applied —
            # a connection that died after buffering loses frames with
            # no client-side error, and that loss must surface HERE,
            # not as silent at-most-once delivery
            with self._unconf_lock:
                pending = sorted(self._unconfirmed[r])
            msg = {"op": "barrier"}
            if pending:
                msg["confirm"] = pending
            rep = self._rpc(r, msg, reply=True)
            if pending:
                missing = rep.get("missing") or []
                with self._unconf_lock:
                    self._unconfirmed[r].difference_update(pending)
                if missing:
                    raise PSUnavailable(
                        f"{len(missing)} async push(es) to PS shard "
                        f"{r} ({self._eps_str(r)}) were lost before "
                        f"the server applied them (first lost seq "
                        f"{missing[0]})")

    def worker_barrier(self, timeout: Optional[float] = None):
        """Rendezvous with every live worker (sync-mode step barrier).

        Flushes this worker's async queue first so pushed grads are
        visible to whoever runs after the barrier.  Returns the list of
        workers evicted as dead; raises if the server reports failure
        (``on_dead="fail"`` or timeout).
        """
        if self.worker_id is None:
            raise RuntimeError("worker_barrier needs a client worker_id")
        self.barrier()  # flush async queue + per-server round trip
        # the server-side barrier legitimately blocks until every
        # worker arrives: the transport timeout must outlast it
        rpc_to = None if timeout is None else timeout + 10.0
        rep = self._rpc(0, {"op": "worker_barrier", "worker": self.worker_id,
                            "timeout": timeout}, reply=True,
                        timeout=rpc_to)
        if rep is None:
            raise RuntimeError("worker_barrier failed: server connection "
                               "closed while waiting")
        if not rep.get("ok"):
            raise RuntimeError(f"worker_barrier failed: {rep.get('error')}")
        return rep.get("evicted", [])

    def leave(self):
        """Gracefully deregister so barriers stop counting this worker."""
        if self.worker_id is None:
            return
        self._beat_stop.set()  # beats after unregister would re-register
        beater = getattr(self, "_beater", None)
        if beater is not None:
            # an in-flight beat landing after the unregister would
            # re-register the departed worker; bounded so a wedged
            # socket can't hang shutdown
            beater.join(timeout=5.0)
        for r in range(len(self._socks)):
            try:
                self._rpc(r, {"op": "unregister", "worker": self.worker_id},
                          reply=True)
            except (OSError, PSError):
                pass

    def stop_server(self):
        for r in range(len(self._socks)):
            try:
                self._rpc(r, {"op": "stop"}, reply=True)
            except (OSError, PSError):
                pass

    def server_stats(self, rank: int = 0) -> dict:
        """Fetch the server's fault-tolerance counters (applied pushes,
        duplicate acks, role) — the observable the chaos harness
        audits."""
        return self._rpc(rank, {"op": "stats"}, reply=True)

    def close(self):
        self._stop.set()
        self._beat_stop.set()
        rsocks = [] if self._read_sets is None else \
            [e["sock"] for g in self._read_sets for e in g]
        for s in self._socks + self._beat_socks + rsocks:
            if s is None:
                continue
            try:
                s.close()
            except OSError:
                pass

    def _rpc(self, rank, msg, reply=False, timeout=_UNSET):
        """One RPC with bounded retries.

        Mutating ops get a (src, seq) stamp ONCE — retries resend the
        same seq, so the server applies at most once.  Any transport
        failure drops the socket (a partial frame must never be
        resumed), backs off exponentially with jitter, reconnects —
        rotating to the shard's next endpoint after repeated failures —
        and re-sends, until ``max_retries``/``rpc_deadline`` surface a
        :class:`PSUnavailable`.
        """
        if self.worker_id is not None:
            # every RPC names its worker: data traffic is proof of life,
            # so pull/push-only clients (no beat thread) stay live
            msg.setdefault("worker", self.worker_id)
        if msg.get("op") in _MUTATING_OPS and "seq" not in msg:
            msg["src"] = self._src
            with self._seq_lock:
                msg["seq"] = next(self._seq)
        # client-side RPC span; its (trace, span) context rides the
        # frame header so the server's handler span parents under it.
        # Retries re-send the same context — the retried apply is the
        # same logical RPC.
        sp = (_trace.Span(f"ps.client.{msg.get('op')}", cat="rpc",
                          shard=rank)
              if _trace.enabled() else None)
        if sp is not None:
            msg[_TRACE_KEY] = [sp.trace, sp.span_id]
            sp.__enter__()
        mx = _monitor.metrics_enabled()
        t_rpc0 = time.perf_counter() if mx else 0.0
        # flight-recorder op: begin/end pair in the ring; an RPC wedged
        # mid-attempt (peer SIGKILLed, recv blocking) stays in the
        # in-flight table, which is how a stall-watchdog bundle names
        # the RPC it is stuck on
        tok = (_flight.begin("rpc", op=msg.get("op"), shard=rank)
               if _flight.enabled() else None)
        try:
            return self._rpc_attempts(rank, msg, reply, timeout)
        finally:
            if mx:
                _monitor.hist_observe(
                    "ps_rpc_ms", (time.perf_counter() - t_rpc0) * 1e3)
            if tok is not None:
                et = sys.exc_info()[0]
                _flight.end(tok, **({} if et is None
                                    else {"err": et.__name__}))
            if sp is not None:
                sp.__exit__(None, None, None)

    def _rpc_attempts(self, rank, msg, reply, timeout):
        rpc_to = self._rpc_timeout if timeout is _UNSET else timeout
        deadline = time.monotonic() + self._deadline
        attempt = 0
        last_err: Optional[Exception] = None
        group = self._ep_lists[rank]
        while True:
            try:
                with self._lock[rank]:
                    sock = self._socks[rank]
                    if sock is None:
                        sock = self._reconnect_locked(rank)
                    try:
                        sock.settimeout(rpc_to)
                        is_reg = msg.get("op") == "register"
                        t_reg = time.time_ns() if is_reg else 0
                        _send_msg(sock, msg)
                        if not reply:
                            if "seq" in msg:
                                # "sent" == kernel buffered; barrier()
                                # verifies actual delivery
                                self._note_sent(rank, msg["seq"])
                            return None
                        rep = _recv_msg(sock)
                        if rep is None:
                            raise ConnectionError(
                                "server closed the connection")
                        # fatal handler errors raise PSError out of the
                        # retry loop entirely (the stream is clean, the
                        # socket stays); a standby refusal falls into
                        # the except below like a down endpoint
                        self._raise_flagged(rep, rank, msg.get("op"))
                        if is_reg:
                            # register round trip doubles as the clock
                            # probe a trace merge aligns timelines with
                            _note_clock(rep, t_reg, time.time_ns())
                        return rep
                    except (OSError, ConnectionError, socket.timeout,
                            _StandbyReply):
                        # the stream may hold a partial frame — never
                        # reuse this socket
                        self._socks[rank] = None
                        try:
                            sock.close()
                        except OSError:
                            pass
                        raise
            except (OSError, ConnectionError, socket.timeout,
                    PSConnectError, _StandbyReply) as e:
                last_err = e
            attempt += 1
            now = time.monotonic()
            if attempt > self._max_retries or now >= deadline:
                op = msg.get("op")
                _flight.record("rpc.error", op=op, shard=rank,
                               attempts=attempt,
                               err=type(last_err).__name__
                               if last_err else None)
                err = PSUnavailable(
                    f"PS rpc {op!r} to shard {rank} "
                    f"({self._eps_str(rank)}) failed after {attempt} "
                    f"attempt(s): {last_err}")
                # typed-failure dump trigger (full flight mode only):
                # the bundle holds the retry/backoff history that led
                # here plus every peer's last-known clock edge
                _flight.maybe_dump("PSUnavailable")
                raise err from last_err
            self.retries += 1
            _monitor.stat_add("ps_client_retries")
            if attempt >= 2 and len(group) > 1:
                # the active endpoint keeps failing: fail over to the
                # next endpoint in the shard's list (promoted standby)
                self._active[rank] = (self._active[rank] + 1) % len(group)
                self.failovers += 1
                _monitor.stat_add("ps_client_failovers")
            delay = min(self._backoff * (2 ** (attempt - 1)), 1.0)
            delay *= 0.5 + 0.5 * self._jitter.random()
            if _monitor.metrics_enabled():
                _monitor.hist_observe("ps_backoff_ms", delay * 1e3)
            time.sleep(min(delay, max(0.0, deadline - now)))
