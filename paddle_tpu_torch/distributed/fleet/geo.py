"""Geo-async replication: cross-cluster delta push for the PS tier
(counterpart of ``paddle_tpu/distributed/fleet/geo.py``).

Training clusters exchange *step deltas* instead of full state,
asynchronously (the reference's GeoCommunicator), so a WAN link's
latency and loss never sit on any cluster's commit path.

:class:`GeoPusher` runs next to a cluster's primary
:class:`~.ps_service.PSServer` and keeps a remote (follower) cluster
converged:

* a **commit listener** on the primary collects the ids each committed
  mutation touched (a set-union under the apply lock — O(batch), no
  values copied, nothing ever blocks on the WAN);
* a flush thread wakes every ``interval_s``: per table it takes up to
  ``max_ids_per_flush`` dirty ids (the per-table rate limit), reads
  their CURRENT rows straight from the primary's table, computes the
  delta against a local **mirror** of what the remote already holds,
  and ships one batched ``push_delta`` through a sync-mode
  :class:`~.ps_service.PSClient` — whose
  (src, seq)-stamped idempotent retries mean a lossy/delayed geo link
  can duplicate or re-send frames without EVER double-applying a delta;
* only after the remote acks does the mirror advance, so an
  unacknowledged flush is re-computed (same ids re-dirty, delta derived
  from the unchanged mirror) instead of lost.

The mirror is a :meth:`~.ps.SparseTable.clone_config` twin of the
primary table: the follower cluster's table
must be built from the same config, because a row's FIRST delta assumes
both sides materialise the identical deterministic init for that id.
The native table core guarantees per-id deterministic init; the pure
Python fallback only does for ``init_std=0`` (the constructor checks).

Bidirectional mode: run one :class:`GeoPusher` on EACH
cluster and the pair converges under concurrent writes — no flag
needed, the machinery is symmetric.  Two things make it sound:

* **echo suppression** — commits whose ``src`` carries the geo prefix
  (a peer pusher's replicated write) are never marked dirty, so a
  delta can't bounce between clusters forever;
* **conflict policy, per table** (``SparseTable(geo_policy=...)``):

  - ``"add"`` (default) — op-based additive merge: each side ships
    exactly its LOCAL writes; a peer delta applied locally also
    advances the mirror (buffered by the commit listener, drained
    atomically with the row read under the primary's apply lock, so
    the ``cur - mirror`` delta is always exactly the unshipped local
    writes — neither echoing a peer delta back nor missing one).
    Fixed point: both sides hold base + all local writes + all peer
    writes, each applied exactly once.  Bit equality across sites —
    also for INEXACT payloads — is enforced by a residual
    verify pass: once a table's local traffic quiesces, the AUTHORITY
    side (greater ``geo_site``, the LWW tie-break direction) pulls the
    peer's actual rows for every id that took part in a cross-site
    merge and ships the Sterbenz-exact ``cur - peer`` difference until
    the bits match — closing the ±1 ulp drift a local commit racing a
    peer's ship loop can leave behind (the mirror replays the peer's
    apply chain in commit order, so it cannot see that race);
  - ``"lww"`` — last-writer-wins per ``(lamport seq, site)`` stamp:
    local writes mint stamps on the server (the stamp directory
    replicates to standbys), the pusher ships ABSOLUTE rows via
    ``geo_set``, and the receiver replaces a row iff the incoming
    stamp strictly beats its stored one.  Fixed point: every site
    holds, per id, the row of the globally maximal stamp, bit-exactly.

Staleness / convergence bound: with a dirty backlog of ``B`` ids and a
per-table rate of ``R = max_ids_per_flush`` per ``interval_s``, the
follower trails the primary by at most ``ceil(B / R)`` flush intervals
once writes quiesce — :meth:`drain` makes that bound a blocking call
and the geo chaos test asserts it under an injected lossy link.

Observability: ``ps.geo.push`` flight events (a stall-watchdog progress
kind — a wedged geo link with a growing backlog is exactly the stall a
bundle should show), ``ps_geo_pushed_ids`` / ``ps_geo_flushes`` /
``ps_geo_push_failures`` counters and the ``ps_geo_backlog_ids`` gauge.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

import numpy as np

from ...framework import monitor as _monitor
from ...observability import flight_recorder as _flight
from .ps import SparseTable
from .ps_service import PSClient, PSError, PSUnavailable

__all__ = ["GeoPusher"]

# Lock order: the commit listener runs under the primary's apply lock
# and takes only the pusher's dirty-set lock (a leaf); the flush thread
# never calls back into the server while holding it.


class GeoPusher:
    """Asynchronous cross-cluster delta pusher (see module docstring).

    ``server``: the LOCAL cluster's primary :class:`PSServer` (the
    pusher reads committed rows straight from its tables).
    ``endpoints``: the REMOTE cluster's PS endpoints (one entry per
    shard, ``"h:p1|h:p2"`` failover groups supported) — or pass a
    ready-made ``client``.
    ``tables``: restrict replication to these table names (default: all
    tables the server holds when a mutation touches them).
    """

    def __init__(self, server, endpoints=None, tables=None,
                 interval_s: float = 0.05,
                 max_ids_per_flush: int = 65536,
                 src: Optional[str] = None,
                 client: Optional[PSClient] = None,
                 **client_kw):
        if client is None and endpoints is None:
            raise ValueError("GeoPusher needs remote endpoints or a "
                             "ready client")
        self._server = server
        # the client is created LAZILY: a geo link that is down when
        # the pusher starts must queue a backlog, not kill the ctor
        self._client = client
        self._endpoints = endpoints
        # site-named src when the server has one: the peer learns our
        # site from the prefix-stripped src, which the cross-site
        # residual verify pass needs to elect its authority
        site = getattr(server, "geo_site", None)
        self._src = src or (f"geo-{site}" if site is not None
                            else f"geo-{server.port}")
        self._client_kw = dict(client_kw)
        self._own_client = client is None
        self._tables = None if tables is None else set(tables)
        self._interval = float(interval_s)
        self._rate = int(max_ids_per_flush)
        self._lock = threading.Lock()
        self._dirty: Dict[str, set] = {}
        self._mirrors: Dict[str, SparseTable] = {}
        # bidirectional mode: a peer pusher's writes arrive with this
        # src prefix — they are never dirty (echo suppression), and on
        # additive tables their deltas buffer here so the mirror
        # advances in step with the local table (drained by flush()
        # atomically with the row read)
        self._peer_prefix = "geo-"
        self._inbound: Dict[str, List] = {}
        # cross-site residual verify: ids whose rows took
        # part in a cross-site additive merge (shipped or inbound) and
        # still await a bit-equality check against the PEER'S ACTUAL
        # rows.  The mirror replays the peer's apply chain in commit
        # order, so serialized flushes converge bit-exactly — but a
        # local commit racing inside the peer's ship loop leaves the
        # receiver's row ±1 ulp off the shipper's mirror with nothing
        # ever re-reading the real bits.  The AUTHORITY side (greater
        # geo_site, the LWW tie-break direction — one side only, so
        # corrections cannot bounce) drains this set once local traffic
        # quiesces: pull the peer's rows, ship the Sterbenz-exact
        # ``cur - peer`` residual, done when the bits match.
        self._xsite: Dict[str, set] = {}
        self._peer_site: Optional[str] = None
        self.verified_ids = 0
        self.corrected_ids = 0
        self._stop_evt = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._flush_lock = threading.Lock()   # flush() is not reentrant
        self.pushed_ids = 0
        self.flushes = 0
        self.push_failures = 0
        server.add_commit_listener(self._on_commit)

    # -- lifecycle ------------------------------------------------------
    def start(self) -> "GeoPusher":
        if self._thread is None:
            self._thread = threading.Thread(target=self._loop,
                                            name="geo-pusher",
                                            daemon=True)
            self._thread.start()
        return self

    def stop(self, drain: bool = True, timeout: float = 30.0):
        if drain:
            try:
                self.drain(timeout=timeout)
            except (PSError, PSUnavailable):
                pass   # remote gone: the backlog stays reported
        self._stop_evt.set()
        self._server.remove_commit_listener(self._on_commit)
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        if self._own_client and self._client is not None:
            self._client.close()

    def _ensure_client(self) -> PSClient:
        if self._client is None:
            self._client = PSClient(self._endpoints, mode="sync",
                                    worker_id=self._src,
                                    **self._client_kw)
        return self._client

    # -- commit feed (runs under PSServer._apply_lock) ------------------
    def _on_commit(self, rec):
        table = rec.get("table")
        if table is None or (self._tables is not None
                             and table not in self._tables):
            return
        op = rec.get("op")
        if op not in ("push", "push_delta", "geo_set"):
            return
        src = str(rec.get("src") or "")
        if src.startswith(self._peer_prefix):
            # a geo peer's replicated write: NEVER dirty (echo
            # suppression).  Additive tables buffer the delta so the
            # mirror advances in step with the table; LWW geo_sets need
            # nothing (the stamp directory already decided).
            if op == "push_delta":
                ids = np.array(rec["ids"], np.int64).reshape(-1)
                with self._lock:
                    if self._peer_site is None:
                        self._peer_site = src[len(self._peer_prefix):]
                    self._inbound.setdefault(table, []).append(
                        (ids, np.array(rec["deltas"], np.float32)))
                    self._xsite.setdefault(table, set()).update(
                        ids.tolist())
            return
        with self._lock:
            self._dirty.setdefault(table, set()).update(
                np.asarray(rec["ids"]).reshape(-1).tolist())

    def backlog(self) -> int:
        with self._lock:
            n = sum(len(s) for s in self._dirty.values())
            # unverified cross-site ids count only on the side that
            # will actually drain them, so drain() forces the verify
            # pass to completion without wedging the non-authority
            if self._is_authority():
                n += sum(len(s) for s in self._xsite.values())
            return n

    def _is_authority(self) -> bool:
        """True iff this side runs the cross-site residual verify:
        deterministically the GREATER geo_site (the same direction as
        the LWW site tie-break).  False until the peer's site is known
        (nothing cross-site has landed yet) or when the local server
        has no site name (unidirectional deployments: no verify, no
        behavior change)."""
        mine = getattr(self._server, "geo_site", None)
        peer = self._peer_site
        return (mine is not None and peer is not None
                and str(mine) > str(peer))

    # -- flush ----------------------------------------------------------
    def _mirror(self, table: str) -> SparseTable:
        m = self._mirrors.get(table)
        if m is None:
            src = self._server._tables[table]
            if not src.is_native and src._init_std != 0.0:
                raise PSError(
                    f"geo replication of table {table!r} needs per-id "
                    f"deterministic row init (native backend, or "
                    f"init_std=0): the python fallback's init depends "
                    f"on materialisation order, so the follower's init "
                    f"for a first-seen id would diverge")
            m = self._mirrors[table] = src.clone_config()
        return m

    def flush(self) -> int:
        """One flush pass: per table, ship up to the rate limit of
        dirty ids — deltas for additive tables, stamped absolute rows
        (``geo_set``) for LWW tables.  Returns how many ids were
        pushed.  A remote failure (typed, after the client's own retry
        budget) re-queues the ids and advances nothing — the delta
        stays derivable from the unmoved mirror."""
        with self._flush_lock:
            total = 0
            with self._lock:
                tables = sorted(set(t for t, s in self._dirty.items()
                                    if s)
                                | set(t for t, b in self._inbound.items()
                                      if b))
            for table in tables:
                src_t = self._server._tables[table]
                policy = getattr(src_t, "geo_policy", "add")
                with self._lock:
                    d = self._dirty.get(table) or set()
                    take = [d.pop() for _ in range(min(len(d),
                                                       self._rate))]
                ids = np.asarray(sorted(take), np.int64)
                # resolve the mirror BEFORE draining inbound: a config
                # error (non-deterministic python init) must surface
                # with the peer-delta buffer untouched and the dirty
                # ids re-queued
                try:
                    mirror = (self._mirror(table) if policy == "add"
                              else None)
                except PSError:
                    self.push_failures += 1
                    _monitor.stat_add("ps_geo_push_failures")
                    with self._lock:
                        self._dirty.setdefault(table, set()).update(
                            ids.tolist())
                    raise
                # pop-BEFORE-read: a commit landing between the pop and
                # the row read re-dirties the id (listener runs after
                # apply), so the next flush re-ships it — values can
                # lag one flush, never be lost.
                # The row read, the LWW stamp read, and the inbound
                # drain happen UNDER THE APPLY LOCK: no commit can
                # interleave, so every buffered peer delta's effect is
                # in ``cur`` and ``cur`` holds no unbuffered one —
                # without this a racing peer delta would be echoed back
                # (double-apply) or subtracted out (loss).
                stamps = None
                with self._server._apply_lock:
                    cur = (src_t.pull(ids) if ids.size else
                           np.zeros((0, src_t.dim), np.float32))
                    if policy == "lww":
                        # stamps live in the table's native directory;
                        # -1 = never stamped -> default to (0, our site)
                        sq, si = src_t.geo_get(ids)
                        stamps = [
                            (int(sq[i]),
                             self._server._site_name(int(si[i])))
                            if sq[i] >= 0
                            else (0, self._server.geo_site)
                            for i in range(ids.size)]
                    with self._lock:
                        inbound = self._inbound.pop(table, [])
                try:
                    if policy == "lww":
                        n_pushed = self._ship_lww(table, ids, cur,
                                                  stamps)
                    else:
                        # peer deltas already committed locally advance
                        # the mirror in commit order, preserving the
                        # invariant cur - mirror == unshipped LOCAL
                        # writes
                        for i_ids, i_deltas in inbound:
                            mirror.push_delta(i_ids, i_deltas)
                        n_pushed = self._ship(table, mirror, ids, cur)
                except (PSError, PSUnavailable):
                    # remote outage / config error: re-queue, never
                    # drop — the mirror did not advance past anything
                    # unacked, so the retry re-derives the same deltas
                    self.push_failures += 1
                    _monitor.stat_add("ps_geo_push_failures")
                    with self._lock:
                        self._dirty.setdefault(table, set()).update(
                            ids.tolist())
                    raise
                total += n_pushed
                if n_pushed:
                    self.pushed_ids += n_pushed
                    self.flushes += 1
                    _monitor.stat_add("ps_geo_flushes")
                    _monitor.stat_add("ps_geo_pushed_ids", n_pushed)
                    _flight.record("ps.geo.push", table=table,
                                   n=int(n_pushed), policy=policy,
                                   backlog=self.backlog())
                # ship rounds are exactly the drift window the verify
                # pass exists for: anything we just pushed awaits a
                # cross-site bit check (authority side only)
                if n_pushed and policy == "add" and ids.size:
                    with self._lock:
                        if self._is_authority():
                            self._xsite.setdefault(table, set()).update(
                                ids.tolist())
            total += self._verify_pass()
            if _monitor.metrics_enabled():
                _monitor.gauge_set("ps_geo_backlog_ids", self.backlog())
            return total

    def _verify_pass(self) -> int:
        """Authority-side stage of flush(): bit-verify quiesced
        cross-site ids against the peer's ACTUAL rows (see the _xsite
        comment in __init__).  Runs only for tables with no local
        dirty/inbound traffic — during active shipping the rows differ
        legitimately, and correcting then would just thrash."""
        if not self._is_authority():
            mine = getattr(self._server, "geo_site", None)
            with self._lock:
                # non-authority (or unidentifiable) side never drains
                # the set — drop it instead of growing without bound
                if self._xsite and (mine is None
                                    or self._peer_site is not None):
                    self._xsite.clear()
            return 0
        with self._lock:
            quiet = [t for t in list(self._xsite)
                     if self._xsite.get(t)
                     and not self._dirty.get(t)
                     and not self._inbound.get(t)]
        corrected = 0
        for table in quiet:
            corrected += self._verify_xsite(table)
        return corrected

    def _verify_xsite(self, table: str) -> int:
        with self._lock:
            pend = self._xsite.get(table) or set()
            take = [pend.pop() for _ in range(min(len(pend),
                                                  self._rate))]
        if not take:
            return 0
        ids = np.asarray(sorted(take), np.int64)
        try:
            mirror = self._mirror(table)
            # peer pull FIRST, then the local read: a local commit
            # landing in between joins the residual harmlessly — the
            # mirror advances by exactly what ships, so the normal
            # path's ``cur - mirror`` still covers only unshipped
            # writes (nothing double-applies)
            peer_rows = self._ensure_client().pull(table, ids)
            src_t = self._server._tables[table]
            with self._server._apply_lock:
                cur = src_t.pull(ids)
            resid = (cur - peer_rows).astype(np.float32)
            bad = np.flatnonzero(np.any(resid != 0, axis=1))
            self.verified_ids += int(ids.size - bad.size)
            if bad.size == 0:
                return 0
            sub_ids = np.ascontiguousarray(ids[bad])
            sub = np.ascontiguousarray(resid[bad])
            self._ensure_client().push_delta(table, sub_ids, sub,
                                             sync=True)
            mirror.push_delta(sub_ids, sub)
        except (PSError, PSUnavailable):
            self.push_failures += 1
            _monitor.stat_add("ps_geo_push_failures")
            with self._lock:
                self._xsite.setdefault(table, set()).update(take)
            raise
        self.corrected_ids += int(bad.size)
        _monitor.stat_add("ps_geo_xsite_corrections", int(bad.size))
        _flight.record("ps.geo.push", table=table, n=int(bad.size),
                       policy="add-xsite-residual",
                       backlog=self.backlog())
        # a correction is Sterbenz-exact for ulp-scale gaps but a
        # racing write can reopen one: re-queue until the pull comes
        # back bit-equal
        with self._lock:
            self._xsite.setdefault(table, set()).update(
                sub_ids.tolist())
        return int(bad.size)

    def _ship_lww(self, table: str, ids: np.ndarray, cur: np.ndarray,
                  stamps) -> int:
        """Ship ABSOLUTE rows with their conflict stamps: the receiver
        replaces a row iff the stamp strictly beats its stored one, so
        concurrent writers converge to the globally maximal stamp's
        bits — no mirror, no residual pass."""
        if ids.size == 0:
            return 0
        seqs = np.asarray([s[0] for s in stamps], np.int64)
        sites = [s[1] for s in stamps]
        self._ensure_client().geo_set(table, ids, cur, seqs, sites)
        return int(ids.size)

    def _ship(self, table: str, mirror: SparseTable, ids: np.ndarray,
              cur: np.ndarray) -> int:
        """Push rows to BIT-EXACT convergence.  ``prev + (cur - prev)``
        does not telescope in f32, so after the main delta a residual
        pass ships ``cur - mirror`` again: the difference of two nearby
        floats is exactly representable (Sterbenz), so one or two
        corrections land the follower on the primary's exact bits.  The
        mirror advances only after the remote acked the same delta, and
        applies it through the identical ``push_delta`` add, so mirror
        == follower bit-for-bit at every point."""
        delta = (cur - mirror.pull(ids)).astype(np.float32)
        pushed = 0
        for _ in range(8):
            nz = np.flatnonzero(np.any(delta != 0, axis=1))
            if nz.size == 0:
                return pushed
            sub_ids = np.ascontiguousarray(ids[nz])
            sub = np.ascontiguousarray(delta[nz])
            self._ensure_client().push_delta(table, sub_ids, sub,
                                             sync=True)
            mirror.push_delta(sub_ids, sub)
            pushed = max(pushed, int(nz.size))
            delta = (cur - mirror.pull(ids)).astype(np.float32)
        # should be unreachable: re-queue whatever refused to converge
        with self._lock:
            self._dirty.setdefault(table, set()).update(
                ids[np.any(delta != 0, axis=1)].tolist())
        return pushed

    def _dirty_tables(self) -> List[str]:
        with self._lock:
            return [t for t, s in self._dirty.items() if s]

    def drain(self, timeout: float = 30.0):
        """Flush until the dirty backlog is empty (writes must have
        quiesced for this to terminate) — the convergence-bound
        primitive the geo tests block on."""
        deadline = time.monotonic() + timeout
        while True:
            self.flush()
            if self.backlog() == 0:
                return
            if time.monotonic() > deadline:
                raise PSUnavailable(
                    f"geo drain did not converge within {timeout}s "
                    f"({self.backlog()} dirty ids left)")

    def _loop(self):
        while not self._stop_evt.wait(self._interval):
            try:
                self.flush()
            except (PSError, PSUnavailable):
                # remote unreachable: backlog holds, retry next tick
                continue
