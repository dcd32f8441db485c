"""Feature lifecycle driver: TTL expiry sweeps for the PS tables
(counterpart of ``paddle_tpu/online/lifecycle.py``).

Ids stop appearing (expired sessions, delisted items) but their rows,
optimizer moments and admission counters would stay resident forever.
:class:`FeatureLifecycle` removes them.  Every ``interval_s`` it advances
each table's lifecycle clock to wall seconds and runs
``PSServer.ttl_sweep(cutoff = now - ttl_s)``, which, under the primary's
apply lock and so atomically with the mutation stream, evicts every id
whose last sighting (any pull / push / push_delta touch) predates the
cutoff, and forwards the evicted ids as an ``evict`` stream record so
replicas (hot standby and read replicas) drop the same rows.  Survivor
rows keep their exact bits.

Sightings are stamped at sweep-tick granularity (the table clock only
advances once per interval): an id is evicted between ``ttl_s`` and
``ttl_s + interval_s`` after its last touch.

Churn is observable: the ``ps_feature_admitted`` / ``ps_feature_evicted``
counters (published by the sweep) and ``ps.ttl_sweep`` flight events.

Run the sweeper only next to the primary: replicas receive evictions
through the stream, and a replica sweeping on its own clock would
diverge from the primary's row set.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, Optional

__all__ = ["FeatureLifecycle"]


class FeatureLifecycle:
    """Background TTL sweeper for a primary :class:`PSServer`.

    ``ttl_s``: seconds since last sighting after which an id expires.
    ``interval_s``: sweep cadence (also the sighting-stamp
    granularity).  ``tables``: restrict to these names (default: every
    table the server holds).  ``time_fn``: clock injection for
    deterministic tests (defaults to ``time.time``).
    """

    def __init__(self, server, ttl_s: float, interval_s: float = 1.0,
                 tables=None, time_fn=None):
        if ttl_s <= 0:
            raise ValueError(f"ttl_s must be positive, got {ttl_s}")
        self._server = server
        self._ttl = float(ttl_s)
        self._interval = float(interval_s)
        self._tables = None if tables is None else sorted(tables)
        self._time = time_fn or time.time
        self._stop_evt = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._primed: set = set()
        self.sweeps = 0
        self.evicted = 0

    def sweep_once(self, now: Optional[float] = None) -> Dict[str, int]:
        """One sweep pass; returns ``{table: evicted_count}``.  The
        heavy lifting (clock advance, apply-lock atomicity, stream
        forwarding, churn counters) lives in ``PSServer.ttl_sweep``.
        A table's FIRST pass grandfathers its existing population
        (``touch_all``): rows of unknown age — pre-sweeper history or
        a restored checkpoint — age from here, not from tick zero."""
        now = self._time() if now is None else now
        names = (self._tables if self._tables is not None
                 else sorted(self._server._tables))
        for name in names:
            t = self._server._tables.get(name)
            if t is None or name in self._primed \
                    or not hasattr(t, "touch_all"):
                continue
            t.touch_all(int(now * 1000.0))
            self._primed.add(name)
        out = self._server.ttl_sweep(now - self._ttl, now=now,
                                     tables=self._tables)
        self.sweeps += 1
        self.evicted += sum(out.values())
        return out

    def start(self) -> "FeatureLifecycle":
        if self._thread is None:
            self._thread = threading.Thread(target=self._loop,
                                            name="ps-ttl-sweeper",
                                            daemon=True)
            self._thread.start()
        return self

    def stop(self):
        self._stop_evt.set()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None

    def _loop(self):
        while not self._stop_evt.wait(self._interval):
            try:
                self.sweep_once()
            except Exception:
                # a transient sweep failure (e.g. mid-shutdown table
                # teardown) must not kill the sweeper thread
                continue
