"""The end-to-end freshness SLO for the online loop (counterpart of
``paddle_tpu/online/freshness.py``).

"Fresh" has one definition here: an event ingested at time ``t`` is
servable at a replica once the mutation it produced has been applied
there.  Two gauges bound it, both fed by the REAL data path (no
synthetic probes):

- ``ps_replica_lag_seq`` — mutations behind the primary's commit head
  (the bounded-staleness gauge);
- ``ps_replica_lag_seconds`` — seconds behind the primary's commit
  wall clock, derived from the mutation-stream ``ts``/heartbeat
  timestamps.

Plus the distribution the bench reports: ``ps_freshness_ms``, the
per-record event-ingested -> applied-at-replica histogram observed by
replicas for pushes stamped with an ingest watermark (``iwm``).

:func:`freshness_objectives` declares the two gauge bounds as
:class:`~paddle_tpu_torch.observability.slo.SLO` objects — they plug into
any :class:`SloEngine` (the local registry or another snapshot
source).  :class:`FreshnessWatch` is the convenience wrapper: its own
engine plus a latched ``online.freshness_breach`` flight event on
every ok->breach transition, the BAD kind ``tools/postmortem.py``
sorts first when a stalled stream gets autopsied (the engine's own
``slo.breach`` event and ``maybe_dump`` bundle capture still fire —
this adds the online-loop-specific marker).
"""
from __future__ import annotations

from typing import List, Optional

from ..observability import flight_recorder as _flight
from ..observability.slo import SLO, SloEngine

__all__ = ["freshness_objectives", "FreshnessWatch"]


def freshness_objectives(max_lag_seq: int = 64,
                         max_lag_seconds: float = 2.0,
                         prefix: str = "online") -> List[SLO]:
    """The freshness SLO as declarative gauge bounds: breach the
    moment a replica's applied state falls more than ``max_lag_seq``
    mutations OR ``max_lag_seconds`` seconds behind the primary's
    head.  Gauge bounds are states, not budgets — no burn windows."""
    return [
        SLO(f"{prefix}_freshness_seq", kind="gauge_bound",
            metric="ps_replica_lag_seq", bound=float(max_lag_seq)),
        SLO(f"{prefix}_freshness_seconds", kind="gauge_bound",
            metric="ps_replica_lag_seconds",
            bound=float(max_lag_seconds)),
    ]


class FreshnessWatch:
    """A :class:`SloEngine` over :func:`freshness_objectives` that
    additionally records the ``online.freshness_breach`` flight marker
    on every ok->breach transition (latched, like the engine's own
    breach event) so an online-loop postmortem sorts the freshness
    failure first."""

    def __init__(self, max_lag_seq: int = 64,
                 max_lag_seconds: float = 2.0, source=None,
                 prefix: str = "online"):
        self.engine = SloEngine(
            freshness_objectives(max_lag_seq, max_lag_seconds,
                                 prefix=prefix),
            source=source)
        self._was_breached = False
        self.breaches = 0

    def evaluate(self, snapshot=None, now: Optional[float] = None):
        statuses = self.engine.evaluate(snapshot=snapshot, now=now)
        bad = [s for s in statuses if not s["ok"]]
        if bad and not self._was_breached:
            self.breaches += 1
            _flight.record("online.freshness_breach",
                           slos=[s["slo"] for s in bad],
                           values={s["slo"]: s.get("value")
                                   for s in bad})
        self._was_breached = bool(bad)
        return statuses

    def run_every(self, interval_s: float):
        """Background evaluation loop; returns a ``stop()``-able
        handle (mirrors ``SloEngine.run_every`` but through
        :meth:`evaluate` so the breach marker fires)."""
        import threading
        stop = threading.Event()
        watch = self

        class _Handle:
            def stop(self):
                stop.set()
                t.join(timeout=10.0)

        def _loop():
            while not stop.wait(interval_s):
                try:
                    watch.evaluate()
                except Exception:
                    continue

        t = threading.Thread(target=_loop, name="online-freshness",
                             daemon=True)
        t.start()
        return _Handle()
