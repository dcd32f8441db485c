"""Declarative SLOs with multi-window burn rates (counterpart of
``paddle_tpu/observability/slo.py``).

A dashboard full of metrics is not an objective; production serving
runs on a handful of explicit promises — "p99 TTFT under X ms", "shed
rate under Y%", "replica lag under Z mutations" — and pages when the
ERROR BUDGET burns too fast, not when a single sample spikes.  This
module is that layer, built directly on the snapshot shape
:mod:`~paddle_tpu_torch.framework.monitor` exports (any callable
returning that shape can be the engine's source, so a merged fleet
rollup makes the objectives fleet objectives).

Objectives (:class:`SLO`):

- ``kind="latency"`` — a histogram family + a bound: the good/bad
  split is "samples <= bound" using the le-bucket at or above the
  bound (exact for bounds on a bucket edge, documented-conservative
  otherwise).  ``budget`` is the allowed bad fraction — 0.01 means
  "p99 under bound".
- ``kind="error_rate"`` — bad-counter / total-counter (e.g. sheds /
  submitted), ``budget`` the allowed ratio.
- ``kind="gauge_bound"`` — a gauge must stay <= bound (e.g.
  ``ps_replica_lag_seq``); breaches immediately on the current value
  (no burn windows — a lag bound is a state, not a budget).

Burn-rate evaluation (the SRE multi-window pattern): for each
``(window_s, threshold)`` pair the engine takes the counter deltas
over the trailing window from its own sample history and computes
``burn = (bad/total) / budget`` — burn 1.0 means "exactly spending the
budget", 14.4 means "the whole 30-day budget in 2 days".  A breach
requires EVERY window to exceed its threshold (the short window makes
alerts fast, the long window keeps them from flapping) plus
``min_events`` total events in the longest window (no paging on 3
requests).  History shorter than a window degrades to since-first-
sample deltas — a cold engine can still breach, it just cannot
under-report by pretending the past was clean.

On an ok -> breach transition the engine records an ``slo.breach``
flight event and calls ``maybe_dump("SLOBreach:<name>")`` so full-mode
processes capture a postmortem bundle WITH the breach context (the
ring holds the recent request/serve/PS events; ``tools/postmortem.py``
sorts the breach first via ``_BAD_KINDS``).  Recovery records
``slo.recover``; repeated breach ticks do not re-fire (latched).
Current burn rates are published as labeled gauges
(``slo_burn_rate{slo="...",window="..."}``) and breach states as
``slo_breached{slo="..."}`` so the fleet's own /metrics shows the
objectives.

Imports nothing of a device runtime.
"""
from __future__ import annotations

import bisect
import time
from collections import deque
from typing import Deque, Dict, List, Optional, Sequence, Tuple

from ..framework import monitor as _monitor
from . import flight_recorder as _flight

__all__ = ["SLO", "SloEngine", "DEFAULT_WINDOWS"]

# (window_s, burn threshold): the classic fast+slow pair, scaled to
# service-minutes rather than SRE-handbook days — tune per deployment
DEFAULT_WINDOWS = ((60.0, 14.4), (300.0, 6.0))


class SLO:
    """One declarative objective (module docstring for the kinds)."""

    KINDS = ("latency", "error_rate", "gauge_bound")

    def __init__(self, name: str, kind: str, metric: str,
                 bound: Optional[float] = None,
                 total: Optional[str] = None,
                 budget: float = 0.01,
                 windows: Sequence[Tuple[float, float]]
                 = DEFAULT_WINDOWS,
                 min_events: int = 1,
                 labels: Optional[Dict] = None):
        if kind not in self.KINDS:
            raise ValueError(f"unknown SLO kind {kind!r} "
                             f"(want one of {self.KINDS})")
        if kind in ("latency", "gauge_bound") and bound is None:
            raise ValueError(f"SLO {name!r}: kind {kind!r} needs a "
                             "bound")
        if kind == "error_rate" and total is None:
            raise ValueError(f"SLO {name!r}: error_rate needs the "
                             "total counter name")
        if not 0.0 < float(budget) <= 1.0:
            raise ValueError(f"SLO {name!r}: budget must be in (0, 1]")
        self.name = str(name)
        self.kind = kind
        self.metric = str(metric)     # histogram / bad counter / gauge
        self.bound = None if bound is None else float(bound)
        self.total = total            # total counter (error_rate)
        self.budget = float(budget)
        self.windows = tuple((float(w), float(t)) for w, t in windows)
        if not self.windows and kind != "gauge_bound":
            raise ValueError(f"SLO {name!r}: needs >= 1 burn window")
        self.min_events = int(min_events)
        self.labels = dict(labels) if labels else None

    # -- snapshot -> cumulative (bad, total) ---------------------------
    def _series(self, snap: Dict, family: str) -> Dict:
        fam = snap.get(family, {})
        if self.labels:
            fam = snap.get("labeled", {}).get(family, {})
            ent = fam.get(self.metric, {})
            return {self.metric: ent.get(
                _monitor.label_key(self.labels))}
        return fam

    def counts(self, snap: Dict) -> Optional[Tuple[int, int]]:
        """Cumulative (bad, total) events in ``snap`` — the burn
        windows difference these.  None when the series is absent
        (nothing observed yet)."""
        if self.kind == "latency":
            h = self._series(snap, "histograms").get(self.metric)
            if not h:
                return None
            bounds = [le for le, _ in h["buckets"]]
            i = bisect.bisect_left(bounds, self.bound)
            good = h["buckets"][i][1] if i < len(bounds) else h["count"]
            return int(h["count"]) - int(good), int(h["count"])
        if self.kind == "error_rate":
            bad = self._series(snap, "counters").get(self.metric)
            tot = snap.get("counters", {}).get(self.total)
            if bad is None and tot is None:
                return None
            return int(bad or 0), int(tot or 0)
        return None                    # gauge_bound has no counts

    def gauge_value(self, snap: Dict) -> Optional[float]:
        v = self._series(snap, "gauges").get(self.metric)
        return None if v is None else float(v)


class SloEngine:
    """Evaluate a set of :class:`SLO`\\ s against a stream of metric
    snapshots (the local registry by default; pass another snapshot
    source, such as a fleet rollup, for fleet objectives)."""

    def __init__(self, slos: Sequence[SLO], source=None,
                 history_s: Optional[float] = None):
        names = [s.name for s in slos]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate SLO names in {names}")
        self.slos = list(slos)
        self._source = source or _monitor.metrics_snapshot
        max_w = max((w for s in self.slos for w, _ in s.windows),
                    default=300.0)
        self.history_s = float(history_s or (2.0 * max_w))
        # per-slo history of (ts_s, (bad, total)) cumulative samples
        self._hist: Dict[str, Deque[Tuple[float, Tuple[int, int]]]] = {
            s.name: deque() for s in self.slos}
        self._breached: Dict[str, bool] = {s.name: False
                                           for s in self.slos}
        self.breaches = 0

    # -- one tick ------------------------------------------------------
    def evaluate(self, snapshot: Optional[Dict] = None,
                 now: Optional[float] = None) -> List[Dict]:
        """One evaluation tick.  Returns one status dict per SLO:
        ``{"slo", "kind", "ok", "burn": {window: rate}, "value"}``.
        Breach transitions emit flight events + ``maybe_dump`` (module
        docstring)."""
        snap = snapshot if snapshot is not None else self._source()
        now = time.time() if now is None else float(now)
        out = []
        for slo in self.slos:
            if slo.kind == "gauge_bound":
                st = self._eval_gauge(slo, snap)
            else:
                st = self._eval_burn(slo, snap, now)
            self._transition(slo, st)
            out.append(st)
        return out

    def _eval_gauge(self, slo: SLO, snap: Dict) -> Dict:
        v = slo.gauge_value(snap)
        ok = v is None or v <= slo.bound
        return {"slo": slo.name, "kind": slo.kind, "ok": ok,
                "value": v, "bound": slo.bound, "burn": {}}

    def _eval_burn(self, slo: SLO, snap: Dict, now: float) -> Dict:
        cur = slo.counts(snap)
        hist = self._hist[slo.name]
        burn: Dict[str, float] = {}
        ok = True
        if cur is not None:
            hist.append((now, cur))
            while hist and now - hist[0][0] > self.history_s \
                    and len(hist) > 1:
                hist.popleft()
            breach_all = True
            events_long = 0
            for w, threshold in slo.windows:
                # oldest sample still inside the window; degrade to
                # the first sample when history is shorter
                base = hist[0]
                for ts, c in hist:
                    if now - ts <= w:
                        break
                    base = (ts, c)
                dbad = cur[0] - base[1][0]
                dtot = cur[1] - base[1][1]
                events_long = max(events_long, dtot)
                rate = (dbad / dtot) if dtot > 0 else 0.0
                b = rate / slo.budget
                burn[str(int(w))] = round(b, 4)
                if b < threshold:
                    breach_all = False
            ok = not (breach_all and events_long >= slo.min_events)
        return {"slo": slo.name, "kind": slo.kind, "ok": ok,
                "burn": burn,
                "value": (cur[0] / cur[1]) if cur and cur[1] else None}

    def _transition(self, slo: SLO, st: Dict):
        for w, b in st["burn"].items():
            _monitor.gauge_set("slo_burn_rate", b,
                               labels={"slo": slo.name, "window": w})
        _monitor.gauge_set("slo_breached", 0.0 if st["ok"] else 1.0,
                           labels={"slo": slo.name})
        was = self._breached[slo.name]
        if not st["ok"] and not was:
            self.breaches += 1
            _monitor.stat_add("slo_breaches",
                              labels={"slo": slo.name})
            _flight.record("slo.breach", slo=slo.name,
                           slo_kind=slo.kind, metric=slo.metric,
                           value=st.get("value"), burn=st["burn"],
                           bound=slo.bound)
            # full-mode processes capture the breach context as a
            # postmortem bundle (rate limited per reason inside)
            _flight.maybe_dump(f"SLOBreach:{slo.name}")
        elif st["ok"] and was:
            _flight.record("slo.recover", slo=slo.name)
        self._breached[slo.name] = not st["ok"]

    # -- background loop ----------------------------------------------
    def run_every(self, interval_s: float):
        """Spawn a daemon evaluating every ``interval_s`` seconds;
        returns a ``stop()``-able handle."""
        import threading
        stop = threading.Event()
        engine = self

        class _Handle:
            def stop(self):
                stop.set()
                t.join(timeout=10.0)

        def _loop():
            while not stop.wait(interval_s):
                try:
                    engine.evaluate()
                except Exception:
                    _monitor.stat_add("slo_eval_errors")

        t = threading.Thread(target=_loop, name="paddle-slo-engine",
                             daemon=True)
        t.start()
        return _Handle()
