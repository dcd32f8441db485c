"""Runtime stats registry + device memory monitoring (a copy of
``paddle_tpu/framework/monitor.py``).

- ``StatRegistry`` / ``stat_add`` <- the reference's platform/monitor.h:77
  StatRegistry + STAT_ADD counters.
- ``device_memory_stats``: PyTorch's caching allocator counters
  (``torch.cuda.memory_stats``) on a CUDA device, ``{}`` on the CPU.

Beyond int counters the registry carries **gauges** (last-written
float, e.g. a queue depth) and **fixed-bucket histograms** (cumulative
bucket counts + sum + count -- p50/p99 derivable without storing
samples, the Prometheus histogram model).  High-frequency observation
sites (per-RPC, per-request, per-step) gate themselves on
:func:`metrics_enabled` (``PADDLE_METRICS=1`` or :func:`enable_metrics`)
so the clean path stays untouched by default; rare-event
counters/gauges (retries, failovers, reshards) always record.

Every family accepts an optional ``labels={...}`` dict -- one series per
distinct label set, stored under a canonical sorted ``k="v"`` key
(exactly the Prometheus label syntax).  Labeled series live in SEPARATE
maps: the unlabeled snapshot stays byte-identical when no labeled series
exist (the ``"labeled"`` snapshot key only appears once one does).
"""
from __future__ import annotations

import bisect
import os
import threading
from typing import Dict, Optional, Sequence

__all__ = ["StatRegistry", "Histogram", "stat_add", "stat_get",
           "stat_reset", "get_all_stats", "stats_with_prefix",
           "gauge_set", "gauge_add", "gauge_get", "hist_observe",
           "get_histogram", "metrics_snapshot", "metrics_reset",
           "metrics_enabled", "enable_metrics", "label_key",
           "device_memory_stats", "max_memory_allocated",
           "memory_allocated"]

_lock = threading.Lock()

# opt-in switch for high-frequency metric observation sites
_metrics_on = os.environ.get("PADDLE_METRICS", "0") == "1"


def metrics_enabled() -> bool:
    return _metrics_on


def enable_metrics(on: bool = True):
    global _metrics_on
    _metrics_on = bool(on)


def label_key(labels: Dict[str, object]) -> str:
    """Canonical label-set key: sorted ``k="v"`` pairs joined by commas
    — exactly the inside of a Prometheus sample's ``{...}``, so the
    exposition side concatenates it verbatim and two processes agree on
    series identity (what the fleet aggregator merges on)."""
    return ",".join(f'{k}="{labels[k]}"' for k in sorted(labels))


class Histogram:
    """Fixed-bucket histogram (Prometheus model): per-bucket counts over
    static upper bounds plus an overflow bucket, running sum and count.
    Quantiles interpolate within the containing bucket — no per-sample
    storage, O(len(buckets)) memory forever."""

    # bounds chosen for millisecond latencies: 100us .. 10s
    DEFAULT_BUCKETS = (0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0,
                       100.0, 250.0, 500.0, 1000.0, 2500.0, 5000.0,
                       10000.0)

    __slots__ = ("bounds", "counts", "sum", "count")

    def __init__(self, buckets: Optional[Sequence[float]] = None):
        self.bounds = tuple(sorted(float(b) for b in
                                   (buckets or self.DEFAULT_BUCKETS)))
        self.counts = [0] * (len(self.bounds) + 1)   # [-1] = +Inf
        self.sum = 0.0
        self.count = 0

    def observe(self, value: float):
        v = float(value)
        # bisect_left: bucket upper bounds are INCLUSIVE (le semantics)
        self.counts[bisect.bisect_left(self.bounds, v)] += 1
        self.sum += v
        self.count += 1

    def percentile(self, q: float) -> float:
        """Quantile estimate (q in [0, 100]) by linear interpolation
        inside the containing bucket; the overflow bucket clamps to its
        lower bound (no upper bound exists to interpolate toward)."""
        if self.count == 0:
            return 0.0
        rank = (q / 100.0) * self.count
        cum = 0
        for i, c in enumerate(self.counts):
            if c == 0:
                continue
            if cum + c >= rank:
                if i >= len(self.bounds):         # overflow bucket
                    return self.bounds[-1]
                lo = 0.0 if i == 0 else self.bounds[i - 1]
                hi = self.bounds[i]
                frac = (rank - cum) / c
                return lo + (hi - lo) * min(max(frac, 0.0), 1.0)
            cum += c
        return self.bounds[-1]

    def snapshot(self) -> Dict:
        cum, buckets = 0, []
        for i, b in enumerate(self.bounds):
            cum += self.counts[i]
            buckets.append([b, cum])
        return {"buckets": buckets, "sum": self.sum,
                "count": self.count}

    @classmethod
    def from_snapshot(cls, snap: Dict) -> "Histogram":
        """Reconstruct a histogram from a ``snapshot()`` dict (the
        fleet aggregator's merged snapshots become queryable again —
        ``percentile()`` on the pooled fleet distribution)."""
        h = cls(buckets=[b for b, _ in snap["buckets"]] or None)
        prev = 0
        for i, (_, cum) in enumerate(snap["buckets"]):
            h.counts[i] = int(cum) - prev
            prev = int(cum)
        h.counts[-1] = int(snap["count"]) - prev
        h.sum = float(snap["sum"])
        h.count = int(snap["count"])
        return h


class StatRegistry:
    """Named monotonic/settable int64 counters (parity:
    platform/monitor.h:77; one global instance like the reference's
    singleton), plus float gauges and fixed-bucket histograms."""

    def __init__(self):
        self._stats: Dict[str, int] = {}
        self._gauges: Dict[str, float] = {}
        self._hists: Dict[str, Histogram] = {}
        # labeled series: family name -> {label_key -> value/Histogram}
        self._lstats: Dict[str, Dict[str, int]] = {}
        self._lgauges: Dict[str, Dict[str, float]] = {}
        self._lhists: Dict[str, Dict[str, Histogram]] = {}

    def add(self, name: str, delta: int = 1,
            labels: Optional[Dict] = None) -> int:
        if labels:
            lk = label_key(labels)
            with _lock:
                fam = self._lstats.setdefault(name, {})
                v = fam.get(lk, 0) + int(delta)
                fam[lk] = v
                return v
        with _lock:
            v = self._stats.get(name, 0) + int(delta)
            self._stats[name] = v
            return v

    def get(self, name: str, labels: Optional[Dict] = None) -> int:
        if labels:
            with _lock:
                return self._lstats.get(name, {}).get(
                    label_key(labels), 0)
        with _lock:
            return self._stats.get(name, 0)

    def set(self, name: str, value: int):
        with _lock:
            self._stats[name] = int(value)

    def reset(self, name: Optional[str] = None):
        with _lock:
            if name is None:
                self._stats.clear()
            else:
                self._stats.pop(name, None)

    def snapshot(self) -> Dict[str, int]:
        with _lock:
            return dict(self._stats)

    # -- gauges ---------------------------------------------------------
    def gauge_set(self, name: str, value: float,
                  labels: Optional[Dict] = None) -> float:
        v = float(value)
        if labels:
            with _lock:
                self._lgauges.setdefault(name, {})[label_key(labels)] = v
                return v
        with _lock:
            self._gauges[name] = v
            return v

    def gauge_add(self, name: str, delta: float = 1.0,
                  labels: Optional[Dict] = None) -> float:
        if labels:
            lk = label_key(labels)
            with _lock:
                fam = self._lgauges.setdefault(name, {})
                v = fam.get(lk, 0.0) + float(delta)
                fam[lk] = v
                return v
        with _lock:
            v = self._gauges.get(name, 0.0) + float(delta)
            self._gauges[name] = v
            return v

    def gauge_get(self, name: str, default: float = 0.0,
                  labels: Optional[Dict] = None) -> float:
        if labels:
            with _lock:
                return self._lgauges.get(name, {}).get(
                    label_key(labels), default)
        with _lock:
            return self._gauges.get(name, default)

    # -- histograms -----------------------------------------------------
    def observe(self, name: str, value: float,
                buckets: Optional[Sequence[float]] = None,
                labels: Optional[Dict] = None):
        with _lock:
            if labels:
                fam = self._lhists.setdefault(name, {})
                lk = label_key(labels)
                h = fam.get(lk)
                if h is None:
                    h = fam[lk] = Histogram(buckets)
            else:
                h = self._hists.get(name)
                if h is None:
                    h = self._hists[name] = Histogram(buckets)
            h.observe(value)

    def histogram(self, name: str,
                  labels: Optional[Dict] = None) -> Optional[Histogram]:
        with _lock:
            if labels:
                return self._lhists.get(name, {}).get(label_key(labels))
            return self._hists.get(name)

    def metrics_snapshot(self) -> Dict:
        """Point-in-time view of all three metric families — what the
        Prometheus exposition and the JSONL flusher render.  The
        ``"labeled"`` key appears ONLY once a labeled series exists, so
        label-free processes keep their exact pre-label snapshot shape
        (golden/flusher stability)."""
        with _lock:
            snap = {
                "counters": dict(self._stats),
                "gauges": dict(self._gauges),
                "histograms": {n: h.snapshot()
                               for n, h in self._hists.items()},
            }
            if self._lstats or self._lgauges or self._lhists:
                snap["labeled"] = {
                    "counters": {n: dict(f)
                                 for n, f in self._lstats.items()},
                    "gauges": {n: dict(f)
                               for n, f in self._lgauges.items()},
                    "histograms": {
                        n: {lk: h.snapshot() for lk, h in f.items()}
                        for n, f in self._lhists.items()},
                }
            return snap

    def metrics_reset(self):
        with _lock:
            self._stats.clear()
            self._gauges.clear()
            self._hists.clear()
            self._lstats.clear()
            self._lgauges.clear()
            self._lhists.clear()


_registry = StatRegistry()


def stat_add(name: str, delta: int = 1,
             labels: Optional[Dict] = None) -> int:
    """STAT_ADD analog.  ``labels`` selects one series of a labeled
    family (e.g. ``labels={"tenant": "a"}``)."""
    return _registry.add(name, delta, labels=labels)


def stat_get(name: str, labels: Optional[Dict] = None) -> int:
    return _registry.get(name, labels=labels)


def stat_reset(name: Optional[str] = None):
    _registry.reset(name)


def get_all_stats() -> Dict[str, int]:
    return _registry.snapshot()


def stats_with_prefix(prefix: str) -> Dict[str, int]:
    """Snapshot of every counter under a namespace (e.g. ``"guard_"``
    for train_guard's guard_skips/guard_rewinds/guard_blamed_rows) —
    the monitoring surface a dashboard scrapes per subsystem."""
    return {k: v for k, v in _registry.snapshot().items()
            if k.startswith(prefix)}


def gauge_set(name: str, value: float,
              labels: Optional[Dict] = None) -> float:
    return _registry.gauge_set(name, value, labels=labels)


def gauge_add(name: str, delta: float = 1.0,
              labels: Optional[Dict] = None) -> float:
    return _registry.gauge_add(name, delta, labels=labels)


def gauge_get(name: str, default: float = 0.0,
              labels: Optional[Dict] = None) -> float:
    return _registry.gauge_get(name, default, labels=labels)


def hist_observe(name: str, value: float,
                 buckets: Optional[Sequence[float]] = None,
                 labels: Optional[Dict] = None):
    """Record one sample into the named fixed-bucket histogram (created
    on first observe; ``buckets`` only applies then)."""
    _registry.observe(name, value, buckets, labels=labels)


def get_histogram(name: str,
                  labels: Optional[Dict] = None) -> Optional[Histogram]:
    return _registry.histogram(name, labels=labels)


def metrics_snapshot() -> Dict:
    return _registry.metrics_snapshot()


def metrics_reset():
    """Clear counters, gauges and histograms (tests / fresh scrape)."""
    _registry.metrics_reset()


def device_memory_stats(device=None) -> Dict[str, int]:
    """Per-device memory counters from PyTorch's CUDA caching allocator
    (``torch.cuda.memory_stats``), plus the reference's names
    ``bytes_in_use`` and ``peak_bytes_in_use``.  ``device``: ``None``
    (the current CUDA device when there is a card), an index, a
    ``"cuda:N"`` / ``"cpu"`` string or a ``torch.device``.  Returns {}
    on the CPU, which reports nothing."""
    import torch
    if device is None:
        if not torch.cuda.is_available():
            return {}
        dev = torch.device("cuda", torch.cuda.current_device())
    elif isinstance(device, int):
        dev = torch.device("cuda", device)
    else:
        dev = torch.device(device)
    if dev.type != "cuda":
        return {}
    stats = dict(torch.cuda.memory_stats(dev))
    stats["bytes_in_use"] = int(stats.get("allocated_bytes.all.current", 0))
    stats["peak_bytes_in_use"] = int(stats.get("allocated_bytes.all.peak",
                                               0))
    return stats


def memory_allocated(device=None) -> int:
    """bytes currently in use on the device (parity surface:
    paddle.device.cuda.memory_allocated)."""
    return int(device_memory_stats(device).get("bytes_in_use", 0))


def max_memory_allocated(device=None) -> int:
    """peak bytes in use (parity: paddle.device.cuda.max_memory_allocated).
    """
    return int(device_memory_stats(device).get("peak_bytes_in_use", 0))
