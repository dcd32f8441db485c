"""The online train -> serve loop (counterpart of ``paddle_tpu.online``).

An unbounded event feed trains the sparse tables on a PS primary, read
replicas serve the same tables, stale features expire at the table,
remote clusters converge through bidirectional geo replication
(``distributed/fleet/geo.py``), and the loop is held to an explicit
event-ingested -> servable-at-replica freshness SLO:

- :class:`StreamingTrainer` (``streaming.py``): the unbounded-feed
  trainer over the iterable DataLoader path, with cursor-exact resume,
  cursor-derived idempotency stamps (exactly-once across kill and
  resume), per-batch ingest watermarks, and the pre-merge on the card
  (``merge_segments``: the sorted segment-sum kernel at vocab-scale
  unique counts);
- :class:`FeatureLifecycle` (``lifecycle.py``): the TTL sweep driver for
  ``PSServer.ttl_sweep`` (on a tiered table the sweep demotes cold rows
  to the spill tier instead of evicting them);
- :func:`freshness_objectives` / :class:`FreshnessWatch`
  (``freshness.py``): the freshness SLO declared on
  ``observability/slo.py``'s engine over ``ps_replica_lag_seq`` and
  ``ps_replica_lag_seconds``.
"""
from .freshness import FreshnessWatch, freshness_objectives  # noqa: F401
from .lifecycle import FeatureLifecycle  # noqa: F401
from .streaming import StreamingTrainer  # noqa: F401

__all__ = ["StreamingTrainer", "FeatureLifecycle", "FreshnessWatch",
           "freshness_objectives"]
