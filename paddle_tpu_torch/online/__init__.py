"""The online train -> serve loop (counterpart of ``paddle_tpu.online``).

An unbounded event feed trains the sparse tables on a PS primary, read
replicas serve the same tables, and stale features expire at the table:

- :class:`StreamingTrainer` (``streaming.py``): the unbounded-feed
  trainer over the iterable DataLoader path, with cursor-exact resume,
  cursor-derived idempotency stamps (exactly-once across kill and
  resume), per-batch ingest watermarks, and the pre-merge on the card
  (``merge_segments``: the sorted segment-sum kernel at vocab-scale
  unique counts);
- :class:`FeatureLifecycle` (``lifecycle.py``): the TTL sweep driver for
  ``PSServer.ttl_sweep``.

``FreshnessWatch`` and ``freshness_objectives`` (the freshness SLO over
``observability/slo.py``) are not ported yet: asking for either raises
``NotImplementedError`` naming ROADMAP.md item 6.
"""
from .lifecycle import FeatureLifecycle  # noqa: F401
from .streaming import StreamingTrainer  # noqa: F401

__all__ = ["StreamingTrainer", "FeatureLifecycle"]


def __getattr__(name):
    if name in ("FreshnessWatch", "freshness_objectives"):
        raise NotImplementedError(
            f"paddle_tpu_torch.online.{name} is not ported yet (ROADMAP.md "
            "item 6: the freshness SLO waits for observability/slo.py)")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
