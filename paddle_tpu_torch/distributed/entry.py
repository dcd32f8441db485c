"""Sparse-table feature admission entries (counterpart of
``paddle_tpu/distributed/entry.py``, the reference's ``entry_attr.py``).

Large recommendation tables do not materialise a row for every raw id:
an entry policy decides which ids earn a slot.  Consumed by
``fleet.ps.SparseTable(entry=...)``: ids not admitted pull zeros and
their gradients are dropped.  The two stock policies have twins inside
the native core (``ps_core.cc``: ``prob_admit`` and the count filter),
evaluated in the same directory probe; both sides admit the same ids.
"""
from __future__ import annotations

__all__ = ["ProbabilityEntry", "CountFilterEntry"]


class ProbabilityEntry:
    """Admit an id with probability p — deterministic per id (hash-based)
    so distributed workers agree without coordination (the reference
    rolls server-side, which is a single authority; hashing gives the
    same single-authority property shard-free)."""

    # admission is count-independent: tables must NOT keep per-id
    # sighting counters (a permanently rejected id would otherwise leak
    # a counter entry forever — the exact memory the entry exists to save)
    needs_count = False

    def __init__(self, probability: float):
        if not 0.0 <= probability <= 1.0:
            raise ValueError(f"probability must be in [0, 1], "
                             f"got {probability}")
        self.probability = probability

    def admit(self, id_: int, seen_count: int) -> bool:
        # splitmix64-style hash -> uniform [0, 1)
        h = (id_ * 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF
        h ^= h >> 31
        h = (h * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
        h ^= h >> 29
        return (h / 2 ** 64) < self.probability

    def _to_attr(self):
        return f"probability_entry:{self.probability}"


class CountFilterEntry:
    """Admit an id once it has been seen ``count_filter`` times
    (reference: show threshold before a feature gets an embedding)."""

    needs_count = True

    def __init__(self, count_filter: int):
        if count_filter < 0:
            raise ValueError(
                f"count_filter must be >= 0, got {count_filter}")
        self.count_filter = int(count_filter)

    def admit(self, id_: int, seen_count: int) -> bool:
        return seen_count >= self.count_filter

    def _to_attr(self):
        return f"count_filter_entry:{self.count_filter}"
