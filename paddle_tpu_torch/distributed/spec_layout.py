"""The spec rules of ZeRO and the batch (counterpart of the reference's
``distributed/planner/spec_layout.py``, the methods the train step
uses): which dims of a parameter, an optimizer slot and a batch are
split over which mesh axes, and how many elements a rank then holds.

A spec is a plain tuple with one entry per dim: ``None`` (the dim is
whole on every rank), an axis name, or a tuple of axis names (the dim is
split over their product, the first axis outermost).  These are data:
the train step reads them to cut each rank's rows, and the same rules
size the state a rank holds (:meth:`SpecLayout.sharded_numel`).  The
rules are the reference's, entry for entry (``tests/test_torch_zero.py``
holds them to its ``SpecLayout`` on the proxy's and ``llama_tiny``'s
shapes).
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

__all__ = ["AXES", "SpecLayout", "get_layout", "sharded_dim"]

# canonical mesh axis order: batch-like axes first, then model axes
AXES = ("dp", "fsdp", "pp", "tp", "sp", "ep")

Spec = Tuple


class SpecLayout:
    """The reference's role registry, cut to the rules ZeRO and the batch
    need; stateless."""

    def replicated(self, ndim: int = 0) -> Spec:
        """Whole on every rank."""
        return (None,) * ndim

    def batch(self, ndim: int, data_axes: Sequence[str]) -> Spec:
        """dim 0 over the (live) data axes, the rest whole; dim 0 always
        carries the axis tuple, a 1-tuple too."""
        return (tuple(data_axes),) + (None,) * (ndim - 1)

    def zero3_augment(self, shape: Sequence[int],
                      annotated: Optional[Sequence], fsdp: int) -> Spec:
        """A parameter's spec under ZeRO-3: the layer's annotation wins
        per dim; ``fsdp`` also splits the largest remaining dim it
        divides (the first of equal sizes)."""
        ndim = len(shape)
        ent = list(annotated) if annotated is not None else [None] * ndim
        ent += [None] * (ndim - len(ent))
        if fsdp > 1:
            for d in sorted(range(ndim), key=lambda d: -shape[d]):
                if ent[d] is None and shape[d] % fsdp == 0 \
                        and shape[d] >= fsdp:
                    ent[d] = "fsdp"
                    break
        return tuple(ent)

    def moment_spec(self, shape: Sequence[int],
                    annotated: Optional[Sequence], param_spec: Spec,
                    zero_stage: int, fsdp: int) -> Spec:
        """A parameter-shaped optimizer slot: under stage 3 it follows
        its parameter; under stages 1-2 (parameters whole) it is still
        split over ``fsdp``; without ZeRO it follows the parameter."""
        if zero_stage >= 3:
            return param_spec
        if zero_stage >= 1:
            return self.zero3_augment(shape, annotated, fsdp)
        return param_spec

    def sharded_numel(self, shape: Sequence[int], spec: Spec,
                      axis_sizes: Dict[str, int]) -> int:
        """The elements one rank holds of an array of ``shape`` under
        ``spec`` (ceil per dim)."""
        n = 1
        for d, s in enumerate(shape):
            ax = spec[d] if d < len(spec) else None
            if ax is None:
                f = 1
            elif isinstance(ax, (tuple, list)):
                f = 1
                for a in ax:
                    f *= int(axis_sizes.get(a, 1))
            else:
                f = int(axis_sizes.get(ax, 1))
            n *= -(-int(s) // max(f, 1))
        return n


def sharded_dim(spec: Spec, axis: str = "fsdp") -> Optional[int]:
    """The dim ``spec`` splits over ``axis`` alone, or None."""
    for d, ax in enumerate(spec):
        if ax == axis:
            return d
    return None


_layout = SpecLayout()


def get_layout() -> SpecLayout:
    return _layout
