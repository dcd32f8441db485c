"""The spec rules of the mesh (counterpart of the reference's
``distributed/planner/spec_layout.py``, the methods the train step and
the parallel layers use): which dims of a parameter, an activation, an
optimizer slot and a batch are split over which mesh axes, and how many
elements a rank then holds.

Parameter roles (``param_spec``): ``embedding`` (vocab rows over
``tp``), ``col_linear`` / ``col_bias`` (output columns over ``tp``),
``row_linear`` (input rows over ``tp``), the Llama projections'
``attn_qkv`` / ``attn_out`` / ``mlp_in`` / ``mlp_out`` / ``logits`` and
the replicated ``norm`` / ``scalar``.  Activation roles (``act_axis``):
``batch`` over the data axes, ``attn_heads`` / ``kv_heads`` / ``col_out``
over ``tp``, ``seq`` over ``sp``, ``experts`` over ``ep``.  A layer-stacked
parameter (``stack``) puts its leading layer dim on ``stack_axis``
(``pp``), so each pipeline stage holds a contiguous block of layers.

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

from typing import Dict, Optional, Sequence, Tuple, Union

__all__ = ["AXES", "PARAM_ROLES", "ACT_ROLES", "STACK_AXIS", "SpecLayout",
           "get_layout", "sharded_dim", "split_axes"]

# canonical mesh axis order: batch-like axes first, then model axes
AXES = ("dp", "fsdp", "pp", "tp", "sp", "ep")

# role -> template: axis names or None a dim; dims beyond it are None
PARAM_ROLES: Dict[str, Tuple] = {
    "embedding":   ("tp", None),
    "attn_qkv":    (None, "tp"),
    "attn_out":    ("tp", None),
    "mlp_in":      (None, "tp"),
    "mlp_out":     ("tp", None),
    "logits":      (None, "tp"),
    "col_linear":  (None, "tp"),
    "col_bias":    ("tp",),
    "row_linear":  ("tp", None),
    "norm":        (),
    "scalar":      (),
}

# activation role -> the axis (or axis tuple) its dim splits over
ACT_ROLES: Dict[str, Union[str, Tuple[str, ...]]] = {
    "batch":      ("dp", "fsdp"),
    "attn_heads": "tp",
    "kv_heads":   "tp",
    "col_out":    "tp",
    "seq":        "sp",
    "experts":    "ep",
}

# the layer-stack axis: the stacked decoder's and the pipeline's leading
# dim
STACK_AXIS = "pp"

Spec = Tuple


class SpecLayout:
    """The reference's role registry; stateless."""

    param_roles = PARAM_ROLES
    act_roles = ACT_ROLES
    stack_axis = STACK_AXIS

    def param_spec(self, role: str, ndim: Optional[int] = None) -> Spec:
        """The spec of a parameter role; with ``ndim`` the template is
        padded with None to that rank."""
        try:
            tpl = self.param_roles[role]
        except KeyError:
            raise KeyError(f"unknown parameter role {role!r}; registered: "
                           f"{sorted(self.param_roles)}") from None
        ent = list(tpl)
        if ndim is not None:
            if len(ent) > ndim:
                raise ValueError(f"role {role!r} template {tpl} needs >= "
                                 f"{len(ent)} dims, got ndim={ndim}")
            ent += [None] * (ndim - len(ent))
        return tuple(ent)

    def act_axis(self, role: str):
        """The axis (or axis tuple) an activation role's dim splits
        over."""
        try:
            return self.act_roles[role]
        except KeyError:
            raise KeyError(f"unknown activation role {role!r}; registered: "
                           f"{sorted(self.act_roles)}") from None

    def stack(self, inner: Optional[Sequence], ndim: int) -> Spec:
        """A layer-stacked parameter: the leading dim on ``stack_axis``,
        the rest the per-layer annotation ``inner`` (padded with None)."""
        rest = (tuple(inner) if inner is not None
                else (None,) * (ndim - 1))
        rest = rest + (None,) * (ndim - 1 - len(rest))
        return (self.stack_axis,) + rest

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


def split_axes(spec: Spec):
    """Every axis ``spec`` splits a dim over, in dim order."""
    out = []
    for ax in spec:
        for a in (ax if isinstance(ax, (tuple, list)) else (ax,)):
            if a is not None and a not in out:
                out.append(a)
    return tuple(out)


_layout = SpecLayout()


def get_layout() -> SpecLayout:
    return _layout
