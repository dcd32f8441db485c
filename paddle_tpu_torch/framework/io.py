"""Carry weights and optimizer state across from a ``paddle_tpu`` model,
and read the port's back as numpy under the reference's names.

``arrays`` is ``{name: np.ndarray}`` as the JAX model's ``state_dict()``
gives it: parameters and persistent buffers (batch norm's ``_mean`` and
``_variance``, an int8 layer's ``qweight``, ``w_scale`` and ``bias``).
Linear weights are [in, out] on both sides (the port computes ``x @ w``),
so no transposes are needed.  Each array is cast to the dtype of the
tensor it lands in: bf16 arrays arrive as float32 numpy (this package
cannot import ``ml_dtypes``), int8 stays int8, and an f32 ``w_scale``
stays f32 in a bf16 model.

Tied parameters (one tensor under several names, as the translation
model's shared embedding ``src_embed.weight`` / ``trg_embed.weight``)
load from whichever of their names ``arrays`` holds: the reference's
``state_dict`` lists a tied parameter once.

Optimizer state is keyed by the parameter's name in the model
(``{name: {slot: array}}``, e.g. ``{"conv1.weight": {"velocity": ...}}``
for ``Momentum``), since both packages key it by parameter object.  It
carries the train step's at-rest slots in every ``moment_dtype``: int8
codes with their ``"<slot>@scale"`` scales bitwise, bf16 / f16 slots as
f32 arrays of their values.  Loading int8 codes into an optimizer that
keeps f32 slots decodes them.  With ``step=`` (a
``DistributedTrainStep`` under ZeRO) a rank loads the rows of each whole
array that the spec rules give it, and ``opt_state_arrays`` all-gathers
the split slots back into whole arrays.

A model built under a mesh over processes holds its block of each
parameter that a spec splits (``dist_spec``: the tensor-parallel layers'
over ``tp``, a stacked decoder's layers over ``pp``).
``load_jax_blocks`` loads a rank's blocks from the whole arrays (layers
``[s L / pp, (s + 1) L / pp)`` of a stacked parameter, the rank's block
of a dim split over ``tp``), and ``gather_blocks`` is its inverse: the
world's blocks of each array (one dict a rank, parameters or gradients)
assembled into the whole arrays by their specs and the ranks' mesh
coordinates.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

__all__ = ["load_jax_state_dict", "state_arrays", "opt_state_arrays",
           "load_jax_opt_state", "load_jax_blocks", "gather_blocks",
           "param_specs"]


def load_jax_state_dict(model: torch.nn.Module,
                        arrays: Mapping[str, np.ndarray]) -> None:
    """Copy ``arrays`` into ``model``'s parameters and persistent buffers
    in place.  Raises on any missing, extra or mis-shaped key, before
    anything is copied; a tied parameter needs one of its names."""
    own = model.state_dict(keep_vars=True)
    names = {}
    for name, t in own.items():
        names.setdefault(id(t), []).append(name)
    missing = sorted(n for n in set(own) - set(arrays)
                     if not any(a in arrays for a in names[id(own[n])]))
    extra = sorted(set(arrays) - set(own))
    if missing or extra:
        raise KeyError(f"state dict mismatch: missing={missing} "
                       f"extra={extra}")
    own = {n: p for n, p in own.items() if n in arrays}
    for name, p in own.items():
        shape = tuple(np.shape(arrays[name]))
        if shape != tuple(p.shape):
            raise ValueError(f"{name}: array shape {shape} != model "
                             f"shape {tuple(p.shape)}")
    with torch.no_grad():
        for name, p in own.items():
            a = np.ascontiguousarray(np.asarray(arrays[name]))
            p.copy_(torch.from_numpy(a).to(device=p.device, dtype=p.dtype))


def _numpy(t: torch.Tensor) -> np.ndarray:
    """A copy: a CPU tensor's ``numpy()`` shares its memory, which the
    next in-place update would change."""
    t = t.detach()
    if t.is_floating_point() and t.dtype != torch.float64:
        t = t.float()
    return np.array(t.cpu().numpy())


def state_arrays(model: torch.nn.Module):
    """``model``'s parameters and persistent buffers as ``{name: array}``
    (floats as f32), the names being the reference's."""
    return {k: _numpy(v) for k, v in model.state_dict().items()}


def _param_names(optimizer, model):
    id2name = {id(p): n for n, p in model.named_parameters()}
    names = []
    for p in optimizer._parameter_list:
        if id(p) not in id2name:
            raise ValueError("optimizer holds a parameter that is not part "
                             "of the model")
        names.append(id2name[id(p)])
    return names


def opt_state_arrays(optimizer, model: torch.nn.Module, step=None):
    """The optimizer's per-parameter state as ``{param name: {slot:
    array}}`` (floats as f32, int8 codes as int8); with ``step``, the
    whole arrays of a ZeRO-split state (a collective: every rank
    calls it)."""
    if step is not None:
        return {n: {k: _numpy(v) for k, v in st.items()}
                for n, st in step.full_slots().items()}
    return {n: {k: _numpy(v) for k, v in st.items()}
            for n, st in zip(_param_names(optimizer, model),
                             optimizer.opt_state())}


def _decode_codes(src, own):
    """int8 codes (with their scales) of slots ``own`` keeps as floats:
    decoded to f32."""
    src = dict(src)
    for k in [k for k in src if k.endswith("@scale")]:
        base = k[: -len("@scale")]
        if k in own or base not in own:
            continue
        q = np.asarray(src[base])
        if q.dtype == np.int8 and own[base].dtype != torch.int8:
            from ..optimizer.slot_codec import _q8_decode
            src[base] = _q8_decode(torch.from_numpy(q.copy()),
                                   torch.from_numpy(np.asarray(
                                       src[k], np.float32).copy())).numpy()
        del src[k]
    return src


def load_jax_opt_state(optimizer, model: torch.nn.Module, states,
                       step=None) -> None:
    """Load ``{param name: {slot: array}}`` (the JAX optimizer's state
    under the parameters' names, in any ``moment_dtype``) into
    ``optimizer``, each slot cast to the dtype and device of the slot it
    replaces (int8 codes and their scales bitwise).  With ``step``, each
    whole array is cut to this rank's rows first.  Raises on a missing or
    extra parameter or slot, or a shape mismatch, before anything is
    loaded."""
    names = _param_names(optimizer, model)
    if step is not None and not step._ready:
        step._prepare()
    own = optimizer.opt_state()
    if sorted(states) != sorted(names):
        raise KeyError(f"optimizer state mismatch: missing "
                       f"{sorted(set(names) - set(states))} extra "
                       f"{sorted(set(states) - set(names))}")
    new = []
    for i, (n, st) in enumerate(zip(names, own)):
        src = _decode_codes(states[n], st)
        if sorted(src) != sorted(st):
            raise KeyError(f"{n}: slots {sorted(src)} != {sorted(st)}")
        if step is not None:
            j = step._names.index(n)
            src = {k: step.rows_of(j, np.asarray(a)) for k, a in src.items()}
        for k, t in st.items():
            if tuple(np.shape(src[k])) != tuple(t.shape):
                raise ValueError(f"{n}.{k}: array shape "
                                 f"{tuple(np.shape(src[k]))} != "
                                 f"{tuple(t.shape)}")
        new.append({k: _placed(np.array(src[k]), t) for k, t in st.items()})
    optimizer.load_opt_state(new)


def _placed(a, like: torch.Tensor) -> torch.Tensor:
    t = torch.from_numpy(a).to(dtype=like.dtype)
    if like.device.type == "cpu" and like.is_pinned():
        return t.pin_memory()
    return t.to(device=like.device)


def param_specs(model: torch.nn.Module):
    """Each parameter's spec (``dist_spec``; whole: all None) by name."""
    return {n: tuple(getattr(p, "dist_spec", None) or (None,) * p.dim())
            for n, p in model.named_parameters()}


def load_jax_blocks(model: torch.nn.Module, arrays: Mapping[str, np.ndarray],
                    mesh=None) -> None:
    """:func:`load_jax_state_dict` from whole arrays into a model that
    holds blocks: each parameter takes its block of its array by its spec
    on ``mesh`` (default: the installed mesh)."""
    from ..distributed import mesh as mesh_mod
    from ..distributed.meta_parallel import block_of
    mesh = mesh or mesh_mod.get_mesh(create=False)
    specs = param_specs(model)
    cut = {}
    for n, a in arrays.items():
        a = np.asarray(a)
        cut[n] = (block_of(a, specs[n], mesh) if n in specs
                  and mesh is not None and mesh.distributed else a)
    load_jax_state_dict(model, cut)


def gather_blocks(blocks, specs, shape):
    """The whole arrays from a world's blocks: ``blocks[r]`` is rank r's
    ``{name: array}``, ``specs`` each name's spec (a dim entry: None, an
    axis name or a tuple of them), ``shape`` the mesh's axis sizes.  The
    ranks that hold the same block must agree on it."""
    from ..distributed.mesh import Mesh
    world = len(blocks)
    coords = [Mesh((), dict(shape), r, world).coords for r in range(world)]
    out = {}
    for n, spec in specs.items():
        first = np.asarray(blocks[0][n])
        spec = tuple(spec) + (None,) * (first.ndim - len(tuple(spec)))
        size = [first.shape[d] * _axes_size(spec[d], shape)
                for d in range(first.ndim)]
        whole, seen = np.zeros(size, first.dtype), {}
        for r in range(world):
            blk = np.asarray(blocks[r][n])
            idx = []
            for d, ax in enumerate(spec):
                i = _axes_index(ax, shape, coords[r])
                idx.append(slice(i * blk.shape[d], (i + 1) * blk.shape[d]))
            key = tuple((s.start, s.stop) for s in idx)
            if key in seen:
                if not np.array_equal(seen[key], blk):
                    raise ValueError(f"{n}: ranks {r} and another hold "
                                     "different values of one block")
                continue
            seen[key] = blk
            whole[tuple(idx)] = blk
        out[n] = whole
    return out


def _axes(ax):
    return () if ax is None else (tuple(ax) if isinstance(ax, (tuple, list))
                                  else (ax,))


def _axes_size(ax, shape):
    n = 1
    for a in _axes(ax):
        n *= int(shape.get(a, 1))
    return n


def _axes_index(ax, shape, coords):
    i = 0
    for a in _axes(ax):
        i = i * int(shape.get(a, 1)) + coords[a]
    return i
