"""DistributedTrainStep: the training step of the reference's
``distributed/fleet/dist_step.py`` over a mesh of ranks, and the elastic
data plane's deterministic ZeRO shard math, learning-rate schedules and
fused optimizer apply (the module's second half).

One call is one optimizer step: the forward and backward of
``loss_fn(*batch)`` on this rank's batch, the gradients' mean over the
data axes, then the optimizer's update of every parameter it holds (its
``grad_clip`` over all gradients first, then its weight decay and rule
parameter by parameter; the lr is read from the optimizer, a scheduler's
current value included).  The update writes into the parameters and the
optimizer state in place, one parameter at a time.

**Ranks.** A rank is a process (``init_parallel_env``); the step runs
over a :class:`~..mesh.Mesh` of ``dp`` x ``fsdp`` x ``pp`` x ``tp`` x
``sp`` ranks (``mesh=``, or the strategy's ``mesh_degrees`` over the
world).  Each rank's batch is
its shard of the global batch (``mesh.batch_spec``); the loss is the mean
over its rows, so the mean of the ranks' gradients is the gradient of the
global mean loss, which the reference's step takes.  The step returns
the global mean loss.  Without a process group the world is this one
process: no collective runs, and the step is the one-device step
bitwise.  At world 1 over a process group (one NCCL rank) every
gradient still crosses its one-rank all-reduce, which changes no bit.
Each rank's forward normalises its own rows (batch norm's statistics are
this rank's batch's, where the reference's span the global batch); the
floating buffers (the running statistics) are broadcast from the first
data rank after each step, as PyTorch's DDP does, so every rank holds
the same model.

**Model axes** (``tensor_parallel``, ``pipeline``, ``sequence_parallel``,
``hybrid_configs`` ``mp`` / ``pp`` / ``sep``).  A model built under the
mesh holds its blocks already (each parameter's ``dist_spec``: the
tensor-parallel layers' over ``tp``, the stacked decoder's layers over
``pp``; :mod:`..meta_parallel`, :mod:`..pipeline`), and its layers run
the collectives of the forward and backward themselves.  The step's part:

- a model that splits the sequence (``splits_sequence()``, the Llama
  model under ``sp`` above 1) gets this rank's block of dim 1 of every
  batch tensor of two or more dims: the step cuts it over ``sp``;
- a parameter that is whole on every rank of an axis where each rank
  computed only part of its gradient has its gradient summed over that
  axis: every parameter over ``sp`` when the sequence is split (each
  rank saw its own positions).  Over ``tp`` the region functions already
  leave equal gradients on the ranks, and over ``pp`` the pipeline sums
  its input's cotangent and hands the last stage's output cotangent to
  that stage alone, so the head and the embedding get the whole gradient
  on every stage;
- the loss the model returns is the same on every rank of ``tp``,
  ``pp`` and ``sp``, and the step returns its mean over the data axes;
- norms over a parameter split over ``tp`` or ``pp`` (and ``fsdp``) sum
  their squares over those axes (the clips, Lamb, Lars, the guard's
  health, float16's finite check).

**ZeRO** (``strategy.sharding``, ``sharding_configs.stage``).  Which rows
a rank holds is the reference's rule a parameter
(:mod:`..spec_layout`): the layer's annotation wins per dim, and
``fsdp`` splits the largest remaining dim it divides (of the whole
shape); a parameter with no such dim stays whole on every rank.

- stage 1: the gradients are all-reduced over the data axes; each rank
  updates its rows of each parameter with its rows of the optimizer
  state, and the rows are all-gathered back into the whole parameter;
- stage 2: the gradients are reduce-scattered over ``fsdp`` (then
  all-reduced over ``dp``), so a rank only ever holds its rows of them;
- stage 3: a rank also stores only its rows of each parameter (the
  parameter's ``data`` is its rows); the whole parameters are
  all-gathered before the forward and dropped after the backward.

At ``fsdp`` 1 no parameter is split and every stage is the plain step
bitwise.  Norms that span a split parameter (a global-norm or per-tensor
clip, Lamb's and Lars's trust ratios, the guard's health) sum their
squares over the ``fsdp`` ranks.

``sharding_configs.moment_dtype`` (float32, bfloat16, float16 or int8; a
typo raises ``ValueError``) is the at-rest dtype of the parameter-shaped
optimizer slots.  int8 is the reference's signed-sqrt q8 codec
(``optimizer/slot_codec.py``, per-row f32 scales under ``"<slot>@scale"``,
denominator slots rounded away from zero); a row split over ``fsdp``
takes its scale over the whole row.  Each parameter's slots are decoded
to f32, updated and encoded in turn, so the f32 scratch is one
parameter's.  ``sharding_configs.offload`` keeps every slot in pinned
host memory; each parameter's slots cross to the card for its update and
back (stream-ordered copies; the step waits for the last before it
returns, so the host reads this step's slots).  It raises on the CPU, refuses gradient
merge and DGC, and is ignored without ``strategy.sharding``, as in the
reference.

**DGC** (``strategy.dgc``, :mod:`.dgc`).  Steps below
``rampup_begin_step`` take the dense update exactly.  From there the
step compresses the global gradient once, as the reference's step does
(its data-axis sum is in the backward): the gradients' mean over the data
axes is corrected with momentum (DGC's ``u``), accumulated (``v``), the
top-k of ``|v|`` of each tensor kept (k = ``max(1, round(n (1 -
sparsity)))``, the sparsity stepped through ``dgc_configs.sparsity`` by
``rampup_stage_index``), the rest left as the residual, and the step
applies SGD (the optimizer's clip and weight decay kept) with the kept
entries.  ``u`` and ``v`` are the same on every rank.  DGC needs
Momentum or SGD, rejects Nesterov, and refuses float16 scaling, gradient
merge, ``guard_health`` and the model axes, as the reference does the
first four.  ``last_dgc_masks`` holds the last
compressed step's masks ({name: bool tensor}).

- ``strategy.amp``: every f32 master parameter is cast to the compute
  dtype inside the step (bfloat16, or float16 with ``amp_configs
  dtype="float16"``), so the model computes in it and the f32 gradients
  come out of the cast's backward; float batch tensors are cast too,
  and the loss is taken in f32.  float16 always runs the reference's
  loss scaling (``update_loss_scaling``): the gradients of ``loss *
  scale`` are divided by the scale; a step with a non-finite gradient
  (on any rank) leaves the parameters and the optimizer state bitwise as
  they were; with ``use_dynamic_loss_scaling`` the scale grows by
  ``incr_ratio`` after ``incr_every_n_steps`` finite steps in a row and
  shrinks by ``decr_ratio`` after ``decr_every_n_nan_or_inf`` bad steps
  in a row (static scaling keeps ``init_loss_scaling`` and still drops
  the bad steps).  The state ``(scale, good, bad)`` stays on the device
  (``amp_state``) and the skip is a device-side select, so the step
  makes no host sync of its own.
- ``strategy.recompute`` recomputes the whole forward during the
  backward (activation checkpointing of the step).
- ``strategy.gradient_merge`` (``k_steps``, ``avg``): the gradients of
  ``k_steps`` calls add up in f32 accumulators (this rank's), and every
  ``k_steps``-th call reduces and applies their sum (or mean, with
  ``avg``) and zeroes them.
- ``guard_health=True``: each call leaves ``train_guard``'s fused health
  vector ``[global_norm, nonfinite, loss]`` (an f32[3] device tensor,
  no host copy) on ``last_health``, for ``TrainGuard.check``, over the
  data axes' mean gradients and loss (the reference's global vector): on
  the plain step, over the unscaled f32 gradients (masked, with a count)
  on the float16 step, and over the accumulators after this call's add
  (reduced) on the gradient-merge step.

The forward runs under ``framework.step_context.loss_only()``: the step
keeps only the loss, so a model may skip outputs no one reads (the
Llama model's chunked LM loss returns no logits there), as the
reference's traced step drops them.

The model's buffers are never cast: they stay f32 under AMP, as the
reference threads its non-parameter state through the step uncast.  A
layer that updates a buffer in its forward does so once per step: the
recomputation under ``strategy.recompute`` runs with every buffer
restored afterwards to the value the step's forward left.  The
recomputation also replays the model's dropout generators (every
``torch.Generator`` held as a module's ``generator``) from their state at
the forward's start, so it draws the masks the forward drew.

The other toggles of the reference (``localsgd``, ``auto``, ...) raise
``NotImplementedError`` naming ROADMAP queue item 4.
"""
from __future__ import annotations

import math
from contextlib import contextmanager
from typing import Any, Dict, Optional

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ... import resolve_device
from ...framework.step_context import loss_only
from .. import mesh as mesh_mod
from ..collective import (ReduceOp, _all_gather, _all_reduce, _broadcast,
                          _reduce_scatter, _world_rank)
from ...optimizer.slot_codec import _SCALE_SUFFIX, _transform_slots
from ..spec_layout import get_layout, sharded_dim, split_axes
from .strategy import (IMPLEMENTED_TOGGLES, NOOP_TOGGLES,
                       DistributedStrategy, warn_noop_toggles)

__all__ = ["DistributedTrainStep", "LRSchedule", "make_lr_schedule",
           "zero_shard_ranges", "flatten_zero_state", "unflatten_zero_state",
           "zero_shard", "zero_unshard", "zero_reshard",
           "fused_optimizer_apply"]

_LATER = "is not ported yet (ROADMAP queue item 4)"

_MOMENT_DTYPES = {"float32": torch.float32, "fp32": torch.float32,
                  "bfloat16": torch.bfloat16, "bf16": torch.bfloat16,
                  "float16": torch.float16, "fp16": torch.float16,
                  "int8": torch.int8}


class _LossModule(nn.Module):
    """Holds the model as a child so ``functional_call`` can swap its
    parameters while ``loss_fn`` runs."""

    def __init__(self, model, loss_fn):
        super().__init__()
        self.model = model
        self._loss_fn = loss_fn

    def forward(self, *args):
        return self._loss_fn(*args)


def _select(keep_new, new, old):
    """``new`` where ``keep_new`` (a 0-d device bool) else ``old``,
    bitwise, for a tensor or a dict of them."""
    if isinstance(new, dict):
        return {k: _select(keep_new, v, old[k]) for k, v in new.items()}
    return torch.where(keep_new, new, old)


def _resolve_mesh(strategy, mesh):
    """The step's mesh: ``mesh`` (a :class:`~..mesh.Mesh`), else the
    installed mesh when it has the strategy's degrees, else a new one over
    the world; a one-process mesh when there is no process group."""
    from ..parallel import is_initialized
    if isinstance(mesh, mesh_mod.Mesh):
        if mesh.distributed or len(mesh.devices) == 1:
            return mesh
        mesh = list(mesh.devices)
    if mesh is not None:
        if len(mesh) > 1:
            raise NotImplementedError(
                f"a mesh of {len(mesh)} devices in one process: the port "
                "runs one process per rank (init_parallel_env, spawn or "
                "launch --nproc_per_node) and takes a Mesh over them")
        return None
    degrees = strategy.mesh_degrees()
    want = {k: v for k, v in degrees.items() if v not in (1, -1)}
    if not is_initialized():
        if want:
            raise ValueError(
                f"mesh degrees {want} need that many ranks: start them "
                "with init_parallel_env (spawn, launch --nproc_per_node)")
        return None
    cur = mesh_mod.get_mesh(create=False)
    if cur is not None and cur.distributed and all(
            cur.shape.get(k, 1) == v for k, v in want.items()):
        return cur
    return mesh_mod.init_mesh(degrees)


class DistributedTrainStep:
    """Compile (model, loss_fn, optimizer, strategy) into one step::

        step = DistributedTrainStep(model, loss_fn, opt, strategy)
        for x, y in loader:
            loss = step(x, y)

    ``mesh``: a :class:`~..mesh.Mesh` over the ranks, or None (module
    docstring); a collection of one device is accepted, more raise.
    ``guard_health`` leaves the step's health vector on ``last_health``.
    """

    def __init__(self, model, loss_fn, optimizer, strategy=None, mesh=None,
                 guard_health=False):
        strategy = strategy or DistributedStrategy()
        acfg = strategy.amp_configs
        self._amp = bool(strategy.amp)
        self._amp_dtype = (torch.bfloat16 if str(acfg["dtype"]) in
                           ("bfloat16", "bf16") else torch.float16)
        # float16 always scales; use_dynamic_loss_scaling only says
        # whether the scale moves
        self._use_scaling = self._amp and self._amp_dtype == torch.float16
        gm = strategy.gradient_merge_configs
        self._k_steps = int(gm["k_steps"]) if strategy.gradient_merge else 1
        self._gm_avg = bool(gm["avg"])
        self._use_dgc = bool(strategy.dgc)
        if self._use_dgc and (self._use_scaling or self._k_steps > 1):
            raise NotImplementedError(
                "strategy.dgc cannot combine with float16 loss scaling or "
                "gradient_merge (the reference treats DGC as its own meta "
                "optimizer too)")
        warn_noop_toggles(strategy)
        refused = [t for t in strategy.enabled()
                   if t not in IMPLEMENTED_TOGGLES + NOOP_TOGGLES]
        if refused:
            raise NotImplementedError(
                f"strategy toggles {refused}: {_LATER}; the port runs "
                f"{list(IMPLEMENTED_TOGGLES)}")
        if self._use_scaling and self._k_steps > 1:
            raise NotImplementedError(
                "float16 loss scaling (dynamic or static) + gradient_merge "
                "is not supported; use bfloat16 (no scaling needed)")
        if guard_health and self._use_dgc:
            raise NotImplementedError(
                "guard_health covers the plain, fp16-loss-scaling and "
                "gradient_merge steps; DGC's error-feedback accumulators "
                "still need a health-vector design")
        self._strategy = strategy
        self._recompute = bool(strategy.recompute)
        self._guard_health = bool(guard_health)
        self.last_health = None          # f32[3] device tensor a call
        self.last_dgc_masks = None
        self._opt = optimizer
        # align with the optimizer's parameter list (its state order)
        id2name = {id(p): n for n, p in model.named_parameters()}
        self._names = []
        for p in optimizer._parameter_list:
            n = id2name.get(id(p))
            if n is None:
                raise ValueError("optimizer holds a parameter that is not "
                                 "part of the model passed to "
                                 "DistributedTrainStep")
            self._names.append(n)
        self._params = list(optimizer._parameter_list)
        self._wrapper = _LossModule(model, loss_fn)
        self._model = model
        gens = (getattr(m, "generator", None) for m in model.modules())
        self._generators = list({id(g): g for g in gens
                                 if isinstance(g, torch.Generator)}.values())
        self._step_i = 0                 # calls so far
        self._accum = None               # gradient-merge accumulators
        self._dgc_state = None           # DGC's (u, v)
        # (loss scale, consecutive finite steps, consecutive bad steps)
        self.amp_state = None
        self._init_sharding(strategy, mesh)
        self._ready = False

    # -- the mesh and the ZeRO layout ----------------------------------
    def _init_sharding(self, strategy, mesh):
        sh = strategy.sharding_configs
        mdt = str(sh.get("moment_dtype", "float32")).lower()
        if mdt not in _MOMENT_DTYPES:
            # a typo here would silently keep f32 slots and fill the card
            # the knob was set to save
            raise ValueError(
                f"sharding_configs.moment_dtype={mdt!r} is not one of "
                f"{sorted(_MOMENT_DTYPES)}")
        on = bool(strategy.sharding)
        self._stage = int(sh["stage"]) if on else 0
        if self._stage not in (0, 1, 2, 3):
            raise ValueError(f"sharding_configs.stage={self._stage}: "
                             "ZeRO has stages 1, 2 and 3")
        self._moment_dtype = _MOMENT_DTYPES[mdt] if on else torch.float32
        self._offload = bool(sh.get("offload", False)) if on else False
        if self._offload:
            dev = self._params[0].device if self._params else None
            if dev is None or dev.type != "cuda":
                raise NotImplementedError(
                    "sharding_configs.offload=True streams the slots between "
                    "pinned host memory and the card, which the CPU has "
                    "not; use sharding_configs.moment_dtype='bfloat16' for "
                    "the in-memory alternative")
            if self._k_steps > 1 or self._use_dgc:
                raise NotImplementedError(
                    "sharding_configs.offload does not compose with "
                    "gradient_merge or DGC (the optimizer-state round "
                    "trip cannot be gated per micro-step); use "
                    "moment_dtype='bfloat16'/'int8' instead")
        if self._use_dgc:
            from ...optimizer import SGD, Momentum
            if not isinstance(self._opt, (Momentum, SGD)):
                raise ValueError(
                    "strategy.dgc requires a Momentum or SGD optimizer "
                    "(parity: the reference's DGCMomentumOptimizer)")
            if getattr(self._opt, "_nesterov", False):
                raise NotImplementedError(
                    "strategy.dgc does not support use_nesterov=True "
                    "(DGC's u-accumulator implements plain momentum)")
        self._mesh = _resolve_mesh(strategy, mesh)
        m = self._mesh
        self._dist = bool(m is not None and m.distributed)
        g = (lambda ax: m.group(ax)) if self._dist else (lambda ax: None)
        self._group = g
        self._data_group = g(mesh_mod.DATA)
        self._dp_group = g("dp")
        self._fsdp_group = g("fsdp")
        self._n_data = m.axis_size(mesh_mod.DATA) if self._dist else 1
        self._fsdp = m.shape["fsdp"] if self._dist else 1
        self._fsdp_index = m.coords["fsdp"] if self._dist else 0
        lay = get_layout()
        seq = lay.act_axis("seq")
        self._sp = m.shape[seq] if self._dist and any(
            getattr(mod, "splits_sequence", lambda: False)()
            for mod in self._model.modules()) else 1
        self._sp_group = g(seq) if self._sp > 1 else None
        self.param_specs, self.slot_specs, self._dim = {}, {}, []
        # this rank's block of each parameter (its tp / pp block), the
        # whole shape and the axes its reduced gradient is split over
        self._full_shapes = [tuple(p.shape) for p in self._params]
        self._global_shapes = [tuple(getattr(p, "full_shape", p.shape))
                               for p in self._params]
        self._norm_axes = []
        live = (lambda ax: m.shape[ax] > 1) if self._dist else \
            (lambda ax: False)
        for n, p, shape in zip(self._names, self._params,
                               self._global_shapes):
            ann = getattr(p, "dist_spec", None)
            pspec = (lay.zero3_augment(shape, ann, self._fsdp)
                     if self._stage >= 3 else
                     tuple(ann) if ann is not None
                     else lay.replicated(len(shape)))
            sspec = lay.moment_spec(shape, ann, pspec, self._stage,
                                    self._fsdp)
            self.param_specs[n], self.slot_specs[n] = pspec, sspec
            self._dim.append(sharded_dim(sspec))
            self._norm_axes.append(tuple(a for a in split_axes(sspec)
                                         if live(a)))
        self._sharded = [d is not None for d in self._dim]
        self._sum_fns = {}
        model_axes = {a for axes in self._norm_axes for a in axes} - {"fsdp"}
        if self._use_dgc and (model_axes or self._sp > 1):
            raise NotImplementedError(
                "strategy.dgc over a model split over tp, pp or sp is not "
                "ported (ROADMAP queue item 4): DGC runs over dp x fsdp")

    def _rows(self, t, d):
        size = t.shape[d] // self._fsdp
        return t.narrow(d, self._fsdp_index * size, size)

    def _row_max(self, i):
        """The maximum over the ranks that split parameter ``i``'s last
        dim (its int8 rows' scales span them), or None."""
        last = self.slot_specs[self._names[i]][-1:] or (None,)
        axes = [a for a in split_axes(last) if a in self._norm_axes[i]]
        if not axes:
            return None

        def mx(t):
            for a in axes:
                _all_reduce(t, ReduceOp.MAX, self._group(a))
            return t
        return mx

    def _sum_over(self, axes):
        """The function that sums a tensor in place over ``axes`` (one per
        set of axes, so a clip groups its norms by it), or None."""
        if not axes:
            return None
        if axes not in self._sum_fns:
            def f(t, axes=axes):
                for a in axes:
                    _all_reduce(t, ReduceOp.SUM, self._group(a))
                return t
            self._sum_fns[axes] = f
        return self._sum_fns[axes]

    def _prepare(self):
        """Lay the state out on first use: stage 3 keeps each rank's rows
        of the split parameters; every parameter's slots are cut to its
        rows, put in their at-rest dtype and, with offload, in pinned host
        memory."""
        opt = self._opt
        with torch.no_grad():
            for i, p in enumerate(self._params):
                d = self._dim[i]
                if self._stage >= 3 and d is not None:
                    p.data = self._rows(p.data, d).clone()
                st = opt._state(p)
                full = self._full_shapes[i]
                if d is not None:
                    st = {k: (self._rows(v, d).clone()
                              if isinstance(v, torch.Tensor)
                              and tuple(v.shape) == full else v)
                          for k, v in st.items()}
                st = self._encode(i, st)
                if self._offload:
                    st = {k: v.detach().cpu().pin_memory()
                          if isinstance(v, torch.Tensor) else v
                          for k, v in st.items()}
                opt._accumulators[id(p)] = st
        if self._use_dgc:
            self._dgc_state = {ax: {n: torch.zeros(
                s, dtype=p.dtype, device=p.device) for n, s, p in zip(
                    self._names, self._full_shapes, self._params)}
                for ax in ("u", "v")}
        self._ready = True

    def _rows_shape(self, i):
        shape = list(self._full_shapes[i])
        d = self._dim[i]
        if d is not None:
            shape[d] //= self._fsdp
        return tuple(shape)

    def _encode(self, i, st):
        if self._moment_dtype == torch.float32:
            return st
        return _transform_slots(st, self._rows_shape(i), self._moment_dtype,
                                "encode", self._row_max(i))

    def _decode(self, i, st):
        if self._moment_dtype == torch.float32:
            return st
        return _transform_slots(st, self._rows_shape(i), self._moment_dtype,
                                "decode")

    def _stored_on_device(self, i):
        st = self._opt._accumulators[id(self._params[i])]
        if not self._offload:
            return st
        dev = self._params[i].device
        return {k: v.to(dev, non_blocking=True)
                if isinstance(v, torch.Tensor) else v for k, v in st.items()}

    def _store(self, i, stored):
        p = self._params[i]
        if not self._offload:
            self._opt._accumulators[id(p)] = stored
            return
        host = self._opt._accumulators[id(p)]
        for k, v in stored.items():
            if isinstance(v, torch.Tensor):
                host[k].copy_(v, non_blocking=True)

    def _gathered(self):
        """The whole parameters for the forward: stage 3 all-gathers each
        split parameter's rows (a tensor that takes gradients)."""
        if self._stage < 3 or not any(self._sharded):
            return self._params
        out = []
        with torch.no_grad():
            for p, d in zip(self._params, self._dim):
                if d is None:
                    out.append(p)
                    continue
                out.append(torch.cat(_all_gather(p.data, self._fsdp_group),
                                     dim=d))
        return [t if isinstance(t, nn.Parameter) else t.requires_grad_()
                for t in out]

    def full_parameters(self) -> Dict[str, torch.Tensor]:
        """Every parameter whole, by name (stage 3 gathers the rows)."""
        return {n: t.detach() for n, t in zip(self._names,
                                              self._gathered())}

    def _split_dim_of(self, i, shape):
        """The dim along which slot leaf of ``shape`` (whole, as the
        reference holds it) splits for parameter ``i``, or None: a
        parameter-shaped slot along the parameter's dim, a scale leaf
        along it unless it is the last (a row's scale spans the row)."""
        d, full = self._dim[i], self._full_shapes[i]
        if d is None:
            return None
        if tuple(shape) == full:
            return d
        if tuple(shape) == full[:-1] and d < len(full) - 1:
            return d
        return None

    def rows_of(self, i, array):
        """This rank's part of parameter ``i``'s whole slot leaf
        ``array`` (numpy or a tensor), by the spec rules."""
        d = self._split_dim_of(i, np.shape(array))
        if d is None:
            return array
        size = np.shape(array)[d] // self._fsdp
        idx = [slice(None)] * len(np.shape(array))
        idx[d] = slice(self._fsdp_index * size,
                       (self._fsdp_index + 1) * size)
        return array[tuple(idx)]

    def full_slots(self) -> Dict[str, Dict[str, torch.Tensor]]:
        """Every parameter's slots in their at-rest form, whole (the
        split ones all-gathered), by parameter name."""
        if not self._ready:
            self._prepare()
        out = {}
        for i, n in enumerate(self._names):
            st = self._stored_on_device(i)
            rows = self._rows_shape(i)
            whole = {}
            for k, v in st.items():
                d = None
                if isinstance(v, torch.Tensor) and self._dim[i] is not None:
                    if tuple(v.shape) == rows:
                        d = self._dim[i]
                    elif k.endswith(_SCALE_SUFFIX) and \
                            self._dim[i] < len(rows) - 1:
                        d = self._dim[i]
                whole[k] = v if d is None else torch.cat(
                    _all_gather(v, self._fsdp_group), dim=d)
            out[n] = whole
        return out

    def slot_bytes(self) -> Dict[str, int]:
        """The bytes of the optimizer's slot tensors this rank holds:
        ``{"device": ..., "pinned": ..., "host": ...}`` (host: unpinned
        CPU)."""
        out = {"device": 0, "pinned": 0, "host": 0}
        for p in self._params:
            for v in (self._opt._accumulators.get(id(p)) or {}).values():
                if not isinstance(v, torch.Tensor):
                    continue
                nb = v.numel() * v.element_size()
                if v.is_cuda:
                    out["device"] += nb
                elif v.is_pinned():
                    out["pinned"] += nb
                else:
                    out["host"] += nb
        return out

    # -- the forward and backward --------------------------------------
    def _amp_cast(self, t):
        if (self._amp and isinstance(t, torch.Tensor)
                and t.dtype == torch.float32):
            return t.to(self._amp_dtype)
        return t

    @contextmanager
    def _buffers_kept(self):
        """Restore every buffer on exit to its value on entry: the
        recomputed forward must not move the running statistics again."""
        bufs = list(self._wrapper.buffers())
        saved = [b.clone() for b in bufs]
        try:
            yield
        finally:
            with torch.no_grad():
                for b, v in zip(bufs, saved):
                    b.copy_(v)

    def _recompute_contexts(self):
        """The (forward, recomputation) contexts of ``checkpoint``: the
        recomputation starts the dropout generators where the forward
        started them, and leaves them and every buffer as the forward
        left them."""
        start = []

        @contextmanager
        def forward():
            start[:] = [g.get_state() for g in self._generators]
            yield

        @contextmanager
        def recompute():
            after = [g.get_state() for g in self._generators]
            for g, st in zip(self._generators, start):
                g.set_state(st)
            try:
                with self._buffers_kept():
                    yield
            finally:
                for g, st in zip(self._generators, after):
                    g.set_state(st)

        return forward(), recompute()

    def _loss(self, params, *args):
        """The f32 loss of ``loss_fn(*args)`` on the (cast) parameters,
        with its graph."""
        cast = [self._amp_cast(p) for p in params]
        args = tuple(self._amp_cast(a) for a in args)
        names = ["model." + n for n in self._names]

        def run(*ps):
            with loss_only():
                return torch.func.functional_call(
                    self._wrapper, dict(zip(names, ps)), args)

        if self._recompute:
            loss = checkpoint(run, *cast, use_reentrant=False,
                              context_fn=self._recompute_contexts)
        else:
            loss = run(*cast)
        return loss.float()

    def _grads(self, loss, params):
        return list(torch.autograd.grad(loss, params, allow_unused=True,
                                        materialize_grads=True))

    def _scaled_grads(self, loss, params):
        """float16: the gradients of ``loss * scale`` divided by the scale
        (f32), and the loss as the reference returns it, ``(loss *
        scale) / scale``."""
        scale = self._scale_state()[0]
        sl = loss * scale
        return [(g / scale).float() for g in self._grads(sl, params)], \
            sl.detach() / scale

    def loss_and_grads(self, *args):
        """This rank's f32 loss of ``loss_fn(*args)`` and the gradients of
        the optimizer's parameters (whole, f32 for f32 masters, unscaled,
        not reduced over the ranks), without a parameter update.  The
        forward does update the model's buffers (batch norm's running
        statistics) once, exactly as ``__call__`` does."""
        if not self._ready:
            self._prepare()
        args = self._cut_sequence(args)
        params = self._gathered()
        loss = self._loss(params, *args)
        if self._use_scaling:
            grads, loss = self._scaled_grads(loss, params)
            return loss, grads
        return loss.detach(), self._grads(loss, params)

    def _scale_state(self):
        if self.amp_state is None:
            dev = self._params[0].device
            acfg = self._strategy.amp_configs
            self.amp_state = (
                torch.tensor(float(acfg["init_loss_scaling"]),
                             dtype=torch.float32, device=dev),
                torch.zeros((), dtype=torch.int32, device=dev),
                torch.zeros((), dtype=torch.int32, device=dev))
        return self.amp_state

    # -- the collectives -------------------------------------------------
    @torch.no_grad()
    def _reduce(self, grads, whole=False):
        """The gradients' mean over the data axes (after their sum over
        ``sp`` when the sequence is split), in place of ``grads``: a split
        parameter's becomes its rows (stage 1: cut from the all-reduced
        gradient; stages 2-3: reduce-scattered over fsdp, then
        all-reduced over dp); ``whole``: every gradient whole."""
        n = self._n_data
        for i, g in enumerate(grads):
            if self._sp_group is not None:
                _all_reduce(g, ReduceOp.SUM, self._sp_group)
            d = None if whole else self._dim[i]
            if d is not None and self._stage >= 2:
                r = _reduce_scatter(g, d, self._fsdp_group)
                _all_reduce(r, ReduceOp.SUM, self._dp_group)
            else:
                r = _all_reduce(g, ReduceOp.SUM, self._data_group) \
                    if self._dist else g
                if d is not None:
                    r = self._rows(r, d)
            if n > 1:
                r = r.div_(n)
            grads[i] = r
        return grads

    def _mean_loss(self, loss):
        if self._n_data > 1:
            loss = _all_reduce(loss.clone(), ReduceOp.SUM,
                               self._data_group) / self._n_data
        return loss

    @torch.no_grad()
    def _sync_buffers(self):
        if self._n_data <= 1:
            return
        src = _world_rank(self._data_group, 0)
        for b in self._model.buffers():
            if b.is_floating_point():
                _broadcast(b, src, self._data_group)

    def _health(self, grads, loss, precise):
        """The health vector over the reduced gradients: a split
        parameter's squares and bad counts sum over the axes it is split
        over."""
        from ...train_guard import fused_health
        if not any(self._norm_axes):
            return fused_health(grads, loss=loss, precise=precise)
        groups = {}
        for g, axes in zip(grads, self._norm_axes):
            groups.setdefault(axes, []).append(g)
        whole = groups.pop((), None) or [
            torch.zeros((1,), device=loss.device)]
        hw = fused_health(whole, loss=loss, precise=precise)
        sq, bad = hw[0] * hw[0], hw[1]
        for axes, gs in groups.items():
            hs = fused_health(gs, loss=None, precise=precise)
            part = self._sum_over(axes)(torch.stack([hs[0] * hs[0], hs[1]]))
            sq, bad = sq + part[0], bad + part[1]
        if not precise:
            bad = (bad > 0).float()
        return torch.stack([torch.sqrt(sq), bad, hw[2]])

    def _finite(self, grads):
        finite = torch.stack([torch.isfinite(g).all() for g in grads]).all()
        # every axis some reduced gradient is split over
        axes = tuple(dict.fromkeys(a for ax in self._norm_axes for a in ax))
        if axes:
            bad = self._sum_over(axes)((~finite).float().reshape(1))
            finite = bad[0] == 0
        return finite

    # -- the update ------------------------------------------------------
    @torch.no_grad()
    def _apply(self, grads, finite=None, sgd=False):
        """The optimizer's update of every parameter (its rows where it is
        split), in place; with ``finite`` (a 0-d device bool) only where
        it holds, the rest bitwise kept; ``sgd``: DGC's SGD apply.
        Empties ``grads`` as it goes, so each gradient is freed once
        applied."""
        from ...optimizer.optimizers import _scalar
        opt = self._opt
        lr = opt.get_lr()
        # a norm over a split gradient sums its squares over its axes
        reduces = ([self._sum_over(a) for a in self._norm_axes]
                   if any(self._norm_axes) else None)
        grads[:] = opt._clip_values(grads, reduces)
        with torch.profiler.record_function("optimizer"):
            for i, p in enumerate(self._params):
                d = self._dim[i]
                rows = (self._rows(p, d) if d is not None
                        and self._stage in (1, 2) else p)
                g = grads[i]
                grads[i] = None
                if sgd:
                    if opt._weight_decay is not None:
                        g = opt._weight_decay.apply_gradient(rows, g)
                    new_p = rows - _scalar(lr, rows.dtype) * g.to(
                        rows.dtype)
                else:
                    stored = self._stored_on_device(i)
                    new_p, new_s = opt._apply_one(
                        rows, g, lr, self._decode(i, stored),
                        sq_reduce=self._sum_over(self._norm_axes[i]))
                    new_s = self._encode(i, new_s)
                    if finite is not None:
                        new_s = _select(finite, new_s, stored)
                    self._store(i, new_s)
                if finite is not None:
                    new_p = torch.where(finite, new_p, rows)
                rows.copy_(new_p)
                del new_p
                if rows is not p:
                    p.copy_(torch.cat(_all_gather(rows, self._fsdp_group),
                                      dim=d))
        if self._offload:
            # the slots' copies back to pinned memory are asynchronous: a
            # host reader of the optimizer's state after the step must
            # see them landed
            torch.cuda.current_stream(self._params[0].device).synchronize()

    @torch.no_grad()
    def _update_scale(self, finite):
        """The reference's ``update_loss_scaling`` on the device."""
        scale, good, bad = self.amp_state
        acfg = self._strategy.amp_configs
        if not acfg["use_dynamic_loss_scaling"]:
            return
        zero = torch.zeros_like(good)
        good = torch.where(finite, good + 1, zero)
        bad = torch.where(finite, zero, bad + 1)
        grow = good >= int(acfg["incr_every_n_steps"])
        shrink = bad >= int(acfg["decr_every_n_nan_or_inf"])
        scale = torch.where(grow, scale * float(acfg["incr_ratio"]),
                            torch.where(shrink,
                                        scale * float(acfg["decr_ratio"]),
                                        scale))
        self.amp_state = (scale, torch.where(grow, zero, good),
                          torch.where(shrink, zero, bad))

    @torch.no_grad()
    def _dgc_exchange(self, grads, i):
        """Compress the global gradients (step ``i``'s sparsity) into the
        kept entries, in place of ``grads``; keeps the residuals."""
        from .dgc import dgc_one, rampup_stage_index
        dcfg = self._strategy.dgc_configs
        mom = float(getattr(self._opt, "_momentum",
                            dcfg.get("momentum", 0.9)))
        spars = dcfg.get("sparsity", [0.999])
        spars = [float(s) for s in (spars if isinstance(
            spars, (list, tuple)) else [spars])]
        warm = int(dcfg.get("rampup_begin_step", 0))
        stage = min(max(rampup_stage_index(
            i, warm, int(dcfg.get("rampup_step", 1)), len(spars)), 0),
            len(spars) - 1)
        st = self._dgc_state
        masks = {}
        for j, n in enumerate(self._names):
            st["u"][n], st["v"][n], grads[j], mask = dgc_one(
                st["u"][n], st["v"][n], grads[j], mom, spars[stage])
            masks[n] = mask.bool()
        self.last_dgc_masks = masks
        return grads

    def _dgc_warm(self, i) -> bool:
        return i < int(self._strategy.dgc_configs.get(
            "rampup_begin_step", 0))

    def _cut_sequence(self, args):
        """This rank's block of dim 1 of every batch tensor of two or
        more dims, over ``sp`` (when the model splits the sequence)."""
        if self._sp <= 1:
            return args
        r = self._mesh.axis_index(get_layout().act_axis("seq"))

        def cut(a):
            if not isinstance(a, torch.Tensor) or a.dim() < 2:
                return a
            if a.shape[1] % self._sp:
                raise ValueError(f"a batch tensor's dim 1 of {a.shape[1]} "
                                 f"does not split over sp={self._sp}")
            n = a.shape[1] // self._sp
            return a[:, r * n:(r + 1) * n]
        return tuple(cut(a) for a in args)

    def __call__(self, *args):
        if not self._ready:
            self._prepare()
        args = self._cut_sequence(args)
        i = self._step_i
        self._step_i += 1
        params = self._gathered()
        loss = self._loss(params, *args)
        if self._use_scaling:
            grads, loss = self._scaled_grads(loss, params)
            del params
            with torch.no_grad():
                self._reduce(grads)
                loss = self._mean_loss(loss)
                finite = self._finite(grads)
                if self._guard_health:
                    self.last_health = self._health(grads, loss, True)
            self._apply(grads, finite)
            self._update_scale(finite)
            self._sync_buffers()
            return loss
        grads = self._grads(loss, params)
        del params
        loss = self._mean_loss(loss.detach())
        if self._k_steps <= 1:
            sgd = self._use_dgc and not self._dgc_warm(i)
            if sgd:
                # the global gradient, compressed once (the same on every
                # rank), then each rank's rows of it
                self._dgc_exchange(self._reduce(grads, whole=True), i)
                grads[:] = [g if d is None else self._rows(g, d)
                            for g, d in zip(grads, self._dim)]
            else:
                self._reduce(grads)
            if self._guard_health:
                with torch.no_grad():
                    self.last_health = self._health(grads, loss, False)
            self._apply(grads, sgd=sgd)
            self._sync_buffers()
            return loss
        with torch.no_grad():
            if self._accum is None:
                self._accum = [torch.zeros(s, dtype=p.dtype,
                                           device=p.device)
                               for s, p in zip(self._full_shapes,
                                               self._params)]
            for a, g in zip(self._accum, grads):
                a.add_(g)
            del grads
            if self._guard_health:
                acc = self._accum
                if self._dist:
                    acc = self._reduce([a.clone() for a in acc])
                self.last_health = self._health(acc, loss, False)
                del acc
        if self._step_i % self._k_steps == 0:
            if self._gm_avg:
                merged = [a / self._k_steps for a in self._accum]
            else:       # _reduce writes in place
                merged = [a.clone() if self._dist else a
                          for a in self._accum]
            self._apply(self._reduce(merged))
            for a in self._accum:
                a.zero_()
        self._sync_buffers()
        return loss


# -- deterministic ZeRO host-shard math (the elastic data plane) --------
#
# The elastic membership controller (fleet/elastic.py) partitions the
# GLOBAL flattened parameter / optimizer-state vector over the live
# worker set.  These helpers are the single source of truth for that
# partition: a reshard after a membership change is a PURE function of
# (global state, new world size), so an N->M transition loads exactly
# the shards a fresh M-worker run would load from the same checkpoint.
# The partition rule (contiguous ranges, remainder spread over the
# leading ranks) matches the reference's UtilBase.get_file_shard.

class LRSchedule:
    """t-indexed learning-rate schedule for the flat elastic optimizers.

    The value is a PURE function of the 1-based global step count
    ``t`` and the construction config -- no internal state, nothing to
    checkpoint beyond ``t`` itself (which the elastic checkpoints
    already carry as ``opt_t``).  That makes the schedule
    world-invariant BY CONSTRUCTION: every worker of every generation
    evaluates the identical f32 lr for step t, so an N->M reshard
    mid-schedule stays bit-exact with the fault-free run.

    Kinds (``warmup_steps`` prepends a linear ramp to all of them):

    ``constant``  ``base_lr``
    ``step``      ``base_lr * gamma ** ((t - warmup) // step_size)``
    ``cosine``    ``min_lr + (base_lr - min_lr) * (1 + cos(pi*p)) / 2``
                  with progress ``p = (t - warmup) / (total - warmup)``
                  clipped to [0, 1] (requires ``total_steps``)
    ``linear``    ``base_lr + (min_lr - base_lr) * p`` (same ``p``)

    Math runs in float64 and rounds ONCE to f32 at the end -- the same
    value on every host, every world size.
    """

    KINDS = ("constant", "step", "cosine", "linear")

    def __init__(self, kind: str, base_lr: float,
                 warmup_steps: int = 0,
                 total_steps: Optional[int] = None,
                 min_lr: float = 0.0, step_size: int = 1000,
                 gamma: float = 0.5):
        if kind not in self.KINDS:
            raise ValueError(f"lr schedule kind must be one of "
                             f"{self.KINDS}, got {kind!r}")
        if kind in ("cosine", "linear") and not total_steps:
            raise ValueError(f"{kind!r} schedule needs total_steps")
        if step_size < 1:
            raise ValueError("step_size must be >= 1")
        self.kind = kind
        self.base_lr = float(base_lr)
        self.warmup_steps = int(warmup_steps)
        self.total_steps = None if total_steps is None else \
            int(total_steps)
        self.min_lr = float(min_lr)
        self.step_size = int(step_size)
        self.gamma = float(gamma)

    def __call__(self, t: int) -> np.float32:
        t = int(t)
        w = self.warmup_steps
        if w > 0 and t <= w:
            return np.float32(self.base_lr * t / w)
        if self.kind == "constant":
            return np.float32(self.base_lr)
        if self.kind == "step":
            return np.float32(
                self.base_lr * self.gamma ** ((t - w - 1)
                                              // self.step_size))
        span = max(1, self.total_steps - w)
        p = min(1.0, max(0.0, (t - w) / span))
        if self.kind == "cosine":
            return np.float32(
                self.min_lr + (self.base_lr - self.min_lr)
                * 0.5 * (1.0 + math.cos(math.pi * p)))
        # linear
        return np.float32(
            self.base_lr + (self.min_lr - self.base_lr) * p)

    def __repr__(self):
        return (f"LRSchedule({self.kind!r}, base_lr={self.base_lr}, "
                f"warmup_steps={self.warmup_steps}, "
                f"total_steps={self.total_steps}, "
                f"min_lr={self.min_lr}, step_size={self.step_size}, "
                f"gamma={self.gamma})")


def make_lr_schedule(kind: str, base_lr: float, **kw) -> LRSchedule:
    """Build an :class:`LRSchedule`; accepts a plain config dict via
    ``make_lr_schedule(**cfg)`` (the launcher/worker-config spelling)."""
    return LRSchedule(kind, base_lr, **kw)


def zero_shard_ranges(total: int, world: int):
    """Contiguous ``[start, stop)`` ranges partitioning a flat
    length-``total`` vector over ``world`` ranks.  Covers every element
    exactly once for ANY (total, world) -- world need not divide total;
    ranks beyond ``total`` get empty ranges."""
    total, world = int(total), int(world)
    if world < 1:
        raise ValueError(f"world must be >= 1, got {world}")
    base, rem = divmod(total, world)
    out, start = [], 0
    for r in range(world):
        size = base + (1 if r < rem else 0)
        out.append((start, start + size))
        start += size
    return out


def flatten_zero_state(tree: Dict[str, Any]):
    """``{name: ndarray}`` -> ``(flat vector, meta)`` with a
    deterministic (sorted-name) layout.  ``meta`` is
    ``[(name, shape), ...]`` -- feed it back to
    :func:`unflatten_zero_state`.  All leaves must share one dtype (the
    elastic data plane is f32): mixing dtypes in one flat vector would
    silently upcast shards."""
    meta, parts, dtype = [], [], None
    for name in sorted(tree):
        v = np.asarray(tree[name])
        if dtype is None:
            dtype = v.dtype
        elif v.dtype != dtype:
            raise ValueError(
                f"flatten_zero_state needs one dtype; {name!r} is "
                f"{v.dtype}, expected {dtype}")
        meta.append((name, tuple(v.shape)))
        parts.append(v.reshape(-1))
    flat = (np.concatenate(parts) if parts
            else np.zeros(0, dtype or np.float32))
    return flat, meta


def unflatten_zero_state(flat: np.ndarray, meta) -> Dict[str, Any]:
    """Inverse of :func:`flatten_zero_state` (views into ``flat``)."""
    out, ofs = {}, 0
    for name, shape in meta:
        n = int(np.prod(shape)) if shape else 1
        out[name] = flat[ofs:ofs + n].reshape(shape)
        ofs += n
    if ofs != flat.size:
        raise ValueError(
            f"flat vector has {flat.size} elements, meta describes {ofs}")
    return out


def zero_shard(flat: np.ndarray, rank: int, world: int) -> np.ndarray:
    """Rank ``rank``'s contiguous shard of the global flat vector."""
    lo, hi = zero_shard_ranges(flat.size, world)[rank]
    return flat[lo:hi]


def zero_unshard(shards) -> np.ndarray:
    """Reassemble the global flat vector from rank-ordered shards."""
    shards = list(shards)
    return (np.concatenate([np.asarray(s).reshape(-1) for s in shards])
            if shards else np.zeros(0, np.float32))


def zero_reshard(shards, new_world: int):
    """Reshard rank-ordered shards from their current world size to
    ``new_world``: merge to the global vector, re-partition.  Pure --
    bit-exact round trips (N->M->N) and identical to what a fresh
    ``new_world`` run would shard from the same global vector."""
    flat = zero_unshard(shards)
    return [zero_shard(flat, r, new_world) for r in range(new_world)]


def _to_device(x, dev) -> torch.Tensor:
    a = np.ascontiguousarray(x, dtype=np.float32)
    if not a.flags.writeable:
        a = a.copy()
    return torch.from_numpy(a).to(dev)


def fused_optimizer_apply(kind: str, p: np.ndarray, g: np.ndarray,
                          slots: Dict[str, np.ndarray], *, t: int,
                          lr, betas=(0.9, 0.999), eps=1e-8,
                          momentum=0.9, device=None):
    """Fused one-pass optimizer apply over a flat ZeRO shard.

    Device analog of the flat elastic sgd/momentum/adam: the shard goes
    to ``device`` (default ``cuda``), one ``opt_apply`` call reads
    grad+param+moments and writes param+moments in one pass (the CUDA
    kernel on the card, its plain version on the CPU), and the results
    come back.  Strictly elementwise with every constant pinned to f32,
    so the update of a shard equals the same slice of the full-vector
    update, for any world size, and it is bitwise the numpy engine's.
    Adam's bias corrections are computed on the host from the global
    step exactly like the numpy engine.

    Takes and returns numpy, as the reference does:
    ``(new_param, new_slots_dict)`` as f32 arrays.
    """
    from ...ops.kernels.opt_apply import SLOTS, opt_apply, pack_hyper
    slot_names = SLOTS[kind]          # raises KeyError on unknown kind
    hyper = pack_hyper(kind, lr=lr, betas=betas, eps=eps,
                       momentum=momentum, t=t)
    dev = resolve_device(device)
    out = opt_apply(kind, _to_device(p, dev), _to_device(g, dev),
                    tuple(_to_device(slots[n], dev) for n in slot_names),
                    hyper)
    host = [o.cpu().numpy() for o in out]
    return host[0], dict(zip(slot_names, host[1:]))
