"""DistributedTrainStep: the one-device training step of the reference's
``distributed/fleet/dist_step.py``, and the elastic data plane's
deterministic ZeRO shard math, learning-rate schedules and fused
optimizer apply (the module's second half).

One call is one optimizer step: the forward and backward of
``loss_fn(*batch)``, then the optimizer's update of every parameter it
holds (its ``grad_clip`` over all gradients first, then its weight decay
and rule parameter by parameter; the lr is read from the optimizer, a
scheduler's current value included).  The update writes into the
parameters and the optimizer state in place, one parameter at a time.

- ``strategy.amp``: every f32 master parameter is cast to the compute
  dtype inside the step (bfloat16, or float16 with ``amp_configs
  dtype="float16"``), so the model computes in it and the f32 gradients
  come out of the cast's backward; float batch tensors are cast too,
  and the loss is taken in f32.  float16 always runs the reference's
  loss scaling (``update_loss_scaling``): the gradients of ``loss *
  scale`` are divided by the scale; a step with a non-finite gradient
  leaves the parameters and the optimizer state bitwise as they were;
  with ``use_dynamic_loss_scaling`` the scale grows by ``incr_ratio``
  after ``incr_every_n_steps`` finite steps in a row and shrinks by
  ``decr_ratio`` after ``decr_every_n_nan_or_inf`` bad steps in a row
  (static scaling keeps ``init_loss_scaling`` and still drops the bad
  steps).  The state ``(scale, good, bad)`` stays on the device
  (``amp_state``) and the skip is a device-side select, so the step
  makes no host sync of its own.
- ``strategy.recompute`` recomputes the whole forward during the
  backward (activation checkpointing of the step).
- ``strategy.gradient_merge`` (``k_steps``, ``avg``): the gradients of
  ``k_steps`` calls add up in f32 accumulators, and every ``k_steps``-th
  call applies their sum (or mean, with ``avg``) and zeroes them.
- ``guard_health=True``: each call leaves ``train_guard``'s fused health
  vector ``[global_norm, nonfinite, loss]`` (an f32[3] device tensor,
  no host copy) on ``last_health``, for ``TrainGuard.check``: over the
  gradients (one pass each) on the plain step, over the unscaled f32
  gradients with the unscaled loss (masked, with a count) on the
  float16 step, and over the accumulators after this call's add on the
  gradient-merge step (the window's folded health; the loss is this
  call's).

The forward runs under ``framework.step_context.loss_only()``: the step
keeps only the loss, so a model may skip outputs no one reads (the
Llama model's chunked LM loss returns no logits there), as the
reference's traced step drops them.

The model's buffers (batch norm's running statistics) are never cast:
they stay f32 under AMP, as the reference threads its non-parameter
state through the step uncast.  A layer that updates a buffer in its
forward does so once per step: the recomputation under
``strategy.recompute`` runs with every buffer restored afterwards to the
value the step's forward left, as the reference's functional
``jax.checkpoint`` updates it once.  The recomputation also replays the
model's dropout generators (every ``torch.Generator`` held as a
module's ``generator``) from their state at the forward's start, so it
draws the masks the forward drew.

The reference's refusals stay: float16 loss scaling with gradient merge,
and DGC with either.  Not ported yet (each raises ``NotImplementedError``
naming ROADMAP queue item 4): ZeRO sharding, DGC, pipelines and the
other parallel toggles, ``hybrid_configs`` and a mesh of more than one
device.
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
from .strategy import IMPLEMENTED_TOGGLES, DistributedStrategy

__all__ = ["DistributedTrainStep", "LRSchedule", "make_lr_schedule",
           "zero_shard_ranges", "flatten_zero_state", "unflatten_zero_state",
           "zero_shard", "zero_unshard", "zero_reshard",
           "fused_optimizer_apply"]

_LATER = "is not ported yet (ROADMAP queue item 4)"


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


class DistributedTrainStep:
    """Compile (model, loss_fn, optimizer, strategy) into one step::

        step = DistributedTrainStep(model, loss_fn, opt, strategy)
        for x, y in loader:
            loss = step(x, y)

    ``mesh`` may be None or a collection of one device.  ``guard_health``
    leaves the step's health vector on ``last_health`` (module
    docstring).
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
        if strategy.dgc and (self._use_scaling or self._k_steps > 1):
            raise NotImplementedError(
                "strategy.dgc cannot combine with float16 loss scaling or "
                "gradient_merge (the reference treats DGC as its own meta "
                "optimizer too)")
        refused = [t for t in strategy.enabled()
                   if t not in IMPLEMENTED_TOGGLES]
        if refused:
            raise NotImplementedError(
                f"strategy toggles {refused}: {_LATER}; the port runs the "
                f"one-device step with {list(IMPLEMENTED_TOGGLES)}")
        if self._use_scaling and self._k_steps > 1:
            raise NotImplementedError(
                "float16 loss scaling (dynamic or static) + gradient_merge "
                "is not supported; use bfloat16 (no scaling needed)")
        hybrid = {k: v for k, v in strategy.hybrid_configs.items()
                  if v not in (1, -1)}
        if hybrid:
            raise NotImplementedError(f"hybrid_configs {hybrid} {_LATER}")
        if mesh is not None and len(mesh) > 1:
            raise NotImplementedError(
                f"a mesh of {len(mesh)} devices {_LATER}")
        self._strategy = strategy
        self._recompute = bool(strategy.recompute)
        self._guard_health = bool(guard_health)
        self.last_health = None          # f32[3] device tensor a call
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
        gens = (getattr(m, "generator", None) for m in model.modules())
        self._generators = list({id(g): g for g in gens
                                 if isinstance(g, torch.Generator)}.values())
        self._step_i = 0                 # calls so far (gradient merge)
        self._accum = None               # gradient-merge accumulators
        # (loss scale, consecutive finite steps, consecutive bad steps)
        self.amp_state = None

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

    def _loss(self, *args):
        """The f32 loss of ``loss_fn(*args)`` on the (cast) parameters,
        with its graph."""
        cast = [self._amp_cast(p) for p in self._params]
        args = tuple(self._amp_cast(a) for a in args)
        names = ["model." + n for n in self._names]

        def run(*params):
            with loss_only():
                return torch.func.functional_call(
                    self._wrapper, dict(zip(names, params)), args)

        if self._recompute:
            loss = checkpoint(run, *cast, use_reentrant=False,
                              context_fn=self._recompute_contexts)
        else:
            loss = run(*cast)
        return loss.float()

    def _grads(self, loss):
        return list(torch.autograd.grad(loss, self._params,
                                        allow_unused=True,
                                        materialize_grads=True))

    def _scaled_grads(self, loss):
        """float16: the gradients of ``loss * scale`` divided by the scale
        (f32), and the loss as the reference returns it, ``(loss *
        scale) / scale``."""
        scale = self._scale_state()[0]
        sl = loss * scale
        return [(g / scale).float() for g in self._grads(sl)], \
            sl.detach() / scale

    def loss_and_grads(self, *args):
        """The f32 loss of ``loss_fn(*args)`` and the gradients of the
        optimizer's parameters (f32 for f32 masters, unscaled), without a
        parameter update.  The forward does update the model's buffers
        (batch norm's running statistics) once, exactly as ``__call__``
        does: one call of either moves them by one step."""
        loss = self._loss(*args)
        if self._use_scaling:
            grads, loss = self._scaled_grads(loss)
            return loss, grads
        return loss.detach(), self._grads(loss)

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

    @torch.no_grad()
    def _apply(self, grads, finite=None):
        """The optimizer's update of every parameter, in place; with
        ``finite`` (a 0-d device bool) only where it holds, the rest
        bitwise kept.  Empties ``grads`` as it goes, so each gradient is
        freed once applied."""
        opt = self._opt
        lr = opt.get_lr()
        states = opt.opt_state()
        if opt._grad_clip is not None:
            grads[:] = opt._clip_values(grads)
        with torch.profiler.record_function("optimizer"):
            for i, p in enumerate(self._params):
                new_p, new_s = opt._apply_one(p, grads[i], lr, states[i])
                grads[i] = None
                if finite is not None:
                    new_p = torch.where(finite, new_p, p)
                    new_s = _select(finite, new_s, states[i])
                p.copy_(new_p)
                states[i] = new_s
        opt.load_opt_state(states)

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

    def __call__(self, *args):
        from ...train_guard import fused_health
        self._step_i += 1
        loss = self._loss(*args)
        if self._use_scaling:
            grads, loss = self._scaled_grads(loss)
            with torch.no_grad():
                finite = torch.stack([torch.isfinite(g).all()
                                      for g in grads]).all()
                if self._guard_health:
                    self.last_health = fused_health(grads, loss=loss,
                                                    precise=True)
            self._apply(grads, finite)
            self._update_scale(finite)
            return loss
        grads = self._grads(loss)
        loss = loss.detach()
        if self._k_steps <= 1:
            if self._guard_health:
                with torch.no_grad():
                    self.last_health = fused_health(grads, loss=loss,
                                                    precise=False)
            self._apply(grads)
            return loss
        with torch.no_grad():
            if self._accum is None:
                self._accum = [torch.zeros_like(p) for p in self._params]
            for a, g in zip(self._accum, grads):
                a.add_(g)
            del grads
            if self._guard_health:
                self.last_health = fused_health(self._accum, loss=loss,
                                                precise=False)
        if self._step_i % self._k_steps == 0:
            merged = ([a / self._k_steps for a in self._accum]
                      if self._gm_avg else list(self._accum))
            self._apply(merged)
            for a in self._accum:
                a.zero_()
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
