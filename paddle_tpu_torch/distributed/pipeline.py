"""Pipeline parallelism: GPipe and 1F1B over the ``pp`` mesh axis
(counterpart of ``paddle_tpu/distributed/pipeline.py``).

Each ``pp`` rank is a stage and holds a contiguous block of a
layer-stacked parameter tree (leading dim ``L / pp``; the spec
``SpecLayout.stack``).  The reference runs the schedule inside one XLA
program (a ``lax.scan`` over ticks under ``shard_map``) and takes the
backward as ``jax.grad`` of it; the port runs the same schedule eagerly
in each rank, tick by tick, and writes the backward wavefront out:

- **GPipe** (:func:`pipeline_apply`): ``hidden``'s dim 0 is cut into
  ``num_microbatches`` M; at tick t (of ``M + S - 1``) stage s runs
  microbatch ``t - s`` (stage 0 takes it from ``hidden``, the others
  from the previous stage) and every rank passes its output on with
  ``ppermute``.  A stage computes only its own M ticks (the reference
  computes the bubble ticks too and masks them).  The last stage's
  outputs reach every ``pp`` rank, as the reference's masked ``psum``
  gives them, so the head and the loss run on every rank.  The backward
  (a ``torch.autograd.Function``) runs the reverse wavefront: each stage
  takes its microbatches' vector-Jacobian products in reverse tick order
  (the last stage on the cotangent of the broadcast output, the others
  on what the next stage sent back), and the cotangent of ``hidden``
  (nonzero on stage 0) is summed over ``pp``, the transpose of feeding
  every stage the same input, so every rank's embedding receives it.
  Every rank calls every collective in one order.
- **1F1B** (:func:`pipeline_train_1f1b`, :func:`one_f_one_b`): forward
  and backward interleaved in ``M + 2 (S - 1)`` ticks; the last stage
  takes each microbatch's loss and output cotangent as its forward
  finishes, the cotangent chases the activations back with a reverse
  ``ppermute``, and a stage keeps its inputs in a ring of
  ``ring_size(M, S)`` slots and recomputes its forward in the backward
  half (activation checkpointing).  The loss, this stage's parameter
  gradients and the input's gradient equal GPipe's.

``stage_fn(local_params, h, extras) -> h`` must return ``h``'s shape and
dtype (the rotation's payload).  ``extras`` (positions) ride along: a
tensor whose dim 0 is the batch is cut into microbatches with ``h``.
"""
from __future__ import annotations

from typing import Any, Callable

import torch
from torch.utils import _pytree as pytree

from . import mesh as mesh_mod
from .collective import ReduceOp, _all_reduce, _broadcast, _world_rank
from .communication import _ppermute

__all__ = ["pipeline_apply", "num_stages", "one_f_one_b",
           "pipeline_train_1f1b", "schedule_ticks", "ring_size"]

AXIS = "pp"


def num_stages(mesh=None) -> int:
    mesh = mesh or mesh_mod.get_mesh(create=False)
    return int(mesh.shape.get(AXIS, 1)) if mesh is not None else 1


def schedule_ticks(num_microbatches: int, num_stages: int,
                   schedule: str = "1F1B") -> int:
    """The schedule's slots, forward and backward: GPipe ``2 (M + S -
    1)`` (a forward wavefront and its reverse), 1F1B ``M + 2 (S - 1)``.
    A 1F1B slot does a forward and a recompute + backward (about 3 GPipe
    slots of work): its gain is the O(S) stash (:func:`ring_size`), not
    a time read from slot counts."""
    M, S = int(num_microbatches), int(num_stages)
    if schedule.upper() == "1F1B":
        return M + 2 * (S - 1)
    return 2 * (M + S - 1)


def ring_size(num_microbatches: int, num_stages: int) -> int:
    """1F1B's stash bound: stage s holds a microbatch's input for at most
    ``2 (S - 1 - s)`` ticks, so ``min(M, 2 S - 1)`` slots suffice."""
    return min(int(num_microbatches), 2 * int(num_stages) - 1)


def _split(v, M):
    B = v.shape[0]
    return list(v.reshape((M, B // M) + tuple(v.shape[1:])).unbind(0))


def _extras_mb(extras, B, M):
    """Per-microbatch extras: tensors with dim 0 ``B`` cut, the rest
    kept."""
    leaves, spec = pytree.tree_flatten(extras)
    cut = [(_split(v, M) if isinstance(v, torch.Tensor) and v.dim() >= 1
            and v.shape[0] == B else None) for v in leaves]

    def at(m):
        return pytree.tree_unflatten(
            [c[m] if c is not None else v for v, c in zip(leaves, cut)],
            spec)
    return at


def _leaves(params, grad=None):
    """Detached leaves of ``params``: differentiated where the parameter
    takes gradients, or all of them with ``grad``."""
    return [p.detach().requires_grad_(bool(grad or p.requires_grad))
            for p in params]


def _vjp(out, leaf, plist, ct):
    """(d leaf, d params) of ``out`` against ``ct``."""
    want = [leaf] + [p for p in plist if p.requires_grad]
    got = torch.autograd.grad(out, want, ct, allow_unused=True)
    it = iter(got[1:])
    return got[0], [next(it) if p.requires_grad else None for p in plist]


def _add(acc, grads):
    """Add the microbatches' gradients, in f32 for 16-bit ones (the
    returned sums are cast back to the parameters' dtype)."""
    for i, g in enumerate(grads):
        if g is not None:
            if g.dtype in (torch.bfloat16, torch.float16):
                g = g.float()
            acc[i] = g if acc[i] is None else acc[i] + g


class _GPipe(torch.autograd.Function):
    @staticmethod
    def forward(ctx, run, mesh, M, hidden, *params):
        group = mesh.group(AXIS)
        S, s = mesh.shape[AXIS], mesh.axis_index(AXIS)
        plist = _leaves(params)
        x_mb = _split(hidden.detach(), M)
        perm = [(i, (i + 1) % S) for i in range(S)]
        saved, outs = {}, [None] * M
        state = torch.zeros_like(x_mb[0])
        for t in range(M + S - 1):
            m = t - s
            send = torch.zeros_like(state)
            if 0 <= m < M:
                leaf = (x_mb[m] if s == 0 else state).detach() \
                    .requires_grad_(True)
                with torch.enable_grad():
                    out = run(plist, leaf, m)
                saved[m] = (leaf, out)
                send = out.detach()
                if s == S - 1:
                    outs[m] = send
            if t != M + S - 2:
                state = _ppermute(send, AXIS, perm, mesh)
        full = torch.cat(outs) if s == S - 1 else \
            torch.empty_like(hidden)
        # the last stage's outputs on every stage
        _broadcast(full, _world_rank(group, S - 1), group)
        ctx.saved, ctx.plist, ctx.mesh, ctx.M = saved, plist, mesh, M
        return full

    @staticmethod
    def backward(ctx, g):
        mesh, M, saved, plist = ctx.mesh, ctx.M, ctx.saved, ctx.plist
        group = mesh.group(AXIS)
        S, s = mesh.shape[AXIS], mesh.axis_index(AXIS)
        g_mb = _split(g.contiguous(), M)
        perm = [(i, (i - 1) % S) for i in range(S)]
        dparams = [None] * len(plist)
        dx = [torch.zeros_like(g_mb[0]) for _ in range(M)]
        state = torch.zeros_like(g_mb[0])
        for t in reversed(range(M + S - 1)):
            m = t - s
            send = torch.zeros_like(state)
            if 0 <= m < M:
                leaf, out = saved.pop(m)
                ct = g_mb[m] if s == S - 1 else state
                d_in, dp = _vjp(out, leaf, plist, ct.to(out.dtype))
                _add(dparams, dp)
                send = d_in
                if s == 0:
                    dx[m] = d_in
            if t != 0:
                state = _ppermute(send, AXIS, perm, mesh)
        # every stage fed the same input: its cotangent sums over pp
        dhidden = _all_reduce(torch.cat(dx), ReduceOp.SUM, group)
        ctx.saved = ctx.plist = None
        return (None, None, None, dhidden) + tuple(
            d if d is None else d.to(p.dtype) for d, p in zip(dparams, plist))


def pipeline_apply(stage_fn: Callable, stacked_params: Any, hidden,
                   extras=None, *, num_microbatches: int = 1, mesh=None):
    """``stage_fn(local_params, h, extras)`` as a GPipe pipeline over
    ``pp`` (module docstring).  ``stacked_params`` is this stage's block
    (a tree of tensors with a leading layer dim); at ``pp`` 1 this is
    ``stage_fn(stacked_params, hidden, extras)``."""
    mesh = mesh or mesh_mod.get_mesh(create=False)
    S = num_stages(mesh)
    if S <= 1:
        return stage_fn(stacked_params, hidden, extras)
    M = int(num_microbatches)
    B = hidden.shape[0]
    if B % M:
        raise ValueError(f"batch {B} not divisible by microbatches {M}")
    leaves, spec = pytree.tree_flatten(stacked_params)
    e_at = _extras_mb(extras, B, M)

    def run(plist, h, m):
        return stage_fn(pytree.tree_unflatten(plist, spec), h, e_at(m))

    return _GPipe.apply(run, mesh, M, hidden, *leaves)


def one_f_one_b(stage_fn: Callable, local_params, payload_mb, cot_fn,
                *, mesh=None):
    """The 1F1B schedule on this stage (module docstring).
    ``payload_mb`` is the list of M microbatch inputs (the same on every
    stage); ``cot_fn(h_out, m) -> (loss_m, dh)`` runs on the last stage
    as microbatch m's forward ends.  Returns ``(loss_sum, dparams,
    dpayload)``: the microbatch losses' sum and the inputs' cotangents on
    every stage, this stage's parameter cotangents."""
    mesh = mesh or mesh_mod.get_mesh(create=False)
    group = mesh.group(AXIS)
    S, s = mesh.shape[AXIS], mesh.axis_index(AXIS)
    M = len(payload_mb)
    R = ring_size(M, S)
    leaves, spec = pytree.tree_flatten(local_params)
    plist = _leaves(leaves, grad=True)

    def run(h):
        return stage_fn(pytree.tree_unflatten(plist, spec), h)

    zero = torch.zeros_like(payload_mb[0])
    ring = [None] * R
    dparams = [None] * len(plist)
    dpayload = [torch.zeros_like(zero) for _ in range(M)]
    loss = torch.zeros((), dtype=torch.float32, device=zero.device)
    fwd_state, cot_state = zero, zero
    dh = None
    perm_fwd = [(i, (i + 1) % S) for i in range(S)]
    perm_bwd = [(i, (i - 1) % S) for i in range(S)]
    for t in range(M + 2 * (S - 1)):
        # forward half: microbatch t - s
        m_f = t - s
        out = zero
        if 0 <= m_f < M:
            inp = payload_mb[m_f] if s == 0 else fwd_state
            ring[m_f % R] = inp.detach()
            with torch.no_grad():
                out = run(inp.detach())
            if s == S - 1:
                loss_m, dh = cot_fn(out, m_f)
                loss = loss + loss_m.detach().float()
        # backward half: microbatch t - 2 (S - 1) + s
        m_b = t - 2 * (S - 1) + s
        dx = zero
        if 0 <= m_b < M:
            leaf = ring[m_b % R].requires_grad_(True)
            ct = dh if s == S - 1 else cot_state
            with torch.enable_grad():
                o2 = run(leaf)
            dx, dp = _vjp(o2, leaf, plist, ct.to(o2.dtype))
            _add(dparams, dp)
            if s == 0:
                dpayload[m_b] = dx
        fwd_state = _ppermute(out.detach(), AXIS, perm_fwd, mesh)
        cot_state = _ppermute(dx.detach(), AXIS, perm_bwd, mesh)
    # the loss lives on the last stage, the inputs' cotangents on stage 0
    loss = _all_reduce(loss, ReduceOp.SUM, group)
    dpayload = [_all_reduce(d, ReduceOp.SUM, group) for d in dpayload]
    dparams = [d if d is None else d.to(p.dtype)
               for d, p in zip(dparams, plist)]
    return loss, pytree.tree_unflatten(dparams, spec), dpayload


def pipeline_train_1f1b(stage_fn: Callable, stacked_params: Any, hidden,
                        labels, head_loss_fn: Callable, *,
                        num_microbatches: int = 1, mesh=None):
    """Loss and gradients of a layer-stacked block under 1F1B:
    ``stage_fn(local_params, h) -> h`` is one stage, ``head_loss_fn(h,
    y) -> scalar`` the head and loss of one microbatch (a mean, so the
    microbatches' mean is the whole batch's objective).  Returns ``(loss,
    dstacked, dhidden)``: the loss, this stage's parameter gradients and
    ``hidden``'s gradient, GPipe's numbers by another schedule."""
    mesh = mesh or mesh_mod.get_mesh(create=False)
    S = num_stages(mesh)
    M = int(num_microbatches)
    if S <= 1:
        leaves, spec = pytree.tree_flatten(stacked_params)
        plist = _leaves(leaves, grad=True)
        h = hidden.detach().requires_grad_(True)
        with torch.enable_grad():
            loss = head_loss_fn(stage_fn(pytree.tree_unflatten(plist, spec),
                                         h), labels)
            got = torch.autograd.grad(loss, [h] + plist, allow_unused=True)
        return (loss.detach(), pytree.tree_unflatten(list(got[1:]), spec),
                got[0])
    B = hidden.shape[0]
    if B % M:
        raise ValueError(f"batch {B} not divisible by microbatches {M}")
    x_mb = _split(hidden.detach(), M)
    y_mb = _split(labels, M)

    def cot(h_out, m):
        with torch.enable_grad():
            h = h_out.detach().requires_grad_(True)
            lm = head_loss_fn(h, y_mb[m]) / M
            dh, = torch.autograd.grad(lm, h)
        return lm, dh

    loss, dstacked, dx = one_f_one_b(stage_fn, stacked_params, x_mb, cot,
                                     mesh=mesh)
    return loss, dstacked, torch.cat(dx)
