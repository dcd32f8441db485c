"""Context-parallel attention: ring attention and Ulysses (counterpart of
``paddle_tpu/ops/ring_attention.py``).

The ``sp`` mesh axis splits the sequence: each rank holds positions
``[r S / n, (r + 1) S / n)`` of q, k and v.

- **Ring**: each rank keeps its q block and passes its K/V block round
  the ring with ``ppermute`` (k and v travel as one tensor, one exchange
  a step); an online-softmax accumulator (running max m, denominator l,
  weighted sum acc) folds each arriving block, so no S x S score matrix
  is formed.
  Each step runs under ``torch.utils.checkpoint``, so the backward
  recomputes its scores (the reference's ``jax.checkpoint``).
- **Ulysses**: an ``all_to_all`` turns sequence blocks of all heads into
  the whole sequence of ``heads / n`` heads, attention runs there
  (KV-chunked, each chunk checkpointed) and a second ``all_to_all``
  turns it back.  The heads a rank holds must divide by ``n``.

Everything is computed in f32 in plain PyTorch, as the reference
computes it outside any Pallas kernel: neither function calls SDPA or the
flash kernels.  ``ppermute`` and ``all_to_all`` are differentiable
(:mod:`..distributed.communication`), so autograd carries the
cotangents back round the ring.

``ring_attention`` / ``ulysses_attention`` take (B, S, H, D) and
``ring_attention_bhsd`` (B, H, S, D) global arrays, as the reference's
do: each rank cuts its block (the batch over the live data axes, the
heads over ``tp_axis`` when its size above 1 divides them, the sequence
over ``axis_name``), runs its block and returns the output whole (the
ranks' blocks gathered; the backward keeps this rank's block of the
cotangent, so an input's gradient holds this rank's part and the ranks'
parts sum to the whole).  The model calls the per-rank forms
``ring_attention_local`` / ``ulysses_attention_local`` on the blocks it
holds.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from ..distributed import communication as comm
from ..distributed import mesh as mesh_mod
from ..distributed.meta_parallel import block_of

__all__ = ["ring_attention", "ulysses_attention", "ring_attention_bhsd",
           "ring_attention_local", "ulysses_attention_local"]

NEG_INF = -1e30


def _block_accumulate(q, k, v, m, l, acc, q0, k0, causal, scale):
    """One online-softmax step: fold the K/V block at global offset ``k0``
    into the accumulator of the q block at ``q0``.  Shapes (B, H, S,
    D)."""
    s = torch.einsum("bhqd,bhkd->bhqk", q.float() * scale, k.float())
    if causal:
        q_pos = q0 + torch.arange(q.shape[2], device=q.device)[:, None]
        k_pos = k0 + torch.arange(k.shape[2], device=q.device)[None, :]
        s = torch.where(q_pos >= k_pos, s, s.new_full((), NEG_INF))
    m_new = torch.maximum(m, s.amax(dim=-1))
    p = torch.exp(s - m_new[..., None])
    alpha = torch.exp(m - m_new)
    l_new = l * alpha + p.sum(dim=-1)
    acc_new = acc * alpha[..., None] + torch.einsum(
        "bhqk,bhkd->bhqd", p, v.float())
    return m_new, l_new, acc_new


def _state(q, dv):
    b, h, sq = q.shape[:3]
    return (q.new_full((b, h, sq), NEG_INF, dtype=torch.float32),
            q.new_zeros((b, h, sq), dtype=torch.float32),
            q.new_zeros((b, h, sq, dv), dtype=torch.float32))


def ring_attention_local(q, k, v, *, axis_name="sp", causal=False,
                         scale=None):
    """This rank's (B, H, S/n, D) output of ring attention over
    ``axis_name`` from its (B, H, S/n, D) blocks."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    n = comm.axis_size(axis_name)
    idx = comm.axis_index(axis_name)
    s_local = q.shape[2]
    q0 = idx * s_local
    m, l, acc = _state(q, v.shape[-1])
    dk = k.shape[-1]
    kv = torch.cat([k, v], dim=-1)
    perm = [(i, (i + 1) % n) for i in range(n)]
    for t in range(n):
        # after t rotations this rank holds the block of rank (idx - t)
        k0 = ((idx - t) % n) * s_local
        m, l, acc = checkpoint(_block_accumulate, q, kv[..., :dk],
                               kv[..., dk:], m, l, acc, q0, k0, causal,
                               scale, use_reentrant=False)
        if t != n - 1:
            kv = comm.ppermute(kv, axis_name, perm)
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out.to(q.dtype)


def _chunked_attention(q, k, v, q0, causal, scale, chunk=1024):
    """Online-softmax attention over K/V chunks, each checkpointed; (B, H,
    Sq, D) x (B, H, Sk, D), ``q0`` the q block's global offset."""
    sk = k.shape[2]
    m, l, acc = _state(q, v.shape[-1])
    n = max(1, -(-sk // chunk))
    chunk = -(-sk // n)
    for i in range(n):
        lo = i * chunk
        hi = min(lo + chunk, sk)
        m, l, acc = checkpoint(_block_accumulate, q, k[:, :, lo:hi],
                               v[:, :, lo:hi], m, l, acc, q0, lo, causal,
                               scale, use_reentrant=False)
    return (acc / torch.clamp_min(l, 1e-30)[..., None]).to(q.dtype)


def ulysses_attention_local(q, k, v, *, axis_name="sp", causal=False,
                            scale=None):
    """This rank's (B, H, S/n, D) output of Ulysses attention over
    ``axis_name`` from its (B, H, S/n, D) blocks (H divisible by n)."""
    n = comm.axis_size(axis_name)
    if q.shape[1] % n:
        raise ValueError("heads-per-device %d %% %s=%d != 0 — use "
                         "ring_attention" % (q.shape[1], axis_name, n))
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    # heads over the axis, the sequence gathered: [3, B, H/n, S, D]
    qkv = comm.all_to_all(torch.stack([q, k, v]), axis_name, split_dim=2,
                          concat_dim=3)
    out = _chunked_attention(qkv[0], qkv[1], qkv[2], 0, causal, scale)
    return comm.all_to_all(out, axis_name, split_dim=2, concat_dim=1)


def _resolve_mesh(mesh, axis_name):
    mesh = mesh or mesh_mod.get_mesh(create=False)
    if mesh is None or not mesh.distributed:
        raise ValueError(
            "ring/ulysses attention needs a live mesh with the sequence "
            "axis; call paddle_tpu_torch.distributed.init_mesh({'sp': n, "
            "...}) over the ranks first")
    return mesh


def _head_axis(mesh, tp_axis, num_heads):
    """The heads split over ``tp_axis`` when it has more than one rank
    and divides them (heads are independent)."""
    if (tp_axis and mesh.shape.get(tp_axis, 1) > 1
            and num_heads % mesh.shape[tp_axis] == 0):
        return tp_axis
    return None


def _batch_axes(mesh, batch):
    """The live data axes the batch dim splits over inside the call, or
    None."""
    axes = tuple(ax for ax in mesh_mod.DATA if mesh.shape.get(ax, 1) > 1)
    if not axes or batch % mesh.axis_size(axes):
        return None
    return axes if len(axes) > 1 else axes[0]


def _whole(y, spec):
    for d in reversed(range(len(spec))):
        if spec[d] is not None:
            y = comm.gather_from_region(y.contiguous(), spec[d], d)
    return y


def _global(local_fn, q, k, v, causal, scale, axis_name, mesh, tp_axis):
    """(B, H, S, D) global arrays through ``local_fn`` on each rank's
    block."""
    spec = (_batch_axes(mesh, q.shape[0]),
            _head_axis(mesh, tp_axis, q.shape[1]), axis_name, None)
    out = local_fn(*[block_of(t, spec, mesh) for t in (q, k, v)],
                   axis_name=axis_name, causal=causal, scale=scale)
    return _whole(out, spec)


def ring_attention_bhsd(q, k, v, causal=False, scale=None,
                        axis_name: str = "sp", mesh=None,
                        tp_axis: Optional[str] = "tp"):
    """Ring attention on (B, H, S, D) global arrays, S split over
    ``axis_name`` (and the heads over ``tp_axis`` when it divides
    them)."""
    mesh = _resolve_mesh(mesh, axis_name)
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    if q.shape[2] % mesh.shape[axis_name] != 0:
        raise ValueError("sequence length %d not divisible by %s=%d" %
                         (q.shape[2], axis_name, mesh.shape[axis_name]))
    return _global(ring_attention_local, q, k, v, causal, scale, axis_name,
                   mesh, tp_axis)


def ring_attention(q, k, v, causal=False, scale=None, axis_name: str = "sp",
                   mesh=None, tp_axis: Optional[str] = "tp"):
    """Ring attention on (B, S, H, D) global arrays."""
    out = ring_attention_bhsd(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        causal=causal, scale=scale, axis_name=axis_name, mesh=mesh,
        tp_axis=tp_axis)
    return out.transpose(1, 2)


def ulysses_attention(q, k, v, causal=False, scale=None,
                      axis_name: str = "sp", mesh=None,
                      tp_axis: Optional[str] = "tp"):
    """Ulysses attention on (B, S, H, D) global arrays (S split over
    ``axis_name``); the heads a rank holds must divide by its size."""
    mesh = _resolve_mesh(mesh, axis_name)
    n = mesh.shape[axis_name]
    num_heads = q.shape[2]
    h_ax = _head_axis(mesh, tp_axis, num_heads)
    local_heads = num_heads // (mesh.shape[h_ax] if h_ax else 1)
    if local_heads % n != 0:
        raise ValueError("heads-per-device %d %% %s=%d != 0 — use "
                         "ring_attention" % (local_heads, axis_name, n))
    if q.shape[1] % n != 0:
        raise ValueError("sequence length %d not divisible by %s=%d" %
                         (q.shape[1], axis_name, n))
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    out = _global(ulysses_attention_local, q.transpose(1, 2),
                  k.transpose(1, 2), v.transpose(1, 2), causal, scale,
                  axis_name, mesh, tp_axis)
    return out.transpose(1, 2)
