"""Attention functionals: the reference's ``nn/functional/attention.py``.

Inputs in paddle layout (B, S, H, D).

:func:`scaled_dot_product_attention` dispatches as the reference's does
(``attention.py:42-100``): at shapes ``flash_eligible`` admits (at least
1,024 positions, head_dim 64/128/256), the flash entry
(:func:`..ops.kernels.flash_attention.flash_attention`: the hand-written
kernels for CUDA tensors, their plain versions for CPU ones) --

- with no mask and dropout, in-kernel dropout whose seed is drawn from
  ``generator`` (:func:`..ops.kernels.flash_attention.dropout_seed`);
- with no mask and no dropout, the plain flash forward;
- with a vettable floating [B, 1, 1, Sk] mask, the kernel's bias row
  (``mask.to(q.dtype)``, as the reference casts it);

and :func:`_sdpa_ref` otherwise.  The reference draws its dropout keys
from its global key chain; the port takes an explicit ``generator`` (a
``torch.Generator`` on the data's device), as its ``dropout`` does, and
raises without one where a mask would be drawn.

:func:`_sdpa_ref` is the plain composition: the causal mask is aligned
to the bottom-right corner (``tril(ones(Sq, Sk), Sk - Sq)``) as the
reference has it; masked logits are -1e30, not -inf.  ``mask`` is added
to the logits (an f32 mask on bf16 logits promotes them to f32, and the
weights then meet V in f32, as ``jnp`` promotes).  With ``dropout_p >
0`` and a ``generator`` the softmax weights go through
:func:`.common.dropout` (kept weights divided by ``1 - p``), as the
reference drops them when given a ``dropout_key``; without a generator
no dropout is applied, as the reference without a key.
"""
from __future__ import annotations

import torch

from ...framework.dtype import promote
from .common import dropout

__all__ = ["scaled_dot_product_attention", "_sdpa_ref"]


def _sdpa_ref(q, k, v, mask, dropout_p, causal, scale, generator=None):
    qh, kh, vh = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    s = scale if scale is not None else 1.0 / (q.shape[-1] ** 0.5)
    logits = torch.matmul(qh, kh.transpose(-1, -2)) * s
    if causal:
        S_q, S_k = logits.shape[-2], logits.shape[-1]
        keep = torch.ones((S_q, S_k), dtype=torch.bool,
                          device=q.device).tril(S_k - S_q)
        logits = torch.where(keep, logits,
                             torch.tensor(-1e30, dtype=logits.dtype,
                                          device=q.device))
    if mask is not None:
        logits = logits + mask
    w = torch.softmax(logits, dim=-1)
    if dropout_p > 0.0 and generator is not None:
        w = dropout(w, dropout_p, generator=generator)
    dt = promote(w.dtype, vh.dtype)
    return torch.matmul(w.to(dt), vh.to(dt)).transpose(1, 2)


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True, scale=None, name=None,
                                 generator=None, mode=None):
    """Attention on (B, S, H, D) tensors, dispatched as the module
    docstring says.  ``generator`` draws the dropout mask (plain path) or
    the kernels' seed (flash path) and is required when ``dropout_p > 0``
    in training; ``mode`` forwards to the flash kernels' dispatch
    (``"torch_ref"``: their plain versions)."""
    from ...ops.kernels.flash_attention import (dropout_seed,
                                                flash_attention,
                                                flash_eligible)
    drop = dropout_p if training else 0.0
    if drop > 0.0 and generator is None:
        raise ValueError("scaled_dot_product_attention draws its dropout "
                         "from an explicit torch.Generator on the tensors' "
                         "device; pass generator=")
    m = attn_mask
    use_flash = query.dim() == 4 and flash_eligible(
        query.shape[1], query.shape[3], has_mask=m is not None, dropout=drop,
        mask_shape=None if m is None else tuple(m.shape),
        mask_dtype=None if m is None else m.dtype,
        kv_seq_len=key.shape[1])
    if use_flash:
        if m is None:
            seed = dropout_seed(generator) if drop > 0.0 else None
            return flash_attention(query, key, value, causal=is_causal,
                                   scale=scale, dropout_p=drop, seed=seed,
                                   mode=mode)
        return flash_attention(query, key, value, bias=m.to(query.dtype),
                               causal=is_causal, scale=scale, mode=mode)
    return _sdpa_ref(query, key, value, m, drop, is_causal, scale,
                     generator)
