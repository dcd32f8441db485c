"""Plain scaled-dot-product attention (counterpart of the reference's
``nn/functional/attention.py`` ``_sdpa_ref``).

Inputs in paddle layout (B, S, H, D).  The causal mask is aligned to the
bottom-right corner (``tril(ones(Sq, Sk), Sk - Sq)``) as the reference
has it; masked logits are -1e30, not -inf.  ``mask`` is added to the
logits.  With ``dropout_p > 0`` and a ``generator`` the softmax weights
go through :func:`.common.dropout` (kept weights divided by ``1 - p``),
as the reference drops them when given a ``dropout_key``; without a
generator no dropout is applied, as the reference without a key.  The
Llama prefill and training forward go through
:func:`..ops.kernels.flash_attention.flash_attention` at flash-eligible
shapes; this is the attention of the others and of BERT.
"""
from __future__ import annotations

import torch

from .common import dropout

__all__ = ["_sdpa_ref"]


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
    return torch.matmul(w, vh).transpose(1, 2)
