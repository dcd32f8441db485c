"""Cross entropy with the reference's options.

Counterpart of ``paddle_tpu/nn/functional/loss.py:22-75`` (``_reduce``,
``cross_entropy``, ``softmax_with_cross_entropy``): log-softmax and the
negative log-likelihood in the input's dtype (a bf16 logit under AMP
gives a bf16 loss; the training step takes it to f32 afterwards), with
``weight``, ``ignore_index``, ``reduction``, ``soft_label``, ``axis`` and
``use_softmax``.  The reference fused this in one XLA expression with no
Pallas kernel, so plain PyTorch is the port.

An ignored label gathers a clamped index and is then masked to zero, as
the reference's gather is: the value is the same, and no index falls
outside the class axis.
"""
from __future__ import annotations

import torch

__all__ = ["cross_entropy", "softmax_with_cross_entropy"]


def _reduce(v, reduction):
    if reduction == "mean":
        return torch.mean(v)
    if reduction == "sum":
        return torch.sum(v)
    return v


def cross_entropy(input, label, weight=None, ignore_index=-100,
                  reduction="mean", soft_label=False, axis=-1,
                  use_softmax=True):
    """The per-example (``reduction="none"``), summed or mean negative
    log-likelihood of ``label`` under ``softmax(input)`` along ``axis``
    (or under ``input`` itself when ``use_softmax`` is False).  Hard
    labels may keep a size-1 class axis; a mean over hard labels divides
    by the count of labels that are not ``ignore_index`` (by their summed
    ``weight`` when one is given)."""
    v = input
    if use_softmax:
        logp = torch.log_softmax(v, dim=axis)
    else:
        logp = torch.log(torch.clamp(v, min=1e-12))
    if soft_label:
        per = -torch.sum(label.to(logp.dtype) * logp, dim=axis)
        return _reduce(per, reduction)
    li = label.to(torch.int64)
    if li.dim() == logp.dim():
        li = li.squeeze(axis)
    mask = li != ignore_index
    safe = torch.where(mask, li, torch.zeros_like(li)).clamp_(
        0, logp.shape[axis] - 1)
    per = -torch.gather(logp, axis, safe.unsqueeze(axis)).squeeze(axis)
    per = torch.where(mask, per, torch.zeros((), dtype=per.dtype,
                                             device=per.device))
    if weight is not None:
        w = weight[safe]
        per = per * w
        if reduction == "mean":
            denom = torch.sum(torch.where(mask, w, torch.zeros(
                (), dtype=w.dtype, device=w.device)))
            return torch.sum(per) / torch.clamp(denom, min=1e-12)
    if reduction == "mean":
        n_valid = torch.clamp(torch.sum(mask.to(per.dtype)), min=1.0)
        return torch.sum(per) / n_valid
    return _reduce(per, reduction)


def softmax_with_cross_entropy(logits, label, soft_label=False,
                               ignore_index=-100, numeric_stable_mode=True,
                               return_softmax=False, axis=-1):
    """The per-example loss with the class axis kept (size 1), and the
    softmax too when ``return_softmax``."""
    loss = cross_entropy(logits, label, soft_label=soft_label,
                         ignore_index=ignore_index, reduction="none",
                         axis=axis).unsqueeze(axis)
    if return_softmax:
        return loss, torch.softmax(logits, dim=axis)
    return loss
