"""Autoregressive text generation: greedy, sampling, beam search
(counterpart of the reference's ``text/generation.py``).

- The sequence lives in a fixed-shape [B, S0 + max_new] buffer.  With a
  KV-cache-capable model (``supports_kv_cache()``) greedy and sampling
  decoding prefill once through ``forward_with_cache`` and then run one
  token a step; otherwise (or with ``use_cache=False``) each step re-runs
  the model over the whole buffer and reads the logits of the last real
  token (causality makes the right padding safe).
- Sampling draws from an explicit ``torch.Generator`` on the model's
  device (``generator=``, default: one from the global seed): the
  temperature / top-k / top-p filter is the reference's, the draw is not
  ``jax.random``'s (a difference by design).
- Beam search keeps [B * num_beams] rows in the same buffer, reorders
  them at each step and scores by the sum of log-probabilities over each
  beam's own length to the ``length_penalty`` power; it re-runs the whole
  buffer each step, as the reference does.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .. import make_generator

__all__ = ["generate"]


def _logits_at(model, buf, pos_idx):
    """Model forward over the whole buffer; the logits at ``pos_idx - 1``
    (each row's last real token).  Every ``pos_idx`` must be >= 1: the
    gather would wrap to the buffer's end otherwise."""
    assert bool((pos_idx >= 1).all()), \
        "_logits_at requires pos_idx >= 1 (no empty rows: the gather " \
        "reads pos_idx - 1, which would wrap to the buffer tail)"
    out = model(buf)
    logits = out[-1] if isinstance(out, tuple) else out
    idx = (pos_idx - 1).long()[:, None, None].expand(-1, 1, logits.shape[-1])
    return torch.gather(logits, 1, idx)[:, 0, :]


def _filter_logits(logits, temperature, top_k, top_p):
    """The reference's filter: divide by the temperature (floored at
    1e-6), keep the ``top_k`` largest, then the fewest largest whose
    softmax mass reaches ``top_p``; the rest become -inf."""
    if temperature is not None and temperature != 1.0:
        logits = logits / max(float(temperature), 1e-6)
    V = logits.shape[-1]
    if top_k and 0 < top_k < V:
        kth = torch.sort(logits, dim=-1).values[:, -top_k][:, None]
        logits = torch.where(logits < kth, float("-inf"), logits)
    if top_p and top_p < 1.0:
        srt = torch.sort(logits, dim=-1, descending=True).values
        cum = torch.cumsum(torch.softmax(srt, dim=-1), dim=-1)
        keep = torch.clamp((cum < top_p).sum(-1) + 1, min=1)
        kth = torch.gather(srt, 1, (keep - 1)[:, None])
        logits = torch.where(logits < kth, float("-inf"), logits)
    return logits


@torch.no_grad()
def generate(model, input_ids, max_new_tokens: int = 32,
             do_sample: bool = False, temperature: float = 1.0,
             top_k: int = 0, top_p: float = 1.0, num_beams: int = 1,
             eos_token_id: Optional[int] = None, pad_token_id: int = 0,
             length_penalty: float = 1.0, use_cache: Optional[bool] = None,
             generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Continuations of ``input_ids`` [B, S0] -> int32 [B, S0 + new] on
    the model's device.

    ``do_sample`` samples with temperature / top-k / top-p from
    ``generator``; ``num_beams > 1`` runs beam search (not with
    sampling).  Rows that emit ``eos_token_id`` are frozen and padded
    with ``pad_token_id``; the loop stops once every row is done.
    ``use_cache`` (default: whether the model supports a KV cache) runs
    greedy and sampling decoding on ``forward_with_cache``."""
    dev = model.device
    ids = torch.as_tensor(np.asarray(
        input_ids.cpu().numpy() if hasattr(input_ids, "cpu") else input_ids),
        dtype=torch.int32).to(dev)
    B, S0 = ids.shape
    if S0 < 1:
        raise ValueError("generate requires a non-empty prompt "
                         "(the first logits gather reads position S0-1)")
    total = S0 + max_new_tokens
    if num_beams > 1 and do_sample:
        raise ValueError("beam search and sampling are mutually exclusive")
    if num_beams > 1:
        return _beam_search(model, ids, max_new_tokens, num_beams,
                            eos_token_id, pad_token_id, length_penalty)
    if do_sample and temperature is not None and float(temperature) == 0.0:
        do_sample = False          # temperature 0.0 IS greedy (exact)
    if do_sample and generator is None:
        generator = make_generator(dev)

    buf = torch.full((B, total), pad_token_id, dtype=torch.int32, device=dev)
    buf[:, :S0] = ids
    pos = torch.full((B,), S0, dtype=torch.int64, device=dev)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    supports = bool(getattr(model, "supports_kv_cache", lambda: False)())
    if use_cache is None:
        use_cache = supports
    elif use_cache and not supports:
        raise ValueError(
            "use_cache=True but the model does not support KV-cache "
            "decode (supports_kv_cache() is False)")
    rows = torch.arange(B, device=dev)
    if use_cache:
        caches = model.init_cache(B, total)
        prefill_pos = torch.arange(S0, dtype=torch.int32,
                                   device=dev)[None].expand(B, S0)
        lg, caches = model.forward_with_cache(ids, prefill_pos, caches,
                                              last_logits_only=True)
        last = lg[:, -1, :]
    for it in range(max_new_tokens):
        logits = last if use_cache else _logits_at(model, buf, pos)
        if do_sample:
            probs = torch.softmax(
                _filter_logits(logits.float(), temperature, top_k, top_p),
                dim=-1)
            nxt = torch.multinomial(probs, 1, generator=generator)[:, 0]
        else:
            nxt = torch.argmax(logits, dim=-1)
        nxt = torch.where(done, pad_token_id, nxt).to(torch.int32)
        buf[rows, pos] = nxt
        if eos_token_id is not None:
            done = done | (nxt == eos_token_id)
        pos = pos + 1          # frozen rows advance too, emitting pads
        if eos_token_id is not None and bool(done.all()):
            break
        if use_cache and it + 1 < max_new_tokens:
            # no decode forward after the last token: its logits would
            # never be read
            lg, caches = model.forward_with_cache(
                nxt[:, None], (pos - 1)[:, None].to(torch.int32), caches)
            last = lg[:, 0, :]
    return buf


def _beam_search(model, ids, max_new_tokens, num_beams, eos_token_id,
                 pad_token_id, length_penalty):
    dev = ids.device
    B, S0 = ids.shape
    total = S0 + max_new_tokens
    K = num_beams
    # beam 0 starts live, the others at -inf, so the first expansion fans
    # out from the prompt once
    buf = torch.full((B * K, total), pad_token_id, dtype=torch.int32,
                     device=dev)
    buf[:, :S0] = ids.repeat_interleave(K, dim=0)
    scores = torch.full((B, K), float("-inf"), device=dev)
    scores[:, 0] = 0.0
    done = torch.zeros((B, K), dtype=torch.bool, device=dev)
    blen = torch.zeros((B, K), dtype=torch.int32, device=dev)
    pos = S0
    for _ in range(max_new_tokens):
        logits = _logits_at(model, buf, torch.full((B * K,), pos,
                                                   device=dev))
        logp = torch.log_softmax(logits.float(), dim=-1).reshape(B, K, -1)
        V = logp.shape[-1]
        if eos_token_id is not None:
            # a frozen beam continues with the pad token alone, score 0
            frozen = torch.full((B, K, V), float("-inf"), device=dev)
            frozen[:, :, pad_token_id] = 0.0
            logp = torch.where(done[:, :, None], frozen, logp)
        cand = scores[:, :, None] + logp
        top_s, top_i = torch.topk(cand.reshape(B, K * V), K, dim=-1)
        beam_idx = top_i // V
        tok = (top_i % V).to(torch.int32)
        gather = (torch.arange(B, device=dev)[:, None] * K
                  + beam_idx).reshape(-1)
        buf = buf[gather]
        buf[:, pos] = tok.reshape(-1)
        scores = top_s
        prev_done = (torch.gather(done, 1, beam_idx)
                     if eos_token_id is not None
                     else torch.zeros((B, K), dtype=torch.bool, device=dev))
        blen = torch.gather(blen, 1, beam_idx) + (~prev_done).to(torch.int32)
        if eos_token_id is not None:
            done = prev_done | (tok == eos_token_id)
            if bool(done.all()):
                break
        pos += 1
    norm = scores / (torch.clamp(blen, min=1).float() ** length_penalty)
    best = torch.argmax(norm, dim=-1)
    return buf[torch.arange(B, device=dev) * K + best]
