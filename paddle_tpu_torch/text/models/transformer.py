"""Seq2seq Transformer for machine translation: the reference's
``text/models/transformer.py`` (the WMT translation configuration, built
from ``nn.Transformer`` with pre-norm blocks).

Ported: ``TransformerConfig`` and ``transformer_base`` / ``_big`` /
``_tiny``, ``TransformerModel`` (embeddings scaled by sqrt(d_model),
sinusoidal positions, the output projection tied to the target
embedding, which is the source embedding when the vocabularies are
shared), ``CrossEntropyCriterion`` (label-smoothed, pad-masked) and the
cached decoders ``greedy_translate`` and ``beam_translate``, under the
reference's parameter names, so a JAX ``state_dict`` loads with
``load_jax_state_dict`` (the tied embedding arrives under its one name,
``src_embed.weight``).  The position table and the causal mask are
non-persistent buffers, made once on the model's device.

The encoder's self-attention runs under the source's [B, 1, 1, S]
padding row (-1e9 at pads): from 1,024 source tokens that is the flash
kernel's bias row (kernel 1, once an encoder layer); the decoder's
one-token steps take the plain attention, as in the reference.

The criterion computes in f32 whatever the logits' dtype (as the BERT
criterion: XLA keeps f32 between the reference's fused operations).
The decoders run under ``torch.no_grad`` and return numpy ids, as the
reference's return host arrays.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from ... import make_generator, resolve_device
from ...framework.dtype import promote, to_torch
from ...nn.layer import Dropout, Embedding, Normal, Transformer

__all__ = ["TransformerConfig", "TransformerModel",
           "CrossEntropyCriterion", "transformer_base", "transformer_big",
           "transformer_tiny", "greedy_translate", "beam_translate"]


class TransformerConfig:
    def __init__(self, src_vocab_size=30000, trg_vocab_size=30000,
                 d_model=512, nhead=8, num_encoder_layers=6,
                 num_decoder_layers=6, dim_feedforward=2048, dropout=0.1,
                 max_len=256, pad_id=0, bos_id=2, eos_id=3,
                 weight_sharing=True, label_smooth_eps=0.1):
        self.src_vocab_size = src_vocab_size
        self.trg_vocab_size = trg_vocab_size
        self.d_model = d_model
        self.nhead = nhead
        self.num_encoder_layers = num_encoder_layers
        self.num_decoder_layers = num_decoder_layers
        self.dim_feedforward = dim_feedforward
        self.dropout = dropout
        self.max_len = max_len
        self.pad_id = pad_id
        self.bos_id = bos_id
        self.eos_id = eos_id
        self.weight_sharing = weight_sharing
        self.label_smooth_eps = label_smooth_eps


def transformer_base(**kw):
    """The reference WMT "base" config."""
    return TransformerConfig(**kw)


def transformer_big(**kw):
    """The reference WMT "big" config."""
    kw.setdefault("d_model", 1024)
    kw.setdefault("nhead", 16)
    kw.setdefault("dim_feedforward", 4096)
    return TransformerConfig(**kw)


def transformer_tiny(**kw):
    kw.setdefault("d_model", 32)
    kw.setdefault("nhead", 4)
    kw.setdefault("num_encoder_layers", 2)
    kw.setdefault("num_decoder_layers", 2)
    kw.setdefault("dim_feedforward", 64)
    kw.setdefault("max_len", 32)
    return TransformerConfig(**kw)


def _sinusoid(max_len: int, d_model: int) -> np.ndarray:
    pos = np.arange(max_len)[:, None]
    i = np.arange(d_model)[None, :]
    angle = pos / np.power(10000.0, (2 * (i // 2)) / d_model)
    enc = np.where(i % 2 == 0, np.sin(angle), np.cos(angle))
    return enc.astype(np.float32)


class TransformerModel(nn.Module):
    def __init__(self, config: TransformerConfig, device=None, dtype=None,
                 generator: Optional[torch.Generator] = None,
                 dropout_generator: Optional[torch.Generator] = None):
        """Weights on ``device`` (default ``cuda``: raises without a card)
        in ``dtype`` (default f32), drawn from ``generator`` (default: the
        global seed); dropout masks and the flash kernels' seeds from
        ``dropout_generator`` (default: the global seed + 1)."""
        super().__init__()
        c = self.config = config
        dev = resolve_device(device)
        dt = to_torch(dtype) if dtype is not None else torch.float32
        gen = generator if generator is not None else make_generator(dev)
        drop = (dropout_generator if dropout_generator is not None
                else make_generator(dev, offset=1))
        kw = dict(device=dev, dtype=dt, generator=gen)
        # N(0, d_model^-0.5): with sqrt(d_model) input scaling and the
        # weight-tied output projection, logits start O(1)
        emb_init = Normal(0.0, c.d_model ** -0.5)
        self.src_embed = Embedding(c.src_vocab_size, c.d_model,
                                   weight_attr=emb_init, **kw)
        if c.weight_sharing and c.src_vocab_size == c.trg_vocab_size:
            self.trg_embed = self.src_embed
        else:
            self.trg_embed = Embedding(c.trg_vocab_size, c.d_model,
                                       weight_attr=emb_init, **kw)
        self.register_buffer(
            "_pos", torch.from_numpy(_sinusoid(c.max_len, c.d_model)).to(dev),
            persistent=False)
        self.register_buffer(
            "_causal", torch.triu(torch.full((c.max_len, c.max_len), -1e9,
                                             device=dev), 1),
            persistent=False)
        self.dropout = Dropout(c.dropout, generator=drop)
        self.transformer = Transformer(
            d_model=c.d_model, nhead=c.nhead,
            num_encoder_layers=c.num_encoder_layers,
            num_decoder_layers=c.num_decoder_layers,
            dim_feedforward=c.dim_feedforward, dropout=c.dropout,
            normalize_before=True, dropout_generator=drop, **kw)

    def _embed(self, table, ids, pos_offset: int = 0):
        x = table(ids)
        s = ids.shape[1]
        scale = float(np.sqrt(self.config.d_model))
        pos = self._pos[pos_offset:pos_offset + s][None, :, :]
        return self.dropout(x * scale + pos)

    def _pad_mask(self, ids):
        """(B, S) int ids -> (B, 1, 1, S) f32 additive mask, -1e9 at
        pads."""
        return torch.where(ids == self.config.pad_id, -1e9, 0.0).to(
            torch.float32)[:, None, None, :]

    def _causal_mask(self, s: int):
        return self._causal[:s, :s]

    def _truncate(self, ids):
        return ids if ids.shape[1] <= self.config.max_len \
            else ids[:, :self.config.max_len]

    def _project(self, h):
        """The weight-tied output projection: h @ embedding^T."""
        w = self.trg_embed.weight
        dt = promote(h.dtype, w.dtype)
        return torch.matmul(h.to(dt), w.to(dt).t())

    def forward(self, src, trg_in):
        """(B, S_src) ids + (B, S_trg) decoder-input ids -> logits
        (B, S_trg, trg_vocab).  Sequences beyond max_len are truncated
        (the position table ends there)."""
        src = self._truncate(src)
        trg_in = self._truncate(trg_in)
        src_mask = self._pad_mask(src)
        trg_mask = self._pad_mask(trg_in) + self._causal_mask(
            trg_in.shape[1])
        memory = self.transformer.encoder(
            self._embed(self.src_embed, src), src_mask)
        dec = self.transformer.decoder(
            self._embed(self.trg_embed, trg_in), memory, trg_mask,
            src_mask)
        return self._project(dec)


class CrossEntropyCriterion(nn.Module):
    """Label-smoothed token cross entropy, pad-masked, in f32: the mean
    over non-pad targets of -sum(smooth * log_softmax)."""

    def __init__(self, label_smooth_eps=0.1, pad_id=0):
        super().__init__()
        self.eps = label_smooth_eps
        self.pad_id = pad_id

    def forward(self, logits, target):
        lg = logits.float()
        v = lg.shape[-1]
        logp = torch.log_softmax(lg, dim=-1)
        onehot = torch.arange(v, device=lg.device)[None, None, :] \
            == target[:, :, None]
        smooth = onehot * (1.0 - self.eps) + self.eps / v
        nll = -(smooth * logp).sum(-1)
        w = (target != self.pad_id).to(torch.float32)
        return (nll * w).sum() / torch.clamp_min(w.sum(), 1.0)


def _take(tree, idx):
    """Every tensor of a cache tree (lists, tuples, namedtuples) gathered
    along its batch axis at ``idx``."""
    if torch.is_tensor(tree):
        return tree.index_select(0, idx)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_take(x, idx) for x in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_take(x, idx) for x in tree)
    return tree


def _encode(model, src):
    src = model._truncate(src)
    src_mask = model._pad_mask(src)
    memory = model.transformer.encoder(
        model._embed(model.src_embed, src), src_mask)
    return memory, src_mask


def beam_translate(model: TransformerModel, src, beam_size: int = 4,
                   max_len=None, alpha: float = 0.6):
    """Beam search with GNMT length penalty ((5+len)/6)^alpha over the
    incremental KV cache.  Per step the model embeds, decodes one token,
    takes log-softmax and top-k over beam*vocab and gathers the caches by
    parent on the device; the host keeps the (B, K) token, parent and
    score arrays.  Returns (B, <=max_len) best-beam ids (numpy)."""
    c = model.config
    k = int(beam_size)
    max_len = min(max_len or c.max_len, c.max_len)
    was_training = model.training
    model.eval()
    try:
        with torch.no_grad():
            memory, src_mask = _encode(model, src)
            b = memory.shape[0]
            dev = memory.device
            memory_t = memory.repeat_interleave(k, dim=0)
            src_mask_t = src_mask.repeat_interleave(k, dim=0)
            cache = model.transformer.decoder.gen_cache(memory_t)

            tokens = np.full((b, k), c.bos_id, np.int64)
            scores = np.full((b, k), -1e9, np.float32)
            scores[:, 0] = 0.0            # fan out from beam 0 at step 1
            finished = np.zeros((b, k), bool)
            step_tokens, step_parents = [], []
            for t in range(max_len - 1):
                tok = torch.from_numpy(tokens.reshape(-1)[:, None]).to(dev)
                x = model._embed(model.trg_embed, tok, pos_offset=t)
                h, cache = model.transformer.decoder(
                    x, memory_t, None, src_mask_t, cache)
                logp = torch.log_softmax(model._project(h)[:, -1, :].float(),
                                         dim=-1)
                v = logp.shape[-1]
                logp = logp.reshape(b, k, v)
                fin_row = torch.full((v,), -1e9, dtype=logp.dtype,
                                     device=dev)
                fin_row[c.eos_id] = 0.0
                logp = torch.where(
                    torch.from_numpy(finished).to(dev)[:, :, None],
                    fin_row[None, None, :], logp)
                total = torch.from_numpy(scores).to(dev)[:, :, None] + logp
                top_scores, top = torch.topk(total.reshape(b, k * v), k)
                parent_d = top // v
                gidx = (torch.arange(b, device=dev)[:, None] * k
                        + parent_d).reshape(-1)
                cache = _take(cache, gidx)
                scores = top_scores.cpu().numpy()
                parent = parent_d.cpu().numpy().astype(np.int64)
                new_tokens = (top % v).cpu().numpy().astype(np.int64)
                finished = np.take_along_axis(finished, parent, 1) | (
                    new_tokens == c.eos_id)
                step_tokens.append(new_tokens)
                step_parents.append(parent)
                tokens = new_tokens
                if finished.all():
                    break

        if not step_tokens:        # max_len=1: nothing decoded
            return np.zeros((b, 0), np.int64)
        T = len(step_tokens)
        ids = np.stack(step_tokens)
        parents = np.stack(step_parents)
        beams = np.broadcast_to(np.arange(k), (b, k)).copy()
        out = np.empty_like(ids)
        for t in range(T - 1, -1, -1):
            out[t] = np.take_along_axis(ids[t], beams, 1)
            beams = np.take_along_axis(parents[t], beams, 1)
        lens = np.full((b, k), T, np.int64)
        for t in range(T - 1, -1, -1):
            lens = np.where(out[t] == c.eos_id, t + 1, lens)
        # GNMT length penalty at final selection
        lp = ((5.0 + lens) / 6.0) ** alpha
        best = np.argmax(scores / lp, axis=1)          # (B,)
        seqs = out.transpose(1, 2, 0)                  # (B, K, T)
        picked = seqs[np.arange(b), best]              # (B, T)
        # pad everything after each sequence's eos
        cut = lens[np.arange(b), best]
        mask = np.arange(T)[None, :] < cut[:, None]
        return np.where(mask, picked, c.pad_id)
    finally:
        if was_training:
            model.train()


def greedy_translate(model: TransformerModel, src, max_len=None):
    """Greedy decode with the incremental KV cache: the encoder runs once,
    each step feeds only the newest token (cross-attention k/v are a
    ``StaticCache``; self-attention concatenates into a per-layer
    ``Cache``).  ``src``: (B, S) ids.  Returns (B, <=max_len) generated
    ids (numpy), stopping per sequence at eos."""
    c = model.config
    max_len = min(max_len or c.max_len, c.max_len)
    was_training = model.training
    model.eval()
    try:
        with torch.no_grad():
            memory, src_mask = _encode(model, src)
            cache = model.transformer.decoder.gen_cache(memory)
            b = memory.shape[0]
            out = np.full((b, 1), c.bos_id, np.int64)
            done = np.zeros(b, bool)
            for t in range(max_len - 1):
                tok = torch.from_numpy(out[:, -1:].copy()).to(memory.device)
                x = model._embed(model.trg_embed, tok, pos_offset=t)
                h, cache = model.transformer.decoder(
                    x, memory, None, src_mask, cache)
                nxt = model._project(h)[:, -1, :].argmax(-1).cpu().numpy()
                nxt = np.where(done, c.pad_id, nxt)
                done |= nxt == c.eos_id
                out = np.concatenate([out, nxt[:, None].astype(np.int64)],
                                     axis=1)
                if done.all():
                    break
        return out[:, 1:]
    finally:
        if was_training:
            model.train()
