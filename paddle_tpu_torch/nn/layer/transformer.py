"""Transformer layers: the reference's ``nn/layer/transformer.py``.

``MultiHeadAttention`` (with its incremental ``Cache`` and cross-attention
``StaticCache``), ``TransformerEncoderLayer``, ``TransformerEncoder``,
``TransformerDecoderLayer``, ``TransformerDecoder`` and ``Transformer``,
under the reference's parameter names (``q_proj``, ``k_proj``, ``v_proj``,
``out_proj``, ``linear1``, ``linear2``, ``norm1``-``norm3``, ``layers.N``)
and [in, out] linear layouts, so a JAX ``state_dict`` loads with
``load_jax_state_dict`` as it is.

Attention goes through :func:`..functional.scaled_dot_product_attention`,
so a [B, 1, 1, S] float padding mask at 1,024 positions or more takes
the flash kernel's bias row (kernel 1), as in the reference.  Bool masks
become additive masks of 0 and -1e9 in the query's dtype
(``_convert_attention_mask``).

Every layer takes ``device`` (default ``cuda``: raises without a card),
``dtype``, ``generator`` (the weights; default PyTorch's) and
``dropout_generator`` (the dropout masks and the flash kernels' dropout
seeds; default the global seed + 1 on ``device``).  A container shares
one dropout generator with its layers, and the encoder's and decoder's
copies of a layer share their original's (the reference deep-copies the
layer, weights and all); ``DistributedTrainStep`` replays it under
``recompute``.  ``kernel_mode`` on a ``MultiHeadAttention`` (None, or
``"torch_ref"``: the plain versions) forwards to the flash kernels'
dispatch (``registry.set_kernel_mode`` sets it on every layer of a
model).
"""
from __future__ import annotations

import collections
import copy
from typing import Optional

import torch
from torch import nn

from ... import make_generator, resolve_device
from .. import functional as F
from .common import Linear
from .norm import LayerNorm

__all__ = ["MultiHeadAttention", "TransformerEncoderLayer",
           "TransformerEncoder", "TransformerDecoderLayer",
           "TransformerDecoder", "Transformer"]


def _convert_attention_mask(attn_mask, dtype):
    """Bool masks -> additive float masks (True keeps: 0, False: -1e9) in
    ``dtype``; a float mask is returned as it is."""
    if attn_mask is None or attn_mask.dtype != torch.bool:
        return attn_mask
    zero = torch.zeros((), dtype=dtype, device=attn_mask.device)
    return torch.where(attn_mask, zero, torch.full_like(zero, -1e9))


def _kw(device, dtype, generator, dropout_generator):
    """(layer keywords, dropout generator) of a layer built on ``device``
    (default ``cuda``) in ``dtype`` (default f32)."""
    dev = resolve_device(device)
    drop = (dropout_generator if dropout_generator is not None
            else make_generator(dev, offset=1))
    return dict(device=dev, dtype=dtype or torch.float32,
                generator=generator), drop


def _clones(layer: nn.Module, n: int):
    """``layer`` and n - 1 deep copies of it that share its dropout
    generators (a torch.Generator is state, not a weight)."""
    gens = {id(m.generator): m.generator for m in layer.modules()
            if isinstance(getattr(m, "generator", None), torch.Generator)}
    return [layer] + [copy.deepcopy(layer, dict(gens)) for _ in range(n - 1)]


class MultiHeadAttention(nn.Module):
    Cache = collections.namedtuple("Cache", ["k", "v"])
    StaticCache = collections.namedtuple("StaticCache", ["k", "v"])

    def __init__(self, embed_dim, num_heads, dropout=0.0, kdim=None,
                 vdim=None, need_weights=False, weight_attr=None,
                 bias_attr=None, *, device=None, dtype=None,
                 generator: Optional[torch.Generator] = None,
                 dropout_generator: Optional[torch.Generator] = None):
        super().__init__()
        kw, drop = _kw(device, dtype, generator, dropout_generator)
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        self.dropout = dropout
        self.need_weights = need_weights
        kdim = kdim or embed_dim
        vdim = vdim or embed_dim
        self.q_proj = Linear(embed_dim, embed_dim, weight_attr, bias_attr,
                             **kw)
        self.k_proj = Linear(kdim, embed_dim, weight_attr, bias_attr, **kw)
        self.v_proj = Linear(vdim, embed_dim, weight_attr, bias_attr, **kw)
        self.out_proj = Linear(embed_dim, embed_dim, weight_attr, bias_attr,
                               **kw)
        self.generator = drop
        self.kernel_mode = None

    def _shape(self, x):
        # (B, S, E) -> (B, S, H, D)
        return x.reshape(x.shape[0], x.shape[1], self.num_heads,
                         self.head_dim)

    def gen_cache(self, key, value=None, type=None):
        """A ``StaticCache`` of ``key`` / ``value`` projected once
        (cross-attention), or an empty incremental ``Cache`` of ``key``'s
        batch."""
        if type == MultiHeadAttention.StaticCache:
            k = self._shape(self.k_proj(key))
            v = self._shape(self.v_proj(value if value is not None else key))
            return self.StaticCache(k, v)
        empty = torch.zeros((key.shape[0], 0, self.num_heads, self.head_dim),
                            dtype=key.dtype, device=key.device)
        return self.Cache(empty, empty)

    def forward(self, query, key=None, value=None, attn_mask=None,
                cache=None):
        key = key if key is not None else query
        value = value if value is not None else key
        q = self._shape(self.q_proj(query))
        if isinstance(cache, self.StaticCache):
            k, v = cache.k, cache.v
        else:
            k = self._shape(self.k_proj(key))
            v = self._shape(self.v_proj(value))
            if isinstance(cache, self.Cache):
                k = torch.cat([cache.k.to(k.dtype), k], dim=1)
                v = torch.cat([cache.v.to(v.dtype), v], dim=1)
                cache = self.Cache(k, v)
        mask = _convert_attention_mask(attn_mask, q.dtype)
        out = F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask,
            dropout_p=self.dropout if self.training else 0.0,
            generator=self.generator, mode=self.kernel_mode)
        out = self.out_proj(out.reshape(out.shape[0], out.shape[1],
                                        self.embed_dim))
        if cache is not None and not isinstance(cache, self.StaticCache):
            return out, cache
        return out


class TransformerEncoderLayer(nn.Module):
    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 *, device=None, dtype=None,
                 generator: Optional[torch.Generator] = None,
                 dropout_generator: Optional[torch.Generator] = None):
        super().__init__()
        kw, drop = _kw(device, dtype, generator, dropout_generator)
        attn_dropout = dropout if attn_dropout is None else attn_dropout
        act_dropout = dropout if act_dropout is None else act_dropout
        self.normalize_before = normalize_before
        self.self_attn = MultiHeadAttention(
            d_model, nhead, attn_dropout, weight_attr=weight_attr,
            bias_attr=bias_attr, dropout_generator=drop, **kw)
        self.linear1 = Linear(d_model, dim_feedforward, weight_attr,
                              bias_attr, **kw)
        self.linear2 = Linear(dim_feedforward, d_model, weight_attr,
                              bias_attr, **kw)
        nkw = dict(device=kw["device"], dtype=kw["dtype"])
        self.norm1 = LayerNorm(d_model, **nkw)
        self.norm2 = LayerNorm(d_model, **nkw)
        self.dropout_p = dropout
        self.act_dropout_p = act_dropout
        self.activation = getattr(F, activation)
        self.generator = drop

    def _drop(self, x, p):
        return F.dropout(x, p, training=self.training,
                         generator=self.generator)

    def forward(self, src, src_mask=None, cache=None):
        residual = src
        if self.normalize_before:
            src = self.norm1(src)
        if cache is None:
            out = self.self_attn(src, src, src, src_mask)
        else:
            out, cache = self.self_attn(src, src, src, src_mask, cache)
        src = residual + self._drop(out, self.dropout_p)
        if not self.normalize_before:
            src = self.norm1(src)
        residual = src
        if self.normalize_before:
            src = self.norm2(src)
        src = self.linear2(self._drop(self.activation(self.linear1(src)),
                                      self.act_dropout_p))
        src = residual + self._drop(src, self.dropout_p)
        if not self.normalize_before:
            src = self.norm2(src)
        return src if cache is None else (src, cache)

    def gen_cache(self, src):
        return self.self_attn.gen_cache(src)


class TransformerEncoder(nn.Module):
    def __init__(self, encoder_layer, num_layers, norm=None):
        super().__init__()
        self.layers = nn.ModuleList(_clones(encoder_layer, num_layers))
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, src, src_mask=None, cache=None):
        output = src
        new_caches = []
        for i, mod in enumerate(self.layers):
            if cache is None:
                output = mod(output, src_mask)
            else:
                output, nc = mod(output, src_mask, cache[i])
                new_caches.append(nc)
        if self.norm is not None:
            output = self.norm(output)
        return output if cache is None else (output, new_caches)

    def gen_cache(self, src):
        return [layer.gen_cache(src) for layer in self.layers]


class TransformerDecoderLayer(nn.Module):
    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 *, device=None, dtype=None,
                 generator: Optional[torch.Generator] = None,
                 dropout_generator: Optional[torch.Generator] = None):
        super().__init__()
        kw, drop = _kw(device, dtype, generator, dropout_generator)
        attn_dropout = dropout if attn_dropout is None else attn_dropout
        act_dropout = dropout if act_dropout is None else act_dropout
        self.normalize_before = normalize_before
        self.self_attn = MultiHeadAttention(
            d_model, nhead, attn_dropout, weight_attr=weight_attr,
            bias_attr=bias_attr, dropout_generator=drop, **kw)
        self.cross_attn = MultiHeadAttention(
            d_model, nhead, attn_dropout, weight_attr=weight_attr,
            bias_attr=bias_attr, dropout_generator=drop, **kw)
        self.linear1 = Linear(d_model, dim_feedforward, weight_attr,
                              bias_attr, **kw)
        self.linear2 = Linear(dim_feedforward, d_model, weight_attr,
                              bias_attr, **kw)
        nkw = dict(device=kw["device"], dtype=kw["dtype"])
        self.norm1 = LayerNorm(d_model, **nkw)
        self.norm2 = LayerNorm(d_model, **nkw)
        self.norm3 = LayerNorm(d_model, **nkw)
        self.dropout_p = dropout
        self.act_dropout_p = act_dropout
        self.activation = getattr(F, activation)
        self.generator = drop

    def _drop(self, x, p):
        return F.dropout(x, p, training=self.training,
                         generator=self.generator)

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None,
                cache=None):
        residual = tgt
        if self.normalize_before:
            tgt = self.norm1(tgt)
        if cache is None:
            tgt2 = self.self_attn(tgt, tgt, tgt, tgt_mask)
            incr_cache = None
        else:
            tgt2, incr_cache = self.self_attn(tgt, tgt, tgt, tgt_mask,
                                              cache[0])
        tgt = residual + self._drop(tgt2, self.dropout_p)
        if not self.normalize_before:
            tgt = self.norm1(tgt)

        residual = tgt
        if self.normalize_before:
            tgt = self.norm2(tgt)
        if cache is None:
            tgt2 = self.cross_attn(tgt, memory, memory, memory_mask)
        else:
            tgt2 = self.cross_attn(tgt, memory, memory, memory_mask,
                                   cache[1])
            if isinstance(tgt2, tuple):
                tgt2 = tgt2[0]
        tgt = residual + self._drop(tgt2, self.dropout_p)
        if not self.normalize_before:
            tgt = self.norm2(tgt)

        residual = tgt
        if self.normalize_before:
            tgt = self.norm3(tgt)
        tgt2 = self.linear2(self._drop(self.activation(self.linear1(tgt)),
                                       self.act_dropout_p))
        tgt = residual + self._drop(tgt2, self.dropout_p)
        if not self.normalize_before:
            tgt = self.norm3(tgt)
        return tgt if cache is None else (tgt, (incr_cache, cache[1]))

    def gen_cache(self, memory):
        incremental = self.self_attn.gen_cache(memory)
        static = self.cross_attn.gen_cache(
            memory, memory, type=MultiHeadAttention.StaticCache)
        return incremental, static


class TransformerDecoder(nn.Module):
    def __init__(self, decoder_layer, num_layers, norm=None):
        super().__init__()
        self.layers = nn.ModuleList(_clones(decoder_layer, num_layers))
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None,
                cache=None):
        output = tgt
        new_caches = []
        for i, mod in enumerate(self.layers):
            if cache is None:
                output = mod(output, memory, tgt_mask, memory_mask)
            else:
                output, nc = mod(output, memory, tgt_mask, memory_mask,
                                 cache[i])
                new_caches.append(nc)
        if self.norm is not None:
            output = self.norm(output)
        return output if cache is None else (output, new_caches)

    def gen_cache(self, memory, do_zip=False):
        caches = [layer.gen_cache(memory) for layer in self.layers]
        if do_zip:
            caches = list(zip(*caches))
        return caches


class Transformer(nn.Module):
    """The full encoder-decoder."""

    def __init__(self, d_model=512, nhead=8, num_encoder_layers=6,
                 num_decoder_layers=6, dim_feedforward=2048, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 custom_encoder=None, custom_decoder=None, *, device=None,
                 dtype=None, generator: Optional[torch.Generator] = None,
                 dropout_generator: Optional[torch.Generator] = None):
        super().__init__()
        kw, drop = _kw(device, dtype, generator, dropout_generator)
        lkw = dict(kw, dropout_generator=drop)
        nkw = dict(device=kw["device"], dtype=kw["dtype"])
        self.d_model = d_model
        self.nhead = nhead
        self.device = kw["device"]
        if custom_encoder is not None:
            self.encoder = custom_encoder
        else:
            enc_layer = TransformerEncoderLayer(
                d_model, nhead, dim_feedforward, dropout, activation,
                attn_dropout, act_dropout, normalize_before, weight_attr,
                bias_attr, **lkw)
            enc_norm = LayerNorm(d_model, **nkw) if normalize_before else None
            self.encoder = TransformerEncoder(enc_layer, num_encoder_layers,
                                              enc_norm)
        if custom_decoder is not None:
            self.decoder = custom_decoder
        else:
            dec_layer = TransformerDecoderLayer(
                d_model, nhead, dim_feedforward, dropout, activation,
                attn_dropout, act_dropout, normalize_before, weight_attr,
                bias_attr, **lkw)
            dec_norm = LayerNorm(d_model, **nkw) if normalize_before else None
            self.decoder = TransformerDecoder(dec_layer, num_decoder_layers,
                                              dec_norm)

    def forward(self, src, tgt, src_mask=None, tgt_mask=None,
                memory_mask=None):
        memory = self.encoder(src, src_mask)
        return self.decoder(tgt, memory, tgt_mask, memory_mask)

    def generate_square_subsequent_mask(self, length):
        """[length, length] f32: -inf above the diagonal, 0 elsewhere."""
        m = torch.full((length, length), float("-inf"), device=self.device)
        return torch.triu(m, 1)
