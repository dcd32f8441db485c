"""Llama decoder-only LM: the serving and training parts of the
reference's ``text/models/llama.py``.

Ported: ``LlamaConfig`` and the named configs, ``RMSNorm``, the
interleaved-pair rotary embedding ``_rope``, the block-paged KV cache
path (``init_paged_cache`` / ``forward_paged``) that ``GenerationServer``
drives, and the training forward: full-sequence attention, per-layer
remat, the layer-stacked decoder (``scan_layers=True``) and the causal
LM loss.  Each function keeps the reference's dtype steps, so the same
weights give the same numbers:

- the embedding is cast to ``compute_dtype`` (layer 0 sees bf16 even
  with f32 weights);
- ``linear`` promotes like ``jnp.matmul`` (bf16 x f32 -> f32), so the
  residual stream turns f32 after the first f32 projection (the stacked
  decoder folds each layer's output back to the compute dtype, as the
  reference's ``lax.scan`` carry does);
- RMSNorm computes in f32 and casts back to its input dtype;
- the LM head runs on f32 hidden states, and the loss is an f32
  log-softmax.

Prefill (S > 1, not verify) and training attention at flash-eligible
shapes run the hand-written flash-attention kernels (the training path
through their autograd Function, so the backward runs the two backward
kernels); decode/verify over int8 pools runs the int8 paged-attention
kernel; all route CPU tensors to their plain versions.

Not ported yet: the chunked LM loss (``_chunked_causal_lm_loss``, which
the reference engages only above 1.5 GiB of f32 logits), the chunked
attention for flash-ineligible long sequences (``_sdpa_ref`` runs
there), pipeline / sequence / context parallelism and the dense
``[B, Smax]`` cache path.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ... import make_generator, resolve_device
from ...framework.dtype import to_torch
from ...nn.functional import _sdpa_ref, silu
from ...nn.layer import (ColumnParallelLinear, Normal, RowParallelLinear,
                         VocabParallelEmbedding)
from ...ops.kernels.flash_attention import flash_attention, flash_eligible
from ...ops.kernels.kv_attention import (int8_paged_attention,
                                         paged_attention_ref)

__all__ = ["LlamaConfig", "LlamaForCausalLM", "LlamaModel", "RMSNorm",
           "StackedLlamaDecoder", "llama_tiny", "llama_7b", "llama_13b"]

_SCAN_LAYERS_KV_MSG = (
    "KV-cache decoding is not supported with scan_layers=True (stacked "
    "decoder); build the model with scan_layers=False for incremental "
    "generation")


@dataclasses.dataclass
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: Optional[int] = None  # GQA; None -> MHA
    max_position_embeddings: int = 4096
    rms_norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    initializer_range: float = 0.02
    tie_word_embeddings: bool = False
    remat: bool = True            # per-layer activation checkpointing
    compute_dtype: str = "bfloat16"
    scan_layers: bool = False     # layer-stacked parameters
    # paged-KV pool dtype: None -> compute_dtype; "int8" -> int8 pools
    # with [num_blocks, block_size] f32 scale tensors (symmetric
    # per-token scales, quantised on write); any other value is a plain
    # storage dtype for the pools
    kv_cache_dtype: Optional[str] = None

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def kv_heads(self) -> int:
        return self.num_key_value_heads or self.num_attention_heads


def llama_tiny(**kw) -> LlamaConfig:
    """Small config for tests."""
    d = dict(vocab_size=256, hidden_size=64, intermediate_size=128,
             num_hidden_layers=2, num_attention_heads=4,
             num_key_value_heads=2, max_position_embeddings=128,
             remat=False)
    d.update(kw)
    return LlamaConfig(**d)


def llama_7b(**kw) -> LlamaConfig:
    return LlamaConfig(**kw)


def llama_13b(**kw) -> LlamaConfig:
    d = dict(hidden_size=5120, intermediate_size=13824,
             num_hidden_layers=40, num_attention_heads=40)
    d.update(kw)
    return LlamaConfig(**d)


class RMSNorm(nn.Module):
    """y = x / rms(x) * w, computed in f32 whatever the input dtype."""

    def __init__(self, hidden_size: int, eps: float = 1e-5, *,
                 device=None, dtype=torch.float32):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(hidden_size, device=device,
                                              dtype=dtype))

    def forward(self, x):
        h = x.float()
        var = torch.mean(h * h, dim=-1, keepdim=True)
        h = h * torch.rsqrt(var + self.eps)
        return (h * self.weight).to(x.dtype)


def _rope(x, positions, theta: float):
    """Rotary embedding on (B, S, H, D) over INTERLEAVED pairs
    (x[..., ::2], x[..., 1::2]), restacked pairwise -- not the
    half-rotation layout most PyTorch code uses."""
    d = x.shape[-1]
    freq = theta ** (-torch.arange(0, d, 2, dtype=torch.float32,
                                   device=x.device) / d)
    ang = positions[:, :, None].float() * freq              # B,S,D/2
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., ::2], x[..., 1::2]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.stack([y1, y2], dim=-1).reshape(x.shape).to(x.dtype)


class LlamaAttention(nn.Module):
    def __init__(self, config: LlamaConfig, *, device=None,
                 dtype=torch.float32, generator=None):
        super().__init__()
        c = config
        self.config = c
        init = Normal(0.0, c.initializer_range)
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.q_proj = ColumnParallelLinear(
            c.hidden_size, c.num_attention_heads * c.head_dim,
            weight_attr=init, has_bias=False, **kw)
        self.k_proj = ColumnParallelLinear(
            c.hidden_size, c.kv_heads * c.head_dim, weight_attr=init,
            has_bias=False, **kw)
        self.v_proj = ColumnParallelLinear(
            c.hidden_size, c.kv_heads * c.head_dim, weight_attr=init,
            has_bias=False, **kw)
        self.o_proj = RowParallelLinear(
            c.num_attention_heads * c.head_dim, c.hidden_size,
            weight_attr=init, has_bias=False, **kw)

    def forward(self, hidden, positions, mode=None):
        """Causal self-attention over the whole sequence (training and
        full-recompute forward).  Grouped-query K/V are repeated to every
        query head first, as the reference does; flash-eligible shapes
        take the flash kernels (``mode`` forwards to their dispatch),
        others the plain attention."""
        c = self.config
        q = self.q_proj(hidden)
        k = self.k_proj(hidden)
        v = self.v_proj(hidden)
        B, S = q.shape[0], q.shape[1]
        H, KH, D = c.num_attention_heads, c.kv_heads, c.head_dim
        qh = _rope(q.reshape(B, S, H, D), positions, c.rope_theta)
        kh = _rope(k.reshape(B, S, KH, D), positions, c.rope_theta)
        vh = v.reshape(B, S, KH, D)
        if KH != H:
            kh = kh.repeat_interleave(H // KH, dim=2)
            vh = vh.repeat_interleave(H // KH, dim=2)
        if flash_eligible(S, D):
            o = flash_attention(qh, kh, vh, causal=True, mode=mode)
        else:
            o = _sdpa_ref(qh, kh, vh, None, 0.0, True, None)
        return self.o_proj(o.reshape(B, S, H * D))

    def forward_paged(self, hidden, positions, cache, block_tables,
                      write_mask, verify_mode: bool = False, mode=None):
        """Block-paged attention.  K/V live in pools
        ``[num_blocks, block_size, KH, D]`` shared by every sequence; a
        sequence's ``block_tables`` row maps logical block
        ``pos // block_size`` to its physical block.  ``write_mask``
        [B, S] sends masked positions' writes to the trash block 0
        (never read: the validity mask is slot <= position).

        The pools (and, for int8 pools, ``k_scale``/``v_scale``) are
        UPDATED IN PLACE; the returned dict is ``cache`` itself.

        ``S > 1`` without ``verify_mode`` is a fresh prefill (positions
        from 0): causal attention over the block through the flash
        kernel.  Otherwise the queries attend the cache through the
        table (int8 pools: the int8 paged-attention kernel).  ``mode``
        forwards to the kernel dispatch (``"torch_ref"`` runs the plain
        versions, for comparisons)."""
        c = self.config
        q = self.q_proj(hidden)
        k = self.k_proj(hidden)
        v = self.v_proj(hidden)
        quant = "k_scale" in cache
        B, S = q.shape[0], q.shape[1]
        H, KH, D = c.num_attention_heads, c.kv_heads, c.head_dim
        kpool, vpool = cache["k"], cache["v"]
        bs = kpool.shape[1]
        qh = _rope(q.reshape(B, S, H, D), positions, c.rope_theta)
        kh = _rope(k.reshape(B, S, KH, D), positions, c.rope_theta)
        vh = v.reshape(B, S, KH, D)
        # scatter this call's K/V: physical block = table[logical block],
        # offset = pos % block_size; masked writes go to (0, 0)
        blk_log = (positions // bs).long().clamp(0, block_tables.shape[1] - 1)
        blk_phys = torch.gather(block_tables.long(), 1, blk_log)
        off = (positions % bs).long()
        fb = torch.where(write_mask, blk_phys, 0).reshape(-1)
        fo = torch.where(write_mask, off, 0).reshape(-1)
        kfl = kh.reshape(B * S, KH, D)
        vfl = vh.reshape(B * S, KH, D)
        if quant:
            # symmetric per-token int8: one f32 scale per written slot,
            # the reference's exact f32 ops (division, round half to
            # even, clip)
            kf, vf = kfl.float(), vfl.float()
            ksc = torch.clamp_min(kf.abs().amax(dim=(1, 2)) / 127.0, 1e-8)
            vsc = torch.clamp_min(vf.abs().amax(dim=(1, 2)) / 127.0, 1e-8)
            kpool[fb, fo] = torch.clamp(torch.round(
                kf / ksc[:, None, None]), -127, 127).to(torch.int8)
            vpool[fb, fo] = torch.clamp(torch.round(
                vf / vsc[:, None, None]), -127, 127).to(torch.int8)
            cache["k_scale"][fb, fo] = ksc
            cache["v_scale"][fb, fo] = vsc
        else:
            kpool[fb, fo] = kfl.to(kpool.dtype)
            vpool[fb, fo] = vfl.to(vpool.dtype)

        if S > 1 and not verify_mode:
            o = flash_attention(qh, kh, vh, causal=True, mode=mode)
        elif quant:
            o = int8_paged_attention(qh, kpool, vpool, cache["k_scale"],
                                     cache["v_scale"], block_tables,
                                     positions, KH, mode=mode)
        else:
            o = paged_attention_ref(qh, kpool, vpool, None, None,
                                    block_tables, positions, KH)
        return self.o_proj(o.reshape(B, S, H * D)), cache


class LlamaMLP(nn.Module):
    def __init__(self, config: LlamaConfig, *, device=None,
                 dtype=torch.float32, generator=None):
        super().__init__()
        c = config
        init = Normal(0.0, c.initializer_range)
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.gate_proj = ColumnParallelLinear(
            c.hidden_size, c.intermediate_size, weight_attr=init,
            has_bias=False, **kw)
        self.up_proj = ColumnParallelLinear(
            c.hidden_size, c.intermediate_size, weight_attr=init,
            has_bias=False, **kw)
        self.down_proj = RowParallelLinear(
            c.intermediate_size, c.hidden_size, weight_attr=init,
            has_bias=False, **kw)

    def forward(self, x):
        return self.down_proj(silu(self.gate_proj(x)) * self.up_proj(x))


class LlamaDecoderLayer(nn.Module):
    def __init__(self, config: LlamaConfig, **kw):
        super().__init__()
        nkw = dict(device=kw["device"], dtype=kw["dtype"])
        self.input_layernorm = RMSNorm(config.hidden_size,
                                       config.rms_norm_eps, **nkw)
        self.self_attn = LlamaAttention(config, **kw)
        self.post_attention_layernorm = RMSNorm(config.hidden_size,
                                                config.rms_norm_eps, **nkw)
        self.mlp = LlamaMLP(config, **kw)

    def forward(self, hidden, positions, mode=None):
        h = hidden + self.self_attn(self.input_layernorm(hidden), positions,
                                    mode=mode)
        return h + self.mlp(self.post_attention_layernorm(h))

    def forward_paged(self, hidden, positions, cache, block_tables,
                      write_mask, verify_mode: bool = False, mode=None):
        attn_out, cache = self.self_attn.forward_paged(
            self.input_layernorm(hidden), positions, cache, block_tables,
            write_mask, verify_mode=verify_mode, mode=mode)
        h = hidden + attn_out
        return h + self.mlp(self.post_attention_layernorm(h)), cache


class StackedLlamaDecoder(nn.Module):
    """The decoder stack with layer-STACKED parameters: every parameter of
    a decoder layer has a leading layer dim, under the reference's names
    (``input_layernorm__weight``, ``self_attn__q_proj__weight``, ...), so
    a ``scan_layers=True`` JAX model's state dict loads unchanged.

    The forward splits each stacked tensor once with ``torch.unbind`` and
    runs a prototype layer (on the ``meta`` device, never holding data)
    with one layer's slices through ``torch.func.functional_call``; a
    Python loop takes the place of ``lax.scan``.  ``unbind``'s backward
    stacks the L per-layer gradients into one [L, ...] tensor, where L
    ``select``s would each materialise a full-size zero gradient.
    """

    def __init__(self, config: LlamaConfig, *, device=None,
                 dtype=torch.float32, generator=None):
        super().__init__()
        self.config = config
        kw = dict(device=device, dtype=dtype, generator=generator)
        layers = [LlamaDecoderLayer(config, **kw)
                  for _ in range(config.num_hidden_layers)]
        self._names = [n for n, _ in layers[0].named_parameters()]
        for n in self._names:
            stacked = torch.stack([dict(l.named_parameters())[n].detach()
                                   for l in layers])
            self.register_parameter(n.replace(".", "__"),
                                    nn.Parameter(stacked))
        del layers
        # not a registered child: its own parameters are placeholders
        object.__setattr__(self, "_proto", LlamaDecoderLayer(
            config, device="meta", dtype=dtype, generator=None))

    def _layer(self, hidden, positions, mode, *params):
        return torch.func.functional_call(
            self._proto, dict(zip(self._names, params)), (hidden, positions),
            {"mode": mode})

    def forward(self, hidden, positions, mode=None):
        per_layer = [torch.unbind(getattr(self, n.replace(".", "__")))
                     for n in self._names]
        for i in range(self.config.num_hidden_layers):
            params = [p[i] for p in per_layer]
            if self.config.remat:
                out = checkpoint(self._layer, hidden, positions, mode,
                                 *params, use_reentrant=False)
            else:
                out = self._layer(hidden, positions, mode, *params)
            # f32 params promote a bf16 carry; fold the layer output back
            # to the carry dtype, as the reference's scan does
            hidden = out.to(hidden.dtype)
        return hidden


class LlamaModel(nn.Module):
    def __init__(self, config: LlamaConfig, *, device=None,
                 dtype=torch.float32, generator=None):
        super().__init__()
        self.config = config
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.embed_tokens = VocabParallelEmbedding(
            config.vocab_size, config.hidden_size,
            weight_attr=Normal(0.0, config.initializer_range), **kw)
        if config.scan_layers:
            self.decoder = StackedLlamaDecoder(config, **kw)
            self.layers = nn.ModuleList()
        else:
            self.decoder = None
            self.layers = nn.ModuleList(
                [LlamaDecoderLayer(config, **kw)
                 for _ in range(config.num_hidden_layers)])
        self.norm = RMSNorm(config.hidden_size, config.rms_norm_eps,
                            device=device, dtype=dtype)

    def forward(self, input_ids, positions=None, mode=None):
        """Final hidden states [B, S, hidden] of a full-sequence causal
        forward.  ``positions`` default to ``arange(S)`` per row."""
        c = self.config
        if positions is None:
            S = input_ids.shape[1]
            positions = torch.arange(
                S, dtype=torch.int32,
                device=input_ids.device)[None, :].expand(input_ids.shape)
        hidden = self.embed_tokens(input_ids)
        if c.compute_dtype:
            hidden = hidden.to(to_torch(c.compute_dtype))
        if self.decoder is not None:
            hidden = self.decoder(hidden, positions, mode=mode)
        else:
            for layer in self.layers:
                if c.remat:
                    hidden = checkpoint(layer, hidden, positions, mode=mode,
                                        use_reentrant=False)
                else:
                    hidden = layer(hidden, positions, mode=mode)
        return self.norm(hidden)

    def forward_paged(self, input_ids, positions, pools, block_tables,
                      write_mask, verify_mode: bool = False, mode=None):
        """``pools``: one {"k", "v"} dict per layer (plus ``k_scale`` /
        ``v_scale`` for int8 pools), updated in place.  Returns
        (hidden, pools)."""
        if self.decoder is not None:
            raise NotImplementedError(_SCAN_LAYERS_KV_MSG)
        c = self.config
        hidden = self.embed_tokens(input_ids)
        if c.compute_dtype:
            hidden = hidden.to(to_torch(c.compute_dtype))
        for layer, pool in zip(self.layers, pools):
            hidden, _ = layer.forward_paged(hidden, positions, pool,
                                            block_tables, write_mask,
                                            verify_mode=verify_mode,
                                            mode=mode)
        return self.norm(hidden), pools


class LlamaForCausalLM(nn.Module):
    """Causal LM head on :class:`LlamaModel`.

    ``device`` defaults to ``cuda`` (raises without a card); ``dtype`` is
    the parameter dtype (float32, as the reference's parameters, unless
    asked); ``generator`` draws the initial weights (default: the global
    seed, see :func:`paddle_tpu_torch.seed`).
    """

    def __init__(self, config: LlamaConfig, device=None, dtype=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        dt = to_torch(dtype) if dtype is not None else torch.float32
        gen = generator if generator is not None else make_generator(dev)
        self.config = config
        self.model = LlamaModel(config, device=dev, dtype=dt, generator=gen)
        self.lm_head = None if config.tie_word_embeddings else \
            ColumnParallelLinear(
                config.hidden_size, config.vocab_size,
                weight_attr=Normal(0.0, config.initializer_range),
                has_bias=False, device=dev, dtype=dt, generator=gen)

    @property
    def device(self) -> torch.device:
        return self.model.embed_tokens.weight.device

    def _logits(self, hidden):
        h = hidden.float()
        if self.lm_head is not None:
            return self.lm_head(h)
        return h @ self.model.embed_tokens.weight.float().T

    def forward(self, input_ids, labels=None, positions=None, mode=None):
        """Logits [B, S, V] (f32), or ``(loss, logits)`` when ``labels``
        are given: next-token cross entropy (the shift is done here,
        label -100 is ignored, the mean is over valid tokens).  ``mode``
        forwards to the attention kernels' dispatch."""
        hidden = self.model(input_ids, positions, mode=mode)
        logits = self._logits(hidden)
        if labels is None:
            return logits
        return _causal_lm_loss(logits, labels), logits

    def supports_kv_cache(self) -> bool:
        return self.model.decoder is None

    def init_paged_cache(self, num_blocks: int, block_size: int):
        """Per-layer K/V pools ``[num_blocks, block_size, KH, D]`` on the
        model's device (block 0 is the trash block: never hand it out).
        ``kv_cache_dtype="int8"`` adds per-(block, slot) f32 scales
        ``k_scale`` / ``v_scale`` [num_blocks, block_size]."""
        if not self.supports_kv_cache():
            raise NotImplementedError(_SCAN_LAYERS_KV_MSG)
        c = self.config
        quant = c.kv_cache_dtype == "int8"
        if quant:
            dt = torch.int8
        elif c.kv_cache_dtype:
            dt = to_torch(c.kv_cache_dtype)
        else:
            dt = to_torch(c.compute_dtype) if c.compute_dtype \
                else torch.float32
        shape = (int(num_blocks), int(block_size), c.kv_heads, c.head_dim)
        dev = self.device

        def make():
            return torch.zeros(shape, dtype=dt, device=dev)

        def make_scale():
            return torch.zeros(shape[:2], dtype=torch.float32, device=dev)

        if quant:
            return [{"k": make(), "v": make(), "k_scale": make_scale(),
                     "v_scale": make_scale()}
                    for _ in range(c.num_hidden_layers)]
        return [{"k": make(), "v": make()}
                for _ in range(c.num_hidden_layers)]

    def forward_paged(self, input_ids, positions, pools, block_tables,
                      write_mask, gather_at=None, verify_mode: bool = False,
                      mode=None):
        """(logits, pools) through the block-paged cache (pools updated
        in place).  With ``gather_at`` [B] the hidden states are taken
        at those positions before the vocab projection, so a prefill
        pays for a [B, 1, V] projection, not [B, S, V]."""
        hidden, pools = self.model.forward_paged(
            input_ids, positions, pools, block_tables, write_mask,
            verify_mode=verify_mode, mode=mode)
        if gather_at is not None:
            idx = gather_at.long()[:, None, None].expand(
                -1, 1, hidden.shape[-1])
            hidden = torch.gather(hidden, 1, idx)
        return self._logits(hidden), pools


def _causal_lm_loss(logits, labels):
    """Mean next-token negative log-likelihood: f32 log-softmax of
    ``logits[:, :-1]`` against ``labels[:, 1:]``, label < 0 ignored, the
    sum divided by the number of valid labels (at least 1)."""
    lg = logits[:, :-1, :]
    lb = labels[:, 1:].long()
    valid = lb >= 0
    logp = torch.log_softmax(lg.float(), dim=-1)
    nll = -torch.gather(logp, -1, torch.where(valid, lb, 0)[..., None])[..., 0]
    nll = torch.where(valid, nll, torch.zeros((), device=nll.device))
    return nll.sum() / valid.sum().clamp_min(1)
