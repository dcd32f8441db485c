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
kernels); decode over int8 pools runs the int8 paged-attention kernel's
decode route, verify blocks and suffix prefills its many-row route; all
route CPU tensors to their plain versions.

The dense ``[B, Smax]`` cache path (``init_cache`` /
``forward_with_cache``, which ``generate`` drives) is the reference's:
a prefill through flash attention where eligible, decode steps in plain
PyTorch (the reference has no kernel there).

The reference's two long-sequence memory savers are ported.  Training
attention at a flash-ineligible length of at least 1,024 positions (or
with flash turned off) takes ``chunked_attention``: query chunks of 512
under their own checkpoint, so no more than one [B, H, chunk, S] score
block is alive (shorter sequences take ``_sdpa_ref``).  The chunked LM
loss (``_chunked_causal_lm_loss``) streams the next-token cross entropy
over chunks of 256 positions, each chunk's [B, 256, V] f32 logits
recomputed in the backward, whose projection (``_ProjChunk``) rounds the
cotangent to the weights' dtype.  The reference engages it when the
forward is traced under ``jit`` (where the unused logits are dead
code), S - 1 >= 512 and the f32 logits would take at least 1.5 GiB.
The port runs eagerly, so it engages it at the same thresholds inside a
train step that keeps only the loss (``DistributedTrainStep``, through
``framework.step_context``), and there ``forward(ids, labels)`` returns
``(loss, None)``: no logits.  Every other caller gets ``(loss,
logits)`` from the plain path, as the reference's eager callers do.

**Model parallelism** (the reference's, with explicit collectives: the
port has no SPMD partitioner).  Every projection is a tensor-parallel
layer (:mod:`...distributed.meta_parallel`): under a mesh over processes
with ``tp`` above 1 a rank holds its block of each (its heads of q, k, v
and o, its columns of the MLP's gate / up and rows of its down, its rows
of the embedding and columns of the head), the attention runs on its
heads (the flash kernels at the rank's shape), and the head's logits are
gathered whole.  With ``sequence_parallel`` or ``context_parallel`` and
``sp`` above 1 the model takes this rank's block of the sequence (dim 1
of ``input_ids``; the train step cuts it), its positions start at the
block's offset, the attention is ring or Ulysses attention over ``sp``
(``context_parallel``, ring by default), and the loss pairs the block's
last position with the next block's first label (brought across with
``ppermute``): each rank sums its positions' losses over the global count
of labels, and the ranks' sums are added (``reduce_from_region``).  With
``pp`` above 1 the stacked decoder holds this stage's contiguous block of
layers and runs them as a GPipe pipeline of ``pp_num_microbatches``
(:mod:`...distributed.pipeline`); the head and the loss run on every
stage.  The paged and dense-cache serving paths take whole weights.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ... import make_generator, resolve_device
from ...framework.dtype import to_torch
from ...framework.step_context import keeps_loss_only
from ...nn.functional import _sdpa_ref, silu
from ...distributed import communication as comm
from ...distributed import mesh as mesh_mod
from ...distributed.meta_parallel import (ColumnParallelLinear,
                                          RowParallelLinear,
                                          VocabParallelEmbedding,
                                          mark_sharding)
from ...distributed.spec_layout import get_layout
from ...nn.layer.common import Normal
from ...ops.kernels.flash_attention import (chunked_attention,
                                           flash_attention, flash_eligible)
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
    # the sequence (dim 1) split over 'sp'; context_parallel: the
    # attention over it, "ring" or "ulysses" (None: ring when the
    # sequence is split)
    sequence_parallel: bool = False
    context_parallel: Optional[str] = None
    scan_layers: bool = False     # layer-stacked parameters
    pp_num_microbatches: int = 1  # GPipe microbatches when pp > 1
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


def _rows(fn, x, min_rows):
    """``fn`` over the rows of ``x`` [..., F], issued with at least
    ``min_rows`` rows (zero rows appended, their results dropped).  A
    GEMM library picks its algorithm by the row count, and some (split
    K, GEMV) sum a row in another order, and so does a reduction over
    the last dim (an RMS norm's mean of squares: with few rows PyTorch
    splits a row over more threads), so the same row can get other bits
    in a call of another size; with a floor on the rows every call of a
    server runs the algorithms of large calls.  ``None``: ``fn(x)`` as it
    is."""
    if not min_rows:
        return fn(x)
    flat = x.reshape(-1, x.shape[-1])
    n = flat.shape[0]
    if n < min_rows:
        flat = torch.cat([flat, flat.new_zeros(min_rows - n,
                                               flat.shape[-1])])
    out = fn(flat)[:n]
    return out.reshape(*x.shape[:-1], out.shape[-1])


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


def _seq_split(config) -> int:
    """The ranks the sequence splits over: ``sp`` of the mesh over
    processes when the config splits it, else 1."""
    if not (config.sequence_parallel or config.context_parallel):
        return 1
    mesh = mesh_mod.get_mesh(create=False)
    if mesh is None or not mesh.distributed:
        return 1
    return mesh.axis_size(get_layout().act_axis("seq"))


def _context_parallel(qh, kh, vh, config):
    """Causal ring or Ulysses attention over ``sp`` on this rank's (B, S /
    sp, H, D) blocks."""
    from ...ops.ring_attention import (ring_attention_local,
                                       ulysses_attention_local)
    mode = config.context_parallel or "ring"
    if mode == "ring":
        fn = ring_attention_local
    elif mode == "ulysses":
        fn = ulysses_attention_local
    else:
        raise ValueError("context_parallel must be 'ring' or 'ulysses', "
                         "got %r" % (mode,))
    o = fn(qh.transpose(1, 2), kh.transpose(1, 2), vh.transpose(1, 2),
           axis_name=get_layout().act_axis("seq"), causal=True)
    return o.transpose(1, 2)


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
            weight_attr=init, has_bias=False, gather_output=False, **kw)
        self.k_proj = ColumnParallelLinear(
            c.hidden_size, c.kv_heads * c.head_dim, weight_attr=init,
            has_bias=False, gather_output=False, **kw)
        self.v_proj = ColumnParallelLinear(
            c.hidden_size, c.kv_heads * c.head_dim, weight_attr=init,
            has_bias=False, gather_output=False, **kw)
        self.o_proj = RowParallelLinear(
            c.num_attention_heads * c.head_dim, c.hidden_size,
            weight_attr=init, has_bias=False, input_is_parallel=True, **kw)

    def forward(self, hidden, positions, mode=None):
        """Causal self-attention over the whole sequence (training and
        full-recompute forward).  Grouped-query K/V are repeated to every
        query head first, as the reference does; flash-eligible shapes
        take the flash kernels (``mode`` forwards to their dispatch),
        other lengths of at least 1,024 ``chunked_attention``, shorter
        ones the plain attention; a sequence split over ``sp`` takes ring
        or Ulysses attention.  Under ``tp`` the rank's heads (its blocks
        of the projections) run, and ``o_proj`` sums the ranks' parts."""
        c = self.config
        x = hidden
        if self.q_proj.split():
            x = comm.copy_to_region(hidden, get_layout().act_axis("col_out"))
        q = self.q_proj.local(x)
        k = self.k_proj.local(x)
        v = self.v_proj.local(x)
        B, S, D = q.shape[0], q.shape[1], c.head_dim
        H, KH = q.shape[-1] // D, k.shape[-1] // D
        qh = _rope(q.reshape(B, S, H, D), positions, c.rope_theta)
        kh = _rope(k.reshape(B, S, KH, D), positions, c.rope_theta)
        vh = v.reshape(B, S, KH, D)
        if KH != H:
            kh = kh.repeat_interleave(H // KH, dim=2)
            vh = vh.repeat_interleave(H // KH, dim=2)
        if _seq_split(c) > 1:
            o = _context_parallel(qh, kh, vh, c)
        elif flash_eligible(S, D):
            o = flash_attention(qh, kh, vh, causal=True, mode=mode)
        elif S >= 1024:
            o = chunked_attention(qh, kh, vh, causal=True)
        else:
            o = _sdpa_ref(qh, kh, vh, None, 0.0, True, None)
        return self.o_proj(o.reshape(B, S, H * D))

    def forward_cached(self, hidden, positions, cache, mode=None):
        """Incremental attention over a dense cache ``{"k", "v"}`` of
        [B, Smax, KH, D] (slot index == absolute position), updated in
        place: this call's roped K/V are written at ``positions``, then
        S > 1 (a prefill into an empty cache) is causal attention over
        the block (flash where eligible), and S = 1 attends the whole
        buffer in f32 with the mask slot <= position, query heads grouped
        by kv head.  Returns (output, cache)."""
        c = self.config
        q = self.q_proj(hidden)
        k = self.k_proj(hidden)
        v = self.v_proj(hidden)
        B, S = q.shape[0], q.shape[1]
        H, KH, D = c.num_attention_heads, c.kv_heads, c.head_dim
        kbuf, vbuf = cache["k"], cache["v"]
        qh = _rope(q.reshape(B, S, H, D), positions, c.rope_theta)
        kh = _rope(k.reshape(B, S, KH, D), positions, c.rope_theta)
        vh = v.reshape(B, S, KH, D)
        bidx = torch.arange(B, device=q.device)[:, None]
        kbuf[bidx, positions.long()] = kh.to(kbuf.dtype)
        vbuf[bidx, positions.long()] = vh.to(vbuf.dtype)
        if S > 1:
            kh2, vh2 = kh, vh
            if KH != H:
                kh2 = kh.repeat_interleave(H // KH, dim=2)
                vh2 = vh.repeat_interleave(H // KH, dim=2)
            if flash_eligible(S, D):
                o = flash_attention(qh, kh2, vh2, causal=True, mode=mode)
            else:
                o = _sdpa_ref(qh, kh2, vh2, None, 0.0, True, None)
            return self.o_proj(o.reshape(B, S, H * D)), cache
        Smax = kbuf.shape[1]
        R = H // KH
        qg = qh.reshape(B, S, KH, R, D)
        logits = torch.einsum("bsgrd,btgd->bgrst", qg.float(),
                              kbuf.float()) * (1.0 / (D ** 0.5))
        valid = (torch.arange(Smax, device=q.device)[None, None, None, None]
                 <= positions[:, None, None, :, None])
        logits = torch.where(valid, logits, float("-inf"))
        w = torch.softmax(logits, dim=-1)
        o = torch.einsum("bgrst,btgd->bsgrd", w, vbuf.float()).to(q.dtype)
        return self.o_proj(o.reshape(B, S, H * D)), cache

    def forward_paged(self, hidden, positions, cache, block_tables,
                      write_mask, verify_mode: bool = False, mode=None,
                      min_rows=None):
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
        table (int8 pools: the int8 paged-attention kernel, its decode
        route at S = 1, its many-row route for verify blocks and suffix
        prefills).  ``mode`` forwards to the kernel dispatch
        (``"torch_ref"`` runs the plain versions, for comparisons);
        ``min_rows`` floors the rows of each projection (see
        :func:`_rows`); the decoder layer floors its norms too."""
        c = self.config
        q = _rows(self.q_proj, hidden, min_rows)
        k = _rows(self.k_proj, hidden, min_rows)
        v = _rows(self.v_proj, hidden, min_rows)
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
        return _rows(self.o_proj, o.reshape(B, S, H * D), min_rows), cache


class LlamaMLP(nn.Module):
    def __init__(self, config: LlamaConfig, *, device=None,
                 dtype=torch.float32, generator=None):
        super().__init__()
        c = config
        init = Normal(0.0, c.initializer_range)
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.gate_proj = ColumnParallelLinear(
            c.hidden_size, c.intermediate_size, weight_attr=init,
            has_bias=False, gather_output=False, **kw)
        self.up_proj = ColumnParallelLinear(
            c.hidden_size, c.intermediate_size, weight_attr=init,
            has_bias=False, gather_output=False, **kw)
        self.down_proj = RowParallelLinear(
            c.intermediate_size, c.hidden_size, weight_attr=init,
            has_bias=False, input_is_parallel=True, **kw)

    def forward(self, x):
        if self.gate_proj.split():
            x = comm.copy_to_region(x, get_layout().act_axis("col_out"))
        return self.down_proj(silu(self.gate_proj.local(x))
                              * self.up_proj.local(x))


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

    def forward_cached(self, hidden, positions, cache, mode=None):
        attn_out, cache = self.self_attn.forward_cached(
            self.input_layernorm(hidden), positions, cache, mode=mode)
        h = hidden + attn_out
        return h + self.mlp(self.post_attention_layernorm(h)), cache

    def forward_paged(self, hidden, positions, cache, block_tables,
                      write_mask, verify_mode: bool = False, mode=None,
                      min_rows=None):
        attn_out, cache = self.self_attn.forward_paged(
            _rows(self.input_layernorm, hidden, min_rows), positions, cache,
            block_tables, write_mask, verify_mode=verify_mode, mode=mode,
            min_rows=min_rows)
        h = hidden + attn_out
        return h + _rows(self.mlp, _rows(self.post_attention_layernorm, h,
                                         min_rows), min_rows), cache


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

    Each stacked parameter's spec is ``SpecLayout.stack`` of its layer's
    (the leading dim over ``pp``): under ``pp`` above 1 a stage holds
    layers ``[s L / pp, (s + 1) L / pp)`` and the forward runs them as a
    GPipe pipeline of ``pp_num_microbatches`` (``pipeline_apply``).
    """

    def __init__(self, config: LlamaConfig, *, device=None,
                 dtype=torch.float32, generator=None):
        super().__init__()
        self.config = config
        kw = dict(device=device, dtype=dtype, generator=generator)
        layers = [LlamaDecoderLayer(config, **kw)
                  for _ in range(config.num_hidden_layers)]
        self._names = [n for n, _ in layers[0].named_parameters()]
        lay = get_layout()
        for n in self._names:
            per = [dict(l.named_parameters())[n] for l in layers]
            stacked = nn.Parameter(torch.stack([p.detach() for p in per]))
            full = (len(per),) + tuple(getattr(per[0], "full_shape",
                                               per[0].shape))
            mark_sharding(stacked, lay.stack(
                getattr(per[0], "dist_spec", None), stacked.dim()), full)
            self.register_parameter(n.replace(".", "__"), stacked)
        del layers
        # not a registered child: its own parameters are placeholders
        object.__setattr__(self, "_proto", LlamaDecoderLayer(
            config, device="meta", dtype=dtype, generator=None))

    def _layer(self, hidden, positions, mode, *params):
        return torch.func.functional_call(
            self._proto, dict(zip(self._names, params)), (hidden, positions),
            {"mode": mode})

    def _stage(self, stacked, hidden, positions, mode):
        per_layer = [torch.unbind(p) for p in stacked]
        for i in range(len(per_layer[0])):
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

    def forward(self, hidden, positions, mode=None):
        from ...distributed.pipeline import num_stages, pipeline_apply
        stacked = [getattr(self, n.replace(".", "__")) for n in self._names]
        mesh = mesh_mod.get_mesh(create=False)
        if mesh is not None and mesh.distributed and num_stages(mesh) > 1:
            return pipeline_apply(
                lambda ps, h, pos: self._stage(ps, h, pos, mode), stacked,
                hidden, positions,
                num_microbatches=max(self.config.pp_num_microbatches, 1),
                mesh=mesh)
        return self._stage(stacked, hidden, positions, mode)


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

    def forward(self, input_ids, positions=None, mode=None, caches=None):
        """Final hidden states [B, S, hidden] of a full-sequence causal
        forward.  ``positions`` default to ``arange(S)`` per row.  With
        ``caches`` (one dense ``{"k", "v"}`` buffer pair a layer, see
        ``LlamaForCausalLM.init_cache``) the call is incremental and
        returns (hidden, caches)."""
        c = self.config
        if positions is None:
            S = input_ids.shape[1]
            start = S * comm.axis_index(get_layout().act_axis("seq")) \
                if self.splits_sequence() else 0
            positions = torch.arange(
                start, start + S, dtype=torch.int32,
                device=input_ids.device)[None, :].expand(input_ids.shape)
        hidden = self.embed_tokens(input_ids)
        if c.compute_dtype:
            hidden = hidden.to(to_torch(c.compute_dtype))
        if caches is not None:
            if self.decoder is not None:
                raise NotImplementedError(_SCAN_LAYERS_KV_MSG)
            for layer, cache in zip(self.layers, caches):
                hidden, _ = layer.forward_cached(hidden, positions, cache,
                                                 mode=mode)
            return self.norm(hidden), caches
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

    def splits_sequence(self) -> bool:
        """Whether the forward takes this rank's block of the sequence
        (``sequence_parallel`` or ``context_parallel`` under ``sp`` above
        1): the train step then cuts dim 1 of the batch over ``sp``."""
        return _seq_split(self.config) > 1

    def forward_paged(self, input_ids, positions, pools, block_tables,
                      write_mask, verify_mode: bool = False, mode=None,
                      min_rows=None):
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
                                            mode=mode, min_rows=min_rows)
        return _rows(self.norm, hidden, min_rows), pools


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
        emb = self.model.embed_tokens
        if emb.weight.shape[0] != emb._num_embeddings:
            # the tied table's rows are split over tp: this rank's vocab
            # columns, gathered
            axis = get_layout().param_spec("embedding")[0]
            part = comm.copy_to_region(h, axis) @ emb.weight.float().T
            return comm.gather_from_region(part, axis, -1)
        return h @ emb.weight.float().T

    def _head_weight(self):
        """The head's weight whole (gathered over tp where split) and
        whether it is the tied [V, H] table."""
        if self.lm_head is not None:
            w, dim, transposed = self.lm_head.weight, 1, False
            split = self.lm_head.split()
        else:
            w, dim, transposed = self.model.embed_tokens.weight, 0, True
            split = w.shape[0] != self.config.vocab_size
        if split:
            axis = get_layout().param_spec("col_linear")[1]
            w = comm.gather_from_region(w, axis, dim)
        return w, transposed

    def forward(self, input_ids, labels=None, positions=None, mode=None):
        """Logits [B, S, V] (f32), or ``(loss, logits)`` when ``labels``
        are given: next-token cross entropy (the shift is done here,
        label -100 is ignored, the mean is over valid tokens).  Inside a
        train step that keeps only the loss, at long sequences and large
        logits, the loss is the chunked one and the logits ``None`` (the
        module docstring).  ``mode`` forwards to the attention kernels'
        dispatch."""
        hidden = self.model(input_ids, positions, mode=mode)
        if labels is None:
            return self._logits(hidden)
        B, S = hidden.shape[0], hidden.shape[1]
        logits_bytes = B * S * self.config.vocab_size * 4
        chunked = (keeps_loss_only() and S - 1 >= 2 * _LOSS_CHUNK
                   and logits_bytes >= _CHUNK_BYTES_MIN)
        if self.model.splits_sequence():
            return self._split_sequence_loss(hidden, labels, chunked)
        if chunked:
            w, transposed = self._head_weight()
            return _chunked_causal_lm_loss(hidden, w, labels,
                                           transposed), None
        logits = self._logits(hidden)
        return _causal_lm_loss(logits, labels), logits

    def _split_sequence_loss(self, hidden, labels, chunked):
        """The causal LM loss of a sequence split over ``sp``: position i
        of this block pairs with label i + 1, the block's last position
        with the next block's first label (none on the last block); each
        rank sums its positions' losses over the global count of valid
        labels, and the ranks' sums add up to the loss (identity
        backward: each rank's part takes the cotangent once)."""
        axis = get_layout().act_axis("seq")
        n, r = comm.axis_size(axis), comm.axis_index(axis)
        lb = labels.long()
        nxt = comm.ppermute(lb[:, :1].contiguous(), axis,
                            [(i, i - 1) for i in range(1, n)])
        if r == n - 1:
            nxt = torch.full_like(nxt, -100)
        lb = torch.cat([lb[:, 1:], nxt], dim=1)
        if chunked:
            w, transposed = self._head_weight()
            s_nll, cnt = _chunked_nll(hidden, lb, w, transposed)
            logits = None
        else:
            logits = self._logits(hidden)
            s_nll, cnt = _nll_sum(logits, lb)
        total = comm.psum(cnt.float(), axis).clamp_min(1.0)
        return comm.reduce_from_region(s_nll / total, axis), logits

    def generate(self, input_ids, **kwargs):
        """Autoregressive decoding (greedy, sampling, beam search): see
        :func:`paddle_tpu_torch.text.generation.generate`."""
        from ..generation import generate
        return generate(self, input_ids, **kwargs)

    def supports_kv_cache(self) -> bool:
        # the stacked decoder and a sequence split over sp (ring /
        # Ulysses exchange) take the full-recompute path
        c = self.config
        return (self.model.decoder is None and not c.context_parallel
                and not c.sequence_parallel)

    def init_cache(self, batch_size: int, max_len: int):
        """Per-layer dense K/V buffers [B, max_len, KH, D] in the compute
        dtype on the model's device; slot index == absolute position."""
        if not self.supports_kv_cache():
            raise NotImplementedError(_SCAN_LAYERS_KV_MSG)
        c = self.config
        dt = to_torch(c.compute_dtype) if c.compute_dtype else torch.float32
        shape = (int(batch_size), int(max_len), c.kv_heads, c.head_dim)
        return [{"k": torch.zeros(shape, dtype=dt, device=self.device),
                 "v": torch.zeros(shape, dtype=dt, device=self.device)}
                for _ in range(c.num_hidden_layers)]

    def forward_with_cache(self, input_ids, positions, caches,
                           last_logits_only: bool = False, mode=None):
        """(logits, caches) for the given token block; the caches advance
        in place.  ``last_logits_only`` projects only the last position
        (a prefill needs the last token's logits alone)."""
        hidden, caches = self.model(input_ids, positions, mode=mode,
                                    caches=caches)
        if last_logits_only:
            hidden = hidden[:, -1:]
        return self._logits(hidden), caches

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
                      mode=None, min_rows=None):
        """(logits, pools) through the block-paged cache (pools updated
        in place).  With ``gather_at`` [B] the hidden states are taken
        at those positions before the vocab projection, so a prefill
        pays for a [B, 1, V] projection, not [B, S, V].  ``min_rows``
        floors the rows of every projection, every norm and the head (see
        :func:`_rows`): a server passes it so a position's bits do not
        depend on the size of the call that computes it."""
        hidden, pools = self.model.forward_paged(
            input_ids, positions, pools, block_tables, write_mask,
            verify_mode=verify_mode, mode=mode, min_rows=min_rows)
        if gather_at is not None:
            idx = gather_at.long()[:, None, None].expand(
                -1, 1, hidden.shape[-1])
            hidden = torch.gather(hidden, 1, idx)
        return _rows(self._logits, hidden, min_rows), pools


def _causal_lm_loss(logits, labels):
    """Mean next-token negative log-likelihood: f32 log-softmax of
    ``logits[:, :-1]`` against ``labels[:, 1:]``, label < 0 ignored, the
    sum divided by the number of valid labels (at least 1)."""
    s_nll, cnt = _nll_sum(logits[:, :-1, :], labels[:, 1:].long())
    return s_nll / cnt.clamp_min(1)


def _nll_sum(logits, lb):
    """The summed NLL of ``logits`` [B, S, V] against the aligned labels
    ``lb`` [B, S] (label < 0 ignored) and the count of valid labels."""
    valid = lb >= 0
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, torch.where(valid, lb, 0)[..., None])[..., 0]
    nll = torch.where(valid, nll, torch.zeros((), device=nll.device))
    return nll.sum(), valid.sum()


_LOSS_CHUNK = 256    # sequence positions a loss chunk
# the chunked loss engages only where the full f32 [B, S, V] logits would
# take this much (the reference's threshold)
_CHUNK_BYTES_MIN = int(1.5 * 1024 ** 3)


class _ProjChunk(torch.autograd.Function):
    """[B, C, H] @ [H, V] in f32 (the inputs upcast exactly, as
    :meth:`LlamaForCausalLM._logits` computes them), whose backward rounds
    the cotangent to the weights' dtype and returns each gradient in its
    input's dtype: the reference's ``_proj_chunk`` custom vjp."""

    @staticmethod
    def forward(ctx, hc, wm):
        ctx.save_for_backward(hc, wm)
        return torch.matmul(hc.float(), wm.float())

    @staticmethod
    def backward(ctx, g):
        hc, wm = ctx.saved_tensors
        gl = g.to(wm.dtype).float()
        dhc = torch.matmul(gl, wm.float().t())
        dwm = torch.matmul(hc.float().reshape(-1, hc.shape[-1]).t(),
                           gl.reshape(-1, gl.shape[-1]))
        return dhc.to(hc.dtype), dwm.to(wm.dtype)


def _chunk_nll(hc, lc, wm):
    """One chunk's summed next-token NLL and its count of valid labels."""
    lg = _ProjChunk.apply(hc, wm)
    valid = lc >= 0
    logp = torch.log_softmax(lg, dim=-1)
    nll = -torch.gather(logp, -1, torch.where(valid, lc, 0)[..., None])[..., 0]
    nll = torch.where(valid, nll, torch.zeros((), device=nll.device))
    return nll.sum(), valid.sum()


def _chunked_causal_lm_loss(hidden, w, labels, transposed):
    """Next-token cross entropy streamed over chunks of ``_LOSS_CHUNK``
    positions: a chunk's f32 logits [B, C, V] are the only vocab-sized
    temporary, and each chunk runs under its own checkpoint, so the
    backward recomputes them instead of keeping them.  ``w`` is [H, V]
    (``lm_head``) or [V, H] with ``transposed`` (the tied embedding).
    The forward's numbers are :func:`_causal_lm_loss`'s (the same
    rounding of the inputs, f32 log-softmax, -100 ignored, the sum over
    the valid count); the projection's cotangents are rounded to the
    weights' dtype (:class:`_ProjChunk`)."""
    s_nll, s_cnt = _chunked_nll(hidden[:, :-1, :], labels[:, 1:].long(), w,
                                transposed)
    return s_nll / s_cnt.clamp_min(1).float()


def _chunked_nll(h, lb, w, transposed):
    """:func:`_chunked_causal_lm_loss`'s sum and count over hidden states
    ``h`` [B, n, H] and their aligned labels ``lb`` [B, n]."""
    n = h.shape[1]
    C = _LOSS_CHUNK
    pad = -(-n // C) * C - n
    if pad:
        h = torch.nn.functional.pad(h, (0, 0, 0, pad))
        lb = torch.nn.functional.pad(lb, (0, pad), value=-100)
    wm = w.t() if transposed else w          # [H, V], compute dtype
    s_nll = torch.zeros((), dtype=torch.float32, device=h.device)
    s_cnt = torch.zeros((), dtype=torch.int64, device=h.device)
    for c0 in range(0, n + pad, C):
        nll, cnt = checkpoint(_chunk_nll, h[:, c0:c0 + C], lb[:, c0:c0 + C],
                              wm, use_reentrant=False)
        s_nll = s_nll + nll
        s_cnt = s_cnt + cnt
    return s_nll, s_cnt
