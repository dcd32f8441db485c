"""BERT/ERNIE-family bidirectional encoder with the pretraining heads:
the reference's ``text/models/bert.py``.

Ported: ``BertConfig`` and the named configs, ``BertEmbeddings``,
``BertSelfAttention``, ``BertLayer`` (post-norm residual blocks),
``BertModel`` (``layers.0 ... layers.N-1`` and the pooler with its tanh),
``BertForPretraining`` and ``BertPretrainingCriterion``, under the
reference's parameter names and [in, out] linear layouts, so a JAX
``state_dict`` loads with ``load_jax_state_dict`` as it is.

Each function keeps the reference's dtype steps: LayerNorm takes f32
moments and casts back to its input's dtype, ``linear`` promotes like
``jnp.matmul``, the padding mask becomes ``(1 - mask) * finfo(dtype).min``
in the attention's dtype, and the criterion computes in f32 (as XLA
computes the reference's bf16 expression: see the criterion).

Attention follows the reference's branch (``bert.py:146-163``): with a
padding mask, or below the flash kernels' length, the plain attention
(``_sdpa_ref``, with dropout on the softmax weights in training); with
no mask at flash-eligible shapes the flash kernels, which in training
drop the attention weights inside kernels 1-3 from a seed drawn from the
model's dropout generator (one int64 a layer, on the device), so that
``DistributedTrainStep``'s generator replay under ``recompute`` redraws
the same seed and the recomputed forward the same mask.
``kernel_mode`` (None, or ``"torch_ref"``: the plain versions) on an
attention layer forwards to the flash kernels' dispatch
(``registry.set_kernel_mode`` sets it on every layer of a model).

Dropout masks come from one ``torch.Generator`` on the model's device
(``dropout_generator``, default: the global seed + 1), shared by every
dropout of the model; they have no bit parity with ``jax.random``.

``BertForPretraining`` gathers the masked positions before the decoder,
so the [B, S, V] logits never exist, and decodes with the word embedding
itself: one parameter, whose gradient sums both uses.

Not ported: tensor-parallel sharding of the parallel linears (they run
at world 1).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from ... import make_generator, resolve_device
from ...framework.dtype import promote, to_torch
from ...nn import functional as F
from ...nn.layer import (ColumnParallelLinear, Dropout, Embedding, LayerNorm,
                         Linear, Normal, RowParallelLinear, Tanh,
                         VocabParallelEmbedding)
from ...ops.kernels.flash_attention import (dropout_seed, flash_attention,
                                            flash_eligible)

__all__ = ["BertConfig", "BertModel", "BertForPretraining",
           "BertPretrainingCriterion", "bert_base", "bert_large",
           "bert_tiny", "ernie_base"]


@dataclasses.dataclass
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    hidden_act: str = "gelu"
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    initializer_range: float = 0.02
    layer_norm_eps: float = 1e-12

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads


def bert_tiny(**kw) -> BertConfig:
    d = dict(vocab_size=1024, hidden_size=128, num_hidden_layers=2,
             num_attention_heads=2, intermediate_size=512,
             max_position_embeddings=128)
    d.update(kw)
    return BertConfig(**d)


def bert_base(**kw) -> BertConfig:
    return BertConfig(**kw)


def bert_large(**kw) -> BertConfig:
    d = dict(hidden_size=1024, num_hidden_layers=24,
             num_attention_heads=16, intermediate_size=4096)
    d.update(kw)
    return BertConfig(**d)


def ernie_base(**kw) -> BertConfig:
    """ERNIE-base shares BERT-base geometry (ERNIE differs in pretraining
    data and masking, not architecture)."""
    d = dict(vocab_size=18000)
    d.update(kw)
    return BertConfig(**d)


class BertEmbeddings(nn.Module):
    """word + position + token-type embeddings -> LayerNorm -> dropout."""

    def __init__(self, c: BertConfig, kw, drop_gen):
        super().__init__()
        init = Normal(0.0, c.initializer_range)
        self.word_embeddings = VocabParallelEmbedding(
            c.vocab_size, c.hidden_size, weight_attr=init, **kw)
        self.position_embeddings = Embedding(
            c.max_position_embeddings, c.hidden_size, weight_attr=init, **kw)
        self.token_type_embeddings = Embedding(
            c.type_vocab_size, c.hidden_size, weight_attr=init, **kw)
        self.layer_norm = LayerNorm(c.hidden_size, epsilon=c.layer_norm_eps,
                                    device=kw["device"], dtype=kw["dtype"])
        self.dropout = Dropout(c.hidden_dropout_prob, generator=drop_gen)

    def forward(self, input_ids, token_type_ids=None, position_ids=None):
        B, S = input_ids.shape
        if position_ids is None:
            position_ids = torch.arange(
                S, dtype=torch.int32, device=input_ids.device)[None, :] \
                .expand(B, S)
        if token_type_ids is None:
            token_type_ids = torch.zeros((B, S), dtype=torch.int32,
                                         device=input_ids.device)
        emb = (self.word_embeddings(input_ids)
               + self.position_embeddings(position_ids)
               + self.token_type_embeddings(token_type_ids))
        return self.dropout(self.layer_norm(emb))


class BertSelfAttention(nn.Module):
    """Bidirectional multi-head attention: one fused Q/K/V projection
    (column-parallel), split into Q, K, V in that order, and the output
    projection (row-parallel)."""

    def __init__(self, c: BertConfig, kw, drop_gen):
        super().__init__()
        init = Normal(0.0, c.initializer_range)
        self.config = c
        self.qkv_proj = ColumnParallelLinear(
            c.hidden_size, 3 * c.hidden_size, weight_attr=init,
            has_bias=True, **kw)
        self.out_proj = RowParallelLinear(
            c.hidden_size, c.hidden_size, weight_attr=init, has_bias=True,
            **kw)
        self.dropout_p = c.attention_probs_dropout_prob
        self.generator = drop_gen
        self.kernel_mode = None

    def forward(self, hidden, attention_mask=None):
        c = self.config
        qkv = self.qkv_proj(hidden)
        B, S = qkv.shape[0], qkv.shape[1]
        H, D = c.num_attention_heads, c.head_dim
        q, k, v = (t.reshape(B, S, H, D)
                   for t in qkv.split(c.hidden_size, dim=-1))
        drop_p = self.dropout_p if self.training else 0.0
        with torch.profiler.record_function("attention"):
            if attention_mask is None and flash_eligible(S, D,
                                                         dropout=drop_p):
                seed = (dropout_seed(self.generator) if drop_p > 0.0
                        else None)
                o = flash_attention(q, k, v, causal=False, dropout_p=drop_p,
                                    seed=seed, mode=self.kernel_mode)
            else:
                m = None
                if attention_mask is not None:
                    # [B, S] 1/0 padding mask -> additive [B, 1, 1, S]
                    m = ((1.0 - attention_mask[:, None, None, :].to(q.dtype))
                         * torch.finfo(q.dtype).min)
                o = F._sdpa_ref(q, k, v, m, drop_p, False, None,
                                generator=self.generator)
        return self.out_proj(o.reshape(B, S, c.hidden_size))


class BertLayer(nn.Module):
    def __init__(self, c: BertConfig, kw, drop_gen):
        super().__init__()
        init = Normal(0.0, c.initializer_range)
        nkw = dict(device=kw["device"], dtype=kw["dtype"])
        self.attention = BertSelfAttention(c, kw, drop_gen)
        self.intermediate = ColumnParallelLinear(
            c.hidden_size, c.intermediate_size, weight_attr=init,
            has_bias=True, **kw)
        self.output = RowParallelLinear(
            c.intermediate_size, c.hidden_size, weight_attr=init,
            has_bias=True, **kw)
        self.norm1 = LayerNorm(c.hidden_size, epsilon=c.layer_norm_eps, **nkw)
        self.norm2 = LayerNorm(c.hidden_size, epsilon=c.layer_norm_eps, **nkw)
        self.dropout = Dropout(c.hidden_dropout_prob, generator=drop_gen)
        self.act = getattr(F, c.hidden_act)

    def forward(self, hidden, attention_mask=None):
        # post-norm residual blocks, the BERT-original layout
        h = self.norm1(hidden + self.dropout(
            self.attention(hidden, attention_mask)))
        ff = self.output(self.act(self.intermediate(h)))
        return self.norm2(h + self.dropout(ff))


def _setup(device, dtype, generator, dropout_generator):
    """(layer keywords, dropout generator) of a BERT model: weights on
    ``device`` (default ``cuda``: raises without a card) in ``dtype``
    (default float32) drawn from ``generator`` (default: the global
    seed), masks from ``dropout_generator`` (default: the global seed +
    1, on ``device``)."""
    dev = resolve_device(device)
    dt = to_torch(dtype) if dtype is not None else torch.float32
    gen = generator if generator is not None else make_generator(dev)
    drop = (dropout_generator if dropout_generator is not None
            else make_generator(dev, offset=1))
    return dict(device=dev, dtype=dt, generator=gen), drop


class BertModel(nn.Module):
    """Encoder trunk -> (sequence_output, pooled_output)."""

    def __init__(self, config: BertConfig, device=None, dtype=None,
                 generator: Optional[torch.Generator] = None,
                 dropout_generator: Optional[torch.Generator] = None):
        super().__init__()
        kw, drop = _setup(device, dtype, generator, dropout_generator)
        c = config
        self.config = c
        self.embeddings = BertEmbeddings(c, kw, drop)
        self.layers = nn.ModuleList([BertLayer(c, kw, drop)
                                     for _ in range(c.num_hidden_layers)])
        self.pooler = Linear(c.hidden_size, c.hidden_size,
                             weight_attr=Normal(0.0, c.initializer_range),
                             **kw)
        self.pooler_act = Tanh()

    def forward(self, input_ids, token_type_ids=None, position_ids=None,
                attention_mask=None):
        h = self.embeddings(input_ids, token_type_ids, position_ids)
        for layer in self.layers:
            h = layer(h, attention_mask)
        pooled = self.pooler_act(self.pooler(h[:, 0]))
        return h, pooled


class BertForPretraining(nn.Module):
    """MLM + NSP heads: the MLM transform, GELU and LayerNorm, then a
    decoder tied to ``bert.embeddings.word_embeddings.weight`` plus a
    fresh zero ``mlm_bias``; the NSP classifier on the pooled [CLS]."""

    def __init__(self, config: BertConfig, device=None, dtype=None,
                 generator: Optional[torch.Generator] = None,
                 dropout_generator: Optional[torch.Generator] = None):
        super().__init__()
        kw, drop = _setup(device, dtype, generator, dropout_generator)
        c = config
        self.config = c
        init = Normal(0.0, c.initializer_range)
        self.bert = BertModel(c, dropout_generator=drop, **kw)
        self.mlm_transform = Linear(c.hidden_size, c.hidden_size,
                                    weight_attr=init, **kw)
        self.mlm_norm = LayerNorm(c.hidden_size, epsilon=c.layer_norm_eps,
                                  device=kw["device"], dtype=kw["dtype"])
        self.act = getattr(F, c.hidden_act)
        self.mlm_bias = nn.Parameter(torch.zeros(
            c.vocab_size, device=kw["device"], dtype=torch.float32))
        self.nsp = Linear(c.hidden_size, 2, weight_attr=init, **kw)

    def forward(self, input_ids, token_type_ids=None, position_ids=None,
                attention_mask=None, masked_positions=None):
        """(mlm_logits, nsp_logits).  ``masked_positions`` [B, M] ints:
        decode the MLM logits only at those positions ([B, M, V]);
        ``None`` decodes every position ([B, S, V])."""
        seq, pooled = self.bert(input_ids, token_type_ids, position_ids,
                                attention_mask)
        if masked_positions is not None:
            idx = masked_positions.long()[:, :, None].expand(
                -1, -1, seq.shape[-1])
            seq = torch.gather(seq, 1, idx)
        h = self.mlm_norm(self.act(self.mlm_transform(seq)))
        w = self.bert.embeddings.word_embeddings.weight      # [V, H]
        with torch.profiler.record_function("mlm_decode"):
            dt = promote(h.dtype, w.dtype)
            mlm_logits = torch.matmul(h.to(dt), w.to(dt).t()) + self.mlm_bias
        return mlm_logits, self.nsp(pooled)


def _ce_rows(lg, labels):
    """Per-row f32 cross entropy, the reference's max-subtracted form:
    log(sum(exp(lg - max))) - (lg - max)[label]."""
    lg = lg.float()
    lp = lg - torch.amax(lg, dim=-1, keepdim=True)
    lse = torch.log(torch.exp(lp).sum(-1))
    return lse - torch.gather(lp, -1, labels.long()[..., None])[..., 0]


class BertPretrainingCriterion(nn.Module):
    """Masked-position MLM cross entropy (weighted by ``mlm_weights``,
    divided by their sum, at least 1) plus the mean NSP cross entropy,
    in f32 whatever the logits' dtype.  The reference writes it in the
    logits' dtype, but XLA keeps f32 between the fused operations of a
    bf16 expression (excess precision), so its bf16-AMP loss comes out
    with f32 precision (7.5546875 where a bf16 loss would be 7.5625)."""

    def __init__(self, vocab_size: int):
        super().__init__()
        self.vocab_size = vocab_size

    def forward(self, mlm_logits, nsp_logits, mlm_labels, nsp_labels,
                mlm_weights=None):
        with torch.profiler.record_function("loss"):
            tok = _ce_rows(mlm_logits, mlm_labels)
            if mlm_weights is None:
                mlm_weights = torch.ones_like(tok)
            mlm = (tok * mlm_weights).sum() / torch.clamp_min(
                mlm_weights.sum(), 1.0)
            return mlm + _ce_rows(nsp_logits, nsp_labels).mean()
