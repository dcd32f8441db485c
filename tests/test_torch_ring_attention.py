"""The port's context-parallel attention (``ops/ring_attention.py``: ring
attention and Ulysses over ``sp``) against the JAX reference.

The port's side runs as four gloo rank processes on the CPU (one world
for the module), the cases in ``tests/torch_dist_worker.py``; the JAX
side is the reference's own full-attention check (``full_attention`` of
``tests/test_ring_attention.py``, written here in JAX) and its
``ring_attention`` / ``ulysses_attention`` on the same mesh of the 8
virtual devices.  Tolerances (f32): outputs within 2e-5 and gradients
within 5e-5 of full attention (the reference's), and within 2e-5 of
JAX's ring / Ulysses outputs; the Llama under context parallelism (ring
and Ulysses over sp 2, heads over tp 2) within 2e-4 of its unsharded
logits (the reference's).  The ranks' parts of an input's gradient sum
to its gradient."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import paddle_tpu as paddle
from paddle_tpu.distributed import mesh as jmesh
from paddle_tpu.ops import ring_attention as jra
from paddle_tpu.text.models import LlamaForCausalLM as JLlama
from paddle_tpu.text.models import llama_tiny as jtiny

import torch

from paddle_tpu_torch.ops import ring_attention as ra
from paddle_tpu_torch.distributed.spawn import spawn

import torch_dist_worker as worker
from torch_llama_ref import eager_uncached


def full_attention(q, k, v, causal):
    """(B, S, H, D) in f32: the reference test's full attention."""
    qh = jnp.swapaxes(q, 1, 2).astype(jnp.float32)
    kh = jnp.swapaxes(k, 1, 2).astype(jnp.float32)
    vh = jnp.swapaxes(v, 1, 2).astype(jnp.float32)
    s = jnp.einsum("bhqd,bhkd->bhqk", qh, kh) / np.sqrt(q.shape[-1])
    if causal:
        mask = np.tril(np.ones((q.shape[1], q.shape[1]), bool))
        s = jnp.where(mask, s, -1e30)
    p = jax.nn.softmax(s, axis=-1)
    return jnp.swapaxes(jnp.einsum("bhqk,bhkd->bhqd", p, vh), 1, 2)


def _qkv(b=2, s=32, h=4, d=8, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randn(b, s, h, d).astype("float32") for _ in range(3)]


def _llama(context):
    cfg = dict(compute_dtype="float32", sequence_parallel=True,
               context_parallel=context)
    paddle.seed(4)
    m = JLlama(jtiny(**cfg))
    return dict(kind="llama", mesh={"sp": 2, "tp": 2}, cfg=cfg,
                weights={k: np.asarray(v._value).copy()
                         for k, v in m.state_dict().items()},
                ids=np.random.RandomState(3).randint(
                    0, 256, (2, 32)).astype("int32"))


CASES = ([dict(kind=kind, mesh={"sp": 4}, causal=causal,
               qkv=_qkv(h=8, seed=i))
          for i, (kind, causal) in enumerate(
              [("ring", False), ("ring", True), ("ulysses", False),
               ("ulysses", True)])]
         + [dict(kind="ring", mesh={"dp": 2, "sp": 2}, causal=True,
                 qkv=_qkv(b=4, seed=9)),
            dict(kind="ulysses", mesh={"dp": 2, "sp": 2}, causal=True,
                 qkv=_qkv(b=4, seed=10)),
            dict(kind="refusals", mesh={"sp": 4}),
            _llama("ring"), _llama("ulysses")])


@pytest.fixture(scope="module")
def ranks():
    ctx = spawn(worker.ring_cases, args=(CASES,), nprocs=4, backend="gloo",
                timeout=60, join=False)
    got = []
    yield lambda: got[0] if got else got.append(ctx.join(300)) or got[0]
    ctx.close()


@pytest.fixture(autouse=True)
def _fresh_mesh():
    jmesh.set_mesh(None)
    yield
    jmesh.set_mesh(None)


def _full_grads(case):
    def loss(q, k, v):
        return jnp.sum(full_attention(q, k, v, case["causal"]) ** 2)
    return jax.grad(loss, argnums=(0, 1, 2))(*case["qkv"])


@pytest.mark.parametrize("i", range(6))
def test_attention_matches_full_and_jax_with_gradients(ranks, i):
    """Cases 0-3: ring and Ulysses over sp 4, causal or not; 4-5: both
    composed with dp 2 (the batch split over dp inside the call)."""
    case = CASES[i]
    got = [r[i] for r in ranks()]
    ref = np.asarray(full_attention(*case["qkv"], case["causal"]))
    mesh = jmesh.init_mesh(case["mesh"], devices=jax.devices()[:4])
    fn = jra.ring_attention if case["kind"] == "ring" else \
        jra.ulysses_attention
    jout = np.asarray(fn(*case["qkv"], causal=case["causal"], mesh=mesh))
    grads = _full_grads(case)
    for r in got:
        np.testing.assert_allclose(r["out"], ref, rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(r["out"], jout, rtol=2e-5, atol=2e-5)
    for j, g in enumerate(grads):
        total = sum(r["grads"][j] for r in got)
        np.testing.assert_allclose(total, np.asarray(g), rtol=5e-5,
                                   atol=5e-5)


def test_refusals_keep_the_reference_messages(ranks):
    got = ranks()[0][6]
    assert "heads-per-device 2 % sp=4 != 0" in got["ulysses_heads"]
    assert "use ring_attention" in got["ulysses_heads"]
    assert "sequence length 6 not divisible by sp=4" in got["ring_seq"]
    q = torch.zeros(1, 8, 2, 4)
    with pytest.raises(ValueError, match="needs a live mesh"):
        ra.ring_attention(q, q, q)
    with pytest.raises(ValueError, match="needs a live mesh"):
        ra.ulysses_attention(q, q, q)


@pytest.mark.parametrize("i", [7, 8])
def test_llama_context_parallel_matches_unsharded(ranks, i):
    """The Llama (layer list) with ring (7) or Ulysses (8) attention over
    sp 2 and its heads over tp 2 reproduces the unsharded JAX logits."""
    case = CASES[i]
    m = JLlama(jtiny(compute_dtype="float32"))
    m.set_state_dict({k: paddle.to_tensor(v)
                      for k, v in case["weights"].items()})
    with eager_uncached():
        ref = np.asarray(m(paddle.to_tensor(case["ids"]))._value)
    for r in ranks():
        np.testing.assert_allclose(r[i]["logits"], ref, rtol=2e-4,
                                   atol=2e-4)


def test_block_step_is_the_references_in_torch():
    """``_block_accumulate`` against the reference's on one block pair,
    and the KV-chunked attention against full attention (one process)."""
    rng = np.random.RandomState(2)
    q, k, v = [rng.randn(1, 2, 8, 4).astype(np.float32) for _ in range(3)]
    m = np.full((1, 2, 8), -1e30, np.float32)
    l = np.zeros((1, 2, 8), np.float32)
    acc = np.zeros((1, 2, 8, 4), np.float32)
    jm, jl, jacc = jra._block_accumulate(q, k, v, m, l, acc, 8, 4, True,
                                         0.5)
    tm, tl, tacc = ra._block_accumulate(
        *[torch.from_numpy(a) for a in (q, k, v, m, l, acc)], 8, 4, True,
        0.5)
    for a, b in ((tm, jm), (tl, jl), (tacc, jacc)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-6)
    qs, ks, vs = _qkv(b=1, s=48, h=2)
    out = ra._chunked_attention(
        *[torch.from_numpy(a).transpose(1, 2) for a in (qs, ks, vs)], 0,
        True, 1.0 / np.sqrt(8), chunk=16).transpose(1, 2)
    np.testing.assert_allclose(out.numpy(),
                               np.asarray(full_attention(qs, ks, vs, True)),
                               rtol=2e-5, atol=2e-5)
