"""The PyTorch port's GenerationServer: the whole serving slice against
the JAX reference on the CPU, and the port's own serving contracts.

Whole slice: the JAX ``GenerationServer`` and the port's serve the same
weights (``initializer_range=0.5`` so logits have margins, f32 compute,
int8 KV pools) and three greedy requests of mixed lengths; the token
streams must be identical.  Before demanding equality the test checks
that every emitted token's top-2 logit margin exceeds 10x the logit
tolerance (1e-4), so a near-tie fails with a message instead of flaking.

Port-only: eviction and re-admission with ``check_replay`` on the
tightest legal pool, position-pure seeded sampling across an eviction,
exact block accounting after drain, typed errors and cancellation.
"""
import numpy as np
import pytest

import torch

import paddle_tpu as paddle
from paddle_tpu.inference import GenerationServer as JaxServer
from paddle_tpu.text.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.text.models import llama_tiny as jax_tiny

from paddle_tpu_torch.framework.io import load_jax_state_dict
from paddle_tpu_torch.inference import (GenerationServer, RequestTimeout,
                                        ServerClosed, ServerDraining,
                                        ServerOverloaded)
from paddle_tpu_torch.inference.generation_server import _sample
from paddle_tpu_torch.ops.kernels import registry
from paddle_tpu_torch.text.models import LlamaForCausalLM, llama_tiny

CFG = dict(kv_cache_dtype="int8", compute_dtype="float32",
           initializer_range=0.5)
LOGIT_TOL = 1e-4
SERVE = dict(num_slots=4, block_size=8, max_model_len=64,
             prompt_buckets=[16, 32], max_prefill_batch=1,
             request_timeout_s=120.0)


@pytest.fixture(scope="module")
def models():
    paddle.seed(0)
    jm = JaxLlama(jax_tiny(**CFG))
    jm.eval()
    arrays = {k: np.asarray(v._value).astype(np.float32)
              for k, v in jm.state_dict().items()}
    tm = LlamaForCausalLM(llama_tiny(**CFG), device="cpu")
    load_jax_state_dict(tm, arrays)
    return jm, tm


def _prompts(seed=0, lens=(5, 13, 20)):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, 256, (n,)).astype(np.int32) for n in lens]


def _stream_logits(tm, prompt, gen):
    """Teacher-forced logits of the port's paged path for one stream:
    row j scores token j of ``gen``."""
    bs, L = 8, len(prompt)
    M = -(-(L + len(gen)) // bs)
    pools = tm.init_paged_cache(M + 1, bs)
    tbl = torch.arange(1, M + 1, dtype=torch.int32)[None]
    rows = []
    with torch.no_grad():
        lg, _ = tm.forward_paged(
            torch.from_numpy(prompt)[None], torch.arange(L)[None], pools,
            tbl, torch.ones(1, L, dtype=torch.bool),
            gather_at=torch.tensor([L - 1]))
        rows.append(lg[0, -1])
        for j, t in enumerate(gen[:-1]):
            lg, _ = tm.forward_paged(
                torch.tensor([[t]]), torch.tensor([[L + j]]), pools, tbl,
                torch.ones(1, 1, dtype=torch.bool))
            rows.append(lg[0, -1])
    return torch.stack(rows).numpy()


def test_whole_slice_matches_jax_server(models):
    jm, tm = models
    prompts = _prompts()
    jsrv = JaxServer(jm, **SERVE)
    jsrv.start(prewarm=False)
    try:
        ref = [s.result(timeout=300) for s in
               [jsrv.submit(p, max_new_tokens=8) for p in prompts]]
    finally:
        jsrv.stop()
    with GenerationServer(tm, **SERVE) as srv:
        got = [s.result(timeout=300) for s in
               [srv.submit(p, max_new_tokens=8) for p in prompts]]
        st = srv.stats()
    for p, g in zip(prompts, got):
        lg = _stream_logits(tm, p, g)
        assert lg.argmax(-1).tolist() == g      # the server's own choice
        top2 = np.sort(lg, axis=-1)[:, -2:]
        margin = (top2[:, 1] - top2[:, 0]).min()
        assert margin > 10 * LOGIT_TOL, (
            f"near-tie: top-2 margin {margin:.2e} for prompt {p.tolist()} "
            "-- equal streams cannot be demanded at this tolerance")
    assert got == ref
    assert st["free_blocks"] == st["total_blocks"]
    assert st["tokens_generated"] == 3 * 8


def _tight(tm, **kw):
    """The tightest legal pool: one max-length sequence + the trash
    block, shared by two slots."""
    return GenerationServer(tm, num_slots=2, block_size=4,
                            max_model_len=32, num_blocks=32 // 4 + 1,
                            prompt_buckets=[16, 32], check_replay=True,
                            request_timeout_s=120.0, **kw)


def test_eviction_readmission_replays_exactly(models):
    _, tm = models
    prompts = _prompts(1, lens=(10, 9, 11))
    with GenerationServer(tm, **SERVE) as srv:
        ref = [s.result(timeout=300) for s in
               [srv.submit(p, max_new_tokens=14) for p in prompts]]
    srv = _tight(tm).start()
    try:
        got = [s.result(timeout=300) for s in
               [srv.submit(p, max_new_tokens=14) for p in prompts]]
        st = srv.stats()
    finally:
        srv.stop()
    assert st["evicted"] >= 1 and st["readmitted"] >= 1
    assert st["replay_steps"] >= 1
    assert got == ref
    assert st["free_blocks"] == st["total_blocks"] == 8


def test_seeded_sampling_is_position_pure_across_eviction(models):
    _, tm = models
    prompts = _prompts(2, lens=(10, 12))
    kw = dict(max_new_tokens=14, do_sample=True, temperature=0.8,
              top_k=20, top_p=0.9)
    with GenerationServer(tm, **SERVE) as srv:
        a = [srv.submit(p, seed=7 + i, **kw).result(timeout=300)
             for i, p in enumerate(prompts)]
        b = [s.result(timeout=300) for s in
             [srv.submit(p, seed=7 + i, **kw)
              for i, p in enumerate(prompts)]]
        c = srv.submit(prompts[0], seed=99, **kw).result(timeout=300)
    srv = _tight(tm).start()
    try:
        d = [s.result(timeout=300) for s in
             [srv.submit(p, seed=7 + i, **kw)
              for i, p in enumerate(prompts)]]
        st = srv.stats()
    finally:
        srv.stop()
    assert a == b == d
    assert c != a[0]
    assert st["evicted"] >= 1
    assert st["free_blocks"] == st["total_blocks"]


def test_sample_rows():
    rng = np.random.default_rng(3)
    lg = torch.from_numpy(rng.standard_normal((4, 50)).astype(np.float32))
    B = 4
    ones, zeros = np.ones(B, np.float32), np.zeros(B, np.int32)
    greedy = _sample(lg, np.arange(B), np.zeros(B), ones, zeros, ones,
                     np.zeros(B, bool))
    assert greedy.tolist() == lg.argmax(-1).tolist()
    k1 = _sample(lg, np.arange(B), np.zeros(B), ones, np.ones(B, np.int32),
                 ones, np.ones(B, bool))
    assert k1.tolist() == greedy.tolist()     # top_k=1 leaves the argmax
    seeds, steps = np.array([5, 6, 7, 8]), np.array([3, 3, 4, 9])
    x = _sample(lg, seeds, steps, ones, zeros, ones, np.ones(B, bool))
    # the draw depends on (seed, step, logits) only, not on the row
    perm = [2, 0, 3, 1]
    y = _sample(lg[perm], seeds[perm], steps[perm], ones, zeros, ones,
                np.ones(B, bool))
    assert y.tolist() == x[perm].tolist()


def test_typed_errors_and_cancel(models):
    _, tm = models
    srv = GenerationServer(tm, **SERVE)
    with pytest.raises(ServerClosed):
        srv.submit(_prompts()[0])
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        GenerationServer(tm, prefix_cache=True)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        GenerationServer(tm, draft_model=tm)
    with pytest.raises(ValueError, match="max_model_len"):
        GenerationServer(tm, max_model_len=64, block_size=8, num_blocks=8)
    srv.start()
    try:
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            srv.submit(_prompts()[0], replay_tokens=[1])
        with pytest.raises(ValueError, match="exceeds max_model_len"):
            srv.submit(_prompts()[0], max_new_tokens=64)
        s = srv.submit(_prompts()[0], max_new_tokens=40)
        assert srv.cancel(s.request_id) is True
        assert s.result(timeout=60) == s.tokens
        assert s.finish_reason == "cancelled"
        assert srv.cancel(10 ** 6) is False
        srv.drain_begin()
        with pytest.raises(ServerDraining):
            srv.submit(_prompts()[0])
    finally:
        srv.stop()
    st = srv.stats()
    assert st["cancelled"] == 1 and st["shed_draining"] == 1
    assert st["free_blocks"] == st["total_blocks"]


def test_overload_and_wait_timeout(models):
    _, tm = models
    with GenerationServer(tm, max_waiting=0, **SERVE) as srv:
        with pytest.raises(ServerOverloaded):
            srv.submit(_prompts()[0])
    one = dict(SERVE, num_slots=1)
    with GenerationServer(tm, **one) as srv:
        long = srv.submit(_prompts()[0], max_new_tokens=40)
        late = srv.submit(_prompts()[1], timeout_s=0.0)
        with pytest.raises(RequestTimeout):
            late.result(timeout=60)
        assert len(long.result(timeout=120)) == 40
        assert srv.stats()["shed_timeout"] == 1


def test_stats_keys_match_reference_except_compile_counters(models):
    jm, tm = models
    jsrv = JaxServer(jm, **SERVE)
    ours = set(GenerationServer(tm, **SERVE).stats())
    compile_keys = {"num_compiles", "bucket_compiles", "prewarm_compiles",
                    "traffic_compiles"}
    assert ours == set(jsrv.stats()) - compile_keys


def test_serving_on_cpu_never_launches_a_kernel(models):
    _, tm = models
    registry.reset_counts()
    with GenerationServer(tm, **SERVE) as srv:
        srv.submit(_prompts()[0], max_new_tokens=3).result(timeout=60)
    assert registry.launch_counts() == dict.fromkeys(registry.kernels(), 0)
    assert registry.spec("flash_attention").torch_ref_calls > 0
    assert registry.spec("int8_kv_attention").torch_ref_calls > 0
