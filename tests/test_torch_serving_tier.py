"""The PyTorch port's serving tier: prefix sharing, speculative decoding,
failover replay, migration and ``generate()``, against the JAX reference
on the CPU and on the port's own contracts.

Against JAX: the same weights (``initializer_range=0.5`` so logits have
margins, f32 compute, int8 KV pools) in both packages' servers, greedy,
a shared 20-token system prompt with three tails, a cold wave then a warm
one, in three modes (prefix sharing; speculation with a one-layer draft
of other weights, ``spec_k=3``; both).  Before demanding equal streams
each emitted token's top-2 logit margin must exceed 10x the logit
tolerance (1e-4), so a near-tie fails with a message instead of flaking.
``generate()`` (greedy and beam) and ``forward_with_cache`` logits are
held to the JAX model's at 1e-4, and ``_filter_logits`` to the JAX
function.

Port-only, mirroring the reference's ``tests/test_prefix_cache.py`` and
``tests/test_spec_decode.py``: warm equals cold (greedy and seeded
sampling), a copy-on-write fork never perturbs its sibling, refcounts
return to the index baseline after eviction, eviction and re-admission
under speculation with ``check_replay``, ``replay_tokens``, export and
import (tokens only and with KV rows), and the typed errors.
"""
import importlib

import numpy as np
import pytest

import jax.numpy as jnp
import torch

import paddle_tpu as paddle
from paddle_tpu.inference import GenerationServer as JaxServer
from paddle_tpu.text.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.text.models import llama_tiny as jax_tiny

from paddle_tpu_torch.framework.io import load_jax_state_dict
from paddle_tpu_torch.inference import (GenerationServer,
                                        MigrationUnsupported, ServeError,
                                        export_sequence, import_sequence)
from paddle_tpu_torch.text import generation
from paddle_tpu_torch.text.models import LlamaForCausalLM, llama_tiny

jgen = importlib.import_module("paddle_tpu.text.generation")

CFG = dict(kv_cache_dtype="int8", compute_dtype="float32",
           initializer_range=0.5)
LOGIT_TOL = 1e-4
SERVE = dict(num_slots=4, block_size=8, max_model_len=64,
             prompt_buckets=[16, 32], max_prefill_batch=2,
             request_timeout_s=120.0)


def _pair(seed, **kw):
    kw = dict(CFG, **kw)
    paddle.seed(seed)
    jm = JaxLlama(jax_tiny(**kw))
    jm.eval()
    arrays = {k: np.asarray(v._value).astype(np.float32)
              for k, v in jm.state_dict().items()}
    tm = LlamaForCausalLM(llama_tiny(**kw), device="cpu")
    load_jax_state_dict(tm, arrays)
    return jm, tm


@pytest.fixture(scope="module")
def models():
    """The target (2 layers) and a one-layer draft of other weights, in
    both packages."""
    jm, tm = _pair(0)
    jd, td = _pair(123, num_hidden_layers=1)
    return jm, tm, jd, td


def _chat(seed=0, tails=(3, 7, 12), system=20):
    rng = np.random.RandomState(seed)
    sys_p = rng.randint(1, 256, (system,)).astype(np.int32)
    return [np.concatenate([sys_p, rng.randint(1, 256, (n,))
                            .astype(np.int32)]) for n in tails]


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


def _check_margins(tm, prompts, outs):
    for p, g in zip(prompts, outs):
        lg = _stream_logits(tm, p, g)
        assert lg.argmax(-1).tolist() == g       # the stream is greedy
        top2 = np.sort(lg, axis=-1)[:, -2:]
        margin = (top2[:, 1] - top2[:, 0]).min()
        assert margin > 10 * LOGIT_TOL, (
            f"near-tie: top-2 margin {margin:.2e} for prompt {p.tolist()} "
            "-- equal streams cannot be demanded at this tolerance")


def _waves(srv, prompts, max_new=8):
    return [[srv.submit(p, max_new_tokens=max_new).result(timeout=300)
             for p in prompts] for _ in range(2)]


_MODES = {"prefix": dict(prefix_cache=True),
          "spec": dict(spec_k=3),
          "prefix_spec": dict(prefix_cache=True, spec_k=3)}


@pytest.mark.parametrize("mode", sorted(_MODES))
def test_server_matches_jax(models, mode):
    """Cold, then warm: the port's streams are the JAX server's, and
    the warm wave equals the cold one (prefix hits on the warm wave)."""
    jm, tm, jd, td = models
    kw = dict(_MODES[mode])
    prompts = _chat()
    jsrv = JaxServer(jm, draft_model=jd if "spec_k" in kw else None,
                     **SERVE, **kw)
    jsrv.start(prewarm=False)
    try:
        ref = _waves(jsrv, prompts)
    finally:
        jsrv.stop()
    with GenerationServer(tm, draft_model=td if "spec_k" in kw else None,
                          check_replay=True, **SERVE, **kw) as srv:
        got = _waves(srv, prompts)
        st = srv.stats()
    _check_margins(tm, prompts, got[0])
    assert got == ref
    assert got[1] == got[0]
    assert st["free_blocks"] == st["total_blocks"]
    if "prefix_cache" in kw:
        assert st["prefix_hit_tokens"] >= 3 * 16
        assert st["prefill_tokens_skipped"] >= 3 * 16
    if "spec_k" in kw:
        assert st["spec_verify_steps"] > 0 and st["spec_proposed"] > 0


# ---------------------------------------------------------------------
# the port's own contracts
# ---------------------------------------------------------------------

def _run(srv, prompts, sample=True, max_new=6, concurrent=False):
    kw = lambda i: dict(max_new_tokens=max_new,  # noqa: E731
                        do_sample=sample and (i % 2 == 1),
                        temperature=0.9, top_k=8, seed=100 + i)
    if concurrent:
        streams = [srv.submit(p, **kw(i)) for i, p in enumerate(prompts)]
        return [s.result(timeout=120) for s in streams]
    return [srv.submit(p, **kw(i)).result(timeout=120)
            for i, p in enumerate(prompts)]


def _small(tm, **kw):
    d = dict(num_slots=4, block_size=4, max_model_len=40,
             prompt_buckets=[8, 16, 32], max_prefill_batch=4,
             check_replay=True, request_timeout_s=120.0)
    d.update(kw)
    return GenerationServer(tm, **d).start()


def test_warm_equals_cold_and_skips_prefill(models):
    _, tm, _, _ = models
    prompts = _chat(1, tails=(1, 3, 2, 4), system=12)
    srv = _small(tm, prefix_cache=True)
    try:
        cold = _run(srv, prompts)
        st1 = srv.stats()
        warm = _run(srv, prompts)
        conc = _run(srv, prompts, concurrent=True)
        st2 = srv.stats()
        srv.flush_prefix_cache()
        st3 = srv.stats()
    finally:
        srv.stop()
    assert warm == cold == conc
    assert st2["prefix_hits"] > st1["prefix_hits"]
    assert st2["prefill_tokens_skipped"] > st1["prefill_tokens_skipped"]
    assert st2["prefix_hit_tokens"] - st1["prefix_hit_tokens"] >= 4 * 8
    assert st3["cached_blocks"] == 0 and st3["prefix_entries"] == 0
    assert st3["free_blocks"] == st3["total_blocks"]


def test_cow_fork_never_perturbs_the_sibling(models):
    """Stream A shares its prompt blocks; B aliases them with a partial
    tail inside one of A's full blocks, which forks before B's suffix
    prefill writes into it.  Both equal their solo runs."""
    _, tm, _, _ = models
    rng = np.random.RandomState(7)
    pa = rng.randint(1, 256, (16,)).astype(np.int32)    # 4 full blocks
    pb = pa[:10].copy()                                  # tail in block 2
    srv = _small(tm, prefix_cache=True)
    try:
        a_ref = srv.submit(pa, max_new_tokens=16).result(timeout=120)
        srv.flush_prefix_cache()
        b_ref = srv.submit(pb, max_new_tokens=6).result(timeout=120)
        srv.flush_prefix_cache()
        forks0 = srv.stats()["cow_forks"]
        a = srv.submit(pa, max_new_tokens=16)
        next(iter(a))                # A prefilled: its prompt is indexed
        b = srv.submit(pb, max_new_tokens=6)
        assert b.result(timeout=120) == b_ref
        assert a.result(timeout=120) == a_ref
        assert srv.stats()["cow_forks"] > forks0
    finally:
        srv.stop()


@pytest.mark.parametrize("spec", [False, True])
def test_eviction_refcounts_return_to_index_baseline(models, spec):
    """Shared-prefix traffic through an oversubscribed pool (with a draft
    too): evictions happen, re-admission replays under ``check_replay``,
    the streams equal the uncontended run, and afterwards only the
    index's own references remain."""
    _, tm, _, td = models
    prompts = [p[:10] for p in _chat(2, tails=(1, 3, 2, 4), system=12)]
    kw = dict(draft_model=td, spec_k=3) if spec else {}
    srv = _small(tm, prefix_cache=True, max_model_len=24, num_blocks=14,
                 prompt_buckets=[8, 16], max_prefill_batch=1, **kw)
    try:
        base = _run(srv, prompts, max_new=12)
        ev0 = srv.stats()["evicted"]
        conc = _run(srv, prompts, max_new=12, concurrent=True)
        st = srv.stats()
    finally:
        srv.stop()
    assert st["evicted"] > ev0, "the pool was never exhausted"
    assert conc == base
    assert st["free_blocks"] == st["total_blocks"]
    assert st["allocated_blocks"] == 0
    pc = srv._cache
    assert sum(pc.refcnt.values()) == len(pc.index)
    assert set(pc.refcnt) == set(pc.entry_of) == set(pc.lru)


def test_spec_same_weights_accepts_everything(models):
    """A draft with the target's weights accepts every proposal, needs
    fewer verify steps than tokens, and (with prefix sharing) withholds
    the tail its pools do not cover; sampled streams equal plain
    decode's."""
    _, tm, _, _ = models
    prompts = _chat(3, tails=(2, 5), system=12)
    srv = _small(tm)
    try:
        plain = _run(srv, prompts, max_new=10)
    finally:
        srv.stop()
    srv = _small(tm, draft_model=tm, spec_k=3, prefix_cache=True)
    try:
        got = _run(srv, prompts, max_new=10)
        warm = _run(srv, prompts, max_new=10)
        st = srv.stats()
    finally:
        srv.stop()
    assert got == plain == warm
    assert st["spec_accept_rate"] == 1.0
    assert st["spec_verify_steps"] < st["tokens_generated"]
    assert st["spec_index_withheld_tokens"] > 0


def test_warm_admission_survives_lru_only_pool(models):
    """Free list empty, the LRU holding exactly the blocks a resubmitted
    prompt hits: the admission falls back to a cold one and the scheduler
    stays alive."""
    _, tm, _, _ = models
    prompt = np.random.RandomState(11).randint(1, 256, (7,)).astype(
        np.int32)
    srv = _small(tm, prefix_cache=True, num_slots=1, max_model_len=8,
                 num_blocks=3, prompt_buckets=[8], max_prefill_batch=1)
    try:
        first = srv.submit(prompt, max_new_tokens=1).result(timeout=60)
        assert len(srv._cache.free) == 0 and len(srv._cache.lru) == 2
        assert srv.submit(prompt, max_new_tokens=1).result(
            timeout=60) == first
        assert srv.submit(prompt, max_new_tokens=1).result(
            timeout=60) == first
        assert srv._thread.is_alive()
    finally:
        srv.stop()


@pytest.mark.parametrize("spec", [False, True])
def test_replay_tokens_continue_the_stream(models, spec):
    """A stream resubmitted with the tokens it already emitted (and its
    seed) continues with exactly the tokens the uninterrupted run
    emitted next, greedy and sampled."""
    _, tm, _, td = models
    kw = dict(draft_model=td, spec_k=3) if spec else {}
    prompt = _chat(4)[1]
    srv = _small(tm, prefix_cache=True, **kw)
    try:
        for sample in (False, True):
            args = dict(max_new_tokens=10, do_sample=sample,
                        temperature=0.9, top_k=8, seed=42)
            full = srv.submit(prompt, **args).result(timeout=120)
            for cut in (1, 4, 9):
                rest = srv.submit(prompt, replay_tokens=full[:cut],
                                  **args).result(timeout=120)
                assert rest == full[cut:], (sample, cut)
        st = srv.stats()
    finally:
        srv.stop()
    assert st["free_blocks"] == st["total_blocks"]


def test_export_import_sequence(models):
    """An active stream exported mid-decode carries its KV rows; imported
    into a second server it finishes with the tokens the uninterrupted
    run emits.  A waiting stream exports tokens only: the KV path refuses
    it (typed) and a resubmission with ``replay_tokens`` finishes it.  A
    speculative server ships no KV."""
    _, tm, _, td = models
    prompt = _chat(5)[0]
    src = _small(tm, num_slots=1)
    dst = _small(tm)
    try:
        full = src.submit(prompt, max_new_tokens=12, seed=3).result(
            timeout=120)
        s = src.submit(prompt, max_new_tokens=12, seed=3)
        it = iter(s)
        head = [next(it) for _ in range(4)]
        waiting = src.submit(prompt, max_new_tokens=12, seed=3)
        wblob = export_sequence(src, waiting.request_id)   # one slot: queued
        blob = export_sequence(src, s.request_id)
        assert s.finish_reason == "migrated"
        assert blob["kv"] is not None and blob["n_blocks"] >= 1
        assert set(blob["kv"][0]) == {"k", "v", "k_scale", "v_scale"}
        assert blob["kv"][0]["k"].dtype == np.int8
        moved = import_sequence(dst, blob)
        got = blob["generated"] + moved.result(timeout=120)
        assert got[:4] == head and got == full
        assert wblob["kv"] is None and wblob["seed"] == 3
        with pytest.raises(MigrationUnsupported, match="no KV"):
            import_sequence(dst, wblob)
        if wblob["generated"]:
            rest = dst.submit(prompt, max_new_tokens=12, seed=3,
                              replay_tokens=wblob["generated"]).result(
                timeout=120)
            assert wblob["generated"] + rest == full
        else:
            assert dst.submit(prompt, max_new_tokens=12, seed=3).result(
                timeout=120) == full
        assert export_sequence(src, 10 ** 6) is None
        st_src, st_dst = src.stats(), dst.stats()
    finally:
        src.stop()
        dst.stop()
    assert st_src["migrated_out"] == 2 and st_dst["migrated_in"] == 1
    assert st_src["free_blocks"] == st_src["total_blocks"]
    assert st_dst["free_blocks"] == st_dst["total_blocks"]
    spec = _small(tm, draft_model=td, spec_k=2)
    try:
        s = spec.submit(prompt, max_new_tokens=16)
        next(iter(s))
        blob = export_sequence(spec, s.request_id)
        assert blob["kv"] is None
        with pytest.raises(MigrationUnsupported, match="speculative"):
            import_sequence(spec, dict(blob, kv=[{}]))
    finally:
        spec.stop()


def test_typed_errors(models):
    _, tm, _, _ = models

    class NoKV:
        def supports_kv_cache(self):
            return False

    with pytest.raises(ServeError, match="draft_model"):
        GenerationServer(tm, draft_model=NoKV())
    other = LlamaForCausalLM(llama_tiny(vocab_size=32), device="cpu")
    with pytest.raises(ValueError, match="vocab_size"):
        GenerationServer(tm, draft_model=other)
    with pytest.raises(ValueError, match="spec_k"):
        GenerationServer(tm, draft_model=tm, spec_k=0)


# ---------------------------------------------------------------------
# generate(), the dense cache, the logits filter
# ---------------------------------------------------------------------

@pytest.fixture(scope="module")
def dense():
    jm, tm = _pair(5, kv_cache_dtype=None)
    return jm, tm


def test_forward_with_cache_matches_jax(dense):
    """A prefill of 9 positions, then three one-token decode steps: the
    logits within 1e-4 of the JAX model's."""
    jm, tm = dense
    rng = np.random.RandomState(6)
    ids = rng.randint(1, 256, (2, 9)).astype(np.int32)
    steps = rng.randint(1, 256, (3, 2, 1)).astype(np.int32)
    jc = jm.init_cache(2, 12)
    tc = tm.init_cache(2, 12)
    pos = np.broadcast_to(np.arange(9, dtype=np.int32), (2, 9)).copy()
    jl, jc = jm.forward_with_cache(paddle.to_tensor(ids),
                                   paddle.to_tensor(pos), jc)
    with torch.no_grad():
        tl, tc = tm.forward_with_cache(torch.from_numpy(ids),
                                       torch.from_numpy(pos), tc)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl._value),
                               atol=LOGIT_TOL, rtol=0)
    for j, tok in enumerate(steps):
        p = np.full((2, 1), 9 + j, np.int32)
        jl, jc = jm.forward_with_cache(paddle.to_tensor(tok),
                                       paddle.to_tensor(p), jc)
        with torch.no_grad():
            tl, tc = tm.forward_with_cache(torch.from_numpy(tok),
                                           torch.from_numpy(p), tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl._value),
                                   atol=LOGIT_TOL, rtol=0)


@pytest.mark.parametrize("how", ["greedy", "greedy_eos", "greedy_nocache",
                                 "beam"])
def test_generate_matches_jax(dense, how):
    jm, tm = dense
    ids = np.random.RandomState(7).randint(1, 256, (2, 6)).astype(np.int32)
    kw = dict(max_new_tokens=8)
    if how == "beam":
        kw.update(num_beams=3, length_penalty=0.8)
    if how == "greedy_eos":
        first = jm.generate(paddle.to_tensor(ids), **kw).numpy()
        kw.update(eos_token_id=int(first[0, 8]), pad_token_id=1)
    if how == "greedy_nocache":
        kw.update(use_cache=False)
    ref = jm.generate(paddle.to_tensor(ids), **kw).numpy()
    got = tm.generate(torch.from_numpy(ids), **kw)
    assert got.dtype == torch.int32 and tuple(got.shape) == ref.shape
    assert got.numpy().tolist() == ref.tolist()


def test_generate_samples_from_its_generator(dense):
    _, tm = dense
    ids = torch.from_numpy(np.random.RandomState(8).randint(
        1, 256, (2, 5)).astype(np.int32))
    kw = dict(max_new_tokens=10, do_sample=True, temperature=1.5,
              top_k=50, top_p=0.95)
    a = tm.generate(ids, generator=torch.Generator().manual_seed(1), **kw)
    b = tm.generate(ids, generator=torch.Generator().manual_seed(1), **kw)
    c = tm.generate(ids, generator=torch.Generator().manual_seed(2), **kw)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert torch.equal(a[:, :5], ids)
    g = tm.generate(ids, do_sample=True, temperature=0.0, max_new_tokens=4)
    assert torch.equal(g, tm.generate(ids, max_new_tokens=4))
    with pytest.raises(ValueError, match="mutually exclusive"):
        tm.generate(ids, do_sample=True, num_beams=2)
    with pytest.raises(ValueError, match="non-empty"):
        tm.generate(torch.zeros((1, 0), dtype=torch.int32))


@pytest.mark.parametrize("temperature,top_k,top_p", [
    (1.0, 0, 1.0), (0.7, 0, 1.0), (1.0, 5, 1.0), (1.0, 0, 0.8),
    (1.3, 7, 0.6), (1e-9, 3, 0.9)])
def test_filter_logits_matches_jax(temperature, top_k, top_p):
    lg = np.random.RandomState(9).standard_normal((4, 50)).astype(
        np.float32) * 3
    ref = np.asarray(jgen._filter_logits(jnp.asarray(lg), temperature,
                                         top_k, top_p))
    got = generation._filter_logits(torch.from_numpy(lg), temperature,
                                    top_k, top_p).numpy()
    assert np.array_equal(np.isinf(got), np.isinf(ref))
    fin = np.isfinite(ref)
    np.testing.assert_allclose(got[fin], ref[fin], rtol=1e-6, atol=0)
