"""The port's device embedding cache and pipelined PS trainer against the
JAX package's.

On the CPU the cache's two kernels run their plain versions (the tensors
lie on the CPU), so these tests hold the whole cache path -- native
directory, miss fill on both wires, segment-sum of device gradients,
on-device SGD / AdaGrad, exact delta write-back -- to the reference at
its own test's tolerance (rtol 1e-5, atol 1e-6 on the host rows after
``flush()``; XLA may contract ``buf - lr * step`` into an FMA, PyTorch
does not).  The reference's cache invariants are ported as port tests
(LRU order, the thrash error, pins, plan invalidation, async eviction
pressure); ``tests/test_device_cache.py`` keeps running them on the
reference.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

import torch

from paddle_tpu.distributed.fleet import heter as jheter
from paddle_tpu.distributed.fleet import ps as jps

from paddle_tpu_torch.distributed.fleet import (DeviceCachedTable,
                                                HeterTrainer, PSClient,
                                                PSServer, SparseTable)
from paddle_tpu_torch.distributed.fleet.heter import RemoteTable
from paddle_tpu_torch.distributed.fleet.ps import dequantize_rows_q8
from paddle_tpu_torch.ops.kernels import registry

RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True)
def _clean_counts():
    registry.reset_counts()
    yield
    registry.reset_counts()


def _mk(capacity=8, dim=4, lr=0.5, optimizer="sgd", **kw):
    table = SparseTable(dim, optimizer="sgd", lr=1.0)
    return table, DeviceCachedTable(table, capacity, optimizer=optimizer,
                                    lr=lr, device="cpu", **kw)


# ---------------------------------------------------------------------
# the cache against the reference's
# ---------------------------------------------------------------------

@pytest.mark.parametrize("optimizer", ["sgd", "adagrad"])
@pytest.mark.parametrize("wire", ["f32", "q8"])
@pytest.mark.parametrize("capacity", [6, 64])
def test_cache_matches_jax_with_device_gradients(optimizer, wire, capacity):
    """The same pull/push sequence with device-array gradients (both sides
    merge through ``segment_sum``); capacity 6 is below the working set
    of 10 ids, so eviction write-backs run too."""
    jt = jps.SparseTable(4, optimizer="sgd", lr=1.0, init_std=0.1)
    tt = SparseTable(4, optimizer="sgd", lr=1.0, init_std=0.1)
    jc = jheter.DeviceCachedTable(jt, capacity, optimizer=optimizer, lr=0.5,
                                  wire=wire)
    tc = DeviceCachedTable(tt, capacity, optimizer=optimizer, lr=0.5,
                           wire=wire, device="cpu")
    rng = np.random.default_rng(0)
    for _ in range(20):
        ids = rng.integers(0, 10, 6).astype(np.int64)
        g = rng.standard_normal((6, 4)).astype(np.float32)
        np.testing.assert_allclose(tc.pull(ids).numpy(),
                                   np.asarray(jc.pull(ids)), rtol=RTOL,
                                   atol=ATOL)
        jc.push(ids, jnp.asarray(g))
        tc.push(ids, torch.from_numpy(g))
    jc.flush()
    tc.flush()
    assert (tc.hits, tc.misses, tc.evictions) == (jc.hits, jc.misses,
                                                  jc.evictions)
    assert (tc.evictions > 0) == (capacity < 10)
    every = np.arange(10, dtype=np.int64)
    np.testing.assert_allclose(tt.pull(every), jt.pull(every), rtol=RTOL,
                               atol=ATOL)
    assert registry.spec("segment_sum").torch_ref_calls == 20
    if wire == "q8":
        assert registry.spec("pull_dequant").torch_ref_calls > 0


def test_numpy_gradients_take_the_native_merge():
    table, cache = _mk(capacity=8, lr=1.0)
    ids = np.array([5, 5, 5, 2], np.int64)
    base = cache.pull(ids).numpy().copy()
    cache.push(ids, np.ones((4, 4), np.float32))
    got = cache.pull(np.array([5, 2], np.int64)).numpy()
    np.testing.assert_array_equal(
        got, base[[0, 3]] - np.array([[3.0], [1.0]], np.float32))
    assert registry.spec("segment_sum").torch_ref_calls == 0


def test_duplicate_ids_segment_summed_in_row_order():
    """Integer gradients through the registry: id 3 gets rows 1+3+6, id 5
    row 4, id 9 rows 2+5 (sgd, lr 1), bitwise as in the reference test."""
    t = SparseTable(4, init_std=0.0)
    c = DeviceCachedTable(t, capacity=16, lr=1.0, device="cpu")
    ids = np.array([3, 9, 3, 5, 9, 3], np.int64)
    c.pull(ids, pin=True)
    c.push(ids, torch.arange(1, 7, dtype=torch.float32)[:, None].repeat(1, 4))
    c.flush()
    got = t.pull(np.array([3, 5, 9], np.int64))
    assert np.array_equal(got[:, 0], [-10.0, -4.0, -7.0])
    assert registry.spec("segment_sum").torch_ref_calls == 1


def test_kernel_mode_routes_and_cpu_never_launches():
    table, cache = _mk(capacity=8, wire="q8", kernel_mode="torch_ref")
    ids = np.arange(4, dtype=np.int64)
    cache.pull(ids)
    cache.push(ids, torch.ones(4, 4))
    assert registry.spec("segment_sum").torch_ref_calls == 1
    assert registry.spec("pull_dequant").torch_ref_calls == 1
    assert registry.launch_counts() == dict.fromkeys(registry.kernels(), 0)
    with pytest.raises(ValueError, match="kernel_mode"):
        _mk(kernel_mode="cuda")


def test_q8_fill_is_the_numpy_dequant_of_the_wire():
    table = SparseTable(16, init_std=0.3, seed=9)
    cache = DeviceCachedTable(table, 32, wire="q8", device="cpu")
    ids = np.array([4, 1, 4, 30, 7], np.int64)
    got = cache.pull(ids).numpy()
    want = dequantize_rows_q8(*table.pull_q8(ids))
    assert np.array_equal(got, want)


def test_default_device_is_cuda_and_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DeviceCachedTable(SparseTable(4), 8)


def test_bad_arguments_and_remote_table():
    with pytest.raises(ValueError, match="sgd|adagrad"):
        _mk(optimizer="adam")
    with pytest.raises(ValueError, match="wire"):
        _mk(wire="bf16")
    # RemoteTable is ported: it wraps a client without touching it
    rt = RemoteTable(None, "emb", 4)
    assert (rt.name, rt.dim) == ("emb", 4)


def test_prime_changes_no_real_row():
    table, cache = _mk(capacity=16, optimizer="adagrad", wire="q8")
    ids = np.arange(6, dtype=np.int64)
    before = cache.pull(ids).numpy().copy()
    host_before = table.pull(ids).copy()
    cache.prime(40)
    assert np.array_equal(cache.pull(ids).numpy(), before)
    # buckets 1..64: one segment-sum and one apply each, one dequant
    assert registry.spec("segment_sum").torch_ref_calls == 7
    cache.flush()
    assert np.array_equal(table.pull(ids), host_before)


# ---------------------------------------------------------------------
# the reference's invariants (tests/test_device_cache.py), on the port
# ---------------------------------------------------------------------

def test_pull_hits_and_misses():
    table, cache = _mk(capacity=8)
    ids = np.array([1, 2, 3, 2, 1], np.int64)
    rows = cache.pull(ids)
    assert rows.shape == (5, 4) and rows.device.type == "cpu"
    assert cache.misses == 3 and cache.hits == 0
    assert torch.equal(rows[0], rows[4])
    assert torch.equal(cache.pull(ids), rows)
    assert cache.hits == 3


def test_cached_training_matches_direct_table():
    rng = np.random.default_rng(0)
    direct = SparseTable(4, optimizer="sgd", lr=0.5)
    table, cache = _mk(capacity=6, lr=0.5)
    for _ in range(20):
        ids = rng.integers(0, 10, size=6).astype(np.int64)
        g = rng.normal(size=(6, 4)).astype(np.float32)
        direct.pull(ids)
        direct.push(ids, g)
        cache.pull(ids)
        cache.push(ids, g)
    cache.flush()
    assert cache.evictions > 0
    every = np.arange(10, dtype=np.int64)
    np.testing.assert_allclose(direct.pull(every), table.pull(every),
                               rtol=RTOL, atol=ATOL)


def test_lru_eviction_order():
    table, cache = _mk(capacity=2)
    for i in (1, 2, 1, 3):                  # 1 is most recent when 3 comes
        cache.pull(np.array([i], np.int64))
    assert cache.has(1) and cache.has(3) and not cache.has(2)
    assert cache.evictions == 1


def test_thrash_raises_and_leaves_the_cache_consistent():
    table, cache = _mk(capacity=2)
    with pytest.raises(RuntimeError, match="thrashing"):
        cache.pull(np.array([1, 2, 3], np.int64))
    table, cache = _mk(capacity=4)
    cache.pull(np.array([0, 1, 2], np.int64), pin=True)
    with pytest.raises(RuntimeError, match="thrashing"):
        cache.pull(np.array([10, 11, 12], np.int64))
    assert cache.load == pytest.approx(3 / 4)
    cache.push(np.array([0, 1, 2], np.int64), np.zeros((3, 4), np.float32))
    cache.pull(np.array([10, 11, 12], np.int64))
    assert cache.has(10)


def test_adagrad_device_updates():
    table, cache = _mk(capacity=4, lr=1.0, optimizer="adagrad")
    ids = np.array([0, 1], np.int64)
    base = cache.pull(ids).numpy().copy()
    g = torch.ones(2, 4)
    cache.push(ids, g)
    got = cache.pull(ids).numpy()
    np.testing.assert_allclose(got, base - 1.0, rtol=1e-4)
    cache.push(ids, g)
    np.testing.assert_allclose(cache.pull(ids).numpy(),
                               got - 1.0 / np.sqrt(2.0), rtol=1e-4)


def test_pinned_pull_blocks_eviction_until_push():
    table, cache = _mk(capacity=2)
    cache.pull(np.array([1, 2], np.int64), pin=True)
    with pytest.raises(RuntimeError, match="in-flight"):
        cache.pull(np.array([3], np.int64))
    cache.push(np.array([1, 2], np.int64), np.zeros((2, 4), np.float32))
    cache.pull(np.array([3], np.int64))
    assert cache.has(3)


def _no_pins_left(cache, capacity):
    """Every slot can be claimed: a pull of ``capacity`` fresh ids would
    raise the thrash error if any pin leaked."""
    fresh = np.arange(10 ** 6, 10 ** 6 + capacity, dtype=np.int64)
    cache.pull(fresh)
    return all(cache.has(i) for i in fresh)


@pytest.mark.parametrize("push_lag,capacity", [(0, 8), (1, 12)])
def test_async_trainer_eviction_pressure_exact(push_lag, capacity):
    """Disjoint 4-id batches in async mode: eviction may only claim
    batches whose push landed.  Exact against direct-table training."""
    dim = 4
    table = SparseTable(dim, optimizer="sgd", lr=1.0)
    ref = SparseTable(dim, optimizer="sgd", lr=1.0)
    every = np.arange(16, dtype=np.int64)
    table.pull(every)
    ref.pull(every)
    cache = DeviceCachedTable(table, capacity=capacity, lr=0.25,
                              device="cpu")

    def dense_step(emb, batch):
        return 0.0, {"emb": torch.ones_like(emb["emb"])}

    tr = HeterTrainer({"emb": cache}, dense_step, sync_mode=False,
                      push_lag=push_lag)
    batches = [every[(4 * i) % 16:(4 * i) % 16 + 4] for i in range(12)]
    assert tr.run(batches, lambda b: {"emb": b}) == 12
    tr.shutdown()
    cache.flush()
    assert cache.evictions > 0
    for b in batches:
        ref.push_delta(b, -0.25 * np.ones((4, dim), np.float32))
    np.testing.assert_allclose(table.pull(every), ref.pull(every),
                               rtol=1e-6, atol=1e-6)
    assert registry.spec("segment_sum").torch_ref_calls == 12
    assert _no_pins_left(cache, capacity)


def test_sync_mode_pulls_after_the_push_and_repeats_bitwise():
    """Sync mode is pull, step, push per batch: each pull starts after the
    previous push landed, so two runs agree bitwise."""
    def run():
        table, cache = _mk(capacity=40, lr=0.5)
        log = []
        pull, push = cache.pull, cache.push
        cache.pull = lambda ids, pin=False: (log.append("pull"),
                                             pull(ids, pin))[1]
        cache.push = lambda ids, g: (log.append("push"), push(ids, g))[1]

        def step(emb, batch):
            rows = emb["emb"]
            return float(rows.sum()), {"emb": rows * 0.5 + 0.1}

        rng = np.random.default_rng(5)
        batches = [rng.integers(0, 12, 6) for _ in range(10)]
        losses = []
        tr = HeterTrainer({"emb": cache}, step, sync_mode=True)
        tr.run(batches, lambda b: {"emb": b},
               on_result=lambda i, r: losses.append(r))
        tr.shutdown()
        cache.flush()
        return log, losses, table.pull(np.arange(12, dtype=np.int64))

    (log, la, ra), (_, lb, rb) = run(), run()
    assert log == ["pull", "push"] * 10
    assert la == lb and np.array_equal(ra, rb)


def test_pin_released_when_no_grads_or_step_raises():
    table, cache = _mk(capacity=8)
    tr = HeterTrainer({"emb": cache}, lambda emb, b: (0.0, {}),
                      sync_mode=False)
    batches = [np.arange(4 * i, 4 * i + 4, dtype=np.int64) for i in range(6)]
    tr.run(batches, lambda b: {"emb": b})
    tr.shutdown()
    assert _no_pins_left(cache, 8)

    table2, cache2 = _mk(capacity=4)

    def boom(emb, batch):
        raise RuntimeError("boom")

    tr2 = HeterTrainer({"emb": cache2}, boom, sync_mode=False)
    with pytest.raises(RuntimeError, match="boom"):
        tr2.run([np.arange(4, dtype=np.int64)], lambda b: {"emb": b})
    tr2.shutdown()
    assert _no_pins_left(cache2, 4)


def test_variable_batch_shapes_reuse_buckets():
    table, cache = _mk(capacity=8)
    assert cache._bucket(1) == 1 and cache._bucket(5) == 8
    p = cache._pad_slots(np.asarray([2, 4, 5], np.int64))
    assert len(p) == 4 and p[-1] == cache._cap
    base = table.pull(np.arange(8, dtype=np.int64)).copy()
    for ids in ([0, 1, 2], [3], [0, 4, 5, 6], [7, 1]):
        cache.pull(np.asarray(ids, np.int64))
        cache.push(np.asarray(ids, np.int64), torch.ones(len(ids), 4))
    cache.flush()
    got = table.pull(np.arange(8, dtype=np.int64))
    n_push = {0: 2, 1: 2, 2: 1, 3: 1, 4: 1, 5: 1, 6: 1, 7: 1}
    for i, n in n_push.items():
        np.testing.assert_allclose(got[i] - base[i], -0.5 * n * np.ones(4),
                                   rtol=RTOL, atol=ATOL)


def test_release_tolerates_partial_eviction():
    table, cache = _mk(capacity=4)
    cache.pull(np.array([1, 2], np.int64), pin=True)
    cache.release(np.array([1, 2, 777, 888], np.int64))
    b = np.array([10, 11, 12, 13], np.int64)
    cache.pull(b, pin=True)
    assert all(cache.has(i) for i in b)


def test_plan_cache_survives_interleaved_pulls():
    rng = np.random.default_rng(3)
    direct = SparseTable(4, optimizer="sgd", lr=0.5)
    table, cache = _mk(capacity=16, lr=0.5)
    ids_a = np.array([1, 2, 3], np.int64)
    ids_b = np.array([3, 4, 5], np.int64)
    g_a = rng.normal(size=(3, 4)).astype(np.float32)
    g_b = rng.normal(size=(3, 4)).astype(np.float32)
    cache.pull(ids_a, pin=True)
    cache.pull(ids_b, pin=True)     # lands before push(a)
    cache.push(ids_a, torch.from_numpy(g_a))
    cache.push(ids_b, torch.from_numpy(g_b))
    cache.flush()
    for ids, g in ((ids_a, g_a), (ids_b, g_b)):
        direct.pull(ids)
        direct.push(ids, g)
    every = np.arange(1, 6, dtype=np.int64)
    np.testing.assert_allclose(table.pull(every), direct.pull(every),
                               rtol=RTOL)


def test_stale_plan_invalidated_on_eviction():
    table, cache = _mk(capacity=4, lr=1.0)
    a = np.arange(0, 4, dtype=np.int64)
    b = np.arange(4, 8, dtype=np.int64)
    cache.pull(a)                   # unpinned; plan retained
    cache.pull(b)                   # evicts batch a entirely
    before = table.pull(b).copy()
    with pytest.raises(KeyError):
        cache.push(a, torch.ones(4, 4))
    cache.flush()
    assert np.array_equal(table.pull(b), before)


# ---------------------------------------------------------------------
# HeterTrainer: the bench's smoke wide&deep, against the same loop in JAX
# ---------------------------------------------------------------------

N_SLOTS, DIM, BATCH, VOCAB, N_DENSE, HIDDEN, STEPS = 4, 8, 64, 1000, 13, 64, 4


def _wide_deep_data():
    """The bench's draws (``bench.py`` ``_bench_wide_deep``, smoke size)
    in its order: w1, w2, wide_w, the Zipf ids, then dense features and
    labels per batch."""
    rng = np.random.RandomState(0)
    w1 = (rng.randn(N_SLOTS * DIM + N_DENSE, HIDDEN) * 0.05).astype(
        np.float32)
    w2 = (rng.randn(HIDDEN, 1) * 0.05).astype(np.float32)
    wide_w = (rng.randn(N_DENSE, 1) * 0.05).astype(np.float32)
    params = [w1, np.zeros(HIDDEN, np.float32), w2, wide_w]
    zipf = np.clip(rng.zipf(1.3, size=(STEPS, BATCH, N_SLOTS)), 1, VOCAB)
    batches = []
    for i in range(STEPS):
        ids = ((zipf[i] - 1) + np.arange(N_SLOTS) * VOCAB).astype(np.int64)
        dense = rng.rand(BATCH, N_DENSE).astype(np.float32)
        label = (dense[:, 0] > 0.5).astype(np.float32)
        batches.append((ids, dense, label))
    return params, batches


def _disjoint(batches):
    """The batches with each one's ids moved to a range of its own, so no
    id is in two batches."""
    return [(ids + i * N_SLOTS * VOCAB, dense, label)
            for i, (ids, dense, label) in enumerate(batches)]


def _jax_loop(params, batches, cached, trainer=False):
    """The bench's loop over the JAX package's tables, one batch at a
    time, or with ``trainer`` the JAX package's own sync
    ``HeterTrainer``."""
    table = jps.SparseTable(DIM, optimizer="sgd", lr=1.0 if cached else 0.05)
    sparse = (jheter.DeviceCachedTable(table, BATCH * N_SLOTS * 3, lr=0.05)
              if cached else table)
    state = {"p": tuple(jnp.asarray(p) for p in params), "losses": []}

    def loss_of(p, emb, dense, label):
        w1, b1, w2, wide_w = p
        x = jnp.concatenate([emb.reshape(BATCH, N_SLOTS * DIM), dense], 1)
        h = jax.nn.relu(x @ w1 + b1)
        logit = jnp.clip((h @ w2 + dense @ wide_w)[:, 0], -15, 15)
        return jnp.mean(jnp.logaddexp(0.0, logit) - logit * label)

    step = jax.jit(jax.value_and_grad(loss_of, argnums=(0, 1)))

    def dense_step(embs, b):
        loss, (gp, ge) = step(state["p"], jnp.asarray(embs["slots"]),
                              jnp.asarray(b[1]), jnp.asarray(b[2]))
        state["p"] = tuple(p - 0.05 * g for p, g in zip(state["p"], gp))
        state["losses"].append(float(loss))
        return loss, {"slots": ge.reshape(-1, DIM)}

    if trainer:
        tr = jheter.HeterTrainer({"slots": sparse}, dense_step,
                                 sync_mode=True)
        tr.run(batches, lambda b: {"slots": b[0].reshape(-1)})
        tr.shutdown()
    else:
        # the loop the reference documents for sync mode: pull, step, push
        for b in batches:
            ids = b[0].reshape(-1)
            _, grads = dense_step({"slots": sparse.pull(ids)}, b)
            sparse.push(ids, grads["slots"] if cached
                        else np.asarray(grads["slots"]))
    if cached:
        sparse.flush()
    return state["losses"], table


def _port_loop(params, batches, cached):
    table = SparseTable(DIM, optimizer="sgd", lr=1.0 if cached else 0.05)
    sparse = (DeviceCachedTable(table, BATCH * N_SLOTS * 3, lr=0.05,
                                device="cpu") if cached else table)
    state = {"p": [torch.from_numpy(p) for p in params], "losses": []}

    def dense_step(embs, b):
        emb = torch.as_tensor(embs["slots"]).requires_grad_()
        p = [t.detach().requires_grad_() for t in state["p"]]
        w1, b1, w2, wide_w = p
        dense, label = torch.from_numpy(b[1]), torch.from_numpy(b[2])
        x = torch.cat([emb.reshape(BATCH, N_SLOTS * DIM), dense], 1)
        h = torch.relu(x @ w1 + b1)
        logit = torch.clamp((h @ w2 + dense @ wide_w)[:, 0], -15, 15)
        loss = torch.mean(torch.logaddexp(torch.zeros_like(logit), logit)
                          - logit * label)
        *gp, ge = torch.autograd.grad(loss, p + [emb])
        state["p"] = [t.detach() - 0.05 * g for t, g in zip(p, gp)]
        state["losses"].append(loss.item())
        return loss.detach(), {"slots": ge.reshape(-1, DIM)}

    tr = HeterTrainer({"slots": sparse}, dense_step, sync_mode=True)
    tr.run(batches, lambda b: {"slots": b[0].reshape(-1)})
    tr.shutdown()
    if cached:
        sparse.flush()
    return state["losses"], table


@pytest.mark.parametrize("cached", [False, True],
                         ids=["host_table", "device_cache"])
def test_heter_trainer_wide_deep_matches_jax(cached):
    """Per-step losses and the final host rows of every id seen, against
    the same loop written over the JAX package's classes (pull, step,
    push per batch): rtol 1e-5, atol 1e-6 (the dense tower's f32 products
    sum in another order).  The JAX package's own ``HeterTrainer`` is not
    the oracle: in sync mode it prefetches pull(i+1), which races push(i)
    for the table lock, so its runs differ from each other."""
    params, batches = _wide_deep_data()
    jl, jt = _jax_loop(params, batches, cached)
    tl, tt = _port_loop(params, batches, cached)
    np.testing.assert_allclose(tl, jl, rtol=RTOL, atol=ATOL)
    seen = np.unique(np.concatenate([b[0].reshape(-1) for b in batches]))
    np.testing.assert_allclose(tt.pull(seen), jt.pull(seen), rtol=RTOL,
                               atol=ATOL)
    assert len(tt) == len(jt) == seen.size
    if cached:
        assert registry.spec("segment_sum").torch_ref_calls == STEPS


@pytest.mark.parametrize("cached", [False, True],
                         ids=["host_table", "device_cache"])
def test_heter_trainer_sync_matches_jax_trainer_on_disjoint_batches(cached):
    """The JAX package's own sync ``HeterTrainer`` against the port's,
    over batches that share no id: the reference's prefetched pull(i+1)
    then reads no row that push(i) writes, so its race cannot show and
    its run is the oracle.  Same tolerance as above."""
    params, batches = _wide_deep_data()
    batches = _disjoint(batches)
    jl, jt = _jax_loop(params, batches, cached, trainer=True)
    tl, tt = _port_loop(params, batches, cached)
    assert len(jl) == len(tl) == STEPS
    np.testing.assert_allclose(tl, jl, rtol=RTOL, atol=ATOL)
    seen = np.unique(np.concatenate([b[0].reshape(-1) for b in batches]))
    np.testing.assert_allclose(tt.pull(seen), jt.pull(seen), rtol=RTOL,
                               atol=ATOL)
    assert len(tt) == len(jt) == seen.size


@pytest.mark.parametrize("wire", ["f32", "q8"])
def test_remote_table_trains_like_the_local_table(wire):
    """``HeterTrainer`` over a cache whose host table is a ``RemoteTable``
    behind a port ``PSServer`` (misses pulled over the RPC on the cache's
    ``wire``, write-backs as ``push_delta``) ends bitwise where the same
    run over a local table ends: the server applies the same native
    calls."""
    params, batches = _wide_deep_data()

    def run(remote):
        table = SparseTable(DIM, optimizer="sgd", lr=1.0)
        srv = cli = None
        host = table
        if remote:
            srv = PSServer({"slots": table}, host="127.0.0.1")
            srv.start()
            cli = PSClient([f"127.0.0.1:{srv.port}"], rpc_timeout=10.0)
            host = RemoteTable(cli, "slots", DIM)
        try:
            # the flush writes every touched row back through push_delta
            cache = DeviceCachedTable(host, BATCH * N_SLOTS * 2, lr=0.05,
                                      wire=wire, device="cpu")
            state = {"p": [torch.from_numpy(p) for p in params],
                     "losses": []}

            def dense_step(embs, b):
                emb = torch.as_tensor(embs["slots"]).requires_grad_()
                p = [t.detach().requires_grad_() for t in state["p"]]
                w1, b1, w2, wide_w = p
                dense, label = torch.from_numpy(b[1]), torch.from_numpy(b[2])
                x = torch.cat([emb.reshape(BATCH, N_SLOTS * DIM), dense], 1)
                h = torch.relu(x @ w1 + b1)
                logit = torch.clamp((h @ w2 + dense @ wide_w)[:, 0], -15, 15)
                loss = torch.mean(torch.logaddexp(torch.zeros_like(logit),
                                                  logit) - logit * label)
                *gp, ge = torch.autograd.grad(loss, p + [emb])
                state["p"] = [t.detach() - 0.05 * g for t, g in zip(p, gp)]
                state["losses"].append(loss.item())
                return loss.detach(), {"slots": ge.reshape(-1, DIM)}

            tr = HeterTrainer({"slots": cache}, dense_step, sync_mode=True)
            tr.run(batches, lambda b: {"slots": b[0].reshape(-1)})
            tr.shutdown()
            cache.flush()
            seen = np.unique(np.concatenate([b[0].reshape(-1)
                                             for b in batches]))
            return state["losses"], table.pull(seen), cache.evictions, \
                (srv.applied if srv is not None else None)
        finally:
            if cli is not None:
                cli.close()
            if srv is not None:
                srv.stop()

    ll, rl, _, _ = run(False)
    lr_, rr, _, applied = run(True)
    assert lr_ == ll and np.array_equal(rr, rl)
    assert applied >= 1                  # write-backs rode the RPC
