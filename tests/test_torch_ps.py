"""The port's host sparse table against the JAX package's.

Both packages build the same C++ source (``ps_core.cc``) with the same
flags, and a row's first value is a pure function of (seed, init_std,
id), so pulls, every optimizer's pushes, raw deltas, the q8 wire and the
checkpoint formats are held bitwise.
"""
import io
from pathlib import Path

import numpy as np
import pytest

from paddle_tpu.distributed.fleet import ps as jps

from paddle_tpu_torch.distributed.fleet import SparseTable
from paddle_tpu_torch.distributed.fleet import ps as tps
from paddle_tpu_torch.native import CXX_FLAGS, NativeBuildError, load_library


def _pair(dim=8, **kw):
    return jps.SparseTable(dim, **kw), SparseTable(dim, **kw)


def _batches(seed, n_batches=6, n=40, vocab=60, dim=8):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, vocab, n).astype(np.int64),
             rng.standard_normal((n, dim)).astype(np.float32))
            for _ in range(n_batches)]


@pytest.mark.parametrize("seed,init_std,dim", [(0, 0.01, 8), (7, 0.5, 5),
                                               (123, 0.0, 16)])
def test_fresh_pulls_bitwise_jax(seed, init_std, dim):
    j, t = _pair(dim, seed=seed, init_std=init_std)
    ids = np.array([0, 5, 5, 1 << 40, -3, 17, 0], np.int64)
    got = t.pull(ids)
    assert got.dtype == np.float32 and got.shape == (7, dim)
    assert np.array_equal(got, j.pull(ids))
    # order of first touch does not matter: the row is a function of the id
    t2 = SparseTable(dim, seed=seed, init_std=init_std)
    assert np.array_equal(t2.pull(ids[::-1])[::-1], got)
    assert len(t) == len(j) == 5


@pytest.mark.parametrize("opt", ["sgd", "adagrad", "adam"])
def test_push_sequences_bitwise_jax(opt):
    j, t = _pair(optimizer=opt, lr=0.05, seed=3, init_std=0.1)
    for ids, g in _batches(1):
        assert np.array_equal(t.pull(ids), j.pull(ids))
        j.push(ids, g)
        t.push(ids, g)
    every = np.arange(60, dtype=np.int64)
    assert np.array_equal(t.pull(every), j.pull(every))
    assert t.version == j.version == 6
    assert len(t) == len(j)


def test_push_delta_and_pull_q8_bitwise_jax():
    j, t = _pair(init_std=0.2)
    for ids, d in _batches(2, n_batches=3):
        j.push_delta(ids, d)
        t.push_delta(ids, d)
    ids = np.array([3, 3, 9, 59, 1000], np.int64)
    assert np.array_equal(t.pull(ids), j.pull(ids))
    tc, ts = t.pull_q8(ids)
    jc, js = j.pull_q8(ids)
    assert tc.dtype == np.int8 and ts.dtype == np.float32
    assert np.array_equal(tc, jc) and np.array_equal(ts, js)
    # the wire's codes are the numpy quantizer's, in both packages
    qc, qs = tps.quantize_rows_q8(t.pull(ids))
    assert np.array_equal(qc, tc) and np.array_equal(qs, ts)


def test_q8_helpers_bitwise_jax_and_zero_rows():
    rng = np.random.default_rng(4)
    rows = (rng.standard_normal((33, 13)) * 3).astype(np.float32)
    rows[[0, 7]] = 0.0
    c, s = tps.quantize_rows_q8(rows)
    jc, js = jps.quantize_rows_q8(rows)
    assert np.array_equal(c, jc) and np.array_equal(s, js)
    assert s[0] == 0 and not c[7].any()
    back = tps.dequantize_rows_q8(c, s)
    assert np.array_equal(back, jps.dequantize_rows_q8(jc, js))
    assert not back[0].any() and np.isfinite(back).all()
    np.testing.assert_allclose(back, rows, atol=np.abs(rows).max() / 127)


@pytest.mark.parametrize("opt", ["sgd", "adagrad", "adam"])
@pytest.mark.parametrize("fmt", ["state_bytes", "save"])
def test_jax_checkpoints_load_and_continue_bitwise(opt, fmt, tmp_path):
    kw = dict(optimizer=opt, lr=0.1, seed=5, init_std=0.05)
    j = jps.SparseTable(8, **kw)
    for ids, g in _batches(3, n_batches=4):
        j.pull(ids)
        j.push(ids, g)
    t = SparseTable(8, **kw)
    t.pull(np.array([999], np.int64))           # replaced, never merged
    if fmt == "state_bytes":
        t.load_state_bytes(j.state_bytes())
    else:
        path = str(tmp_path / "table.npz")
        j.save(path)
        t.load(path)
        # the values-only format drops optimizer state: the JAX table
        # continues from the same file
        j = jps.SparseTable(8, **kw)
        j.load(path)
    assert len(t) == len(j) and t.version == j.version == 4
    for ids, g in _batches(4, n_batches=3):
        assert np.array_equal(t.pull(ids), j.pull(ids))
        j.push(ids, g)
        t.push(ids, g)
    every = np.arange(60, dtype=np.int64)
    assert np.array_equal(t.pull(every), j.pull(every))


def test_port_checkpoints_load_into_jax_and_match_layout(tmp_path):
    j, t = _pair(optimizer="adagrad", lr=0.1, seed=2)
    for ids, g in _batches(5, n_batches=3):
        j.pull(ids)
        t.pull(ids)
        j.push(ids, g)
        t.push(ids, g)
    a = np.load(io.BytesIO(t.state_bytes()))
    b = np.load(io.BytesIO(j.state_bytes()))
    assert sorted(a.files) == sorted(b.files)
    oa, ob = np.argsort(a["ids"]), np.argsort(b["ids"])
    for k in ("ids", "vals", "opt_state"):
        assert np.array_equal(a[k][oa], b[k][ob]), k
    for k in set(a.files) - {"ids", "vals", "opt_state"}:
        assert a[k] == b[k], k
    path = str(tmp_path / "port")
    t.save(path)
    j2 = jps.SparseTable(8, optimizer="adagrad", lr=0.1, seed=2)
    j2.load(path)
    every = np.arange(60, dtype=np.int64)
    assert np.array_equal(j2.pull(every), t.pull(every))
    assert t.config_arrays().keys() == j.config_arrays().keys()


def test_load_rejects_mismatched_layouts():
    j = jps.SparseTable(8, optimizer="adam")
    j.pull(np.arange(4, dtype=np.int64))
    with pytest.raises(ValueError, match="different embedding dim"):
        SparseTable(4).load_state_bytes(j.state_bytes())
    with pytest.raises(ValueError, match="different optimizer"):
        SparseTable(8, optimizer="sgd").load_state_bytes(j.state_bytes())


@pytest.mark.parametrize("kw", [dict(entry=object()),
                                dict(initializer=lambda: None),
                                dict(backend="python"),
                                dict(use_native=False),
                                dict(geo_policy="lww")])
def test_unported_options_raise_naming_the_roadmap(kw):
    with pytest.raises(NotImplementedError, match="ROADMAP.md item 6"):
        SparseTable(4, **kw)


@pytest.mark.parametrize("method", ["enable_spill", "geo_get"])
def test_unported_methods_raise_naming_the_roadmap(method):
    with pytest.raises(NotImplementedError, match="ROADMAP.md item 6"):
        getattr(SparseTable(4), method)(0)


def _lifecycle(t, method):
    """One lifecycle scenario on table ``t``: rows sighted at 1 s and at
    5 s, then ``method``; returns what a caller can observe."""
    t.set_clock(1000)
    t.pull(np.arange(10, dtype=np.int64))
    t.set_clock(5000)
    t.push(np.arange(4, dtype=np.int64), np.ones((4, 8), np.float32))
    if method == "set_clock":      # a later touch restamps the sighting
        t.set_clock(9000)
        t.pull(np.array([8], np.int64))
        out = t.ttl_sweep(6000)
    elif method == "touch_all":    # grandfathers every row to 7 s
        t.touch_all(7000)
        out = t.ttl_sweep(6000)
    elif method == "ttl_sweep":
        out = t.ttl_sweep(3000)
    else:                          # evict_ids: exact ids, absent ones too
        out = np.asarray([t.evict_ids(np.array([2, 7, 99], np.int64))])
    every = np.arange(12, dtype=np.int64)
    d = t._snapshot_arrays(full_state=True)
    o = np.argsort(d["ids"])
    return (out, d["ids"][o], d["vals"][o], d["opt_state"][o], t.version,
            t.admitted_total, t.evicted_total, t.pull(every))


@pytest.mark.parametrize("method", ["set_clock", "touch_all", "ttl_sweep",
                                    "evict_ids"])
def test_lifecycle_bitwise_jax(method):
    """The TTL lifecycle on the native core: the same sightings, sweeps and
    evictions leave the same rows (optimizer state and version
    included) and the same churn counters as the reference's table."""
    j, t = _pair(optimizer="adam", lr=0.05, seed=4, init_std=0.1)
    got, want = _lifecycle(t, method), _lifecycle(j, method)
    for a, b in zip(got, want):
        assert np.array_equal(np.asarray(a), np.asarray(b)), method


def test_bad_optimizer_is_a_value_error():
    with pytest.raises(ValueError, match="optimizer must be one of"):
        SparseTable(4, optimizer="momentum")


@pytest.mark.parametrize("name", ["ps_core.cc", "cache_dir.cc"])
def test_native_sources_are_the_reference_code(name):
    """The port's copies hold the reference's code line for line; only
    comments may differ."""
    repo = Path(__file__).resolve().parents[1]

    def code(path):
        return [line.split("//")[0].rstrip()
                for line in path.read_text().splitlines()]

    assert code(repo / "paddle_tpu_torch" / "native" / name) == code(
        repo / "paddle_tpu" / "native" / name)


def test_native_build_uses_the_reference_flags_and_raises_on_failure(
        monkeypatch):
    assert {"-ffp-contract=off", "-march=native", "-O3"} <= set(CXX_FLAGS)
    import paddle_tpu_torch.native as nat
    monkeypatch.setattr(nat, "_libs", {})
    monkeypatch.setenv("CXX", "/nonexistent/g++")
    monkeypatch.setattr(nat, "CXX_FLAGS", CXX_FLAGS + ("-DPORT_TEST",))
    with pytest.raises(NativeBuildError, match="did not run"):
        load_library("cache_dir")
