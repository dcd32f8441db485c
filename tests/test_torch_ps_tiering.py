"""The port's tiered sparse table, feature admission and Python backend
against the JAX package's (``paddle_tpu/distributed/fleet/ps.py``).

The reference's tiering cases (``tests/test_ps_tiering.py``) run on the
port's table, each also held to the reference's table on the same
inputs; admission (``entry=``) is held to the reference's on the same
pulls and pushes; the Python backend to the reference's Python backend
(and to the native backend at ``init_std=0``); the checkpoint carrier
(``save`` / ``state_bytes``) with admission state loads both ways.
Every comparison is bitwise (tolerance 0): both packages run the same
``ps_core.cc`` and the same numpy arithmetic.
"""
import io
import os
import re
import subprocess
import sys
import time

import numpy as np
import pytest

from paddle_tpu.distributed import entry as jentry
from paddle_tpu.distributed.fleet import ps as jps
from paddle_tpu_torch.distributed import entry as tentry
from paddle_tpu_torch.distributed.fleet import ps as tps
from paddle_tpu_torch.distributed.fleet.ps import SparseTable

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CFG = dict(dim=8, optimizer="adam", lr=0.01, seed=3, init_std=0.05)
_FUTURE = lambda: int(time.time() * 1000) + 60_000  # noqa: E731


def _spilled_twin(tmp_path, ids, name="spill"):
    """(plain, tiered) same-seed port tables and the reference's plain
    one; the tiered table has every row demoted to its spill file."""
    a = SparseTable(**_CFG)
    b = SparseTable(**_CFG)
    j = jps.SparseTable(**_CFG)
    assert b.enable_spill(str(tmp_path / name))
    for t in (a, b, j):
        t.pull(ids)
    assert b.spill_sweep(_FUTURE()) == ids.size
    assert b.spill_stats()["cold"] == ids.size
    return a, b, j


def test_pull_parity_across_tiers(tmp_path):
    ids = np.arange(500, dtype=np.int64)
    a, b, j = _spilled_twin(tmp_path, ids)
    probe = np.array([0, 7, 499, 7], np.int64)
    np.testing.assert_array_equal(b.pull(probe), a.pull(probe))
    st = b.spill_stats()
    assert st["promoted"] == 3 and st["hot"] == 3
    np.testing.assert_array_equal(b.pull(ids), a.pull(ids))
    np.testing.assert_array_equal(b.pull(ids), j.pull(ids))


@pytest.mark.parametrize("op", ["push", "push_delta"])
def test_push_parity_across_tiers(tmp_path, op):
    ids = np.arange(200, dtype=np.int64)
    a, b, j = _spilled_twin(tmp_path, ids, name=op)
    g = np.random.RandomState(1).randn(50, _CFG["dim"]).astype(np.float32)
    sub = np.arange(0, 200, 4, dtype=np.int64)
    for sign in (1, -1):
        for t in (a, b, j):
            getattr(t, op)(sub, sign * g)
        np.testing.assert_array_equal(b.pull(ids), a.pull(ids))
        np.testing.assert_array_equal(b.pull(ids), j.pull(ids))


def test_checkpoint_bit_exact_and_format_unchanged(tmp_path):
    ids = np.arange(300, dtype=np.int64)
    a, b, j = _spilled_twin(tmp_path, ids)
    b.pull(ids[:100])                      # 100 hot, 200 cold
    a.save(str(tmp_path / "a"))
    b.save(str(tmp_path / "b"))
    j.save(str(tmp_path / "j"))
    da, db, dj = (np.load(str(tmp_path / f"{n}.npz")) for n in "abj")
    assert sorted(da.files) == sorted(db.files) == sorted(dj.files)
    for k in da.files:
        np.testing.assert_array_equal(da[k], db[k])
    oa, oj = np.argsort(da["ids"]), np.argsort(dj["ids"])
    np.testing.assert_array_equal(da["vals"][oa], dj["vals"][oj])
    # the reference's file loads into a spill-enabled port table
    c = SparseTable(**_CFG)
    assert c.enable_spill(str(tmp_path / "c_spill"))
    c.load(str(tmp_path / "j"))
    np.testing.assert_array_equal(c.pull(ids), a.pull(ids))


def test_replica_snapshot_parity_across_tiers(tmp_path):
    ids = np.arange(256, dtype=np.int64)
    a, b, j = _spilled_twin(tmp_path, ids)
    g = np.random.RandomState(2).randn(ids.size,
                                       _CFG["dim"]).astype(np.float32)
    for t in (a, b, j):
        t.push(ids, g)
    b.spill_sweep(_FUTURE())               # the snapshot reads the cold tier
    ra, rb = SparseTable(**_CFG), SparseTable(**_CFG)
    rj = jps.SparseTable(**_CFG)
    ra.load_state_bytes(a.state_bytes())
    rb.load_state_bytes(b.state_bytes())
    rj.load_state_bytes(b.state_bytes())   # the port's tiered snapshot
    for r in (ra, rb, rj):
        r.push(ids, g)                     # optimizer state came across
    np.testing.assert_array_equal(rb.pull(ids), ra.pull(ids))
    np.testing.assert_array_equal(rj.pull(ids), ra.pull(ids))


def test_ttl_sweep_demotes_instead_of_evicting(tmp_path):
    t = SparseTable(**_CFG)
    assert t.enable_spill(str(tmp_path / "ttl"))
    ids = np.arange(100, dtype=np.int64)
    vals = t.pull(ids).copy()
    n = len(t)
    assert t.spill_sweep(_FUTURE()) == 100
    assert len(t) == n
    assert t.spill_stats() == {"hot": 0, "cold": 100, "promoted": 0,
                               "demoted": 100}
    np.testing.assert_array_equal(t.pull(ids), vals)
    assert t.spill_stats()["promoted"] == 100


def test_spill_recovery_bit_exact(tmp_path):
    sdir = str(tmp_path / "rec")
    ids = np.arange(1000, dtype=np.int64)
    oracle = jps.SparseTable(**_CFG)
    t = SparseTable(**_CFG)
    assert t.enable_spill(sdir)
    g = np.random.RandomState(4).randn(ids.size,
                                       _CFG["dim"]).astype(np.float32)
    for tab in (oracle, t):
        tab.pull(ids)
        tab.push(ids, g)
    t.spill_sweep(_FUTURE())
    del t
    r = SparseTable(**_CFG)
    assert r.recover_spill(sdir) == ids.size
    np.testing.assert_array_equal(r.pull(ids), oracle.pull(ids))
    r.push(ids, g)
    oracle.push(ids, g)
    np.testing.assert_array_equal(r.pull(ids), oracle.pull(ids))
    # the reference's table recovers the port's spill files too
    r2 = jps.SparseTable(**_CFG)
    r.spill_sweep(_FUTURE())
    del r
    assert r2.recover_spill(sdir) == ids.size
    np.testing.assert_array_equal(r2.pull(ids), oracle.pull(ids))


_KILL_CHILD = r"""
import sys, time
import numpy as np
sys.path.insert(0, {repo!r})
from paddle_tpu_torch.distributed.fleet.ps import SparseTable
t = SparseTable(dim=8, optimizer="adam", lr=0.01, seed=3, init_std=0.05)
assert t.enable_spill({sdir!r})
ids = np.arange(5000, dtype=np.int64)
t.pull(ids)
g = np.random.RandomState(4).randn(5000, 8).astype(np.float32)
t.push(ids, g)
t.spill_sweep(int(time.time() * 1000) + 60_000)
print("SWEEPING", flush=True)
while True:  # promote/demote churn until SIGKILLed mid-sweep
    t.pull(ids)
    t.spill_sweep(int(time.time() * 1000) + 60_000)
"""


def test_sigkill_mid_sweep_recovers_committed_rows(tmp_path):
    """A port process SIGKILLed during promote/demote churn: every
    record recovery accepts is bitwise the reference table's history
    (the commit mark lands after the payload)."""
    sdir = str(tmp_path / "kill")
    p = subprocess.Popen(
        [sys.executable, "-c", _KILL_CHILD.format(repo=_REPO, sdir=sdir)],
        stdout=subprocess.PIPE, text=True)
    try:
        assert p.stdout.readline().strip() == "SWEEPING"
        time.sleep(0.15)
    finally:
        p.kill()
        p.wait(timeout=15)
    r = SparseTable(**_CFG)
    ids = np.arange(5000, dtype=np.int64)
    recovered = r.recover_spill(sdir)
    assert 0 <= recovered <= ids.size
    oracle = jps.SparseTable(**_CFG)
    oracle.pull(ids)
    oracle.push(ids, np.random.RandomState(4).randn(5000, 8)
                .astype(np.float32))
    r.save(str(tmp_path / "r"))
    d = np.load(str(tmp_path / "r.npz"))
    got_ids = np.asarray(d["ids"], np.int64)
    assert got_ids.size == recovered
    if recovered:
        np.testing.assert_array_equal(
            np.asarray(d["vals"], np.float32), oracle.pull(got_ids))


def test_simd_toggle_is_bit_exact():
    if not SparseTable.simd_available():
        pytest.skip("native core built without AVX2")
    ids = np.arange(333, dtype=np.int64)
    g = np.random.RandomState(5).randn(ids.size, 8).astype(np.float32)
    out = {}
    try:
        for simd in (True, False):
            SparseTable.set_simd(simd)
            t = SparseTable(**_CFG)
            t.pull(ids)
            for _ in range(3):
                t.push(ids, g)
                t.push_delta(ids, g * 0.5)
            out[simd] = t.pull(ids)
    finally:
        SparseTable.set_simd(True)
    np.testing.assert_array_equal(out[True], out[False])
    j = jps.SparseTable(**_CFG)
    j.pull(ids)
    for _ in range(3):
        j.push(ids, g)
        j.push_delta(ids, g * 0.5)
    np.testing.assert_array_equal(out[True], j.pull(ids))


# ---------------------------------------------------------------------------
# feature admission
# ---------------------------------------------------------------------------

class _EveryThird:
    """A custom entry: the Python admission path over native rows."""
    needs_count = True

    def admit(self, id_, seen_count):
        return id_ % 3 == 0 or seen_count >= 2


def _entries(pkg):
    e = jentry if pkg == "jax" else tentry
    return {"count2": e.CountFilterEntry(2), "prob": e.ProbabilityEntry(0.4),
            "custom": _EveryThird()}


def _admission_run(table, seed=7):
    """Pulls and pushes over a small vocabulary: returns every pull and
    the table's rows and admission state at the end."""
    rng = np.random.default_rng(seed)
    outs = []
    for _ in range(6):
        ids = rng.integers(0, 40, 24).astype(np.int64)
        outs.append(table.pull(ids).copy())
        table.push(ids, rng.standard_normal((24, 4)).astype(np.float32))
        table.push_delta(ids[:5], np.ones((5, 4), np.float32))
    return outs, table._entry_state(), table.pull(np.arange(40))


def _sorted_entry(st):
    o = np.argsort(st["seen_ids"])
    return (np.sort(st["admitted"]), st["seen_ids"][o], st["seen_counts"][o])


@pytest.mark.parametrize("backend", ["auto", "python"])
@pytest.mark.parametrize("kind", ["count2", "prob", "custom"])
def test_entry_admission_bitwise_jax(kind, backend):
    kw = dict(optimizer="adagrad", lr=0.1, seed=9, init_std=0.0
              if backend == "python" else 0.02, backend=backend)
    j = jps.SparseTable(4, entry=_entries("jax")[kind], **kw)
    t = SparseTable(4, entry=_entries("port")[kind], **kw)
    assert t.is_native == j.is_native == (backend == "auto")
    assert t._native_entry == j._native_entry
    jo, js, jr = _admission_run(j)
    to, ts, tr = _admission_run(t)
    for a, b in zip(jo, to):
        assert np.array_equal(a, b)
    assert np.array_equal(jr, tr)
    for a, b in zip(_sorted_entry(js), _sorted_entry(ts)):
        assert np.array_equal(a, b)
    assert t.admitted_total == j.admitted_total


def test_probability_entry_admits_the_native_subset():
    """``ProbabilityEntry.admit`` in Python and the native core's
    ``prob_admit`` admit the same ids (the hash is shared)."""
    ids = np.arange(2000, dtype=np.int64)
    e = tentry.ProbabilityEntry(0.3)
    py = np.asarray([e.admit(int(i), 0) for i in ids])
    assert py.tolist() == [jentry.ProbabilityEntry(0.3).admit(int(i), 0)
                           for i in ids]
    t = SparseTable(4, entry=e, init_std=0.5)
    rows = t.pull(ids)
    assert np.array_equal(np.any(rows != 0, axis=1), py)


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
@pytest.mark.parametrize("fmt", ["state_bytes", "save"])
def test_entry_state_rides_checkpoints_both_ways(direction, fmt, tmp_path):
    kw = dict(optimizer="sgd", lr=0.5, seed=4, init_std=0.02)
    src_pkg, dst_pkg = direction.split("_to_")
    mk = {"jax": (jps.SparseTable, jentry), "port": (SparseTable, tentry)}
    S, E = mk[src_pkg]
    src = S(4, entry=E.CountFilterEntry(3), **kw)
    rng = np.random.default_rng(11)
    for _ in range(5):
        src.pull(rng.integers(0, 30, 20).astype(np.int64))
    D, DE = mk[dst_pkg]
    dst = D(4, entry=DE.CountFilterEntry(3), **kw)
    if fmt == "state_bytes":
        dst.load_state_bytes(src.state_bytes())
    else:
        src.save(str(tmp_path / "t"))
        dst.load(str(tmp_path / "t"))
    for a, b in zip(_sorted_entry(src._entry_state()),
                    _sorted_entry(dst._entry_state())):
        assert np.array_equal(a, b)
    probe = np.arange(30, dtype=np.int64)
    assert np.array_equal(dst.pull(probe), src.pull(probe))


# ---------------------------------------------------------------------------
# the Python backend
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("opt", ["sgd", "adagrad", "adam"])
def test_python_backend_bitwise_jax_python_backend(opt):
    kw = dict(optimizer=opt, lr=0.05, seed=13, init_std=0.03,
              backend="python")
    j, t = jps.SparseTable(6, **kw), SparseTable(6, **kw)
    assert not t.is_native and not j.is_native
    rng = np.random.default_rng(3)
    for _ in range(5):
        ids = rng.integers(0, 50, 30).astype(np.int64)
        assert np.array_equal(t.pull(ids), j.pull(ids))
        g = rng.standard_normal((30, 6)).astype(np.float32)
        t.push(ids, g)
        j.push(ids, g)
        t.push_delta(ids[:4], g[:4])
        j.push_delta(ids[:4], g[:4])
    assert t.version == j.version
    a = np.load(io.BytesIO(t.state_bytes()))
    b = np.load(io.BytesIO(j.state_bytes()))
    assert sorted(a.files) == sorted(b.files)
    for k in ("ids", "vals", "opt_state"):
        assert np.array_equal(a[k], b[k]), k
    # the snapshot crosses to the native backend (the rows it holds)
    n = SparseTable(6, **{**kw, "backend": "auto"})
    n.load_state_bytes(j.state_bytes())
    assert np.array_equal(n.pull(a["ids"]), t.pull(a["ids"]))


# Adam is left out: the reference's Python backend takes its bias
# correction ``1 - beta ** t`` in f64, the native core in f32
@pytest.mark.parametrize("opt", ["sgd", "adagrad"])
def test_python_backend_equals_native_at_zero_init(opt):
    kw = dict(optimizer=opt, lr=0.05, seed=13, init_std=0.0)
    py, nat = SparseTable(5, backend="python", **kw), SparseTable(5, **kw)
    rng = np.random.default_rng(8)
    for _ in range(4):
        ids = rng.integers(0, 25, 16).astype(np.int64)
        g = rng.integers(-3, 4, (16, 5)).astype(np.float32)
        for t in (py, nat):
            t.push(ids, g)
    every = np.arange(25, dtype=np.int64)
    assert np.array_equal(py.pull(every), nat.pull(every))


def test_custom_initializer_takes_the_python_backend():
    t = SparseTable(3, initializer=lambda: np.full(3, 0.5, np.float32))
    assert not t.is_native
    assert np.all(t.pull(np.arange(4)) == 0.5)
    assert t.resolve(np.arange(2)) is None and t.pull_plan([1]) is None
    assert not t.enable_spill("unused") and not t.spill_enabled


def test_set_vals_and_resolve_bitwise_jax():
    j, t = jps.SparseTable(4, seed=2), SparseTable(4, seed=2)
    ids = np.array([5, 1, 9], np.int64)
    vals = np.arange(12, dtype=np.float32).reshape(3, 4)
    for s in (j, t):
        s.pull(np.array([1], np.int64))
        s.set_vals(ids, vals)
    assert t.version == j.version == 1
    assert np.array_equal(t.pull(ids), j.pull(ids))
    assert t.pin_read()
    try:
        addrs = t.resolve(ids)
        assert addrs.dtype == np.uint64 and np.all(addrs > 0)
    finally:
        t.unpin_read()


def test_geo_stamps_bitwise_jax():
    j, t = jps.SparseTable(4, geo_policy="lww"), \
        SparseTable(4, geo_policy="lww")
    ids = np.array([3, 8, 1], np.int64)
    for s in (j, t):
        s.geo_put(ids, np.array([4, 2, 9], np.int64),
                  np.array([0, 1, 1], np.int32))
    for a, b in zip(j.geo_get(np.array([8, 2, 3], np.int64)),
                    t.geo_get(np.array([8, 2, 3], np.int64))):
        assert np.array_equal(a, b)
    ja, ta = j.geo_export(), t.geo_export()
    oj, ot = np.argsort(ja[0]), np.argsort(ta[0])
    for a, b in zip(ja, ta):
        assert np.array_equal(a[oj], b[ot])
    assert t.clone_config().geo_policy == "lww"
    with pytest.raises(ValueError, match="geo_policy"):
        SparseTable(4, geo_policy="max")


def test_native_bindings_are_the_reference_set():
    """Every ``pts_*`` symbol the reference's wrapper declares has
    argument types in the port's wrapper, and the same ones."""
    from paddle_tpu.native import ps_core as jcore
    from paddle_tpu_torch.native import ps_core as tcore
    jl, tl = jcore(), tcore()
    with open(os.path.join(_REPO, "paddle_tpu", "native",
                           "__init__.py")) as f:
        src = f.read()
    names = sorted(set(re.findall(r"lib\.(pts_\w+)\.argtypes", src)))
    assert len(names) == 43
    for n in names:
        ja, ta = getattr(jl, n).argtypes, getattr(tl, n).argtypes
        assert ja == ta, n
        assert getattr(jl, n).restype == getattr(tl, n).restype, n
    assert tps.__all__ == jps.__all__
