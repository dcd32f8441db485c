"""The online loop of the port (``paddle_tpu_torch/online``) against the
JAX package: the sorted segment-sum's plain version and
``merge_segments``, the streaming trainer's pushes, and the whole loop
(primary, read replica, TTL sweeper) on a seeded stream.

Tolerances: ``segment_sum_sorted``'s registered one (atol 1e-6, "bit-
exact for integer-valued grads"); the merge, the trainer's pushes and
the loop's tables are held bitwise (every path adds each segment's rows
in row order from 0.0, and both packages run the same native table
core).  Every wait is bounded.
"""
import importlib
import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from paddle_tpu.distributed.fleet.ps import SparseTable as JTable
from paddle_tpu.distributed.fleet.ps_service import PSServer as JServer
from paddle_tpu.framework import monitor as jmonitor
from paddle_tpu.io.dataloader import DataLoader as JLoader
from paddle_tpu.io.dataset import IterableDataset as JIterable
from paddle_tpu.online import FeatureLifecycle as JLifecycle
from paddle_tpu.online import StreamingTrainer as JTrainer
from paddle_tpu_torch.distributed.fleet import (PSClient, PSServer,
                                                SparseTable)
from paddle_tpu_torch.framework import monitor
from paddle_tpu_torch.io import DataLoader, IterableDataset
from paddle_tpu_torch.observability import flight_recorder
from paddle_tpu_torch.online import FeatureLifecycle, StreamingTrainer
from paddle_tpu_torch.ops.kernels import registry
from paddle_tpu_torch.ops.kernels.segment_sum import (
    SORTED_NSEG_MIN, merge_segments, segment_sum, segment_sum_sorted,
    segment_sum_sorted_ref)

jseg = importlib.import_module("paddle_tpu.ops.pallas.segment_sum")

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_FAST = dict(connect_timeout=2.0, rpc_timeout=2.0, max_retries=8,
             backoff_base=0.02, rpc_deadline=30.0)
# counting table: sgd lr 1, gradient -1, init 0 -> a row's value is the
# number of batches applied to it
_COUNT = dict(dim=4, optimizer="sgd", lr=1.0, seed=0, init_std=0.0)


@pytest.fixture()
def _metrics():
    monitor.enable_metrics(True)
    jmonitor.enable_metrics(True)
    yield
    on = os.environ.get("PADDLE_METRICS", "0") == "1"
    monitor.enable_metrics(on)
    jmonitor.enable_metrics(on)


def _hist_count(mon, name):
    h = mon.metrics_snapshot().get("histograms", {}).get(name)
    return 0 if h is None else int(h["count"])


# ---------------------------------------------------------------------------
# kernel 8's plain version and merge_segments against JAX
# ---------------------------------------------------------------------------

def test_sorted_plain_matches_jax_at_vocab_scale():
    """The reference test's shape: 256 rows of dim 16 into 200,000
    segments, random f32 gradients, within the registered atol 1e-6; the
    result also comes out bitwise (recorded by the second assert)."""
    rng = np.random.default_rng(21)
    nseg, n, dim = 200_000, 256, 16
    seg = np.sort(rng.integers(0, nseg, n)).astype(np.int64)
    g = rng.standard_normal((n, dim)).astype(np.float32)
    got = segment_sum_sorted(torch.from_numpy(g), seg, nseg).numpy()
    ref = np.asarray(jseg.segment_sum_sorted_ref(g, seg, nseg))
    ker = np.asarray(jseg.segment_sum_sorted_pallas(g, seg, nseg,
                                                    interpret=True))
    assert got.shape == (nseg, dim)
    np.testing.assert_allclose(got, ker, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    assert np.array_equal(got, ker) and np.array_equal(got, ref)


@pytest.mark.parametrize("nseg,n", [(6000, 64), (513, 9), (4096, 8)])
def test_sorted_plain_integer_grads_bitwise(nseg, n):
    rng = np.random.default_rng(22)
    seg = np.sort(rng.integers(0, nseg, n)).astype(np.int64)
    g = rng.integers(-50, 50, (n, 5)).astype(np.float32)
    got = segment_sum_sorted_ref(torch.from_numpy(g), seg, nseg).numpy()
    for want in (jseg.segment_sum_sorted_ref(g, seg, nseg),
                 jseg.segment_sum_sorted_pallas(g, seg, nseg,
                                                interpret=True)):
        assert np.array_equal(got, np.asarray(want))


@pytest.mark.parametrize("universe,n", [(40, 128), (20_000, 8192)])
def test_merge_segments_picks_the_kernel_by_segment_count(universe, n):
    """Below ``SORTED_NSEG_MIN`` unique ids the merge takes kernel 7, at
    or above it kernel 8 (the plain versions here, counted); either way
    it is bitwise ``np.add.at`` and the JAX ``merge_segments``."""
    rng = np.random.default_rng(23)
    ids = rng.integers(0, universe, n)
    uniq, inv = np.unique(ids, return_inverse=True)
    g = rng.standard_normal((n, 6)).astype(np.float32)
    sorted_path = uniq.size >= SORTED_NSEG_MIN
    assert sorted_path == (universe > 40)
    registry.reset_counts()
    got = merge_segments(torch.from_numpy(g), inv, uniq.size).numpy()
    calls = {k: s.torch_ref_calls for k, s in registry.kernels().items()}
    assert calls["segment_sum_sorted"] == int(sorted_path)
    assert calls["segment_sum"] == int(not sorted_path)
    want = np.zeros((uniq.size, 6), np.float32)
    np.add.at(want, inv, g)
    assert np.array_equal(got, want)
    assert np.array_equal(got, np.asarray(jseg.merge_segments(
        g, inv, uniq.size)))


def test_sorted_kernel_refuses_what_it_does_not_take():
    """The CUDA route names what it refuses (asked for explicitly here:
    on a CPU tensor the eligibility check runs up to the device test)."""
    g = torch.zeros(4, 3)
    seg = np.array([0, 1, 1, 2])
    cases = [((g.double(), seg, 3), "float32"),
             ((g.reshape(4, 3, 1), seg, 3), "2-D"),
             ((g, torch.from_numpy(seg), 3), "host"),
             ((g, seg.astype(np.float32), 3), "integer"),
             ((g, np.array([0, 2, 1, 2]), 3), "ascending"),
             ((g, np.array([0, 1, 1, 3]), 3), "outside"),
             ((g, seg, 3), "CUDA tensor")]
    for args, msg in cases:
        with pytest.raises(ValueError, match=msg):
            registry.dispatch("segment_sum_sorted", *args, mode="cuda")
    spec = registry.spec("segment_sum_sorted")
    assert spec.replaces == "paddle_tpu/ops/pallas/segment_sum.py:126"
    assert spec.tolerance == jseg.registry.kernels()[
        "segment_sum_sorted"].tolerance


def test_sorted_matches_kernel7_order_on_an_unsorted_merge():
    """Kernel 8 after the stable sort adds in kernel 7's order: the two
    plain versions agree bitwise on random f32 rows."""
    rng = np.random.default_rng(5)
    inv = np.minimum(rng.zipf(1.3, 5000) - 1, 4999)
    g = torch.from_numpy(rng.standard_normal((5000, 13)).astype(np.float32))
    a = segment_sum(g, inv, 5000)
    b = merge_segments(g, inv, 5000)
    assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the trainer's pushes against the JAX trainer
# ---------------------------------------------------------------------------

class _Sink:
    """A client that records every stamped push and answers pulls."""

    def __init__(self, dim):
        self.dim = dim
        self.pushes = []

    def pull(self, table, ids):
        return np.zeros((np.asarray(ids).size, self.dim), np.float32)

    def push_stamped(self, table, ids, grads, seq, src=None, wm=None):
        self.pushes.append((np.array(ids), np.array(grads), int(seq),
                            src))
        return True


def _zipf_feed(base, n_batches, rows, universe, seed):
    class Feed(base):
        def __iter__(self):
            rng = np.random.default_rng(seed)
            for i in range(n_batches):
                yield {"ids": rng.integers(0, universe, rows)
                       .astype(np.int64), "i": i}
    return Feed()


def _collate(items):
    return {"ids": np.concatenate([np.asarray(d["ids"], np.int64)
                                   for d in items]),
            "i": int(items[0]["i"])}


def _seeded_grads(batch, dim=8):
    ids = np.asarray(batch["ids"]).reshape(-1)
    i = int(np.asarray(batch["i"]))
    g = np.random.default_rng(100 + i).standard_normal(
        (ids.size, dim)).astype(np.float32)
    return ids, g


def test_trainer_pushes_match_jax_trainer():
    """``StreamingTrainer(device_merge=True, device="cpu")`` and the JAX
    trainer push the same ``(ids, grads, seq)`` bitwise on a stream of
    8,192-row batches with more than 4,096 unique ids each (the sorted
    merge), the port's step returning a torch tensor."""
    n_batches = 3
    port_sink, jax_sink = _Sink(8), _Sink(8)

    def port_step(batch, pull):
        ids, g = _seeded_grads(batch)
        return ids, torch.from_numpy(g)

    def jax_step(batch, pull):
        return _seeded_grads(batch)

    registry.reset_counts()
    StreamingTrainer(
        DataLoader(_zipf_feed(IterableDataset, n_batches, 8192, 20_000, 1),
                   batch_size=1, collate_fn=_collate),
        port_sink, "emb", port_step, device_merge=True,
        device="cpu").run()
    assert registry.spec("segment_sum_sorted").torch_ref_calls == n_batches
    JTrainer(JLoader(_zipf_feed(JIterable, n_batches, 8192, 20_000, 1),
                     batch_size=1, collate_fn=_collate),
             jax_sink, "emb", jax_step, device_merge=True).run()
    assert len(port_sink.pushes) == len(jax_sink.pushes) == n_batches
    for (pi, pg, ps, psrc), (ji, jg, js, jsrc) in zip(port_sink.pushes,
                                                      jax_sink.pushes):
        assert pi.size >= SORTED_NSEG_MIN
        assert np.array_equal(pi, ji) and ps == js and psrc == jsrc
        assert pg.dtype == np.float32 and np.array_equal(pg, jg)


def test_small_host_batches_merge_in_numpy():
    """Host gradients of fewer than 4,096 rows merge in numpy even under
    ``device_merge=True`` (no kernel and no plain version runs), and the
    pushes are bitwise the JAX trainer's.  ``kernel_mode`` takes only
    None or "torch_ref"."""
    port_sink, jax_sink = _Sink(8), _Sink(8)

    def step(batch, pull):
        return _seeded_grads(batch)

    registry.reset_counts()
    StreamingTrainer(
        DataLoader(_zipf_feed(IterableDataset, 2, 512, 300, 2),
                   batch_size=1, collate_fn=_collate),
        port_sink, "emb", step, device_merge=True,
        device="cpu").run()
    assert not any(s.torch_ref_calls for s in registry.kernels().values())
    JTrainer(JLoader(_zipf_feed(JIterable, 2, 512, 300, 2), batch_size=1,
                     collate_fn=_collate),
             jax_sink, "emb", step, device_merge=True).run()
    assert len(port_sink.pushes) == len(jax_sink.pushes) == 2
    for (pi, pg, ps, _), (ji, jg, js, _) in zip(port_sink.pushes,
                                                jax_sink.pushes):
        assert pi.size < 512 and np.array_equal(pi, ji) and ps == js
        assert np.array_equal(pg, jg)
    with pytest.raises(ValueError, match="kernel_mode"):
        StreamingTrainer(None, _Sink(4), "emb", step,
                         device_merge=True, device="cpu",
                         kernel_mode="cuda")


def test_device_merge_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        StreamingTrainer(None, _Sink(4), "emb", _seeded_grads,
                         device_merge=True)
    with pytest.raises(NotImplementedError, match="ROADMAP.md item 6"):
        from paddle_tpu_torch.online import FreshnessWatch  # noqa: F401


# ---------------------------------------------------------------------------
# the whole slice against the JAX package
# ---------------------------------------------------------------------------

# the wide&deep stream (26 fields of Zipf(1.3) ids over 20,000 each,
# offset per field) at its smoke dim 8, with the full batch of 1,024 so
# that a batch holds ~6,200 unique ids and takes the sorted merge
_WD = dict(n_slots=26, vocab=20_000, batch=1024, dim=8, batches=3)
_SEEDED = np.arange(10 ** 6, 10 ** 6 + 100, dtype=np.int64)


def _wd_feed(base):
    W = _WD

    class Feed(base):
        def __iter__(self):
            rng = np.random.RandomState(0)
            for _ in range(W["batches"]):
                z = np.clip(rng.zipf(1.3, (W["batch"], W["n_slots"])), 1,
                            W["vocab"])
                ids = (z - 1) + np.arange(W["n_slots"]) * W["vocab"]
                yield {"ids": ids.astype(np.int64).reshape(-1),
                       "y": rng.rand(W["batch"]).astype(np.float32),
                       "ingest_ts": time.time()}
    return Feed()


def _wd_collate(items):
    (d,) = items
    return {"ids": d["ids"], "y": d["y"], "ingest_ts": d["ingest_ts"]}


def _wd_grads(batch, pull):
    """Pull the batch's rows and step them toward each example's label:
    numpy f32 arithmetic, the same bits in both packages."""
    ids = np.asarray(batch["ids"]).reshape(-1).astype(np.int64)
    rows = pull(ids)
    y = np.repeat(np.asarray(batch["y"], np.float32), _WD["n_slots"])
    return ids, (rows - y[:, None]).astype(np.float32)


def _run_loop(pkg):
    """Primary + read replica + sweeper of one package over the stream;
    returns (primary table, replica table, server, replica, sweeper)."""
    if pkg == "port":
        S, T, Tr, L, Loader, Base = (PSServer, SparseTable, StreamingTrainer,
                                     FeatureLifecycle, DataLoader,
                                     IterableDataset)
    else:
        S, T, Tr, L, Loader, Base = (JServer, JTable, JTrainer, JLifecycle,
                                     JLoader, JIterable)
    spec = dict(dim=_WD["dim"], optimizer="adagrad", lr=0.05, seed=3)
    prim = S({"emb": T(**spec)}, host="127.0.0.1")
    prim.start()
    pep = f"127.0.0.1:{prim.port}"
    rep = S({"emb": T(**spec)}, host="127.0.0.1", replica_of=pep,
            replica_mode="read", wm_interval_s=0.05)
    rep.start()
    cli = PSClient([pep], **_FAST)
    try:
        assert rep.replica_ready.wait(10.0)
        cli.push("emb", _SEEDED, np.ones((_SEEDED.size, _WD["dim"]),
                                         np.float32))
        sweeper = L(prim, ttl_s=8.0, interval_s=1.0)
        assert sweeper.sweep_once(now=10.0) == {"emb": 0}   # primes
        assert sweeper.sweep_once(now=14.0) == {"emb": 0}
        kw = dict(device_merge=True)
        if pkg == "port":
            kw["device"] = "cpu"

            def step(batch, pull):
                ids, g = _wd_grads(batch, pull)
                return ids, torch.from_numpy(g)
        else:
            step = _wd_grads
        tr = Tr(Loader(_wd_feed(Base), batch_size=1,
                       collate_fn=_wd_collate), cli, "emb", step, **kw)
        tr.run()
        assert tr.batches == _WD["batches"]
        # the seeded ids were last seen at 10 s, the stream's at 14 s
        assert sweeper.sweep_once(now=20.0) == {"emb": _SEEDED.size}
        assert _wait(lambda: rep._stats()["watermark"]
                     >= prim._stats()["applied"])
        return (prim._tables["emb"]._snapshot_arrays(full_state=True),
                rep._tables["emb"]._snapshot_arrays(full_state=True))
    finally:
        cli.close()
        rep.stop()
        prim.stop()


def _wait(pred, timeout=15.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.02)
    return pred()


def _sorted_state(d):
    o = np.argsort(d["ids"])
    return d["ids"][o], d["vals"][o], d["opt_state"][o], int(d["version"])


def test_whole_slice_matches_jax(_metrics):
    """The same seeded wide&deep stream through a primary, a read replica
    and a TTL sweeper of each package: the final primary tables agree
    within atol 1e-6 (and come out bitwise), each replica equals its
    primary, the swept ids are gone everywhere, and the port's
    ``ps_freshness_ms`` histogram counts every batch."""
    registry.reset_counts()
    h0 = _hist_count(monitor, "ps_freshness_ms")
    port_p, port_r = _run_loop("port")
    assert _hist_count(monitor, "ps_freshness_ms") - h0 >= _WD["batches"]
    assert registry.spec("segment_sum_sorted").torch_ref_calls == \
        _WD["batches"]
    jax_p, jax_r = _run_loop("jax")
    pi, pv, po, pver = _sorted_state(port_p)
    ji, jv, jo, jver = _sorted_state(jax_p)
    assert np.array_equal(pi, ji) and pver == jver
    np.testing.assert_allclose(pv, jv, rtol=0, atol=1e-6)
    np.testing.assert_allclose(po, jo, rtol=0, atol=1e-6)
    assert np.array_equal(pv, jv) and np.array_equal(po, jo)
    for prim, rep in ((port_p, port_r), (jax_p, jax_r)):
        for x, y in zip(_sorted_state(prim), _sorted_state(rep)):
            assert np.array_equal(x, y)
        assert not np.isin(_SEEDED, prim["ids"]).any()
        assert not np.isin(_SEEDED, rep["ids"]).any()


# ---------------------------------------------------------------------------
# the reference's online-loop tests, ported
# ---------------------------------------------------------------------------

class _Feed(IterableDataset):
    """Unbounded feed: batch i touches ids 0..31 and stamps its ingest
    time."""

    def __iter__(self):
        while True:
            yield {"ids": np.arange(32, dtype=np.int64),
                   "ingest_ts": time.time()}


def _count_collate(items):
    # ingest_ts as a python float: the loader narrows float64 arrays
    return {"ids": np.concatenate([np.asarray(d["ids"], np.int64)
                                   for d in items]),
            "ingest_ts": max(d["ingest_ts"] for d in items)}


def _count_step(batch, pull):
    ids = np.asarray(batch["ids"]).reshape(-1)
    return ids, np.full((ids.size, 4), -1.0, np.float32)


def test_streaming_trainer_feeds_replica_freshness(_metrics):
    prim = PSServer({"emb": SparseTable(**_COUNT)}, host="127.0.0.1")
    prim.start()
    pep = f"127.0.0.1:{prim.port}"
    rep = PSServer({"emb": SparseTable(**_COUNT)}, host="127.0.0.1",
                   replica_of=pep, replica_mode="read", wm_interval_s=0.05)
    rep.start()
    cli = PSClient([pep], mode="sync", **_FAST)
    try:
        assert rep.replica_ready.wait(10.0)
        h0 = _hist_count(monitor, "ps_freshness_ms")
        tr = StreamingTrainer(DataLoader(_Feed(), batch_size=1,
                                         collate_fn=_count_collate),
                              cli, "emb", _count_step)
        tr.run(max_batches=20)
        assert tr.batches == 20 and tr.seq == 20
        assert _wait(lambda: rep._stats()["watermark"] >= 20)
        assert rep._stats()["ingest_wm"] > 0
        snap = monitor.metrics_snapshot()
        assert snap["histograms"]["ps_freshness_ms"]["count"] - h0 >= 20
        assert "ps_replica_lag_seconds" in snap["gauges"]
        rd = PSClient([pep], mode="read", max_lag=64,
                      read_replicas=[f"127.0.0.1:{rep.port}"], **_FAST)
        try:
            assert np.all(rd.pull("emb", np.arange(32, dtype=np.int64))
                          == 20.0)
            assert rd.read_fanout >= 1
        finally:
            rd.close()
        assert "online.ingest" in {e.get("kind")
                                   for e in flight_recorder.events()}
    finally:
        cli.close()
        rep.stop()
        prim.stop()


def test_full_loop_with_ttl_sweeper(_metrics):
    """Streaming, background TTL sweeps and a read replica together: the
    sweeper never evicts the stream's refreshed ids, and the replica
    tracks both the pushes and the evictions."""
    spec = dict(dim=4, optimizer="adagrad", lr=0.1, seed=7)
    prim = PSServer({"emb": SparseTable(**spec)}, host="127.0.0.1")
    prim.start()
    pep = f"127.0.0.1:{prim.port}"
    rep = PSServer({"emb": SparseTable(**spec)}, host="127.0.0.1",
                   replica_of=pep, replica_mode="read", wm_interval_s=0.05)
    rep.start()
    cli = PSClient([pep], mode="sync", **_FAST)
    sweeper = None
    try:
        assert rep.replica_ready.wait(10.0)
        cli.push("emb", np.arange(100, 110, dtype=np.int64),
                 np.ones((10, 4), np.float32))
        sweeper = FeatureLifecycle(prim, ttl_s=0.4, interval_s=0.1).start()

        def slow_step(b, pull):
            time.sleep(0.05)     # ~1 s of streaming: several sweeps
            ids = np.asarray(b["ids"]).reshape(-1)
            return ids, np.ones((ids.size, 4), np.float32)

        tr = StreamingTrainer(DataLoader(_Feed(), batch_size=1,
                                         collate_fn=_count_collate),
                              cli, "emb", slow_step)
        tr.run(max_batches=20)
        sweeper.stop()
        live = set(int(i) for i in
                   prim._tables["emb"]._snapshot_arrays()["ids"])
        assert set(range(32)) <= live
        assert not set(range(100, 110)) & live
        assert sweeper.evicted >= 10
        assert _wait(lambda: rep._tables["emb"].version
                     == prim._tables["emb"].version)
        rep_ids = rep._tables["emb"]._snapshot_arrays()["ids"]
        assert sorted(int(i) for i in rep_ids) == sorted(live)
    finally:
        if sweeper is not None:
            sweeper.stop()
        cli.close()
        rep.stop()
        prim.stop()


_TRAINER_PROC_SRC = r"""
import json, os, sys, time
sys.path.insert(0, sys.argv[1])
cfg = json.loads(sys.argv[2])
import numpy as np
from paddle_tpu_torch.distributed.fleet import PSClient
from paddle_tpu_torch.io import DataLoader, IterableDataset
from paddle_tpu_torch.online import StreamingTrainer

class Feed(IterableDataset):
    def __iter__(self):
        while True:
            yield {"ids": np.arange(32, dtype=np.int64)}

def collate(items):
    return {"ids": np.concatenate([np.asarray(d["ids"], np.int64)
                                   for d in items])}

calls = [0]

def step(batch, pull):
    calls[0] += 1
    if calls[0] == cfg.get("hang_at"):
        # the batch after a few pushes past the last checkpoint: say so,
        # then wait for the SIGKILL
        open(cfg["marker"], "w").close()
        time.sleep(120)
    ids = np.asarray(batch["ids"]).reshape(-1)
    return ids, np.full((ids.size, 4), -1.0, np.float32)

cli = PSClient([cfg["ep"]], mode="sync", connect_timeout=2.0,
               rpc_timeout=2.0, max_retries=6, backoff_base=0.02,
               rpc_deadline=20.0)
tr = StreamingTrainer(DataLoader(Feed(), batch_size=1, collate_fn=collate),
                      cli, "emb", step, src="stream-acc",
                      state_path=cfg["state"], ckpt_every=7)
tr.run(max_batches=max(0, int(cfg["until_seq"]) - tr.seq))
print(json.dumps({"seq": tr.seq, "dups": tr.dup_acks,
                  "batches": tr.batches}), flush=True)
cli.close()
"""


def test_trainer_sigkill_resume_exactly_once(tmp_path):
    """A subprocess trainer is SIGKILLed three pushes past its last cursor
    checkpoint (seq 14; it pushed 15-17 and hangs in batch 18's step),
    resumes from the cursor, replays 15-17 as duplicate acks and ends
    bitwise at the fault-free table."""
    until = 40
    prim = PSServer({"emb": SparseTable(**_COUNT)}, host="127.0.0.1")
    prim.start()
    ep = f"127.0.0.1:{prim.port}"
    marker = str(tmp_path / "hung")
    cfg = {"ep": ep, "state": str(tmp_path / "cursor.json"),
           "until_seq": until, "hang_at": 18, "marker": marker}
    env = dict(os.environ)
    env.pop("PADDLE_CHAOS", None)
    p1 = subprocess.Popen([sys.executable, "-c", _TRAINER_PROC_SRC, _REPO,
                           json.dumps(cfg)], env=env,
                          stdout=subprocess.DEVNULL)
    try:
        assert _wait(lambda: os.path.exists(marker), timeout=30.0), \
            "the first trainer never reached batch 18"
        os.kill(p1.pid, signal.SIGKILL)
        p1.wait(timeout=10)
        assert p1.returncode == -signal.SIGKILL
        assert prim.applied == 17
        with open(cfg["state"]) as f:
            assert json.load(f)["seq"] == 14
        out = subprocess.run(
            [sys.executable, "-c", _TRAINER_PROC_SRC, _REPO,
             json.dumps(dict(cfg, hang_at=None))], env=env,
            capture_output=True, text=True, timeout=30)
        assert out.returncode == 0, out.stderr
        res = json.loads(out.stdout.strip().splitlines()[-1])
        assert res["seq"] == until and res["dups"] == 3
        assert prim.applied == until and prim.dup_acks == 3
        got = prim._tables["emb"].pull(np.arange(32, dtype=np.int64))
        assert np.all(got == float(until))
    finally:
        if p1.poll() is None:
            p1.kill()
            p1.wait(timeout=10)
        prim.stop()
