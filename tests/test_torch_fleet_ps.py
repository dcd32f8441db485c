"""The fleet PS entry points of the port (``fleet_base.py``,
``role_maker.py``, ``PSRuntime``, ``metrics.py``), the geo client mode
and replica-side read coalescing, against the JAX package.

The reference's cases (``tests/test_fleet_role_maker_util.py``, the
role-maker, ``run_server``-from-env, pure-trainer and geo-mode cases of
``tests/test_ps_heartbeat.py`` and ``tests/test_ps_fault_tolerance.py``,
and the coalescing cases of ``tests/test_read_replica.py``) run on the
port; the role makers, the metrics and a geo-mode client's pushes are
also held to the reference's on the same inputs (bitwise; the
collectives' sums within float32 ``assert_allclose`` defaults, as the
reference holds them).  Every wait is bounded.
"""
import importlib
import os
import pkgutil
import threading
import time

import numpy as np
import pytest

import paddle_tpu_torch
from paddle_tpu.distributed.fleet import metrics as jmetrics
from paddle_tpu.distributed.fleet import ps_service as jpss
from paddle_tpu.distributed.fleet import role_maker as jrm
from paddle_tpu_torch.distributed import fleet
from paddle_tpu_torch.distributed.fleet import chaos, metrics
from paddle_tpu_torch.distributed.fleet.fleet_base import Fleet
from paddle_tpu_torch.distributed.fleet.ps import PSRuntime, SparseTable
from paddle_tpu_torch.distributed.fleet.ps_service import (PSClient,
                                                           PSServer)
from paddle_tpu_torch.distributed.fleet.role_maker import (
    PaddleCloudRoleMaker, Role, UserDefinedRoleMaker, UtilBase,
    endpoint_groups, replica_primary_for)
from paddle_tpu_torch.distributed.fleet.strategy import DistributedStrategy

_FAST = dict(connect_timeout=2.0, rpc_timeout=1.0, max_retries=6,
             backoff_base=0.02, rpc_deadline=20.0)
_COUNT = dict(dim=4, optimizer="sgd", lr=1.0, seed=0, init_std=0.0)
_ENV = ("TRAINING_ROLE", "PADDLE_TRAINER_ID", "PADDLE_TRAINERS_NUM",
        "PADDLE_TRAINER_ENDPOINTS", "PADDLE_PSERVERS_IP_PORT_LIST",
        "POD_IP", "PADDLE_PORT")


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for k in _ENV:
        monkeypatch.delenv(k, raising=False)
    yield
    chaos.uninstall()


def _hb_server():
    srv = PSServer({"emb": SparseTable(4, optimizer="sgd", lr=0.5)},
                   host="127.0.0.1", heartbeat_timeout=0.6)
    srv.monitor._interval = 0.05
    srv.start()
    return srv, [f"127.0.0.1:{srv.port}"]


def _ftserver(dim=4, lr=0.5, seed=7, replica_of=None, **kw):
    srv = PSServer({"emb": SparseTable(dim, optimizer="sgd", lr=lr,
                                       seed=seed)},
                   host="127.0.0.1", replica_of=replica_of, **kw)
    srv.start()
    return srv, f"127.0.0.1:{srv.port}"


def _cserver(replica_of=None, mode="standby", **kw):
    srv = PSServer({"emb": SparseTable(**_COUNT)}, host="127.0.0.1",
                   replica_of=replica_of, replica_mode=mode, **kw)
    srv.start()
    return srv, f"127.0.0.1:{srv.port}"


def _push_n(cli, n, ids):
    for _ in range(n):
        cli.push("emb", ids, np.full((ids.size, 4), -1.0, np.float32))


# ---------------------------------------------------------------------------
# role makers, UtilBase, metrics
# ---------------------------------------------------------------------------

def test_paddle_cloud_role_maker_env(monkeypatch):
    monkeypatch.setenv("TRAINING_ROLE", "TRAINER")
    monkeypatch.setenv("PADDLE_TRAINER_ID", "2")
    monkeypatch.setenv("PADDLE_TRAINERS_NUM", "4")
    monkeypatch.setenv("PADDLE_TRAINER_ENDPOINTS",
                       "a:1,b:2,c:3,d:4")
    rm = PaddleCloudRoleMaker()
    assert rm.is_worker() and not rm.is_server()
    assert rm.worker_index() == 2 and rm.worker_num() == 4
    assert rm.get_trainer_endpoints() == ["a:1", "b:2", "c:3", "d:4"]
    assert not rm.is_first_worker()

    monkeypatch.setenv("TRAINING_ROLE", "PSERVER")
    monkeypatch.setenv("POD_IP", "10.0.0.2")
    monkeypatch.setenv("PADDLE_PORT", "6200")
    monkeypatch.setenv("PADDLE_PSERVERS_IP_PORT_LIST",
                       "10.0.0.1:6200,10.0.0.2:6200")
    rm = PaddleCloudRoleMaker()
    assert rm.is_server() and rm.server_index() == 1
    monkeypatch.setenv("TRAINING_ROLE", "NONSENSE")
    with pytest.raises(ValueError, match="TRAINING_ROLE"):
        PaddleCloudRoleMaker()


def test_user_defined_role_maker_and_file_shard():
    rm = UserDefinedRoleMaker(current_id=1, role=Role.WORKER,
                              worker_num=3)
    u = UtilBase(rm)
    files = [f"f{i}" for i in range(8)]   # 8 over 3 -> 3,3,2
    assert u.get_file_shard(files) == ["f3", "f4", "f5"]
    u0 = UtilBase(UserDefinedRoleMaker(current_id=0, worker_num=3))
    assert u0.get_file_shard(files) == ["f0", "f1", "f2"]
    u2 = UtilBase(UserDefinedRoleMaker(current_id=2, worker_num=3))
    assert u2.get_file_shard(files) == ["f6", "f7"]


def test_util_collectives_over_ps_two_workers():
    tables = {"emb": SparseTable(4)}
    # expected_workers guards launch skew: the first barrier must not
    # complete before both workers have ever registered
    srv = PSServer(tables, host="127.0.0.1", heartbeat_timeout=5.0,
                   expected_workers=2)
    srv.start()
    eps = [f"127.0.0.1:{srv.port}"]
    results = {}

    def worker(rank):
        cli = PSClient(eps, mode="sync", worker_id=f"w{rank}")
        u = UtilBase(UserDefinedRoleMaker(current_id=rank, worker_num=2))
        u._set_ps_client(cli)
        x = np.asarray([1.0 + rank, 10.0 * (rank + 1)], np.float32)
        results[f"sum{rank}"] = u.all_reduce(x, mode="sum")
        results[f"max{rank}"] = u.all_reduce(x, mode="max")
        results[f"gather{rank}"] = u.all_gather(x)
        # metrics ride the same util
        results[f"acc{rank}"] = metrics.acc(
            np.asarray([2.0 + rank]), np.asarray([4.0]), util=u)
        cli.leave()
        cli.close()

    ts = [threading.Thread(target=worker, args=(r,)) for r in range(2)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=30)
    try:
        np.testing.assert_allclose(results["sum0"], [3.0, 30.0])
        np.testing.assert_allclose(results["sum1"], [3.0, 30.0])
        np.testing.assert_allclose(results["max0"], [2.0, 20.0])
        g = sorted(np.asarray(v).tolist() for v in results["gather0"])
        assert g == [[1.0, 10.0], [2.0, 20.0]]
        # correct = 2 + 3 = 5 over total = 8
        assert abs(results["acc0"] - 5.0 / 8.0) < 1e-6
        assert abs(results["acc1"] - 5.0 / 8.0) < 1e-6
    finally:
        srv.stop()


def test_metrics_single_process_identity():
    u = UtilBase()
    np.testing.assert_allclose(
        metrics.sum(np.asarray([1.0, 2.0]), util=u), [1.0, 2.0])
    assert metrics.mae(np.asarray([3.0]), np.asarray([6.0]),
                       util=u) == 0.5
    assert metrics.rmse(np.asarray([8.0]), np.asarray([2.0]),
                        util=u) == 2.0
    # auc from bucket stats: perfect separation -> 1.0
    pos = np.zeros(10); pos[9] = 5
    neg = np.zeros(10); neg[0] = 5
    assert metrics.auc(pos, neg, util=u) == 1.0
    # chance: same buckets -> 0.5
    pos2 = np.zeros(10); pos2[4] = 5
    neg2 = np.zeros(10); neg2[4] = 5
    assert abs(metrics.auc(pos2, neg2, util=u) - 0.5) < 1e-6


# ---------------------------------------------------------------------------
# the geo client mode, the pure trainer, run_server from the environment
# ---------------------------------------------------------------------------

def test_geo_mode_accumulates_and_flushes_deltas():
    # GeoCommunicator parity: deltas accumulate client-side and hit the
    # server only every k pushes (and at barrier), via push_delta (raw
    # add, no server optimizer)
    srv, eps = _hb_server()
    try:
        cli = PSClient(eps, mode="geo", geo_k_steps=3, worker_id="w0")
        ids = np.arange(4, dtype=np.int64)
        base = cli.pull("emb", ids).copy()
        cli.push("emb", ids, np.full((4, 4), 0.5, np.float32))
        cli.push("emb", ids, np.full((4, 4), 0.5, np.float32))
        # 2 < k pushes: nothing on the server yet
        np.testing.assert_allclose(cli.pull("emb", ids), base)
        cli.push("emb", ids, np.full((4, 4), 0.5, np.float32))
        # 3rd push flushed the accumulated 1.5 raw delta
        np.testing.assert_allclose(cli.pull("emb", ids), base + 1.5,
                                   rtol=1e-6)
        cli.push("emb", ids, np.full((4, 4), 0.25, np.float32))
        cli.barrier()   # barrier flushes the remainder
        np.testing.assert_allclose(cli.pull("emb", ids), base + 1.75,
                                   rtol=1e-6)
        cli.close()
    finally:
        srv.stop()


def test_fleet_pure_trainer_builds_client(monkeypatch):
    # a trainer process never calls init_server; init_worker must still
    # connect, register and rendezvous via the launcher env contract
    srv = PSServer({"emb": SparseTable(4)}, host="127.0.0.1",
                   heartbeat_timeout=5.0)
    srv.monitor._interval = 0.05
    srv.start()
    try:
        monkeypatch.setenv("PADDLE_PSERVERS_IP_PORT_LIST",
                           f"127.0.0.1:{srv.port}")
        monkeypatch.setenv("PADDLE_TRAINER_ID", "3")
        f = Fleet()
        f.init(is_collective=False)
        f.init_worker()
        assert f._ps_runtime._client.worker_id == "trainer-3"
        assert f._ps_runtime.worker_barrier(timeout=5.0) == []
        f.stop_worker()
    finally:
        srv.stop()


def test_endpoint_groups_and_replica_primary():
    eps = ["10.0.0.1:7100|10.0.0.2:7100", "10.0.0.3:7100"]
    assert endpoint_groups(eps) == [["10.0.0.1:7100", "10.0.0.2:7100"],
                                    ["10.0.0.3:7100"]]
    assert replica_primary_for("10.0.0.2:7100", eps) == "10.0.0.1:7100"
    assert replica_primary_for("10.0.0.1:7100", eps) is None
    assert replica_primary_for("10.0.0.3:7100", eps) is None
    assert replica_primary_for("10.0.0.9:7100", eps) is None


def test_role_maker_shard_id_inside_replica_group(monkeypatch):
    monkeypatch.setenv("TRAINING_ROLE", "PSERVER")
    monkeypatch.setenv("PADDLE_PSERVERS_IP_PORT_LIST",
                       "10.0.0.1:7100|10.0.0.2:7100,10.0.0.3:7100|10.0.0.4:7100")
    monkeypatch.setenv("POD_IP", "10.0.0.4")
    monkeypatch.setenv("PADDLE_PORT", "7100")
    rm = PaddleCloudRoleMaker()
    assert rm.is_server()
    assert rm.server_index() == 1    # standby of shard 1's primary


def test_fleet_run_server_starts_replica_from_env(monkeypatch):
    prim, pep = _ftserver(seed=3)
    try:
        # a worker must touch the table so the snapshot is non-trivial
        cli = PSClient([pep], **_FAST)
        ids = np.arange(4, dtype=np.int64)
        cli.push("emb", ids, np.ones((4, 4), np.float32))
        expect = prim._tables["emb"].pull(ids)
        monkeypatch.setenv("TRAINING_ROLE", "PSERVER")
        monkeypatch.setenv("PADDLE_PSERVERS_IP_PORT_LIST",
                           f"{pep}|127.0.0.1:0")
        monkeypatch.setenv("POD_IP", "127.0.0.1")
        monkeypatch.setenv("PADDLE_PORT", "0")
        f = Fleet()
        f.init(is_collective=False)
        f.init_server()
        f.run_server()
        srv = f._ps_runtime._server
        assert srv.role == "replica" and srv.replica_of == pep
        assert srv.replica_ready.wait(10.0)
        # replica recovered the table (dim included) from the snapshot
        assert np.array_equal(srv._tables["emb"].pull(ids), expect)
        cli.close()
        f._ps_runtime.stop()
    finally:
        prim.stop()


# ---------------------------------------------------------------------------
# replica-side read coalescing
# ---------------------------------------------------------------------------

def test_coalesced_single_pull_bit_equal_direct():
    """Even a batch of ONE goes through the union-gather + scatter
    path: unsorted ids with duplicates must come back exactly like a
    direct pull."""
    prim, pep = _cserver()
    rep, rep_ep = _cserver(replica_of=pep, mode="read",
                          read_coalesce_ms=5.0)
    try:
        assert rep.replica_ready.wait(10.0)
        w = PSClient([pep], **_FAST)
        ids = np.arange(32, dtype=np.int64)
        _push_n(w, 3, ids)
        rd = PSClient([pep], mode="read", max_lag=8,
                      read_replicas=[rep_ep], **_FAST)
        odd = np.asarray([7, 3, 3, 31, 0, 7], np.int64)
        deadline = time.monotonic() + 10.0
        while time.monotonic() < deadline:
            got = rd.pull("emb", odd)
            if np.all(got == 3.0):
                break
            time.sleep(0.05)
        ref = w.pull("emb", odd)          # primary = uncoalesced path
        assert np.array_equal(got, ref)
        assert got.shape == (6, 4)
        rd.close()
        w.close()
    finally:
        rep.stop()
        prim.stop()


def test_concurrent_pulls_coalesce_bit_equal():
    """N concurrent bounded pulls inside the window merge into one
    gather over the union of ids; every reader's rows are bit-equal
    to its uncoalesced pull of the quiesced table."""
    from paddle_tpu_torch.framework import monitor as _monitor
    prim, pep = _cserver()
    rep, rep_ep = _cserver(replica_of=pep, mode="read",
                          read_coalesce_ms=40.0)
    try:
        assert rep.replica_ready.wait(10.0)
        w = PSClient([pep], **_FAST)
        ids = np.arange(64, dtype=np.int64)
        _push_n(w, 4, ids)
        # wait for the replica to fully catch up (quiesced afterwards)
        deadline = time.monotonic() + 10.0
        while time.monotonic() < deadline and rep._watermark < 4:
            time.sleep(0.02)
        assert rep._watermark == 4
        rng = np.random.RandomState(0)
        id_sets = [np.sort(rng.choice(64, size=24, replace=True))
                   .astype(np.int64) for _ in range(8)]
        refs = [w.pull("emb", s).copy() for s in id_sets]
        b0 = _monitor.stat_get("ps_read_coalesce_batches")
        p0 = _monitor.stat_get("ps_read_coalesced_pulls")
        results = [None] * 8
        errors = []
        start = threading.Barrier(8)

        def reader(i):
            try:
                cli = PSClient([pep], mode="read", max_lag=8,
                               read_replicas=[rep_ep], **_FAST)
                start.wait(10.0)
                results[i] = cli.pull("emb", id_sets[i]).copy()
                cli.close()
            except Exception as e:   # noqa: BLE001
                errors.append(e)
        threads = [threading.Thread(target=reader, args=(i,))
                   for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30.0)
        assert not errors, errors
        for got, ref in zip(results, refs):
            assert np.array_equal(got, ref)
        pulls = _monitor.stat_get("ps_read_coalesced_pulls") - p0
        batches = _monitor.stat_get("ps_read_coalesce_batches") - b0
        assert pulls == 8
        # released together behind a barrier into a 40ms window: at
        # least one merge actually happened
        assert batches < pulls, (batches, pulls)
        w.close()
    finally:
        rep.stop()
        prim.stop()


def test_solitary_pull_skips_the_window():
    """A leader elected on a QUIET coalescer (no flush within the
    last window) executes immediately — a low-rate reader must not
    pay the whole window as a fixed latency floor."""
    from paddle_tpu_torch.distributed.fleet.ps_service import _ReadCoalescer

    class _T:
        def pull(self, ids):
            return np.asarray(ids, dtype=np.float32)[:, None]

    co = _ReadCoalescer(lambda name: _T(), 0.5)
    t0 = time.monotonic()
    out = co.pull("emb", np.arange(4, dtype=np.int64))
    assert time.monotonic() - t0 < 0.25, "quiet pull paid the window"
    assert np.array_equal(out.reshape(-1),
                          np.arange(4, dtype=np.float32))


def test_full_batch_flushes_before_window():
    """Once ``flush_at`` pulls are pending the leader abandons the
    window wait — amortization is achieved; waiting longer would only
    add latency."""
    from paddle_tpu_torch.distributed.fleet.ps_service import _ReadCoalescer

    class _T:
        def pull(self, ids):
            return np.asarray(ids, dtype=np.float32)[:, None]

    co = _ReadCoalescer(lambda name: _T(), 5.0, flush_at=3)
    co.pull("emb", np.arange(2, dtype=np.int64))   # warm-up: not quiet
    ok = []
    start = threading.Barrier(3)

    def reader(i):
        start.wait(10.0)
        ids = np.arange(i, i + 4, dtype=np.int64)
        vals = co.pull("emb", ids)
        ok.append(np.array_equal(vals.reshape(-1),
                                 ids.astype(np.float32)))
    t0 = time.monotonic()
    ts = [threading.Thread(target=reader, args=(i,)) for i in range(3)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(30.0)
    assert len(ok) == 3 and all(ok)
    assert time.monotonic() - t0 < 2.5, \
        "full batch still waited out the 5s window"


def test_early_flush_observes_coalescer_telemetry():
    """When the ``read_coalesce_batch`` ceiling (not the timer)
    flushes the batch, the coalescer telemetry still observes:
    ``ps_read_coalesce_batches`` / ``ps_read_coalesced_pulls`` count
    and the size histogram records the early-flushed batch size."""
    from paddle_tpu_torch.distributed.fleet.ps_service import _ReadCoalescer
    from paddle_tpu_torch.framework import monitor as _monitor

    class _T:
        def pull(self, ids):
            return np.asarray(ids, dtype=np.float32)[:, None]

    was_on = _monitor.metrics_enabled()
    _monitor.enable_metrics(True)
    try:
        co = _ReadCoalescer(lambda name: _T(), 5.0, flush_at=3)
        b0 = _monitor.stat_get("ps_read_coalesce_batches")
        p0 = _monitor.stat_get("ps_read_coalesced_pulls")
        h = _monitor.get_histogram("ps_read_coalesce_size")
        hc0 = h.count if h is not None else 0
        hs0 = h.sum if h is not None else 0.0
        co.pull("emb", np.arange(2, dtype=np.int64))  # warm: not quiet
        start = threading.Barrier(3)
        ok = []

        def reader(i):
            start.wait(10.0)
            ids = np.arange(i, i + 4, dtype=np.int64)
            vals = co.pull("emb", ids)
            ok.append(np.array_equal(vals.reshape(-1),
                                     ids.astype(np.float32)))
        t0 = time.monotonic()
        ts = [threading.Thread(target=reader, args=(i,))
              for i in range(3)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(30.0)
        assert len(ok) == 3 and all(ok)
        # the CEILING flushed (well under the 5s window)...
        assert time.monotonic() - t0 < 2.5
        # ...and the telemetry observed it: 2 gathers (warm-up of 1 +
        # early-flushed batch of 3), 4 coalesced pulls, histogram
        # samples [1, 3]
        assert _monitor.stat_get("ps_read_coalesce_batches") - b0 == 2
        assert _monitor.stat_get("ps_read_coalesced_pulls") - p0 == 4
        h = _monitor.get_histogram("ps_read_coalesce_size")
        assert h is not None
        assert h.count - hc0 == 2
        assert h.sum - hs0 == pytest.approx(4.0)
    finally:
        _monitor.enable_metrics(was_on)


def test_coalescer_error_propagates_to_every_rider():
    from paddle_tpu_torch.distributed.fleet.ps_service import _ReadCoalescer

    def bad_table(name):
        raise KeyError(f"unknown table {name!r}")
    co = _ReadCoalescer(bad_table, 0.02)
    errs = []

    def puller():
        try:
            co.pull("nope", np.arange(4, dtype=np.int64))
        except KeyError as e:
            errs.append(e)
    ts = [threading.Thread(target=puller) for _ in range(3)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(10.0)
    assert len(errs) == 3     # nobody hangs, everyone gets the error


def test_role_makers_match_jax(monkeypatch):
    monkeypatch.setenv("TRAINING_ROLE", "PSERVER")
    monkeypatch.setenv("POD_IP", "10.0.0.4")
    monkeypatch.setenv("PADDLE_PORT", "7100")
    monkeypatch.setenv("PADDLE_PSERVERS_IP_PORT_LIST",
                       "10.0.0.1:7100|10.0.0.2:7100,10.0.0.3:7100|"
                       "10.0.0.4:7100")
    monkeypatch.setenv("PADDLE_TRAINER_ENDPOINTS", "a:1,b:2")
    for mk in (lambda m: m.PaddleCloudRoleMaker(),
               lambda m: m.UserDefinedRoleMaker(
                   current_id=1, role=m.Role.SERVER, worker_num=3,
                   server_endpoints=["s:1", "s:2"])):
        a, b = mk(jrm), mk(paddle_tpu_torch.distributed.fleet.role_maker)
        for q in ("is_worker", "is_server", "is_first_worker",
                  "worker_index", "server_index", "worker_num",
                  "server_num", "get_trainer_endpoints",
                  "get_pserver_endpoints", "role_id", "to_string"):
            assert getattr(a, q)() == getattr(b, q)(), q
    files = [f"f{i}" for i in range(11)]
    for i in range(4):
        ja = jrm.UtilBase(jrm.UserDefinedRoleMaker(current_id=i,
                                                   worker_num=4))
        ta = UtilBase(UserDefinedRoleMaker(current_id=i, worker_num=4))
        assert ja.get_file_shard(files) == ta.get_file_shard(files)


def test_metrics_match_jax_in_a_world_of_one():
    u, ju = UtilBase(), jrm.UtilBase()
    rng = np.random.default_rng(3)
    pos, neg = rng.integers(0, 9, 16), rng.integers(0, 9, 16)
    x, y = rng.random(8), rng.random(8)
    assert metrics.auc(pos, neg, util=u) == jmetrics.auc(pos, neg, util=ju)
    for name in ("mae", "rmse", "mse"):
        assert getattr(metrics, name)(x, 8.0, util=u) == \
            getattr(jmetrics, name)(x, 8.0, util=ju), name
    assert metrics.acc(x, y, util=u) == jmetrics.acc(x, y, util=ju)
    assert metrics.__all__ == jmetrics.__all__


@pytest.mark.parametrize("server_pkg", ["port", "jax"])
def test_util_all_reduce_over_either_package(server_pkg):
    """Two port workers reduce through a server of either package."""
    S = (PSServer, SparseTable) if server_pkg == "port" else \
        (jpss.PSServer, importlib.import_module(
            "paddle_tpu.distributed.fleet.ps").SparseTable)
    srv = S[0]({"emb": S[1](4)}, host="127.0.0.1",
               heartbeat_timeout=5.0, expected_workers=2)
    srv.start()
    eps = [f"127.0.0.1:{srv.port}"]
    out, errs = {}, []

    def worker(rank):
        try:
            cli = PSClient(eps, mode="sync", worker_id=f"w{rank}", **_FAST)
            u = UtilBase(UserDefinedRoleMaker(current_id=rank, worker_num=2))
            u._set_ps_client(cli)
            x = np.asarray([0.5 + rank, 3.0 * (rank + 1)], np.float32)
            out[rank] = (u.all_reduce(x, mode="sum"),
                         u.all_reduce(x, mode="min"))
            cli.leave()
            cli.close()
        except Exception as e:   # noqa: BLE001
            errs.append(e)
    ts = [threading.Thread(target=worker, args=(r,)) for r in range(2)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=15)
    try:
        assert not errs, errs
        for r in range(2):
            np.testing.assert_array_equal(out[r][0], [2.0, 9.0])
            np.testing.assert_array_equal(out[r][1], [0.5, 3.0])
    finally:
        srv.stop()


# ---------------------------------------------------------------------------
# the fleet entry points over PSRuntime
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["sync", "async", "geo"])
def test_init_worker_picks_the_strategy_mode(mode, monkeypatch):
    srv, eps = _hb_server()
    try:
        s = DistributedStrategy()
        if mode != "sync":
            s.a_sync = True
            s.a_sync_configs = {"geo_sgd_mode": mode == "geo",
                                "geo_sgd_need_push_nums": 2}
        monkeypatch.setenv("PADDLE_PSERVERS_IP_PORT_LIST", eps[0])
        f = Fleet()
        f.init(strategy=s)
        cli = f.init_worker()
        assert cli is f._ps_runtime._client and cli._mode == mode
        if mode == "geo":
            assert cli._geo_k == 2
        ids = np.arange(3, dtype=np.int64)
        base = cli.pull("emb", ids).copy()
        cli.push("emb", ids, np.ones((3, 4), np.float32))
        f.barrier_worker()            # flushes geo deltas, drains async
        want = base - 0.5 if mode != "geo" else base + 1.0
        assert np.array_equal(cli.pull("emb", ids), want)
        f.stop_worker()
    finally:
        srv.stop()


def test_ps_runtime_warm_starts_and_saves(tmp_path):
    rt = PSRuntime()
    t = rt.table("emb", 4, optimizer="adagrad", lr=0.2, seed=3)
    t.push(np.arange(5, dtype=np.int64), np.ones((5, 4), np.float32))
    rt.save_persistables(str(tmp_path))
    rt2 = PSRuntime()
    rt2.init_server(str(tmp_path))
    t2 = rt2._tables["emb"]
    assert t2._opt == "adagrad" and t2._lr == 0.2 and t2.dim == 4
    ids = np.arange(5, dtype=np.int64)
    assert np.array_equal(t2.pull(ids), t.pull(ids))
    rt2.run_server(expected_workers=1)
    try:
        cli = PSClient([f"127.0.0.1:{rt2._server.port}"], **_FAST)
        assert np.array_equal(cli.pull("emb", ids), t.pull(ids))
        cli.close()
    finally:
        rt2.stop()


def test_fleet_api_surface_and_queue_item_4():
    """The collective ``init`` takes dp / fsdp / tp / pp / sp degrees (a
    world of one rank needs no process group; wider degrees need their
    ranks, which ``tests/test_torch_collective.py`` and
    ``tests/test_torch_hybrid.py`` start: a tp degree of 2 here raises
    for its ranks, no longer queue item 4); the LAMB / LARS toggles swap
    the optimizer."""
    from paddle_tpu.distributed.fleet import fleet_base as jfb
    assert set(jfb.__all__) <= set(fleet.__all__)
    for name in ("PSRuntime", "GeoPusher", "PaddleCloudRoleMaker",
                 "UserDefinedRoleMaker", "UtilBase", "metrics", "dgc"):
        assert hasattr(fleet, name), name
    s = DistributedStrategy()
    s.hybrid_configs = {"mp_degree": 2}
    with pytest.raises(ValueError, match="ranks"):
        Fleet().init(is_collective=True, strategy=s)
    s1 = DistributedStrategy()
    s1.sharding = True
    s1.sharding_configs = {"stage": 2, "sharding_degree": 1}
    s1.hybrid_configs = {"dp_degree": 1}
    f = Fleet().init(is_collective=True, strategy=s1)
    assert f.worker_num() == 1 and f.is_worker()
    s2 = DistributedStrategy()
    s2.hybrid_configs = {"dp_degree": 2}
    with pytest.raises(ValueError, match="ranks"):
        Fleet().init(is_collective=True, strategy=s2)
    import torch
    from paddle_tpu_torch.optimizer import Lamb, Lars, Momentum
    m = torch.nn.Linear(2, 1)
    for toggle, cls in (("lamb", Lamb), ("lars", Lars)):
        s3 = DistributedStrategy()
        setattr(s3, toggle, True)
        dopt = f.distributed_optimizer(
            Momentum(0.1, parameters=list(m.parameters())), strategy=s3)
        assert type(dopt.inner_opt) is cls
        assert dopt.inner_opt.get_lr() == 0.1
    opt = f.distributed_optimizer(
        Momentum(0.1, parameters=list(m.parameters())),
        strategy=DistributedStrategy())
    step = f.distributed_train_step(
        m, lambda x: m(x).square().mean(), opt)
    from paddle_tpu_torch.distributed.fleet import DistributedTrainStep
    assert isinstance(step, DistributedTrainStep)
    assert f.distributed_model(m) is m


def test_no_module_raises_item_6():
    """Nothing in the port still refuses a feature as ROADMAP item 6."""
    root = os.path.dirname(paddle_tpu_torch.__file__)
    hits = []
    for dirpath, _, names in os.walk(root):
        for n in names:
            if n.endswith(".py"):
                with open(os.path.join(dirpath, n)) as f:
                    src = f.read()
                if "item 6" in src or "_ITEM6" in src:
                    hits.append(os.path.join(dirpath, n))
    assert not hits, hits
    for m in pkgutil.walk_packages(paddle_tpu_torch.__path__,
                                   "paddle_tpu_torch."):
        if ".tools." in m.name or m.name.endswith(".tools"):
            continue
        importlib.import_module(m.name)
    from paddle_tpu_torch.online import FreshnessWatch, freshness_objectives
    assert [s.metric for s in freshness_objectives()] == [
        "ps_replica_lag_seq", "ps_replica_lag_seconds"]
    assert FreshnessWatch().evaluate(snapshot={})[0]["ok"]
