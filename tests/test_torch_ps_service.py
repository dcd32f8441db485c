"""The port's PS service (``paddle_tpu_torch/distributed/fleet/ps_service.py``)
and its chaos harness, held to the reference's contracts.

- Wire compatibility: a port client against a JAX server and a JAX
  client against a port server, after the same pushes, leave bitwise
  equal tables, and every pull wire (row, zc, q8) decodes the same rows
  from either package's replies; a read replica of either package
  follows a primary of the other.
- The reference's service tests, ported: seq windows, lost-ack retry,
  duplicate delivery, mid-frame cuts, typed errors, async barrier loss
  reports, replica catch-up, failover to a promoted standby, an
  unpromoted standby refusing, the SIGKILL failover, heartbeats and
  worker barriers, sync / async / empty pulls, and the chaos harness's
  wire kinds.

Every wait is bounded.  Subprocess servers import the port, not JAX.
"""
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from paddle_tpu.distributed.fleet import chaos as jchaos
from paddle_tpu.distributed.fleet.ps import SparseTable as JTable
from paddle_tpu.distributed.fleet.ps_service import PSClient as JClient
from paddle_tpu.distributed.fleet.ps_service import PSServer as JServer
from paddle_tpu_torch.distributed.fleet import chaos
from paddle_tpu_torch.distributed.fleet import ps_service as svc
from paddle_tpu_torch.distributed.fleet.chaos import Fault, FaultPlan
from paddle_tpu_torch.distributed.fleet.ps import SparseTable
from paddle_tpu_torch.distributed.fleet.ps_service import (
    HeartBeatMonitor, PSClient, PSConnectError, PSError, PSServer,
    PSUnavailable, _SeqWindow)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# fast-failing client knobs (the defaults are production-scale)
_FAST = dict(connect_timeout=2.0, rpc_timeout=1.0, max_retries=6,
             backoff_base=0.02, rpc_deadline=20.0)


@pytest.fixture(autouse=True)
def _no_leaked_chaos():
    yield
    chaos.uninstall()
    jchaos.uninstall()


def _server(dim=4, lr=0.5, seed=7, replica_of=None, **kw):
    srv = PSServer({"emb": SparseTable(dim, optimizer="sgd", lr=lr,
                                       seed=seed)},
                   host="127.0.0.1", replica_of=replica_of, **kw)
    srv.start()
    return srv, f"127.0.0.1:{srv.port}"


def _wait(pred, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.02)
    return pred()


def _table_state(t):
    d = t._snapshot_arrays(full_state=True)
    o = np.argsort(d["ids"])
    return d["ids"][o], d["vals"][o], d["opt_state"][o], int(d["version"])


def _assert_tables_bitwise(a, b):
    for x, y in zip(_table_state(a), _table_state(b)):
        assert np.array_equal(x, y)


# ---------------------------------------------------------------------------
# wire compatibility with the reference
# ---------------------------------------------------------------------------

_SPEC = dict(optimizer="adagrad", lr=0.1, seed=5, init_std=0.2)


@pytest.mark.parametrize("wire", ["row", "zc", "q8"])
def test_wire_both_directions_bitwise(wire):
    """A port client pushes to a JAX server and a JAX client pushes the
    same to a port server: the two tables end bitwise equal (one native
    core), and each package's client decodes the other's pull replies
    on ``wire`` to the same rows as the server's own package."""
    jsrv = JServer({"emb": JTable(6, **_SPEC)}, host="127.0.0.1")
    psrv = PSServer({"emb": SparseTable(6, **_SPEC)}, host="127.0.0.1")
    jsrv.start()
    psrv.start()
    jep, pep = f"127.0.0.1:{jsrv.port}", f"127.0.0.1:{psrv.port}"
    clients = []
    try:
        port_to_jax = PSClient([jep], pull_wire=wire, **_FAST)
        jax_to_port = JClient([pep], pull_wire=wire, **_FAST)
        port_to_port = PSClient([pep], pull_wire=wire, **_FAST)
        jax_to_jax = JClient([jep], pull_wire=wire, **_FAST)
        clients = [port_to_jax, jax_to_port, port_to_port, jax_to_jax]
        rng = np.random.default_rng(3)
        for step in range(6):
            ids = rng.integers(0, 40, 64).astype(np.int64)  # duplicates
            g = rng.standard_normal((64, 6)).astype(np.float32)
            port_to_jax.push("emb", ids, g)
            jax_to_port.push("emb", ids, g)
            q = rng.integers(0, 50, 33).astype(np.int64)
            a = port_to_jax.pull("emb", q)      # port decodes JAX's reply
            b = jax_to_jax.pull("emb", q)
            c = jax_to_port.pull("emb", q)      # JAX decodes the port's
            d = port_to_port.pull("emb", q)
            assert a.dtype == np.float32 and a.shape == (33, 6)
            for x in (b, c, d):
                assert np.array_equal(a, x), step
        _assert_tables_bitwise(jsrv._tables["emb"], psrv._tables["emb"])
        if wire != "q8":       # the lossless wires ship the rows exactly
            every = np.arange(50, dtype=np.int64)
            assert np.array_equal(port_to_jax.pull("emb", every),
                                  psrv._tables["emb"].pull(every))
    finally:
        for c in clients:
            c.close()
        jsrv.stop()
        psrv.stop()


@pytest.mark.parametrize("replica_pkg", ["port", "jax"])
def test_read_replica_across_packages(replica_pkg):
    """A read replica follows a primary of the other package: snapshot,
    streamed pushes and a TTL eviction, ending bitwise the primary."""
    S, T = (PSServer, SparseTable) if replica_pkg == "port" \
        else (JServer, JTable)
    PS, PT = (JServer, JTable) if replica_pkg == "port" \
        else (PSServer, SparseTable)
    prim = PS({"emb": PT(4, **_SPEC)}, host="127.0.0.1")
    prim.start()
    pep = f"127.0.0.1:{prim.port}"
    cli = PSClient([pep], **_FAST)
    rep = None
    try:
        ids = np.arange(12, dtype=np.int64)
        cli.push("emb", ids, np.ones((12, 4), np.float32))  # pre-snapshot
        rep = S({"emb": T(4, **_SPEC)}, host="127.0.0.1", replica_of=pep,
                replica_mode="read", wm_interval_s=0.05)
        rep.start()
        assert rep.replica_ready.wait(10.0)
        cli.push("emb", ids[:6], np.full((6, 4), 0.5, np.float32))
        prim._tables["emb"].set_clock(1000)
        cli.pull("emb", ids[:6])                 # ids 0-5 sighted at 1000
        assert prim.ttl_sweep(0.5, now=2.0)["emb"] == 6   # cutoff 500 ms
        assert _wait(lambda: rep._stats()["watermark"]
                     >= prim._stats()["applied"])
        _assert_tables_bitwise(prim._tables["emb"], rep._tables["emb"])
        assert len(rep._tables["emb"]) == 6
    finally:
        cli.close()
        if rep is not None:
            rep.stop()
        prim.stop()


# ---------------------------------------------------------------------------
# typed connect errors, constructor timeouts, the drain, empty push_delta
# ---------------------------------------------------------------------------

def test_connect_refused_raises_typed_error_naming_endpoint():
    with pytest.raises(PSConnectError) as ei:
        PSClient(["127.0.0.1:1"], connect_timeout=0.5)
    assert "127.0.0.1:1" in str(ei.value)


def test_unresponsive_server_cannot_wedge_constructor():
    # a listener that accepts but never speaks the protocol
    lst = socket.socket()
    lst.bind(("127.0.0.1", 0))
    lst.listen(8)
    ep = f"127.0.0.1:{lst.getsockname()[1]}"
    t0 = time.monotonic()
    try:
        with pytest.raises(PSUnavailable) as ei:
            PSClient([ep], worker_id="w0", connect_timeout=1.0,
                     rpc_timeout=0.3, max_retries=2, backoff_base=0.01,
                     rpc_deadline=3.0)
        assert ep in str(ei.value)
        assert time.monotonic() - t0 < 10.0
    finally:
        lst.close()


def test_drain_keeps_first_error_and_counts_the_rest():
    srv, ep = _server()
    cli = PSClient([ep], mode="async", rpc_timeout=0.3, max_retries=1,
                   backoff_base=0.01, rpc_deadline=0.8, connect_timeout=0.5)
    ids = np.arange(4, dtype=np.int64)
    cli.push("emb", ids, np.ones((4, 4), np.float32))
    cli.barrier()
    srv.stop()
    # frames into a freshly dead server may land in the TCP buffer before
    # the RST arrives: push until the drainer records a real failure
    deadline = time.monotonic() + 20.0
    while cli._push_err is None:
        assert time.monotonic() < deadline, "drainer never saw an error"
        cli.push("emb", ids, np.ones((4, 4), np.float32))
        cli._q.join()
    first = cli._push_err
    for _ in range(3):
        cli.push("emb", ids, np.ones((4, 4), np.float32))
    cli._q.join()
    assert cli._push_err_later == 3
    with pytest.raises(RuntimeError) as ei:
        cli.barrier()
    assert ei.value.__cause__ is first
    assert isinstance(first, PSUnavailable)
    assert "3 subsequent" in str(ei.value)
    assert cli._push_err is None and cli._push_err_later == 0
    cli.close()


def test_push_delta_empty_ids_skips_rpc_and_keeps_dim():
    srv, ep = _server(dim=5)
    cli = PSClient([ep], **_FAST)
    before = srv.applied
    cli.push_delta("emb", np.zeros(0, np.int64),
                   np.zeros((0, 5), np.float32))
    cli.push_delta("emb", [], [])
    assert srv.applied == before
    ids = np.array([2, 5], np.int64)
    base = cli.pull("emb", ids).copy()
    cli.push_delta("emb", ids, np.full((2, 5), 0.25, np.float32))
    assert srv.applied == before + 1
    assert np.array_equal(cli.pull("emb", ids),
                          base + np.float32(0.25))
    cli.close()
    srv.stop()


# ---------------------------------------------------------------------------
# idempotent retries
# ---------------------------------------------------------------------------

def test_seq_window_semantics():
    w = _SeqWindow()
    assert not w.check_and_record(1)
    assert w.check_and_record(1)          # immediate duplicate
    assert not w.check_and_record(3)      # gaps are fine (sharding)
    assert not w.check_and_record(2)      # late arrival inside window
    assert w.check_and_record(2)
    assert not w.check_and_record(10_000)
    assert w.check_and_record(10_000 - _SeqWindow.WINDOW)   # ancient
    w2 = _SeqWindow.from_export(w.export())
    assert w2.max_seq == w.max_seq
    assert w2.check_and_record(10_000)


def test_lost_ack_retry_applies_push_exactly_once():
    srv, ep = _server(lr=0.5)
    chaos.install(FaultPlan([Fault("drop", op="push_reply", first=1)],
                            seed=1))
    cli = PSClient([ep], mode="sync", **_FAST)
    ids = np.arange(6, dtype=np.int64)
    base = cli.pull("emb", ids).copy()
    cli.push("emb", ids, np.ones((6, 4), np.float32))
    assert np.array_equal(cli.pull("emb", ids), base - np.float32(0.5))
    assert srv.dup_acks == 1 and srv.applied == 1
    assert cli.retries >= 1
    cli.close()
    srv.stop()


def test_duplicate_delivery_fault_plan_applies_push_once():
    srv, ep = _server(lr=1.0)
    plan = chaos.install(chaos.named_plan("dup", seed=3))
    cli = PSClient([ep], mode="async", **_FAST)
    ids = np.arange(8, dtype=np.int64)
    base = cli.pull("emb", ids).copy()
    for _ in range(5):
        cli.push("emb", ids, np.ones((8, 4), np.float32))
    cli.barrier()
    np.testing.assert_allclose(cli.pull("emb", ids), base - 5.0, rtol=1e-5)
    assert plan.stats_dict().get("dup:push", 0) == 5
    assert srv.dup_acks == 5 and srv.applied == 5
    cli.close()
    srv.stop()


def test_mid_frame_cut_is_survived_by_retry():
    srv, ep = _server(lr=0.5)
    plan = chaos.install(FaultPlan(
        [Fault("cut", op="pull", first=2), Fault("cut", op="push", first=1)],
        seed=2))
    cli = PSClient([ep], mode="sync", **_FAST)
    ids = np.arange(4, dtype=np.int64)
    base = cli.pull("emb", ids).copy()      # pull 1 clean
    cli.push("emb", ids, np.ones((4, 4), np.float32))  # push frame cut
    after = cli.pull("emb", ids)            # pull 2 cut
    assert np.array_equal(after, base - np.float32(0.5))
    st = plan.stats_dict()
    assert st.get("cut:pull") == 1 and st.get("cut:push") == 1
    assert cli.retries >= 2
    cli.close()
    srv.stop()


def test_failed_reregister_never_reuses_half_used_socket():
    srv, ep = _server(lr=0.5)
    cli = PSClient([ep], worker_id="w0", connect_timeout=2.0,
                   rpc_timeout=0.5, max_retries=4, backoff_base=0.01,
                   rpc_deadline=20.0)
    ids = np.arange(4, dtype=np.int64)
    base = cli.pull("emb", ids).copy()
    chaos.install(FaultPlan([Fault("delay", op="register_reply", first=1,
                                   times=1, arg=1.5)], seed=4))
    cli._socks[0].close()
    cli._socks[0] = None
    assert np.array_equal(cli.pull("emb", ids), base)
    assert cli.retries >= 1
    cli.close()
    srv.stop()


def test_unknown_table_is_typed_error_not_retry_burn():
    srv, ep = _server()
    cli = PSClient([ep], **_FAST)
    ids = np.arange(2, dtype=np.int64)
    with pytest.raises(PSError) as ei:
        cli.pull("nope", ids)
    assert not isinstance(ei.value, (PSUnavailable, PSConnectError))
    assert "nope" in str(ei.value) and "KeyError" in str(ei.value)
    assert cli.retries == 0
    assert cli.pull("emb", ids).shape == (2, 4)     # the connection lives
    with pytest.raises(PSError) as ei2:
        cli.push("nope", ids, np.ones((2, 4), np.float32))
    assert not isinstance(ei2.value, PSUnavailable)
    cli.close()
    srv.stop()


def test_barrier_confirms_async_delivery_and_reports_loss():
    srv, ep = _server(lr=1.0)
    cli = PSClient([ep], mode="async", **_FAST)
    ids = np.arange(4, dtype=np.int64)
    for _ in range(3):
        cli.push("emb", ids, np.ones((4, 4), np.float32))
    cli.barrier()
    assert cli._unconfirmed[0] == set() and srv.applied == 3
    cli._note_sent(0, 10_000)       # buffered, never delivered
    with pytest.raises(PSUnavailable) as ei:
        cli.barrier()
    assert "lost" in str(ei.value)
    assert cli._unconfirmed[0] == set()
    cli.barrier()
    cli.close()
    srv.stop()


# ---------------------------------------------------------------------------
# replication and failover
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["standby", "read"])
def test_replica_catches_up_from_snapshot_and_stream(mode):
    prim, pep = _server(seed=11)
    cli = PSClient([pep], **_FAST)
    ids = np.arange(8, dtype=np.int64)
    cli.pull("emb", ids)
    cli.push("emb", ids, np.ones((8, 4), np.float32))     # pre-snapshot
    rep, _ = _server(seed=11, replica_of=pep, replica_mode=mode,
                     wm_interval_s=0.05)
    try:
        assert rep.replica_ready.wait(10.0)
        cli.push("emb", ids, np.ones((8, 4), np.float32))  # streamed
        assert _wait(lambda: rep._tables["emb"].version
                     == prim._tables["emb"].version)
        assert np.array_equal(prim._tables["emb"].pull(ids),
                              rep._tables["emb"].pull(ids))
    finally:
        cli.close()
        prim.stop()
        rep.stop()


def test_client_fails_over_to_promoted_replica():
    prim, pep = _server(seed=5)
    rep, rep_ep = _server(seed=5, replica_of=pep)
    assert rep.replica_ready.wait(10.0)
    cli = PSClient([f"{pep}|{rep_ep}"], worker_id="w0", **_FAST)
    ids = np.arange(6, dtype=np.int64)
    base = cli.pull("emb", ids).copy()
    cli.push("emb", ids, np.ones((6, 4), np.float32))
    prim.stop()
    np.testing.assert_allclose(cli.pull("emb", ids), base - 0.5, rtol=1e-5)
    cli.push("emb", ids, np.ones((6, 4), np.float32))
    np.testing.assert_allclose(cli.pull("emb", ids), base - 1.0, rtol=1e-5)
    assert cli.failovers >= 1
    st = cli.server_stats()
    assert st["role"] == "primary" and st["promoted"]
    cli.close()
    rep.stop()


def test_unpromoted_standby_refuses_data_rpcs():
    prim, pep = _server(seed=5)
    rep, rep_ep = _server(seed=5, replica_of=pep)
    assert rep.replica_ready.wait(10.0)
    ids = np.arange(4, dtype=np.int64)
    cli = PSClient([rep_ep], connect_timeout=1.0, rpc_timeout=0.5,
                   max_retries=2, backoff_base=0.01, rpc_deadline=3.0)
    with pytest.raises(PSUnavailable) as ei:
        cli.pull("emb", ids)
    assert "not promoted" in str(ei.value)
    with pytest.raises(PSUnavailable):
        cli.push("emb", ids, np.ones((4, 4), np.float32))
    assert rep.applied == 0
    cli.close()
    # standby first in the list: the client rotates to the primary
    cli2 = PSClient([f"{rep_ep}|{pep}"], **_FAST)
    base = cli2.pull("emb", ids).copy()
    cli2.push("emb", ids, np.ones((4, 4), np.float32))
    np.testing.assert_allclose(cli2.pull("emb", ids), base - 0.5, rtol=1e-5)
    assert cli2.failovers >= 1
    assert prim.applied == 1 and rep.applied == 1
    cli2.close()
    prim.stop()
    rep.stop()


def test_failed_replica_attach_does_not_deadlock_mutations():
    srv, ep = _server(lr=0.5)
    cli = PSClient([ep], **_FAST)
    ids = np.arange(4, dtype=np.int64)
    cli.pull("emb", ids)
    raw = socket.create_connection(svc._parse_ep(ep), timeout=5.0)
    try:
        svc._send_msg_raw(raw, {"op": "replicate"})
        head = svc._recv_msg(raw)
        for _ in head["tables"]:
            assert svc._recv_msg(raw) is not None
        done = threading.Event()

        def _push():
            cli.push("emb", ids, np.ones((4, 4), np.float32))
            done.set()

        t = threading.Thread(target=_push, daemon=True)
        t.start()
        time.sleep(0.3)
        svc._send_msg_raw(raw, {"ok": False})     # reject the snapshot
        assert done.wait(10.0), "push deadlocked behind failed attach"
        assert srv.applied == 1
        with srv._apply_lock:
            assert srv._replicas == []
        cli.push("emb", ids, np.ones((4, 4), np.float32))
        assert srv.applied == 2
    finally:
        raw.close()
        cli.close()
        srv.stop()


_SERVER_PROC_SRC = r"""
import json, os, sys
sys.path.insert(0, sys.argv[1])
cfg = json.loads(sys.argv[2])
from paddle_tpu_torch.distributed.fleet.ps import SparseTable
from paddle_tpu_torch.distributed.fleet.ps_service import PSServer
tables = {n: SparseTable(**kw) for n, kw in cfg["tables"].items()}
srv = PSServer(tables, host="127.0.0.1", replica_of=cfg.get("replica_of"))
srv.start()
print(json.dumps({"port": srv.port, "pid": os.getpid()}), flush=True)
srv._stop.wait()
"""


def _spawn_server(tables, env_extra=None):
    env = dict(os.environ)
    env.pop("PADDLE_CHAOS", None)
    env.update(env_extra or {})
    proc = subprocess.Popen(
        [sys.executable, "-c", _SERVER_PROC_SRC, _REPO,
         json.dumps({"tables": tables})],
        stdout=subprocess.PIPE, text=True, env=env)
    info = json.loads(proc.stdout.readline())
    return proc, f"127.0.0.1:{info['port']}"


def _train(endpoints, steps, ids, kill_at=None, kill_proc=None, dim=4):
    cli = PSClient(endpoints, mode="sync", worker_id="w0", **_FAST)
    for step in range(steps):
        assert cli.pull("emb", ids).shape == (ids.size, dim)
        g = np.full((ids.size, dim), 0.125 * ((step % 5) + 1), np.float32)
        cli.push("emb", ids, g)
        if kill_at is not None and step == kill_at:
            os.kill(kill_proc.pid, signal.SIGKILL)
            kill_proc.wait(timeout=10)
    final = cli.pull("emb", ids).copy()
    cli.close()
    return final


def test_sigkill_failover_matches_fault_free_run_bit_for_bit():
    """Sync training whose subprocess primary is SIGKILLed mid-run ends,
    through the promoted in-process standby, bitwise at the fault-free
    run (no lost and no double-applied push)."""
    spec = {"emb": dict(dim=4, optimizer="adagrad", lr=0.1, seed=23)}
    ids = np.arange(32, dtype=np.int64)
    steps, kill_at = 12, 5
    ref_srv = PSServer({"emb": SparseTable(**spec["emb"])},
                       host="127.0.0.1")
    ref_srv.start()
    try:
        ref = _train([f"127.0.0.1:{ref_srv.port}"], steps, ids)
    finally:
        ref_srv.stop()
    prim_proc, prim_ep = _spawn_server(spec)
    rep = PSServer({"emb": SparseTable(**spec["emb"])}, host="127.0.0.1",
                   replica_of=prim_ep)
    rep.start()
    try:
        assert rep.replica_ready.wait(15.0)
        got = _train([f"{prim_ep}|127.0.0.1:{rep.port}"], steps, ids,
                     kill_at=kill_at, kill_proc=prim_proc)
        assert rep.promoted
        assert np.array_equal(got, ref)
    finally:
        prim_proc.kill()
        prim_proc.wait(timeout=10)
        rep.stop()


def test_chaos_crash_fault_kills_subprocess_server():
    spec = {"emb": dict(dim=4, optimizer="sgd", lr=0.5, seed=1)}
    proc, ep = _spawn_server(
        spec, env_extra={"PADDLE_CHAOS": "crash:push:first=2"})
    cli = PSClient([ep], mode="sync", rpc_timeout=0.5, max_retries=2,
                   backoff_base=0.01, rpc_deadline=3.0, connect_timeout=1.0)
    try:
        ids = np.arange(4, dtype=np.int64)
        cli.push("emb", ids, np.ones((4, 4), np.float32))
        with pytest.raises(PSUnavailable):
            cli.push("emb", ids, np.ones((4, 4), np.float32))
        assert proc.wait(timeout=10) == 137
    finally:
        cli.close()
        proc.kill()
        proc.wait(timeout=10)


def test_unported_options_raise_naming_the_roadmap():
    """Read coalescing, geo sites, the geo client mode, ``geo_set`` and
    commit listeners were refused until the rest of the online tier was
    ported; each now works, and a reference client's ``geo_set`` is
    applied as the reference's server applies it."""
    PSServer({}, host="127.0.0.1", read_coalesce_ms=5.0).stop()
    srv = PSServer({"emb": SparseTable(4, optimizer="sgd", lr=0.5, seed=7,
                                       geo_policy="lww")},
                   host="127.0.0.1", geo_site="a")
    srv.start()
    ep = f"127.0.0.1:{srv.port}"
    seen = []
    try:
        srv.add_commit_listener(lambda rec: seen.append(rec["op"]))
        geo = PSClient([ep], mode="geo", geo_k_steps=2, **_FAST)
        geo.push("emb", [1], [[1.0] * 4])
        assert seen == []                  # accumulated, not sent
        geo.push("emb", [1], [[1.0] * 4])
        assert seen == ["push_delta"]      # the k-th push flushed
        cli = PSClient([ep], **_FAST)
        cli.geo_set("emb", [2], [[0.5] * 4], [7], ["b"])
        jc = JClient([ep], **_FAST)
        jc.geo_set("emb", [3], [[0.25] * 4], [9], ["b"])
        assert seen == ["push_delta", "geo_set", "geo_set"]
        assert srv.applied == 3
        assert srv._geo_stamps["emb"][2] == (7, "b")
        assert srv._geo_stamps["emb"][3] == (9, "b")
        assert np.all(cli.pull("emb", [3]) == 0.25)
        jc.close()
        cli.close()
        geo.close()
    finally:
        srv.stop()


# ---------------------------------------------------------------------------
# worker liveness
# ---------------------------------------------------------------------------

def _hb_server(on_dead="evict", timeout=0.6, **kw):
    srv = PSServer({"emb": SparseTable(4, optimizer="sgd", lr=0.5)},
                   host="127.0.0.1", heartbeat_timeout=timeout,
                   on_dead=on_dead, **kw)
    srv.monitor._interval = 0.05
    srv.start()
    return srv, [f"127.0.0.1:{srv.port}"]


def test_monitor_marks_stale_worker_dead():
    mon = HeartBeatMonitor(timeout=0.2, interval=0.05)
    mon.start()
    try:
        mon.beat("w0")
        mon.beat("w1")
        assert mon.live_workers() == {"w0", "w1"}
        deadline = time.monotonic() + 2.0
        while time.monotonic() < deadline:
            mon.beat("w0")
            if mon.live_workers() == {"w0"}:
                break
            time.sleep(0.05)
        assert mon.live_workers() == {"w0"}
        mon.beat("w1")
        assert mon.live_workers() == {"w0", "w1"}
    finally:
        mon.stop()


def test_worker_barrier_rendezvous():
    srv, eps = _hb_server()
    try:
        c0 = PSClient(eps, worker_id="w0", heartbeat_interval=0.1)
        c1 = PSClient(eps, worker_id="w1", heartbeat_interval=0.1)
        order = []

        def late():
            time.sleep(0.3)
            order.append("w1-enter")
            c1.worker_barrier(timeout=5.0)

        t = threading.Thread(target=late)
        t.start()
        assert c0.worker_barrier(timeout=5.0) == []
        t.join(timeout=10)
        assert not t.is_alive() and order == ["w1-enter"]
        t2 = threading.Thread(target=lambda: c1.worker_barrier(timeout=5.0))
        t2.start()
        c0.worker_barrier(timeout=5.0)
        t2.join(timeout=10)
        assert not t2.is_alive()
        c0.close()
        c1.close()
    finally:
        srv.stop()


@pytest.mark.parametrize("on_dead", ["evict", "fail"])
def test_barrier_with_a_killed_worker(on_dead):
    srv, eps = _hb_server(on_dead=on_dead, timeout=0.4)
    try:
        c0 = PSClient(eps, worker_id="w0", heartbeat_interval=0.1)
        c1 = PSClient(eps, worker_id="w1", heartbeat_interval=0.0)
        c1.close()          # no unregister, no more beats
        if on_dead == "fail":
            with pytest.raises(RuntimeError, match="w1"):
                c0.worker_barrier(timeout=10.0)
        else:
            assert c0.worker_barrier(timeout=10.0) == ["w1"]
            ids = np.arange(4, dtype=np.int64)
            base = c0.pull("emb", ids).copy()
            c0.push("emb", ids, np.ones((4, 4), np.float32))
            np.testing.assert_allclose(c0.pull("emb", ids), base - 0.5,
                                       rtol=1e-5)
        c0.close()
    finally:
        srv.stop()


def test_graceful_leave_is_not_an_eviction():
    srv, eps = _hb_server(on_dead="fail", timeout=5.0)
    try:
        c0 = PSClient(eps, worker_id="w0", heartbeat_interval=0.1)
        c1 = PSClient(eps, worker_id="w1", heartbeat_interval=0.1)
        c1.leave()
        c1.close()
        assert c0.worker_barrier(timeout=5.0) == []
        c0.close()
    finally:
        srv.stop()


def test_expected_workers_gates_early_barrier():
    srv, eps = _hb_server(timeout=5.0, expected_workers=2)
    try:
        c0 = PSClient(eps, worker_id="w0", heartbeat_interval=0.1)
        done = []

        def late_joiner():
            time.sleep(0.5)
            c = PSClient(eps, worker_id="w1", heartbeat_interval=0.1)
            c.worker_barrier(timeout=5.0)
            done.append(c)

        t = threading.Thread(target=late_joiner)
        t.start()
        t0 = time.monotonic()
        c0.worker_barrier(timeout=5.0)
        assert time.monotonic() - t0 > 0.3
        t.join(timeout=10)
        assert not t.is_alive()
        done[0].close()
        c0.close()
    finally:
        srv.stop()


def test_pull_push_traffic_counts_as_liveness():
    srv, eps = _hb_server(on_dead="fail", timeout=0.5)
    try:
        c0 = PSClient(eps, worker_id="w0", heartbeat_interval=0.1)
        c1 = PSClient(eps, worker_id="w1", heartbeat_interval=0.0)
        ids = np.arange(4, dtype=np.int64)
        for _ in range(15):
            c1.pull("emb", ids)
            time.sleep(0.1)
        assert srv.monitor.live_workers() == {"w0", "w1"}
        c0.close()
        c1.close()
    finally:
        srv.stop()


def test_barrier_timeout_errors_instead_of_hanging():
    srv, eps = _hb_server(on_dead="evict", timeout=30.0)
    try:
        c0 = PSClient(eps, worker_id="w0", heartbeat_interval=0.1)
        c1 = PSClient(eps, worker_id="w1", heartbeat_interval=0.1)
        t0 = time.monotonic()
        with pytest.raises(RuntimeError, match="timeout"):
            c0.worker_barrier(timeout=0.5)
        assert time.monotonic() - t0 < 5.0
        c0.close()
        c1.close()
    finally:
        srv.stop()


# ---------------------------------------------------------------------------
# end to end: two shards, sync and async, raw deltas, empty pulls
# ---------------------------------------------------------------------------

def _cluster(n, dim=4, lr=0.5):
    servers = [PSServer({"emb": SparseTable(dim, optimizer="sgd", lr=lr)},
                        host="127.0.0.1") for _ in range(n)]
    for s in servers:
        s.start()
    return servers, [f"127.0.0.1:{s.port}" for s in servers]


@pytest.mark.parametrize("mode", ["sync", "async"])
def test_pull_push_two_servers(mode):
    servers, eps = _cluster(2, lr=1.0)
    try:
        cli = PSClient(eps, mode=mode)
        ids = np.array([0, 1, 2, 3, 10, 11], np.int64)
        base = cli.pull("emb", ids).copy()
        assert base.shape == (6, 4)
        for _ in range(3):
            cli.push("emb", ids, np.ones((6, 4), np.float32))
        cli.barrier()
        np.testing.assert_allclose(cli.pull("emb", ids), base - 3.0,
                                   rtol=1e-5)
        # shard routing: even ids on server 0, odd on server 1
        assert len(servers[0]._tables["emb"]) == 3
        assert len(servers[1]._tables["emb"]) == 3
        cli.close()
    finally:
        for s in servers:
            s.stop()


def test_raw_push_delta_rpc():
    servers, eps = _cluster(1, dim=3)
    try:
        cli = PSClient(eps, mode="sync")
        ids = np.array([5, 6], np.int64)
        base = cli.pull("emb", ids).copy()
        cli._rpc(0, {"op": "push_delta", "table": "emb", "ids": ids,
                     "deltas": np.full((2, 3), 0.25, np.float32),
                     "sync": True}, reply=True)
        assert np.array_equal(cli.pull("emb", ids), base + np.float32(0.25))
        cli.close()
    finally:
        servers[0].stop()


def test_empty_pull():
    servers, eps = _cluster(1, dim=4)
    try:
        cli = PSClient(eps, mode="sync")
        assert cli.pull("emb", np.zeros(0, np.int64)).shape == (0, 4)
        cli.close()
    finally:
        servers[0].stop()


# ---------------------------------------------------------------------------
# the chaos harness's wire kinds
# ---------------------------------------------------------------------------

def _fires(fault, n):
    out = []
    for i in range(1, n + 1):
        fault.matches += 1
        if fault._should_fire():
            out.append(i)
    return out


def test_fault_schedule_first_every_times():
    assert _fires(Fault("delay", first=3), 10) == [3]
    assert _fires(Fault("delay", first=2, every=3, times=0), 12) == \
        [2, 5, 8, 11]
    assert _fires(Fault("delay", first=1, every=2, times=2), 10) == [1, 3]
    a = Fault("cut", first=4, every=5, times=0)
    b = Fault("cut", first=4, every=5, times=0)
    assert _fires(a, 40) == _fires(b, 40)


def test_plan_from_spec_parsing():
    p = chaos.plan_from_spec("seed=9;dup:push:every=2;"
                             "delay:pull:first=3:arg=0.5;"
                             "crash:push:first=50")
    assert p.seed == 9
    assert [(f.kind, f.op) for f in p.faults] == \
        [("dup", "push"), ("delay", "pull"), ("crash", "push")]
    assert p.faults[1].first == 3 and p.faults[1].arg == 0.5
    p2 = chaos.plan_from_spec("plan=dup;seed=4;delay:pull:first=1")
    assert p2.seed == 4 and any(f.kind == "delay" for f in p2.faults)
    for bad in ("explode:push", "badtoken", "dup:push:bogus=1"):
        with pytest.raises(ValueError):
            chaos.plan_from_spec(bad)


def test_named_plans_exist():
    for name in ("flaky", "dup", "lost_ack", "crash@7", "gw_kill@3",
                 "gw_flaky"):
        jp = jchaos.named_plan(name, seed=1)
        p = chaos.named_plan(name, seed=1)
        assert [repr(f) for f in p.faults] == [repr(f) for f in jp.faults]
    assert chaos.named_plan("crash@7").faults[0].first == 7
    with pytest.raises(ValueError):
        chaos.named_plan("nope")
    for name in ("nan_grad@5", "inf_grad@2", "nan_batch@3", "diverge@8"):
        jp = jchaos.named_plan(name, seed=1)
        p = chaos.named_plan(name, seed=1)
        assert [repr(f) for f in p.faults] == [repr(f) for f in jp.faults]


def test_install_uninstall_roundtrip():
    assert chaos.active() is None
    p = chaos.install(FaultPlan([], seed=0))
    assert chaos.active() is p
    chaos.uninstall()
    assert chaos.active() is None


def test_dup_downgrades_on_request_reply_frames():
    srv, ep = _server(lr=0.5)
    plan = chaos.install(FaultPlan(
        [Fault("dup", op="push", first=1, every=1, times=0)], seed=0))
    cli = PSClient([ep], mode="sync", rpc_timeout=2.0, connect_timeout=2.0)
    ids = np.arange(4, dtype=np.int64)
    base = cli.pull("emb", ids).copy()
    cli.push("emb", ids, np.ones((4, 4), np.float32))   # sync: not dup'd
    assert np.array_equal(cli.pull("emb", ids), base - np.float32(0.5))
    st = plan.stats_dict()
    assert st.get("dup_skipped") == 1 and "dup:push" not in st
    cli.close()
    srv.stop()


def test_delay_fault_fires_and_is_counted():
    srv, ep = _server()
    plan = chaos.install(FaultPlan(
        [Fault("delay", op="pull", first=1, every=1, times=3, arg=0.01)],
        seed=0))
    cli = PSClient([ep], rpc_timeout=2.0, connect_timeout=2.0)
    for _ in range(5):
        cli.pull("emb", np.arange(3, dtype=np.int64))
    assert plan.stats_dict().get("delay:pull") == 3
    cli.close()
    srv.stop()


def test_refuse_fault_fails_connect_then_recovers():
    srv, ep = _server()
    cli = PSClient([ep], rpc_timeout=1.0, connect_timeout=1.0,
                   max_retries=6, backoff_base=0.01, rpc_deadline=10.0)
    chaos.install(FaultPlan(
        [Fault("refuse", op="*", first=1, every=1, times=2)], seed=0))
    cli._socks[0].close()
    assert cli.pull("emb", np.arange(2, dtype=np.int64)).shape == (2, 4)
    assert cli.retries >= 1
    cli.close()
    srv.stop()


def test_same_seed_same_injection_sequence():
    def run():
        srv, ep = _server(lr=0.5, seed=3)
        plan = chaos.install(chaos.named_plan("flaky", seed=42))
        cli = PSClient([ep], mode="sync", rpc_timeout=1.0,
                       connect_timeout=2.0, backoff_base=0.01,
                       rpc_deadline=20.0)
        ids = np.arange(16, dtype=np.int64)
        for step in range(12):
            cli.pull("emb", ids)
            cli.push("emb", ids,
                     np.full((16, 4), 0.1 * (step + 1), np.float32))
        rows = cli.pull("emb", ids).copy()
        stats = plan.stats_dict()
        cli.close()
        srv.stop()
        chaos.uninstall()
        return rows, stats

    rows1, stats1 = run()
    rows2, stats2 = run()
    assert stats1 == stats2 and sum(stats1.values()) > 0
    assert np.array_equal(rows1, rows2)
