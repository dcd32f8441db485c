"""Geo replication of the port (``paddle_tpu_torch/distributed/fleet/
geo.py``, the geo parts of ``ps_service.py``) against the JAX package.

The reference's cases (``tests/test_geo.py``, ``tests/test_geo_conflict
.py``) run on the port's servers and pushers; a pusher of either package
replicates into the other's server (the wire is the same); and one
deterministic two-site schedule, drained after every batch, ends with
the same bits in both packages, additive and last-writer-wins.  Every
comparison is bitwise (tolerance 0).  Every wait is bounded.
"""
import os
import sys
import time
from types import SimpleNamespace

import numpy as np
import pytest

from paddle_tpu.distributed.fleet import geo as jgeo
from paddle_tpu.distributed.fleet import ps as jps
from paddle_tpu.distributed.fleet import ps_service as jpss
from paddle_tpu_torch.distributed.fleet import chaos
from paddle_tpu_torch.distributed.fleet.geo import GeoPusher
from paddle_tpu_torch.distributed.fleet.ps import SparseTable
from paddle_tpu_torch.distributed.fleet.ps_service import (PSClient, PSError,
                                                           PSServer,
                                                           PSUnavailable)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_PKG = {
    "port": SimpleNamespace(PSServer=PSServer, PSClient=PSClient,
                            SparseTable=SparseTable, GeoPusher=GeoPusher),
    "jax": SimpleNamespace(PSServer=jpss.PSServer, PSClient=jpss.PSClient,
                           SparseTable=jps.SparseTable,
                           GeoPusher=jgeo.GeoPusher),
}


@pytest.fixture(autouse=True)
def _no_leaked_chaos():
    yield
    chaos.uninstall()


_FAST = dict(connect_timeout=2.0, rpc_timeout=1.0, max_retries=6,
             backoff_base=0.02, rpc_deadline=20.0)
_SPEC = dict(dim=6, optimizer="adagrad", lr=0.1, seed=5)


@pytest.fixture(autouse=True)
def _no_leaked_chaos():
    yield
    chaos.uninstall()


def _cluster(pkg="port"):
    P = _PKG[pkg]
    srv = P.PSServer({"emb": P.SparseTable(**_SPEC)}, host="127.0.0.1")
    srv.start()
    return srv, f"127.0.0.1:{srv.port}"


def _train(ep, steps=20, batch=32, vocab=300, seed=0):
    w = PSClient([ep], mode="sync", **_FAST)
    rng = np.random.RandomState(seed)
    for step in range(steps):
        ids = np.clip(rng.zipf(1.3, batch), 1, vocab).astype(np.int64)
        w.push("emb", ids, np.full((batch, 6),
                                   0.05 * ((step % 7) + 1), np.float32))
    w.close()


def _assert_converged(local, remote, vocab=300):
    all_ids = np.arange(vocab, dtype=np.int64)
    a = local._tables["emb"].pull(all_ids)
    b = remote._tables["emb"].pull(all_ids)
    neq = ~np.all(a == b, axis=1)
    # chaos_ps-style count: ANY differing row is a lost or
    # double-applied delta — the geo contract is exactly zero of each
    assert int(neq.sum()) == 0, \
        f"{int(neq.sum())} rows diverged: ids {np.flatnonzero(neq)[:8]}"


def test_geo_follower_converges_bit_exact():
    local, lep = _cluster()
    remote, rep = _cluster()
    gp = GeoPusher(local, [rep], interval_s=0.01, **_FAST).start()
    try:
        _train(lep, steps=20)
        gp.drain(timeout=30.0)
        _assert_converged(local, remote)
        assert gp.pushed_ids > 0 and gp.push_failures == 0
    finally:
        gp.stop(drain=False)
        local.stop()
        remote.stop()


def test_geo_lossy_delayed_link_zero_lost_zero_double_applied():
    """THE geo acceptance: the geo client's push_delta frames ride a
    seeded lossy/delayed link (delays, dropped acks — the classic
    double-apply trap); the follower still lands on the primary's
    exact bits because retries re-send the SAME (src, seq) and the
    server dedups them."""
    local, lep = _cluster()
    remote, rep = _cluster()
    chaos.install(chaos.plan_from_spec(
        "seed=3;delay:push_delta:first=1:every=2:times=0:arg=0.002;"
        "drop:push_delta_reply:first=2:every=3:times=0;"
        "cut:push_delta:first=9:every=11:times=0"))
    gp = GeoPusher(local, [rep], interval_s=0.01,
                   max_ids_per_flush=64, **_FAST).start()
    try:
        _train(lep, steps=20)
        gp.drain(timeout=60.0)
        _assert_converged(local, remote)
        st = chaos.active().stats_dict()
        assert any(k.startswith(("drop", "delay", "cut"))
                   for k in st), st   # the link really was hostile
        assert remote.dup_acks >= 1   # a retry was deduped, not
        # double-applied — the idempotency stamp did its job
    finally:
        chaos.uninstall()
        gp.stop(drain=False)
        local.stop()
        remote.stop()


def test_geo_rate_limit_and_convergence_bound():
    """Per-table rate: each flush ships at most max_ids_per_flush ids,
    so a backlog of B dirty ids provably drains within ceil(B/R)
    flushes once writes quiesce — the configured staleness bound."""
    local, lep = _cluster()
    remote, rep = _cluster()
    gp = GeoPusher(local, [rep], interval_s=3600.0,   # manual flushes
                   max_ids_per_flush=50, **_FAST)
    try:
        w = PSClient([lep], mode="sync", **_FAST)
        ids = np.arange(170, dtype=np.int64)
        w.push("emb", ids, np.ones((170, 6), np.float32))
        w.close()
        assert gp.backlog() == 170
        bound = -(-170 // 50)         # ceil(B / R) = 4 flushes
        flushes = 0
        while gp.backlog() and flushes < bound:
            gp.flush()
            flushes += 1
        assert gp.backlog() == 0 and flushes == bound
        _assert_converged(local, remote)
    finally:
        gp.stop(drain=False)
        local.stop()
        remote.stop()


def test_geo_remote_outage_requeues_never_drops():
    local, lep = _cluster()
    remote, rep = _cluster()
    remote.stop()                     # remote cluster is DOWN
    gp = GeoPusher(local, [rep], interval_s=3600.0,
                   connect_timeout=0.5, rpc_timeout=0.5, max_retries=1,
                   backoff_base=0.01, rpc_deadline=1.5)
    try:
        w = PSClient([lep], mode="sync", **_FAST)
        ids = np.arange(8, dtype=np.int64)
        w.push("emb", ids, np.ones((8, 6), np.float32))
        w.close()
        assert gp.backlog() == 8
        with pytest.raises((PSError, PSUnavailable)):
            gp.flush()
        assert gp.backlog() == 8      # re-queued, not dropped
        assert gp.push_failures == 1
    finally:
        gp.stop(drain=False)
        local.stop()


def test_geo_python_backend_requires_deterministic_init():
    """The mirror contract: a python-backend table with a random init
    cannot geo-replicate (materialisation-order-dependent init would
    diverge the follower); init_std=0 can."""
    bad = PSServer({"emb": SparseTable(4, optimizer="sgd", lr=0.1,
                                       init_std=0.01,
                                       use_native=False)},
                   host="127.0.0.1")
    bad.start()
    gp = GeoPusher(bad, ["127.0.0.1:1"], interval_s=3600.0,
                   connect_timeout=0.5, rpc_timeout=0.5, max_retries=1,
                   backoff_base=0.01, rpc_deadline=1.0)
    try:
        bad._tables["emb"].push(np.arange(4, dtype=np.int64),
                                np.ones((4, 4), np.float32))
        gp._on_commit({"op": "push", "table": "emb",
                       "ids": np.arange(4, dtype=np.int64)})
        with pytest.raises(PSError, match="deterministic"):
            gp.flush()
    finally:
        gp.stop(drain=False)
        bad.stop()


def test_geo_observability_wiring():
    from paddle_tpu_torch.observability.flight_recorder import \
        _PROGRESS_KINDS
    assert {"ps.geo.push", "ps.replica.attach",
            "ps.promote"} <= set(_PROGRESS_KINDS)
    sys.path.insert(0, os.path.join(_REPO, "tools"))
    import postmortem
    assert postmortem._is_bad({"kind": "ps.read_stale_exhausted"})
    assert postmortem._is_bad({"kind": "ps.replica_error"})
    assert postmortem._is_bad({"kind": "online.freshness_breach"})
    assert postmortem._is_bad({"kind": "slo.breach"})


# ---------------------------------------------------------------------------
# bidirectional geo with conflict policies
# ---------------------------------------------------------------------------

# exact-arithmetic workload: zero init + integer deltas, so the
# additive fixed point is order-insensitive and bit-checkable
_XSPEC = dict(dim=6, optimizer="sgd", lr=1.0, seed=5, init_std=0.0)


def _site(policy, site, pkg="port"):
    P = _PKG[pkg]
    srv = P.PSServer({"emb": P.SparseTable(geo_policy=policy, **_XSPEC)},
                     host="127.0.0.1", geo_site=site)
    srv.start()
    return srv, f"127.0.0.1:{srv.port}"


def _bridge(policy, pkgs=("port", "port")):
    A, aep = _site(policy, "A", pkgs[0])
    B, bep = _site(policy, "B", pkgs[1])
    gA = _PKG[pkgs[0]].GeoPusher(A, [bep], interval_s=3600.0,
                                 **_FAST)  # manual flush
    gB = _PKG[pkgs[1]].GeoPusher(B, [aep], interval_s=3600.0, **_FAST)
    return A, B, aep, bep, gA, gB


def _settle(gA, gB, rounds=8):
    for _ in range(rounds):
        gA.flush()
        gB.flush()
    assert gA.backlog() == 0 and gB.backlog() == 0


def _teardown(*objs):
    for o in objs:
        try:
            if isinstance(o, (GeoPusher, _PKG["jax"].GeoPusher)):
                o.stop(drain=False)
            elif isinstance(o, (PSClient, _PKG["jax"].PSClient)):
                o.close()
            else:
                o.stop()
        except Exception:
            pass


# ---------------------------------------------------------------------------
# additive merge
# ---------------------------------------------------------------------------

def test_additive_bidirectional_fixed_point_concurrent_writes():
    A, B, aep, bep, gA, gB = _bridge("add")
    wa = PSClient([aep], mode="sync", **_FAST)
    wb = PSClient([bep], mode="sync", **_FAST)
    try:
        ids = np.arange(40, dtype=np.int64)
        # concurrent, OVERLAPPING writes (ids 10..29 written both sides)
        wa.push_delta("emb", ids[:30], np.full((30, 6), 2.0, np.float32))
        wb.push_delta("emb", ids[10:], np.full((30, 6), 5.0, np.float32))
        _settle(gA, gB)
        ra = A._tables["emb"].pull(ids)
        rb = B._tables["emb"].pull(ids)
        want = np.zeros((40, 6), np.float32)
        want[:30] += 2.0
        want[10:] += 5.0
        # the fixed point: both sides, every write exactly once
        assert np.array_equal(ra, rb)
        assert np.array_equal(ra, want)
    finally:
        _teardown(gA, gB, wa, wb, A, B)


def test_additive_echo_suppression_quiesces():
    """After convergence NOTHING keeps flowing: a replicated delta
    must not re-dirty the receiving side (the infinite-bounce trap)."""
    A, B, aep, bep, gA, gB = _bridge("add")
    wa = PSClient([aep], mode="sync", **_FAST)
    try:
        ids = np.arange(8, dtype=np.int64)
        wa.push_delta("emb", ids, np.ones((8, 6), np.float32))
        _settle(gA, gB)
        pushed_a, pushed_b = gA.pushed_ids, gB.pushed_ids
        # extra rounds move NOTHING
        for _ in range(4):
            assert gA.flush() == 0
            assert gB.flush() == 0
        assert (gA.pushed_ids, gB.pushed_ids) == (pushed_a, pushed_b)
        assert not any(gA._inbound.values())
        assert not any(gB._inbound.values())
    finally:
        _teardown(gA, gB, wa, A, B)


def test_additive_bidirectional_inexact_payload_bit_equality():
    """Each site applies {local writes, peer deltas} in its own commit
    order, so inexact (non-representable-sum) payloads land within
    ±1 ulp of each other.  The authority-side cross-site residual pass
    (Sterbenz, the mechanism ``_ship`` uses against its mirror) must
    close the gap: after settling, both sites hold identical bits."""
    A, B, aep, bep, gA, gB = _bridge("add")
    wa = PSClient([aep], mode="sync", **_FAST)
    wb = PSClient([bep], mode="sync", **_FAST)
    try:
        rng = np.random.default_rng(17)
        ids = np.arange(32, dtype=np.int64)
        # irrational-ish f32 payloads whose pairwise sums round, written
        # concurrently and OVERLAPPING (ids 8..23 from both sides), with
        # ship rounds interleaved between write bursts so each site
        # accumulates the same set of deltas in a different order
        for _ in range(3):
            da = (rng.standard_normal((24, 6)) * 0.1).astype(np.float32)
            db = (rng.standard_normal((24, 6)) * 0.1).astype(np.float32)
            wa.push_delta("emb", ids[:24], da)
            wb.push_delta("emb", ids[8:], db)
            gA.flush()
            gB.flush()
        _settle(gA, gB, rounds=12)
        ra = A._tables["emb"].pull(ids)
        rb = B._tables["emb"].pull(ids)
        assert np.allclose(ra, rb, rtol=1e-5)     # value sanity
        # THE bar: identical bits on both sites, not just allclose
        assert np.array_equal(ra, rb), \
            (ra.view(np.int32) - rb.view(np.int32))
    finally:
        _teardown(gA, gB, wa, wb, A, B)


def test_additive_residual_verify_repairs_silent_ulp_drift():
    """The race the verify pass exists for: a commit landing inside
    the peer's ship-loop window leaves the receiver's row ±1 ulp off
    the shipper's MIRROR — both mirrors still match their own tables,
    backlog hits 0, and the drift is permanent because nothing
    re-reads the actual cross-site bits.  Simulate it by nudging a
    follower row behind the commit feed's back (a direct table write
    raises no commit record, exactly like the race), then prove the
    authority's verify pass detects and repairs it to bit equality."""
    A, B, aep, bep, gA, gB = _bridge("add")
    wa = PSClient([aep], mode="sync", **_FAST)
    wb = PSClient([bep], mode="sync", **_FAST)
    try:
        rng = np.random.default_rng(3)
        ids = np.arange(10, dtype=np.int64)
        wa.push_delta("emb", ids,
                      (rng.standard_normal((10, 6)) * 7.3)
                      .astype(np.float32))
        wb.push_delta("emb", ids[3:],
                      (rng.standard_normal((7, 6)) * 0.13)
                      .astype(np.float32))
        _settle(gA, gB)
        # the silent ulp nudge on the NON-authority site ("A" < "B"):
        # invisible to A's dirty set and to B's mirror
        row = A._tables["emb"].pull(ids[:1])
        drift = np.nextafter(row, np.full_like(row, np.inf)) - row
        A._tables["emb"].push_delta(ids[:1], drift)
        assert not np.array_equal(A._tables["emb"].pull(ids),
                                  B._tables["emb"].pull(ids))
        # a later write re-enters the id into the cross-site pending
        # set (any real race is created BY a ship round, so the id is
        # always re-touched); the authority verify then repairs it
        wb.push_delta("emb", ids[:4], np.ones((4, 6), np.float32))
        _settle(gA, gB)
        ra = A._tables["emb"].pull(ids)
        rb = B._tables["emb"].pull(ids)
        assert np.array_equal(ra, rb)
        assert gB.corrected_ids >= 1          # the repair really ran
        assert gB.verified_ids >= 1
        # and it quiesces: further rounds move nothing
        for _ in range(3):
            assert gA.flush() == 0 and gB.flush() == 0
    finally:
        _teardown(gA, gB, wa, wb, A, B)


def test_additive_bidirectional_lossy_link_zero_lost_zero_double():
    """THE additive chaos bar: both directions ride a seeded
    lossy/delayed link (delays, dropped acks, cut connections); the
    idempotent (src, seq) retries mean no delta is lost or applied
    twice — the exact-arithmetic fixed point is still hit on the bit."""
    A, B, aep, bep, gA, gB = _bridge("add")
    wa = PSClient([aep], mode="sync", **_FAST)
    wb = PSClient([bep], mode="sync", **_FAST)
    chaos.install(chaos.plan_from_spec(
        "seed=11;delay:push_delta:first=1:every=2:times=0:arg=0.002;"
        "drop:push_delta_reply:first=2:every=3:times=0;"
        "cut:push_delta:first=7:every=9:times=0"))
    try:
        ids = np.arange(50, dtype=np.int64)
        wa.push_delta("emb", ids[:35], np.full((35, 6), 3.0, np.float32))
        wb.push_delta("emb", ids[15:], np.full((35, 6), 4.0, np.float32))
        _settle(gA, gB, rounds=12)
        st = chaos.active().stats_dict()
        assert any(k.startswith(("drop", "delay", "cut"))
                   for k in st), st   # the link really was hostile
        chaos.uninstall()
        ra = A._tables["emb"].pull(ids)
        rb = B._tables["emb"].pull(ids)
        want = np.zeros((50, 6), np.float32)
        want[:35] += 3.0
        want[15:] += 4.0
        assert np.array_equal(ra, rb)
        assert np.array_equal(ra, want)   # 0 lost / 0 double-applied
        assert A.dup_acks + B.dup_acks >= 1   # a retry WAS deduped
    finally:
        _teardown(gA, gB, wa, wb, A, B)


# ---------------------------------------------------------------------------
# last-writer-wins
# ---------------------------------------------------------------------------

def test_lww_higher_lamport_wins_everywhere():
    A, B, aep, bep, gA, gB = _bridge("lww")
    wa = PSClient([aep], mode="sync", **_FAST)
    wb = PSClient([bep], mode="sync", **_FAST)
    try:
        one = np.array([1], np.int64)
        # A writes once (lamport 1); B writes twice (lamport 2):
        # B's stamp (2, "B") is the global max — its ROW must win on
        # both sides, bit-exactly
        wa.push_delta("emb", one, np.full((1, 6), 10.0, np.float32))
        wb.push_delta("emb", one, np.full((1, 6), 1.0, np.float32))
        wb.push_delta("emb", one, np.full((1, 6), 1.0, np.float32))
        _settle(gA, gB)
        ra = A._tables["emb"].pull(one)
        rb = B._tables["emb"].pull(one)
        assert np.array_equal(ra, rb)
        assert np.all(ra == 2.0), ra          # B's row, not A's 10.0
        assert A._geo_stamps["emb"][1] == (2, "B")
        assert B._geo_stamps["emb"][1] == (2, "B")
    finally:
        _teardown(gA, gB, wa, wb, A, B)


def test_lww_equal_lamport_site_tiebreak_is_deterministic():
    A, B, aep, bep, gA, gB = _bridge("lww")
    wa = PSClient([aep], mode="sync", **_FAST)
    wb = PSClient([bep], mode="sync", **_FAST)
    try:
        one = np.array([2], np.int64)
        # one write each: both stamps are (1, site) — site "B" > "A"
        # lexicographically, so B's row wins deterministically
        wa.push_delta("emb", one, np.full((1, 6), 7.0, np.float32))
        wb.push_delta("emb", one, np.full((1, 6), 9.0, np.float32))
        _settle(gA, gB)
        ra = A._tables["emb"].pull(one)
        rb = B._tables["emb"].pull(one)
        assert np.array_equal(ra, rb) and np.all(ra == 9.0)
        assert A._geo_stamps["emb"][2] == B._geo_stamps["emb"][2] \
            == (1, "B")
    finally:
        _teardown(gA, gB, wa, wb, A, B)


def test_lww_loser_update_is_skipped_not_merged():
    """A stale geo_set arriving AFTER a newer local write must be
    dropped whole — LWW never mixes rows."""
    A, aep = _site("lww", "A")
    w = PSClient([aep], mode="sync", **_FAST)
    try:
        one = np.array([3], np.int64)
        w.push_delta("emb", one, np.full((1, 6), 5.0, np.float32))
        st = A._geo_stamps["emb"][3]
        assert st[0] >= 1
        # a peer's OLDER stamp loses; its value must not land
        w.geo_set("emb", one, np.full((1, 6), 123.0, np.float32),
                  np.array([0], np.int64), ["B"])
        assert np.all(A._tables["emb"].pull(one) == 5.0)
        assert A._geo_stamps["emb"][3] == st
        # a NEWER stamp replaces wholesale
        w.geo_set("emb", one, np.full((1, 6), 42.0, np.float32),
                  np.array([st[0] + 1], np.int64), ["B"])
        assert np.all(A._tables["emb"].pull(one) == 42.0)
        assert A._geo_stamps["emb"][3] == (st[0] + 1, "B")
    finally:
        _teardown(w, A)


def test_lww_stamp_directory_survives_standby_promotion():
    """The conflict decisions must outlive the primary: a hot standby
    inherits the stamp directory (snapshot header) and keeps skipping
    stale geo_sets after promotion."""
    prim, pep = _site("lww", "P")
    w = PSClient([pep], **_FAST)
    one = np.array([4], np.int64)
    w.push_delta("emb", one, np.full((1, 6), 8.0, np.float32))
    w.push_delta("emb", one, np.full((1, 6), 8.0, np.float32))
    stamp = prim._geo_stamps["emb"][4]
    stby = PSServer({"emb": SparseTable(geo_policy="lww", **_XSPEC)},
                    host="127.0.0.1", replica_of=pep)
    stby.start()
    try:
        assert stby.replica_ready.wait(10.0)
        prim.stop()
        deadline = time.monotonic() + 10.0
        while time.monotonic() < deadline and not stby.promoted:
            time.sleep(0.05)
        assert stby.promoted
        assert stby._geo_stamps["emb"][4] == stamp
        # a stale geo_set against the promoted standby is still skipped
        w2 = PSClient([f"127.0.0.1:{stby.port}"], **_FAST)
        w2.geo_set("emb", one, np.full((1, 6), 99.0, np.float32),
                   np.array([stamp[0] - 1], np.int64), ["B"])
        assert np.all(stby._tables["emb"].pull(one) == 16.0)
        w2.close()
    finally:
        _teardown(w, stby, prim)


def test_lww_stream_replication_keeps_replica_stamps_in_step():
    """Forwarded records carry their stamp (``gst``): a read replica's
    stamp directory tracks the primary's without ever minting its own
    (site divergence would corrupt later conflict decisions)."""
    prim, pep = _site("lww", "P")
    rep = PSServer({"emb": SparseTable(geo_policy="lww", **_XSPEC)},
                   host="127.0.0.1", replica_of=pep,
                   replica_mode="read", wm_interval_s=0.05)
    rep.start()
    w = PSClient([pep], **_FAST)
    try:
        assert rep.replica_ready.wait(10.0)
        ids = np.arange(5, dtype=np.int64)
        w.push_delta("emb", ids, np.ones((5, 6), np.float32))
        w.push_delta("emb", ids[:2], np.ones((2, 6), np.float32))
        deadline = time.monotonic() + 10.0
        while time.monotonic() < deadline \
                and rep._stats()["watermark"] < 2:
            time.sleep(0.05)
        assert rep._geo_stamps["emb"] == prim._geo_stamps["emb"]
        # every stamp carries the PRIMARY's site
        assert all(s[1] == "P"
                   for s in rep._geo_stamps["emb"].values())
    finally:
        _teardown(w, rep, prim)


# ---------------------------------------------------------------------------
# across the packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pkgs", [("port", "jax"), ("jax", "port")])
def test_geo_pusher_replicates_into_the_other_package(pkgs):
    """A pusher of one package converges the other package's server
    bitwise (same frames, same residual passes)."""
    local, lep = _cluster(pkgs[0])
    remote, rep = _cluster(pkgs[1])
    gp = _PKG[pkgs[0]].GeoPusher(local, [rep], interval_s=3600.0, **_FAST)
    try:
        _train(lep, steps=12)
        gp.drain(timeout=15.0)
        _assert_converged(local, remote)
        assert gp.pushed_ids > 0
    finally:
        gp.stop(drain=False)
        local.stop()
        remote.stop()


def _schedule(pkg, policy, batches=6):
    """Two sites of one package; each batch writes inexact f32 deltas on
    both sites (overlapping ids) and drains both pushers.  Returns both
    sites' rows over the id universe, their stamps, and the pushers'
    counters."""
    P = _PKG[pkg]
    A, aep = _site(policy, "A", pkg)
    B, bep = _site(policy, "B", pkg)
    gA = P.GeoPusher(A, [bep], interval_s=3600.0, **_FAST)
    gB = P.GeoPusher(B, [aep], interval_s=3600.0, **_FAST)
    wa = P.PSClient([aep], mode="sync", **_FAST)
    wb = P.PSClient([bep], mode="sync", **_FAST)
    try:
        rng = np.random.default_rng(29)
        for _ in range(batches):
            ia = np.sort(rng.choice(48, 20, replace=False)).astype(np.int64)
            ib = np.sort(rng.choice(48, 20, replace=False)).astype(np.int64)
            wa.push_delta("emb", ia, (rng.standard_normal((20, 6)) * 0.37)
                          .astype(np.float32))
            wb.push_delta("emb", ib, (rng.standard_normal((20, 6)) * 0.11)
                          .astype(np.float32))
            for _ in range(3):
                gA.drain(timeout=15.0)
                gB.drain(timeout=15.0)
        every = np.arange(48, dtype=np.int64)
        return (A._tables["emb"].pull(every), B._tables["emb"].pull(every),
                A._geo_stamps.get("emb"), B._geo_stamps.get("emb"))
    finally:
        _teardown(gA, gB, wa, wb, A, B)


@pytest.mark.parametrize("policy", ["add", "lww"])
def test_two_site_schedule_bitwise_across_packages(policy):
    ra, rb, sa, sb = _schedule("port", policy)
    ja, jb, jsa, jsb = _schedule("jax", policy)
    assert np.array_equal(ra, rb), "the port's sites did not converge"
    assert np.array_equal(ja, jb)
    assert np.array_equal(ra, ja), "the packages' fixed points differ"
    assert sa == sb == jsa == jsb


@pytest.mark.parametrize("pkgs", [("port", "jax"), ("jax", "port")])
def test_stamps_and_admission_replicate_across_packages(pkgs):
    """The replica attach carries the LWW stamp directory (site names in
    the snapshot header) and the tables' admission state (in the npz
    snapshot) from a primary of one package to a standby of the other;
    the stream keeps both in step, and the standby holds the primary's
    state bitwise."""
    P, R = _PKG[pkgs[0]], _PKG[pkgs[1]]
    entry = {"port": "paddle_tpu_torch.distributed.entry",
             "jax": "paddle_tpu.distributed.entry"}

    def table(pkg):
        import importlib
        e = importlib.import_module(entry[pkg]).CountFilterEntry(2)
        return _PKG[pkg].SparseTable(entry=e, geo_policy="lww", **_XSPEC)
    prim = P.PSServer({"emb": table(pkgs[0])}, host="127.0.0.1",
                      geo_site="P")
    prim.start()
    pep = f"127.0.0.1:{prim.port}"
    w = P.PSClient([pep], **_FAST)
    stby = None
    try:
        ids = np.arange(6, dtype=np.int64)
        for _ in range(2):                   # sighted twice: admitted
            w.pull("emb", ids[:4])
        w.pull("emb", ids[4:])               # sighted once: counted
        w.push_delta("emb", ids[:4], np.ones((4, 6), np.float32))
        stby = R.PSServer({"emb": table(pkgs[1])}, host="127.0.0.1",
                          replica_of=pep)
        stby.start()
        assert stby.replica_ready.wait(10.0)
        w.push_delta("emb", ids[:2], np.ones((2, 6), np.float32))
        deadline = time.monotonic() + 10.0
        while time.monotonic() < deadline and \
                stby._stats()["watermark"] < prim.applied:
            time.sleep(0.02)
        assert stby._stats()["watermark"] == prim.applied == 2
        assert stby._geo_stamps == prim._geo_stamps
        assert set(prim._geo_stamps["emb"].values()) == {(1, "P"), (2, "P")}
        a = prim._tables["emb"]._entry_state()
        b = stby._tables["emb"]._entry_state()
        for k in ("admitted", "seen_ids", "seen_counts"):
            assert sorted(a[k].tolist()) == sorted(b[k].tolist()), k
        assert np.array_equal(stby._tables["emb"].pull(ids[:4]),
                              prim._tables["emb"].pull(ids[:4]))
    finally:
        _teardown(*(o for o in (w, stby, prim) if o is not None))
