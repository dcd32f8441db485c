"""The port's inference gateway (``paddle_tpu_torch/inference/gateway.py``)
on the CPU: the cases of the reference's ``tests/test_gateway.py``, and
parity with the JAX package.

The invariant everywhere: a client stream never errors on a replica's
loss; it stalls for the failover and resumes token-identical (greedy and
seeded sampling), no token lost or duplicated.  Every comparison is with
a fault-free run on one ample server with the same seeded weights, so
equality is the audit.

The three replica servers are module-scoped and shared; each test builds
its own router and replica layer over them, and a "kill" is a partition
(``owns_server=False``): the router sees a dead replica, the warm server
runs on.  Tests that need thrash-sized pools share the module's scarce
pair; the drain test poisons it and comes last among its users.  The
SIGKILL + drain test runs real subprocess replicas
(``python -m paddle_tpu_torch.tools.chaos_gateway --serve``) and comes
last.  Every wait is bounded.

Against JAX, on a tiny Llama carried across with ``load_jax_state_dict``:
``route_owner`` is the reference router's for the same replica names and
prompts; greedy streams through both packages' gateways are equal;
``chaos.named_plan("gw_kill@N")`` / ``"gw_flaky"`` are the reference's
faults; a ``RequestTrace`` lane has the reference's span names and its
``ttft_ms`` is the ``serve_ttft_ms`` the server observed; tenant counters
sum to the totals.
"""
import json
import os
import pathlib
import time

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.distributed.fleet import chaos as jchaos
from paddle_tpu.inference import GatewayRouter as JaxRouter
from paddle_tpu.inference import GenerationServer as JaxServer
from paddle_tpu.inference import LocalReplica as JaxLocal
from paddle_tpu.observability import trace as jtrace
from paddle_tpu.text.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.text.models import llama_tiny as jax_tiny

from paddle_tpu_torch.distributed.fleet import chaos
from paddle_tpu_torch.framework import monitor
from paddle_tpu_torch.framework.io import load_jax_state_dict
from paddle_tpu_torch.inference import gateway
from paddle_tpu_torch.inference import (GatewayRouter, GenerationRpcServer,
                                        GenerationServer, LocalReplica,
                                        RemoteReplica, RequestTimeout,
                                        ServerClosed, ServerDraining,
                                        ServerOverloaded)
from paddle_tpu_torch.observability import trace
from paddle_tpu_torch.text.models import LlamaForCausalLM, llama_tiny
from paddle_tpu_torch.tools import chaos_gateway as tool

_AMPLE = dict(tool.TINY_SERVER)
WAIT = 60.0


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Up to five servers step at once here, each over a tiny model:
    one intra-op thread each keeps them from oversubscribing the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mk_server(**kw):
    """A server over the chaos tool's tiny model (the weights every
    process builds from the same seed)."""
    return GenerationServer(tool.build_model("tiny", "cpu", 0),
                            **dict(_AMPLE, **kw))


@pytest.fixture(scope="module")
def servers():
    srvs = [_mk_server().start() for _ in range(3)]
    yield srvs
    for s in srvs:
        s.stop()


def _prompts(seed=0, lens=(5, 9, 3, 12), prefix=()):
    rng = np.random.RandomState(seed)
    out = []
    for n in lens:
        p = rng.randint(1, 64, (n,)).astype("int32")
        if prefix:
            p = np.concatenate([np.asarray(prefix, np.int32), p]).astype(
                "int32")
        out.append(p)
    return out


def _kws(n, max_new=16):
    """Even streams greedy, odd streams seeded sampling: failover must
    be token-identical for both."""
    return [dict(max_new_tokens=max_new, seed=1000 + i,
                 **({"do_sample": True, "temperature": 0.9, "top_k": 8}
                    if i % 2 else {}))
            for i in range(n)]


@pytest.fixture(scope="module")
def ref():
    """The fault-free oracle: runs on one ample server."""
    srv = _mk_server().start()

    def run(prompts, kws):
        return [srv.submit(p, **kw).result(timeout=WAIT)
                for p, kw in zip(prompts, kws)]
    yield run
    srv.stop()


def _wait_idle(servers, timeout=30):
    """Let orphaned sequences on partitioned servers run out, so the
    next test starts from an idle fleet."""
    deadline = time.monotonic() + timeout
    for s in servers:
        while True:
            st = s.stats()
            if st["active"] == 0 and st["waiting"] == 0:
                break
            assert time.monotonic() < deadline, \
                "shared server never went idle after the test"
            time.sleep(0.002)


@pytest.fixture(scope="module")
def scarce_pair():
    """Two replicas with thrash-sized pools, shared by the eviction, RPC
    and drain tests (the drain test poisons them and comes last)."""
    srvs = [_mk_server(num_blocks=14, num_slots=4, max_model_len=24)
            .start() for _ in range(2)]
    yield srvs
    for s in srvs:
        s.stop()


class _Trio:
    """Router and replica layer over the shared servers; ``kill()`` on
    these replicas is a partition, and ``close()`` waits for the fleet to
    go idle."""

    def __init__(self, servers, **router_kw):
        self.servers = servers
        self.reps = [LocalReplica(f"r{i}", s, owns_server=False)
                     for i, s in enumerate(servers)]
        rkw = dict(block_size=_AMPLE["block_size"], seed=0,
                   request_timeout_s=WAIT)
        rkw.update(router_kw)
        self.router = GatewayRouter(self.reps, **rkw).start()

    def replica(self, name):
        return self.router._replicas[name]

    def close(self):
        self.router.stop()
        _wait_idle(self.servers)


@pytest.fixture
def trio(servers):
    t = _Trio(servers)
    yield t
    t.close()


# -- routing ------------------------------------------------------------

def test_prefix_affinity_routing(trio):
    prompts = _prompts(seed=3, lens=(8,) * 16 + (11,) * 16)
    owners = [trio.router.route_owner(p) for p in prompts]
    assert owners == [trio.router.route_owner(p) for p in prompts]
    assert len(set(owners)) >= 2
    # the route key is the first block's chain hash: a conversation
    # growing by whole turns keeps its replica
    for p, owner in zip(prompts, owners):
        grown = np.concatenate([p, np.arange(1, 6, dtype=np.int32)])
        assert trio.router.route_owner(grown) == owner


def test_router_lifecycle_typed_errors(servers):
    t = _Trio(servers)
    try:
        with pytest.raises(ValueError):
            t.router.submit(np.zeros((0,), np.int32))
    finally:
        t.close()
    with pytest.raises(ServerClosed):
        t.router.submit(np.array([1, 2, 3], np.int32))
    with pytest.raises(ValueError, match="unique"):
        GatewayRouter([LocalReplica("a", servers[0], owns_server=False),
                       LocalReplica("a", servers[1], owns_server=False)])


def test_fanout_token_equality(trio, ref):
    prompts = _prompts(seed=0, lens=(5, 9, 3, 12, 7, 6))
    kws = _kws(6)
    expect = ref(prompts, kws)
    streams = [trio.router.submit(p, **kw) for p, kw in zip(prompts, kws)]
    assert [s.result(timeout=WAIT) for s in streams] == expect
    st = trio.router.stats()
    assert st["finished"] == 6 and st["failovers"] == 0
    assert sum(st["routed"].values()) == 6


# -- failover -----------------------------------------------------------

def test_failover_mid_stream_token_identical(trio, ref):
    prompts = _prompts(seed=1, lens=(5, 9, 3, 12))
    kws = _kws(4, max_new=18)
    expect = ref(prompts, kws)
    victim = trio.router.route_owner(prompts[0])
    f0 = monitor.stat_get("gw_failovers")
    streams = [trio.router.submit(p, **kw) for p, kw in zip(prompts, kws)]
    time.sleep(0.01)
    trio.replica(victim).kill()
    outs = [s.result(timeout=WAIT) for s in streams]
    assert outs == expect, "failover lost, duplicated or changed tokens"
    st = trio.router.stats()
    assert st["failovers"] >= 1
    assert monitor.stat_get("gw_failovers") - f0 == st["failovers"]
    assert victim in st["down"] or st["routed"].get(victim, 0) >= 1


def test_failover_mid_eviction_replay(scarce_pair, ref):
    """A replica dies while its pool thrashes: the prompts share their
    first block, so all route to one oversubscribed replica, which is
    evicting when it dies; failover re-prefills conversations that were
    themselves mid-replay.  The kill waits (bounded) for the first
    eviction."""
    reps = [LocalReplica(f"r{i}", s, owns_server=False)
            for i, s in enumerate(scarce_pair)]
    router = GatewayRouter(reps, block_size=4, seed=0,
                           request_timeout_s=WAIT).start()
    try:
        common = (7, 11, 13, 3)     # one full block: one ring slot
        prompts = _prompts(seed=2, lens=(2, 6, 1, 4), prefix=common)
        kws = _kws(4, max_new=12)
        expect = ref(prompts, kws)
        victim = router.route_owner(prompts[0])
        assert all(router.route_owner(p) == victim for p in prompts)
        vsrv = router._replicas[victim].server
        evicted0 = vsrv.stats()["evicted"]
        streams = [router.submit(p, **kw) for p, kw in zip(prompts, kws)]
        deadline = time.monotonic() + 30
        while vsrv.stats()["evicted"] == evicted0:
            assert time.monotonic() < deadline, \
                "the pool was never exhausted: eviction untested"
            time.sleep(0.0002)
        router._replicas[victim].kill()
        assert [s.result(timeout=WAIT) for s in streams] == expect
        assert router.stats()["failovers"] >= 1
    finally:
        router.stop()
        _wait_idle(scarce_pair)


def test_failover_shared_prefix_warm_survivor(trio, ref):
    """When the failover target already holds the prompt's blocks (an
    earlier conversation), re-prefill aliases them: a prefix-cache hit
    on the survivor."""
    router = trio.router
    prompt = None
    for seed in range(200):
        (cand,) = _prompts(seed=100 + seed, lens=(8,))
        with router._lock:
            order = router._candidates(router._route_pos(cand))
        if len(order) >= 2:
            prompt, owner, backup = cand, order[0], order[1]
            break
    assert prompt is not None
    kw = dict(max_new_tokens=24, seed=4242, do_sample=True,
              temperature=0.9, top_k=8)
    (expect,) = ref([prompt], [kw])
    warm = trio.replica(backup).server.submit(np.asarray(prompt), **kw) \
        .result(timeout=WAIT)
    assert warm == expect
    hits0 = trio.replica(backup).server.stats()["prefix_hits"]
    stream = router.submit(prompt, **kw)
    time.sleep(0.008)
    trio.replica(owner).kill()
    assert stream.result(timeout=WAIT) == expect
    assert trio.replica(backup).server.stats()["prefix_hits"] > hits0, \
        "failover re-prefill missed the survivor's warm blocks"


def test_double_failure_token_identical(trio, ref):
    """The second replica dies during the re-prefill recovery: the ring
    rotates again and the stream still finishes token-identical."""
    router = trio.router
    prompts = _prompts(seed=4, lens=(6,))
    kw = dict(max_new_tokens=25, seed=77, do_sample=True,
              temperature=0.9, top_k=8)
    (expect,) = ref(prompts, [kw])
    first = router.route_owner(prompts[0])
    stream = router.submit(prompts[0], **kw)
    time.sleep(0.006)
    trio.replica(first).kill()
    second = None
    deadline = time.monotonic() + 30
    while second in (None, first):
        assert time.monotonic() < deadline, "failover never re-placed"
        with router._lock:
            req = router._reqs.get(stream.request_id)
            second = req.replica if req is not None else None
        if req is None:     # already finished on its second home
            break
        time.sleep(0.0002)
    if second is not None and second != first:
        trio.replica(second).kill()
    assert stream.result(timeout=WAIT) == expect
    assert router.stats()["failovers"] >= 1


# -- deadline-aware admission ------------------------------------------

def test_tenant_budget_shed_typed(servers):
    t = _Trio(servers, tenant_budgets={"acme": 40})
    try:
        s0 = monitor.stat_get("gw_sheds", labels={"reason": "tenant_budget"})
        p = np.array([1, 2, 3, 4, 5], np.int32)
        s1 = t.router.submit(p, max_new_tokens=25, tenant="acme")
        with pytest.raises(ServerOverloaded):
            t.router.submit(p, max_new_tokens=25, tenant="acme")
        s1.result(timeout=WAIT)
        # the budget is in flight, not cumulative: capacity returns
        t.router.submit(p, max_new_tokens=25, tenant="acme").result(
            timeout=WAIT)
        assert t.router.stats()["sheds"]["tenant_budget"] == 1
        assert monitor.stat_get(
            "gw_sheds", labels={"reason": "tenant_budget"}) - s0 == 1
    finally:
        t.close()


def test_pressure_shed_is_deadline_ordered(servers, ref):
    """At ``max_pending`` the request with the most remaining deadline is
    shed: a tight-deadline late arrival takes a slack early one's slot."""
    t = _Trio(servers, max_pending=1)
    try:
        prompts = _prompts(seed=6, lens=(5, 7))
        kws = _kws(2, max_new=25)
        expect = ref(prompts, kws)
        slack = t.router.submit(prompts[0], timeout_s=300.0, **kws[0])
        tight = t.router.submit(prompts[1], timeout_s=30.0, **kws[1])
        assert tight.result(timeout=WAIT) == expect[1]
        with pytest.raises(ServerOverloaded):
            slack.result(timeout=WAIT)
        assert t.router.stats()["sheds"]["pressure"] == 1
    finally:
        t.close()


def test_failover_keeps_original_deadline(trio):
    """A failed-over request's deadline stays anchored at its submit."""
    router = trio.router
    (p,) = _prompts(seed=7, lens=(5,))
    t0 = time.monotonic()
    stream = router.submit(p, max_new_tokens=25, timeout_s=9.0)
    with router._lock:
        req = router._reqs.get(stream.request_id)
        deadline0 = req.deadline
    time.sleep(0.004)
    with router._lock:
        live = router._reqs.get(stream.request_id)
        victim = live.replica if live is not None else None
    if victim is not None:
        trio.replica(victim).kill()
    stream.result(timeout=WAIT)
    assert abs(deadline0 - (t0 + 9.0)) < 0.25
    assert req.deadline == deadline0


def test_deadline_exhaustion_typed(servers):
    """No live replica at all: the stream fails typed at its deadline,
    not a hang."""
    t = _Trio(servers)
    try:
        for rep in t.reps:
            rep.kill()
        time.sleep(0.02)
        (p,) = _prompts(seed=8, lens=(4,))
        with pytest.raises((ServerOverloaded, RequestTimeout)):
            t.router.submit(p, max_new_tokens=8, timeout_s=0.6).result(
                timeout=30)
    finally:
        t.close()


# -- RPC replicas and the drain (scarce-pair users; the drain poisons the
# -- pair, so it comes last among them) --------------------------------

def test_rpc_replica_roundtrip(scarce_pair, ref):
    rpc = GenerationRpcServer(scarce_pair[0])
    rep = RemoteReplica("w0", "127.0.0.1", rpc.port, rpc_timeout=WAIT)
    try:
        assert rep.ping() == {"ok": True, "draining": False}
        (p,) = _prompts(seed=9, lens=(6,))
        kw = dict(max_new_tokens=12, seed=5)
        (expect,) = ref([p], [kw])
        rep.submit(1, p, kw)
        got = []
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            (res,) = rep.poll([(1, len(got))])
            got.extend(res["toks"])
            if res["done"]:
                break
            time.sleep(0.002)
        assert got == expect
        (res,) = rep.poll([(99, 0)])
        assert res["err"] == "unknown" and res["done"]
    finally:
        rpc.stop()
        _wait_idle(scarce_pair[:1])


def test_drain_migrates_then_drain_all_typed(scarce_pair, ref):
    """``drain(victim)`` mid-traffic moves its live conversations (KV or
    replay) token-identically and closes its admission typed, directly
    and across the wire; draining every replica makes the router itself
    refuse typed."""
    reps = [LocalReplica(f"r{i}", s, owns_server=False)
            for i, s in enumerate(scarce_pair)]
    router = GatewayRouter(reps, block_size=4, seed=0,
                           request_timeout_s=WAIT).start()
    try:
        prompts = _prompts(seed=5, lens=(5, 9, 3, 12))
        kws = _kws(4, max_new=10)
        expect = ref(prompts, kws)
        victim = router.route_owner(prompts[0])
        m0 = monitor.stat_get("gw_migrated_seqs")
        streams = [router.submit(p, **kw) for p, kw in zip(prompts, kws)]
        time.sleep(0.006)
        moved = router.drain(victim)
        assert [s.result(timeout=WAIT) for s in streams] == expect
        st = router.stats()
        assert victim in st["draining"] and victim not in st["ring"]
        assert st["migrated"] == moved
        assert monitor.stat_get("gw_migrated_seqs") - m0 == moved
        vsrv = router._replicas[victim].server
        with pytest.raises(ServerDraining):
            vsrv.submit(np.asarray(prompts[0]), max_new_tokens=4)
        wrpc = GenerationRpcServer(vsrv)
        wrep = RemoteReplica("w", "127.0.0.1", wrpc.port, rpc_timeout=WAIT)
        try:
            assert wrep.ping()["draining"] is True
            with pytest.raises(ServerDraining):
                wrep.submit(9, prompts[0], dict(max_new_tokens=4))
        finally:
            wrpc.stop()
        s2 = router.submit(prompts[0], **kws[0])
        assert s2.result(timeout=WAIT) == expect[0]
        assert router.stats()["routed"].get(victim, 0) \
            == st["routed"].get(victim, 0)
        for name in list(router._replicas):
            if name not in router.stats()["draining"]:
                router.drain(name)
        with pytest.raises(ServerDraining):
            router.submit(np.array([1, 2, 3], np.int32), max_new_tokens=4)
    finally:
        router.stop()


def test_gateway_under_flaky_link_chaos(servers, ref):
    """``gw_flaky``: seeded delays and repeated cuts on the poll link.
    A cut socket surfaces as ReplicaLost and the router fails over (the
    replica is healthy); every stream is still token-identical."""
    rpcs = [GenerationRpcServer(s) for s in servers[:2]]
    reps = [RemoteReplica(f"w{i}", "127.0.0.1", r.port, rpc_timeout=WAIT)
            for i, r in enumerate(rpcs)]
    reps.append(LocalReplica("w2", servers[2], owns_server=False))
    prompts = _prompts(seed=10, lens=(5, 9, 3, 12))
    kws = _kws(4, max_new=16)
    expect = ref(prompts, kws)
    plan = chaos.install(chaos.named_plan("gw_flaky", seed=3))
    router = None
    try:
        router = GatewayRouter(reps, block_size=4, seed=0,
                               request_timeout_s=WAIT).start()
        streams = [router.submit(p, **kw) for p, kw in zip(prompts, kws)]
        assert [s.result(timeout=WAIT) for s in streams] == expect
        assert sum(plan.stats_dict().values()) >= 1
    finally:
        chaos.uninstall()
        if router is not None:
            router.stop()
        for r in rpcs:
            r.stop()
        _wait_idle(servers)


def test_delivery_is_once_whoever_polls(servers):
    """The pump and a drain can poll one request with the same cursor
    (a drain that began while the pump's poll was in flight): each
    token reaches the client once, in order, whichever delivers first."""
    t = _Trio(servers)
    try:
        req = gateway._GwReq(1, np.array([1, 2], np.int32),
                             dict(max_new_tokens=8), 0, time.monotonic() + 9,
                             None, 10)
        t.router._deliver(req, 0, [5])
        t.router._deliver(req, 1, [6, 7])      # the pump, cursor 1
        t.router._deliver(req, 1, [6, 7, 8])   # the drain, cursor 1
        t.router._deliver(req, 0, [5, 6, 7, 8, 9])   # an export's cut
        assert req.emitted == [5, 6, 7, 8, 9]
        assert req.stream.tokens == [5, 6, 7, 8, 9]
        assert req.stream.ttft_s is not None
    finally:
        t.close()


def test_gateway_stop_fails_streams_typed(servers):
    t = _Trio(servers)
    (p,) = _prompts(seed=11, lens=(5,))
    stream = t.router.submit(p, max_new_tokens=25)
    t.close()
    try:
        stream.result(timeout=10)
    except ServerClosed:
        pass    # stopped mid-flight: typed, not a hang


# -- against the JAX package ---------------------------------------------

_JCFG = dict(vocab_size=64, hidden_size=32, intermediate_size=64,
             num_hidden_layers=2, num_attention_heads=4,
             num_key_value_heads=2, max_position_embeddings=64,
             compute_dtype="float32", initializer_range=0.5)


@pytest.fixture(scope="module")
def jax_pair():
    """One JAX server and one port server over the same weights."""
    paddle.seed(0)
    jm = JaxLlama(jax_tiny(**_JCFG))
    jm.eval()
    tm = LlamaForCausalLM(llama_tiny(**_JCFG), device="cpu")
    load_jax_state_dict(tm, {k: np.asarray(v._value).astype(np.float32)
                             for k, v in jm.state_dict().items()})
    js = JaxServer(jm, **_AMPLE).start(prewarm=False)
    ts = GenerationServer(tm, **_AMPLE).start()
    yield js, ts
    js.stop()
    ts.stop()


class _Stub:
    def __init__(self, name):
        self.name = name


def test_route_owner_matches_jax():
    names = ["a", "b", "c", "replica-7"]
    ours = GatewayRouter([_Stub(n) for n in names], block_size=4, seed=3)
    theirs = JaxRouter([_Stub(n) for n in names], block_size=4, seed=3)
    prompts = _prompts(seed=12, lens=(1, 2, 3, 4, 5, 8, 9, 13, 17) * 4)
    got = [ours.route_owner(p) for p in prompts]
    assert got == [theirs.route_owner(p) for p in prompts]
    assert len(set(got)) >= 3


def test_greedy_streams_match_jax_gateway(jax_pair):
    js, ts = jax_pair
    prompts = _prompts(seed=13, lens=(5, 9, 3, 12))
    jr = JaxRouter([JaxLocal("r0", js, owns_server=False)], block_size=4,
                   seed=0).start()
    tr = GatewayRouter([LocalReplica("r0", ts, owns_server=False)],
                       block_size=4, seed=0).start()
    try:
        want = [jr.submit(p, max_new_tokens=12).result(timeout=WAIT)
                for p in prompts]
        got = [tr.submit(p, max_new_tokens=12).result(timeout=WAIT)
               for p in prompts]
    finally:
        jr.stop()
        tr.stop()
    assert got == want


@pytest.mark.parametrize("name", ["gw_kill@5", "gw_flaky"])
def test_gateway_plans_match_the_reference(name, monkeypatch):
    ours, theirs = chaos.named_plan(name, seed=2), jchaos.named_plan(
        name, seed=2)
    assert [repr(f) for f in ours.faults] == [repr(f) for f in
                                              theirs.faults]
    if name != "gw_kill@5":
        return
    # the kill fires at the 5th scheduler step, once, as SIGKILL
    kills = []
    monkeypatch.setattr(chaos.os, "kill", lambda pid, sig: kills.append(
        (pid, sig)))
    chaos.install(chaos.plan_from_spec("plan=gw_kill@5;seed=2"))
    try:
        for step in range(1, 9):
            chaos.maybe_kill_replica()
            assert len(kills) == (1 if step >= 5 else 0), step
    finally:
        chaos.uninstall()
    assert kills == [(os.getpid(), chaos.signal.SIGKILL)]


def _lanes(path):
    spans = {}
    for f in pathlib.Path(path).glob("*.jsonl"):
        for line in f.read_text().splitlines():
            r = json.loads(line)
            if r.get("t") == "span" and r["name"].startswith("req"):
                spans.setdefault(r["tid"], []).append(r)
    return spans


def test_request_trace_lane_matches_jax(jax_pair, tmp_path):
    """One request through each package's server with tracing on: the
    port's lane has the reference's span names (submit, queue, admit,
    prefill, first_token, the root), and its ``first_token`` span
    carries the ``ttft_ms`` the server observed into ``serve_ttft_ms``."""
    js, ts = jax_pair
    (p,) = _prompts(seed=14, lens=(7,))
    monitor.enable_metrics(True)
    monitor.metrics_reset()
    trace.enable(dir=str(tmp_path / "port"), every=1)
    jtrace.enable(dir=str(tmp_path / "jax"), every=1)
    try:
        ts.submit(p, max_new_tokens=6, tenant="t").result(timeout=WAIT)
        js.submit(p, max_new_tokens=6, tenant="t").result(timeout=WAIT)
    finally:
        trace.disable()
        jtrace.disable()
        hist = monitor.get_histogram("serve_ttft_ms")
        monitor.enable_metrics(False)
    (ours,) = _lanes(tmp_path / "port").values()
    (theirs,) = _lanes(tmp_path / "jax").values()
    assert sorted({r["name"] for r in ours}) == sorted(
        {r["name"] for r in theirs})
    assert {"req", "req.submit", "req.queue", "req.admit", "req.prefill",
            "req.first_token", "req.decode"} <= {r["name"] for r in ours}
    (ft,) = [r for r in ours if r["name"] == "req.first_token"]
    assert hist.count == 1 and ft["args"]["ttft_ms"] == hist.sum
    assert all(r["args"]["tenant"] == "t" for r in ours)
    (root,) = [r for r in ours if r["name"] == "req"]
    assert root["args"]["reason"] == "length"
    assert all(r["tid"] == root["tid"] for r in ours)


def test_tenant_counters_sum_to_totals(servers):
    """Tagged traffic's tenant series sum to the untagged totals: tokens
    in at admission, tokens out at the finish, prefix-hit tokens, and
    a shed counted for its tenant."""
    srv = servers[0]
    names = ("serve_tokens_in", "serve_tokens_out")
    base = {n: monitor.stat_get(n) for n in names}
    tenants = ("acme", "globex")
    tb = {(n, t): monitor.stat_get(f"serve_tenant_{n[6:]}",
                                   labels={"tenant": t})
          for n in names for t in tenants}
    hit0 = {t: monitor.stat_get("serve_tenant_prefix_hit_tokens",
                                labels={"tenant": t}) for t in tenants}
    prompts = _prompts(seed=15, lens=(9, 9, 4), prefix=(1, 2, 3, 4))
    streams = [srv.submit(p, max_new_tokens=5, tenant=tenants[i % 2])
               for i, p in enumerate(prompts)]
    for s in streams:
        s.result(timeout=WAIT)
    # the same prompt again: a prefix hit for its tenant
    srv.submit(prompts[0], max_new_tokens=5, tenant="acme").result(
        timeout=WAIT)
    for n in names:
        total = monitor.stat_get(n) - base[n]
        parts = sum(monitor.stat_get(f"serve_tenant_{n[6:]}",
                                     labels={"tenant": t}) - tb[(n, t)]
                    for t in tenants)
        assert total == parts > 0, n
    assert monitor.stat_get("serve_tokens_out") - base[
        "serve_tokens_out"] == 4 * 5
    assert monitor.stat_get("serve_tenant_prefix_hit_tokens",
                            labels={"tenant": "acme"}) > hit0["acme"]
    srv.drain_begin()
    try:
        sheds = monitor.stat_get("serve_tenant_sheds", labels={
            "tenant": "acme", "reason": "draining"})
        with pytest.raises(ServerDraining):
            srv.submit(prompts[0], max_new_tokens=2, tenant="acme")
        assert monitor.stat_get("serve_tenant_sheds", labels={
            "tenant": "acme", "reason": "draining"}) == sheds + 1
    finally:
        with srv._cond:
            srv._draining = False


# -- the SIGKILL acceptance check (last: it drains a shared server) ------

def _workload(n=8, seed=7):
    """Half the prompts chosen to hash onto the doomed replica, so the
    kill hits live streams; a pure function of the names and the seed."""
    owner = tool.owner_probe(("doomed", "b", "c"), 4, seed)
    rng = np.random.RandomState(seed)
    doomed, other = [], []
    while len(doomed) < n // 2 or len(other) < n - n // 2:
        p = rng.randint(1, 64, (int(rng.randint(3, 13)),)).astype("int32")
        bucket = doomed if owner(p) == "doomed" else other
        if len(bucket) < (n // 2 if bucket is doomed else n - n // 2):
            bucket.append(p)
    return [(p, tool._kw(i, 16)) for i, p in enumerate(doomed + other)]


def test_sigkill_and_drain_all_streams_token_identical(servers, ref):
    """8 streams over 3 replicas: a subprocess replica SIGKILLs itself
    on its 12th scheduler step (``plan=gw_kill@12`` in its
    ``PADDLE_CHAOS``), then a second replica is drained mid-traffic;
    every stream equals its fault-free run."""
    work = _workload()
    expect = ref([p for p, _ in work], [kw for _, kw in work])
    proc, port = tool._spawn_replica("tiny", "cpu", 0, 120.0,
                                     "plan=gw_kill@12;seed=7")
    reps = [RemoteReplica("doomed", "127.0.0.1", port, rpc_timeout=WAIT),
            LocalReplica("b", servers[0], owns_server=False),
            LocalReplica("c", servers[1], owns_server=False)]
    router = GatewayRouter(reps, block_size=4, seed=7,
                           request_timeout_s=120.0).start()
    try:
        streams = [router.submit(p, **kw) for p, kw in work]
        outs = [s.result(timeout=120) for s in streams]
        for i, (o, r) in enumerate(zip(outs, expect)):
            assert o == r, f"stream {i}: {o} != fault-free {r}"
        assert router.stats()["failovers"] >= 1, \
            "the kill never hit a live stream"
        assert proc.wait(timeout=30) == -9
        streams = [router.submit(p, **kw) for p, kw in work]
        time.sleep(0.01)
        router.drain("b")
        outs = [s.result(timeout=120) for s in streams]
        for i, (o, r) in enumerate(zip(outs, expect)):
            assert o == r, f"post-drain stream {i}: {o} != fault-free {r}"
        st = router.stats()
        assert "b" in st["draining"] and "b" not in st["ring"]
    finally:
        router.stop()
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
