"""The port's elastic data plane against the JAX package's.

The reference's bar is ``np.array_equal``, and the port holds it across
packages: the port's ``ElasticTrainer`` on either engine (the device
engine on ``device="cpu"`` runs the ``opt_apply`` kernel's plain version
and sums the slot gradients with torch) ends bitwise equal to the JAX
package's host numpy engine, at worlds 1 and 2, for every optimizer,
with the same optimizer step count and byte-identical checkpoints, and
either package resumes the other's pinned checkpoint.  (The JAX
package's own device engine is not a bitwise oracle: XLA on the CPU
contracts multiply-adds, ~1 ulp on ~1 % of elements.)

Then the reference's elastic contracts, ported against the port: the
ZeRO shard math, lr schedules, join mid-run, graceful leave and lease
eviction, N->M reshard, a schedule across a reshard, the staging-peak
bound, no teardown cascade, coordinator standby and ``ckpt_dir`` scan,
and the acceptance: a worker SIGKILLed every K steps under the port's
``launch --elastic`` ends bitwise equal to the fault-free run.
"""
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from paddle_tpu.distributed.fleet import dist_step as jds
from paddle_tpu.distributed.fleet import elastic as jelastic
from paddle_tpu.distributed.fleet import ps_service as jps_service
from paddle_tpu.io.dataloader import DataLoader as JDataLoader

from paddle_tpu_torch.distributed import mesh as mesh_mod
from paddle_tpu_torch.distributed.checkpoint import (CheckpointManager,
                                                     save_state_dict)
from paddle_tpu_torch.distributed.fleet import chaos, dist_step, ps_service
from paddle_tpu_torch.distributed.fleet.elastic import (
    CoordinatorLost, ElasticClient, ElasticCoordinator, ElasticTrainer,
    _scan_ckpt_dir)
from paddle_tpu_torch.distributed.fleet.elastic_engine import (
    DeviceZeroEngine)
from paddle_tpu_torch.framework import monitor as _monitor
from paddle_tpu_torch.io import DataLoader, Dataset
from paddle_tpu_torch.observability import flight_recorder
from paddle_tpu_torch.ops.kernels import registry

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DIM = 4
WAIT = 90          # seconds any elastic run or coordinator wait may take


class RegressionSet(Dataset):
    """Fixed synthetic regression data, identical in every process."""

    def __init__(self, n=64, d=DIM):
        rng = np.random.default_rng(7)
        self.x = rng.standard_normal((n, d)).astype(np.float32)
        w = np.arange(1, d + 1, dtype=np.float32)
        self.y = (self.x @ w + 0.5).astype(np.float32)

    def __len__(self):
        return len(self.x)

    def __getitem__(self, i):
        return self.x[i], self.y[i]


def grad_fn(params, batch):
    x, y = batch
    pred = x @ params["w"] + params["b"]
    err = (pred - y).astype(np.float32)
    n = np.float32(x.shape[0])
    return {"w": (x.T @ err / n).astype(np.float32),
            "b": np.asarray(err.sum() / n, np.float32).reshape(())}


def _init():
    return {"w": np.zeros(DIM, np.float32), "b": np.zeros((), np.float32)}


_DEFAULTS = dict(optimizer="adam", lr=0.05, micro_batches=4, ckpt_every=2,
                 client_timeout=60.0)


def _make_trainer(ckpt, ep, world, grad=None, jax=False, **kw):
    cfg = dict(_DEFAULTS, ckpt_dir=ckpt, coordinator=ep,
               expected_world=world)
    cfg.update(kw)
    if jax:
        loader = JDataLoader(RegressionSet(), batch_size=16, shuffle=True,
                             seed=11, drop_last=True)
        return jelastic.ElasticTrainer(_init(), grad or grad_fn, loader,
                                       **cfg)
    cfg.setdefault("device", "cpu")
    loader = DataLoader(RegressionSet(), batch_size=16, shuffle=True,
                        seed=11, drop_last=True)
    return ElasticTrainer(_init(), grad or grad_fn, loader, **cfg)


def _run_world(ckpt, world, steps, coord=None, jax=False, **kw):
    own = coord is None
    if own:
        cls = jelastic.ElasticCoordinator if jax else ElasticCoordinator
        coord = cls(expected_world=world).start()
    ep = f"127.0.0.1:{coord.port}"
    trainers = [_make_trainer(ckpt, ep, world, jax=jax, **kw)
                for _ in range(world)]
    results, errs = [None] * world, [None] * world

    def go(i):
        try:
            results[i] = trainers[i].run(steps)
        except BaseException as e:  # surfaced below
            errs[i] = e

    ts = [threading.Thread(target=go, args=(i,), daemon=True)
          for i in range(world)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=WAIT)
    assert all(not t.is_alive() for t in ts), "elastic run hung"
    for e in errs:
        if e is not None:
            raise e
    if own:
        coord.stop()
    return results, trainers, coord


def _assert_params_equal(got, want):
    for k in ("w", "b"):
        assert got[k].dtype == np.float32
        assert np.array_equal(got[k], want[k]), k


def _dir_bytes(d):
    return {f: open(os.path.join(d, f), "rb").read()
            for f in sorted(os.listdir(d))}


@pytest.fixture(autouse=True)
def _no_chaos():
    chaos.uninstall()
    yield
    chaos.uninstall()


# ---------------------------------------------------------------------------
# the ZeRO math, lr schedules and the fused apply against paddle_tpu's
# ---------------------------------------------------------------------------

def test_zero_shard_math_bitwise_reference():
    for total, world in [(10, 1), (10, 2), (10, 3), (7, 4), (3, 5),
                         (0, 2), (64, 8), (200_000, 3)]:
        assert dist_step.zero_shard_ranges(total, world) == \
            jds.zero_shard_ranges(total, world)
    rng = np.random.default_rng(3)
    tree = {"w": rng.standard_normal((5, 3)).astype(np.float32),
            "b": rng.standard_normal(7).astype(np.float32),
            "s": np.float32(rng.standard_normal()).reshape(())}
    flat, meta = dist_step.flatten_zero_state(tree)
    jflat, jmeta = jds.flatten_zero_state(tree)
    assert meta == jmeta and flat.tobytes() == jflat.tobytes()
    assert flat.size == 23
    shards3 = [dist_step.zero_shard(flat, r, 3) for r in range(3)]
    shards2 = dist_step.zero_reshard(shards3, 2)
    for a, b in zip(dist_step.zero_reshard(shards2, 3), shards3):
        assert np.array_equal(a, b)
    for r, (a, b) in enumerate(zip(shards2, jds.zero_reshard(shards3, 2))):
        assert np.array_equal(a, b)
        assert np.array_equal(a, jds.zero_shard(jflat, r, 2))
    assert np.array_equal(dist_step.zero_unshard(shards2), flat)
    back = dist_step.unflatten_zero_state(flat, meta)
    for k in tree:
        assert np.array_equal(back[k], tree[k])
        assert back[k].shape == tree[k].shape
    with pytest.raises(ValueError, match="one dtype"):
        dist_step.flatten_zero_state({"a": np.zeros(2, np.float32),
                                      "b": np.zeros(2, np.float64)})


@pytest.mark.parametrize("cfg", [
    dict(kind="cosine", base_lr=0.1, warmup_steps=4, total_steps=20,
         min_lr=0.01),
    dict(kind="step", base_lr=1.0, step_size=3, gamma=0.5),
    dict(kind="linear", base_lr=1.0, total_steps=10, min_lr=0.0),
    dict(kind="constant", base_lr=0.3, warmup_steps=2)])
def test_lr_schedule_bitwise_reference(cfg):
    ours, theirs = (dist_step.make_lr_schedule(**cfg),
                    jds.make_lr_schedule(**cfg))
    for t in range(1, 30):
        assert ours(t).dtype == np.float32
        assert ours(t).tobytes() == theirs(t).tobytes(), t
    with pytest.raises(ValueError, match="total_steps"):
        dist_step.make_lr_schedule("cosine", 0.1)
    with pytest.raises(ValueError, match="kind"):
        dist_step.make_lr_schedule("warble", 0.1)


@pytest.mark.parametrize("kind", ["sgd", "momentum", "adam"])
def test_fused_apply_bitwise_numpy_engine_and_world_invariant(kind):
    """``fused_optimizer_apply`` on the CPU (the kernel's plain version)
    over 4 steps, whole and in 3 shards, is bitwise the reference's
    numpy flat optimizer; with a schedule-driven lr too."""
    rng = np.random.default_rng(5)
    n, steps = 37, 4
    p0 = rng.standard_normal(n).astype(np.float32)
    grads = [rng.standard_normal(n).astype(np.float32)
             for _ in range(steps)]
    sched = jds.make_lr_schedule("cosine", 0.05, warmup_steps=1,
                                 total_steps=4)
    cls = {"sgd": jelastic._FlatSGD, "momentum": jelastic._FlatMomentum,
           "adam": jelastic._FlatAdam}[kind]
    ref = cls(0.05, lr_schedule=sched, fused=False)
    ref.load({k: np.zeros(n, np.float32) for k in cls.SLOTS}, t=0)
    p_ref = p0.copy()
    for g in grads:
        p_ref = ref.update(p_ref, g)
    for world in (1, 3):
        shards = []
        for lo, hi in dist_step.zero_shard_ranges(n, world):
            p, slots = p0[lo:hi].copy(), {k: np.zeros(hi - lo, np.float32)
                                          for k in cls.SLOTS}
            for t, g in enumerate(grads, 1):
                p, slots = dist_step.fused_optimizer_apply(
                    kind, p, g[lo:hi], slots, t=t, lr=sched(t),
                    momentum=0.9, device="cpu")
            shards.append((p, slots))
        assert np.array_equal(np.concatenate([s[0] for s in shards]), p_ref)
        for k in cls.SLOTS:
            assert np.array_equal(
                np.concatenate([s[1][k] for s in shards]), getattr(ref, k))


def test_device_entry_points_default_to_the_card():
    """``device=None`` means cuda: without a card the device engine and
    the fused apply raise; the host engine touches no device."""
    if torch.cuda.is_available():
        pytest.skip("this checks the CPU-only machine's refusal")
    z = np.zeros(3, np.float32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dist_step.fused_optimizer_apply("sgd", z, z, {}, t=1, lr=0.1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DeviceZeroEngine(2, 10)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _make_trainer("unused", "127.0.0.1:1", 1, device=None)
    tr = _make_trainer("unused", "127.0.0.1:1", 1, device=None,
                       engine="host")
    assert tr.device is None and tr._engine is None
    assert tr._opt.fused is False
    with pytest.raises(ValueError, match="engine"):
        _make_trainer("unused", "127.0.0.1:1", 1, engine="gpu")


def test_engine_is_a_constructor_argument_not_an_env_var(monkeypatch):
    monkeypatch.setenv("PADDLE_ELASTIC_ENGINE", "host")
    monkeypatch.setenv("PADDLE_ELASTIC_FUSED", "0")
    tr = _make_trainer("unused", "127.0.0.1:1", 1)
    assert tr.engine == "device" and tr._engine is not None
    assert tr._opt.fused is True and tr.device == torch.device("cpu")


# ---------------------------------------------------------------------------
# the whole slice against the JAX package
# ---------------------------------------------------------------------------

_STEPS = 10


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """The JAX package's host-engine runs, per (optimizer, world)."""
    out = {}
    for opt in ("sgd", "momentum", "adam"):
        for world in (1, 2):
            ck = str(tmp_path_factory.mktemp(f"jax_{opt}_{world}"))
            res, trs, _ = _run_world(ck, world, _STEPS, jax=True,
                                     optimizer=opt, engine="host")
            out[opt, world] = (res, _shards_by_rank(trs), ck)
    return out


def _shards_by_rank(trainers):
    """Each trainer's optimizer shard, in rank order (threads register in
    any order, so list order is not rank order)."""
    return [tr.opt_shard() for tr in
            sorted(trainers, key=lambda t: t.role_maker.worker_index())]


@pytest.mark.parametrize("engine", ["host", "device"])
@pytest.mark.parametrize("world", [1, 2])
@pytest.mark.parametrize("opt", ["sgd", "momentum", "adam"])
def test_whole_slice_bitwise_jax_host_engine(jax_runs, tmp_path, opt,
                                             world, engine):
    # device engine: one plain opt_apply per step per rank plus the
    # rebuild's warm-up; the host engine calls it never
    _check_slice_against_jax(jax_runs, tmp_path, opt, world,
                             world * (_STEPS + 1) if engine == "device"
                             else 0, engine=engine)


@pytest.mark.parametrize("engine,fused", [("host", True),
                                          ("device", False)])
@pytest.mark.parametrize("world", [1, 2])
@pytest.mark.parametrize("opt", ["sgd", "momentum", "adam"])
def test_off_default_fused_optimizer_bitwise_jax_host_engine(
        jax_runs, tmp_path, opt, world, engine, fused):
    """``fused_optimizer=`` against its engine's default: the host
    engine with the update through opt_apply (one call per step per
    rank, no warm-up), and the device engine with the numpy update (the
    rebuild's warm-up only) end bitwise equal to the JAX host engine."""
    _check_slice_against_jax(jax_runs, tmp_path, opt, world,
                             world * _STEPS if fused else world,
                             engine=engine, fused_optimizer=fused)


def _check_slice_against_jax(jax_runs, tmp_path, opt, world, calls, **kw):
    jres, jshards, jck = jax_runs[opt, world]
    ck = str(tmp_path / "ck")
    registry.reset_counts()
    res, trs, _ = _run_world(ck, world, _STEPS, optimizer=opt, **kw)
    spec = registry.spec("opt_apply")
    assert spec.torch_ref_calls == calls
    assert spec.launches == 0
    for r in res:
        for jr in jres:
            _assert_params_equal(r, jr)
    for sh, js in zip(_shards_by_rank(trs), jshards):
        assert int(sh["t"]) == int(js["t"]) == _STEPS
        for k in js:
            assert np.array_equal(sh[k], js[k]), k
    # the final pinned checkpoint: the same bytes in both packages
    step = f"step_{_STEPS}"
    assert _dir_bytes(os.path.join(ck, step)) == \
        _dir_bytes(os.path.join(jck, step))


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_cross_package_checkpoint_resume(tmp_path, direction, jax_runs):
    """A world-2 run of one package pins step 6; the other package
    resumes it at world 3 and ends bitwise equal to an uninterrupted
    JAX run to 10."""
    ck = str(tmp_path / "ck")
    first_jax = direction == "jax_to_port"
    _run_world(ck, 2, 6, jax=first_jax, engine="host")
    cls = ElasticCoordinator if first_jax else jelastic.ElasticCoordinator
    coord = cls(expected_world=3, ckpt_step=6).start()
    res, trs, _ = _run_world(ck, 3, _STEPS, coord=coord, jax=not first_jax,
                             engine="device" if first_jax else "host")
    coord.stop()
    for tr in trs:
        assert tr.transitions[0]["resume_step"] == 6
        assert int(tr.opt_shard()["t"]) == _STEPS
    for r in res:
        _assert_params_equal(r, jax_runs["adam", 1][0][0])


# ---------------------------------------------------------------------------
# the reference's elastic contracts, against the port
# ---------------------------------------------------------------------------

def test_world_invariance_and_observability(tmp_path):
    before = _monitor.stat_get("elastic_transitions")
    (r1,), (t1,), _ = _run_world(str(tmp_path / "ck1"), 1, 8)
    r2, trainers, _ = _run_world(str(tmp_path / "ck2"), 2, 8)
    assert t1.engine == "device" and t1._opt.fused is True
    assert t1._engine.compiles == 1
    for r in r2:
        _assert_params_equal(r, r1)
    for tr in trainers:
        assert tr.transitions and tr.transitions[0]["world"] == 2
        assert tr.role_maker.worker_num() == 2
        assert tr.role_maker.generation() >= 1
        assert tr._engine.world == 2
    assert _monitor.stat_get("elastic_transitions") > before
    for name in ("reshard_ms", "reshard_bytes"):
        h = _monitor.get_histogram(name)
        assert h is not None and h.snapshot()["count"] > 0
    assert mesh_mod.get_mesh().shape["dp"] == 1      # the CPU device


def test_reshard_flight_decomposition_recorded(tmp_path):
    flight_recorder.clear()
    _run_world(str(tmp_path / "ck"), 2, 4)
    by_kind = {}
    for e in flight_recorder.events():
        by_kind.setdefault(e.get("kind"), []).append(e)
    for kind in ("elastic.join", "elastic.resume", "elastic.reshard",
                 "elastic.reshard.exchange", "elastic.reshard.load",
                 "elastic.reshard.compile"):
        assert by_kind.get(kind), f"missing {kind} events"
    assert all(e["bytes"] > 0 for e in by_kind["elastic.reshard.load"])
    assert all(e["shard_len"] > 0
               for e in by_kind["elastic.reshard.compile"])
    assert any(e.get("engine") == "device"
               for e in by_kind["elastic.reshard"])
    assert {"elastic.join", "elastic.reshard", "elastic.resume",
            "elastic.reshard.compile"} <= flight_recorder._PROGRESS_KINDS
    assert "elastic.leave" not in flight_recorder._PROGRESS_KINDS


def test_streamed_checkpoint_bytes_equal_concat_format(tmp_path):
    ck = str(tmp_path / "ck")
    _run_world(ck, 2, 4)                      # streamed saves at 0, 2, 4
    mgr = CheckpointManager(ck)
    for step in (0, 4):
        ref = str(tmp_path / f"ref_{step}")
        save_state_dict(mgr.restore(step), ref)
        assert _dir_bytes(os.path.join(ck, f"step_{step}")) == \
            _dir_bytes(ref)


def test_reshard_n_to_m_matches_fresh_world_restore(tmp_path):
    ck = str(tmp_path / "ck")
    _run_world(ck, 2, 6)           # ckpts pinned at 2, 4, 6
    coord = ElasticCoordinator(expected_world=3, ckpt_step=6).start()
    r3, trainers, _ = _run_world(ck, 3, 10, coord=coord)
    coord.stop()
    for tr in trainers:
        assert tr.transitions[0]["resume_step"] == 6
        assert tr._engine.world == 3
    (ref,), _, _ = _run_world(str(tmp_path / "ref"), 1, 10)
    for r in r3:
        _assert_params_equal(r, ref)


def test_lr_schedule_bit_exact_across_reshard_mid_schedule(tmp_path):
    sched = {"kind": "cosine", "base_lr": 0.08, "warmup_steps": 2,
             "total_steps": 10, "min_lr": 0.005}
    ck = str(tmp_path / "ck")
    _run_world(ck, 2, 6, lr_schedule=sched)      # pinned at 2, 4, 6
    coord = ElasticCoordinator(expected_world=3, ckpt_step=6).start()
    r3, trainers, _ = _run_world(ck, 3, 10, coord=coord, lr_schedule=sched)
    coord.stop()
    assert trainers[0].transitions[0]["resume_step"] == 6
    (ref,), _, _ = _run_world(str(tmp_path / "ref"), 1, 10,
                              lr_schedule=sched)
    for r in r3:
        _assert_params_equal(r, ref)
    (flat,), _, _ = _run_world(str(tmp_path / "flat"), 1, 10)
    assert not np.array_equal(flat["w"], ref["w"])


def _slow_grad_fn(params, batch):
    time.sleep(0.02)
    return grad_fn(params, batch)


def test_join_mid_run_matches_fresh_run(tmp_path):
    ck = str(tmp_path / "ck")
    steps = 14
    coord = ElasticCoordinator(expected_world=2).start()
    ep = f"127.0.0.1:{coord.port}"
    results, errs = {}, []

    def worker(name):
        try:
            tr = _make_trainer(ck, ep, 2, grad=_slow_grad_fn)
            results[name] = (tr.run(steps), tr)
        except BaseException as e:
            errs.append(e)

    ts = [threading.Thread(target=worker, args=(f"w{i}",), daemon=True)
          for i in range(2)]
    for t in ts:
        t.start()
    deadline = time.monotonic() + WAIT
    while coord.status()["last_step"] < 3:
        assert time.monotonic() < deadline, "run never reached step 3"
        time.sleep(0.005)
    tj = threading.Thread(target=worker, args=("joiner",), daemon=True)
    tj.start()
    for t in ts + [tj]:
        t.join(timeout=WAIT)
    assert all(not t.is_alive() for t in ts + [tj]), "join run hung"
    for e in errs:
        raise e
    coord.stop()
    _, jt = results["joiner"]
    assert jt.transitions[0]["world"] == 3
    assert jt.transitions[0]["resume_step"] % 2 == 0
    assert any(t["world"] == 3 for _, tr in results.values()
               for t in tr.transitions)
    (ref,), _, _ = _run_world(str(tmp_path / "ref"), 1, steps)
    for r, _ in results.values():
        _assert_params_equal(r, ref)


def test_graceful_leave_and_lease_eviction_reform(tmp_path):
    """A registered-but-silent worker is evicted by the lease and the
    survivor reshards at world 1; a graceful ``leave`` reforms too."""
    ck = str(tmp_path / "ck")
    coord = ElasticCoordinator(expected_world=2, lease_s=0.4).start()
    ep = f"127.0.0.1:{coord.port}"
    wedged = ElasticClient(ep, timeout=30.0)
    out, errs = {}, []

    def survivor():
        try:
            tr = _make_trainer(ck, ep, 2)
            out["r"] = (tr.run(8), tr)
        except BaseException as e:
            errs.append(e)

    t = threading.Thread(target=survivor, daemon=True)
    t.start()
    wedged.register(2)
    t.join(timeout=WAIT)
    assert not t.is_alive(), "survivor hung behind the wedged worker"
    for e in errs:
        raise e
    assert any(k == "lease" for k, _, _ in coord.events)
    r, tr = out["r"]
    assert any(tt["world"] == 1 for tt in tr.transitions)
    (ref,), _, _ = _run_world(str(tmp_path / "ref"), 1, 8)
    _assert_params_equal(r, ref)
    wedged.close()
    coord.stop()
    # graceful leave: a member leaving reforms the generation
    coord = ElasticCoordinator(expected_world=2).start()
    ep = f"127.0.0.1:{coord.port}"
    a, b = ElasticClient(ep, timeout=30.0), ElasticClient(ep, timeout=30.0)
    infos = []
    tb = threading.Thread(target=lambda: infos.append(b.register(2)),
                          daemon=True)
    tb.start()
    infos.append(a.register(2))
    tb.join(timeout=WAIT)
    gen = coord.status()["gen"]
    b.leave()
    deadline = time.monotonic() + WAIT
    while coord.status()["world"] != 1:
        assert time.monotonic() < deadline, "leave never reformed"
        time.sleep(0.01)
    assert coord.status()["gen"] > gen
    assert any(k == "leave" for k, _, _ in coord.events)
    status, rep = a.exchange(gen, 0, "x", {})
    assert status == "reform" and rep["world"] == 1
    a.leave()
    coord.stop()


_BIG = 30_000 - 1     # +1 scalar bias -> numel = 30_000


class _BigSet(Dataset):
    def __init__(self, n=32):
        self.x = np.random.default_rng(5).standard_normal(n).astype(
            np.float32)

    def __len__(self):
        return self.x.size

    def __getitem__(self, i):
        return self.x[i]


def _big_grad(params, batch):
    s = np.float32(np.mean(batch))
    return {"w": (params["w"] * np.float32(1e-3)
                  + s * np.float32(1e-2)).astype(np.float32),
            "b": np.asarray(s, np.float32).reshape(())}


def test_reshard_and_ckpt_peak_host_bytes_bounded(tmp_path):
    """Across bootstrap save, restore and the streamed checkpoint round
    the reshard/checkpoint machinery of every rank stages at most
    O(max shard), measured by the per-trainer ReshardMeter."""
    world, numel = 3, _BIG + 1
    coord = ElasticCoordinator(expected_world=world).start()
    ep = f"127.0.0.1:{coord.port}"
    trainers = [ElasticTrainer(
        {"w": np.zeros(_BIG, np.float32), "b": np.zeros((), np.float32)},
        _big_grad, DataLoader(_BigSet(), batch_size=8, shuffle=True, seed=3,
                              drop_last=True),
        ckpt_dir=str(tmp_path / "ck"), optimizer="adam", lr=0.01,
        micro_batches=2, ckpt_every=2, coordinator=ep,
        expected_world=world, client_timeout=60.0, device="cpu")
        for _ in range(world)]
    errs = [None] * world

    def go(i):
        try:
            trainers[i].run(2)
        except BaseException as e:
            errs[i] = e

    ts = [threading.Thread(target=go, args=(i,), daemon=True)
          for i in range(world)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=WAIT)
    assert all(not t.is_alive() for t in ts), "big elastic run hung"
    for e in errs:
        if e is not None:
            raise e
    coord.stop()
    shard_bytes = -(-numel // world) * 4
    for tr in trainers:
        peak = tr.reshard_meter.peak_bytes
        assert tr.reshard_meter.total_bytes > 0
        # adam holds both slot-shard reads concurrently through load()
        assert peak <= 2 * shard_bytes + 4096, (peak, shard_bytes)
        assert peak < numel * 4


def test_no_teardown_reshard_cascade(tmp_path):
    world = 3
    coord = ElasticCoordinator(expected_world=world).start()
    ep = f"127.0.0.1:{coord.port}"
    trainers = [_make_trainer(str(tmp_path / "ck"), ep, world)
                for _ in range(world)]
    errs = [None] * world

    def go(i):
        try:
            trainers[i].run(4)
        except BaseException as e:
            errs[i] = e

    ts = [threading.Thread(target=go, args=(i,), daemon=True)
          for i in range(world)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=WAIT)
    assert all(not t.is_alive() for t in ts), "teardown hung"
    for e in errs:
        if e is not None:
            raise e
    coord.stop()
    for tr in trainers:
        assert tr._finished is True
        assert len(tr.transitions) == 1, tr.transitions
        assert tr._engine.compiles == 1


def test_generation_info_is_a_consistent_snapshot():
    coord = ElasticCoordinator(expected_world=1)
    member = lambda uid: type("M", (), {"uid": uid, "rank": 0,
                                        "conn": None, "last_seen": 0.0})()
    with coord._cond:
        coord._pending[0] = member(0)
        coord._reform_locked()
        coord._ckpt_step = 0
        assert coord._info_locked(0)["ckpt_step"] is None
        coord._pending[1] = member(1)
        coord._reform_locked()
        assert coord._info_locked(0)["ckpt_step"] == 0
        assert coord._info_locked(1)["ckpt_step"] == 0


def test_reform_hooks_fire_with_the_new_mesh():
    seen = []

    class Owner:
        def reform(self, mesh):
            seen.append(mesh)

    o = Owner()
    mesh_mod.on_reform(o.reform)
    m = mesh_mod.reform_mesh()
    assert seen == [m] and mesh_mod.get_mesh() is m
    assert m.shape["dp"] == len(m.devices) and m.shape["tp"] == 1
    del o                      # dead owners are pruned, not called
    mesh_mod.reform_mesh()
    assert len(seen) == 1


# ---------------------------------------------------------------------------
# the wire: the framing and the coordinator protocol are the reference's
# ---------------------------------------------------------------------------

def test_wire_frames_bitwise_reference():
    import socket
    msg = {"op": "exchange", "uid": 3, "gen": 2, "step": 7, "tag": "grads",
           "a:g0": np.arange(5, dtype=np.float32),
           "a:ids": np.arange(6, dtype=np.int64).reshape(2, 3),
           "a:none": np.zeros(0, np.float32)}
    frame = ps_service._frame_bytes(msg)
    assert frame == jps_service._frame_bytes(msg)
    a, b = socket.socketpair()
    try:
        ps_service._send_msg(a, msg)
        got = jps_service._recv_msg(b)
        ps_service._send_msg_raw(a, msg)
        raw = b.recv(len(frame), socket.MSG_WAITALL)
    finally:
        a.close()
        b.close()
    assert raw == frame
    assert got.keys() == msg.keys()
    for k, v in msg.items():
        assert np.array_equal(got[k], v) if isinstance(v, np.ndarray) \
            else got[k] == v
    assert ps_service._parse_ep("10.0.0.1:8000") == ("10.0.0.1", 8000)


def test_port_client_speaks_to_the_jax_coordinator():
    coord = jelastic.ElasticCoordinator(expected_world=1).start()
    try:
        cli = ElasticClient(f"127.0.0.1:{coord.port}", timeout=20)
        info = cli.register(1)
        assert (info["rank"], info["world"], info["ckpt_step"]) == \
            (0, 1, None)
        status, reps = cli.exchange(info["gen"], 0, "x",
                                    {"g": np.arange(3, dtype=np.float32)})
        assert status == "ok" and np.array_equal(reps[0]["g"],
                                                 np.arange(3))
        cli.report_ckpt(4)
        assert cli.status()["ckpt_step"] == 4
        cli.leave()
    finally:
        coord.stop()


# ---------------------------------------------------------------------------
# coordinator HA and the ckpt_dir scan
# ---------------------------------------------------------------------------

def _wait(cond, what):
    deadline = time.monotonic() + WAIT
    while not cond():
        assert time.monotonic() < deadline, what
        time.sleep(0.02)


def test_standby_replicates_state_and_promotes_on_eof():
    prim = ElasticCoordinator(expected_world=1).start()
    stby = ElasticCoordinator(standby_of=f"127.0.0.1:{prim.port}").start()
    try:
        cli = ElasticClient(
            f"127.0.0.1:{prim.port}|127.0.0.1:{stby.port}", timeout=20)
        info = cli.register(1)
        assert info["rank"] == 0 and info["world"] == 1
        cli.report_ckpt(4)
        _wait(lambda: stby.status()["ckpt_step"] == 4, "no replication")
        assert stby.status()["role"] == "standby"
        gen_before = prim.status()["gen"]
        prim.stop()                      # EOF -> promote
        _wait(lambda: stby.promoted, "standby never promoted")
        st = stby.status()
        assert st["role"] == "primary" and st["ckpt_step"] == 4
        assert st["gen"] > gen_before
        with pytest.raises(CoordinatorLost):
            cli.exchange(info["gen"], 0, "x", {})
        info2 = cli.rejoin(1)
        assert info2["ckpt_step"] == 4 and info2["gen"] > info["gen"]
        cli.leave()
    finally:
        prim.stop()
        stby.stop()


def test_client_rotates_past_unpromoted_standby():
    prim = ElasticCoordinator(expected_world=1).start()
    stby = ElasticCoordinator(standby_of=f"127.0.0.1:{prim.port}").start()
    try:
        cli = ElasticClient(f"127.0.0.1:{stby.port}|127.0.0.1:{prim.port}",
                            timeout=20, retry_delay=0.05)
        info = cli.register(1)
        assert info["status"] == "ok" and info["world"] == 1
        cli.leave()
    finally:
        prim.stop()
        stby.stop()


def test_ckpt_dir_scan_and_restart_resume(tmp_path):
    ck = str(tmp_path / "ck")
    _run_world(ck, 1, 6)                   # pinned ckpts at 2, 4, 6
    assert _scan_ckpt_dir(ck) == 6
    coord = ElasticCoordinator(expected_world=1, ckpt_dir=ck).start()
    assert coord.status()["ckpt_step"] == 6
    r, trainers, _ = _run_world(ck, 1, 10, coord=coord)
    coord.stop()
    assert trainers[0].transitions[0]["resume_step"] == 6
    (ref,), _, _ = _run_world(str(tmp_path / "ref"), 1, 10)
    _assert_params_equal(r[0], ref)
    empty = ElasticCoordinator(ckpt_dir=str(tmp_path / "empty")).start()
    assert empty.status()["ckpt_step"] is None
    empty.stop()


# ---------------------------------------------------------------------------
# acceptance: the port's launch --elastic + SIGKILL every K steps
# ---------------------------------------------------------------------------

_WORKER_SRC = r'''
import json, os, sys
import numpy as np
from paddle_tpu_torch.distributed.fleet.elastic import ElasticTrainer
from paddle_tpu_torch.io import DataLoader, Dataset

DIM = 4


class RegressionSet(Dataset):
    def __init__(self, n=64, d=DIM):
        rng = np.random.default_rng(7)
        self.x = rng.standard_normal((n, d)).astype(np.float32)
        w = np.arange(1, d + 1, dtype=np.float32)
        self.y = (self.x @ w + 0.5).astype(np.float32)

    def __len__(self):
        return len(self.x)

    def __getitem__(self, i):
        return self.x[i], self.y[i]


def grad_fn(params, batch):
    x, y = batch
    err = (x @ params["w"] + params["b"] - y).astype(np.float32)
    n = np.float32(x.shape[0])
    return {"w": (x.T @ err / n).astype(np.float32),
            "b": np.asarray(err.sum() / n, np.float32).reshape(())}


cfg = json.load(open(sys.argv[1]))
tr = ElasticTrainer(
    {"w": np.zeros(DIM, np.float32), "b": np.zeros((), np.float32)},
    grad_fn, DataLoader(RegressionSet(), batch_size=16, shuffle=True,
                        seed=11, drop_last=True),
    ckpt_dir=cfg["ckpt_dir"], optimizer="adam", lr=0.05, micro_batches=4,
    ckpt_every=2, coordinator=cfg["coordinator"],
    expected_world=cfg["world"], client_timeout=60.0, device="cpu")
params = tr.run(cfg["steps"])
out = cfg["result"] + ".rank" + os.environ["PADDLE_TRAINER_ID"] + ".npz"
np.savez(out + ".tmp.npz", w=params["w"], b=params["b"],
         transitions=json.dumps(tr.transitions),
         opt_t=int(tr.opt_shard()["t"]))
os.replace(out + ".tmp.npz", out)
'''


def test_chaos_kill_every_k_steps_matches_fault_free_run(tmp_path):
    """Two workers under the port's ``launch --elastic``; rank 1 is
    SIGKILLed every 5 executed steps, the launcher restarts it, the
    survivors reshard from the pinned step on each loss: the final
    weights AND optimizer step count are bitwise the fault-free run's."""
    steps, world = 12, 2
    worker = tmp_path / "worker.py"
    worker.write_text(_WORKER_SRC)
    coord = ElasticCoordinator(expected_world=world).start()
    res = str(tmp_path / "res")
    cfgp = tmp_path / "cfg.json"
    cfgp.write_text(json.dumps({
        "ckpt_dir": str(tmp_path / "ck"), "result": res, "steps": steps,
        "world": world, "coordinator": f"127.0.0.1:{coord.port}"}))
    procs = []
    for r in range(world):
        env = dict(os.environ, PYTHONPATH=REPO)
        env.pop("PADDLE_CHAOS", None)
        env.pop("PADDLE_COORDINATOR", None)
        if r == 1:
            env["PADDLE_CHAOS"] = "plan=kill_worker@every=5"
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
             "--elastic", "--max_restarts", "8", "--restart_backoff",
             "0.05", "--ips", "127.0.0.1,127.0.0.1", "--host_rank", str(r),
             "--log_dir", str(tmp_path / "log"), str(worker), str(cfgp)],
            env=env, cwd=str(tmp_path)))
    try:
        rcs = [p.wait(timeout=240) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        coord.stop()
    assert rcs == [0, 0], "elastic launcher did not recover the worker"
    assert any(k == "leave" for k, _, _ in coord.events)
    assert len([u for k, u, _ in coord.events if k == "join"]) >= 3, \
        "killed worker never rejoined"
    (ref,), _, _ = _run_world(str(tmp_path / "ref"), 1, steps)
    all_trans = []
    for r in range(world):
        o = np.load(f"{res}.rank{r}.npz")
        _assert_params_equal(o, ref)
        assert int(o["opt_t"]) == steps
        all_trans += json.loads(str(o["transitions"]))
    assert any(t["world"] == 1 for t in all_trans), \
        "no worker ever trained in a shrunken world"


def test_kill_worker_chaos_plan():
    plan = chaos.named_plan("kill_worker@every=3")
    f = plan.faults[0]
    assert (f.kind, f.op, f.first, f.every, f.times) == \
        ("kill", "worker", 3, 3, 0)
    fired = [bool(plan.match_elastic()) for _ in range(9)]
    assert fired == [False, False, True] * 3
    assert chaos.plan_from_spec("plan=kill_worker@every=5").faults[0] \
        .every == 5
    p3 = chaos.plan_from_spec("kill:worker:first=2:every=4")
    assert (p3.faults[0].kind, p3.faults[0].first) == ("kill", 2)
    # the PS wire kinds are ported: a delay spec parses
    (d,) = chaos.plan_from_spec("delay:pull:every=2").faults
    assert (d.kind, d.op, d.every) == ("delay", "pull", 2)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        chaos.plan_from_spec("nan:grad:step=3")
    chaos.maybe_kill_worker()       # no active plan: a no-op
