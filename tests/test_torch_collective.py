"""The port's ranks and collectives against the JAX reference:
``init_parallel_env``, ``spawn``, ``launch --nproc_per_node``, the mesh
over process groups, the collective API, the named-axis collectives, the
``shard_map`` counterpart and ``DataParallel``.

The port's side runs as four gloo processes on the CPU, started once for
the module by ``spawn`` (every rank runs every case of
``torch_dist_worker.collective_cases`` and returns its results); the
JAX side runs on its host mesh restricted to four devices.  Tolerances:
collectives of integer-valued floats exact; ``DataParallel`` against one
device on the whole batch within rtol / atol 2e-5 (the reference's own
bound: the mean of four quarter-batch gradients is the whole batch's up
to summation order).  Every wait is bounded (the rendezvous and each
collective by the group's timeout, the ranks by ``spawn``'s
``join_timeout``), and a hung rank fails its test."""
import os
import subprocess
import sys
import textwrap
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import paddle_tpu as paddle
import paddle_tpu.distributed as jdist
from paddle_tpu.distributed import communication as jcomm
from paddle_tpu.distributed import mesh as jmesh

import paddle_tpu_torch.distributed as tdist
from paddle_tpu_torch.distributed import collective, parallel
from paddle_tpu_torch.distributed import mesh as tmesh
from paddle_tpu_torch.distributed.spawn import SpawnError, spawn

import torch_dist_worker as worker

WORLD = 4
_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _dp_weights():
    import paddle_tpu.nn as jnn
    paddle.seed(42)
    m = jnn.Sequential(jnn.Linear(16, 32), jnn.ReLU(), jnn.Linear(32, 4))
    return m, {k: np.asarray(v._value).copy()
               for k, v in m.state_dict().items()}


def _dp_data():
    rng = np.random.default_rng(0)
    return (rng.normal(size=(4, 16, 16)).astype(np.float32),
            rng.normal(size=(4, 16, 4)).astype(np.float32))


@pytest.fixture(scope="module")
def ranks():
    _, w = _dp_weights()
    xs, ys = _dp_data()
    return spawn(worker.collective_cases,
                 args=({"dp_weights": w, "dp_x": xs, "dp_y": ys},),
                 nprocs=WORLD, backend="gloo", timeout=60, join_timeout=180)


@pytest.fixture
def jax_mesh():
    jmesh.set_mesh(None)
    yield
    jmesh.set_mesh(None)


def _jgroup_value(fn, value, **kw):
    """The reference's eager collective over a group of ``WORLD``
    devices."""
    g = jdist.new_group(list(range(WORLD)))
    t = paddle.to_tensor(value)
    out = fn(t, group=g, **kw)
    return np.asarray((out if out is not None else t)._value)


def test_all_reduce_sums_the_ranks_like_jax(ranks):
    want = _jgroup_value(jdist.all_reduce, np.ones((4,), np.float32))
    for r in ranks:
        np.testing.assert_array_equal(r["all_reduce"], want)
        np.testing.assert_array_equal(r["all_reduce"], np.full(4, WORLD))


def test_all_reduce_ops_and_group(ranks):
    import math
    for r in ranks:
        np.testing.assert_array_equal(r["max"], np.full((2, 2), WORLD))
        np.testing.assert_array_equal(r["min"], np.ones((2, 2)))
        np.testing.assert_array_equal(r["prod"], np.full(
            (2, 2), math.factorial(WORLD)))
    # MAX over the group of ranks 0-1; the others keep their value
    want = _jgroup_value(jdist.all_reduce, np.full((2,), 3.0, np.float32),
                         op=jdist.ReduceOp.MAX)
    np.testing.assert_array_equal(want, np.full(2, 3.0))
    for r in ranks:
        np.testing.assert_array_equal(
            r["group_max"], np.full(2, 4.0 if r["rank"] < 2 else
                                    3.0 + r["rank"]))


def test_all_gather_broadcast_barrier(ranks):
    want = np.stack([np.arange(3) + 10 * j for j in range(WORLD)])
    for r in ranks:
        np.testing.assert_array_equal(r["all_gather"], want)
        np.testing.assert_array_equal(r["broadcast"], np.full(3, WORLD - 1))


def test_reduce_scatter_reduce_scatter_alltoall_send(ranks):
    total = np.arange(2 * WORLD) * sum(range(1, WORLD + 1))
    for r in ranks:
        i = r["rank"]
        np.testing.assert_array_equal(r["reduce_scatter"],
                                      total[2 * i:2 * i + 2])
        np.testing.assert_array_equal(r["reduce"],
                                      np.full(2, sum(range(WORLD))))
        np.testing.assert_array_equal(r["scatter"], np.full(2, i))
        np.testing.assert_array_equal(
            r["alltoall"], [10 * j + i for j in range(WORLD)])
        np.testing.assert_array_equal(
            r["send_recv"], np.full(2, 42.0 if i == 1 else i))


def test_named_axis_collectives_match_jax(ranks, jax_mesh):
    """Each rank's named-axis results against the reference's in-graph
    collectives over a ``WORLD``-device ``dp`` mesh on the same values."""
    from paddle_tpu.distributed.collective import shard_map as jshard_map
    mesh = jdist.init_mesh({"dp": WORLD}, devices=jax.devices()[:WORLD])
    x = jnp.asarray([[float(r + 1), 2.0 * (r + 1)] for r in range(WORLD)])

    def f(v):
        v = v[0]
        out = [jcomm.psum(v, "dp"), jcomm.pmean(v, "dp"),
               jcomm.pmax(v, "dp"), jcomm.pmin(v, "dp"),
               jcomm.pprod(v, "dp"),
               jcomm.all_gather(v, "dp", tiled=True),
               jcomm.ppermute(v, "dp", [(0, WORLD - 1)]),
               jcomm.ring_shift(v, "dp", 1),
               jcomm.broadcast_from(v, "dp", root=WORLD - 1)]
        return tuple(o[None] for o in out)

    outs = jax.jit(jshard_map(f, mesh=mesh, in_specs=(P("dp"),),
                              out_specs=(P("dp"),) * 9))(x)
    keys = ["psum", "pmean", "pmax", "pmin", "pprod", "gather_tiled",
            "ppermute", "ring_shift", "broadcast_from"]
    for r in ranks:
        i = r["rank"]
        for k, o in zip(keys, outs):
            np.testing.assert_array_equal(r[k], np.asarray(o)[i], err_msg=k)
        np.testing.assert_array_equal(r["gather_stacked"],
                                      np.asarray(x))
        assert r["axis"] == (i, WORLD)
        np.testing.assert_array_equal(
            r["rs"], (np.arange(2.0 * WORLD) * sum(range(1, WORLD + 1)))
            [2 * i:2 * i + 2])
        np.testing.assert_array_equal(
            r["all_to_all"], [100 * j + i for j in range(WORLD)])


def test_shard_map_counterpart_matches_jax(ranks, jax_mesh):
    """The reference's shard_map test at ``WORLD`` ranks: every rank
    returns the whole assembled outputs, equal to JAX's."""
    from paddle_tpu.distributed.collective import shard_map as jshard_map
    mesh = jdist.init_mesh({"dp": WORLD}, devices=jax.devices()[:WORLD])

    def f(v):
        return (jcomm.psum(v, "dp"), jcomm.all_gather(v, "dp", tiled=True),
                jcomm.axis_index("dp")[None], jcomm.ring_shift(v, "dp", 1))

    x = jnp.arange(float(WORLD)).reshape(WORLD, 1)
    want = jax.jit(jshard_map(f, mesh=mesh, in_specs=(P("dp"),),
                              out_specs=(P("dp"),) * 4))(x)
    bc = jax.jit(jshard_map(lambda v: jcomm.broadcast_from(
        v, "dp", root=WORLD - 1), mesh=mesh, in_specs=(P("dp"),),
        out_specs=P("dp")))(jnp.arange(float(WORLD)))
    for r in ranks:
        for got, w in zip(r["shard_map"], want):
            np.testing.assert_array_equal(got.reshape(np.shape(w)),
                                          np.asarray(w))
        np.testing.assert_array_equal(r["shard_map_broadcast"],
                                      np.asarray(bc))


def test_mesh_axis_groups_and_batch_rows(ranks):
    """dp 2 x fsdp 2 over four ranks: row-major coordinates, one group a
    rank an axis, and the data axes' rows of a 16-row batch."""
    for r in ranks:
        i = r["rank"]
        m = r["mesh"]
        assert m["coords"]["dp"] == i // 2 and m["coords"]["fsdp"] == i % 2
        assert m["fsdp"] == [i - i % 2, i - i % 2 + 1]
        assert m["dp"] == [i % 2, i % 2 + 2]
        assert m["data"] == list(range(WORLD))
        assert m["sum_fsdp"] == sum(m["fsdp"])
        assert m["sum_dp"] == sum(m["dp"])
        assert m["sum_data"] == sum(range(WORLD))
        assert m["rows"] == slice(4 * i, 4 * i + 4)
        assert r["fleet_mesh"]["dp"] == 2 and r["fleet_mesh"]["fsdp"] == 2
        assert r["fleet_workers"] == WORLD
        assert r["fleet_model"] == "DataParallel"


def test_data_parallel_matches_one_device(ranks):
    """The reference's test: SGD over four batches of 16 on one device
    (JAX) against DataParallel over four ranks of 4 rows each."""
    m1, _ = _dp_weights()
    xs, ys = _dp_data()
    o1 = paddle.optimizer.SGD(learning_rate=0.1, parameters=m1.parameters())
    for x, y in zip(xs, ys):
        loss = ((m1(paddle.to_tensor(x)) - paddle.to_tensor(y)) ** 2).mean()
        loss.backward()
        o1.step()
        o1.clear_grad()
    want = {k: np.asarray(v._value) for k, v in m1.state_dict().items()}
    for r in ranks:
        for k, v in want.items():
            np.testing.assert_allclose(r["dp_params"][k], v, rtol=2e-5,
                                       atol=2e-5, err_msg=k)
    for k in want:                   # the ranks hold one model, bitwise
        for r in ranks[1:]:
            np.testing.assert_array_equal(r["dp_params"][k],
                                          ranks[0]["dp_params"][k])


def test_backend_is_never_picked_silently(monkeypatch):
    """Ranks that share a card without backend='gloo' raise and say why;
    'nccl' without a card raises; without a card the rule picks gloo."""
    monkeypatch.setenv("PADDLE_LOCAL_SIZE", "2")
    monkeypatch.setenv("PADDLE_TRAINERS_NUM", "2")
    monkeypatch.setenv("PADDLE_TRAINER_ID", "0")
    monkeypatch.delenv("PADDLE_DISTRI_BACKEND", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="backend='gloo'"):
        tdist.init_parallel_env()
    assert not parallel.is_initialized()
    env = parallel.ParallelEnv()
    assert parallel._pick_backend(env, "gloo") == "gloo"
    monkeypatch.setenv("PADDLE_DISTRI_BACKEND", "gloo")
    assert parallel._pick_backend(env, None) == "gloo"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    monkeypatch.delenv("PADDLE_DISTRI_BACKEND")
    assert parallel._pick_backend(env, None) == "gloo"
    with pytest.raises(RuntimeError, match="nccl"):
        parallel._pick_backend(env, "nccl")


def test_gloo_stages_cuda_tensors_through_host(monkeypatch):
    """On a gloo group a CUDA tensor reaches the collective as a host
    copy and comes back by ``copy_``; a host tensor goes as it is."""
    calls = []

    class FakeDist:
        class ReduceOp:
            SUM = "sum"
            MAX = PRODUCT = MIN = "other"

        @staticmethod
        def get_backend(pg):
            return "gloo"

        @staticmethod
        def all_reduce(t, op, pg):
            calls.append(("all_reduce", t.device.type))
            t.mul_(2)

    class FakeCuda:
        is_cuda = True

        def __init__(self):
            self.host = torch.ones(3)
            self.back = None

        def cpu(self):
            return self.host.clone()

        def copy_(self, h):
            self.back = h

    monkeypatch.setattr(collective, "_dist", lambda: FakeDist)
    t = FakeCuda()
    collective._all_reduce(t, collective.ReduceOp.SUM, object())
    assert calls == [("all_reduce", "cpu")]
    np.testing.assert_array_equal(t.back.numpy(), np.full(3, 2.0))
    h = torch.ones(2)
    collective._all_reduce(h, collective.ReduceOp.SUM, object())
    np.testing.assert_array_equal(h.numpy(), np.full(2, 2.0))


def test_a_hung_rank_fails_within_its_bound():
    """Rank 1 never joins: rank 0's all-reduce fails at the group's 3 s
    timeout, spawn ends rank 1 and raises with both ranks' log tails."""
    t0 = time.monotonic()
    with pytest.raises(SpawnError, match="rank 0") as e:
        spawn(worker.hang_case, args=({"sleep": 120},), nprocs=2,
              backend="gloo", timeout=3, join_timeout=60)
    assert time.monotonic() - t0 < 45
    assert "--- rank 1" in str(e.value)


def test_launch_starts_ranks_over_gloo(tmp_path):
    """``launch --nproc_per_node 2 --backend gloo``: two ranks, their
    global ranks and the backend from the launcher."""
    script = tmp_path / "rank.py"
    script.write_text(textwrap.dedent("""
        import torch
        import paddle_tpu_torch.distributed as dist
        env = dist.init_parallel_env()
        t = torch.full((2,), float(env.rank + 1))
        dist.all_reduce(t)
        print("RANK", env.rank, env.world_size, env.local_rank,
              dist.parallel.backend(), t.tolist(), flush=True)
    """))
    logs = tmp_path / "logs"
    env = dict(os.environ, PYTHONPATH=_REPO)
    for k in ("PADDLE_TRAINER_ID", "PADDLE_TRAINERS_NUM",
              "PADDLE_TRAINER_ENDPOINTS", "PADDLE_DISTRI_BACKEND"):
        env.pop(k, None)
    port = worker_port()
    out = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
         "--nproc_per_node", "2", "--backend", "gloo", "--timeout", "90",
         "--coordinator_port", str(port), "--log_dir", str(logs),
         str(script)], env=env, cwd=_REPO, capture_output=True, text=True,
        timeout=120)
    assert out.returncode == 0, out.stderr
    lines = sorted(open(logs / f"worker.{r}.log").read().split("RANK")[-1]
                   .split() for r in range(2))
    assert lines == [["0", "2", "0", "gloo", "[3.0,", "3.0]"],
                     ["1", "2", "1", "gloo", "[3.0,", "3.0]"]]


def worker_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_refusals_name_queue_item_4():
    """ep still names queue item 4 (part 2c); tp, pp and sp are ported:
    ``split`` without a mesh is the whole layer, and a one-process mesh
    takes their degrees over its devices."""
    with pytest.raises(NotImplementedError, match="queue item 4, part 2c"):
        tmesh.init_mesh({"ep": 2}, devices=["cpu", "cpu"])
    torch.manual_seed(0)
    y = tdist.split(torch.ones(2, 8), (8, 16), "linear", axis=1)
    assert y.shape == (2, 16)
    m = tmesh.init_mesh({"tp": 2}, devices=["cpu", "cpu"])
    assert m.shape["tp"] == 2 and not m.distributed
    with pytest.raises(RuntimeError, match="init_parallel_env"):
        tdist.all_reduce(torch.ones(2))
    # no process group: the mesh is this process's one device
    tmesh.set_mesh(None)
    m = tmesh.init_mesh({"dp": -1}, devices=["cpu"])
    assert m.shape["dp"] == 1 and not m.distributed
    assert tmesh.batch_spec(8, m) == slice(0, 8)
    tmesh.set_mesh(None)
