"""The port's Llama ``DistributedTrainStep`` over the model axes against
the JAX step on the same mesh: tp 2, sp 2 (ring and Ulysses), pp 2
(GPipe), tp 2 x pp 2 and fsdp 2 x pp 2 at ZeRO-3 -- the layouts
``chip_smoke.py`` phases 48-51 run at the proxy's width.

The port's side runs as gloo rank processes on the CPU: one world of 2
for the first four layouts and one of 4 for the last two, both started
once for the module (``spawn``), the case in
``tests/torch_dist_worker.py`` (``llama_case``).  Each rank builds the
stacked ``llama_tiny`` (f32, remat) under the mesh, loads its blocks of
the JAX weights (``load_jax_blocks``), takes its loss and reduced
gradients, then two AdamW steps.  The JAX side (``torch_llama_ref``):
the reference model's eager loss and gradients on the same mesh of the
virtual devices, and its step's losses (one run: every layout has the
same weights and batch, and the global view makes them the same on any
mesh).  Tolerances (f32): loss and step
losses within 1e-5 relative; every gradient, gathered from the ranks'
blocks (``gather_blocks``, which also holds the ranks that share a
block to bitwise equality), within 1e-4 of its largest entry."""
import numpy as np
import pytest

import paddle_tpu as paddle
from paddle_tpu.distributed import mesh as jmesh
from paddle_tpu.text.models import LlamaForCausalLM as JLlama
from paddle_tpu.text.models import llama_tiny as jtiny

from paddle_tpu_torch.distributed.spawn import spawn

import torch_dist_worker as worker
from torch_llama_ref import check_llama, jax_llama

BASE = dict(compute_dtype="float32", scan_layers=True, remat=True)


def _case(mesh, cfg=None, strategy=None, shape=(4, 32)):
    cfg = dict(BASE, **(cfg or {}))
    paddle.seed(0)
    m = JLlama(jtiny(**cfg))
    return dict(mesh=mesh, cfg=cfg, strategy=strategy or {}, steps=2,
                weights={k: np.asarray(v._value).copy()
                         for k, v in m.state_dict().items()},
                ids=np.random.RandomState(0).randint(
                    0, 256, shape).astype("int32"))


# the chunked LM loss under tp 2: 1,024 positions (S - 1 >= 512), its
# byte threshold lowered in the ranks to the logits' 2 MiB; the head's
# weight is gathered whole before the chunks
CHUNKED = dict(_case({"tp": 2}, {"max_position_embeddings": 1024},
                     shape=(2, 1024)), chunk_bytes_min=2 * 1024 * 256 * 4)


PP = {"pp_num_microbatches": 2}
WORLD2 = [_case({"tp": 2}, strategy={"tensor_parallel": True}),
          _case({"sp": 2}, {"sequence_parallel": True,
                            "context_parallel": "ring"},
                {"sequence_parallel": True}),
          _case({"sp": 2}, {"sequence_parallel": True,
                            "context_parallel": "ulysses"},
                {"sequence_parallel": True}),
          _case({"pp": 2}, PP, {"pipeline": True}), CHUNKED]
WORLD4 = [_case({"tp": 2, "pp": 2}, PP),
          _case({"fsdp": 2, "pp": 2}, PP,
                {"sharding": True, "sharding_configs": {"stage": 3}})]


@pytest.fixture(scope="module")
def ranks():
    ctx = [spawn(worker.llama_cases, args=(cases,), nprocs=n,
                 backend="gloo", timeout=60, join=False)
           for n, cases in ((2, WORLD2), (4, WORLD4))]
    got = {}

    def get(n):
        if n not in got:
            got[n] = ctx[0 if n == 2 else 1].join(300)
        return got[n]
    yield get
    for c in ctx:
        c.close()


@pytest.fixture(autouse=True)
def _fresh_mesh():
    jmesh.set_mesh(None)
    yield
    jmesh.set_mesh(None)


@pytest.fixture(scope="module")
def step_losses():
    """Every layout's weights and batch are the same, and so are the JAX
    step's losses on any mesh (the global view): its two steps on one
    device, computed once."""
    jmesh.set_mesh(None)
    _, _, losses = jax_llama(dict(WORLD2[0], mesh={"dp": 1}))
    jmesh.set_mesh(None)
    return losses


@pytest.mark.parametrize("i,name", [(0, "tp2"), (1, "sp2_ring"),
                                    (2, "sp2_ulysses"), (3, "pp2")])
def test_world2_layouts_match_jax(ranks, step_losses, i, name):
    got = [r[i] for r in ranks(2)]
    check_llama(got, WORLD2[i], step_losses)
    if name == "pp2":
        # each stage holds its layer of the two
        assert got[0]["grads"]["model.decoder.self_attn__q_proj__weight"] \
            .shape[0] == 1


def test_chunked_loss_under_tp_gathers_the_head(ranks):
    """The chunked LM loss's branch under tp 2 (threshold lowered in the
    ranks): it ran on the whole [H, V] head on every call, and the loss,
    gradients and steps match the JAX model's (f32: the chunks' sums are
    the plain loss's)."""
    got = [r[4] for r in ranks(2)]
    for r in got:
        assert r["chunked"] and set(r["chunked"]) == {(64, 256)}
    check_llama(got, CHUNKED)


@pytest.mark.parametrize("i,name", [(0, "tp2_pp2"), (1, "fsdp2_pp2")])
def test_world4_layouts_match_jax(ranks, step_losses, i, name):
    got = [r[i] for r in ranks(4)]
    check_llama(got, WORLD4[i], step_losses)


def test_strategy_toggles_map_to_the_mesh():
    from paddle_tpu.distributed.fleet import DistributedStrategy as JS
    from paddle_tpu_torch.distributed.fleet import DistributedStrategy
    from paddle_tpu_torch.distributed.fleet.strategy import \
        IMPLEMENTED_TOGGLES
    for kw in ({"tensor_parallel": True,
                "tensor_parallel_configs": {"tensor_parallel_degree": 2}},
               {"sequence_parallel": True,
                "sequence_parallel_configs": {"sequence_parallel_degree": 4,
                                              "mode": "ulysses"}},
               {"hybrid_configs": {"mp_degree": 2, "pp_degree": 2,
                                   "sep_degree": 2, "dp_degree": -1}},
               {"pipeline": True,
                "pipeline_configs": {"schedule_mode": "F-then-B"}}):
        a, b = JS(), DistributedStrategy()
        for k, v in kw.items():
            setattr(a, k, v)
            setattr(b, k, v)
        assert b.mesh_degrees() == a.mesh_degrees(), kw
    for t in ("pipeline", "tensor_parallel", "sequence_parallel"):
        assert t in IMPLEMENTED_TOGGLES
