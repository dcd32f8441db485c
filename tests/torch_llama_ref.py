"""The JAX side of the port's Llama step tests over tp, sp and pp
(``tests/test_torch_{meta_parallel,pipeline,hybrid}.py``): the JAX model
on the case's mesh of the virtual CPU devices, and the check that holds
the port's ranks (``torch_dist_worker.llama_case``) to it."""
import contextlib

import numpy as np

import jax
import paddle_tpu as paddle
from paddle_tpu.distributed import mesh as jmesh
from paddle_tpu.distributed.fleet import DistributedStrategy as JStrategy
from paddle_tpu.distributed.fleet import DistributedTrainStep as JStep
from paddle_tpu.framework import flags as jflags
from paddle_tpu.text.models import LlamaForCausalLM as JLlama
from paddle_tpu.text.models import llama_tiny as jtiny

from paddle_tpu_torch.framework.io import gather_blocks

AXES = ("dp", "fsdp", "pp", "tp", "sp", "ep")


def mesh_shape(mesh):
    """Every axis's size of a degrees dict (missing axes 1)."""
    return dict(dict.fromkeys(AXES, 1), **mesh)


@contextlib.contextmanager
def eager_uncached():
    """The reference's eager op cache off for the block: it keys an op's
    jitted (out, vjp) pair without the mesh, so a pair built by an
    earlier test on another mesh of the same shapes would put this
    call's activations on that mesh's devices."""
    key = "FLAGS_eager_vjp_cache"
    prev = jflags.get_flags(key)[key]
    jflags.set_flags({key: False})
    try:
        yield
    finally:
        jflags.set_flags({key: prev})


def jax_llama(case, steps=True):
    """The JAX model's loss and gradients (eager, on the case's mesh) and
    its step's losses (same mesh, same strategy; None without
    ``steps``)."""
    n = int(np.prod(list(case["mesh"].values())))
    mesh = jmesh.init_mesh(case["mesh"], devices=jax.devices()[:n])
    m = JLlama(jtiny(**case["cfg"]))
    m.set_state_dict({k: paddle.to_tensor(v)
                      for k, v in case["weights"].items()})
    ids = paddle.to_tensor(case["ids"])
    with eager_uncached():
        loss, _ = m(ids, labels=ids)
        loss.backward()
    grads = {k: np.asarray(p.grad._value) for k, p in m.named_parameters()}
    if not steps:
        return float(loss._value), grads, None
    m.clear_gradients()
    opt = paddle.optimizer.AdamW(learning_rate=1e-3,
                                 parameters=m.parameters())
    s = JStrategy()
    for k, v in case.get("strategy", {}).items():
        setattr(s, k, v)
    step = JStep(m, lambda a, b: m(a, labels=b)[0], opt, s, mesh=mesh)
    losses = [float(step(ids, ids)._value) for _ in range(case["steps"])]
    return float(loss._value), grads, losses


def check_llama(got, case, losses=None):
    """The ranks' loss, gradients (gathered) and step losses against the
    JAX model on the same mesh (the step's losses: ``losses`` where the
    caller has them from a JAX step of the same weights and batch); every
    rank holds ``sharded_numel``; the first step's ``guard_health`` norm
    on every rank is the norm of JAX's gradient (1e-4 relative)."""
    loss, grads, jl = jax_llama(case, steps=losses is None)
    losses = jl if losses is None else losses
    for r in got:
        np.testing.assert_allclose(r["loss"], loss, rtol=1e-5)
        np.testing.assert_allclose(r["losses"], losses, rtol=1e-5)
        assert all(h[1] for h in r["held"]), r["held"]
    whole = gather_blocks([r["grads"] for r in got], got[0]["grad_specs"],
                          mesh_shape(case["mesh"]))
    assert sorted(whole) == sorted(grads)
    for k, v in grads.items():
        np.testing.assert_allclose(whole[k], v, rtol=0,
                                   atol=1e-4 * np.abs(v).max() + 1e-9,
                                   err_msg=k)
    # the step's own norm over its split gradients (guard_health): what
    # chip_smoke.py holds against world 1 to see a stray factor of an axis
    norm = np.sqrt(sum(float(np.sum(np.square(v, dtype=np.float64)))
                       for v in grads.values()))
    for r in got:
        np.testing.assert_allclose(r["health_norm"], norm, rtol=1e-4)
