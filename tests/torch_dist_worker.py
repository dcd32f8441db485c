"""Rank-side cases of the port's collective tests
(``tests/test_torch_{collective,zero,zero_ranks,dgc}.py``): each
function runs in every rank process that
``paddle_tpu_torch.distributed.spawn`` starts (gloo on the CPU), after
``init_parallel_env``, and returns numpy results for the test to hold
against the JAX package.  Imports torch and the port only."""
import time

import numpy as np
import torch

import paddle_tpu_torch.distributed as dist
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.distributed import communication as comm
from paddle_tpu_torch.distributed import mesh as mesh_mod
from paddle_tpu_torch.distributed.collective import shard_map
from paddle_tpu_torch.distributed.fleet import (DistributedStrategy,
                                                DistributedTrainStep)


def _np(t):
    return t.detach().cpu().numpy().copy()


# -- collectives ---------------------------------------------------------

def collective_cases(payload):
    r, n = dist.get_rank(), dist.get_world_size()
    out = {"rank": r, "world": n}
    t = torch.ones(4)
    dist.all_reduce(t)
    out["all_reduce"] = _np(t)
    for op, name in ((dist.ReduceOp.MAX, "max"), (dist.ReduceOp.MIN, "min"),
                     (dist.ReduceOp.PROD, "prod")):
        t = torch.full((2, 2), float(r + 1))
        dist.all_reduce(t, op=op)
        out[name] = _np(t)
    g = dist.new_group(list(range(min(n, 2))))
    t = torch.full((2,), 3.0 + r)
    if r < 2:
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=g)
    out["group_max"] = _np(t)
    lst = []
    dist.all_gather(lst, torch.arange(3, dtype=torch.float32) + 10 * r)
    out["all_gather"] = np.stack([_np(x) for x in lst])
    t = torch.full((3,), float(r))
    dist.broadcast(t, src=n - 1)
    out["broadcast"] = _np(t)
    dist.barrier()
    t = torch.arange(2 * n, dtype=torch.float32) * (r + 1)
    out["reduce_scatter"] = _np(dist.reduce_scatter(t))
    t = torch.full((2,), float(r))
    dist.reduce(t, dst=0)
    out["reduce"] = _np(t)
    t = torch.zeros(2)
    dist.scatter(t, [torch.full((2,), float(j)) for j in range(n)]
                 if r == 0 else None, src=0)
    out["scatter"] = _np(t)
    got = []
    dist.alltoall([torch.full((1,), float(10 * r + j)) for j in range(n)],
                  got)
    out["alltoall"] = np.concatenate([_np(x) for x in got])
    t = torch.full((2,), float(r))
    if r == 0:
        dist.send(torch.full((2,), 42.0), dst=1)
    elif r == 1:
        dist.recv(t, src=0)
    out["send_recv"] = _np(t)
    # named-axis collectives over an all-dp mesh
    mesh_mod.init_mesh({"dp": n})
    x = torch.tensor([float(r + 1), 2.0 * (r + 1)])
    out["psum"] = _np(comm.psum(x, "dp"))
    out["pmean"] = _np(comm.pmean(x, "dp"))
    out["pmax"] = _np(comm.pmax(x, "dp"))
    out["pmin"] = _np(comm.pmin(x, "dp"))
    out["pprod"] = _np(comm.pprod(x, "dp"))
    out["gather_tiled"] = _np(comm.all_gather(x, "dp", tiled=True))
    out["gather_stacked"] = _np(comm.all_gather(x, "dp"))
    out["rs"] = _np(comm.reduce_scatter(
        torch.arange(2.0 * n) * (r + 1), "dp"))
    out["ppermute"] = _np(comm.ppermute(x, "dp", [(0, n - 1)]))
    out["ring_shift"] = _np(comm.ring_shift(x, "dp", 1))
    out["all_to_all"] = _np(comm.all_to_all(
        torch.arange(float(n)) + 100 * r, "dp", split_dim=0, concat_dim=0))
    out["axis"] = (comm.axis_index("dp"), comm.axis_size("dp"))
    out["broadcast_from"] = _np(comm.broadcast_from(x, "dp", root=n - 1))
    # the reference's shard_map test at n ranks
    xs = torch.arange(float(n)).reshape(n, 1)

    def f(blk):
        return (comm.psum(blk, "dp"), comm.all_gather(blk, "dp", tiled=True),
                torch.tensor([comm.axis_index("dp")]),
                comm.ring_shift(blk, "dp", 1))

    spec = ("dp",)
    res = shard_map(f, in_specs=(spec,), out_specs=(spec,) * 4)(xs)
    out["shard_map"] = [_np(y) for y in res]
    bc = shard_map(lambda v: comm.broadcast_from(v, "dp", root=n - 1),
                   in_specs=(spec,), out_specs=spec)(torch.arange(float(n)))
    out["shard_map_broadcast"] = _np(bc)
    # the mesh's axis groups at dp x fsdp
    if n % 2 == 0:
        m = mesh_mod.init_mesh({"dp": n // 2, "fsdp": 2})
        v = torch.full((1,), float(r))
        out["mesh"] = dict(coords=m.coords, fsdp=m.axis_ranks("fsdp"),
                           dp=m.axis_ranks("dp"),
                           data=m.axis_ranks(mesh_mod.DATA),
                           sum_fsdp=float(comm.psum(v, "fsdp")[0]),
                           sum_dp=float(comm.psum(v, "dp")[0]),
                           sum_data=float(comm.psum(v, mesh_mod.DATA)[0]),
                           rows=mesh_mod.batch_spec(16))
    # DataParallel against one device: the reference's test at n ranks
    mesh_mod.init_mesh({"dp": n})
    w = payload["dp_weights"]
    model = torch.nn.Sequential(tnn.Linear(16, 32, device="cpu"),
                                tnn.ReLU(), tnn.Linear(32, 4, device="cpu"))
    with torch.no_grad():
        for k, v in model.state_dict().items():
            v.copy_(torch.from_numpy(w[k]))
    from paddle_tpu_torch.optimizer import SGD
    opt = SGD(0.1, parameters=list(model.parameters()))
    dp = dist.DataParallel(model)
    rows = mesh_mod.batch_spec(16)
    for xb, yb in zip(payload["dp_x"], payload["dp_y"]):
        xb = dist.global_batch(xb[rows])
        yb = dist.global_batch(yb[rows])
        loss = ((dp(xb) - yb) ** 2).mean()
        loss.backward()
        opt.step()
        opt.clear_grad()
    out["dp_params"] = {k: _np(v) for k, v in model.state_dict().items()}
    # a collective fleet.init over dp x fsdp degrees
    from paddle_tpu_torch.distributed import fleet
    s = DistributedStrategy()
    s.sharding = True
    s.sharding_configs = {"sharding_degree": 2}
    f = fleet.Fleet().init(is_collective=True, strategy=s)
    out["fleet_mesh"] = dict(f._mesh.shape)
    out["fleet_workers"] = f.worker_num()
    out["fleet_model"] = type(f.distributed_model(model)).__name__
    return out


def hang_case(payload):
    """Rank 1 never joins the all-reduce: rank 0's wait is bounded by the
    group's timeout."""
    if dist.get_rank() == 1:
        time.sleep(payload["sleep"])
    t = torch.ones(2)
    dist.all_reduce(t)
    return _np(t)


# -- the train step over dp x fsdp ---------------------------------------

def _mlp(weights, sizes, act):
    layers = []
    for i in range(len(sizes) - 1):
        layers.append(tnn.Linear(sizes[i], sizes[i + 1], device="cpu"))
        if i < len(sizes) - 2:
            layers.append(act())
    model = torch.nn.Sequential(*layers)
    with torch.no_grad():
        for k, v in model.state_dict().items():
            v.copy_(torch.from_numpy(weights[k]))
    return model


def train_case(case):
    """One configuration: ``case`` has weights, sizes, act ("gelu",
    "relu", "tanh"), loss ("mse", "ce", "ce_mean"), opt, lr, strategy
    settings, mesh degrees and the global batches."""
    from paddle_tpu_torch import optimizer as topt
    from paddle_tpu_torch.nn import functional as F
    act = {"gelu": tnn.GELU, "relu": tnn.ReLU, "tanh": tnn.Tanh}[case["act"]]
    model = _mlp(case["weights"], case["sizes"], act)
    kw = dict(case.get("opt_kw", {}))
    if "clip" in case:
        from paddle_tpu_torch.nn import clip as tclip
        kw["grad_clip"] = getattr(
            tclip, case.get("clip_kind", "ClipGradByGlobalNorm"))(case["clip"])
    opt = getattr(topt, case["opt"])(learning_rate=case["lr"],
                                     parameters=list(model.parameters()),
                                     **kw)
    s = DistributedStrategy()
    for k, v in case.get("strategy", {}).items():
        setattr(s, k, v)
    mesh = mesh_mod.init_mesh(case["mesh"]) if case.get("mesh") else None

    def loss_fn(x, y):
        out = model(x)
        if case["loss"] == "mse":
            return ((out - y) ** 2).mean()
        return F.cross_entropy(out, y).mean()

    step = DistributedTrainStep(model, loss_fn, opt, s, mesh=mesh)
    loaded = None
    if "load_state" in case:
        from paddle_tpu_torch.framework.io import (load_jax_opt_state,
                                                   opt_state_arrays)
        load_jax_opt_state(opt, model, case["load_state"], step=step)
        loaded = dict(
            rows={n: {k: _np(v) for k, v in
                      opt._accumulators[id(p)].items()}
                  for n, p in zip(step._names, step._params)},
            whole=opt_state_arrays(opt, model, step=step),
            fsdp_index=step._fsdp_index)
    m = step._mesh
    rows = mesh_mod.batch_spec(len(case["xs"][0]), m) if m is not None \
        and m.distributed else slice(None)
    losses, masks = [], []
    for x, y in zip(case["xs"], case["ys"]):
        losses.append(float(step(torch.from_numpy(x[rows]),
                                 torch.from_numpy(y[rows]))))
        if step.last_dgc_masks is not None:
            masks.append({k: int(v.sum()) for k, v in
                          step.last_dgc_masks.items()})
            step.last_dgc_masks = None
    held = {n: (int(p.numel()), {k: int(v.numel()) for k, v in
                                 opt._accumulators[id(p)].items()})
            for n, p in zip(step._names, step._params)}
    return dict(losses=losses,
                params={k: _np(v) for k, v in
                        step.full_parameters().items()},
                held=held, specs=dict(step.param_specs),
                slot_specs=dict(step.slot_specs),
                slot_dtypes={n: {k: str(v.dtype) for k, v in
                                 opt._accumulators[id(p)].items()}
                             for n, p in zip(step._names, step._params)},
                masks=masks, loaded=loaded,
                dgc=({k: (_np(step._dgc_state["u"][k]),
                          _np(step._dgc_state["v"][k]))
                      for k in step._names}
                     if step._dgc_state is not None else None))


def train_cases(cases):
    return [train_case(c) for c in cases]



# -- the Llama step over tp, sp and pp -----------------------------------

def llama_case(case):
    """One layout: the Llama model built under ``case["mesh"]`` holds its
    blocks of the JAX weights (``load_jax_blocks``); this rank's loss and
    reduced gradients (summed over sp, the mean over the data axes) at
    the weights, then ``steps`` steps of the strategy's step, the first
    one's ``guard_health`` norm of its reduced gradient.  Blocks come
    back with their specs, for ``gather_blocks``."""
    from paddle_tpu_torch import optimizer as topt
    from paddle_tpu_torch.distributed.spec_layout import get_layout
    from paddle_tpu_torch.framework.io import load_jax_blocks, param_specs
    from paddle_tpu_torch.text.models import LlamaForCausalLM, llama_tiny
    from paddle_tpu_torch.text.models import llama
    mesh = mesh_mod.init_mesh(case["mesh"])
    model = LlamaForCausalLM(llama_tiny(**case["cfg"]), device="cpu")
    load_jax_blocks(model, case["weights"])
    chunked = []
    if case.get("chunk_bytes_min") is not None:
        # the chunked LM loss at a tiny size: its threshold lowered here
        llama._CHUNK_BYTES_MIN = case["chunk_bytes_min"]
        plain_nll = llama._chunked_nll

        def counted(*a):
            chunked.append(tuple(a[2].shape))
            return plain_nll(*a)
        llama._chunked_nll = counted
    opt = getattr(topt, case.get("opt", "AdamW"))(
        learning_rate=case.get("lr", 1e-3),
        parameters=list(model.parameters()))
    s = DistributedStrategy()
    for k, v in case.get("strategy", {}).items():
        setattr(s, k, v)
    step = DistributedTrainStep(model, lambda a, b: model(a, labels=b)[0],
                                opt, s, mesh=mesh, guard_health=True)
    ids = case["ids"]
    x = torch.from_numpy(ids[mesh_mod.batch_spec(len(ids), mesh)])
    loss, grads = step.loss_and_grads(x, x)
    grads = step._reduce(list(grads))
    out = dict(rank=dist.get_rank(), coords=mesh.coords,
               loss=float(step._mean_loss(loss)),
               grads={n: _np(g) for n, g in zip(step._names, grads)},
               grad_specs=dict(step.slot_specs), losses=[])
    for _ in range(case["steps"]):
        out["losses"].append(float(step(x, x)))
        # the first step's: its gradient is the one at the weights
        out.setdefault("health_norm", float(step.last_health[0]))
    out["params"] = {n: _np(v) for n, v in step.full_parameters().items()}
    out["chunked"] = chunked
    out["param_specs"] = param_specs(model)
    lay = get_layout()
    out["held"] = [
        (n, p.numel() == lay.sharded_numel(g, step.param_specs[n],
                                           mesh.shape)
         and all(v.numel() == lay.sharded_numel(g, step.slot_specs[n],
                                                mesh.shape)
                 for v in opt._accumulators[id(p)].values()
                 if v.dim() and tuple(v.shape) == tuple(p.shape)))
        for n, p, g in zip(step._names, step._params, step._global_shapes)]
    return out


def llama_cases(cases):
    torch.set_num_threads(1)
    return [llama_case(c) for c in cases]


# -- the tensor-parallel layers, split -------------------------------------

def _blocks(layer, arrays, mesh):
    from paddle_tpu_torch.distributed.meta_parallel import block_of
    with torch.no_grad():
        for n, p in layer.named_parameters():
            a = arrays[n]
            spec = getattr(p, "dist_spec", None) or (None,) * a.ndim
            p.copy_(torch.from_numpy(np.ascontiguousarray(
                block_of(a, spec, mesh))))


def meta_parallel_case(case):
    """The three layers at ``case["mesh"]``: outputs, and the gradients of
    sum(y^2) (their blocks, with specs) and of the input."""
    from paddle_tpu_torch.distributed import meta_parallel as mp
    from paddle_tpu_torch.framework.io import param_specs
    mesh = mesh_mod.init_mesh(case["mesh"])
    gather = case["gather"]
    col = mp.ColumnParallelLinear(16, 64, gather_output=gather, device="cpu")
    row = mp.RowParallelLinear(64, 16, input_is_parallel=not gather,
                               device="cpu")
    emb = mp.VocabParallelEmbedding(64, 8, device="cpu")
    for layer, pre in ((col, "col."), (row, "row."), (emb, "emb.")):
        _blocks(layer, {k[len(pre):]: v for k, v in case["weights"].items()
                        if k.startswith(pre)}, mesh)
    x = torch.from_numpy(case["x"]).requires_grad_()
    y = row(col(x))
    (y * y).sum().backward()
    e = emb(torch.from_numpy(case["ids"]))
    (e * torch.from_numpy(case["e_ct"])).sum().backward()
    grads, specs = {}, {}
    for layer, pre in ((col, "col."), (row, "row."), (emb, "emb.")):
        for n, p in layer.named_parameters():
            grads[pre + n] = _np(p.grad)
            specs[pre + n] = param_specs(layer)[n]
    return dict(rank=dist.get_rank(), coords=mesh.coords, y=_np(y),
                e=_np(e), x_grad=_np(x.grad), grads=grads, specs=specs,
                split=(col.split(), row.split()))


def split_case(case):
    """``distributed.split``'s three cases from one seed on every rank."""
    mesh_mod.init_mesh(case["mesh"])
    x = torch.from_numpy(case["x"])
    out = {}
    for name, kw in (("col", dict(size=(8, 16), operation="linear",
                                  axis=1, gather_out=True)),
                     ("row", dict(size=(8, 16), operation="linear",
                                  axis=0)),
                     ("emb", dict(size=(64, 8), operation="embedding"))):
        torch.manual_seed(5)
        arg = torch.from_numpy(case["ids"]) if name == "emb" else x
        out[name] = _np(dist.split(arg, num_partitions=2, **kw))
    return out


def fleet_case(case):
    """A collective ``fleet.init`` over the strategy's tp degree: the mesh
    it installs."""
    from paddle_tpu_torch.distributed import fleet
    s = DistributedStrategy()
    for k, v in case["strategy"].items():
        setattr(s, k, v)
    f = fleet.Fleet().init(is_collective=True, strategy=s)
    return dict(shape=dict(f._mesh.shape), coords=f._mesh.coords,
                tp_ranks=f._mesh.axis_ranks("tp"))


def meta_parallel_cases(cases):
    torch.set_num_threads(1)
    return [{"layers": meta_parallel_case, "split": split_case,
             "llama": llama_case, "fleet": fleet_case}[c["kind"]](c)
            for c in cases]


# -- ring and Ulysses attention ------------------------------------------

def ring_case(case):
    """Ring or Ulysses attention on the global (B, S, H, D) arrays: the
    whole output and this rank's part of the inputs' gradients of
    sum(out^2) (the ranks' parts sum to the gradient); or the model's
    logits under context parallelism; or the refusals."""
    from paddle_tpu_torch.ops import ring_attention as ra
    mesh = mesh_mod.init_mesh(case["mesh"])
    if case["kind"] == "llama":
        from paddle_tpu_torch.framework.io import load_jax_blocks
        from paddle_tpu_torch.text.models import LlamaForCausalLM, llama_tiny
        model = LlamaForCausalLM(llama_tiny(**case["cfg"]), device="cpu")
        load_jax_blocks(model, case["weights"])
        ids = case["ids"]
        n, r = mesh.shape["sp"], mesh.coords["sp"]
        blk = ids.shape[1] // n
        with torch.no_grad():
            logits = model(torch.from_numpy(
                ids[:, r * blk:(r + 1) * blk].copy()))
        return dict(logits=_np(comm.all_gather(logits, "sp", tiled=True,
                                               gather_dim=1)))
    if case["kind"] == "refusals":
        got = {}
        for name, fn, (b, s, h) in (("ulysses_heads", ra.ulysses_attention,
                                     (1, 16, 2)),
                                    ("ring_seq", ra.ring_attention,
                                     (1, 6, 2))):
            q = torch.zeros(b, s, h, 4)
            try:
                fn(q, q, q)
                got[name] = None
            except ValueError as e:
                got[name] = str(e)
        return got
    fn = ra.ring_attention if case["kind"] == "ring" else \
        ra.ulysses_attention
    q, k, v = [torch.from_numpy(a).requires_grad_() for a in case["qkv"]]
    out = fn(q, k, v, causal=case["causal"])
    (out * out).sum().backward()
    return dict(out=_np(out), grads=[_np(t.grad) for t in (q, k, v)])


def ring_cases(cases):
    torch.set_num_threads(1)
    return [ring_case(c) for c in cases]


# -- GPipe and 1F1B ------------------------------------------------------

def _tanh_stage(p, h):
    w, b = p
    for i in range(w.shape[0]):
        h = torch.tanh(h @ w[i] + b[i])
    return h


def _mse(h, y):
    return ((h - y) ** 2).mean()


def pipeline_case(case):
    """The reference's stacked tanh-linear block over ``pp``: GPipe's
    output, loss and gradients (this stage's layers, the input), then
    1F1B's loss and gradients, both at ``M`` microbatches."""
    from paddle_tpu_torch.distributed import pipeline as pl
    if case["kind"] == "llama":
        return llama_case(case)
    mesh = mesh_mod.init_mesh(case["mesh"])
    S, s = mesh.shape["pp"], mesh.coords["pp"]
    w, b = case["w"], case["b"]
    per = w.shape[0] // S
    wl = torch.from_numpy(w[s * per:(s + 1) * per].copy()).requires_grad_()
    bl = torch.from_numpy(b[s * per:(s + 1) * per].copy()).requires_grad_()
    x = torch.from_numpy(case["x"]).requires_grad_()
    y = torch.from_numpy(case["y"])
    M = case["M"]
    out = pl.pipeline_apply(lambda p, h, e: _tanh_stage(p, h), (wl, bl), x,
                            num_microbatches=M, mesh=mesh)
    loss = _mse(out, y)
    loss.backward()
    loss2, (dw, db), dx = pl.pipeline_train_1f1b(
        _tanh_stage, (wl.detach(), bl.detach()), x.detach(), y, _mse,
        num_microbatches=M, mesh=mesh)
    return dict(stage=s, per=per, out=_np(out), loss=float(loss.detach()),
                dw=_np(wl.grad), db=_np(bl.grad), dx=_np(x.grad),
                f_loss=float(loss2), f_dw=_np(dw), f_db=_np(db),
                f_dx=_np(dx))


def pipeline_cases(cases):
    torch.set_num_threads(1)
    return [pipeline_case(c) for c in cases]
