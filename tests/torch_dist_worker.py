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

