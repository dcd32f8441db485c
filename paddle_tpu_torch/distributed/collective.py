"""The user-facing collective API (counterpart of
``paddle_tpu/distributed/collective.py``): ``ReduceOp``, ``Group``,
``new_group``, ``get_group``, ``all_reduce``, ``reduce``, ``all_gather``,
``reduce_scatter``, ``broadcast``, ``scatter``, ``alltoall``, ``send``,
``recv``, ``barrier``, ``wait``, ``split`` and ``shard_map``.

Each rank is a process (``init_parallel_env``) and each call is a
``torch.distributed`` collective over the group's ranks, with the
reference's eager semantics: a tensor that every rank holds is summed
over the ranks (``all_reduce``); ``reduce`` leaves the result on every
rank, as the reference's replicated view does; ``reduce_scatter``
returns this rank's block of dim 0.  ``src`` / ``dst`` are global ranks,
as in Paddle.

**Staging on gloo.** Gloo's CUDA support differs between collectives
and releases, so on a gloo group every collective stages CUDA tensors
through host memory (a copy to the CPU, the collective there, a copy
back): by backend, always, never by a probe.  On gloo ``reduce_scatter``
is an all-reduce of which each rank keeps its block, and ``alltoall`` an
all-gather of which each rank keeps its column; NCCL runs both natively.
A group of one rank in a larger world needs no communicator: every
collective over it is the identity.

``shard_map(f, mesh, in_specs, out_specs)`` is the per-rank application
of the reference's ``jax.shard_map``: each rank cuts its block of every
input by ``in_specs``, runs ``f`` on the blocks (``f`` may call the
named-axis collectives of :mod:`.communication`), and the blocks of each
output are assembled by ``out_specs`` (all-gathered along every split
dim), so every rank returns the whole output.

``split`` makes and applies one of the tensor-parallel layers of
:mod:`.meta_parallel`.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch

__all__ = [
    "ReduceOp", "Group", "new_group", "get_group", "wait", "barrier",
    "all_reduce", "all_gather", "reduce", "reduce_scatter", "broadcast",
    "scatter", "alltoall", "send", "recv", "split", "shard_map",
]


class ReduceOp:
    """Paddle's reduce operations."""
    SUM = 0
    MAX = 1
    MIN = 2
    PROD = 3


def _dist():
    import torch.distributed as dist
    return dist


def _op(op):
    d = _dist()
    return {ReduceOp.SUM: d.ReduceOp.SUM, ReduceOp.MAX: d.ReduceOp.MAX,
            ReduceOp.MIN: d.ReduceOp.MIN,
            ReduceOp.PROD: d.ReduceOp.PRODUCT}[op]


def _require():
    from .parallel import is_initialized
    if not is_initialized():
        raise RuntimeError("a collective needs the world's process group: "
                           "call paddle_tpu_torch.distributed."
                           "init_parallel_env() in every rank first")


def _pg(group):
    """The torch process group of ``group`` (a :class:`Group`, a process
    group, a group id or None for the world)."""
    if isinstance(group, Group):
        return group.process_group
    if group is None or group == 0:
        return _dist().group.WORLD
    if isinstance(group, int):
        return get_group(group).process_group
    return group


def _size(pg) -> int:
    return 1 if pg is None else _dist().get_world_size(pg)


def _gloo(pg) -> bool:
    return _dist().get_backend(pg) == "gloo"


def _world_rank(pg, i: int) -> int:
    """The global rank of group rank ``i``."""
    d = _dist()
    if pg is None or pg is d.group.WORLD:
        return i
    return d.get_global_rank(pg, i)


# -- the collectives the package itself runs (pg: a process group, or
# None for a one-rank axis) ----------------------------------------------

def _all_reduce(t: torch.Tensor, op, pg) -> torch.Tensor:
    """In place over ``pg``."""
    if pg is None:
        return t
    if _gloo(pg) and t.is_cuda:
        h = t.cpu()
        _dist().all_reduce(h, _op(op), pg)
        t.copy_(h)
    else:
        _dist().all_reduce(t, _op(op), pg)
    return t


def _all_gather(t: torch.Tensor, pg) -> List[torch.Tensor]:
    """Every rank's ``t``, in group-rank order."""
    if pg is None:
        return [t]
    n = _size(pg)
    if _gloo(pg) and t.is_cuda:
        h = t.detach().cpu().contiguous()
        out = [torch.empty_like(h) for _ in range(n)]
        _dist().all_gather(out, h, pg)
        return [o.to(t.device) for o in out]
    out = [torch.empty_like(t) for _ in range(n)]
    _dist().all_gather(out, t.contiguous(), pg)
    return out


def _reduce_scatter(t: torch.Tensor, dim: int, pg) -> torch.Tensor:
    """The sum over ``pg`` of ``t``, this rank's block of ``dim``."""
    if pg is None:
        return t
    n = _size(pg)
    me = _dist().get_rank(pg)
    if _gloo(pg):
        s = t.clone()
        _all_reduce(s, ReduceOp.SUM, pg)
        return s.chunk(n, dim)[me].contiguous()
    parts = [c.contiguous() for c in t.chunk(n, dim)]
    out = torch.empty_like(parts[me])
    _dist().reduce_scatter(out, parts, op=_dist().ReduceOp.SUM, group=pg)
    return out


def _broadcast(t: torch.Tensor, src: int, pg) -> torch.Tensor:
    """In place from global rank ``src``."""
    if pg is None:
        return t
    if _gloo(pg) and t.is_cuda:
        h = t.cpu()
        _dist().broadcast(h, src, pg)
        t.copy_(h)
    else:
        _dist().broadcast(t, src, pg)
    return t


def _all_to_all(parts: Sequence[torch.Tensor], pg) -> List[torch.Tensor]:
    """``parts[j]`` goes to group rank j; returns what each rank sent
    this one."""
    if pg is None:
        return [parts[0]]
    if _gloo(pg):
        me = _dist().get_rank(pg)
        rows = _all_gather(torch.stack(list(parts)), pg)
        return [r[me] for r in rows]
    out = [torch.empty_like(p) for p in parts]
    _dist().all_to_all(out, [p.contiguous() for p in parts], pg)
    return out


# -- groups ----------------------------------------------------------------

class Group:
    """A set of ranks that run collectives together (the reference's
    ``ring_id``)."""

    def __init__(self, gid: int, ranks, process_group):
        self.id = gid
        self.ranks = list(ranks)
        self.nranks = len(self.ranks)
        self.process_group = process_group

    @property
    def world_size(self):
        return self.nranks

    @property
    def rank(self) -> int:
        """This process's rank in the group, -1 outside it."""
        me = _dist().get_rank()
        return self.ranks.index(me) if me in self.ranks else -1

    def __repr__(self):
        return f"Group(id={self.id}, nranks={self.nranks})"


_groups = {}


def get_group(gid: int = 0) -> Group:
    _require()
    if gid == 0 and 0 not in _groups:
        _groups[0] = Group(0, range(_dist().get_world_size()),
                           _dist().group.WORLD)
    return _groups[gid] if gid in _groups else get_group(0)


def new_group(ranks: Optional[Sequence[int]] = None, backend=None,
              timeout: Optional[float] = None) -> Group:
    """A group over ``ranks`` (every rank of the world calls this, in the
    same order)."""
    import datetime
    from .parallel import collective_timeout
    _require()
    world = _dist().get_world_size()
    ranks = sorted(range(world) if ranks is None else ranks)
    td = (collective_timeout() if timeout is None
          else datetime.timedelta(seconds=float(timeout)))
    pg = _dist().new_group(ranks, timeout=td, backend=backend)
    gid = max(_groups, default=0) + 1
    g = Group(gid, ranks, pg)
    _groups[gid] = g
    return g


# -- the public collectives ------------------------------------------------

def all_reduce(tensor: torch.Tensor, op: int = ReduceOp.SUM, group=None,
               use_calc_stream: bool = True):
    """In place: ``tensor`` reduced over the group's ranks."""
    _require()
    return _all_reduce(tensor, op, _pg(group))


def reduce(tensor: torch.Tensor, dst: int = 0, op: int = ReduceOp.SUM,
           group=None, use_calc_stream: bool = True):
    """The reduction over the ranks; every rank holds it afterwards (the
    reference's replicated view), ``dst`` among them."""
    return all_reduce(tensor, op, group)


def all_gather(tensor_list: List[torch.Tensor], tensor: torch.Tensor,
               group=None, use_calc_stream: bool = True):
    """Fills ``tensor_list`` with every rank's ``tensor``, in rank
    order."""
    _require()
    out = _all_gather(tensor, _pg(group))
    del tensor_list[:]
    tensor_list.extend(out)
    return tensor_list


def reduce_scatter(tensor: torch.Tensor, op: int = ReduceOp.SUM,
                   group=None):
    """The sum over the ranks, this rank's block of dim 0."""
    _require()
    if op != ReduceOp.SUM:
        raise ValueError("reduce_scatter sums (ReduceOp.SUM)")
    return _reduce_scatter(tensor, 0, _pg(group))


def broadcast(tensor: torch.Tensor, src: int = 0, group=None,
              use_calc_stream: bool = True):
    """In place: global rank ``src``'s ``tensor`` on every rank."""
    _require()
    return _broadcast(tensor, src, _pg(group))


def scatter(tensor: torch.Tensor,
            tensor_list: Optional[List[torch.Tensor]] = None, src: int = 0,
            group=None, use_calc_stream: bool = True):
    """Rank r of the group receives ``tensor_list[r]`` of global rank
    ``src`` into ``tensor``."""
    _require()
    pg = _pg(group)
    d = _dist()
    mine = d.get_rank() == src
    if _gloo(pg) and tensor.is_cuda:
        h = torch.empty_like(tensor, device="cpu")
        d.scatter(h, [t.cpu() for t in tensor_list] if mine else None,
                  src, pg)
        tensor.copy_(h)
    else:
        d.scatter(tensor, [t.contiguous() for t in tensor_list]
                  if mine else None, src, pg)
    return tensor


def alltoall(in_tensor_list: List[torch.Tensor],
             out_tensor_list: List[torch.Tensor], group=None,
             use_calc_stream: bool = True):
    """``in_tensor_list[j]`` goes to rank j; ``out_tensor_list[i]`` is
    what rank i sent this one."""
    _require()
    out = _all_to_all(in_tensor_list, _pg(group))
    del out_tensor_list[:]
    out_tensor_list.extend(out)
    return out_tensor_list


def send(tensor: torch.Tensor, dst: int = 0, group=None,
         use_calc_stream=True):
    _require()
    pg = _pg(group)
    if _gloo(pg) and tensor.is_cuda:
        _dist().send(tensor.cpu(), dst, pg)
    else:
        _dist().send(tensor.contiguous(), dst, pg)
    return tensor


def recv(tensor: torch.Tensor, src: int = 0, group=None,
         use_calc_stream=True):
    _require()
    pg = _pg(group)
    if _gloo(pg) and tensor.is_cuda:
        h = torch.empty_like(tensor, device="cpu")
        _dist().recv(h, src, pg)
        tensor.copy_(h)
    else:
        _dist().recv(tensor, src, pg)
    return tensor


def barrier(group=None):
    """Every rank of the group waits for the others (bounded by the
    group's timeout)."""
    _require()
    _dist().barrier(_pg(group))


def wait(tensor: torch.Tensor, group=None, use_calc_stream: bool = True):
    """The collectives on ``tensor`` have finished (they run on the
    current stream: a device sync)."""
    if tensor.is_cuda:
        torch.cuda.current_stream(tensor.device).synchronize()
    return tensor


def split(x, size, operation: str, axis: int = 0, num_partitions: int = 1,
          gather_out: bool = True, weight_attr=None, bias_attr=None,
          name=None):
    """A tensor-parallel layer made and applied to ``x`` (the reference's
    ``split``): ``"linear"`` with ``axis`` 0 is a ``RowParallelLinear``,
    with ``axis`` 1 a ``ColumnParallelLinear`` (``gather_out``);
    ``"embedding"`` a ``VocabParallelEmbedding``; ``size`` is (in, out)
    or (vocab, dim).  The layer's weights are drawn on ``x``'s device
    from PyTorch's default generator, whole, and each rank keeps its
    block over ``tp``."""
    from .meta_parallel import (ColumnParallelLinear, RowParallelLinear,
                                VocabParallelEmbedding)
    dt = x.dtype if x.is_floating_point() else torch.float32
    kw = dict(device=x.device, dtype=dt)
    if operation == "linear":
        in_f, out_f = size
        if axis == 0:
            layer = RowParallelLinear(in_f, out_f, weight_attr,
                                      has_bias=bias_attr is not False, **kw)
        else:
            layer = ColumnParallelLinear(in_f, out_f, weight_attr,
                                         has_bias=bias_attr is not False,
                                         gather_output=gather_out, **kw)
    elif operation == "embedding":
        vocab, emb = size
        layer = VocabParallelEmbedding(vocab, emb, weight_attr, **kw)
    else:
        raise ValueError(f"unsupported split operation {operation!r}")
    return layer(x)


# -- shard_map -------------------------------------------------------------

def _entries(spec, ndim):
    if spec is None:
        return (None,) * ndim
    ent = tuple(spec)
    return ent + (None,) * (ndim - len(ent))


def _block(x, spec, mesh):
    if not isinstance(x, torch.Tensor):
        return x
    for d, ax in enumerate(_entries(spec, x.dim())):
        if ax is None:
            continue
        n = mesh.axis_size(ax)
        if x.shape[d] % n:
            raise ValueError(f"dim {d} of size {x.shape[d]} does not split "
                             f"over {ax!r} ({n} ranks)")
        size = x.shape[d] // n
        x = x.narrow(d, mesh.axis_index(ax) * size, size)
    return x


def _assemble(y, spec, mesh):
    if not isinstance(y, torch.Tensor):
        return y
    ent = _entries(spec, y.dim())
    for d in reversed(range(len(ent))):
        if ent[d] is not None:
            y = torch.cat(_all_gather(y, mesh.group(ent[d])), dim=d)
    return y


def shard_map(f, mesh=None, in_specs=(), out_specs=None):
    """``f`` applied per rank: blocks in by ``in_specs`` (one spec an
    argument), outputs assembled by ``out_specs`` (one spec an output
    when ``f`` returns a tuple, else one spec); a spec is a tuple of dim
    entries or None (module docstring)."""
    from . import mesh as mesh_mod

    def run(*args):
        m = mesh or mesh_mod.get_mesh()
        if len(in_specs) != len(args):
            raise ValueError(f"{len(args)} arguments, {len(in_specs)} "
                             "in_specs")
        out = f(*[_block(a, s, m) for a, s in zip(args, in_specs)])
        if isinstance(out, tuple):
            return tuple(_assemble(o, s, m) for o, s in zip(out, out_specs))
        return _assemble(out, out_specs, m)

    return run
