"""Ranks and data parallelism (counterpart of
``paddle_tpu/distributed/parallel.py``): ``ParallelEnv``,
``init_parallel_env``, ``get_rank`` / ``get_world_size``,
``global_batch`` and ``DataParallel``.

The port's idiom is one process per rank, as Paddle's collective mode
(its ``init_parallel_env`` over ``NCCLParallelContext``) and PyTorch's:
a rank reads its place from the launcher's variables
(``PADDLE_TRAINER_ID``, ``PADDLE_TRAINERS_NUM``,
``PADDLE_TRAINER_ENDPOINTS``, ``PADDLE_RANK_IN_NODE``,
``PADDLE_LOCAL_SIZE``, ``FLAGS_selected_gpus`` for its card and
``PADDLE_DISTRI_BACKEND``, which ``launch --backend`` sets) and joins
a ``torch.distributed`` process group whose store is the first endpoint.

The backend is never switched silently.  With ``backend=None``
``init_parallel_env`` takes ``"nccl"`` when every rank of this host owns
a card of its own and ``"gloo"`` when the ranks run on the CPU; ranks
that share a card (more ranks on this host than cards) must ask for
``"gloo"`` themselves, or it raises and says why (NCCL refuses two ranks
on one card).  ``"nccl"`` without a card raises.  Every wait is bounded:
the group's timeout (``timeout``, seconds) bounds its rendezvous and
every collective on it.

A rank's batch is its shard of the global batch over the data axes
(``mesh.batch_spec`` gives its rows); ``global_batch`` names that shard
on the rank's device, where the reference assembles the shards of all
processes into one global array.  ``DataParallel`` all-reduces the mean
gradient over the data axes at the end of every backward, so data
parallelism matches one device on the whole batch (the reference's
gradient is that of the global mean loss).
"""
from __future__ import annotations

import atexit
import datetime
import os
import socket
import sys
from typing import Optional

import numpy as np
import torch

__all__ = ["ParallelEnv", "init_parallel_env", "get_rank", "get_world_size",
           "DataParallel", "global_batch", "is_initialized",
           "collective_timeout", "backend"]

DEFAULT_TIMEOUT_S = 300.0
_state = {"backend": None, "timeout": DEFAULT_TIMEOUT_S, "failed": False}


def _env_int(name, default):
    v = os.environ.get(name)
    return int(v) if v not in (None, "") else default


def is_initialized() -> bool:
    import torch.distributed as dist
    return dist.is_available() and dist.is_initialized()


def backend() -> Optional[str]:
    """The world group's backend, or None before ``init_parallel_env``."""
    return _state["backend"] if is_initialized() else None


def collective_timeout() -> datetime.timedelta:
    return datetime.timedelta(seconds=float(_state["timeout"]))


class ParallelEnv:
    """This rank's place: rank and world from the process group once it
    exists, from the launcher's variables before."""

    @property
    def rank(self) -> int:
        if is_initialized():
            import torch.distributed as dist
            return dist.get_rank()
        return _env_int("PADDLE_TRAINER_ID", 0)

    @property
    def world_size(self) -> int:
        if is_initialized():
            import torch.distributed as dist
            return dist.get_world_size()
        return _env_int("PADDLE_TRAINERS_NUM", 1)

    @property
    def local_rank(self) -> int:
        return _env_int("PADDLE_RANK_IN_NODE", self.rank)

    @property
    def local_size(self) -> int:
        """Ranks on this host: ``PADDLE_LOCAL_SIZE``, else the whole world
        when every endpoint names one host, else 1."""
        n = _env_int("PADDLE_LOCAL_SIZE", 0)
        if n:
            return n
        hosts = {e.rsplit(":", 1)[0] for e in self.trainer_endpoints}
        return self.world_size if len(hosts) <= 1 else 1

    @property
    def device_id(self) -> int:
        sel = os.environ.get("FLAGS_selected_gpus", "")
        return int(sel.split(",")[0]) if sel else self.local_rank

    @property
    def device(self) -> torch.device:
        if torch.cuda.is_available():
            return torch.device("cuda", self.device_id)
        return torch.device("cpu")

    @property
    def current_endpoint(self) -> str:
        eps = self.trainer_endpoints
        return eps[self.rank] if self.rank < len(eps) else ""

    @property
    def trainer_endpoints(self):
        return [e for e in os.environ.get(
            "PADDLE_TRAINER_ENDPOINTS", "").split(",") if e]

    # the reference's alias
    @property
    def nranks(self) -> int:
        return self.world_size


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _pick_backend(env: ParallelEnv, backend: Optional[str]) -> str:
    backend = backend or os.environ.get("PADDLE_DISTRI_BACKEND") or None
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if backend is not None:
        if backend not in ("nccl", "gloo"):
            raise ValueError(f"backend {backend!r}: the port runs 'nccl' "
                             "or 'gloo'")
        if backend == "nccl" and cards == 0:
            raise RuntimeError("backend 'nccl' needs a CUDA card; this "
                               "rank has none (use backend='gloo')")
        return backend
    if cards == 0:
        return "gloo"
    if env.local_size > cards:
        raise RuntimeError(
            f"{env.local_size} ranks share this host's {cards} card(s): "
            "NCCL refuses two ranks on one card, and the port does not "
            "switch backends silently; pass backend='gloo' to "
            "init_parallel_env (or launch --backend gloo) to run them over "
            "gloo with their tensors staged through host memory")
    if env.device_id >= cards:
        raise RuntimeError(f"rank {env.rank} selects card {env.device_id} "
                           f"of {cards}")
    return "nccl"


def init_parallel_env(backend: Optional[str] = None,
                      timeout: Optional[float] = None) -> ParallelEnv:
    """Join the world's process group (once; later calls return the
    environment) and install the default all-``dp`` mesh over its ranks.

    ``backend``: ``"nccl"``, ``"gloo"`` or None (the rule in the module
    docstring).  ``timeout``: seconds that bound the rendezvous and every
    collective (default 300)."""
    import torch.distributed as dist
    env = ParallelEnv()
    if is_initialized():
        return env
    rank, world = env.rank, env.world_size
    chosen = _pick_backend(env, backend)
    eps = env.trainer_endpoints
    if eps:
        store = eps[0]
    elif world == 1:
        store = f"127.0.0.1:{_free_port()}"
    else:
        raise RuntimeError(f"a world of {world} ranks needs "
                           "PADDLE_TRAINER_ENDPOINTS (the launcher's)")
    if timeout is not None:
        _state["timeout"] = float(timeout)
    if env.device.type == "cuda":
        torch.cuda.set_device(env.device)
    dist.init_process_group(chosen, init_method=f"tcp://{store}",
                            rank=rank, world_size=world,
                            timeout=collective_timeout())
    # a group still open when the interpreter exits can abort the process
    # from its threads' destructors: close it first
    atexit.register(_close_group)
    sys.excepthook = _note_failure(sys.excepthook)
    _state["backend"] = chosen
    from . import mesh as mesh_mod
    mesh_mod.set_mesh(None)
    mesh_mod.init_mesh({"dp": -1})
    return env


def _close_group():
    """At exit: every rank waits for the others (bounded by the group's
    timeout), then closes the group; a rank leaving on an uncaught
    exception does not wait."""
    import torch.distributed as dist
    if is_initialized() and not _state["failed"]:
        dist.barrier()
        dist.destroy_process_group()


def _note_failure(hook):
    def excepthook(*exc):
        _state["failed"] = True
        hook(*exc)
    return excepthook


def get_rank() -> int:
    return ParallelEnv().rank


def get_world_size() -> int:
    return ParallelEnv().world_size


def global_batch(data, mesh=None) -> torch.Tensor:
    """This rank's shard of the global batch (``data``: the rows
    ``mesh.batch_spec`` gives this rank) as a tensor on the rank's
    device.  A tensor keeps its device."""
    if isinstance(data, torch.Tensor):
        return data
    from . import mesh as mesh_mod
    m = mesh or mesh_mod.get_mesh()
    return torch.as_tensor(np.asarray(data)).to(m.devices[0])


class DataParallel:
    """Data parallelism over the mesh's data axes: the wrapped layer runs
    this rank's batch, and at the end of every backward each parameter's
    gradient becomes the mean over the data ranks (one all-reduce a
    parameter, staged through host memory on gloo).  The parameters are
    broadcast from the first data rank when the wrapper is made, so every
    rank starts from the same weights.  Without a process group (world
    1) the wrapper is the layer itself.  ``scale_loss`` and
    ``apply_collective_grads`` are the identity, as in the reference."""

    def __init__(self, layers, strategy=None, comm_buffer_size: int = 25,
                 last_comm_buffer_size: int = 1,
                 find_unused_parameters=False, group=None):
        from . import mesh as mesh_mod
        from .collective import _broadcast, _world_rank
        self._layers = layers
        self._queued = False
        self._group = None
        self._n = 1
        if not is_initialized():
            return
        m = mesh_mod.get_mesh()
        self._group = group if group is not None else m.group(
            mesh_mod.DATA)
        self._n = m.axis_size(mesh_mod.DATA)
        if self._group is None:
            return
        src = _world_rank(self._group, 0)
        with torch.no_grad():
            for p in layers.parameters():
                _broadcast(p.data, src, self._group)
        for p in layers.parameters():
            if p.requires_grad:
                p.register_post_accumulate_grad_hook(self._on_grad)

    def _on_grad(self, _p):
        if not self._queued:
            self._queued = True
            torch.autograd.Variable._execution_engine.queue_callback(
                self._sync)

    @torch.no_grad()
    def _sync(self):
        from .collective import ReduceOp, _all_reduce
        self._queued = False
        for p in self._layers.parameters():
            if p.grad is not None:
                _all_reduce(p.grad, ReduceOp.SUM, self._group)
                p.grad.div_(self._n)

    def forward(self, *inputs, **kwargs):
        return self._layers(*inputs, **kwargs)

    __call__ = forward

    def scale_loss(self, loss):
        return loss

    def apply_collective_grads(self):
        pass

    # everything else is the wrapped layer's
    def __getattr__(self, name):
        return getattr(self.__dict__["_layers"], name)

    def state_dict(self, *a, **k):
        return self._layers.state_dict(*a, **k)

    def set_state_dict(self, *a, **k):
        return self._layers.load_state_dict(*a, **k)
