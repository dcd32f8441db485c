"""Fleet: the unified distributed-training API surface (counterpart of
``paddle_tpu/distributed/fleet/fleet_base.py``).

``fleet.init`` takes a role maker (by default a
:class:`~.role_maker.PaddleCloudRoleMaker`, which reads the launcher's
``TRAINING_ROLE`` / ``PADDLE_*`` / ``POD_IP`` environment) and a
strategy.  The role queries and ``util`` (:class:`~.role_maker.UtilBase`)
read the role maker; the parameter-server lifecycle runs over
:class:`~.ps.PSRuntime`: a server process calls ``init_server`` (a warm
start from a directory of ``.npz`` tables, or none) and ``run_server``
(a primary, or the hot standby of its ``|``-separated replica group's
primary); a trainer calls ``init_worker`` (a client in the strategy's
sync, async or geo mode), ``barrier_worker`` and ``stop_worker``.
A collective ``init`` (``is_collective=True``) joins the world's
process group when the launcher's world has more than one rank
(``init_parallel_env``) and installs the strategy's mesh over it (``dp``,
``fsdp``, ``pp``, ``tp`` and ``sp`` degrees, as
``DistributedStrategy.mesh_degrees`` maps them); a world of one rank
needs no group.
``distributed_model`` wraps the model in ``DataParallel`` past one
worker; ``distributed_train_step`` returns a
:class:`~.dist_step.DistributedTrainStep` over that mesh; the
``DistributedOptimizer`` of ``distributed_optimizer`` swaps in ``Lamb``
or ``Lars`` for the strategy's ``lamb`` / ``lars`` toggles, as the
reference's meta optimizers do.
"""
from __future__ import annotations

import os
from typing import Optional

from .strategy import DistributedStrategy

__all__ = [
    "Fleet", "init", "is_first_worker", "worker_index", "worker_num",
    "is_worker", "worker_endpoints", "server_num", "server_index",
    "server_endpoints", "is_server", "barrier_worker", "init_worker",
    "init_server", "run_server", "stop_worker", "distributed_optimizer",
    "distributed_model", "distributed_train_step", "DistributedStrategy",
]


class Fleet:
    """The module's singleton facade (``fleet.init``, ``fleet.run_server``,
    ...)."""

    def __init__(self):
        self._role_maker = None
        self._mesh = None
        self._strategy: Optional[DistributedStrategy] = None
        self._ps_runtime = None
        self._util = None
        self._util_stamp = None

    @property
    def util(self):
        """The fleet :class:`~.role_maker.UtilBase`: PS-backed
        ``all_reduce`` / ``all_gather`` / ``barrier`` and file sharding.
        Rebuilt whenever the role maker or the PS client changes, so an
        access before ``fleet.init()`` cannot pin a stale one-worker
        world."""
        from .role_maker import UtilBase
        client = getattr(self._ps_runtime, "_client", None) \
            if self._ps_runtime is not None else None
        stamp = (id(self._role_maker), id(client))
        if self._util is None or self._util_stamp != stamp:
            self._util = UtilBase(self._role_maker)
            if client is not None:
                self._util._set_ps_client(client)
            self._util_stamp = stamp
        return self._util

    # -- lifecycle -----------------------------------------------------
    def init(self, role_maker=None, is_collective=False, strategy=None):
        from .role_maker import PaddleCloudRoleMaker
        self._role_maker = role_maker or PaddleCloudRoleMaker(
            is_collective=is_collective)
        self._strategy = strategy or DistributedStrategy()
        self._mesh = None
        if is_collective or getattr(role_maker, "_is_collective", False):
            from .. import mesh as mesh_mod
            from ..parallel import ParallelEnv, init_parallel_env, \
                is_initialized
            degrees = self._strategy.mesh_degrees()
            if ParallelEnv().world_size > 1 or is_initialized():
                init_parallel_env()
                self._mesh = mesh_mod.init_mesh(degrees)
            else:
                wide = {k: v for k, v in degrees.items()
                        if v not in (1, -1)}
                if wide:
                    raise ValueError(
                        f"mesh degrees {wide} need that many ranks; this "
                        "world has one (start the ranks with launch "
                        "--nproc_per_node or spawn)")
        return self

    # -- role info -----------------------------------------------------
    def is_first_worker(self):
        return self._rm().is_first_worker()

    def worker_index(self):
        return self._rm().worker_index()

    def worker_num(self):
        return self._rm().worker_num()

    def is_worker(self):
        return self._rm().is_worker()

    def worker_endpoints(self, to_string=False):
        eps = self._rm().get_trainer_endpoints()
        return ",".join(eps) if to_string else eps

    def server_num(self):
        return self._rm().server_num()

    def server_index(self):
        return self._rm().server_index()

    def server_endpoints(self, to_string=False):
        eps = self._rm().get_pserver_endpoints()
        return ",".join(eps) if to_string else eps

    def is_server(self):
        return self._rm().is_server()

    def _rm(self):
        if self._role_maker is None:
            self.init()
        return self._role_maker

    def barrier_worker(self):
        """A rendezvous of the live trainers through the PS service when
        this trainer has a client; a no-op in a world of one."""
        if self._ps_runtime is not None:
            self._ps_runtime.worker_barrier()

    # -- the parameter-server lifecycle --------------------------------
    def init_worker(self):
        """Connect this trainer to the servers the launcher lists
        (``PADDLE_PSERVERS_IP_PORT_LIST``), registering as
        ``trainer-<PADDLE_TRAINER_ID>``; without servers the runtime's
        tables stay in process and no client is made."""
        from .ps import PSRuntime
        eps = self._rm().get_pserver_endpoints() or None
        if self._ps_runtime is None:
            # a pure trainer process never ran init_server, but its
            # client still needs a runtime to hold the connection
            self._ps_runtime = PSRuntime(self._strategy)
        tid = int(os.environ.get("PADDLE_TRAINER_ID", "0"))
        wid = f"trainer-{tid}" if eps else None
        return self._ps_runtime.init_worker(endpoints=eps, worker_id=wid)

    def init_server(self, *args, **kwargs):
        from .ps import PSRuntime
        self._ps_runtime = PSRuntime(self._strategy)
        self._ps_runtime.init_server(*args, **kwargs)

    def run_server(self):
        """Serve the runtime's tables on ``PADDLE_PORT``.  The launch
        barrier waits for every trainer (``worker_num``) to register; a
        server listed behind a primary in a ``|``-separated replica group
        of ``PADDLE_PSERVERS_IP_PORT_LIST`` comes up as that primary's
        hot standby."""
        if self._ps_runtime is None:
            return
        from .role_maker import replica_primary_for
        me = (f"{os.environ.get('POD_IP', '127.0.0.1')}:"
              f"{os.environ.get('PADDLE_PORT', '')}")
        replica_of = replica_primary_for(
            me, self._rm().get_pserver_endpoints())
        port = os.environ.get("PADDLE_PORT")
        self._ps_runtime.run_server(
            expected_workers=self.worker_num(), replica_of=replica_of,
            port=int(port) if port else None)

    def stop_worker(self):
        if self._ps_runtime is not None:
            self._ps_runtime.stop()

    # -- the core API --------------------------------------------------
    def distributed_optimizer(self, optimizer, strategy=None):
        if strategy is not None:
            self._strategy = strategy
        return DistributedOptimizer(optimizer,
                                    self._strategy or DistributedStrategy(),
                                    self)

    def distributed_model(self, model):
        """``DataParallel`` over the data axes past one worker; the model
        itself in a world of one."""
        if self._rm().worker_num() > 1:
            from ..parallel import DataParallel
            return DataParallel(model)
        return model

    def distributed_train_step(self, model, loss_fn, optimizer,
                               strategy=None):
        from .dist_step import DistributedTrainStep
        opt = optimizer.inner_opt if isinstance(optimizer,
                                                DistributedOptimizer) \
            else optimizer
        return DistributedTrainStep(model, loss_fn, opt,
                                    strategy or self._strategy,
                                    mesh=getattr(self, "_mesh", None))

    @property
    def strategy(self):
        return self._strategy


class DistributedOptimizer:
    """Returned by ``fleet.distributed_optimizer``: swaps in ``Lamb`` /
    ``Lars`` for the strategy's ``lamb`` / ``lars`` toggles (the
    reference's meta optimizers, over the wrapped optimizer's lr and
    parameters) and delegates to the result; graph-level strategies live
    in the train step (``dist_step.py``)."""

    def __init__(self, optimizer, strategy, fleet_obj):
        import warnings
        from .strategy import warn_noop_toggles
        self.user_defined_strategy = strategy
        self._fleet = fleet_obj
        self.inner_opt = self._maybe_swap(optimizer, strategy)
        warn_noop_toggles(strategy)
        if strategy.dgc:
            warnings.warn(
                "strategy.dgc compresses gradients only through the train "
                "step (fleet.distributed_train_step / "
                "DistributedTrainStep); a hand-written loop over this "
                "optimizer is not compressed", UserWarning)

    @staticmethod
    def _maybe_swap(opt, strategy):
        from ...optimizer import Lamb, Lars
        if strategy.lamb:
            cfg = strategy.lamb_configs
            return Lamb(learning_rate=opt._learning_rate,
                        lamb_weight_decay=cfg["lamb_weight_decay"],
                        parameters=opt._parameter_list)
        if strategy.lars:
            cfg = strategy.lars_configs
            return Lars(learning_rate=opt._learning_rate,
                        lars_coeff=cfg["lars_coeff"],
                        lars_weight_decay=cfg["lars_weight_decay"],
                        epsilon=cfg["epsilon"],
                        parameters=opt._parameter_list)
        return opt

    def step(self):
        return self.inner_opt.step()

    def clear_grad(self):
        return self.inner_opt.clear_grad()

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        loss.backward()
        self.inner_opt.step()
        self.inner_opt.clear_grad()
        return [], []

    def state_dict(self):
        return self.inner_opt.state_dict()

    def set_state_dict(self, d):
        return self.inner_opt.set_state_dict(d)

    def __getattr__(self, name):
        return getattr(self.__dict__["inner_opt"], name)


_fleet = Fleet()


def init(role_maker=None, is_collective=False, strategy=None):
    return _fleet.init(role_maker, is_collective, strategy)


def is_first_worker():
    return _fleet.is_first_worker()


def worker_index():
    return _fleet.worker_index()


def worker_num():
    return _fleet.worker_num()


def is_worker():
    return _fleet.is_worker()


def worker_endpoints(to_string=False):
    return _fleet.worker_endpoints(to_string)


def server_num():
    return _fleet.server_num()


def server_index():
    return _fleet.server_index()


def server_endpoints(to_string=False):
    return _fleet.server_endpoints(to_string)


def is_server():
    return _fleet.is_server()


def barrier_worker():
    return _fleet.barrier_worker()


def init_worker():
    return _fleet.init_worker()


def init_server(*a, **k):
    return _fleet.init_server(*a, **k)


def run_server():
    return _fleet.run_server()


def stop_worker():
    return _fleet.stop_worker()


def distributed_optimizer(optimizer, strategy=None):
    return _fleet.distributed_optimizer(optimizer, strategy)


def distributed_model(model):
    return _fleet.distributed_model(model)


def distributed_train_step(model, loss_fn, optimizer, strategy=None):
    return _fleet.distributed_train_step(model, loss_fn, optimizer, strategy)
