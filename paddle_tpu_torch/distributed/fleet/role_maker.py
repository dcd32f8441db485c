"""Role makers and ``UtilBase``: the fleet bootstrap surface (counterpart
of ``paddle_tpu/distributed/fleet/role_maker.py``).

The ``Role`` enum, ``PaddleCloudRoleMaker`` reading the ``PADDLE_*`` /
``TRAINING_ROLE`` / ``POD_IP`` environment a launcher exports,
``UserDefinedRoleMaker`` (an explicit topology), the membership-aware
``ElasticRoleMaker``, the endpoint-group helpers of ``|``-separated
replica groups, and ``UtilBase``: worker-world ``all_reduce`` /
``all_gather`` / ``barrier`` over the PS service (accumulator tables and
the worker rendezvous barrier) when a client is attached, identities in
a world of one otherwise, plus file sharding.
"""
from __future__ import annotations

import os
from typing import List, Optional, Sequence

import numpy as np

__all__ = ["Role", "PaddleCloudRoleMaker", "UserDefinedRoleMaker",
           "ElasticRoleMaker", "UtilBase", "endpoint_groups",
           "replica_primary_for"]


def endpoint_groups(endpoints: Sequence[str]) -> List[List[str]]:
    """Split server endpoint entries into replica groups: each entry
    (one PS shard) is ``"host:port"`` or a ``|``-separated failover
    list ordered primary first — ``"h:p1|h:p2"`` means shard served by
    p1 with hot standby p2 (PADDLE_PSERVERS_IP_PORT_LIST carries the
    same syntax, commas between shards)."""
    return [[x for x in str(e).split("|") if x] for e in endpoints]


def replica_primary_for(me: str, endpoints: Sequence[str]):
    """The primary endpoint THIS server replicates, or ``None`` when
    ``me`` is itself a shard primary (or not listed at all — the
    single-server dev case)."""
    for group in endpoint_groups(endpoints):
        if me in group and group.index(me) > 0:
            return group[0]
    return None


class Role:
    WORKER = 1
    SERVER = 2
    HETER_WORKER = 3


class RoleMakerBase:
    def __init__(self):
        self._role = Role.WORKER
        self._current_id = 0
        self._worker_endpoints: List[str] = []
        self._server_endpoints: List[str] = []

    # -- the surface fleet_base consults -------------------------------
    def is_worker(self) -> bool:
        return self._role == Role.WORKER

    def is_server(self) -> bool:
        return self._role == Role.SERVER

    def is_first_worker(self) -> bool:
        return self.is_worker() and self._current_id == 0

    def worker_index(self) -> int:
        return self._current_id if self.is_worker() else -1

    def server_index(self) -> int:
        return self._current_id if self.is_server() else -1

    def worker_num(self) -> int:
        return max(1, len(self._worker_endpoints)) \
            if self._worker_endpoints else 1

    def server_num(self) -> int:
        return len(self._server_endpoints)

    def get_trainer_endpoints(self) -> List[str]:
        return list(self._worker_endpoints)

    def get_pserver_endpoints(self) -> List[str]:
        return list(self._server_endpoints)

    def role_id(self) -> int:
        return self._current_id

    def to_string(self) -> str:
        return (f"role={self._role} id={self._current_id} "
                f"workers={self._worker_endpoints} "
                f"servers={self._server_endpoints}")


class PaddleCloudRoleMaker(RoleMakerBase):
    """Reads the PADDLE_* environment the launcher exports (reference
    role_maker.py:691 — TRAINING_ROLE, PADDLE_TRAINERS_NUM,
    PADDLE_TRAINER_ID, PADDLE_PORT/POD_IP, PADDLE_PSERVERS_IP_PORT_LIST,
    PADDLE_TRAINER_ENDPOINTS). Missing variables degrade to a
    single-process worker (collective mode's common case under one
    launcher) rather than raising at import."""

    def __init__(self, is_collective: bool = False, **kwargs):
        super().__init__()
        self._is_collective = is_collective
        role = os.getenv("TRAINING_ROLE", "TRAINER").upper()
        if role not in ("TRAINER", "PSERVER", "HETER_TRAINER"):
            raise ValueError(
                f"TRAINING_ROLE must be PSERVER or TRAINER or "
                f"HETER_TRAINER, got {role!r}")
        self._role = {"TRAINER": Role.WORKER, "PSERVER": Role.SERVER,
                      "HETER_TRAINER": Role.HETER_WORKER}[role]
        self._worker_endpoints = [
            e for e in os.getenv("PADDLE_TRAINER_ENDPOINTS",
                                 "").split(",") if e]
        self._server_endpoints = [
            e for e in os.getenv("PADDLE_PSERVERS_IP_PORT_LIST",
                                 "").split(",") if e]
        if self._role == Role.SERVER:
            ip = os.getenv("POD_IP", "127.0.0.1")
            port = os.getenv("PADDLE_PORT", "")
            me = f"{ip}:{port}"
            # an endpoint entry may be a "|"-separated replica group:
            # the shard id is the group's index, whether this server is
            # the group's primary or a standby
            self._current_id = 0
            for gi, group in enumerate(
                    endpoint_groups(self._server_endpoints)):
                if me in group:
                    self._current_id = gi
                    break
        else:
            self._current_id = int(os.getenv("PADDLE_TRAINER_ID", "0"))

    def worker_num(self) -> int:
        n = os.getenv("PADDLE_TRAINERS_NUM")
        if n:
            return int(n)
        return super().worker_num()


class UserDefinedRoleMaker(RoleMakerBase):
    """Explicit in-code topology (reference role_maker.py
    UserDefinedRoleMaker) — tests and notebook use."""

    def __init__(self, is_collective: bool = False, current_id: int = 0,
                 role: int = Role.WORKER, worker_num: int = 1,
                 server_endpoints: Optional[Sequence[str]] = None,
                 worker_endpoints: Optional[Sequence[str]] = None,
                 **kwargs):
        super().__init__()
        self._is_collective = is_collective
        self._role = role
        self._current_id = int(current_id)
        self._server_endpoints = list(server_endpoints or [])
        self._worker_endpoints = list(
            worker_endpoints or [f"127.0.0.1:{6170 + i}"
                                 for i in range(worker_num)])
        self._worker_num = int(worker_num)

    def worker_num(self) -> int:
        return self._worker_num


class ElasticRoleMaker(RoleMakerBase):
    """Membership-aware role maker for elastic jobs.

    Static role makers read a fixed topology once; under elastic
    training rank and world size are ASSIGNED by the
    :class:`~.elastic.ElasticCoordinator`
    and change on every membership generation (worker join / leave /
    fail).  The elastic trainer calls :meth:`update_membership` on each
    transition; everything consulting the RoleMakerBase surface
    (worker_index / worker_num / is_first_worker) then sees the
    post-transition world.  ``generation()`` fences stale readers: a
    cached rank is only valid while the generation it was read under
    is still current."""

    def __init__(self, worker_endpoints: Optional[Sequence[str]] = None):
        super().__init__()
        self._worker_endpoints = list(worker_endpoints or [])
        self._generation = 0
        self._world = 1

    def update_membership(self, rank: int, world: int, generation: int):
        if world < 1:
            raise ValueError(f"world must be >= 1, got {world}")
        if not 0 <= int(rank) < int(world):
            raise ValueError(f"rank {rank} outside world {world}")
        self._current_id = int(rank)
        self._world = int(world)
        self._generation = int(generation)

    def generation(self) -> int:
        return self._generation

    def worker_num(self) -> int:
        return self._world

    def to_string(self) -> str:
        return (f"{super().to_string()} world={self._world} "
                f"generation={self._generation}")


class UtilBase:
    """Worker-world utilities (the reference's base/util_factory.py).

    Collectives ride the PS service's worker_barrier and accumulator
    tables when a :class:`~.ps_service.PSClient` is attached
    (``_set_ps_client``);
    otherwise single-process identities apply — the degenerate world the
    reference also supports (worker_num == 1)."""

    _AR_STRIDE = 1 << 20   # id block per slot; reduction values per
                           # round stay well under this
    _AR_SLOTS = 8          # id blocks cycle: each round returns its rows
                           # to zero after the pull, so server memory is
                           # bounded at _AR_SLOTS blocks

    def __init__(self, role_maker: Optional[RoleMakerBase] = None):
        self._role_maker = role_maker or UserDefinedRoleMaker()
        self._ps_client = None
        self._round = 0

    def _set_role_maker(self, role_maker):
        self._role_maker = role_maker

    def _set_ps_client(self, client):
        """Attach a fleet.ps_service PSClient: collectives then ride the
        server's auto-vivified ``__util`` accumulator tables + the
        worker rendezvous barrier."""
        self._ps_client = client

    # -- collectives ----------------------------------------------------
    def _check_stride(self, id_footprint: int):
        """A round's ids must fit its slot's id block: spilling into the
        next slot would silently corrupt a reduction _AR_SLOTS rounds
        away (cleanup for this round would also zero a live slot)."""
        if id_footprint > self._AR_STRIDE:
            raise ValueError(
                f"UtilBase collective needs {id_footprint} ids but the "
                f"per-round id block is {self._AR_STRIDE}; reduce the "
                "array (elements x worker_num for all_gather) or raise "
                "UtilBase._AR_STRIDE")

    def all_reduce(self, input, mode: str = "sum",
                   comm_world: str = "worker"):
        arr = np.asarray(input, np.float32)
        if self._ps_client is None:
            return arr  # world of one
        if mode in ("max", "min"):
            gathered = np.stack(
                [np.asarray(g, np.float32).reshape(arr.shape)
                 for g in self.all_gather(arr)])
            return (gathered.max(0) if mode == "max"
                    else gathered.min(0))
        if mode != "sum":
            raise ValueError(f"all_reduce mode must be sum|max|min, "
                             f"got {mode!r}")
        flat = arr.reshape(-1)
        self._check_stride(flat.size)
        self._round += 1
        base = (self._round % self._AR_SLOTS) * self._AR_STRIDE
        ids = (base + np.arange(flat.size)).astype(np.int64)
        self._ps_client.push_delta("__util_ar__", ids, flat[:, None])
        self._ps_client.worker_barrier()
        out = self._ps_client.pull("__util_ar__", ids)[:, 0]
        # second barrier: nobody may zero the slot while a peer is
        # still pulling it; then return the rows to zero so the slot's
        # reuse _AR_SLOTS rounds later starts clean
        self._ps_client.worker_barrier()
        self._ps_client.push_delta("__util_ar__", ids, -flat[:, None])
        return out.reshape(arr.shape)

    def all_gather(self, input, comm_world: str = "worker"):
        if self._ps_client is None:
            return [input]
        arr = np.asarray(input, np.float32).reshape(-1)
        rank = max(self._role_maker.worker_index(), 0)
        n = max(self._role_maker.worker_num(), 1)
        self._check_stride(n * arr.size)
        self._round += 1
        base = (self._round % self._AR_SLOTS) * self._AR_STRIDE
        my_ids = (base + rank * arr.size
                  + np.arange(arr.size)).astype(np.int64)
        self._ps_client.push_delta("__util_ar__", my_ids, arr[:, None])
        self._ps_client.worker_barrier()
        out = []
        for r in range(n):
            ids = (base + r * arr.size
                   + np.arange(arr.size)).astype(np.int64)
            out.append(self._ps_client.pull("__util_ar__", ids)[:, 0])
        # see all_reduce: peers must finish pulling before the cleanup
        self._ps_client.worker_barrier()
        self._ps_client.push_delta("__util_ar__", my_ids, -arr[:, None])
        return out

    def barrier(self, comm_world: str = "worker"):
        if self._ps_client is not None:
            self._ps_client.worker_barrier()

    # -- file utilities -------------------------------------------------
    def get_file_shard(self, files: Sequence[str]) -> List[str]:
        """This worker's contiguous shard of ``files`` (reference
        util_factory.py:206 — remainder spread over the first ranks)."""
        if not isinstance(files, (list, tuple)):
            raise TypeError("files should be a list of file names")
        idx = max(self._role_maker.worker_index(), 0)
        n = max(self._role_maker.worker_num(), 1)
        base, rem = divmod(len(files), n)
        start = idx * base + min(idx, rem)
        size = base + (1 if idx < rem else 0)
        return list(files[start:start + size])

    def print_on_rank(self, message: str, rank_id: int):
        if max(self._role_maker.worker_index(), 0) == int(rank_id):
            print(message)
