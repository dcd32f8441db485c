"""Role makers (counterpart of ``paddle_tpu/distributed/fleet/role_maker.py``,
the part the elastic data plane uses): the ``Role`` enum, the
``RoleMakerBase`` surface fleet code consults, and the membership-aware
``ElasticRoleMaker``.

Not ported yet (ROADMAP queue item 6, with the PS service):
``PaddleCloudRoleMaker``, ``UserDefinedRoleMaker``, ``UtilBase`` and the
endpoint-group helpers.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

__all__ = ["Role", "RoleMakerBase", "ElasticRoleMaker"]


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
