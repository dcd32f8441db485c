"""The installed device mesh, its axis groups and its reform hooks
(counterpart of ``paddle_tpu/distributed/mesh.py``).

A :class:`Mesh` names axis sizes (``AXES``).  It spans one of two things:

- **the world's ranks**, once ``torch.distributed`` is initialised
  (``init_parallel_env``): one process per rank, each on its own device,
  the sizes' product the world size.  The ranks fill the axes in row-major
  ``AXES`` order (``dp`` outermost), so a rank's coordinates are its rank
  unravelled over the sizes.  Each axis has one process group a rank
  (``new_group`` over the ranks that share every other coordinate, made
  by every rank in one order); the data axes ``dp`` x ``fsdp`` have one
  more.  An axis whose ranks are the whole world uses the world group,
  even at world 1 (so a one-rank NCCL world still runs its collectives
  through NCCL); an axis of one rank in a larger world has no group, and
  a collective over it is the identity.
- **this process's devices**, when no process group exists (one process,
  world 1): the visible CUDA cards, or the CPU.  The elastic data plane
  re-forms this mesh; the train step accepts it only at one device.

``init_mesh`` builds a mesh from degrees with the reference's arithmetic
(missing axes get 1, one ``-1`` absorbs the remaining ranks, the rest
goes to ``dp``).  Every axis but ``ep`` takes degrees above 1: ``tp``
splits the parallel layers' weights (:mod:`.meta_parallel`), ``sp`` the
sequence (:mod:`..ops.ring_attention`), ``pp`` the stacked layers
(:mod:`.pipeline`).  A degree above 1 on ``ep`` raises
``NotImplementedError`` (ROADMAP queue item 4, part 2c: expert
parallelism with ``MoELayer``).  The elastic trainer calls :func:`reform_mesh` on every
membership generation; every hook registered with :func:`on_reform` then
fires with the new mesh.

``batch_spec`` answers which rows of a global batch this rank holds: dim 0
splits over the data axes in rank order, as the reference shards a batch
over ``("dp", "fsdp")``.
"""
from __future__ import annotations

import math
import weakref
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import torch

from .spec_layout import AXES

__all__ = ["AXES", "Mesh", "visible_devices", "init_mesh", "get_mesh",
           "set_mesh", "reform_mesh", "on_reform", "mesh_axis_size",
           "data_axes", "batch_spec", "DATA"]

# the key of the data axes' group in ``Mesh.groups``
DATA = ("dp", "fsdp")

_LATER = ("is not ported yet (ROADMAP queue item 4, part 2c: expert "
          "parallelism with MoELayer)")


@dataclass(frozen=True)
class Mesh:
    """Axis sizes (``shape``, in ``AXES`` order) over ``devices``.

    For a mesh over processes ``devices`` is this rank's device, ``rank``
    and ``world`` its place in the world, and ``groups`` maps each axis
    (and ``DATA``) to its process group, or to None where the axis has one
    rank in a larger world.  A one-process mesh has ``world`` 1 and no
    groups (``distributed`` False)."""

    devices: tuple
    shape: Dict[str, int]
    rank: int = 0
    world: int = 1
    distributed: bool = False
    groups: Dict = field(default_factory=dict, compare=False)

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    @property
    def coords(self) -> Dict[str, int]:
        """This rank's coordinate on every axis."""
        out, r = {}, self.rank
        for ax in reversed(AXES):
            out[ax] = r % self.shape[ax]
            r //= self.shape[ax]
        return out

    def group(self, axis):
        """The process group of ``axis`` (an axis name or ``DATA``), or
        None where no communication is needed (one rank, or no process
        group at all)."""
        key = tuple(axis) if isinstance(axis, (tuple, list)) else axis
        if key not in self.groups and key not in AXES and key != DATA:
            raise ValueError(f"unknown mesh axis {axis!r}; valid: {AXES} "
                             f"and {DATA}")
        return self.groups.get(key)

    def axis_size(self, axis) -> int:
        if isinstance(axis, (tuple, list)):
            return math.prod(self.shape[a] for a in axis)
        return self.shape[axis]

    def axis_index(self, axis) -> int:
        """This rank's index along ``axis`` (``DATA``: dp-major)."""
        c = self.coords
        if isinstance(axis, (tuple, list)):
            i = 0
            for a in axis:
                i = i * self.shape[a] + c[a]
            return i
        return c[axis]

    def axis_ranks(self, axis) -> List[int]:
        """The global ranks along ``axis`` that share this rank's other
        coordinates, in axis order."""
        return _line(self.shape, self.coords,
                     tuple(axis) if isinstance(axis, (tuple, list))
                     else (axis,))


def _line(shape, coords, axes) -> List[int]:
    sizes = [shape[a] for a in AXES]
    out = []
    for j in range(math.prod(shape[a] for a in axes)):
        c = dict(coords)
        for a in reversed(axes):
            c[a] = j % shape[a]
            j //= shape[a]
        r = 0
        for a, s in zip(AXES, sizes):
            r = r * s + c[a]
        out.append(r)
    return out


_global_mesh: Optional[Mesh] = None

# per-mesh rebuild hooks: owners of state laid out for a mesh register
# here so an elastic reform_mesh() reaches them in one place.  Bound
# methods are held weakly (a registered owner stays collectable); dead
# entries are pruned at fire time.
_reform_hooks: list = []


def visible_devices() -> List[torch.device]:
    """The visible CUDA cards, or the CPU when there is none."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n == 0:
        return [torch.device("cpu")]
    return [torch.device("cuda", i) for i in range(n)]


def on_reform(hook) -> None:
    """Register a callable invoked with the NEW mesh after every
    :func:`reform_mesh`."""
    try:
        ref = weakref.WeakMethod(hook)
    except TypeError:
        ref = (lambda h=hook: h)
    _reform_hooks.append(ref)


def _fire_reform(mesh: Mesh) -> None:
    dead = []
    for ref in list(_reform_hooks):
        hook = ref()
        if hook is None:
            dead.append(ref)
            continue
        hook(mesh)
    for ref in dead:
        try:
            _reform_hooks.remove(ref)
        except ValueError:
            pass


def _refuse_model_axes(shape):
    if shape.get("ep", 1) > 1:
        raise NotImplementedError(f"mesh degree ep={shape['ep']} {_LATER}")


def _sizes(degrees, n):
    degrees = dict(degrees or {})
    for ax in degrees:
        if ax not in AXES:
            raise ValueError(f"unknown mesh axis {ax!r}; valid: {AXES}")
    _refuse_model_axes(degrees)
    sizes = [degrees.get(ax, 1) for ax in AXES]
    if -1 in sizes:
        i = sizes.index(-1)
        rest = math.prod(s for s in sizes if s != -1)
        if n % rest:
            raise ValueError(f"{n} ranks not divisible by {rest}")
        sizes[i] = n // rest
    elif math.prod(sizes) != n:
        if n % math.prod(sizes):
            raise ValueError(
                f"mesh degrees {degrees} (= {math.prod(sizes)}) do not "
                f"divide the {n} ranks")
        sizes[AXES.index("dp")] *= n // math.prod(sizes)
    shape = dict(zip(AXES, sizes))
    _refuse_model_axes(shape)
    return shape


def _groups(shape, rank, world, timeout):
    """Every axis's process group (and the data axes'), made by every
    rank in one order."""
    import torch.distributed as dist
    coords = Mesh((), shape, rank, world).coords
    groups = {}
    for key in AXES + (DATA,):
        axes = key if isinstance(key, tuple) else (key,)
        size = math.prod(shape[a] for a in axes)
        if size == world:
            groups[key] = dist.group.WORLD
            continue
        if size == 1:
            groups[key] = None
            continue
        mine = _line(shape, coords, axes)
        seen = set()
        for r in range(world):                 # every line, in rank order
            c = Mesh((), shape, r, world).coords
            line = tuple(_line(shape, c, axes))
            if line in seen:
                continue
            seen.add(line)
            g = dist.new_group(list(line), timeout=timeout)
            if list(line) == mine:
                groups[key] = g
    return groups


def init_mesh(degrees: Optional[Dict[str, int]] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """Create and install the global mesh.  ``degrees`` maps axis name
    -> size; the product must equal the world size (the device count
    without a process group).  A single ``-1`` entry absorbs the remaining
    ranks, and without one the remainder goes to ``dp``."""
    global _global_mesh
    from . import parallel
    if parallel.is_initialized():
        if devices is not None:
            raise ValueError("a mesh over the world's ranks takes no "
                             "device list: each rank holds its own device")
        env = parallel.ParallelEnv()
        shape = _sizes(degrees, env.world_size)
        _global_mesh = Mesh((env.device,), shape, env.rank,
                            env.world_size, True,
                            _groups(shape, env.rank, env.world_size,
                                    parallel.collective_timeout()))
        return _global_mesh
    devices = list(devices if devices is not None else visible_devices())
    _global_mesh = Mesh(tuple(devices), _sizes(degrees, len(devices)))
    return _global_mesh


def reform_mesh(degrees: Optional[Dict[str, int]] = None,
                devices: Optional[Sequence] = None) -> Mesh:
    """Re-form the global mesh after an elastic membership change: the
    installed mesh is dropped and rebuilt (all ``dp`` by default), then
    every :func:`on_reform` hook fires with it."""
    set_mesh(None)
    mesh = init_mesh(degrees if degrees is not None else {"dp": -1},
                     devices=devices)
    _fire_reform(mesh)
    return mesh


def set_mesh(mesh: Optional[Mesh]):
    global _global_mesh
    _global_mesh = mesh


def get_mesh(create: bool = True) -> Optional[Mesh]:
    """The installed global mesh; lazily builds an all-``dp`` mesh."""
    if _global_mesh is None and create:
        init_mesh({"dp": -1})
    return _global_mesh


def mesh_axis_size(axis: str) -> int:
    mesh = get_mesh()
    return mesh.shape.get(axis, 1) if mesh is not None else 1


def data_axes(mesh: Optional[Mesh] = None):
    """The axes a batch's dim 0 splits over: the live ones of ``dp`` and
    ``fsdp`` (``("dp",)`` when both are 1)."""
    mesh = mesh or get_mesh()
    axes = tuple(ax for ax in DATA
                 if mesh is not None and mesh.shape.get(ax, 1) > 1)
    return axes or ("dp",)


def batch_spec(global_rows: int, mesh: Optional[Mesh] = None) -> slice:
    """The rows of a global batch of ``global_rows`` that this rank holds:
    dim 0 split over the data axes in rank order (the reference's
    ``batch`` spec over ``("dp", "fsdp")``).  ``global_rows`` must divide
    evenly."""
    mesh = mesh or get_mesh()
    n = mesh.axis_size(DATA)
    if global_rows % n:
        raise ValueError(f"a global batch of {global_rows} rows does not "
                         f"split over {n} data ranks")
    per = global_rows // n
    i = mesh.axis_index(DATA)
    return slice(i * per, (i + 1) * per)
