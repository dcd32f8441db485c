"""The installed device mesh and its reform hooks (counterpart of
``paddle_tpu/distributed/mesh.py``, the part the elastic data plane
uses).

A :class:`Mesh` names axis sizes over a list of devices: the visible
CUDA cards, or the CPU when there is none.  ``init_mesh`` builds it
from degrees with the reference's arithmetic (missing axes get 1, one
``-1`` absorbs the remaining devices, the rest goes to ``dp``).  The
elastic trainer calls :func:`reform_mesh` on every membership
generation; every hook registered with :func:`on_reform` then fires
with the new mesh, so owners of state laid out for the old mesh can
rebuild it.

Not ported yet (ROADMAP queue item 4): sharding specs
(``batch_spec``, ``named_sharding``, ``maybe_constrain``) and a mesh
that spans processes.
"""
from __future__ import annotations

import math
import weakref
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import torch

__all__ = ["AXES", "Mesh", "visible_devices", "init_mesh", "get_mesh",
           "set_mesh", "reform_mesh", "on_reform"]

# the reference's axis vocabulary (planner/spec_layout.py AXES)
AXES = ("dp", "fsdp", "pp", "tp", "sp", "ep")


@dataclass(frozen=True)
class Mesh:
    """Axis sizes (``shape``, in ``AXES`` order) over ``devices``."""

    devices: tuple
    shape: Dict[str, int]


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


def init_mesh(degrees: Optional[Dict[str, int]] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """Create and install the global mesh.  ``degrees`` maps axis name
    -> size; the product must equal the device count (a single ``-1``
    entry absorbs the remaining devices, and without one the remainder
    goes to ``dp``)."""
    global _global_mesh
    devices = list(devices if devices is not None else visible_devices())
    n = len(devices)
    degrees = dict(degrees or {})
    for ax in degrees:
        if ax not in AXES:
            raise ValueError(f"unknown mesh axis {ax!r}; valid: {AXES}")
    sizes = [degrees.get(ax, 1) for ax in AXES]
    if -1 in sizes:
        i = sizes.index(-1)
        rest = math.prod(s for s in sizes if s != -1)
        if n % rest:
            raise ValueError(f"{n} devices not divisible by {rest}")
        sizes[i] = n // rest
    elif math.prod(sizes) != n:
        if n % math.prod(sizes):
            raise ValueError(
                f"mesh degrees {degrees} (= {math.prod(sizes)}) do not "
                f"divide device count {n}")
        sizes[AXES.index("dp")] *= n // math.prod(sizes)
    _global_mesh = Mesh(tuple(devices), dict(zip(AXES, sizes)))
    return _global_mesh


def reform_mesh(degrees: Optional[Dict[str, int]] = None,
                devices: Optional[Sequence] = None) -> Mesh:
    """Re-form the global mesh after an elastic membership change: the
    installed mesh is dropped and rebuilt from the CURRENT device set
    (all ``dp`` by default), then every :func:`on_reform` hook fires
    with it."""
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
