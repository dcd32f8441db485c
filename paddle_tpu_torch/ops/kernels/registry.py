"""Kernel registry and dispatch for the port's hand-written CUDA kernels.

The counterpart of ``paddle_tpu/ops/pallas/registry.py``.  Every kernel
module registers:

- a **kernel function**: the wrapper that launches the hand-written
  CUDA kernel (built at first use by :mod:`._build`) and adds one to the
  spec's ``launches`` right after a launch that reported no error;
- a **plain version** (``torch_ref``): the same function in plain
  PyTorch, used for CPU tensors and as the oracle;
- the documented **tolerance** between the two;
- an optional **eligibility check** returning ``None`` when the kernel
  takes the call, else the reason it does not.

Routing is by tensor device.  A CUDA tensor launches the kernel or
raises (an ineligible shape raises ``ValueError`` naming the reason;
a failed build or launch raises ``RuntimeError``).  The plain version
runs for CPU tensors, or where a caller passes ``mode="torch_ref"``
explicitly to compare against it.  There is no environment switch and
no silent fallback.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Callable, Dict, Optional

import torch

__all__ = ["KernelSpec", "register", "kernels", "spec", "dispatch",
           "card_error", "launch_counts", "reset_counts", "MODES"]

MODES = ("cuda", "torch_ref")


@dataclass
class KernelSpec:
    """One registered kernel, its plain twin and their counters."""

    name: str
    kernel_fn: Callable
    torch_ref_fn: Callable
    tolerance: str
    eligible_fn: Optional[Callable] = None
    source: str = ""          # the .cu file under ops/kernels/csrc/
    replaces: str = ""        # file:line of the TPU kernel
    doc: str = ""
    launches: int = 0         # kernel launches (bumped by the wrapper)
    torch_ref_calls: int = 0  # plain-version runs


_REGISTRY: Dict[str, KernelSpec] = {}
_lock = threading.Lock()


def register(name: str, kernel_fn: Callable, torch_ref_fn: Callable, *,
             tolerance: str, eligible: Optional[Callable] = None,
             source: str = "", replaces: str = "",
             doc: str = "") -> KernelSpec:
    s = KernelSpec(name=name, kernel_fn=kernel_fn,
                   torch_ref_fn=torch_ref_fn, tolerance=tolerance,
                   eligible_fn=eligible, source=source, replaces=replaces,
                   doc=doc)
    with _lock:
        _REGISTRY[name] = s
    return s


def kernels() -> Dict[str, KernelSpec]:
    with _lock:
        return dict(_REGISTRY)


def spec(name: str) -> KernelSpec:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown kernel {name!r}; registered: "
                       f"{sorted(_REGISTRY)}") from None


def _device_of(args) -> torch.device:
    for a in args:
        if isinstance(a, torch.Tensor):
            return a.device
    raise TypeError("kernel dispatch needs at least one tensor argument")


def dispatch(name: str, *args, mode: Optional[str] = None, **kwargs):
    """Run kernel ``name``: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors, or the route ``mode`` names explicitly."""
    s = spec(name)
    if mode is None:
        mode = "cuda" if _device_of(args).type == "cuda" else "torch_ref"
    elif mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    if mode == "torch_ref":
        s.torch_ref_calls += 1
        return s.torch_ref_fn(*args, **kwargs)
    if s.eligible_fn is not None:
        reason = s.eligible_fn(*args, **kwargs)
        if reason:
            raise ValueError(f"{name}: the CUDA kernel does not take this "
                             f"call: {reason}")
    return s.kernel_fn(*args, **kwargs)


def card_error(got: torch.Tensor, ref: torch.Tensor, tol) -> tuple:
    """A kernel's output ``got`` against its plain version ``ref`` under
    a kernel module's ``CARD_TOL`` entry ``(atol, rtol, row[, whole])``:
    the limit per element is ``atol + rtol * |ref| + row * RMS(ref's last
    axis) + whole * RMS(ref)``.  Returns (largest |got - ref|, largest
    share of its limit an element uses): every element is within iff that
    share is at most 1."""
    atol, rtol, row, *rest = tol
    whole = rest[0] if rest else 0.0
    g, r = got.float(), ref.float()
    err = (g - r).abs()
    lim = atol + rtol * r.abs()
    if row:
        lim = lim + row * r.pow(2).mean(dim=-1, keepdim=True).sqrt()
    if whole:
        lim = lim + whole * r.pow(2).mean().sqrt()
    share = torch.where(err > 0, err / lim, torch.zeros_like(err))
    return err.max().item(), share.max().item()


def launch_counts() -> Dict[str, int]:
    with _lock:
        return {k: s.launches for k, s in _REGISTRY.items()}


def reset_counts() -> None:
    with _lock:
        for s in _REGISTRY.values():
            s.launches = 0
            s.torch_ref_calls = 0
