"""Fused optimizer apply over a flat f32 ZeRO shard: the Hopper kernel and
its plain version.

Counterpart of ``paddle_tpu/ops/pallas/opt_apply.py`` (kernel 5,
``_opt_apply_kernel``).  The elastic data plane's flat optimizers
(``distributed/fleet/elastic.py`` ``_FlatSGD/_FlatMomentum/_FlatAdam``)
update a contiguous f32 shard of the global parameter vector; one call
reads p, g and the moment slots once and writes p' and the slots once:
``(3 + 2 * slots) * 4 * N`` bytes (the reference's docstring counts one
vector fewer).

Bitwise contract.  Kernel, plain version and the host numpy engine
compute the same expressions in the same order, each operation rounded
once to f32:

- the kernel with explicit round-to-nearest intrinsics (no FMA
  contraction, correctly rounded division and square root, no flushed
  denormals);
- the plain version with one PyTorch operation per step, the hyper
  scalars as 0-d tensors on the data's device (PyTorch's CUDA division
  by a Python or CPU scalar multiplies by the reciprocal instead), and
  the square root taken in f64 and rounded to f32: PyTorch's f32
  ``sqrt`` on the CPU is not correctly rounded on every build;
- numpy, whose f32 operations and ``sqrt`` are correctly rounded.

So the three agree bit for bit, and a shard's update is bitwise the same
slice of the full vector's update (the update is elementwise).  Against
the JAX reference the port agrees only up to FMA contraction: XLA on the
CPU contracts multiply-adds, so the JAX package's device and host
engines differ by about 1 ulp on about 1 % of elements.

Hyper-parameter layout (``hyper`` f32 ``[1, 9]``, see ``_H_*``):
``[lr, b1, b2, eps, c1, c2, mu, 1 - b1, 1 - b2]``.  ``c1``/``c2`` (Adam's
bias corrections) are computed on the host from the global step exactly
as the numpy engine computes them.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _build, registry

__all__ = ["KINDS", "SLOTS", "HYPER_LEN", "CARD_TOL", "pack_hyper",
           "opt_apply", "opt_apply_ref"]

_SOURCE = "opt_apply.cu"

KINDS = ("sgd", "momentum", "adam")
# moment-vector names per optimizer kind, in argument order
SLOTS = {"sgd": (), "momentum": ("u",), "adam": ("m", "v")}

# hyper vector layout: index -> meaning
_H_LR, _H_B1, _H_B2, _H_EPS, _H_C1, _H_C2, _H_MU = range(7)
_H_OMB1, _H_OMB2 = 7, 8
HYPER_LEN = 9

# kernel against plain version on the card: bitwise
CARD_TOL = (0.0, 0.0, 0.0)


def pack_hyper(kind: str, *, lr, betas=(0.9, 0.999), eps=1e-8,
               momentum=0.9, t: int = 1) -> np.ndarray:
    """Build the f32 hyper vector.  ``c1/c2`` are computed exactly as
    the numpy engine does (python-float pow, one f32 rounding)."""
    h = np.zeros((1, HYPER_LEN), np.float32)
    h[0, _H_LR] = np.float32(lr)
    h[0, _H_B1] = np.float32(betas[0])
    h[0, _H_B2] = np.float32(betas[1])
    h[0, _H_EPS] = np.float32(eps)
    h[0, _H_C1] = np.float32(1.0 - float(betas[0]) ** int(t))
    h[0, _H_C2] = np.float32(1.0 - float(betas[1]) ** int(t))
    h[0, _H_MU] = np.float32(momentum)
    h[0, _H_OMB1] = np.float32(1) - np.float32(betas[0])
    h[0, _H_OMB2] = np.float32(1) - np.float32(betas[1])
    return h


def _hyper_values(hyper) -> np.ndarray:
    if isinstance(hyper, torch.Tensor):
        hyper = hyper.detach().cpu().numpy()
    h = np.asarray(hyper, np.float32).reshape(-1)
    if h.size != HYPER_LEN:
        raise ValueError(f"hyper has {h.size} values, want {HYPER_LEN}")
    return h


def _check_kind(kind, slots):
    if kind not in KINDS:
        raise ValueError(f"unknown optimizer kind {kind!r} "
                         f"(expected one of {KINDS})")
    if len(slots) != len(SLOTS[kind]):
        raise ValueError(f"{kind} takes slots {SLOTS[kind]}, got "
                         f"{len(slots)} slot tensors")


def opt_apply_ref(kind, p, g, slots, hyper):
    """The plain version: the reference's expressions, one PyTorch
    operation each, in its order.  Returns ``(p', *slots')``."""
    slots = tuple(slots)
    _check_kind(kind, slots)
    h = _hyper_values(hyper)

    def hy(i):
        return torch.tensor(h[i], dtype=torch.float32, device=p.device)

    lr = hy(_H_LR)
    if kind == "sgd":
        return (p - lr * g,)
    if kind == "momentum":
        (u,) = slots
        u_n = hy(_H_MU) * u + g
        return p - lr * u_n, u_n
    m, v = slots
    m_n = hy(_H_B1) * m + hy(_H_OMB1) * g
    v_n = hy(_H_B2) * v + hy(_H_OMB2) * g * g
    mhat = m_n / hy(_H_C1)
    vhat = v_n / hy(_H_C2)
    root = torch.sqrt(vhat.double()).float()    # correctly rounded
    return p - lr * mhat / (root + hy(_H_EPS)), m_n, v_n


def _eligible(kind, p, g, slots, hyper):
    if kind not in KINDS:
        return f"unknown optimizer kind {kind!r}"
    if len(slots) != len(SLOTS[kind]):
        return f"{kind} takes {len(SLOTS[kind])} slots, got {len(slots)}"
    ts = (p, g) + tuple(slots)
    if not all(isinstance(t, torch.Tensor) and t.is_cuda for t in ts):
        return "p, g and the slots must be CUDA tensors"
    if any(t.device != p.device for t in ts):
        return "p, g and the slots must lie on one device"
    for name, t in zip(("p", "g") + SLOTS[kind], ts):
        if t.dtype != torch.float32:
            return f"{name} is {t.dtype} (needs float32)"
        if t.dim() != 1:
            return f"{name} has shape {tuple(t.shape)} (needs a flat [N])"
        if not t.is_contiguous():
            return f"{name} is not contiguous"
        if t.numel() != p.numel():
            return f"{name} has {t.numel()} elements, p has {p.numel()}"
    return None


def _opt_apply_cuda(kind, p, g, slots, hyper):
    h = _hyper_values(hyper)
    n = p.numel()
    outs = tuple(torch.empty_like(p) for _ in range(1 + len(slots)))
    if n == 0:
        return outs
    lib = _build.load(_SOURCE)
    fn = lib.opt_apply_f32
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 7
                       + [ctypes.c_longlong] + [ctypes.c_float] * HYPER_LEN
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    ins = [s.data_ptr() for s in slots] + [None] * (2 - len(slots))
    outp = [o.data_ptr() for o in outs[1:]] + [None] * (2 - len(slots))
    with torch.cuda.device(p.device):
        stream = torch.cuda.current_stream(p.device).cuda_stream
        rc = fn(KINDS.index(kind), p.data_ptr(), g.data_ptr(), *ins,
                outs[0].data_ptr(), *outp, n, *(float(x) for x in h),
                stream)
    _build.check(lib, rc, f"opt_apply {kind} n={n}")
    registry.note_launch(_SPEC)
    return outs


_SPEC = registry.register(
    "opt_apply", _opt_apply_cuda, opt_apply_ref,
    # copied from the reference's registration
    tolerance="bit-exact vs xla_ref (np.array_equal); host-numpy "
              "engine differs <=~1 ulp on ~1% of elements (XLA CPU "
              "FMA contraction, documented in the module docstring)",
    eligible=_eligible,
    source="paddle_tpu_torch/ops/kernels/csrc/opt_apply.cu",
    replaces="paddle_tpu/ops/pallas/opt_apply.py:117",
    doc="fused sgd/momentum/adam apply over a flat ZeRO shard: one "
        "pass reading grad+param+moments, writing param+moments",
)


def opt_apply(kind: str, p: torch.Tensor, g: torch.Tensor, slots,
              hyper, *, mode=None):
    """One ``kind`` update of the flat f32 shard ``p`` with gradient
    ``g`` and moment ``slots`` (``SLOTS[kind]`` order) under the
    ``pack_hyper`` vector ``hyper``.  Out of place: returns
    ``(p', *slots')``."""
    return registry.dispatch("opt_apply", kind, p, g, tuple(slots), hyper,
                             mode=mode)
