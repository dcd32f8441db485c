"""Segment sums of embedding-gradient rows: the Hopper kernels and their
plain versions.

Counterpart of ``paddle_tpu/ops/pallas/segment_sum.py``, two kernels:

- ``segment_sum`` (kernel 7, ``_segment_sum_kernel``): ``out[inverse[i]]
  += grads[i]`` for the rows in ascending order, ``out`` [num_segments,
  dim] f32 starting at zero.  The device cache merges a batch's
  duplicate-id gradients with it.
- ``segment_sum_sorted`` (kernel 8, ``_segment_sum_sorted_kernel``): the
  same sum for rows that arrive sorted by segment id, for vocab-scale
  segment counts.  :func:`merge_segments` (the streaming trainer's
  pre-merge) picks it at ``SORTED_NSEG_MIN`` segments or more, after a
  stable host argsort of the inverse and a gather of the rows into that
  order on the card.

Both versions add each segment's rows in ascending row order, from 0.0,
so they are bitwise equal to each other and to the native host merge
(``ps_segsum_inv``):

- the CUDA kernel (``csrc/segment_sum.cu``) gets a stable order of the
  rows by segment and each segment's range in it, both built on the host
  from the host ``inverse`` (numpy, as the cache's plan gives it), and
  one thread sums one (segment, column);
- the sorted CUDA kernel (``csrc/segment_sum_sorted.cu``) gets the sorted
  ids, and one thread finds its segment's rows by binary search and sums
  one (segment, column);
- the plain versions add by occurrence rank: round k adds the k-th row of
  every segment with one ``index_add_`` whose indices are unique.

So with the same rows in the same order, kernel 8 is bitwise kernel 7.
Segment ids are host arrays of ints in ``[0, num_segments)``; CUDA ids are
refused (no caller has device-side ids yet).
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _build, registry

__all__ = ["segment_sum", "segment_sum_ref", "segment_plan",
           "segment_sum_planned", "segment_sum_sorted",
           "segment_sum_sorted_ref", "segment_sum_sorted_planned",
           "merge_segments", "SORTED_NSEG_MIN"]

_SOURCE = "segment_sum.cu"
_SORTED_SOURCE = "segment_sum_sorted.cu"

# segment count at which merge_segments takes the sorted kernel (the
# reference's threshold)
SORTED_NSEG_MIN = 4096


def segment_sum_ref(grads: torch.Tensor, inverse, num_segments: int):
    """The plain version, bitwise the kernel's order (module docstring)."""
    g = grads.to(torch.float32).reshape(-1, grads.shape[-1])
    inv = torch.from_numpy(
        np.ascontiguousarray(inverse, np.int64).reshape(-1)).to(g.device)
    out = torch.zeros((num_segments, g.shape[1]), dtype=torch.float32,
                      device=g.device)
    if inv.numel() == 0:
        return out
    # rank of each row among its segment's rows, in row order
    _, perm = torch.sort(inv, stable=True)
    counts = torch.bincount(inv, minlength=num_segments)
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.empty_like(perm)
    pos[perm] = torch.arange(inv.numel(), device=g.device)
    rank = pos - starts[inv]
    # rows grouped by rank: round k holds one row per segment at most
    by_rank = torch.argsort(rank, stable=True)
    sizes = torch.bincount(rank).tolist()
    for rows in torch.split(by_rank, sizes):
        out.index_add_(0, inv[rows], g[rows])
    return out


def segment_plan(inverse, num_segments: int, device) -> tuple:
    """``(order, offsets)`` int32 tensors on ``device``: the rows stably
    sorted by segment, and segment s's range ``[offsets[s], offsets[s+1])``
    in that order.  The host ``inverse`` is ordered on the host and both
    arrays are copied in one transfer."""
    inv = np.asarray(inverse).reshape(-1)
    if inv.size and (inv.min() < 0 or inv.max() >= num_segments):
        raise ValueError(f"segment_sum: inverse holds ids outside "
                         f"[0, {num_segments})")
    host = np.empty(inv.size + num_segments + 1, np.int32)
    host[:inv.size] = np.argsort(inv, kind="stable")
    host[inv.size] = 0
    np.cumsum(np.bincount(inv, minlength=num_segments),
              out=host[inv.size + 1:])
    both = torch.from_numpy(host).to(device)
    return both[:inv.size], both[inv.size:]


def _eligible(grads, inverse, num_segments):
    if not grads.is_cuda:
        return "grads must be a CUDA tensor"
    if grads.dtype != torch.float32 or grads.dim() != 2:
        return (f"grads {tuple(grads.shape)} {grads.dtype} (needs [n, dim] "
                "float32)")
    n = grads.shape[0]
    if isinstance(inverse, torch.Tensor):
        return "inverse must be a host (numpy) array"
    inverse = np.asarray(inverse)
    if not np.issubdtype(inverse.dtype, np.integer):
        return f"inverse dtype {inverse.dtype} (needs an integer type)"
    if inverse.size != n:
        return f"inverse of {inverse.shape} for {n} rows"
    if not 0 <= num_segments < 2 ** 31 or n >= 2 ** 31:
        return f"num_segments {num_segments}, n {n} (each below 2**31)"
    return None


def _segment_sum_cuda(grads, inverse, num_segments):
    if num_segments == 0 or grads.shape[1] == 0:
        return torch.zeros((num_segments, grads.shape[1]),
                           dtype=torch.float32, device=grads.device)
    order, offsets = segment_plan(inverse, num_segments, grads.device)
    return segment_sum_planned(grads.contiguous(), order, offsets)


def segment_sum_planned(grads: torch.Tensor, order: torch.Tensor,
                        offsets: torch.Tensor) -> torch.Tensor:
    """Launch the kernel on a plan from :func:`segment_plan`: ``grads``
    [n, dim] contiguous f32, ``order`` [n] and ``offsets`` [nseg + 1]
    int32, all on one card.  No host work, so a caller can time the
    kernel alone."""
    n, dim = grads.shape
    nseg = offsets.numel() - 1
    out = torch.empty((nseg, dim), dtype=torch.float32, device=grads.device)
    lib = _build.load(_SOURCE)
    fn = lib.segment_sum_f32
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    with torch.cuda.device(grads.device):
        stream = torch.cuda.current_stream(grads.device).cuda_stream
        rc = fn(grads.data_ptr(), order.data_ptr(), offsets.data_ptr(),
                out.data_ptr(), nseg, dim, stream)
    _build.check(lib, rc, f"segment_sum n={n} dim={dim} nseg={nseg}")
    _SPEC.launches += 1
    return out


_SPEC = registry.register(
    "segment_sum", _segment_sum_cuda, segment_sum_ref,
    # copied from the reference's registration
    tolerance="measured exact vs xla_ref on this backend; documented "
              "atol 1e-6 (XLA scatter-add ordering is not pinned); "
              "bit-exact for integer-valued grads by construction",
    eligible=_eligible,
    source="paddle_tpu_torch/ops/kernels/csrc/segment_sum.cu",
    replaces="paddle_tpu/ops/pallas/segment_sum.py:58",
    doc="ordered per-segment sum of embedding-gradient rows, one thread "
        "per (segment, column) over a host-built row order: "
        "bitwise the reference's row-order accumulation, no atomics",
)


def segment_sum(grads: torch.Tensor, inverse, num_segments: int, *,
                mode=None) -> torch.Tensor:
    """``grads`` [n, dim] f32, ``inverse`` [n] host ints in
    ``[0, num_segments)``; returns [num_segments, dim] f32."""
    return registry.dispatch("segment_sum", grads, inverse,
                             int(num_segments), mode=mode)


# -- kernel 8: rows sorted by segment ------------------------------------

def segment_sum_sorted_ref(grads: torch.Tensor, seg_sorted,
                           num_segments: int):
    """The plain version: :func:`segment_sum_ref` with the sorted ids as
    the inverse, so each segment's rows add in row order from 0.0, the
    kernel's order."""
    return segment_sum_ref(grads, seg_sorted, num_segments)


def _sorted_eligible(grads, seg_sorted, num_segments):
    if grads.dtype != torch.float32:
        return f"grads dtype {grads.dtype} (needs float32)"
    if grads.dim() != 2:
        return f"grads of shape {tuple(grads.shape)} (needs 2-D [n, dim])"
    n = grads.shape[0]
    if isinstance(seg_sorted, torch.Tensor):
        return "segment ids must be a host (numpy) array"
    seg = np.asarray(seg_sorted)
    if not np.issubdtype(seg.dtype, np.integer):
        return f"segment ids of dtype {seg.dtype} (needs an integer type)"
    if seg.ndim != 1 or seg.size != n:
        return f"segment ids of shape {seg.shape} for {n} rows"
    if not 0 <= num_segments < 2 ** 31 or n >= 2 ** 31 \
            or grads.shape[1] >= 2 ** 31:
        return (f"num_segments {num_segments}, n {n}, dim "
                f"{grads.shape[1]} (each below 2**31)")
    if n and (seg[0] < 0 or seg[-1] >= num_segments):
        return f"segment ids outside [0, {num_segments})"
    if n > 1 and not bool(np.all(seg[1:] >= seg[:-1])):
        return "segment ids are not sorted ascending"
    if not grads.is_cuda:
        return "grads must be a CUDA tensor"
    return None


def _segment_sum_sorted_cuda(grads, seg_sorted, num_segments):
    if num_segments == 0 or grads.shape[1] == 0:
        return torch.zeros((num_segments, grads.shape[1]),
                           dtype=torch.float32, device=grads.device)
    seg = torch.from_numpy(
        np.ascontiguousarray(seg_sorted, np.int32)).to(grads.device)
    return segment_sum_sorted_planned(grads.contiguous(), seg,
                                      int(num_segments))


def segment_sum_sorted_planned(grads: torch.Tensor, seg: torch.Tensor,
                               num_segments: int) -> torch.Tensor:
    """Launch kernel 8 on ``grads`` [n, dim] contiguous f32 and ``seg``
    [n] ascending int32 ids, both on one card.  No host work, so a caller
    can time the kernel alone."""
    n, dim = grads.shape
    out = torch.empty((num_segments, dim), dtype=torch.float32,
                      device=grads.device)
    lib = _build.load(_SORTED_SOURCE)
    fn = lib.segment_sum_sorted_f32
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    with torch.cuda.device(grads.device):
        stream = torch.cuda.current_stream(grads.device).cuda_stream
        rc = fn(grads.data_ptr(), seg.data_ptr(), out.data_ptr(), n,
                num_segments, dim, stream)
    _build.check(lib, rc, f"segment_sum_sorted n={n} dim={dim} "
                          f"nseg={num_segments}")
    registry.note_launch(_SORTED_SPEC)
    return out


_SORTED_SPEC = registry.register(
    "segment_sum_sorted", _segment_sum_sorted_cuda, segment_sum_sorted_ref,
    # copied from the reference's registration
    tolerance="measured exact vs xla_ref on this backend; documented "
              "atol 1e-6 (per-segment accumulation order equals row "
              "order in both); bit-exact for integer-valued grads",
    eligible=_sorted_eligible,
    source="paddle_tpu_torch/ops/kernels/csrc/segment_sum_sorted.cu",
    replaces="paddle_tpu/ops/pallas/segment_sum.py:126",
    doc="per-segment sum of rows sorted by segment id, one thread per "
        "(segment, column) finding its rows by binary search: bitwise "
        "segment_sum on the same merge, no atomics",
)


def segment_sum_sorted(grads: torch.Tensor, seg_sorted, num_segments: int,
                       *, mode=None) -> torch.Tensor:
    """``grads`` [n, dim] f32 in segment order, ``seg_sorted`` [n]
    ascending host ints in ``[0, num_segments)``; returns [num_segments,
    dim] f32, zero where no row lands."""
    return registry.dispatch("segment_sum_sorted", grads, seg_sorted,
                             int(num_segments), mode=mode)


def merge_segments(grads: torch.Tensor, inverse, num_segments: int, *,
                   mode=None) -> torch.Tensor:
    """Sum the rows of ``grads`` [n, dim] by ``inverse`` (host ints in
    ``[0, num_segments)``), dispatching on the segment count as the
    reference does: below ``SORTED_NSEG_MIN`` :func:`segment_sum`, else a
    stable host argsort of ``inverse`` (within a segment the rows keep
    their order, so the sums keep theirs), the rows gathered into that
    order on their device, and :func:`segment_sum_sorted`."""
    num_segments = int(num_segments)
    if num_segments < SORTED_NSEG_MIN:
        return segment_sum(grads, inverse, num_segments, mode=mode)
    inv = np.asarray(inverse).reshape(-1)
    order = np.argsort(inv, kind="stable")
    g = grads.index_select(0, torch.from_numpy(order).to(grads.device))
    return segment_sum_sorted(g, inv[order], num_segments, mode=mode)
