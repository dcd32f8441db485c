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

- the CUDA kernels (one source, ``csrc/segment_sum.cu``) give a block
  tiles of consecutive segments: kernel 7 reads their ranges from a
  stable order of the rows by segment and each segment's range in it,
  both built on the host from the host ``inverse`` (numpy, as the
  cache's plan gives it); kernel 8 finds them in the sorted ids once per
  block.  The block streams its rows into shared memory with independent
  loads, and one thread per column of a segment adds them in row order;
  :func:`segment_tile_plan` is the launch plan;
- the plain versions add by occurrence rank: round k adds the k-th row of
  every segment with one ``index_add_`` whose indices are unique.

So with the same rows in the same order, kernel 8 is bitwise kernel 7.
Segment ids are host arrays of ints in ``[0, num_segments)``; CUDA ids are
refused (no caller has device-side ids yet).
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from . import _build, registry
from .flash_attention import H100_SMS, _sm_count

__all__ = ["segment_sum", "segment_sum_ref", "segment_plan",
           "segment_sum_planned", "segment_tile_plan", "TilePlan",
           "hard_segment_cases",
           "segment_sum_sorted",
           "segment_sum_sorted_ref", "segment_sum_sorted_planned",
           "merge_segments", "SORTED_NSEG_MIN"]

_SOURCE = "segment_sum.cu"          # kernels 7 and 8

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


# the kernels' block (csrc/segment_sum.cu): 256 threads, 4 blocks an SM
# (its launch bounds), a slice of at most 128 columns, up to 16 tiles in
# turn, ring stages of 768 copies
_THREADS, _BLOCKS_PER_SM, _MAX_WIDTH = 256, 4, 128
_MAX_REPS, _STAGE_GROUPS = 16, 768


class TilePlan(NamedTuple):
    """A launch of the segment-sum kernels: ``grid`` = (blocks of
    ``reps`` tiles, column slices), 256 threads each."""

    vec: int      # floats a copy moves (4: 16 bytes)
    width: int    # columns of a block's slice
    tile: int     # consecutive segments a block folds at once
    reps: int     # tiles a block takes in turn
    chunk: int    # rows a ring stage holds
    grid: tuple


def segment_tile_plan(n: int, nseg: int, dim: int, aligned: bool = True,
                      sms: int = H100_SMS) -> TilePlan:
    """The launch plan of kernels 7 and 8 for ``n`` rows of ``dim`` into
    ``nseg`` segments (``aligned``: the rows start on 16 bytes) on a card
    of ``sms`` SMs.

    - A block gives each of its threads one column of one segment, so a
      tile holds ``256 // width`` segments (16 at dim 16: the 6,242- and
      8,192-segment merges give 391 and 512 blocks for the card's 132
      SMs).
    - Where the tiles outnumber the blocks the card holds at once (4 an
      SM: 528 on an H100), a block takes up to 16 tiles in turn, so the
      surplus blocks do not queue behind the first wave, each paying a
      block's fixed latency for an almost-empty tile.
    - Rows are copied ``vec`` floats at a time (16 bytes on 16-byte rows
      of a dim divisible by 4).  A ring stage holds about four average
      tiles' rows: at least 32 and at most 768 copies (192 rows at dim
      16, so with 3 stages in flight a ~550-row hot tile of a Zipf merge
      is one round of loads and few stages to fold, and 4 blocks fit an
      SM), and few at vocab scale.

    Pure arithmetic: it runs without a card."""
    if n < 0 or nseg < 1 or dim < 1:
        raise ValueError(f"segment_tile_plan: n {n}, nseg {nseg}, dim {dim}"
                         " (needs n >= 0, nseg >= 1, dim >= 1)")
    vec = 4 if aligned and dim % 4 == 0 else 1
    width = min(dim, _MAX_WIDTH)
    tile = _THREADS // width
    tiles = -(-nseg // tile)
    reps = min(_MAX_REPS, -(-tiles // (_BLOCKS_PER_SM * sms)))
    want = -(-4 * n * tile // nseg)
    chunk = min(_STAGE_GROUPS * vec // width,
                max(32, -(-want // 32) * 32))
    return TilePlan(vec, width, tile, reps, chunk,
                    (-(-nseg // (tile * reps)), -(-dim // width)))


def hard_segment_cases(rng):
    """The cases that stress the tile design of kernels 7 and 8, for the
    card's checks against the plain versions, as (label, ascending
    segment ids, dim, nseg, rows 16-byte aligned): a 5,000-row segment
    (longer than any ring of staged rows) at dim 16 and 13, all rows on
    one segment, every other segment empty, long segments on both sides
    of a tile's edge (segments 15 and 16: a tile holds 16 at dim 16),
    many tiles a block (200,000 segments: on an H100 a block takes 16
    tiles in turn through 32-row ring stages) with two long segments in
    a later tile, and rows one float off 16-byte alignment (4-byte
    copies).  ``rng`` is a numpy ``Generator``."""
    long = np.sort(np.concatenate([rng.integers(0, 40, 300),
                                   np.full(5000, 40),
                                   rng.integers(41, 128, 300)]))
    edge = np.sort(np.concatenate([np.full(700, 15), np.full(700, 16),
                                   rng.integers(0, 96, 500)]))
    zipf = np.sort(np.minimum(rng.zipf(1.3, 5000) - 1, 2047))
    return [("5,000-row segment", long, 16, 128, True),
            ("5,000-row segment", long, 13, 128, True),
            ("all rows on one segment", np.full(26_624, 3), 16, 8, True),
            ("every other segment empty",
             np.sort(2 * rng.integers(0, 4096, 26_624)), 16, 8192, True),
            ("tile edge in long segments", edge, 16, 96, True),
            ("many tiles a block", np.sort(np.concatenate([
                rng.integers(0, 200_000, 20_000), np.full(700, 33),
                np.full(700, 34)])), 16, 200_000, True),
            ("unaligned rows", zipf, 16, 2048, False)]


def _launch(spec, entry: str, grads, index, nseg: int) -> torch.Tensor:
    """Launch ``entry`` of ``csrc/segment_sum.cu`` on ``grads`` [n, dim]
    contiguous f32 and the int32 tensors ``index`` (kernel 7: order and
    offsets; kernel 8: the sorted ids) under :func:`segment_tile_plan`;
    count the launch on ``spec`` and return the [nseg, dim] output."""
    n, dim = grads.shape
    out = torch.empty((nseg, dim), dtype=torch.float32, device=grads.device)
    plan = segment_tile_plan(n, nseg, dim, grads.data_ptr() % 16 == 0,
                             _sm_count(grads.device))
    lib = _build.load(_SOURCE)
    fn = getattr(lib, entry)
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * (2 + len(index)) + [
            ctypes.c_int] * 8 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    with torch.cuda.device(grads.device):
        stream = torch.cuda.current_stream(grads.device).cuda_stream
        rc = fn(grads.data_ptr(), *(t.data_ptr() for t in index),
                out.data_ptr(), n, nseg, dim, plan.tile, plan.reps,
                plan.width, plan.chunk, plan.vec, stream)
    _build.check(lib, rc, f"{spec.name} n={n} dim={dim} nseg={nseg}")
    registry.note_launch(spec)
    return out


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
    return _launch(_SPEC, "segment_sum_f32", grads, (order, offsets),
                   offsets.numel() - 1)


_SPEC = registry.register(
    "segment_sum", _segment_sum_cuda, segment_sum_ref,
    # copied from the reference's registration
    tolerance="measured exact vs xla_ref on this backend; documented "
              "atol 1e-6 (XLA scatter-add ordering is not pinned); "
              "bit-exact for integer-valued grads by construction",
    eligible=_eligible,
    source="paddle_tpu_torch/ops/kernels/csrc/segment_sum.cu",
    replaces="paddle_tpu/ops/pallas/segment_sum.py:58",
    doc="ordered per-segment sum of embedding-gradient rows over a "
        "host-built row order: a block stages a tile of segments' rows in "
        "shared memory and folds each segment in row order, bitwise the "
        "reference's row-order accumulation, no atomics",
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
    return _launch(_SORTED_SPEC, "segment_sum_sorted_f32", grads, (seg,),
                   num_segments)


_SORTED_SPEC = registry.register(
    "segment_sum_sorted", _segment_sum_sorted_cuda, segment_sum_sorted_ref,
    # copied from the reference's registration
    tolerance="measured exact vs xla_ref on this backend; documented "
              "atol 1e-6 (per-segment accumulation order equals row "
              "order in both); bit-exact for integer-valued grads",
    eligible=_sorted_eligible,
    source="paddle_tpu_torch/ops/kernels/csrc/segment_sum.cu",
    replaces="paddle_tpu/ops/pallas/segment_sum.py:126",
    doc="per-segment sum of rows sorted by segment id: a block finds its "
        "tile of segments' rows once, stages them in shared memory and "
        "folds each segment in row order, bitwise segment_sum on the same "
        "merge, no atomics",
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
