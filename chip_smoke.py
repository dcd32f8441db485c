#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``paddle_tpu_torch``) on one NVIDIA H100.

Run from the repository root with no arguments (one card)::

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and nothing is caught:

1. header: the card's name and power limit (``nvidia-smi``), torch and
   CUDA versions;
2. build every CUDA kernel from ``paddle_tpu_torch/ops/kernels/csrc``
   (one ``nvcc`` per source, started together) and print the seconds
   and the registers/shared memory ptxas reports (and the dynamic shared
   memory, tiles and stages of the Hopper flash forward and backward); a
   spill in ``segment_sum.cu`` (kernels 7 and 8) or in the two sm90
   entries of ``flash_attention_bwd.cu`` (kernels 2 and 3), or a wgmma
   that ptxas serialised there, fails;
3. each kernel against its plain PyTorch version on the card, at the
   serving and training shapes and a few more (dtypes, head dims, GQA,
   ragged lengths, the (B, S, H, D) layouts the models pass, verify
   blocks, idle trash-block rows), within the kernel module's
   ``CARD_TOL``, timed with CUDA events (median of 20), beside the least
   time the card could take (``bound_ms``) and, for flash attention,
   PyTorch's ``scaled_dot_product_attention`` (forward, and backward for
   the two backward kernels) as a yardstick the port never calls; the
   bf16 flash forward is held to the blockwise plain version at its own
   key tile (``flash_fwd_plan(...).block_k``), and at its two main-path
   shapes (the 7B prefill, the proxy's forward with the LSE) it, its
   plain version and SDPA are timed queued behind a spinning kernel
   (device time), with the kernel / SDPA ratio beside that of the first
   (``mma.sync``) kernel; the backward kernels also run twice on the
   same inputs and must agree bitwise, and at the proxy they,
   ``attention_delta`` and SDPA's backward are timed the same way;
4. serve ``llama_7b(kv_cache_dtype="int8")`` (bf16 weights drawn from a
   seed) through the port's ``GenerationServer``: 8 greedy requests of
   mixed prompt lengths, 32 new tokens each; the kernel launch counts of
   this run prove prefill went through the flash kernel (32 launches per
   prefill dispatch) and decode through the int8 kernel (32 per step);
5. one prefill and one decode step of the same model with the kernels
   and with their plain versions (``mode="torch_ref"``): the logits must
   agree within the bf16 bound stated below;
6. ``torch.profiler`` over 5 steady decode steps of the same model:
   device busy time against wall time, the top device kernels, and
   kernel 1's device ms per step (0: decode runs no flash forward);
7. train the Llama proxy of the reference's headline training bench
   (hidden 2048, 8 layers, 16 heads, head_dim 128, vocab 32000, seq
   2048, batch 4, stacked layers with per-layer remat; f32 weights from
   a seed) with AdamW at lr 1e-4 and bf16 AMP through the port's
   ``DistributedTrainStep``: 10 steps on seeded random ids (labels =
   ids); every loss finite, the first near the cross entropy of the
   initial logits (ln(vocab) + hidden * init^2 / 2); ms/step, tokens/s,
   model TFLOP/s and MFU, peak memory; the launch counts of this run
   prove every step went through the flash forward (16: 8 layers plus 8
   remat recomputes) and both backward kernels (8 each);
8. one step's loss and global gradient with the kernels, with their
   plain versions, and from an f32 copy of the weights: the kernel path
   may be at most ``E2E_RATIO_BOUND`` times further from the f32 result
   than the plain path;
9. ``torch.profiler`` over 2 training steps: device busy time against
   wall time, the top device kernels, kernels 1, 2 and 3's device ms per
   step and the largest allocations;
10. serve ``resnet50(num_classes=1000)`` at 224x224 (f32 weights drawn
    from a seed) converted with ``convert_to_int8_inference`` and cast as
    the reference's inference bench casts it (every float tensor but
    ``w_scale`` to bf16), on bf16 NCHW images at batch 1, 32 and 128:
    per-forward ms (median of 20 CUDA-event timings), images/s and peak
    memory, the same for the bf16 model (cuDNN convolutions) and their
    ratio (the bench's ``int8_speedup``); the launch counts prove every
    int8 forward went through ``int8_matmul`` exactly 54 times (53
    convolutions and the classifier);
11. the int8 model's batch-32 logits with the kernel and with its plain
    version (``set_kernel_mode(model, "torch_ref")``) must be bitwise
    equal (integer sums are order-free); for information, the top-1
    agreement of the int8 and the bf16 model;
12. ``torch.profiler`` over 3 batch-32 int8 forwards: device busy time
    against wall time, and the top device kernels;
13. train the reference bench's wide&deep (``bench.py:618-624``, nothing
    cut: 26 fields of 16-wide embeddings over 20,000 Zipf(1.3) ids each,
    13 dense features, hidden 256, batch 1,024; ``RandomState(0)`` draws
    in the bench's order) through ``HeterTrainer(sync_mode=False,
    push_lag=1)``, 2 warm-up and 20 timed batches, on (a) a host
    ``SparseTable`` and (b) a primed ``DeviceCachedTable`` of 79,872
    rows whose dense step leaves its gradients on the card: examples/s,
    ms/step, the first and last timed loss (the last must be lower) and
    (b)'s hit rate; the launch counts prove every push of (b) merged
    through ``segment_sum`` (22 launches) and (a) launched nothing;
14. 8 sync batches through a 16,384-row cache (evictions from the third
    batch on) on the f32 and the q8 wire, each with the kernels and with
    their plain versions (``kernel_mode="torch_ref"``): per wire the
    losses and the host rows of every id seen must be bitwise equal;
15. serve (b)'s trained table through a q8-wire cache over 20 fresh
    batches (pull and the tower's forward): examples/s, the
    ``pull_dequant`` launches, the first batch's rows bitwise the numpy
    dequant of the table's q8 pull, and for information the largest
    logit distance from an f32-wire cache;
16. ``torch.profiler`` over 3 async steps of (b): device busy time against
    wall time, the top device kernels, and the ``segment_sum`` kernels
    that the trainer's pool threads launch;
17. the reference bench's elastic A/B (``bench.py:1372-1468``, nothing
    cut: a linear model of 200,000 f32 parameters, 64 seeded samples,
    batch 8, Adam at lr 0.01, 2 micro-batches, 30 steps, one checkpoint)
    through ``ElasticTrainer`` at world 1 with an in-process coordinator,
    once on the host engine and once on the device engine: steps/s, the
    restore and rebuild ms and reshard bytes off the flight ring, the
    staging peak; the engines' final params, optimizer state and last
    checkpoint must be bitwise equal, the device engine must launch
    ``opt_apply`` once per step plus its rebuild's warm-up, the host
    engine nothing;
18. the same at world 2 (two trainer threads on the card, one
    coordinator) and a world-2 run whose rank 1 leaves after step 10:
    both must end bitwise at phase 17's params, the survivor resharding
    from the pinned step at world 1 and rebuilding at the new shard
    length;
19. 5 device-engine steps at 2^25 + 1 parameters with ``torch.profiler``
    over three of them: device busy time against wall time, the
    ``opt_apply`` kernel, the reduce's adds, the host<->device copies the
    numpy contract of ``fused_optimizer_apply`` forces, and the host ms
    of each stage of a step and of the checkpoint round;
20. the online loop at full width: a primary ``PSServer`` with one
    ``SparseTable(dim=16, sgd, lr=0.05)``, a read replica and a
    ``FeatureLifecycle`` sweeper; ``StreamingTrainer(device_merge=True)``
    on the card over phase 13's 22 wide&deep batches (2 warm-up, 20
    timed; ~6,250 unique of 26,624 ids a batch), each step pulling its
    rows through the client and running phase 13's dense tower on the
    card: events/s, ms per batch, the first and last timed loss (the last
    must be lower), ``ps_freshness_ms`` p50/p99, the replica's watermark
    (it must reach the trainer's seq, and its table the primary's); the
    launch counts prove every batch merged through ``segment_sum_sorted``
    (22 launches, no plain call); after the run a sweep past the TTL
    evicts every id but the last batch's on both, the replica still
    bitwise the primary;
21. the same stream with the plain versions (``kernel_mode="torch_ref"``)
    and with the numpy merge (``device_merge=False``): both primary tables
    bitwise phase 20's;
22. the stream under the ``lost_ack`` and ``dup`` chaos plans, and a
    trainer that dies three pushes past its cursor checkpoint, restarted
    in-process from it: both end bitwise at phase 20's table, with
    duplicate acks;
23. ``torch.profiler`` over 3 streaming batches: device busy time
    against wall time, the ``segment_sum_sorted`` kernels in the trace,
    and the host ms of the pull RPC, the dense step, the merge and the
    push RPC;
24. train the reference bench's ResNet-50 (``bench.py:320-364``, nothing
    cut: ``resnet50(num_classes=1000)``, NCHW, f32 weights from a seed,
    one fixed batch of 256 224x224 images and labels drawn by
    ``RandomState(0)`` as the bench draws them) through the bf16-AMP
    ``DistributedTrainStep`` with ``Momentum(0.1, 0.9)`` and
    ``cross_entropy``: 12 steps, every loss finite; ms/step (median of
    steps 3-12), images/s, model TFLOP/s and MFU from the bench's
    analytic count, peak memory; the launch counts of this run are 0 for
    every registered kernel, by design (the reference's ResNet training
    runs no Pallas kernel);
25. at batch 64, one bf16-AMP step against the same step from the f32
    weights in f32: the loss within 2 %, the running statistics' move
    within 2 % relative RMS, the gradients' cosine printed beside a
    control (the f32 step on bf16-rounded weights and images) and
    required positive;
26. forward hooks on the 32 bottleneck 1x1 convolutions of one training
    step of phase 24's model: kernel 10 on each conv's input as [M, K]
    with its weight as [K, N] must match the conv output within
    ``CARD_TOL`` and ``s1 / M`` the batch mean the port's batch norm
    takes; the one-pass variance ``s2 / M - (s1 / M)^2`` is printed
    against the two-pass one;
27. the A/B entry point (``paddle_tpu_torch.tools.exp_conv_bn_kernel``):
    kernel 10 against ``torch.matmul`` followed by the two reductions at
    the eight bottleneck shapes, and the "fused wins" verdict;
28. ``torch.profiler`` over 2 ResNet-50 training steps: device busy time
    against wall time, the top device kernels, device time by kernel
    class and under the batch-norm, convolution, loss, pooling and
    optimizer ranges, and the largest allocations.

Every profiled phase (6, 9, 12, 16, 19, 23, 28) prints the idle share
``1 - busy / wall`` unclamped and fails when busy exceeds wall.

Phase 3 also holds ``int8_matmul`` against its plain version at the
ResNet-50 GEMMs of batch 32 (and at batch 1) with the int8 model's bf16
output (the stem also with f32 output): dynamic mode bitwise,
weight-only within the module's ``CARD_TOL``; each is timed beside its
bound and beside ``torch._int_mm`` plus its scale pass, which compute
the same function and which the port never calls.  It holds
``segment_sum_sorted`` bitwise against its plain version (the first
wide&deep batch's merge, 26,624 x 16 into 6,242 segments; 256 x 16 into
200,000; integer gradients; n = 1; dim 13; the hard cases of the
port's ``hard_segment_cases``: a 5,000-row segment at dim 16 and 13, all rows
on one segment, every other segment empty, long segments on both sides
of a tile's edge, many tiles a block, unaligned rows; each run twice)
and, through ``merge_segments``, against ``segment_sum`` on the same
unsorted merge,
timed at the first two shapes beside ``torch.segment_reduce`` and
``index_add_``.  It holds
``segment_sum`` (at the wide&deep push: 26,624 rows of dim 16 into
8,192 segments; integer gradients; n = 1; dim 13; the same hard cases
with their rows shuffled; each run twice) and
``pull_dequant`` (6,242 x 16, 1 x 16, 4,097 x 13, 1,000 x 4,096, zero
rows) bitwise against their plain versions, times each kernel queued
behind a spinning kernel beside its byte bound and beside
``index_add_`` and ``torch.mul`` as yardsticks the port never calls.
It holds ``opt_apply`` (sgd, momentum, adam) bitwise against its plain
version at the elastic bench's 200,000-element shard, its world-2
halves, odd lengths, an unaligned view, a late step and a scheduled lr,
each run twice, and counts the elements that differ from the host numpy
engine (expected 0); Adam also at the Llama proxy's 535.9 M parameters,
compared slice by slice; timed beside its byte bound and beside
``torch._fused_adam_``, ``torch._fused_sgd_`` with momentum and
``torch.add`` (SGD), which round differently and are timed only.  It
holds ``conv_bn_stats`` (kernel 10) within its ``CARD_TOL`` at the eight
ResNet-50 batch-256 bottleneck 1x1 shapes and two tails, bitwise over
two runs, timed beside its bound, ``matmul_then_stats`` (its library
yardstick) and ``torch.matmul`` alone.

The 7B serving model is freed before phase 7, and the training model
before phase 10, and the peak-memory counter reset, so each workload
reports its own peak.  Before the last line it prints one JSON object
``{"kernels": [...]}`` (launches summed over the serving run of phase 4,
the training run of phase 7, the ResNet run of phase 10, the wide&deep
run (b) of phase 13, the q8 serving run of phase 15, the elastic runs
of phases 17 and 18, the online run of phase 20, the ResNet training
of phase 24 and the A/B of phase 27); the last line is ``{"ok": true, "device": {...}}``.  Exits non-zero, printing no
result, without a CUDA device or without the package.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import math
import os
import pathlib
import re
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

SEED = 1234
# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, f32
# outside the tensor cores, HBM3 bandwidth
PEAK_BF16_FLOPS = 989e12
PEAK_INT8_OPS = 1979e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
# end to end (phases 5 and 8): the bf16 logits (serving) or loss and
# global gradient (training) with kernels may be at most this many times
# further from the same weights in f32 than those with plain versions
E2E_RATIO_BOUND = 2.0
# phase 8's loss check also passes within this absolute distance from the
# f32 loss (1e-4 of ln(32000)): a plain-path loss that lands by chance
# next to the f32 one must not fail a kernel path that is as close as
# bf16 allows
E2E_LOSS_FLOOR = 1e-3
TRAIN_STEPS = 10
TRAIN_BATCH, TRAIN_SEQ = 4, 2048     # the proxy bench's batch and length
RESNET_BATCHES = (1, 32, 128)        # of the reference bench's 1, 8, 32, 128
RESNET_GEMMS = 54                    # 53 convolutions and the classifier
# the reference bench's wide&deep (bench.py:618-624, non-smoke): 26
# sparse fields of 16-wide embeddings over 20,000 ids each, 13 dense
# features, hidden 256, batch 1,024, 20 timed steps
WIDE_DEEP = dict(n_slots=26, dim=16, vocab=20_000, n_dense=13, hidden=256,
                 batch=1024, steps=20)
# phase 14's cache: below the ~27,400 ids of its 8 batches, so rows are
# evicted and written back from the third batch on
WIDE_DEEP_E2E_CAPACITY = 16_384
# the reference bench's elastic A/B (bench.py:1372-1468, non-smoke): a
# linear model of 200,000 f32 parameters (w [199,999] and a scalar b),
# 64 seeded samples, batch 8, shuffle seed 3, drop_last, Adam at lr 0.01,
# 2 micro-batches, 30 steps, one checkpoint at the end
ELASTIC = dict(numel=200_000, samples=64, batch=8, shuffle_seed=3, lr=0.01,
               micro=2, steps=30, ckpt_every=30)
# phase 19's shard: 2^25 + 1 f32 parameters (134 MB a vector)
ELASTIC_PROFILE_NUMEL = (1 << 25) + 1
# the reference bench's ResNet-50 training (bench.py:320-364, non-smoke):
# batch 256 of 224x224 NCHW images, 1000 classes, Momentum(0.1, 0.9),
# bf16 AMP; 12 steps here, timed over steps 3-12
RESNET_TRAIN = dict(batch=256, hw=224, classes=1000, steps=12, lr=0.1,
                    momentum=0.9)
# the bench's analytic count: ~4.1 GFLOP a 224x224 image forward, and a
# training step ~3x the forward
RESNET_TRAIN_FLOPS = 3 * 4.1e9
# phase 25: the bf16-AMP step against f32 at this batch (memory), with
# the loss within E2E_AMP_LOSS_REL and the running statistics' move
# within E2E_AMP_STATS_RRMS relative RMS of the f32 step's
RESNET_TRAIN_F32_BATCH = 64
E2E_AMP_LOSS_REL = 0.02
E2E_AMP_STATS_RRMS = 0.02


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def queued_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Device time per call of ``fn``: the calls are queued behind a
    spinning kernel, so the CUDA events around them time the device and
    not the host's launch overhead."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()                                     # the host's time per call
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    # spin (at most ~2 GHz) for twice the time the host needs to queue
    torch.cuda._sleep(int(2e9 * max(0.05, 2 * iters * host_s)))
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / iters


def bound_ms(flops: float, peak_flops: float, nbytes: float):
    t_ops = flops / peak_flops * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


# the port's ``record_function`` ranges (batch norm in training, the
# step's optimizer update); the profiler also lists their device-side
# spans, which cover kernels and must not be counted as kernels
ANNOTATIONS = ("batch_norm", "optimizer")


def device_kernels(avgs):
    """The device kernels among a profile's ``key_averages()``: CUDA
    events that are not the device side of a ``record_function``
    range."""
    from torch.autograd import DeviceType
    return [e for e in avgs if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and e.key not in ANNOTATIONS]


def log_flash_fwd(label, kern, steps):
    """Kernel 1's device ms and launches per step in a profile (its
    kernels' names start with ``flash_fwd``)."""
    mine = [e for e in kern if "flash_fwd" in e.key]
    ms = sum(e.self_device_time_total for e in mine) / 1e3 / steps
    n = sum(e.count for e in mine) / steps
    log(f"{label}: kernel 1 (flash forward) {ms:.3f} device ms/step over "
        f"{n:g} launches/step " + ", ".join(e.key[:40] for e in mine))


def log_flash_bwd(label, kern, steps):
    """Kernels 2 and 3's device ms and launches per step in a profile
    (the Hopper route's ``flash_bwd_sm90<true>`` / ``<false>``, the first
    kernels' ``flash_bwd_dkv_*`` / ``flash_bwd_dq_*``)."""
    for which, keys in (("kernel 2 (dK/dV)", ("flash_bwd_sm90<true>",
                                                "flash_bwd_dkv")),
                        ("kernel 3 (dQ)", ("flash_bwd_sm90<false>",
                                           "flash_bwd_dq"))):
        mine = [e for e in kern if any(k in e.key for k in keys)]
        ms = sum(e.self_device_time_total for e in mine) / 1e3 / steps
        n = sum(e.count for e in mine) / steps
        log(f"{label}: {which} {ms:.3f} device ms/step over {n:g} "
            f"launches/step")


def check_busy(label, busy_ms, wall_ms):
    """A profiled window's device busy time cannot exceed its wall time;
    if it does, kernels were counted twice and the idle share is
    wrong."""
    if busy_ms > wall_ms:
        fail(f"{label}: device busy {busy_ms:.3f} ms exceeds the wall "
             f"{wall_ms:.3f} ms (kernels counted twice?)")


def check_close(label, got, ref, tol):
    """Fail unless the kernel's ``got`` is within the kernel module's
    ``CARD_TOL`` entry ``tol`` of its plain version's ``ref``; returns
    the largest |got - ref| and the largest share of its limit an
    element uses."""
    from paddle_tpu_torch.ops.kernels.registry import card_error
    if not bool(torch.isfinite(got.float()).all()):
        fail(f"{label}: non-finite kernel output")
    err, share = card_error(got, ref, tol)
    if not share <= 1.0:
        fail(f"{label}: max |err| {err:.3g}; an element uses {share:.3g} "
             f"of its limit (atol, rtol, row) {tol}")
    return err, share


# ---------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------

# kernel 1's time over SDPA's at its two main-path shapes in the first
# (mma.sync) kernel, CUDA events around one call (PERF.md section 6)
FLASH_MMA_SYNC_SDPA_RATIO = {"7B prefill": 4.63, "proxy with lse": 4.74}


def flash_timing(label, q, k, v, return_lse):
    """Kernel 1, its plain version and SDPA at one main-path shape, each
    queued behind a spinning kernel (device time, not the wrapper's host
    time); the kernel and SDPA twice, in turns, the lower of each kept.
    Returns the kernels-line numbers."""
    import torch.nn.functional as tF

    from paddle_tpu_torch.ops.kernels.flash_attention import (
        flash_attention_bhsd, flash_fwd_plan)
    B, H, S, D = q.shape
    plan = flash_fwd_plan(q, k, v)

    def kern():
        return flash_attention_bhsd(q, k, v, causal=True,
                                    return_lse=return_lse)

    def lib():
        return tF.scaled_dot_product_attention(q, k, v, is_causal=True)

    with torch.no_grad():
        runs = [(queued_ms(kern), queued_ms(lib)) for _ in range(2)]
        plain = queued_ms(lambda: flash_attention_bhsd(
            q, k, v, causal=True, return_lse=return_lse, mode="torch_ref"),
            iters=5, warmup=1)
    ms, lib_ms = (min(r[i] for r in runs) for i in (0, 1))
    pairs = B * H * S * (S + 1) / 2          # causal (q, k) pairs
    nbytes = 4 * B * H * S * D * q.element_size() + (
        B * H * S * 4 if return_lse else 0)
    bms, by = bound_ms(4 * D * pairs, PEAK_BF16_FLOPS, nbytes)
    log(f"flash_attention {label} (B={B} H={H} S={S} D={D} bf16 causal"
        f"{', lse' if return_lse else ''}): route {plan.route}, tiles "
        f"{plan.block_q} query rows x {plan.block_k} keys, {plan.stages} "
        f"K/V stages, {plan.threads} threads, {plan.smem_bytes} B shared "
        f"memory, grid {plan.grid}; device ms (queued): kernel {ms:.4f} "
        f"plain {plain:.4f} bound {bms:.4f} ({by}) library(sdpa) "
        f"{lib_ms:.4f}; kernel / sdpa {ms / lib_ms:.3f} (the mma.sync "
        f"kernel's {FLASH_MMA_SYNC_SDPA_RATIO[label]}); "
        f"{4 * D * pairs / ms / 1e9:.1f} "
        f"TFLOP/s")
    return dict(ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by,
                library_ms=lib_ms)


def flash_cases(dev):
    from paddle_tpu_torch.ops.kernels.flash_attention import (
        CARD_TOL, flash_attention, flash_attention_bhsd,
        flash_attention_blockwise_ref, flash_fwd_plan)
    g = torch.Generator(device=dev).manual_seed(SEED)

    row = None
    bf = torch.bfloat16
    cases = [  # (B, H, Hkv, S, D, dtype, causal, layout)
        (1, 32, 32, 2048, 128, bf, True, "bhsd"),  # 7B prefill
        (4, 32, 32, 1024, 128, bf, True, "bshd"),  # as served
        (2, 8, 2, 1000, 128, bf, False, "bhsd"),   # GQA, ragged
        (1, 8, 2, 777, 128, bf, True, "bshd"),     # GQA, ragged, served
        (1, 4, 1, 130, 128, bf, True, "bhsd"),     # one key past a tile
        (2, 4, 4, 300, 128, bf, False, "bshd"),
        (1, 8, 8, 512, 128, torch.float32, True, "bhsd"),
        (2, 8, 8, 1000, 64, bf, False, "bhsd"),
        (1, 8, 2, 777, 256, bf, True, "bhsd"),
        (1, 4, 4, 300, 64, torch.float32, False, "bhsd"),
        (1, 4, 2, 130, 256, torch.float32, True, "bhsd"),
    ]
    for i, (B, H, Hkv, S, D, dt, causal, layout) in enumerate(cases):
        if layout == "bshd":
            # the server's batched prefill: (B, S, H, D) tensors through
            # flash_attention, so the kernel reads strided head views
            q, k, v = [torch.randn(B, S, h, D, device=dev, dtype=dt,
                                   generator=g) for h in (H, Hkv, Hkv)]
            o = flash_attention(q, k, v, causal=causal).transpose(1, 2)
            q, k, v = (t.transpose(1, 2) for t in (q, k, v))
            lse = None
        else:
            q, k, v = [torch.randn(B, h, S, D, device=dev, dtype=dt,
                                   generator=g) for h in (H, Hkv, Hkv)]
            o, lse = flash_attention_bhsd(q, k, v, causal=causal,
                                          return_lse=True)
        ro, rl = flash_attention_bhsd(q, k, v, causal=causal,
                                      return_lse=True, mode="torch_ref")
        # bf16: the kernel rounds P to bf16 before P.V against the running
        # max of its key tiles; the blockwise plain version does the same
        # at the kernel's key tile, and the kernel is held to it
        plan = flash_fwd_plan(q, k, v)
        rp = (flash_attention_blockwise_ref(q, k, v, causal=causal,
                                            block_k=plan.block_k)
              if dt == torch.bfloat16 else ro)
        torch.cuda.synchronize()
        dname = str(dt).replace("torch.", "")
        shape = f"B={B} H={H} Hkv={Hkv} S={S} D={D} {dname} causal={causal}"
        err, share = check_close(f"flash_attention {shape}", o, rp,
                                 CARD_TOL[dt])
        late = (o.float() - rp.float())[:, :, S // 2:].abs().max().item()
        late_o = rp[:, :, S // 2:].float().abs().median().item()
        full = (o.float() - ro.float()).abs().max().item()
        msg = (f"flash_attention {shape} {layout} ({plan.route}, block_k "
               f"{plan.block_k}): max_err {err:.3g}, {share:.3g} of its "
               f"limit; rows >= S/2 {late:.3g} at a median |o| "
               f"{late_o:.3g}; vs the chunked f32 plain version {full:.3g}")
        if lse is not None:
            lerr = (lse - rl).abs().max().item()
            if lerr > 1e-3:
                fail(f"flash_attention lse: max |err| {lerr:.3g} > 1e-3")
            msg += f" lse_err {lerr:.3g}"
        log(msg)
        if i == 0:
            row = dict(max_abs_err=err,
                       **flash_timing("7B prefill", q, k, v, False))
    return row


def _flash_grads(q, k, v, g, causal, mode=None):
    """dq, dk, dv of ``flash_attention`` on (B, S, H, D) tensors through
    the autograd Function, as the model's attention calls it."""
    from paddle_tpu_torch.ops.kernels.flash_attention import flash_attention
    qq, kk, vv = (t.detach().requires_grad_() for t in (q, k, v))
    o = flash_attention(qq, kk, vv, causal=causal, mode=mode)
    return torch.autograd.grad(o, (qq, kk, vv), g)


def bwd_timing(label, args, o, gh):
    """Kernels 2 and 3, ``attention_delta`` and SDPA's backward at the
    proxy, each queued behind a spinning kernel (device time), twice in
    turns, the lower of each kept; the plain versions between CUDA
    events.  Returns the kernels-line rows of both kernels."""
    import torch.nn.functional as tF

    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    from paddle_tpu_torch.ops.kernels import registry
    qh, kh, vh, do = args[:4]
    B, H, S, D = qh.shape
    names = ("flash_attention_bwd_dkv", "flash_attention_bwd_dq")
    plan = fa.flash_bwd_plan(qh, kh, vh, do, causal=True)
    kw = dict(causal=True)
    # SDPA's backward on contiguous copies (its own layout)
    q2, k2, v2 = (t.detach().contiguous().requires_grad_()
                  for t in (qh, kh, vh))
    out = tF.scaled_dot_product_attention(q2, k2, v2, is_causal=True)
    do2 = gh.contiguous()
    calls = {
        names[0]: lambda: registry.dispatch(names[0], *args, **kw),
        names[1]: lambda: registry.dispatch(names[1], *args, **kw),
        "attention_delta": lambda: fa.attention_delta(o, gh),
        "sdpa backward": lambda: torch.autograd.grad(
            out, (q2, k2, v2), do2, retain_graph=True)}
    runs = [{n: queued_ms(f) for n, f in calls.items()} for _ in range(2)]
    ms = {n: min(r[n] for r in runs) for n in calls}
    plain = {n: cuda_ms(lambda n=n: registry.dispatch(
        n, *args, mode="torch_ref", **kw), iters=5, warmup=1)
        for n in names}
    total = ms[names[0]] + ms[names[1]] + ms["attention_delta"]
    lib = ms["sdpa backward"]
    pairs = B * H * S * (S + 1) / 2          # causal (q, k) pairs
    elt = qh.element_size()
    row_bytes = B * H * S * D * elt
    stats_bytes = 2 * B * H * S * 4           # lse and delta
    rows = {}
    for name, kp, flop_per_pair, n_rows in (
            (names[0], plan.dkv, 8 * D, 6), (names[1], plan.dq, 6 * D, 5)):
        bms, by = bound_ms(flop_per_pair * pairs, PEAK_BF16_FLOPS,
                           n_rows * row_bytes + stats_bytes)
        rows[name] = dict(ms=ms[name], plain_ms=plain[name], bound_ms=bms,
                          bound_by=by, library_ms=lib)
        log(f"{name} {label} (B={B} H={H} S={S} D={D} bf16 causal): route "
            f"{plan.route}, {kp.block_res} resident rows x {kp.block_str}"
            f"-row streamed tiles, {kp.stages} stages, {kp.threads} "
            f"threads, {kp.smem_bytes} B shared memory, grid {kp.grid} "
            f"over {kp.items} items ({kp.tiles} streamed tiles); device ms "
            f"(queued): kernel {ms[name]:.4f} plain {plain[name]:.4f} bound "
            f"{bms:.4f} ({by}); {flop_per_pair * pairs / ms[name] / 1e9:.1f}"
            f" TFLOP/s; runs {[round(r[name], 4) for r in runs]}")
    log(f"flash backward {label}: device ms (queued, the lower of two "
        f"turns): dK/dV {ms[names[0]]:.4f} + dQ {ms[names[1]]:.4f} + "
        f"attention_delta {ms['attention_delta']:.4f} = {total:.4f}; "
        f"library(sdpa backward, dq+dk+dv) {lib:.4f}; kernels / sdpa "
        f"{(ms[names[0]] + ms[names[1]]) / lib:.3f}, with delta "
        f"{total / lib:.3f}")
    del out, q2, k2, v2
    return rows


def bwd_cases(dev):
    """Both backward kernels against their plain versions: the training
    shape (first case) and more dtypes, head dims, GQA, ragged lengths,
    all as (B, S, H, D) tensors through the autograd Function, so the
    kernels read the views the model passes.  Returns the kernels-line
    rows of both kernels; also prints the flash forward's time at the
    training shape."""
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    g0 = torch.Generator(device=dev).manual_seed(SEED + 3)
    rows = {}
    bf = torch.bfloat16
    cases = [  # (B, H, Hkv, S, D, dtype, causal); first = the proxy
        (4, 16, 16, 2048, 128, bf, True),
        # the Hopper route (bf16, head_dim 128): GQA and ragged, one key
        # past a tile, not causal, a single work item, more items than
        # SMs
        (1, 8, 2, 777, 128, bf, True),
        (1, 4, 4, 130, 128, bf, True),
        (2, 4, 4, 1000, 128, bf, False),
        (1, 1, 1, 100, 128, bf, True),
        (1, 8, 8, 4096, 128, bf, True),
        # the first kernels
        (1, 8, 8, 512, 64, torch.float32, True),
        (2, 8, 2, 1000, 64, bf, False),
        (1, 4, 4, 777, 256, bf, True),
        (1, 4, 2, 300, 256, torch.float32, False),
        (2, 4, 4, 130, 128, torch.float32, True),
    ]
    for i, (B, H, Hkv, S, D, dt, causal) in enumerate(cases):
        q, k, v, g = [torch.randn(B, S, h, D, device=dev, dtype=dt,
                                  generator=g0) for h in (H, Hkv, Hkv, H)]
        got = _flash_grads(q, k, v, g, causal)
        again = _flash_grads(q, k, v, g, causal)
        torch.cuda.synchronize()
        dname = str(dt).replace("torch.", "")
        shape = f"B={B} H={H} Hkv={Hkv} S={S} D={D} {dname} causal={causal}"
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            fail(f"flash backward {shape}: a rerun on the same inputs is "
                 "not bitwise equal")
        qh, kh, vh, gh = (t.transpose(1, 2) for t in (q, k, v, g))
        plan = fa.flash_bwd_plan(qh, kh, vh, gh, causal=causal)
        o, lse = fa.flash_attention_bhsd(qh, kh, vh, causal=causal,
                                         return_lse=True)
        delta = fa.attention_delta(o, gh)
        args = (qh, kh, vh, gh, lse, delta)
        # bf16: the kernels round P and dS to bf16 before their products;
        # the blockwise plain version does the same, and they are held
        # to it; the chunked f32 plain version is printed beside
        chunked = (fa.flash_attention_bwd_dq_ref(*args, causal=causal),
                   *fa.flash_attention_bwd_dkv_ref(*args, causal=causal))
        ref = (fa.flash_attention_bwd_blockwise_ref(*args, causal=causal)
               if dt == torch.bfloat16 else chunked)
        torch.cuda.synchronize()
        errs = {}
        msg = (f"flash backward {shape} (B, S, H, D) views, taken as they "
               f"lie: {all(plan.as_is.values())}; route {plan.route}, grid "
               f"{plan.dkv.grid} / {plan.dq.grid} over {plan.dkv.items} / "
               f"{plan.dq.items} items:")
        for name, a, r, c in zip(("dq", "dk", "dv"), got, ref, chunked):
            a = a.transpose(1, 2)
            err, share = check_close(f"flash backward {name} {shape}", a, r,
                                     fa.CARD_TOL_BWD[dt])
            full = (a.float() - c.float()).abs().max().item()
            errs[name] = err
            msg += (f" {name} max_err {err:.3g} ({share:.3g} of its limit, "
                    f"median |ref| {r.float().abs().median().item():.3g}, "
                    f"vs chunked f32 {full:.3g});")
        log(msg + " rerun bitwise equal")
        if i:
            continue
        timed = bwd_timing("training shape", args, o, gh)
        for name, grads in (("flash_attention_bwd_dkv", ("dk", "dv")),
                            ("flash_attention_bwd_dq", ("dq",))):
            rows[name] = dict(max_abs_err=max(errs[x] for x in grads),
                              **timed[name])
        # the forward at the training shape, on contiguous copies so that
        # SDPA times its own layout (the kernel takes both)
        flash_timing("proxy with lse", *(t.detach().contiguous()
                                         for t in (qh, kh, vh)), True)
    return rows


def kv_case(dev, B, S, H, KH, D, bs, M, dt, trash_rows=0, full=True):
    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    nb = B * M + 1
    kpool = torch.randint(-127, 128, (nb, bs, KH, D), device=dev,
                          dtype=torch.int8, generator=g)
    vpool = torch.randint(-127, 128, (nb, bs, KH, D), device=dev,
                          dtype=torch.int8, generator=g)
    ks = torch.rand(nb, bs, device=dev, generator=g) * 0.01 + 1e-3
    vs = torch.rand(nb, bs, device=dev, generator=g) * 0.01 + 1e-3
    perm = torch.randperm(nb - 1, device=dev, generator=g) + 1
    tbl = perm[:B * M].reshape(B, M).to(torch.int32)
    T = M * bs
    if full:
        last = torch.full((B,), T - S, device=dev)
    else:
        last = torch.randint(0, T - S + 1, (B,), device=dev, generator=g)
    pos = (last[:, None] + torch.arange(S, device=dev)[None]).to(torch.int32)
    if trash_rows:
        tbl[-trash_rows:] = 0
        pos[-trash_rows:] = 0
    qh = torch.randn(B, S, H, D, device=dev, dtype=dt, generator=g)
    return qh, kpool, vpool, ks, vs, tbl, pos, KH


def kv_cases(dev):
    from paddle_tpu_torch.ops.kernels.kv_attention import (
        CARD_TOL, int8_paged_attention)
    row = None
    cases = [  # (B, S, H, KH, D, bs, M, dtype, trash); first = 7B decode
        (8, 1, 32, 32, 128, 16, 128, torch.bfloat16, 0),
        (8, 1, 32, 32, 128, 16, 128, torch.float32, 2),
        (8, 3, 32, 8, 128, 16, 128, torch.float32, 2),
        (4, 3, 32, 8, 128, 16, 128, torch.bfloat16, 1),
        (3, 1, 8, 8, 64, 8, 40, torch.float32, 1),
        (3, 2, 8, 2, 256, 32, 20, torch.float32, 1),
    ]
    for i, (B, S, H, KH, D, bs, M, dt, trash) in enumerate(cases):
        args = kv_case(dev, B, S, H, KH, D, bs, M, dt, trash, full=(i == 0))
        got = int8_paged_attention(*args)
        ref = int8_paged_attention(*args, mode="torch_ref")
        torch.cuda.synchronize()
        dname = str(dt).replace("torch.", "")
        shape = (f"B={B} S={S} H={H} KH={KH} D={D} bs={bs} T={M * bs} "
                 f"{dname} trash_rows={trash}")
        err, share = check_close(f"int8_kv_attention {shape}", got, ref,
                                 CARD_TOL[dt])
        log(f"int8_kv_attention {shape}: max_err {err:.3g}, {share:.3g} of "
            f"its limit; median |o| "
            f"{ref.float().abs().median().item():.3g}")
        if i == 0:
            ms = cuda_ms(lambda: int8_paged_attention(*args))
            plain = cuda_ms(lambda: int8_paged_attention(
                *args, mode="torch_ref"))
            pos = args[6]
            valid = int((pos.max(dim=1).values + 1).sum().item())  # tokens
            nbytes = (valid * KH * D * 2            # int8 K and V rows
                      + valid * 4 * 2               # their f32 scales
                      + 2 * args[0].numel() * args[0].element_size()
                      + args[5].numel() * 4 + pos.numel() * 4)
            flops = 4 * D * H * S * valid           # q.k and p.v per row
            bms, by = bound_ms(flops, PEAK_F32_FLOPS, nbytes)
            row = dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bms,
                       bound_by=by, library_ms=None)
            log(f"int8_kv_attention 7B decode shape: kernel_ms {ms:.4f} "
                f"plain_ms {plain:.4f} bound_ms {bms:.4f} ({by}) "
                f"library_ms n/a (no single PyTorch call)")
    return row


def _int_mm_library(x, w_nk, scale, cdt):
    """``torch._int_mm`` (cuBLASLt's int8 GEMM) and the same scale pass:
    the yardstick, never called by the port.  It takes K padded to a
    multiple of 8 and M > 16."""
    k = x.shape[1]
    if k % 8:
        pad = 8 - k % 8
        x = torch.nn.functional.pad(x, (0, pad))
        w_nk = torch.nn.functional.pad(w_nk, (0, pad))
    wt = w_nk.t()
    return lambda: (torch._int_mm(x, wt).float() * scale).to(cdt)


def int8_cases(dev):
    """``int8_matmul`` at the ResNet-50 GEMMs of batch 32 (M = batch x
    output pixels, K = C_in x kh x kw, N = C_out) with bf16 output, as
    the int8 model calls it (the stem also with f32 output, as the
    reference's convolution calls its kernel), the batch-1 ones that
    stress small M, and weight-only at the classifier's shape."""
    from paddle_tpu_torch.ops.kernels import int8_matmul as im
    g = torch.Generator(device=dev).manual_seed(SEED + 4)
    row = None
    cases = [  # (label, M, K, N, compute dtype, dynamic); first = stem
        ("conv1 7x7/2 b32", 401408, 147, 64, torch.bfloat16, True),
        ("conv1 7x7/2 b32", 401408, 147, 64, torch.float32, True),
        ("layer1 3x3 b32", 100352, 576, 64, torch.bfloat16, True),
        ("layer3 3x3 b32", 6272, 2304, 256, torch.bfloat16, True),
        ("layer4 3x3 b32", 1568, 4608, 512, torch.bfloat16, True),
        ("fc b32", 32, 2048, 1000, torch.bfloat16, True),
        ("layer4 3x3 b1", 49, 4608, 512, torch.bfloat16, True),
        ("fc b1", 1, 2048, 1000, torch.bfloat16, True),
        ("fc b32 weight-only", 32, 2048, 1000, torch.bfloat16, False),
        ("fc b32 weight-only", 32, 2048, 1000, torch.float32, False),
    ]
    for i, (label, M, K, N, cdt, dyn) in enumerate(cases):
        w = torch.randint(-127, 128, (N, K), device=dev, dtype=torch.int8,
                          generator=g)
        ws = torch.rand(N, device=dev, generator=g) * 1e-2 + 1e-4
        if dyn:
            x = torch.randint(-127, 128, (M, K), device=dev,
                              dtype=torch.int8, generator=g)
            xs = torch.tensor(0.0123, device=dev)
        else:
            x = torch.randn(M, K, device=dev, dtype=cdt, generator=g)
            xs = None

        def run(mode=None):
            return im.int8_matmul(x, w, ws, x_scale=xs, compute_dtype=cdt,
                                  mode=mode)

        got, ref = run(), run("torch_ref")
        torch.cuda.synchronize()
        dname = str(cdt).replace("torch.", "")
        shape = f"{label} M={M} K={K} N={N} {dname}"
        if not bool(torch.isfinite(got.float()).all()):
            fail(f"int8_matmul {shape}: non-finite kernel output")
        if dyn:
            if not torch.equal(got, ref):
                d = (got.float() - ref.float()).abs().max().item()
                fail(f"int8_matmul {shape}: not bitwise equal to the plain "
                     f"version (max |diff| {d:.3g})")
            err, verdict = 0.0, "bitwise equal"
        else:
            err, share = check_close(f"int8_matmul {shape}", got, ref,
                                     im.CARD_TOL[cdt])
            verdict = f"max_err {err:.3g}, {share:.3g} of its limit"
        ms = queued_ms(run)
        wall = cuda_ms(run)
        plain = queued_ms(lambda: run("torch_ref"))
        out_b = M * N * got.element_size()
        nbytes = M * K * x.element_size() + N * K + 4 * N + out_b
        bms, by = bound_ms(2.0 * M * N * K,
                           PEAK_INT8_OPS if dyn else PEAK_BF16_FLOPS
                           if cdt == torch.bfloat16 else PEAK_F32_FLOPS,
                           nbytes)
        lib = None
        if dyn and M > 16:
            scale = (xs * ws).contiguous()
            lib_fn = _int_mm_library(x, w, scale, cdt)
            if not torch.equal(lib_fn(), ref):
                fail(f"int8_matmul {shape}: torch._int_mm's product differs "
                     "from the plain version")
            lib = queued_ms(lib_fn)
        log(f"int8_matmul {shape} {'dynamic' if dyn else 'weight-only'}: "
            f"{verdict}; kernel_ms {ms:.4f} (one call between events "
            f"{wall:.4f}) plain_ms {plain:.4f} bound_ms {bms:.4f} ({by}) "
            "library_ms(_int_mm + scale) "
            + ("n/a" if lib is None else f"{lib:.4f}"))
        if i == 0:
            row = dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bms,
                       bound_by=by, library_ms=lib)
    return row


# ---------------------------------------------------------------------
# phases 4 and 5: the serving slice at 7B width
# ---------------------------------------------------------------------

def serve(dev, model):
    from paddle_tpu_torch.inference import GenerationServer
    from paddle_tpu_torch.ops.kernels import registry

    srv = GenerationServer(model, num_slots=8, block_size=16,
                           max_model_len=2048, max_prefill_batch=4)
    t0 = time.perf_counter()
    srv.start()          # one warm-up prefill + decode (kernels built)
    log(f"serve: server started in {time.perf_counter() - t0:.2f} s")
    rng = np.random.default_rng(SEED)
    lens = [1900, 1500, 1024, 700, 333, 128, 64, 17]
    prompts = [rng.integers(1, model.config.vocab_size, n).astype(np.int32)
               for n in lens]
    torch.cuda.reset_peak_memory_stats(dev)
    registry.reset_counts()                  # the main path starts here
    t0 = time.perf_counter()
    streams = [srv.submit(p, max_new_tokens=32) for p in prompts]
    outs = [s.result(timeout=900) for s in streams]
    wall = time.perf_counter() - t0
    counts = registry.launch_counts()        # ... and ends here
    st = srv.stats()
    srv.stop()
    V = model.config.vocab_size
    for n, o in zip(lens, outs):
        if len(o) != 32 or not all(0 <= t < V for t in o):
            fail(f"prompt of {n} tokens: got {len(o)} tokens {o[:8]}...")
    pb, ds = st["prefill_batches"], st["decode_steps"]
    L = model.config.num_hidden_layers
    if counts["flash_attention"] < L * pb:
        fail(f"flash launches {counts['flash_attention']} < {L} x {pb} "
             "prefill dispatches")
    if counts["int8_kv_attention"] < L * ds:
        fail(f"int8 launches {counts['int8_kv_attention']} < {L} x {ds} "
             "decode steps")
    if st["free_blocks"] != st["total_blocks"]:
        fail(f"leaked blocks: {st['free_blocks']} free of "
             f"{st['total_blocks']}")
    ttft = sorted(s.ttft_s * 1e3 for s in streams)
    res = dict(prefill_batches=pb, decode_steps=ds,
               prefill_ms_total=st["prefill_ms"],
               decode_ms_per_step=st["decode_ms"] / max(ds, 1),
               ttft_ms_median=statistics.median(ttft), ttft_ms_max=ttft[-1],
               tokens=sum(len(o) for o in outs), wall_s=wall,
               tokens_per_s=sum(len(o) for o in outs) / wall,
               max_memory_allocated_gb=torch.cuda.max_memory_allocated(dev)
               / 1e9, launches=counts)
    log("serve: " + json.dumps(res))
    return counts, res


def _paged_two_steps(model, dev, mode, tok=None):
    """One batched prefill (prompts of 1024 and 333 tokens in a 1024
    bucket) and one decode step on fresh pools; returns the f32 logits
    of both steps and the decode tokens (the argmax of the prefill
    unless ``tok`` is given, so every run decodes the same tokens)."""
    bs, M, B, Lb = 16, 64, 2, 1024
    rng = np.random.default_rng(SEED + 2)
    lens = np.array([1024, 333], np.int32)
    ids = np.zeros((B, Lb), np.int32)
    for i, n in enumerate(lens):
        ids[i, :n] = rng.integers(1, model.config.vocab_size, n)
    tbl = np.arange(1, B * M + 1, dtype=np.int32).reshape(B, M)
    pos = np.broadcast_to(np.arange(Lb, dtype=np.int32), (B, Lb)).copy()
    wm = np.arange(Lb)[None] < lens[:, None]
    T = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa
    pools = model.init_paged_cache(B * M + 1, bs)
    with torch.no_grad():
        lg1, _ = model.forward_paged(T(ids), T(pos), pools, T(tbl), T(wm),
                                     gather_at=T(lens - 1), mode=mode)
        if tok is None:
            tok = lg1[:, -1].argmax(-1).to(torch.int32)[:, None]
        lg2, _ = model.forward_paged(tok, T(lens[:, None]), pools, T(tbl),
                                     T(np.ones((B, 1), bool)), mode=mode)
    torch.cuda.synchronize()
    return (lg1.float(), lg2.float()), tok


def end_to_end(dev, model):
    """The bf16 model with kernels and with plain versions, each against
    the same weights in f32 run with plain versions: the kernel path
    must be no further from the f32 model than E2E_RATIO_BOUND times
    the plain bf16 path (bf16 drift over 32 layers is the noise floor,
    not a fixed number)."""
    from paddle_tpu_torch.text.models import LlamaForCausalLM
    ker, tok = _paged_two_steps(model, dev, None)
    plain, _ = _paged_two_steps(model, dev, "torch_ref", tok)
    cfg32 = dataclasses.replace(model.config, compute_dtype="float32")
    m32 = LlamaForCausalLM(cfg32, device=dev, dtype="float32",
                           generator=torch.Generator(device=dev))
    with torch.no_grad():
        for p32, p16 in zip(m32.parameters(), model.parameters()):
            p32.copy_(p16)
    f32, _ = _paged_two_steps(m32, dev, "torch_ref", tok)
    del m32
    torch.cuda.empty_cache()
    res = {}
    for i, name in enumerate(("prefill", "decode")):
        a, r, ref = ker[i], plain[i], f32[i]
        if not bool(torch.isfinite(a).all()):
            fail(f"end to end {name}: non-finite logits")
        e_k = (a - ref).abs().max().item()
        e_p = (r - ref).abs().max().item()
        d = (a - r).abs().max().item()
        agree = float((a.argmax(-1) == r.argmax(-1)).float().mean().item())
        res[name] = dict(kernel_vs_f32=e_k, plain_vs_f32=e_p,
                         kernel_vs_plain=d, max_abs_f32=ref.abs().max().item(),
                         argmax_agree=agree)
        log(f"end to end {name}: logits {tuple(a.shape)} max|kernel-f32| "
            f"{e_k:.4g} max|plain-f32| {e_p:.4g} max|kernel-plain| {d:.4g} "
            f"max|f32| {res[name]['max_abs_f32']:.4g} argmax agreement "
            f"{agree:.3f}")
        if e_k > E2E_RATIO_BOUND * e_p:
            fail(f"end to end {name}: the kernel path is {e_k:.4g} from the "
                 f"f32 model, over {E2E_RATIO_BOUND} x the plain path's "
                 f"{e_p:.4g}")
    return res


def profile_decode(dev, model, steps: int = 5):
    """torch.profiler over steady decode steps at the serving batch (8
    slots at the serve phase's prompt lengths + 16): device busy time
    against wall time, and the top device ops."""
    from torch.profiler import ProfilerActivity, profile
    bs, M, B = 16, 128, 8
    lens = np.array([1900, 1500, 1024, 700, 333, 128, 64, 17]) + 16
    tbl = np.arange(1, B * M + 1, dtype=np.int32).reshape(B, M)
    T = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa
    pools = model.init_paged_cache(B * M + 1, bs)
    tok = T(np.full((B, 1), 7, np.int32))

    def step(j):
        with torch.no_grad():
            lg, _ = model.forward_paged(
                tok, T((lens + j)[:, None].astype(np.int32)), pools, T(tbl),
                T(np.ones((B, 1), bool)))
            return lg[:, -1].float().argmax(-1).cpu()

    for j in range(3):
        step(j)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for j in range(steps):
            step(3 + j)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    kern = device_kernels(prof.key_averages())
    busy_ms = sum(e.self_device_time_total for e in kern) / 1e3 / steps
    n_kern = sum(e.count for e in kern) // steps
    log(f"profile decode: wall {wall_ms:.2f} ms/step, device busy "
        f"{busy_ms:.2f} ms/step, idle share "
        f"{1 - busy_ms / wall_ms:.4f}, {n_kern} kernels/step")
    # a decode step attends through the int8 kernel; prefill alone runs
    # kernel 1, so this reads 0
    log_flash_fwd("profile decode", kern, steps)
    for e in sorted(kern, key=lambda e: -e.self_device_time_total)[:12]:
        log(f"  {e.key[:70]:70s} {e.self_device_time_total / 1e3 / steps:8.3f}"
            f" ms/step  x{e.count // steps}")
    check_busy("profile decode (phase 6)", busy_ms, wall_ms)


# ---------------------------------------------------------------------
# phases 7, 8 and 9: the training slice at the proxy's full width
# ---------------------------------------------------------------------

def proxy_config(**kw):
    """The reference's Llama training proxy (``bench.py``
    ``_llama_proxy_cfg`` at seq 2048): ~536.6 M parameters."""
    from paddle_tpu_torch.text.models import llama_tiny
    d = dict(vocab_size=32000, hidden_size=2048, intermediate_size=5504,
             num_hidden_layers=8, num_attention_heads=16,
             num_key_value_heads=16, max_position_embeddings=2048,
             scan_layers=True, remat=True)
    d.update(kw)
    return llama_tiny(**d)


def _loss_fn(model):
    def loss_fn(ids, labels, mode=None):
        loss, _ = model(ids, labels=labels, mode=mode)
        return loss
    return loss_fn


def _train_step(model, amp=True):
    from paddle_tpu_torch.distributed.fleet import (DistributedStrategy,
                                                    DistributedTrainStep)
    from paddle_tpu_torch.optimizer import AdamW
    opt = AdamW(learning_rate=1e-4, parameters=model.parameters())
    strategy = DistributedStrategy()
    if amp:
        strategy.amp = True
        strategy.amp_configs = {"dtype": "bfloat16"}
    return DistributedTrainStep(model, _loss_fn(model), opt, strategy)


def train(dev):
    """Phase 7: 10 AdamW steps of the proxy with bf16 AMP."""
    from paddle_tpu_torch.ops.kernels import registry
    from paddle_tpu_torch.text.models import LlamaForCausalLM
    cfg = proxy_config()
    B, S = TRAIN_BATCH, TRAIN_SEQ
    t0 = time.perf_counter()
    model = LlamaForCausalLM(cfg, device=dev, dtype="float32",
                             generator=torch.Generator(device=dev)
                             .manual_seed(SEED))
    step = _train_step(model)
    nparams = sum(p.numel() for p in model.parameters())
    torch.cuda.synchronize()
    log(f"train: proxy f32 weights drawn in {time.perf_counter() - t0:.1f} s "
        f"({nparams / 1e6:.1f} M params)")
    ids = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab_size, (B, S)).astype("int32")).to(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    losses, ms = [], []
    registry.reset_counts()                  # the main path starts here
    for _ in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(step(ids, ids).item())
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    counts = registry.launch_counts()        # ... and ends here
    log("train: losses " + " ".join(f"{x:.6f}" for x in losses))
    if not all(math.isfinite(x) for x in losses):
        fail(f"train: non-finite loss in {losses}")
    # at initialisation the final norm gives unit-RMS hidden states and
    # the LM head N(0, init^2) weights, so the logits are ~N(0, hidden *
    # init^2) and the expected cross entropy is ln(vocab) + that / 2
    first = (math.log(cfg.vocab_size)
             + cfg.hidden_size * cfg.initializer_range ** 2 / 2)
    if abs(losses[0] - first) > 0.1:
        fail(f"train: first loss {losses[0]:.4f} is not near ln(vocab) + "
             f"hidden * init^2 / 2 = {first:.4f}")
    want = dict.fromkeys(counts, 0)
    want.update({"flash_attention": 2 * cfg.num_hidden_layers,
                 "flash_attention_bwd_dkv": cfg.num_hidden_layers,
                 "flash_attention_bwd_dq": cfg.num_hidden_layers})
    per_step = {n: c / TRAIN_STEPS for n, c in counts.items()}
    log(f"train: launches per step {per_step} (want {want})")
    if per_step != want:
        fail(f"train: launches per step {per_step}, want {want}")
    step_ms = statistics.median(ms[2:])      # steps 3..10
    flops = (6.0 * nparams * B * S + 6.0 * cfg.num_hidden_layers * B * S
             * S * cfg.hidden_size)          # bench.py _llama_analytic
    tflops = flops / (step_ms / 1e3) / 1e12
    res = dict(ms_per_step_median_3_10=step_ms, ms_per_step=ms,
               tokens_per_s=B * S / (step_ms / 1e3),
               model_flops_per_step=flops, model_tflops=tflops,
               mfu=tflops * 1e12 / PEAK_BF16_FLOPS, n_params=nparams,
               max_memory_allocated_gb=torch.cuda.max_memory_allocated(dev)
               / 1e9, launches=counts)
    log("train: " + json.dumps(res))
    return model, step, ids, counts


def train_end_to_end(dev, model, step, ids):
    """Phase 8: one step's loss and global gradient with kernels, with
    plain versions, and from an f32 copy of the same weights (plain
    versions, no AMP)."""
    from paddle_tpu_torch.text.models import LlamaForCausalLM
    lk, gk = step.loss_and_grads(ids, ids)
    lp, gp = step.loss_and_grads(ids, ids, "torch_ref")
    cfg32 = dataclasses.replace(model.config, compute_dtype="float32")
    m32 = LlamaForCausalLM(cfg32, device=dev, dtype="float32",
                           generator=torch.Generator(device=dev))
    with torch.no_grad():
        for p32, p in zip(m32.parameters(), model.parameters()):
            p32.copy_(p)
    l32, g32 = _train_step(m32, amp=False).loss_and_grads(ids, ids,
                                                          "torch_ref")
    del m32
    names = [n for n, _ in model.named_parameters()]

    def dist(ga, gb):
        num = sum((a - b).double().pow(2).sum() for a, b in zip(ga, gb))
        return math.sqrt(num.item())

    norm32 = math.sqrt(sum(g.double().pow(2).sum() for g in g32).item())
    e_k, e_p = dist(gk, g32) / norm32, dist(gp, g32) / norm32
    d_kp = dist(gk, gp) / norm32
    lk, lp, l32 = lk.item(), lp.item(), l32.item()
    log(f"train end to end: loss kernels {lk:.6f} plain {lp:.6f} f32 "
        f"{l32:.6f}; global gradient |kernel-f32|/|f32| {e_k:.4g} "
        f"|plain-f32|/|f32| {e_p:.4g} |kernel-plain|/|f32| {d_kp:.4g}")
    for n, a, b, c in zip(names, gk, gp, g32):
        cn = c.double().norm().item()
        log(f"  {n:48s} |kernel-f32| {(a - c).double().norm().item() / cn:.4g}"
            f"  |plain-f32| {(b - c).double().norm().item() / cn:.4g}")
    del gk, gp, g32
    torch.cuda.empty_cache()
    if e_k > E2E_RATIO_BOUND * e_p:
        fail(f"train end to end: the kernel path's gradient is {e_k:.4g} "
             f"from the f32 model's, over {E2E_RATIO_BOUND} x the plain "
             f"path's {e_p:.4g}")
    if abs(lk - l32) > max(E2E_RATIO_BOUND * abs(lp - l32), E2E_LOSS_FLOOR):
        fail(f"train end to end: the kernel path's loss is "
             f"{abs(lk - l32):.4g} from the f32 model's, over "
             f"{E2E_RATIO_BOUND} x the plain path's {abs(lp - l32):.4g} and "
             f"over {E2E_LOSS_FLOOR}")
    return dict(loss_kernel=lk, loss_plain=lp, loss_f32=l32,
                grad_kernel_vs_f32=e_k, grad_plain_vs_f32=e_p)


def profile_train(dev, step, ids, steps: int = 2):
    """Phase 9: torch.profiler over training steps: device busy time
    against wall time, the top device kernels and the ops that allocate
    the most device memory per step."""
    from torch.profiler import ProfilerActivity, profile
    step(ids, ids)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 profile_memory=True) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step(ids, ids)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    avgs = prof.key_averages()
    kern = device_kernels(avgs)
    busy_ms = sum(e.self_device_time_total for e in kern) / 1e3 / steps
    n_kern = sum(e.count for e in kern) // steps
    log(f"profile train: wall {wall_ms:.2f} ms/step, device busy "
        f"{busy_ms:.2f} ms/step, idle share "
        f"{1 - busy_ms / wall_ms:.4f}, {n_kern} kernels/step")
    check_busy("profile train (phase 9)", busy_ms, wall_ms)
    log_flash_fwd("profile train", kern, steps)
    log_flash_bwd("profile train", kern, steps)
    for e in sorted(kern, key=lambda e: -e.self_device_time_total)[:15]:
        log(f"  {e.key[:70]:70s} {e.self_device_time_total / 1e3 / steps:8.3f}"
            f" ms/step  x{e.count // steps}")

    def mem(e, inclusive=False):
        return getattr(e, "device_memory_usage" if inclusive
                       else "self_device_memory_usage", 0) or 0

    ranked = sorted(avgs, key=lambda e: -mem(e))
    log("profile train: device memory allocated by op itself (GB/step):")
    for e in ranked[:8]:
        log(f"  {e.key[:60]:60s} {mem(e) / 1e9 / steps:8.3f} GB/step"
            f"  x{e.count // steps}")
    # the stacked weights' gradients: unbind's backward stacks each
    # parameter's L per-layer bf16 gradients into one [L, ...] tensor
    # (~0.81 GB/step for the proxy's decoder); select's backward would
    # allocate a full [L, ...] zero gradient for every layer instead
    log("profile train: gradient bytes of the stacked parameters, "
        "allocations under the autograd node (GB/step):")
    for e in ranked:
        if "UnbindBackward" in e.key or "SelectBackward" in e.key:
            log(f"  {e.key[:60]:60s} {mem(e, True) / 1e9 / steps:8.3f} "
                f"GB/step  x{e.count // steps}")


# ---------------------------------------------------------------------
# phases 10, 11 and 12: int8 ResNet-50 inference
# ---------------------------------------------------------------------

def _cast_bf16(model):
    """The reference inference bench's cast: every float parameter and
    buffer to bf16 but the int8 layers' ``w_scale`` (int8 codes stay)."""
    for mod in model.modules():
        for p in mod.parameters(recurse=False):
            if p.dtype == torch.float32:
                p.data = p.data.to(torch.bfloat16)
        for name, b in mod.named_buffers(recurse=False):
            if b.dtype == torch.float32 and name != "w_scale":
                mod._buffers[name] = b.to(torch.bfloat16)
    return model


def resnet_models(dev):
    """The bf16 ResNet-50 and its int8 conversion, both from the same f32
    weights drawn from the seed (the bench draws both from one seed)."""
    from paddle_tpu_torch.quantization import convert_to_int8_inference
    from paddle_tpu_torch.vision.models import resnet50

    def make():
        return resnet50(num_classes=1000, device=dev,
                        generator=torch.Generator(device=dev)
                        .manual_seed(SEED))

    return (_cast_bf16(make().eval()),
            _cast_bf16(convert_to_int8_inference(make())))


def _images(dev, b):
    g = torch.Generator(device=dev).manual_seed(SEED + 5 + b)
    return torch.randn(b, 3, 224, 224, device=dev, generator=g).to(
        torch.bfloat16)


def resnet_serve(dev, bf16_model, int8_model):
    """Phase 10: per-forward latency, images/s and peak memory of both
    models at each batch; every int8 forward must launch the kernel
    exactly RESNET_GEMMS times."""
    from paddle_tpu_torch.ops.kernels import registry
    torch.backends.cudnn.benchmark = True     # the bf16 yardstick's best
    forwards = 0

    def int8_fwd(x):
        nonlocal forwards
        forwards += 1
        return int8_model(x)

    res = []
    registry.reset_counts()                  # the main path starts here
    with torch.no_grad():
        for b in RESNET_BATCHES:
            x = _images(dev, b)
            row = dict(batch=b)
            for name, fn in (("int8", int8_fwd), ("bf16", bf16_model)):
                y = fn(x)
                torch.cuda.synchronize()
                if y.shape != (b, 1000) or not bool(
                        torch.isfinite(y.float()).all()):
                    fail(f"resnet50 {name} batch {b}: logits "
                         f"{tuple(y.shape)}, finite "
                         f"{bool(torch.isfinite(y.float()).all())}")
                del y
                torch.cuda.reset_peak_memory_stats(dev)
                ms = cuda_ms(lambda: fn(x))
                row[f"{name}_ms"] = ms
                row[f"{name}_images_per_s"] = b / (ms / 1e3)
                row[f"{name}_max_memory_allocated_gb"] = (
                    torch.cuda.max_memory_allocated(dev) / 1e9)
                row[f"{name}_device_busy_ms"] = profile_calls(
                    lambda: fn(x))[1]
            row["int8_speedup"] = row["bf16_ms"] / row["int8_ms"]
            res.append(row)
            log("resnet50 serve: " + json.dumps(row))
    counts = registry.launch_counts()        # ... and ends here
    want = dict.fromkeys(counts, 0)
    want["int8_matmul"] = RESNET_GEMMS * forwards
    log(f"resnet50 serve: {forwards} int8 forwards, launches {counts} "
        f"(want {want})")
    if counts != want:
        fail(f"resnet50 serve: launches {counts}, want {want}")
    torch.backends.cudnn.benchmark = False
    return counts, res


def resnet_end_to_end(dev, bf16_model, int8_model):
    """Phase 11: the int8 logits with the kernel and with its plain
    version must be bitwise equal; top-1 agreement with the bf16 model
    for information."""
    from paddle_tpu_torch.quantization import set_kernel_mode
    x = _images(dev, 32)
    with torch.no_grad():
        ker = int8_model(x)
        set_kernel_mode(int8_model, "torch_ref")
        try:
            plain = int8_model(x)
        finally:
            set_kernel_mode(int8_model, None)
        ref = bf16_model(x)
    torch.cuda.synchronize()
    equal = torch.equal(ker, plain)
    agree = (ker.argmax(-1) == ref.argmax(-1)).float().mean().item()
    dist = ((ker.float() - ref.float()).abs().max()
            / ref.float().abs().max()).item()
    log(f"resnet50 end to end (batch 32): int8 logits with the kernel "
        f"{'bitwise equal to' if equal else 'DIFFER from'} those with its "
        f"plain version; top-1 agreement with the bf16 model {agree:.4f}; "
        f"max|int8 - bf16| / max|bf16| {dist:.4g}")
    if not equal:
        d = (ker.float() - plain.float()).abs().max().item()
        fail(f"resnet50 end to end: int8 logits with the kernel differ "
             f"from the plain version's by up to {d:.4g}")
    return dict(bitwise_equal=equal, top1_agreement=agree,
                rel_dist_to_bf16=dist)


def profile_calls(fn, calls: int = 3):
    """torch.profiler over ``calls`` calls of ``fn`` after one warm-up:
    (wall ms per call, device busy ms per call, the device kernels'
    averages)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / calls
    kern = device_kernels(prof.key_averages())
    busy_ms = sum(e.self_device_time_total for e in kern) / 1e3 / calls
    return wall_ms, busy_ms, kern


def profile_resnet(dev, int8_model, forwards: int = 3):
    """Phase 12: torch.profiler over batch-32 int8 forwards."""
    x = _images(dev, 32)
    with torch.no_grad():
        wall_ms, busy_ms, kern = profile_calls(lambda: int8_model(x),
                                               forwards)
    n_kern = sum(e.count for e in kern) // forwards
    log(f"profile resnet50 int8 batch 32: wall {wall_ms:.2f} ms/forward, "
        f"device busy {busy_ms:.2f} ms/forward, idle share "
        f"{1 - busy_ms / wall_ms:.4f}, {n_kern} kernels/forward")
    check_busy("profile resnet50 (phase 12)", busy_ms, wall_ms)
    for e in sorted(kern, key=lambda e: -e.self_device_time_total)[:15]:
        log(f"  {e.key[:70]:70s} {e.self_device_time_total / 1e3 / forwards:8.3f}"
            f" ms/forward  x{e.count // forwards}")


# ---------------------------------------------------------------------
# phase 3 (PS kernels) and phases 13-16: wide&deep through the PS path
# ---------------------------------------------------------------------

def _bucket(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length()


def wide_deep_data(extra_batches: int = 0):
    """The reference bench's wide&deep draws (``bench.py:662-714``, full
    size) with ``RandomState(0)`` in its order: w1, w2, wide_w, the Zipf
    ids of every batch, then each batch's dense features and labels.
    ``extra_batches`` more batches of the same distribution follow from
    the same generator (the serving phase's fresh traffic).  Returns
    (params as numpy [w1, b1, w2, wide_w], batches, extra batches)."""
    W = WIDE_DEEP
    rng = np.random.RandomState(0)
    w1 = (rng.randn(W["n_slots"] * W["dim"] + W["n_dense"], W["hidden"])
          * 0.05).astype(np.float32)
    w2 = (rng.randn(W["hidden"], 1) * 0.05).astype(np.float32)
    wide_w = (rng.randn(W["n_dense"], 1) * 0.05).astype(np.float32)
    params = [w1, np.zeros(W["hidden"], np.float32), w2, wide_w]

    def draw(steps):
        zipf = np.clip(rng.zipf(1.3, size=(steps, W["batch"],
                                           W["n_slots"])), 1, W["vocab"])
        out = []
        for i in range(steps):
            ids = ((zipf[i] - 1) + np.arange(W["n_slots"]) * W["vocab"]
                   ).astype(np.int64)
            dense = rng.rand(W["batch"], W["n_dense"]).astype(np.float32)
            out.append((ids, dense, (dense[:, 0] > 0.5).astype(np.float32)))
        return out

    batches = draw(W["steps"])
    return params, batches, draw(extra_batches) if extra_batches else []


class WideDeepTower:
    """The dense tower of ``bench.py:671-684`` in torch autograd: a deep
    MLP over the concatenated embeddings and dense features plus a wide
    linear term, logits clipped to +-15, BCE with logits as
    ``logaddexp(0, l) - l * y``, SGD 0.05 on the dense weights.  Losses
    stay on the card until :meth:`fetch`."""

    def __init__(self, params, dev):
        self.dev = dev
        self.p = [torch.from_numpy(a).to(dev) for a in params]
        self.losses = []

    def logits(self, emb, dense, p=None):
        w1, b1, w2, wide_w = p or self.p
        x = torch.cat([emb.reshape(dense.shape[0], -1), dense], 1)
        h = torch.relu(x @ w1 + b1)
        return torch.clamp((h @ w2 + dense @ wide_w)[:, 0], -15, 15)

    def step(self, embs, batch):
        """``HeterTrainer``'s dense step: (loss, {"slots": d loss / d rows})
        with the gradient left on the card."""
        emb = torch.as_tensor(embs["slots"]).to(self.dev).requires_grad_()
        p = [t.requires_grad_() for t in self.p]
        dense = torch.from_numpy(batch[1]).to(self.dev)
        label = torch.from_numpy(batch[2]).to(self.dev)
        logit = self.logits(emb, dense, p)
        loss = torch.mean(torch.logaddexp(torch.zeros_like(logit), logit)
                          - logit * label)
        *gp, ge = torch.autograd.grad(loss, p + [emb])
        self.p = [t.detach() - 0.05 * g for t, g in zip(p, gp)]
        self.losses.append(loss.detach())
        return self.losses[-1], {"slots": ge.reshape(-1, emb.shape[-1])}

    def fetch(self):
        return torch.stack(self.losses).cpu().numpy()


def _segment_grads(n, d, integer, aligned, dev, gen):
    """Seeded [n, d] f32 gradients on the card; not ``aligned``: a view
    one float into its buffer."""
    if integer:
        return torch.randint(-50, 50, (n, d), device=dev,
                             generator=gen).float()
    if aligned:
        return torch.randn(n, d, device=dev, generator=gen)
    return torch.randn(n * d + 1, device=dev, generator=gen)[1:].view(n, d)


def _tile_note(plan, per_seg):
    return (f"longest segment {int(per_seg.max())} rows; plan: {plan.tile} "
            f"segments a tile, {plan.reps} tiles a block, "
            f"{plan.grid[0] * plan.grid[1]} blocks, "
            f"{plan.chunk}-row ring stages, {4 * plan.vec}-byte copies")


def ps_cases(dev, batches):
    """Phase 3 for the PS kernels: ``segment_sum`` and ``pull_dequant``
    against their plain versions, bitwise, at the wide&deep shapes, odd
    ones and (``segment_sum``) the hard cases, rows shuffled; the timed
    push logs its longest segment and launch plan; returns their
    kernels-line rows."""
    from paddle_tpu_torch.distributed.fleet.ps import (dequantize_rows_q8,
                                                       quantize_rows_q8)
    from paddle_tpu_torch.ops.kernels.pull_dequant import pull_dequant
    from paddle_tpu_torch.ops.kernels.segment_sum import (
        hard_segment_cases, segment_plan, segment_sum, segment_sum_planned,
        segment_tile_plan)
    g0 = torch.Generator(device=dev).manual_seed(SEED + 5)
    rng = np.random.default_rng(SEED)
    rows = {}
    _, push_inv = np.unique(batches[0][0].reshape(-1), return_inverse=True)
    push_nseg = _bucket(int(push_inv.max()) + 1)
    dim = WIDE_DEEP["dim"]
    cases = [  # (label, inverse, dim, nseg, integer gradients, aligned)
        ("wide&deep push", push_inv, dim, push_nseg, False, True),
        ("integer grads", rng.integers(0, 7, 64), 5, 8, True, True),
        ("n=1", np.zeros(1, np.int64), dim, 1, False, True),
        ("dim 13", np.minimum(rng.zipf(1.3, 5000) - 1, 999), 13, 1024,
         False, True)]
    # the hard cases with their rows in shuffled order
    cases += [(label, seg[rng.permutation(seg.size)], d, nseg, False, al)
              for label, seg, d, nseg, al in hard_segment_cases(rng)]
    for i, (label, inv, d, nseg, integer, aligned) in enumerate(cases):
        n = inv.size
        g = _segment_grads(n, d, integer, aligned, dev, g0)
        ref = segment_sum(g, inv, nseg, mode="torch_ref")
        got = [segment_sum(g, inv, nseg) for _ in range(2)]
        torch.cuda.synchronize()
        shape = f"{label} n={n} dim={d} nseg={nseg}"
        err = (got[0] - ref).abs().max().item()
        if not (torch.equal(got[0], got[1]) and torch.equal(got[0], ref)):
            fail(f"segment_sum {shape}: not bitwise equal to the plain "
                 f"version or to its rerun (max |diff| {err:.3g})")
        msg = (f"segment_sum {shape}: bitwise equal to the plain version "
               "and on a rerun")
        if i:
            log(msg)
            continue
        per_seg = np.bincount(inv, minlength=nseg)
        order, offsets = segment_plan(inv, nseg, dev)
        inv_t = torch.from_numpy(inv).to(dev)
        ms = queued_ms(lambda: segment_sum_planned(g, order, offsets))
        wrapper_ms = cuda_ms(lambda: segment_sum(g, inv, nseg))
        plain = cuda_ms(lambda: segment_sum(g, inv, nseg, mode="torch_ref"))

        def lib_fn():
            return torch.zeros(nseg, d, device=dev).index_add_(0, inv_t, g)

        lib_err = (lib_fn() - ref).abs().max().item()
        lib = queued_ms(lib_fn)
        # what the kernel reads once (f32 rows, int32 order [n] and
        # offsets [nseg + 1]) and writes once (the f32 output)
        nbytes = n * d * 4 + n * 4 + (nseg + 1) * 4 + nseg * d * 4
        bms, by = bound_ms(n * d, PEAK_F32_FLOPS, nbytes)
        rows["segment_sum"] = dict(max_abs_err=err, ms=ms, plain_ms=plain,
                                   bound_ms=bms, bound_by=by,
                                   library_ms=lib)
        plan = segment_tile_plan(
            n, nseg, d, sms=torch.cuda.get_device_properties(dev)
            .multi_processor_count)
        log(f"{msg}; {int((per_seg > 0).sum())} segments in use, "
            f"{_tile_note(plan, per_seg)}; kernel_ms {ms:.4f} "
            f"(wrapper with the host plan and its copy, one call between "
            f"events {wrapper_ms:.4f}) plain_ms {plain:.4f} bound_ms "
            f"{bms:.6f} ({by}) library_ms(index_add_) {lib:.4f} (max "
            f"|index_add_ - plain| {lib_err:.3g})")
    for i, (m, d, zero) in enumerate(((6242, 16, 5), (1, 16, 0),
                                      (4097, 13, 3), (1000, 4096, 7),
                                      (512, 16, 1))):
        x = rng.standard_normal((m, d)).astype(np.float32) * 3
        if zero:
            x[::zero] = 0.0              # all-zero rows ship scale 0
        codes, scales = quantize_rows_q8(x)
        c = torch.from_numpy(codes).to(dev)
        s = torch.from_numpy(scales).to(dev)
        got = pull_dequant(c, s)
        ref = pull_dequant(c, s, mode="torch_ref")
        torch.cuda.synchronize()
        err = (got - ref).abs().max().item()
        shape = f"m={m} dim={d} zero rows every {zero or 'none'}"
        if not torch.equal(got, ref):
            fail(f"pull_dequant {shape}: not bitwise equal to the plain "
                 "version")
        if not np.array_equal(got.cpu().numpy(),
                              dequantize_rows_q8(codes, scales)):
            fail(f"pull_dequant {shape}: not bitwise the numpy dequant")
        msg = (f"pull_dequant {shape}: bitwise equal to the plain version "
               "and to numpy dequantize_rows_q8")
        if i:
            log(msg)
            continue
        ms = queued_ms(lambda: pull_dequant(c, s))
        plain = queued_ms(lambda: pull_dequant(c, s, mode="torch_ref"))
        lib = queued_ms(lambda: torch.mul(c, s[:, None]))
        # int8 codes and f32 scales read once, f32 rows written once
        bms, by = bound_ms(m * d, PEAK_F32_FLOPS, m * d * 5 + m * 4)
        rows["pull_dequant"] = dict(max_abs_err=err, ms=ms, plain_ms=plain,
                                    bound_ms=bms, bound_by=by,
                                    library_ms=lib)
        log(f"{msg}; kernel_ms {ms:.4f} plain_ms {plain:.4f} bound_ms "
            f"{bms:.6f} ({by}) library_ms(torch.mul) {lib:.4f}")
    return rows


def _wide_deep_ids(b):
    return {"slots": b[0].reshape(-1)}


def wide_deep_train(dev, params, batches):
    """Phase 13: the bench's wide&deep through ``HeterTrainer(sync_mode=
    False, push_lag=1)`` on (a) a host ``SparseTable`` and (b) a
    ``DeviceCachedTable``: 2 warm-up and 20 timed batches each.  Returns
    (the launch counts of (b)'s run, (b)'s host table, tower and cache,
    results)."""
    from paddle_tpu_torch.distributed.fleet import (DeviceCachedTable,
                                                    HeterTrainer,
                                                    SparseTable)
    from paddle_tpu_torch.ops.kernels import registry
    W = WIDE_DEEP
    n_ids = W["batch"] * W["n_slots"]
    res = {}
    for backend in ("host_table", "device_cache"):
        cache = None
        if backend == "host_table":
            table = sparse = SparseTable(W["dim"], optimizer="sgd", lr=0.05)
        else:
            table = SparseTable(W["dim"], optimizer="sgd", lr=1.0)
            cache = sparse = DeviceCachedTable(table, capacity=n_ids * 3,
                                               optimizer="sgd", lr=0.05)
            t0 = time.perf_counter()
            cache.prime(n_ids)
            log(f"wide&deep device_cache: primed in "
                f"{time.perf_counter() - t0:.2f} s")
        tower = WideDeepTower(params, dev)
        tr = HeterTrainer({"slots": sparse}, tower.step, sync_mode=False,
                          push_lag=1)
        registry.reset_counts()              # the main path starts here
        tr.run(batches[:2], _wide_deep_ids)
        n_warm = len(tower.losses)
        if cache is not None:
            cache.hits = cache.misses = 0    # steady-state hit rate only
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        n = tr.run(batches, _wide_deep_ids)
        losses = tower.fetch()               # every loss fetched here
        dt = time.perf_counter() - t0
        counts = registry.launch_counts()    # ... and ends here
        tr.shutdown()
        timed = losses[n_warm:]
        row = dict(examples_per_s=W["batch"] * n / dt,
                   ms_per_step=dt * 1e3 / n, first_loss=float(timed[0]),
                   last_loss=float(timed[-1]), launches=counts)
        if cache is not None:
            cache.flush()
            row.update(hit_rate=cache.hits / (cache.hits + cache.misses),
                       evictions=cache.evictions)
        row["rows_in_table"] = len(table)
        log(f"wide&deep {backend}: " + json.dumps(row))
        if not np.isfinite(losses).all() or not timed[-1] < timed[0]:
            fail(f"wide&deep {backend}: losses {losses.tolist()} (finite, "
                 "the last timed below the first)")
        want = dict.fromkeys(counts, 0)
        if cache is not None:
            want["segment_sum"] = n_warm + n     # one merge per push
        if counts != want:
            fail(f"wide&deep {backend}: launches {counts}, want {want}")
        res[backend] = row
    return counts, table, tower, cache, res


def wide_deep_end_to_end(dev, params, batches):
    """Phase 14: 8 sync batches through a 16,384-row cache (evictions and
    write-backs from the third batch on), on each wire with the kernels
    and with their plain versions: per wire, the losses and the host
    rows of every id seen must be bitwise equal."""
    from paddle_tpu_torch.distributed.fleet import (DeviceCachedTable,
                                                    HeterTrainer,
                                                    SparseTable)
    from paddle_tpu_torch.ops.kernels import registry
    W = WIDE_DEEP
    batches = batches[:8]
    seen = np.unique(np.concatenate([b[0].reshape(-1) for b in batches]))
    known, missed = set(), 0
    for b in batches:                     # batches bringing a new id
        new = set(np.unique(b[0]).tolist()) - known
        missed += bool(new)
        known |= new
    res = {}
    for wire in ("f32", "q8"):
        out = {}
        for mode in (None, "torch_ref"):
            table = SparseTable(W["dim"], optimizer="sgd", lr=1.0)
            cache = DeviceCachedTable(
                table, capacity=WIDE_DEEP_E2E_CAPACITY, optimizer="sgd",
                lr=0.05, wire=wire, kernel_mode=mode)
            tower = WideDeepTower(params, dev)
            tr = HeterTrainer({"slots": cache}, tower.step, sync_mode=True)
            registry.reset_counts()
            tr.run(batches, _wide_deep_ids)
            tr.shutdown()
            cache.flush()
            counts = registry.launch_counts()
            calls = {k: s.torch_ref_calls
                     for k, s in registry.kernels().items()}
            out[mode] = (tower.fetch(), table.pull(seen))
            route = "kernels" if mode is None else "plain"
            log(f"wide&deep end to end {wire} wire, {route}: losses "
                + " ".join(f"{x:.7f}" for x in out[mode][0])
                + f"; evictions {cache.evictions}; launches segment_sum "
                f"{counts['segment_sum']} pull_dequant "
                f"{counts['pull_dequant']}; plain calls segment_sum "
                f"{calls['segment_sum']} pull_dequant "
                f"{calls['pull_dequant']}")
            if cache.evictions == 0:
                fail(f"wide&deep end to end {wire}: no eviction")
            if mode is None:
                if counts["segment_sum"] != len(batches):
                    fail(f"wide&deep end to end {wire}: segment_sum "
                         f"launches {counts['segment_sum']}, want "
                         f"{len(batches)}")
                if wire == "q8" and counts["pull_dequant"] < missed:
                    fail(f"wide&deep end to end q8: pull_dequant launches "
                         f"{counts['pull_dequant']} < {missed} batches "
                         "that missed")
            elif any(counts.values()):
                fail(f"wide&deep end to end {wire} plain: launches {counts}")
        (lk, rk), (lp, rp) = out[None], out["torch_ref"]
        equal = np.array_equal(lk, lp) and np.array_equal(rk, rp)
        res[wire] = dict(bitwise_equal=equal, rows=int(seen.size),
                         evictions=cache.evictions)
        log(f"wide&deep end to end {wire} wire: the 8 losses and "
            f"{seen.size} host rows {'bitwise equal' if equal else 'DIFFER'}"
            " between the kernels and their plain versions")
        if not equal:
            fail(f"wide&deep end to end {wire}: max |loss diff| "
                 f"{np.abs(lk - lp).max():.3g}, max |row diff| "
                 f"{np.abs(rk - rp).max():.3g}")
    return res


def wide_deep_serve(dev, table, tower, serve_batches):
    """Phase 15: the trained table served through a q8 cache, pull and
    the tower's forward only, over fresh batches; the first batch's rows
    must be bitwise the numpy dequant of the host table's q8 pull.  An
    f32-wire cache over the same batches gives the logits' distance, for
    information.  Returns (the launch counts of the q8 run, results)."""
    from paddle_tpu_torch.distributed.fleet import DeviceCachedTable
    from paddle_tpu_torch.distributed.fleet.ps import dequantize_rows_q8
    from paddle_tpu_torch.ops.kernels import registry
    W = WIDE_DEEP
    n_ids = W["batch"] * W["n_slots"]
    dense = [torch.from_numpy(b[1]).to(dev) for b in serve_batches]
    out = {}
    for wire in ("q8", "f32"):
        cache = DeviceCachedTable(table, capacity=n_ids * 3, wire=wire)
        cache.prime(n_ids)
        registry.reset_counts()              # the main path starts here
        t0 = time.perf_counter()
        logits, first = [], None
        with torch.no_grad():
            for b, x in zip(serve_batches, dense):
                rows = cache.pull(b[0].reshape(-1))
                first = rows if first is None else first
                logits.append(tower.logits(rows, x))
            logits = torch.stack(logits).cpu().numpy()
        dt = time.perf_counter() - t0
        counts = registry.launch_counts()    # ... and ends here
        row = dict(examples_per_s=W["batch"] * len(serve_batches) / dt,
                   ms_per_batch=dt * 1e3 / len(serve_batches),
                   hit_rate=cache.hits / (cache.hits + cache.misses),
                   launches=counts)
        out[wire] = (logits, counts, row, first)
        log(f"wide&deep serve {wire} wire: " + json.dumps(row))
        if not np.isfinite(logits).all():
            fail(f"wide&deep serve {wire}: non-finite logits")
    logits, counts, row, first = out["q8"]
    if counts["pull_dequant"] < 1:
        fail("wide&deep serve q8: pull_dequant never launched")
    # a fresh cache: every row of the first batch was a miss
    want = dequantize_rows_q8(*table.pull_q8(serve_batches[0][0]))
    if not np.array_equal(first.cpu().numpy(), want):
        fail("wide&deep serve q8: the first batch's rows are not the numpy "
             "dequant of the host table's q8 pull")
    diff = float(np.abs(logits - out["f32"][0]).max())
    row["max_logit_diff_vs_f32"] = diff
    log(f"wide&deep serve: the first batch's rows are bitwise the numpy "
        f"dequant of the q8 pull; pull_dequant launches "
        f"{counts['pull_dequant']}; max |logit(q8) - logit(f32)| "
        f"{diff:.4g} (max |logit(f32)| "
        f"{float(np.abs(out['f32'][0]).max()):.4g})")
    return counts, row


def profile_wide_deep(dev, cache, tower, batches):
    """Phase 16: torch.profiler over 3 async steps of the device-cache
    backend: device busy time against wall time, the idle share and the
    top device kernels; the pushes run on the trainer's pool threads, so
    their segment_sum kernels must show in the trace."""
    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch.distributed.fleet import HeterTrainer
    tr = HeterTrainer({"slots": cache}, tower.step, sync_mode=False,
                      push_lag=1)
    tr.run(batches[:1], _wide_deep_ids)
    torch.cuda.synchronize()
    steps = 3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        tr.run(batches[1:1 + steps], _wide_deep_ids)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    tr.shutdown()
    kern = device_kernels(prof.key_averages())
    busy_ms = sum(e.self_device_time_total for e in kern) / 1e3 / steps
    n_kern = sum(e.count for e in kern) // steps
    log(f"profile wide&deep device_cache: wall {wall_ms:.2f} ms/step, "
        f"device busy {busy_ms:.3f} ms/step, idle share "
        f"{1 - busy_ms / wall_ms:.4f}, {n_kern} kernels/step")
    check_busy("profile wide&deep (phase 16)", busy_ms, wall_ms)
    for e in sorted(kern, key=lambda e: -e.self_device_time_total)[:12]:
        log(f"  {e.key[:70]:70s} {e.self_device_time_total / 1e3 / steps:8.3f}"
            f" ms/step  x{e.count // steps}")
    seg = sum(e.count for e in kern if "segment_sum" in e.key)
    if seg != steps:
        fail(f"profile wide&deep: {seg} segment_sum kernels in the trace, "
             f"want {steps} (one per push, from the pool threads)")
    log(f"profile wide&deep: the {seg} segment_sum kernels of the pool "
        "threads' pushes are in the trace")


# ---------------------------------------------------------------------
# phase 3 (opt_apply) and phases 17-19: the elastic data plane
# ---------------------------------------------------------------------

def proxy_numel() -> int:
    """The Llama proxy's flat parameter count (the model phase 7
    trains): embeddings and LM head, 8 layers of q/k/v/o and the gated
    MLP with two norms each, the final norm."""
    c = proxy_config()
    h, i, L = c.hidden_size, c.intermediate_size, c.num_hidden_layers
    kv = h // c.num_attention_heads * c.num_key_value_heads
    layer = h * h * 2 + h * kv * 2 + 3 * h * i + 2 * h
    return 2 * c.vocab_size * h + L * layer + h


def _host_engine(kind, p, g, slots, lr, t, betas=(0.9, 0.999), eps=1e-8,
                 mu=0.9):
    """The reference's host numpy engine (``_FlatSGD/_FlatMomentum/
    _FlatAdam.update``): f32 numpy operations in its order."""
    lr = np.float32(lr)
    if kind == "sgd":
        return [(p - lr * g).astype(np.float32)]
    if kind == "momentum":
        u = (np.float32(mu) * slots[0] + g).astype(np.float32)
        return [(p - lr * u).astype(np.float32), u]
    b1, b2 = np.float32(betas[0]), np.float32(betas[1])
    m = (b1 * slots[0] + (np.float32(1) - b1) * g).astype(np.float32)
    v = (b2 * slots[1] + (np.float32(1) - b2) * g * g).astype(np.float32)
    c1 = np.float32(1.0 - betas[0] ** t)
    c2 = np.float32(1.0 - betas[1] ** t)
    return [(p - lr * (m / c1) / (np.sqrt(v / c2) + np.float32(eps)))
            .astype(np.float32), m, v]


def _opt_state(n, gen, dev):
    p = torch.randn(n, device=dev, generator=gen)
    g = torch.randn(n, device=dev, generator=gen)
    m = torch.randn(n, device=dev, generator=gen) * 0.1
    v = torch.randn(n, device=dev, generator=gen).square_() * 0.01
    return p, g, [m, v]


def _opt_check(label, kind, p, g, slots, hyper):
    """opt_apply twice and its plain version once: fail unless all three
    are bitwise equal.  Returns the kernel's outputs and the largest
    |kernel - plain| over them."""
    from paddle_tpu_torch.ops.kernels.opt_apply import SLOTS, opt_apply
    slots = slots[:len(SLOTS[kind])]
    ref = opt_apply(kind, p, g, slots, hyper, mode="torch_ref")
    a = opt_apply(kind, p, g, slots, hyper)
    b = opt_apply(kind, p, g, slots, hyper)
    torch.cuda.synchronize()
    err = max((x - z).abs().max().item() for x, z in zip(a, ref))
    for x, y, z in zip(a, b, ref):
        if not (torch.equal(x, z) and torch.equal(x, y)):
            fail(f"opt_apply {kind} {label}: not bitwise equal to the plain "
                 f"version or to its rerun (max |diff| {err:.3g})")
    return a, err


def opt_cases(dev):
    """Phase 3 for ``opt_apply``: every kind at the elastic bench's shard
    (200,000 elements), at its two world-2 halves (each bitwise the half
    of the full update), at odd lengths, an unaligned view, a late step
    and a schedule-driven lr, each run twice and bitwise equal to the
    plain version; the host numpy engine's expression recomputed on the
    host for the 200,000 case (differing elements counted, expected 0);
    Adam at the Llama proxy's flat parameter count, compared with the
    plain version slice by slice.  Returns the kernels-line row (the
    200,000 Adam shard the main path runs)."""
    from paddle_tpu_torch.distributed.fleet.dist_step import (
        make_lr_schedule, zero_shard_ranges)
    from paddle_tpu_torch.ops.kernels.opt_apply import (KINDS, SLOTS,
                                                        opt_apply,
                                                        pack_hyper)
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    n, lr = ELASTIC["numel"], ELASTIC["lr"]
    sched = make_lr_schedule("cosine", lr, warmup_steps=2,
                             total_steps=ELASTIC["steps"], min_lr=lr / 10)
    row = {}
    for kind in KINDS:
        p, g, slots = _opt_state(n, gen, dev)
        hyper = pack_hyper(kind, lr=lr, t=1)
        full, err = _opt_check(f"n={n}", kind, p, g, slots, hyper)
        for lo, hi in zero_shard_ranges(n, 2):
            half, _ = _opt_check(f"[{lo}, {hi})", kind, p[lo:hi],
                                 g[lo:hi], [s[lo:hi] for s in slots], hyper)
            for x, y in zip(half, full):
                if not torch.equal(x, y[lo:hi]):
                    fail(f"opt_apply {kind}: the update of [{lo}, {hi}) is "
                         "not bitwise that slice of the full update")
        host = _host_engine(kind, p.cpu().numpy(), g.cpu().numpy(),
                            [s.cpu().numpy() for s in slots], lr, 1)
        diff = sum(int((x.cpu().numpy() != y).sum())
                   for x, y in zip(full, host))
        for m in (1, 4097, (1 << 20) + 3):
            q, h, s = _opt_state(m, gen, dev)
            _opt_check(f"n={m}", kind, q, h, s, hyper)
        _opt_check(f"unaligned n={n - 1}", kind, p[1:], g[1:],
                   [s[1:] for s in slots], hyper)
        _opt_check("t=10000", kind, p, g, slots,
                   pack_hyper(kind, lr=lr, t=10_000))
        _opt_check("scheduled lr at t=17", kind, p, g, slots,
                   pack_hyper(kind, lr=sched(17), t=17))
        log(f"opt_apply {kind}: bitwise equal to the plain version and on a "
            f"rerun at n={n}, its world-2 halves (each the slice of the full "
            "update), n=1, 4097, 2^20+3, an unaligned view, t=10000 and a "
            f"scheduled lr; elements differing from the host numpy engine "
            f"at n={n}: {diff}")
        if diff:
            fail(f"opt_apply {kind}: {diff} elements differ from the host "
                 "numpy engine's expression")
        ns = len(SLOTS[kind])
        sl = slots[:ns]
        ms = queued_ms(lambda: opt_apply(kind, p, g, sl, hyper))
        plain = cuda_ms(lambda: opt_apply(kind, p, g, sl, hyper,
                                          mode="torch_ref"))
        flops = {"sgd": 2, "momentum": 4, "adam": 14}[kind] * n
        bms, by = bound_ms(flops, PEAK_F32_FLOPS, (3 + 2 * ns) * 4 * n)
        if kind == "adam":
            steps_t = torch.full((), 3.0, device=dev)
            lib_name = "torch._fused_adam_"
            lib = queued_ms(lambda: _fused_adam(p, g, sl, lr, steps_t))
        elif kind == "momentum":
            lib_name = "torch._fused_sgd_ with momentum"
            lib = queued_ms(lambda: _fused_momentum(p, g, sl, lr))
        else:
            lib_name = "torch.add"
            lib = queued_ms(lambda: torch.add(p, g, alpha=-lr))
        log(f"opt_apply {kind} n={n}: max_abs_err {err} kernel_ms {ms:.4f} "
            f"plain_ms {plain:.4f} bound_ms {bms:.6f} ({by}) library_ms "
            f"{lib:.4f} ({lib_name}, rounds differently; time only)")
        if kind == "adam":
            row = dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bms,
                       bound_by=by, library_ms=lib)
    del p, g, slots, full, half
    # Adam at the Llama proxy's flat parameter count
    N = proxy_numel()
    p, g, slots = _opt_state(N, gen, dev)
    hyper = pack_hyper("adam", lr=lr, t=3)
    a = opt_apply("adam", p, g, slots, hyper)
    b = opt_apply("adam", p, g, slots, hyper)
    torch.cuda.synchronize()
    step, big_err = 1 << 26, 0.0
    for lo in range(0, N, step):
        hi = min(N, lo + step)
        ref = opt_apply("adam", p[lo:hi], g[lo:hi],
                        [s[lo:hi] for s in slots], hyper, mode="torch_ref")
        for x, y, z in zip(a, b, ref):
            big_err = max(big_err, (x[lo:hi] - z).abs().max().item())
            if not (torch.equal(x[lo:hi], z) and torch.equal(x[lo:hi],
                                                              y[lo:hi])):
                fail(f"opt_apply adam n={N}: [{lo}, {hi}) not bitwise equal "
                     "to the plain version or to its rerun")
        del ref
    del a, b
    ms = cuda_ms(lambda: opt_apply("adam", p, g, slots, hyper), iters=10)
    steps_t = torch.full((), 3.0, device=dev)
    lib = cuda_ms(lambda: _fused_adam(p, g, slots, lr, steps_t), iters=10)
    bms, by = bound_ms(14 * N, PEAK_F32_FLOPS, 28 * N)
    log(f"opt_apply adam n={N} (the Llama proxy's parameters): bitwise equal "
        f"to the plain version (in slices of {step}, max_abs_err {big_err}) "
        f"and on a rerun; kernel_ms {ms:.4f} bound_ms {bms:.4f} ({by}, {28 * N / 1e9:.2f} GB) "
        f"= {bms / ms:.3f} of the bound; library_ms(torch._fused_adam_) "
        f"{lib:.4f}")
    del p, g, slots
    torch.cuda.empty_cache()
    return {"opt_apply": row}


def _fused_momentum(p, g, slots, lr):
    """PyTorch's own fused SGD with momentum (dampening 0, not Nesterov,
    past the first step: ``u = 0.9 u + g; p -= lr u``) over one flat
    tensor, in place: a yardstick for time only, which the port never
    calls."""
    torch._fused_sgd_([p], [g], [slots[0]], weight_decay=0.0,
                      momentum=0.9, lr=lr, dampening=0.0, nesterov=False,
                      maximize=False, is_first_step=False)


def _fused_adam(p, g, slots, lr, step):
    """PyTorch's own fused Adam over one flat tensor (in place; ``step``
    a float tensor on the card): a yardstick for time only, which the
    port never calls."""
    torch._fused_adam_([p], [g], [slots[0]], [slots[1]], [], [step], lr=lr,
                       beta1=0.9, beta2=0.999, weight_decay=0.0, eps=1e-8,
                       amsgrad=False, maximize=False)


class _ElasticData:
    """The elastic bench's 64 seeded samples (``bench.py:1399-1407``)."""

    def __init__(self, n=64):
        self.x = np.random.default_rng(5).standard_normal(n).astype(
            np.float32)

    def __len__(self):
        return self.x.size

    def __getitem__(self, i):
        return self.x[i]


def _elastic_grad(params, batch):
    """The elastic bench's gradient (``bench.py:1409-1413``)."""
    s = np.float32(np.mean(batch))
    return {"w": (params["w"] * np.float32(1e-3)
                  + s * np.float32(1e-2)).astype(np.float32),
            "b": np.asarray(s, np.float32).reshape(())}


def _elastic_trainer(dev, ck, port, world, engine="device", numel=None,
                     grad=_elastic_grad, **kw):
    from paddle_tpu_torch.distributed.fleet import ElasticTrainer
    from paddle_tpu_torch.io import DataLoader
    E = ELASTIC
    cfg = dict(optimizer="adam", lr=E["lr"], micro_batches=E["micro"],
               ckpt_every=E["ckpt_every"])
    cfg.update(kw)
    numel = numel or E["numel"]
    loader = DataLoader(_ElasticData(E["samples"]), batch_size=E["batch"],
                        shuffle=True, seed=E["shuffle_seed"], drop_last=True)
    return ElasticTrainer(
        {"w": np.zeros(numel - 1, np.float32), "b": np.zeros((), np.float32)},
        grad, loader, ckpt_dir=ck, coordinator=f"127.0.0.1:{port}",
        expected_world=world, client_timeout=120.0, engine=engine,
        device=dev, **cfg)


def _ckpt_bytes(d):
    return {f: (pathlib.Path(d) / f).read_bytes()
            for f in sorted(os.listdir(d))}


def elastic_bench(dev):
    """Phase 17: the reference bench's elastic configuration
    (``bench.py:1372-1468``, nothing cut) on the host and the device
    engine: steps/s, the reshard window off the flight ring, the staging
    peak; the engines' final params, optimizer state and last checkpoint
    must be bitwise equal, the device engine launch ``opt_apply`` once
    per step plus its rebuild's warm-up, the host engine nothing.
    Returns (the device run's launch counts, its final params)."""
    from paddle_tpu_torch.distributed.fleet import ElasticCoordinator
    from paddle_tpu_torch.observability import flight_recorder as flight
    from paddle_tpu_torch.ops.kernels import registry
    E = ELASTIC
    res = {}
    for engine in ("host", "device"):
        coord = ElasticCoordinator(expected_world=1).start()
        with tempfile.TemporaryDirectory() as ck:
            tr = _elastic_trainer(dev, ck, coord.port, 1, engine=engine)
            flight.clear()
            registry.reset_counts()          # the main path starts here
            t0 = time.perf_counter()
            params = tr.run(E["steps"])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = registry.launch_counts()  # ... and ends here
            evs = flight.events()
            files = _ckpt_bytes(os.path.join(ck, f"step_{E['steps']}"))
        coord.stop()

        def total(kind, key):
            return sum(e.get(key, 0) for e in evs if e.get("kind") == kind)

        row = dict(steps_per_s=E["steps"] / wall, wall_s=wall,
                   restore_ms=total("elastic.reshard", "ms"),
                   rebuild_ms=total("elastic.reshard.compile", "ms"),
                   reshard_bytes=total("elastic.reshard", "bytes"),
                   meter_peak_bytes=tr.reshard_meter.peak_bytes)
        log(f"elastic {engine} engine: " + json.dumps(row))
        want = dict.fromkeys(counts, 0)
        if engine == "device":
            want["opt_apply"] = E["steps"] + 1       # + the rebuild warm-up
        if counts != want:
            fail(f"elastic {engine} engine: launches {counts}, want {want}")
        res[engine] = (params, tr.opt_shard(), files, counts)
    (hp, hs, hf, _), (dp, ds, df, counts) = res["host"], res["device"]
    for k in hp:
        if not np.array_equal(hp[k], dp[k]):
            fail(f"elastic: the engines' final {k} differ")
    for k in hs:
        if not np.array_equal(hs[k], ds[k]):
            fail(f"elastic: the engines' optimizer state {k} differs")
    if hf != df:
        fail("elastic: the engines' last checkpoints differ in bytes")
    if not all(np.isfinite(v).all() for v in dp.values()):
        fail("elastic: non-finite parameters")
    log(f"elastic: host and device engines bitwise equal after "
        f"{E['steps']} steps (params, optimizer state at opt_t "
        f"{int(ds['t'])}, and the step-{E['steps']} checkpoint's "
        f"{len(df)} files)")
    return counts, dp


class _Left(Exception):
    """Raised by the leaving rank's gradient to end its thread."""


def elastic_worlds(dev, want):
    """Phase 18: the same configuration at world 2 (two trainer threads
    on one card, one coordinator) must end bitwise at phase 17's params
    ``want``; then a world-2 run whose rank 1 leaves after step 10
    (``client.leave()``): the survivor reshards from the pinned step at
    world 1, rebuilds at the new shard length and must end bitwise at
    ``want`` too.  Returns the launch counts of both runs."""
    import threading

    from paddle_tpu_torch.distributed.fleet import ElasticCoordinator
    from paddle_tpu_torch.observability import flight_recorder as flight
    from paddle_tpu_torch.ops.kernels import registry
    E = ELASTIC
    leave_after = 10

    def run_world(ck, coord, leave):
        trainers, out, errs = [], {}, []

        def grad_of(i):
            calls = [0]

            def grad(params, batch):
                tr = trainers[i]
                rm = tr.role_maker
                if leave and rm.worker_num() == 2 and rm.worker_index() == 1:
                    calls[0] += 1
                    if calls[0] > leave_after:
                        # leave once step 10's checkpoint is pinned
                        deadline = time.monotonic() + 120
                        while (coord.status()["ckpt_step"] or 0) < \
                                leave_after:
                            if time.monotonic() > deadline:
                                fail("elastic leave: step 10 never pinned")
                            time.sleep(0.005)
                        tr._client.leave()
                        raise _Left()
                return _elastic_grad(params, batch)
            return grad

        for i in range(2):
            trainers.append(_elastic_trainer(
                dev, ck, coord.port, 2, grad=grad_of(i),
                ckpt_every=leave_after if leave else E["ckpt_every"]))

        def go(i):
            try:
                out[i] = trainers[i].run(E["steps"])
            except _Left:
                out[i] = None
            except BaseException as e:      # re-raised in the main thread
                errs.append(e)

        ts = [threading.Thread(target=go, args=(i,)) for i in range(2)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=600)
        if any(t.is_alive() for t in ts):
            fail("elastic world-2 run hung")
        if errs:
            raise errs[0]
        return trainers, out

    registry.reset_counts()                  # the main path starts here
    for leave in (False, True):
        coord = ElasticCoordinator(expected_world=2).start()
        flight.clear()
        with tempfile.TemporaryDirectory() as ck:
            t0 = time.perf_counter()
            trainers, out = run_world(ck, coord, leave)
            wall = time.perf_counter() - t0
        coord.stop()
        label = "rank 1 leaves after step 10" if leave else "world 2"
        finals = [r for r in out.values() if r is not None]
        if len(finals) != (1 if leave else 2):
            fail(f"elastic {label}: {len(finals)} trainers finished")
        for r in finals:
            for k in want:
                if not np.array_equal(r[k], want[k]):
                    fail(f"elastic {label}: final {k} not bitwise phase 17's")
        for i, tr in enumerate(trainers):
            log(f"elastic {label}: trainer {i} transitions "
                f"{json.dumps(tr.transitions)} rebuilds {tr._engine.compiles}")
        if leave:
            (surv,) = [tr for i, tr in enumerate(trainers)
                       if out[i] is not None]
            last = surv.transitions[-1]
            rebuilt = [e["shard_len"] for e in flight.events()
                       if e.get("kind") == "elastic.reshard.compile"]
            if (last["world"], last["resume_step"]) != (1, leave_after) \
                    or surv._engine.compiles != 2 \
                    or rebuilt[-1] != E["numel"]:
                fail(f"elastic leave: survivor transitions "
                     f"{surv.transitions}, rebuild shard lengths {rebuilt}")
            log(f"elastic {label}: the survivor resharded from pinned step "
                f"{leave_after} at world 1, rebuilt at shard length "
                f"{rebuilt[-1]} (rebuild shard lengths {rebuilt})")
        log(f"elastic {label}: bitwise phase 17's final params, "
            f"{E['steps'] / wall:.2f} steps/s")
    counts = registry.launch_counts()        # ... and ends here
    return counts


def profile_elastic(dev):
    """Phase 19: 5 device-engine steps at numel 2^25 + 1 (134 MB per f32
    vector), checkpointing at the end, with ``torch.profiler`` over
    the 2nd to the 4th step: device busy time against wall time, the ``opt_apply``
    kernel, the reduce's adds and the host<->device copies; and the host
    ms of each stage of a step (gradient, exchange, reduce, update) and
    of the checkpoint round."""
    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch.distributed.fleet import ElasticCoordinator
    numel, steps = ELASTIC_PROFILE_NUMEL, 5
    coord = ElasticCoordinator(expected_world=1).start()
    host_ms = {}
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    window = {}

    def timed(name, fn):
        def wrapped(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                host_ms[name] = host_ms.get(name, 0.0) + \
                    (time.perf_counter() - t0) * 1e3
        return wrapped

    with tempfile.TemporaryDirectory() as ck:
        tr = _elastic_trainer(dev, ck, coord.port, 1, numel=numel,
                              ckpt_every=steps)
        batches = [0]
        next_batch = tr._next_batch

        def step_boundary():
            # the 2nd, 3rd and 4th steps run under the profiler
            if batches[0] == 1:
                torch.cuda.synchronize()
                prof.start()
                window["t0"] = time.perf_counter()
            elif batches[0] == 4:
                torch.cuda.synchronize()
                window["wall_ms"] = (time.perf_counter() - window["t0"]) * 1e3
                prof.stop()
            batches[0] += 1
            return next_batch()

        exchange = tr._exchange

        def tagged_exchange(gen, step, tag, arrays):
            name = "exchange " + tag.split(":")[0]
            return timed(name, exchange)(gen, step, tag, arrays)

        tr._next_batch = step_boundary
        tr._exchange = tagged_exchange
        tr._slot_grad = timed("gradient", tr._slot_grad)
        tr._checkpoint_round = timed("checkpoint round", tr._checkpoint_round)
        tr._opt.update = timed("update (opt_apply + copies)", tr._opt.update)
        tr._engine.reduce = timed("reduce (copies + adds)", tr._engine.reduce)
        t0 = time.perf_counter()
        params = tr.run(steps)
        run_s = time.perf_counter() - t0
    coord.stop()
    if not all(np.isfinite(v).all() for v in params.values()):
        fail("profile elastic: non-finite parameters")
    n = 3
    wall_ms = window["wall_ms"] / n
    kern = device_kernels(prof.key_averages())
    busy_ms = sum(e.self_device_time_total for e in kern) / 1e3 / n

    def part(pred):
        sel = [e for e in kern if pred(e.key)]
        return (sum(e.self_device_time_total for e in sel) / 1e3 / n,
                sum(e.count for e in sel) // n)

    opt_ms, opt_n = part(lambda k: "opt_apply" in k)
    add_ms, add_n = part(lambda k: "add" in k.lower() and "Memcpy" not in k)
    h2d_ms, h2d_n = part(lambda k: "HtoD" in k)
    d2h_ms, d2h_n = part(lambda k: "DtoH" in k)
    vec = numel * 4
    log(f"profile elastic numel={numel}: {run_s:.2f} s for {steps} steps "
        f"with a checkpoint at the end; profiled the 2nd to the 4th step: "
        f"wall {wall_ms:.2f} ms/step, device busy {busy_ms:.3f} ms/step, "
        f"idle share {1 - busy_ms / wall_ms:.4f}")
    log(f"  opt_apply {opt_ms:.3f} ms/step x{opt_n}; reduce adds "
        f"{add_ms:.3f} ms/step x{add_n}; host-to-device copies {h2d_ms:.3f} "
        f"ms/step x{h2d_n} ({6 * vec / 1e6:.0f} MB: p, g, m, v and 2 slot "
        f"gradients); device-to-host {d2h_ms:.3f} ms/step x{d2h_n} "
        f"({4 * vec / 1e6:.0f} MB: p, m, v and the gradient sum)")
    for e in sorted(kern, key=lambda e: -e.self_device_time_total)[:8]:
        log(f"  {e.key[:70]:70s} {e.self_device_time_total / 1e3 / n:8.3f}"
            f" ms/step  x{e.count // n}")
    per_step = ("gradient", "exchange grads", "exchange params",
                "reduce (copies + adds)", "update (opt_apply + copies)")
    for name, ms in sorted(host_ms.items(), key=lambda kv: -kv[1]):
        if name in per_step:
            log(f"  host {name}: {ms / steps:.2f} ms/step")
        else:
            log(f"  host {name}: {ms:.2f} ms in the run")
    if opt_n != 1:
        fail(f"profile elastic: {opt_n} opt_apply kernels per step, want 1")
    check_busy("profile elastic (phase 19)", busy_ms, wall_ms)


# ---------------------------------------------------------------------
# phase 3 (segment_sum_sorted) and phases 20-23: the online loop
# ---------------------------------------------------------------------

def sorted_cases(dev, batches):
    """Phase 3 for kernel 8: ``segment_sum_sorted`` bitwise against its
    plain version (each case run twice, the rerun bitwise too) at the
    first wide&deep batch's merge, at vocab scale, with integer gradients,
    n = 1, dim 13 and the hard cases; ``merge_segments`` bitwise against
    ``segment_sum`` (kernel 7) on the same unsorted merge; the first two
    shapes timed beside the byte bound, ``torch.segment_reduce`` and
    ``index_add_``, with their longest segment and launch plan.  Returns
    its kernels-line row."""
    from paddle_tpu_torch.ops.kernels.segment_sum import (
        hard_segment_cases, merge_segments, segment_sum, segment_sum_sorted,
        segment_sum_sorted_planned, segment_tile_plan)
    g0 = torch.Generator(device=dev).manual_seed(SEED + 8)
    rng = np.random.default_rng(SEED + 8)
    _, inv0 = np.unique(batches[0][0].reshape(-1), return_inverse=True)
    inv0 = inv0.reshape(-1)
    nseg0 = int(inv0.max()) + 1
    dim = WIDE_DEEP["dim"]
    cases = [  # (label, ascending ids, dim, nseg, integer grads, aligned)
        ("wide&deep merge", np.sort(inv0), dim, nseg0, False, True),
        ("vocab scale", np.sort(rng.integers(0, 200_000, 256)), dim,
         200_000, False, True)]
    cases += [("integer grads", np.sort(rng.integers(0, ns, n)), 5, ns,
               True, True)
              for ns, n in ((6000, 64), (513, 9), (4096, 8))]
    cases += [("n=1", np.zeros(1, np.int64), dim, 4096, False, True),
              ("dim 13", np.sort(np.minimum(rng.zipf(1.3, 5000) - 1, 4999)),
               13, 5000, False, True)]
    cases += [(label, seg, d, nseg, False, al)
              for label, seg, d, nseg, al in hard_segment_cases(rng)]
    row = {}
    for i, (label, seg, d, nseg, integer, aligned) in enumerate(cases):
        n = seg.size
        g = _segment_grads(n, d, integer, aligned, dev, g0)
        ref = segment_sum_sorted(g, seg, nseg, mode="torch_ref")
        got = [segment_sum_sorted(g, seg, nseg) for _ in range(2)]
        torch.cuda.synchronize()
        shape = f"{label} n={n} dim={d} nseg={nseg}"
        err = (got[0] - ref).abs().max().item()
        if not (torch.equal(got[0], got[1]) and torch.equal(got[0], ref)):
            fail(f"segment_sum_sorted {shape}: not bitwise equal to the "
                 f"plain version or to its rerun (max |diff| {err:.3g})")
        msg = (f"segment_sum_sorted {shape}: bitwise equal to the plain "
               "version and on a rerun")
        if i >= 2:
            log(msg)
            continue
        seg_t = torch.from_numpy(seg).to(dev)
        seg32 = seg_t.to(torch.int32)
        ms = queued_ms(lambda: segment_sum_sorted_planned(g, seg32, nseg))
        wrapper_ms = cuda_ms(lambda: segment_sum_sorted(g, seg, nseg))
        plain = cuda_ms(lambda: segment_sum_sorted(g, seg, nseg,
                                                   mode="torch_ref"))
        lengths = torch.bincount(seg_t, minlength=nseg)

        def reduce_fn():
            return torch.segment_reduce(g, "sum", lengths=lengths)

        def add_fn():
            return torch.zeros(nseg, d, device=dev).index_add_(0, seg_t, g)

        red_err = (reduce_fn() - ref).abs().max().item()
        add_err = (add_fn() - ref).abs().max().item()
        red, add = queued_ms(reduce_fn), queued_ms(add_fn)
        # f32 rows and int32 ids read once, the f32 output written once
        bms, by = bound_ms(n * d, PEAK_F32_FLOPS,
                           n * d * 4 + n * 4 + nseg * d * 4)
        per_seg = np.bincount(seg, minlength=nseg)
        if i == 0:   # the faster of the two library calls, as row 7
            row = dict(max_abs_err=err, ms=ms, plain_ms=plain,
                       bound_ms=bms, bound_by=by, library_ms=min(red, add))
        plan = segment_tile_plan(
            n, nseg, d, sms=torch.cuda.get_device_properties(dev)
            .multi_processor_count)
        log(f"{msg}; {int((per_seg > 0).sum())} segments in use, "
            f"{_tile_note(plan, per_seg)}; kernel_ms {ms:.4f} "
            f"(wrapper with the host check and the id copy, one call "
            f"between events {wrapper_ms:.4f}) plain_ms {plain:.4f} "
            f"bound_ms {bms:.6f} ({by}) library_ms {min(red, add):.4f} "
            f"(the faster of segment_reduce {red:.4f}, max |diff| to "
            f"plain {red_err:.3g}, and index_add_ {add:.4f}, max |diff| "
            f"{add_err:.3g})")
    # the same unsorted merge through both kernels: the stable sort keeps
    # each segment's rows in order, so kernel 8 adds as kernel 7 does
    g = torch.randn(inv0.size, dim, device=dev, generator=g0)
    k8 = merge_segments(g, inv0, nseg0)
    k7 = segment_sum(g, inv0, nseg0)
    torch.cuda.synchronize()
    if not torch.equal(k8, k7):
        fail(f"merge_segments (kernel 8) not bitwise segment_sum (kernel "
             f"7) on the wide&deep merge: max |diff| "
             f"{(k8 - k7).abs().max().item():.3g}")
    log(f"merge_segments n={inv0.size} nseg={nseg0}: kernel 8 after the "
        "stable sort bitwise equal to kernel 7 on the unsorted merge")
    return {"segment_sum_sorted": row}


def _online_stream(batches):
    """The online phases' event stream: phase 13's 2 warm-up and 20 timed
    wide&deep batches, as dicts stamped with their ingest time."""
    from paddle_tpu_torch.io import IterableDataset
    stream = list(batches[:2]) + list(batches)

    class Stream(IterableDataset):
        def __iter__(self):
            for ids, dense, label in stream:
                yield {"ids": ids, "dense": dense, "label": label,
                       "ingest_ts": time.time()}
    return Stream(), len(stream)


def _online_loader(batches):
    from paddle_tpu_torch.io import DataLoader
    ds, n = _online_stream(batches)
    return DataLoader(ds, batch_size=1, collate_fn=lambda items: items[0]), n


def _online_step(tower, timers=None, dry=lambda: False):
    """``step_fn`` of the online phases: pull the batch's rows through the
    client, run the wide&deep tower's dense step on the card, and return
    the row gradients as a CUDA tensor.  ``dry()`` true steps a copy of
    the tower (a replayed batch, whose push the server drops)."""
    def step(batch, pull):
        ids = np.asarray(batch["ids"]).reshape(-1).astype(np.int64)
        t0 = time.perf_counter()
        rows = pull(ids)
        t1 = time.perf_counter()
        b = (ids, np.asarray(batch["dense"]), np.asarray(batch["label"]))
        if dry():
            p, losses = tower.p, list(tower.losses)
            _, grads = tower.step({"slots": rows}, b)
            tower.p, tower.losses = p, losses
        else:
            _, grads = tower.step({"slots": rows}, b)
        if timers is not None:
            torch.cuda.synchronize()
            timers["pull RPC"] += (t1 - t0) * 1e3
            timers["dense step"] += (time.perf_counter() - t1) * 1e3
        return ids, grads["slots"]
    return step


def _online_primary(replica=False):
    from paddle_tpu_torch.distributed.fleet import (PSClient, PSServer,
                                                    SparseTable)
    W = WIDE_DEEP
    prim = PSServer({"emb": SparseTable(W["dim"], optimizer="sgd",
                                        lr=0.05)}, host="127.0.0.1")
    prim.start()
    pep = f"127.0.0.1:{prim.port}"
    rep = None
    if replica:
        rep = PSServer({"emb": SparseTable(W["dim"], optimizer="sgd",
                                           lr=0.05)}, host="127.0.0.1",
                       replica_of=pep, replica_mode="read",
                       wm_interval_s=0.05)
        rep.start()
        if not rep.replica_ready.wait(30.0):
            fail("online: the read replica never attached")
    return prim, rep, PSClient([pep])


def _table_state(t):
    d = t._snapshot_arrays(full_state=True)
    o = np.argsort(d["ids"])
    return [d["ids"][o], d["vals"][o], d["opt_state"][o], int(d["version"])]


def _same_table(a, b):
    return all(np.array_equal(x, y) for x, y in zip(a, b))


def _wait_for(pred, timeout=30.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.02)
    return pred()


def _online_ttl(prim, rep, cli, sweeper, batches, state):
    """Phase 20's sweep at full width, after the run: advance the clock
    half a TTL past the run (nothing expires), touch the last batch's ids
    there with a pull, then sweep with a cutoff between the run and that
    touch.  Every other id expires on the primary and, through the
    forwarded ``evict`` record, on the read replica, whose table must
    stay bitwise the primary's."""
    ttl = sweeper._ttl
    t_a = time.time() + ttl / 2
    if sweeper.sweep_once(now=t_a)["emb"]:
        fail("online TTL: a sweep inside the TTL evicted rows")
    keep = np.unique(np.asarray(batches[-1][0]).reshape(-1).astype(np.int64))
    cli.pull("emb", keep)
    evicted = sweeper.sweep_once(now=t_a + ttl * 0.9)["emb"]
    if not _wait_for(lambda: rep._stats()["watermark"] >= prim.applied):
        fail(f"online TTL: replica watermark {rep._stats()['watermark']} "
             f"never reached the primary's {prim.applied} commits")
    after = _table_state(prim._tables["emb"])
    rep_after = _table_state(rep._tables["emb"])
    if evicted != state[0].size - keep.size or \
            not np.array_equal(after[0], keep):
        fail(f"online TTL: evicted {evicted} of {state[0].size} rows, "
             f"{after[0].size} left; want {keep.size} left, the last "
             "batch's ids")
    if not np.array_equal(rep_after[0], keep) or \
            not _same_table(rep_after, after):
        fail("online TTL: after the sweep the read replica's table is not "
             "the primary's")
    log(f"online TTL: the sweep evicted {evicted} of {state[0].size} rows "
        f"on the primary and the read replica; the {keep.size} ids touched "
        "after the run survive, and the replica's table is bitwise the "
        "primary's")
    return dict(ttl_evicted=int(evicted), ttl_kept=int(keep.size))


def online_loop(dev, params, batches):
    """Phase 20: the online loop at full width.  A primary ``PSServer``
    with one ``SparseTable(dim=16, sgd, lr=0.05)``, a read replica and a
    ``FeatureLifecycle`` sweeper (a TTL far beyond the run: it sweeps and
    evicts nothing while the stream runs); ``StreamingTrainer(device_merge
    =True)`` on the card over the 22-batch wide&deep stream, each step
    pulling its rows, running the dense tower and returning its row
    gradients on the card.  2 warm-up and 20 timed batches.  After the
    run a sweep past the TTL evicts every id but the last batch's, on the
    primary and the replica (``_online_ttl``).  Returns (the launch counts of the
    run, the primary's table state, results)."""
    from paddle_tpu_torch.framework import monitor
    from paddle_tpu_torch.online import FeatureLifecycle, StreamingTrainer
    from paddle_tpu_torch.ops.kernels import registry
    W = WIDE_DEEP
    monitor.enable_metrics(True)
    monitor.metrics_reset()
    prim, rep, cli = _online_primary(replica=True)
    sweeper = FeatureLifecycle(prim, ttl_s=3600.0, interval_s=0.25).start()
    tower = WideDeepTower(params, dev)
    loader, n = _online_loader(batches)
    calls, window = [0], {}
    inner = _online_step(tower)

    def step(batch, pull):
        calls[0] += 1
        if calls[0] == 3:                    # the first timed batch
            torch.cuda.synchronize()
            window["t0"] = time.perf_counter()
        return inner(batch, pull)

    tr = StreamingTrainer(loader, cli, "emb", step, device_merge=True,
                          device=dev)
    registry.reset_counts()                  # the main path starts here
    tr.run()
    torch.cuda.synchronize()
    losses = tower.fetch()                   # every loss fetched here
    dt = time.perf_counter() - window["t0"]
    counts = registry.launch_counts()        # ... and ends here
    plain = {k: s.torch_ref_calls for k, s in registry.kernels().items()}
    if not _wait_for(lambda: rep._stats()["watermark"] >= prim.applied):
        fail(f"online: replica watermark {rep._stats()['watermark']} never "
             f"reached the primary's {prim.applied} commits")
    sweeper.stop()
    state = _table_state(prim._tables["emb"])
    rep_state = _table_state(rep._tables["emb"])
    hist = monitor.get_histogram("ps_freshness_ms")
    timed = losses[2:]
    res = dict(events_per_s=20 * W["batch"] * W["n_slots"] / dt,
               ms_per_batch=dt * 1e3 / 20, batches=tr.batches,
               first_loss=float(timed[0]), last_loss=float(timed[-1]),
               freshness_p50_ms=hist.percentile(50) if hist else None,
               freshness_p99_ms=hist.percentile(99) if hist else None,
               freshness_count=hist.count if hist else 0,
               replica_watermark=rep._stats()["watermark"],
               trainer_seq=tr.seq, sweeps=sweeper.sweeps,
               evicted=sweeper.evicted, rows=len(prim._tables["emb"]),
               launches=counts)
    res.update(_online_ttl(prim, rep, cli, sweeper, batches, state))
    cli.close()
    rep.stop()
    prim.stop()
    log("online loop: " + json.dumps(res))
    if tr.batches != n or tr.seq != n:
        fail(f"online: {tr.batches} batches, seq {tr.seq}, want {n}")
    if not np.isfinite(losses).all() or not timed[-1] < timed[0]:
        fail(f"online: losses {losses.tolist()} (finite, the last timed "
             "below the first)")
    if res["replica_watermark"] < tr.seq:
        fail(f"online: replica watermark {res['replica_watermark']} < "
             f"trainer seq {tr.seq}")
    if not _same_table(rep_state, state):
        fail("online: the read replica's table is not the primary's")
    if res["freshness_count"] < n:
        fail(f"online: ps_freshness_ms counted {res['freshness_count']} "
             f"of {n} batches")
    want = dict.fromkeys(counts, 0)
    want["segment_sum_sorted"] = n            # one merge per batch
    if counts != want or plain["segment_sum_sorted"] or \
            plain["segment_sum"]:
        fail(f"online: launches {counts} (want {want}), plain calls "
             f"{plain}")
    log(f"online loop: segment_sum_sorted launched {n} times, once per "
        "batch, no plain call; the replica's table is bitwise the "
        "primary's")
    return counts, state, res


def _online_run(dev, params, batches, **kw):
    """The stream through a fresh primary (no replica): returns (table
    state, server, trainer)."""
    from paddle_tpu_torch.online import StreamingTrainer
    prim, _, cli = _online_primary()
    tower = WideDeepTower(params, dev)
    loader, _ = _online_loader(batches)
    tr = StreamingTrainer(loader, cli, "emb", _online_step(tower),
                          device=dev, **kw)
    tr.run()
    torch.cuda.synchronize()
    state = _table_state(prim._tables["emb"])
    cli.close()
    prim.stop()
    return state, prim, tr


def online_parity(dev, params, batches, state):
    """Phase 21: the stream with the plain versions (``kernel_mode=
    "torch_ref"``) and with the numpy merge (``device_merge=False``): both
    primary tables must be bitwise phase 20's (kernels)."""
    from paddle_tpu_torch.ops.kernels import registry
    for label, kw in (("plain versions", dict(device_merge=True,
                                               kernel_mode="torch_ref")),
                      ("numpy merge", dict(device_merge=False))):
        registry.reset_counts()
        got, _, _ = _online_run(dev, params, batches, **kw)
        counts = registry.launch_counts()
        if any(counts.values()):
            fail(f"online parity ({label}): launches {counts}")
        if not _same_table(got, state):
            fail(f"online parity ({label}): the primary's table is not "
                 "bitwise the kernels' run")
        log(f"online parity: {label}: the primary's table "
            f"({got[0].size} rows, version {got[3]}) bitwise equal to the "
            "kernels' run")


class _Crash(Exception):
    pass


def online_exactly_once(dev, params, batches, state):
    """Phase 22: (a) the stream under the ``lost_ack`` and ``dup`` chaos
    plans together; (b) a trainer that dies in batch 11's step, three
    pushes past its cursor checkpoint (seq 7), restarted in-process from
    that checkpoint: the dense tower carries over and the replayed batches
    step a copy of it (their pushes are acked as duplicates).  Both must
    end bitwise at phase 20's table with duplicate acks."""
    from paddle_tpu_torch.distributed.fleet import chaos
    from paddle_tpu_torch.online import StreamingTrainer
    plan = chaos.FaultPlan(chaos.named_plan("lost_ack").faults
                           + chaos.named_plan("dup").faults, seed=SEED,
                           name="lost_ack+dup")
    chaos.install(plan)
    try:
        got, prim, tr = _online_run(dev, params, batches, device_merge=True)
    finally:
        chaos.uninstall()
    log(f"online exactly-once under chaos: faults {plan.stats_dict()}, "
        f"server dup_acks {prim.dup_acks}, applied {prim.applied}")
    if prim.dup_acks == 0 or prim.applied != tr.seq:
        fail(f"online chaos: dup_acks {prim.dup_acks}, applied "
             f"{prim.applied} of {tr.seq}")
    if not _same_table(got, state):
        fail("online chaos: the table is not bitwise phase 20's")
    with tempfile.TemporaryDirectory() as d:
        cursor = os.path.join(d, "cursor.json")
        prim, _, cli = _online_primary()
        tower = WideDeepTower(params, dev)
        inner = _online_step(tower)
        calls = [0]

        def dying(batch, pull):
            calls[0] += 1
            if calls[0] == 11:
                raise _Crash()
            return inner(batch, pull)

        loader, n = _online_loader(batches)
        a = StreamingTrainer(loader, cli, "emb", dying, device_merge=True,
                             device=dev, state_path=cursor, ckpt_every=7)
        try:
            a.run()
            fail("online restart: the first trainer did not die")
        except _Crash:
            pass
        with open(cursor) as f:
            ckpt_seq = json.load(f)["seq"]
        pushed = prim.applied
        loader, _ = _online_loader(batches)
        b = StreamingTrainer(
            loader, cli, "emb",
            _online_step(tower, dry=lambda: b.seq < pushed),
            device_merge=True, device=dev, state_path=cursor, ckpt_every=7)
        b.run()
        torch.cuda.synchronize()
        got = _table_state(prim._tables["emb"])
        cli.close()
        prim.stop()
    log(f"online restart: died after push {pushed} with the cursor at "
        f"{ckpt_seq}; resumed to seq {b.seq}: {b.dup_acks} duplicate "
        f"acks, server applied {prim.applied}")
    if (ckpt_seq, pushed) != (7, 10) or b.dup_acks != 3 or \
            prim.applied != n or b.seq != n:
        fail(f"online restart: cursor {ckpt_seq}, pushed {pushed}, dup "
             f"acks {b.dup_acks}, applied {prim.applied}, seq {b.seq}")
    if not _same_table(got, state):
        fail("online restart: the table is not bitwise phase 20's")
    log("online exactly-once: the chaos run and the restarted trainer end "
        "bitwise at phase 20's table")


def profile_online(dev, params, batches, steps: int = 3):
    """Phase 23: ``torch.profiler`` over 3 streaming batches after one
    warm-up: device busy time against wall time, the idle share, the
    ``segment_sum_sorted`` kernels in the trace, and the host ms of the
    pull RPC, the dense step, the merge and the push RPC."""
    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch.online import StreamingTrainer
    prim, _, cli = _online_primary()
    tower = WideDeepTower(params, dev)
    timers = dict.fromkeys(("pull RPC", "dense step", "merge", "push RPC"),
                           0.0)
    loader, _ = _online_loader(batches)
    tr = StreamingTrainer(loader, cli, "emb", _online_step(tower, timers),
                          device_merge=True, device=dev)
    merge, push = tr._merge_batch, cli.push_stamped

    def timed_merge(ids, grads):
        t0 = time.perf_counter()
        out = merge(ids, grads)
        torch.cuda.synchronize()
        timers["merge"] += (time.perf_counter() - t0) * 1e3
        return out

    def timed_push(*a, **kw):
        t0 = time.perf_counter()
        try:
            return push(*a, **kw)
        finally:
            timers["push RPC"] += (time.perf_counter() - t0) * 1e3

    tr._merge_batch, cli.push_stamped = timed_merge, timed_push
    tr.run(max_batches=1)
    torch.cuda.synchronize()
    timers.update(dict.fromkeys(timers, 0.0))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        tr.run(max_batches=1 + steps)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    cli.close()
    prim.stop()
    kern = device_kernels(prof.key_averages())
    busy_ms = sum(e.self_device_time_total for e in kern) / 1e3 / steps
    n_kern = sum(e.count for e in kern) // steps
    log(f"profile online: wall {wall_ms:.2f} ms/batch, device busy "
        f"{busy_ms:.3f} ms/batch, idle share {1 - busy_ms / wall_ms:.4f}, "
        f"{n_kern} kernels/batch")
    for e in sorted(kern, key=lambda e: -e.self_device_time_total)[:10]:
        log(f"  {e.key[:70]:70s} {e.self_device_time_total / 1e3 / steps:8.3f}"
            f" ms/batch  x{e.count // steps}")
    for name, ms in timers.items():
        log(f"  host {name}: {ms / steps:.2f} ms/batch")
    check_busy("profile online (phase 23)", busy_ms, wall_ms)
    srt = [e for e in kern if "segment_sum_sorted" in e.key]
    n_srt = sum(e.count for e in srt)
    if n_srt != steps:
        fail(f"profile online: {n_srt} segment_sum_sorted kernels in the "
             f"trace, want {steps} (one per batch)")
    log(f"profile online: the {n_srt} segment_sum_sorted kernels are in "
        f"the trace, {sum(e.self_device_time_total for e in srt) / 1e3 / steps:.4f}"
        " ms/batch")


# ---------------------------------------------------------------------
# phase 3 (kernel 10) and phases 24-28: ResNet-50 training
# ---------------------------------------------------------------------

def conv_bn_cases(dev):
    """``fused_matmul_bn_stats`` at the eight ResNet-50 batch-256
    bottleneck 1x1 shapes and two tails (M off the 128-row tile; N 8)
    within ``CARD_TOL`` of its plain version, bitwise equal over two
    runs; timed beside its bound, its plain version, ``matmul_then_stats``
    (the A/B's yardstick, the library time) and ``torch.matmul`` alone."""
    from paddle_tpu_torch.ops.kernels import conv_bn_stats as cbs
    from paddle_tpu_torch.tools.exp_conv_bn_kernel import (SHAPES,
                                                           matmul_then_stats)
    g = torch.Generator(device=dev).manual_seed(SEED + 10)
    row = None
    cases = [("bottleneck", *s) for s in SHAPES] + [
        ("tail M", 1000, 72, 136), ("tail N 8", 12_545, 64, 8)]
    for i, (label, M, K, N) in enumerate(cases):
        x = torch.randn(M, K, device=dev, generator=g).to(torch.bfloat16)
        w = (torch.randn(K, N, device=dev, generator=g) * 0.05).to(
            torch.bfloat16)

        def run(mode=None):
            return cbs.fused_matmul_bn_stats(x, w, mode=mode)

        a, b, ref = run(), run(), run("torch_ref")
        torch.cuda.synchronize()
        shape = f"{label} M={M} K={K} N={N}"
        if not all(bool(torch.isfinite(t.float()).all()) for t in a):
            fail(f"conv_bn_stats {shape}: non-finite kernel output")
        if not all(torch.equal(p, q) for p, q in zip(a, b)):
            fail(f"conv_bn_stats {shape}: two runs differ")
        errs = cbs.card_check(x, w, a, ref)
        for name, (err, share) in errs.items():
            if not share <= 1.0:
                fail(f"conv_bn_stats {shape}: {name} max |err| {err:.3g} "
                     f"uses {share:.3g} of its limit ({cbs.CARD_TOL})")
        del a, b, ref
        ms = queued_ms(run)
        plain = queued_ms(lambda: run("torch_ref"))
        lib = queued_ms(lambda: matmul_then_stats(x, w))
        mm = queued_ms(lambda: torch.matmul(x, w))
        bms, by = bound_ms(2.0 * M * K * N, PEAK_BF16_FLOPS,
                           2.0 * (M * K + K * N + M * N) + 8.0 * N)
        log(f"conv_bn_stats {shape}: bitwise over two runs; "
            + ", ".join(f"{k} max_err {e:.3g} ({s:.3g} of its limit)"
                        for k, (e, s) in errs.items())
            + f"; kernel_ms {ms:.4f} plain_ms {plain:.4f} bound_ms "
            f"{bms:.4f} ({by}) library_ms(matmul_then_stats) {lib:.4f} "
            f"torch.matmul alone {mm:.4f}")
        if i == 0:
            row = dict(max_abs_err=errs["y"][0], ms=ms, plain_ms=plain,
                       bound_ms=bms, bound_by=by, library_ms=lib)
    return row


def _resnet_batch(dev, batch):
    """The bench's fixed batch (``bench.py:347-352``): ``RandomState(0)``
    draws the NCHW images, then the labels."""
    rng = np.random.RandomState(0)
    shape = (batch, 3, RESNET_TRAIN["hw"], RESNET_TRAIN["hw"])
    img = rng.standard_normal(shape).astype(np.float32)
    label = rng.randint(0, RESNET_TRAIN["classes"], (batch,)).astype(
        np.int64)
    return torch.from_numpy(img).to(dev), torch.from_numpy(label).to(dev)


def _resnet_train_step(dev, amp=True, bf16_weights=False):
    """``resnet50(num_classes=1000)`` with f32 weights from the seed, and
    the bench's step over it: ``Momentum(0.1, 0.9)``, ``cross_entropy``,
    bf16 AMP unless ``amp`` is False.  ``bf16_weights`` rounds the f32
    weights to bf16 values first."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.distributed.fleet import (DistributedStrategy,
                                                    DistributedTrainStep)
    from paddle_tpu_torch.vision.models import resnet50
    model = resnet50(num_classes=RESNET_TRAIN["classes"], device=dev,
                     generator=torch.Generator(device=dev).manual_seed(SEED))
    if bf16_weights:
        with torch.no_grad():
            for p in model.parameters():
                p.copy_(p.to(torch.bfloat16))
    strategy = DistributedStrategy()
    if amp:
        strategy.amp = True
        strategy.amp_configs = {"dtype": "bfloat16"}
    opt = pt.optimizer.Momentum(learning_rate=RESNET_TRAIN["lr"],
                                momentum=RESNET_TRAIN["momentum"],
                                parameters=list(model.parameters()))

    def loss_fn(img, label):
        return pt.nn.functional.cross_entropy(model(img), label).mean()

    return model, DistributedTrainStep(model, loss_fn, opt, strategy)


def resnet_train(dev):
    """Phase 24: the bench's ResNet-50 training at batch 256, 224x224,
    nothing cut: every loss finite; ms/step (median of steps 3-12),
    images/s, model TFLOP/s and MFU from the bench's analytic count, peak
    memory; every registered kernel's launch count 0."""
    from paddle_tpu_torch.ops.kernels import registry
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    model, step = _resnet_train_step(dev)
    img, label = _resnet_batch(dev, RESNET_TRAIN["batch"])
    torch.cuda.synchronize()
    log(f"resnet50 train: model and batch built in "
        f"{time.perf_counter() - t0:.1f} s "
        f"({sum(p.numel() for p in model.parameters()) / 1e6:.2f} M params"
        f"), cudnn.benchmark {torch.backends.cudnn.benchmark}")
    registry.reset_counts()                  # the main path starts here
    losses, times = [], []
    for _ in range(RESNET_TRAIN["steps"]):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = step(img, label)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss))
    counts = registry.launch_counts()        # ... and ends here
    plain = {k: s.torch_ref_calls for k, s in registry.kernels().items()}
    log("resnet50 train: losses " + " ".join(f"{x:.4f}" for x in losses))
    if not all(math.isfinite(x) for x in losses):
        fail(f"resnet50 train: non-finite loss in {losses}")
    ms = statistics.median(times[2:])
    b = RESNET_TRAIN["batch"]
    tflops = RESNET_TRAIN_FLOPS * b / (ms / 1e3) / 1e12
    row = dict(batch=b, steps=len(losses), ms_per_step=ms,
               first_step_ms=times[0], images_per_s=b / (ms / 1e3),
               model_tflops=tflops, mfu=tflops * 1e12 / PEAK_BF16_FLOPS,
               max_memory_allocated_gb=torch.cuda.max_memory_allocated(
                   dev) / 1e9, first_loss=losses[0], last_loss=losses[-1])
    log("resnet50 train: " + json.dumps(row))
    log(f"resnet50 train: launches {counts}, plain-version calls {plain} "
        "(all 0 by design: the reference's ResNet training runs no Pallas "
        "kernel, and its batch norm's two-pass moments are not kernel "
        "10's one-pass sums)")
    if any(counts.values()) or any(plain.values()):
        fail(f"resnet50 train: kernels ran on the training path: "
             f"{counts} {plain}")
    return model, step, img, label, counts


def resnet_train_vs_f32(dev, img, label):
    """Phase 25: one bf16-AMP step against the same step from the f32
    weights in f32 (TF32 off), at batch ``RESNET_TRAIN_F32_BATCH``: the
    loss within ``E2E_AMP_LOSS_REL``, the step's move of the running
    statistics (after - momentum * before) within ``E2E_AMP_STATS_RRMS``
    relative RMS.  The gradients' cosine is printed beside a control: the
    same f32 step on the bf16-rounded weights and images, which shows how
    far bf16 rounding of the inputs alone turns the gradient of this
    network at initialisation."""
    n = RESNET_TRAIN_F32_BATCH
    x, y = img[:n].contiguous(), label[:n].contiguous()
    mom = RESNET_TRAIN["momentum"]
    res = {}
    for name, amp, rnd in (("amp", True, False), ("f32", False, False),
                           ("f32 on bf16 inputs", False, True)):
        model, step = _resnet_train_step(dev, amp=amp, bf16_weights=rnd)
        before = {k: v.clone() for k, v in model.named_buffers()}
        loss, grads = step.loss_and_grads(
            x.to(torch.bfloat16).float() if rnd else x, y)
        moved = {k: (v - mom * before[k]).double()
                 for k, v in model.named_buffers()}
        res[name] = (float(loss), torch.cat([g.flatten().double()
                                             for g in grads]), moved)
        del model, step, grads
        torch.cuda.empty_cache()

    def cos(a, b):
        return float(a @ b / (a.norm() * b.norm()))

    f32 = res["f32"]
    out = {}
    for name in ("amp", "f32 on bf16 inputs"):
        r = res[name]
        stats = {}
        for kind in ("_mean", "_variance"):
            keys = [k for k in f32[2] if k.endswith(kind)]
            a = torch.cat([r[2][k] for k in keys])
            b = torch.cat([f32[2][k] for k in keys])
            stats[kind] = float((a - b).norm() / b.norm())
        out[name] = dict(loss=r[0], loss_f32=f32[0],
                         loss_rel=abs(r[0] - f32[0]) / abs(f32[0]),
                         grad_cos=cos(r[1], f32[1]),
                         grad_norm_ratio=float(r[1].norm() / f32[1].norm()),
                         mean_rel_rms=stats["_mean"],
                         var_rel_rms=stats["_variance"])
        log(f"resnet50 train vs f32 (batch {n}), {name}: "
            + json.dumps(out[name]))
    a = out["amp"]
    if not a["loss_rel"] <= E2E_AMP_LOSS_REL:
        fail(f"resnet50 train vs f32: loss {a['loss']} against "
             f"{a['loss_f32']} (relative {a['loss_rel']:.4g} > "
             f"{E2E_AMP_LOSS_REL})")
    for kind in ("mean_rel_rms", "var_rel_rms"):
        if not a[kind] <= E2E_AMP_STATS_RRMS:
            fail(f"resnet50 train vs f32: running statistics {kind} "
                 f"{a[kind]:.4g} > {E2E_AMP_STATS_RRMS}")
    if not a["grad_cos"] > 0:
        fail(f"resnet50 train vs f32: the bf16 gradient is not a descent "
             f"direction of the f32 loss (cosine {a['grad_cos']:.4g})")
    return out


def conv_bn_on_activations(dev, model, step, img, label):
    """Phase 26: forward hooks on every bottleneck's conv1 and conv3 (1x1,
    stride 1) capture, in one training step of phase 24's model, each
    conv's bf16 input and output; kernel 10 runs on the input as [M, K]
    (NHWC rows) with the conv's weight as [K, N].  ``y`` must match the
    conv output within ``CARD_TOL``, and ``s1 / M`` the batch mean the
    port's batch norm takes of that output (``_moments``) within 1e-5 of
    the column's sum of |acc| over M plus half a bf16 step (at most 2^-8
    of |y|) of its mean |y|: batch norm reads the rounded y.  Prints, per shape,
    ``s2 / M - (s1 / M)^2`` against the two-pass variance."""
    from paddle_tpu_torch.nn.functional.common import _moments
    from paddle_tpu_torch.ops.kernels import conv_bn_stats as cbs
    from paddle_tpu_torch.ops.kernels.registry import card_error
    from paddle_tpu_torch.vision.models.resnet import BottleneckBlock
    rows = []

    def hook(name):
        def fn(mod, inputs, output):
            with torch.no_grad():
                x = inputs[0]
                b, k, h, w_ = x.shape
                n = output.shape[1]
                xm = x.permute(0, 2, 3, 1).reshape(-1, k).contiguous()
                wk = mod.weight.detach().to(x.dtype).reshape(n, k).t() \
                    .contiguous()
                yc = output.permute(0, 2, 3, 1).reshape(-1, n)
                M = xm.shape[0]
                yk, s1, s2 = cbs.fused_matmul_bn_stats(xm, wk)
                err_y, share_y = card_error(yk, yc, cbs.CARD_TOL["y"])
                m, var, _ = _moments(output.float(), (0, 2, 3))
                acc_abs = (xm.float() @ wk.float()).abs().sum(0)
                lim = (cbs.CARD_TOL["s1"] * acc_abs
                       + 2.0 ** -8 * yc.float().abs().sum(0)) / M
                err_m = (s1 / M - m).abs()
                share_m = float((err_m / lim).max())
                one_pass = s2 / M - (s1 / M) ** 2
                rows.append(dict(
                    conv=name, M=M, K=k, N=n, y_max_err=err_y,
                    y_share=share_y, mean_max_err=float(err_m.max()),
                    mean_share=share_m,
                    one_pass_var_max_rel_err=float(
                        ((one_pass - var).abs() / var.abs()).max()),
                    var_over_mean_sq_min=float(
                        (var / (m * m).clamp_min(1e-30)).min())))
        return fn

    handles = []
    for name, mod in model.named_modules():
        if isinstance(mod, BottleneckBlock):
            for c in ("conv1", "conv3"):
                handles.append(getattr(mod, c).register_forward_hook(
                    hook(f"{name}.{c}")))
    try:
        step(img, label)
        torch.cuda.synchronize()
    finally:
        for h in handles:
            h.remove()
    if len(rows) != 32:
        fail(f"conv_bn on activations: {len(rows)} convolutions captured, "
             "want 32 (conv1 and conv3 of 16 bottlenecks)")
    for r in rows:
        log("conv_bn on activations: " + json.dumps(r))
        if not (r["y_share"] <= 1.0 and r["mean_share"] <= 1.0):
            fail(f"conv_bn on activations: {r['conv']} y uses "
                 f"{r['y_share']:.3g}, s1 / M {r['mean_share']:.3g} of "
                 "their limits")
    worst = max(rows, key=lambda r: r["one_pass_var_max_rel_err"])
    log(f"conv_bn on activations: 32 convolutions match; the one-pass "
        f"variance s2/M - (s1/M)^2 is off the two-pass one by up to "
        f"{worst['one_pass_var_max_rel_err']:.4g} relative "
        f"({worst['conv']}, M={worst['M']} N={worst['N']})")
    return rows


def conv_bn_ab():
    """Phase 27: the A/B entry point, ``python -m
    paddle_tpu_torch.tools.exp_conv_bn_kernel``'s ``main()``: the fused
    kernel against ``matmul_then_stats`` at the eight shapes.  Its
    launches are kernel 10's main path."""
    from paddle_tpu_torch.ops.kernels import registry
    from paddle_tpu_torch.tools import exp_conv_bn_kernel as ab
    registry.reset_counts()                  # the main path starts here
    res = ab.main()
    counts = registry.launch_counts()        # ... and ends here
    if counts["conv_bn_stats"] < len(ab.SHAPES) or any(
            v for k, v in counts.items() if k != "conv_bn_stats"):
        fail(f"conv_bn A/B: launches {counts}")
    log(f"conv_bn A/B: launches {counts}")
    return counts, res


def _train_class(name: str) -> str:
    n = name.lower()
    if "dgrad" in n:
        return "conv dgrad"
    if "wgrad" in n:
        return "conv wgrad"
    if "fprop" in n or "conv" in n or "implicit" in n or "winograd" in n:
        return "conv fprop"
    if "gemm" in n or "cutlass" in n:
        return "gemm"
    if "reduce" in n:
        return "reductions"
    if "pool" in n:
        return "pooling"
    if "nchw" in n or "nhwc" in n or "transpose" in n:
        return "layout"
    if "elementwise" in n or "unrolled" in n or "vectorized" in n:
        return "elementwise"
    return "other"


def profile_resnet_train(dev, step, img, label, steps: int = 2):
    """Phase 28: ``torch.profiler`` over 2 training steps of phase 24's
    model: device busy time against wall time, the top device kernels,
    device time by kernel class and by range (batch norm forward and
    backward, the convolutions, the optimizer), and the largest
    allocations."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    step(img, label)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 profile_memory=True) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step(img, label)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    avgs = prof.key_averages()
    kern = device_kernels(avgs)
    busy_ms = sum(e.self_device_time_total for e in kern) / 1e3 / steps
    n_kern = sum(e.count for e in kern) // steps
    log(f"profile resnet50 train: wall {wall_ms:.2f} ms/step, device busy "
        f"{busy_ms:.2f} ms/step, idle share {1 - busy_ms / wall_ms:.4f}, "
        f"{n_kern} kernels/step")
    check_busy("profile resnet50 train (phase 28)", busy_ms, wall_ms)
    for e in sorted(kern, key=lambda e: -e.self_device_time_total)[:15]:
        log(f"  {e.key[:70]:70s} {e.self_device_time_total / 1e3 / steps:8.3f}"
            f" ms/step  x{e.count // steps}")
    by_class = {}
    for e in kern:
        c = _train_class(e.key)
        by_class[c] = by_class.get(c, 0.0) + e.self_device_time_total
    log("profile resnet50 train: device ms/step by kernel class:")
    for c, t in sorted(by_class.items(), key=lambda kv: -kv[1]):
        log(f"  {c:14s} {t / 1e3 / steps:8.3f} ms/step "
            f"({t / 1e3 / steps / busy_ms:.3f} of busy)")
    cpu = {e.key: e for e in avgs if e.device_type == DeviceType.CPU}
    ranges = {
        "batch norm forward": ["batch_norm"],
        "batch norm backward": [k for k in cpu
                                if k.endswith("BatchNormTrainBackward")
                                and "evaluate_function" not in k][:1],
        "conv forward": ["aten::cudnn_convolution"],
        "conv backward": ["aten::convolution_backward"],
        "optimizer": ["optimizer"],
        "loss": ["aten::_log_softmax", "aten::_log_softmax_backward_data"],
        "max pool": ["aten::max_pool2d_with_indices",
                     "aten::max_pool2d_with_indices_backward"],
    }
    log("profile resnet50 train: device ms/step under each range "
        "(inclusive):")
    shares = {}
    for label_, keys in ranges.items():
        t = sum(cpu[k].device_time_total for k in keys if k in cpu)
        shares[label_] = t / 1e3 / steps
        log(f"  {label_:20s} {t / 1e3 / steps:8.3f} ms/step "
            f"({t / 1e3 / steps / busy_ms:.3f} of busy)")
    bn = shares["batch norm forward"] + shares["batch norm backward"]
    log(f"profile resnet50 train: batch norm (forward and backward) takes "
        f"{bn:.3f} ms/step, {bn / busy_ms:.3f} of device busy time")

    def mem(e):
        return getattr(e, "self_device_memory_usage", 0) or 0

    log("profile resnet50 train: device memory allocated by op itself "
        "(GB/step):")
    for e in sorted(avgs, key=lambda e: -mem(e))[:8]:
        log(f"  {e.key[:60]:60s} {mem(e) / 1e9 / steps:8.3f} GB/step"
            f"  x{e.count // steps}")
    return dict(wall_ms=wall_ms, busy_ms=busy_ms, by_class=by_class,
                ranges=shares)


def check_ptxas(source, match, entries=None):
    """Phase 2's check of one source's ``ptxas -v`` log (kept beside a
    cached library): fails without a log, on a spill in an entry whose
    name contains ``match``, or on a wgmma that ptxas serialised; with
    ``entries``, unless that many entries match.  Returns the matching
    entries' [registers, spill-store bytes, spill-load bytes]."""
    from paddle_tpu_torch.ops.kernels import _build
    text = _build.build_logs.get(source) or ""
    found, cur = {}, None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = (found.setdefault(m.group(1), [0, 0, 0])
                   if match in m.group(1) else None)
        elif cur is not None:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
            if m:
                cur[1:] = [int(m.group(1)), int(m.group(2))]
            m = re.search(r"Used (\d+) registers", line)
            if m:
                cur[0] = int(m.group(1))
    if not found or (entries is not None and len(found) != entries):
        fail(f"build {source}: no ptxas -v log of its entries to check for "
             "spills (a library cached without its log: empty the build "
             "directory and rerun)")
    spills = {n: e[1:] for n, e in found.items() if e[1] or e[2]}
    if spills:
        fail(f"build {source}: ptxas reports spills (stores, loads bytes): "
             f"{spills}")
    serial = [ln.strip() for ln in text.splitlines()
              if "wgmma" in ln and "serializ" in ln]
    if serial:
        fail(f"build {source}: ptxas serialised wgmmas: "
             + " | ".join(serial))
    return found


def _build_host_libs() -> float:
    """Build (or load) the port's host C++ and return the seconds taken."""
    from paddle_tpu_torch.native import load_library, ps_core
    t0 = time.perf_counter()
    ps_core()
    load_library("cache_dir")
    return time.perf_counter() - t0


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    try:
        import paddle_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here: {e}",
              file=sys.stderr)
        return 2
    from paddle_tpu_torch.ops.kernels import _build, registry
    from paddle_tpu_torch.text.models import LlamaForCausalLM, llama_7b

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)

    # 1. header
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")

    # 2. build: the CUDA sources and, meanwhile, the PS path's host C++
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=1) as pool:
        host = pool.submit(_build_host_libs)
        _build.build()
        host_s = host.result()
    log(f"build: {time.perf_counter() - t0:.1f} s wall for "
        f"{len(_build.SOURCES)} sources in parallel; host C++ (ps_core.cc, "
        f"cache_dir.cc) {host_s:.1f} s beside them")
    for src in _build.SOURCES:
        secs = _build.build_seconds.get(src)
        log(f"build {src}: " + ("cached (its kept log below)" if secs is None
                                else f"{secs:.1f} s"))
        for line in _build.build_logs.get(src, "").splitlines():
            if "Compiling entry" in line or "Used" in line \
                    or "spill" in line or "warning" in line:
                log("  " + line.strip())
    # kernels 7 and 8 fold from registers and shared memory, and kernels
    # 2 and 3 on the Hopper route keep dK and dV (or dQ) in the consumers'
    # registers: a spill would put them back in memory.  A cached library
    # is checked on the log kept beside it
    check_ptxas("segment_sum.cu", "")
    bwd = check_ptxas("flash_attention_bwd.cu", "flash_bwd_sm90", entries=2)
    from paddle_tpu_torch.ops.kernels.flash_attention import (
        flash_bwd_plan, flash_fwd_plan)
    meta = torch.empty(1, 1, 2048, 128, dtype=torch.bfloat16, device="meta")
    bplan = flash_bwd_plan(meta, meta, meta, meta, causal=True).dkv
    # the sm90 flash kernels' shared memory is dynamic (ptxas does not
    # see it) and their consumers run at the register count setmaxnreg
    # gives them, not at the count ptxas prints for the launch
    for name, (regs, _, _) in sorted(bwd.items()):
        log(f"  flash_bwd_sm90 ({'dK/dV' if 'ILb1E' in name else 'dQ'}): "
            f"{regs} registers at launch (a producer warpgroup at 40 by "
            f"setmaxnreg, two consumer warpgroups at 232), no spill; "
            f"{bplan.threads} threads, {bplan.smem_bytes} B dynamic shared "
            f"memory, {bplan.block_res} resident rows, {bplan.block_str}-row "
            f"streamed tiles, {bplan.stages} stages")
    plan = flash_fwd_plan(meta, meta, meta)
    log(f"  flash_fwd_sm90: {plan.threads} threads (a producer warpgroup "
        f"at 40 registers, two consumer warpgroups at 232), "
        f"{plan.smem_bytes} B dynamic shared memory, {plan.block_q} query "
        f"rows x {plan.block_k} keys, {plan.stages} K/V stages")

    # 3. kernels against their plain versions
    rows = {"flash_attention": flash_cases(dev),
            "int8_kv_attention": kv_cases(dev),
            "int8_matmul": int8_cases(dev)}
    rows.update(bwd_cases(dev))
    wd_params, wd_batches, wd_serve = wide_deep_data(extra_batches=20)
    rows.update(ps_cases(dev, wd_batches))
    rows.update(sorted_cases(dev, wd_batches))
    rows.update(opt_cases(dev))
    rows["conv_bn_stats"] = conv_bn_cases(dev)

    # 4. serve the 7B slice
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    model = LlamaForCausalLM(llama_7b(kv_cache_dtype="int8"), device=dev,
                             dtype="bfloat16", generator=gen)
    model.eval()
    torch.cuda.synchronize()
    log(f"serve: llama_7b bf16 weights drawn in "
        f"{time.perf_counter() - t0:.1f} s "
        f"({sum(p.numel() for p in model.parameters()) / 1e9:.2f} B params)")
    counts, _ = serve(dev, model)

    # 5. end to end against the plain versions
    end_to_end(dev, model)

    # 6. where a decode step's time goes
    profile_decode(dev, model)
    del model
    gc.collect()
    torch.cuda.empty_cache()

    # 7. train the proxy
    torch.cuda.reset_peak_memory_stats(dev)
    model, step, ids, train_counts = train(dev)

    # 8. end to end against the plain versions
    train_end_to_end(dev, model, step, ids)

    # 9. where a training step's time goes
    profile_train(dev, step, ids)
    del model, step, ids
    gc.collect()
    torch.cuda.empty_cache()

    # 10. serve int8 ResNet-50
    bf16_model, int8_model = resnet_models(dev)
    resnet_counts, _ = resnet_serve(dev, bf16_model, int8_model)

    # 11. the int8 logits against the plain version's
    resnet_end_to_end(dev, bf16_model, int8_model)

    # 12. where an int8 forward's time goes
    profile_resnet(dev, int8_model)
    del bf16_model, int8_model
    gc.collect()
    torch.cuda.empty_cache()

    # 13. train wide&deep through the PS path, host table and device cache
    wd_counts, wd_table, wd_tower, wd_cache, _ = wide_deep_train(
        dev, wd_params, wd_batches)

    # 14. end to end against the plain versions, with evictions
    wide_deep_end_to_end(dev, wd_params, wd_batches)

    # 15. serve the trained table through a q8 cache
    q8_counts, _ = wide_deep_serve(dev, wd_table, wd_tower, wd_serve)

    # 16. where a device-cache step's time goes
    profile_wide_deep(dev, wd_cache, wd_tower, wd_batches)
    del wd_table, wd_tower, wd_cache
    gc.collect()
    torch.cuda.empty_cache()

    # 17. the elastic bench on the host and the device engine
    el_counts, el_params = elastic_bench(dev)

    # 18. world 2, and a rank leaving mid-run, against phase 17
    el2_counts = elastic_worlds(dev, el_params)

    # 19. where an elastic step's time goes
    profile_elastic(dev)

    # 20. the online loop: primary, read replica, sweeper, trainer
    online_counts, online_state, _ = online_loop(dev, wd_params, wd_batches)

    # 21. the same stream with the plain versions and the numpy merge
    online_parity(dev, wd_params, wd_batches, online_state)

    # 22. exactly-once under chaos and across a restart
    online_exactly_once(dev, wd_params, wd_batches, online_state)

    # 23. where a streaming batch's time goes
    profile_online(dev, wd_params, wd_batches)
    gc.collect()
    torch.cuda.empty_cache()

    # 24. train ResNet-50 at the bench's configuration
    rn_model, rn_step, rn_img, rn_label, rn_counts = resnet_train(dev)

    # 25. the bf16-AMP step against f32
    resnet_train_vs_f32(dev, rn_img, rn_label)

    # 26. kernel 10 on the real 1x1-conv activations of a training step
    conv_bn_on_activations(dev, rn_model, rn_step, rn_img, rn_label)

    # 27. the A/B: kernel 10 against matmul_then_stats
    ab_counts, _ = conv_bn_ab()

    # 28. where a ResNet-50 training step's time goes
    profile_resnet_train(dev, rn_step, rn_img, rn_label)
    del rn_model, rn_step, rn_img, rn_label

    kernels = []
    for name, s in registry.kernels().items():
        launches = sum(c[name] for c in (counts, train_counts, resnet_counts,
                                         wd_counts, q8_counts, el_counts,
                                         el2_counts, online_counts,
                                         rn_counts, ab_counts))
        kernels.append(dict(name=name, route="cuda", source=s.source,
                            replaces=s.replaces, launches=launches,
                            **rows[name]))
    log(json.dumps({"kernels": kernels}))
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
