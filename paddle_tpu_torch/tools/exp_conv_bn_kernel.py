"""Kernel-level A/B on the card: the fused 1x1-conv + BN-statistics kernel
against ``torch.matmul`` followed by the two reductions, at the eight
ResNet-50 batch-256 bottleneck 1x1-convolution shapes.

Counterpart of ``tools/exp_conv_bn_kernel.py`` (``xla_matmul_then_stats``,
``bench_one``, ``main``).  The question it asks: does taking the batch-norm
statistics in the matrix product's epilogue, with the activation never
read back, beat the product followed by reductions that read it again?
The fused kernel has one tile (no autotune: see
``ops.kernels.conv_bn_stats``), so ``tile`` is that kernel's.

Run on a machine with a CUDA card::

    python -m paddle_tpu_torch.tools.exp_conv_bn_kernel

It prints one JSON line per shape and the count of shapes where the fused
kernel wins by more than 5 %.  Without a card it raises.
"""
from __future__ import annotations

import json

import numpy as np
import torch

from ..ops.kernels.conv_bn_stats import (BLOCK_ROWS, fused_matmul_bn_stats,
                                         fused_matmul_bn_stats_ref)

__all__ = ["SHAPES", "matmul_then_stats", "bench_one", "main"]

# ResNet-50 batch-256 bottleneck 1x1 shapes (M = B*H*W, K in, N out)
SHAPES = [
    (256 * 56 * 56, 256, 64),      # stage 2 reduce (the largest activation)
    (256 * 56 * 56, 64, 256),      # stage 2 expand
    (256 * 28 * 28, 512, 128),     # stage 3 reduce
    (256 * 28 * 28, 128, 512),     # stage 3 expand
    (256 * 14 * 14, 1024, 256),    # stage 4 reduce
    (256 * 14 * 14, 256, 1024),    # stage 4 expand
    (256 * 7 * 7, 2048, 512),      # stage 5 reduce
    (256 * 7 * 7, 512, 2048),      # stage 5 expand
]


def matmul_then_stats(x, w):
    """The unfused yardstick: ``torch.matmul`` with bf16 out, then the f32
    column sums of y and of its square, reading y again."""
    y = torch.matmul(x, w)
    yf = y.float()
    return y, yf.sum(0), (yf * yf).sum(0)


def _median_window_ms(fn, iters):
    """Median of 3 windows of ``iters`` calls, each timed by CUDA events."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(3):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(iters):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / iters)
    return sorted(times)[1]


def bench_one(M, K, N, iters=30):
    """Time the fused kernel, ``matmul_then_stats`` and ``torch.matmul``
    alone on the same seeded bf16 inputs on the card.  Returns the
    reference's keys (``xla_ms`` is ``torch_ms``) in ms; the fused
    kernel's s1 must agree with the plain version's first."""
    if not torch.cuda.is_available():
        raise RuntimeError("exp_conv_bn_kernel runs on a CUDA card only "
                           "(torch.cuda.is_available() is False)")
    dev = torch.device("cuda")
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(M, K).astype(np.float32)).to(
        dev, torch.bfloat16)
    w = torch.from_numpy((rng.randn(K, N) * 0.05).astype(np.float32)).to(
        dev, torch.bfloat16)
    _, s1f, _ = fused_matmul_bn_stats(x, w)
    _, s1p, _ = fused_matmul_bn_stats_ref(x, w)
    # the reference's check of its candidate tiles
    torch.testing.assert_close(s1f, s1p, rtol=2e-2, atol=M * 2e-3)
    best = _median_window_ms(lambda: fused_matmul_bn_stats(x, w), iters)
    tp = _median_window_ms(lambda: matmul_then_stats(x, w), iters)
    tm = _median_window_ms(lambda: torch.matmul(x, w), iters)
    bn = 64 if N <= 64 else 128
    return dict(M=M, K=K, N=N, tile=(BLOCK_ROWS, bn),
                fused_ms=round(best, 3), torch_ms=round(tp, 3),
                matmul_only_ms=round(tm, 3),
                speedup=round(tp / best, 3),
                stats_overhead_fused_ms=round(best - tm, 3),
                stats_overhead_torch_ms=round(tp - tm, 3))


def main():
    """Run the eight shapes; print each result and the verdict line.
    Returns the list of results."""
    out = []
    for M, K, N in SHAPES:
        r = bench_one(M, K, N)
        print(json.dumps(r), flush=True)
        out.append(r)
    won = sum(1 for r in out if r["speedup"] > 1.05)
    print(f"# fused wins (>5%) on {won}/{len(out)} shapes", flush=True)
    return out


if __name__ == "__main__":
    main()
