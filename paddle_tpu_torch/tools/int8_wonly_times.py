"""Device times of weight-only ``int8_matmul`` between checkouts of the repo,
on the card.

Run from the root of a checkout, with another checkout unpacked into a
directory of it (``git archive <commit> | tar -x -C _parent``)::

    python3 paddle_tpu_torch/tools/int8_wonly_times.py _parent .

Each tree named runs in a process of its own, with its
``paddle_tpu_torch`` and its ``chip_smoke.py`` first on the path, and
times its weight-only ``int8_matmul`` at the weight-only ResNet-50's
classifier (M = 1, 32 and 128, K = 2,048, N = 1,000) and at BERT-base's
FFN at batch 128 and sequence 128 (M = 16,384, K = 768, N = 3,072), in
bf16 and f32: the calls queued behind a spinning kernel
(``chip_smoke.queued_ms``), each checked against the tree's plain
version within its ``CARD_TOL``.  It prints one line ``T {json}`` a
shape, with the bound (bytes at 3.35 TB/s or operations at 989 TFLOP/s
bf16 / 67 TFLOP/s f32, whichever is larger) and, for a tree whose module
has ``int8_wonly_plan``, the plan.  Without a card it raises.
"""
from __future__ import annotations

import json
import pathlib
import subprocess
import sys

PATH_SHAPES = [(1, 2048, 1000), (32, 2048, 1000), (128, 2048, 1000)]
LARGE_SHAPE = (16384, 768, 3072)


def _inputs(torch, dev, M, K, N, cdt, seed=5):
    g = torch.Generator(device=dev).manual_seed(seed)
    w = torch.randint(-127, 128, (N, K), device=dev, dtype=torch.int8,
                      generator=g)
    ws = torch.rand(N, device=dev, generator=g) * 1e-2 + 1e-4
    x = torch.randn(M, K, device=dev, generator=g).to(cdt)
    return x, w, ws


def _bound(cs, M, K, N, elt):
    peak = cs.PEAK_BF16_FLOPS if elt == 2 else cs.PEAK_F32_FLOPS
    return cs.bound_ms(2.0 * M * N * K, peak,
                       M * K * elt + N * K + 4 * N + M * N * elt)


def _check(torch, registry, im, got, ref, cdt):
    torch.cuda.synchronize()
    _, share = registry.card_error(got, ref, im.CARD_TOL[cdt])
    if not share <= 1.0:
        raise SystemExit(f"int8_wonly_times: {share:.3g} of the limit")
    return share


def run_one(tree: str) -> None:
    sys.path.insert(0, str(pathlib.Path(tree).resolve()))
    import torch
    import chip_smoke as cs
    from paddle_tpu_torch.ops.kernels import int8_matmul as im
    from paddle_tpu_torch.ops.kernels import registry
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    for (M, K, N) in PATH_SHAPES + [LARGE_SHAPE]:
        for cdt in (torch.bfloat16, torch.float32):
            x, w, ws = _inputs(torch, dev, M, K, N, cdt)

            def run():
                return im.int8_matmul(x, w, ws, compute_dtype=cdt)

            ref = im.int8_matmul(x, w, ws, compute_dtype=cdt,
                                 mode="torch_ref")
            share = _check(torch, registry, im, run(), ref, cdt)
            ms = cs.queued_ms(run, iters=20 if M < 1024 else 5)
            bms, by = _bound(cs, M, K, N, x.element_size())
            row = dict(tree=tree, M=M, K=K, N=N,
                       dtype=str(cdt).replace("torch.", ""), ms=ms,
                       bound_ms=bms, bound_by=by, share_of_limit=share)
            if hasattr(im, "int8_wonly_plan"):
                p = im.int8_wonly_plan(M, N, K, cdt)
                row["plan"] = dict(block_m=p.block_m, splits=p.splits,
                                   grid=p.grid)
            print("T " + json.dumps(row), flush=True)


def main(trees) -> int:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    for tree in trees:
        out = subprocess.run(
            [sys.executable, __file__, "--one", tree],
            capture_output=True, text=True)
        sys.stdout.write(out.stdout)
        if out.returncode:
            sys.stderr.write(out.stderr)
            return out.returncode
    return 0


if __name__ == "__main__":
    if len(sys.argv) > 2 and sys.argv[1] == "--one":
        run_one(sys.argv[2])
        sys.exit(0)
    sys.exit(main(sys.argv[1:]))
