"""A/B of the int8 ResNet-50 forward between checkouts of the repo, on the
card: ``chip_smoke.py`` phase 10's measurement with each checkout's own
package, in turns.

Run from the root of a checkout, with the other checkout unpacked into a
directory of it (``git archive <commit> | tar -x -C _parent``)::

    python3 paddle_tpu_torch/tools/int8_forward_ab.py _parent . . _parent

(any sequence of trees; the host is noisy, so name each tree several
times, in turns).

Each tree named runs in a process of its own, with its
``paddle_tpu_torch`` and its ``chip_smoke.py`` first on the path, and
prints one line ``AB {json}``:

- per batch (1, 32, 128), the int8 and the bf16 model's wall ms a
  forward (events around one forward, median and least of 20).  No int8
  change touches the bf16 model: its time shows how fast the host was
  in that run;
- the int8 forward's device busy ms and its int8 GEMMs' device ms
  (``torch.profiler`` over 3 forwards);
- the host's microseconds to issue one ``int8_matmul`` call at layer4's
  3x3 at batch 1 (M 49, K 4,608, N 512), and, as a yardstick of the
  host's speed in the same process, one ``torch.add`` of two [512]
  tensors: 200 calls queued behind a spinning kernel, the least of 10
  rounds (the host's other work only ever adds time).

Then ``AB pairs {json}`` gives each pair of runs (first and second,
third and fourth, ...) as the other tree's numbers minus the first
tree's, and the last line, ``AB summary {json}``, for each number the
first tree's and the other tree's median, the first tree's quartiles,
and in how many pairs the other tree's was lower.  Without a card it
raises.
"""
from __future__ import annotations

import json
import pathlib
import statistics
import subprocess
import sys
import time

BATCHES = (1, 32, 128)


def _wall_ms(torch, fn, iters=20, warmup=3):
    """Events around one call of ``fn``: (median, least) ms of ``iters``."""
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
    return statistics.median(times), min(times)


def _host_us(torch, fn, calls=200, rounds=10):
    """The least over ``rounds`` of the host's microseconds a call of
    ``fn``, ``calls`` calls queued behind a spinning kernel."""
    for _ in range(20):
        fn()
    best = float("inf")
    for _ in range(rounds):
        torch.cuda.synchronize()
        torch.cuda._sleep(int(2e9 * 0.05))      # ~50 ms of device time
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        best = min(best, (time.perf_counter() - t0) / calls * 1e6)
        torch.cuda.synchronize()
    return best


def _call_host_us(torch, dev):
    from paddle_tpu_torch.ops.kernels.int8_matmul import int8_matmul
    g = torch.Generator(device=dev).manual_seed(7)
    x = torch.randint(-127, 128, (49, 4608), device=dev, dtype=torch.int8,
                      generator=g)
    w = torch.randint(-127, 128, (512, 4608), device=dev, dtype=torch.int8,
                      generator=g)
    ws = torch.rand(512, device=dev, generator=g) * 1e-2 + 1e-4
    xs = torch.tensor(0.0123, device=dev)
    return (_host_us(torch, lambda: int8_matmul(x, w, ws, x_scale=xs)),
            _host_us(torch, lambda: torch.add(ws, ws)))


def run_one(tree: str) -> dict:
    """Phase 10's numbers with the package of ``tree``."""
    sys.path.insert(0, str(pathlib.Path(tree).resolve()))
    import torch
    import chip_smoke as cs
    import paddle_tpu_torch
    dev = torch.device("cuda", 0)
    res = {"tree": tree, "package": paddle_tpu_torch.__file__}
    torch.backends.cudnn.benchmark = True
    bf16, int8 = cs.resnet_models(dev)
    with torch.no_grad():
        for b in BATCHES:
            x = cs._images(dev, b)
            for name, model in (("int8", int8), ("bf16", bf16)):
                model(x)
                torch.cuda.synchronize()
                (res[f"b{b}_{name}_ms"],
                 res[f"b{b}_{name}_min_ms"]) = _wall_ms(torch,
                                                       lambda: model(x))
            _, busy, kern = cs.profile_calls(lambda: int8(x))
            res[f"b{b}_int8_busy_ms"] = busy
            res[f"b{b}_gemm_ms"] = sum(
                e.self_device_time_total for e in kern
                if "int8_mm" in e.key) / 1e3 / 3
        res["call_host_us"], res["add_host_us"] = _call_host_us(torch, dev)
    return res


def main(trees) -> int:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    runs = []
    for tree in trees:
        out = subprocess.run([sys.executable, __file__, "--one", tree],
                             capture_output=True, text=True, check=True)
        line = [ln for ln in out.stdout.splitlines()
                if ln.startswith("AB ")][-1]
        print(line, flush=True)
        runs.append(json.loads(line[3:]))
    base = trees[0]
    pairs = []
    for a, b in zip(runs[::2], runs[1::2]):
        first, other = (a, b) if a["tree"] == base else (b, a)
        pairs.append({"tree": other["tree"], **{
            k: other[k] - first[k] for k in first
            if isinstance(first[k], float)}})
    print("AB pairs " + json.dumps(pairs), flush=True)
    summary = {}
    for k in pairs[0] if pairs else ():
        if k == "tree":
            continue
        mine = [r[k] for r in runs if r["tree"] == base]
        other = [r[k] for r in runs if r["tree"] != base]
        summary[k] = dict(
            first=statistics.median(mine), other=statistics.median(other),
            first_quartiles=statistics.quantiles(mine, n=4)
            if len(mine) > 1 else None,
            other_lower=sum(p[k] < 0 for p in pairs), pairs=len(pairs))
    print("AB summary " + json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--one"]:
        print("AB " + json.dumps(run_one(sys.argv[2])), flush=True)
    else:
        sys.exit(main(sys.argv[1:] or ["_parent", ".", ".", "_parent"]))
