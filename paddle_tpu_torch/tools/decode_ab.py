"""Kernel 4 at S = 1 and the 7B's decode step between checkouts of the
repo, on the card.

Run from the root of a checkout, with another checkout unpacked into a
directory of it (``git archive <commit> | tar -x -C _parent``)::

    python3 paddle_tpu_torch/tools/decode_ab.py _parent .

Each tree named runs in a process of its own with its
``paddle_tpu_torch`` first on the path, where this checkout's
``chip_smoke.py`` builds the tree's kernels and measures:

- kernel 4 at S = 1 at row 4's three shapes (the 7B decode, B 8, 32
  heads, head_dim 128, block size 16, 2,048 tokens; the serving mix;
  batch 1), held to the plain version within ``CARD_TOL`` and timed
  queued (``chip_smoke.queued_ms``) beside its bound
  (``chip_smoke.kv_bound``), with the plan's route; where the tree plans
  S = 1 on the many-row kernel, also with both of its folds (the keys
  split one chunk a block, and every chunk in one block:
  ``_rows_plan(..., chunks_a_block=K)``), each bitwise the plan's
  output;
- phase 4: the 7B served through a plain ``GenerationServer`` (8
  prompts of the serving mix, 32 tokens each): decode ms a step
  (``chip_smoke.serve``);
- phase 6: device busy ms a steady decode step and kernel 4's share of
  it, under ``torch.profiler`` (``chip_smoke.profile_decode``).

It prints one line ``T {json}`` a tree; without a card it raises.
"""
from __future__ import annotations

import importlib.util
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]

S1_SHAPES = ("7B decode (B 8, T 2048)", "serving mix (phase 6's lengths)",
             "batch 1 (T 2048)")


def chunk_sweep(cs, kva, args, plan, want):
    """Queued ms of the many-row kernel on ``args`` with its keys split
    one chunk a block (K = 1) and with every chunk in one block (the
    kernel folds a row's chunks bitwise alike only at these two; each
    output must equal ``want``)."""
    import ctypes

    import torch
    from paddle_tpu_torch.ops.kernels import _build
    qh, kp, vp, ks, vs, tbl, pos, KH = args
    B, S, H, D = qh.shape
    lib = _build.load(kva._SOURCE)
    out = {}
    for K in (1, plan.chunks):
        other = kva._rows_plan(B, S, H, KH, D, kp.shape[1], tbl.shape[1],
                               kva._sm_count(qh.device), plan.q_pieces,
                               chunks_a_block=K)
        ints = (ctypes.c_int * 7)(*other.launch())
        t32, p32 = tbl.to(torch.int32).contiguous(), pos.to(
            torch.int32).contiguous()

        def run():
            return kva._rows_cuda(lib, other, ints, qh, kp, vp, ks, vs, t32,
                                  p32, torch.empty_like(qh))
        if not torch.equal(run(), want):
            cs.fail(f"{K} chunks a block changed the bits")
        out[K] = cs.queued_ms(run)
    return out


def run_one(tree: str) -> None:
    sys.path.insert(0, str(pathlib.Path(tree).resolve()))
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import torch
    from paddle_tpu_torch.ops.kernels import _build
    from paddle_tpu_torch.ops.kernels import kv_attention as kva
    from paddle_tpu_torch.text.models import LlamaForCausalLM, llama_7b
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    _build.build()
    bf = torch.bfloat16
    mix = [n + 16 for n in cs.SERVING_MIX_LENS]
    shapes = dict(zip(S1_SHAPES, (
        cs.kv_case(dev, 8, 1, 32, 32, 128, 16, 128, bf, full=True),
        cs.kv_case(dev, 8, 1, 32, 32, 128, 16, 128, bf, last=mix),
        cs.kv_case(dev, 1, 1, 32, 32, 128, 16, 128, bf, full=True))))
    res = dict(tree=tree, s1={})
    for label, args in shapes.items():
        got = kva.int8_paged_attention(*args)
        ref = kva.int8_paged_attention(*args, mode="torch_ref")
        err, _ = cs.check_close(f"{tree} {label}", got, ref, kva.CARD_TOL[bf])
        plan = kva.int8_kv_plan(*args[0].shape[:3], args[7],
                                args[0].shape[3], 16, args[5].shape[1])
        bms, by = cs.kv_bound(args)
        res["s1"][label] = dict(
            ms=cs.queued_ms(lambda: kva.int8_paged_attention(*args)),
            bound_ms=bms, bound_by=by, max_abs_err=err, route=plan.route)
        if plan.route == "rows":
            res["s1"][label]["chunks_a_block"] = chunk_sweep(
                cs, kva, args, plan, got)
    del shapes
    torch.cuda.empty_cache()
    model = LlamaForCausalLM(llama_7b(kv_cache_dtype="int8"), device=dev,
                             dtype="bfloat16", generator=torch.Generator(
                                 device=dev).manual_seed(cs.SEED))
    model.eval()
    _, served = cs.serve(dev, model)
    res["phase4_decode_ms_per_step"] = served["decode_ms_per_step"]
    res["phase4_ttft_ms_median"] = served["ttft_ms_median"]
    res["phase6"] = cs.profile_decode(dev, model)
    print("T " + json.dumps(res), flush=True)


def main(trees) -> int:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    for tree in trees:
        out = subprocess.run([sys.executable, __file__, "--one", tree],
                             capture_output=True, text=True)
        sys.stdout.write(out.stdout)
        if out.returncode:
            sys.stderr.write(out.stderr[-8000:])
            return out.returncode
    return 0


if __name__ == "__main__":
    if len(sys.argv) > 2 and sys.argv[1] == "--one":
        run_one(sys.argv[2])
        sys.exit(0)
    sys.exit(main(sys.argv[1:]))
