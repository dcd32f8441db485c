"""Device times of the flash kernels (kernel 1, the forward; kernels 2 and
3, the backward) between checkouts of the repo, on the card, at
ERNIE-3.0-base's attention shape and, for kernel 1's bias row, at the
translation encoder's.

Run from the root of a checkout, with another checkout unpacked into a
directory of it (``git archive <commit> | tar -x -C _base``)::

    python3 paddle_tpu_torch/tools/flash_times.py _base . . _base

Each tree named runs in a process of its own with its
``paddle_tpu_torch`` first on the path.  There this checkout's
``chip_smoke.py`` makes phase 33's inputs and times the tree's kernels
queued, in turns with SDPA:

- kernel 1 at ERNIE's shape (B 8, H 12, S 2,048, D 64, bf16, not
  causal, with its LSE) with dropout p = 0.1 and without an option
  (``chip_smoke.forward_times``), held to the blockwise plain version at
  the tree's key tile within ``CARD_TOL``;
- kernel 1 with the bias row at the translation shape (B 8, H 8, S
  1,024, D 64, bf16, seeded padding; ``chip_smoke.bias_times``), held
  alike;
- kernels 2 and 3 at ERNIE's shape with dropout and without
  (``chip_smoke.backward_times``), held to the tree's blockwise plain
  version within ``CARD_TOL_BWD``;
- kernel 1 at row 1's shapes (the 7B prefill, B 1, H 32, and the
  proxy's forward with its LSE, B 4, H 16; S 2,048, D 128, causal), in
  turns with SDPA, held alike;
- kernel 1 in f32: with the bias row at the translation shape
  (``f32_bias``, the translation path's route) and at ERNIE's shape with
  dropout p = 0.1 and without an option (``f32_fwd``), held to the
  chunked plain version within ``CARD_TOL``.

It prints one line ``T {json}`` a tree, with the registers and spills
``ptxas -v`` reported for the tree's sm90 forward entries and its f32
forward entries (``chip_smoke.ptxas_entries``); without a card it
raises.
"""
from __future__ import annotations

import importlib.util
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]


def row1_times(cs, fa, dev, gen, tree):
    """Kernel 1 and SDPA at row 1's two shapes, causal, in turns."""
    import torch
    import torch.nn.functional as tF
    bf = torch.bfloat16
    out = {}
    for label, B, H, lse in (("7B prefill", 1, 32, False),
                             ("proxy with lse", 4, 16, True)):
        q, k, v = (torch.randn(B, H, 2048, 128, device=dev, dtype=bf,
                               generator=gen) for _ in range(3))
        with torch.no_grad():
            cs.check_close(f"{tree} {label}",
                           fa.flash_attention_bhsd(q, k, v, causal=True),
                           fa.flash_attention_blockwise_ref(
                               q, k, v, causal=True, block_k=fa.flash_fwd_plan(
                                   q, k, v).block_k), fa.CARD_TOL[bf])
            t = cs._turns({
                "kernel": lambda: fa.flash_attention_bhsd(
                    q, k, v, causal=True, return_lse=lse),
                "sdpa": lambda: tF.scaled_dot_product_attention(
                    q, k, v, is_causal=True)})
        out[label] = t
    return out


def run_one(tree: str) -> None:
    sys.path.insert(0, str(pathlib.Path(tree).resolve()))
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import torch
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    from paddle_tpu_torch.ops.kernels import registry
    dev = torch.device("cuda", 0)
    bf = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(cs.SEED + 36)
    seed = fa.dropout_seed(gen)
    q, k, v, do = (torch.randn(cs.ERNIE_TRAIN["batch"], 12,
                               cs.ERNIE_TRAIN["seq"], 64, device=dev,
                               dtype=bf, generator=gen)
                   for _ in range(4))
    kw = dict(causal=False, dropout_p=cs.OPT_P, seed=seed)
    fplan = fa.flash_fwd_plan(q, k, v, dropout_p=cs.OPT_P)
    broute = fa.flash_bwd_plan(q, k, v, do, dropout_p=cs.OPT_P).route
    with torch.no_grad():
        o, lse = fa.flash_attention_bhsd(q, k, v, return_lse=True, **kw)
        o0 = fa.flash_attention_bhsd(q, k, v)
        ro = fa.flash_attention_blockwise_ref(q, k, v, block_k=fplan.block_k,
                                              **kw)
        ro0 = fa.flash_attention_blockwise_ref(
            q, k, v, block_k=fa.flash_fwd_plan(q, k, v).block_k)
    for n, got, want in (("o", o, ro), ("o without dropout", o0, ro0)):
        cs.check_close(f"{tree} {n}", got, want, fa.CARD_TOL[bf])
    del ro, ro0
    tf = cs.forward_times(q, k, v, kw)
    args = (q, k, v, do, lse, fa.attention_delta(o, do))
    with torch.no_grad():
        dq, dk, dv = fa.flash_attention_bwd_blockwise_ref(*args, **kw)
    t, t0, bits = cs.backward_times(args, kw)   # the bits dQ reads
    with torch.no_grad():
        got_dk, got_dv = registry.dispatch(
            "flash_attention_bwd_dkv", *args, **kw,
            **({} if bits is None else dict(keep_bits_out=bits)))
        got_dq = registry.dispatch(
            "flash_attention_bwd_dq", *args, **kw,
            **({} if bits is None else dict(keep_bits=bits)))
    for n, got, want in (("dq", got_dq, dq), ("dk", got_dk, dk),
                         ("dv", got_dv, dv)):
        cs.check_close(f"{tree} {n}", got, want, fa.CARD_TOL_BWD[bf])
    res = dict(tree=tree, fwd=tf, ms=t, ms_no_dropout=t0, route=broute)
    del args, dq, dk, dv, got_dq, got_dk, got_dv, bits
    del q, k, v, do, o, o0, lse
    res["row1"] = row1_times(cs, fa, dev, gen, tree)
    # the bias row at the translation encoder's shape
    B, S = cs.MT_SRC["batch"], cs.MT_SRC["seq"]
    qb, kb, vb = (torch.randn(B, 8, S, 64, device=dev, dtype=bf,
                              generator=gen) for _ in range(3))
    bias = cs._pad_bias(dev, B, S, bf, cs.SEED + 35)
    bplan = fa.flash_fwd_plan(qb, kb, vb, bias=bias)
    with torch.no_grad():
        cs.check_close(f"{tree} o with the bias row",
                       fa.flash_attention_bhsd(qb, kb, vb, bias=bias),
                       fa.flash_attention_blockwise_ref(
                           qb, kb, vb, bias=bias, block_k=bplan.block_k),
                       fa.CARD_TOL[bf])
    res.update(bias=cs.bias_times(qb, kb, vb, bias), fwd_route=fplan.route,
               bias_route=bplan.route, ptxas=cs.ptxas_entries(
                   "flash_attention_fwd.cu", "flash_fwd_sm90"))
    # f32: the bias row at the translation shape, then dropout and no
    # option at ERNIE's shape
    f32 = torch.float32
    qf, kf, vf = (t.float() for t in (qb, kb, vb))
    del qb, kb, vb
    bias = cs._pad_bias(dev, B, S, f32, cs.SEED + 35)
    with torch.no_grad():
        cs.check_close(f"{tree} f32 o with the bias row",
                       fa.flash_attention_bhsd(qf, kf, vf, bias=bias),
                       fa.flash_attention_ref(qf, kf, vf, bias=bias),
                       fa.CARD_TOL[f32])
    res.update(f32_bias=cs.bias_times(qf, kf, vf, bias),
               f32_route=fa.flash_fwd_plan(qf, kf, vf, bias=bias).route)
    del qf, kf, vf, bias
    q, k, v = (torch.randn(cs.ERNIE_TRAIN["batch"], 12, cs.ERNIE_TRAIN["seq"],
                           64, device=dev, dtype=f32, generator=gen)
               for _ in range(3))
    with torch.no_grad():
        cs.check_close(f"{tree} f32 o with dropout",
                       fa.flash_attention_bhsd(q, k, v, **kw),
                       fa.flash_attention_ref(q, k, v, **kw),
                       fa.CARD_TOL[f32])
    res.update(f32_fwd=cs.forward_times(q, k, v, kw),
               ptxas_f32={n: e for m in ("flash_fwd_tf32x3", "flash_fwd_f32")
                          for n, e in cs.ptxas_entries(
                              "flash_attention_fwd.cu", m).items()})
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
            sys.stderr.write(out.stderr)
            return out.returncode
    return 0


if __name__ == "__main__":
    if len(sys.argv) > 2 and sys.argv[1] == "--one":
        run_one(sys.argv[2])
        sys.exit(0)
    sys.exit(main(sys.argv[1:]))
