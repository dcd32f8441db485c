"""Device times of the flash backward kernels (kernels 2 and 3) between
checkouts of the repo, on the card, at ERNIE-3.0-base's attention shape.

Run from the root of a checkout, with another checkout unpacked into a
directory of it (``git archive <commit> | tar -x -C _base``)::

    python3 paddle_tpu_torch/tools/flash_bwd_times.py _base . . _base

Each tree named runs in a process of its own with its
``paddle_tpu_torch`` first on the path.  There this checkout's
``chip_smoke.py`` makes phase 33 (c)'s inputs (B 8, H 12, S 2,048, D 64,
bf16, not causal, its seed), holds the tree's kernels 2 and 3 with
dropout p = 0.1 to the tree's plain version within ``CARD_TOL_BWD``, and
times them with dropout and without (``chip_smoke.backward_times``).  It
prints one line ``T {json}`` a tree; without a card it raises.
"""
from __future__ import annotations

import importlib.util
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]


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
    gen = torch.Generator(device=dev).manual_seed(cs.SEED + 36)
    seed = fa.dropout_seed(gen)
    q, k, v, do = (torch.randn(cs.ERNIE_TRAIN["batch"], 12,
                               cs.ERNIE_TRAIN["seq"], 64, device=dev,
                               dtype=torch.bfloat16, generator=gen)
                   for _ in range(4))
    kw = dict(causal=False, dropout_p=cs.OPT_P, seed=seed)
    with torch.no_grad():
        o, lse = fa.flash_attention_bhsd(q, k, v, return_lse=True, **kw)
        args = (q, k, v, do, lse, fa.attention_delta(o, do))
        dq, dk, dv = fa.flash_attention_bwd_blockwise_ref(*args, **kw)
    t, t0, bits = cs.backward_times(args, kw)   # the keep bits dQ reads
    with torch.no_grad():
        got_dk, got_dv = registry.dispatch(
            "flash_attention_bwd_dkv", *args, **kw,
            **({} if bits is None else dict(keep_bits_out=bits)))
        got_dq = registry.dispatch(
            "flash_attention_bwd_dq", *args, **kw,
            **({} if bits is None else dict(keep_bits=bits)))
    for n, got, want in (("dq", got_dq, dq), ("dk", got_dk, dk),
                         ("dv", got_dv, dv)):
        cs.check_close(f"{tree} {n}", got, want,
                       fa.CARD_TOL_BWD[torch.bfloat16])
    print("T " + json.dumps(dict(
        tree=tree, ms=t, ms_no_dropout=t0,
        route=fa.flash_bwd_plan(q, k, v, do, dropout_p=cs.OPT_P).route)),
        flush=True)


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
