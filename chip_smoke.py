#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``paddle_tpu_torch``) on one NVIDIA H100.

Run from the repository root with no arguments (one card)::

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and nothing is caught:

1. header: the card's name and power limit (``nvidia-smi``), torch and
   CUDA versions;
2. build every CUDA kernel from ``paddle_tpu_torch/ops/kernels/csrc``
   (one ``nvcc`` per source, started together) and print the seconds
   and the registers/shared memory ptxas reports;
3. each kernel against its plain PyTorch version on the card, at the
   serving and training shapes and a few more (dtypes, head dims, GQA,
   ragged lengths, the (B, S, H, D) layouts the models pass, verify
   blocks, idle trash-block rows), within the kernel module's
   ``CARD_TOL``, timed with CUDA events (median of 20), beside the least
   time the card could take (``bound_ms``) and, for flash attention,
   PyTorch's ``scaled_dot_product_attention`` (forward, and backward for
   the two backward kernels) as a yardstick the port never calls; the
   backward kernels also run twice on the same inputs and must agree
   bitwise;
4. serve ``llama_7b(kv_cache_dtype="int8")`` (bf16 weights drawn from a
   seed) through the port's ``GenerationServer``: 8 greedy requests of
   mixed prompt lengths, 32 new tokens each; the kernel launch counts of
   this run prove prefill went through the flash kernel (32 launches per
   prefill dispatch) and decode through the int8 kernel (32 per step);
5. one prefill and one decode step of the same model with the kernels
   and with their plain versions (``mode="torch_ref"``): the logits must
   agree within the bf16 bound stated below;
6. ``torch.profiler`` over 5 steady decode steps of the same model:
   device busy time against wall time, and the top device kernels;
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
   wall time, the top device kernels and the largest allocations.

The 7B serving model is freed before phase 7, and the peak-memory
counter reset, so each workload reports its own peak.  Before the last
line it prints one JSON object ``{"kernels": [...]}`` (launches summed
over the serving run of phase 4 and the training run of phase 7); the
last line is ``{"ok": true, "device": {...}}``.  Exits non-zero,
printing no result, without a CUDA device or without the package.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import math
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 1234
# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, f32
# outside the tensor cores, HBM3 bandwidth
PEAK_BF16_FLOPS = 989e12
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


def bound_ms(flops: float, peak_flops: float, nbytes: float):
    t_ops = flops / peak_flops * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


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

def flash_cases(dev):
    import torch.nn.functional as tF

    from paddle_tpu_torch.ops.kernels.flash_attention import (
        CARD_TOL, flash_attention, flash_attention_bhsd,
        flash_attention_blockwise_ref)
    g = torch.Generator(device=dev).manual_seed(SEED)

    row = None
    cases = [  # (B, H, Hkv, S, D, dtype, causal, layout)
        (1, 32, 32, 2048, 128, torch.bfloat16, True, "bhsd"),  # 7B prefill
        (4, 32, 32, 1024, 128, torch.bfloat16, True, "bshd"),  # as served
        (1, 8, 8, 512, 128, torch.float32, True, "bhsd"),
        (2, 8, 8, 1000, 64, torch.bfloat16, False, "bhsd"),
        (1, 8, 2, 777, 256, torch.bfloat16, True, "bhsd"),
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
        # max of 64-key tiles; the blockwise plain version does the same,
        # and the kernel is held to it
        rp = (flash_attention_blockwise_ref(q, k, v, causal=causal)
              if dt == torch.bfloat16 else ro)
        torch.cuda.synchronize()
        dname = str(dt).replace("torch.", "")
        shape = f"B={B} H={H} Hkv={Hkv} S={S} D={D} {dname} causal={causal}"
        err, share = check_close(f"flash_attention {shape}", o, rp,
                                 CARD_TOL[dt])
        late = (o.float() - rp.float())[:, :, S // 2:].abs().max().item()
        late_o = rp[:, :, S // 2:].float().abs().median().item()
        full = (o.float() - ro.float()).abs().max().item()
        msg = (f"flash_attention {shape} {layout}: max_err {err:.3g}, "
               f"{share:.3g} of its limit; rows >= S/2 {late:.3g} at a "
               f"median |o| {late_o:.3g}; vs the chunked f32 plain version "
               f"{full:.3g}")
        if lse is not None:
            lerr = (lse - rl).abs().max().item()
            if lerr > 1e-3:
                fail(f"flash_attention lse: max |err| {lerr:.3g} > 1e-3")
            msg += f" lse_err {lerr:.3g}"
        log(msg)
        if i == 0:
            ms = cuda_ms(lambda: flash_attention_bhsd(q, k, v, causal=True))
            plain = cuda_ms(lambda: flash_attention_bhsd(
                q, k, v, causal=True, mode="torch_ref"))
            lib = cuda_ms(lambda: tF.scaled_dot_product_attention(
                q, k, v, is_causal=True))
            pairs = B * H * S * (S + 1) / 2          # causal (q, k) pairs
            nbytes = 4 * B * H * S * D * q.element_size()
            bms, by = bound_ms(4 * D * pairs, PEAK_BF16_FLOPS, nbytes)
            row = dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bms,
                       bound_by=by, library_ms=lib)
            log(f"flash_attention 7B prefill shape: kernel_ms {ms:.4f} "
                f"plain_ms {plain:.4f} bound_ms {bms:.4f} ({by}) "
                f"library_ms(sdpa) {lib:.4f}")
    return row


def _flash_grads(q, k, v, g, causal, mode=None):
    """dq, dk, dv of ``flash_attention`` on (B, S, H, D) tensors through
    the autograd Function, as the model's attention calls it."""
    from paddle_tpu_torch.ops.kernels.flash_attention import flash_attention
    qq, kk, vv = (t.detach().requires_grad_() for t in (q, k, v))
    o = flash_attention(qq, kk, vv, causal=causal, mode=mode)
    return torch.autograd.grad(o, (qq, kk, vv), g)


def bwd_cases(dev):
    """Both backward kernels against their plain versions: the training
    shape (first case) and more dtypes, head dims, GQA, ragged lengths,
    all as (B, S, H, D) tensors through the autograd Function.  Returns
    the kernels-line rows of both kernels; also prints the flash
    forward's time at the training shape."""
    import torch.nn.functional as tF

    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    from paddle_tpu_torch.ops.kernels import registry
    g0 = torch.Generator(device=dev).manual_seed(SEED + 3)
    rows = {}
    cases = [  # (B, H, Hkv, S, D, dtype, causal); first = the proxy
        (4, 16, 16, 2048, 128, torch.bfloat16, True),
        (1, 8, 8, 512, 64, torch.float32, True),
        (2, 8, 2, 1000, 64, torch.bfloat16, False),
        (1, 4, 4, 777, 256, torch.bfloat16, True),
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
        msg = f"flash backward {shape} (B, S, H, D):"
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
        kw = dict(causal=True)
        ms = {n: cuda_ms(lambda n=n: registry.dispatch(n, *args, **kw))
              for n in ("flash_attention_bwd_dkv", "flash_attention_bwd_dq")}
        plain = {n: cuda_ms(lambda n=n: registry.dispatch(
            n, *args, mode="torch_ref", **kw))
            for n in ("flash_attention_bwd_dkv", "flash_attention_bwd_dq")}
        q2, k2, v2 = (t.detach().contiguous().requires_grad_()
                      for t in (qh, kh, vh))
        out = tF.scaled_dot_product_attention(q2, k2, v2, is_causal=True)
        do2 = gh.contiguous()
        lib = cuda_ms(lambda: torch.autograd.grad(out, (q2, k2, v2), do2,
                                                  retain_graph=True))
        pairs = B * H * S * (S + 1) / 2          # causal (q, k) pairs
        elt = q.element_size()
        row_bytes = B * H * S * D * elt
        stats_bytes = 2 * B * H * S * 4           # lse and delta
        for name, flop_per_pair, n_rows, grads in (
                ("flash_attention_bwd_dkv", 8 * D, 6, ("dk", "dv")),
                ("flash_attention_bwd_dq", 6 * D, 5, ("dq",))):
            bms, by = bound_ms(flop_per_pair * pairs, PEAK_BF16_FLOPS,
                               n_rows * row_bytes + stats_bytes)
            rows[name] = dict(max_abs_err=max(errs[x] for x in grads),
                              ms=ms[name], plain_ms=plain[name],
                              bound_ms=bms, bound_by=by, library_ms=lib)
            log(f"{name} training shape: kernel_ms {ms[name]:.4f} plain_ms "
                f"{plain[name]:.4f} bound_ms {bms:.4f} ({by}) "
                f"library_ms(sdpa backward, dq+dk+dv) {lib:.4f}")
        f_ms = cuda_ms(lambda: fa.flash_attention_bhsd(
            qh, kh, vh, causal=True, return_lse=True))
        f_plain = cuda_ms(lambda: fa.flash_attention_bhsd(
            qh, kh, vh, causal=True, return_lse=True, mode="torch_ref"))
        with torch.no_grad():
            f_lib = cuda_ms(lambda: tF.scaled_dot_product_attention(
                q2, k2, v2, is_causal=True))
        f_bms, f_by = bound_ms(4 * D * pairs, PEAK_BF16_FLOPS,
                               4 * row_bytes + B * H * S * 4)
        log(f"flash_attention training shape (with lse): kernel_ms "
            f"{f_ms:.4f} plain_ms {f_plain:.4f} bound_ms {f_bms:.4f} "
            f"({f_by}) library_ms(sdpa) {f_lib:.4f}")
        del out, q2, k2, v2
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
    from torch.autograd import DeviceType
    kern = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kern) / 1e3 / steps
    n_kern = sum(e.count for e in kern) // steps
    log(f"profile decode: wall {wall_ms:.2f} ms/step, device busy "
        f"{busy_ms:.2f} ms/step, idle share "
        f"{max(0.0, 1 - busy_ms / wall_ms):.3f}, {n_kern} kernels/step")
    for e in sorted(kern, key=lambda e: -e.self_device_time_total)[:12]:
        log(f"  {e.key[:70]:70s} {e.self_device_time_total / 1e3 / steps:8.3f}"
            f" ms/step  x{e.count // steps}")


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
    want = {"flash_attention": 2 * cfg.num_hidden_layers,
            "flash_attention_bwd_dkv": cfg.num_hidden_layers,
            "flash_attention_bwd_dq": cfg.num_hidden_layers,
            "int8_kv_attention": 0}
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
    from torch.autograd import DeviceType
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
    kern = [e for e in avgs if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kern) / 1e3 / steps
    n_kern = sum(e.count for e in kern) // steps
    log(f"profile train: wall {wall_ms:.2f} ms/step, device busy "
        f"{busy_ms:.2f} ms/step, idle share "
        f"{max(0.0, 1 - busy_ms / wall_ms):.3f}, {n_kern} kernels/step")
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

    # 2. build
    t0 = time.perf_counter()
    _build.build()
    log(f"build: {time.perf_counter() - t0:.1f} s wall for "
        f"{len(_build.SOURCES)} sources in parallel")
    for src in _build.SOURCES:
        secs = _build.build_seconds.get(src)
        log(f"build {src}: " + ("cached" if secs is None else
                                f"{secs:.1f} s"))
        for line in _build.build_logs.get(src, "").splitlines():
            if "Compiling entry" in line or "Used" in line \
                    or "spill" in line:
                log("  " + line.strip())

    # 3. kernels against their plain versions
    rows = {"flash_attention": flash_cases(dev),
            "int8_kv_attention": kv_cases(dev)}
    rows.update(bwd_cases(dev))

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

    kernels = []
    for name, s in registry.kernels().items():
        kernels.append(dict(name=name, route="cuda", source=s.source,
                            replaces=s.replaces,
                            launches=counts[name] + train_counts[name],
                            **rows[name]))
    log(json.dumps({"kernels": kernels}))
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
