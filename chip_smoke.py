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
   spill in ``segment_sum.cu`` (kernels 7 and 8), in the four sm90
   entries of ``flash_attention_fwd.cu`` (kernel 1: head_dim 128; head
   dim 64 without options, with the bias row, with dropout) or the six
   of ``flash_attention_bwd.cu`` (kernels 2 and 3), in the
   option entries (bias row, dropout) of both flash sources or in the
   four ``int8_mm_sm90`` entries of ``int8_matmul.cu`` (kernel 6) or the
   twenty ``int8_kv_rows`` entries of ``int8_kv_attention.cu`` (kernel 4,
   one kernel for every S) or the nine
   ``int8_wonly`` entries of ``int8_matmul.cu`` (kernel 6's weight-only
   mode), or a wgmma that ptxas serialised there, fails;
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
   ``attention_delta`` and SDPA's backward are timed the same way; the
   int8 paged attention (kernel 4) is also bitwise equal to itself on a
   rerun in every case, a sequence alone at batch 1 through a narrower
   table is bitwise its row in the serving mix's batch of 8, and the 7B
   decode (B 8, 2,048 tokens), the serving mix (phase 6's lengths) and
   batch 1 at 2,048 tokens (S = 1) are timed queued beside their byte
   bounds, with the plan's split; an empty kernel is timed queued the same way (at 1
   and at 128 blocks): the fixed device cost of a launch; kernels 1-3
   are also held, rerun and timed at the shapes phases 48-51 launch
   them at (S 2,048: B 4, H 8; B 1, H 16; B 1, H 8);
4. serve ``llama_7b(kv_cache_dtype="int8")`` (bf16 weights drawn from a
   seed) through the port's ``GenerationServer``: 8 greedy requests of
   mixed prompt lengths, 32 new tokens each; the kernel launch counts of
   this run prove prefill went through the flash kernel (32 launches per
   prefill dispatch) and decode through the int8 kernel (32 per step);
5. one prefill and one decode step of the same model with the kernels
   and with their plain versions (``mode="torch_ref"``): the logits must
   agree within the bf16 bound stated below;
6. ``torch.profiler`` over 5 steady decode steps of the same model:
   device busy time against wall time, the top device kernels, kernel
   1's device ms per step (0: decode runs no flash forward) and kernel
   4's device ms and launches per step;
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
    ratio (the bench's ``int8_speedup``), and the same for the
    weight-only conversion (``act_quant=None``: its 53 convolutions
    dequantise and convolve, its classifier runs the kernel's
    weight-only mode); the launch counts prove every int8 forward went
    through ``int8_matmul`` exactly 54 times (53 convolutions and the
    classifier) and every weight-only forward exactly once, in
    weight-only mode;
11. the int8 model's batch-32 logits with the kernel and with its plain
    version (``set_kernel_mode(model, "torch_ref")``) must be bitwise
    equal (integer sums are order-free); the weight-only model's within
    ``CARD_TOL[bf16]`` of its plain version's and bitwise on a rerun; for
    information, the top-1 agreement of each with the bf16 model;
12. ``torch.profiler`` over 3 batch-32 int8 forwards: device busy time
    against wall time, the top device kernels, and the int8 GEMMs'
    device ms a forward beside the first (``mma.sync``) kernel's; then
    over 3 weight-only forwards: busy, idle share and the weight-only
    kernel's device ms a forward;
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
    optimizer ranges, and the largest allocations;
29. train the reference bench's BERT-base pretraining
    (``bench.py:366-418``, nothing cut: ``BertForPretraining(bert_base())``
    with dropout 0.1, f32 weights from a seed, batch 128 x seq 128, 19
    masked positions a sequence, ids, sorted positions and MLM and NSP
    labels drawn by ``RandomState(0)`` in the bench's order) with
    ``BertPretrainingCriterion`` and ``AdamW(1e-4)`` through the bf16-AMP
    ``DistributedTrainStep``: 20 steps, every loss finite, the first
    within 0.5 of ln(30,522) + ln(2); ms/step (median of steps 3-20),
    tokens/s, model TFLOP/s and MFU from the bench's analytic count, peak
    memory; the launch counts of this run are 0 for every registered
    kernel (at seq 128 the reference runs no Pallas kernel);
30. at batch 16 with dropout off, one bf16-AMP step against the same
    step from the f32 weights in f32: the loss within 2 %, the gradients'
    cosine printed beside a control (the f32 step on bf16-rounded
    weights) and required positive; then dropout on 2^24 elements at p =
    0.1: the keep rate within 0.9 +- 0.001, the output bitwise the kept
    values divided by f32(0.9) (the mask replayed from the generator),
    the same seed the same mask, another seed another;
32. (run right after phase 30, on phase 29's model, which is then freed)
    ``torch.profiler`` over 2 BERT training steps: device busy time
    against wall time, the top device kernels, device time by kernel
    class and under the ``layer_norm``, ``dropout``, ``attention``,
    ``gelu``, ``mlm_decode``, ``loss`` and ``optimizer`` ranges, and the
    largest allocations;
31. serve the reference inference bench's BERT arm
    (``bench.py:1684-1714``): ``BertModel(bert_base())`` cast to bf16 and
    its int8 conversion (only the pooler is a ``Linear``) cast the same
    way, on ids of seq 128 at batch 1, 8, 32 and 128: per-forward ms
    (median of 20 CUDA-event timings), sequences/s, device busy ms, peak
    memory and the bench's ``int8_speedup``; the launch counts prove every
    int8 forward launched ``int8_matmul`` exactly once, in dynamic mode,
    and no bf16 forward any kernel; at batch 32 the int8 pooled output is
    bitwise the plain version's (``set_kernel_mode(model, "torch_ref")``),
    and its largest distance from the bf16 model's is printed.

33. kernels 1-3's options against their plain versions: the keep mask
    of ``csrc/dropout.cuh`` (its debug entry) bitwise against
    ``dropout_keep_mask`` at phase 34's and 35's attention shapes, the
    keep rate within 5 sigma of 1 - p; kernel 1 with the bias row at the
    translation encoder's shape (B 8, H 8, S 1,024, D 64, seeded padding)
    in f32 and bf16 (the Hopper route; a row shared by the batch too)
    and at head_dim 128 in bf16 (``mma.sync``); kernels 1-3 with dropout
    (p 0.1) at ERNIE's shape (B 8, H 12, S 2,048, D 64), bf16 and f32,
    causal and not; each within ``CARD_TOL`` / ``CARD_TOL_BWD`` of its
    plain version with the same seed (bf16: the blockwise one at the
    kernel's key tile) and bitwise on a rerun, timed queued beside its
    bound (operations at 989 / 67 TFLOP/s; for kernel 1 also its
    exponentials, for kernels 1 and 2 with dropout also the keep mask's
    integer instructions from their SASS), its plain version and SDPA
    with the same float mask or with ``dropout_p`` (yardsticks only:
    their masks differ); kernels 1-3 also without dropout;
34. train ERNIE-3.0-base (``bert_base(vocab_size=40000,
    max_position_embeddings=2048, type_vocab_size=4)``, dropout 0.1) at
    batch 8 x seq 2,048 with bf16 AMP and AdamW 1e-4, 307 masked
    positions a sequence, no padding mask: ms/step, tokens/s, MFU, peak
    memory; kernels 1-3 launch 12 times a step each, all with dropout;
    one step with the kernels against one with their plain versions from
    the same weights and generator state (the same masks), bf16 AMP and
    f32: the loss and each attention parameter's gradient within
    ``ERNIE_E2E``, which two planted faults (a different mask, a
    backward's mask unlike its forward's) must break; ``torch.profiler``
    over 2 steps: kernels 1-3's device ms a step and the idle share;
35. ``transformer_base(max_len=1024)`` (f32 weights from the seed)
    translating 8 sources of seeded lengths 512-1,024: the encoder memory
    with kernel 1's bias row against the plain versions, then
    ``greedy_translate`` and ``beam_translate`` (4 beams) of 32 tokens:
    ms per call and 6 launches of kernel 1 a call, each with the bias
    row;
36. the served 7B's serving tier (the reference gateway bench's
    workload, ``bench.py:2056-2133``, at phase 4's width): (a) kernel
    4 at S > 1 at a cold prefill (B 1, S
    2,048), a warm suffix (B 4, S 256 from position 1,536) and a verify
    block (B 8, S 5) within ``CARD_TOL`` of its plain version, bitwise on
    a rerun, the cold call's rows bitwise the warm call's where they
    overlap, timed queued beside its bound (4 D flops a valid pair and
    head at 989 TFLOP/s against the int8 K/V and scale bytes); (b) S = 1
    plans the kernel every S takes (the 7B decode's plan is its verify
    block's); then ``llama_7b(
    kv_cache_dtype="int8")`` with its decoder-layer weights damped by
    0.15 and a one-layer draft sharing its embeddings, head and first
    layer, 8 streams of a seeded 1,536-token system prompt and 17-384
    token tails, a cold and a warm wave of 32 greedy tokens through
    three arms (plain; prefix sharing; prefix + speculation, ``spec_k``
    4) and two prompts through ``generate()``: TTFT, decode ms/step,
    accept rate, the target's iteration speedup; (c) each arm's warm
    wave bitwise its cold one, every emitted token the argmax of its
    arm's own arithmetic (teacher-forced), the prefix arm and the prefix
    + speculation arm bitwise equal in every token of both waves and in
    every teacher-forced logit, the other pairs' logits within
    ``LOGIT_DIST_LIMIT`` wherever they computed from the same tokens (a
    stream's first difference is named with its top-2 margin), and every
    projection, norm (and an RMS norm's f32 mean of squares) and the head
    bitwise at each row count a server issues and at the first and last
    rows of a 2,048-row call, under the row floor; (d) kernel 4's
    launches by call (rows for prefix-server prefills and verify
    blocks, decode for decode and draft steps, no flash launch on the
    prefix arms); (e) wave 2 hits the prefix cache, every block free
    after ``flush_prefix_cache``; (f) a stream exported mid-decode and
    imported into a second server, and one resubmitted with
    ``replay_tokens``, token-identical to the plain arm; (g) a prefix +
    speculation server whose draft is the target itself accepts every
    proposal (accept rate exactly 1.0), gives the speculation arm's
    streams, and its draft's teacher-forced logits are the target's,
    bitwise (no position parts); (h) the gateway bench's own
    configuration (``bench.py:2101-2133``: hidden 1,024, 8 layers, 16
    heads, 8 kv heads, intermediate 2,816, vocab 32,000, int8 pools,
    decoder weights damped by 0.15, the bench's one-layer draft): 8
    streams of a 24-token system prompt and 8-token tails, two waves of
    64 tokens through the plain, prefix and gateway (prefix +
    speculation, ``spec_k`` 3) arms, the gateway arm's cold and warm
    streams the prefix arm's, a same-weights draft accepting 1.0, the
    accept rate and target-iteration speedup printed, and the GEMM row
    check at this width;
37. the served 7B (phase 36's damped model, int8 pools, prefix sharing)
    behind ``GatewayRouter`` over three ``LocalReplica``s sharing the
    model: phase 36's 8 streams and 8 under a second system prompt, even
    streams greedy, odd ones seeded sampling, against one fault-free
    server: (a) ``route_owner`` agrees with where each stream ran; (b) a
    replica killed mid-decode, every stream token-identical, at least one
    failover; (c) a surviving replica drained mid-traffic, at least one
    sequence migrated, every stream token-identical; (d) the tenant
    budget and the deadline-ordered shed raise ``ServerOverloaded``; (e)
    a ``GenerationRpcServer`` on loopback through a ``RemoteReplica``,
    token-identical; (f) ``python -m paddle_tpu_torch.tools.chaos_gateway
    --config bench`` (subprocess replicas on the card, one SIGKILLed by
    its chaos plan, then a drain) exits 0.  TTFT median and max, failover
    ms and kernel 4's launches by call are logged.
38. the geo-replicated online loop at full width (the reference bench's
    ``_bench_online`` geo half and ``tests/test_online_loop.py:291``):
    site a in this process (a primary with ``geo_site="a"``, its hot
    standby, a read replica), site b as ``python -m
    paddle_tpu_torch.tools.ps_site`` subprocesses (a primary and a
    standby started through ``fleet.init`` -> ``fleet.init_server()`` ->
    ``fleet.run_server()`` from a ``PaddleCloudRoleMaker`` environment,
    and a read replica of their group), each site a ``SparseTable(16,
    sgd, lr=0.05)``, a ``FeatureLifecycle`` sweeper and a
    ``FreshnessWatch``; site a's ``StreamingTrainer(device_merge=True)``
    streams phase 13's 22 batches and site b's (its client from
    ``fleet.init_worker()``) 22 batches of the same generator under seed
    1, both at once on the card with phase 13's tower, a ``GeoPusher``
    each way (additive): (a) 44 launches of ``segment_sum_sorted`` and no
    plain call; (b) after both pushers drain (each drain bounded by 60 s)
    the two primaries' values bitwise equal and every replica bitwise its
    primary (values, optimizer state, version); (c) the chaos acceptance:
    site a's primary a subprocess SIGKILLed before batch 8, one pusher
    (a -> b, as in the reference) riding its standby under the
    reference's seeded lossy, delayed and cut plan (site b's primary
    drops replies under the same plan), the
    sign of the tower's gradients pushed (integers): both sites bitwise a
    numpy replay of every acknowledged push on the initial rows (0 lost,
    0 double-applied rows), 22 batches applied once, no bounded read
    failed, site b deduplicating at least one retried frame; (d) the same
    sites under ``geo_policy="lww"``: every id holds, at both sites, the
    row of its greatest ``(lamport seq, site)`` stamp, bitwise, and each
    replica its primary's state; (e) ``ps_freshness_ms`` p50 / p99 at
    each site's replicas, events/s of each site, every ``FreshnessWatch``
    objective ok once the sites are quiet, and the host ms of pull, dense
    step, merge and push as phase 23 prints them;
39. the tiered table at ``_bench_ps_scale``'s configuration
    (``bench.py:1109-1262``): ``SparseTable(64, sgd, lr=0.1, init_std=
    0.05, seed=11)`` with spill on, ``clamp(2.2 RSS / 268, 1.5 M, 6 M)``
    rows built by admission and demotion in chunks of 100,000,
    ``recover_spill`` into a fresh table (probe rows bitwise), 2 x 300
    paired zc / row pulls of 2,048 Zipf(1.3) ids over 50,000 hot ids
    with 10 % cold (p50 / p99, pulls/s on each wire, the q8 wire's egress
    reduction); then a ``DeviceCachedTable(RemoteTable(client, "emb",
    64), capacity=50_000, wire="q8")`` on the card serves the same 600
    batches: one ``pull_dequant`` launch for every miss fill, no plain
    call, every batch's rows bitwise the numpy dequant of the table's q8
    pull and a ``kernel_mode="torch_ref"`` cache's; fails if the RSS
    growth over the build reaches the spill bytes; the spill directory
    (``tempfile.mkdtemp``) is removed whether the phase passes or fails.

40. the long-context proxy (the reference bench's ``_bench_llama_long``
    and ``_bench_llama_8k``, ``bench.py:517-587``): ``proxy_config`` at
    seq 4,096, batch 2 and seq 8,192, batch 1 (remat, AdamW 1e-4, bf16
    AMP, seed weights): kernels 1-3 at the proxy's attention there (B,
    16, S, 128) against their blockwise plain versions within
    ``CARD_TOL`` / ``CARD_TOL_BWD``, reruns bitwise, timed queued beside
    their bounds, plain versions and SDPA; then at each length a flash
    arm and a chunked arm (flash turned off as the bench turns it off:
    ``flash_eligible`` patched on the Llama module and restored) from the
    same weights, ``LONG_STEPS`` steps each: 16 / 8 / 8 launches of
    kernels 1 / 2 / 3 a step on the flash arm and none on the chunked
    arm, the first-step losses within ``LONG_FIRST_LOSS_TOL``, ms/step
    (median after the first), tokens/s, MFU (``_llama_analytic``), peak
    memory and ``flash_speedup_vs_chunked``;
41. the chunked LM loss: the proxy at seq 4,096, batch 4 (f32 logits of
    2.10 GB, over the 1.5 GiB threshold): the train step's loss and
    gradients with the chunked loss and, the threshold raised for that
    run only, with the plain loss: the loss within ``CHUNKED_LOSS_REL``,
    the global gradient within ``CHUNKED_GRAD_REL``, the chunked run's
    peak memory lower;
42. the guard on the proxy at 2,048 x 4 (``bench.py:158-210``,
    ``_guard_ab``): the clean-path A/B of ``guard_health`` +
    ``TrainGuard(min_history=10**9)`` against the plain step (median of
    3 runs of ``GUARD_STEPS`` steps; the overhead against the reference's
    < 1 % target, read and not gated; one host fetch a guarded step, 0
    skips); an eager ``TrainGuard.step`` loop under the chaos plan
    ``nan:grad:step=3`` (that step skipped, the parameters and AdamW
    state bitwise unchanged across it); a k = 2 gradient merge with the
    health vector folding over the window; ``LinearWarmup(
    CosineAnnealingDecay)`` with ``ClipGradByGlobalNorm(1.0)`` (the lr
    applied is the schedule's, the clipped norm at most 1);
43. BERT-base at ``_bench_bert``'s configuration (``bench.py:366-418``)
    in float16: the train step with ``amp_configs={"dtype": "float16"}``
    and the eager ``auto_cast(dtype="float16")`` + ``GradScaler`` loop,
    ``FP16_STEPS`` steps each, their losses within ``E2E_AMP_LOSS_REL``
    of the f32 step's, the scale histories; a planted ``inf:grad`` on two
    steps in a row skips both (bitwise) and halves the scale after the
    second; no kernel launch;
44. collectives on the card: (a) this process joins a world of one rank
    over NCCL (``init_parallel_env(backend="nccl")``; phases 45 and 47
    (a) run in it), (b) two rank processes on the one card over gloo
    (``spawn``, their CUDA tensors staged through host memory): every
    collective of the collective API and of the named-axis collectives,
    ``shard_map`` included, exact on integer-valued floats with its
    results on the card; (c) two ranks on the one card over NCCL, whose
    refusal is recorded (if NCCL accepts them, (b) runs over NCCL too);
45. the proxy of phase 7 under ``strategy.sharding`` at world 1 over
    NCCL: the plain step and stages 1, 2 and 3 with f32 slots,
    ``ZERO_STAGE_STEPS`` steps each, bitwise phase 7's losses and each
    other's parameters; stage 1 with bf16 slots, int8 slots and
    offloaded f32 slots, ``ZERO_ARM_STEPS`` steps each: losses within
    ``ZERO_LOSS_LIMIT`` of phase 7's (offload: bitwise), the slot bytes
    on the card as planned (offload: none, every slot pinned), the peak
    below the f32 arm's by at least half the bytes saved, ms/step;
    launches 16 / 8 / 8 a step;
46. the proxy at world 2 on the one card over gloo (two rank processes,
    batch 2 each of phase 7's batch 4): dp 2, and fsdp 2 at stage 3 with
    int8 slots, ``ZERO_W2_STEPS`` steps each: the ranks' parameters
    bitwise equal after every step, the losses within ``ZERO_W2_LIMIT``
    of the world-1 runs (phase 7; phase 45's int8 arm), each rank holding
    ``sharded_numel`` of every parameter and slot; ms/step (host-staged,
    no target); launches 16 / 8 / 8 a step a rank;
47. DGC on ResNet-50 at the bench's configuration (``DGC_CFG``): (a)
    world 1 over NCCL, ``DGC_STEPS`` steps: the warm-up steps bitwise
    phase 24's, then every tensor sends exactly max(1, round(n * 0.001))
    entries with u and v zero where it sent, finite losses,
    ``guard_health`` refused; (b) world 2 over gloo, batch 128 a rank,
    ``DGC_W2_STEPS`` steps: the ranks' parameters, losses and buffers
    bitwise equal, the losses within ``DGC_W2_LIMIT`` of (a)'s; no kernel
    launch;
48. the proxy of phase 7 at tp 2 (two rank processes on the one card over
    gloo, each holding its blocks of every projection, the embedding and
    the head), ``MP_STEPS`` steps: the losses within ``TP_W2_LIMIT`` of
    phase 7's, the blocks two ranks share (the norms) bitwise equal after
    every step, each rank holding ``sharded_numel`` of every parameter
    and slot, launches 16 / 8 / 8 a step a rank (kernels 1-3 at B 4, H 8),
    ms/step (host-staged, no target); this and every arm of 49-51 also
    holds the norm of its first reduced gradient (``guard_health``)
    within ``MP_GRAD_NORM_LIMIT`` of phase 7's at the same weights and
    batch, so that a stray factor of tp, sp or pp in the gradients, which
    AdamW's steps hide, fails on the card;
49. the proxy at sp 2, ring and Ulysses attention (``context_parallel``),
    ``MP_STEPS`` steps each: the losses within ``SP_W2_LIMIT``, the ranks'
    parameters bitwise equal, no launch of kernels 1-3 (the context-
    parallel attention is plain PyTorch, as the reference's), ms/step;
50. the proxy at pp 2 (GPipe, 4 microbatches), ``MP_STEPS`` steps: the
    losses within ``PP_W2_LIMIT``, each stage holding 4 layers, launches a
    step a rank as the schedule predicts (4 ticks x 4 layers: 32 / 16 /
    16, B 1); then ``pipeline_train_1f1b`` on each stage's bf16 layers and
    the embedded batch against GPipe within ``PP_1F1B_LIMIT``;
51. world 4 (four rank processes on the one card): tp 2 x pp 2 (4
    microbatches) and ZeRO-3 over fsdp 2 x pp 2 (2 microbatches of a
    rank's 2 rows), ``MP_W4_STEPS`` steps each: the losses within
    ``W4_LIMIT``, the shared blocks bitwise, ``sharded_numel`` held, the
    AdamW slot bytes a rank equal to the plan, peak memory a rank,
    ms/step.

Every rank process's waits are bounded (``COLL_TIMEOUT`` a rendezvous
or collective, ``RANKS_TIMEOUT`` a phase's ranks); a hung or failed rank
fails its phase with every rank's log tail.

Every profiled phase (6, 9, 12, 16, 19, 23, 28, 32, 34) prints the idle share
``1 - busy / wall`` unclamped and fails when busy exceeds wall.

Phase 3 also holds ``int8_matmul`` against its plain version at every
GEMM shape the int8 ResNet-50 sends at batch 1 and at batch 32 (recorded
from the model by ``recorded_int8_shapes``: 21 shapes each, 54 launches a
forward) with the model's bf16 output (the stem also with f32 output):
dynamic mode bitwise and bitwise on a rerun; each is timed queued beside
its bound, its plain version and ``torch._int_mm`` plus its scale pass,
which compute the same function and which the port never calls, with
the launch-weighted sums a forward; the kernel's launch plan
(``int8_mm_plan``) is printed beside each shape.  The same holds at the
int8 BERT-base's pooler (M = 1, 8, 32, 128; K = N = 768; bf16 output).  Weight-only mode runs
at the weight-only model's classifier (M = 1, 32 and 128, K = 2,048, N =
1,000), at BERT-base's FFN at batch 128 x 128 (16,384 x 768 x 3,072) and
at split edges (K not a multiple of the split, M past a block's rows),
in bf16 and f32: within ``CARD_TOL`` of the plain version and bitwise
equal to itself on a rerun, the first two timed queued beside the bound,
the plain version and ``torch._weight_int8pack_mm`` (or a logged line
where the card's torch has no CUDA kernel for it), with its plan
(``int8_wonly_plan``).  It holds
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

The 7B serving model is freed before phase 7, the training model
before phase 10, the ResNet-50 training model before phase 29 and the
BERT training model before phase 31, and the peak-memory counter reset,
so each workload reports its own peak.  Before the last line it prints one JSON object
``{"kernels": [...]}`` (launches summed over the serving run of phase 4,
the training run of phase 7, the ResNet run of phase 10, the wide&deep
run (b) of phase 13, the q8 serving run of phase 15, the elastic runs
of phases 17 and 18, the online run of phase 20, the ResNet training
of phase 24, the A/B of phase 27, the BERT training of phase 29, the
BERT serving run of phase 31, the ERNIE training of phase 34, the
translation calls of phase 35, the three serving arms of phase 36,
the gateway waves of phase 37, the two sites' streams of phase 38 (a),
the q8 cache's run of phase 39, the flash arms of phase 40, the two runs
of phase 41, the A/B of phase 42, the arms of phase 45, the ranks of
phase 46 and the ranks' steps of phases 48-51;
kernels 1-3 also carry their launches by mode, ``bias`` or ``dropout``,
of phases 34 and 35, and their options' phase-33 numbers; kernel 4 its
phase-36 and phase-37 launches by call, ``decode`` (S = 1) or ``rows``
(S > 1), and its phase-36 (a) numbers at S > 1; kernels 1-3 also their
phase-40 numbers at S = 4,096 and 8,192 and their phase-3 numbers at
the shapes phases 48-51 give them: a tp-2 rank's heads, ``tp_rank``
(B 4, H 8), a pp-2 microbatch, ``pp_microbatch`` (B 1, H 16), and a
tp-2 x pp-2 one, ``tp_pp_microbatch`` (B 1, H 8)); the last line is
``{"ok": true,
"device": {...}}``.
Exits non-zero, printing no result, without a CUDA device or without
the package.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import gc
import json
import math
import os
import pathlib
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

SEED = 1234
# H100 SXM peaks (NVIDIA data sheet, dense): bf16 and TF32 tensor
# cores, f32 outside the tensor cores, HBM3 bandwidth
PEAK_BF16_FLOPS = 989e12
PEAK_INT8_OPS = 1979e12
PEAK_TF32_FLOPS = 495e12
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
# the reference bench's BERT pretraining (bench.py:366-418, non-smoke):
# bert_base, batch 128, seq 128, int(128 * 0.15) = 19 masked positions a
# sequence, AdamW(1e-4), bf16 AMP, 20 steps (timed over steps 3-20)
BERT_TRAIN = dict(batch=128, seq=128, steps=20, lr=1e-4)
# the first loss: ln(vocab) + ln(2) (MLM and NSP at chance) within this
# distance (the initial logits' spread adds ~0.15)
BERT_FIRST_LOSS_TOL = 0.5
# phase 30: the bf16-AMP step against f32 at this batch, dropout off
BERT_F32_BATCH = 16
# phase 30's dropout check: elements, probability, keep-rate tolerance
BERT_DROPOUT = dict(numel=1 << 24, p=0.1, rate_tol=1e-3)
# the reference inference bench's BERT arm (bench.py:1684-1714): batches
# 1, 8, 32, 128 of seq 128; one int8_matmul (the pooler) a forward
BERT_INFER_BATCHES = (1, 8, 32, 128)
BERT_INFER_SEQ = 128


# the card's name and power limit, as nvidia-smi reports them (phase 1)
_CARD = ["not read"]
# the losses of phase 7's proxy run and phase 24's ResNet-50 run, which
# phases 45-47 hold their world-1 steps to
_LOSSES = {}
# the norm of phase 7's first gradient (world 1, its seed weights and
# batch), which phases 48-51 hold their first reduced gradient's to
_GRAD_NORM = {}


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
# step's optimizer update, BERT's layer norm, dropout, attention, GELU,
# MLM decode and loss); the profiler also lists their device-side spans,
# which cover kernels and must not be counted as kernels
ANNOTATIONS = ("batch_norm", "optimizer", "layer_norm", "dropout",
               "attention", "gelu", "mlm_decode", "loss")


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
    (the Hopper route's ``flash_bwd_sm90<true, D, drop>`` / ``<false,
    ...>``, the first kernels' ``flash_bwd_dkv_*`` / ``flash_bwd_dq_*``);
    returns {"dkv": ms, "dq": ms}."""
    out = {}
    for short, which, keys in (
            ("dkv", "kernel 2 (dK/dV)", ("flash_bwd_sm90<true",
                                         "flash_bwd_dkv")),
            ("dq", "kernel 3 (dQ)", ("flash_bwd_sm90<false",
                                     "flash_bwd_dq"))):
        mine = [e for e in kern if any(k in e.key for k in keys)]
        ms = sum(e.self_device_time_total for e in mine) / 1e3 / steps
        n = sum(e.count for e in mine) / steps
        out[short] = ms
        names = {re.search(r"flash_\w+(<[^>]*>)?", e.key).group(0)
                 for e in mine}
        log(f"{label}: {which} {ms:.3f} device ms/step over {n:g} "
            f"launches/step " + ", ".join(sorted(names)))
    return out


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
        f"kernel's {FLASH_MMA_SYNC_SDPA_RATIO.get(label, 'not measured')}); "
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


def kv_case(dev, B, S, H, KH, D, bs, M, dt, trash_rows=0, full=True,
            last=None):
    """Int8 pools, scales, a table of distinct random blocks and queries;
    the sequences' last query positions are ``last`` where given, else the
    table's end (``full``) or random."""
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
    if last is not None:
        last = torch.tensor(last, device=dev) - (S - 1)
    elif full:
        last = torch.full((B,), T - S, device=dev)
    else:
        last = torch.randint(0, T - S + 1, (B,), device=dev, generator=g)
    pos = (last[:, None] + torch.arange(S, device=dev)[None]).to(torch.int32)
    if trash_rows:
        tbl[-trash_rows:] = 0
        pos[-trash_rows:] = 0
    qh = torch.randn(B, S, H, D, device=dev, dtype=dt, generator=g)
    return qh, kpool, vpool, ks, vs, tbl, pos, KH


def kv_bound(args):
    """Kernel 4's least time for one call on these inputs: the bytes of
    each valid token's int8 K and V rows (every kv head) and its two f32
    scales, the live table entries and the positions read, q read and the
    output written once, over the HBM rate; against its 4 D flops a valid
    token and query row at the bf16 tensor-core rate (the products run on
    the tensor cores)."""
    qh, kpool, _, _, _, tbl, pos, KH = args
    B, S, H, D = qh.shape
    bs = kpool.shape[1]
    last = pos.max(dim=1).values.clamp(min=0) + 1
    valid = int(last.sum().item())                           # tokens
    blocks = int(torch.clamp((last + bs - 1) // bs, max=tbl.shape[1])
                 .sum().item())
    nbytes = (valid * KH * D * 2 + valid * 4 * 2 + blocks * 4
              + pos.numel() * 4 + 2 * qh.numel() * qh.element_size())
    return bound_ms(4 * D * H * S * valid, PEAK_BF16_FLOPS, nbytes)


# phase 6's decode batch: the serve phase's prompt lengths + 16 new
# tokens, in a 128-block table of 16-slot blocks
SERVING_MIX_LENS = (1900, 1500, 1024, 700, 333, 128, 64, 17)


def kv_cases(dev):
    """Phase 3 for kernel 4: six cases within CARD_TOL of the plain
    version and bitwise equal on a rerun; a sequence alone at batch 1
    through a narrower table bitwise equal to its row in the serving mix;
    the 7B decode, the serving mix and batch 1 at 2,048 tokens checked
    against the plain version and timed queued beside their bounds."""
    from paddle_tpu_torch.ops.kernels import kv_attention as kva
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
        again = int8_paged_attention(*args)
        ref = int8_paged_attention(*args, mode="torch_ref")
        torch.cuda.synchronize()
        dname = str(dt).replace("torch.", "")
        shape = (f"B={B} S={S} H={H} KH={KH} D={D} bs={bs} T={M * bs} "
                 f"{dname} trash_rows={trash}")
        err, share = check_close(f"int8_kv_attention {shape}", got, ref,
                                 CARD_TOL[dt])
        if not torch.equal(got, again):
            fail(f"int8_kv_attention {shape}: a rerun is not bitwise equal")
        log(f"int8_kv_attention {shape}: max_err {err:.3g}, {share:.3g} of "
            f"its limit, bitwise equal on a rerun; median |o| "
            f"{ref.float().abs().median().item():.3g}")
        if i == 0:
            row = dict(max_abs_err=err)
    bf = torch.bfloat16
    mix = [n + 16 for n in SERVING_MIX_LENS]
    shapes = {
        "7B decode (B 8, T 2048)": kv_case(dev, 8, 1, 32, 32, 128, 16, 128,
                                           bf, full=True),
        "serving mix (phase 6's lengths)": kv_case(
            dev, 8, 1, 32, 32, 128, 16, 128, bf, last=mix),
        "batch 1 (T 2048)": kv_case(dev, 1, 1, 32, 32, 128, 16, 128, bf,
                                    full=True),
    }
    # batch invariance: a sequence alone through a table just wide enough
    args = shapes["serving mix (phase 6's lengths)"]
    qh, kp, vp, ks, vs, tbl, pos, KH = args
    full = int8_paged_attention(*args)
    for i in (0, 4, 7):
        m = mix[i] // 16 + 2
        alone = int8_paged_attention(qh[i:i + 1].clone(), kp, vp, ks, vs,
                                     tbl[i:i + 1, :m].clone(),
                                     pos[i:i + 1].clone(), KH)
        torch.cuda.synchronize()
        if not torch.equal(alone[0], full[i]):
            fail(f"int8_kv_attention: sequence {i} ({mix[i]} tokens) alone "
                 f"at batch 1 through {m} table blocks is not bitwise its "
                 "row in the batch of 8")
    log("int8_kv_attention: sequences 0, 4 and 7 of the serving mix alone "
        "at batch 1 (narrower tables) bitwise equal to their rows in the "
        "batch of 8")
    for label, args in shapes.items():
        ref = int8_paged_attention(*args, mode="torch_ref")
        bms, by = kv_bound(args)
        check_close(f"int8_kv_attention {label}", int8_paged_attention(*args),
                    ref, CARD_TOL[bf])
        ms = queued_ms(lambda: int8_paged_attention(*args))
        plain = queued_ms(lambda: int8_paged_attention(*args,
                                                       mode="torch_ref"))
        events = cuda_ms(lambda: int8_paged_attention(*args))
        plan = kva.int8_kv_plan(*args[0].shape[:3], args[7], args[0].shape[3],
                                args[1].shape[1], args[5].shape[1])
        log(f"int8_kv_attention {label}: kernel_ms {ms:.4f} (events "
            f"around one call {events:.4f}) plain_ms {plain:.4f} bound_ms "
            f"{bms:.4f} ({by}; kernel / bound {ms / bms:.2f}) library_ms "
            f"n/a (no single PyTorch call); plan {plan.q_tile} rows a "
            f"block, {plan.chunks_a_block} of {plan.chunks} chunks a block, "
            f"grid {plan.grid}, {plan.stages} stages, {plan.smem_bytes} B")
        if label.startswith("7B"):
            row.update(ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by,
                       library_ms=None)
    return row


def _int_mm_library(x, w_nk, scale, cdt):
    """``torch._int_mm`` (cuBLASLt's int8 GEMM) and the same scale pass:
    the yardstick, never called by the port.  It takes M > 16 and K a
    multiple of 8: the operands are zero-padded to it here, once, outside
    what is timed."""
    k = x.shape[1]
    if k % 8:
        pad = 8 - k % 8
        x = torch.nn.functional.pad(x, (0, pad))
        w_nk = torch.nn.functional.pad(w_nk, (0, pad))
    x, wt = x.contiguous(), w_nk.contiguous().t()
    return lambda: (torch._int_mm(x, wt).float() * scale).to(cdt)


def _weight_only_library(x, w_nk, w_scale, cdt, ref, shape):
    """``torch._weight_int8pack_mm(x, w, scale)``: x @ (w * scale)^T with
    the scale in the compute dtype, the reference's weight-only expression
    (``int8_matmul_ref``); the yardstick, never called by the port.  Its
    queued ms, or None (logged) where the card's torch has no CUDA
    implementation of it."""
    w, s = w_nk.contiguous(), w_scale.to(cdt)

    def lib_fn():
        return torch._weight_int8pack_mm(x, w, s)

    try:
        out = lib_fn()
        torch.cuda.synchronize()
    except (NotImplementedError, RuntimeError) as e:
        log(f"int8_matmul {shape}: torch._weight_int8pack_mm does not run "
            f"on this card's torch: {str(e).splitlines()[0][:160]}")
        return None
    d = (out.float() - ref.float()).abs().max().item()
    log(f"int8_matmul {shape}: torch._weight_int8pack_mm max |diff| from "
        f"the plain version {d:.3g} (it rounds differently; timed only)")
    return queued_ms(lib_fn)


@contextlib.contextmanager
def recorded_int8_shapes():
    """Count the int8 layers' ``int8_matmul`` calls made inside the block:
    yields a ``Counter`` of ``(M, K, N, compute dtype, dynamic)`` (M the
    rows after leading dims are collapsed), filled as the calls come.
    The layers call the name ``paddle_tpu_torch.quantization.int8_matmul``,
    which is wrapped for the block's length."""
    import paddle_tpu_torch.quantization as q
    from paddle_tpu_torch.framework.dtype import to_torch
    inner = q.int8_matmul
    counts = collections.Counter()

    def record(x, w_nk, w_scale, x_scale=None, compute_dtype=None, **kw):
        cdt = (torch.bfloat16 if compute_dtype is None
               else to_torch(compute_dtype))
        counts[(math.prod(x.shape[:-1]), x.shape[-1], w_nk.shape[0], cdt,
                x_scale is not None)] += 1
        return inner(x, w_nk, w_scale, x_scale, compute_dtype, **kw)

    q.int8_matmul = record
    try:
        yield counts
    finally:
        q.int8_matmul = inner


def resnet_int8_gemms(dev):
    """Every distinct ``(M, K, N, compute dtype, dynamic)`` that one
    forward of phase 10's int8 ResNet-50 (224x224) sends to
    ``int8_matmul`` at batch 1 and at batch 32, with its calls a forward:
    recorded from the model (``recorded_int8_shapes``), nothing typed
    here."""
    from paddle_tpu_torch.quantization import convert_to_int8_inference
    from paddle_tpu_torch.vision.models import resnet50
    model = _cast_bf16(convert_to_int8_inference(resnet50(
        num_classes=1000, device=dev,
        generator=torch.Generator(device=dev).manual_seed(SEED))))
    shapes = {}
    with torch.no_grad():
        for b in (1, 32):
            with recorded_int8_shapes() as got:
                model(_images(dev, b))
            if sum(got.values()) != RESNET_GEMMS:
                fail(f"int8 resnet50 batch {b}: {sum(got.values())} "
                     f"int8_matmul calls a forward, want {RESNET_GEMMS}")
            shapes[b] = got
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return shapes


# the int8 GEMMs' device ms a batch-32 int8 ResNet-50 forward (phase 12)
# in the first (mma.sync) kernel of int8_matmul (PERF.md section 6)
INT8_MMA_SYNC_GEMM_MS = 2.05


def _int8_case(dev, g, label, M, K, N, cdt, dyn, timed=True):
    """One ``int8_matmul`` shape on the card: dynamic mode bitwise equal
    to the plain version, weight-only within ``CARD_TOL``, both bitwise
    equal to themselves on a rerun; the kernel, the plain version and
    (dynamic, M > 16) ``torch._int_mm`` + scale or (weight-only)
    ``torch._weight_int8pack_mm`` timed queued.  Returns the numbers (None
    untimed)."""
    from paddle_tpu_torch.ops.kernels import int8_matmul as im
    from paddle_tpu_torch.ops.kernels.flash_attention import _sm_count
    # in the rows the int8 layers keep (weight_rows(): a 16-byte pitch,
    # zero past K), made once and not on every call
    w = im.kernel_rows(torch.randint(-127, 128, (N, K), device=dev,
                                     dtype=torch.int8, generator=g))
    ws = torch.rand(N, device=dev, generator=g) * 1e-2 + 1e-4
    if dyn:
        # in rows of a 16-byte pitch, as the int8 convolutions gather them
        x = im.aligned_rows(M, K, dev)
        x.copy_(torch.randint(-127, 128, (M, K), device=dev,
                              dtype=torch.int8, generator=g))
        xs = torch.tensor(0.0123, device=dev)
    else:
        x = torch.randn(M, K, device=dev, dtype=cdt, generator=g)
        xs = None

    def run(mode=None):
        return im.int8_matmul(x, w, ws, x_scale=xs, compute_dtype=cdt,
                              mode=mode)

    got, again, ref = run(), run(), run("torch_ref")
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
        if not torch.equal(again, got):
            fail(f"int8_matmul {shape}: a rerun is not bitwise equal")
        err, verdict = 0.0, "bitwise equal to the plain version and on a rerun"
        plan = im.int8_mm_plan(M, N, K, _sm_count(x.device),
                               got.element_size())
        verdict += (f"; plan {plan.block_m}x{plan.block_n} tiles, grid "
                    f"{plan.grid}, {plan.stages} stages, "
                    + ("TMA" if plan.tma_store else "plain") + " stores")
    else:
        err, share = check_close(f"int8_matmul {shape}", got, ref,
                                 im.CARD_TOL[cdt])
        if not torch.equal(again, got):
            fail(f"int8_matmul {shape} weight-only: a rerun is not bitwise "
                 "equal (the partials must merge in split order)")
        plan = im.int8_wonly_plan(M, N, K, cdt, _sm_count(x.device))
        verdict = (f"max_err {err:.3g}, {share:.3g} of its limit, bitwise "
                   f"on a rerun; plan {plan.route} {plan.block_m} rows of "
                   f"x x 64, {plan.tiles_n * plan.tiles_m} tiles x "
                   f"{plan.splits} splits of {plan.chunks_a_split} chunks, "
                   f"grid {plan.grid}")
    if not timed:
        log(f"int8_matmul {shape} weight-only: {verdict}")
        return None
    ms = queued_ms(run)
    plain = queued_ms(lambda: run("torch_ref"))
    out_b = M * N * got.element_size()
    nbytes = M * K * x.element_size() + N * K + 4 * N + out_b
    bms, by = bound_ms(2.0 * M * N * K,
                       PEAK_INT8_OPS if dyn else PEAK_BF16_FLOPS
                       if cdt == torch.bfloat16 else PEAK_F32_FLOPS,
                       nbytes)
    lib = None
    if dyn and M > 16:
        lib_fn = _int_mm_library(x, w, (xs * ws).contiguous(), cdt)
        if not torch.equal(lib_fn(), ref):
            fail(f"int8_matmul {shape}: torch._int_mm's product differs "
                 "from the plain version")
        lib = queued_ms(lib_fn)
    elif not dyn:
        lib = _weight_only_library(x, w, ws, cdt, ref, shape)
    log(f"int8_matmul {shape} {'dynamic' if dyn else 'weight-only'}: "
        f"{verdict}; kernel_ms {ms:.4f} plain_ms {plain:.4f} bound_ms "
        f"{bms:.4f} ({by}) library_ms("
        + ("_int_mm + scale" if dyn else "_weight_int8pack_mm") + ") "
        + ("n/a" if lib is None else
           f"{lib:.4f} (kernel / library {ms / lib:.3f})"))
    return dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bms,
                bound_by=by, library_ms=lib)


def int8_cases(dev):
    """``int8_matmul`` at every GEMM an int8 ResNet-50 forward sends at
    batch 1 and at batch 32 (``resnet_int8_gemms``), with each shape's
    calls a forward and the launch-weighted sums a forward of the
    kernel's, the library's and the bound's times; the stem also with f32
    output (as the reference's convolution calls its kernel), the int8
    BERT-base's pooler (M = 1, 8, 32, 128; K = N = 768; bf16) and
    weight-only mode at the classifier's shape."""
    g = torch.Generator(device=dev).manual_seed(SEED + 4)
    row = None
    for b, shapes in resnet_int8_gemms(dev).items():
        kern = bound = lib = kern_lib = 0.0
        no_lib = 0
        # the largest products first
        for (M, K, N, cdt, dyn), calls in sorted(
                shapes.items(), key=lambda kv: -kv[0][0] * kv[0][1]
                * kv[0][2]):
            r = _int8_case(dev, g, f"resnet50 b{b} ({calls} a forward)",
                           M, K, N, cdt, dyn)
            kern += calls * r["ms"]
            bound += calls * r["bound_ms"]
            if r["library_ms"] is None:
                no_lib += calls
            else:
                lib += calls * r["library_ms"]
                kern_lib += calls * r["ms"]
            if b == 32 and K == 147:
                row = r
        log(f"int8_matmul resnet50 batch {b}, a forward ({RESNET_GEMMS} "
            f"launches, {len(shapes)} shapes): kernel {kern:.4f} ms, bound "
            f"{bound:.4f} ms (kernel / bound {kern / bound:.2f}); "
            f"_int_mm + scale {lib:.4f} ms over the {RESNET_GEMMS - no_lib} "
            f"launches where it runs (M > 16), the kernel {kern_lib:.4f} "
            f"on those (kernel / library {kern_lib / lib:.3f})")
    _int8_case(dev, g, "conv1 7x7/2 b32", 401408, 147, 64, torch.float32,
               True)
    # the int8 BERT-base's one int8_matmul a forward: the pooler (phase 31)
    for M in BERT_INFER_BATCHES:
        _int8_case(dev, g, f"BERT-base pooler b{M} (1 a forward)", M, 768,
                   768, torch.bfloat16, True)
    for cdt in (torch.bfloat16, torch.float32):
        for M in RESNET_BATCHES:
            _int8_case(dev, g, f"weight-only fc b{M}", M, 2048, 1000, cdt,
                       False)
        _int8_case(dev, g, "weight-only BERT-base FFN b128 s128",
                   *WONLY_LARGE, cdt, False)
        for label, M, K, N in WONLY_EDGES:
            _int8_case(dev, g, f"weight-only {label}", M, K, N, cdt, False,
                       timed=False)
    return row


# weight-only int8_matmul beyond the classifier: BERT-base's FFN at batch
# 128 x 128 (M, K, N), which a weight-only BERT would send; and split
# edges (K not a multiple of the split, N not a multiple of 64, M past a
# block's rows, K below a chunk), checked and not timed
WONLY_LARGE = (16384, 768, 3072)
WONLY_EDGES = (("K 2,100 in 7 splits", 32, 2100, 1000),
               ("K 2,000, M 5", 5, 2000, 1000),
               ("M 129 past a block", 129, 2048, 1000),
               ("N 70, K 300", 33, 300, 70),
               ("K 17", 1, 17, 5))


def launch_floor(dev):
    """An empty kernel (``csrc/empty_kernel.cu``) queued behind the spin
    kernel as the port's kernels are: the least device time of a launch,
    at 1 block of 32 threads and at 128 blocks of 128 (the weight-only
    kernel's grid at the classifier).  Returns {grid: ms}."""
    import ctypes
    from paddle_tpu_torch.ops.kernels import _build
    lib = _build.load("empty_kernel.cu")
    lib.empty_launch.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.empty_launch.restype = ctypes.c_int
    stream = torch.cuda.current_stream(dev).cuda_stream
    res = {}
    for grid, threads in ((1, 32), (128, 128)):
        def run():
            _build.check(lib, lib.empty_launch(grid, threads, stream),
                         "empty_launch")
        res[grid] = queued_ms(run)
        log(f"empty kernel ({grid} x {threads} threads) queued: "
            f"{res[grid]:.4f} ms a launch: the fixed device cost of one "
            "launch")
    return res


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
    lens = SERVING_MIX_LENS
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
    lens = np.array(SERVING_MIX_LENS) + 16
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
    # the kernel's name in this tree (int8_kv_rows) or an older one's
    mine = [e for e in kern if "int8_kv_" in e.key]
    k4 = sum(e.self_device_time_total for e in mine) / 1e3 / steps
    n4 = sum(e.count for e in mine) / steps
    log(f"profile decode: kernel 4 (int8_kv_rows) {k4:.3f} device ms/step "
        f"over {n4:g} launches/step ({k4 / max(n4, 1):.4f} ms a launch), "
        f"{k4 / busy_ms:.3f} of the device busy time")
    for e in sorted(kern, key=lambda e: -e.self_device_time_total)[:12]:
        log(f"  {e.key[:70]:70s} {e.self_device_time_total / 1e3 / steps:8.3f}"
            f" ms/step  x{e.count // steps}")
    check_busy("profile decode (phase 6)", busy_ms, wall_ms)
    return dict(wall_ms=wall_ms, busy_ms=busy_ms, kernel4_ms=k4,
                kernel4_launches=n4)


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


def _first_grad_norm(step, ids):
    """The 2-norm of the step's gradient at its present weights, without
    an update: ``guard_health``'s one-pass norm, the one phases 48-51
    read from their steps."""
    from paddle_tpu_torch.train_guard import fused_health
    _, grads = step.loss_and_grads(ids, ids)
    return float(fused_health(grads, precise=False)[0])


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
    _GRAD_NORM["train"] = _first_grad_norm(step, ids)
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
    _LOSSES["train"] = list(losses)
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
    """The bf16 ResNet-50, its int8 conversion and its weight-only int8
    conversion (``act_quant=None``), all from the same f32 weights drawn
    from the seed (the bench draws them from one seed)."""
    from paddle_tpu_torch.quantization import convert_to_int8_inference
    from paddle_tpu_torch.vision.models import resnet50

    def make():
        return resnet50(num_classes=1000, device=dev,
                        generator=torch.Generator(device=dev)
                        .manual_seed(SEED))

    return (_cast_bf16(make().eval()),
            _cast_bf16(convert_to_int8_inference(make())),
            _cast_bf16(convert_to_int8_inference(make(), act_quant=None)))


def _images(dev, b):
    g = torch.Generator(device=dev).manual_seed(SEED + 5 + b)
    return torch.randn(b, 3, 224, 224, device=dev, generator=g).to(
        torch.bfloat16)


def resnet_serve(dev, bf16_model, int8_model, wonly_model):
    """Phase 10: per-forward latency, images/s and peak memory of the
    three models at each batch; every int8 forward must launch the kernel
    exactly RESNET_GEMMS times in dynamic mode, every weight-only forward
    exactly once in weight-only mode."""
    from paddle_tpu_torch.ops.kernels import registry
    torch.backends.cudnn.benchmark = True     # the bf16 yardstick's best
    forwards = collections.Counter()

    def counted(name, model):
        def fwd(x):
            forwards[name] += 1
            return model(x)
        return fwd

    res = []
    registry.reset_counts()                  # the main path starts here
    with torch.no_grad():
        for b in RESNET_BATCHES:
            x = _images(dev, b)
            row = dict(batch=b)
            for name, fn in (("int8", counted("int8", int8_model)),
                             ("wonly", counted("wonly", wonly_model)),
                             ("bf16", bf16_model)):
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
            row["wonly_speedup"] = row["bf16_ms"] / row["wonly_ms"]
            res.append(row)
            log("resnet50 serve: " + json.dumps(row))
    counts = registry.launch_counts()        # ... and ends here
    by_mode = registry.spec("int8_matmul").mode_launches
    modes = {k: by_mode.get(k, 0) for k in ("dynamic", "weight_only")}
    want = dict.fromkeys(counts, 0)
    want["int8_matmul"] = RESNET_GEMMS * forwards["int8"] + forwards["wonly"]
    want_modes = {"dynamic": RESNET_GEMMS * forwards["int8"],
                  "weight_only": forwards["wonly"]}
    log(f"resnet50 serve: {forwards['int8']} int8 and {forwards['wonly']} "
        f"weight-only forwards, launches {counts} (want {want}), "
        f"int8_matmul by mode {modes} (want {want_modes})")
    if counts != want or modes != want_modes:
        fail(f"resnet50 serve: launches {counts} by mode {modes}, want "
             f"{want} by mode {want_modes}")
    torch.backends.cudnn.benchmark = False
    return counts, res


def resnet_end_to_end(dev, bf16_model, int8_model, wonly_model):
    """Phase 11: the int8 logits with the kernel and with its plain
    version must be bitwise equal, the weight-only logits within
    CARD_TOL[bf16] of the plain version's and bitwise on a rerun; top-1
    agreement with the bf16 model for information."""
    from paddle_tpu_torch.ops.kernels.registry import set_kernel_mode
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
    from paddle_tpu_torch.ops.kernels.int8_matmul import CARD_TOL
    # deterministic convolutions: a rerun then differs only where the
    # weight-only kernel would
    torch.backends.cudnn.deterministic = True
    try:
        with torch.no_grad():
            wk = wonly_model(x)
            again = wonly_model(x)
            set_kernel_mode(wonly_model, "torch_ref")
            try:
                wplain = wonly_model(x)
            finally:
                set_kernel_mode(wonly_model, None)
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.deterministic = False
    err, share = check_close("resnet50 weight-only end to end (batch 32)",
                             wk, wplain, CARD_TOL[torch.bfloat16])
    if not torch.equal(again, wk):
        fail("resnet50 weight-only end to end: a rerun's logits are not "
             "bitwise equal")
    wagree = (wk.argmax(-1) == ref.argmax(-1)).float().mean().item()
    log(f"resnet50 weight-only end to end (batch 32): logits with the "
        f"kernel within CARD_TOL[bf16] of the plain version's (max |diff| "
        f"{err:.4g}, {share:.3g} of the limit), bitwise on a rerun; top-1 "
        f"agreement with the bf16 model {wagree:.4f}")
    return dict(bitwise_equal=equal, top1_agreement=agree,
                rel_dist_to_bf16=dist, wonly_share_of_limit=share,
                wonly_top1_agreement=wagree)


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


def profile_resnet(dev, int8_model, wonly_model, forwards: int = 3):
    """Phase 12: torch.profiler over batch-32 int8 forwards, then over
    batch-32 weight-only forwards."""
    x = _images(dev, 32)
    with torch.no_grad():
        wall_ms, busy_ms, kern = profile_calls(lambda: int8_model(x),
                                               forwards)
    n_kern = sum(e.count for e in kern) // forwards
    log(f"profile resnet50 int8 batch 32: wall {wall_ms:.2f} ms/forward, "
        f"device busy {busy_ms:.2f} ms/forward, idle share "
        f"{1 - busy_ms / wall_ms:.4f}, {n_kern} kernels/forward")
    gemm = [e for e in kern if "int8_mm" in e.key]
    gemm_ms = sum(e.self_device_time_total for e in gemm) / 1e3 / forwards
    log(f"profile resnet50 int8 batch 32: the int8 GEMMs (int8_matmul) "
        f"{gemm_ms:.3f} device ms/forward in "
        f"{sum(e.count for e in gemm) // forwards} launches "
        f"({gemm_ms / busy_ms:.3f} of busy; the first mma.sync kernel's: "
        f"{INT8_MMA_SYNC_GEMM_MS})")
    check_busy("profile resnet50 (phase 12)", busy_ms, wall_ms)
    for e in sorted(kern, key=lambda e: -e.self_device_time_total)[:15]:
        log(f"  {e.key[:70]:70s} {e.self_device_time_total / 1e3 / forwards:8.3f}"
            f" ms/forward  x{e.count // forwards}")
    with torch.no_grad():
        wall_ms, busy_ms, kern = profile_calls(lambda: wonly_model(x),
                                               forwards)
    wk = [e for e in kern if "int8_wonly" in e.key]
    wk_ms = sum(e.self_device_time_total for e in wk) / 1e3 / forwards
    launches = sum(e.count for e in wk) // forwards
    log(f"profile resnet50 weight-only batch 32: wall {wall_ms:.2f} "
        f"ms/forward, device busy {busy_ms:.2f} ms/forward, idle share "
        f"{1 - busy_ms / wall_ms:.4f}, "
        f"{sum(e.count for e in kern) // forwards} kernels/forward; the "
        f"weight-only kernel (int8_wonly) {wk_ms:.4f} device ms/forward in "
        f"{launches} launch(es)")
    check_busy("profile resnet50 weight-only (phase 12)", busy_ms, wall_ms)
    if launches != 1:
        fail(f"profile resnet50 weight-only: {launches} int8_wonly launches "
             "a forward in the trace, want 1")
    for e in sorted(kern, key=lambda e: -e.self_device_time_total)[:8]:
        log(f"  {e.key[:70]:70s} {e.self_device_time_total / 1e3 / forwards:8.3f}"
            f" ms/forward  x{e.count // forwards}")


# ---------------------------------------------------------------------
# phase 3 (PS kernels) and phases 13-16: wide&deep through the PS path
# ---------------------------------------------------------------------

def _bucket(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length()


def wide_deep_data(extra_batches: int = 0, seed: int = 0):
    """The reference bench's wide&deep draws (``bench.py:662-714``, full
    size) with ``RandomState(seed)`` (the bench's 0) in its order: w1,
    w2, wide_w, the Zipf ids of every batch, then each batch's dense
    features and labels.  ``extra_batches`` more batches of the same
    distribution follow from the same generator (the serving phase's
    fresh traffic).  Returns (params as numpy [w1, b1, w2, wide_w],
    batches, extra batches)."""
    W = WIDE_DEEP
    rng = np.random.RandomState(seed)
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


def _time_parts(tr, cli, timers):
    """Phase 23's host timers on ``tr``'s merge and ``cli``'s push."""
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
    _time_parts(tr, cli, timers)
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


def _resnet_train_step(dev, amp=True, bf16_weights=False, dgc=None,
                       guard_health=False):
    """``resnet50(num_classes=1000)`` with f32 weights from the seed, and
    the bench's step over it: ``Momentum(0.1, 0.9)``, ``cross_entropy``,
    bf16 AMP unless ``amp`` is False.  ``bf16_weights`` rounds the f32
    weights to bf16 values first; ``dgc``: the strategy's dgc_configs
    (DGC on)."""
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
    if dgc is not None:
        strategy.dgc = True
        strategy.dgc_configs = dgc
    opt = pt.optimizer.Momentum(learning_rate=RESNET_TRAIN["lr"],
                                momentum=RESNET_TRAIN["momentum"],
                                parameters=list(model.parameters()))

    def loss_fn(img, label):
        return pt.nn.functional.cross_entropy(model(img), label).mean()

    return model, DistributedTrainStep(model, loss_fn, opt, strategy,
                                       guard_health=guard_health)


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
    _LOSSES["resnet"] = list(losses)
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
    """A device kernel's class in the training profiles (phases 28, 32)."""
    n = name.lower()
    if "dgrad" in n:
        return "conv dgrad"
    if "wgrad" in n:
        return "conv wgrad"
    if "fprop" in n or "conv" in n or "implicit" in n or "winograd" in n:
        return "conv fprop"
    if any(k in n for k in ("gemm", "cutlass", "nvjet", "xmma")):
        return "gemm"
    if "softmax" in n:
        return "softmax"
    if "reduce" in n:
        return "reductions"
    if "pool" in n:
        return "pooling"
    if "nchw" in n or "nhwc" in n or "transpose" in n:
        return "layout"
    if "flash_" in n:
        return "flash kernels"
    if "philox" in n or "distribution" in n:
        return "random"
    if "index" in n or "gather" in n or "scatter" in n or "embedding" in n:
        return "gather/scatter"
    if "copy" in n:
        return "copy/cast"
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


# ---------------------------------------------------------------------
# phases 29-32: BERT-base pretraining and inference
# ---------------------------------------------------------------------

def _bert_batch(dev, vocab, batch, seq):
    """The bench's pretraining batch (``bench.py:392-399``):
    ``RandomState(0)`` draws the ids, the sorted masked positions (19 a
    sequence at seq 128), the MLM labels and the NSP labels, in that
    order."""
    rng = np.random.RandomState(0)
    n_mask = max(1, int(seq * 0.15))
    ids = rng.randint(0, vocab, (batch, seq)).astype("int32")
    pos = np.sort(rng.randint(0, seq, (batch, n_mask)), axis=1).astype(
        "int32")
    mlm = rng.randint(0, vocab, (batch, n_mask)).astype("int64")
    nsp = rng.randint(0, 2, (batch,)).astype("int64")
    return tuple(torch.from_numpy(a).to(dev) for a in (ids, pos, mlm, nsp))


def _bert_train_step(dev, amp=True, bf16_weights=False, **cfg_kw):
    """``BertForPretraining(bert_base(**cfg_kw))`` with f32 weights from
    the seed (dropout masks from the seed + 1) and the bench's step over
    it: ``BertPretrainingCriterion``, ``AdamW(1e-4)``, bf16 AMP unless
    ``amp`` is False.  ``bf16_weights`` rounds the f32 weights to bf16
    values first."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.distributed.fleet import (DistributedStrategy,
                                                    DistributedTrainStep)
    from paddle_tpu_torch.text.models import (BertForPretraining,
                                              BertPretrainingCriterion,
                                              bert_base)
    cfg = bert_base(**cfg_kw)
    model = BertForPretraining(
        cfg, device=dev,
        generator=torch.Generator(device=dev).manual_seed(SEED),
        dropout_generator=torch.Generator(device=dev).manual_seed(SEED + 1))
    if bf16_weights:
        with torch.no_grad():
            for p in model.parameters():
                p.copy_(p.to(torch.bfloat16))
    strategy = DistributedStrategy()
    if amp:
        strategy.amp = True
        strategy.amp_configs = {"dtype": "bfloat16"}
    crit = BertPretrainingCriterion(cfg.vocab_size)
    opt = pt.optimizer.AdamW(learning_rate=BERT_TRAIN["lr"],
                             parameters=list(model.parameters()))

    def loss_fn(ids, pos, mlm, nsp):
        mlm_logits, nsp_logits = model(ids, masked_positions=pos)
        return crit(mlm_logits, nsp_logits, mlm, nsp)

    return model, cfg, DistributedTrainStep(model, loss_fn, opt, strategy)


def bert_train(dev):
    """Phase 29: the bench's BERT-base pretraining at batch 128 x seq 128,
    dropout on: every loss finite, the first within BERT_FIRST_LOSS_TOL
    of ln(vocab) + ln(2); ms/step (median of steps 3-20), tokens/s, model
    TFLOP/s and MFU from the bench's analytic count, peak memory; every
    registered kernel's launch count 0 (the reference runs no Pallas
    kernel at seq 128: its flash kernel needs 1,024 positions)."""
    from paddle_tpu_torch.ops.kernels import registry
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    model, cfg, step = _bert_train_step(dev)
    b, s = BERT_TRAIN["batch"], BERT_TRAIN["seq"]
    batch = _bert_batch(dev, cfg.vocab_size, b, s)
    n_mask = batch[1].shape[1]
    nparams = sum(p.numel() for p in model.parameters())
    torch.cuda.synchronize()
    log(f"bert train: model and batch built in "
        f"{time.perf_counter() - t0:.1f} s ({nparams / 1e6:.2f} M params, "
        f"{n_mask} masked positions a sequence)")
    registry.reset_counts()                  # the main path starts here
    losses, times = [], []
    for _ in range(BERT_TRAIN["steps"]):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = step(*batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss))
    counts = registry.launch_counts()        # ... and ends here
    plain = {k: sp.torch_ref_calls for k, sp in registry.kernels().items()}
    log("bert train: losses " + " ".join(f"{x:.4f}" for x in losses))
    if not all(math.isfinite(x) for x in losses):
        fail(f"bert train: non-finite loss in {losses}")
    want = math.log(cfg.vocab_size) + math.log(2.0)
    if not abs(losses[0] - want) <= BERT_FIRST_LOSS_TOL:
        fail(f"bert train: first loss {losses[0]:.4f}, want {want:.4f} +- "
             f"{BERT_FIRST_LOSS_TOL}")
    ms = statistics.median(times[2:])
    vh = cfg.vocab_size * cfg.hidden_size
    flops = 6.0 * (nparams - vh) * b * s + 6.0 * vh * b * n_mask
    tflops = flops / (ms / 1e3) / 1e12
    row = dict(batch=b, seq=s, masked=n_mask, steps=len(losses),
               ms_per_step=ms, first_step_ms=times[0],
               tokens_per_s=b * s / (ms / 1e3), analytic_tflop=flops / 1e12,
               model_tflops=tflops, mfu=tflops * 1e12 / PEAK_BF16_FLOPS,
               max_memory_allocated_gb=torch.cuda.max_memory_allocated(
                   dev) / 1e9, first_loss=losses[0], first_loss_want=want,
               last_loss=losses[-1])
    log("bert train: " + json.dumps(row))
    log(f"bert train: launches {counts}, plain-version calls {plain} (all 0 "
        "by design: at seq 128 the reference runs no Pallas kernel)")
    if any(counts.values()) or any(plain.values()):
        fail(f"bert train: kernels ran on the training path: {counts} "
             f"{plain}")
    return model, step, batch, counts


def bert_train_vs_f32(dev, batch):
    """Phase 30 (a): one bf16-AMP step against the same step from the f32
    weights in f32 (TF32 off) at batch ``BERT_F32_BATCH``, dropout off:
    the loss within ``E2E_AMP_LOSS_REL``, the global gradient's cosine
    printed beside a control (the f32 step on bf16-rounded weights) and
    required positive."""
    n = BERT_F32_BATCH
    args = tuple(t[:n].contiguous() for t in batch)
    res = {}
    for name, amp, rnd in (("amp", True, False), ("f32", False, False),
                           ("f32 on bf16 weights", False, True)):
        model, _, step = _bert_train_step(
            dev, amp=amp, bf16_weights=rnd, hidden_dropout_prob=0.0,
            attention_probs_dropout_prob=0.0)
        loss, grads = step.loss_and_grads(*args)
        res[name] = (float(loss), torch.cat([g.flatten().double()
                                             for g in grads]))
        del model, step, grads
        torch.cuda.empty_cache()

    def cos(a, b):
        return float(a @ b / (a.norm() * b.norm()))

    f32 = res["f32"]
    out = {}
    for name in ("amp", "f32 on bf16 weights"):
        r = res[name]
        out[name] = dict(loss=r[0], loss_f32=f32[0],
                         loss_rel=abs(r[0] - f32[0]) / abs(f32[0]),
                         grad_cos=cos(r[1], f32[1]),
                         grad_norm_ratio=float(r[1].norm() / f32[1].norm()))
        log(f"bert train vs f32 (batch {n}), {name}: "
            + json.dumps(out[name]))
    a = out["amp"]
    if not a["loss_rel"] <= E2E_AMP_LOSS_REL:
        fail(f"bert train vs f32: loss {a['loss']} against {a['loss_f32']} "
             f"(relative {a['loss_rel']:.4g} > {E2E_AMP_LOSS_REL})")
    if not a["grad_cos"] > 0:
        fail(f"bert train vs f32: the bf16 gradient is not a descent "
             f"direction of the f32 loss (cosine {a['grad_cos']:.4g})")
    return out


def dropout_on_card(dev):
    """Phase 30 (b): ``nn.functional.dropout`` on 2^24 f32 elements at p =
    0.1 on the card: the keep rate within 0.9 +- 0.001; the output
    bitwise ``where(keep, x / f32(0.9), 0)`` with the mask replayed from
    the generator and the quotient correctly rounded (f64, rounded once);
    the same seed gives the same mask, another seed another."""
    from paddle_tpu_torch.nn.functional import dropout
    n, p = BERT_DROPOUT["numel"], BERT_DROPOUT["p"]
    x = torch.randn(n, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(
                        SEED + 7))

    def gen(seed):
        return torch.Generator(device=dev).manual_seed(seed)

    y, again, other = (dropout(x, p, generator=gen(sd))
                       for sd in (SEED, SEED, SEED + 1))
    keep = torch.rand(n, generator=gen(SEED), device=dev) < 1.0 - p
    div = (x.double() / float(np.float32(1.0 - p))).float()
    want = torch.where(keep, div, torch.zeros((), device=dev))
    recip = x * float(np.float32(1.0) / np.float32(1.0 - p))
    rate = float(keep.double().mean())
    row = dict(numel=n, p=p, keep_rate=rate,
               bitwise_divided=bool(torch.equal(y, want)),
               same_seed_same_mask=bool(torch.equal(y, again)),
               other_seed_other_mask=not bool(torch.equal(y, other)),
               kept_values_a_reciprocal_multiply_would_change=int(
                   (keep & (recip != div)).sum()),
               ms=cuda_ms(lambda: dropout(x, p, generator=gen(SEED))))
    log("dropout on the card: " + json.dumps(row))
    if not abs(rate - (1.0 - p)) <= BERT_DROPOUT["rate_tol"]:
        fail(f"dropout: keep rate {rate:.6f}, want {1 - p} +- "
             f"{BERT_DROPOUT['rate_tol']}")
    if not (row["bitwise_divided"] and row["same_seed_same_mask"]
            and row["other_seed_other_mask"]):
        fail(f"dropout: {row}")
    return row


def bert_models(dev):
    """The reference inference bench's BERT pair (``bench.py:1690-1696``):
    ``BertModel(bert_base())`` cast to bf16, and a second copy from the
    same f32 weights converted with ``convert_to_int8_inference`` (dynamic:
    only the pooler is a ``Linear``) and cast the same way."""
    from paddle_tpu_torch.quantization import convert_to_int8_inference
    from paddle_tpu_torch.text.models import BertModel, bert_base

    def make():
        return BertModel(bert_base(), device=dev,
                         generator=torch.Generator(device=dev)
                         .manual_seed(SEED))

    return (_cast_bf16(make().eval()),
            _cast_bf16(convert_to_int8_inference(make())))


def _bert_ids(rng, b):
    return torch.from_numpy(rng.randint(0, 30522, (b, BERT_INFER_SEQ))
                            .astype(np.int32))


def bert_serve(dev, bf16_model, int8_model):
    """Phase 31: per-forward ms (median of 20 CUDA-event timings),
    sequences/s, device busy ms and peak memory of the bf16 and the int8
    BERT-base at each batch, and the bench's ``int8_speedup``; every int8
    forward must launch ``int8_matmul`` exactly once in dynamic mode, no
    bf16 forward any kernel.  Then, at batch 32, the int8 pooled output
    bitwise against the plain version's (``set_kernel_mode(model,
    "torch_ref")``) and, for information, its largest distance from the
    bf16 model's."""
    from paddle_tpu_torch.ops.kernels import registry
    from paddle_tpu_torch.ops.kernels.registry import set_kernel_mode
    forwards = collections.Counter()

    def counted(name, model):
        def fwd(ids):
            forwards[name] += 1
            return model(ids)
        return fwd

    # a fresh RandomState(0), batch by batch (the bench's shares its
    # generator with the ResNet sweep before it)
    rng = np.random.RandomState(0)
    res = []
    registry.reset_counts()                  # the main path starts here
    with torch.no_grad():
        for b in BERT_INFER_BATCHES:
            ids = _bert_ids(rng, b).to(dev)
            row = dict(batch=b, seq=BERT_INFER_SEQ)
            for name, fn in (("int8", counted("int8", int8_model)),
                             ("bf16", counted("bf16", bf16_model))):
                seq, pooled = fn(ids)
                torch.cuda.synchronize()
                ok = (tuple(seq.shape) == (b, BERT_INFER_SEQ, 768)
                      and tuple(pooled.shape) == (b, 768)
                      and bool(torch.isfinite(seq.float()).all())
                      and bool(torch.isfinite(pooled.float()).all()))
                if not ok:
                    fail(f"bert {name} batch {b}: outputs "
                         f"{tuple(seq.shape)} {tuple(pooled.shape)} not "
                         "of the expected shape or not finite")
                del seq, pooled
                torch.cuda.reset_peak_memory_stats(dev)
                ms = cuda_ms(lambda: fn(ids))
                row[f"{name}_ms"] = ms
                row[f"{name}_sequences_per_s"] = b / (ms / 1e3)
                row[f"{name}_max_memory_allocated_gb"] = (
                    torch.cuda.max_memory_allocated(dev) / 1e9)
                row[f"{name}_device_busy_ms"] = profile_calls(
                    lambda: fn(ids))[1]
            row["int8_speedup"] = row["bf16_ms"] / row["int8_ms"]
            res.append(row)
            log("bert serve: " + json.dumps(row))
    counts = registry.launch_counts()        # ... and ends here
    by_mode = registry.spec("int8_matmul").mode_launches
    modes = {k: by_mode.get(k, 0) for k in ("dynamic", "weight_only")}
    want = dict.fromkeys(counts, 0)
    want["int8_matmul"] = forwards["int8"]
    want_modes = {"dynamic": forwards["int8"], "weight_only": 0}
    log(f"bert serve: {forwards['int8']} int8 and {forwards['bf16']} bf16 "
        f"forwards, launches {counts} (want {want}), int8_matmul by mode "
        f"{modes} (want {want_modes})")
    if counts != want or modes != want_modes:
        fail(f"bert serve: launches {counts} by mode {modes}, want {want} "
             f"by mode {want_modes}")
    # the pooler alone (host and device, between events): where the int8
    # forward's wall time differs from the bf16 forward's
    with torch.no_grad():
        for row in res:
            h0 = torch.randn(row["batch"], 768, device=dev).to(torch.bfloat16)
            for name, model in (("int8", int8_model), ("bf16", bf16_model)):
                row[f"{name}_pooler_ms"] = cuda_ms(lambda: model.pooler(h0))
            log(f"bert serve: the pooler alone at batch {row['batch']}: "
                f"int8 {row['int8_pooler_ms']:.4f} ms, bf16 "
                f"{row['bf16_pooler_ms']:.4f} ms a call")
    ids = _bert_ids(np.random.RandomState(1), 32).to(dev)
    with torch.no_grad():
        ker = int8_model(ids)[1]
        set_kernel_mode(int8_model, "torch_ref")
        try:
            plain = int8_model(ids)[1]
        finally:
            set_kernel_mode(int8_model, None)
        ref = bf16_model(ids)[1]
    torch.cuda.synchronize()
    equal = torch.equal(ker, plain)
    dist = float((ker.float() - ref.float()).abs().max())
    log(f"bert end to end (batch 32): the int8 pooled output with the "
        f"kernel {'bitwise equal to' if equal else 'DIFFERS from'} the "
        f"plain version's; max |int8 - bf16| pooled {dist:.4g}")
    if not equal:
        d = float((ker.float() - plain.float()).abs().max())
        fail(f"bert end to end: the int8 pooled output differs from the "
             f"plain version's by up to {d:.4g}")
    return counts, res


def profile_bert_train(dev, step, batch, steps: int = 2):
    """Phase 32: ``torch.profiler`` over 2 training steps of phase 29's
    model: device busy time against wall time, the top device kernels,
    device time by kernel class and under the forward's ``layer_norm``,
    ``dropout``, ``attention``, ``gelu``, ``mlm_decode`` and ``loss``
    ranges and the ``optimizer`` range, and the largest allocations."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    step(*batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 profile_memory=True) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step(*batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    avgs = prof.key_averages()
    kern = device_kernels(avgs)
    busy_ms = sum(e.self_device_time_total for e in kern) / 1e3 / steps
    n_kern = sum(e.count for e in kern) // steps
    log(f"profile bert train: wall {wall_ms:.2f} ms/step, device busy "
        f"{busy_ms:.2f} ms/step, idle share {1 - busy_ms / wall_ms:.4f}, "
        f"{n_kern} kernels/step")
    check_busy("profile bert train (phase 32)", busy_ms, wall_ms)
    for e in sorted(kern, key=lambda e: -e.self_device_time_total)[:15]:
        log(f"  {e.key[:70]:70s} {e.self_device_time_total / 1e3 / steps:8.3f}"
            f" ms/step  x{e.count // steps}")
    by_class = {}
    for e in kern:
        c = _train_class(e.key)
        by_class[c] = by_class.get(c, 0.0) + e.self_device_time_total
    log("profile bert train: device ms/step by kernel class (forward and "
        "backward):")
    for c, t in sorted(by_class.items(), key=lambda kv: -kv[1]):
        log(f"  {c:14s} {t / 1e3 / steps:8.3f} ms/step "
            f"({t / 1e3 / steps / busy_ms:.3f} of busy)")
    cpu = {e.key: e for e in avgs if e.device_type == DeviceType.CPU}
    log("profile bert train: device ms/step under each range (inclusive; "
        "the forward's ranges hold no backward kernel; attention holds "
        "its dropout):")
    ranges = {}
    for name in ("layer_norm", "dropout", "attention", "gelu", "mlm_decode",
                 "loss", "optimizer"):
        t = cpu[name].device_time_total if name in cpu else 0.0
        ranges[name] = t / 1e3 / steps
        log(f"  {name:12s} {ranges[name]:8.3f} ms/step "
            f"({ranges[name] / busy_ms:.3f} of busy)  "
            f"x{(cpu[name].count if name in cpu else 0) // steps}")

    def mem(e):
        return getattr(e, "self_device_memory_usage", 0) or 0

    log("profile bert train: device memory allocated by op itself "
        "(GB/step):")
    for e in sorted(avgs, key=lambda e: -mem(e))[:8]:
        log(f"  {e.key[:60]:60s} {mem(e) / 1e9 / steps:8.3f} GB/step"
            f"  x{e.count // steps}")
    return dict(wall_ms=wall_ms, busy_ms=busy_ms, by_class=by_class,
                ranges=ranges)


# ---------------------------------------------------------------------
# phases 33-35: the flash kernels' options, ERNIE-3.0-base pretraining
# at 2,048 positions, Transformer-base translation of 1,024-token sources
# ---------------------------------------------------------------------

# ERNIE 3.0 base (PaddleNLP's ernie-3.0-base-zh): BERT-base geometry
# (hidden 768, 12 layers, 12 heads of 64, FFN 3,072, dropout 0.1) with a
# 40,000-id vocabulary, 2,048 learned positions and 4 token types,
# trained as the bench trains BERT (bench.py:366-418: AdamW 1e-4, bf16
# AMP, 15 % masked positions, no padding mask) at batch 8 x seq 2,048:
# the bench's 16,384 tokens a step, int(2048 * 0.15) = 307 masked a
# sequence.  Left out: ERNIE 3.0's task-type embedding (use_task_id),
# which the reference's BertConfig has no table for.
ERNIE_CFG = dict(vocab_size=40000, max_position_embeddings=2048,
                 type_vocab_size=4)
ERNIE_TRAIN = dict(batch=8, seq=2048, steps=6)
# phase 34's kernels-against-plain step, per precision: the loss's
# relative distance and the worst attention leaf's relative L2 distance
# at most these.  Each limit lies between the sound step's reading and
# the planted faults' (this function in my chip call 5, PR 15, NVIDIA
# H100 80GB HBM3, 700 W; a rerun agreed to 1e-3 of each reading), near
# their geometric mean:
# bf16 AMP, where the kernels round P to bf16 per 64-key tile and the
# plain versions do not, read loss 6.1e-5 and worst leaf 0.0144 sound
# against 1.4e-4 (the forward's fault) and 0.0252-0.0262 faulty; f32
# read loss 0 and worst leaf 1.8e-6 sound against 6.6e-5 and 0.0204-0.0211
ERNIE_E2E = {"bf16": dict(loss_rel=9e-5, attn_grad_rel=0.019),
             "f32": dict(loss_rel=1e-6, attn_grad_rel=2e-4)}
# the repo's WMT Transformer base (text/models/transformer.py) with a
# 1,024-position table (sinusoidal: no weight changes): 8 sources of
# seeded lengths 512-1,024 padded with pad id 0; greedy and 4-beam
# decoding of 32 tokens, f32 (the reference's dtype for this model)
MT_SRC = dict(batch=8, seq=1024, min_len=512, decode=32, beam=4)
# phase 35: the encoder memory with kernels against plain versions, at
# most this share of the memory's largest |value| apart (f32 kernels
# within 1e-4 of the plain attention, through 6 pre-norm layers)
MT_MEMORY_TOL = 1e-4
# phase 33's dropout probability and the keep rate's band in sigmas
OPT_P, OPT_SIGMAS = 0.1, 5.0


def _pad_bias(dev, B, S, dt, seed):
    """The translation encoder's padding row: 0 on each source's seeded
    length (MT_SRC's range), -1e9 on its pads, [B, 1, 1, S] in ``dt``."""
    rng = np.random.RandomState(seed)
    lens = rng.randint(MT_SRC["min_len"], S + 1, B)
    row = np.where(np.arange(S)[None, :] < lens[:, None], 0.0, -1e9)
    return torch.from_numpy(row.astype(np.float32)[:, None, None, :]).to(
        dev, dt)


def _turns(calls, rounds=2):
    """Each call queued behind a spinning kernel, in turns, ``rounds``
    times; the lower of each kept."""
    runs = [{n: queued_ms(f) for n, f in calls.items()}
            for _ in range(rounds)]
    return {n: min(r[n] for r in runs) for n in calls}


def keep_mask_cases(dev):
    """Phase 33 (a): the device header's keep mask (its debug entry, one
    element a thread) bitwise against ``dropout_keep_mask`` at both paths'
    full shapes (ERNIE's B 8 x H 12 x 2,048^2 and the translation
    encoder's B 8 x H 8 x 1,024^2) and at an odd block; the keep rate
    within OPT_SIGMAS sigma of 1 - p."""
    from paddle_tpu_torch.ops.kernels.flash_attention import (
        dropout_keep_mask, dropout_keep_mask_cuda, dropout_seed)
    seed = dropout_seed(torch.Generator(device=dev).manual_seed(SEED + 33))
    eb, es = ERNIE_TRAIN["batch"], ERNIE_TRAIN["seq"]
    mb, ms = MT_SRC["batch"], MT_SRC["seq"]
    out = {}
    for label, shape in (("ernie", (eb, 12, es, es, 0, 0)),
                         ("translation", (mb, 8, ms, ms, 0, 0)),
                         ("odd block", (2, 3, 33, 65, 7, 1021))):
        got = dropout_keep_mask_cuda(seed, *shape[:4], OPT_P, *shape[4:])
        want = dropout_keep_mask(seed, *shape[:4], OPT_P, *shape[4:])
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            fail(f"keep mask {label} {shape}: the device header's mask "
                 f"differs from dropout_keep_mask at "
                 f"{int((got != want).sum())} elements")
        n = got.numel()
        rate = got.double().mean().item()
        sigma = math.sqrt(OPT_P * (1 - OPT_P) / n)
        out[label] = dict(elements=n, keep_rate=rate,
                          sigmas=(rate - (1 - OPT_P)) / sigma)
        if abs(rate - (1 - OPT_P)) > OPT_SIGMAS * sigma:
            fail(f"keep mask {label}: keep rate {rate:.6f} more than "
                 f"{OPT_SIGMAS} sigma from {1 - OPT_P}")
        del got, want
    log("keep mask (device header vs dropout_keep_mask, p = "
        f"{OPT_P}): bitwise; " + json.dumps(out))
    return out


def bias_cases(dev):
    """Phase 33 (b): kernel 1 with the bias row at the translation
    encoder's shape (B 8, H 8, S 1,024, D 64; seeded padding) in bf16 and
    f32 (bf16 on the Hopper route), and at head_dim 128 in bf16 (the
    mma.sync route): within ``CARD_TOL`` of the plain versions (bf16: the
    blockwise one at the kernel's key tile), bitwise on a rerun; a row
    shared by the batch (batch stride 0) bitwise equal to the same row
    copied to every sequence; timed queued beside its bound
    (operations at 989 TFLOP/s bf16), its plain version and SDPA with the
    same float [B, 1, 1, S] mask (a yardstick only).  f32 (the 3xTF32
    route) is bounded by three TF32 products for each product at 495
    TFLOP/s and by its exponentials; the same products on the FMA pipe
    (67 TFLOP/s) are reported beside.  Returns the rows by label."""
    from paddle_tpu_torch.ops.kernels.flash_attention import (
        CARD_TOL, flash_attention_bhsd, flash_attention_blockwise_ref,
        flash_attention_ref, flash_fwd_plan)
    g = torch.Generator(device=dev).manual_seed(SEED + 34)
    B, S = MT_SRC["batch"], MT_SRC["seq"]
    rows = {}
    for dt, H, D in ((torch.float32, 8, 64), (torch.bfloat16, 8, 64),
                     (torch.bfloat16, 8, 128)):
        q, k, v = (torch.randn(B, H, S, D, device=dev, dtype=dt,
                               generator=g) for _ in range(3))
        bias = _pad_bias(dev, B, S, dt, SEED + 35)
        plan = flash_fwd_plan(q, k, v, bias=bias)
        with torch.no_grad():
            o = flash_attention_bhsd(q, k, v, bias=bias)
            again = flash_attention_bhsd(q, k, v, bias=bias)
            ref = (flash_attention_blockwise_ref(q, k, v, bias=bias,
                                                 block_k=plan.block_k)
                   if dt == torch.bfloat16
                   else flash_attention_ref(q, k, v, bias=bias))
            torch.cuda.synchronize()
            dname = str(dt).replace("torch.", "")
            label = f"bias {dname} D={D}"
            if not torch.equal(o, again):
                fail(f"flash_attention {label}: a rerun is not bitwise")
            err, share = check_close(f"flash_attention {label}", o, ref,
                                     CARD_TOL[dt])
            # one row for the whole batch (a [1, 1, 1, S] row, read with
            # batch stride 0) against that row copied to every sequence
            row = bias[:1]
            shared = flash_attention_bhsd(q, k, v, bias=row)
            copied = flash_attention_bhsd(
                q, k, v, bias=row.expand(B, 1, 1, S).contiguous())
            torch.cuda.synchronize()
            if not torch.equal(shared, copied):
                fail(f"flash_attention {label}: a row shared by the batch "
                     "differs from the row copied to every sequence")
            del shared, copied
            t = bias_times(q, k, v, bias)
            plain = cuda_ms(lambda: flash_attention_bhsd(
                q, k, v, bias=bias, mode="torch_ref"), iters=3, warmup=1)
        flops = 4 * D * B * H * S * S
        nbytes = (4 * B * H * S * D * q.element_size()
                  + B * S * q.element_size())
        extra, why = {}, ""
        if dt == torch.bfloat16:
            bms, by = bound_ms(flops, PEAK_BF16_FLOPS, nbytes)
        else:
            # f32-accurate products on the tensor cores: three TF32
            # products each (3xTF32), beside the exponentials (one a
            # score); the same products on the FMA pipe, the bound of the
            # route before it, are reported beside it
            tc_ms, by = bound_ms(3 * flops, PEAK_TF32_FLOPS, nbytes)
            ex_ms, _ = exp_bound_ms(dev, B * H * S * S)
            bms = max(tc_ms, ex_ms)
            fma_ms, _ = bound_ms(flops, PEAK_F32_FLOPS, nbytes)
            extra = dict(bound_tf32x3_ms=tc_ms, bound_exp_ms=ex_ms,
                         bound_fma_ms=fma_ms)
            why = (f"; the kernel is measured against 3xTF32 at "
                   f"{PEAK_TF32_FLOPS / 1e12:.0f} TFLOP/s {tc_ms:.4f} "
                   f"(exponentials {ex_ms:.4f}); the products on the FMA "
                   f"pipe at {PEAK_F32_FLOPS / 1e12:.0f} TFLOP/s "
                   f"{fma_ms:.4f}, kernel / that {t['kernel'] / fma_ms:.3f}")
        rows[label] = dict(ms=t["kernel"], plain_ms=plain, bound_ms=bms,
                           bound_by=by, library_ms=t["sdpa"],
                           max_abs_err=err, **extra)
        log(f"flash_attention {label} (B={B} H={H} S={S}, seeded padding "
            f"rows): route {plan.route}, {plan.block_q} x {plan.block_k} "
            f"tiles, {plan.smem_bytes} B shared memory; max_err {err:.3g} "
            f"({share:.3g} of its limit), rerun bitwise, a shared row "
            f"bitwise its copies; device ms "
            f"(queued): kernel {t['kernel']:.4f} plain {plain:.4f} bound "
            f"{bms:.4f} ({by}) library(sdpa, float mask) {t['sdpa']:.4f}; "
            f"kernel / sdpa {t['kernel'] / t['sdpa']:.3f}, kernel / plain "
            f"{t['kernel'] / plain:.3f}, kernel / bound "
            f"{t['kernel'] / bms:.3f}; {flops / t['kernel'] / 1e9:.1f} "
            f"TFLOP/s{why}")
        del q, k, v, o, again, ref
    return rows


def dropout_cases(dev):
    """Phase 33 (c): kernels 1-3 with in-kernel dropout (p = OPT_P, one
    seed) through the autograd Function at ERNIE's shape (B 8, H 12, S
    2,048, D 64), bf16 and f32, causal and not: the forward and the three
    gradients within ``CARD_TOL`` / ``CARD_TOL_BWD`` of the plain versions
    with the same seed (bf16: the blockwise ones), bitwise on a rerun.
    The path's own case (bf16, not causal) is timed queued: the forward
    with its LSE, each backward kernel (with dropout and without),
    beside their bounds (:func:`_dropout_timing`), their plain versions
    and SDPA with ``dropout_p`` (its forward, and its backward for dq +
    dk + dv; a yardstick only, its masks differ).
    Returns the rows by kernel name."""
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    gen = torch.Generator(device=dev).manual_seed(SEED + 36)
    B, S, H, D = ERNIE_TRAIN["batch"], ERNIE_TRAIN["seq"], 12, 64
    seed = fa.dropout_seed(gen)
    rows = {}
    for dt in (torch.bfloat16, torch.float32):
        q, k, v, do = (torch.randn(B, H, S, D, device=dev, dtype=dt,
                                   generator=gen) for _ in range(4))
        for causal in (False, True):
            kw = dict(causal=causal, dropout_p=OPT_P, seed=seed)
            outs = []
            for _ in range(2):
                qq, kk, vv = (t.detach().requires_grad_()
                              for t in (q, k, v))
                o = fa.flash_attention_bhsd(qq, kk, vv, **kw)
                outs.append((o.detach(), *torch.autograd.grad(
                    o, (qq, kk, vv), do)))
            dname = str(dt).replace("torch.", "")
            label = f"dropout {dname} causal={causal}"
            if not all(torch.equal(a, b) for a, b in zip(*outs)):
                fail(f"flash {label}: a rerun is not bitwise")
            with torch.no_grad():
                ro, lse = fa.flash_attention_ref(q, k, v, return_lse=True,
                                                 **kw)
                if dt == torch.bfloat16:
                    ro = fa.flash_attention_blockwise_ref(
                        q, k, v, block_k=fa.flash_fwd_plan(
                            q, k, v, dropout_p=OPT_P).block_k, **kw)
                delta = fa.attention_delta(outs[0][0], do)
                args = (q, k, v, do, lse, delta)
                ref = (fa.flash_attention_bwd_blockwise_ref(*args, **kw)
                       if dt == torch.bfloat16 else
                       (fa.flash_attention_bwd_dq_ref(*args, **kw),
                        *fa.flash_attention_bwd_dkv_ref(*args, **kw)))
            torch.cuda.synchronize()
            errs = [check_close(f"flash_attention {label}", outs[0][0], ro,
                                fa.CARD_TOL[dt])]
            for name, got, want in zip(("dq", "dk", "dv"), outs[0][1:],
                                       ref):
                errs.append(check_close(f"flash {name} {label}", got, want,
                                        fa.CARD_TOL_BWD[dt]))
            log(f"flash {label} (B={B} H={H} S={S} D={D}): route "
                f"{fa.flash_fwd_plan(q, k, v, dropout_p=OPT_P).route}; "
                "max_err (share of its limit) o / dq / dk / dv: "
                + " / ".join(f"{e:.3g} ({s:.3g})" for e, s in errs)
                + "; rerun bitwise")
            if dt == torch.bfloat16 and not causal:
                rows = _dropout_timing(q, k, v, do, lse, delta, kw, errs)
            del outs, ro, lse, delta, ref
        del q, k, v, do
    return rows


# The keep mask's integer bound on an H100 SM, a clock: 64 results on
# each integer pipe (CUDA C++ Programming Guide, arithmetic instruction
# throughput, compute capability 9.0: 32-bit add, compare, bitwise,
# shift and multiply-add each 64), IMAD / IMUL on the FMA pipe and the
# rest on the ALU (Nsight Compute's kernel profiling guide, "Pipelines"),
# and at most 128 thread-instructions issued (four schedulers, one warp
# instruction a clock each; NVIDIA H100 Tensor Core GPU Architecture);
# at the card's maximum SM clock
INT_PIPE_PER_CLOCK_SM = 64
ISSUE_PER_CLOCK_SM = 128
# ex2 on the special-function units: 16 results a clock an SM (the same
# throughput table: base-2 exponential)
MUFU_PER_CLOCK_SM = 16
# the kernels that run Philox at ERNIE's shape -- kernel 1 (the forward)
# and kernel 2 (dK/dV, which writes the keep bits kernel 3 reads) -- with
# dropout and the same kernel without it, as substrings of their mangled
# names, and the scores whose keep bits the kernel's code forms once
# (keep_groups_mma: 8 Philox calls of 4 scores for 32 scores).  Kernel
# 2's consumer loop body forms one 64 x 64 tile's bits, 32 a thread.
# Kernel 1 splits a 128 x 128 tile's between its producer warps (64 a
# thread, once in their loop) and its consumer threads (32 a thread, in
# the loop body and again for the item's first tile, which the pipeline
# issues before the loop); the 128 producer and 256 consumer threads
# run that code once a tile, so the static difference over 64 + 2 x 32
# = 128 scores is the integer work a score.  The keep mask's integer
# instructions are the difference (paddle_tpu_torch/tools/sass_counts.py).
# That difference holds each design's own overhead (stores and loads of
# the keep words, per-item arithmetic) beside the mask's work, so every
# kernel that runs Philox is bounded by the least count a score of any
# kernel here, which is the least that the mask is known to need.
KEEP_MASK_SASS = {
    "flash_attention": ("flash_attention_fwd.cu",
                        "flash_fwd_sm90ILi64ELb0ELb1E",
                        "flash_fwd_sm90ILi64ELb0ELb0E", 128),
    "flash_attention_bwd_dkv": ("flash_attention_bwd.cu",
                                "flash_bwd_sm90ILb1ELi64ELi1E",
                                "flash_bwd_sm90ILb1ELi64ELi0E", 32)}


def max_sm_clock_mhz():
    return float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60, check=True).stdout.split()[0])


def keep_mask_bound_ms(name, dev, scores):
    """The least time the card needs for kernel ``name``'s keep mask:
    ``scores`` x the integer instructions a score costs in the kernel's
    SASS, on the busier of the two integer pipes or, if it binds, the
    issue slots, over the SMs at the maximum SM clock.  Returns (ms, the
    counts)."""
    from paddle_tpu_torch.tools import sass_counts
    counts = sass_counts.keep_mask_int_ops(*KEEP_MASK_SASS[name])
    mhz = max_sm_clock_mhz()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    ps = counts["per_score"]
    clocks = max(ps["fma"] / INT_PIPE_PER_CLOCK_SM,
                 ps["alu"] / INT_PIPE_PER_CLOCK_SM,
                 (ps["fma"] + ps["alu"]) / ISSUE_PER_CLOCK_SM)
    counts.update(clocks_per_score_sm=clocks, sm_clock_mhz=mhz, sms=sms)
    return scores * clocks / (sms * mhz * 1e6) * 1e3, counts


def exp_bound_ms(dev, scores):
    """The least time the card needs for ``scores`` exponentials, one
    ex2 each at MUFU_PER_CLOCK_SM a clock an SM over the SMs at the
    maximum SM clock.  Returns (ms, the clock and SMs)."""
    mhz = max_sm_clock_mhz()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    return (scores / (MUFU_PER_CLOCK_SM * sms * mhz * 1e6) * 1e3,
            dict(sm_clock_mhz=mhz, sms=sms))


def forward_times(q, k, v, kw):
    """Kernel 1 on q, k, v (its forward with the LSE, as training
    launches it) and SDPA, queued in turns (:func:`_turns`), each with
    dropout (``kw``: causal, dropout_p, seed; SDPA with ``dropout_p``, a
    yardstick only, its masks differ) and without it.  Also run by
    ``paddle_tpu_torch/tools/flash_times.py`` on other checkouts'
    packages.  Returns ms by name: "flash_attention", "flash_attention
    no option", "sdpa", "sdpa no dropout"."""
    import torch.nn.functional as tF

    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    causal, p = kw["causal"], kw["dropout_p"]
    with torch.no_grad():
        return _turns({
            "flash_attention": lambda: fa.flash_attention_bhsd(
                q, k, v, return_lse=True, **kw),
            "flash_attention no option": lambda: fa.flash_attention_bhsd(
                q, k, v, return_lse=True, causal=causal),
            "sdpa": lambda: tF.scaled_dot_product_attention(
                q, k, v, dropout_p=p, is_causal=causal),
            "sdpa no dropout": lambda: tF.scaled_dot_product_attention(
                q, k, v, is_causal=causal)})


def bias_times(q, k, v, bias):
    """Kernel 1 with the bias row on q, k, v and SDPA with the same float
    [B, 1, 1, S] mask (a yardstick only), queued in turns.  Also run by
    ``paddle_tpu_torch/tools/flash_times.py``.  Returns ms by name:
    "kernel", "sdpa"."""
    import torch.nn.functional as tF

    from paddle_tpu_torch.ops.kernels.flash_attention import (
        flash_attention_bhsd)
    with torch.no_grad():
        return _turns({
            "kernel": lambda: flash_attention_bhsd(q, k, v, bias=bias),
            "sdpa": lambda: tF.scaled_dot_product_attention(
                q, k, v, attn_mask=bias)})


def backward_times(args, kw):
    """Kernels 2 and 3 on ``args`` (q, k, v, dO, LSE, delta), queued in
    turns (:func:`_turns`), with dropout (``kw``: causal, dropout_p,
    seed) and without it, each as the autograd backward launches it: on
    the Hopper route dK/dV writes the keep bits dQ reads.  Also run by
    ``paddle_tpu_torch/tools/flash_times.py`` on other checkouts'
    packages, so it passes the keep bits only where the package has
    them.  Returns (ms with dropout, ms without) by kernel name, and the
    keep bits (None off the Hopper route)."""
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    from paddle_tpu_torch.ops.kernels import registry
    bits, extra = None, ({}, {})
    if hasattr(fa, "keep_bits_buffer"):
        bits = fa.keep_bits_buffer(*args[:4], kw["causal"], kw["dropout_p"],
                                    kw["seed"], None)
        extra = (dict(keep_bits_out=bits), dict(keep_bits=bits))
    with torch.no_grad():
        registry.dispatch(FLASH_NAMES[1], *args, **extra[0], **kw)
        t = _turns({n: lambda n=n, e=e: registry.dispatch(
            n, *args, **e, **kw) for n, e in zip(FLASH_NAMES[1:], extra)})
        t0 = _turns({n: lambda n=n: registry.dispatch(
            n, *args, causal=kw["causal"]) for n in FLASH_NAMES[1:]})
    return t, t0, bits


def _dropout_timing(q, k, v, do, lse, delta, kw, errs):
    """Phase 33 (c)'s timing of the path's own case: kernels 1-3 (the
    forward with its LSE, :func:`forward_times`; the backward,
    :func:`backward_times`), their plain versions and SDPA with
    ``dropout_p`` (forward, and backward for dq + dk + dv), each kernel
    beside its bound: the larger of its score products' (989 TFLOP/s),
    for kernel 1 its exponentials' (:func:`exp_bound_ms`) and, for the
    kernels that run Philox, the keep mask's integer work at the least
    count a score among them (:func:`keep_mask_bound_ms`).  Each kernel
    is also timed without dropout, beside SDPA's forward or backward
    without it.  Returns the rows by kernel name."""
    import torch.nn.functional as tF

    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    from paddle_tpu_torch.ops.kernels import registry
    B, H, S, D = q.shape
    names = FLASH_NAMES[1:]
    args = (q, k, v, do, lse, delta)
    t, t0, bits = backward_times(args, kw)
    tf = forward_times(q, k, v, kw)
    t.update({"flash_attention": tf["flash_attention"], "sdpa": tf["sdpa"]})
    t0.update({"flash_attention": tf["flash_attention no option"],
               "sdpa": tf["sdpa no dropout"]})
    q2, k2, v2 = (x.detach().clone().requires_grad_() for x in (q, k, v))
    out = tF.scaled_dot_product_attention(q2, k2, v2, dropout_p=OPT_P)
    q3, k3, v3 = (x.detach().clone().requires_grad_() for x in (q, k, v))
    out3 = tF.scaled_dot_product_attention(q3, k3, v3)
    t["sdpa backward"] = _turns({"b": lambda: torch.autograd.grad(
        out, (q2, k2, v2), do, retain_graph=True)})["b"]
    t0["sdpa backward"] = _turns({"b": lambda: torch.autograd.grad(
        out3, (q3, k3, v3), do, retain_graph=True)})["b"]
    with torch.no_grad():
        plain = {"flash_attention": cuda_ms(lambda: fa.flash_attention_bhsd(
            q, k, v, return_lse=True, mode="torch_ref", **kw), iters=3,
            warmup=1)}
        for n in names:
            plain[n] = cuda_ms(lambda n=n: registry.dispatch(
                n, *args, mode="torch_ref", **kw), iters=3, warmup=1)
    fplan = fa.flash_fwd_plan(q, k, v, dropout_p=OPT_P)
    plan = fa.flash_bwd_plan(q, k, v, do, dropout_p=OPT_P)
    plan0 = fa.flash_bwd_plan(q, k, v, do)
    log(f"flash forward (ERNIE shape): route {fplan.route} with dropout, "
        f"{fa.flash_fwd_plan(q, k, v).route} without; {fplan.block_q} "
        f"query rows x {fplan.block_k} keys, {fplan.stages} stages, "
        f"{fplan.smem_bytes} B shared memory, grid {fplan.grid}")
    log(f"flash backward (ERNIE shape): route {plan.route} with dropout, "
        f"{plan0.route} without; dK/dV {plan.dkv.block_res} resident x "
        f"{plan.dkv.block_str} streamed rows, {plan.dkv.stages} stages, "
        f"grid {plan.dkv.grid}; dQ {plan.dq.block_res} x "
        f"{plan.dq.block_str}, grid {plan.dq.grid}")
    pairs = B * H * S * S
    row_bytes = B * H * S * D * q.element_size()
    # the keep bits dK/dV writes and dQ reads (none off the Hopper route)
    bits_bytes = 0 if bits is None else bits.numel() * 4
    keep = {n: keep_mask_bound_ms(n, q.device, pairs)
            for n in KEEP_MASK_SASS}
    least_name = min(keep, key=lambda n: keep[n][0])
    least = keep[least_name]
    rows = {}
    for name, flops, nbytes, lib, lib_name, err in (
            ("flash_attention", 4 * D * pairs, 4 * row_bytes + B * H * S * 4,
             "sdpa", "SDPA forward", errs[0][0]),
            (names[0], 8 * D * pairs,
             6 * row_bytes + 2 * B * H * S * 4 + bits_bytes,
             "sdpa backward", "SDPA backward", max(errs[2][0], errs[3][0])),
            (names[1], 6 * D * pairs,
             5 * row_bytes + 2 * B * H * S * 4 + bits_bytes,
             "sdpa backward", "SDPA backward", errs[1][0])):
        pms, by = bound_ms(flops, PEAK_BF16_FLOPS, nbytes)
        b0 = pms            # the bound without the keep mask
        rows[name] = dict(ms=t[name], plain_ms=plain[name], bound_ms=pms,
                          bound_by=by, library_ms=t[lib], max_abs_err=err,
                          bound_products_ms=pms)
        parts = [f"products {pms:.4f}"]
        if name == "flash_attention":
            # one ex2 a score on the special-function units
            ems, c = exp_bound_ms(q.device, pairs)
            rows[name]["bound_exp_ms"] = ems
            parts.append(f"exponentials {ems:.4f}")
            if ems > b0:
                b0, by = ems, "operations"
        bms = b0
        if name in KEEP_MASK_SASS:
            # the keep mask's integer work bounds the kernel too, at the
            # least count a score of the kernels that run it
            c = keep[name][1]
            rows[name].update(bound_keep_mask_ms=least[0],
                              bound_keep_mask_from=least_name,
                              keep_mask_int_per_score=c["per_score"],
                              keep_mask_own_ms=keep[name][0])
            parts.append(f"keep mask {least[0]:.4f}")
            if least[0] > bms:
                bms, by = least[0], "operations"
            ps = c["per_score"]
            log(f"{name} keep mask: {c['extra']['fma']} FMA-pipe and "
                f"{c['extra']['alu']} ALU-pipe integer instructions over "
                f"the kernel without dropout in SASS, for {c['scores']} "
                f"scores a thread: {ps['fma']:.3f} + {ps['alu']:.3f} a "
                f"score, max({ps['fma']:.3f} / {INT_PIPE_PER_CLOCK_SM}, "
                f"{ps['alu']:.3f} / {INT_PIPE_PER_CLOCK_SM}, "
                f"{ps['fma'] + ps['alu']:.3f} / {ISSUE_PER_CLOCK_SM}) = "
                f"{c['clocks_per_score_sm']:.4f} SM clocks a score; "
                f"{pairs} scores / ({c['sms']} SMs x "
                f"{c['sm_clock_mhz']:g} MHz) = {keep[name][0]:.4f} ms; "
                f"bounded at the least of the kernels, {least_name}'s "
                f"{least[0]:.4f} ms, against the products' {pms:.4f} ms")
        rows[name].update(bound_ms=bms, bound_by=by)
        rows[name].update(ms_no_dropout=t0[name],
                          library_ms_no_dropout=t0[lib])
        log(f"{name} dropout p={OPT_P} (B={B} H={H} S={S} D={D} bf16, not "
            f"causal): device ms (queued): kernel {t[name]:.4f} plain "
            f"{plain[name]:.4f} bound {bms:.4f} ({by}: "
            f"{', '.join(parts)}) library ({lib_name}) {t[lib]:.4f}; "
            f"kernel / library {t[name] / t[lib]:.3f}; "
            f"{flops / t[name] / 1e9:.1f} TFLOP/s; without dropout: kernel "
            f"{t0[name]:.4f} (bound {b0:.4f}), "
            f"{lib_name} {t0[lib]:.4f}; the keep mask's share "
            f"{1 - t0[name] / t[name]:.3f}")
    fwd_bwd = sum(t[n] for n in FLASH_NAMES)
    lib = t["sdpa"] + t["sdpa backward"]
    log(f"flash dropout (ERNIE shape): kernels 1-3 {fwd_bwd:.4f} ms against "
        f"SDPA forward + backward with dropout_p {lib:.4f} ms: "
        f"{fwd_bwd / lib:.3f}x; kernel 1 {t['flash_attention']:.4f} ms "
        f"({t0['flash_attention']:.4f} without dropout) against SDPA's "
        f"forward {t['sdpa']:.4f} ({t0['sdpa']:.4f}); kernels 2 + 3 "
        f"{t[names[0]] + t[names[1]]:.4f} ms "
        f"({t0[names[0]] + t0[names[1]]:.4f} without dropout) against "
        f"SDPA's backward {t['sdpa backward']:.4f} "
        f"({t0['sdpa backward']:.4f})")
    del out, q2, k2, v2, out3, q3, k3, v3
    return rows


def _mode_counts():
    from paddle_tpu_torch.ops.kernels import registry
    return {n: dict(s.mode_launches) for n, s in registry.kernels().items()
            if s.mode_launches}


FLASH_NAMES = ("flash_attention", "flash_attention_bwd_dkv",
               "flash_attention_bwd_dq")


def ernie_train(dev):
    """Phase 34: ERNIE-3.0-base pretraining at batch 8 x seq 2,048 (no
    padding mask, so every layer's training attention takes kernels 1-3
    with in-kernel dropout): every loss finite, the first within
    BERT_FIRST_LOSS_TOL of ln(vocab) + ln(2); ms/step (median of steps
    3 on), tokens/s, model TFLOP/s and MFU (the bench's analytic count,
    and with the attention's score products added), peak memory; the
    launches of kernels 1-3, each 12 a step and every one in ``dropout``
    mode."""
    from paddle_tpu_torch.ops.kernels import registry
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    model, cfg, step = _bert_train_step(dev, **ERNIE_CFG)
    b, s = ERNIE_TRAIN["batch"], ERNIE_TRAIN["seq"]
    batch = _bert_batch(dev, cfg.vocab_size, b, s)
    n_mask = batch[1].shape[1]
    nparams = sum(p.numel() for p in model.parameters())
    torch.cuda.synchronize()
    log(f"ernie train: model and batch built in "
        f"{time.perf_counter() - t0:.1f} s ({nparams / 1e6:.2f} M params, "
        f"{n_mask} masked positions a sequence)")
    registry.reset_counts()                  # the main path starts here
    losses, times = [], []
    for _ in range(ERNIE_TRAIN["steps"]):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = step(*batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss))
    counts = registry.launch_counts()        # ... and ends here
    modes = _mode_counts()
    log("ernie train: losses " + " ".join(f"{x:.4f}" for x in losses))
    if not all(math.isfinite(x) for x in losses):
        fail(f"ernie train: non-finite loss in {losses}")
    want = math.log(cfg.vocab_size) + math.log(2.0)
    if not abs(losses[0] - want) <= BERT_FIRST_LOSS_TOL:
        fail(f"ernie train: first loss {losses[0]:.4f}, want {want:.4f} +- "
             f"{BERT_FIRST_LOSS_TOL}")
    ms = statistics.median(times[2:])
    vh = cfg.vocab_size * cfg.hidden_size
    flops = 6.0 * (nparams - vh) * b * s + 6.0 * vh * b * n_mask
    # the score products a step: forward 4 D, backward 8 D + 6 D a pair
    attn = 18.0 * cfg.head_dim * b * cfg.num_attention_heads * s * s \
        * cfg.num_hidden_layers
    tflops = flops / (ms / 1e3) / 1e12
    row = dict(batch=b, seq=s, masked=n_mask, steps=len(losses),
               ms_per_step=ms, first_step_ms=times[0],
               tokens_per_s=b * s / (ms / 1e3), analytic_tflop=flops / 1e12,
               attention_tflop=attn / 1e12, model_tflops=tflops,
               mfu=tflops * 1e12 / PEAK_BF16_FLOPS,
               mfu_with_attention=(flops + attn) / (ms / 1e3)
               / PEAK_BF16_FLOPS,
               max_memory_allocated_gb=torch.cuda.max_memory_allocated(
                   dev) / 1e9, first_loss=losses[0], first_loss_want=want,
               last_loss=losses[-1])
    log("ernie train: " + json.dumps(row))
    log(f"ernie train: launches {counts}, by mode {modes}")
    n = ERNIE_TRAIN["steps"] * cfg.num_hidden_layers
    for name in FLASH_NAMES:
        if counts[name] != n or modes.get(name) != {"dropout": n}:
            fail(f"ernie train: {name} launched {counts[name]} times "
                 f"({modes.get(name)}), want {n}, all with dropout")
    others = {k: c for k, c in counts.items() if c and k not in FLASH_NAMES}
    if others:
        fail(f"ernie train: other kernels ran on the path: {others}")
    return model, step, batch, counts, modes


def _attention_grad_rel(named_k, named_p):
    """||g_k - g_p|| / ||g_p|| of each attention parameter (every layer's
    qkv_proj and out_proj, weight and bias), in f64."""
    return {n: float((gk.double() - gp.double()).norm()
                     / gp.double().norm())
            for (n, gk), (_, gp) in zip(named_k, named_p)
            if ".attention." in n}


@contextlib.contextmanager
def _planted(fault):
    """A planted fault for phase 34 (b), None for none: ``"seed"`` moves
    every attention seed by one (each layer's masks differ from the
    plain run's, forward and backward alike); ``"bwd_seed"`` moves the
    seed only where the backward kernels regenerate the mask (the
    backward's masks differ from the forward's)."""
    import paddle_tpu_torch.text.models.bert as bert_mod
    from paddle_tpu_torch.ops.kernels import registry
    seed_fn, dispatch = bert_mod.dropout_seed, registry.dispatch

    def bwd_shifted(name, *args, **kw):
        if name.startswith("flash_attention_bwd"):
            kw["seed"] = kw["seed"] + 1
        return dispatch(name, *args, **kw)

    if fault == "seed":
        bert_mod.dropout_seed = lambda g: seed_fn(g) + 1
    elif fault == "bwd_seed":
        registry.dispatch = bwd_shifted
    try:
        yield
    finally:
        bert_mod.dropout_seed, registry.dispatch = seed_fn, dispatch


def ernie_kernels_vs_plain(dev, batch):
    """Phase 34 (b): one step with kernels 1-3 against the same step with
    their plain versions, from the same weights and the same dropout
    generator state (the same seeds, so the same masks), with bf16 AMP
    (the path's Hopper route) and in f32 (the 3xTF32 forward and the FMA
    backward, where the rounding is no longer in the way): the loss, and
    each attention
    parameter's gradient (48 leaves: qkv_proj and out_proj of 12 layers)
    by its relative L2 distance, the worst leaf within ERNIE_E2E.  Each precision also runs the kernels' step
    with each planted fault (:func:`_planted`), which must break its
    gradient limit: the limits see a wrong mask."""
    from paddle_tpu_torch.ops.kernels.registry import set_kernel_mode
    row = {}
    for prec in ("bf16", "f32"):
        runs = {}
        for name, mode, fault in (("plain", "torch_ref", None),
                                  ("kernels", None, None),
                                  ("fault_seed", None, "seed"),
                                  ("fault_bwd_seed", None, "bwd_seed")):
            model, cfg, step = _bert_train_step(dev, amp=prec == "bf16",
                                                **ERNIE_CFG)
            set_kernel_mode(model, mode)
            with _planted(fault):
                loss, grads = step.loss_and_grads(*batch)
            runs[name] = (float(loss), list(zip(
                (n for n, _ in model.named_parameters()), grads)))
            del model, step, grads
            torch.cuda.empty_cache()
        lp, gp = runs.pop("plain")
        row[prec] = {"loss_plain": lp}
        for name, (lk, gk) in runs.items():
            rel = _attention_grad_rel(gk, gp)
            worst = max(rel, key=rel.get)
            row[prec][name] = dict(
                loss_rel=abs(lk - lp) / abs(lp), attn_grad_rel_max=rel[worst],
                worst_leaf=worst, attn_grad_rel_median=statistics.median(
                    rel.values()), leaves=len(rel))
        del runs, gp
        log(f"ernie train, {prec}: kernels vs plain versions (one step, "
            f"the same masks), and the planted faults: "
            + json.dumps(row[prec]))
        lim, ok = ERNIE_E2E[prec], row[prec]["kernels"]
        if not (ok["leaves"] == 4 * cfg.num_hidden_layers
                and ok["loss_rel"] <= lim["loss_rel"]
                and ok["attn_grad_rel_max"] <= lim["attn_grad_rel"]):
            fail(f"ernie train, {prec}: kernels and plain versions disagree "
                 f"beyond {lim}: {ok}")
        for name in ("fault_seed", "fault_bwd_seed"):
            if not row[prec][name]["attn_grad_rel_max"] > lim["attn_grad_rel"]:
                fail(f"ernie train, {prec}: the planted fault {name} stays "
                     f"within {lim}: the check cannot see a wrong mask: "
                     f"{row[prec][name]}")
    return row


def profile_ernie_train(dev, step, batch, steps: int = 2):
    """Phase 34 (c): ``torch.profiler`` over 2 ERNIE training steps:
    device busy time against wall time (the idle share), kernels 1-3's
    device ms and launches a step (kernels 2 and 3 each), and the top
    device kernels."""
    from torch.profiler import ProfilerActivity, profile
    step(*batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step(*batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    kern = device_kernels(prof.key_averages())
    busy_ms = sum(e.self_device_time_total for e in kern) / 1e3 / steps
    log(f"profile ernie train: wall {wall_ms:.2f} ms/step, device busy "
        f"{busy_ms:.2f} ms/step, idle share {1 - busy_ms / wall_ms:.4f}, "
        f"{sum(e.count for e in kern) // steps} kernels/step")
    check_busy("profile ernie train (phase 34)", busy_ms, wall_ms)
    log_flash_fwd("profile ernie train", kern, steps)
    bwd = log_flash_bwd("profile ernie train", kern, steps)
    flash = sum(e.self_device_time_total for e in kern
                if "flash_" in e.key) / 1e3 / steps
    log(f"profile ernie train: kernels 1-3 {flash:.3f} device ms/step "
        f"({flash / max(busy_ms, 1e-9):.3f} of busy); kernels 2-3 "
        f"{bwd['dkv'] + bwd['dq']:.3f} device ms/step "
        f"({(bwd['dkv'] + bwd['dq']) / max(busy_ms, 1e-9):.3f} of busy)")
    for e in sorted(kern, key=lambda e: -e.self_device_time_total)[:10]:
        log(f"  {e.key[:70]:70s} {e.self_device_time_total / 1e3 / steps:8.3f}"
            f" ms/step  x{e.count // steps}")
    return dict(wall_ms=wall_ms, busy_ms=busy_ms, flash_ms=flash,
                flash_bwd_ms=bwd)


def _mt_sources(dev, vocab, pad_id):
    rng = np.random.RandomState(SEED + 37)
    B, S = MT_SRC["batch"], MT_SRC["seq"]
    lens = rng.randint(MT_SRC["min_len"], S + 1, B)
    ids = rng.randint(4, vocab, (B, S)).astype(np.int64)
    ids[np.arange(S)[None, :] >= lens[:, None]] = pad_id
    return torch.from_numpy(ids).to(dev), lens


def mt_translate(dev):
    """Phase 35: ``TransformerModel(transformer_base(max_len=1024))``
    (f32 weights from the seed) translating 8 sources of seeded lengths
    512-1,024: the encoder memory with kernel 1's bias row against the
    plain versions (within MT_MEMORY_TOL of its largest |value|), then
    ``greedy_translate`` and ``beam_translate`` (4 beams), 32 tokens:
    ms per call, and 6 launches of kernel 1 per call, each with the bias
    row (one an encoder layer; the decoder's one-token steps take the
    plain attention)."""
    from paddle_tpu_torch.ops.kernels import registry
    from paddle_tpu_torch.ops.kernels.registry import set_kernel_mode
    from paddle_tpu_torch.text.models import (TransformerModel,
                                              beam_translate,
                                              greedy_translate,
                                              transformer_base)
    cfg = transformer_base(max_len=MT_SRC["seq"])
    t0 = time.perf_counter()
    model = TransformerModel(
        cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(
            SEED),
        dropout_generator=torch.Generator(device=dev).manual_seed(SEED + 1))
    model.eval()
    src, lens = _mt_sources(dev, cfg.src_vocab_size, cfg.pad_id)
    torch.cuda.synchronize()
    log(f"translate: transformer_base(max_len={cfg.max_len}) built in "
        f"{time.perf_counter() - t0:.1f} s "
        f"({sum(p.numel() for p in model.parameters()) / 1e6:.2f} M "
        f"params); source lengths {sorted(lens.tolist())}")

    def memory():
        with torch.no_grad():
            return model.transformer.encoder(
                model._embed(model.src_embed, src), model._pad_mask(src))

    registry.reset_counts()
    got = memory()
    set_kernel_mode(model, "torch_ref")
    ref = memory()
    set_kernel_mode(model, None)
    torch.cuda.synchronize()
    err = (got - ref).abs().max().item()
    scale = ref.abs().max().item()
    log(f"translate: encoder memory, kernels vs plain versions: max |err| "
        f"{err:.3g} at a largest |value| {scale:.3g} (limit "
        f"{MT_MEMORY_TOL} of it)")
    if not (bool(torch.isfinite(got).all()) and err <= MT_MEMORY_TOL * scale):
        fail(f"translate: encoder memory {err:.3g} from the plain "
             f"versions' (limit {MT_MEMORY_TOL * scale:.3g})")
    row = dict(memory_max_abs_err=err, memory_max_abs=scale)
    total, modes = {}, {}
    for name, fn in (("greedy", lambda: greedy_translate(
            model, src, max_len=MT_SRC["decode"])),
                     ("beam", lambda: beam_translate(
                         model, src, beam_size=MT_SRC["beam"],
                         max_len=MT_SRC["decode"]))):
        fn()                                 # warm-up
        times = []
        for _ in range(3):
            registry.reset_counts()          # the main path starts here
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            counts = registry.launch_counts()    # ... and ends here
            mode = _mode_counts()
            if counts["flash_attention"] != cfg.num_encoder_layers or \
                    mode.get("flash_attention") != {
                        "bias": cfg.num_encoder_layers}:
                fail(f"translate {name}: kernel 1 launched "
                     f"{counts['flash_attention']} times "
                     f"({mode.get('flash_attention')}), want "
                     f"{cfg.num_encoder_layers} with the bias row")
            others = {k: c for k, c in counts.items()
                      if c and k != "flash_attention"}
            if others:
                fail(f"translate {name}: other kernels ran: {others}")
            for k, c in counts.items():
                total[k] = total.get(k, 0) + c
            for k, m in mode.items():
                for kk, c in m.items():
                    modes.setdefault(k, {})[kk] = modes.get(k, {}).get(
                        kk, 0) + c
        if out.shape[0] != MT_SRC["batch"] or out.shape[1] > MT_SRC[
                "decode"] or not ((out >= 0) & (out < cfg.trg_vocab_size)
                                  ).all():
            fail(f"translate {name}: output {out.shape} out of range")
        row[f"{name}_ms"] = statistics.median(times)
        log(f"translate {name}: {statistics.median(times):.2f} ms a call "
            f"(median of 3: {[round(x, 2) for x in times]}), "
            f"{out.shape[1]} tokens, kernel 1 {cfg.num_encoder_layers} "
            f"launches a call, all with the bias row")
    log("translate: " + json.dumps(row))
    del model
    return total, modes, row


# ---------------------------------------------------------------------
# phase 36: the served 7B's prefix sharing, speculation, replay,
# migration and generate(); kernel 4's many-row route
# ---------------------------------------------------------------------

# the reference gateway bench's workload at the 7B serving width
# (bench.py:2056-2133): a shared system prompt, per-stream tails, two
# waves (cold, warm), greedy; the target's decoder-layer weights damped
# by 0.15 (not the layer norms) and a one-layer draft sharing the
# target's embeddings, head and first layer
GATEWAY = dict(streams=8, system=1536, tail=(17, 384), new=32, spec_k=4,
               damp=0.15, slots=8, block_size=16, max_len=2048)


def gateway_models(dev):
    """The damped 7B target (bf16 weights from the seed, int8 pools) and
    its one-layer draft, whose embeddings, first layer, final norm and
    head are the target's own modules."""
    from paddle_tpu_torch.text.models import LlamaForCausalLM, llama_7b
    gen = torch.Generator(device=dev).manual_seed(SEED)
    model = LlamaForCausalLM(llama_7b(kv_cache_dtype="int8"), device=dev,
                             dtype="bfloat16", generator=gen)
    model.eval()
    with torch.no_grad():
        for name, p in model.named_parameters():
            if ".layers." in name and "layernorm" not in name:
                p.mul_(GATEWAY["damp"])
    draft = LlamaForCausalLM(
        llama_7b(kv_cache_dtype="int8", num_hidden_layers=1), device=dev,
        dtype="bfloat16", generator=torch.Generator(device=dev).manual_seed(
            SEED + 36))
    draft.eval()
    draft.model.embed_tokens = model.model.embed_tokens
    draft.model.layers[0] = model.model.layers[0]
    draft.model.norm = model.model.norm
    draft.lm_head = model.lm_head
    torch.cuda.synchronize()
    return model, draft


def gateway_prompts(vocab):
    rng = np.random.default_rng(SEED + 36)
    system = rng.integers(1, vocab, GATEWAY["system"]).astype(np.int32)
    lo, hi = GATEWAY["tail"]
    tails = rng.integers(lo, hi + 1, GATEWAY["streams"])
    return [np.concatenate([system, rng.integers(1, vocab, n).astype(
        np.int32)]) for n in tails]


def _gateway_server(model, cfg=None, **kw):
    from paddle_tpu_torch.inference import GenerationServer
    g = cfg or GATEWAY
    return GenerationServer(model, num_slots=g["slots"],
                            block_size=g["block_size"],
                            max_model_len=g["max_len"],
                            request_timeout_s=900.0, **kw)


def gateway_arm(name, model, prompts, cfg=None, **kw):
    """One arm: a fresh server, a cold and a warm wave of the prompts
    (``cfg["new"]`` greedy tokens each; ``cfg`` defaults to
    ``GATEWAY``), the launch counts of the two waves by kernel 4's
    calls, the prefix cache flushed after them."""
    from paddle_tpu_torch.ops.kernels import registry
    cfg = cfg or GATEWAY
    srv = _gateway_server(model, cfg, **kw)
    srv.start()
    waves = []
    registry.reset_counts()                  # the main path starts here
    for w in range(2):
        hit0 = srv.stats()["prefix_hit_tokens"]
        t0 = time.perf_counter()
        streams = [srv.submit(p, max_new_tokens=cfg["new"])
                   for p in prompts]
        outs = [s.result(timeout=900) for s in streams]
        wall = time.perf_counter() - t0
        ttft = sorted(s.ttft_s * 1e3 for s in streams)
        waves.append(dict(outs=outs, wall_s=wall,
                          ttft_ms_median=statistics.median(ttft),
                          ttft_ms_max=ttft[-1],
                          hit_tokens=srv.stats()["prefix_hit_tokens"]
                          - hit0))
    counts = registry.launch_counts()        # ... and ends here
    modes = dict(registry.spec("int8_kv_attention").mode_launches)
    st = srv.stats()
    srv.flush_prefix_cache()
    flushed = srv.stats()
    res = dict(arm=name, waves=waves, counts=counts, modes=modes, stats=st,
               server=srv)
    if flushed["free_blocks"] != flushed["total_blocks"] or \
            flushed["cached_blocks"] or flushed["prefix_entries"]:
        fail(f"phase 36 {name}: after flush_prefix_cache "
             f"{flushed['free_blocks']} of {flushed['total_blocks']} "
             f"blocks free, {flushed['cached_blocks']} cached")
    ds = max(st["decode_steps"], 1)
    log(f"phase 36 {name}: wave 1 TTFT median {waves[0]['ttft_ms_median']:.1f}"
        f" / max {waves[0]['ttft_ms_max']:.1f} ms, wave 2 "
        f"{waves[1]['ttft_ms_median']:.1f} / {waves[1]['ttft_ms_max']:.1f} "
        f"ms; walls {waves[0]['wall_s']:.2f} / {waves[1]['wall_s']:.2f} s; "
        f"{st['prefill_batches']} prefill dispatches, {st['decode_steps']} "
        f"decode or verify steps ({st['decode_ms'] / ds:.2f} ms each), "
        f"{st['draft_steps']} draft steps, accept rate "
        f"{st['spec_accept_rate']:.4f}; prefix hit tokens wave 2 "
        f"{waves[1]['hit_tokens']}, skipped {st['prefill_tokens_skipped']};"
        f" launches flash {counts['flash_attention']}, kernel 4 by route "
        f"{modes}")
    return res


def _first_difference(ref, got):
    for i, (a, b) in enumerate(zip(ref, got)):
        for j, (x, y) in enumerate(zip(a, b)):
            if x != y:
                return i, j
        if len(a) != len(b):
            return i, min(len(a), len(b))
    return None


# the row counts a server issues a projection or the head with: a decode
# step (8 slots), 16, a verify block (8 x 5), and prefills of up to 4
# sequences padded to power-of-two buckets (up to 4 x 2,048)
GEMM_ROWS = (8, 16, 40, 64, 256, 512, 1024, 2048, 4096, 8192)
# the largest logit distance phase 36 (c) accepts between two arms'
# arithmetics at a position both computed from the same tokens: three
# times the largest read over every such position of the eight streams
# (plain / prefix 0.1011, plain / generate() 0.05605, of logits up to
# 5.02; NVIDIA H100 80GB HBM3, 700.00 W).  The prefix and the prefix +
# speculation arms share one arithmetic a position and are held bitwise
LOGIT_DIST_LIMIT = {"plain/prefix": 0.30, "plain/generate": 0.17}


def gemm_rows_follow_m(model):
    """Which of the model's row-wise operations give a row other bits
    when the call has another number of rows or puts the row at another
    index: the first layer's norm, its q, k, v and o projections, the
    MLP's gate, up and down projections, the final norm, the f32 head and
    an RMS norm's f32 mean of squares (the norm's one reduction, seen
    before its bf16 output rounds most differences away), each over the
    ``GEMM_ROWS`` counts, at the first and the last rows of a 2,048-row
    call (rows 0..n and 2,048 - n..2,048), against the same rows of that
    call, issued as they are (the model's other paths) and with the row
    floor (``ROW_FLOOR``) that every server puts under every projection,
    norm and the head.  Returns two {operation: [row counts whose bits
    differ]}."""
    from paddle_tpu_torch.inference.generation_server import ROW_FLOOR
    from paddle_tpu_torch.text.models.llama import _rows
    c, dev = model.config, model.device
    g = torch.Generator(device=dev).manual_seed(SEED + 37)
    x = (torch.randn(max(GEMM_ROWS), c.hidden_size, generator=g,
                     device=dev) * 0.5).to(torch.bfloat16)
    xi = (torch.randn(max(GEMM_ROWS), c.intermediate_size, generator=g,
                      device=dev) * 0.1).to(torch.bfloat16)
    layer = model.model.layers[0]
    att, mlp = layer.self_attn, layer.mlp

    def mean_sq(t):
        t = t.float()
        return torch.mean(t * t, dim=-1, keepdim=True)

    ops = {"input_layernorm": (layer.input_layernorm, x),
           "q_proj": (att.q_proj, x), "k_proj": (att.k_proj, x),
           "v_proj": (att.v_proj, x), "o_proj": (att.o_proj, x),
           "gate_proj": (mlp.gate_proj, x), "up_proj": (mlp.up_proj, x),
           "down_proj": (mlp.down_proj, xi), "norm": (model.model.norm, x),
           "f32 head": (model._logits, x), "rms mean of squares": (mean_sq,
                                                                   x)}
    raw, floored = {}, {}
    with torch.no_grad():
        for name, (fn, inp) in ops.items():
            base = fn(inp[:2048].clone())
            for n in GEMM_ROWS:
                k = min(n, 2048)
                starts = (0,) if n >= 2048 else (0, 2048 - n)
                for r in starts:
                    rows = inp[r:r + n].clone()
                    if not torch.equal(fn(rows)[:k], base[r:r + k]):
                        raw.setdefault(name, []).append(n)
                    if not torch.equal(_rows(fn, rows, ROW_FLOOR)[:k],
                                       base[r:r + k]):
                        floored.setdefault(name, []).append(n)
            del base
    return ({k: sorted(set(v)) for k, v in raw.items()},
            {k: sorted(set(v)) for k, v in floored.items()})


def teacher_forced(model, prompts, streams, family):
    """The f32 logits [n, V] that emit each token of each stream after
    its prompt, teacher-forced through one arm's arithmetic (row j scores
    token j):

    - ``plain``: each prompt prefilled alone by flash attention over its
      own bf16 K/V, padded to its bucket (a plain server's prefill), then
      decode steps through the int8 pools (kernel 4 at S = 1), every
      projection and the head under the row floor;
    - ``prefix``: each prompt through kernel 4 over the int8 pools (a
      prefix server's prefill), then the same decode steps;
    - ``spec``: prompt and stream in one S > 1 forward under the row
      floor (a speculative server computes every position in a verify
      block, and neither kernel 4's rows nor a floored GEMM's depend on
      the call a position lands in);
    - ``generate``: ``generate()``'s dense bf16 cache, one prompt at a
      time.

    The paged decode steps carry every stream at once, one slot each, at
    the serving width (8 slots), so every GEMM has a server's shape."""
    from paddle_tpu_torch.inference.generation_server import ROW_FLOOR
    from paddle_tpu_torch.text.models.llama import _rows
    dev, g = model.device, GATEWAY
    T = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa
    V = model.config.vocab_size
    rows = [[] for _ in prompts]
    with torch.no_grad():
        if family == "generate":
            for p, toks, out in zip(prompts, streams, rows):
                L = len(p)
                caches = model.init_cache(1, L + g["new"])
                lg, caches = model.forward_with_cache(
                    T(p[None]), T(np.arange(L, dtype=np.int32)[None]),
                    caches, last_logits_only=True)
                out.append(lg[0, -1].float())
                for i, t in enumerate(toks[:-1]):
                    lg, caches = model.forward_with_cache(
                        T(np.array([[t]], np.int32)),
                        T(np.array([[L + i]], np.int32)), caches)
                    out.append(lg[0, -1].float())
            return [torch.stack(r) for r in rows]
        bs, B = g["block_size"], g["slots"]
        M = -(-g["max_len"] // bs)
        floor = ROW_FLOOR
        pools = model.init_paged_cache(B * M + 1, bs)
        tbl = np.zeros((B, M), np.int32)
        for s in range(len(prompts)):
            tbl[s] = 1 + s * M + np.arange(M)
        for s, (p, toks) in enumerate(zip(prompts, streams)):
            seq = p if family != "spec" else np.concatenate(
                [p, np.asarray(toks[:-1], np.int32)])
            n = len(seq)
            Lb = min(max(8, 1 << (n - 1).bit_length()), g["max_len"])
            ids = np.zeros((1, Lb), np.int32)
            ids[0, :n] = seq
            pos = np.arange(Lb, dtype=np.int32)[None]
            hidden, _ = model.model.forward_paged(
                T(ids), T(pos), pools, T(tbl[s:s + 1]), T(pos < n),
                verify_mode=family != "plain", min_rows=floor)
            at = np.arange(len(p) - 1, n)
            rows[s].append(_rows(model._logits, hidden[:, T(at)],
                                 floor)[0].float())
        if family != "spec":
            for j in range(max(len(t) for t in streams) - 1):
                tok = np.zeros((B, 1), np.int32)
                pos = np.zeros((B, 1), np.int32)
                wm = np.zeros((B, 1), bool)
                live = [s for s, t in enumerate(streams) if j + 1 < len(t)]
                for s in live:
                    tok[s, 0] = streams[s][j]
                    pos[s, 0] = len(prompts[s]) + j
                    wm[s, 0] = True
                lg, _ = model.forward_paged(T(tok), T(pos), pools, T(tbl),
                                            T(wm), min_rows=floor)
                for s in live:
                    rows[s].append(lg[s, -1:].float())
        del pools
    return [torch.cat(r).reshape(-1, V) for r in rows]


def gateway_streams(model, prompts, arms, gen_outs):
    """Phase 36 (c).  Bitwise where the design makes streams bitwise:
    each arm's warm wave is its cold wave, and the prefix + speculation
    arm's streams are the prefix arm's in every token of both waves
    (kernel 4 gives a row the same bits whatever S, batch or suffix
    start, and under the row floor every server puts under its
    projections and head neither do the GEMMs: checked here at the row
    counts a server issues, and printed without the floor).  Every token
    of every stream of every arm, and of ``generate()``, is the argmax of
    that arm's own arithmetic, teacher-forced (``teacher_forced``): the
    server emits what the model computes; and the prefix and speculation
    arithmetics' teacher-forced logits are bitwise equal.  Across arms
    whose arithmetic differs by design -- flash prefill over the prompt's
    bf16 K/V against the gather over its int8 codes (plain / prefix),
    the dense bf16 cache against the int8 pools (plain /
    ``generate()``) -- the two arithmetics' logits stay within
    ``LOGIT_DIST_LIMIT`` at every position both computed from the same
    tokens (up to and including a stream's first difference, which is
    named with its top-2 margin).  Anything else fails as a fault.
    Returns the differences by design and the prefix and speculation
    arithmetics' teacher-forced logits."""
    raw, floored = gemm_rows_follow_m(model)
    log(f"phase 36 (c): row counts {list(GEMM_ROWS)} against 2,048, "
        f"issued as they are: a row's bits follow the call's rows for "
        f"{raw or 'no operation'}; with the row floor: {floored or 'for none'}")
    if floored:
        fail("phase 36 (c): with the row floor a row's bits still follow "
             f"the call's rows: {floored}")
    for arm in arms:
        a, b = arm["waves"][0]["outs"], arm["waves"][1]["outs"]
        d = _first_difference(a, b)
        if d is not None:
            i, j = d
            fail(f"phase 36 (c): the {arm['arm']} arm's warm stream {i} "
                 f"differs from its cold one at token {j} ({a[i][j]} vs "
                 f"{b[i][j]})")
    log("phase 36 (c): every arm's warm wave is bitwise its cold wave")
    plain, prefix, spec = arms
    for w in range(2):
        d = _first_difference(prefix["waves"][w]["outs"],
                              spec["waves"][w]["outs"])
        if d is not None:
            i, j = d
            fail(f"phase 36 (c): wave {w + 1}'s prefix + speculation stream "
                 f"{i} differs from the prefix arm's at token {j}")
    log("phase 36 (c): the prefix + speculation arm's streams are the "
        "prefix arm's, token for token, in both waves")
    outs = {"plain": plain["waves"][0]["outs"],
            "prefix": prefix["waves"][0]["outs"],
            "spec": spec["waves"][0]["outs"], "generate": gen_outs}
    tf = {}
    for fam, streams in outs.items():
        t0 = time.perf_counter()
        tf[fam] = lg = teacher_forced(model, prompts[:len(streams)],
                                      streams, fam)
        for i, toks in enumerate(streams):
            t = torch.as_tensor(toks, device=lg[i].device)
            got = lg[i].gather(1, t[:, None])[:, 0]
            top = lg[i].max(dim=1)
            bad = (got < top.values).nonzero()
            if bad.numel():
                j = int(bad[0, 0])
                fail(f"phase 36 (c): the {fam} arm's stream {i} emitted "
                     f"{toks[j]} at token {j}, its own arithmetic's argmax"
                     f" is {int(top.indices[j])} (logits "
                     f"{float(got[j]):.6g} vs {float(top.values[j]):.6g})")
        log(f"phase 36 (c): each of the {sum(len(s) for s in streams)} "
            f"tokens of the {fam} streams is the argmax of its own "
            f"arithmetic, teacher-forced ({time.perf_counter() - t0:.1f} s)")
    bad = [i for i, (a, b) in enumerate(zip(tf["prefix"], tf["spec"]))
           if not torch.equal(a, b)]
    if bad:
        i = bad[0]
        fail(f"phase 36 (c): the prefix and speculation arithmetics' "
             f"teacher-forced logits differ in streams {bad}: stream {i} "
             f"by up to {float((tf['prefix'][i] - tf['spec'][i]).abs().max()):.4g}")
    log(f"phase 36 (c): the prefix and speculation arithmetics' teacher-"
        f"forced logits are bitwise equal at all "
        f"{sum(x.shape[0] for x in tf['spec'])} positions")
    found = []
    for fa, fb in (("plain", "prefix"), ("plain", "generate")):
        worst, npos, same = 0.0, 0, 0
        for i, (sa, sb) in enumerate(zip(outs[fa], outs[fb])):
            d = _first_difference([sa], [sb])
            j = d[1] if d else min(len(sa), len(sb))
            upto = min(j + 1, len(sa), len(sb))
            dist = (tf[fa][i][:upto] - tf[fb][i][:upto]).abs().amax(dim=1)
            worst = max(worst, float(dist.max()))
            npos += upto
            if d is None:
                same += 1
                continue
            top = torch.topk(tf[fa][i][j], 2).values
            margin = float(top[0] - top[1])
            log(f"phase 36 (c): {fa} and {fb} streams first differ at "
                f"stream {i} token {j} ({sa[j]} vs {sb[j]}); top-2 logit "
                f"margin there {margin:.4g} under {fa}, the two "
                f"arithmetics' logit distance there {float(dist[j]):.4g} "
                f"(max |logit| {float(tf[fa][i][j].abs().max()):.4g})")
            found.append(dict(pair=f"{fa}/{fb}", stream=i, token=j,
                              margin=margin, distance=float(dist[j])))
        log(f"phase 36 (c): {fa} and {fb}: {same} of "
            f"{min(len(outs[fa]), len(outs[fb]))} streams identical; "
            f"largest logit distance over the {npos} positions both "
            f"computed from the same tokens {worst:.4g} (limit "
            f"{LOGIT_DIST_LIMIT[f'{fa}/{fb}']})")
        if worst > LOGIT_DIST_LIMIT[f"{fa}/{fb}"]:
            fail(f"phase 36 (c): {fa} and {fb} logits {worst:.4g} apart "
                 f"(limit {LOGIT_DIST_LIMIT[f'{fa}/{fb}']})")
    return found, tf["prefix"], tf["spec"]


def self_draft(model, prompts, spec_outs, drafts, targets):
    """Phase 36 (g): the speculative path that emits more than one token
    a verify step.  A prefix + speculation server whose draft is the
    target itself proposes the target's own tokens (a draft step and a
    verify block compute a position alike), so the verify block accepts
    every proposal: accept rate exactly 1.0.  Two waves (cold, warm) of
    the prompts must give the prefix + speculation arm's streams token
    for token, with fewer verify steps than tokens, and a withheld index
    tail
    of at least the last token of every finished stream (the draft never
    consumes it) and at most ``spec_k`` + 3 a stream (the two tokens the
    draft can lag behind the stream into the last verify step, and the
    ``spec_k`` + 1 that step emits)."""
    k = GATEWAY["spec_k"]
    srv = _gateway_server(model, prefix_cache=True, max_prefill_batch=4,
                          draft_model=model, spec_k=k).start()
    waves = []
    try:
        for _ in range(2):
            streams = [srv.submit(p, max_new_tokens=GATEWAY["new"])
                       for p in prompts]
            waves.append([s.result(timeout=900) for s in streams])
        st = srv.stats()
    finally:
        srv.stop()
    n = 2 * len(prompts)
    held = st["spec_index_withheld_tokens"]
    msg = (f"accept rate {st['spec_accept_rate']:.4f} ({st['spec_accepted']}"
           f" of {st['spec_proposed']} proposals), {st['spec_verify_steps']}"
           f" verify steps for {st['tokens_generated']} tokens, "
           f"{st['draft_steps']} draft steps, {held} index tokens withheld "
           f"from {n} streams")
    for w, outs in enumerate(waves):
        d = _first_difference(spec_outs, outs)
        if d is not None:
            fail(f"phase 36 (g): wave {w + 1} of the self-draft server "
                 f"differs from the prefix + speculation arm at stream "
                 f"{d[0]} token {d[1]}; {msg}")
    if not (st["spec_accepted"] > 0 and st["spec_accept_rate"] == 1.0
            and st["spec_verify_steps"] < st["tokens_generated"]
            and n <= held <= n * (k + 3)):
        fail(f"phase 36 (g): {msg}")
    log(f"phase 36 (g): with the target as its own draft: {msg}; both "
        "waves token-identical to the prefix + speculation arm")
    parted = routes_part(spec_outs, drafts, targets)
    unaccepted = st["spec_proposed"] - st["spec_accepted"]
    if parted or unaccepted:
        fail(f"phase 36 (g): {unaccepted} proposals unaccepted, the "
             f"draft's arithmetic parts from the target's at {len(parted)}"
             " positions")
    log("phase 36 (g): no proposal went unaccepted and the draft's "
        "arithmetic parts from the target's at no position")
    return dict(accept_rate=st["spec_accept_rate"],
                verify_steps=st["spec_verify_steps"],
                tokens=st["tokens_generated"], withheld=held,
                unaccepted=unaccepted, parted=parted)


def routes_part(streams, drafts, targets):
    """Phase 36 (g): where a self-draft's proposal could be rejected.
    ``drafts``: the streams teacher-forced through the draft's arithmetic
    (S = 1 steps after a prefix server's prefill: ``teacher_forced``'s
    ``prefix`` family); ``targets``: through the target's (a verify
    block: its ``spec`` family).  Returns every token after the first
    whose draft argmax is not the emitted token, or whose two logit rows
    are not bitwise equal, with the two arithmetics' logit distance
    there; each is logged."""
    parted, n = [], 0
    for i, toks in enumerate(streams):
        dl, tl = drafts[i], targets[i]
        darg = dl.argmax(dim=1).tolist()
        same = (dl == tl).all(dim=1).tolist()
        for j in range(1, len(toks)):
            n += 1
            if darg[j] == toks[j] and same[j]:
                continue
            row = dict(stream=i, token=j, target_token=toks[j],
                       draft_token=darg[j],
                       distance=float((dl[j] - tl[j]).abs().max()))
            parted.append(row)
            log(f"phase 36 (g): stream {i} token {j}: the draft's argmax "
                f"{darg[j]}, the target's {toks[j]}; logit distance "
                f"{row['distance']:.4g}")
    log(f"phase 36 (g): {len(parted)} of the {n} tokens after the first "
        "part the draft's arithmetic from the target's")
    return parted


def rows_bound(args):
    """Kernel 4's many-row route's least time for one call: 4 D flops a
    valid (query row, slot) pair and query head at the bf16 tensor-core
    rate, against the valid tokens' int8 K and V (every kv head) and
    their two f32 scales at the HBM rate."""
    qh, kpool, _, _, _, _, pos, KH = args
    B, S, H, D = qh.shape
    valid_pairs = int((pos.long().clamp(min=0) + 1).sum().item())
    tokens = int((pos.max(dim=1).values.long().clamp(min=0) + 1).sum()
                 .item())
    nbytes = tokens * (KH * D * 2 + 8)
    return bound_ms(4 * D * H * valid_pairs, PEAK_BF16_FLOPS, nbytes)


# kernel 4's many-row route at phase 36 (a)'s shapes in its first design
# (FMA pipe, no ring, no key split; this script's phase 36 (a) on an
# NVIDIA H100 80GB HBM3 at 700.00 W, PERF.md section 6), queued device ms
ROWS_FIRST_DESIGN_MS = {"cold prefill (B 1, S 2048)": 2.6841,
                        "warm suffix (B 4, S 256 from 1536)": 1.9161,
                        "verify (B 8, S 5)": 0.4767}


def rows_other_fold(args, plan):
    """The many-row route on ``args`` with the chunks folded the other
    way than ``plan`` folds them: split over blocks (one chunk a block)
    where the plan runs a row tile's chunks in one block, else in one
    block.  Returns that plan and a function that launches it and
    returns its output."""
    import ctypes
    from paddle_tpu_torch.ops.kernels import _build
    from paddle_tpu_torch.ops.kernels import kv_attention as kva
    qh, kp, vp, ks, vs, tbl, pos, KH = args
    B, S, H, D = qh.shape
    other = kva._rows_plan(
        B, S, H, KH, D, kp.shape[1], tbl.shape[1], kva._sm_count(qh.device),
        plan.q_pieces, chunks_a_block=(1 if plan.chunks_a_block > 1
                                       else plan.chunks))
    lib = _build.load(kva._SOURCE)
    ints = (ctypes.c_int * 7)(*other.launch())
    tbl32 = tbl.to(torch.int32).contiguous()
    pos32 = pos.to(torch.int32).contiguous()
    q = qh.contiguous()
    return other, lambda: kva._rows_cuda(lib, other, ints, q, kp, vp, ks,
                                         vs, tbl32, pos32,
                                         torch.empty_like(q))


def rows_cases(dev):
    """Phase 36 (a): the many-row route at the three 7B shapes -- a cold
    prefill (B 1, S 2,048), a warm suffix (B 4, S 256 from position
    1,536), a verify block (B 8, S 5 at the serving mix's lengths, its
    keys split over blocks) -- within CARD_TOL of the plain version,
    bitwise on a rerun, timed queued beside its bound, its plain
    version and the first design's time (``ROWS_FIRST_DESIGN_MS``); the
    cold call's rows bitwise the warm call's at the positions they
    share.  Each shape also runs with its chunks folded the other way
    (``rows_other_fold``), which must give the same bits, timed beside
    the plan's fold.  (b) S = 1 plans the kernel every S takes: the 7B
    decode's plan is its verify block's."""
    from paddle_tpu_torch.ops.kernels import kv_attention as kva
    from paddle_tpu_torch.ops.kernels.kv_attention import (
        CARD_TOL, int8_paged_attention)
    bf = torch.bfloat16
    warm_args = kv_case(dev, 4, 2048, 32, 32, 128, 16, 128, bf, full=True)
    qh, kp, vp, ks, vs, tbl, pos, KH = warm_args
    shapes = {
        "cold prefill (B 1, S 2048)": (qh[:1].clone(), kp, vp, ks, vs,
                                       tbl[:1].clone(), pos[:1].clone(), KH),
        "warm suffix (B 4, S 256 from 1536)": (
            qh[:, 1536:1792].clone(), kp, vp, ks, vs, tbl,
            pos[:, 1536:1792].clone(), KH),
        "verify (B 8, S 5)": kv_case(
            dev, 8, 5, 32, 32, 128, 16, 128, bf,
            last=[n + 16 for n in SERVING_MIX_LENS]),
    }
    outs, rows = {}, {}
    for label, args in shapes.items():
        plan = kva.int8_kv_plan(*args[0].shape[:3], args[7],
                                args[0].shape[3], 16, args[5].shape[1])
        if plan.route != "rows":
            fail(f"phase 36 (a) {label}: planned route {plan.route}")
        if label.startswith("verify") and \
                plan.chunks_a_block >= plan.chunks:
            fail(f"phase 36 (a) {label}: the plan does not split the keys "
                 f"({plan})")
        got = int8_paged_attention(*args)
        again = int8_paged_attention(*args)
        ref = int8_paged_attention(*args, mode="torch_ref")
        torch.cuda.synchronize()
        err, share = check_close(f"phase 36 (a) {label}", got, ref,
                                 CARD_TOL[bf])
        if not torch.equal(got, again):
            fail(f"phase 36 (a) {label}: a rerun is not bitwise equal")
        del ref
        other, run_other = rows_other_fold(args, plan)
        alt = run_other()
        torch.cuda.synchronize()
        if not torch.equal(got, alt):
            fail(f"phase 36 (a) {label}: {other.chunks_a_block} of "
                 f"{other.chunks} chunks a block does not give the bits of "
                 f"{plan.chunks_a_block} of {plan.chunks}")
        del alt
        ms = queued_ms(lambda: int8_paged_attention(*args))
        other_ms = queued_ms(run_other)
        plain = queued_ms(lambda: int8_paged_attention(*args,
                                                       mode="torch_ref"),
                          iters=3, warmup=1)
        bms, by = rows_bound(args)
        first = ROWS_FIRST_DESIGN_MS[label]
        outs[label] = got
        rows[label] = dict(ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by,
                           max_abs_err=err, other_fold_ms=other_ms)
        log(f"phase 36 (a) int8_kv_attention rows {label}: kernel_ms "
            f"{ms:.4f} plain_ms {plain:.4f} bound_ms {bms:.4f} ({by}; "
            f"kernel / bound {ms / bms:.2f}) library_ms n/a (no single "
            f"PyTorch call); the first design {first} ms (now "
            f"{ms / first:.4f} of it); max_err {err:.3g} ({share:.3g} of "
            f"its limit), bitwise on a rerun; plan {plan.q_tile} rows a "
            f"block ({plan.warps} slabs), {plan.stages} stages, "
            f"{plan.chunks_a_block} of {plan.chunks} chunks a block, grid "
            f"{plan.grid}, {plan.smem_bytes} B; {other.chunks_a_block} "
            f"of {other.chunks} chunks a block instead (grid {other.grid}):"
            f" the same bits in {other_ms:.4f} ms ({other_ms / ms:.3f} of "
            "the plan's)")
        gc.collect()
        torch.cuda.empty_cache()
    cold = outs["cold prefill (B 1, S 2048)"]
    warm = outs["warm suffix (B 4, S 256 from 1536)"]
    if not torch.equal(cold[0, 1536:1792], warm[0]):
        fail("phase 36 (a): the cold prefill's rows at positions "
             "1,536-1,791 are not bitwise the warm suffix's")
    log("phase 36 (a): positions 1,536-1,791 bitwise equal between the "
        "cold prefill (S 2,048) and the warm suffix (S 256)")
    p = kva.int8_kv_plan(8, 1, 32, 32, 128, 16, 128)
    if p.route != "rows" or p != kva.int8_kv_plan(8, 5, 32, 32, 128, 16,
                                                   128):
        fail(f"phase 36 (b): the 7B decode's plan is not its verify "
             f"block's: {p}")
    log("phase 36 (b): S = 1 plans the kernel every S takes (the 7B "
        f"decode's plan {tuple(p)} is its verify block's); phase 3 times "
        "its rows 4")
    return rows


def profile_rows_route(model, draft, prompt):
    """Phase 36 (d)'s device time under the many-row route: a fresh
    prefix + speculation server serves one cold prompt (one prefill
    dispatch of the target and one of the draft, then verify steps)
    under torch.profiler.  Kernel 4's one-slab entries take the verify
    blocks (5 rows a kv head) and the draft's decode steps, its entries of
    more slabs the prefills: device ms a prefill dispatch and a verify
    step with its draft steps, beside the busy device ms of the whole
    request."""
    from torch.profiler import ProfilerActivity, profile
    srv = _gateway_server(model, prefix_cache=True, max_prefill_batch=4,
                          draft_model=draft, spec_k=GATEWAY["spec_k"])
    srv.start()
    # a warm-up request that shares no block with the prompt
    srv.submit(np.full(24, 5, np.int32), max_new_tokens=4).result(
        timeout=900)
    st0 = srv.stats()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        srv.submit(prompt, max_new_tokens=min(
            16, GATEWAY["max_len"] - len(prompt))).result(timeout=900)
        torch.cuda.synchronize()
    st = srv.stats()
    srv.stop()
    kern = device_kernels(prof.key_averages())
    by_slabs, busy = {}, 0.0
    for e in kern:
        busy += e.self_device_time_total / 1e3
        m = (re.search(r"int8_kv_rows<[^,]+, *\d+, *(\d)>", e.key)
             or re.search(r"int8_kv_rows\w*Li\d+ELi(\d)E", e.key))
        if m:
            w = "verify" if m.group(1) == "1" else "prefill"
            ms, n = by_slabs.get(w, (0.0, 0))
            by_slabs[w] = (ms + e.self_device_time_total / 1e3, n + e.count)
    pb = st["prefill_batches"] - st0["prefill_batches"]
    vs = st["spec_verify_steps"] - st0["spec_verify_steps"]
    pre_ms, pre_n = by_slabs.get("prefill", (0.0, 0))
    ver_ms, ver_n = by_slabs.get("verify", (0.0, 0))
    if pb < 1 or vs < 1 or pre_n < pb or ver_n < vs:
        fail(f"phase 36 (d): the profiled request made {pb} prefill "
             f"dispatches and {vs} verify steps, the profile holds "
             f"many-row launches {by_slabs}")
    res = dict(prefill_dispatch_ms=pre_ms / pb, prefill_launches=pre_n,
               verify_step_ms=ver_ms / vs, verify_launches=ver_n,
               prefill_dispatches=pb, verify_steps=vs, busy_ms=busy)
    log(f"phase 36 (d) profile: kernel 4's many-row route "
        f"{pre_ms / pb:.4f} device ms a prefix-server prefill dispatch "
        f"({pre_n} launches over {pb} dispatches of the target and its "
        f"draft, prompt of {len(prompt)} tokens), {ver_ms / vs:.4f} a "
        f"verify step with its draft steps ({ver_n} launches over {vs} "
        f"steps); the request's "
        f"device busy {busy:.2f} ms")
    return res


def gateway(dev):
    """Phase 36: kernel 4's many-row route (a, b); then the damped 7B and
    its draft through three arms (plain; prefix; prefix + speculation),
    generate() on two prompts, a migration and a replay (c-f), and a
    prefix + speculation server whose draft is the target (g)."""
    from paddle_tpu_torch.inference import export_sequence, import_sequence
    rows = rows_cases(dev)
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    model, draft = gateway_models(dev)
    log(f"phase 36: damped llama_7b and its one-layer draft built in "
        f"{time.perf_counter() - t0:.1f} s")
    L = model.config.num_hidden_layers
    prompts = gateway_prompts(model.config.vocab_size)
    log(f"phase 36: {len(prompts)} prompts of "
        f"{sorted(len(p) for p in prompts)} tokens (a {GATEWAY['system']}-"
        f"token system prompt shared)")
    plain = gateway_arm("plain", model, prompts, max_prefill_batch=1)
    srv_a = plain.pop("server")
    # (f) migration and replay against the plain arm, on its server
    ref = plain["waves"][0]["outs"]
    srv_b = _gateway_server(model).start()
    s = srv_a.submit(prompts[0], max_new_tokens=GATEWAY["new"])
    it = iter(s)
    head = [next(it) for _ in range(8)]
    blob = export_sequence(srv_a, s.request_id)
    if blob is None or blob["kv"] is None:
        fail("phase 36 (f): the stream finished or lost its KV before its "
             "export")
    moved = import_sequence(srv_b, blob)
    migrated = blob["generated"] + moved.result(timeout=900)
    cut = 10
    rest = srv_a.submit(prompts[1], max_new_tokens=GATEWAY["new"],
                        replay_tokens=ref[1][:cut]).result(timeout=900)
    if migrated[:8] != head or migrated != ref[0]:
        fail(f"phase 36 (f): the stream exported after {len(blob['generated'])}"
             f" tokens and imported ({blob['n_blocks']} blocks of KV) "
             f"differs from the plain arm's: first difference "
             f"{_first_difference([ref[0]], [migrated])}")
    if ref[1][:cut] + rest != ref[1]:
        fail("phase 36 (f): the stream resubmitted with replay_tokens "
             "differs from the plain arm's")
    log(f"phase 36 (f): a stream exported after {len(blob['generated'])} "
        f"tokens with {blob['n_blocks']} blocks of KV and imported into a "
        "second server, and one resubmitted with 10 replay_tokens, finish "
        "token-identical to the plain arm")
    srv_a.stop()
    srv_b.stop()
    del srv_a, srv_b
    gc.collect()
    torch.cuda.empty_cache()
    prefix = gateway_arm("prefix", model, prompts, prefix_cache=True,
                         max_prefill_batch=4)
    prefix.pop("server").stop()
    spec = gateway_arm("prefix + speculation", model, prompts,
                       prefix_cache=True, max_prefill_batch=4,
                       draft_model=draft, spec_k=GATEWAY["spec_k"])
    spec.pop("server").stop()
    # (d) device time under the many-row route, profiled
    rows_profile = profile_rows_route(model, draft, prompts[0])
    del draft
    gc.collect()
    torch.cuda.empty_cache()
    # generate() on two prompts, one at a time
    gen_outs, gen_ms = [], []
    for p in prompts[:2]:
        t0 = time.perf_counter()
        out = model.generate(torch.from_numpy(p)[None],
                             max_new_tokens=GATEWAY["new"])
        torch.cuda.synchronize()
        gen_ms.append((time.perf_counter() - t0) * 1e3)
        gen_outs.append(out[0, len(p):].tolist())
    log(f"phase 36 generate(): {gen_ms[0]:.1f} / {gen_ms[1]:.1f} ms a call "
        f"(prefill of {len(prompts[0])} / {len(prompts[1])} tokens, 32 "
        "tokens)")
    # (c) token streams
    diffs, tf_prefix, tf_spec = gateway_streams(
        model, prompts, (plain, prefix, spec), gen_outs)
    # (g) every proposal accepted on the card: the target as its own draft
    accepting = self_draft(model, prompts, spec["waves"][0]["outs"],
                           tf_prefix, tf_spec)
    del tf_prefix, tf_spec
    gc.collect()
    torch.cuda.empty_cache()
    # (d) the routes taken, (e) the cache's accounting
    for arm in (plain, prefix, spec):
        st, c, m = arm["stats"], arm["counts"], arm["modes"]
        pb, ds = st["prefill_batches"], st["decode_steps"]
        if arm is plain:
            if c["flash_attention"] < L * pb or m.get("rows", 0) != 0 or \
                    m.get("decode", 0) < L * ds:
                fail(f"phase 36 (d) plain: flash {c['flash_attention']} "
                     f"(>= {L} x {pb}), kernel 4 {m} (rows 0, decode >= "
                     f"{L} x {ds})")
            continue
        if c["flash_attention"] != 0:
            fail(f"phase 36 (d) {arm['arm']}: {c['flash_attention']} flash "
                 "launches (a prefix server prefills through kernel 4)")
        if arm["waves"][1]["hit_tokens"] <= 0:
            fail(f"phase 36 (e) {arm['arm']}: no prefix hit tokens in "
                 "wave 2")
        if arm is prefix:
            need_rows, need_dec = L * pb, L * ds
        else:
            need_rows = L * (pb + st["spec_verify_steps"]) + pb
            need_dec = 1 * st["draft_steps"]
        if m.get("rows", 0) < need_rows or m.get("decode", 0) < need_dec:
            fail(f"phase 36 (d) {arm['arm']}: kernel 4 by route {m}; needs "
                 f"rows >= {need_rows}, decode >= {need_dec}")
    log("phase 36 (d): kernel 4's many-row route took every prefix-server "
        "prefill and every verify block, its S = 1 calls every decode and "
        "draft step; no flash launch on the prefix arms; (e) wave 2 hit "
        "the prefix cache and every block was free after the flush")
    sst = spec["stats"]
    speedup = plain["stats"]["decode_steps"] / max(
        sst["spec_verify_steps"], 1)
    res = dict(
        ttft_ms={a["arm"]: [[w["ttft_ms_median"], w["ttft_ms_max"]]
                            for w in a["waves"]]
                 for a in (plain, prefix, spec)},
        decode_ms_per_step={a["arm"]: a["stats"]["decode_ms"]
                            / max(a["stats"]["decode_steps"], 1)
                            for a in (plain, prefix, spec)},
        accept_rate=sst["spec_accept_rate"],
        target_iteration_speedup=speedup,
        launches_by_route={a["arm"]: a["modes"]
                           for a in (plain, prefix, spec)},
        generate_ms=gen_ms, differences_by_design=diffs,
        self_draft=accepting, rows_route_profile=rows_profile)
    log("phase 36: " + json.dumps(res))
    counts = {k: sum(a["counts"][k] for a in (plain, prefix, spec))
              for k in plain["counts"]}
    modes = {}
    for a in (plain, prefix, spec):
        for k, v in a["modes"].items():
            modes[k] = modes.get(k, 0) + v
    return counts, modes, rows, res, model


# phase 36 (h): the reference gateway bench's own configuration
# (bench.py:2101-2133; the model in paddle_tpu_torch/tools/chaos_gateway
# .py, ``build_model("bench", ...)``): 8 streams of a 24-token system
# prompt and 8-token tails, two waves of 64 new tokens, block size 16,
# max_model_len 96, spec_k 3, the bench's one-layer draft
GATEWAY_BENCH = dict(streams=8, system=24, tail=8, new=64, spec_k=3,
                     slots=8, block_size=16, max_len=96)


def gateway_bench_models(dev):
    """The bench's damped target (``chaos_gateway.build_model("bench")``,
    bf16 weights from the seed, int8 pools) and its one-layer draft,
    whose embeddings, first layer, final norm and head are the target's
    own modules (the bench copies them into the draft)."""
    from paddle_tpu_torch.text.models import LlamaForCausalLM, llama_tiny
    from paddle_tpu_torch.tools import chaos_gateway as cg
    model = cg.build_model("bench", dev, SEED)
    draft = LlamaForCausalLM(
        llama_tiny(**dict(cg.BENCH_MODEL, num_hidden_layers=1)), device=dev,
        dtype="bfloat16", generator=torch.Generator(device=dev).manual_seed(
            SEED + 38))
    draft.eval()
    draft.model.embed_tokens = model.model.embed_tokens
    draft.model.layers[0] = model.model.layers[0]
    draft.model.norm = model.model.norm
    draft.lm_head = model.lm_head
    torch.cuda.synchronize()
    return model, draft


def gateway_bench(dev):
    """Phase 36 (h): the gateway bench's configuration through its three
    arms (plain; prefix; gateway = prefix + speculation with the bench's
    draft), a cold and a warm wave each.  The gateway arm's cold and warm
    streams must be the prefix arm's (``bench.py:2184-2185``); a prefix +
    speculation server whose draft is the target itself must give them
    too and accept exactly 1.0; the accept rate of the bench's draft and
    the target-iteration speedup (plain decode steps / gateway verify
    steps) are printed with the card; and the GEMM row floor is checked
    at this width (``gemm_rows_follow_m``).  Returns the three arms'
    launch counts and kernel 4's launches by call."""
    from paddle_tpu_torch.inference.generation_server import ROW_FLOOR
    g = GATEWAY_BENCH
    t0 = time.perf_counter()
    model, draft = gateway_bench_models(dev)
    V = model.config.vocab_size
    rng = np.random.RandomState(0)
    shared = rng.randint(1, V, (g["system"],)).astype(np.int32)
    prompts = [np.concatenate([shared, rng.randint(1, V, (g["tail"],))
                               .astype(np.int32)])
               for _ in range(g["streams"])]
    log(f"phase 36 (h): the gateway bench's model and draft built in "
        f"{time.perf_counter() - t0:.1f} s; {len(prompts)} prompts of "
        f"{g['system']} + {g['tail']} tokens, {g['new']} new")
    plain = gateway_arm("(h) plain", model, prompts, g, max_prefill_batch=1)
    plain.pop("server").stop()
    prefix = gateway_arm("(h) prefix", model, prompts, g, prefix_cache=True,
                         max_prefill_batch=4)
    prefix.pop("server").stop()
    gw = gateway_arm("(h) gateway", model, prompts, g, prefix_cache=True,
                     max_prefill_batch=4, draft_model=draft,
                     spec_k=g["spec_k"])
    gw.pop("server").stop()
    for w, wave in enumerate(("cold", "warm")):
        d = _first_difference(prefix["waves"][w]["outs"],
                              gw["waves"][w]["outs"])
        if d is not None:
            fail(f"phase 36 (h): the gateway arm's {wave} stream {d[0]} "
                 f"differs from the prefix arm's at token {d[1]}")
    same = sum(a == b for a, b in zip(plain["waves"][0]["outs"],
                                      prefix["waves"][0]["outs"]))
    self_arm = gateway_arm("(h) self-draft", model, prompts, g,
                           prefix_cache=True, max_prefill_batch=4,
                           draft_model=model, spec_k=g["spec_k"])
    self_arm.pop("server").stop()
    sst = self_arm["stats"]
    for w in range(2):
        d = _first_difference(prefix["waves"][w]["outs"],
                              self_arm["waves"][w]["outs"])
        if d is not None:
            fail(f"phase 36 (h): the self-draft server's wave {w + 1} "
                 f"stream {d[0]} differs from the prefix arm's at token "
                 f"{d[1]}")
    if sst["spec_accept_rate"] != 1.0 or not sst["spec_proposed"]:
        fail(f"phase 36 (h): a same-weights draft accepted "
             f"{sst['spec_accepted']} of {sst['spec_proposed']} proposals")
    raw, floored = gemm_rows_follow_m(model)
    log(f"phase 36 (h): row counts {list(GEMM_ROWS)} against 2,048 at "
        f"hidden {model.config.hidden_size}, intermediate "
        f"{model.config.intermediate_size}, vocab {V}: a row's bits follow "
        f"the call's rows for {raw or 'no operation'}; with the row floor "
        f"({ROW_FLOOR}): {floored or 'for none'}")
    if floored:
        fail("phase 36 (h): with the row floor a row's bits still follow "
             f"the call's rows: {floored}")
    gst = gw["stats"]
    speedup = plain["stats"]["decode_steps"] / max(
        gst["spec_verify_steps"], 1)
    log(f"phase 36 (h): {_CARD[0]}: the bench's draft accepts "
        f"{gst['spec_accept_rate']:.4f} ({gst['spec_accepted']} of "
        f"{gst['spec_proposed']}); target-iteration speedup {speedup:.3f} "
        f"({plain['stats']['decode_steps']} plain decode steps / "
        f"{gst['spec_verify_steps']} verify steps); the gateway arm's cold "
        f"and warm streams are the prefix arm's; a same-weights draft "
        f"accepts {sst['spec_accept_rate']:.4f} ({sst['spec_accepted']} of "
        f"{sst['spec_proposed']}); plain and prefix arms' cold streams "
        f"identical in {same} of {len(prompts)} (flash prefill against the "
        "gather, by design)")
    res = dict(accept_rate=gst["spec_accept_rate"],
               target_iteration_speedup=speedup,
               self_draft_accept_rate=sst["spec_accept_rate"],
               ttft_ms={a["arm"]: [[w["ttft_ms_median"], w["ttft_ms_max"]]
                                   for w in a["waves"]]
                        for a in (plain, prefix, gw)},
               tokens_per_s={a["arm"]: 2 * g["streams"] * g["new"] / sum(
                   w["wall_s"] for w in a["waves"])
                   for a in (plain, prefix, gw)})
    log("phase 36 (h): " + json.dumps(res))
    arms = (plain, prefix, gw, self_arm)
    counts = {k: sum(a["counts"][k] for a in arms) for k in plain["counts"]}
    modes = {}
    for a in arms:
        for k, v in a["modes"].items():
            modes[k] = modes.get(k, 0) + v
    del model, draft
    gc.collect()
    torch.cuda.empty_cache()
    return counts, modes


def _wait_tokens(stream, n, timeout_s=300.0):
    deadline = time.monotonic() + timeout_s
    while len(stream.tokens) < n:
        if time.monotonic() > deadline:
            fail(f"phase 37: a stream emitted {len(stream.tokens)} tokens "
                 f"in {timeout_s} s")
        time.sleep(0.005)


def gateway_fleet(dev, model):
    """Phase 37: the served 7B behind ``GatewayRouter`` (see the module
    docstring).  Returns the gateway waves' launch counts and kernel 4's
    launches by call."""
    from paddle_tpu_torch.framework import monitor
    from paddle_tpu_torch.inference import (
        GatewayRouter, GenerationRpcServer, LocalReplica, RemoteReplica,
        ServerOverloaded)
    from paddle_tpu_torch.observability import flight_recorder
    from paddle_tpu_torch.ops.kernels import registry
    from paddle_tpu_torch.tools.chaos_gateway import owner_probe
    g = GATEWAY
    t_phase = time.perf_counter()
    V = model.config.vocab_size
    names = ["r0", "r1", "r2"]
    route_owner = owner_probe(names, g["block_size"], SEED)
    first = gateway_prompts(V)
    owner0 = route_owner(first[0])
    rng = np.random.default_rng(SEED + 37)
    for _ in range(1000):
        sys2 = rng.integers(1, V, g["system"]).astype(np.int32)
        if route_owner(sys2) != owner0:
            break
    else:
        fail("phase 37: no second system prompt routes to another replica")
    lo, hi = g["tail"]
    prompts = first + [np.concatenate([sys2, rng.integers(1, V, n).astype(
        np.int32)]) for n in rng.integers(lo, hi + 1, len(first))]
    kws = [dict(max_new_tokens=g["new"], seed=5000 + i,
                **({"do_sample": True, "temperature": 0.9, "top_k": 8}
                   if i % 2 else {})) for i in range(len(prompts))]
    skw = dict(prefix_cache=True, max_prefill_batch=4, check_replay=True)
    oracle = _gateway_server(model, **skw).start()
    t0 = time.perf_counter()
    ref = [s.result(timeout=900) for s in
           [oracle.submit(p, **kw) for p, kw in zip(prompts, kws)]]
    oracle_s = time.perf_counter() - t0
    oracle.stop()
    del oracle
    gc.collect()
    torch.cuda.empty_cache()
    owners = [route_owner(p) for p in prompts]
    log(f"phase 37: {len(prompts)} streams (8 greedy, 8 seeded sampling) "
        f"of {min(len(p) for p in prompts)}-{max(len(p) for p in prompts)}"
        f" prompt tokens, {g['new']} new; the oracle served them in "
        f"{oracle_s:.2f} s; route owners {collections.Counter(owners)}")

    def check(label, outs):
        d = _first_difference(ref, outs)
        if d is not None:
            fail(f"phase 37 {label}: stream {d[0]} differs from the oracle "
                 f"at token {d[1]}")

    monitor.enable_metrics(True)
    monitor.metrics_reset()
    flight_recorder.clear()
    servers = [_gateway_server(model, **skw).start() for _ in names]
    registry.reset_counts()                  # the main path starts here
    router = GatewayRouter([LocalReplica(n, s) for n, s in
                            zip(names, servers)],
                           block_size=g["block_size"], seed=SEED,
                           request_timeout_s=900.0).start()
    try:
        # (b) a replica killed mid-decode
        t0 = time.perf_counter()
        streams = [router.submit(p, **kw) for p, kw in zip(prompts, kws)]
        _wait_tokens(streams[0], 4)
        router._replicas[owner0].kill()
        outs = [s.result(timeout=900) for s in streams]
        kill_s = time.perf_counter() - t0
        check("(b) kill", outs)
        st = router.stats()
        if st["failovers"] < 1 or monitor.stat_get("gw_failovers") < 1:
            fail(f"phase 37 (b): {st['failovers']} failovers")
        ttft = sorted(s.ttft_s * 1e3 for s in streams)
        fo = monitor.get_histogram("gw_failover_ms")
        if fo is None or fo.count < 1:
            fail("phase 37 (b): no failover time observed")
        log(f"phase 37 (b): {owner0} killed after stream 0's 4th token; "
            f"all {len(streams)} streams token-identical to the oracle in "
            f"{kill_s:.2f} s; {st['failovers']} failovers (gw_failover_ms "
            f"mean {fo.sum / fo.count:.2f} over {fo.count} re-placements, "
            f"median in its buckets {fo.percentile(50):.2f}); TTFT median "
            f"{statistics.median(ttft):.1f} / max {ttft[-1]:.1f} ms; routed "
            f"{st['routed']}")
        # (a) affinity: each stream's first placement is its route owner
        placed = {e["grid"]: e["replica"] for e in flight_recorder.events()
                  if e.get("kind") == "gw.route" and e.get("failovers") == 0}
        ran = [placed.get(i + 1) for i in range(len(prompts))]
        if ran != owners or len(set(ran)) < 2:
            fail(f"phase 37 (a): first placements {ran}, route owners "
                 f"{owners}")
        log(f"phase 37 (a): every stream's first placement is its "
            f"route_owner ({len(set(ran))} replicas took traffic)")
        # (c) a surviving replica drained mid-traffic
        survivors = [n for n in names if n != owner0]
        t0 = time.perf_counter()
        streams = [router.submit(p, **kw) for p, kw in zip(prompts, kws)]
        _wait_tokens(streams[0], 4)
        with router._lock:
            homes = collections.Counter(
                r.replica for r in router._reqs.values() if not r.done)
        victim = max(survivors, key=lambda n: homes.get(n, 0))
        moved = router.drain(victim)
        outs = [s.result(timeout=900) for s in streams]
        drain_s = time.perf_counter() - t0
        check("(c) drain", outs)
        st = router.stats()
        if st["migrated"] < 1 or monitor.stat_get("gw_migrated_seqs") < 1:
            fail(f"phase 37 (c): drain({victim}) migrated {st['migrated']}")
        ttft2 = sorted(s.ttft_s * 1e3 for s in streams)
        log(f"phase 37 (c): drain({victim}) mid-traffic moved {moved} live "
            f"sequences ({st['migrated']} migrated); all streams "
            f"token-identical to the oracle in {drain_s:.2f} s; TTFT median "
            f"{statistics.median(ttft2):.1f} / max {ttft2[-1]:.1f} ms")
    finally:
        router.stop()
    counts = registry.launch_counts()        # ... and ends here
    modes = dict(registry.spec("int8_kv_attention").mode_launches)
    log(f"phase 37: kernel 4's launches by call over waves (b) and (c): "
        f"{modes}; flash {counts['flash_attention']}")
    live = next(s for n, s in zip(names, servers)
                if n not in (owner0, victim))
    # (d) typed sheds: a tenant over its budget, then deadline order
    short = prompts[0][:64]
    r2 = GatewayRouter([LocalReplica("s", live, owns_server=False)],
                       block_size=g["block_size"], seed=SEED,
                       tenant_budgets={"t": 100}, max_pending=1,
                       request_timeout_s=900.0).start()
    try:
        a = r2.submit(short, max_new_tokens=8, tenant="t", timeout_s=300.0)
        try:
            r2.submit(short, max_new_tokens=8, tenant="t")
            fail("phase 37 (d): a tenant over its budget was not shed")
        except ServerOverloaded:
            pass
        b = r2.submit(short, max_new_tokens=8, timeout_s=60.0)
        try:
            a.result(timeout=300)
            fail("phase 37 (d): the slacker request kept its slot")
        except ServerOverloaded:
            pass
        b.result(timeout=300)
        sheds = r2.stats()["sheds"]
        if sheds.get("tenant_budget") != 1 or sheds.get("pressure") != 1:
            fail(f"phase 37 (d): sheds {sheds}")
    finally:
        r2.stop()
    log(f"phase 37 (d): the tenant budget and the deadline-ordered shed "
        f"raised ServerOverloaded ({sheds})")
    # (e) a replica over loopback RPC
    rpc = GenerationRpcServer(live)
    r3 = GatewayRouter([RemoteReplica("w", "127.0.0.1", rpc.port,
                                      rpc_timeout=900.0)],
                       block_size=g["block_size"], seed=SEED,
                       request_timeout_s=900.0).start()
    try:
        sub = list(range(0, len(prompts), 4))
        outs = [s.result(timeout=900) for s in
                [r3.submit(prompts[i], **kws[i]) for i in sub]]
        if outs != [ref[i] for i in sub]:
            fail("phase 37 (e): the RPC replica's streams differ from the "
                 "oracle's")
    finally:
        r3.stop()
        rpc.stop()
    log(f"phase 37 (e): {len(sub)} streams through a GenerationRpcServer "
        "on loopback and a RemoteReplica token-identical to the oracle")
    for srv in servers:
        srv.stop()
    del servers, live
    monitor.enable_metrics(False)
    gc.collect()
    torch.cuda.empty_cache()
    # (f) the chaos tool at the gateway bench's configuration
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.tools.chaos_gateway",
         "--config", "bench", "--device", "cuda", "--timeout", "300"],
        capture_output=True, text=True, timeout=900)
    for line in out.stdout.strip().splitlines():
        log("  chaos_gateway: " + line)
    if out.returncode:
        log(out.stderr[-4000:])
        fail(f"phase 37 (f): chaos_gateway --config bench exited "
             f"{out.returncode}")
    log(f"phase 37 (f): python -m paddle_tpu_torch.tools.chaos_gateway "
        f"--config bench exited 0 in {time.perf_counter() - t0:.1f} s; "
        f"phase 37 {time.perf_counter() - t_phase:.1f} s")
    return counts, {"int8_kv_attention": modes}


# ---------------------------------------------------------------------
# phases 38-39: the geo-replicated online loop, the tiered table
# ---------------------------------------------------------------------

# phase 38: the geo pushers' links (the port's ps_site tool uses the
# same), the chaos run's kill batch and its seeded lossy geo plan (the
# reference acceptance's, tests/test_online_loop.py:291)
GEO_CLIENT = dict(connect_timeout=2.0, rpc_timeout=2.0, max_retries=8,
                  backoff_base=0.02, rpc_deadline=30.0)
GEO_KILL_AT = 8
GEO_CHAOS = ("seed=13;delay:push_delta:first=1:every=3:times=0:arg=0.002;"
             "drop:push_delta_reply:first=2:every=4:times=0;"
             "cut:push_delta:first=9:every=13:times=0")
GEO_DRAIN_S = 60.0
GEO_READ_MAX_LAG = 64


def _free_ports(n):
    """``n`` loopback ports free at the time of the call (a replica group
    lists its members' ports before they start)."""
    import socket
    socks = []
    for _ in range(n):
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        socks.append(s)
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


class _SiteProc:
    """One ``python -m paddle_tpu_torch.tools.ps_site`` server: its first
    stdout line (port, pid, role, site), then one JSON command a line.
    Its stderr goes to a file beside the phase's tables, logged on a
    failure."""

    def __init__(self, label, env, args, logdir):
        self.label = label
        full = dict(os.environ)
        full.pop("PADDLE_CHAOS", None)
        full.update(env)
        self._err = open(os.path.join(logdir, f"{label}.err"), "w")
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "paddle_tpu_torch.tools.ps_site", *args],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=self._err,
            text=True, env=full, cwd=str(pathlib.Path(__file__).parent))
        self.info = None

    def _line(self, timeout):
        import select
        ready, _, _ = select.select([self.proc.stdout], [], [], timeout)
        line = self.proc.stdout.readline() if ready else ""
        if not line:
            self._err.flush()
            with open(self._err.name) as f:
                log(f"{self.label} stderr: {f.read()[-3000:]}")
            fail(f"phase 38: ps_site {self.label} gave no answer within "
                 f"{timeout:.0f} s (exit code {self.proc.poll()})")
        return json.loads(line)

    def ready(self, timeout=120.0):
        self.info = self._line(timeout)
        return self

    def ask(self, cmd, wait=120.0, **fields):
        self.proc.stdin.write(json.dumps({"cmd": cmd, **fields}) + "\n")
        self.proc.stdin.flush()
        reply = self._line(wait)
        if "error" in reply:
            fail(f"phase 38: ps_site {self.label} {cmd}: {reply['error']}")
        return reply

    def stop(self):
        """Stop the server, and kill it if it does not exit in 10 s."""
        try:
            if self.proc.poll() is None:
                self.proc.stdin.write(json.dumps({"cmd": "stop"}) + "\n")
                self.proc.stdin.flush()
                self.proc.wait(timeout=10)
        except (OSError, ValueError, subprocess.TimeoutExpired):
            pass
        finally:
            if self.proc.poll() is None:
                self.proc.kill()
                self.proc.wait(timeout=10)
            self._err.close()


def _geo_table(policy):
    from paddle_tpu_torch.distributed.fleet import SparseTable
    return SparseTable(WIDE_DEEP["dim"], optimizer="sgd", lr=0.05,
                       geo_policy=policy)


def _geo_site_b(root, peer, policy, procs, chaos=None, interval=0.05):
    """Site b: a primary (with its sweeper and, unless ``peer`` is None,
    its geo pusher to ``peer``) and a hot standby started through
    ``fleet.init`` /
    ``init_server`` / ``run_server`` from a ``PaddleCloudRoleMaker``
    environment, and a read replica of their group, each a ps_site
    subprocess (appended to ``procs`` as it starts).  Returns the
    group."""
    tdir = os.path.join(root, f"tables_{policy}")
    if not os.path.isdir(tdir):
        os.makedirs(tdir)
        _geo_table(policy).save(os.path.join(tdir, "emb"))
    p1, p2, p3 = _free_ports(3)
    group = f"127.0.0.1:{p1}|127.0.0.1:{p2}"
    env = {"TRAINING_ROLE": "PSERVER", "POD_IP": "127.0.0.1",
           "PADDLE_PSERVERS_IP_PORT_LIST": group, "PADDLE_TRAINERS_NUM": "1"}
    prim_env = {**env, "PADDLE_PORT": str(p1)}
    if chaos:
        prim_env["PADDLE_CHAOS"] = chaos
    n = len(procs)
    geo = [] if peer is None else ["--geo-peer", peer, "--geo-interval",
                                   str(interval)]
    procs.append(_SiteProc(f"b{n}_primary", prim_env, [
        "--tables", tdir, "--ttl", "3600", "--site", "b", *geo], root))
    procs.append(_SiteProc(f"b{n}_standby", {**env, "PADDLE_PORT": str(p2)},
                           ["--tables", tdir], root))
    procs.append(_SiteProc(f"b{n}_read", {"PADDLE_PORT": str(p3)},
                           ["--tables", tdir, "--read-replica-of", group],
                           root))
    for p in procs[n:]:
        p.ready()
    return group


def _geo_site_a(policy, primary_port=None, standby_port=0):
    """Site a in this process: a primary (``geo_site="a"``, unless
    ``primary_port`` names a primary running elsewhere), its hot standby
    and a read replica of the group.  Returns (primary or None, standby,
    replica, group)."""
    from paddle_tpu_torch.distributed.fleet import PSServer
    prim = None
    if primary_port is None:
        prim = PSServer({"emb": _geo_table(policy)}, host="127.0.0.1",
                        geo_site="a")
        prim.start()
        primary_port = prim.port
    pep = f"127.0.0.1:{primary_port}"
    stby = PSServer({"emb": _geo_table(policy)}, host="127.0.0.1",
                    port=standby_port, replica_of=pep, geo_site="a")
    stby.start()
    group = f"{pep}|127.0.0.1:{stby.port}"
    rep = PSServer({"emb": _geo_table(policy)}, host="127.0.0.1",
                   replica_of=group, replica_mode="read", wm_interval_s=0.05)
    rep.start()
    for r in (stby, rep):
        if not r.replica_ready.wait(60.0):
            fail("phase 38: a replica of site a never attached")
    return prim, stby, rep, group


@contextlib.contextmanager
def _environ(**env):
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _fleet_trainer_client(group):
    """Site b's trainer reaches its servers as a user's trainer does:
    ``fleet.init()`` over the launcher's environment, then
    ``fleet.init_worker()``."""
    from paddle_tpu_torch.distributed import fleet
    with _environ(TRAINING_ROLE="TRAINER", PADDLE_TRAINER_ID="0",
                  PADDLE_TRAINERS_NUM="1",
                  PADDLE_PSERVERS_IP_PORT_LIST=group):
        fleet.init()
        return fleet.init_worker()


def _geo_trainer(dev, params, batches, cli, src, timers=None, step=None):
    """A streaming trainer of the online phases on the card, timed from
    its first timed batch (the third): returns (trainer, tower, window)."""
    from paddle_tpu_torch.online import StreamingTrainer
    tower = WideDeepTower(params, dev)
    loader, _ = _online_loader(batches)
    inner = (step or _online_step)(tower, timers)
    window, calls = {}, [0]

    def timed(batch, pull):
        calls[0] += 1
        if calls[0] == 3:
            torch.cuda.synchronize()
            window["t0"] = time.perf_counter()
        return inner(batch, pull)

    tr = StreamingTrainer(loader, cli, "emb", timed, device_merge=True,
                          device=dev, src=src)
    return tr, tower, window


def _run_both(trainers):
    """Both sites' trainers at once, each on its own thread; re-raises
    the first failure."""
    import threading
    errs = []

    def run(tr):
        try:
            tr.run()
        except BaseException as e:   # noqa: BLE001 - re-raised below
            errs.append(e)
    ts = [threading.Thread(target=run, args=(tr,)) for tr in trainers]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=600)
    torch.cuda.synchronize()
    if errs:
        raise errs[0]
    if any(t.is_alive() for t in ts):
        fail("phase 38: a site's trainer did not finish in 600 s")


def _replica_caught_up(rep, prim_applied, timeout=30.0):
    return _wait_for(lambda: rep._stats()["watermark"] >= prim_applied,
                     timeout)


def _b_digests(procs, n0):
    """(primary, standby, read replica) digests of site b's servers
    ``procs[n0:n0 + 3]``, once the replicas hold the primary's state
    (bounded wait)."""
    deadline = time.monotonic() + 30.0
    while True:
        d = [p.ask("digest") for p in procs[n0:n0 + 3]]
        full = [x["tables"]["emb"]["full"] for x in d]
        if full[1] == full[0] == full[2] or time.monotonic() > deadline:
            return d
        time.sleep(0.1)


def _drain_sites(gp_a, proc_b, rounds=6):
    """Drain both pushers in turns until a round moves nothing (the
    authority's residual verify pass included), each drain bounded by
    ``GEO_DRAIN_S``.  Returns (site b's last drain reply, ids moved a
    round as (a -> b, b -> a))."""
    moved, last_b = [], 0
    for _ in range(rounds):
        before = gp_a.pushed_ids + gp_a.corrected_ids
        gp_a.drain(timeout=GEO_DRAIN_S)
        rb = proc_b.ask("drain", wait=GEO_DRAIN_S + 30, timeout=GEO_DRAIN_S)
        b_now = rb["pushed_ids"] + rb["corrected_ids"]
        moved.append((gp_a.pushed_ids + gp_a.corrected_ids - before,
                      b_now - last_b))
        last_b = b_now
        if moved[-1] == (0, 0) and gp_a.backlog() == 0 and \
                rb["backlog"] == 0:
            break
    return rb, moved


def geo_online(dev, params, batches):
    """Phase 38: the geo-replicated online loop at full width (the
    reference's ``_bench_online`` geo half and its acceptance test).  Two
    sites: site a in this process (a primary with ``geo_site="a"``, its
    hot standby and a read replica), site b as ps_site subprocesses (a
    primary and a standby through ``fleet.init`` / ``init_server`` /
    ``run_server`` from a ``PaddleCloudRoleMaker`` environment, and a
    read replica); each site a ``SparseTable(16, sgd, lr=0.05)``, a
    ``FeatureLifecycle`` sweeper and a ``FreshnessWatch``.  Site a's
    trainer streams phase 13's 22 batches, site b's (a client from
    ``fleet.init_worker()``) 22 batches of the same generator under seed
    1, both ``StreamingTrainer(device_merge=True)`` on the card with
    phase 13's tower, both at once; a ``GeoPusher`` runs each way
    (additive).  (a) 44 launches of ``segment_sum_sorted``, no plain
    call; (b) after both pushers drain the primaries' values are bitwise
    equal and each replica bitwise its primary; (e) freshness at each
    site's replica and every ``FreshnessWatch`` objective ok; the host
    ms of pull, dense step, merge and push.  Then (c) the chaos
    acceptance and (d) last-writer-wins (``_geo_chaos``, ``_geo_lww``).
    Returns (the launch counts of (a), results)."""
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.fleet import GeoPusher, PSClient
    from paddle_tpu_torch.framework import monitor
    from paddle_tpu_torch.online import FeatureLifecycle, FreshnessWatch
    from paddle_tpu_torch.ops.kernels import registry
    from paddle_tpu_torch.tools.ps_site import table_digest
    t_phase = time.perf_counter()
    W = WIDE_DEEP
    b_batches = wide_deep_data(seed=1)[1]
    root = tempfile.mkdtemp(prefix="geo_sites_")
    procs, res = [], {}
    prim = stby = rep = gp = sweeper = handle = cli_a = None
    try:
        monitor.enable_metrics(True)
        monitor.metrics_reset()
        prim, stby, rep, group_a = _geo_site_a("add")
        group_b = _geo_site_b(root, group_a, "add", procs)
        log(f"phase 38: site a {group_a} (this process), site b {group_b} "
            f"(ps_site: {[p.info['role'] for p in procs]}, site "
            f"{procs[0].info['site']!r}) up in "
            f"{time.perf_counter() - t_phase:.1f} s")
        sweeper = FeatureLifecycle(prim, ttl_s=3600.0, interval_s=0.25).start()
        watch = FreshnessWatch()
        handle = watch.run_every(0.25)
        gp = GeoPusher(prim, [group_b], interval_s=0.05,
                       **GEO_CLIENT).start()
        cli_a = PSClient([group_a])
        cli_b = _fleet_trainer_client(group_b)
        timers = dict.fromkeys(("pull RPC", "dense step", "merge",
                                "push RPC"), 0.0)
        tr_a, tower_a, win_a = _geo_trainer(dev, params, batches, cli_a,
                                            "stream-a", timers)
        tr_b, tower_b, win_b = _geo_trainer(dev, params, b_batches, cli_b,
                                            "stream-b")
        _time_parts(tr_a, cli_a, timers)
        registry.reset_counts()              # the main path starts here
        _run_both([tr_a, tr_b])
        t_end = time.perf_counter()
        counts = registry.launch_counts()    # ... and ends here
        plain = {k: s.torch_ref_calls for k, s in registry.kernels().items()}
        fleet.stop_worker()
        n = tr_a.batches
        if (tr_a.batches, tr_b.batches) != (22, 22):
            fail(f"phase 38: batches a {tr_a.batches}, b {tr_b.batches}")
        want = dict.fromkeys(counts, 0)
        want["segment_sum_sorted"] = 44       # one merge a batch, each site
        if counts != want or plain["segment_sum_sorted"] or \
                plain["segment_sum"]:
            fail(f"phase 38 (a): launches {counts} (want {want}), plain "
                 f"calls {plain}")
        log("phase 38 (a): segment_sum_sorted launched 44 times (22 "
            "batches a site, one merge each), no plain call")
        losses = [t.fetch() for t in (tower_a, tower_b)]
        for s, l in zip("ab", losses):
            if not np.isfinite(l).all() or not l[-1] < l[2]:
                fail(f"phase 38: site {s}'s losses {l.tolist()}")
        # (b) the additive fixed point
        t0 = time.perf_counter()
        rb, moved = _drain_sites(gp, procs[0])
        drain_s = time.perf_counter() - t0
        if not _replica_caught_up(rep, prim.applied) or \
                not _replica_caught_up(stby, prim.applied):
            fail("phase 38 (b): site a's replicas never caught up")
        t_a = prim._tables["emb"]
        da = (table_digest(t_a, False), table_digest(t_a, True))
        for r, name in ((stby, "standby"), (rep, "read replica")):
            if table_digest(r._tables["emb"], True) != da[1]:
                fail(f"phase 38 (b): site a's {name} is not bitwise its "
                     "primary")
        db = _b_digests(procs, 0)
        fb = [x["tables"]["emb"] for x in db]
        if not fb[0]["full"] == fb[1]["full"] == fb[2]["full"]:
            fail("phase 38 (b): a replica of site b is not bitwise its "
                 "primary")
        if fb[0]["vals"] != da[0]:
            fail(f"phase 38 (b): the primaries' tables differ after the "
                 f"drains (a {len(t_a)} rows, b {fb[0]['rows']}; drains "
                 f"moved {moved})")
        log(f"phase 38 (b): after {len(moved)} drain rounds ({drain_s:.2f} "
            f"s; ids moved a->b, b->a: {moved}) both primaries hold the "
            f"same {len(t_a)} rows bitwise, each replica bitwise its "
            f"primary; pusher a pushed {gp.pushed_ids} ids in "
            f"{gp.flushes} flushes, {gp.push_failures} failures; pusher b "
            f"{rb}")
        # (e) freshness and the host parts
        handle.stop()
        handle = None
        st_a = watch.evaluate()
        h = monitor.get_histogram("ps_freshness_ms")
        fr_b = procs[2].ask("freshness")
        ev = 20 * W["batch"] * W["n_slots"]
        res = dict(
            events_per_s={"a": ev / (t_end - win_a["t0"]),
                          "b": ev / (t_end - win_b["t0"])},
            freshness_a=dict(p50_ms=h.percentile(50), p99_ms=h.percentile(99),
                             count=h.count),
            freshness_b={k: fr_b[k] for k in ("p50_ms", "p99_ms", "count")},
            objectives_a={s["slo"]: s["ok"] for s in st_a},
            objectives_b=fr_b["objectives"], breaches_a=watch.breaches,
            host_ms={k: v / n for k, v in timers.items()},
            rows=len(t_a), drain_s=drain_s, launches=counts)
        log("phase 38 (e): " + json.dumps(res))
        if not all(res["objectives_a"].values()) or \
                not all(res["objectives_b"].values()):
            fail(f"phase 38 (e): a freshness objective is not ok at "
                 f"steady state: a {res['objectives_a']}, b "
                 f"{res['objectives_b']}")
        if h.count < n or fr_b["count"] < n:
            fail(f"phase 38 (e): ps_freshness_ms counted {h.count} (a), "
                 f"{fr_b['count']} (b) of {n} batches a site")
        for name, ms in res["host_ms"].items():
            log(f"  host {name}: {ms:.2f} ms/batch (site a)")
    finally:
        if handle is not None:
            handle.stop()
        if gp is not None:
            gp.stop(drain=False)
        if sweeper is not None:
            sweeper.stop()
        if cli_a is not None:
            cli_a.close()
        fleet.stop_worker()
        monitor.enable_metrics(False)
        for p in procs:
            p.stop()
        for s in (rep, stby, prim):
            if s is not None:
                s.stop()
    try:
        res["chaos"] = _geo_chaos(dev, params, batches, root)
        res["lww"] = _geo_lww(dev, params, batches, b_batches, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log(f"phase 38: {time.perf_counter() - t_phase:.1f} s")
    return counts, res


def _geo_chaos(dev, params, batches, root):
    """Phase 38 (c): the reference's chaos acceptance at full width.  Site
    a's primary is a ps_site subprocess, SIGKILLed before batch
    ``GEO_KILL_AT``; its in-process standby promotes, a read replica
    serves bounded reads (``max_lag``) throughout, and the one geo pusher
    (a -> b, as in the reference) rides the standby under ``GEO_CHAOS``
    (delays and cuts on its sends here, dropped replies at site b's
    primary, where the same plan is installed).  Integer-valued
    gradients (the sign of the tower's) make a numpy replay of every
    acknowledged push on the initial rows exact:
    both sites must hold it bitwise (zero lost, zero double-applied rows),
    the standby must have applied each batch once, and no read failed."""
    import signal
    import threading

    from paddle_tpu_torch.distributed.fleet import (GeoPusher, PSClient,
                                                    SparseTable, chaos)
    t0 = time.perf_counter()
    tdir = os.path.join(root, "tables_add")
    pa, pb = _free_ports(2)
    procs, gp, stby, rep, cli, rd_err = [], None, None, None, None, []
    stop = threading.Event()
    try:
        procs.append(_SiteProc("a_primary", {
            "TRAINING_ROLE": "PSERVER", "POD_IP": "127.0.0.1",
            "PADDLE_PORT": str(pa), "PADDLE_TRAINERS_NUM": "1",
            "PADDLE_PSERVERS_IP_PORT_LIST":
                f"127.0.0.1:{pa}|127.0.0.1:{pb}"},
            ["--tables", tdir, "--site", "a"], root).ready())
        _, stby, rep, group_a = _geo_site_a("add", primary_port=pa,
                                            standby_port=pb)
        # one pusher, a -> b, as in the reference's acceptance: site b has
        # no local writes (a pusher there would run the authority's
        # verify pass against rows site a has not shipped yet)
        group_b = _geo_site_b(root, None, "add", procs, chaos=GEO_CHAOS)
        chaos.install(chaos.plan_from_spec(GEO_CHAOS))
        gp = GeoPusher(stby, [group_b], interval_s=0.02,
                       **GEO_CLIENT).start()
        probe = np.unique(batches[0][0].reshape(-1))[:4096]
        reads = [0]

        def reader():
            rd = PSClient([group_a], mode="read", max_lag=GEO_READ_MAX_LAG,
                          read_replicas=[f"127.0.0.1:{rep.port}"],
                          **GEO_CLIENT)
            try:
                while not stop.is_set():
                    rd.pull("emb", probe)
                    reads[0] += 1
                    time.sleep(0.002)
            except Exception as e:   # noqa: BLE001 - reported below
                rd_err.append(repr(e))
            finally:
                rd.close()
        rth = threading.Thread(target=reader, daemon=True)
        rth.start()
        cli = PSClient([group_a], **GEO_CLIENT)
        acked = []
        push = cli.push_stamped

        def recorded(table, ids, grads, **kw):
            out = push(table, ids, grads, **kw)
            acked.append((np.array(ids, np.int64), np.array(grads)))
            return out
        cli.push_stamped = recorded
        calls = [0]

        def step(tower, timers=None):
            inner = _online_step(tower, timers)

            def int_step(batch, pull):
                calls[0] += 1
                if calls[0] == GEO_KILL_AT:
                    os.kill(procs[0].proc.pid, signal.SIGKILL)
                    procs[0].proc.wait(timeout=30)
                ids, g = inner(batch, pull)
                return ids, torch.sign(g)
            return int_step
        tr, _, _ = _geo_trainer(dev, params, batches, cli, "stream-chaos",
                                step=step)
        tr.run()
        torch.cuda.synchronize()
        if not _wait_for(lambda: stby.promoted, 30.0):
            fail("phase 38 (c): site a's standby never promoted")
        if not _replica_caught_up(rep, stby.applied):
            fail("phase 38 (c): site a's read replica never caught up")
        stop.set()
        rth.join(timeout=30)
        gp.drain(timeout=GEO_DRAIN_S)
        st = chaos.active().stats_dict()
        chaos.uninstall()
        # the oracle: the initial rows plus every acknowledged push, in
        # the native core's arithmetic (v -= lr * g, float32, unfused)
        every = np.unique(np.concatenate([b[0].reshape(-1)
                                          for b in batches]))
        rows = SparseTable(WIDE_DEEP["dim"], optimizer="sgd",
                           lr=0.05).pull(every)
        for ids, g in acked:
            k = np.searchsorted(every, ids)
            rows[k] = rows[k] - np.float32(0.05) * g
        got_a = stby._tables["emb"].pull(every)
        # a row whose delta was never non-zero was never shipped: site
        # b's pull materialises it from the same seeded init
        cli_b = PSClient([group_b], **GEO_CLIENT)
        got_b = cli_b.pull("emb", every)
        cli_b.close()
        dig = procs[1].ask("digest")
        bad_a = int(np.any(got_a != rows, axis=1).sum())
        bad_b = int(np.any(got_b != rows, axis=1).sum())
        out = dict(batches=tr.batches, acked=len(acked),
                   standby_applied=stby.applied, promoted=stby.promoted,
                   reads=reads[0], read_errors=len(rd_err),
                   rows=int(every.size), rows_off_a=bad_a, rows_off_b=bad_b,
                   dup_acks_b=dig["dup_acks"], dup_acks_a=stby.dup_acks,
                   faults=st, pushed_ids=gp.pushed_ids,
                   push_failures=gp.push_failures,
                   seconds=time.perf_counter() - t0)
        log("phase 38 (c): " + json.dumps(out))
        if rd_err:
            fail(f"phase 38 (c): bounded reads failed: {rd_err[:3]}")
        if tr.batches != 22 or len(acked) != 22 or stby.applied != 22:
            fail(f"phase 38 (c): {tr.batches} batches, {len(acked)} acked, "
                 f"the promoted standby applied {stby.applied}; want 22")
        if bad_a or bad_b:
            fail(f"phase 38 (c): rows off the exact oracle: site a "
                 f"{bad_a}, site b {bad_b} of {every.size}")
        if not any(k.startswith(("drop", "delay", "cut")) for k in st) or \
                dig["dup_acks"] < 1:
            fail(f"phase 38 (c): the link was not hostile enough: faults "
                 f"{st}, site b's duplicate acks {dig['dup_acks']}")
        log(f"phase 38 (c): primary SIGKILLed before batch {GEO_KILL_AT}; "
            f"22 batches, 0 lost and 0 double-applied rows of "
            f"{every.size} at both sites against the exact oracle; "
            f"{reads[0]} bounded reads, none failed; site b deduplicated "
            f"{dig['dup_acks']} retried frames")
        return out
    finally:
        stop.set()
        chaos.uninstall()
        if gp is not None:
            gp.stop(drain=False)
        if cli is not None:
            cli.close()
        for p in procs:
            p.stop()
        for s in (rep, stby):
            if s is not None:
                s.stop()


def _geo_lww(dev, params, batches, b_batches, root):
    """Phase 38 (d): the two sites under ``geo_policy="lww"``.  Both
    trainers stream with the pushers idle; the oracle takes each id's
    row from the site whose ``(lamport seq, site)`` stamp is greater;
    then both pushers drain and both sites (and their replicas) must
    hold the oracle's rows and stamps bitwise."""
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.fleet import GeoPusher, PSClient
    from paddle_tpu_torch.tools.ps_site import table_digest
    t0 = time.perf_counter()
    procs, gp, prim, stby, rep, cli_a = [], None, None, None, None, None
    try:
        prim, stby, rep, group_a = _geo_site_a("lww")
        group_b = _geo_site_b(root, group_a, "lww", procs, interval=3600.0)
        gp = GeoPusher(prim, [group_b], interval_s=3600.0, **GEO_CLIENT)
        cli_a = PSClient([group_a])
        cli_b = _fleet_trainer_client(group_b)
        tr_a, _, _ = _geo_trainer(dev, params, batches, cli_a, "lww-a")
        tr_b, _, _ = _geo_trainer(dev, params, b_batches, cli_b, "lww-b")
        _run_both([tr_a, tr_b])
        fleet.stop_worker()

        def state(site):
            if site == "a":
                t = prim._tables["emb"]
                d = t._snapshot_arrays()
                gi, gs, gsi = t.geo_export()
                st = {int(k): (int(s), prim._site_name(int(x)))
                      for k, s, x in zip(gi, gs, gsi)}
                return d["ids"], d["vals"], st
            path = os.path.join(root, f"lww_b_{time.monotonic_ns()}.npz")
            procs[0].ask("dump", path=path)
            with np.load(path) as d:
                st = {int(k): (int(s), str(x)) for k, s, x in zip(
                    d["emb.geo_ids"], d["emb.geo_seqs"], d["emb.geo_sites"])}
                return d["emb.ids"], d["emb.vals"], st

        before = {s: state(s) for s in "ab"}
        rows, stamps = {}, {}
        for s in "ab":
            ids, vals, st = before[s]
            for k, v in zip(ids.tolist(), vals):
                cand = st.get(k, (-1, ""))
                if k not in stamps or cand > stamps[k]:
                    rows[k], stamps[k] = v, cand
        rb, moved = _drain_sites(gp, procs[0])
        after = {s: state(s) for s in "ab"}
        keys = np.asarray(sorted(rows), np.int64)
        want = np.stack([rows[k] for k in keys.tolist()])
        off = {}
        for s in "ab":
            ids, vals, st = after[s]
            o = np.argsort(ids)
            same_ids = np.array_equal(ids[o], keys)
            off[s] = int(np.any(vals[o] != want, axis=1).sum()) \
                if same_ids else -1
            if st != stamps:
                fail(f"phase 38 (d): site {s}'s stamps are not the "
                     "greatest of each id's")
        if not _replica_caught_up(rep, prim.applied) or \
                not _replica_caught_up(stby, prim.applied):
            fail("phase 38 (d): site a's replicas never caught up")
        full = table_digest(prim._tables["emb"], True)
        if any(table_digest(r._tables["emb"], True) != full
               for r in (stby, rep)):
            fail("phase 38 (d): a replica of site a is not bitwise its "
                 "primary")
        fb = [x["tables"]["emb"]["full"] for x in _b_digests(procs, 0)]
        if not fb[0] == fb[1] == fb[2]:
            fail("phase 38 (d): a replica of site b is not bitwise its "
                 "primary")
        wins = collections.Counter(s for _, s in stamps.values())
        out = dict(rows=int(keys.size), rows_off=off, winners=dict(wins),
                   drains=moved, pushed_ids_a=gp.pushed_ids,
                   pushed_ids_b=rb["pushed_ids"],
                   seconds=time.perf_counter() - t0)
        log("phase 38 (d): " + json.dumps(out))
        if off != {"a": 0, "b": 0}:
            fail(f"phase 38 (d): rows off the greatest stamp's row: {off}")
        log(f"phase 38 (d): every one of {keys.size} ids holds the row of "
            f"its greatest (lamport seq, site) stamp at both sites, bitwise "
            f"(winning sites {dict(wins)}); each replica bitwise its primary")
        return out
    finally:
        if gp is not None:
            gp.stop(drain=False)
        if cli_a is not None:
            cli_a.close()
        fleet.stop_worker()
        for p in procs:
            p.stop()
        for s in (rep, stby, prim):
            if s is not None:
                s.stop()


# phase 39: the reference bench's tiered table (bench.py:1109-1262, full
# configuration): 64-wide rows, pulls of 2,048 Zipf(1.3) ids over 50,000
# hot ids with 10 % cold, 300 paired pulls a pass, two passes, rows sized
# beyond this process's resident set (clamped to 1.5-6 M) and built by
# admission and demotion in chunks of 100,000; a q8 cache of 50,000 rows
# on the card serves the same batches
PS_SCALE = dict(dim=64, batch=2048, steps=300, reps=2, hot_n=50_000,
                chunk=100_000, rows_min=1_500_000, rows_max=6_000_000,
                capacity=50_000)


def _rss_bytes() -> int:
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) * 1024
    return 0


def ps_scale(dev):
    """Phase 39: the tiered table at ``_bench_ps_scale``'s configuration:
    ``SparseTable(64, sgd, lr=0.1, init_std=0.05, seed=11)`` with spill
    on, ``n_rows = clamp(2.2 RSS / 268, 1.5 M, 6 M)`` rows built by
    admission and demotion in chunks of 100,000; ``recover_spill`` into a
    fresh table (probe rows bitwise); 2 x 300 paired zc / row pulls of
    2,048 ids over the PS socket (p50 / p99, pulls/s); then a
    ``DeviceCachedTable(RemoteTable(client, "emb", 64), 50,000,
    wire="q8")`` on the card serves the same batches, every miss fill
    launching ``pull_dequant``, its rows bitwise the numpy dequant of the
    table's q8 pull and a ``kernel_mode="torch_ref"`` cache's.  Fails if
    the RSS growth over the build reaches the spill bytes.  The spill
    directory (``tempfile.mkdtemp``) is removed whether the phase passes
    or fails.  Returns (the launch counts of the q8 cache's run,
    results)."""
    import glob

    from paddle_tpu_torch.distributed.fleet import (DeviceCachedTable,
                                                    PSClient, PSServer,
                                                    RemoteTable, SparseTable)
    from paddle_tpu_torch.distributed.fleet.ps import dequantize_rows_q8
    from paddle_tpu_torch.distributed.fleet.ps_service import _frame_bytes
    from paddle_tpu_torch.ops.kernels import registry
    t_phase = time.perf_counter()
    P = PS_SCALE
    dim = P["dim"]
    base_rss = _rss_bytes()
    rec = 8 + (dim + 1) * 4              # id + row and step, pre-align
    n_rows = int(min(max(2.2 * base_rss / rec, P["rows_min"]),
                     P["rows_max"]))
    kw = dict(optimizer="sgd", lr=0.1, init_std=0.05, seed=11)
    sdir = tempfile.mkdtemp(prefix="ps_scale_spill_")
    srv = None
    clients = []
    try:
        t = SparseTable(dim, **kw)
        if not t.enable_spill(sdir):
            fail("phase 39: enable_spill refused")
        rss0 = _rss_bytes()
        t0 = time.perf_counter()
        ids_all = np.arange(n_rows, dtype=np.int64)
        for lo in range(0, n_rows, P["chunk"]):
            t.pull(ids_all[lo:lo + P["chunk"]])          # admission
            t.spill_sweep(int(time.time() * 1000) + 10_000)  # demote all
        t.spill_advise()
        build_s = time.perf_counter() - t0
        spill_bytes = sum(os.path.getsize(p) for p in
                          glob.glob(os.path.join(sdir, "*.spill")))
        growth = _rss_bytes() - rss0
        stats = t.spill_stats()
        t2 = SparseTable(dim, **kw)
        t0 = time.perf_counter()
        recovered = t2.recover_spill(sdir)
        recovery_s = time.perf_counter() - t0
        probe = np.asarray([0, n_rows // 2, n_rows - 1], np.int64)
        if recovered != n_rows or \
                not np.array_equal(t.pull(probe), t2.pull(probe)):
            fail(f"phase 39: recovery gave {recovered} of {n_rows} rows, "
                 "or probe rows unlike the source's")
        del t2
        rng = np.random.RandomState(7)
        hot_ids = rng.choice(n_rows, P["hot_n"], replace=False).astype(
            np.int64)

        def make_batches():
            r = np.random.RandomState(1234)
            out = []
            for _ in range(P["steps"]):
                hot = hot_ids[np.minimum(r.zipf(1.3, P["batch"]) - 1,
                                         P["hot_n"] - 1)]
                n_cold = max(P["batch"] // 10, 1)
                hot[:n_cold] = r.randint(0, n_rows, n_cold)
                out.append(np.ascontiguousarray(hot))
            return out
        batches = [b for _ in range(P["reps"]) for b in make_batches()]
        srv = PSServer({"emb": t}, host="127.0.0.1")
        srv.start()
        ep = f"127.0.0.1:{srv.port}"
        # the bench's tier state: all demoted, pages dropped, the hot set
        # promoted
        t.spill_sweep(int(time.time() * 1000) + 10_000)
        t.spill_advise()
        t.pull(hot_ids)
        cli = {w: PSClient([ep], pull_wire=w) for w in ("zc", "row")}
        clients += list(cli.values())
        for c in cli.values():
            c.pull("emb", batches[0])
        samples = {"zc": [], "row": []}
        for i, b in enumerate(batches):
            for w in (("zc", "row") if i % 2 == 0 else ("row", "zc")):
                a = time.perf_counter()
                cli[w].pull("emb", b)
                samples[w].append(time.perf_counter() - a)
        wires = {}
        for w, ts in samples.items():
            pool = np.asarray(ts)
            wires[w] = dict(p50_ms=float(np.percentile(pool, 50) * 1e3),
                            p99_ms=float(np.percentile(pool, 99) * 1e3),
                            pulls_per_s=len(pool) / float(pool.sum()))
        uniq = np.unique(batches[0])
        f32_bytes = len(_frame_bytes({"vals": t.pull(batches[0])}))
        codes, scales = t.pull_q8(uniq)
        q8_bytes = len(_frame_bytes({
            "inv": np.searchsorted(uniq, batches[0]).astype(np.int32),
            "codes": codes, "scales": scales}))
        # the q8 cache on the card, and its plain twin, over the batches
        out = {}
        for arm in ("cuda", "torch_ref"):
            c = PSClient([ep])
            clients.append(c)
            cache = DeviceCachedTable(
                RemoteTable(c, "emb", dim), capacity=P["capacity"],
                wire="q8", device=dev,
                kernel_mode=None if arm == "cuda" else "torch_ref")
            fills = [0]
            fill = cache._fill_rows

            def counted(miss_ids, nsp, fill=fill, fills=fills):
                fills[0] += 1
                return fill(miss_ids, nsp)
            cache._fill_rows = counted
            registry.reset_counts()          # the main path starts here
            t0 = time.perf_counter()
            rows = [cache.pull(b) for b in batches]
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            counts = registry.launch_counts()  # ... and ends here
            plain = registry.kernels()["pull_dequant"].torch_ref_calls
            out[arm] = (rows, counts, plain, fills[0], dt, cache)
        rows, counts, plain, fills, dt, cache = out["cuda"]
        ref_rows, ref_counts, ref_plain, ref_fills = out["torch_ref"][:4]
        off = [i for i, (a, b) in enumerate(zip(rows, ref_rows))
               if not torch.equal(a, b)]
        off_np = []
        for i, (b, r) in enumerate(zip(batches, rows)):
            want = dequantize_rows_q8(*t.pull_q8(b))
            if not np.array_equal(r.cpu().numpy(), want):
                off_np.append(i)
        res = dict(rows_total=n_rows, base_rss_mb=base_rss / 2**20,
                   build_s=build_s, spill_mb=spill_bytes / 2**20,
                   rss_growth_mb=growth / 2**20, hot_rows=stats["hot"],
                   cold_rows=stats["cold"], recovery_s=recovery_s,
                   recovered_rows=int(recovered), wires=wires,
                   zc_over_row_paired=float(np.median(
                       np.asarray(samples["row"])
                       / np.asarray(samples["zc"]))),
                   q8_egress_ratio=f32_bytes / q8_bytes,
                   q8_cache=dict(ms_per_batch=dt * 1e3 / len(batches),
                                 fills=fills, hits=cache.hits,
                                 misses=cache.misses,
                                 evictions=cache.evictions,
                                 launches=counts["pull_dequant"],
                                 plain_calls=plain),
                   seconds=time.perf_counter() - t_phase)
        log("phase 39: " + json.dumps(res))
        if growth >= spill_bytes:
            fail(f"phase 39: RSS grew {growth} bytes over the build, not "
                 f"below the {spill_bytes} spill bytes")
        want = dict.fromkeys(counts, 0)
        want["pull_dequant"] = fills
        if counts != want or plain or fills < 1:
            fail(f"phase 39: launches {counts} (want {want}: one "
                 f"pull_dequant a miss fill), plain calls {plain}")
        if ref_fills != fills or ref_plain != ref_fills or \
                any(ref_counts.values()):
            fail(f"phase 39: the plain arm filled {ref_fills} times with "
                 f"{ref_plain} plain calls and launches {ref_counts}")
        if off or off_np:
            fail(f"phase 39: the q8 cache's rows differ from the plain "
                 f"arm's at batches {off[:5]}, from the numpy dequant at "
                 f"{off_np[:5]}")
        log(f"phase 39: {n_rows} rows, {spill_bytes / 2**20:.1f} MiB "
            f"spilled, RSS grew {growth / 2**20:.1f} MiB over the build; "
            f"recovery bitwise; pull_dequant launched once for each of "
            f"{fills} miss fills, every batch's rows bitwise the plain arm's "
            f"and the numpy dequant of the q8 pull; q8 egress "
            f"{f32_bytes / q8_bytes:.2f}x below f32")
        return counts, res
    finally:
        for c in clients:
            c.close()
        if srv is not None:
            srv.stop()
        shutil.rmtree(sdir, ignore_errors=True)


# ---------------------------------------------------------------------
# phases 40-43: the one-device training step, whole
# ---------------------------------------------------------------------

# the reference bench's long-context A/B (bench.py:517-587, non-smoke):
# the proxy at (seq, batch) 4,096 x 2 and 8,192 x 1, each trained once on
# the flash kernels and once with flash off (query-chunked attention);
# steps a training run here (the first is a warm-up, not timed)
LONG_CONTEXT = ((4096, 2), (8192, 1))
LONG_STEPS = 6
# the two arms' first-step losses (bf16 AMP, same weights and ids): the
# attention's arithmetic differs (flash: P rounded to bf16 per key tile;
# chunked: bf16 scores and softmax), so the losses part by rounding
LONG_FIRST_LOSS_TOL = 0.01
# phase 41: the proxy at 4,096 x 4 (f32 logits 2.10 GB >= 1.5 GiB), one
# step with the chunked loss and one with the plain loss: the loss within
# CHUNKED_LOSS_REL; the global gradient within CHUNKED_GRAD_REL.  The
# chunked backward rounds the head's cotangent to bf16 before its
# products (2^-9 an element), where the plain path rounds only their
# results; the sums over tokens cancel, so the gradients part by more
# than 2^-9 (6.8e-3 on the CPU at hidden 128, vocab 512)
CHUNKED_LOSS_BATCH = 4
CHUNKED_LOSS_REL = 1e-4
CHUNKED_GRAD_REL = 3e-2
# phase 42: the guard A/B (bench.py:158-210): median of 3 runs of
# GUARD_STEPS steps each side; the reference's target is < 1 % (read, not
# a gate)
GUARD_STEPS = 8
# phase 43: BERT-base at the bench's configuration, float16 against f32:
# the loss after FP16_STEPS steps within E2E_AMP_LOSS_REL of the f32
# step's
FP16_STEPS = 8


def _long_kernel_cases(dev, B, S, H=16, label="phase 40"):
    """Kernels 1-3 at the proxy's attention (B, H, S, 128): the long
    contexts (H 16), a tp-2 rank's heads (B 4, H 8) and the pipeline's
    microbatches (B 1, H 16 or 8); bf16, causal,
    against their blockwise plain versions (``CARD_TOL``,
    ``CARD_TOL_BWD``), a rerun bitwise equal, each timed queued beside its
    bound, its plain version and SDPA.  Returns the rows by kernel name."""
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    g0 = torch.Generator(device=dev).manual_seed(SEED + 40)
    D = 128
    q, k, v, g = (torch.randn(B, S, H, D, device=dev, dtype=torch.bfloat16,
                              generator=g0) for _ in range(4))
    got = _flash_grads(q, k, v, g, True)
    again = _flash_grads(q, k, v, g, True)
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        fail(f"{label}: kernels 2-3 at B={B} S={S}: a rerun is not "
             "bitwise equal")
    qh, kh, vh, gh = (t.transpose(1, 2) for t in (q, k, v, g))
    o, lse = fa.flash_attention_bhsd(qh, kh, vh, causal=True,
                                     return_lse=True)
    o2 = fa.flash_attention_bhsd(qh, kh, vh, causal=True)
    if not torch.equal(o, o2):
        fail(f"{label}: kernel 1 at B={B} S={S}: a rerun is not bitwise "
             "equal")
    plan = fa.flash_fwd_plan(qh, kh, vh)
    ref = fa.flash_attention_blockwise_ref(qh, kh, vh, causal=True,
                                           block_k=plan.block_k)
    shape = f"B={B} H={H} S={S} D={D} bf16 causal"
    err1, share1 = check_close(f"{label}: flash_attention {shape}", o, ref,
                               fa.CARD_TOL[torch.bfloat16])
    del ref, o2
    delta = fa.attention_delta(o, gh)
    args = (qh, kh, vh, gh, lse, delta)
    bref = fa.flash_attention_bwd_blockwise_ref(*args, causal=True)
    errs = {}
    for name, a, r in zip(("dq", "dk", "dv"), got, bref):
        errs[name], share = check_close(
            f"{label}: flash backward {name} {shape}", a.transpose(1, 2),
            r, fa.CARD_TOL_BWD[torch.bfloat16])
    del bref
    torch.cuda.empty_cache()
    log(f"{label}: kernels 1-3 at {shape}: forward max_err {err1:.3g} "
        f"({share1:.3g} of its limit), dq {errs['dq']:.3g} dk "
        f"{errs['dk']:.3g} dv {errs['dv']:.3g}; reruns bitwise")
    fwd = flash_timing(f"{label} B={B} H={H} S={S}", *(t.detach().contiguous()
                                        for t in (qh, kh, vh)), True)
    bwd = bwd_timing(f"{label} B={B} H={H} S={S}", args, o, gh)
    rows = {"flash_attention": dict(max_abs_err=err1, **fwd)}
    for name, grads in (("flash_attention_bwd_dkv", ("dk", "dv")),
                        ("flash_attention_bwd_dq", ("dq",))):
        rows[name] = dict(max_abs_err=max(errs[x] for x in grads),
                          **bwd[name])
    del q, k, v, g, got, again, o, lse, delta, args
    torch.cuda.empty_cache()
    return rows


def _long_arm(dev, S, B, use_flash):
    """One training run of the proxy at (B, S) from the seed-0 weights,
    on the flash kernels or with flash off (as ``bench.py:537-572`` turns
    it off: ``flash_eligible`` patched on the module that calls it, and
    restored).  Returns losses, ms, launch counts per step, peak
    memory."""
    from paddle_tpu_torch.ops.kernels import registry
    from paddle_tpu_torch.text.models import LlamaForCausalLM
    from paddle_tpu_torch.text.models import llama as llama_mod
    orig = llama_mod.flash_eligible
    if not use_flash:
        llama_mod.flash_eligible = lambda *a, **k: False
    try:
        cfg = proxy_config(max_position_embeddings=S)
        if use_flash and not llama_mod.flash_eligible(S, cfg.head_dim):
            fail(f"phase 40: flash is not live on the flash arm at S={S}")
        model = LlamaForCausalLM(cfg, device=dev, dtype="float32",
                                 generator=torch.Generator(device=dev)
                                 .manual_seed(SEED))
        step = _train_step(model)
        nparams = sum(p.numel() for p in model.parameters())
        ids = torch.from_numpy(np.random.RandomState(0).randint(
            0, cfg.vocab_size, (B, S)).astype("int32")).to(dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        losses, ms = [], []
        registry.reset_counts()              # the main path starts here
        for _ in range(LONG_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses.append(step(ids, ids).item())
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        counts = registry.launch_counts()    # ... and ends here
        peak = torch.cuda.max_memory_allocated(dev) / 1e9
        del model, step
    finally:
        llama_mod.flash_eligible = orig
    gc.collect()
    torch.cuda.empty_cache()
    if not all(math.isfinite(x) for x in losses):
        fail(f"phase 40: non-finite loss at S={S} "
             f"({'flash' if use_flash else 'chunked'}): {losses}")
    step_ms = statistics.median(ms[1:])
    flops = (6.0 * nparams * B * S + 6.0 * cfg.num_hidden_layers * B * S
             * S * cfg.hidden_size)          # bench.py _llama_analytic
    tflops = flops / (step_ms / 1e3) / 1e12
    return dict(losses=losses, ms_per_step=ms, ms_median=step_ms,
                tokens_per_s=B * S / (step_ms / 1e3), model_tflops=tflops,
                mfu=tflops * 1e12 / PEAK_BF16_FLOPS,
                max_memory_allocated_gb=peak,
                launches_per_step={n: c / LONG_STEPS
                                   for n, c in counts.items()},
                layers=cfg.num_hidden_layers), counts


def long_context(dev):
    """Phase 40: the proxy at 4,096 x 2 and 8,192 x 1 (``bench.py``
    ``_bench_llama_long`` / ``_bench_llama_8k``): kernels 1-3 at each
    shape against their plain versions and timed; then a flash arm and a
    chunked arm from the same weights, ``LONG_STEPS`` steps each: launches
    a step 16 / 8 / 8 on the flash arm and 0 on the chunked arm, the
    first-step losses within ``LONG_FIRST_LOSS_TOL``, ms/step, tokens/s,
    MFU, peak memory and ``flash_speedup_vs_chunked``.  Returns the
    flash arms' launch counts and the kernel rows at both shapes."""
    total = collections.Counter()
    rows = {}
    for S, B in LONG_CONTEXT:
        t0 = time.perf_counter()
        rows[S] = _long_kernel_cases(dev, B, S)
        flash, fcounts = _long_arm(dev, S, B, True)
        chunked, ccounts = _long_arm(dev, S, B, False)
        L = flash.pop("layers")
        chunked.pop("layers")
        want = dict.fromkeys(fcounts, 0.0)
        want.update({"flash_attention": 2.0 * L,
                     "flash_attention_bwd_dkv": float(L),
                     "flash_attention_bwd_dq": float(L)})
        if flash["launches_per_step"] != want:
            fail(f"phase 40: flash arm at S={S}: launches a step "
                 f"{flash['launches_per_step']}, want {want}")
        if any(ccounts.values()):
            fail(f"phase 40: chunked arm at S={S} launched {ccounts}")
        d = abs(flash["losses"][0] - chunked["losses"][0])
        if not d <= LONG_FIRST_LOSS_TOL:
            fail(f"phase 40: S={S}: first-step losses flash "
                 f"{flash['losses'][0]:.6f} chunked "
                 f"{chunked['losses'][0]:.6f} part by {d:.4g} > "
                 f"{LONG_FIRST_LOSS_TOL}")
        res = dict(seq=S, batch=B, flash=flash, chunked=chunked,
                   first_loss_diff=d,
                   flash_speedup_vs_chunked=chunked["ms_median"]
                   / flash["ms_median"], card=_CARD[0],
                   seconds=time.perf_counter() - t0)
        log(f"phase 40 (S={S}, B={B}): " + json.dumps(res))
        total.update(fcounts)
    return dict(total), rows


def chunked_loss(dev):
    """Phase 41: the proxy at 4,096 x 4 (f32 logits 2.10 GB >= 1.5 GiB):
    the train step's loss and gradients with the chunked LM loss (the
    step engages it) and with the plain loss (its threshold raised for
    the second run only), same weights and batch: the loss within
    ``CHUNKED_LOSS_REL``, the global gradient's distance within
    ``CHUNKED_GRAD_REL``, and the chunked run's peak memory lower."""
    from paddle_tpu_torch.ops.kernels import registry
    from paddle_tpu_torch.text.models import LlamaForCausalLM
    from paddle_tpu_torch.text.models import llama as llama_mod
    S, B = 4096, CHUNKED_LOSS_BATCH
    cfg = proxy_config(max_position_embeddings=S)
    model = LlamaForCausalLM(cfg, device=dev, dtype="float32",
                             generator=torch.Generator(device=dev)
                             .manual_seed(SEED))
    step = _train_step(model)
    ids = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab_size, (B, S)).astype("int32")).to(dev)
    logits_gb = B * S * cfg.vocab_size * 4 / 1e9
    if not B * S * cfg.vocab_size * 4 >= llama_mod._CHUNK_BYTES_MIN:
        fail(f"phase 41: {logits_gb:.2f} GB of logits is under the "
             "chunked loss's threshold")
    registry.reset_counts()
    out = {}
    orig = llama_mod._CHUNK_BYTES_MIN
    for name in ("chunked", "plain"):
        if name == "plain":
            llama_mod._CHUNK_BYTES_MIN = float("inf")
        try:
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            base = torch.cuda.memory_allocated(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            t0 = time.perf_counter()
            loss, grads = step.loss_and_grads(ids, ids)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            peak = torch.cuda.max_memory_allocated(dev)
        finally:
            llama_mod._CHUNK_BYTES_MIN = orig
        out[name] = dict(loss=loss.item(), grads=grads, ms=ms,
                         peak_gb=peak / 1e9,
                         peak_over_start_gb=(peak - base) / 1e9)
    counts = registry.launch_counts()
    gc_, gp = out["chunked"].pop("grads"), out["plain"].pop("grads")
    num = sum((a - b).double().pow(2).sum() for a, b in zip(gc_, gp))
    den = sum(b.double().pow(2).sum() for b in gp)
    grad_rel = math.sqrt(num.item() / den.item())
    head = [n for n, _ in model.named_parameters()].index("lm_head.weight")
    head_rel = ((gc_[head] - gp[head]).double().norm()
                / gp[head].double().norm()).item()
    del gc_, gp, model, step
    gc.collect()
    torch.cuda.empty_cache()
    lc, lp = out["chunked"]["loss"], out["plain"]["loss"]
    res = dict(seq=S, batch=B, logits_gb=logits_gb, chunked=out["chunked"],
               plain=out["plain"], loss_rel=abs(lc - lp) / abs(lp),
               grad_rel=grad_rel, lm_head_grad_rel=head_rel,
               launches=counts, card=_CARD[0])
    log("phase 41: " + json.dumps(res))
    if not res["loss_rel"] <= CHUNKED_LOSS_REL:
        fail(f"phase 41: the chunked loss {lc} against the plain {lp} "
             f"(relative {res['loss_rel']:.3g} > {CHUNKED_LOSS_REL})")
    if not grad_rel <= CHUNKED_GRAD_REL:
        fail(f"phase 41: the chunked loss's global gradient is "
             f"{grad_rel:.3g} from the plain one's (> {CHUNKED_GRAD_REL})")
    if not out["chunked"]["peak_gb"] < out["plain"]["peak_gb"]:
        fail(f"phase 41: the chunked loss's peak memory "
             f"{out['chunked']['peak_gb']:.3f} GB is not below the plain "
             f"loss's {out['plain']['peak_gb']:.3f} GB")
    return counts


def _guard_overhead(plain_fn, guarded_fn, steps):
    """The reference bench's A/B (``bench.py:158-182``): a warm-up call,
    then the median of 3 timed runs of ``steps`` calls a side."""
    def loop(fn):
        fn()
        ts = []
        for _ in range(3):
            t0 = time.perf_counter()
            for _ in range(steps):
                fn()
            ts.append((time.perf_counter() - t0) / steps)
        return sorted(ts)[1]
    a, b = loop(plain_fn), loop(guarded_fn)
    return dict(guard_ms_plain=a * 1e3, guard_ms_guarded=b * 1e3,
                guard_overhead_pct=(b - a) / a * 100.0)


def _snapshot(params, opt):
    return ([p.detach().clone() for p in params],
            [{k: v.clone() for k, v in s.items()} for s in opt.opt_state()])


def _same_state(snap, params, opt):
    ps, ss = snap
    return (all(torch.equal(a, p) for a, p in zip(ps, params))
            and all(torch.equal(s0[k], s1[k])
                    for s0, s1 in zip(ss, opt.opt_state()) for k in s0))


def guard_phase(dev):
    """Phase 42: the guard on the proxy at 2,048 x 4 (``bench.py``
    ``_guard_ab``): (a) the clean-path A/B of ``guard_health`` +
    ``TrainGuard(min_history=10**9).check`` against the plain step (one
    host fetch a step, 0 skips; the overhead against the reference's < 1
    % target, read and not gated); (b) an eager ``TrainGuard.step`` loop
    under ``nan:grad:step=3``: that step skipped, parameters and AdamW
    state bitwise unchanged across it, the others applied; (c) a k = 2
    gradient merge with ``guard_health`` on one batch twice: nothing
    applied on the first call, the health's norm doubled on the second
    (folded over the window), the parameters moved; (d)
    ``LinearWarmup(CosineAnnealingDecay)`` + ``ClipGradByGlobalNorm(1.0)``:
    on a batch the model has not seen: the lr applied at each step is the
    schedule's, the clip engages at least once, and the clipped
    gradients' global norm is at most 1 (1 + 1e-6), unchanged where it
    was under 1.  Returns the launch
    counts of (a)."""
    from paddle_tpu_torch import train_guard as tg
    from paddle_tpu_torch.distributed.fleet import (DistributedStrategy,
                                                    DistributedTrainStep,
                                                    chaos)
    from paddle_tpu_torch.nn.clip import ClipGradByGlobalNorm
    from paddle_tpu_torch.ops.kernels import registry
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.optimizer.lr import (CosineAnnealingDecay,
                                               LinearWarmup)
    from paddle_tpu_torch.text.models import LlamaForCausalLM
    cfg = proxy_config()
    B, S = TRAIN_BATCH, TRAIN_SEQ
    model = LlamaForCausalLM(cfg, device=dev, dtype="float32",
                             generator=torch.Generator(device=dev)
                             .manual_seed(SEED))
    params = list(model.parameters())
    ids = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab_size, (B, S)).astype("int32")).to(dev)
    strategy = DistributedStrategy()
    strategy.amp = True
    strategy.amp_configs = {"dtype": "bfloat16"}
    res = dict(card=_CARD[0])

    # (a) the clean-path A/B
    opt = AdamW(learning_rate=1e-4, parameters=params)
    step = DistributedTrainStep(model, _loss_fn(model), opt, strategy)
    gstep = DistributedTrainStep(model, _loss_fn(model), opt, strategy,
                                 guard_health=True)
    guard = tg.TrainGuard(min_history=10 ** 9)

    def plain():
        step(ids, ids)
        torch.cuda.synchronize()

    def guarded():
        gstep(ids, ids)
        guard.check(gstep.last_health)       # the fetch is the sync

    registry.reset_counts()
    n0 = tg.host_sync_count()
    res["ab"] = _guard_overhead(plain, guarded, GUARD_STEPS)
    counts = registry.launch_counts()
    syncs = tg.host_sync_count() - n0
    res["ab"].update(host_syncs=syncs, guarded_steps=1 + 3 * GUARD_STEPS,
                     skips=guard.skips, target_pct=1.0)
    log("phase 42 (a): " + json.dumps(res["ab"]))
    if syncs != 1 + 3 * GUARD_STEPS or guard.skips:
        fail(f"phase 42 (a): {syncs} host fetches over "
             f"{1 + 3 * GUARD_STEPS} guarded steps, {guard.skips} skips")
    del step, gstep

    # (b) a planted NaN gradient through the eager guarded loop
    opt_b = AdamW(learning_rate=1e-4, parameters=params)
    guard_b = tg.TrainGuard(optimizer=opt_b)
    chaos.install(chaos.plan_from_spec("nan:grad:step=3"))
    verdicts = []
    try:
        for i in range(4):
            loss, _ = model(ids, labels=ids)
            loss.backward()
            snap = _snapshot(params, opt_b) if i == 2 else None
            verdicts.append(guard_b.step(loss.detach(), step=i))
            if snap is not None and not _same_state(snap, params, opt_b):
                fail("phase 42 (b): the skipped step moved the parameters "
                     "or the AdamW state")
            del snap
        fired = chaos.active().stats_dict()
    finally:
        chaos.uninstall()
    log(f"phase 42 (b): verdicts {verdicts}, skips {guard_b.skips}, chaos "
        f"{fired}, AdamW global step {opt_b._global_step}")
    if verdicts != ["ok", "ok", "skip", "ok"] or guard_b.skips != 1 \
            or fired != {"nan:grad": 1} or opt_b._global_step != 3:
        fail(f"phase 42 (b): verdicts {verdicts}, chaos {fired}")
    del opt_b, guard_b
    torch.cuda.empty_cache()

    # (c) gradient merge, k = 2, with the health vector
    gm = DistributedStrategy()
    gm.amp = True
    gm.amp_configs = {"dtype": "bfloat16"}
    gm.gradient_merge = True
    gm.gradient_merge_configs = {"k_steps": 2, "avg": True}
    opt_c = AdamW(learning_rate=1e-4, parameters=params)
    mstep = DistributedTrainStep(model, _loss_fn(model), opt_c, gm,
                                 guard_health=True)
    before = [p.detach().clone() for p in params]
    mstep(ids, ids)
    h1 = mstep.last_health.cpu().numpy()
    same = all(torch.equal(a, p) for a, p in zip(before, params))
    mstep(ids, ids)
    h2 = mstep.last_health.cpu().numpy()
    moved = not all(torch.equal(a, p) for a, p in zip(before, params))
    ratio = float(h2[0] / h1[0])
    log(f"phase 42 (c): health after call 1 {h1.tolist()}, after call 2 "
        f"{h2.tolist()}, norm ratio {ratio:.6f} (one batch twice: 2); "
        f"parameters unchanged after call 1: {same}, moved after call 2: "
        f"{moved}")
    if not (same and moved and abs(ratio - 2.0) <= 1e-3 and h2[1] == 0):
        fail(f"phase 42 (c): the merge's health did not fold (ratio "
             f"{ratio}) or the window applied at the wrong call")
    del mstep, opt_c, before
    torch.cuda.empty_cache()

    # (d) a warmup + cosine schedule and the global-norm clip, on a batch
    # the model has not seen (on the memorised one the norm is far below 1)
    ids = torch.from_numpy(np.random.RandomState(1).randint(
        0, cfg.vocab_size, (B, S)).astype("int32")).to(dev)
    sched = LinearWarmup(CosineAnnealingDecay(1e-4, T_max=8), 2, 1e-5, 1e-4)
    clip = ClipGradByGlobalNorm(1.0)
    opt_d = AdamW(learning_rate=sched, parameters=params, grad_clip=clip)
    seen_lr, norms = [], []
    apply_one = opt_d._apply_one

    def recording_apply(p, g, lr, state, decay=None, sq_reduce=None):
        seen_lr.append(lr)
        return apply_one(p, g, lr, state, decay, sq_reduce)

    clip_values = clip.apply_values

    def recording_clip(grads, sq_reduce=None):
        out = clip_values(grads, sq_reduce)
        raw = math.sqrt(sum(float(g.double().pow(2).sum()) for g in grads))
        cut = math.sqrt(sum(float(g.double().pow(2).sum()) for g in out))
        norms.append((raw, cut))
        return out

    opt_d._apply_one = recording_apply
    clip.apply_values = recording_clip
    dstep = DistributedTrainStep(model, _loss_fn(model), opt_d, strategy)
    want_lr = []
    for _ in range(4):
        want_lr.append(sched())
        n = len(seen_lr)
        dstep(ids, ids)
        lrs = set(seen_lr[n:])
        if lrs != {want_lr[-1]}:
            fail(f"phase 42 (d): the step applied lr {lrs}, the schedule "
                 f"gives {want_lr[-1]}")
        sched.step()
    engaged = sum(raw > 1.0 for raw, _ in norms)
    log(f"phase 42 (d): lr a step {want_lr}; global norm before / after "
        f"the clip {norms}; the clip engaged on {engaged} of {len(norms)} "
        f"steps")
    # at most 1 after the clip; a norm under 1 passes through unscaled
    if not engaged or not all(
            cut <= 1.0 * (1 + 1e-6) and (raw > 1.0 or
                                         abs(cut - raw) <= 1e-6 * raw)
            for raw, cut in norms):
        fail(f"phase 42 (d): clipped norms {norms}")
    del dstep, opt_d, model, params
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase 42: guard overhead {res['ab']['guard_overhead_pct']:.3f} % "
        f"(the reference's target < 1 %, read not gated) on {_CARD[0]}")
    return counts


def bert_fp16(dev):
    """Phase 43: BERT-base pretraining at the bench's configuration
    (``bench.py:366-418``: 128 x 128, 19 masked positions, AdamW 1e-4)
    from the seed's weights and dropout masks: (a) the train step with
    ``amp_configs={"dtype": "float16"}`` (dynamic loss scaling), (b) the
    eager ``auto_cast(dtype="float16")`` + ``GradScaler`` loop, and the
    f32 step, ``FP16_STEPS`` steps each on the bench's batch: both float16
    losses after the last step within ``E2E_AMP_LOSS_REL`` of the f32
    step's; the scale history of each; (c) a planted ``inf:grad`` on two
    steps in a row of the eager loop: both skipped (parameters and AdamW
    state bitwise), the scale times ``decr_ratio`` after the second
    (``decr_every_n_nan_or_inf`` = 2).  Every registered kernel's launch
    count is 0 (seq 128 sends no flash call)."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.distributed.fleet import chaos
    from paddle_tpu_torch.ops.kernels import registry
    from paddle_tpu_torch.train_guard import chaos_corrupt
    b, s = BERT_TRAIN["batch"], BERT_TRAIN["seq"]
    registry.reset_counts()
    res = dict(card=_CARD[0], steps=FP16_STEPS)
    batch = None
    for name in ("f32", "fp16 step"):
        model, cfg, step = _bert_train_step(dev, amp=name != "f32")
        if name != "f32":
            step = _bert_fp16_step(model, step)
        if batch is None:
            batch = _bert_batch(dev, cfg.vocab_size, b, s)
        losses, scales, ms = [], [], []
        for _ in range(FP16_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses.append(step(*batch).item())
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            if step.amp_state is not None:
                scales.append(step.amp_state[0].item())
        res[name] = dict(losses=losses, scales=scales,
                         ms_median=statistics.median(ms[1:]))
        del model, step
        gc.collect()
        torch.cuda.empty_cache()

    # (b) and (c): the eager auto_cast + GradScaler loop
    model, cfg, step = _bert_train_step(dev, amp=False)
    opt = step._opt
    crit = step._wrapper._loss_fn
    del step
    scaler = amp.GradScaler()
    params = list(model.parameters())
    losses, scales, skipped = [], [], []
    n_eager = FP16_STEPS + 2
    chaos.install(chaos.plan_from_spec(
        f"inf:grad:step={FP16_STEPS + 1}:every=1:times=2"))
    try:
        for i in range(n_eager):
            with amp.auto_cast(dtype="float16"):
                loss = crit(*batch)
            scaler.scale(loss).backward()
            grads = [p for p in params if p.grad is not None]
            new, fired = chaos_corrupt("grad", [p.grad for p in grads])
            if fired:
                for p, g in zip(grads, new):
                    p.grad = g
            snap = _snapshot(params, opt) if fired else None
            scale0 = scaler.get_loss_scaling()
            scaler.step(opt)
            opt.clear_grad()
            if snap is not None:
                if not _same_state(snap, params, opt):
                    fail("phase 43 (c): an overflow step moved the "
                         "parameters or the AdamW state")
                skipped.append((i, scale0, scaler.get_loss_scaling()))
            del snap
            losses.append(loss.item())
            scales.append(scaler.get_loss_scaling())
    finally:
        chaos.uninstall()
    counts = registry.launch_counts()
    res["eager"] = dict(losses=losses, scales=scales, skipped=skipped)
    del model, opt, params
    gc.collect()
    torch.cuda.empty_cache()
    f32_last = res["f32"]["losses"][-1]
    for name, last in (("fp16 step", res["fp16 step"]["losses"][-1]),
                       ("eager", losses[FP16_STEPS - 1])):
        res[name]["loss_rel_vs_f32"] = abs(last - f32_last) / abs(f32_last)
    log("phase 43: " + json.dumps(res))
    for name in ("fp16 step", "eager"):
        if not res[name]["loss_rel_vs_f32"] <= E2E_AMP_LOSS_REL:
            fail(f"phase 43: the {name} loss after {FP16_STEPS} steps is "
                 f"{res[name]['loss_rel_vs_f32']:.4g} from the f32 step's "
                 f"(> {E2E_AMP_LOSS_REL})")
    if [i for i, _, _ in skipped] != [FP16_STEPS, FP16_STEPS + 1]:
        fail(f"phase 43 (c): skipped steps {skipped}")
    (_, a0, a1), (_, b0, b1) = skipped
    if not (a1 == a0 and b1 == b0 * 0.5):
        fail(f"phase 43 (c): scale {a0} -> {a1} -> {b1} over two overflows; "
             f"want it halved after the second")
    if any(counts.values()):
        fail(f"phase 43: kernels launched {counts}")
    return res


def _bert_fp16_step(model, step):
    """The phase-29 step over the same model, optimizer and loss with
    ``amp_configs={"dtype": "float16"}`` (the defaults: dynamic scaling
    from 2**15)."""
    from paddle_tpu_torch.distributed.fleet import (DistributedStrategy,
                                                    DistributedTrainStep)
    s = DistributedStrategy()
    s.amp = True
    s.amp_configs = {"dtype": "float16"}
    return DistributedTrainStep(model, step._wrapper._loss_fn, step._opt, s)


# -- phases 44-47: collective training across ranks -------------------------

# seconds a rendezvous or one collective may wait, and a phase's ranks
# may run, before the phase fails with the ranks' log tails
COLL_TIMEOUT = 120
RANKS_TIMEOUT = 600
ZERO_STAGE_STEPS = 5          # phase 45: stages 1-3 (f32 slots)
ZERO_ARM_STEPS = 10           # phase 45: bf16, int8, offload
ZERO_W2_STEPS = 3             # phase 46
# phase 45: the largest distance of an arm's losses from the f32 arm's
# (phase 7's run) over 10 steps, 3x its reading on an NVIDIA H100 80GB
# HBM3 at 700 W (bf16 1.094e-3, int8 4.539e-2); the offload arm must be
# bitwise (the same update, its slots moved)
ZERO_LOSS_LIMIT = {"bfloat16": 3.3e-3, "int8": 0.14, "offload": 0.0}
# phase 46: the world-2 losses' largest distance from the world-1 run of
# the same global batches (phase 7's for dp 2, phase 45's int8 arm for
# fsdp 2 / int8) over 3 steps, 3x its reading on that card (2.298e-4,
# 1.898e-4)
ZERO_W2_LIMIT = {"dp2": 7e-4, "fsdp2_int8": 6e-4}
# phase 47: ResNet-50 with DGC (the bench's configuration)
DGC_CFG = {"rampup_begin_step": 2, "rampup_step": 1, "sparsity": [0.999]}
DGC_STEPS = 10
DGC_W2_STEPS = 4
# phase 47 (b): world 2's losses against (a)'s first four, 3x its reading
# on that card (1.5625e-2: the bf16-AMP losses step in 2^-6 there).  Read
# again after world 2 came to compress the global gradient: the
# same 1.5625e-2, already at step 0, before any compression -- each
# rank's batch norm normalises its own 128 rows
DGC_W2_LIMIT = 0.047


def _digest(tensors):
    """Exact fingerprints of a list of f32 tensors (bit sums, wrapped)."""
    out = []
    for t in tensors:
        b = t.detach().contiguous().view(torch.int32).to(torch.int64)
        out.append((int(b.sum()), int((b * b).sum()), int(b[::7].sum())))
    return out


def _rank_setup():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from paddle_tpu_torch.ops.kernels import registry
    registry.reset_counts()
    return torch.device("cuda", torch.cuda.current_device())


def _coll_rank(_payload):
    """Every collective of the collective API and the named-axis
    collectives on this rank's CUDA tensors; each result as numpy."""
    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch.distributed import communication as comm
    from paddle_tpu_torch.distributed import mesh as mesh_mod
    from paddle_tpu_torch.distributed import parallel
    dev = _rank_setup()
    r, n = dist.get_rank(), dist.get_world_size()
    got, where = {}, set()

    def keep(name, t):
        where.add(t.device.type)
        got[name] = t.detach().cpu().numpy().copy()

    for op in ("SUM", "MAX", "MIN", "PROD"):
        t = torch.full((4,), float(r + 2), device=dev)
        dist.all_reduce(t, op=getattr(dist.ReduceOp, op))
        keep(f"all_reduce_{op}", t)
    t = torch.full((3,), float(r + 1), device=dev)
    dist.reduce(t, dst=0)
    keep("reduce", t)
    lst = []
    dist.all_gather(lst, torch.arange(3.0, device=dev) + 10 * r)
    keep("all_gather", torch.stack(lst))
    keep("reduce_scatter", dist.reduce_scatter(
        torch.arange(2.0 * n, device=dev) * (r + 1)))
    t = torch.full((3,), float(r), device=dev)
    dist.broadcast(t, src=n - 1)
    keep("broadcast", t)
    t = torch.zeros(2, device=dev)
    dist.scatter(t, [torch.full((2,), float(j), device=dev)
                     for j in range(n)] if r == 0 else None, src=0)
    keep("scatter", t)
    lst = []
    dist.alltoall([torch.full((1,), float(10 * r + j), device=dev)
                   for j in range(n)], lst)
    keep("alltoall", torch.cat(lst))
    if n > 1:
        t = torch.full((2,), float(r), device=dev)
        if r == 0:
            dist.send(torch.full((2,), 42.0, device=dev), dst=1)
        elif r == 1:
            dist.recv(t, src=0)
        keep("send_recv", t)
    g = dist.new_group(list(range(n)))
    t = torch.ones(2, device=dev)
    dist.all_reduce(t, group=g)
    keep("new_group", dist.wait(t))
    dist.barrier()
    mesh_mod.init_mesh({"dp": n})
    x = torch.tensor([float(r + 1), 2.0 * (r + 1)], device=dev)
    for name in ("psum", "pmean", "pmax", "pmin", "pprod"):
        keep(name, getattr(comm, name)(x, "dp"))
    keep("gather_tiled", comm.all_gather(x, "dp", tiled=True))
    keep("gather_stacked", comm.all_gather(x, "dp"))
    keep("rs", comm.reduce_scatter(
        torch.arange(2.0 * n, device=dev) * (r + 1), "dp"))
    keep("ppermute", comm.ppermute(x, "dp", [(0, n - 1)]))
    keep("ring_shift", comm.ring_shift(x, "dp", 1))
    keep("all_to_all", comm.all_to_all(
        torch.arange(float(n), device=dev) + 100 * r, "dp", split_dim=0,
        concat_dim=0))
    keep("broadcast_from", comm.broadcast_from(x, "dp", root=n - 1))
    keep("shard_map", dist.shard_map(
        lambda b: comm.psum(b, "dp") + comm.axis_index("dp"),
        in_specs=(("dp",),), out_specs=("dp",))(
            torch.arange(float(n), device=dev)))
    torch.cuda.synchronize()
    return dict(rank=r, world=n, backend=parallel.backend(),
                device=str(dev), axis=(comm.axis_index("dp"),
                                       comm.axis_size("dp")),
                where=sorted(where), got=got)


def _coll_want(r, n):
    s = n * (n + 1) / 2
    x = np.array([r + 1.0, 2.0 * (r + 1)])
    want = {"all_reduce_SUM": np.full(4, sum(j + 2.0 for j in range(n))),
            "all_reduce_MAX": np.full(4, n + 1.0),
            "all_reduce_MIN": np.full(4, 2.0),
            "all_reduce_PROD": np.full(4, float(math.prod(
                j + 2 for j in range(n)))),
            "reduce": np.full(3, s),
            "all_gather": np.stack([np.arange(3.0) + 10 * j
                                    for j in range(n)]),
            "reduce_scatter": (np.arange(2.0 * n) * s)[2 * r:2 * r + 2],
            "broadcast": np.full(3, n - 1.0), "scatter": np.full(2, r),
            "alltoall": np.array([10.0 * j + r for j in range(n)]),
            "new_group": np.full(2, float(n)),
            "psum": np.array([s, 2 * s]), "pmean": np.array([s, 2 * s]) / n,
            "pmax": np.array([n, 2.0 * n]), "pmin": np.array([1.0, 2.0]),
            "pprod": np.array([math.prod(range(1, n + 1)),
                               math.prod(2.0 * j for j in range(1, n + 1))]),
            "gather_tiled": np.concatenate([[j + 1.0, 2.0 * (j + 1)]
                                            for j in range(n)]),
            "gather_stacked": np.stack([[j + 1.0, 2.0 * (j + 1)]
                                        for j in range(n)]),
            "rs": (np.arange(2.0 * n) * s)[2 * r:2 * r + 2],
            "ppermute": x * 0 + (np.array([1.0, 2.0]) if r == n - 1
                                 else 0.0),
            "ring_shift": np.array([(r - 1) % n + 1.0,
                                    2.0 * ((r - 1) % n + 1)]),
            "all_to_all": np.array([100.0 * j + r for j in range(n)]),
            "broadcast_from": np.array([n, 2.0 * n]),
            "shard_map": np.array([s - n + j for j in range(n)])}
    if n > 1:
        want["send_recv"] = np.full(2, 42.0 if r == 1 else float(r))
    return want


def _check_coll(label, results, backend):
    """Every rank's results exact, computed where the tensors live."""
    for res in results:
        r, n = res["rank"], res["world"]
        if res["backend"] != backend or res["where"] != ["cuda"]:
            fail(f"phase 44 {label}: rank {r} ran over {res['backend']} "
                 f"with results on {res['where']}")
        if tuple(res["axis"]) != (r, n):
            fail(f"phase 44 {label}: rank {r} axis {res['axis']}")
        want = _coll_want(r, n)
        if sorted(want) != sorted(res["got"]):
            fail(f"phase 44 {label}: collectives {sorted(res['got'])}")
        for k, w in want.items():
            if not np.array_equal(res["got"][k].astype(np.float64), w):
                fail(f"phase 44 {label}: rank {r} {k} {res['got'][k]} "
                     f"!= {w}")


def _nccl_pair(_payload):
    """Two ranks on one card over NCCL: NCCL's own answer."""
    import paddle_tpu_torch.distributed as dist
    dev = _rank_setup()
    t = torch.ones(4, device=dev)
    try:
        dist.all_reduce(t)
        torch.cuda.synchronize()
        return {"accepted": True, "value": t.cpu().tolist()}
    except RuntimeError as e:           # NCCL's DistBackendError
        return {"accepted": False, "error": f"{type(e).__name__}: {e}"}


def _spawn(fn, payload, nprocs, backend, label):
    from paddle_tpu_torch.distributed.spawn import spawn
    logs = os.path.join(tempfile.gettempdir(),
                        f"chip_smoke_{label}_{os.getpid()}")
    return spawn(fn, args=(payload,), nprocs=nprocs, backend=backend,
                 timeout=COLL_TIMEOUT, join_timeout=RANKS_TIMEOUT,
                 log_dir=logs)


def collectives_phase(dev):
    """Phase 44: (a) world 1 over NCCL in this process, then (b) two ranks
    on the one card over gloo (their CUDA tensors staged through host
    memory), every collective of the collective API and the named-axis
    collectives exact on integer-valued floats; (c) two ranks on the one
    card over NCCL, whose refusal is recorded (if NCCL accepts the pair,
    (b) runs over NCCL too)."""
    from paddle_tpu_torch.distributed import init_parallel_env, parallel
    t0 = time.perf_counter()
    init_parallel_env(backend="nccl", timeout=COLL_TIMEOUT)
    one = _coll_rank(None)
    _check_coll("(a) world 1", [one], "nccl")
    ta = time.perf_counter() - t0
    t0 = time.perf_counter()
    two = _spawn(_coll_rank, None, 2, "gloo", "p44b")
    _check_coll("(b) world 2 gloo", two, "gloo")
    tb = time.perf_counter() - t0
    t0 = time.perf_counter()
    pair = _spawn(_nccl_pair, None, 2, "nccl", "p44c")
    accepted = all(p["accepted"] for p in pair)
    extra = {}
    if accepted:
        log("phase 44 (c): NCCL accepted two ranks on one card; (b) runs "
            "over NCCL too")
        _check_coll("(c) world 2 nccl", _spawn(_coll_rank, None, 2, "nccl",
                                               "p44c2"), "nccl")
    else:
        extra["nccl_refusal"] = [p.get("error", "")[:400] for p in pair]
    res = dict(world1_backend=parallel.backend(), world1_s=ta,
               world2_gloo_s=tb, nccl_pair_accepted=accepted,
               nccl_pair_s=time.perf_counter() - t0,
               collectives=sorted(one["got"]), card=_CARD[0], **extra)
    log("phase 44: " + json.dumps(res))
    return res


def _proxy_arm(dev, ids, steps, stage=0, mdt="float32", offload=False):
    """One arm of phase 45: the proxy from the seed, AdamW(1e-4), bf16
    AMP, ``stage`` / ``mdt`` / ``offload``; ``steps`` steps on ``ids``."""
    from paddle_tpu_torch.distributed.fleet import (DistributedStrategy,
                                                    DistributedTrainStep)
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.text.models import LlamaForCausalLM
    cfg = proxy_config()
    model = LlamaForCausalLM(cfg, device=dev, dtype="float32",
                             generator=torch.Generator(device=dev)
                             .manual_seed(SEED))
    s = DistributedStrategy()
    s.amp = True
    s.amp_configs = {"dtype": "bfloat16"}
    if stage:
        s.sharding = True
        s.sharding_configs = {"stage": stage, "moment_dtype": mdt,
                              "offload": offload}
    opt = AdamW(learning_rate=1e-4, parameters=model.parameters())
    step = DistributedTrainStep(model, _loss_fn(model), opt, s)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    losses, ms = [], []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(step(ids, ids).item())
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    arm = dict(losses=losses, ms_per_step=statistics.median(ms[2:]),
               first_step_ms=ms[0],
               peak_gb=torch.cuda.max_memory_allocated(dev) / 1e9,
               slot_bytes=step.slot_bytes())
    return arm, model, step


def _slot_plan(model, mdt):
    """The AdamW slots' bytes a rank holds at world 1: m and v in their
    at-rest dtype (int8: with a per-row f32 scale), beta1_pow, beta2_pow
    and the decay flag as f32 scalars, a parameter."""
    size = {"float32": 4, "bfloat16": 2, "int8": 1}[mdt]
    total = 0
    for p in model.parameters():
        total += 2 * p.numel() * size + 3 * 4
        if mdt == "int8":
            total += 2 * (p.numel() // p.shape[-1]) * 4
    return total


def zero_world1(dev):
    """Phase 45: the proxy (phase 7's configuration) under
    ``strategy.sharding`` at world 1 over NCCL.  The plain step and stages
    1, 2 and 3 with f32 slots, ``ZERO_STAGE_STEPS`` steps each: bitwise
    phase 7's losses and each other's parameters.  Then stage 1 with
    bf16 and int8 slots and with offloaded f32 slots, ``ZERO_ARM_STEPS``
    steps each: losses within ``ZERO_LOSS_LIMIT`` of phase 7's (the f32
    arm), slot bytes on the card as planned (offload: none, every slot
    pinned host memory), the peak below the f32 arm's by at least half
    the slots saved; ms/step.  Returns the launches and the int8 arm's
    losses."""
    from paddle_tpu_torch.distributed import parallel
    from paddle_tpu_torch.ops.kernels import registry
    if parallel.backend() != "nccl":
        fail(f"phase 45: world 1 runs over {parallel.backend()}")
    cfg = proxy_config()
    ids = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ)).astype("int32")).to(dev)
    ref = _LOSSES["train"]
    registry.reset_counts()                  # the main path starts here
    arms, steps_run, base = {}, 0, None
    for name, stage in (("plain", 0), ("stage 1", 1), ("stage 2", 2),
                        ("stage 3", 3)):
        arm, model, step = _proxy_arm(dev, ids, ZERO_STAGE_STEPS, stage)
        steps_run += ZERO_STAGE_STEPS
        if arm["losses"] != ref[:ZERO_STAGE_STEPS]:
            fail(f"phase 45: {name}: losses {arm['losses']} are not "
                 f"phase 7's {ref[:ZERO_STAGE_STEPS]} bitwise")
        params = [p.detach().cpu() for p in model.parameters()]
        if base is None:
            base = params
        elif not all(torch.equal(a, b) for a, b in zip(base, params)):
            fail(f"phase 45: {name}: parameters are not the plain step's "
                 "bitwise")
        arms[name] = arm
        f32_plan = _slot_plan(model, "float32")
        del model, step, params
        gc.collect()
        torch.cuda.empty_cache()
    f32 = arms["stage 1"]
    if f32["slot_bytes"]["device"] != f32_plan:
        fail(f"phase 45: f32 slots {f32['slot_bytes']} != plan {f32_plan}")
    for name, mdt, offload in (("bfloat16", "bfloat16", False),
                               ("int8", "int8", False),
                               ("offload", "float32", True)):
        arm, model, step = _proxy_arm(dev, ids, ZERO_ARM_STEPS, 1, mdt,
                                      offload)
        steps_run += ZERO_ARM_STEPS
        plan = _slot_plan(model, mdt)
        dist_ = max(abs(a - b) for a, b in zip(arm["losses"], ref))
        arm.update(loss_dist_vs_f32=dist_, limit=ZERO_LOSS_LIMIT[name],
                   slot_plan=plan)
        if not all(math.isfinite(x) for x in arm["losses"]):
            fail(f"phase 45: {name}: non-finite losses {arm['losses']}")
        if dist_ > ZERO_LOSS_LIMIT[name]:
            fail(f"phase 45: {name}: losses {dist_:.4g} from f32's, limit "
                 f"{ZERO_LOSS_LIMIT[name]}")
        sb = arm["slot_bytes"]
        if offload:
            pinned = all(v.device.type == "cpu" and v.is_pinned()
                         for st in step._opt.opt_state()
                         for v in st.values())
            if sb["device"] or sb["host"] or sb["pinned"] != plan \
                    or not pinned:
                fail(f"phase 45: offload slots {sb} (plan: 0 on the card, "
                     f"{plan} pinned; every slot pinned: {pinned})")
            saved = f32_plan
        else:
            if sb["device"] != plan:
                fail(f"phase 45: {name} slots {sb} != plan {plan}")
            saved = f32_plan - plan
        fall = (f32["peak_gb"] - arm["peak_gb"]) * 1e9
        arm["peak_fall_gb"] = fall / 1e9
        arm["slots_saved_gb"] = saved / 1e9
        if fall < saved / 2:
            fail(f"phase 45: {name}: the peak fell {fall / 1e9:.3f} GB, "
                 f"less than half the {saved / 1e9:.3f} GB saved")
        arms[name] = arm
        del model, step
        gc.collect()
        torch.cuda.empty_cache()
    counts = registry.launch_counts()        # ... and ends here
    want = dict.fromkeys(counts, 0.0)
    want.update({"flash_attention": 2.0 * cfg.num_hidden_layers,
                 "flash_attention_bwd_dkv": float(cfg.num_hidden_layers),
                 "flash_attention_bwd_dq": float(cfg.num_hidden_layers)})
    per_step = {k: c / steps_run for k, c in counts.items()}
    if per_step != want:
        fail(f"phase 45: launches a step {per_step}, want {want}")
    log("phase 45: " + json.dumps(dict(arms=arms, f32_slot_plan=f32_plan,
                                       launches=counts, card=_CARD[0])))
    return counts, arms["int8"]["losses"]


def _zero_rank(payload):
    """One rank of phase 46: each arm from the seed on this rank's rows
    of the global batch; the global loss and the parameters' digests
    after every step, the rows held against ``sharded_numel``."""
    from paddle_tpu_torch.distributed import mesh as mesh_mod
    from paddle_tpu_torch.distributed.fleet import (DistributedStrategy,
                                                    DistributedTrainStep)
    from paddle_tpu_torch.distributed.spec_layout import get_layout
    from paddle_tpu_torch.ops.kernels import registry
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.text.models import LlamaForCausalLM
    dev = _rank_setup()
    cfg = proxy_config()
    ids = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ)).astype("int32")).to(dev)
    out = {}
    for name, degrees, stage, mdt in payload["arms"]:
        mesh = mesh_mod.init_mesh(degrees)
        model = LlamaForCausalLM(cfg, device=dev, dtype="float32",
                                 generator=torch.Generator(device=dev)
                                 .manual_seed(SEED))
        s = DistributedStrategy()
        s.amp = True
        s.amp_configs = {"dtype": "bfloat16"}
        if stage:
            s.sharding = True
            s.sharding_configs = {"stage": stage, "moment_dtype": mdt}
        opt = AdamW(learning_rate=1e-4, parameters=model.parameters())
        step = DistributedTrainStep(model, _loss_fn(model), opt, s,
                                    mesh=mesh)
        rows = ids[mesh_mod.batch_spec(TRAIN_BATCH, mesh)]
        torch.cuda.reset_peak_memory_stats(dev)
        registry.reset_counts()
        losses, digests, ms = [], [], []
        for _ in range(payload["steps"]):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses.append(step(rows, rows).item())
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            digests.append(_digest(list(step.full_parameters().values())))
        counts = registry.launch_counts()
        lay, held = get_layout(), []
        for n, p, shape in zip(step._names, step._params,
                               step._full_shapes):
            want_p = lay.sharded_numel(shape, step.param_specs[n],
                                       mesh.shape)
            want_s = lay.sharded_numel(shape, step.slot_specs[n],
                                       mesh.shape)
            st = opt._accumulators[id(p)]
            ok = p.numel() == want_p and st["m"].numel() == want_s \
                and st["v"].numel() == want_s
            held.append((n, ok, p.numel(), want_p, st["m"].numel(),
                         want_s))
        out[name] = dict(losses=losses, digests=digests, ms=ms,
                         counts=counts, held=held, rows=str(rows.shape),
                         peak_gb=torch.cuda.max_memory_allocated(dev) / 1e9,
                         slot_bytes=step.slot_bytes())
        del model, step, opt
        gc.collect()
        torch.cuda.empty_cache()
    return out


def zero_world2(dev, int8_losses):
    """Phase 46: the proxy at world 2 on the one card over gloo, each rank
    batch 2 of phase 7's global batch 4: dp 2 (no ZeRO) and fsdp 2 at
    stage 3 with int8 slots, ``ZERO_W2_STEPS`` steps each.  The two ranks'
    parameters bitwise equal after every step; the losses within
    ``ZERO_W2_LIMIT`` of the world-1 runs of the same global batches
    (phase 7, phase 45's int8 arm); under stage 3 each rank holds
    ``sharded_numel`` of every parameter and slot; ms/step (host-staged,
    no target).  Returns the ranks' launches."""
    t0 = time.perf_counter()
    arms = [("dp2", {"dp": 2}, 0, "float32"),
            ("fsdp2_int8", {"fsdp": 2}, 3, "int8")]
    res = _spawn(_zero_rank, {"arms": arms, "steps": ZERO_W2_STEPS}, 2,
                 "gloo", "p46")
    total = collections.Counter()
    summary = {}
    ref = {"dp2": _LOSSES["train"], "fsdp2_int8": int8_losses}
    L = proxy_config().num_hidden_layers
    for name, *_ in arms:
        a, b = res[0][name], res[1][name]
        if a["digests"] != b["digests"]:
            fail(f"phase 46: {name}: the ranks' parameters differ")
        if a["losses"] != b["losses"]:
            fail(f"phase 46: {name}: the ranks' losses differ")
        d = max(abs(x - y) for x, y in zip(a["losses"], ref[name]))
        if not all(math.isfinite(x) for x in a["losses"]) \
                or d > ZERO_W2_LIMIT[name]:
            fail(f"phase 46: {name}: losses {a['losses']} {d:.4g} from "
                 f"world 1's, limit {ZERO_W2_LIMIT[name]}")
        bad = [h for r in res for h in r[name]["held"] if not h[1]]
        if bad:
            fail(f"phase 46: {name}: rows held != sharded_numel: {bad[:3]}")
        for r in res:
            c = r[name]["counts"]
            want = dict.fromkeys(c, 0)
            want.update({"flash_attention": 2 * L * ZERO_W2_STEPS,
                         "flash_attention_bwd_dkv": L * ZERO_W2_STEPS,
                         "flash_attention_bwd_dq": L * ZERO_W2_STEPS})
            if c != want:
                fail(f"phase 46: {name}: launches {c}, want {want}")
            total.update(c)
        summary[name] = dict(losses=a["losses"], loss_dist_vs_world1=d,
                             limit=ZERO_W2_LIMIT[name],
                             ms_per_step=[statistics.median(r[name]["ms"])
                                          for r in res],
                             peak_gb=[r[name]["peak_gb"] for r in res],
                             slot_bytes=[r[name]["slot_bytes"]
                                         for r in res],
                             rows=a["rows"])
    log("phase 46: " + json.dumps(dict(arms=summary, card=_CARD[0],
                                       seconds=time.perf_counter() - t0)))
    return dict(total)


def _dgc_rank(payload):
    """One rank of phase 47 (b): ResNet-50 with DGC on this rank's rows of
    the bench's batch; the global loss and the parameters' digests after
    every step."""
    from paddle_tpu_torch.distributed import mesh as mesh_mod
    dev = _rank_setup()
    model, step = _resnet_train_step(dev, dgc=payload["dgc"])
    img, label = _resnet_batch(dev, RESNET_TRAIN["batch"])
    rows = mesh_mod.batch_spec(RESNET_TRAIN["batch"])
    img, label = img[rows].contiguous(), label[rows].contiguous()
    losses, digests, ms = [], [], []
    for _ in range(payload["steps"]):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(float(step(img, label)))
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        digests.append(_digest(list(model.parameters())))
    return dict(losses=losses, digests=digests, ms=ms,
                buffers=_digest([b for b in model.buffers()
                                 if b.is_floating_point()]),
                batch=int(img.shape[0]))


def dgc_phase(dev):
    """Phase 47: DGC on ResNet-50 at the bench's configuration (batch 256,
    224x224, Momentum(0.1, 0.9), bf16 AMP, cross entropy) with
    ``DGC_CFG``.  (a) world 1 over NCCL, ``DGC_STEPS`` steps: steps 0-1
    bitwise phase 24's dense steps; from step 2 each tensor sends exactly
    k = max(1, round(n * 0.001)) entries, u and v zero where it sent;
    losses finite; ``guard_health`` with DGC still raises.  (b) world 2
    over gloo on the one card, batch 128 a rank, ``DGC_W2_STEPS`` steps:
    the ranks bitwise equal, the losses within ``DGC_W2_LIMIT`` of (a)'s
    first steps.  No kernel runs here, in the reference as in the port."""
    from paddle_tpu_torch.distributed.fleet.dgc import topk_count
    from paddle_tpu_torch.ops.kernels import registry
    t0 = time.perf_counter()
    model, step = _resnet_train_step(dev, dgc=DGC_CFG)
    img, label = _resnet_batch(dev, RESNET_TRAIN["batch"])
    registry.reset_counts()
    losses, ms, sent = [], [], []
    for i in range(DGC_STEPS):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        losses.append(float(step(img, label)))
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t1) * 1e3)
        masks = step.last_dgc_masks
        step.last_dgc_masks = None
        if i < DGC_CFG["rampup_begin_step"]:
            if masks is not None:
                fail(f"phase 47: step {i} compressed during warm-up")
            continue
        total = 0
        for n, p in zip(step._names, step._params):
            k = topk_count(p.numel(), DGC_CFG["sparsity"][0])
            m = masks[n]
            if int(m.sum()) != k:
                fail(f"phase 47: step {i}: {n} sent {int(m.sum())}, "
                     f"want {k}")
            if step._dgc_state["u"][n][m].any() or \
                    step._dgc_state["v"][n][m].any():
                fail(f"phase 47: step {i}: {n}: u or v not zero where "
                     "it sent")
            total += k
        sent.append(total)
    counts = registry.launch_counts()
    if not all(math.isfinite(x) for x in losses):
        fail(f"phase 47: non-finite losses {losses}")
    warm = DGC_CFG["rampup_begin_step"]
    if losses[:warm] != _LOSSES["resnet"][:warm]:
        fail(f"phase 47: warm-up losses {losses[:warm]} are not phase "
             f"24's {_LOSSES['resnet'][:warm]} bitwise")
    if any(counts.values()):
        fail(f"phase 47: kernels ran: {counts}")
    nparams = sum(p.numel() for p in step._params)
    del model, step
    gc.collect()
    torch.cuda.empty_cache()
    try:
        _resnet_train_step(dev, dgc=DGC_CFG, guard_health=True)
        fail("phase 47: guard_health with DGC did not raise")
    except NotImplementedError as e:
        refused = str(e)[:80]
    gc.collect()
    torch.cuda.empty_cache()
    ta = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = _spawn(_dgc_rank, {"dgc": DGC_CFG, "steps": DGC_W2_STEPS}, 2,
                 "gloo", "p47")
    a, b = res
    if a["digests"] != b["digests"] or a["losses"] != b["losses"] \
            or a["buffers"] != b["buffers"]:
        fail("phase 47 (b): the ranks' parameters, losses or buffers "
             "differ")
    d = max(abs(x - y) for x, y in zip(a["losses"], losses))
    if d > DGC_W2_LIMIT:
        fail(f"phase 47 (b): losses {a['losses']} {d:.4g} from (a)'s, "
             f"limit {DGC_W2_LIMIT}")
    out = dict(world1=dict(losses=losses, ms_per_step=statistics.median(
        ms[2:]), sent_a_step=sent, params=nparams,
        sent_share=sent[-1] / nparams, guard_refusal=refused, seconds=ta),
               world2=dict(losses=a["losses"], loss_dist_vs_world1=d,
                           limit=DGC_W2_LIMIT, batch_a_rank=a["batch"],
                           ms_per_step=[statistics.median(r["ms"][1:])
                                        for r in res],
                           seconds=time.perf_counter() - t0),
               card=_CARD[0])
    log("phase 47: " + json.dumps(out))
    return counts


# ---------------------------------------------------------------------
# phases 48-51: model parallelism in the step (tp, sp, pp; world 4)
# ---------------------------------------------------------------------

MP_STEPS = 3                  # phases 48-50: steps an arm
MP_W4_STEPS = 2               # phase 51
# the largest distance of an arm's losses from phase 7's (world 1, the
# same weights and batch, bf16 AMP) over its steps, 3x its first reading
# on an NVIDIA H100 80GB HBM3 at 700 W (tp 2 1.433e-3: the row-parallel
# products' bf16 partial sums added across ranks; sp 2 ring 2.437e-3,
# Ulysses 2.021e-3: f32 attention against the kernel's bf16 P; pp 2
# 1.450e-4; tp 2 x pp 2 1.363e-3; fsdp 2 x pp 2 1.431e-5)
TP_W2_LIMIT = 4.3e-3
SP_W2_LIMIT = {"ring": 7.3e-3, "ulysses": 6.1e-3}
PP_W2_LIMIT = 4.4e-4
W4_LIMIT = {"tp2_pp2": 4.1e-3, "fsdp2_pp2": 4.3e-5}
# the relative distance of an arm's first reduced gradient's norm
# (``guard_health``) from phase 7's at the same weights and batch, 3x its
# first reading on that card (tp 2 2.009e-5; ring 1.308e-4, Ulysses
# 1.123e-4; pp 2 3.381e-6; tp 2 x pp 2 1.814e-5; fsdp 2 x pp 2
# 1.690e-6): a stray factor of tp, sp or pp in the gradients, which
# AdamW's steps do not show, moves it by 0.5 or more
MP_GRAD_NORM_LIMIT = {"tp2": 6.1e-5, "ring": 4.0e-4, "ulysses": 3.4e-4,
                      "pp2": 1.1e-5, "tp2_pp2": 5.5e-5, "fsdp2_pp2": 5.1e-6}
# phase 50: 1F1B against GPipe on the same stage weights (bf16) and
# batch: the loss's relative distance, and each gradient's (this
# stage's layers, the embedded input's) relative 2-norm distance, 3x the
# first reading on that card (8.61e-8; 1.164e-2 on stage 0, 5.63e-3 on
# stage 1: bf16 gradients of one arithmetic in two schedules)
PP_1F1B_LIMIT = {"loss": 2.6e-7, "grad": 3.5e-2}
# the arms: (name, mesh degrees, config flags, strategy, steps)
MP_ARMS = {
    48: [("tp2", {"tp": 2}, {}, {"tensor_parallel": True}, MP_STEPS)],
    49: [("ring", {"sp": 2}, {"sequence_parallel": True,
                              "context_parallel": "ring"},
          {"sequence_parallel": True}, MP_STEPS),
         ("ulysses", {"sp": 2}, {"sequence_parallel": True,
                                 "context_parallel": "ulysses"},
          {"sequence_parallel": True}, MP_STEPS)],
    50: [("pp2", {"pp": 2}, {"pp_num_microbatches": 4}, {"pipeline": True},
          MP_STEPS)],
    51: [("tp2_pp2", {"tp": 2, "pp": 2}, {"pp_num_microbatches": 4},
          {"tensor_parallel": True, "pipeline": True}, MP_W4_STEPS),
         ("fsdp2_pp2", {"fsdp": 2, "pp": 2}, {"pp_num_microbatches": 2},
          {"pipeline": True, "sharding": True,
           "sharding_configs": {"stage": 3}}, MP_W4_STEPS)],
}


def _mp_step(dev, degrees, cfg_kw, strat_kw):
    """The proxy from phase 7's seed built under the mesh (each rank its
    blocks), AdamW(1e-4), bf16 AMP, the arm's strategy; ``guard_health``
    leaves each step's norm of the reduced gradient."""
    from paddle_tpu_torch.distributed import mesh as mesh_mod
    from paddle_tpu_torch.distributed.fleet import (DistributedStrategy,
                                                    DistributedTrainStep)
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.text.models import LlamaForCausalLM
    mesh = mesh_mod.init_mesh(degrees)
    model = LlamaForCausalLM(proxy_config(**cfg_kw), device=dev,
                             dtype="float32",
                             generator=torch.Generator(device=dev)
                             .manual_seed(SEED))
    s = DistributedStrategy()
    s.amp = True
    s.amp_configs = {"dtype": "bfloat16"}
    for k, v in strat_kw.items():
        setattr(s, k, v)
    opt = AdamW(learning_rate=1e-4, parameters=model.parameters())
    return mesh, model, opt, DistributedTrainStep(
        model, _loss_fn(model), opt, s, mesh=mesh, guard_health=True)


def _mp_held(step, opt, mesh):
    """Each parameter and AdamW slot this rank holds against
    ``sharded_numel`` of its spec; the slot bytes the plan gives (m and v
    in f32, three f32 scalars a parameter)."""
    from paddle_tpu_torch.distributed.spec_layout import get_layout
    lay, bad, plan = get_layout(), [], 0
    for n, p, g in zip(step._names, step._params, step._global_shapes):
        want_p = lay.sharded_numel(g, step.param_specs[n], mesh.shape)
        want_s = lay.sharded_numel(g, step.slot_specs[n], mesh.shape)
        st = opt._accumulators[id(p)]
        if p.numel() != want_p or st["m"].numel() != want_s \
                or st["v"].numel() != want_s:
            bad.append((n, p.numel(), want_p, st["m"].numel(), want_s))
        plan += 2 * want_s * 4 + 3 * 4
    return bad, plan


def _one_f_one_b(dev, model, ids, M):
    """Phase 50 (b): GPipe and 1F1B on this stage's stacked decoder
    (its bf16 layers) and the embedded batch, the head and loss of a
    microbatch on every stage: the losses, this stage's layer gradients
    and the input's gradient of both."""
    from paddle_tpu_torch.distributed import pipeline as pl
    from paddle_tpu_torch.text.models.llama import _causal_lm_loss
    dec = model.model.decoder
    stacked = [getattr(dec, n.replace(".", "__")).detach()
               .to(torch.bfloat16) for n in dec._names]
    B, S = ids.shape
    pos = torch.arange(S, dtype=torch.int32, device=dev)[None, :]
    with torch.no_grad():
        hidden = model.model.embed_tokens(ids).to(torch.bfloat16)

    def head(h, y):
        return _causal_lm_loss(model._logits(model.model.norm(h)), y)

    ps = [t.clone().requires_grad_() for t in stacked]
    h = hidden.clone().requires_grad_()
    out = pl.pipeline_apply(lambda p, hh, e: dec._stage(p, hh, e, None), ps,
                            h, pos.expand(B, S), num_microbatches=M)
    g_loss = head(out, ids)
    g_grads = torch.autograd.grad(g_loss, ps + [h])
    f_loss, f_d, f_dx = pl.pipeline_train_1f1b(
        lambda p, hh: dec._stage(p, hh, pos.expand(B // M, S), None),
        stacked, hidden, ids, head, num_microbatches=M)
    rel = [float((a.float() - b.float()).norm()
                 / b.float().norm().clamp_min(1e-30))
           for a, b in zip(list(f_d) + [f_dx], g_grads)]
    return dict(gpipe_loss=float(g_loss), f1b_loss=float(f_loss),
                loss_rel=abs(float(f_loss) - float(g_loss))
                / abs(float(g_loss)), grad_rel=max(rel),
                ticks={"gpipe": pl.schedule_ticks(M, 2, "gpipe"),
                       "1f1b": pl.schedule_ticks(M, 2, "1F1B")},
                ring_size=pl.ring_size(M, 2))


def _mp_rank(payload):
    """One rank of phases 48-51: each arm from the seed on this rank's
    rows (the step cuts the sequence under sp), its steps with the global
    loss, ms, the reduced gradient's norm and every parameter's digest
    (this rank's block, gathered over fsdp) after each, launches, what it holds against the plan,
    peak memory; phase 50's 1F1B comparison after its steps."""
    from paddle_tpu_torch.distributed import mesh as mesh_mod
    from paddle_tpu_torch.ops.kernels import registry
    dev = _rank_setup()
    cfg = proxy_config()
    ids = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ)).astype("int32")).to(dev)
    out = {}
    for name, degrees, cfg_kw, strat_kw, steps in payload["arms"]:
        torch.cuda.reset_peak_memory_stats(dev)
        mesh, model, opt, step = _mp_step(dev, degrees, cfg_kw, strat_kw)
        rows = ids[mesh_mod.batch_spec(TRAIN_BATCH, mesh)]
        layers = model.model.decoder.input_layernorm__weight.shape[0]
        registry.reset_counts()
        losses, digests, ms, norms = [], [], [], []
        for _ in range(steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses.append(step(rows, rows).item())
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            norms.append(float(step.last_health[0]))
            full = step.full_parameters()
            digests.append({n: _digest([full[n]])[0] for n in full})
        counts = registry.launch_counts()
        bad, plan = _mp_held(step, opt, mesh)
        arm = dict(losses=losses, digests=digests, ms=ms, counts=counts,
                   grad_norms=norms,
                   held_bad=bad, slot_plan=plan,
                   slot_bytes=step.slot_bytes(), layers=layers,
                   coords=mesh.coords, rows=list(rows.shape),
                   specs={n: step.param_specs[n] for n in step._names},
                   peak_gb=torch.cuda.max_memory_allocated(dev) / 1e9)
        if payload.get("one_f_one_b"):
            registry.reset_counts()
            arm["f1b"] = _one_f_one_b(dev, model, rows,
                                      cfg_kw["pp_num_microbatches"])
        out[name] = arm
        del model, step, opt
        gc.collect()
        torch.cuda.empty_cache()
    return out


def _mp_check(phase, name, res, limit, want_per_step):
    """The ranks of one arm: finite losses, the same on every rank, within
    ``limit`` of phase 7's; the first step's gradient norm on every rank
    within ``MP_GRAD_NORM_LIMIT`` of phase 7's; the blocks two ranks share
    bitwise equal after every step; every rank holding ``sharded_numel``;
    launches a step a rank ``want_per_step``.  Returns the arm's
    summary."""
    arms = [r[name] for r in res]
    a = arms[0]
    for r in arms[1:]:
        if r["losses"] != a["losses"]:
            fail(f"phase {phase}: {name}: the ranks' losses differ: "
                 f"{[x['losses'] for x in arms]}")
    ref = _LOSSES["train"]
    d = max(abs(x - y) for x, y in zip(a["losses"], ref))
    if not all(math.isfinite(x) for x in a["losses"]) or d > limit:
        fail(f"phase {phase}: {name}: losses {a['losses']} {d:.4g} from "
             f"phase 7's, limit {limit}")
    ref_norm = _GRAD_NORM["train"]
    norms = [r["grad_norms"][0] for r in arms]
    dn = max(abs(x - ref_norm) / ref_norm for x in norms)
    if not all(math.isfinite(x) for x in norms) or \
            dn > MP_GRAD_NORM_LIMIT[name]:
        fail(f"phase {phase}: {name}: first gradient norms {norms}, "
             f"{dn:.4g} from phase 7's {ref_norm} (relative), limit "
             f"{MP_GRAD_NORM_LIMIT[name]}")
    for i in range(len(a["losses"])):
        blocks = {}
        for r in arms:
            for n, dg in r["digests"][i].items():
                spec = r["specs"][n]
                key = (n,) + tuple(r["coords"][ax] for ent in spec
                                   for ax in ((ent,) if isinstance(ent, str)
                                              else (ent or ()))
                                   if ax != "fsdp")
                if blocks.setdefault(key, dg) != dg:
                    fail(f"phase {phase}: {name}: step {i}: ranks holding "
                         f"the same block of {n} differ")
    bad = [b for r in arms for b in r["held_bad"]]
    if bad:
        fail(f"phase {phase}: {name}: held != sharded_numel: {bad[:3]}")
    for r in arms:
        c = r["counts"]
        steps = len(r["losses"])
        want = dict.fromkeys(c, 0)
        want.update({k: v * steps for k, v in want_per_step.items()})
        if c != want:
            fail(f"phase {phase}: {name}: launches {c}, want {want}")
    return dict(losses=a["losses"], loss_dist_vs_world1=d, limit=limit,
                first_grad_norms=norms, world1_grad_norm=ref_norm,
                grad_norm_rel_dist=dn,
                grad_norm_limit=MP_GRAD_NORM_LIMIT[name],
                ms_per_step=[statistics.median(r["ms"][1:] or r["ms"])
                             for r in arms],
                first_step_ms=[r["ms"][0] for r in arms],
                peak_gb=[r["peak_gb"] for r in arms],
                slot_bytes=[r["slot_bytes"]["device"] for r in arms],
                slot_plan=[r["slot_plan"] for r in arms],
                layers_a_rank=[r["layers"] for r in arms],
                rows=a["rows"], launches_a_rank=arms[0]["counts"])


def _flash_want(per_step):
    return {"flash_attention": 2 * per_step,
            "flash_attention_bwd_dkv": per_step,
            "flash_attention_bwd_dq": per_step}


def model_parallel(phase):
    """Phases 48-51 (module docstring): the arms of ``MP_ARMS[phase]`` in
    rank processes on the one card over gloo, each checked by
    ``_mp_check``.  Returns the ranks' launches summed."""
    t0 = time.perf_counter()
    arms = MP_ARMS[phase]
    world = math.prod(arms[0][1].values())
    res = _spawn(_mp_rank, {"arms": arms, "one_f_one_b": phase == 50},
                 world, "gloo", f"p{phase}")
    L = proxy_config().num_hidden_layers
    summary, total = {}, collections.Counter()
    for name, degrees, cfg_kw, _, _ in arms:
        pp = degrees.get("pp", 1)
        M = cfg_kw.get("pp_num_microbatches", 1) if pp > 1 else 1
        if cfg_kw.get("context_parallel"):
            per = dict.fromkeys(_flash_want(0), 0)
            limit = SP_W2_LIMIT[name]
        else:
            # a stage computes its M ticks x its L / pp layers: the
            # forward, its recompute and the backward of each
            per = _flash_want(M * L // pp)
            limit = {48: TP_W2_LIMIT, 50: PP_W2_LIMIT}.get(phase) or \
                W4_LIMIT[name]
        s = _mp_check(phase, name, res, limit, per)
        s["launches_predicted_a_step"] = per
        if pp > 1 and any(r[name]["layers"] != L // pp for r in res):
            fail(f"phase {phase}: {name}: stages hold "
                 f"{[r[name]['layers'] for r in res]} layers, not {L // pp}")
        if phase == 51:
            if any(r[name]["slot_bytes"]["device"] != r[name]["slot_plan"]
                   for r in res):
                fail(f"phase 51: {name}: slot bytes {s['slot_bytes']} != "
                     f"plan {s['slot_plan']}")
        for r in res:
            total.update(r[name]["counts"])
        if phase == 50:
            f = [r[name]["f1b"] for r in res]
            s["one_f_one_b"] = f
            for x in f:
                if x["loss_rel"] > PP_1F1B_LIMIT["loss"] or \
                        x["grad_rel"] > PP_1F1B_LIMIT["grad"]:
                    fail(f"phase 50: 1F1B against GPipe: {x}, limit "
                         f"{PP_1F1B_LIMIT}")
        summary[name] = s
    log(f"phase {phase}: " + json.dumps(dict(
        arms=summary, card=_CARD[0], seconds=time.perf_counter() - t0)))
    return dict(total)


def log_bwd_entries(bwd):
    """Phase 2's line for each sm90 backward entry (``check_ptxas``'s
    {mangled name: [registers, spill bytes]}): its kernel, head_dim and
    dropout (the template's third argument: 0 none, 1 Philox, 2 the keep
    bits dK/dV wrote), registers and plan.  The shared memory is dynamic
    (ptxas does not see it), and the warps run at the registers
    setmaxnreg gives them, not at the count ptxas prints for the
    launch."""
    from paddle_tpu_torch.ops.kernels.flash_attention import flash_bwd_plan
    for name, (regs, _, _) in sorted(bwd.items()):
        dkv, hd, drop = re.search(r"sm90ILb([01])ELi(\d+)ELi(\d)E",
                                  name).groups()
        m = torch.empty(1, 1, 2048, int(hd), dtype=torch.bfloat16,
                        device="meta")
        bplan = flash_bwd_plan(m, m, m, m, causal=True,
                               dropout_p=0.1 if drop != "0" else 0.0).dkv
        how = {"0": "", "1": ", dropout (Philox, writes the keep bits)",
               "2": ", dropout (reads the keep bits)"}[drop]
        warps = ("every warp at 168, no setmaxnreg" if drop == "2" else
                 "a producer warpgroup at 40 by setmaxnreg, two consumer "
                 "warpgroups at 232")
        log(f"  flash_bwd_sm90 ({'dK/dV' if dkv == '1' else 'dQ'}, head_dim "
            f"{hd}{how}): {regs} registers at launch ({warps}), no spill; "
            f"{bplan.threads} threads, {bplan.smem_bytes} B dynamic shared "
            f"memory, {bplan.block_res} resident rows, {bplan.block_str}-row "
            f"streamed tiles, {bplan.stages} stages")


def log_tf32_entries(tf):
    """Phase 2's line for each f32 forward entry (``check_ptxas``'s
    {mangled name: [registers, spill bytes]}): head_dim, option,
    registers and plan (the shared memory is dynamic: ptxas does not see
    it)."""
    from paddle_tpu_torch.ops.kernels.flash_attention import flash_fwd_plan
    for name, (regs, _, _) in sorted(tf.items()):
        hd, bias, drop = re.search(r"tf32x3ILi(\d+)ELb([01])ELb([01])E",
                                   name).groups()
        m = torch.empty(1, 1, 2048, int(hd), device="meta")
        plan = flash_fwd_plan(m, m, m, bias=(
            torch.empty(1, 1, 1, 2048, device="meta") if bias == "1"
            else None), dropout_p=0.1 if drop == "1" else 0.0)
        how = (", the bias row" if bias == "1" else ", dropout"
               if drop == "1" else "")
        log(f"  flash_fwd_tf32x3 (f32, head_dim {hd}{how}): {regs} "
            f"registers, no spill; {plan.threads} threads, "
            f"{plan.smem_bytes} B dynamic shared memory, {plan.block_q} "
            f"query rows x {plan.block_k} keys, {plan.stages} K/V stages")


def ptxas_entries(source, match):
    """{mangled name: [registers, spill-store bytes, spill-load bytes]} of
    the entries whose name contains ``match`` in ``source``'s ``ptxas
    -v`` log (kept beside a cached library; empty without one).  Also
    read by ``paddle_tpu_torch/tools/flash_times.py``."""
    from paddle_tpu_torch.ops.kernels import _build
    found, cur = {}, None
    for line in (_build.build_logs.get(source) or "").splitlines():
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
    return found


def rows_hmma_counts():
    """{mangled name: HMMA instructions in its SASS} of the many-row
    route's entries (``cuobjdump -sass`` of the built library,
    ``tools/sass_counts.py``): its scores and P.V run on the tensor
    cores."""
    from paddle_tpu_torch.ops.kernels import _build
    from paddle_tpu_torch.tools import sass_counts
    (lib,) = _build.build(["int8_kv_attention.cu"])
    return {name: sum(c for op, c in ops.items() if op.startswith("HMMA"))
            for name, ops in sass_counts.sass_opcodes(lib).items()
            if "int8_kv_rows" in name}


def check_ptxas(source, match, entries=None):
    """Phase 2's check of one source's ``ptxas -v`` log (kept beside a
    cached library, :func:`ptxas_entries`): fails without a log, on a
    spill in an entry whose name contains ``match``, or on a wgmma that
    ptxas serialised; with ``entries``, unless that many entries match.
    Returns the matching entries' [registers, spill-store bytes,
    spill-load bytes]."""
    from paddle_tpu_torch.ops.kernels import _build
    text = _build.build_logs.get(source) or ""
    found = ptxas_entries(source, match)
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
    _CARD[0] = smi
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
    # six sm90 backward entries: dK/dV and dQ at head_dim 128 without
    # dropout, at head_dim 64 with and without it
    bwd = check_ptxas("flash_attention_bwd.cu", "flash_bwd_sm90", entries=6)
    # four sm90 forward entries, whose consumers keep S, O and P (and the
    # keep bits) in registers: head_dim 128 without options, head_dim 64
    # without them, with the bias row and with dropout
    fwd = check_ptxas("flash_attention_fwd.cu", "flash_fwd_sm90", entries=4)
    # nine f32 forward entries (head_dim 64, 128, 256; without an
    # option, with the bias row, with dropout), which keep S, O and, at
    # head_dim 64, Q's split fragments in registers
    tf = check_ptxas("flash_attention_fwd.cu", "flash_fwd_tf32x3",
                     entries=9)
    # kernel 6's dynamic mode keeps its s32 sums in registers for a whole
    # item: four instantiations (64 or 128 columns, bf16 or f32 output)
    mm = check_ptxas("int8_matmul.cu", "int8_mm_sm90", entries=4)
    # its weight-only mode keeps mma.sync or wgmma fragments or FMA tiles
    # in registers: nine entries (bf16 at 8 to 128 rows of x, f32 at 8 to 64)
    wo = check_ptxas("int8_matmul.cu", "int8_wonly", entries=9)
    for name, (regs, _, _) in sorted(wo.items()):
        log(f"  int8_wonly ({name[-36:]}): {regs} registers, no spill")
    # kernel 4 (every S) keeps its scores, P and the chunk's acc fragments
    # in registers: twenty entries (1, 2, 4 or 8 slabs at head_dim 64 and
    # 128, 1 and 2 at 256; both dtypes), each with its products on the
    # tensor cores (HMMA in its SASS)
    kvr = check_ptxas("int8_kv_attention.cu", "int8_kv_rows", entries=20)
    hmma = rows_hmma_counts()
    for name, (regs, _, _) in sorted(kvr.items()):
        q, d, w = re.search(r"rowsI(f|13__nv_bfloat16)Li(\d+)ELi(\d)E",
                            name).groups()
        if hmma.get(name, 0) < 1:
            fail(f"int8_kv_rows ({name}): no HMMA in its SASS ({hmma})")
        log(f"  int8_kv_rows ({'f32' if q == 'f' else 'bf16'} q, head_dim "
            f"{d}, {w} slabs): {regs} registers, no spill; "
            f"{hmma[name]} HMMA instructions in its SASS")
    for name, (regs, _, _) in sorted(mm.items()):
        log(f"  int8_mm_sm90 ({name[-40:]}): {regs} registers, no spill")
    from paddle_tpu_torch.ops.kernels.flash_attention import flash_fwd_plan
    log_bwd_entries(bwd)
    log_tf32_entries(tf)
    # kernels 1-3's option instantiations (bias row, dropout: template
    # argument kOpt true) keep their Philox state and fragments in
    # registers: a spill would put them in local memory
    for src in ("flash_attention_fwd.cu", "flash_attention_bwd.cu"):
        for name, (regs, _, _) in sorted(check_ptxas(src, "Lb1E").items()):
            if "sm90" not in name and "tf32x3" not in name:
                short = re.search(r"\d(flash_[a-z0-9_]+I.*?)EEv", name)
                log(f"  {short.group(1) if short else name}: {regs} "
                    "registers, no spill")
    for name, (regs, _, _) in sorted(fwd.items()):
        hd, bias, drop = re.search(r"sm90ILi(\d+)ELb([01])ELb([01])E",
                                   name).groups()
        m = torch.empty(1, 1, 2048, int(hd), dtype=torch.bfloat16,
                        device="meta")
        plan = flash_fwd_plan(m, m, m, bias=(
            torch.empty(1, 1, 1, 2048, dtype=torch.bfloat16, device="meta")
            if bias == "1" else None), dropout_p=0.1 if drop == "1" else 0.0)
        how = (", the bias row" if bias == "1" else ", dropout (Philox in "
               "the producer and the consumers)" if drop == "1" else "")
        log(f"  flash_fwd_sm90 (head_dim {hd}{how}): {regs} registers at "
            f"launch (setmaxnreg splits them between the producer and "
            f"consumer warpgroups), no spill; {plan.threads} "
            f"threads, {plan.smem_bytes} B dynamic shared memory, "
            f"{plan.block_q} query rows x {plan.block_k} keys, "
            f"{plan.stages} K/V stages")

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
    # kernels 1-3 at the shapes phases 48-51 give them: a tp-2 rank's
    # heads of the proxy (phase 48), a pp-2 microbatch (phases 50, 51 at
    # fsdp 2 x pp 2) and a tp-2 x pp-2 one (phase 51)
    mp_rows = {"tp_rank": _long_kernel_cases(
        dev, TRAIN_BATCH, TRAIN_SEQ, H=8, label="phase 3 (tp rank)"),
        "pp_microbatch": _long_kernel_cases(
        dev, 1, TRAIN_SEQ, H=16, label="phase 3 (pp microbatch)"),
        "tp_pp_microbatch": _long_kernel_cases(
        dev, 1, TRAIN_SEQ, H=8, label="phase 3 (tp x pp microbatch)")}
    floor = launch_floor(dev)
    for name, r in rows.items():
        log(f"{name}: kernel {r['ms']:.4f} ms, bound {r['bound_ms']:.5f} ms, "
            f"an empty kernel's launch {floor[1]:.4f} (1 block) / "
            f"{floor[128]:.4f} (128 blocks) ms")

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

    # 10. serve int8 ResNet-50, dynamic and weight-only
    bf16_model, int8_model, wonly_model = resnet_models(dev)
    resnet_counts, _ = resnet_serve(dev, bf16_model, int8_model, wonly_model)

    # 11. the int8 logits against the plain version's
    resnet_end_to_end(dev, bf16_model, int8_model, wonly_model)

    # 12. where an int8 forward's time goes
    profile_resnet(dev, int8_model, wonly_model)
    del bf16_model, int8_model, wonly_model
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
    gc.collect()
    torch.cuda.empty_cache()

    # 29. BERT-base pretraining at the bench's configuration
    bt_model, bt_step, bt_batch, bt_counts = bert_train(dev)

    # 30. the bf16-AMP step against f32, and dropout on the card
    bert_train_vs_f32(dev, bt_batch)
    dropout_on_card(dev)

    # 32. where a BERT training step's time goes (before phase 31 frees
    # the training model)
    profile_bert_train(dev, bt_step, bt_batch)
    del bt_model, bt_step, bt_batch
    gc.collect()
    torch.cuda.empty_cache()

    # 31. serve bf16 and int8 BERT-base
    bert_bf16, bert_int8 = bert_models(dev)
    bs_counts, _ = bert_serve(dev, bert_bf16, bert_int8)
    del bert_bf16, bert_int8
    gc.collect()
    torch.cuda.empty_cache()

    # 33. kernels 1-3's options (bias row, in-kernel dropout) against
    # their plain versions, and the keep mask against its plain version
    t0 = time.perf_counter()
    keep_mask_cases(dev)
    bias_rows = bias_cases(dev)
    drop_rows = dropout_cases(dev)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase 33: {time.perf_counter() - t0:.1f} s")

    # 34. ERNIE-3.0-base pretraining at 2,048 positions: kernels 1-3 with
    # dropout on every layer; a step against the plain versions; profile
    t0 = time.perf_counter()
    er_model, er_step, er_batch, er_counts, er_modes = ernie_train(dev)
    profile_ernie_train(dev, er_step, er_batch)
    del er_model, er_step
    gc.collect()
    torch.cuda.empty_cache()
    ernie_kernels_vs_plain(dev, er_batch)
    del er_batch
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase 34: {time.perf_counter() - t0:.1f} s")

    # 35. Transformer-base translation of 1,024-token sources: kernel 1's
    # bias row in every encoder layer
    t0 = time.perf_counter()
    mt_counts, mt_modes, _ = mt_translate(dev)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase 35: {time.perf_counter() - t0:.1f} s")

    # 36. the served 7B's prefix sharing, speculation, migration, replay
    # and generate(): kernel 4's many-row route on verify blocks and
    # suffix prefills
    t0 = time.perf_counter()
    gw_counts, gw_modes, kv_rows, _, gw_model = gateway(dev)
    gh_counts, gh_modes = gateway_bench(dev)
    log(f"phase 36: {time.perf_counter() - t0:.1f} s")

    # 37. the served 7B behind the gateway: replicas, a kill, a drain,
    # typed sheds, an RPC replica and the chaos tool
    t0 = time.perf_counter()
    fleet_counts, fleet_modes = gateway_fleet(dev, gw_model)
    del gw_model
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase 37: {time.perf_counter() - t0:.1f} s")

    # 38. the geo-replicated online loop: two sites, geo pushers both ways,
    # chaos, last-writer-wins, freshness
    geo_counts, _ = geo_online(dev, wd_params, wd_batches)
    gc.collect()
    torch.cuda.empty_cache()

    # 39. the tiered table beyond RAM, its wires and a q8 cache on the card
    t0 = time.perf_counter()
    scale_counts, _ = ps_scale(dev)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase 39: {time.perf_counter() - t0:.1f} s")

    # 40. the long-context proxy at 4,096 and 8,192 positions: kernels
    # 1-3 at both shapes, a flash arm and a chunked arm each
    t0 = time.perf_counter()
    long_counts, long_rows = long_context(dev)
    log(f"phase 40: {time.perf_counter() - t0:.1f} s")

    # 41. the chunked LM loss against the plain loss at 4,096 x 4
    t0 = time.perf_counter()
    cl_counts = chunked_loss(dev)
    log(f"phase 41: {time.perf_counter() - t0:.1f} s")

    # 42. the guard: the clean-path A/B, a planted NaN gradient, gradient
    # merge with the health vector, a schedule with the global-norm clip
    t0 = time.perf_counter()
    guard_counts = guard_phase(dev)
    log(f"phase 42: {time.perf_counter() - t0:.1f} s")

    # 43. float16 BERT-base: the scaled step and the eager auto_cast +
    # GradScaler loop against f32, a planted overflow
    t0 = time.perf_counter()
    bert_fp16(dev)
    log(f"phase 43: {time.perf_counter() - t0:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()

    # 44. collectives on the card: world 1 over NCCL (this process from
    # here on), two ranks on the card over gloo, NCCL's refusal of them
    t0 = time.perf_counter()
    collectives_phase(dev)
    log(f"phase 44: {time.perf_counter() - t0:.1f} s")

    # 45. the proxy under ZeRO at world 1 over NCCL: stages 1-3 bitwise
    # the plain step, bf16 / int8 / offloaded slots
    t0 = time.perf_counter()
    zero_counts, int8_losses = zero_world1(dev)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase 45: {time.perf_counter() - t0:.1f} s")

    # 46. the proxy at world 2 on the one card over gloo: dp 2, and fsdp 2
    # at stage 3 with int8 slots
    t0 = time.perf_counter()
    w2_counts = zero_world2(dev, int8_losses)
    log(f"phase 46: {time.perf_counter() - t0:.1f} s")

    # 47. DGC on ResNet-50 at the bench's configuration: world 1 over
    # NCCL, world 2 over gloo
    t0 = time.perf_counter()
    dgc_counts = dgc_phase(dev)
    import torch.distributed as tdist
    tdist.destroy_process_group()            # phase 44's world of one
    log(f"phase 47: {time.perf_counter() - t0:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()

    # 48-51. model parallelism in the step: tp 2, sp 2 (ring, Ulysses),
    # pp 2 (GPipe, then 1F1B against it), world 4 (tp 2 x pp 2, fsdp 2 x
    # pp 2 at ZeRO-3), rank processes on the one card over gloo
    mp_counts = collections.Counter()
    for phase in (48, 49, 50, 51):
        t0 = time.perf_counter()
        mp_counts.update(model_parallel(phase))
        log(f"phase {phase}: {time.perf_counter() - t0:.1f} s")

    options = {
        "flash_attention": {
            "bias": bias_rows["bias float32 D=64"],
            "bias bf16": bias_rows["bias bfloat16 D=64"],
            "bias bf16 D=128": bias_rows["bias bfloat16 D=128"],
            "dropout": drop_rows["flash_attention"]},
        "flash_attention_bwd_dkv": {
            "dropout": drop_rows["flash_attention_bwd_dkv"]},
        "flash_attention_bwd_dq": {
            "dropout": drop_rows["flash_attention_bwd_dq"]}}
    kernels = []
    for name, s in registry.kernels().items():
        launches = sum(c[name] for c in (counts, train_counts, resnet_counts,
                                         wd_counts, q8_counts, el_counts,
                                         el2_counts, online_counts,
                                         rn_counts, ab_counts, bt_counts,
                                         bs_counts, er_counts, mt_counts,
                                         gw_counts, gh_counts,
                                         fleet_counts, geo_counts,
                                         scale_counts, long_counts,
                                         cl_counts, guard_counts,
                                         zero_counts, w2_counts,
                                         dgc_counts, mp_counts))
        by_mode = {}
        for m in (er_modes, mt_modes, {"int8_kv_attention": gw_modes},
                  {"int8_kv_attention": gh_modes}, fleet_modes):
            for k, c in m.get(name, {}).items():
                by_mode[k] = by_mode.get(k, 0) + c
        extra = dict(launches_by_mode=by_mode) if by_mode else {}
        if name in options:
            extra["options"] = options[name]
        if name == "int8_kv_attention":
            extra["rows_route"] = kv_rows
        if name in long_rows[4096]:
            extra["long_context"] = {f"S={S}": r[name]
                                     for S, r in long_rows.items()}
        for shape, r in mp_rows.items():
            if name in r:
                extra[shape] = r[name]
        kernels.append(dict(name=name, route="cuda", source=s.source,
                            replaces=s.replaces, launches=launches,
                            **rows[name], **extra))
    log(json.dumps({"kernels": kernels}))
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
