"""Run concurrent generation streams through the gateway router while a
seeded fault plan SIGKILLs a replica mid-decode, and check that every
client stream finished token-identical to a fault-free run (counterpart
of the reference's ``tools/chaos_gateway.py``).

Replicas are subprocesses (this module, ``--serve``) behind
``GenerationRpcServer``; the doomed one carries its fault plan in
``PADDLE_CHAOS``, so the kill fires inside its scheduler loop and the
router sees what a machine loss delivers: a dead socket mid-stream.  The
fault-free streams come first, from one in-process server with the same
seeded weights, so the comparison counts exactly: a lost, duplicated or
diverged token fails.

Two phases in one session:

  kill    submit the streams; the doomed replica dies on its K-th decode
          step (``plan=gw_kill@K``); every stream must finish token-equal
          with at least one failover
  drain   submit them again and ``drain()`` the replica that owns the
          second half's prompts mid-traffic: sequences migrate (KV or
          replay) token-equal

Two configurations: ``tiny`` (the reference tool's model and server,
random prompts of 3-12 tokens, 16 new tokens) and ``bench`` (the
reference gateway bench's: hidden 1,024, 8 layers, 16 heads, 8 kv heads,
intermediate 2,816, vocab 32,000, int8 pools, decoder weights damped by
0.15; 24-token system prompts plus 8-token tails, 64 new tokens, block
size 16, ``max_model_len`` 96).  Half the streams are greedy, half use
seeded sampling.  Examples::

    python -m paddle_tpu_torch.tools.chaos_gateway              # the card
    python -m paddle_tpu_torch.tools.chaos_gateway --device cpu
    python -m paddle_tpu_torch.tools.chaos_gateway --config bench

Every wait is bounded (``--timeout`` seconds a stream, a replica's start
and its exit).  Exit status 0 only if every stream of both phases equals
its fault-free run; the last line of output is a JSON summary.
"""
from __future__ import annotations

import argparse
import json
import os
import select
import subprocess
import sys
import time

import numpy as np

# the reference tool's tiny model and server
TINY_MODEL = dict(vocab_size=64, hidden_size=32, intermediate_size=64,
                  num_hidden_layers=2, num_attention_heads=4,
                  num_key_value_heads=2, max_position_embeddings=64)
TINY_SERVER = dict(num_slots=8, block_size=4, max_model_len=32,
                   check_replay=True, max_prefill_batch=1,
                   request_timeout_s=120.0, prefix_cache=True)
# the reference gateway bench's model (bench.py ``_bench_llama_gateway``)
BENCH_MODEL = dict(vocab_size=32000, hidden_size=1024,
                   intermediate_size=2816, num_hidden_layers=8,
                   num_attention_heads=16, num_key_value_heads=8,
                   max_position_embeddings=1024, kv_cache_dtype="int8")
BENCH_DAMP = 0.15
BENCH_SERVER = dict(num_slots=8, block_size=16, max_model_len=96,
                    check_replay=True, max_prefill_batch=4,
                    request_timeout_s=600.0, prefix_cache=True)
BENCH_TRAFFIC = dict(system=24, tail=8, new=64)


def build_model(config: str, device, seed: int = 0):
    """The configuration's target model, its weights drawn from ``seed``
    on ``device`` (each process that builds it gets the same weights);
    the bench's decoder-layer weights (not its norms) damped by
    ``BENCH_DAMP``, in bf16."""
    import torch
    from paddle_tpu_torch.text.models import LlamaForCausalLM, llama_tiny
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    if config == "tiny":
        m = LlamaForCausalLM(llama_tiny(**TINY_MODEL), device=dev,
                             generator=gen)
    else:
        m = LlamaForCausalLM(llama_tiny(**BENCH_MODEL), device=dev,
                             dtype="bfloat16", generator=gen)
        with torch.no_grad():
            for name, p in m.named_parameters():
                if ".layers." in name and "layernorm" not in name:
                    p.mul_(BENCH_DAMP)
    m.eval()
    return m


def server_kw(config: str) -> dict:
    return dict(TINY_SERVER if config == "tiny" else BENCH_SERVER)


def build_server(config: str, device, seed: int = 0):
    from paddle_tpu_torch.inference import GenerationServer
    return GenerationServer(build_model(config, device, seed),
                            **server_kw(config))


def _serve(config, device, seed):
    """Replica mode: serve one GenerationServer over RPC until the
    main process stops it (or the chaos plan kills this process)."""
    from paddle_tpu_torch.inference import GenerationRpcServer
    srv = build_server(config, device, seed).start()
    rpc = GenerationRpcServer(srv)
    print(json.dumps({"port": rpc.port, "pid": os.getpid()}), flush=True)
    while rpc._running:
        time.sleep(0.2)


def _spawn_replica(config, device, seed, timeout_s, chaos_spec=None):
    env = dict(os.environ)
    env.pop("PADDLE_CHAOS", None)
    if chaos_spec:
        env["PADDLE_CHAOS"] = chaos_spec
    proc = subprocess.Popen(
        [sys.executable, "-m", "paddle_tpu_torch.tools.chaos_gateway",
         "--serve", "--config", config, "--device", device, "--seed",
         str(seed)], stdout=subprocess.PIPE, text=True, env=env)
    ready, _, _ = select.select([proc.stdout], [], [], timeout_s)
    line = proc.stdout.readline() if ready else ""
    if not line:
        proc.kill()
        proc.wait(timeout=30)
        raise RuntimeError(f"replica did not start within {timeout_s} s")
    return proc, json.loads(line)["port"]


def _kw(i, new):
    kw = dict(max_new_tokens=new, seed=1000 + i)
    if i % 2:
        kw.update(do_sample=True, temperature=0.9, top_k=8)
    return kw


def workload(config: str, streams: int, seed: int, owner):
    """(prompt, kwargs) a stream: even streams greedy, odd ones seeded
    sampling.  ``tiny``: random prompts of 3-12 tokens, 16 new tokens.
    ``bench``: a 24-token system prompt plus an 8-token tail, 64 new
    tokens; the first half share a system prompt that ``owner`` (prompt
    -> replica name) routes to replica ``r0``, the second half one that
    it routes elsewhere, so the doomed replica and a survivor both carry
    streams."""
    rng = np.random.RandomState(seed)
    if config == "tiny":
        out = []
        for i in range(streams):
            p = rng.randint(1, TINY_MODEL["vocab_size"],
                            (int(rng.randint(3, 13)),)).astype(np.int32)
            out.append((p, _kw(i, 16)))
        return out
    V, t = BENCH_MODEL["vocab_size"], BENCH_TRAFFIC
    systems = {}
    while len(systems) < 2:
        sp = rng.randint(1, V, (t["system"],)).astype(np.int32)
        systems.setdefault("doomed" if owner(sp) == "r0" else "other", sp)
    out = []
    for i in range(streams):
        sp = systems["doomed" if i < streams // 2 else "other"]
        tail = rng.randint(1, V, (t["tail"],)).astype(np.int32)
        out.append((np.concatenate([sp, tail]), _kw(i, t["new"])))
    return out


def owner_probe(names, block_size, seed):
    """The ``route_owner`` of a router over replicas of these names (no
    replica is called)."""
    from paddle_tpu_torch.inference import GatewayRouter

    class _Stub:
        def __init__(self, name):
            self.name = name
    probe = GatewayRouter([_Stub(n) for n in names], block_size=block_size,
                          seed=seed)
    return probe.route_owner


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="gateway chaos check: SIGKILL and drain, token "
                    "equality as the bar")
    ap.add_argument("--serve", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--config", choices=("tiny", "bench"), default="tiny")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--replicas", type=int, default=3)
    ap.add_argument("--streams", type=int, default=8)
    ap.add_argument("--kill-step", type=int, default=6,
                    help="the doomed replica dies on its Nth decode step")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--timeout", type=float, default=600.0,
                    help="seconds a stream, a replica start or exit may "
                         "take")
    args = ap.parse_args(argv)
    weights_seed = 0
    if args.serve:
        _serve(args.config, args.device, weights_seed)
        return 0

    from paddle_tpu_torch.inference import GatewayRouter, RemoteReplica

    names = [f"r{i}" for i in range(args.replicas)]
    bs = server_kw(args.config)["block_size"]
    owner = owner_probe(names, bs, args.seed)
    work = workload(args.config, args.streams, args.seed, owner)
    print(f"[ref] fault-free run, {args.streams} streams ({args.config} "
          f"on {args.device}) ...", flush=True)
    ref_srv = build_server(args.config, args.device, weights_seed).start()
    try:
        refs = [ref_srv.submit(p, **kw).result(timeout=args.timeout)
                for p, kw in work]
    finally:
        ref_srv.stop()

    chaos_spec = f"plan=gw_kill@{args.kill_step};seed={args.seed}"
    print(f"[spawn] {args.replicas} replicas (r0 doomed: {chaos_spec})",
          flush=True)
    procs, reps = [], []
    st = {"failovers": 0, "migrated": 0}
    bad = 0
    router = None
    try:
        for i, name in enumerate(names):
            proc, port = _spawn_replica(args.config, args.device,
                                        weights_seed, args.timeout,
                                        chaos_spec if i == 0 else None)
            procs.append(proc)
            reps.append(RemoteReplica(name, "127.0.0.1", port,
                                      rpc_timeout=args.timeout))
        router = GatewayRouter(reps, block_size=bs, seed=args.seed,
                               request_timeout_s=args.timeout).start()
        placed = {owner(p) for p, _ in work}
        print(f"[kill] wave 1: the streams route to {sorted(placed)}; r0 "
              "dies mid-decode", flush=True)
        t0 = time.perf_counter()
        streams = [router.submit(p, **kw) for p, kw in work]
        outs = [s.result(timeout=args.timeout) for s in streams]
        wave1_s = time.perf_counter() - t0
        for i, (o, r) in enumerate(zip(outs, refs)):
            if o != r:
                bad += 1
                print(f"  stream {i}: MISMATCH {o} != {r}", flush=True)
        st = router.stats()
        print(f"  failovers={st['failovers']} routed={st['routed']} "
              f"({wave1_s:.2f} s)", flush=True)
        if st["failovers"] < 1:
            bad += 1
            print("  FAIL: the kill never hit a live stream (raise "
                  "--streams or lower --kill-step)", flush=True)
        killed = procs[0].wait(timeout=args.timeout)
        if killed != -9:
            bad += 1
            print(f"  FAIL: the doomed replica exited {killed}, not by "
                  "SIGKILL", flush=True)
        # drain the survivor that owns the second half's prompts (the
        # ring drops draining replicas, not dead ones: never r0)
        victim = next((owner(p) for p, _ in reversed(work)
                       if owner(p) != "r0"), names[1])
        print(f"[drain] wave 2 with drain({victim}) mid-traffic",
              flush=True)
        streams = [router.submit(p, **kw) for p, kw in work]
        time.sleep(0.05)
        moved = router.drain(victim)
        outs = [s.result(timeout=args.timeout) for s in streams]
        for i, (o, r) in enumerate(zip(outs, refs)):
            if o != r:
                bad += 1
                print(f"  stream {i}: MISMATCH {o} != {r}", flush=True)
        st = router.stats()
        print(f"  migrated={st['migrated']} (moved {moved} live) "
              f"failovers={st['failovers']}", flush=True)
    finally:
        if router is not None:
            router.stop()
        for rep in reps[1:]:
            try:
                rep.stop_remote()
            except Exception:   # noqa: BLE001 - shutting down anyway
                pass
        for proc in procs:
            try:
                proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=30)
    ok = bad == 0
    print(json.dumps({"ok": ok, "mismatches": bad,
                      "failovers": st["failovers"],
                      "migrated": st["migrated"], "config": args.config,
                      "device": args.device}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
