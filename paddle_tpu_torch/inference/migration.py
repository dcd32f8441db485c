"""Live-sequence KV migration for a graceful replica drain (counterpart
of the reference's ``inference/migration.py``).

- **KV migration** (:func:`export_sequence` / :func:`import_sequence`):
  the sequence's scheduler state (prompt, emitted tokens, its sampling
  seed, priority, the remaining deadline) and the pool rows its block
  table points at go into a blob, and the target rebuilds it at fresh
  blocks with the same bytes.  Physical block ids never enter the
  attention math and every pool tensor round-trips through numpy at its
  own dtype (bf16 as its bits, in int16), so the continuation is the one
  the source would have
  produced: the target's next decode step reads exactly the K/V the
  source would have read.
- **token replay** (the fallback when the target lacks capacity, the
  geometries differ, or the blob carries no KV because the sequence was
  waiting or evicted): ship the prompt and emitted tokens and resubmit
  with ``replay_tokens=``; re-prefill recomputes the KV and the replay
  contract makes the continuation token-identical.

A speculative server takes the replay path by construction: the draft's
pools trail the emitted stream, and target KV without coherent draft KV
would sink the accept rate; :class:`MigrationUnsupported` routes such
sequences to replay.

The blob carries the request's integer sampling seed where the
reference carries JAX key data (the port's draws are keyed by (seed,
position), see ``generation_server._stream_seed``).  Everything runs on
the scheduler thread of the server it touches (``_run_on_scheduler``):
sequence, slot and pool state is only coherent between steps.
"""
from __future__ import annotations

import time
from typing import Dict, Optional

import numpy as np
import torch

from .serving import ServeError

__all__ = ["MigrationUnsupported", "export_sequence", "import_sequence"]


class MigrationUnsupported(ServeError):
    """The KV path cannot carry this sequence (no capacity on the target,
    mismatched pool geometry, a speculative server, or a blob with no KV):
    the caller falls back to token replay."""


def _bits(t):
    """``t`` as numpy can hold it: bf16 viewed as its int16 bits."""
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


def export_sequence(server, request_id: int) -> Optional[dict]:
    """Serialize one live request off ``server`` and remove it there (its
    stream ends with ``finish_reason="migrated"``).  Returns the blob, or
    None when the request is unknown (already finished).

    An active sequence ships its pool rows (KV valid through position
    ``L + decoded - 1``); a waiting one (queued or evicted) has no blocks
    and gives a tokens-only blob (``kv is None``) for the replay
    fallback.  ``deadline_remaining`` is measured here and re-anchored
    at import: the migration's wall time counts against the budget."""
    def _do():
        with server._lock:
            seq = next((s for s in server._active.values()
                        if s.rid == request_id), None)
            active = seq is not None
            if not active:
                seq = next((s for s in server._waiting
                            if s.rid == request_id), None)
                if seq is not None:
                    server._waiting.remove(seq)
        if seq is None:
            return None
        blob: Dict = {
            "prompt": np.asarray(seq.prompt, np.int32),
            "generated": list(seq.generated),
            "decoded": int(seq.decoded),
            "max_new": seq.max_new,
            "eos": seq.eos,
            "do_sample": seq.do_sample,
            "temp": seq.temp,
            "top_k": seq.top_k,
            "top_p": seq.top_p,
            "seed": int(seq.seed),
            "priority": seq.priority,
            "tenant": seq.tenant,
            "evictions": seq.evictions,
            "deadline_remaining": max(seq.deadline - time.monotonic(), 0.0),
            "block_size": server._bs,
            "kv": None,
        }
        if active and not server._spec and seq.blocks:
            # gather the pool rows before releasing: an unreferenced
            # block is recyclable the moment another admission wants it
            idx = torch.as_tensor(seq.blocks, dtype=torch.long,
                                  device=server._device)
            blob["kv"] = [{k: _bits(v[idx]).cpu().numpy()
                           for k, v in layer.items()}
                          for layer in server._pools]
            blob["n_blocks"] = len(seq.blocks)
        server._release(seq)
        with server._lock:
            server._stats["migrated_out"] += 1
        if seq.rt is not None:
            seq.rt.finish("migrated", tokens=len(seq.generated))
        seq.stream._end("migrated")
        return blob
    return server._run_on_scheduler(_do)


def import_sequence(server, blob: dict):
    """Rebuild an exported sequence on ``server``: allocate fresh blocks,
    write the shipped pool rows there and enter the sequence straight
    into the active set (no prefill: its KV is valid through ``L +
    decoded - 1``; a mid-replay sequence keeps replaying).  Returns the
    new :class:`~paddle_tpu_torch.inference.generation_server.
    GenerationStream`.

    Raises :class:`MigrationUnsupported` when the KV path cannot apply
    (the caller resubmits with ``replay_tokens=``); the server is then
    left as it was."""
    from .generation_server import _GenSeq

    kv = blob.get("kv")
    if kv is None:
        raise MigrationUnsupported("blob carries no KV (sequence was "
                                   "waiting) — replay it instead")
    if server._spec:
        raise MigrationUnsupported(
            "target runs speculative decoding (draft KV cannot be "
            "reconstructed) — replay instead")
    if server._pools is None:
        raise MigrationUnsupported("target server was never started")
    if int(blob["block_size"]) != server._bs \
            or len(kv) != len(server._pools) \
            or any(k not in server._pools[i]
                   or tuple(v.shape[1:]) != tuple(
                       server._pools[i][k].shape[1:])
                   for i, layer in enumerate(kv) for k, v in layer.items()):
        raise MigrationUnsupported("pool geometry mismatch — replay "
                                   "instead")

    def _do():
        n = int(blob["n_blocks"])
        with server._lock:
            if not server._free_slots:
                raise MigrationUnsupported("no free slot on target")
            got = []
            for _ in range(n):
                b = server._cache.alloc()
                if b is None:
                    break
                got.append(b)
            if len(got) < n:
                for b in got:
                    server._cache.unref(b)
                raise MigrationUnsupported(
                    f"target pool has room for {len(got)}/{n} blocks")
            slot = server._free_slots.pop()
            server._rid += 1
            server._arrival += 1
            rid, arrival = server._rid, server._arrival
        # device writes outside the lock, on the scheduler thread:
        # nothing else touches the pools between steps
        idx = torch.as_tensor(got, dtype=torch.long, device=server._device)
        with torch.no_grad():
            for layer, rows in zip(server._pools, kv):
                for k, v in layer.items():
                    src = torch.from_numpy(np.asarray(rows[k]))
                    if src.dtype != v.dtype:
                        src = src.view(v.dtype)   # bf16 shipped as bits
                    v[idx] = src.to(v.device)
        now = time.monotonic()
        prompt = np.asarray(blob["prompt"], np.int32)
        seq = _GenSeq(rid, prompt, blob["max_new"], blob["eos"],
                      blob["do_sample"], blob["temp"], blob["top_k"],
                      blob["top_p"], int(blob["seed"]), blob["priority"],
                      arrival, now + float(blob["deadline_remaining"]),
                      tenant=blob.get("tenant"))
        seq.generated = list(blob["generated"])
        seq.decoded = int(blob["decoded"])
        seq.evictions = int(blob.get("evictions", 0))
        seq.blocks = got
        seq.slot = slot
        seq.t_first_tok = now    # the first token was delivered long ago
        with server._lock:
            server._active[slot] = seq
            server._stats["migrated_in"] += 1
            # index the KV-valid full blocks (prompt + replayed tokens)
            # so the survivors' traffic can alias them
            server._cache.insert(
                prompt.tolist() + seq.generated[:seq.decoded], got)
        return seq.stream
    return server._run_on_scheduler(_do)
