"""Elastic training: dynamic worker membership with deterministic reshard
(counterpart of ``paddle_tpu/distributed/fleet/elastic.py``).

The reference framework has NO elasticity: its launcher watchdog aborts
the whole job when any worker dies (SURVEY §5.3, launch_utils.py
watch-local-trainers semantics).  This module is a membership
controller that handles worker **join / leave / fail mid-run** and
resumes training **bit-identical** to a run that never lost the worker
(``np.array_equal``, not allclose).

Architecture
============

``ElasticCoordinator``
    A small TCP rendezvous service (frames ride the ps_service framing
    layer: pickled header + out-of-band numpy buffers).  It owns the
    **membership generation**: the set of live workers, their rank
    assignment (sorted by registration uid), and the last COMPLETED
    pinned checkpoint step.  Every data-plane RPC carries the caller's
    generation; a stale generation gets a ``reform`` reply instead of
    data — the generation number is the fence that makes membership
    transitions race-free.  Worker loss is detected by connection EOF
    (SIGKILL closes the socket) or by lease expiry; either bumps the
    generation and wakes every blocked peer with ``reform``.

``ElasticClient``
    The worker-side connection: ``register`` (blocks until admitted to
    a generation), ``exchange`` (the one collective — an all-gather
    barrier over per-rank payloads for a given (step, tag)),
    ``report_ckpt`` and ``leave``.

``ElasticTrainer``
    The membership-aware training loop.  Determinism is engineered
    so that the global trajectory is a **pure function of the global
    step, independent of world size**:

    * the GLOBAL batch for step s comes from the seeded
      :class:`~paddle_tpu_torch.io.dataloader.DataLoader` cursor (pure
      function of (seed, epoch, batch index));
    * the batch splits into ``micro_batches`` fixed SLOTS; ranks own
      contiguous slot ranges (``zero_shard_ranges``), each slot's
      gradient is computed independently (same shape every world
      size), and after the ``grads`` exchange EVERY worker sums the
      byte-identical slot gradients in slot order 0..G-1 — a
      world-size-invariant reduction order (float addition is not
      associative; a rank-topology-dependent reduction would break
      bit-equality across worlds);
    * optimizer state is ZeRO-partitioned: rank r owns the contiguous
      shard ``zero_shard_ranges(numel, world)[r]`` of the flat
      param/slot vectors and applies a purely ELEMENTWISE update to
      it, so the concatenation of shards equals the full-vector
      update bit-for-bit; the ``params`` exchange all-gathers the
      updated shards back to a full replicated vector;
    * checkpoints (every ``ckpt_every`` steps and at the end) gather
      the slot shards, and rank 0 writes the GLOBAL state — flat
      params, full optimizer vectors, the exact dataloader cursor and
      the step — via the pinned
      :class:`~paddle_tpu_torch.distributed.checkpoint.CheckpointManager`.
      Because every saved quantity is world-size invariant, a
      checkpoint written by an N-worker run is bit-identical to one a
      fresh M-worker run would write at the same step, and the reshard
      on restore is the pure function
      :func:`~.dist_step.zero_shard` (global state, rank, new world).

    On any membership change the trainer re-enters its generation
    loop: re-forms the mesh (:func:`paddle_tpu_torch.distributed.mesh.
    reform_mesh`), updates its
    :class:`~.role_maker.ElasticRoleMaker`, reshards from the last
    pinned checkpoint and replays — replayed steps recompute the
    identical updates, so the final weights match the fault-free run
    exactly.  A worker SIGKILLed mid-step leaves its peers blocked in
    the exchange; the coordinator sees the EOF, bumps the generation
    and the survivors reshard without it.  A (re)joining worker
    registers, is admitted at the next round boundary, and every
    member resumes from the same pinned step — the post-join
    trajectory equals a fresh (world+1)-worker run from that step.

Failure injection: ``PADDLE_CHAOS="plan=kill_worker@every=K"`` SIGKILLs
the worker at every K-th executed step
(:func:`~paddle_tpu_torch.distributed.fleet.chaos.maybe_kill_worker`); the
launcher's ``--elastic`` mode restarts it and it rejoins.  Progress
under sustained kills needs ``ckpt_every`` < K.

Coordinator HA (the rendezvous is otherwise a single point of failure;
the PS tier's hot-standby pattern): ``ElasticCoordinator(standby_of="h:p")``
starts a STANDBY that subscribes to the primary's replicated
membership log (``op=co_replicate``: a snapshot of the tiny durable
state — generation, uid counter, pinned checkpoint step — then every
change as it commits).  An un-promoted standby answers every worker op
with ``{"status": "standby"}``; on primary EOF it promotes: bumps the
generation past everything the primary ever fenced (a zombie primary's
rounds can never match) and starts serving.  Workers hold the
coordinator endpoint LIST (``"h:p1|h:p2"`` in ``PADDLE_COORDINATOR``);
a dead or standby coordinator makes the client rotate, re-register and
raise :class:`Reform`, so the trainer reshards from the replicated
pinned step exactly as it does for a worker loss — the run's final
weights stay bit-equal to the fault-free run because everything since
that step replays deterministically.

``ElasticCoordinator(ckpt_dir=...)``: a
coordinator (re)started over a populated checkpoint directory scans it
via :meth:`CheckpointManager.all_steps`/``pinned_steps`` and resumes
from the latest pinned step automatically — no manual ``ckpt_step=``;
a promoting standby does the same scan and takes the max of scan and
replicated log.

Engines (constructor arguments, run-scoped): ``engine="device"`` (the
default) sums the slot gradients on the card and applies the optimizer
through the ``opt_apply`` CUDA kernel, streaming checkpoints range-wise;
``engine="host"`` is the flat-numpy path.  The port's two engines give
the same bits (its kernel and plain version round as numpy does); the
JAX package's differ by about 1 ulp.  ``device=`` (default ``cuda``)
places the device engine; ``device="cpu"`` runs it on the kernel's
plain version.

Env (the launcher's contract): ``PADDLE_COORDINATOR`` (host:port
rendezvous address — may be a ``|``-separated failover list, set by the
launcher) and ``PADDLE_TRAINERS_NUM`` (expected initial world).  No
environment variable selects the engine, the kernel or its plain
version.

Observability: flight-recorder events ``elastic.join`` /
``elastic.leave`` / ``elastic.reshard`` / ``elastic.resume`` (join/
reshard/resume are stall-watchdog progress kinds; leave is a
postmortem bad kind), the ``elastic_transitions`` counter and the
``reshard_ms`` histogram.
"""
from __future__ import annotations

import contextlib
import os
import queue
import re
import socket
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ... import resolve_device
from ...framework import monitor as _monitor
from ...observability import flight_recorder as _flight
from ..checkpoint import CheckpointManager, StreamedArray
from .. import mesh as mesh_mod
from . import chaos as _chaos
from .elastic_engine import DeviceZeroEngine, ReshardMeter
from .dist_step import (flatten_zero_state, fused_optimizer_apply,
                        make_lr_schedule, unflatten_zero_state,
                        zero_shard_ranges)
from .ps_service import _parse_ep, _recv_msg, _send_msg_raw
from .role_maker import ElasticRoleMaker

__all__ = ["ElasticCoordinator", "ElasticClient", "ElasticTrainer",
           "Reform", "CoordinatorLost"]

# elastic locks are LEAVES of the process-wide lock order: nothing may
# call into the PS / serving layers while holding them (the coordinator
# records telemetry only after releasing its condition).

_PAYLOAD_KEY = re.compile(r"^r(\d+):(.*)$")


class Reform(Exception):
    """Internal control flow: the membership changed; ``info`` carries
    the new (gen, rank, world, ckpt_step) to resume under."""

    def __init__(self, info: dict):
        super().__init__(f"membership reform -> {info}")
        self.info = dict(info)


class CoordinatorLost(ConnectionError):
    """The coordinator connection died or the endpoint answered as an
    un-promoted standby — the caller must :meth:`ElasticClient.rejoin`
    (rotate + re-register) and reform."""


def _scan_ckpt_dir(ckpt_dir: str) -> Optional[int]:
    """Latest restorable step in a checkpoint directory: the newest
    PINNED step (the elastic trainer pins every global checkpoint and
    unpins old ones), falling back to :meth:`CheckpointManager.
    all_steps` for directories without pin records."""
    mgr = CheckpointManager(ckpt_dir)
    steps = mgr.pinned_steps() or mgr.all_steps()
    return max(steps) if steps else None


class _Member:
    __slots__ = ("uid", "conn", "rank", "last_seen")

    def __init__(self, uid, conn):
        self.uid = uid
        self.conn = conn
        self.rank = -1
        self.last_seen = time.monotonic()


class _Round:
    """One (step, tag) all-gather: collects per-rank payloads, holds
    the rank-ordered result until every participant has taken it."""

    __slots__ = ("step", "tag", "payloads", "result", "world", "taken")

    def __init__(self, step, tag):
        self.step = step
        self.tag = tag
        self.payloads: Dict[int, dict] = {}
        self.result: Optional[List[dict]] = None
        self.world = 0
        self.taken: set = set()


class ElasticCoordinator:
    """Membership rendezvous + the exchange collective (see module
    docstring).  Runs a thread-per-connection TCP server; all state
    lives under one condition variable.  Start it in the rank-0
    launcher (``--elastic`` does this automatically) or in a test."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 expected_world: Optional[int] = None,
                 lease_s: float = 0.0,
                 ckpt_step: Optional[int] = None,
                 ckpt_dir: Optional[str] = None,
                 standby_of: Optional[str] = None):
        self._host = host
        self._cond = threading.Condition()
        self._gen = 0
        self._members: Dict[int, _Member] = {}
        self._pending: Dict[int, _Member] = {}
        self._uid_next = 0
        # ``ckpt_step``: resume an EXISTING run — a coordinator restarted
        # over a populated checkpoint directory names the pinned step the
        # first generation reshards from (None = fresh run, rank 0
        # bootstraps step 0).  ``ckpt_dir`` derives it automatically by
        # scanning the CheckpointManager directory on (re)start.
        self._ckpt_step: Optional[int] = ckpt_step
        # per-generation snapshot of _ckpt_step handed to members (see
        # _reform_locked — all of gen N must agree on the resume point)
        self._gen_ckpt_step: Optional[int] = ckpt_step
        self._ckpt_dir = ckpt_dir
        self._rounds: Dict[Tuple[int, str], _Round] = {}
        self._last_step = -1
        self._expected = expected_world
        self._lease_s = float(lease_s)
        self._stop_evt = threading.Event()
        self._srv: Optional[socket.socket] = None
        self._threads: List[threading.Thread] = []
        self.port = port
        # membership log for tests/debugging: (kind, uid, gen) tuples
        self.events: List[Tuple[str, int, int]] = []
        # HA: a standby binds + listens but answers every
        # worker op with {"status": "standby"} until it promotes
        self.standby_of = standby_of
        self.promoted = standby_of is None
        self._co_sinks: List[dict] = []   # replication subscribers

    @property
    def role(self) -> str:
        return "primary" if self.promoted else "standby"

    # -- lifecycle ------------------------------------------------------
    def start(self):
        if self._ckpt_step is None and self._ckpt_dir and self.promoted:
            self._ckpt_step = _scan_ckpt_dir(self._ckpt_dir)
        srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        srv.bind((self._host, self.port))
        srv.listen(64)
        self.port = srv.getsockname()[1]
        self._srv = srv
        t = threading.Thread(target=self._accept_loop, daemon=True,
                             name="elastic-coord-accept")
        t.start()
        self._threads.append(t)
        if self._lease_s > 0:
            lt = threading.Thread(target=self._lease_loop, daemon=True,
                                  name="elastic-coord-lease")
            lt.start()
            self._threads.append(lt)
        if self.standby_of is not None:
            st = threading.Thread(target=self._standby_loop, daemon=True,
                                  name="elastic-coord-standby")
            st.start()
            self._threads.append(st)
        return self

    def stop(self):
        self._stop_evt.set()
        with self._cond:
            conns = [m.conn for m in list(self._members.values())
                     + list(self._pending.values())]
            conns += [s["conn"] for s in self._co_sinks]
            self._cond.notify_all()
        for c in conns:
            try:
                c.close()
            except OSError:
                pass
        if self._srv is not None:
            try:
                self._srv.close()
            except OSError:
                pass

    def status(self) -> dict:
        with self._cond:
            return {"gen": self._gen, "world": len(self._members),
                    "pending": len(self._pending),
                    "ckpt_step": self._ckpt_step,
                    "last_step": self._last_step,
                    "role": self.role}

    # -- accept / serve -------------------------------------------------
    def _accept_loop(self):
        while not self._stop_evt.is_set():
            try:
                conn, _ = self._srv.accept()
            except OSError:
                return
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            t = threading.Thread(target=self._serve_conn, args=(conn,),
                                 daemon=True, name="elastic-coord-conn")
            t.start()
            self._threads.append(t)

    def _serve_conn(self, conn):
        uid = None
        left = False
        handed_off = False
        try:
            while not self._stop_evt.is_set():
                msg = _recv_msg(conn)
                if msg is None:
                    break
                op = msg.get("op")
                if op == "co_replicate":
                    handed_off = self._attach_co_sink(conn)
                    if handed_off:
                        return
                    continue
                if not self.promoted and op != "status":
                    # un-promoted standby: workers must keep rotating
                    # until they reach the promoted coordinator — a
                    # standby that admitted members would split the
                    # rendezvous brain exactly like a PS standby
                    # serving writes
                    _send_msg_raw(conn, {"status": "standby",
                                         "standby_of": self.standby_of})
                    continue
                if op == "register":
                    uid = self._handle_register(conn, msg)
                elif op == "exchange":
                    self._handle_exchange(conn, msg)
                elif op == "ckpt":
                    self._handle_ckpt(conn, msg)
                elif op == "status":
                    _send_msg_raw(conn, {"status": "ok", **self.status()})
                elif op == "leave":
                    _send_msg_raw(conn, {"status": "ok"})
                    left = True
                    break
                else:
                    _send_msg_raw(conn, {"status": "error",
                                         "error": f"unknown op {op!r}"})
        except (OSError, ConnectionError, EOFError):
            pass
        finally:
            if not handed_off:
                try:
                    conn.close()
                except OSError:
                    pass
            if uid is not None:
                self._on_disconnect(uid, "leave" if left else "fail")

    # -- membership -----------------------------------------------------
    def _reform_locked(self):
        """Admit every pending worker, bump the generation, reassign
        ranks (sorted by uid), drop in-flight rounds, wake everyone.
        Called with ``self._cond`` held."""
        self._members.update(self._pending)
        self._pending.clear()
        self._gen += 1
        # snapshot the resume point PER GENERATION: every member of gen
        # N must see the SAME ckpt_step, or they disagree about the
        # bootstrap barrier (a register reply delayed past rank 0's
        # first ckpt report would see a live ckpt_step its peers read
        # as None — two members in one barrier, one skipping it: hang)
        self._gen_ckpt_step = self._ckpt_step
        for r, uid in enumerate(sorted(self._members)):
            self._members[uid].rank = r
        self._rounds.clear()
        self._co_publish_locked()
        self._cond.notify_all()

    def _maybe_admit_locked(self):
        """Form a generation when none is live: the INITIAL formation
        waits for ``expected_world`` registrants; after a total loss
        whoever shows up is admitted immediately (a lone survivor of a
        shrunken world must be able to continue)."""
        if not self._pending or self._members:
            return
        need = (self._expected or 1) if self._gen == 0 else 1
        if len(self._pending) >= need:
            self._reform_locked()

    def _info_locked(self, uid) -> dict:
        m = self._members.get(uid)
        if m is None:
            return {"status": "evicted"}
        return {"status": "reform", "gen": self._gen, "rank": m.rank,
                "world": len(self._members),
                "ckpt_step": self._gen_ckpt_step}

    def _on_disconnect(self, uid, reason: str):
        with self._cond:
            self._pending.pop(uid, None)
            m = self._members.pop(uid, None)
            gen = self._gen
            if m is not None:
                self.events.append(("leave", uid, gen))
                if self._members or self._pending:
                    self._reform_locked()
                else:
                    # no survivors: still fence stale exchanges so a
                    # zombie request can never match a dead generation
                    self._gen += 1
                    self._rounds.clear()
                    self._co_publish_locked()
                    self._cond.notify_all()
        if m is not None:
            # telemetry strictly OUTSIDE the condition (lock-order leaf)
            _flight.record("elastic.leave", uid=int(uid), reason=reason,
                           gen=int(gen))

    def _handle_register(self, conn, msg):
        with self._cond:
            uid = self._uid_next
            self._uid_next += 1
            self._co_publish_locked()
            self._pending[uid] = _Member(uid, conn)
            if self._expected is None:
                self._expected = max(1, int(msg.get("world", 1)))
            self._maybe_admit_locked()
            while not self._stop_evt.is_set():
                if uid in self._members:
                    info = self._info_locked(uid)
                    break
                if uid not in self._pending:
                    info = None
                    break
                self._cond.wait(0.2)
            else:
                info = None
            if info is not None:
                self.events.append(("join", uid, self._gen))
        if info is None:
            _send_msg_raw(conn, {"status": "stopped"})
            return uid
        _flight.record("elastic.join", uid=int(uid), gen=int(info["gen"]),
                       world=int(info["world"]))
        _send_msg_raw(conn, {"status": "ok", "uid": uid,
                             **{k: v for k, v in info.items()
                                if k != "status"}})
        return uid

    def _handle_exchange(self, conn, msg):
        uid, gen = msg["uid"], int(msg["gen"])
        step, tag = int(msg["step"]), str(msg["tag"])
        payload = {k[2:]: v for k, v in msg.items()
                   if isinstance(k, str) and k.startswith("a:")}
        with self._cond:
            m = self._members.get(uid)
            if m is None or gen != self._gen:
                rep = self._info_locked(uid)
            else:
                m.last_seen = time.monotonic()
                key = (step, tag)
                r = self._rounds.get(key)
                if r is None:
                    r = self._rounds[key] = _Round(step, tag)
                r.payloads[m.rank] = payload
                if r.result is None and \
                        len(r.payloads) == len(self._members):
                    if self._pending:
                        # round boundary = the membership-change safe
                        # point: admit joiners, everyone reforms from
                        # the pinned step (the collected payloads are
                        # discarded — the round will be replayed)
                        self._reform_locked()
                    else:
                        r.world = len(self._members)
                        r.result = [r.payloads[i]
                                    for i in range(r.world)]
                        self._last_step = max(self._last_step, step)
                        self._cond.notify_all()
                while r.result is None and self._gen == gen \
                        and not self._stop_evt.is_set():
                    self._cond.wait(0.2)
                if self._gen != gen:
                    rep = self._info_locked(uid)
                elif r.result is None:
                    rep = {"status": "stopped"}
                else:
                    rep = {"status": "ok", "world": r.world,
                           "step": step}
                    for i, p in enumerate(r.result):
                        for k, v in p.items():
                            rep[f"r{i}:{k}"] = v
                    r.taken.add(m.rank)
                    if len(r.taken) >= r.world:
                        self._rounds.pop(key, None)
        _send_msg_raw(conn, rep)

    def _handle_ckpt(self, conn, msg):
        step = int(msg["step"])
        with self._cond:
            if self._ckpt_step is None or step > self._ckpt_step:
                self._ckpt_step = step
                self._co_publish_locked()
        _send_msg_raw(conn, {"status": "ok"})

    # -- HA: replicated membership log ----------------------------------
    def _co_state_locked(self) -> dict:
        return {"gen": self._gen, "uid_next": self._uid_next,
                "ckpt_step": self._ckpt_step}

    def _co_publish_locked(self):
        """Queue the durable-state snapshot to every standby sink
        (called under ``self._cond``).  Tiny and idempotent — the
        standby only needs the LATEST values, so a full snapshot per
        change beats a fragile event log.  A sink whose queue is full
        is dead or wedged: drop it (the standby reconnects)."""
        if not self._co_sinks:
            return
        snap = self._co_state_locked()
        for sink in list(self._co_sinks):
            try:
                sink["q"].put_nowait(snap)
            except queue.Full:
                self._co_sinks.remove(sink)
                try:
                    sink["conn"].close()
                except OSError:
                    pass

    def _attach_co_sink(self, conn) -> bool:
        """Register a standby subscriber: snapshot + update stream.
        Returns True when the connection was handed to a sender
        thread."""
        sink = {"conn": conn, "q": queue.Queue(maxsize=64)}
        with self._cond:
            if not self.promoted:
                snap = None     # a standby cannot seed another standby
            else:
                snap = self._co_state_locked()
                self._co_sinks.append(sink)
        if snap is None:
            _send_msg_raw(conn, {"status": "standby"})
            return False
        _send_msg_raw(conn, {"status": "ok", **snap})
        t = threading.Thread(target=self._co_sender, args=(sink,),
                             daemon=True, name="elastic-coord-co-sender")
        t.start()
        self._threads.append(t)
        return True

    def _co_sender(self, sink):
        conn, q = sink["conn"], sink["q"]
        try:
            while not self._stop_evt.is_set():
                try:
                    snap = q.get(timeout=0.5)
                except queue.Empty:
                    continue
                _send_msg_raw(conn, snap)
        except (OSError, ConnectionError):
            pass
        finally:
            try:
                conn.close()
            except OSError:
                pass
            with self._cond:
                if sink in self._co_sinks:
                    self._co_sinks.remove(sink)

    def _standby_loop(self):
        """Standby side: subscribe to the primary's replicated log;
        promote on EOF."""
        host, port = _parse_ep(self.standby_of)
        last: dict = {}
        while not self._stop_evt.is_set():
            try:
                sock = socket.create_connection((host, port),
                                                timeout=5.0)
            except OSError:
                time.sleep(0.2)
                continue
            try:
                sock.settimeout(10.0)
                _send_msg_raw(sock, {"op": "co_replicate"})
                head = _recv_msg(sock)
                if head is None or head.get("status") != "ok":
                    time.sleep(0.2)
                    continue
                self._apply_co_state(head)
                last = head
                sock.settimeout(None)
                while not self._stop_evt.is_set():
                    upd = _recv_msg(sock)
                    if upd is None:
                        break       # primary is gone
                    self._apply_co_state(upd)
                    last = upd
            except (OSError, ConnectionError):
                pass
            finally:
                try:
                    sock.close()
                except OSError:
                    pass
            if not self._stop_evt.is_set() and last:
                # the primary died AFTER we were caught up: take over
                self._promote()
                return
            time.sleep(0.2)

    def _apply_co_state(self, st: dict):
        with self._cond:
            self._gen = max(self._gen, int(st.get("gen", 0)))
            self._uid_next = max(self._uid_next,
                                 int(st.get("uid_next", 0)))
            cs = st.get("ckpt_step")
            if cs is not None and (self._ckpt_step is None
                                   or int(cs) > self._ckpt_step):
                self._ckpt_step = int(cs)

    def _promote(self):
        with self._cond:
            # fence PAST everything the dead primary ever handed out: a
            # zombie worker's stale (gen, round) can never match here
            self._gen += 1
            if self._ckpt_dir:
                scanned = _scan_ckpt_dir(self._ckpt_dir)
                if scanned is not None and (
                        self._ckpt_step is None
                        or scanned > self._ckpt_step):
                    self._ckpt_step = scanned
            self.promoted = True
            gen, step = self._gen, self._ckpt_step
            self._cond.notify_all()
        _flight.record("elastic.promote", was_standby_of=self.standby_of,
                       gen=int(gen),
                       ckpt_step=(None if step is None else int(step)))
        _monitor.stat_add("elastic_coord_promotions")

    def _lease_loop(self):
        """Lease-based liveness for wedged-but-connected workers: a
        member that has neither RPC'd nor joined the pending round
        within ``lease_s`` while peers wait on it is evicted exactly
        like a died one."""
        while not self._stop_evt.wait(max(self._lease_s / 4.0, 0.05)):
            evicted = []
            with self._cond:
                if not self._rounds:
                    continue
                now = time.monotonic()
                waiting_ranks = set()
                for r in self._rounds.values():
                    if r.result is None:
                        waiting_ranks |= set(r.payloads)
                for uid, m in list(self._members.items()):
                    if m.rank in waiting_ranks:
                        continue
                    if now - m.last_seen > self._lease_s:
                        evicted.append(self._members.pop(uid))
                        self.events.append(("lease", uid, self._gen))
                if evicted and (self._members or self._pending):
                    self._reform_locked()
                elif evicted:
                    self._gen += 1
                    self._rounds.clear()
                    self._co_publish_locked()
                    self._cond.notify_all()
            for m in evicted:
                _flight.record("elastic.leave", uid=int(m.uid),
                               reason="lease", gen=int(self._gen))
                try:
                    m.conn.close()
                except OSError:
                    pass


class ElasticClient:
    """Worker-side connection to the :class:`ElasticCoordinator`.

    ``endpoint`` may be a failover LIST (``"h:p1|h:p2"``):
    the client connects to the first endpoint that answers as a
    PROMOTED coordinator.  Any transport death — or a ``standby``
    answer after a failover — surfaces as :class:`CoordinatorLost`;
    :meth:`rejoin` then rotates through the list, re-registers (the
    promoted standby assigns a fresh uid under a fenced generation) and
    returns the new membership info for the trainer to reform under.
    """

    def __init__(self, endpoint: str, timeout: float = 120.0,
                 connect_retries: int = 40, retry_delay: float = 0.25):
        self._eps = [e for e in str(endpoint).split("|") if e]
        if not self._eps:
            raise ValueError(f"empty coordinator endpoint {endpoint!r}")
        self._active = 0
        self._timeout = float(timeout)
        self._retries = max(1, int(connect_retries))
        self._retry_delay = float(retry_delay)
        self._lock = threading.Lock()
        self._sock: Optional[socket.socket] = None
        self.uid: Optional[int] = None
        self._connect_any()

    def _connect_any(self):
        """(Re)connect to the first reachable endpoint, rotating
        through the list.  Caller must not hold ``self._lock``."""
        last: Optional[BaseException] = None
        with self._lock:
            if self._sock is not None:
                try:
                    self._sock.close()
                except OSError:
                    pass
                self._sock = None
            for attempt in range(self._retries * len(self._eps)):
                ep = self._eps[self._active]
                try:
                    sock = socket.create_connection(_parse_ep(ep),
                                                    timeout=5.0)
                except OSError as e:
                    last = e
                    self._active = (self._active + 1) % len(self._eps)
                    time.sleep(self._retry_delay)
                    continue
                sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY,
                                1)
                sock.settimeout(self._timeout)
                self._sock = sock
                return
        raise ConnectionError(
            f"elastic coordinator unreachable at "
            f"{'|'.join(self._eps)}: {last}")

    def _rpc(self, msg) -> dict:
        with self._lock:
            if self._sock is None:
                raise CoordinatorLost("not connected")
            try:
                _send_msg_raw(self._sock, msg)
                rep = _recv_msg(self._sock)
            except (OSError, ConnectionError) as e:
                try:
                    self._sock.close()
                except OSError:
                    pass
                self._sock = None
                raise CoordinatorLost(
                    f"elastic coordinator connection died: {e}") from e
        if rep is None:
            with self._lock:
                if self._sock is not None:
                    try:
                        self._sock.close()
                    except OSError:
                        pass
                    self._sock = None
            raise CoordinatorLost(
                "elastic coordinator closed the connection")
        return rep

    def register(self, expected_world: int = 1) -> dict:
        deadline = time.monotonic() + self._timeout
        while True:
            rep = self._rpc({"op": "register",
                             "world": int(expected_world)})
            if rep.get("status") == "standby":
                # rotated onto an un-promoted standby (failover in
                # flight): try the next endpoint until one has promoted
                if time.monotonic() > deadline:
                    raise ConnectionError(
                        f"no promoted coordinator in "
                        f"{'|'.join(self._eps)}")
                self._active = (self._active + 1) % len(self._eps)
                time.sleep(self._retry_delay)
                self._connect_any()
                continue
            if rep.get("status") != "ok":
                raise ConnectionError(f"elastic register rejected: {rep}")
            self.uid = rep["uid"]
            return rep

    def rejoin(self, expected_world: int = 1) -> dict:
        """After :class:`CoordinatorLost`: rotate to the promoted
        coordinator and register as a fresh member."""
        self._active = (self._active + 1) % len(self._eps)
        self._connect_any()
        return self.register(expected_world)

    def exchange(self, gen: int, step: int, tag: str,
                 arrays: Optional[Dict[str, np.ndarray]] = None):
        """All-gather ``arrays`` across the generation's members for
        (step, tag).  Returns ``("ok", [payload_rank0, ...])`` or
        ``(status, raw_reply)`` for reform/evicted/stopped."""
        msg: Dict[str, Any] = {"op": "exchange", "uid": self.uid,
                               "gen": int(gen), "step": int(step),
                               "tag": str(tag)}
        for k, v in (arrays or {}).items():
            msg[f"a:{k}"] = np.ascontiguousarray(v)
        rep = self._rpc(msg)
        if rep.get("status") != "ok":
            return rep.get("status", "error"), rep
        out: List[dict] = [dict() for _ in range(int(rep["world"]))]
        for k, v in rep.items():
            mt = _PAYLOAD_KEY.match(k) if isinstance(k, str) else None
            if mt:
                out[int(mt.group(1))][mt.group(2)] = v
        return "ok", out

    def report_ckpt(self, step: int):
        self._rpc({"op": "ckpt", "uid": self.uid, "step": int(step)})

    def status(self) -> dict:
        return self._rpc({"op": "status"})

    def leave(self):
        try:
            self._rpc({"op": "leave", "uid": self.uid})
        except (OSError, ConnectionError):
            pass
        self.close()

    def close(self):
        try:
            self._sock.close()
        except OSError:
            pass


# -- flat (host-resident) ZeRO-shard optimizers -------------------------
#
# The elastic data plane keeps optimizer state as flat f32 vectors so
# a reshard is pure slicing; the update is strictly ELEMENTWISE (every
# constant pinned to f32) so a shard's update equals the same slice of
# the full-vector update bit-for-bit — the property the N->M reshard
# tests assert.  The step count ``t`` equals the number of applied
# global steps (world-size invariant), so Adam's bias correction is a
# pure function of the global step.

class _FlatSGD:
    SLOTS: Tuple[str, ...] = ()
    KIND = "sgd"

    def __init__(self, lr, lr_schedule=None, fused=False, device=None,
                 **_):
        self.lr = np.float32(lr)
        # t-indexed schedule: a pure function of
        # the 1-based global step — see dist_step.LRSchedule.  Because
        # ``t`` is world-size invariant (checkpointed as opt_t) and the
        # schedule is stateless config, lr(t) is bit-identical across
        # any N->M reshard mid-schedule.
        self.sched = lr_schedule
        self.t = 0
        # fused: route the update through the opt_apply kernel
        # (dist_step.fused_optimizer_apply) on ``device`` — ONE device
        # pass over grad+param+moments instead of the numpy expression
        # chain.  The kernel and its plain version round as numpy does
        # (ops/kernels/opt_apply.py), so both routes give the same bits.
        self.fused = bool(fused)
        self.device = device

    def lr_at(self, t: int) -> np.float32:
        return self.lr if self.sched is None else np.float32(
            self.sched(t))

    def _hyper(self) -> dict:
        return {"lr": self.lr_at(self.t)}

    def _fused_update(self, p, g):
        p_new, slots = fused_optimizer_apply(
            self.KIND, p, g,
            {k: getattr(self, k) for k in self.SLOTS},
            t=self.t, device=self.device, **self._hyper())
        for k in self.SLOTS:
            setattr(self, k, slots[k])
        return p_new

    def load(self, slots: Dict[str, np.ndarray], t: int):
        if set(slots) != set(self.SLOTS):
            raise ValueError(
                f"optimizer slots {sorted(slots)} do not match "
                f"{sorted(self.SLOTS)} — the checkpoint was written by "
                f"a different optimizer")
        self.t = int(t)
        for k in self.SLOTS:
            setattr(self, k, np.asarray(slots[k], np.float32).copy())

    def state(self) -> Dict[str, np.ndarray]:
        return {k: getattr(self, k) for k in self.SLOTS}

    def update(self, p: np.ndarray, g: np.ndarray) -> np.ndarray:
        self.t += 1
        if self.fused:
            return self._fused_update(p, g)
        return (p - self.lr_at(self.t) * g).astype(np.float32)


class _FlatMomentum(_FlatSGD):
    SLOTS = ("u",)
    KIND = "momentum"

    def __init__(self, lr, momentum=0.9, **kw):
        super().__init__(lr, **kw)
        self.mu = np.float32(momentum)
        self.u = None

    def _hyper(self):
        return {"lr": self.lr_at(self.t), "momentum": self.mu}

    def update(self, p, g):
        self.t += 1
        if self.fused:
            return self._fused_update(p, g)
        self.u = (self.mu * self.u + g).astype(np.float32)
        return (p - self.lr_at(self.t) * self.u).astype(np.float32)


class _FlatAdam(_FlatSGD):
    SLOTS = ("m", "v")
    KIND = "adam"

    def __init__(self, lr, betas=(0.9, 0.999), eps=1e-8, **kw):
        super().__init__(lr, **kw)
        self.b1 = float(betas[0])
        self.b2 = float(betas[1])
        self.eps = np.float32(eps)
        self.m = None
        self.v = None

    def _hyper(self):
        return {"lr": self.lr_at(self.t), "betas": (self.b1, self.b2),
                "eps": self.eps}

    def update(self, p, g):
        self.t += 1
        if self.fused:
            return self._fused_update(p, g)
        b1, b2 = np.float32(self.b1), np.float32(self.b2)
        self.m = (b1 * self.m + (np.float32(1) - b1) * g) \
            .astype(np.float32)
        self.v = (b2 * self.v + (np.float32(1) - b2) * g * g) \
            .astype(np.float32)
        # bias correction: pure function of the global step count
        c1 = np.float32(1.0 - self.b1 ** self.t)
        c2 = np.float32(1.0 - self.b2 ** self.t)
        mhat = self.m / c1
        vhat = self.v / c2
        return (p - self.lr_at(self.t) * mhat
                / (np.sqrt(vhat) + self.eps)).astype(np.float32)


_FLAT_OPTS = {"sgd": _FlatSGD, "momentum": _FlatMomentum,
              "adam": _FlatAdam}


class ElasticTrainer:
    """Membership-aware deterministic training loop (see the module
    docstring for the determinism contract).

    ``params``: ``{name: ndarray}`` initial values (only rank 0 of the
    FIRST generation ever uses them — it writes the pinned step-0
    checkpoint every later (re)join restores from, which is also how a
    joiner with a divergent init is forced onto the canonical state).
    ``grad_fn(params_dict, batch) -> grads_dict``: a pure,
    deterministic per-microbatch gradient function over numpy arrays.
    ``loader``: a seeded :class:`~paddle_tpu_torch.io.dataloader.DataLoader`
    (its cursor is checkpointed for exact replay).

    ``engine``: ``"device"`` (default) or ``"host"``.  ``fused_optimizer``
    (default: on for the device engine) routes the optimizer through
    ``opt_apply``.  ``device``: where the device engine and the fused
    optimizer run (``None`` means ``cuda``, which raises without a card;
    ``"cpu"`` runs the kernel's plain version).  The host engine without
    the fused optimizer touches no device.
    """

    def __init__(self, params: Dict[str, np.ndarray],
                 grad_fn: Callable[[Dict[str, np.ndarray], Any],
                                   Dict[str, np.ndarray]],
                 loader, *, ckpt_dir: str, optimizer: str = "adam",
                 lr: float = 0.01, lr_schedule=None,
                 betas=(0.9, 0.999), eps: float = 1e-8,
                 momentum: float = 0.9, micro_batches: int = 1,
                 ckpt_every: int = 10, max_to_keep: int = 5,
                 coordinator: Optional[str] = None,
                 expected_world: Optional[int] = None,
                 client_timeout: float = 120.0,
                 role_maker: Optional[ElasticRoleMaker] = None,
                 fused_optimizer: Optional[bool] = None,
                 engine: Optional[str] = None, device=None):
        flat0, meta = flatten_zero_state(
            {k: np.asarray(v, np.float32) for k, v in params.items()})
        self._init_flat = flat0.astype(np.float32)
        self._meta = meta
        self._numel = int(flat0.size)
        self._grad_fn = grad_fn
        self._loader = loader
        self._micro = int(micro_batches)
        if self._micro < 1:
            raise ValueError("micro_batches must be >= 1")
        if optimizer not in _FLAT_OPTS:
            raise ValueError(f"optimizer must be one of "
                             f"{sorted(_FLAT_OPTS)}, got {optimizer!r}")
        if isinstance(lr_schedule, dict):
            lr_schedule = make_lr_schedule(**lr_schedule)
        # engine selection: "device" (default) sums the slot gradients
        # on the card, applies the optimizer through opt_apply and
        # streams checkpoints range-wise; "host" is the flat-numpy
        # path.  Constructor arguments only: no environment variable
        # selects the engine or the kernel.
        eng = engine or "device"
        if eng not in ("device", "host"):
            raise ValueError(
                f"engine must be 'device' or 'host', got {eng!r}")
        self.engine = eng
        fused = (eng == "device") if fused_optimizer is None \
            else bool(fused_optimizer)
        self.device = (resolve_device(device)
                       if eng == "device" or fused else None)
        self._opt = _FLAT_OPTS[optimizer](lr, betas=betas, eps=eps,
                                          momentum=momentum,
                                          lr_schedule=lr_schedule,
                                          fused=fused, device=self.device)
        self._engine: Optional[DeviceZeroEngine] = (
            DeviceZeroEngine(self._micro, self._numel, device=self.device)
            if eng == "device" else None)
        # per-trainer staging meter (models per-HOST accounting — the
        # in-process multi-rank tests would alias a process-global one);
        # peak_bytes is the O(max shard) bound tests assert on
        self.reshard_meter = ReshardMeter()
        self._mgr = CheckpointManager(ckpt_dir, max_to_keep=max_to_keep)
        self._ckpt_every = int(ckpt_every)
        self._endpoint = coordinator
        self._expected_world = expected_world
        self._client_timeout = float(client_timeout)
        self._role_maker = role_maker or ElasticRoleMaker()
        self._client: Optional[ElasticClient] = None
        self._flat: Optional[np.ndarray] = None
        self._full_slots: Dict[str, np.ndarray] = {}
        self._bit = None
        # membership transitions this worker lived through (tests +
        # postmortems read this): {"gen","rank","world","resume_step"}
        self.transitions: List[dict] = []

    # -- public surface -------------------------------------------------
    @property
    def role_maker(self) -> ElasticRoleMaker:
        return self._role_maker

    def params(self) -> Dict[str, np.ndarray]:
        if self._flat is None:
            return dict(unflatten_zero_state(self._init_flat.copy(),
                                             self._meta))
        return {k: v.copy() for k, v in
                unflatten_zero_state(self._flat, self._meta).items()}

    def opt_shard(self) -> Dict[str, np.ndarray]:
        """This worker's live optimizer-state shard (+ step count)."""
        out = {k: v.copy() for k, v in self._opt.state().items()}
        out["t"] = np.asarray(self._opt.t, np.int64)
        return out

    def run(self, total_steps: int) -> Dict[str, np.ndarray]:
        endpoint = self._endpoint or os.environ.get("PADDLE_COORDINATOR")
        if not endpoint:
            raise RuntimeError(
                "elastic training needs a coordinator: pass "
                "coordinator='host:port' or set PADDLE_COORDINATOR "
                "(the launcher's --elastic mode exports it)")
        expected = self._expected_world or int(
            os.environ.get("PADDLE_TRAINERS_NUM", "1"))
        self._client = ElasticClient(endpoint,
                                     timeout=self._client_timeout)
        self._finished = False
        info = self._client.register(expected)
        try:
            while True:
                try:
                    return self._run_generation(dict(info),
                                                int(total_steps))
                except Reform as e:
                    info = e.info
        finally:
            self._close_batches()

    # -- generation loop ------------------------------------------------
    def _run_generation(self, info, total: int):
        gen = int(info["gen"])
        rank = int(info["rank"])
        world = int(info["world"])
        ckpt_step = info.get("ckpt_step")
        if self._finished:
            # teardown cascade: each peer's leave() reforms the
            # shrinking survivor world, but this trainer already ran
            # its steps and passed a completion fence — resharding
            # here would be pure waste (a full restore + rebuild
            # per surviving rank per leave; at world 1 the restore
            # stages 2x the FULL vector, busting the O(max shard)
            # staging bound).  Hold the new generation's fence so
            # peers still draining don't hang on the barrier, then go.
            self._exchange(gen, total, "done", {})
            self._client.leave()
            return self.params()
        mesh_mod.reform_mesh()
        self._role_maker.update_membership(rank, world, gen)
        self.transitions.append({"gen": gen, "rank": rank,
                                 "world": world,
                                 "resume_step": ckpt_step})
        _monitor.stat_add("elastic_transitions")
        if ckpt_step is None:
            # bootstrap: rank 0 pins step 0 from its init state; the
            # barrier makes it durable before anyone trains (identical
            # re-saves after a reform mid-bootstrap are atomic no-ops)
            if rank == 0:
                self._save_checkpoint(0, bootstrap=True, world=world)
                self._report_ckpt(0)
            self._exchange(gen, 0, "bootstrap", {})
            ckpt_step = 0
        start = self._restore(int(ckpt_step), rank, world, gen)
        my_slots = zero_shard_ranges(self._micro, world)[rank]
        lo, hi = zero_shard_ranges(self._numel, world)[rank]
        if self._engine is not None:
            # per-generation rebuild: the reshard window ends with the
            # kernel warmed for the NEW (world, shard) — steady-state
            # steps never pay a first build or launch
            self._engine.rebuild(self._opt, world, rank, lo, hi, gen)
        for step in range(start, total):
            _chaos.maybe_kill_worker()
            batch = self._next_batch()
            payload = {f"g{s}": self._slot_grad(batch, s)
                       for s in range(my_slots[0], my_slots[1])}
            reps = self._exchange(gen, step, "grads", payload)
            merged: Dict[str, np.ndarray] = {}
            for rp in reps:
                merged.update(rp)
            # world-size-invariant reduction: fixed slot order, every
            # worker sums the same byte-identical wire copies (device
            # engine: the same f32 adds on the card — the world size
            # never enters them, so bit-equality across ranks AND
            # worlds holds exactly as in the host loop)
            if self._engine is not None:
                gsum = self._engine.reduce(
                    [merged[f"g{s}"] for s in range(self._micro)])
            else:
                gsum = np.zeros(self._numel, np.float32)
                for s in range(self._micro):
                    gsum += merged[f"g{s}"]
            new_shard = self._opt.update(self._flat[lo:hi], gsum[lo:hi])
            reps = self._exchange(gen, step, "params",
                                  {"p": new_shard})
            self._flat = np.concatenate(
                [np.asarray(reps[r]["p"], np.float32)
                 for r in range(world)])
            done = step + 1
            if done % self._ckpt_every == 0 or done == total:
                self._checkpoint_round(gen, step, rank, world, done)
        # completion fence: rank 0's final _report_ckpt is an RPC that
        # runs AFTER the last ckpt barrier — without this barrier a
        # faster peer's leave() reforms the generation under that RPC
        # and rolls rank 0 into a spurious world-1 generation at the
        # finish line (observed as a completion-window flake).  Every
        # member of this generation reaches the fence (a rejoiner that
        # restored the final checkpoint runs zero steps and lands here
        # too), so nobody leaves before the report is durable.
        # set BEFORE the fence: a peer's leave can reform the generation
        # while our done-exchange is in flight, and the re-entry must
        # already know the steps + final checkpoint round are behind us
        self._finished = True
        self._exchange(gen, total, "done", {})
        self._client.leave()
        return self.params()

    # -- state ----------------------------------------------------------
    def _view_chunks(self, src: np.ndarray, ranges):
        """Zero-arg chunk factory over VIEWS of a resident flat vector,
        staged (and metered) one shard range at a time at write time."""
        src = np.asarray(src, np.float32)

        def chunks():
            for a, b in ranges:
                with self.reshard_meter.hold(src[a:b]) as c:
                    yield c
        return chunks

    def _zero_chunks(self, ranges):
        """Bootstrap slots, materialized one shard range at a time —
        rank 0 never allocates a full ``numel`` zero vector per slot."""
        def chunks():
            for a, b in ranges:
                with self.reshard_meter.hold(
                        np.zeros(b - a, np.float32)) as c:
                    yield c
        return chunks

    def _save_checkpoint(self, done: int, bootstrap: bool = False,
                         world: Optional[int] = None, opt_streams=None):
        cursor = self._loader.state_dict()
        flat = self._init_flat if bootstrap else self._flat
        t = 0 if bootstrap else self._opt.t
        if self._engine is not None:
            # streamed path: every array leaf goes to disk
            # shard-by-shard through StreamedArray — the on-disk bytes
            # are IDENTICAL to the concat path (same .npy payload, same
            # index; tests prove byte equality), only the staging
            # changes: O(max shard), not O(numel * slots).
            assert world is not None, "device-path save needs the world"
            ranges = zero_shard_ranges(self._numel, world)
            model_leaf: Any = StreamedArray(
                (self._numel,), np.float32,
                self._view_chunks(flat, ranges))
            if opt_streams is None:
                # bootstrap runs on rank 0 ALONE, before the barrier —
                # no exchange rounds, just streamed zeros
                opt_streams = {k: StreamedArray(
                    (self._numel,), np.float32, self._zero_chunks(ranges))
                    for k in self._opt.SLOTS}
            opt: Any = opt_streams
        else:
            model_leaf = np.asarray(flat, np.float32)
            opt = ({k: np.zeros(self._numel, np.float32)
                    for k in self._opt.SLOTS} if bootstrap
                   else self._full_slots)
        state = {
            "model": {"flat": model_leaf},
            "opt": opt,
            "meta": {"step": int(done), "opt_t": int(t),
                     "epoch": int(cursor["epoch"]),
                     "batch": int(cursor["batch"])},
        }
        self._mgr.save(done, state)
        self._mgr.pin(done)
        for s in self._mgr.pinned_steps()[:-2]:
            self._mgr.unpin(s)

    def _checkpoint_round(self, gen, step, rank, world, done):
        if self._engine is None:
            payload = {f"s:{k}": v
                       for k, v in self._opt.state().items()}
            reps = self._exchange(gen, step, "ckpt", payload)
            if rank == 0:
                self._full_slots = {
                    k: np.concatenate([np.asarray(reps[r][f"s:{k}"],
                                                  np.float32)
                                       for r in range(world)])
                    for k in self._opt.SLOTS}
                self._save_checkpoint(done)
                self._report_ckpt(done)
            return
        # device path: slot state moves range-wise — one
        # coordinator round per (slot, owner rank), tag "ckpt:{k}:{r}"
        # (distinct tags are distinct barriers) — and rank 0 consumes
        # each round INSIDE the streamed writer, so no rank ever stages
        # more than one shard of any slot.  Every rank must run the
        # identical round sequence: SLOTS order, then owner rank
        # 0..world-1; rank 0's rounds fire lazily from the chunk
        # generators in exactly that order because the state dict
        # writes model||flat (no rounds) first, then slots in SLOTS
        # order.  A Reform mid-round unwinds through the writer: the
        # index is never written, so the torn step stays invisible and
        # the deterministic replay re-saves identical bytes.
        my = self._opt.state()
        moved = {"bytes": 0}

        def slot_chunks(k):
            def chunks():
                for r in range(world):
                    reps = self._exchange(
                        gen, step, f"ckpt:{k}:{r}",
                        {"s": my[k]} if r == rank else {})
                    c = np.asarray(reps[r]["s"], np.float32)
                    moved["bytes"] += int(c.nbytes)
                    with self.reshard_meter.hold(c):
                        yield c
            return chunks

        if rank == 0:
            streams = {k: StreamedArray((self._numel,), np.float32,
                                        slot_chunks(k))
                       for k in self._opt.SLOTS}
            self._save_checkpoint(done, world=world,
                                  opt_streams=streams)
        else:
            for k in self._opt.SLOTS:
                for r in range(world):
                    self._exchange(gen, step, f"ckpt:{k}:{r}",
                                   {"s": my[k]} if r == rank else {})
                    if r == rank:
                        moved["bytes"] += int(my[k].nbytes)
        _flight.record("elastic.reshard.exchange", step=int(done),
                       gen=int(gen), rank=int(rank), world=int(world),
                       bytes=int(moved["bytes"]),
                       rounds=len(self._opt.SLOTS) * world)
        if rank == 0:
            self._report_ckpt(done)

    def _restore(self, ckpt_step: int, rank: int, world: int, gen: int):
        t0 = time.perf_counter()
        lo, hi = zero_shard_ranges(self._numel, world)[rank]
        if self._engine is None:
            st = self._mgr.restore(ckpt_step)
            flat = np.asarray(st["model"]["flat"], np.float32)
            if flat.size != self._numel:
                raise RuntimeError(
                    f"checkpoint step {ckpt_step} holds {flat.size} "
                    f"parameters, this trainer expects {self._numel}")
            meta = st["meta"]
            slots = {k: np.asarray(v, np.float32)[lo:hi].copy()
                     for k, v in st.get("opt", {}).items()}
            self._opt.load(slots, t=meta["opt_t"])
            self._flat = flat.copy()
            nbytes = int(flat.nbytes) + sum(
                int(np.asarray(v).nbytes)
                for v in st.get("opt", {}).values())
        else:
            # ranged path: slots come back as O(shard)
            # mmap ranged reads and the replica is assembled range-wise
            # — the restore MACHINERY never stages more than a shard
            # (the replica itself is full-size by the grad_fn host
            # contract; that is the bound the meter test pins down)
            shape, _ = self._mgr.entry_meta(ckpt_step,
                                            ("model", "flat"))
            if len(shape) != 1 or int(shape[0]) != self._numel:
                raise RuntimeError(
                    f"checkpoint step {ckpt_step} holds shape {shape} "
                    f"parameters, this trainer expects ({self._numel},)")
            meta = self._mgr.restore(ckpt_step, names=["meta"])["meta"]
            nbytes = 0
            with contextlib.ExitStack() as held:
                slots = {}
                for k in self._opt.SLOTS:
                    arr = self._mgr.restore_range(ckpt_step,
                                                  ("opt", k), lo, hi)
                    held.enter_context(self.reshard_meter.hold(arr))
                    slots[k] = np.asarray(arr, np.float32)
                    nbytes += int(arr.nbytes)
                # load() copies the shard into live state while the
                # staging is still held — the meter sees staging only
                self._opt.load(slots, t=meta["opt_t"])
            flat = np.empty(self._numel, np.float32)
            for a, b in zero_shard_ranges(self._numel, world):
                with self.reshard_meter.hold(
                        self._mgr.restore_range(
                            ckpt_step, ("model", "flat"), a, b)) as c:
                    flat[a:b] = c
                    nbytes += int(c.nbytes)
            self._flat = flat
            _flight.record(
                "elastic.reshard.load",
                ms=round((time.perf_counter() - t0) * 1e3, 3),
                bytes=int(nbytes), gen=int(gen), world=int(world),
                rank=int(rank), step=int(ckpt_step))
        self._loader.load_state_dict({"epoch": meta["epoch"],
                                      "batch": meta["batch"],
                                      "seed": self._loader.seed})
        self._close_batches()
        ms = (time.perf_counter() - t0) * 1e3
        _monitor.hist_observe("reshard_ms", ms)
        _monitor.hist_observe("reshard_bytes", float(nbytes))
        _flight.record("elastic.reshard", ms=round(ms, 3), gen=int(gen),
                       world=int(world), step=int(meta["step"]),
                       bytes=int(nbytes), engine=self.engine)
        _flight.record("elastic.resume", gen=int(gen), rank=int(rank),
                       world=int(world), step=int(meta["step"]))
        return int(meta["step"])

    # -- data -----------------------------------------------------------
    def _close_batches(self):
        """Drop the live batch iterator (its prefetch thread ends with
        it): the cursor moved, or the run is over."""
        if self._bit is not None:
            self._bit.close()
            self._bit = None

    def _next_batch(self):
        if self._bit is None:
            self._bit = iter(self._loader)
        try:
            b = next(self._bit)
        except StopIteration:
            self._bit = iter(self._loader)
            b = next(self._bit)
        return _batch_to_numpy(b)

    def _slot_grad(self, batch, s: int) -> np.ndarray:
        lead = _leading_dim(batch)
        if lead % self._micro:
            raise ValueError(
                f"global batch dim {lead} not divisible by "
                f"micro_batches={self._micro}")
        mb = lead // self._micro
        sl = _slice_batch(batch, s * mb, (s + 1) * mb)
        params = unflatten_zero_state(self._flat, self._meta)
        grads = self._grad_fn(params, sl)
        gflat, gmeta = flatten_zero_state(
            {k: np.asarray(v, np.float32) for k, v in grads.items()})
        if gmeta != self._meta:
            raise ValueError(
                f"grad_fn returned tree {gmeta} but the parameter tree "
                f"is {self._meta}")
        return gflat

    # -- exchange wrapper -----------------------------------------------
    def _exchange(self, gen, step, tag, arrays) -> List[dict]:
        try:
            status, rep = self._client.exchange(gen, step, tag, arrays)
        except ConnectionError:
            # the coordinator died (CoordinatorLost) — rotate to its
            # promoted standby, register fresh under the fenced
            # generation and reform from the replicated pinned step,
            # exactly the worker-loss path (coordinator HA)
            raise Reform(self._rejoin())
        if status == "ok":
            return rep
        if status == "reform":
            raise Reform({"gen": rep["gen"], "rank": rep["rank"],
                          "world": rep["world"],
                          "ckpt_step": rep.get("ckpt_step")})
        if status == "evicted":
            # our membership lapsed (lease) — rejoin from scratch
            info = self._client.register(self._expected_world or 1)
            raise Reform(info)
        if status == "standby":
            raise Reform(self._rejoin())
        raise RuntimeError(f"elastic exchange failed: {rep}")

    def _rejoin(self) -> dict:
        info = self._client.rejoin(self._expected_world or 1)
        _flight.record("elastic.join", uid=int(info.get("uid", -1)),
                       gen=int(info["gen"]), world=int(info["world"]))
        return info

    def _report_ckpt(self, done: int):
        try:
            self._client.report_ckpt(done)
        except ConnectionError:
            # the checkpoint is on disk; membership reforms and the
            # promoted coordinator's ckpt_dir scan (or a later report)
            # picks it up — losing the report must not kill the run
            raise Reform(self._rejoin())


# -- numpy batch utilities ----------------------------------------------

def _batch_to_numpy(batch):
    if isinstance(batch, torch.Tensor):
        return batch.detach().cpu().numpy()
    if isinstance(batch, (list, tuple)):
        return type(batch)(_batch_to_numpy(b) for b in batch)
    if isinstance(batch, dict):
        return {k: _batch_to_numpy(v) for k, v in batch.items()}
    return np.asarray(batch)


def _leading_dim(batch) -> int:
    if isinstance(batch, np.ndarray):
        return batch.shape[0]
    if isinstance(batch, (list, tuple)):
        for b in batch:
            return _leading_dim(b)
    if isinstance(batch, dict):
        for b in batch.values():
            return _leading_dim(b)
    raise ValueError("cannot find a leading batch dimension")


def _slice_batch(batch, lo: int, hi: int):
    if isinstance(batch, np.ndarray):
        return batch[lo:hi]
    if isinstance(batch, (list, tuple)):
        return type(batch)(_slice_batch(b, lo, hi) for b in batch)
    if isinstance(batch, dict):
        return {k: _slice_batch(v, lo, hi) for k, v in batch.items()}
    return batch
