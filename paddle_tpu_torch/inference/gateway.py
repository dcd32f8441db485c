"""A self-healing inference gateway (counterpart of
``paddle_tpu/inference/gateway.py``): a prefix-affinity router over N
``GenerationServer`` replicas whose failover is token-identical by
construction.

- **prefix-affinity routing**: a request hashes onto the replica ring by
  the blake2b chain hash of its first prompt block
  (``prefix_cache.chain_hashes``, the digest each replica's prefix cache
  indexes its KV by) over the PS service's vnode ring
  (``ps_service._build_ring``).  A conversation's turns share their first
  block, so they land where their KV blocks already live, and adding or
  removing a replica remaps about 1/N of the sessions.
- **failover by re-prefill and replay**: a one-shot RPC a replica (no
  retries inside; a failure closes the socket and arms a bounded
  backoff; the ring's fall-through is the retry).  When a replica dies
  mid-stream (EOF, timeout, SIGKILL) the router re-submits the original
  prompt, in ring order, with ``replay_tokens=`` everything already
  delivered.  Token j's sampling draw is a pure function of (request
  seed, j), and every position's logits the same bits whatever the call
  that computes them (one arithmetic a position, row-floored GEMMs), so
  the re-run is token-identical and ``check_replay`` asserts it.  The
  client's :class:`GenerationStream` never errors: it stalls for the
  failover and resumes where it left off (the router's cursor is the
  number of tokens it delivered; a replica is only asked for what comes
  after).
- **KV migration for a graceful drain**: :meth:`GatewayRouter.drain`
  stops a replica's admission, exports each live sequence's block table
  and pool rows (:mod:`.migration`), rebuilds them on ring-order
  targets (or ships only tokens and re-prefills), and drops the replica
  from the ring.
- **deadline-aware admission, once at the router**: per-tenant
  in-flight token budgets, the remaining deadline carried on every
  re-route (a failed-over request never exceeds its original budget),
  typed :class:`ServerDraining` / :class:`ServerOverloaded` /
  :class:`RequestTimeout` at the router, and deadline-ordered shedding
  under pressure (the request with the most slack is the one shed).

Chaos: ``distributed/fleet/chaos.py``'s gateway site (``kill:gen_step``,
fired by the scheduler's ``maybe_kill_replica``) SIGKILLs a replica
mid-decode, and the RPC protocol here rides the PS framing layer
(``_send_msg`` / ``_recv_msg``), so cut / slow / drop faults on the
replica link match its ops (``gen_poll`` ...).
``python -m paddle_tpu_torch.tools.chaos_gateway`` exits 0 only if every
stream survives a SIGKILLed replica and a drain token for token.

Observability: always-on counters ``gw_failovers``,
``gw_migrated_seqs`` and ``gw_sheds{reason}``, a ``gw_failover_ms``
histogram (on when metrics are), and flight events ``gw.route``,
``gw.failover``, ``gw.migrate`` and ``gw.drain``.

Every wait is bounded: RPCs by their socket timeouts, the RPC server's
threads by a poll interval, ``stop()`` by its join timeout, a stream by
its deadline.
"""
from __future__ import annotations

import hashlib
import select
import socket
import threading
import time
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..distributed.fleet import chaos as _chaos
from ..distributed.fleet.ps_service import (_build_ring, _recv_msg,
                                            _send_msg)
from ..framework import monitor as _monitor
from ..observability import flight_recorder as _flight
from .generation_server import GenerationStream
from .migration import MigrationUnsupported, export_sequence, \
    import_sequence
from .prefix_cache import chain_hashes
from .serving import (RequestTimeout, ServeError, ServerClosed,
                      ServerDraining, ServerOverloaded)

__all__ = ["GatewayRouter", "LocalReplica", "RemoteReplica",
           "GenerationRpcServer", "ReplicaLost"]


class ReplicaLost(ServeError):
    """A replica stopped answering (EOF, timeout, refused, SIGKILL).
    Internal to the gateway: the router turns it into a failover, never
    into a client-visible error."""


# -- replica-side request book ------------------------------------------

class _ReplicaCore:
    """Maps gateway request ids to live streams on one
    ``GenerationServer``, for the in-process and the RPC-served replica
    front ends alike.  ``base`` is the token prefix the stream was
    re-submitted with (``replay_tokens``): a request's whole view on
    this replica is ``base + stream.tokens``, so the router's cursor
    arithmetic is the same whether the request lived here from the
    start or failed over in."""

    def __init__(self, server):
        self.server = server
        self._lock = threading.Lock()
        self._reqs: Dict[int, dict] = {}

    def submit(self, grid: int, prompt, kw: dict, base=()):
        stream = self.server.submit(
            np.asarray(prompt, np.int32),
            replay_tokens=list(base) or None, **kw)
        with self._lock:
            self._reqs[grid] = {"stream": stream, "base": list(base)}

    def poll(self, reqs) -> List[dict]:
        out = []
        for grid, cursor in reqs:
            with self._lock:
                ent = self._reqs.get(grid)
            if ent is None:
                out.append({"grid": grid, "toks": [], "done": True,
                            "reason": None, "err": "unknown"})
                continue
            st = ent["stream"]
            # read completion before the tokens: finish_reason is set
            # after the final append, so done here means the token list
            # below is complete (the other order could report done with
            # the last token missing)
            exc = st._exc
            done = st.finish_reason is not None or exc is not None
            err = None
            if exc is not None:
                err = ("timeout" if isinstance(exc, RequestTimeout)
                       else "lost")
            toks = ent["base"] + list(st.tokens)
            out.append({"grid": grid, "toks": toks[int(cursor):],
                        "done": done, "reason": st.finish_reason,
                        "err": err})
            if done:
                with self._lock:
                    self._reqs.pop(grid, None)
        return out

    def cancel(self, grid: int) -> bool:
        with self._lock:
            ent = self._reqs.pop(grid, None)
        if ent is None:
            return False
        return self.server.cancel(ent["stream"].request_id,
                                  reason="gw_cancel")

    def drain(self):
        self.server.drain_begin()

    def export(self, grid: int) -> Optional[dict]:
        with self._lock:
            ent = self._reqs.get(grid)
        if ent is None:
            return None
        blob = export_sequence(self.server, ent["stream"].request_id)
        if blob is not None:
            # None: the sequence finished since the caller's last poll;
            # keep the record so that poll still delivers the tail and
            # the finish reason
            with self._lock:
                self._reqs.pop(grid, None)
        return blob

    def import_(self, grid: int, blob: dict, base=()):
        stream = import_sequence(self.server, blob)
        with self._lock:
            self._reqs[grid] = {"stream": stream, "base": list(base)}

    def ping(self) -> dict:
        return {"ok": True, "draining": self.server.draining}


class LocalReplica:
    """In-process replica: the replica interface over a
    ``GenerationServer`` in this process (tests, several replicas on one
    host or card).  ``kill()`` makes it look SIGKILLed from the router's
    side: every later call raises :class:`ReplicaLost` at once, and the
    server is stopped in the background without the router seeing its
    final state.  With ``owns_server=False`` the server outlives
    ``kill()``: the loss is a partition (the router sees a dead replica,
    the server runs on), which lets tests share one warm server across
    many simulated losses."""

    def __init__(self, name: str, server, owns_server: bool = True):
        self.name = name
        self.server = server
        self._owns_server = owns_server
        self._core = _ReplicaCore(server)
        self._dead = False

    def _check(self):
        if self._dead:
            raise ReplicaLost(f"replica {self.name} was killed")

    def submit(self, grid, prompt, kw, base=()):
        self._check()
        try:
            self._core.submit(grid, prompt, kw, base)
        except ServerClosed as e:
            raise ReplicaLost(f"replica {self.name}: {e}") from e

    def poll(self, reqs):
        self._check()
        return self._core.poll(reqs)

    def cancel(self, grid):
        self._check()
        return self._core.cancel(grid)

    def drain(self):
        self._check()
        self._core.drain()

    def export(self, grid):
        self._check()
        return self._core.export(grid)

    def import_(self, grid, blob, base=()):
        self._check()
        self._core.import_(grid, blob, base)

    def ping(self):
        self._check()
        try:
            return self._core.ping()
        except ServerClosed as e:
            raise ReplicaLost(f"replica {self.name}: {e}") from e

    def kill(self):
        self._dead = True
        if self._owns_server:
            threading.Thread(target=self.server.stop,
                             daemon=True).start()


# -- RPC front end (rides the PS framing layer) -------------------------

# how long a server thread waits for a connection or a request before it
# looks at whether the server still runs
_RPC_POLL_S = 0.25


class GenerationRpcServer:
    """Socket front end for one ``GenerationServer`` replica.  The
    protocol rides :mod:`~paddle_tpu_torch.distributed.fleet.ps_service`'s
    ``_send_msg`` / ``_recv_msg`` framing, so every gateway op
    (``gen_submit`` / ``gen_poll`` / ``gen_export`` / ...) is a chaos
    site: seeded cut / slow / drop plans match it by op name, and
    ``crash:gen_poll`` works as the PS server's crash site does
    (``plan.on_serve``).  Its threads wait at most ``_RPC_POLL_S`` at a
    time, so ``stop()`` ends them."""

    def __init__(self, server, host: str = "127.0.0.1", port: int = 0):
        self._core = _ReplicaCore(server)
        self._server = server
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, int(port)))
        self._sock.listen(64)
        self._sock.settimeout(_RPC_POLL_S)
        self.host, self.port = self._sock.getsockname()[:2]
        self._running = True
        self._accept = threading.Thread(target=self._accept_loop,
                                        name="gen-rpc-accept",
                                        daemon=True)
        self._accept.start()

    def _accept_loop(self):
        while self._running:
            try:
                conn, _ = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            conn.settimeout(None)
            threading.Thread(target=self._serve_conn, args=(conn,),
                             daemon=True).start()

    def _serve_conn(self, conn):
        plan = _chaos.active()
        try:
            while self._running:
                # wait for a frame's first byte a poll interval at a time
                # (a timeout inside a frame would break its framing)
                try:
                    ready, _, _ = select.select([conn], [], [], _RPC_POLL_S)
                except (OSError, ValueError):
                    break
                if not ready:
                    continue
                try:
                    msg = _recv_msg(conn)
                except (OSError, ConnectionError):
                    break
                if msg is None:
                    break
                op = msg.get("op", "?")
                if plan is not None:
                    plan.on_serve(msg)       # may crash the process
                    plan.set_context(op)     # replies match <op>_reply
                try:
                    rep = self._handle(op, msg)
                except (ServerDraining, ServerOverloaded,
                        RequestTimeout, MigrationUnsupported) as e:
                    # typed, retry-elsewhere errors travel by name so
                    # the client re-raises the SAME type at its side
                    rep = {"ok": False, "kind": type(e).__name__,
                           "error": str(e)}
                except Exception as e:   # noqa: BLE001 - to the wire
                    rep = {"ok": False, "kind": "ServeError",
                           "error": f"{type(e).__name__}: {e}"}
                try:
                    _send_msg(conn, rep)
                except (OSError, ConnectionError):
                    break
                finally:
                    if plan is not None:
                        plan.set_context(None)
        finally:
            if plan is not None:
                plan.set_context(None)
            try:
                conn.close()
            except OSError:
                pass

    def _handle(self, op: str, msg: dict) -> dict:
        if op == "gen_submit":
            self._core.submit(msg["grid"],
                              np.asarray(msg["prompt"], np.int32),
                              msg["kw"], msg.get("base") or [])
            return {"ok": True}
        if op == "gen_poll":
            return {"ok": True, "results": self._core.poll(msg["reqs"])}
        if op == "gen_cancel":
            return {"ok": True,
                    "cancelled": self._core.cancel(msg["grid"])}
        if op == "gen_drain":
            self._core.drain()
            return {"ok": True}
        if op == "gen_export":
            return {"ok": True, "blob": self._core.export(msg["grid"])}
        if op == "gen_import":
            self._core.import_(msg["grid"], msg["blob"],
                               msg.get("base") or [])
            return {"ok": True}
        if op == "gen_ping":
            return self._core.ping()
        if op == "gen_stop":
            # reply first, then stop: the caller's shutdown must not read
            # an EOF it would take for a crash
            threading.Thread(target=self._stop_all,
                             daemon=True).start()
            return {"ok": True}
        return {"ok": False, "kind": "ServeError",
                "error": f"unknown gateway op {op!r}"}

    def _stop_all(self):
        time.sleep(0.05)
        self.stop()
        self._server.stop()

    def stop(self):
        self._running = False
        try:
            self._sock.close()
        except OSError:
            pass


class RemoteReplica:
    """Socket client for a :class:`GenerationRpcServer` replica: one
    persistent connection and no retries inside.  A failure closes the
    socket, arms a bounded exponential backoff and raises
    :class:`ReplicaLost`; the router's ring fall-through is the retry,
    so a request pinned to a dead replica moves on without a failed call
    reaching the client.  Every call is bounded by ``connect_timeout``
    and ``rpc_timeout``.  The router never calls a replica while it holds
    its own lock."""

    def __init__(self, name: str, host: str, port: int,
                 connect_timeout: float = 2.0,
                 rpc_timeout: float = 60.0):
        self.name = name
        self._ep = (host, int(port))
        self._lock = threading.Lock()
        self._sock: Optional[socket.socket] = None
        self._fails = 0
        self._down_until = 0.0
        self._connect_timeout = float(connect_timeout)
        self._rpc_timeout = float(rpc_timeout)

    def _call(self, op: str, payload: dict) -> dict:
        plan = _chaos.active()
        with self._lock:
            if time.monotonic() < self._down_until:
                raise ReplicaLost(
                    f"replica {self.name} in backoff "
                    f"({self._fails} consecutive failures)")
            sock = self._sock
            try:
                if sock is None:
                    if plan is not None:
                        plan.check_connect(self._ep)
                    sock = socket.create_connection(
                        self._ep, timeout=self._connect_timeout)
                    self._sock = sock
                sock.settimeout(self._rpc_timeout)
                msg = dict(payload)
                msg["op"] = op
                _send_msg(sock, msg)
                rep = _recv_msg(sock)
                if rep is None:
                    raise ConnectionError(
                        "replica closed the connection")
            except (OSError, ConnectionError, socket.timeout) as e:
                self._sock = None
                if sock is not None:
                    try:
                        sock.close()
                    except OSError:
                        pass
                self._fails += 1
                self._down_until = time.monotonic() + min(
                    0.25 * (2 ** min(self._fails - 1, 5)), 5.0)
                raise ReplicaLost(
                    f"replica {self.name}: {e}") from e
            self._fails = 0
        if isinstance(rep, dict) and rep.get("ok") is False:
            kind = rep.get("kind", "ServeError")
            err = rep.get("error", "")
            cls = {"ServerDraining": ServerDraining,
                   "ServerOverloaded": ServerOverloaded,
                   "RequestTimeout": RequestTimeout,
                   "MigrationUnsupported": MigrationUnsupported,
                   }.get(kind, ServeError)
            raise cls(f"replica {self.name}: {err}")
        return rep

    def submit(self, grid, prompt, kw, base=()):
        self._call("gen_submit", {
            "grid": int(grid),
            "prompt": np.asarray(prompt, np.int32),
            "kw": kw, "base": list(base)})

    def poll(self, reqs):
        return self._call("gen_poll",
                          {"reqs": [[int(g), int(c)]
                                    for g, c in reqs]})["results"]

    def cancel(self, grid):
        return self._call("gen_cancel",
                          {"grid": int(grid)}).get("cancelled", False)

    def drain(self):
        self._call("gen_drain", {})

    def export(self, grid):
        return self._call("gen_export", {"grid": int(grid)}).get("blob")

    def import_(self, grid, blob, base=()):
        self._call("gen_import", {"grid": int(grid), "blob": blob,
                                  "base": list(base)})

    def ping(self):
        return self._call("gen_ping", {})

    def stop_remote(self):
        self._call("gen_stop", {})


# -- the router ---------------------------------------------------------

class _GwReq:
    """Router-side request record (one per client stream)."""

    __slots__ = ("grid", "prompt", "kw", "stream", "emitted", "replica",
                 "pos", "deadline", "t_submit", "failovers", "done",
                 "tenant", "cost", "migrating", "placed")

    def __init__(self, grid, prompt, kw, pos, deadline, tenant, cost):
        self.grid = grid
        self.prompt = prompt              # np.int32 [L]
        self.kw = kw                      # submit kwargs sans timeout_s
        self.stream = GenerationStream(grid)
        self.emitted: List[int] = []      # delivered to the client
        self.replica: Optional[str] = None
        self.pos = pos                    # ring position (routing key)
        self.deadline = deadline          # monotonic; NEVER re-anchored
        self.t_submit = time.monotonic()
        self.failovers = 0
        self.done = False
        self.tenant = tenant
        self.cost = cost                  # prompt + max_new (budget)
        self.migrating = False            # drain owns it, pump skips
        self.placed = False               # ever placed on a replica;
        # until then submit() owns placement and the pump's orphan
        # sweep must NOT race it (a double place = a leaked sequence)


class GatewayRouter:
    """Prefix-affinity gateway over N ``GenerationServer`` replicas
    (:class:`LocalReplica` and :class:`RemoteReplica` mix freely).  See
    the module docstring for the recovery contracts.

    Usage::

        router = GatewayRouter([LocalReplica("a", sa),
                                RemoteReplica("b", host, port)],
                               block_size=16, seed=0)
        router.start()
        stream = router.submit(prompt_ids, max_new_tokens=64, seed=7)
        toks = stream.result()       # survives replica SIGKILL
        router.drain("a")            # graceful scale-down
        router.stop()

    ``tenant_budgets`` maps tenant -> max in-flight tokens
    (prompt + max_new summed over that tenant's live requests); past
    it, a submit sheds typed with ``gw_sheds{reason="tenant_budget"}``.
    ``max_pending`` bounds the requests in flight; at the cap the request
    with the most remaining deadline is the one shed (the tightest
    deadlines keep their slots)."""

    def __init__(self, replicas: Sequence, *, block_size: int = 16,
                 seed: int = 0, request_timeout_s: float = 300.0,
                 tenant_budgets: Optional[Dict[str, int]] = None,
                 max_pending: int = 256,
                 poll_interval_s: float = 0.002):
        reps = list(replicas)
        self._replicas = {r.name: r for r in reps}
        if len(self._replicas) != len(reps):
            raise ValueError("replica names must be unique")
        if not self._replicas:
            raise ValueError("need at least one replica")
        self._bs = int(block_size)
        self._seed = int(seed)
        self._timeout_s = float(request_timeout_s)
        self._budgets = dict(tenant_budgets or {})
        self._max_pending = int(max_pending)
        self._poll_s = float(poll_interval_s)
        self._lock = threading.Lock()
        # one client delivery at a time (``_deliver``); never held across
        # an RPC
        self._deliver_lock = threading.Lock()
        self._names: List[str] = sorted(self._replicas)
        self._ring = _build_ring(self._names)
        self._reqs: Dict[int, _GwReq] = {}
        self._grid = 0
        self._tenant_used: Dict[str, int] = {}
        self._down: Dict[str, float] = {}
        self._down_fails: Dict[str, int] = {}
        self._draining: set = set()
        self._stats = {"submitted": 0, "finished": 0, "failovers": 0,
                       "migrated": 0, "deadline_sheds": 0,
                       "sheds": {}, "routed": {}}
        self._running = False
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle ----------------------------------------------------
    def start(self) -> "GatewayRouter":
        if self._running:
            return self
        self._running = True
        self._thread = threading.Thread(target=self._pump,
                                        name="gateway-router",
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self):
        if not self._running:
            return
        self._running = False
        if self._thread is not None:
            self._thread.join(timeout=30.0)
            self._thread = None
        with self._lock:
            victims = [r for r in self._reqs.values() if not r.done]
            self._reqs.clear()
        for r in victims:
            r.done = True
            r.stream._fail(ServerClosed("gateway stopped"))

    def __enter__(self) -> "GatewayRouter":
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    # -- routing ------------------------------------------------------
    def _route_pos(self, prompt: np.ndarray) -> int:
        """Ring position for a prompt: the chain hash of its FIRST
        full block (stable as the conversation grows - turn N+1 keeps
        turn N's affinity), blake2b over the raw tokens when the
        prompt is shorter than one block."""
        hs = chain_hashes(prompt.tolist(), self._bs)
        if hs:
            h = int(hs[0][:16], 16)
        else:
            h = int.from_bytes(
                hashlib.blake2b(prompt.tobytes(),
                                digest_size=8).digest(), "big")
        pts, _ = self._ring
        if len(pts) == 0:
            return 0
        return int(np.searchsorted(pts, np.uint64(h), side="left")
                   % len(pts))

    def _candidates(self, pos: int, exclude=()) -> List[str]:
        """Replica names clockwise from ``pos``, deduplicated, with
        draining / backed-off / excluded members skipped - the
        fall-through order that IS the retry policy."""
        pts, owners = self._ring
        now = time.monotonic()
        order: List[str] = []
        for k in range(len(pts)):
            name = self._names[int(owners[(pos + k) % len(pts)])]
            if name not in order:
                order.append(name)
        return [nm for nm in order
                if nm not in exclude and nm not in self._draining
                and self._down.get(nm, 0.0) <= now]

    def route_owner(self, prompt) -> Optional[str]:
        """The replica a fresh submit of ``prompt`` would try first
        (affinity introspection for tests/tools)."""
        p = np.asarray(prompt, np.int32).reshape(-1)
        with self._lock:
            cands = self._candidates(self._route_pos(p))
        return cands[0] if cands else None

    def _mark_down(self, name: str):
        with self._lock:
            self._down_fails[name] = self._down_fails.get(name, 0) + 1
            self._down[name] = time.monotonic() + min(
                0.25 * (2 ** min(self._down_fails[name] - 1, 5)), 5.0)

    # -- admission ----------------------------------------------------
    def submit(self, prompt, max_new_tokens: int = 32,
               do_sample: bool = False, temperature: float = 1.0,
               top_k: int = 0, top_p: float = 1.0,
               eos_token_id: Optional[int] = None,
               seed: Optional[int] = None, priority: int = 0,
               timeout_s: Optional[float] = None,
               tenant: Optional[str] = None) -> GenerationStream:
        """Route one generation request; returns a stream that
        survives replica loss.  The RNG seed is pinned HERE (the
        user's, or derived from the gateway seed + request id): every
        replica incarnation of this request samples the same stream,
        which is what makes failover token-identical.  Raises
        :class:`ServerDraining` (every replica draining),
        :class:`ServerOverloaded` (tenant budget / pressure shed /
        no replica accepting)."""
        if not self._running:
            raise ServerClosed("gateway not started")
        p = np.asarray(prompt.cpu().numpy() if hasattr(prompt, "cpu")
                       else prompt).astype(np.int32).reshape(-1)
        if p.size < 1:
            raise ValueError("empty prompt")
        to = self._timeout_s if timeout_s is None else float(timeout_s)
        cost = int(p.size) + int(max_new_tokens)
        shed_victim: Optional[_GwReq] = None
        with self._lock:
            deadline = time.monotonic() + to
            if tenant is not None and tenant in self._budgets:
                used = self._tenant_used.get(tenant, 0)
                if used + cost > self._budgets[tenant]:
                    shed = "tenant_budget"
                    self._note_shed_locked(shed)
                    raise_after = (ServerOverloaded(
                        f"tenant {tenant!r} budget "
                        f"{self._budgets[tenant]} tokens: {used} in "
                        f"flight + {cost} requested - shed"), shed)
                    # fallthrough to raise outside the lock
                    pending = None
                else:
                    raise_after = None
                    pending = [r for r in self._reqs.values()
                               if not r.done]
            else:
                raise_after = None
                pending = [r for r in self._reqs.values()
                           if not r.done]
            if raise_after is None and len(pending) >= self._max_pending:
                # deadline-ordered shedding: the request with the most
                # slack loses its slot (tightest deadlines ride out
                # the pressure)
                slackest = max(pending, key=lambda r: r.deadline)
                if slackest.deadline > deadline:
                    shed_victim = slackest
                    slackest.done = True
                    self._note_shed_locked("pressure")
                else:
                    self._note_shed_locked("pressure")
                    raise_after = (ServerOverloaded(
                        f"gateway at max_pending={self._max_pending} "
                        "and every in-flight request has a tighter "
                        "deadline - shed"), "pressure")
            if raise_after is None:
                self._grid += 1
                grid = self._grid
                rseed = (int(seed) if seed is not None
                         else self._seed * 1000003 + grid)
                kw = dict(max_new_tokens=int(max_new_tokens),
                          do_sample=bool(do_sample),
                          temperature=float(temperature),
                          top_k=int(top_k), top_p=float(top_p),
                          eos_token_id=eos_token_id, seed=rseed,
                          priority=int(priority), tenant=tenant)
                req = _GwReq(grid, p, kw, self._route_pos(p), deadline,
                             tenant, cost)
                self._reqs[grid] = req
                self._stats["submitted"] += 1
                if tenant is not None:
                    self._tenant_used[tenant] = \
                        self._tenant_used.get(tenant, 0) + cost
        if shed_victim is not None:
            self._finalize_shed(shed_victim, "pressure")
        if raise_after is not None:
            exc, reason = raise_after
            _monitor.stat_add("gw_sheds", labels={"reason": reason})
            raise exc from None
        name = self._try_place(req, exclude=set())
        if name is None:
            with self._lock:
                req.done = True
                self._reqs.pop(grid, None)
                if tenant is not None:
                    self._tenant_used[tenant] -= cost
                all_draining = bool(self._replicas) and all(
                    nm in self._draining for nm in self._replicas)
                self._note_shed_locked("no_replica")
            _monitor.stat_add("gw_sheds", labels={"reason": "no_replica"})
            if all_draining:
                raise ServerDraining(
                    "every replica is draining - the fleet is "
                    "scaling down, retry against its successor")
            raise ServerOverloaded(
                "no replica accepted the request (all down, draining "
                "or overloaded) - back off and retry")
        return req.stream

    def _note_shed_locked(self, reason: str):
        self._stats["sheds"][reason] = \
            self._stats["sheds"].get(reason, 0) + 1

    def _finalize_shed(self, req: _GwReq, reason: str):
        """Fail a shed victim's stream outside the router lock."""
        _monitor.stat_add("gw_sheds", labels={"reason": reason})
        if req.replica is not None:
            rep = self._replicas.get(req.replica)
            if rep is not None:
                try:
                    rep.cancel(req.grid)
                except (ReplicaLost, ServeError):
                    pass
        with self._lock:
            self._reqs.pop(req.grid, None)
            if req.tenant is not None:
                self._tenant_used[req.tenant] = \
                    self._tenant_used.get(req.tenant, 0) - req.cost
        req.stream._fail(ServerOverloaded(
            f"request {req.grid} shed under pressure "
            f"({reason}: a tighter-deadline request took its slot)"))

    # -- placement ----------------------------------------------------
    def _try_place(self, req: _GwReq, exclude) -> Optional[str]:
        """Ring-order placement (the fall-through IS the retry).  The
        REMAINING deadline travels with every attempt, so a re-routed
        request keeps its original budget."""
        if self._finish_if_complete(req):
            return req.replica
        with self._lock:
            cands = self._candidates(req.pos, exclude)
        for name in cands:
            remaining = req.deadline - time.monotonic()
            if remaining <= 0:
                return None         # pump's deadline check sheds it
            kw = dict(req.kw)
            kw["timeout_s"] = remaining
            rep = self._replicas[name]
            try:
                rep.submit(req.grid, req.prompt, kw,
                           base=req.emitted)
            except (ServerDraining, ServerOverloaded):
                continue
            except ReplicaLost:
                self._mark_down(name)
                continue
            with self._lock:
                req.replica = name
                req.placed = True
                self._stats["routed"][name] = \
                    self._stats["routed"].get(name, 0) + 1
            _flight.record("gw.route", grid=req.grid, replica=name,
                           failovers=req.failovers,
                           emitted=len(req.emitted))
            _flight.progress("gw.route")
            return name
        return None

    def _finish_if_complete(self, req: _GwReq) -> bool:
        """A request whose delivered tokens already satisfy its stop
        condition (the dead replica finished it but the 'done' poll
        was lost) must NOT be re-placed: ``replay_tokens`` of a
        complete stream is a contract violation on the replica."""
        eos = req.kw.get("eos_token_id")
        if len(req.emitted) >= req.kw["max_new_tokens"]:
            self._finish(req, "length")
            return True
        if eos is not None and req.emitted \
                and req.emitted[-1] == eos:
            self._finish(req, "eos")
            return True
        return False

    # -- the pump: poll / deliver / failover --------------------------
    def _pump(self):
        try:
            while self._running:
                self._pump_once()
                time.sleep(self._poll_s)
        except BaseException as e:   # noqa: BLE001 - fail streams loudly
            with self._lock:
                victims = [r for r in self._reqs.values()
                           if not r.done]
                self._reqs.clear()
                self._running = False
            for r in victims:
                r.done = True
                r.stream._fail(ServeError(
                    f"gateway pump died: {e!r}"))
            raise

    def _pump_once(self):
        with self._lock:
            by_rep: Dict[str, List[_GwReq]] = {}
            orphans: List[_GwReq] = []
            for r in self._reqs.values():
                if r.done or r.migrating:
                    continue
                if r.replica is None:
                    if r.placed:    # never-placed = submit() owns it
                        orphans.append(r)
                else:
                    by_rep.setdefault(r.replica, []).append(r)
        now = time.monotonic()
        for name, reqs in by_rep.items():
            rep = self._replicas.get(name)
            expired = [r for r in reqs if now > r.deadline]
            live = [r for r in reqs if now <= r.deadline]
            for r in expired:
                try:
                    rep.cancel(r.grid)
                except (ReplicaLost, ServeError):
                    pass
                self._fail_deadline(r)
            if not live:
                continue
            cursors = {r.grid: len(r.emitted) for r in live}
            try:
                results = rep.poll(list(cursors.items()))
            except ReplicaLost:
                self._mark_down(name)
                for r in live:
                    if not r.migrating:
                        self._failover(r, name)
                continue
            by_grid = {res["grid"]: res for res in results}
            for r in live:
                res = by_grid.get(r.grid)
                if res is None or r.migrating or r.replica != name:
                    continue        # a drain took it over meanwhile
                if res["err"] in ("lost", "unknown"):
                    # the replica process survives but this stream
                    # died (scheduler error / server stopped / record
                    # gone after a restart): recover it elsewhere
                    self._failover(r, name)
                    continue
                self._deliver(r, cursors[r.grid], res["toks"])
                if res["err"] == "timeout":
                    self._fail_deadline(r)
                elif res["done"]:
                    self._finish(r, res["reason"] or "length")
        for r in orphans:
            if now > r.deadline:
                self._fail_deadline(r)
            elif not self._finish_if_complete(r):
                # a failover that found no home yet (double failure /
                # all replicas briefly down): keep trying ring-order
                # each round until the deadline says stop
                self._try_place(r, exclude=set())

    def _deliver(self, req: _GwReq, cursor: int, toks):
        """Deliver the tokens a replica returned from stream index
        ``cursor`` on, only those past what the client already has: the
        pump and a drain can poll one request at once (each with the
        cursor it read), and a token must reach the client once, in
        order.  Sets the client's time to first token."""
        with self._deliver_lock:
            start = len(req.emitted) - cursor
            if start < len(toks) and req.stream.ttft_s is None:
                req.stream.ttft_s = time.monotonic() - req.t_submit
            for t in toks[max(start, 0):]:
                req.emitted.append(int(t))
                req.stream._emit(int(t))

    def _failover(self, req: _GwReq, dead_name: Optional[str]):
        req.failovers += 1
        req.replica = None
        with self._lock:
            self._stats["failovers"] += 1
        _monitor.stat_add("gw_failovers")
        _flight.record("gw.failover", grid=req.grid,
                       replica=dead_name, n=req.failovers,
                       emitted=len(req.emitted),
                       remaining_s=round(
                           req.deadline - time.monotonic(), 3))
        if time.monotonic() > req.deadline:
            self._fail_deadline(req)
            return
        t0 = time.perf_counter()
        name = self._try_place(
            req, exclude={dead_name} if dead_name else set())
        if name is not None and _monitor.metrics_enabled():
            _monitor.hist_observe("gw_failover_ms",
                                  (time.perf_counter() - t0) * 1e3)
        # no home right now: the pump's orphan sweep keeps retrying

    def _fail_deadline(self, req: _GwReq):
        if req.done:
            return
        req.done = True
        _monitor.stat_add("gw_sheds", labels={"reason": "deadline"})
        with self._lock:
            self._stats["deadline_sheds"] += 1
            self._note_shed_locked("deadline")
            self._reqs.pop(req.grid, None)
            if req.tenant is not None:
                self._tenant_used[req.tenant] = \
                    self._tenant_used.get(req.tenant, 0) - req.cost
        req.stream._fail(RequestTimeout(
            f"request {req.grid} spent its whole deadline "
            f"({req.failovers} failovers, {len(req.emitted)} tokens "
            "delivered) - the deadline is anchored at submit and "
            "survives re-routing"))

    def _finish(self, req: _GwReq, reason: str):
        if req.done:
            return
        req.done = True
        with self._lock:
            self._stats["finished"] += 1
            self._reqs.pop(req.grid, None)
            if req.tenant is not None:
                self._tenant_used[req.tenant] = \
                    self._tenant_used.get(req.tenant, 0) - req.cost
        req.stream._end(reason)

    # -- graceful drain (KV migration) --------------------------------
    def drain(self, name: str) -> int:
        """Gracefully remove replica ``name``: stop its admission,
        migrate every live conversation to ring-order survivors (KV
        blob when the target has capacity, token replay otherwise),
        and drop it from the ring.  Returns how many sequences moved.
        The drained replica's server keeps running (caller stops it)
        - it is simply no longer addressable."""
        if name not in self._replicas:
            raise KeyError(f"unknown replica {name!r}")
        rep = self._replicas[name]
        with self._lock:
            self._draining.add(name)
            survivors = [n for n in sorted(self._replicas)
                         if n not in self._draining]
            self._names = survivors or sorted(self._replicas)
            self._ring = _build_ring(self._names)
            mine = [r for r in self._reqs.values()
                    if r.replica == name and not r.done]
            for r in mine:
                r.migrating = True    # pump hands them off to us
        _flight.record("gw.drain", replica=name, live=len(mine))
        try:
            rep.drain()
        except ReplicaLost:
            # died as we drained it: plain failover recovers the reqs
            self._mark_down(name)
            for r in mine:
                r.migrating = False
                self._failover(r, name)
            return 0
        moved = 0
        for r in mine:
            moved += int(self._migrate_one(r, rep, name))
            r.migrating = False
        return moved

    def _migrate_one(self, req: _GwReq, rep, src: str) -> bool:
        # catch up first: every token the source emitted must reach
        # the client (and the cursor) before the sequence moves
        try:
            cursor = len(req.emitted)
            res = rep.poll([(req.grid, cursor)])[0]
            if res["err"] in ("lost", "unknown"):
                self._failover(req, src)
                return False
            self._deliver(req, cursor, res["toks"])
            if res["err"] == "timeout":
                self._fail_deadline(req)
                return False
            if res["done"]:
                self._finish(req, res["reason"] or "length")
                return False
        except ReplicaLost:
            self._failover(req, src)
            return False
        if time.monotonic() > req.deadline:
            try:
                rep.cancel(req.grid)
            except (ReplicaLost, ServeError):
                pass
            self._fail_deadline(req)
            return False
        blob = None
        try:
            blob = rep.export(req.grid)
        except (ReplicaLost, ServeError):
            blob = None
        if blob is None:
            # the sequence finished (or vanished) between the catch-up
            # poll and the export - one more poll collects the tail
            try:
                cursor = len(req.emitted)
                res = rep.poll([(req.grid, cursor)])[0]
            except ReplicaLost:
                self._failover(req, src)
                return False
            if res["err"] in ("lost", "unknown", "timeout"):
                self._failover(req, src)
                return False
            self._deliver(req, cursor, res["toks"])
            if res["done"]:
                self._finish(req, res["reason"] or "length")
            else:
                self._failover(req, src)
            return False
        # the export is the authoritative cut: every token the source
        # generated past the catch-up poll is in the blob but NOT in
        # the cursor - deliver those now, or the import target would
        # treat them as already-streamed and they'd be lost
        self._deliver(req, 0, blob["generated"])
        if self._finish_if_complete(req):
            return False
        path = None
        if blob is not None and blob.get("kv") is not None:
            # the gateway owns deadline truth: whatever the source
            # measured, the target gets the ROUTER's remaining budget
            blob["deadline_remaining"] = max(
                req.deadline - time.monotonic(), 0.0)
            with self._lock:
                cands = self._candidates(req.pos, exclude={src})
            for nm in cands:
                try:
                    self._replicas[nm].import_(req.grid, blob,
                                               base=req.emitted)
                    with self._lock:
                        req.replica = nm
                    path = "kv"
                    break
                except (MigrationUnsupported, ServerOverloaded,
                        ServerDraining):
                    continue
                except ReplicaLost:
                    self._mark_down(nm)
                    continue
        if path is None:
            # cheap fallback: tokens only, re-prefill + replay on the
            # target (export already detached it from the source)
            req.replica = None
            if self._finish_if_complete(req):
                return False
            path = "replay" if self._try_place(
                req, exclude={src}) is not None else None
        if path is None:
            return False    # orphan: the pump keeps retrying it
        with self._lock:
            self._stats["migrated"] += 1
        _monitor.stat_add("gw_migrated_seqs")
        _flight.record("gw.migrate", grid=req.grid, src=src,
                       dst=req.replica, path=path,
                       tokens=len(req.emitted))
        return True

    # -- introspection ------------------------------------------------
    def stats(self) -> Dict:
        with self._lock:
            s = {k: (dict(v) if isinstance(v, dict) else v)
                 for k, v in self._stats.items()}
            s["pending"] = sum(1 for r in self._reqs.values()
                               if not r.done)
            s["replicas"] = sorted(self._replicas)
            s["ring"] = list(self._names)
            s["draining"] = sorted(self._draining)
            now = time.monotonic()
            s["down"] = sorted(n for n, t in self._down.items()
                               if t > now)
            s["tenant_inflight_tokens"] = dict(self._tenant_used)
        return s
