"""Deterministic fault injection (counterpart of
``paddle_tpu/distributed/fleet/chaos.py``): the PS wire sites and the
elastic site.

A seedable :class:`FaultPlan` wraps the ``_send_msg`` / ``_recv_msg``
framing layer of :mod:`.ps_service` and injects faults at exact,
reproducible points of the RPC stream.

Fault kinds (``Fault.kind``):

  delay   sleep ``arg`` seconds (seeded jitter when arg == 0) before the
          frame goes out: a slow network or a GC pause.
  dup     deliver the frame twice.  Only one-way frames (async push /
          push_delta, heartbeat) are duplicated; duplicating a frame
          that expects a reply would desynchronise the request/reply
          stream in a way no real network can, so those are sent once
          and counted as ``dup_skipped``.
  cut     send the first half of the frame, then sever the connection.
  drop    sever the connection instead of sending; aimed at ``*_reply``
          ops this is the "server applied the write but the ack was
          lost" window that makes a naive retry apply twice.
  refuse  fail a client connect attempt with ConnectionRefusedError.
  crash   ``os._exit(137)`` when the server receives the matching
          request: SIGKILL-grade loss of a subprocess server.
  kill    the elastic site: SIGKILL the current worker process at the
          matching training step (``op`` is ``worker``; the match
          counter advances once per executed step of this process, so
          ``kill:worker:every=K`` kills each incarnation after K steps).
          Fired by :func:`maybe_kill_worker` from the elastic step loop.

The reference's other sites wait for the slices that run them: ``kill``
on a serving replica (the gateway, ROADMAP queue item 2) and the
numeric ``nan`` / ``inf`` streams (queue item 4).  A plan naming one
raises ``NotImplementedError``.

Matching: every fault names an ``op`` (the request header's ``op``;
reply frames match ``<op>_reply``, or ``reply`` as a catch-all; ``*``
matches everything) and fires on a deterministic schedule over its
match counter: the ``first``-th match, then every ``every``-th after
that, at most ``times`` firings (0 = unlimited).

Activation: ``install(plan)`` / ``uninstall()`` in tests, or the
``PADDLE_CHAOS`` environment variable for subprocesses, e.g.::

    PADDLE_CHAOS="seed=3;dup:push:every=2;crash:push:first=50"
    PADDLE_CHAOS="plan=flaky;seed=7"
    PADDLE_CHAOS="plan=kill_worker@every=5"

``plan.stats`` counts every fired fault by ``kind:op``.
"""
from __future__ import annotations

import collections
import os
import random
import signal
import threading
import time
from typing import List, Optional

from ...observability import flight_recorder as _flight

__all__ = ["Fault", "FaultPlan", "install", "uninstall", "active",
           "named_plan", "plan_from_spec", "maybe_kill_worker"]

# frames the protocol never answers: safe to duplicate on the wire
_ONE_WAY_OPS = {"heartbeat"}

_LATER = {"gateway": "the gateway's replica kill (ROADMAP queue item 2)",
          "numeric": "the numeric nan/inf streams (ROADMAP queue item 4)"}


def _one_way(obj) -> bool:
    if not isinstance(obj, dict):
        return False
    op = obj.get("op")
    if op in _ONE_WAY_OPS:
        return True
    # async-mode push/push_delta frames carry sync=False and get no ack
    return op in ("push", "push_delta") and not obj.get("sync")


class Fault:
    """One deterministic fault rule (see module docstring)."""

    KINDS = ("delay", "dup", "cut", "drop", "refuse", "crash", "kill",
             "nan", "inf")

    def __init__(self, kind: str, op: str = "*", first: int = 1,
                 every: int = 0, times: int = 1, arg: float = 0.0):
        if kind not in self.KINDS:
            raise ValueError(f"unknown fault kind {kind!r}; "
                             f"one of {self.KINDS}")
        self.kind = kind
        self.op = op
        site = self._site()
        if site in _LATER:
            raise NotImplementedError(
                f"chaos fault {kind}:{op} is not ported yet: "
                f"{_LATER[site]}")
        self.first = max(1, int(first))
        self.every = int(every)
        self.times = int(times)
        self.arg = float(arg)
        self.matches = 0   # candidate events seen
        self.fired = 0     # faults actually injected

    def _site(self) -> str:
        if self.kind == "refuse":
            return "connect"
        if self.kind == "crash":
            return "serve"
        if self.kind == "kill":
            return "elastic" if self.op in ("*", "worker") else "gateway"
        if self.kind in ("nan", "inf"):
            return "numeric"
        return "send"

    def _should_fire(self) -> bool:
        """Called with the plan lock held, after ``matches`` was
        incremented for the current candidate event."""
        n = self.matches
        if n < self.first:
            return False
        if self.every <= 0:
            hit = n == self.first
        else:
            hit = (n - self.first) % self.every == 0
        if not hit:
            return False
        if self.times and self.fired >= self.times:
            return False
        self.fired += 1
        return True

    def __repr__(self):
        return (f"Fault({self.kind}:{self.op} first={self.first} "
                f"every={self.every} times={self.times} arg={self.arg})")


class FaultPlan:
    """A seeded, ordered list of :class:`Fault` rules plus firing stats.
    At most one fault fires per event (list order wins), so a plan reads
    as a deterministic schedule."""

    def __init__(self, faults: List[Fault], seed: int = 0,
                 name: str = ""):
        self.faults = list(faults)
        self.seed = int(seed)
        self.name = name
        self._rng = random.Random(self.seed)
        self._lock = threading.Lock()
        self._tl = threading.local()
        self.stats: "collections.Counter" = collections.Counter()

    # -- context: reply frames (which carry no op) match the op of the
    #    request being answered --------------------------------------
    def set_context(self, op: Optional[str]):
        self._tl.op = op

    def _op_of(self, obj) -> str:
        if isinstance(obj, dict) and "op" in obj:
            return str(obj["op"])
        ctx = getattr(self._tl, "op", None)
        return f"{ctx}_reply" if ctx else "reply"

    def _match(self, site: str, op: str) -> Optional[Fault]:
        with self._lock:
            fired = None
            for f in self.faults:
                if f._site() != site:
                    continue
                if f.op != "*" and f.op != op and not (
                        site == "send" and f.op == "reply"
                        and op.endswith("_reply")):
                    continue
                f.matches += 1
                if f._should_fire():
                    fired = f
                    break
        if fired is not None:
            # the flight ring keeps every injected fault, so a postmortem
            # bundle shows the chaos that caused the failure
            _flight.record("chaos", fault=fired.kind, op=op, site=site,
                           n=fired.fired, plan=self.name)
        return fired

    # -- injection sites (called from ps_service) ----------------------
    def send(self, sock, obj, raw_send):
        """Wrap one outgoing frame.  ``raw_send(sock, obj)`` is the real
        framing function; a fault may call it 0, 1 or 2 times."""
        op = self._op_of(obj)
        f = self._match("send", op)
        if f is None:
            return raw_send(sock, obj)
        if f.kind == "delay":
            with self._lock:
                d = f.arg if f.arg > 0 else 0.001 + self._rng.random() * 0.01
            self.stats[f"delay:{op}"] += 1
            time.sleep(d)
            return raw_send(sock, obj)
        if f.kind == "dup":
            if _one_way(obj):
                self.stats[f"dup:{op}"] += 1
                raw_send(sock, obj)
                return raw_send(sock, obj)
            self.stats["dup_skipped"] += 1
            return raw_send(sock, obj)
        if f.kind == "cut":
            from .ps_service import _frame_bytes
            self.stats[f"cut:{op}"] += 1
            data = _frame_bytes(obj)
            try:
                sock.sendall(data[:max(1, len(data) // 2)])
            finally:
                try:
                    sock.close()
                except OSError:
                    pass
            raise ConnectionError(f"chaos: mid-frame cut ({op})")
        # drop
        self.stats[f"drop:{op}"] += 1
        try:
            sock.close()
        except OSError:
            pass
        raise ConnectionError(f"chaos: frame dropped ({op})")

    def check_connect(self, endpoint):
        f = self._match("connect", "connect")
        if f is not None:
            self.stats["refuse:connect"] += 1
            raise ConnectionRefusedError(
                f"chaos: connection refused to {endpoint[0]}:{endpoint[1]}")

    def match_elastic(self, op: str = "worker") -> Optional[Fault]:
        """Elastic-site hook (:func:`maybe_kill_worker`): consulted once
        per executed training step.  Returns the firing ``kill`` fault or
        None; the caller delivers the signal."""
        f = self._match("elastic", op)
        if f is not None and f.kind == "kill":
            return f
        return None

    def on_serve(self, msg):
        """Server-side hook, called once per received request."""
        op = msg.get("op", "?") if isinstance(msg, dict) else "?"
        f = self._match("serve", op)
        if f is not None and f.kind == "crash":
            os._exit(137)     # stats die with the process: that is the point

    def stats_dict(self) -> dict:
        with self._lock:
            return dict(self.stats)

    def __repr__(self):
        return (f"FaultPlan(name={self.name!r}, seed={self.seed}, "
                f"faults={self.faults})")


# -- named plans --------------------------------------------------------

def named_plan(name: str, seed: int = 0) -> FaultPlan:
    """Prebuilt schedules: ``flaky``, ``dup``, ``lost_ack``, ``crash@N``
    and ``kill_worker@every=K``."""
    if name == "flaky":
        # survivable background noise: slow frames, duplicated async
        # pushes, a lost push ack (the idempotent retry path), one
        # mid-frame cut
        faults = [
            Fault("delay", op="pull", first=3, every=7, times=0,
                  arg=0.002),
            Fault("dup", op="push", first=2, every=5, times=0),
            Fault("drop", op="push_reply", first=4, every=9, times=0),
            Fault("cut", op="pull", first=11, every=17, times=0),
        ]
    elif name == "dup":
        faults = [Fault("dup", op="push", first=1, every=1, times=0),
                  Fault("dup", op="push_delta", first=1, every=1,
                        times=0)]
    elif name == "lost_ack":
        faults = [Fault("drop", op="push_reply", first=1, every=3,
                        times=0)]
    elif name.startswith("crash@"):
        faults = [Fault("crash", op="push", first=int(name[6:]))]
    elif name.startswith("kill_worker@every="):
        # SIGKILL this worker at its K-th executed step, then every K
        # after that (each launcher restart re-arms the plan from the
        # env, so every incarnation dies after K steps; the run finishes
        # because checkpoints land more often than kills)
        k = int(name[len("kill_worker@every="):])
        faults = [Fault("kill", op="worker", first=k, every=k, times=0)]
    elif name.startswith(("gw_kill@", "gw_flaky")):
        raise NotImplementedError(
            f"chaos plan {name!r} is not ported yet: {_LATER['gateway']}")
    elif name.startswith(("nan_grad@", "inf_grad@", "nan_batch@",
                          "diverge@")):
        raise NotImplementedError(
            f"chaos plan {name!r} is not ported yet: {_LATER['numeric']}")
    else:
        raise ValueError(f"unknown chaos plan {name!r} (flaky, dup, "
                         f"lost_ack, crash@N, kill_worker@every=K)")
    return FaultPlan(faults, seed=seed, name=name)


def maybe_kill_worker(op: str = "worker"):
    """Elastic step-loop hook: SIGKILL the current process when the
    active plan schedules a ``kill`` fault for this step.  SIGKILL (not
    ``os._exit``) so the launcher's watchdog sees what a machine-level
    worker loss delivers."""
    plan = active()
    if plan is None:
        return
    if plan.match_elastic(op) is not None:
        os.kill(os.getpid(), signal.SIGKILL)


def plan_from_spec(spec: str) -> FaultPlan:
    """Parse a ``PADDLE_CHAOS`` spec: ``;``-separated tokens, each
    either ``seed=N``, ``plan=<name>``, or
    ``kind:op[:key=val[:key=val...]]`` with keys first/every/times/arg."""
    seed = 0
    name = None
    faults: List[Fault] = []
    for tok in (t.strip() for t in spec.split(";")):
        if not tok:
            continue
        if tok.startswith("seed="):
            seed = int(tok[5:])
        elif tok.startswith("plan="):
            name = tok[5:]
        else:
            parts = tok.split(":")
            if len(parts) < 2:
                raise ValueError(f"bad chaos token {tok!r} "
                                 f"(want kind:op[:k=v...])")
            kw = {}
            for p in parts[2:]:
                k, _, v = p.partition("=")
                if k == "step":     # numeric-site spelling of first=
                    k = "first"
                if k not in ("first", "every", "times", "arg"):
                    raise ValueError(f"bad chaos fault key {k!r} in "
                                     f"{tok!r}")
                kw[k] = float(v) if k == "arg" else int(v)
            faults.append(Fault(parts[0], op=parts[1], **kw))
    if name is not None:
        plan = named_plan(name, seed=seed)
        plan.faults.extend(faults)
        return plan
    return FaultPlan(faults, seed=seed, name="env")


# -- global activation --------------------------------------------------
_plan: Optional[FaultPlan] = None


def install(plan: FaultPlan):
    global _plan
    _plan = plan
    return plan


def uninstall():
    global _plan
    _plan = None


def active() -> Optional[FaultPlan]:
    return _plan


_env_spec = os.environ.get("PADDLE_CHAOS")
if _env_spec:
    install(plan_from_spec(_env_spec))
