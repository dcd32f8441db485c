"""Deterministic fault injection (counterpart of
``paddle_tpu/distributed/fleet/chaos.py``, the elastic site).

A seedable :class:`FaultPlan` injects faults at exact, reproducible
points.  The elastic data plane reads one kind:

  kill    SIGKILL the current worker process at the matching training
          step -- the elastic membership controller's acceptance-test
          fault.  ``op`` is ``worker``; the match counter advances once
          per EXECUTED training step in this process (replayed steps
          after a rewind count), so ``kill:worker:every=K`` kills each
          incarnation after K steps and the run finishes iff
          checkpoints land more often than kills.  Fired via
          :func:`maybe_kill_worker` from the elastic step loop.

The reference's other kinds (delay, dup, cut, drop, refuse and crash on
the PS wire, the gateway's replica kill, the numeric nan/inf streams)
wait for the slices that run those sites (ROADMAP queue items 2 and 6);
a plan naming one raises ``NotImplementedError``.

Matching: every fault names an ``op`` (``*`` matches everything) and
fires on a deterministic schedule over its match counter: the
``first``-th match, then every ``every``-th after that, at most
``times`` firings (0 = unlimited).

Activation: ``install(plan)`` / ``uninstall()`` in tests, or the
``PADDLE_CHAOS`` environment variable for worker subprocesses, e.g.::

    PADDLE_CHAOS="plan=kill_worker@every=5"
    PADDLE_CHAOS="kill:worker:first=2:every=4"
"""
from __future__ import annotations

import os
import signal
import threading
from typing import List, Optional

from ...observability import flight_recorder as _flight

__all__ = ["Fault", "FaultPlan", "install", "uninstall", "active",
           "named_plan", "plan_from_spec", "maybe_kill_worker"]

_LATER = ("is not ported yet: only the elastic site's kill:worker fault "
          "is (ROADMAP queue items 2 and 6)")


class Fault:
    """One deterministic fault rule (see module docstring)."""

    KINDS = ("kill",)

    def __init__(self, kind: str, op: str = "worker", first: int = 1,
                 every: int = 0, times: int = 1, arg: float = 0.0):
        if kind not in self.KINDS or op not in ("*", "worker"):
            raise NotImplementedError(f"chaos fault {kind}:{op} {_LATER}")
        self.kind = kind
        self.op = op
        self.first = max(1, int(first))
        self.every = int(every)
        self.times = int(times)
        self.arg = float(arg)
        self.matches = 0   # candidate events seen
        self.fired = 0     # faults actually injected

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
    """An ordered list of :class:`Fault` rules.  At most ONE fault
    fires per event (list order wins), so a plan reads as a
    deterministic schedule."""

    def __init__(self, faults: List[Fault], seed: int = 0,
                 name: str = ""):
        self.faults = list(faults)
        self.seed = int(seed)
        self.name = name
        self._lock = threading.Lock()

    def match_elastic(self, op: str = "worker") -> Optional[Fault]:
        """Elastic-site hook (:func:`maybe_kill_worker`): consult the
        schedule for stream ``op``.  Called exactly once per EXECUTED
        training step, so ``every=K`` fires after K steps of this
        process's current incarnation.  Returns the firing Fault or
        None; the caller delivers the signal."""
        with self._lock:
            fired = None
            for f in self.faults:
                if f.op != "*" and f.op != op:
                    continue
                f.matches += 1
                if f._should_fire():
                    fired = f
                    break
        if fired is not None:
            # the flight-recorder ring keeps every injected fault, so a
            # postmortem bundle shows the chaos that caused the failure
            _flight.record("chaos", fault=fired.kind, op=op,
                           site="elastic", n=fired.fired, plan=self.name)
        return fired

    def __repr__(self):
        return (f"FaultPlan(name={self.name!r}, seed={self.seed}, "
                f"faults={self.faults})")


def named_plan(name: str, seed: int = 0) -> FaultPlan:
    """Prebuilt schedules: ``kill_worker@every=K``."""
    if name.startswith("kill_worker@every="):
        # SIGKILL this worker at its K-th executed step, then every K
        # after that, forever (each launcher restart re-arms the plan
        # from the env, so every incarnation dies after K steps -- the
        # run only finishes because checkpoints land more often than
        # kills and the final incarnation's remaining step count is
        # below K)
        k = int(name[len("kill_worker@every="):])
        faults = [Fault("kill", op="worker", first=k, every=k, times=0)]
    else:
        raise NotImplementedError(f"chaos plan {name!r} {_LATER}")
    return FaultPlan(faults, seed=seed, name=name)


def maybe_kill_worker(op: str = "worker"):
    """Elastic step-loop hook: SIGKILL the current process when the
    active plan schedules a ``kill`` fault for this step.  SIGKILL (not
    ``os._exit``) so the launcher watchdog sees exactly what a
    machine-level worker loss delivers: a negative waitpid status it
    must normalise to 128+9."""
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
