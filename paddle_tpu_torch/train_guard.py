"""TrainGuard: in-step numeric health checks, loss-spike skip and rewind,
batch blame and the numeric chaos hook (counterpart of the reference's
``train_guard.py``).

1. **Fused health check** (:func:`health_check`, :func:`fused_health`):
   one reduction over the whole gradient tree into a single f32[3]
   device tensor ``[global_norm, nonfinite_count, loss]``.  The caller
   pays one device-to-host copy a step for all of the guard's state, and
   every such copy goes through :func:`_host_fetch`, which
   :func:`host_sync_count` counts.  The reference computes it in XLA
   with no Pallas kernel, so plain PyTorch is the port.
2. **Policy** (:class:`TrainGuard`): skip the step on non-finite
   gradients or loss; detect loss spikes against a rolling median / MAD
   window; after ``max_consecutive_bad`` bad steps rewind to the last
   healthy (pinned) ``CheckpointManager`` step and go on with the next
   batches (the bad window's data is skipped); when the rewind budget is
   spent raise :class:`NumericalDivergence`.
3. **Batch blame** (:meth:`TrainGuard.blame`): bisect a bad batch by
   halves to the poisoned rows; counted in the ``guard_skips`` /
   ``guard_rewinds`` / ``guard_blamed_rows`` stats of
   ``framework.monitor``.
4. **Numeric chaos** (:func:`chaos_corrupt`): the injection hook of
   ``distributed.fleet.chaos``'s ``nan`` / ``inf`` kinds
   (``PADDLE_CHAOS="nan:grad:step=50"``), which the guard (gradients)
   and the tools (batch, activation) call.
"""
from __future__ import annotations

import collections
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from .framework import monitor as _monitor
from .framework.monitor import gauge_set, stat_add, stat_get
from .observability import flight_recorder as _flight
from .observability import trace as _obs_trace

__all__ = ["TrainGuard", "HealthState", "NumericalDivergence",
           "health_check", "fused_health", "chaos_corrupt",
           "host_sync_count", "GUARD_STAT_NAMES"]

# the StatRegistry counters the guard reports through
GUARD_STAT_NAMES = ("guard_skips", "guard_rewinds", "guard_blamed_rows")


class NumericalDivergence(RuntimeError):
    """The rewind budget is spent and the run still diverges: nothing is
    left to do automatically.  (The reference's base, ``EnforceNotMet``,
    is a ``RuntimeError``.)"""


# ----------------------------------------------------------------------
# the fused health check
# ----------------------------------------------------------------------

def _device_of(loss, grads):
    if grads:
        return grads[0].device
    if isinstance(loss, torch.Tensor):
        return loss.device
    return torch.device("cpu")


def _loss_value(loss, dev):
    if loss is None:
        return torch.zeros((), dtype=torch.float32, device=dev)
    if isinstance(loss, torch.Tensor):
        loss = loss.detach()
    return torch.as_tensor(loss, device=dev).float().reshape(())


def _health_reduce(loss, grads):
    """Gradients and loss -> f32[3] ``[global_norm, nonfinite_count,
    loss]``.  Non-finite elements are masked out of the norm, so the norm
    still describes the healthy rest of a poisoned step."""
    dev = _device_of(loss, grads)
    sq = torch.zeros((), dtype=torch.float32, device=dev)
    bad = torch.zeros((), dtype=torch.float32, device=dev)
    for g in grads:
        finite = torch.isfinite(g)
        bad = bad + (~finite).sum().float()
        g32 = torch.where(finite, g, 0).float()
        sq = sq + torch.sum(g32 * g32)
    lv = _loss_value(loss, dev)
    if loss is not None:
        bad = bad + (~torch.isfinite(lv)).float()
    return torch.stack([torch.sqrt(sq), bad, lv])


def _health_reduce_fast(loss, grads):
    """One pass over each gradient (its sum of squares): NaN / Inf carry
    into the sum, so badness is the result's own finiteness.  Slot 1 is
    then a 0/1 indicator, not a count, and the norm is non-finite on a
    bad step: what the skip policy needs."""
    dev = _device_of(loss, grads)
    sq = torch.zeros((), dtype=torch.float32, device=dev)
    for g in grads:
        g32 = g.float()
        sq = sq + torch.sum(g32 * g32)
    lv = _loss_value(loss, dev)
    ok = torch.isfinite(sq)
    if loss is not None:
        ok = ok & torch.isfinite(lv)
    return torch.stack([torch.sqrt(sq), (~ok).float(), lv])


# every guard device-to-host copy goes through _host_fetch, so the count
# can be read; nothing else in this module reads a device value
_host_syncs = 0


def host_sync_count() -> int:
    return _host_syncs


def _host_fetch(dev_arr) -> np.ndarray:
    global _host_syncs
    _host_syncs += 1
    if _obs_trace.enabled() or _monitor.metrics_enabled():
        # the copy is the guard's only device sync: its duration is the
        # time the host stalls on guard state (the step's "health fetch")
        with _obs_trace.span("step.health_fetch", cat="step"):
            t0 = time.perf_counter()
            out = dev_arr.detach().cpu().numpy()
        if _monitor.metrics_enabled():
            _monitor.hist_observe("step_health_fetch_ms",
                                  (time.perf_counter() - t0) * 1e3)
        return out
    return dev_arr.detach().cpu().numpy()


def _grad_leaves(source) -> List[torch.Tensor]:
    """Gradient tensors from an optimizer, a parameter holder or a list
    of tensors / arrays."""
    if hasattr(source, "grad_leaves"):
        return list(source.grad_leaves())
    if hasattr(source, "_parameter_list"):
        source = [p.grad for p in source._parameter_list
                  if p.grad is not None]
    return [g if isinstance(g, torch.Tensor) else torch.as_tensor(g)
            for g in source if g is not None]


class HealthState:
    """One step's health: the f32[3] device tensor; :meth:`fetch` is the
    single host copy (cached)."""

    __slots__ = ("device", "_host")

    def __init__(self, device_arr):
        self.device = device_arr
        self._host = None

    def fetch(self) -> np.ndarray:
        if self._host is None:
            self._host = _host_fetch(self.device)
        return self._host

    @property
    def global_norm(self) -> float:
        return float(self.fetch()[0])

    @property
    def nonfinite_count(self) -> int:
        v = self.fetch()[1]
        return int(v) if np.isfinite(v) else 1

    @property
    def loss(self) -> float:
        return float(self.fetch()[2])

    @property
    def ok(self) -> bool:
        h = self.fetch()
        return bool(h[1] == 0 and np.isfinite(h[2]))


def fused_health(grads: Sequence, loss=None, precise: bool = True):
    """The f32[3] health tensor with no host copy: a train step computes
    it and hands it to :meth:`TrainGuard.check`.  ``precise=False`` takes
    the one-pass reduction (an indicator instead of a count, an unmasked
    norm), the right one inside a hot step."""
    reduce = _health_reduce if precise else _health_reduce_fast
    return reduce(loss, list(grads))


@torch.no_grad()
def health_check(grads, loss=None) -> HealthState:
    """The fused health reduction over ``grads`` (an optimizer, or a list
    of tensors).  No host sync happens until the returned state is read,
    and then exactly one."""
    leaves = _grad_leaves(grads)
    if not leaves:
        dev = _device_of(loss, leaves)
        return HealthState(_health_reduce(
            0.0 if loss is None else loss,
            [torch.zeros((1,), device=dev)]))
    return HealthState(_health_reduce(loss, leaves))


# ----------------------------------------------------------------------
# the numeric chaos hook
# ----------------------------------------------------------------------

def chaos_corrupt(op: str, arrays):
    """If the active chaos plan has a numeric fault (``nan`` / ``inf``)
    for stream ``op`` (``grad``, ``batch``, ``activation``, ``loss``)
    scheduled now, corrupt ``arrays`` (a list of numpy arrays or tensors,
    or one of them) and return ``(arrays, fired)``.  The first
    ``max(1, int(arg))`` rows (elements, for 0/1-d arrays) of the first
    floating array take the fault's value; the others are returned as
    they are.  Tensors are copied, not written."""
    from .distributed.fleet import chaos as _chaos
    plan = _chaos.active()
    if plan is None:
        return arrays, False
    single = not isinstance(arrays, (list, tuple))
    arrs = [arrays] if single else list(arrays)
    fault = plan.match_numeric(op)
    if fault is None:
        return arrays, False
    val = np.nan if fault.kind == "nan" else np.inf
    n = max(1, int(fault.arg))
    out = []
    done = False
    for a in arrs:
        is_float = (a.is_floating_point() if isinstance(a, torch.Tensor)
                    else "float" in str(getattr(a, "dtype", "")))
        if done or not is_float:
            out.append(a)
            continue
        b = a.clone() if isinstance(a, torch.Tensor) else a.copy()
        if b.ndim >= 2:
            b[:n] = val
        else:
            b.reshape(-1)[:min(n, b.size if isinstance(b, np.ndarray)
                               else b.numel())] = val
        out.append(b)
        done = True
    plan.stats[f"{fault.kind}:{op}"] += 1
    return (out[0] if single else out), True


def _corrupt_optimizer_grads(optimizer) -> bool:
    """Apply a scheduled ``nan:grad`` / ``inf:grad`` fault to the
    optimizer's real gradients, so the guard sees the state the optimizer
    would consume."""
    params = [p for p in optimizer._parameter_list if p.grad is not None]
    if not params:
        return False
    new, fired = chaos_corrupt("grad", [p.grad for p in params])
    if fired:
        for p, v in zip(params, new):
            p.grad = v
    return fired


# ----------------------------------------------------------------------
# the policy
# ----------------------------------------------------------------------

class TrainGuard:
    """Detection -> skip -> rewind -> blame for a training loop::

        guard = TrainGuard(optimizer=opt, manager=ckpt_mgr,
                           state_fn=lambda: {...}, restore_fn=restore)
        for step, batch in enumerate(loader):
            loss = loss_fn(batch); loss.backward()
            verdict = guard.step(loss, step=step)
            # "ok" (stepped), "skip" (gradients dropped) or "rewind"
            # (state restored to the last healthy checkpoint)

    ``state_fn()`` gives the nested state (model, optimizer, scheduler)
    saved through ``manager`` every ``checkpoint_every`` healthy steps;
    the newest healthy step is pinned, so rotation never deletes the
    rewind target.  ``restore_fn(state)`` restores what a fresh process
    would.  A train step built with ``guard_health=True`` hands its
    ``last_health`` to :meth:`check` instead (the step applies its own
    update).
    """

    def __init__(self, optimizer=None, manager=None, state_fn=None,
                 restore_fn=None, scaler=None, window: int = 32,
                 min_history: int = 8, spike_factor: float = 10.0,
                 mad_floor: float = 1e-3, max_consecutive_bad: int = 3,
                 rewind_budget: int = 2, checkpoint_every: int = 1,
                 blame_fn: Optional[Callable] = None):
        self.optimizer = optimizer
        self.manager = manager
        self.state_fn = state_fn
        self.restore_fn = restore_fn
        self.scaler = scaler
        self.blame_fn = blame_fn
        self.window = int(window)
        self.min_history = int(min_history)
        self.spike_factor = float(spike_factor)
        self.mad_floor = float(mad_floor)
        self.max_consecutive_bad = int(max_consecutive_bad)
        self.rewind_budget = int(rewind_budget)
        self.checkpoint_every = int(checkpoint_every)

        self._history: collections.deque = collections.deque(
            maxlen=self.window)
        self._bad_streak = 0
        self._healthy_since_ckpt = 0
        self.last_healthy_step: Optional[int] = None
        self.skips = 0
        self.rewinds = 0
        # the gauges mirror this guard's live counts: a new guard zeroes
        # the last run's
        for k in GUARD_STAT_NAMES:
            gauge_set(k, 0)
        self.blamed_rows: List = []          # (step, [row indices])
        self.events: List[Dict] = []         # skips and rewinds
        self.last_health: Optional[HealthState] = None

    # -- detection -----------------------------------------------------
    def _spike(self, loss_val: float) -> bool:
        if len(self._history) < self.min_history:
            return False
        med = float(np.median(self._history))
        mad = float(np.median(np.abs(np.asarray(self._history) - med)))
        dev = max(mad, self.mad_floor)
        # only upward excursions are divergence; a sudden drop is luck
        return loss_val - med > self.spike_factor * dev

    def check(self, health, step: Optional[int] = None) -> str:
        """Classify one step's health (a :class:`HealthState` or the raw
        f32[3] tensor of :func:`fused_health`) without acting on it:
        "ok", "skip" or "rewind"."""
        if not isinstance(health, HealthState):
            health = HealthState(health)
        self.last_health = health
        h = health.fetch()               # the step's one host copy
        nonfinite = h[1] != 0 or not np.isfinite(h[2])
        reason = None
        if nonfinite:
            reason = "nonfinite"
        elif self._spike(float(h[2])):
            reason = "loss_spike"
        if reason is None:
            self._history.append(float(h[2]))
            self._bad_streak = 0
            self._flight_health(step, h, "ok", None)
            return "ok"
        self._bad_streak += 1
        self.events.append({"step": step, "reason": reason,
                            "loss": float(h[2]),
                            "nonfinite": int(h[1]) if np.isfinite(h[1])
                            else -1, "streak": self._bad_streak})
        if (self._bad_streak >= self.max_consecutive_bad
                and self._can_rewind()):
            self._flight_health(step, h, "rewind", reason)
            return "rewind"
        self._flight_health(step, h, "skip", reason)
        return "skip"

    @staticmethod
    def _flight_health(step, h, verdict, reason):
        """The flight recorder's copy of the health vector and verdict."""
        if not _flight.enabled():
            return
        ev = {"step": step, "norm": float(h[0]),
              "nonfinite": float(h[1]), "loss": float(h[2]),
              "verdict": verdict}
        if reason is not None:
            ev["reason"] = reason
        _flight.record("health", **ev)

    def _can_rewind(self) -> bool:
        return (self.manager is not None and self.restore_fn is not None
                and self.last_healthy_step is not None)

    # -- actions -------------------------------------------------------
    def mark_healthy(self, step: int):
        """Record a healthy step; save and pin a checkpoint every
        ``checkpoint_every`` healthy steps."""
        if self.manager is None or self.state_fn is None:
            self.last_healthy_step = step
            return
        self._healthy_since_ckpt += 1
        if (self.last_healthy_step is None
                or self._healthy_since_ckpt >= self.checkpoint_every):
            self.manager.save(step, self.state_fn())
            prev = self.last_healthy_step
            self.manager.pin(step)
            if prev is not None:
                self.manager.unpin(prev)
            self.last_healthy_step = step
            self._healthy_since_ckpt = 0

    def rewind(self, at_step: Optional[int] = None) -> int:
        """Restore the last healthy checkpoint and return its step
        (raises :class:`NumericalDivergence` once the budget is spent).
        The batches since that step are not replayed."""
        if not self._can_rewind():
            _flight.record("divergence", step=at_step,
                           detail="no rewind target")
            _flight.maybe_dump("NumericalDivergence")
            raise NumericalDivergence(
                "TrainGuard cannot rewind: no CheckpointManager/"
                "restore_fn/healthy checkpoint available")
        if self.rewinds >= self.rewind_budget:
            _flight.record("divergence", step=at_step,
                           rewinds=self.rewinds, budget=self.rewind_budget)
            _flight.maybe_dump("NumericalDivergence")
            raise NumericalDivergence(
                f"rewind budget exhausted ({self.rewinds}/"
                f"{self.rewind_budget}) and the run is still diverging "
                f"(last events: {self.events[-3:]})")
        target = self.last_healthy_step
        self.restore_fn(self.manager.restore(target))
        self.rewinds += 1
        stat_add("guard_rewinds")
        gauge_set("guard_rewinds", self.rewinds)
        self.events.append({"step": at_step, "reason": "rewind",
                            "to_step": target})
        _flight.record("rewind", step=at_step, to_step=target,
                       rewinds=self.rewinds)
        # the diverged region poisoned the rolling window
        self._history.clear()
        self._bad_streak = 0
        if self.optimizer is not None:
            self.optimizer.clear_grad()
        return target

    def blame(self, blame_fn: Callable, n_rows: int,
              step: Optional[int] = None) -> List[int]:
        """Bisect the batch by halves to its poisoned rows.
        ``blame_fn(rows)`` returns True when that sub-batch is healthy.
        The rows found are kept on ``blamed_rows`` and counted in
        ``guard_blamed_rows``."""
        bad: List[int] = []

        def _bisect(idx: np.ndarray):
            if blame_fn(idx):
                return
            if idx.size == 1:
                bad.append(int(idx[0]))
                return
            mid = idx.size // 2
            _bisect(idx[:mid])
            _bisect(idx[mid:])

        _bisect(np.arange(n_rows))
        if bad:
            self.blamed_rows.append((step, sorted(bad)))
            stat_add("guard_blamed_rows", len(bad))
            _flight.record("blame", step=step, rows=sorted(bad))
        gauge_set("guard_blamed_rows",
                  sum(len(r) for _, r in self.blamed_rows))
        return sorted(bad)

    def step(self, loss=None, step: Optional[int] = None,
             optimizer=None, health=None, blame_fn=None,
             n_rows: Optional[int] = None) -> str:
        """One guarded step: the chaos gradient hook, the fused health
        check, the verdict and its action ("ok": ``optimizer.step()``,
        ``clear_grad`` and :meth:`mark_healthy`; "skip": the gradients
        dropped, the scaler backed off, blame run when ``blame_fn`` and
        ``n_rows`` are given; "rewind": :meth:`rewind`)."""
        opt = optimizer or self.optimizer
        if blame_fn is None:
            blame_fn = self.blame_fn
        if opt is not None:
            _corrupt_optimizer_grads(opt)
        if health is None:
            health = health_check(opt if opt is not None else [], loss=loss)
        verdict = self.check(health, step=step)
        if verdict == "ok":
            if opt is not None:
                opt.step()
                opt.clear_grad()
            if self.scaler is not None:
                self.scaler._found_inf = False
                self.scaler.update()
                self.scaler._unscaled.discard(id(opt))
            if step is not None:
                self.mark_healthy(step)
            return verdict
        # a bad step: the poisoned gradients never reach the weights
        if opt is not None:
            if hasattr(opt, "skip_step"):
                opt.skip_step()
            else:
                opt.clear_grad()
        if self.scaler is not None:
            # the loss scale backs off as if its own overflow test fired
            self.scaler._found_inf = True
            self.scaler.update()
            self.scaler._unscaled.discard(id(opt))
        if verdict == "rewind":
            self.rewind(at_step=step)
            return verdict
        self.skips += 1
        stat_add("guard_skips")
        gauge_set("guard_skips", self.skips)
        if blame_fn is not None and n_rows:
            self.blame(blame_fn, n_rows, step=step)
        return verdict

    # -- reporting -----------------------------------------------------
    def stats(self) -> Dict:
        return {
            "skips": self.skips,
            "rewinds": self.rewinds,
            "blamed_rows": sum(len(r) for _, r in self.blamed_rows),
            "quarantine": list(self.blamed_rows),
            "last_healthy_step": self.last_healthy_step,
            "host_syncs": host_sync_count(),
            "registry": {k: stat_get(k) for k in GUARD_STAT_NAMES},
            "events": list(self.events),
        }
