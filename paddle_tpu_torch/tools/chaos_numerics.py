"""Run a guarded training loop under deterministic numeric fault
injection and report what the guard did (counterpart of the reference's
``tools/chaos_numerics.py``).

A small regression net (4 -> 16 tanh -> 1, ``Momentum(StepDecay(0.1,
5, 0.5), 0.9)``) trains with a ``TrainGuard`` attached (fused health
check, skip / rewind policy, batch blame, a pinned checkpoint as the
rewind target) while ``distributed.fleet.chaos`` injects NaN / Inf into
the chosen stream at exact steps.  The report counts what fired and
what the guard recovered:

  skips         steps whose poisoned gradients were dropped
  rewinds       restores of the last healthy pinned checkpoint
  blamed_rows   poisoned rows found by bisecting the batch
  final_loss    must be finite for exit status 0

Plans (the chaos module's named numeric plans, ``env`` for the
``PADDLE_CHAOS`` spec, or ``clean``):

  nan_grad@N    NaN in the gradients at step N   -> one skip
  inf_grad@N    +inf in the gradients at step N  -> one skip
  nan_batch@N   2 poisoned rows in batch N       -> a skip and blame
  diverge@N     4 poisoned batches from N on     -> a rewind
  clean         no injection: the guard stays silent

Examples::

    python -m paddle_tpu_torch.tools.chaos_numerics --plan nan_grad@5
    python -m paddle_tpu_torch.tools.chaos_numerics --plan diverge@8 \
        --steps 24 --device cpu

Exit status 0 when the run completed with a finite final loss and the
guard's actions match the plan; the report is printed as JSON.
"""
from __future__ import annotations

import argparse
import json
import sys
import tempfile

import numpy as np
import torch

from .. import resolve_device
from ..distributed.checkpoint import CheckpointManager
from ..distributed.fleet import chaos
from ..framework.monitor import stats_with_prefix
from ..nn import Linear
from ..optimizer import Momentum
from ..optimizer.lr import StepDecay
from ..train_guard import NumericalDivergence, TrainGuard, chaos_corrupt


def _batch(step, batch_size):
    """The batch of a step, the same on every (re)run: the property a
    rewind relies on."""
    rng = np.random.default_rng(1000 + step)
    x = rng.normal(size=(batch_size, 4)).astype(np.float32)
    return x, x.sum(1, keepdims=True).astype(np.float32)


class _Net(torch.nn.Module):
    def __init__(self, dev):
        super().__init__()
        gen = torch.Generator(device=dev).manual_seed(0)
        self.fc1 = Linear(4, 16, device=dev, generator=gen)
        self.fc2 = Linear(16, 1, device=dev, generator=gen)

    def forward(self, x):
        return self.fc2(torch.tanh(self.fc1(x)))


def _mse(a, b):
    return torch.mean((a - b) ** 2)


def run(plan_name, steps, batch_size, seed, ckdir, device=None,
        max_consecutive_bad=3, rewind_budget=2):
    dev = resolve_device(device)
    net = _Net(dev)
    sched = StepDecay(learning_rate=0.1, step_size=5, gamma=0.5)
    opt = Momentum(learning_rate=sched, momentum=0.9,
                   parameters=list(net.parameters()))
    mgr = CheckpointManager(ckdir, max_to_keep=2)

    def state_fn():
        return {"model": net.state_dict(), "opt": opt.state_dict(),
                "sched": sched.state_dict()}

    def restore_fn(state):
        with torch.no_grad():
            for k, v in net.state_dict().items():
                v.copy_(torch.as_tensor(np.asarray(state["model"][k])))
        opt.set_state_dict(state["opt"])
        sched.set_state_dict(state["sched"])

    guard = TrainGuard(optimizer=opt, manager=mgr, state_fn=state_fn,
                       restore_fn=restore_fn, min_history=4,
                       spike_factor=8.0,
                       max_consecutive_bad=max_consecutive_bad,
                       rewind_budget=rewind_budget, checkpoint_every=2)

    if plan_name == "env":
        plan = chaos.active()   # PADDLE_CHAOS installed it at import
    elif plan_name == "clean":
        plan = None
    else:
        plan = chaos.install(chaos.named_plan(plan_name, seed=seed))

    losses = []
    diverged = None
    for step in range(steps):
        x, y = _batch(step, batch_size)
        (x,), _ = chaos_corrupt("batch", [x])
        xt, yt = torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev)

        def blame_fn(rows):
            with torch.no_grad():
                sub = _mse(net(xt[torch.from_numpy(rows).to(dev)]),
                           yt[torch.from_numpy(rows).to(dev)])
            return bool(torch.isfinite(sub).item())

        loss = _mse(net(xt), yt)
        loss.backward()
        try:
            verdict = guard.step(loss.detach(), step=step,
                                 blame_fn=blame_fn, n_rows=batch_size)
        except NumericalDivergence as e:
            diverged = str(e)
            break
        if verdict == "ok":
            sched.step()
            losses.append(guard.last_health.loss)

    report = {
        "plan": plan_name, "steps": steps, "applied_steps": len(losses),
        "final_loss": losses[-1] if losses else None,
        "skips": guard.skips, "rewinds": guard.rewinds,
        "blamed": guard.blamed_rows,
        "pinned": mgr.pinned_steps(),
        "registry": stats_with_prefix("guard_"),
        "events": guard.events,
        "diverged": diverged,
        "chaos": plan.stats_dict() if plan is not None else {},
        "completed": diverged is None,
    }
    if plan is not None and plan_name != "env":
        chaos.uninstall()
    return report


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--plan", default="nan_grad@5",
                    help="clean | env | nan_grad@N | inf_grad@N | "
                         "nan_batch@N | diverge@N")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    ap.add_argument("--ckdir", default=None,
                    help="checkpoint directory (default: a new temporary "
                         "one)")
    args = ap.parse_args(argv)

    ckdir = args.ckdir or tempfile.mkdtemp(prefix="chaos_numerics_")
    report = run(args.plan, args.steps, args.batch, args.seed, ckdir,
                 device=args.device)
    print(json.dumps(report, indent=1, sort_keys=True, default=str))

    ok = (report["completed"] and report["final_loss"] is not None
          and np.isfinite(report["final_loss"]))
    if args.plan == "clean":
        ok = ok and report["skips"] == 0 and report["rewinds"] == 0
    elif args.plan.startswith(("nan_grad@", "inf_grad@")):
        ok = ok and report["skips"] == 1 and report["rewinds"] == 0
    elif args.plan.startswith("nan_batch@"):
        ok = (ok and report["skips"] == 1
              and sum(len(r) for _, r in report["blamed"]) == 2)
    elif args.plan.startswith("diverge@"):
        ok = ok and report["rewinds"] >= 1
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
