"""``python -m paddle_tpu_torch.distributed.launch`` — the launcher
(counterpart of ``paddle_tpu/distributed/launch.py``).

Reference: python/paddle/distributed/fleet/launch.py:334 — parses
``--ips``, builds the trainer endpoint table, runs the training script
with ``PADDLE_TRAINER_ID``/``PADDLE_TRAINER_ENDPOINTS`` in its
environment and watchdogs it (launch_utils.py:526).

``--nproc_per_node N`` starts N rank processes on this host (one per
rank, the port's collective idiom): local rank l gets global rank
``host_rank * N + l``, the world ``len(ips) * N``, endpoint
``ip:coordinator_port + l`` and card ``FLAGS_selected_gpus`` = l mod the
host's card count, with ``PADDLE_RANK_IN_NODE`` and ``PADDLE_LOCAL_SIZE``
beside; ``--backend`` (``nccl`` or ``gloo``) goes to every rank as
``PADDLE_DISTRI_BACKEND``, which ``init_parallel_env`` reads (ranks that
share a card must ask for ``gloo``).  The first rank to fail ends the
others and the launcher exits with its code; ``--timeout`` bounds the
whole run (every rank is killed past it, exit 124).  With ``--log_dir``
each rank logs to ``worker.<rank>.log`` and a failure prints every
rank's log tail.  At ``--nproc_per_node 1`` it simply runs the script.

Elastic mode: the reference's watchdog aborts the whole job when any
worker dies (launch_utils.py watch-local-trainers semantics).
``--elastic`` replaces die-on-first-failure with a restart loop: a
worker that exits non-zero is relaunched (up to ``--max_restarts``,
with exponential backoff from ``--restart_backoff``) and rejoins the
run through the elastic rendezvous at ``PADDLE_COORDINATOR``
(fleet/elastic.py); the membership controller reshards state from the
last pinned checkpoint and training resumes bit-identically.  When no
coordinator is running, the rank-0 launcher starts one in-process.

Watchdog contract: a worker killed by signal exits the launcher with
``128 + signum`` (never a raw negative waitpid code), and the
per-worker log handle is closed even when ``proc.wait()`` raises.
"""
from __future__ import annotations

import argparse
import os
import signal
import subprocess
import sys
import time

from .spawn import _tail

__all__ = ["launch", "main"]


def _parse_args(argv):
    p = argparse.ArgumentParser("paddle_tpu_torch.distributed.launch")
    p.add_argument("--ips", type=str, default="127.0.0.1",
                   help="comma-separated host list (rank order)")
    p.add_argument("--host_rank", type=int, default=None,
                   help="this host's index in --ips (auto from hostname/env)")
    p.add_argument("--coordinator_port", type=int, default=12355)
    p.add_argument("--log_dir", type=str, default=None)
    p.add_argument("--nproc_per_node", type=int, default=1,
                   help="rank processes to start on this host")
    p.add_argument("--backend", type=str, default=None,
                   choices=("nccl", "gloo"),
                   help="the ranks' collective backend (default: "
                        "init_parallel_env's rule)")
    p.add_argument("--timeout", type=float, default=86400.0,
                   help="seconds the ranks may run before every one is "
                        "killed (exit 124)")
    p.add_argument("--elastic", action="store_true",
                   help="supervise the worker elastically: restart on "
                        "failure and rejoin via PADDLE_COORDINATOR "
                        "instead of aborting the job")
    p.add_argument("--max_restarts", type=int, default=3,
                   help="elastic restart budget (per launcher)")
    p.add_argument("--restart_backoff", type=float, default=1.0,
                   help="base seconds between restarts (doubles per "
                        "consecutive failure, capped at 30s)")
    p.add_argument("training_script", type=str)
    p.add_argument("training_script_args", nargs=argparse.REMAINDER)
    return p.parse_args(argv)


def _open_log(path):
    """Split out so the watchdog tests can hand in a tracking file."""
    return open(path, "a")


def _normalize_exit(ret: int) -> int:
    """Signal deaths surface as ``128 + signum`` (shell convention);
    the raw negative ``Popen.returncode`` would read as success-ish to
    ``$? > 128`` checks and confuse restart policies."""
    return 128 - ret if ret < 0 else ret


def _run_worker(cmd, env, log_path, forward_signals=True):
    """Spawn one worker, watchdog it, return its normalized exit code.

    The log handle closes in ``finally`` — an exception out of
    ``proc.wait()`` (KeyboardInterrupt, a dying pytest harness) must
    not leak the descriptor across restart iterations."""
    log = _open_log(log_path) if log_path else None
    try:
        proc = subprocess.Popen(cmd, env=env, stdout=log or None,
                                stderr=subprocess.STDOUT if log else None)

        # watchdog parity (reference launch_utils.py:526
        # watch_local_trainers): propagate signals, reap child
        def _forward(sig, _frame):
            try:
                proc.send_signal(sig)
            except ProcessLookupError:
                pass

        if forward_signals:
            for s in (signal.SIGINT, signal.SIGTERM):
                signal.signal(s, _forward)
        return _normalize_exit(proc.wait())
    finally:
        if log:
            log.close()


def _run_ranks(cmds_envs, log_paths, timeout):
    """Start every local rank; the first to fail ends the rest.  Returns
    the launcher's exit code."""
    logs = [_open_log(p) if p else None for p in log_paths]
    procs = []
    try:
        for (cmd, env), log in zip(cmds_envs, logs):
            procs.append(subprocess.Popen(
                cmd, env=env, stdout=log or None,
                stderr=subprocess.STDOUT if log else None))

        def _forward(sig, _frame):
            for p in procs:
                try:
                    p.send_signal(sig)
                except ProcessLookupError:
                    pass

        for s in (signal.SIGINT, signal.SIGTERM):
            signal.signal(s, _forward)
        deadline = time.monotonic() + timeout
        code = 0
        while True:
            rcs = [p.poll() for p in procs]
            bad = [(i, r) for i, r in enumerate(rcs) if r not in (None, 0)]
            if bad:
                i, r = bad[0]
                code = _normalize_exit(r)
                print(f"[launch] rank {i} exited {code}; ending the "
                      "others", file=sys.stderr)
                break
            if all(r == 0 for r in rcs):
                return 0
            if time.monotonic() > deadline:
                code = 124
                print(f"[launch] ranks not done within {timeout:.0f} s; "
                      "killing them", file=sys.stderr)
                break
            time.sleep(0.1)
        for p in procs:
            if p.poll() is None:
                p.terminate()
        for p in procs:
            try:
                p.wait(10)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
        for i, path in enumerate(log_paths):
            if path:
                print(f"[launch] --- {path} ---\n{_tail(path)}",
                      file=sys.stderr)
        return code
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for log in logs:
            if log:
                log.close()


def _ensure_coordinator(env, nhosts):
    """Elastic mode with no live coordinator: the rank-0 launcher hosts
    one in-process (it outlives every worker incarnation) and exports
    its address."""
    if env.get("PADDLE_COORDINATOR"):
        return None
    from .fleet.elastic import ElasticCoordinator
    coord = ElasticCoordinator(expected_world=nhosts)
    coord.start()
    env["PADDLE_COORDINATOR"] = f"127.0.0.1:{coord.port}"
    return coord


def launch(argv=None):
    args = _parse_args(argv if argv is not None else sys.argv[1:])
    ips = [h for h in args.ips.split(",") if h]
    nhosts = len(ips)
    rank = args.host_rank
    if rank is None:
        rank = int(os.environ.get("PADDLE_TRAINER_ID", "0"))

    if args.nproc_per_node > 1:
        if args.elastic:
            raise SystemExit("--elastic runs one worker per host "
                             "(--nproc_per_node 1)")
        sys.exit(_launch_ranks(args, ips, rank))

    env = dict(os.environ)
    env["PADDLE_TRAINER_ID"] = str(rank)
    env["PADDLE_TRAINERS_NUM"] = str(nhosts)
    env["PADDLE_TRAINER_ENDPOINTS"] = ",".join(
        f"{h}:{args.coordinator_port}" for h in ips)
    env["PADDLE_CURRENT_ENDPOINT"] = f"{ips[rank]}:{args.coordinator_port}"
    if nhosts > 1:
        env["PADDLE_COORDINATOR"] = f"{ips[0]}:{args.coordinator_port}"

    cmd = [sys.executable, "-u", args.training_script] \
        + args.training_script_args
    log_path = None
    if args.log_dir:
        os.makedirs(args.log_dir, exist_ok=True)
        log_path = os.path.join(args.log_dir, f"worker.{rank}.log")

    coord = None
    try:
        if args.elastic:
            env["PADDLE_ELASTIC"] = "1"
            if rank == 0:
                coord = _ensure_coordinator(env, nhosts)

            restarts = 0
            while True:
                env["PADDLE_ELASTIC_RESTART"] = str(restarts)
                code = _run_worker(cmd, env, log_path)
                if code == 0:
                    sys.exit(0)
                if restarts >= args.max_restarts:
                    print(f"[launch] worker rank {rank} failed with "
                          f"exit {code}; restart budget "
                          f"({args.max_restarts}) exhausted",
                          file=sys.stderr)
                    sys.exit(code)
                delay = min(args.restart_backoff * (2 ** restarts), 30.0)
                restarts += 1
                print(f"[launch] worker rank {rank} exited {code}; "
                      f"elastic restart {restarts}/{args.max_restarts} "
                      f"in {delay:.1f}s", file=sys.stderr)
                time.sleep(delay)
        else:
            sys.exit(_run_worker(cmd, env, log_path))
    finally:
        if coord is not None:
            coord.stop()


def _launch_ranks(args, ips, host_rank):
    n = args.nproc_per_node
    world = len(ips) * n
    eps = [f"{h}:{args.coordinator_port + i}" for h in ips for i in range(n)]
    cards = 0
    try:
        import torch
        cards = torch.cuda.device_count() if torch.cuda.is_available() \
            else 0
    except ImportError:
        pass
    if args.log_dir:
        os.makedirs(args.log_dir, exist_ok=True)
    cmds_envs, logs = [], []
    for local in range(n):
        r = host_rank * n + local
        env = dict(os.environ)
        env.update({"PADDLE_TRAINER_ID": str(r),
                    "PADDLE_TRAINERS_NUM": str(world),
                    "PADDLE_TRAINER_ENDPOINTS": ",".join(eps),
                    "PADDLE_CURRENT_ENDPOINT": eps[r],
                    "PADDLE_RANK_IN_NODE": str(local),
                    "PADDLE_LOCAL_SIZE": str(n)})
        if cards:
            env["FLAGS_selected_gpus"] = str(local % cards)
        if args.backend:
            env["PADDLE_DISTRI_BACKEND"] = args.backend
        cmds_envs.append(([sys.executable, "-u", args.training_script]
                          + args.training_script_args, env))
        logs.append(os.path.join(args.log_dir, f"worker.{r}.log")
                    if args.log_dir else None)
    return _run_ranks(cmds_envs, logs, args.timeout)


def main():
    launch()


if __name__ == "__main__":
    main()
