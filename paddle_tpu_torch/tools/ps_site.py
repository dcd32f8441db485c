"""One parameter server of a geo site, started the way a user starts one.

::

    TRAINING_ROLE=PSERVER POD_IP=127.0.0.1 PADDLE_PORT=7100 \\
    PADDLE_PSERVERS_IP_PORT_LIST="127.0.0.1:7100|127.0.0.1:7101" \\
    PADDLE_TRAINERS_NUM=1 \\
    python -m paddle_tpu_torch.tools.ps_site --tables DIR \\
        [--geo-peer "h:p1|h:p2"] [--geo-interval S] [--ttl S] \\
        [--site NAME]

``fleet.init()`` reads that environment through ``PaddleCloudRoleMaker``,
``fleet.init_server(DIR)`` warm-starts the tables from ``DIR``'s
``.npz`` files (an empty table's file carries its configuration), and
``fleet.run_server()`` serves them on ``PADDLE_PORT``: as the primary of
its ``|``-separated replica group, or as the hot standby of the group's
primary when it is listed behind it.  ``--read-replica-of GROUP`` serves
a read replica of ``GROUP`` instead (fleet has no read-replica role).  A
primary may run a ``FeatureLifecycle`` sweeper (``--ttl``) and a
``GeoPusher`` to the peer site's group (``--geo-peer``).

The first line of standard output is one JSON object: ``port``, ``pid``,
``role`` and ``site``.  Then each line of standard input is one JSON
command and gets one JSON line back:

- ``{"cmd": "digest"}``: SHA-256 digests of each table sorted by id, of
  the values alone and of the whole state (values, optimizer state,
  version), with the server's applied count and duplicate acks;
- ``{"cmd": "dump", "path": P}``: each table's ids, values and geo
  stamps (site names) to ``P`` (npz, one set of keys a table);
- ``{"cmd": "drain", "timeout": T}``: ``GeoPusher.drain(T)`` and its
  counters;
- ``{"cmd": "freshness"}``: ``ps_freshness_ms`` p50 / p99 / count and a
  ``FreshnessWatch`` evaluation of this process's gauges;
- ``{"cmd": "stop"}``: stop and exit.

End of input stops the server too, so a server whose parent dies exits.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys

import numpy as np

__all__ = ["table_digest", "main"]

# the geo link's retry budget: a peer group that fails over stays
# reachable, a dead site fails the drain within its own timeout
GEO_CLIENT = dict(connect_timeout=2.0, rpc_timeout=2.0, max_retries=8,
                  backoff_base=0.02, rpc_deadline=30.0)


def table_digest(table, full: bool) -> str:
    """SHA-256 of ``table`` sorted by id: ids and values, and with
    ``full`` the optimizer state and the version too (a replica's whole
    state against its primary's; across geo sites only the values
    agree, since a peer's writes arrive as raw deltas)."""
    d = table._snapshot_arrays(full_state=full)
    o = np.argsort(d["ids"], kind="stable")
    h = hashlib.sha256()
    for k in ("ids", "vals") + (("opt_state",) if full else ()):
        h.update(np.ascontiguousarray(d[k][o]).tobytes())
    if full:
        h.update(int(d["version"]).to_bytes(8, "little"))
    return h.hexdigest()


def _dump(server, path: str):
    out = {}
    for name, t in server._tables.items():
        d = t._snapshot_arrays()
        out[f"{name}.ids"], out[f"{name}.vals"] = d["ids"], d["vals"]
        gi, gs, gsi = t.geo_export()
        out[f"{name}.geo_ids"], out[f"{name}.geo_seqs"] = gi, gs
        out[f"{name}.geo_sites"] = np.asarray(
            [server._site_name(int(i)) for i in gsi], dtype=str)
    np.savez(path, **out)


def _serve(args):
    from ..distributed import fleet
    from ..distributed.fleet.ps import PSRuntime
    from ..distributed.fleet.ps_service import PSServer
    from ..framework import monitor
    monitor.enable_metrics(True)
    if args.read_replica_of:
        rt = PSRuntime()
        rt.init_server(args.tables)
        server = PSServer(rt._tables, host="127.0.0.1",
                          port=int(os.environ.get("PADDLE_PORT", "0")),
                          replica_of=args.read_replica_of,
                          replica_mode="read", wm_interval_s=0.05)
        server.start()
        role = "read replica"
    else:
        fleet.init()
        fleet.init_server(args.tables)
        fleet.run_server()
        server = fleet.fleet_base._fleet._ps_runtime._server
        role = "standby" if server.replica_of else "primary"
    if args.site and role == "primary":
        # the site's name mints its LWW stamps and names its geo pusher
        server.geo_site = args.site
    if server.replica_of and not server.replica_ready.wait(60.0):
        raise SystemExit(f"ps_site: the {role} never attached to "
                         f"{server.replica_of}")
    sweeper = pusher = None
    if args.ttl and role == "primary":
        from ..online import FeatureLifecycle
        sweeper = FeatureLifecycle(server, ttl_s=args.ttl,
                                   interval_s=0.25).start()
    if args.geo_peer and role == "primary":
        from ..distributed.fleet.geo import GeoPusher
        pusher = GeoPusher(server, [args.geo_peer],
                           interval_s=args.geo_interval,
                           **GEO_CLIENT).start()
    return server, role, sweeper, pusher


def _command(msg, server, pusher):
    cmd = msg.get("cmd")
    if cmd == "digest":
        return {"tables": {n: {"vals": table_digest(t, False),
                               "full": table_digest(t, True),
                               "rows": len(t)}
                           for n, t in server._tables.items()},
                "applied": server.applied, "dup_acks": server.dup_acks,
                "promoted": server.promoted}
    if cmd == "dump":
        _dump(server, msg["path"])
        return {"ok": True}
    if cmd == "drain":
        if pusher is None:
            return {"error": "no geo pusher in this process"}
        pusher.drain(timeout=float(msg.get("timeout", 30.0)))
        return {"pushed_ids": pusher.pushed_ids, "flushes": pusher.flushes,
                "push_failures": pusher.push_failures,
                "verified_ids": pusher.verified_ids,
                "corrected_ids": pusher.corrected_ids,
                "backlog": pusher.backlog()}
    if cmd == "freshness":
        from ..framework import monitor
        from ..online import FreshnessWatch
        h = monitor.get_histogram("ps_freshness_ms")
        st = FreshnessWatch().evaluate()
        return {"p50_ms": h.percentile(50) if h else None,
                "p99_ms": h.percentile(99) if h else None,
                "count": h.count if h else 0,
                "objectives": {s["slo"]: s["ok"] for s in st},
                "watermark": server._stats().get("watermark")}
    return {"error": f"unknown command {cmd!r}"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tables", required=True,
                    help="directory of .npz tables to warm-start from")
    ap.add_argument("--read-replica-of", default=None,
                    help="serve a read replica of this replica group")
    ap.add_argument("--geo-peer", default=None,
                    help="the peer site's replica group (a primary only)")
    ap.add_argument("--geo-interval", type=float, default=0.05,
                    help="seconds between the geo pusher's flushes")
    ap.add_argument("--ttl", type=float, default=0.0,
                    help="run a FeatureLifecycle sweeper with this TTL")
    ap.add_argument("--site", default=None,
                    help="the site's name (a primary only)")
    args = ap.parse_args(argv)
    server, role, sweeper, pusher = _serve(args)
    print(json.dumps({"port": server.port, "pid": os.getpid(),
                      "role": role, "site": server.geo_site}), flush=True)
    try:
        for line in sys.stdin:
            msg = json.loads(line)
            if msg.get("cmd") == "stop":
                break
            try:
                reply = _command(msg, server, pusher)
            except Exception as e:   # noqa: BLE001 - reported to the caller
                reply = {"error": repr(e)}
            print(json.dumps(reply), flush=True)
    finally:
        if pusher is not None:
            pusher.stop(drain=False)
        if sweeper is not None:
            sweeper.stop()
        server.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
