"""Per-request lifecycle tracing for the serving tier (counterpart of
``paddle_tpu/observability/request_trace.py``, the same code).

Thread spans show what each thread did; a continuous-batching server
multiplexes every request through one scheduler thread, so a thread view
shows one undifferentiated decode stream.  A :class:`RequestTrace` is
one request's span chain, in a lane of its own:

    req (root, submit -> finish)
      req.queue     submit -> admission (re-opened after an eviction)
      req.admit     instant; kind = prefix-hit / cold / readmit, plus
                    an admit-rollback instant when the capacity check
                    sheds the admission
      req.prefill   the prefill dispatch window (every rider of one
                    batched dispatch gets its own span over it)
      req.first_token  instant carrying ``ttft_ms`` -- the same value
                    the server observes into ``serve_ttft_ms``, so the
                    span view and the histogram agree by construction
      req.decode    sampled decode iterations (1 in
                    ``PADDLE_TRACE_EVERY``)
      req.evict / req.finish  terminal / requeue instants

Every span is written by :func:`trace.emit_span` with explicit ids (no
thread-local stack: phases open and close on different threads and
interleave across requests), and the chain shares one virtual lane id
(``tid``), so a merged trace renders one lane per request (its name from
the root span's ``lane`` argument).

Cost: servers hold ``rt = None`` when tracing is off (the off path is
one attribute check); phase bookkeeping is two dict writes; decode
spans are sampled.  Timestamps anchor wall-clock microseconds at
construction and advance by ``perf_counter`` deltas, so phases nest
exactly inside the root span whatever the wall clock does.

Imports nothing of a device runtime.
"""
from __future__ import annotations

import os
import time
from typing import Dict, Optional

from . import trace as _trace

__all__ = ["RequestTrace", "LANE_BASE"]

# virtual-lane tid base (a collision with a real thread's ident after
# the renderers' % (1 << 31) fold only shares a lane on screen: the ids
# in the records stay per request)
LANE_BASE = 0x40000000


class RequestTrace:
    """Span chain + virtual lane for ONE serving request."""

    __slots__ = ("server", "rid", "tenant", "trace_id", "root_id",
                 "lane", "t0_us", "_mono0", "_open")

    def __init__(self, server: str, rid: int,
                 tenant: Optional[str] = None):
        self.server = str(server)
        self.rid = int(rid)
        self.tenant = tenant
        self.trace_id = _trace.new_id()
        self.root_id = _trace.new_id()
        # one lane per request; fold into 31 bits for Chrome tids
        self.lane = (LANE_BASE + ((os.getpid() << 12) ^ self.rid)) \
            % (1 << 31)
        self.t0_us = time.time_ns() // 1000
        self._mono0 = time.perf_counter()
        self._open: Dict[str, float] = {}

    # -- clock ----------------------------------------------------------
    def _now_us(self) -> int:
        return self.t0_us + int(
            (time.perf_counter() - self._mono0) * 1e6)

    def _args(self, extra: Dict) -> Dict:
        a = {"rid": self.rid}
        if self.tenant is not None:
            a["tenant"] = self.tenant
        a.update(extra)
        return a

    # -- phases ---------------------------------------------------------
    def begin(self, phase: str):
        """Open a named phase (re-openable: ``queue`` re-opens after an
        eviction).  Cheap — one dict write, no record."""
        self._open[phase] = time.perf_counter()

    def end(self, phase: str, **args):
        """Close a phase -> one ``req.<phase>`` span in this request's
        lane (ignored when the phase was never opened — a server
        restart path must not crash on bookkeeping)."""
        t0 = self._open.pop(phase, None)
        if t0 is None:
            return
        now = time.perf_counter()
        ts_us = self.t0_us + int((t0 - self._mono0) * 1e6)
        _trace.emit_span(
            f"req.{phase}", ts_us, int((now - t0) * 1e6),
            self.trace_id, _trace.new_id(), parent=self.root_id,
            tid=self.lane, args=self._args(args))

    def span_at(self, name: str, dur_ms: float, **args):
        """One span of known duration ENDING now (the decode loop
        measures the step first, then attributes it)."""
        dur_us = max(int(dur_ms * 1e3), 0)
        _trace.emit_span(
            f"req.{name}", self._now_us() - dur_us, dur_us,
            self.trace_id, _trace.new_id(), parent=self.root_id,
            tid=self.lane, args=self._args(args))

    def instant(self, name: str, **args):
        """Zero-duration marker in the request lane."""
        _trace.emit_span(
            f"req.{name}", self._now_us(), 0, self.trace_id,
            _trace.new_id(), parent=self.root_id, tid=self.lane,
            args=self._args(args))

    # -- terminal -------------------------------------------------------
    def finish(self, reason: str, **args):
        """Close the chain: any still-open phases end here, then the
        ROOT span covering submit -> now is written, carrying the lane
        name (``<server>-req-<rid>``) the renderers turn into the
        lane's thread_name."""
        for phase in list(self._open):
            self.end(phase)
        _trace.emit_span(
            "req", self.t0_us,
            int((time.perf_counter() - self._mono0) * 1e6),
            self.trace_id, self.root_id, tid=self.lane,
            args=self._args({"lane": f"{self.server}-req-{self.rid}",
                             "reason": reason, **args}))
