"""Observability (counterpart of ``paddle_tpu.observability``): so far the
flight recorder, the always-on event ring that the elastic data plane,
the PS service, the generation server and the gateway record into;
cross-process tracing (``trace``), whose spans the PS client and server
open on every RPC; per-request span lanes (``request_trace``) the
generation server writes when tracing is on; and declarative SLOs with
multi-window burn rates (``slo``: ``SLO``, ``SloEngine``, the latched
``slo.breach`` flight event).  The metrics exporters, timelines and the
fleet aggregator are not ported yet (ROADMAP queue item 8).

Imports nothing of a device runtime.
"""
from __future__ import annotations

from . import flight_recorder, request_trace, slo, trace  # noqa: F401
from .flight_recorder import (  # noqa: F401
    FlightRecorder, Watchdog, compile_log, flight_dump, flight_enabled,
    flight_record)
from .slo import SLO, SloEngine  # noqa: F401

__all__ = ["flight_recorder", "request_trace", "slo", "trace",
           "FlightRecorder", "Watchdog", "flight_record", "flight_dump",
           "flight_enabled", "compile_log", "SLO", "SloEngine"]

# honour PADDLE_FLIGHT (full mode installs the dump triggers)
flight_recorder.enable_from_env()
