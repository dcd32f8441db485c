"""Observability (counterpart of ``paddle_tpu.observability``): so far the
flight recorder, the always-on event ring that the elastic data plane,
the PS service, the generation server and the gateway record into,
cross-process tracing (``trace``), whose spans the PS client and server
open on every RPC, and per-request span lanes (``request_trace``) the
generation server writes when tracing is on.  The metrics
exporters, timelines, the fleet aggregator and the SLO engine are not
ported yet (ROADMAP queue item 8).

Imports nothing of a device runtime.
"""
from __future__ import annotations

from . import flight_recorder, request_trace, trace  # noqa: F401
from .flight_recorder import (  # noqa: F401
    FlightRecorder, Watchdog, compile_log, flight_dump, flight_enabled,
    flight_record)

__all__ = ["flight_recorder", "request_trace", "trace", "FlightRecorder", "Watchdog", "flight_record",
           "flight_dump", "flight_enabled", "compile_log"]

# honour PADDLE_FLIGHT (full mode installs the dump triggers)
flight_recorder.enable_from_env()
