"""Observability (counterpart of ``paddle_tpu.observability``): so far the
flight recorder, the always-on event ring that the elastic data plane
records its joins, leaves and reshards into.  Tracing, the metrics
exporters, timelines, the fleet aggregator and the SLO engine are not
ported yet (ROADMAP queue item 8).

Imports nothing of a device runtime.
"""
from __future__ import annotations

from . import flight_recorder  # noqa: F401
from .flight_recorder import (  # noqa: F401
    FlightRecorder, Watchdog, compile_log, flight_dump, flight_enabled,
    flight_record)

__all__ = ["flight_recorder", "FlightRecorder", "Watchdog", "flight_record",
           "flight_dump", "flight_enabled", "compile_log"]

# honour PADDLE_FLIGHT (full mode installs the dump triggers)
flight_recorder.enable_from_env()
