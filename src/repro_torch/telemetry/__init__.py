"""Telemetry of the port (``src/repro/telemetry`` ported): span tracing,
metrics, profiler capture.

Three layers, all off by default and near-free when off:

  * ``spans``     -- round-phase span tracer emitting Chrome trace-event
                     JSON (Perfetto-loadable); the global tracer instruments
                     the popstore round (``core.popstore``).  A copy of the
                     reference's module.
  * ``metrics``   -- Counter/Gauge/Histogram registry absorbing round
                     metrics rows, flushed to a crash-safe JSONL sink and an
                     optional Prometheus textfile.  A copy of the
                     reference's module.
  * ``torchprof`` -- opt-in ``torch.profiler`` capture of an exact round
                     window (``RoundProfiler.parse("A:B", out_dir)``), the
                     counterpart of the reference's ``jaxprof``.

See docs/telemetry.md for the span taxonomy and metric names.
"""
from repro_torch.telemetry.metrics import (
    COUNTER_KEYS,
    Counter,
    Gauge,
    Histogram,
    JsonlSink,
    Registry,
    read_jsonl,
    write_prometheus,
)
from repro_torch.telemetry.spans import (
    Tracer,
    close,
    configure,
    counter,
    enabled,
    flush,
    get_tracer,
    instant,
    load_trace,
    span,
    traced,
)
from repro_torch.telemetry.torchprof import RoundProfiler

__all__ = [
    "COUNTER_KEYS", "Counter", "Gauge", "Histogram", "JsonlSink", "Registry",
    "RoundProfiler", "Tracer", "close", "configure", "counter", "enabled",
    "flush", "get_tracer", "instant", "load_trace", "read_jsonl", "span",
    "traced", "write_prometheus",
]
