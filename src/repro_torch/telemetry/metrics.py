"""Unified metrics registry with JSONL and Prometheus-textfile sinks.

A copy of ``src/repro/telemetry/metrics.py`` (standard library only): the
same metric kinds, the same JSONL rows and the same textfile bytes, without
importing the reference.

The round drivers already COMPUTE the paper's convergence signals -- the
eq.-(24)/(25) residual diagnostics (``lam_sum_norm``), ``server_loss``,
``client_drift``, the fault/staleness accounting -- but until now they died
in stdout.  ``Registry`` absorbs every logged metrics row and keeps three
metric kinds:

  * ``Counter``   -- monotonic totals (faults injected/demoted, stale
                     admitted/dropped, rollbacks, ring hits, checkpoint
                     bytes).  Round rows carry PER-ROUND counts; ``absorb``
                     sums them, so the registry total equals the launcher's
                     own accounting (tests pin this against
                     ``--expect-demotions``).
  * ``Gauge``     -- last-value signals (server_loss, lam_sum_norm,
                     cohort m_active, eta_scale).
  * ``Histogram`` -- distributions (swap latency, round wall time,
                     tokens/sec): count/sum/min/max, mean derived.

Sinks:

  * ``JsonlSink`` -- one JSON object per line, flushed per row, so a
    crashed run keeps every completed row and at worst tears the final
    line; ``read_jsonl`` tolerates exactly that torn tail.  The train
    launcher streams its ``history`` rows through this (loss curves used
    to live only in stdout).
  * ``write_prometheus`` -- the node-exporter *textfile collector* format
    for the serving path: counters get a ``_total`` suffix, histograms
    export ``_count``/``_sum``/``_min``/``_max``; the file is written
    atomically (tmp + rename) because the textfile collector may scrape
    mid-write.
"""
from __future__ import annotations

import json
import math
import os
import pathlib
import re
import threading
from typing import Any, Iterable

# Device-side round-metric keys with COUNTER semantics (per-round counts
# that sum over the run); everything else numeric in a round row is a gauge
# unless the caller asks for a histogram.
COUNTER_KEYS = frozenset({
    "faults_injected", "faults_demoted",
    "stale_admitted", "stale_dropped",
})


class Counter:
    __slots__ = ("name", "value")

    kind = "counter"

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError(f"counter {self.name}: negative increment "
                             f"{amount} (use a gauge)")
        self.value += amount

    def snapshot(self) -> float:
        return self.value


class Gauge:
    __slots__ = ("name", "value")

    kind = "gauge"

    def __init__(self, name: str):
        self.name = name
        self.value = math.nan

    def set(self, value: float) -> None:
        self.value = float(value)

    def snapshot(self) -> float:
        return self.value


class Histogram:
    """Streaming count/sum/min/max (mean derived).  No buckets: the
    consumers (bench cells, the serve summary) want the moments, and the
    Prometheus export stays a fixed four lines per metric."""

    __slots__ = ("name", "count", "total", "min", "max")

    kind = "histogram"

    def __init__(self, name: str):
        self.name = name
        self.count = 0
        self.total = 0.0
        self.min = math.inf
        self.max = -math.inf

    def observe(self, value: float) -> None:
        v = float(value)
        self.count += 1
        self.total += v
        self.min = min(self.min, v)
        self.max = max(self.max, v)

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else math.nan

    def snapshot(self) -> dict:
        return {"count": self.count, "sum": self.total,
                "min": self.min if self.count else None,
                "max": self.max if self.count else None,
                "mean": self.mean if self.count else None}


class Registry:
    """Get-or-create registry of named metrics.  Thread-safe creation (the
    serve watcher observes from its own thread); mutation of a single
    metric is GIL-atomic float arithmetic."""

    def __init__(self):
        self._metrics: dict[str, Any] = {}
        self._lock = threading.Lock()

    def _get(self, name: str, cls):
        m = self._metrics.get(name)
        if m is None:
            with self._lock:
                m = self._metrics.get(name)
                if m is None:
                    m = self._metrics[name] = cls(name)
        if not isinstance(m, cls):
            raise TypeError(
                f"metric {name!r} already registered as {m.kind}, "
                f"requested {cls.kind}")
        return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str) -> Histogram:
        return self._get(name, Histogram)

    def absorb(self, row: dict, *, counters: Iterable[str] = COUNTER_KEYS,
               prefix: str = "") -> None:
        """Fold one logged metrics row in: keys named in ``counters`` sum
        into Counters, every other scalar sets a Gauge AND feeds a same-name
        ``<key>_hist`` Histogram so both the trajectory endpoint and the
        distribution survive.  Non-numeric values are skipped.  Keys with
        GLOBAL counter semantics (``COUNTER_KEYS``) that this call was told
        not to count (``counters=()``: the caller accumulates them from a
        more complete stream) are skipped entirely -- registering them as
        gauges would collide with the counter of the same name."""
        counters = set(counters)
        for key, val in row.items():
            try:
                v = float(val)
            except (TypeError, ValueError):
                continue
            name = prefix + key
            if key in counters:
                if math.isfinite(v):
                    self.counter(name).inc(v)
            elif key not in COUNTER_KEYS:
                self.gauge(name).set(v)
                if math.isfinite(v):
                    self.histogram(name + "_hist").observe(v)

    def snapshot(self) -> dict:
        """{name: value-or-histogram-dict} for every registered metric."""
        return {name: m.snapshot()
                for name, m in sorted(self._metrics.items())}

    def summary_row(self) -> dict:
        """The flat one-line form the JSONL sink and end-of-run prints use:
        histogram moments inline as ``name_count``/``name_mean``/etc."""
        out: dict[str, Any] = {}
        for name, m in sorted(self._metrics.items()):
            if isinstance(m, Histogram):
                snap = m.snapshot()
                for k in ("count", "mean", "min", "max", "sum"):
                    out[f"{name}_{k}"] = snap[k]
            else:
                out[name] = m.snapshot()
        return out


# -- JSONL sink -------------------------------------------------------------


class JsonlSink:
    """Append-only JSON-lines writer, one flush per row: a crash loses at
    most the torn final line, never an earlier row.  Values that json can't
    serialise (numpy scalars) are coerced via ``float`` as a fallback."""

    def __init__(self, path: str | os.PathLike):
        self.path = pathlib.Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._file = open(self.path, "a")
        self._lock = threading.Lock()
        self.rows_written = 0

    @staticmethod
    def _default(obj):
        try:
            return float(obj)
        except (TypeError, ValueError):
            return str(obj)

    def write(self, row: dict) -> None:
        line = json.dumps(row, default=self._default)
        with self._lock:
            self._file.write(line + "\n")
            self._file.flush()
            self.rows_written += 1

    def close(self) -> None:
        with self._lock:
            if not self._file.closed:
                self._file.close()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        self.close()
        return False


def read_jsonl(path: str | os.PathLike) -> list[dict]:
    """Read a JSONL file, tolerating a crash-torn FINAL line (dropped with
    no error).  A malformed line anywhere else raises -- that is corruption,
    not truncation, and silently skipping it would fake a clean run."""
    rows = []
    with open(path) as f:
        lines = f.readlines()
    for i, line in enumerate(lines):
        line = line.strip()
        if not line:
            continue
        try:
            rows.append(json.loads(line))
        except json.JSONDecodeError:
            if i == len(lines) - 1:
                break  # torn tail of a crashed writer
            raise
    return rows


# -- Prometheus textfile exporter -------------------------------------------

_NAME_OK = re.compile(r"[a-zA-Z_:][a-zA-Z0-9_:]*$")


def _prom_name(name: str) -> str:
    """Metric names like ``serve/swap_latency_s`` -> ``serve_swap_latency_s``
    (Prometheus names admit only [a-zA-Z0-9_:])."""
    out = re.sub(r"[^a-zA-Z0-9_:]", "_", name)
    if not _NAME_OK.match(out):
        out = "_" + out
    return out


def _prom_val(v) -> str:
    if v is None or (isinstance(v, float) and math.isnan(v)):
        return "NaN"
    if v == math.inf:
        return "+Inf"
    if v == -math.inf:
        return "-Inf"
    return repr(float(v))


def write_prometheus(registry: Registry, path: str | os.PathLike,
                     *, namespace: str = "repro") -> str:
    """Write the registry as a node-exporter textfile-collector file.
    Atomic (tmp + ``os.replace``): the collector may scrape mid-write, and
    a torn exposition file fails the whole scrape."""
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    lines: list[str] = []
    for name, m in sorted(registry._metrics.items()):
        base = _prom_name(f"{namespace}_{name}" if namespace else name)
        if isinstance(m, Counter):
            lines.append(f"# TYPE {base}_total counter")
            lines.append(f"{base}_total {_prom_val(m.value)}")
        elif isinstance(m, Gauge):
            lines.append(f"# TYPE {base} gauge")
            lines.append(f"{base} {_prom_val(m.value)}")
        else:  # Histogram moments as gauges (no buckets kept)
            snap = m.snapshot()
            lines.append(f"# TYPE {base}_count counter")
            lines.append(f"{base}_count {_prom_val(snap['count'])}")
            lines.append(f"# TYPE {base}_sum counter")
            lines.append(f"{base}_sum {_prom_val(snap['sum'])}")
            for stat in ("min", "max", "mean"):
                lines.append(f"# TYPE {base}_{stat} gauge")
                lines.append(f"{base}_{stat} {_prom_val(snap[stat])}")
    text = "\n".join(lines) + "\n"
    tmp = path.with_suffix(path.suffix + ".tmp")
    with open(tmp, "w") as f:
        f.write(text)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    return str(path)
