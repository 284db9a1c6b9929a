"""Round-phase span tracing: Chrome trace-event JSON, near-zero when off.

A copy of ``src/repro/telemetry/spans.py`` (standard library only), so the
port emits the same events under the same names without importing the
reference.

The five load-bearing runtime paths (the scan round driver, the popstore
prefetch ring, the async staleness engine, the watchdog/rollback loop, the
hot-swap server) emit their phase breakdown through ONE global ``Tracer``:

    from repro_torch.telemetry import spans
    with spans.span("round/dispatch"):
        state, metrics = step_fn(state, batch)
    spans.instant("watchdog/rollback", {"to_round": 3})
    spans.counter("popstore/ring_hit", hits)

Design constraints, in order:

  * DISABLED is the default and must cost nothing measurable per call:
    ``span()`` on a disabled tracer is one attribute test and returns a
    shared singleton whose ``__enter__``/``__exit__`` allocate nothing
    (fixed-arity ``__exit__`` -- a ``*args`` signature would allocate a
    tuple per call; tests/test_telemetry.py pins zero allocations per
    disabled span).  Instrumented library code (``core.popstore``,
    ``launch.serve``) therefore calls the tracer unconditionally.

  * Timestamps are MONOTONIC (``time.perf_counter_ns``) -- wall-clock
    ``time.time`` steps under NTP adjustment and can negate a duration.
    Events record microseconds relative to the tracer's start, which is
    what the trace-event format's ``ts`` field wants anyway.

  * Thread-safe: events append to a ``collections.deque`` (atomic under
    the GIL, no lock on the hot path); per-thread ``tid`` keeps the serve
    thread's spans on their own Perfetto track.  ``flush``/``close`` take
    a lock only around draining and file IO.

  * CRASH-TOLERANT output: the trace file is the Chrome trace-event JSON
    *array* format, appended incrementally on every ``flush()``.  The
    closing ``]`` is only written by ``close()``, but the format is
    specified so that a missing terminator is legal -- Perfetto and
    chrome://tracing both load a truncated trace, so a killed run keeps
    every span flushed before the crash.

Span names are ``path/phase`` (taxonomy in docs/telemetry.md).  ``ph`` codes
emitted: ``X`` (complete span), ``i`` (instant), ``C`` (counter).
"""
from __future__ import annotations

import functools
import json
import os
import pathlib
import threading
import time
from collections import deque
from typing import Any, Optional


class _NullSpan:
    """Shared no-op context manager returned by every disabled ``span()``.

    ``__exit__`` takes the three exception operands POSITIONALLY: a
    ``*args`` signature would build a tuple per call, and the whole point
    of this object is that the disabled path allocates nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False


_NULL_SPAN = _NullSpan()


class _Span:
    """One live span on an ENABLED tracer; records on ``__exit__``."""

    __slots__ = ("_tracer", "_name", "_args", "_t0")

    def __init__(self, tracer: "Tracer", name: str, args):
        self._tracer = tracer
        self._name = name
        self._args = args

    def __enter__(self):
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, exc_type, exc, tb):
        t1 = time.perf_counter_ns()
        # ("X", name, start_ns, dur_ns, tid, args) -- rendered at flush
        self._tracer._events.append(
            ("X", self._name, self._t0, t1 - self._t0,
             threading.get_ident(), self._args))
        return False


class Tracer:
    """Buffering trace-event recorder.  One global instance (``get_tracer``)
    serves the whole process; tests construct private ones."""

    def __init__(self):
        self.enabled = False
        self._events: deque = deque()
        self._lock = threading.Lock()
        self._t0_ns = time.perf_counter_ns()
        self._pid = os.getpid()
        self._path: Optional[pathlib.Path] = None
        self._file = None
        self._wrote_any = False

    # -- configuration ----------------------------------------------------

    def configure(self, *, enabled: bool = True,
                  trace_out: str | os.PathLike | None = None) -> "Tracer":
        """Enable/disable recording and (re)target the output file.  A new
        ``trace_out`` closes any previous file and starts a fresh array."""
        if trace_out is not None:
            new = pathlib.Path(trace_out)
            with self._lock:
                if self._path != new:
                    self._close_file_locked()
                    self._path = new
        self.enabled = bool(enabled)
        return self

    # -- recording (hot path) ---------------------------------------------

    def span(self, name: str, args: Optional[dict] = None):
        """Context manager timing a phase.  Disabled: returns the shared
        no-op singleton (zero allocations)."""
        if not self.enabled:
            return _NULL_SPAN
        return _Span(self, name, args)

    def instant(self, name: str, args: Optional[dict] = None) -> None:
        """Point event (watchdog strike, rollback, hot swap)."""
        if not self.enabled:
            return
        self._events.append(("i", name, time.perf_counter_ns(), 0,
                             threading.get_ident(), args))

    def counter(self, name: str, value) -> None:
        """Counter track sample (prefetch-ring hits/misses).  ``value`` may
        be a number or a {series: number} dict for stacked counters."""
        if not self.enabled:
            return
        self._events.append(("C", name, time.perf_counter_ns(), 0,
                             threading.get_ident(), value))

    def traced(self, name: Optional[str] = None):
        """Decorator form: ``@tracer.traced("serve/query")``."""

        def deco(fn):
            label = name or fn.__qualname__

            @functools.wraps(fn)
            def wrapper(*a, **kw):
                if not self.enabled:
                    return fn(*a, **kw)
                with self.span(label):
                    return fn(*a, **kw)

            return wrapper

        return deco

    # -- rendering / IO ----------------------------------------------------

    def _render(self, ev) -> dict:
        ph, name, t_ns, dur_ns, tid, args = ev
        out = {"ph": ph, "name": name, "pid": self._pid, "tid": tid,
               "ts": (t_ns - self._t0_ns) / 1e3}
        if ph == "X":
            out["dur"] = dur_ns / 1e3
            if args:
                out["args"] = args
        elif ph == "i":
            out["s"] = "t"  # thread-scoped instant
            if args:
                out["args"] = args
        elif ph == "C":
            out["args"] = args if isinstance(args, dict) else {"value": args}
        return out

    def drain(self) -> list[dict]:
        """Pop and render every buffered event (no file IO) -- the in-memory
        consumer tests and ad-hoc callers use this."""
        out = []
        while True:
            try:
                out.append(self._render(self._events.popleft()))
            except IndexError:
                return out

    def flush(self) -> None:
        """Append buffered events to ``trace_out`` (no-op without a path).
        Every flushed event survives a later crash: the array format needs
        no terminator to parse."""
        events = self.drain()
        if not events:
            return
        with self._lock:
            if self._path is None:
                # no sink configured: drop (recording without an output file
                # is only useful through ``drain``)
                return
            if self._file is None:
                self._path.parent.mkdir(parents=True, exist_ok=True)
                self._file = open(self._path, "w")
                self._file.write("[\n")
            f = self._file
            for ev in events:
                if self._wrote_any:
                    f.write(",\n")
                f.write(json.dumps(ev))
                self._wrote_any = True
            f.flush()

    def _close_file_locked(self):
        if self._file is not None:
            if self._wrote_any:
                self._file.write("\n]\n")
            else:
                self._file.write("]\n")
            self._file.close()
            self._file = None
            self._wrote_any = False

    def close(self) -> Optional[str]:
        """Flush, terminate the JSON array, close the file.  Returns the
        trace path (if any) so launchers can print it.  The tracer stays
        usable: the next flush starts a new file at the same path."""
        self.flush()
        with self._lock:
            path = str(self._path) if self._path else None
            wrote = self._file is not None
            self._close_file_locked()
        return path if wrote else None


# -- the process-global tracer the instrumented paths share -----------------

_GLOBAL = Tracer()


def get_tracer() -> Tracer:
    return _GLOBAL


def configure(*, enabled: bool = True,
              trace_out: str | os.PathLike | None = None) -> Tracer:
    return _GLOBAL.configure(enabled=enabled, trace_out=trace_out)


def enabled() -> bool:
    return _GLOBAL.enabled


def span(name: str, args: Optional[dict] = None):
    return _GLOBAL.span(name, args)


def instant(name: str, args: Optional[dict] = None) -> None:
    _GLOBAL.instant(name, args)


def counter(name: str, value: Any) -> None:
    _GLOBAL.counter(name, value)


def traced(name: Optional[str] = None):
    return _GLOBAL.traced(name)


def flush() -> None:
    _GLOBAL.flush()


def close() -> Optional[str]:
    return _GLOBAL.close()


def load_trace(path: str | os.PathLike) -> list[dict]:
    """Parse a trace file, tolerating a crash-truncated tail: a missing
    closing ``]`` (and a partial final line) is legal per the trace-event
    array format, so recover every complete event instead of raising."""
    text = pathlib.Path(path).read_text()
    try:
        return json.loads(text)
    except json.JSONDecodeError:
        pass
    body = text.strip()
    if body.startswith("["):
        body = body[1:]
    events = []
    for line in body.splitlines():
        line = line.strip().rstrip(",")
        if not line or line == "]":
            continue
        try:
            events.append(json.loads(line))
        except json.JSONDecodeError:
            continue  # the torn final line of a crashed run
    return events
