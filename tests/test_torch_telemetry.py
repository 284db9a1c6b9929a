"""The telemetry of the port (``repro_torch.telemetry``) against the
reference's (tests/test_telemetry.py's tests that need no launcher).

``spans`` and ``metrics`` are copies of the reference's standard-library
modules: the same event schema (Chrome trace-event JSON), the no-op
singleton when tracing is off, and the same bytes from the JSONL sink and
the Prometheus textfile for the same registry.  ``RoundProfiler`` is the
``torch.profiler`` counterpart of the reference's ``jaxprof`` and captures
exactly its round window (on the CPU here)."""
import json
import sys
import threading

import pytest
import torch

from repro import telemetry as ref_tel
from repro_torch import telemetry as tel
from repro_torch.telemetry.spans import _NULL_SPAN, Tracer, load_trace


# -- spans -------------------------------------------------------------------


def test_span_nesting_and_chrome_trace_json(tmp_path):
    path = tmp_path / "trace.json"
    tr = Tracer().configure(enabled=True, trace_out=path)
    with tr.span("outer", {"round": 1}):
        with tr.span("inner"):
            pass
        tr.instant("mark", {"k": 3})
    tr.counter("ring", {"hit": 2, "miss": 1})
    tr.flush()
    assert tr.close() == str(path)

    events = json.loads(path.read_text())  # closed: a plain JSON array
    by_name = {e["name"]: e for e in events}
    assert set(by_name) == {"outer", "inner", "mark", "ring"}
    outer, inner = by_name["outer"], by_name["inner"]
    assert outer["ph"] == inner["ph"] == "X"
    assert outer["args"] == {"round": 1}
    # spans record on exit: the inner event precedes the outer one
    assert events.index(inner) < events.index(outer)
    assert outer["ts"] <= inner["ts"]
    assert inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"] + 1e-3
    assert all(e["pid"] == outer["pid"] for e in events)
    mark = by_name["mark"]
    assert (mark["ph"], mark["s"]) == ("i", "t") and mark["args"] == {"k": 3}
    ring = by_name["ring"]
    assert ring["ph"] == "C" and ring["args"] == {"hit": 2, "miss": 1}


def test_event_schema_equals_reference():
    """The same calls give events with the same keys and values, the
    clock-dependent ones (ts, dur, pid, tid) aside."""
    got, want = Tracer().configure(enabled=True), ref_tel.Tracer().configure(enabled=True)
    for t in (got, want):
        with t.span("popstore/device_round", {"round": 3}):
            t.instant("watchdog/rollback", {"to_round": 2})
        t.counter("popstore/ring", {"hit": 1, "miss": 0})
        t.counter("hits", 7)
    clock = ("ts", "dur", "pid", "tid")
    strip = lambda evs: [{k: v for k, v in e.items() if k not in clock} for e in evs]  # noqa: E731
    g, w = got.drain(), want.drain()
    assert strip(g) == strip(w)
    assert [sorted(e) for e in g] == [sorted(e) for e in w]


def test_scalar_counter_and_traced_decorator():
    tr = Tracer().configure(enabled=True)
    tr.counter("hits", 7)

    @tr.traced("work/fn")
    def fn(x):
        return x + 1

    assert fn(1) == 2
    events = tr.drain()
    assert {"ph": "C", "args": {"value": 7}}.items() <= events[0].items()
    assert events[1]["name"] == "work/fn" and events[1]["ph"] == "X"
    tr.configure(enabled=False)
    assert fn(2) == 3  # the decorator bypasses the span when disabled
    assert tr.drain() == []


def test_disabled_tracer_is_allocation_free():
    tr = Tracer()  # enabled=False
    assert tr.span("x") is _NULL_SPAN
    assert tr.span("y", {"a": 1}) is _NULL_SPAN

    def burn(n):
        for _ in range(n):
            with tr.span("hot/phase", None):
                pass
            tr.instant("i")
            tr.counter("c", 1)

    def blocks(n):
        burn(64)
        before = sys.getallocatedblocks()
        burn(n)
        return sys.getallocatedblocks() - before

    small, large = blocks(100), blocks(20_000)
    assert large - small < 64, (small, large)


def test_tracer_threads_get_own_tid():
    tr = Tracer().configure(enabled=True)

    def work():
        with tr.span("t/span"):
            pass

    th = threading.Thread(target=work)
    th.start()
    th.join()
    with tr.span("main/span"):
        pass
    assert len({e["tid"] for e in tr.drain()}) == 2


def test_load_trace_recovers_crash_truncated_file(tmp_path):
    path = tmp_path / "trace.json"
    tr = Tracer().configure(enabled=True, trace_out=path)
    for i in range(3):
        with tr.span(f"s{i}"):
            pass
    tr.flush()  # no close(): a killed run (no closing "]")
    text = path.read_text()
    assert not text.rstrip().endswith("]")
    with pytest.raises(json.JSONDecodeError):
        json.loads(text)
    assert [e["name"] for e in load_trace(path)] == ["s0", "s1", "s2"]
    path.write_text(text[: len(text) - 7])  # a torn final line on top
    assert [e["name"] for e in load_trace(path)] == ["s0", "s1"]
    tr.close()
    # and the reference's loader reads the port's trace the same way
    assert ref_tel.load_trace(path) == load_trace(path)


# -- registry ----------------------------------------------------------------


def test_registry_kinds_and_absorb():
    reg = tel.Registry()
    reg.counter("n").inc(2)
    reg.counter("n").inc(3)
    assert reg.counter("n").value == 5
    with pytest.raises(ValueError):
        reg.counter("n").inc(-1)
    with pytest.raises(TypeError):
        reg.gauge("n")  # kind collision is loud

    reg.absorb({"server_loss": 2.0, "faults_injected": 3, "note": "text"})
    reg.absorb({"server_loss": 4.0, "faults_injected": 1})
    snap = reg.snapshot()
    assert snap["faults_injected"] == 4.0
    assert snap["server_loss"] == 4.0
    h = snap["server_loss_hist"]
    assert (h["count"], h["sum"], h["min"], h["max"]) == (2, 6.0, 2.0, 4.0)
    assert "note" not in snap
    reg.absorb({"faults_injected": 99.0, "server_loss": 1.0}, counters=())
    assert reg.snapshot()["faults_injected"] == 4.0
    assert tel.COUNTER_KEYS == ref_tel.COUNTER_KEYS


def _fill(mod):
    reg = mod.Registry()
    reg.counter("serve/tokens").inc(128)
    reg.gauge("eta_scale").set(0.5)
    h = reg.histogram("swap_latency_s")
    h.observe(0.1)
    h.observe(0.3)
    for row in ({"server_loss": 2.5, "faults_injected": 3, "lam_sum_norm": 1e-6},
                {"server_loss": 1.25, "faults_injected": 1, "faults_demoted": 2}):
        reg.absorb(row)
    return reg


def test_sinks_write_the_reference_bytes(tmp_path):
    """The same registry and rows give the reference's bytes: the
    Prometheus textfile and the JSONL rows (snapshot and summary)."""
    got, want = _fill(tel), _fill(ref_tel)
    assert got.snapshot() == want.snapshot()
    tel.write_prometheus(got, tmp_path / "port.prom")
    ref_tel.write_prometheus(want, tmp_path / "ref.prom")
    assert (tmp_path / "port.prom").read_bytes() == (tmp_path / "ref.prom").read_bytes()
    rows = [{"kind": "round", "round": 1, "server_loss": 2.5},
            {"kind": "summary", **got.snapshot()}]
    with tel.JsonlSink(tmp_path / "port.jsonl") as sink:
        for row in rows:
            sink.write(row)
    with ref_tel.JsonlSink(tmp_path / "ref.jsonl") as sink:
        for row in [{"kind": "round", "round": 1, "server_loss": 2.5},
                    {"kind": "summary", **want.snapshot()}]:
            sink.write(row)
    assert (tmp_path / "port.jsonl").read_bytes() == (tmp_path / "ref.jsonl").read_bytes()
    assert tel.read_jsonl(tmp_path / "port.jsonl") == ref_tel.read_jsonl(tmp_path / "ref.jsonl")


# -- sinks -------------------------------------------------------------------


def test_jsonl_sink_torn_tail_tolerated_midfile_corruption_raises(tmp_path):
    path = tmp_path / "m.jsonl"
    with tel.JsonlSink(path) as sink:
        sink.write({"a": 1})
        sink.write({"a": 2})
    with open(path, "a") as f:
        f.write('{"a": 3, "tor')  # crash mid-row
    assert [r["a"] for r in tel.read_jsonl(path)] == [1, 2]
    bad = tmp_path / "bad.jsonl"
    bad.write_text('{"a": 1}\n{torn}\n{"a": 3}\n')
    with pytest.raises(json.JSONDecodeError):
        tel.read_jsonl(bad)


def test_prometheus_textfile_format(tmp_path):
    reg = tel.Registry()
    reg.counter("serve/tokens").inc(128)
    reg.gauge("eta_scale").set(0.5)
    h = reg.histogram("swap_latency_s")
    h.observe(0.1)
    h.observe(0.3)
    out = tmp_path / "metrics.prom"
    assert tel.write_prometheus(reg, out) == str(out)
    text = out.read_text()
    lines = text.splitlines()
    assert "# TYPE repro_serve_tokens_total counter" in lines
    assert "repro_serve_tokens_total 128.0" in lines
    assert "repro_eta_scale 0.5" in lines
    assert "repro_swap_latency_s_count 2.0" in lines
    assert any(ln.startswith("repro_swap_latency_s_mean 0.2") for ln in lines)
    assert text.endswith("\n")
    for ln in lines:
        if ln.startswith("#"):
            continue
        name, val = ln.split(" ")
        assert tel.metrics._NAME_OK.match(name), name
        float(val)
    assert not out.with_suffix(out.suffix + ".tmp").exists()


# -- the profiler window -----------------------------------------------------


@pytest.mark.parametrize("spec,want", [("1:2", (1, 2)), ("3", (3, 3))])
def test_round_profiler_parse(spec, want, tmp_path):
    p = tel.RoundProfiler.parse(spec, tmp_path)
    assert (p.start, p.stop) == want
    assert tel.RoundProfiler.parse(None, tmp_path) is None
    assert tel.RoundProfiler.parse("", tmp_path) is None


@pytest.mark.parametrize("spec", ["a:b", "1:2:3", "3:1", "-1:2"])
def test_round_profiler_parse_refuses(spec, tmp_path):
    with pytest.raises(ValueError):
        tel.RoundProfiler.parse(spec, tmp_path)


def test_round_profiler_captures_exactly_its_window(tmp_path):
    """Rounds 0-4, each under a labelled range; the window 1:2 holds rounds
    1 and 2 and no other, as one Chrome trace."""
    prof = tel.RoundProfiler.parse("1:2", tmp_path / "prof")
    x = torch.ones(64, 64)
    for r in range(5):
        prof.before_round(r)
        with torch.profiler.record_function(f"round_{r}"):
            x = x @ x * 1e-2
        prof.after_round(r)
    prof.close()
    assert prof.captured and not prof.active
    events = json.loads(open(prof.trace_path).read())
    events = events["traceEvents"] if isinstance(events, dict) else events
    names = {e.get("name") for e in events}
    assert {"round_1", "round_2"} <= names
    assert not names & {"round_0", "round_3", "round_4"}
    # a second window never opens: the capture is one-shot
    prof.before_round(1)
    assert not prof.active
