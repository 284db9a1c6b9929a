"""On-demand ``torch.profiler`` capture for a round window, the port's
counterpart of ``src/repro/telemetry/jaxprof.py``.

``RoundProfiler.parse("A:B", out_dir)`` captures exactly rounds A..B
(inclusive, 0-indexed round numbers as the launchers log them): the
profiler starts before round A's dispatch and stops after round B has
finished, so the capture holds whole rounds -- the host's ops, the CUDA
kernels and copies (CUPTI) where a card is present -- and is exported as a
Chrome trace (``rounds_A-B.trace.json`` in ``out_dir``), which Perfetto and
``chrome://tracing`` load.

Why a window and not the whole run: the profiler's overhead and its trace
grow with every event, so two or three steady-state rounds are what a
tuning session reads.  Zero cost when unset: ``parse(None, ...)`` returns
None and callers guard every call site on that.
"""
from __future__ import annotations

import os
import pathlib
import warnings
from typing import Optional


class RoundProfiler:
    """Start/stop ``torch.profiler`` around a [start, stop] round window.

    The caller calls ``before_round(r)`` ahead of each round and
    ``after_round(r)`` once the round's results are on the host; ``close``
    is the crash/early-exit backstop (a capture left open holds no
    trace)."""

    def __init__(self, start: int, stop: int, out_dir: str | os.PathLike):
        if start < 0 or stop < start:
            raise ValueError(
                f"--profile-rounds window must be 0 <= A <= B, got {start}:{stop}")
        self.start = start
        self.stop = stop
        self.out_dir = str(out_dir)
        self.active = False
        self.captured = False
        self.trace_path: Optional[str] = None
        self._prof = None

    @classmethod
    def parse(cls, spec: Optional[str],
              out_dir: str | os.PathLike) -> Optional["RoundProfiler"]:
        """``"A:B"`` -> profiler for rounds A..B; ``"A"`` -> just round A;
        None/"" -> None (profiling off)."""
        if not spec:
            return None
        parts = str(spec).split(":")
        try:
            if len(parts) == 1:
                a = b = int(parts[0])
            elif len(parts) == 2:
                a, b = int(parts[0]), int(parts[1])
            else:
                raise ValueError(spec)
        except ValueError:
            raise ValueError(
                f"--profile-rounds expects 'A:B' or 'A' (round numbers), "
                f"got {spec!r}") from None
        return cls(a, b, out_dir)

    def before_round(self, round_idx: int) -> None:
        if self.active or self.captured or round_idx < self.start:
            return
        if round_idx > self.stop:
            return  # window already passed (e.g. resumed beyond it)
        import torch
        from torch.profiler import ProfilerActivity, profile

        pathlib.Path(self.out_dir).mkdir(parents=True, exist_ok=True)
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        try:
            self._prof = profile(activities=acts)
            self._prof.__enter__()
        except Exception as e:  # profiler backend unavailable: degrade loudly
            warnings.warn(f"[telemetry] torch.profiler capture unavailable: {e}",
                          RuntimeWarning, stacklevel=2)
            self._prof = None
            self.captured = True
            return
        self.active = True
        print(f"[telemetry] torch.profiler capture started at round "
              f"{round_idx} -> {self.out_dir}", flush=True)

    def after_round(self, round_idx: int) -> None:
        if self.active and round_idx >= self.stop:
            self._stop()

    def _stop(self) -> None:
        import torch

        prof, self._prof = self._prof, None
        try:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            prof.__exit__(None, None, None)
            path = pathlib.Path(self.out_dir) / f"rounds_{self.start}-{self.stop}.trace.json"
            prof.export_chrome_trace(str(path))
        except Exception as e:
            warnings.warn(f"[telemetry] torch.profiler stop failed: {e}",
                          RuntimeWarning, stacklevel=2)
        else:
            self.trace_path = str(path)
            print(f"[telemetry] torch.profiler capture written to {path}", flush=True)
        self.active = False
        self.captured = True

    def close(self) -> None:
        if self.active:
            self._stop()
