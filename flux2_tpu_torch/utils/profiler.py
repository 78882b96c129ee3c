"""Phase profiler and span recorder: timers, step stats, Chrome-trace export,
and a ``torch.profiler`` region.

The port's copy of ``flux2_tpu/utils/profiler.py``: start/end phase timers
around the pipeline, per-step durations with an ETA, a boxed console report
with the bottleneck, and Chrome Trace JSON (Perfetto). ``shared()`` is the
process's one recorder; ``FLUX2_PROFILE=1`` enables it.

Spans. ``span(name, **attrs)`` times a block; ``record(name, start, end,
**attrs)`` files an interval whose two ends were read elsewhere, on another
thread too. A span holds its name, its start and end in absolute
``time.perf_counter()`` seconds (the host clock onto which
``benchmark/trace.py`` shifts the device's ops, so a span and a device idle
gap compare directly), the thread it ran on, and a few scalar attributes.
Phases are spans too, their starts kept per thread, so two threads in one
phase keep their own. Every span goes into one ring of the last ``RING``
(``spans()`` reads it); only phases enter the report's totals and its
bottleneck. The Chrome export writes the ring, threads numbered from 0 in
the order they appear there.

A profiler records while ``enabled`` or while a ``torch.profiler`` runs in
the process: ``torch.autograd.profiler._is_profiler_enabled`` is a module
global, true on every thread between the profiler's start and stop (the
profiler's own flag, ``torch._C._autograd._profiler_enabled()``, is per
thread; a torch without it leaves ``FLUX2_PROFILE=1`` alone). The check is
made when a span opens (``record``: when it is filed); off, a span takes no
lock and makes no span object, and costs the call with its keywords, the
check and a shared null context.

``torch_trace`` takes the place of JAX's ``jax_trace``: a region under
``torch.profiler`` (the card's kernels too, when CUDA is up) written as a
Chrome trace.
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import threading
import time
import types
from typing import Deque, Dict, Iterator, List, Mapping, NamedTuple, Optional, Tuple

from torch.autograd import profiler as _autograd_profiler

RING = 1 << 16  # spans kept: hours of served images at ~10 spans an image


class Span(NamedTuple):
    name: str
    start: float  # s, time.perf_counter()
    end: float
    thread: int  # threading.get_ident() of the thread that filed it
    attrs: Mapping[str, object]


class _Open:
    """A span being timed: filed on exit."""

    __slots__ = ("_prof", "_name", "_attrs", "_start")

    def __init__(self, prof: "PhaseProfiler", name: str, attrs: dict):
        self._prof, self._name, self._attrs = prof, name, attrs

    def __enter__(self) -> "_Open":
        self._start = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        self._prof._file(self._name, self._start, time.perf_counter(), self._attrs)
        return False


def _flag_holder(module) -> object:
    """``module`` if it holds ``_is_profiler_enabled``, else a stand-in whose
    flag is always false: a torch without that private global records under
    ``FLUX2_PROFILE=1`` alone, and its hot paths do not raise."""
    if hasattr(module, "_is_profiler_enabled"):
        return module
    return types.SimpleNamespace(_is_profiler_enabled=False)


_torch_profiler = _flag_holder(_autograd_profiler)
_OFF = contextlib.nullcontext()
_NO_ATTRS: Mapping[str, object] = {}


class PhaseProfiler:
    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self._open: Dict[Tuple[int, str], float] = {}  # (thread, phase) -> start
        self._ring: Deque[Span] = collections.deque(maxlen=RING)
        self._phases: Dict[str, float] = {}
        self._n_steps = 0
        self._step_sum = 0.0
        self._lock = threading.Lock()
        self._t0 = time.perf_counter()

    def _file(self, name: str, start: float, end: float, attrs: Mapping[str, object], phase: bool = False) -> None:
        span = Span(name, start, end, threading.get_ident(), attrs)
        with self._lock:
            self._ring.append(span)
            if phase:
                self._phases[name] = self._phases.get(name, 0.0) + (end - start)

    # -- spans ---------------------------------------------------------------

    def span(self, name: str, **attrs):
        """``with prof.span("dit.step", step=i):`` times the block, when on."""
        if not (self.enabled or _torch_profiler._is_profiler_enabled):
            return _OFF
        return _Open(self, name, attrs)

    def record(self, name: str, start: float, end: float, **attrs) -> None:
        """Files [start, end] (``time.perf_counter()`` seconds), when on."""
        if self.enabled or _torch_profiler._is_profiler_enabled:
            self._file(name, start, end, attrs)

    def spans(self, name: Optional[str] = None) -> List[Span]:
        """The ring's spans, oldest first; only those called ``name`` if given."""
        with self._lock:
            return [s for s in self._ring if name is None or s.name == name]

    # -- phases ------------------------------------------------------------

    def start(self, phase: str) -> None:
        if not (self.enabled or _torch_profiler._is_profiler_enabled):
            return
        key = (threading.get_ident(), phase)
        with self._lock:
            self._open[key] = time.perf_counter()

    def end(self, phase: str) -> None:
        if not (self.enabled or self._open):  # a phase opened while on closes after
            return
        now = time.perf_counter()
        with self._lock:
            t0 = self._open.pop((threading.get_ident(), phase), None)
        if t0 is not None:
            self._file(phase, t0, now, _NO_ATTRS, phase=True)

    @contextlib.contextmanager
    def phase(self, name: str) -> Iterator[None]:
        self.start(name)
        try:
            yield
        finally:
            self.end(name)

    # -- steps ---------------------------------------------------------------

    def record_step(self, duration_s: float) -> None:
        if self.enabled or _torch_profiler._is_profiler_enabled:
            with self._lock:
                self._n_steps += 1
                self._step_sum += duration_s

    def eta(self, remaining_steps: int) -> Optional[float]:
        if not self._n_steps:
            return None
        return remaining_steps * (self._step_sum / self._n_steps)

    # -- reports -------------------------------------------------------------

    def report(self) -> str:
        """Boxed console report: phase timings with % and the bottleneck."""
        phases = self.phases
        total = sum(phases.values()) or 1e-9
        lines = ["┌─ flux2-tpu profile " + "─" * 40]
        for phase, dur in sorted(phases.items(), key=lambda kv: -kv[1]):
            lines.append(f"│ {phase:<38} {dur:8.3f}s {100 * dur / total:5.1f}%")
        if self._n_steps:
            avg = self._step_sum / self._n_steps
            lines.append(f"│ steps: {self._n_steps}  avg {avg:.3f}s/step  ({1 / avg:.2f} steps/s)")
        if phases:
            worst = max(phases, key=phases.get)
            lines.append(f"│ bottleneck: {worst} ({100 * phases[worst] / total:.0f}% of profiled time)")
        lines.append("└" + "─" * 59)
        return "\n".join(lines)

    def export_chrome_trace(self, path: str) -> None:
        """Perfetto-loadable Chrome Trace JSON of the ring's spans."""
        tids: Dict[int, int] = {}
        events = []
        for s in self.spans():
            e = {"name": s.name, "ph": "X", "ts": (s.start - self._t0) * 1e6, "dur": (s.end - s.start) * 1e6,
                 "pid": 0, "tid": tids.setdefault(s.thread, len(tids))}
            if s.attrs:
                e["args"] = dict(s.attrs)
            events.append(e)
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as f:
            json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, f)

    @property
    def phases(self) -> Dict[str, float]:
        with self._lock:
            return dict(self._phases)


@contextlib.contextmanager
def torch_trace(path: str) -> Iterator[None]:
    """Run a region under ``torch.profiler`` (CPU ops, and the card's kernels
    when CUDA is available) and write it to ``path`` as a Chrome trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    with profile(activities=activities) as prof:
        yield
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    prof.export_chrome_trace(path)


_shared: Optional[PhaseProfiler] = None


def shared() -> PhaseProfiler:
    global _shared
    if _shared is None:
        _shared = PhaseProfiler(enabled=os.environ.get("FLUX2_PROFILE", "0") == "1")
    return _shared
