"""Phase profiler: timers, step stats, Chrome-trace export, and a
``torch.profiler`` region.

The port's copy of ``flux2_tpu/utils/profiler.py``: start/end phase timers
around the pipeline, per-step durations with an ETA, a boxed console report
with the bottleneck, and Chrome Trace JSON of the phases (Perfetto). Zero cost
when disabled; ``shared()`` is enabled by ``FLUX2_PROFILE=1``.

``torch_trace`` takes the place of JAX's ``jax_trace``: a region under
``torch.profiler`` (the card's kernels too, when CUDA is up) written as a
Chrome trace.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from typing import Dict, Iterator, List, Optional


class PhaseProfiler:
    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self._open: Dict[str, float] = {}
        self._events: List[dict] = []  # chrome trace events
        self._phases: Dict[str, float] = {}
        self._steps: List[float] = []
        self._lock = threading.Lock()
        self._t0 = time.perf_counter()

    # -- phases ------------------------------------------------------------

    def start(self, phase: str) -> None:
        if not self.enabled:
            return
        with self._lock:
            self._open[phase] = time.perf_counter()

    def end(self, phase: str) -> None:
        if not self.enabled:
            return
        now = time.perf_counter()
        with self._lock:
            t0 = self._open.pop(phase, None)
            if t0 is None:
                return
            dur = now - t0
            self._phases[phase] = self._phases.get(phase, 0.0) + dur
            self._events.append(
                {"name": phase, "ph": "X", "ts": (t0 - self._t0) * 1e6, "dur": dur * 1e6, "pid": 0, "tid": 0}
            )

    @contextlib.contextmanager
    def phase(self, name: str) -> Iterator[None]:
        self.start(name)
        try:
            yield
        finally:
            self.end(name)

    # -- steps ---------------------------------------------------------------

    def record_step(self, duration_s: float) -> None:
        if self.enabled:
            with self._lock:
                self._steps.append(duration_s)

    def eta(self, remaining_steps: int) -> Optional[float]:
        if not self._steps:
            return None
        return remaining_steps * (sum(self._steps) / len(self._steps))

    # -- reports -------------------------------------------------------------

    def report(self) -> str:
        """Boxed console report: phase timings with % and the bottleneck."""
        total = sum(self._phases.values()) or 1e-9
        lines = ["┌─ flux2-tpu profile " + "─" * 40]
        for phase, dur in sorted(self._phases.items(), key=lambda kv: -kv[1]):
            lines.append(f"│ {phase:<38} {dur:8.3f}s {100 * dur / total:5.1f}%")
        if self._steps:
            avg = sum(self._steps) / len(self._steps)
            lines.append(f"│ steps: {len(self._steps)}  avg {avg:.3f}s/step  ({1 / avg:.2f} steps/s)")
        if self._phases:
            worst = max(self._phases, key=self._phases.get)
            lines.append(f"│ bottleneck: {worst} ({100 * self._phases[worst] / total:.0f}% of profiled time)")
        lines.append("└" + "─" * 59)
        return "\n".join(lines)

    def export_chrome_trace(self, path: str) -> None:
        """Perfetto-loadable Chrome Trace JSON of the phases."""
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as f:
            json.dump({"traceEvents": self._events, "displayTimeUnit": "ms"}, f)

    @property
    def phases(self) -> Dict[str, float]:
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
