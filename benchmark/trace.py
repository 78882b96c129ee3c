"""The device trace of a ``--trace 1`` run: ``torch.profiler`` over the
first ``TRACE_S`` seconds of the measured window, CUDA activity only, read
back from its Chrome trace. (The profiler's buffers hold a bounded number
of activities, and a 30 s trace lost its end.)

``DeviceTrace`` holds every kernel, copy and set of the traced window
(name, start and end in seconds on the host's ``perf_counter`` clock,
grid) and its bounds. The trace's clock is tied to the host's by a marker:
a ``torch.cuda._sleep`` kernel launched on the idle card at a known host
time, before the load starts.
"""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile
import time
from typing import List, Optional, Sequence, Tuple

import torch

MARKER = "spin_kernel"  # torch.cuda._sleep's kernel
TRACE_S = 12.0
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


@dataclasses.dataclass
class DeviceOp:
    name: str
    cat: str
    start: float  # s, host perf_counter clock
    end: float
    grid: Tuple[int, ...] = ()

    @property
    def dur(self) -> float:
        return self.end - self.start


@dataclasses.dataclass
class DeviceTrace:
    ops: List[DeviceOp]
    t0: float  # the traced window, host perf_counter clock
    t1: float

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    def kernels(self, name: str) -> List[DeviceOp]:
        """The launches of the kernel called ``name`` (its function's name)."""
        return [op for op in self.ops if op.cat == "kernel" and base_name(op.name) == name]

    def busy_intervals(self) -> List[Tuple[float, float]]:
        """The union of the ops' intervals inside the window, merged and sorted."""
        spans = sorted((max(op.start, self.t0), min(op.end, self.t1)) for op in self.ops)
        merged: List[List[float]] = []
        for a, b in spans:
            if b <= a:
                continue
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return [(a, b) for a, b in merged]

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals())

    def idle_percent(self) -> float:
        return 100.0 * (1.0 - self.busy_s() / self.window_s)

    def idle_gaps(self) -> List[Tuple[float, float]]:
        gaps, t = [], self.t0
        for a, b in self.busy_intervals():
            if a > t:
                gaps.append((t, a))
            t = max(t, b)
        if self.t1 > t:
            gaps.append((t, self.t1))
        return gaps


def base_name(name: str) -> str:
    """A kernel's function name without its return type, namespace,
    template arguments and parameter list, as the profiler demangles them."""
    name = name.replace("(anonymous namespace)", "").split("(")[0].split("<")[0]
    return name.split()[-1].split("::")[-1] if name.strip() else name


def _marker() -> float:
    """Launch the marker on the idle card; its host launch time."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    torch.cuda._sleep(1000)
    torch.cuda.synchronize()
    return t


class Tracer:
    """``start()`` on the idle card before the load starts, ``stop(t0, t1)``
    at the traced window's end; ``trace`` then holds the window [t0, t1]
    (None when tracing is off)."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.trace: Optional[DeviceTrace] = None
        self._prof = None

    def start(self) -> None:
        if not self.enabled:
            return
        self._prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
        self._prof.start()
        self._m0 = _marker()

    def stop(self, t0: float, t1: float) -> None:
        if self._prof is None:
            return
        times = [time.perf_counter()]
        self._prof.stop()
        times.append(time.perf_counter())
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            times.append(time.perf_counter())
            with open(path) as f:
                events = json.load(f)["traceEvents"]
            times.append(time.perf_counter())
        finally:
            os.unlink(path)
        self.read_s = [b - a for a, b in zip(times, times[1:])]  # stop, export, load
        self._prof = None
        self.trace = parse(events, self._m0, t0, t1)


def parse(events: Sequence[dict], marker_host: float, t0: float, t1: float) -> DeviceTrace:
    """Device ops of Chrome trace ``events`` on the host clock: the trace's
    microseconds are shifted so that the marker's start falls on its host
    launch time."""
    ops, marks = [], []
    for e in events:
        if e.get("ph") != "X" or e.get("cat", "").lower() not in DEVICE_CATS:
            continue
        if base_name(e["name"]) == MARKER:
            marks.append(e["ts"] * 1e-6)
            continue
        grid = tuple(e.get("args", {}).get("grid", ()))
        ops.append(DeviceOp(e["name"], e["cat"].lower(), e["ts"] * 1e-6, (e["ts"] + e.get("dur", 0.0)) * 1e-6, grid))
    if len(marks) != 1:
        raise RuntimeError(f"the device trace holds {len(marks)} markers, not 1: its device activity was not traced")
    shift = marker_host - marks[0]
    for op in ops:
        op.start += shift
        op.end += shift
    return DeviceTrace([op for op in ops if op.end > t0 and op.start < t1], t0, t1)
