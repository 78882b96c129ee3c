"""The program's own spans (``flux2_tpu_torch/utils/profiler.py``) for the
metric readers: those of one name inside the traced window, and the part of
the device's idle time that falls inside them.

The program records its spans while a ``torch.profiler`` runs, so over a
``--trace 1`` run's traced window, on the host's ``perf_counter`` clock:
the clock onto which ``benchmark/trace.py`` shifts the device's ops, so a
span and an idle gap compare directly. A run without a trace, or a program
that files no spans, gives none, and each reader then returns None.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence, Tuple

Interval = Tuple[float, float]


def program_spans(run, name: str) -> list:
    """The program's spans called ``name`` that ended inside the traced
    window [run.t0, run.t1], oldest first; [] without a trace or a recorder."""
    if run.trace is None:
        return []
    from flux2_tpu_torch.utils import profiler

    get = getattr(profiler.shared(), "spans", None)
    if get is None:
        return []
    return [s for s in get(name) if run.t0 <= s.end <= run.t1]


def mean_ms(spans: Sequence) -> Optional[float]:
    return 1000.0 * sum(s.end - s.start for s in spans) / len(spans) if spans else None


def union(intervals: Iterable[Interval]) -> List[Interval]:
    """The intervals merged: sorted and disjoint."""
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def intersect(xs: Sequence[Interval], ys: Sequence[Interval]) -> List[Interval]:
    """The overlap of two sorted, disjoint interval lists."""
    out, i, j = [], 0, 0
    while i < len(xs) and j < len(ys):
        a, b = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        if b > a:
            out.append((a, b))
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return out


def subtract(xs: Sequence[Interval], ys: Sequence[Interval]) -> List[Interval]:
    """The parts of sorted, disjoint ``xs`` outside sorted, disjoint ``ys``."""
    out, j = [], 0
    for a, b in xs:
        while j < len(ys) and ys[j][1] <= a:
            j += 1
        k = j
        while k < len(ys) and ys[k][0] < b:
            if ys[k][0] > a:
                out.append((a, ys[k][0]))
            a = max(a, ys[k][1])
            k += 1
        if b > a:
            out.append((a, b))
    return out


def length(intervals: Iterable[Interval]) -> float:
    return sum(b - a for a, b in intervals)


def idle_share(run, name: str) -> Optional[float]:
    """100 × the device's idle time inside the union of the window's ``name``
    spans, over the traced window; None without a trace or such spans."""
    spans = program_spans(run, name)
    if not spans:
        return None
    cover = union((s.start, s.end) for s in spans)
    return 100.0 * length(intersect(run.trace.idle_gaps(), cover)) / run.trace.window_s


def idle_split(trace, groups: Sequence[Tuple[str, Sequence]]) -> Dict[str, float]:
    """The trace's idle seconds by what the host was in: each moment goes to
    the first of ``groups`` ((label, spans), in order) whose spans hold it,
    the rest to "no span"."""
    left = trace.idle_gaps()
    out: Dict[str, float] = {}
    for label, spans in groups:
        cover = union((s.start, s.end) for s in spans)
        out[label] = length(intersect(left, cover))
        left = subtract(left, cover)
    out["no span"] = length(left)
    return out
