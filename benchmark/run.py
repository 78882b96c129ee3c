"""Runs one cell of the benchmark once and prints its result line.

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. The cell (``BENCHMARK.json``) names a
configuration and a traffic mix; the run builds the configuration's models
from the seed on the card, warms up the shapes the traffic uses, measures
for ``--seconds``, checks a sample of what it served against the plain
reference, and prints one JSON line: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer metrics), ``device``, with ``--trace 1`` ``breakdown``, and last
``checks`` (each compared number with its limit, also the last lines on
standard error). No card, or fewer than the cell asks for: exit 2, no
result. A module of JAX or the JAX package loaded by the time the result
would be printed (after the window, the check and the metric readers):
exit 3, no result.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import types
from pathlib import Path
from typing import Dict, List, Optional

# a library the program uses must not load JAX on its own
for _k in ("USE_FLAX", "USE_JAX", "USE_TF"):
    os.environ.setdefault(_k, "0")

FORBIDDEN = ("jax", "jaxlib", "flax", "flux2_tpu")


def process_age_s() -> float:
    """Seconds since this process started (the kernel's start time)."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def log(msg: str) -> None:
    print(f"benchmark: {msg}", file=sys.stderr, flush=True)


def require_cards(n: int) -> None:
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < n:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"benchmark: this cell needs {n} CUDA card(s); found {found}. No result.", file=sys.stderr)
        sys.exit(2)


def card_info() -> dict:
    import torch

    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1}
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits", "-i", "0"],
                             capture_output=True, text=True, timeout=20).stdout.strip()
        info["power_limit_w"] = float(out.splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        info["power_limit_w"] = None
    return info


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def serve_window(cell, seed: int, seconds: float, trace: bool, device, quantization: Optional[str] = None) -> dict:
    """Builds the served pipeline, warms it up, runs the window; returns the
    window's record with the program's outputs for the check on the host,
    the program's state already freed."""
    import gc

    import torch

    from benchmark import check, serving
    from benchmark.trace import TRACE_S, Tracer
    from flux2_tpu_torch.serve import Flux2Server

    log(f"process age {process_age_s():.2f} s: building")
    t = time.perf_counter()
    pipe = cell.model.build_pipeline(cell.config, seed, device, quantization)
    log(f"weights drawn and loaded: {time.perf_counter() - t:.2f} s")
    keep = check.positions(cell.traffic, seed)
    recorder = serving.Recorder(pipe, [r for _, r in keep], device)
    server = Flux2Server(recorder, recorder.encode_prompt)
    t = time.perf_counter()
    serving.warm_up(pipe, server, cell.traffic)
    log(f"warm-up: {time.perf_counter() - t:.2f} s; process age {process_age_s():.2f} s")
    recorder.spans.clear()
    setup_peak = torch.cuda.max_memory_allocated() if device.type == "cuda" else 0
    tracer = Tracer(trace)
    marks: Dict[str, float] = {}

    def on_start():
        if device.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        tracer.start()
        marks["setup_s"] = process_age_s()

    def on_trace_end(tt0, tt1):
        marks["traced"] = (tt0, tt1)
        t = time.perf_counter()
        tracer.stop(tt0, tt1)
        log(f"trace of {tt1 - tt0:.2f} s read in {time.perf_counter() - t:.2f} s (stop, export, load: "
            f"{tracer.read_s}), {len(tracer.trace.ops)} device ops")

    win = serving.run_closed(server, cell.traffic, seed, seconds, on_start, TRACE_S, on_trace_end if trace else None,
                             need=max(i for i, _ in keep) + 1)
    # setup_s: process start to the window's start (the first completion in a closed loop)
    setup_s = marks["setup_s"] + (win["t0"] - win["started"])
    window_peak = torch.cuda.max_memory_allocated() if device.type == "cuda" else 0
    server.shutdown()
    served = check.take_served(recorder, keep, win["completions"])
    spans = list(recorder.spans)
    del pipe, recorder, server
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    rec = dict(win, window_all=win["window"], setup_s=setup_s, trace=tracer.trace, spans=spans, served=served,
               memory_peak_bytes=max(setup_peak, window_peak), window_peak_bytes=window_peak)
    if trace:  # the per-layer metrics read the traced part of the window
        tt0, tt1 = marks["traced"]
        rec.update(t0=tt0, t1=tt1, window=[c for c in win["window"] if tt0 < c.done <= tt1])
    return rec


def train_window(cell, seed: int, seconds: float, trace: bool, device, quantization: Optional[str] = None) -> dict:
    """The train cell's set-up and window (``benchmark/training.py``); the
    program's state is freed when it returns."""
    import gc

    import torch

    from benchmark import training
    from benchmark.trace import TRACE_S, Tracer

    tracer = Tracer(trace)
    marks: Dict[str, float] = {}

    def on_start():
        if device.type == "cuda":
            marks["setup_peak"] = torch.cuda.max_memory_allocated()
            torch.cuda.reset_peak_memory_stats()
        tracer.start()
        marks["setup_s"] = process_age_s()

    def on_trace_end(tt0, tt1):
        marks["traced"] = (tt0, tt1)
        tracer.stop(tt0, tt1)

    t = time.perf_counter()
    rec = training.run_train(cell.model, cell.config, cell.traffic, seed, seconds, device, quantization, on_start,
                             TRACE_S, on_trace_end if trace else None)
    log(f"set-up and window: {time.perf_counter() - t:.2f} s, {rec['steps']} steps in the window")
    window_peak = torch.cuda.max_memory_allocated() if device.type == "cuda" else 0
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    out = dict(rec, setup_s=marks["setup_s"] + (rec["t0"] - rec["started"]), trace=tracer.trace,
               memory_peak_bytes=max(marks.get("setup_peak", 0), window_peak), window_peak_bytes=window_peak)
    if trace:  # the per-layer metrics read the traced part of the window
        tt0, tt1 = marks["traced"]
        out.update(t0=tt0, t1=tt1, steps=sum(tt0 < e <= tt1 for e in rec["ends"]))
    return out


def breakdown(trace, spans, completions) -> dict:
    """The device ops that took most time, and the idle time by what the host was doing."""
    ops: Dict[str, float] = {}
    for op in trace.ops:
        a, b = max(op.start, trace.t0), min(op.end, trace.t1)
        if b > a:
            ops[op.name[:160]] = ops.get(op.name[:160], 0.0) + (b - a)
    idle: Dict[str, float] = {}
    for a, b in trace.idle_gaps():
        mid = (a + b) / 2
        if any(s.name == "generate" and s.start <= mid <= s.end for s in spans):
            label = "host inside pipeline.generate"
        elif any(s.name == "encode_prompt" and s.start <= mid <= s.end for s in spans):
            label = "host inside encode_prompt"
        elif any(c.due <= mid <= c.done for c in completions):
            label = "requests in flight, none in a batch or an encode (queue, batching, PNG)"
        elif not spans and not completions:
            label = "host inside the train step (autograd, optimizer, launches)"
        else:
            label = "no request in flight"
        idle[label] = idle.get(label, 0.0) + (b - a)
    top = sorted(ops.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[k, v] for k, v in top],
            "idle_gaps": [[k, v] for k, v in sorted(idle.items(), key=lambda kv: -kv[1])[:10]]}


def main(argv=None, root: Optional[Path] = None) -> int:
    args = parse_args(argv)
    from benchmark import spec

    cell = spec.load_cell(args.workload, root or spec.ROOT)
    require_cards(cell.chips)
    import torch

    log(f"process age {process_age_s():.2f} s: torch imported, {torch.cuda.device_count()} card(s)")
    from benchmark import check, flops

    device = torch.device("cuda", 0) if torch.cuda.is_available() else torch.device("cpu")
    kind = cell.traffic["kind"]
    if kind == "train":
        rec = train_window(cell, args.seed, args.seconds, bool(args.trace), device)
    elif kind == "closed":
        rec = serve_window(cell, args.seed, args.seconds, bool(args.trace), device)
    else:
        raise ValueError(f"traffic kind {kind!r}")
    info = card_info() if device.type == "cuda" else {"platform": "cpu", "kind": "cpu", "count": 0}
    info["memory_peak_bytes"] = int(rec["memory_peak_bytes"])

    t = time.perf_counter()
    if kind == "train":
        from benchmark import training

        numbers = training.compare_train(cell.model, cell.config, cell.traffic, args.seed, device, rec)
        numbers["nonfinite_losses"] = float(rec["nonfinite"])
        attempted, failed, window, completions, spans = len(rec["ends"]) - 1, rec["nonfinite"], [], [], []
    else:
        unanswered, malformed = check.answered(rec["window_all"])
        numbers, _ = check.compare_served(cell.model, cell.config, args.seed, device, rec["served"])
        numbers.update(unanswered=float(unanswered), malformed=float(malformed))
        window, completions, spans = rec["window"], rec["completions"], rec["spans"]
        attempted, failed = len(rec["window_all"]), unanswered
    log(f"reference check: {time.perf_counter() - t:.2f} s")
    limits = dict(cell.limits, unanswered=0.0, malformed=0.0, nonfinite_losses=0.0)
    correct, table = check.verdict(numbers, limits)

    # what the window did, for the metric readers (benchmark/metrics/*.py)
    run = types.SimpleNamespace(
        config=cell.config, traffic=cell.traffic, trace=rec["trace"], spans=spans,
        window=window, completions=completions, t0=rec["t0"], t1=rec["t1"],
        window_peak_bytes=rec["window_peak_bytes"], setup_s=rec["setup_s"], steps=rec.get("steps"),
        peaks=flops.peaks(info["kind"]) if device.type == "cuda" else None)
    metrics = {}
    for m in cell.per_layer if args.trace else cell.end_to_end:
        value = spec.reader(m.name, cell.root)(run)
        if value is not None:
            metrics[m.name] = {"value": float(value), "unit": m.unit}
    result = {"correct": bool(correct), "attempted": attempted, "failed": failed, "metrics": metrics, "device": info}
    if args.trace and rec["trace"] is not None:
        info["busy_s"] = rec["trace"].busy_s()
        info["window_s"] = rec["trace"].window_s
        result["breakdown"] = breakdown(rec["trace"], spans, completions)
    result["checks"] = table
    bad = forbidden_modules()  # after the window, the reference and every reader
    if bad:
        print(f"benchmark: modules of JAX or the JAX package are loaded: {', '.join(bad)}. No result.",
              file=sys.stderr)
        return 3
    for name, t in table.items():
        print(f"check {name}: {t['value']!r} (limit {t['limit']!r})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
