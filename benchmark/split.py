"""Where a cell's device idle time goes, by the program span the host was in.

    python3 -m benchmark.split --workload <cell> --seed <n> --seconds <s>

Runs the cell's set-up and window as ``benchmark/run.py --trace 1`` does,
without the output check, and prints one JSON line: the traced window, its
busy and idle seconds, and ``idle_split_s``, the idle seconds split by
``spans.idle_split``: each idle moment goes to the first of these, in order,
whose spans hold it, the rest to "no span":

- a served cell: ``dit.step``, "2. Denoising" outside it, "3. VAE Decoding",
  "1. Text Encoding", then ``pipeline.encode`` and ``serve.png`` (the
  request threads' encode and PNG);
- the train cell: ``train.forward``, ``train.backward``, ``train.optimizer``.

With it: each span's count and number of threads; in a served cell, the mean
``dit.step`` span by step and the longest wait for the prompt lock
(``pipeline.encode``'s ``lock_wait_s``). A program without the spans gives
an empty split (every idle moment under "no span").
"""

from __future__ import annotations

import argparse
import json
import sys
import types
from typing import Dict, List, Sequence

from benchmark import spans

SERVE = ("dit.step", "2. Denoising", "3. VAE Decoding", "1. Text Encoding", "pipeline.encode", "serve.png")
TRAIN = ("train.forward", "train.backward", "train.optimizer")


def summary(trace, named: Dict[str, List], order: Sequence[str]) -> dict:
    """The split of ``trace``'s idle time over ``named`` spans (name -> the
    spans that ended in the traced window), in ``order``, and what the spans
    say beside it."""
    busy = trace.busy_s()
    out = {"window_s": trace.window_s, "busy_s": busy, "idle_s": trace.window_s - busy,
           "idle_split_s": spans.idle_split(trace, [(n, named.get(n, [])) for n in order]),
           "counts": {n: len(v) for n, v in named.items()},
           "threads": {n: len({s.thread for s in v}) for n, v in named.items()}}
    by_step: Dict[int, List[float]] = {}
    for s in named.get("dit.step", []):
        by_step.setdefault(int(s.attrs["step"]), []).append(s.end - s.start)
    if by_step:
        out["dispatch_ms_by_step"] = {k: 1000.0 * sum(v) / len(v) for k, v in sorted(by_step.items())}
    waits = [s.attrs["lock_wait_s"] for s in named.get("pipeline.encode", []) if "lock_wait_s" in s.attrs]
    if waits:
        out["lock_wait_ms_max"] = 1000.0 * max(waits)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    args = p.parse_args(argv)
    import torch

    from benchmark import run, spec

    cell = spec.load_cell(args.workload)
    run.require_cards(cell.chips)
    device = torch.device("cuda", 0) if torch.cuda.is_available() else torch.device("cpu")
    train = cell.traffic["kind"] == "train"
    window = run.train_window if train else run.serve_window
    rec = window(cell, args.seed, args.seconds, True, device)
    if rec["trace"] is None:
        print("benchmark.split: no device trace was taken", file=sys.stderr)
        return 1
    traced = types.SimpleNamespace(trace=rec["trace"], t0=rec["t0"], t1=rec["t1"])
    order = TRAIN if train else SERVE
    names = order if train else order + ("serve.queue",)
    named = {n: spans.program_spans(traced, n) for n in names}
    print(json.dumps(dict(workload=args.workload, seed=args.seed, **summary(rec["trace"], named, order))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
