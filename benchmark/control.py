"""The control of a cell's output check: the program with its own
lower-precision path switched on (``--quantization``, the port's w8a8 for a
bf16 configuration), run through the cell's own window and check, on
several seeds in one process. The denoising and decode stages take the
reference with fp8 operands in the program's place: the program has no
lower-precision decode, and its w8a8 lowers the projections of the DiT
alone, leaving its attention and elementwise arithmetic in bf16. It has to
come out as not correct; its readings set the upper end of each limit
(PERF.md). ``--fault`` plants a fault of ``benchmark/faults.py`` instead.
The benchmark's own runs never run it.

    python3 -m benchmark.control --workload <name> --seeds 1,2,3 --seconds 10 [--quantization w8a8]

Prints one JSON line per seed: the compared numbers and the verdict
against the committed limits, which judges the cell's limited numbers
alone, and under ``beside`` what is read but not judged (the program's own
w8a8 latents, ``latents_rel_l2.program``). A train cell's control is
QLoRA's: the same step on the w8a8 base.
"""

from __future__ import annotations

import argparse
import json
import sys

from benchmark import run as bench_run


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--quantization", default="w8a8")
    p.add_argument("--fault", help="plant a fault of benchmark/faults.py instead (with --quantization bf16)")
    args = p.parse_args(argv)
    from benchmark import check, spec

    cell = spec.load_cell(args.workload)
    bench_run.require_cards(cell.chips)
    import torch

    device = torch.device("cuda", 0)
    if args.fault:
        from benchmark.faults import plant

        plant(args.fault)
    for seed in (int(s) for s in args.seeds.split(",")):
        beside = {}
        if cell.traffic["kind"] == "train":
            from benchmark import training

            rec = bench_run.train_window(cell, seed, args.seconds, False, device, args.quantization)
            numbers = training.compare_train(cell.model, cell.config, cell.traffic, seed, device, rec)
        else:
            rec = bench_run.serve_window(cell, seed, args.seconds, False, device, args.quantization)
            numbers, beside = check.compare_served(cell.model, cell.config, seed, device, rec["served"],
                                                   fp8_control=not args.fault)
        correct, table = check.verdict(numbers, cell.limits)
        print(json.dumps({"seed": seed, "quantization": args.quantization, "fault": args.fault,
                          "correct": correct, "checks": table, "beside": beside}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
