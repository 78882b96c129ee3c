"""Runs a tiny cell through the whole harness on the CPU, with the look for
a card skipped and, if asked, one fault planted under the timed path:

    python -m benchmark.tests.tiny_run <root> <workload> <seed> [fault]

Faults: ``benchmark/faults.py``. Prints the run's result line.
"""

import sys
from pathlib import Path

import torch

from benchmark.faults import plant


def main(argv):
    root, workload, seed = Path(argv[0]), argv[1], argv[2]
    fault = argv[3] if len(argv) > 3 else "none"
    torch.set_num_threads(2)
    from benchmark import run

    run.require_cards = lambda n: None
    plant(fault)
    return run.main(["--workload", workload, "--seed", seed, "--seconds", "2", "--trace", "0"], root=root)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
