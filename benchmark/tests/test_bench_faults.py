"""The output check on the CPU at a tiny size: a sound run comes out
correct; each fault a cell can have, planted under the timed path, comes
out not correct; so does the control (the program's w8a8 path). Every cell
runs on one chip, so the fault of an exchange between chips left out does
not apply, and the serving cells serve batches of one, so half a batch
left out applies to the train cell alone."""

import json
import subprocess
import sys

import pytest
import torch

from benchmark.tests import tiny

ROOT_DIR = __import__("pathlib").Path(__file__).resolve().parents[2]


def _run(root, workload, fault="none"):
    out = subprocess.run([sys.executable, "-m", "benchmark.tests.tiny_run", str(root), workload, "2147483659", fault],
                         cwd=ROOT_DIR, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("kind", ["closed", "train"])
def test_sound_run_is_correct(tmp_path, kind):
    res = _run(tiny.make_root(tmp_path, kind), f"tiny-{kind}")
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] > 0
    assert list(res)[-1] == "checks"


@pytest.mark.parametrize("fault,kind", [("frozen_step", "closed"), ("altered_answer", "closed"),
                                        ("frozen_step", "train"),
                                        ("half_batch", "train"), ("altered_answer", "train")])
def test_fault_is_not_correct(tmp_path, fault, kind):
    res = _run(tiny.make_root(tmp_path, kind), f"tiny-{kind}", fault)
    assert not res["correct"], res["checks"]


def test_control_is_not_correct(tmp_path):
    """The program's w8a8 runtime in place of its float path fails the limits
    that the float path meets, served and trained."""
    from benchmark import check, run, spec, training

    torch.set_num_threads(2)
    device = torch.device("cpu")
    cell = spec.load_cell("tiny-closed", tiny.make_root(tmp_path, "closed"))
    rec = run.serve_window(cell, 2147483659, 2.0, False, device, "w8a8")
    numbers, _ = check.compare_served(cell.model, cell.config, 2147483659, device, rec["served"])
    correct, table = check.verdict(numbers, cell.limits)
    assert not correct, table
    cell = spec.load_cell("tiny-train", tiny.make_root(tmp_path, "train"))
    rec = run.train_window(cell, 2147483659, 1.0, False, device, "w8a8")
    numbers = training.compare_train(cell.model, cell.config, cell.traffic, 2147483659, device, rec)
    correct, table = check.verdict(numbers, cell.limits)
    assert not correct, table
