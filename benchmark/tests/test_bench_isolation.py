"""What the harness may load and where it may run: no CUDA card means no
result and no CPU fallback; a checkout without the program fails; no module
whose top-level name is JAX's or the JAX package's is loaded (whole-name
compare: the port's name begins with the JAX package's); the reference and
the yardstick load nothing of the program."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

from benchmark import run
from benchmark.tests import tiny

ROOT_DIR = Path(__file__).resolve().parents[2]


def test_no_card_no_result(tmp_path):
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", "klein4b-t2i1024-closed", "--seed",
                          "3000000019", "--seconds", "1", "--trace", "0"], cwd=ROOT_DIR, capture_output=True,
                         text=True, timeout=300, env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin",
                                                      "HOME": str(tmp_path)})
    assert out.returncode == 2, out.stderr[-2000:]
    assert out.stdout.strip() == ""
    assert "CUDA card" in out.stderr


def test_checkout_without_the_program_fails(tmp_path):
    shutil.copy(ROOT_DIR / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT_DIR / "benchmark", tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys; from benchmark import run; run.require_cards = lambda n: None; "
            "sys.exit(run.main(['--workload', 'klein4b-t2i1024-closed', '--seed', '1', '--seconds', '1', "
            "'--trace', '0']))")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    for name in ("flux2_tpu_torch", "flux2_tpu_torchx", "jaxtyping_like"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert run.forbidden_modules() == [m for m in run.FORBIDDEN if m in {k.split(".")[0] for k in sys.modules}]
    monkeypatch.setitem(sys.modules, "flux2_tpu.models", sys)
    assert "flux2_tpu" in run.forbidden_modules()


def test_a_whole_run_loads_no_jax(tmp_path):
    """tiny_run exits 3 if anything of JAX or the JAX package is loaded once the window has closed."""
    root = tiny.make_root(tmp_path, "closed")
    out = subprocess.run([sys.executable, "-m", "benchmark.tests.tiny_run", str(root), "tiny-closed", "2147483701"],
                         cwd=ROOT_DIR, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert '"correct": true' in out.stdout


def test_a_reader_that_loads_jax_leaves_no_result(tmp_path):
    """A metric reader runs after the window and the check; a JAX module it
    loads still keeps the run from printing a result (exit 3)."""
    root = tiny.make_root(tmp_path / "root", "closed")
    stub = tmp_path / "stub"
    stub.mkdir()
    (stub / "jax.py").write_text("")
    (root / "benchmark/metrics/loads_jax.py").write_text("def read(run):\n    import jax\n    return 1.0\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["end_to_end"].append({"name": "loads_jax", "unit": "s", "better": "lower", "bound": 0.05,
                                "source": "host_clock"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(stub), str(ROOT_DIR)]))
    out = subprocess.run([sys.executable, "-m", "benchmark.tests.tiny_run", str(root), "tiny-closed", "2147483713"],
                         cwd=ROOT_DIR, capture_output=True, text=True, timeout=600, env=env)
    assert out.returncode == 3, out.stderr[-3000:]
    assert out.stdout.strip() == ""
    assert "jax" in out.stderr.splitlines()[-1]


def test_reference_and_yardstick_load_nothing_of_the_program():
    code = ("import sys; import benchmark.reference.klein, benchmark.weights, benchmark.flops, benchmark.check, "
            "benchmark.traffic, benchmark.trace, benchmark.png, benchmark.spec; "
            "bad = sorted({m.split('.')[0] for m in sys.modules} & {'flux2_tpu_torch', 'flux2_tpu', 'jax', 'jaxlib', "
            "'flax'}); print(bad); sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT_DIR, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr[-2000:]
