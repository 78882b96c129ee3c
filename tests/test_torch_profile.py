"""``flux2 profile`` in the port against the JAX package's (CPU).

- ``PhaseProfiler``: the same phases and steps under one fake clock give
  JAX's report text and Chrome-trace events.
- ``profile --compare bf16,w8a8`` on the tiny checkpoint tree of
  ``tests/test_torch_checkpoints.py`` prints JAX's table and JSON shape (JAX's
  own command run on the same tree and flags), and ``--trace`` writes the
  pipeline's three phases as Chrome-trace events; the generate phases are the
  profiler's and the memory snapshots close each one.
- ``torch_trace`` (JAX's ``jax_trace``) writes a Chrome trace of its region.
"""

import json
import time

import pytest
import torch

from flux2_tpu.cli import main as jcli
from flux2_tpu.utils import profiler as jprof
from flux2_tpu_torch.cli import main as tcli
from flux2_tpu_torch.utils import memory as tmem
from flux2_tpu_torch.utils import profiler as tprof

from tests.test_torch_checkpoints import tree_argv, write_tiny_tree

PHASES = ("1. Text Encoding", "2. Denoising", "3. VAE Decoding")


def _drive(module, monkeypatch):
    """The same phases, a nested pair and three steps on a clock that ticks 0.25 s a read."""
    ticks = iter(range(1000))
    monkeypatch.setattr(time, "perf_counter", lambda: 0.25 * next(ticks))
    prof = module.PhaseProfiler(enabled=True)
    with prof.phase("run 0"):
        for phase in PHASES:
            prof.start(phase)
            prof.end(phase)
        prof.end("never started")
    prof.start("4. Load Transformer")
    prof.end("4. Load Transformer")
    for s in (0.5, 0.25, 0.75):
        prof.record_step(s)
    disabled = module.PhaseProfiler(enabled=False)
    disabled.start("x")
    disabled.end("x")
    return prof, disabled


def test_report_and_trace_events_equal_jax(monkeypatch, tmp_path):
    port, port_off = _drive(tprof, monkeypatch)
    ref, ref_off = _drive(jprof, monkeypatch)
    assert port.report() == ref.report()
    assert port.phases == ref.phases and port.eta(4) == ref.eta(4) == 2.0
    assert port_off.phases == ref_off.phases == {}
    port.export_chrome_trace(str(tmp_path / "port.json"))
    ref.export_chrome_trace(str(tmp_path / "jax.json"))
    assert json.loads((tmp_path / "port.json").read_text()) == json.loads((tmp_path / "jax.json").read_text())


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return write_tiny_tree(tmp_path_factory.mktemp("tree"))


def _flags(tree, warmup=1, runs=2):
    return [*tree_argv(tree), "--prompt", "a red fox", "--width", "64", "--height", "64", "--steps", "1",
            "--warmup", str(warmup), "--runs", str(runs)]


def _fresh_profiler(module, monkeypatch):
    monkeypatch.setattr(module, "_shared", None)
    monkeypatch.delenv("FLUX2_PROFILE", raising=False)


def test_profile_compare_prints_jax_table_and_json(tree, monkeypatch, capsys):
    _fresh_profiler(tprof, monkeypatch)
    assert tcli.main(["profile", *_flags(tree), "--compare", "bf16,w8a8", "--device", "cpu"]) == 0
    port = capsys.readouterr().out.strip().splitlines()
    _fresh_profiler(jprof, monkeypatch)
    jcli.main(["profile", *_flags(tree, warmup=0, runs=1), "--compare", "bf16,w8a8"])  # JAX's w8a8 is slow here
    ref = capsys.readouterr().out.strip().splitlines()
    assert port[-4] == ref[-4]  # the table's header
    assert [line.split()[0] for line in port[-3:-1]] == [line.split()[0] for line in ref[-3:-1]] == ["bf16", "w8a8"]
    assert port[-3].endswith("1.00x")
    got, want = json.loads(port[-1]), json.loads(ref[-1])
    assert {k: sorted(v) for k, v in got.items()} == {k: sorted(v) for k, v in want.items()}
    assert got["bf16"]["runs"] == got["w8a8"]["runs"] == 2
    assert set(tprof.shared().phases) >= {*PHASES, "4. Load Transformer", "5. Load VAE", "1. Load Text Encoder",
                                          "run 0", "run 1", "run 2"}


def test_profile_trace_writes_the_pipeline_phases(tree, monkeypatch, tmp_path, capsys):
    _fresh_profiler(tprof, monkeypatch)
    trace = tmp_path / "trace" / "t.json"
    assert tcli.main(["profile", *_flags(tree), "--trace", str(trace), "--device", "cpu"]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert out[-1] == f"chrome trace -> {trace} (open in Perfetto)"
    stats = json.loads(out[-2])
    assert stats["runs"] == 2 and stats["min_s"] <= stats["mean_s"] <= stats["max_s"]
    assert out[0].startswith("┌─ flux2-tpu profile") and any("bottleneck:" in line for line in out)
    events = json.loads(trace.read_text())["traceEvents"]
    names = [e["name"] for e in events]
    for phase in PHASES:
        assert names.count(phase) == 3  # warmup + 2 runs
    assert all(e["ph"] == "X" and e["dur"] >= 0 for e in events)


def test_generate_snapshots_memory_per_phase(tree):
    pipe = tcli.build_pipeline(tcli.parse_args(["t2i", *tree_argv(tree), "--device", "cpu"]), "cpu")
    res = pipe.generate(prompt="a red fox", height=64, width=64, num_steps=1)
    zero = {"in_use_gb": 0.0, "peak_gb": 0.0}  # the CPU has no memory stats, as JAX's backends without them
    assert res.memory_stats == {"text_encoding": zero, "denoising": zero, "vae_decoding": zero}
    assert tmem.device_memory_stats("cpu") == {"bytes_in_use": 0, "peak_bytes_in_use": 0, "bytes_limit": 0}
    peak, scope = tmem.host_peak_rss_bytes()
    assert peak > 0 and scope in ("since reset", "ru_maxrss")


def test_torch_trace_writes_a_chrome_trace(tmp_path):
    path = tmp_path / "torch" / "trace.json"
    with tprof.torch_trace(str(path)):
        torch.ones(64, 64) @ torch.ones(64, 64)
    events = json.loads(path.read_text())["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)
