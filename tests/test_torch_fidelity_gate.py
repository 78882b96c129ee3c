"""The port's fidelity gate (``flux2_tpu_torch/tools/fidelity_gate.py``) against JAX's ``tools/fidelity_gate.py``.

JAX's three tests mirrored, with their markers and skips: the fixture
registry against the shipped PNGs (skipped without the reference tree), the
offline download probe (here with ``huggingface_hub`` patched to act offline:
a stale empty directory, or an error, is never reported as a download), and
the slow random-init row. Then fast cases on the CPU: the fixture table
equals JAX's; on the same generated image and PNG the port's fixture row
equals JAX's key for key (all but the wall time), and so does the mire row on
the same I2I output; a missing reference gives JAX's row; ``main`` writes
JAX's report.
"""

import argparse
import dataclasses
import importlib.util
import json
import os
import sys
import types

import numpy as np
import pytest
from PIL import Image

from flux2_tpu_torch.tools import fidelity_gate as tfg

_TOOL = os.path.join(os.path.dirname(__file__), "..", "tools", "fidelity_gate.py")
_REF = tfg.DEFAULT_REFERENCE_TREE


def _load_jax():
    """JAX's tool as a fresh module (its dataclass needs its module in ``sys.modules``)."""
    spec = importlib.util.spec_from_file_location("jax_fidelity_gate", _TOOL)
    mod = importlib.util.module_from_spec(spec)
    sys.modules["jax_fidelity_gate"] = mod
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.skipif(not os.path.isdir(_REF), reason="reference tree not present")
def test_fixture_registry_points_at_shipped_pngs():
    missing = [f.name for f in tfg.FIXTURES if not os.path.exists(os.path.join(_REF, f.reference_png))]
    assert not missing, f"fixtures without reference PNGs: {missing}"
    assert all(f.seed == 42 for f in tfg.FIXTURES)
    assert all(f.steps == (28 if f.model == "dev" else 4) for f in tfg.FIXTURES)


def test_fixture_table_and_gates_equal_jax():
    jfg = _load_jax()
    assert [dataclasses.asdict(f) for f in tfg.FIXTURES] == [dataclasses.asdict(f) for f in jfg.FIXTURES]
    assert (tfg.PSNR_GATE_BF16, tfg.PSNR_GATE_QUANT, tfg.CAT_PROMPT) == \
        (jfg.PSNR_GATE_BF16, jfg.PSNR_GATE_QUANT, jfg.CAT_PROMPT)


@pytest.fixture
def offline_hub(monkeypatch, tmp_path):
    """``huggingface_hub`` acting offline, models under ``tmp_path``: ``mode`` "stale" returns the empty
    local_dir (what the hub does when the network is unreachable), "raise" fails as an offline hub does."""
    import huggingface_hub
    from huggingface_hub.errors import OfflineModeIsEnabled

    monkeypatch.setenv("FLUX2_MODELS_DIR", str(tmp_path / "models"))
    monkeypatch.setenv("HF_HOME", str(tmp_path / "hf"))
    calls = []

    def use(mode):
        def snapshot_download(repo_id, local_dir=None, **kw):
            calls.append(repo_id)
            if mode == "raise":
                raise OfflineModeIsEnabled("offline")
            return local_dir

        def hf_hub_download(*a, **kw):
            raise OfflineModeIsEnabled("offline")
        monkeypatch.setattr(huggingface_hub, "snapshot_download", snapshot_download)
        monkeypatch.setattr(huggingface_hub, "hf_hub_download", hf_hub_download)
        return calls
    return use


@pytest.mark.parametrize("mode", ["stale", "raise"])
def test_download_probe_is_honest_offline(offline_hub, mode):
    """With no network and no cached payload the probe must NOT claim success."""
    calls = offline_hub(mode)
    out = tfg.attempt_download("klein-4b")
    assert calls == ["black-forest-labs/FLUX.2-klein-4B"]
    assert out["model"] == "klein-4b" and out["outcome"] == "unavailable"
    if mode == "stale":
        assert out["error"] == "download incomplete (missing ['<no .safetensors present>'])"
    assert tfg.attempt_tekken_probe()["outcome"] == "unavailable"


class _StubPipe:
    """What the gate reads of a pipeline: ``generate`` returns a fixed image; the I2I encode is recorded."""

    def __init__(self, image: np.ndarray, joint: int = 16):
        import torch

        self.image, self.calls = image, []
        self.transformer_config = types.SimpleNamespace(joint_attention_dim=joint)  # JAX's pipeline
        self.transformer = types.SimpleNamespace(config=self.transformer_config)  # the port's
        self.device = torch.device("cpu")

    def encode_image_to_packed_sequence(self, image):
        self.calls.append(("encode", image.shape))
        return None

    def generate(self, **kw):
        emb = kw.get("embeddings")
        self.calls.append(("generate", {k: v for k, v in kw.items() if k not in ("embeddings", "init_latents")},
                           None if emb is None else (tuple(emb.shape), str(emb.dtype).split(".")[-1])))
        return types.SimpleNamespace(image=self.image)


def _args(random_init: bool, save_images=None) -> argparse.Namespace:
    return argparse.Namespace(random_init=random_init, save_images=save_images, transformer_dir=None, vae_dir=None,
                              encoder_dir=None, device="cpu")


@pytest.mark.parametrize("random_init", [False, True], ids=["prompt", "random_init"])
def test_fixture_row_equals_jax_on_the_same_image_and_png(tmp_path, monkeypatch, random_init):
    """The scoring path: one generated image (128^2, scored against a 96^2 PNG, so the resize is exercised)
    gives JAX's row, every key but ``wall_s``; both pipelines were asked for the same generation."""
    jfg = _load_jax()
    rng = np.random.RandomState(0)
    fx = dataclasses.replace(tfg.FIXTURES[1], width=128, height=128, steps=1)
    png = tmp_path / fx.reference_png
    png.parent.mkdir(parents=True)
    Image.fromarray(rng.randint(0, 256, (96, 96, 3), dtype=np.uint8)).save(png)
    image = np.floor(rng.rand(128, 128, 3).astype(np.float32) * 255) / 255
    jpipe, tpipe = _StubPipe(image), _StubPipe(image)
    monkeypatch.setattr(jfg, "_build_pipeline", lambda m, q, a: jpipe)
    monkeypatch.setattr(tfg, "_build_pipeline", lambda m, q, a: tpipe)
    want = jfg.run_fixture(jfg.Fixture(**dataclasses.asdict(fx)), str(tmp_path), _args(random_init, str(tmp_path / "j")), {})
    got = tfg.run_fixture(fx, str(tmp_path), _args(random_init, str(tmp_path / "t")), {})
    for row in (want, got):
        assert row.pop("wall_s") >= 0
        row["generated"] = os.path.basename(row["generated"])
    assert got == want and "psnr_db" in got and got["note"].startswith("shape mismatch")
    assert got.get("no_checkpoint", False) == random_init and not got["pass"]
    assert tpipe.calls == jpipe.calls
    with Image.open(tmp_path / "t" / f"{fx.name}.png") as a, Image.open(tmp_path / "j" / f"{fx.name}.png") as b:
        assert np.array_equal(np.asarray(a), np.asarray(b))


def test_missing_reference_and_mire_rows_equal_jax(tmp_path, monkeypatch):
    """Without the reference PNG both give the same error row; the mire row (the chart's I2I output here a
    blurred, shifted chart) gives JAX's ΔE."""
    from flux2_tpu_torch.utils import quality

    jfg = _load_jax()
    fx = tfg.FIXTURES[0]
    assert tfg.run_fixture(fx, str(tmp_path), _args(True), {}) == \
        jfg.run_fixture(jfg.FIXTURES[0], str(tmp_path), _args(True), {})
    chart = quality.color_chart_image(cell=128, cols=6)
    out = np.clip(0.9 * chart + 0.05 + 0.02 * np.roll(chart, 3, axis=0), 0, 1).astype(np.float32)
    jpipe, tpipe = _StubPipe(out), _StubPipe(out)
    monkeypatch.setattr(jfg, "_build_pipeline", lambda m, q, a: jpipe)
    monkeypatch.setattr(tfg, "_build_pipeline", lambda m, q, a: tpipe)
    for random_init in (False, True):
        got, want = tfg.run_mire("klein-4b", "w8a8", _args(random_init)), jfg.run_mire("klein-4b", "w8a8", _args(random_init))
        assert got == want and got["delta_e_mean"] > 0
    assert tpipe.calls == jpipe.calls
    assert tpipe.calls[-1][1] == {"height": 512, "width": 768, "num_steps": 4, "seed": 42, "strength": 0.35}


def test_main_writes_jax_report(tmp_path, monkeypatch, capsys):
    """``main`` with an empty tree: the fixture rows missing their reference, the mire rows scored, the
    report and the last line JAX's; exit 0 (nothing scored)."""
    jfg = _load_jax()
    out = np.full((512, 768, 3), 0.5, np.float32)
    monkeypatch.setattr(jfg, "_build_pipeline", lambda m, q, a: _StubPipe(out))
    monkeypatch.setattr(tfg, "_build_pipeline", lambda m, q, a: _StubPipe(out))
    argv = ["--random-init", "--models", "klein-4b", "--quantizations", "bf16,w8a8", "--mire",
            "--reference-tree", str(tmp_path)]
    assert tfg.main(argv + ["--device", "cpu", "--out", str(tmp_path / "t.json")]) == 0
    got_lines = capsys.readouterr().out.splitlines()
    monkeypatch.setattr(sys, "argv", ["fidelity_gate"] + argv + ["--out", str(tmp_path / "j.json")])
    assert jfg.main() == 0
    assert got_lines == capsys.readouterr().out.splitlines() and len(got_lines) == 5
    assert json.loads((tmp_path / "t.json").read_text()) == json.loads((tmp_path / "j.json").read_text())


@pytest.mark.slow
@pytest.mark.skipif(not os.path.isdir(_REF), reason="reference tree not present")
def test_random_init_produces_honest_no_checkpoint_row(tmp_path, monkeypatch):
    """The harness runs end to end without checkpoints: generates, scores against the shipped PNG, marks the
    row no_checkpoint, and exits 0 (a harness-validation run must not fail the gate)."""
    monkeypatch.setattr(tfg, "FIXTURES", [tfg.Fixture("klein4b_bf16", "klein-4b", "bf16",
                                                      "quantization-benchmark/images/klein4b_bf16.png",
                                                      steps=1, width=128, height=128)])
    out = tmp_path / "fid.json"
    rc = tfg.main(["--random-init", "--models", "klein-4b", "--quantizations", "bf16", "--out", str(out),
                   "--device", "cpu"])
    assert rc == 0
    report = json.loads(out.read_text())
    (row,) = report["rows"]
    assert row["no_checkpoint"] and not row["pass"]
    assert "psnr_db" in row and "mean_delta_e" in row
    assert report["gate"]["no_checkpoint"] == 1 and report["gate"]["scored"] == 0
