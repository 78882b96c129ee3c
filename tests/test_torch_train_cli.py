"""``train-lora --random-init`` through the port's CLI, on the CPU at a tiny size.

A 1-double / 1-single-block DiT (2 heads of 128, joint dim 96) trains a rank-4
LoRA on 32x32 synthetic data for a few steps: checkpoints, the learning-curve
SVG, the log lines, pruning, the stop sentinel, and ``--resume`` (a run cut at
step 2 and resumed ends where an uninterrupted run does, bit for bit: the
same per-step draws, the same optimizer state). Every option the port does
not carry yet raises ``SystemExit`` naming its ROADMAP queue.
"""

import json
import os

import numpy as np
import pytest

from flux2_tpu.io import safetensors_io
from flux2_tpu.models.flux2.config import Flux2TransformerConfig
from flux2_tpu.training.control import TrainingController
from flux2_tpu_torch.cli import main as cli
from flux2_tpu_torch.cli.train import run_training

TINY = Flux2TransformerConfig(num_layers=1, num_single_layers=1, num_attention_heads=2, attention_head_dim=128,
                              joint_attention_dim=96, guidance_embeds=True)


def _yaml(tmp_path, name="cfg.yaml", steps=3, save_every=2, rank=4, training="", checkpoints="", extra="",
          out="out"):
    """A YAML in the reference schema; ``training`` / ``checkpoints`` add keys to
    those sections, ``extra`` adds top-level lines."""
    path = tmp_path / name
    path.write_text(f"""model: {{name: klein-4b}}
lora: {{rank: {rank}, alpha: 8, target_layers: attention_ffn}}
dataset: {{image_size: 32}}
training: {{optimizer: adamw, learning_rate: 1.0e-2, warmup_steps: 1, lr_scheduler: cosine, batch_size: 1,
  max_steps: {steps}, log_every: 1{training}}}
memory: {{gradient_checkpointing: true}}
checkpoints: {{output: {tmp_path / out}, save_every: {save_every}{checkpoints}}}
{extra}""")
    return str(path)


def _run(argv, config=TINY):
    return run_training(cli.parse_args(["train-lora", *argv, "--device", "cpu"]), "cpu", transformer_config=config)


def _lora(path):
    return safetensors_io.load_file(os.path.join(path, "lora.safetensors"))


def test_random_init_training_writes_checkpoints_curve_and_logs(tmp_path, capsys):
    history = _run(["--config", _yaml(tmp_path), "--random-init"])
    out = tmp_path / "out"
    assert [r["step"] for r in history] == [1, 2, 3]
    assert all(np.isfinite(r["loss"]) and r["grad_norm"] > 0 for r in history)
    assert history[0]["lr"] == 0.0 and history[1]["lr"] > 0  # warmup: step 1 reads count 0
    assert sorted(os.listdir(out)) == ["checkpoint_000002", "checkpoint_000003", "learning_curve.svg"]
    ckpt = out / "checkpoint_000003"
    assert sorted(os.listdir(ckpt)) == ["lora.safetensors", "optimizer.safetensors", "training_state.json"]
    lora = _lora(ckpt)
    assert lora["double_blocks.to_q.a"].shape == (1, 256, 4) and lora["single_blocks.out_mlp.b"].shape == (1, 4, 256)
    assert len(lora) == 38 and all(np.any(v) for k, v in lora.items() if k.endswith(".b"))
    meta = json.loads((ckpt / "training_state.json").read_text())
    assert meta["step"] == 3 and meta["rank"] == 4 and meta["optimizer"] == "adamw" and len(meta["loss_history"]) == 3
    assert (out / "learning_curve.svg").read_text().startswith("<svg")
    err = capsys.readouterr()
    assert "resolved training variant: klein-4b -> klein-4b-base" in err.err
    assert "step 1/3 loss" in err.err and "step 3/3 loss" in err.err
    assert f"checkpoint -> {ckpt}" in err.out


def test_resume_ends_where_an_uninterrupted_run_does(tmp_path):
    full = tmp_path / "full"
    full.mkdir()
    _run(["--config", _yaml(full, steps=4, save_every=0), "--random-init"])
    cut = tmp_path / "cut"
    cut.mkdir()
    cfg = _yaml(cut, steps=4, save_every=2)
    _run(["--config", cfg, "--random-init", "--max-steps", "2"])
    history = _run(["--config", cfg, "--random-init", "--resume", str(cut / "out" / "checkpoint_000002")])
    assert [r["step"] for r in history] == [3, 4]
    a, b = _lora(full / "out" / "checkpoint_000004"), _lora(cut / "out" / "checkpoint_000004")
    assert sorted(a) == sorted(b) and all(np.array_equal(a[k], b[k]) for k in a)
    meta = json.loads((cut / "out" / "checkpoint_000004" / "training_state.json").read_text())
    assert len(meta["loss_history"]) == 4


def test_resume_refuses_a_changed_rank(tmp_path):
    _run(["--config", _yaml(tmp_path, steps=1), "--random-init"])
    with pytest.raises(SystemExit, match="rank=4"):
        _run(["--config", _yaml(tmp_path, name="r8.yaml", steps=2, rank=8), "--random-init", "--resume",
              str(tmp_path / "out" / "checkpoint_000001")])


def test_ema_is_saved_and_keep_last_prunes(tmp_path):
    _run(["--config", _yaml(tmp_path, steps=2, save_every=1, extra="ema: {enabled: true, decay: 0.5}\n"),
          "--random-init"])
    ckpt = tmp_path / "out" / "checkpoint_000002"
    ema, lora = (safetensors_io.load_file(str(ckpt / f)) for f in ("lora_ema.safetensors", "lora.safetensors"))
    assert sorted(ema) == sorted(lora) and not np.array_equal(ema["double_blocks.to_q.b"], lora["double_blocks.to_q.b"])
    _run(["--config", _yaml(tmp_path, name="keep.yaml", steps=3, save_every=1, checkpoints=", keep_last: 1",
                            out="kept"), "--random-init"])
    assert sorted(d for d in os.listdir(tmp_path / "kept") if d.startswith("checkpoint_")) == ["checkpoint_000003"]


def test_stop_sentinel_checkpoints_and_exits(tmp_path):
    os.makedirs(tmp_path / "out")
    TrainingController.write_sentinel(str(tmp_path / "out"), "stop")
    assert _run(["--config", _yaml(tmp_path), "--random-init"]) == []
    assert "checkpoint_000000" in os.listdir(tmp_path / "out")


def test_main_entry_point_runs_train_lora(tmp_path, monkeypatch):
    from flux2_tpu_torch.cli import train as cli_train

    seen = {}
    monkeypatch.setattr(cli_train, "run_training", lambda args, device: seen.update(args=args, device=device))
    assert cli.main(["train-lora", "--config", "x.yaml", "--random-init", "--device", "cpu"]) == 0
    assert seen["device"] == "cpu" and seen["args"].config == "x.yaml" and seen["args"].random_init


@pytest.mark.parametrize("flags,yaml_kw,queue", [
    ([], {}, "10/12"),  # no --random-init: training from checkpoints
    (["--random-init", "--transformer-dir", "/nonexistent"], {}, "10/12"),
    (["--random-init", "--dataset-dir", "{tmp}"], {}, "11"),
    (["--random-init"], {"extra": "control_dir: {tmp}\n"}, "11"),
    (["--random-init"], {"extra": "validation: {{prompts: [a red fox]}}\n"}, "13/15"),
    (["--random-init"], {"extra": "validation: {{vlm_scoring: {{enabled: true}}}}\n"}, "13/15"),
    (["--random-init"], {"extra": "validation_dataset_dir: {tmp}\n"}, "13"),
    (["--random-init"], {"extra": "lora_dropout: 0.1\n"}, "13"),
    (["--random-init", "--shard", "auto"], {}, "16"),
    (["--random-init"], {"training": ", pp: 5"}, "16"),
    (["--random-init", "--quantization", "w8a8"], {}, "12"),
], ids=["checkpoints", "transformer_dir", "dataset", "control_dir", "validation_prompts", "vlm_scoring",
        "validation_dataset", "lora_dropout", "shard", "pp", "quantized_base"])
def test_unsupported_options_raise_naming_their_queue(tmp_path, flags, yaml_kw, queue):
    cfg = _yaml(tmp_path, **{k: v.format(tmp=tmp_path) for k, v in yaml_kw.items()})
    with pytest.raises(SystemExit, match=f"queue {queue}"):
        _run(["--config", cfg, *(f.format(tmp=tmp_path) for f in flags)])
    assert not os.path.exists(tmp_path / "out")
