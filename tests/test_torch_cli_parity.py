"""Every subcommand's parsed namespace against JAX's ``build_parser()``, the
six command lines of fault F7 run end to end, and the two library gaps of
ROADMAP item 11 (``MemoryTelemetry.report`` / ``peak_bytes``,
``VAEConfig.scaling_factor``).

F7: JAX's ``_add_common`` gives ``-o/--output`` and ``--checkpoint-every``
to all six generating subcommands; the port gave them to ``t2i`` / ``i2i``
only (``-o`` alone to ``inpaint`` / ``outpaint``), so six lines JAX accepts
exited 2. Only ``--device``, the port's own flag, is left out of the
comparison; ``--shard``, ``--context-parallel`` and ``--dcn`` are in.
"""

import argparse
import dataclasses
import io
import os
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

from flux2_tpu.cli import main as jcli
from flux2_tpu.models.flux2 import vae as jvae
from flux2_tpu.utils import memory as jmem
from flux2_tpu_torch.cli import main as tcli
from flux2_tpu_torch.io.png import decode_png, encode_png
from flux2_tpu_torch.models.flux2 import vae as tvae
from flux2_tpu_torch.models.flux2.config import Flux2Model, Flux2TransformerConfig
from flux2_tpu_torch.pipeline.pipeline import Flux2Pipeline
from flux2_tpu_torch.utils import memory as tmem
from flux2_tpu_torch.utils import synthetic

F7_LINES = [
    ["inpaint", "--image", "a.png", "--mask", "m.png", "--checkpoint-every", "2"],
    ["outpaint", "--image", "a.png", "--checkpoint-every", "2"],
    ["profile", "-o", "x.png"],
    ["profile", "--checkpoint-every", "2"],
    ["evaluate-lora", "--dataset", "d", "-o", "x.png"],
    ["evaluate-lora", "--dataset", "d", "--checkpoint-every", "2"],
]
SHARD_FLAGS = [["--shard", "1,2,4"], ["--shard", "auto"], ["--shard", "1,1,2,4", "--context-parallel"],
               ["--shard", "2,2,2", "--dcn"]]
ARGVS = {
    "t2i": [["t2i"], ["t2i", "--prompt", "a fox", "-o", "f.png", "--checkpoint-every", "3", "--seed", "4"],
            *[["t2i", *f] for f in SHARD_FLAGS]],
    "i2i": [["i2i", "--reference", "r.png"], ["i2i", "--reference", "r.png", "--strength", "0.5", "--shard", "1,1,8"]],
    "inpaint": [["inpaint", "--image", "a.png", "--mask", "m.png"], F7_LINES[0],
                ["inpaint", "--image", "a.png", "--mask", "m.png", "--shard", "1,2,4", "--context-parallel"]],
    "outpaint": [["outpaint", "--image", "a.png"], F7_LINES[1], ["outpaint", "--image", "a.png", "--shard", "auto"]],
    "profile": [["profile"], F7_LINES[2], F7_LINES[3], ["profile", "--compare", "bf16,w8a8", "--shard", "2,2,2", "--dcn"]],
    "evaluate-lora": [["evaluate-lora", "--dataset", "d"], F7_LINES[4], F7_LINES[5]],
    "export-quantized": [["export-quantized", "--quantization", "qint8"]],
    "train-lora": [["train-lora", "--config", "c.yaml"], ["train-lora", "--config", "c.yaml", "--shard", "1,1,8"]],
    "download": [["download"]],
    "info": [["info"]],
    "mask-subject": [["mask-subject", "--image", "a.png"]],
    "training-control": [["training-control", "pause", "--output-dir", "D"]],
    "beacons": [["beacons"]],
}


def _subcommands(parser) -> set:
    return next(set(a.choices) for a in parser._actions if isinstance(a, argparse._SubParsersAction))


def test_every_subcommand_is_held():
    assert set(ARGVS) == _subcommands(jcli.build_parser()) == _subcommands(tcli._parser())


@pytest.mark.parametrize("argv", [a for argvs in ARGVS.values() for a in argvs],
                         ids=lambda a: " ".join(a))
def test_parsed_namespace_equals_jax(argv):
    port = vars(tcli.parse_args(argv))
    ref = vars(jcli.build_parser().parse_args(argv))
    ref.pop("fn", None)
    port.pop("device", None)
    assert port == ref


# -- F7's six lines end to end ------------------------------------------------------------------


class _Encoder:
    """A fixed prompt encoder for the tiny pipeline ([1, 8, 32] of ones)."""

    def __call__(self, prompt: str) -> torch.Tensor:
        return torch.ones(1, 8, 32)


@pytest.fixture(scope="module")
def tiny_pipe():
    tc = Flux2TransformerConfig(num_layers=1, num_single_layers=1, num_attention_heads=1, attention_head_dim=128,
                                joint_attention_dim=32, guidance_embeds=False)
    vc = tvae.VAEConfig(block_out_channels=(8, 8, 8, 8), layers_per_block=1, norm_num_groups=4)
    pipe = Flux2Pipeline.from_random(Flux2Model.KLEIN_4B, device="cpu", generator=torch.Generator().manual_seed(0),
                                     dtype=torch.float32, transformer_config=tc, vae_config=vc)
    return dataclasses.replace(pipe, text_encoder=_Encoder())


@pytest.mark.parametrize("line", F7_LINES, ids=lambda a: " ".join(a))
def test_f7_line_runs(line, tiny_pipe, tmp_path, monkeypatch):
    """Each line, at 64^2 and 2 steps on the tiny pipeline: exit 0. ``inpaint`` / ``outpaint`` write
    ``-o`` and ignore ``--checkpoint-every``, as JAX's do; ``profile`` and ``evaluate-lora`` ignore
    ``-o``."""
    monkeypatch.setattr(tcli, "build_pipeline", lambda args, device: tiny_pipe)
    monkeypatch.chdir(tmp_path)
    rng = np.random.RandomState(0)
    with open("a.png", "wb") as f:
        f.write(encode_png(rng.randint(0, 256, (64, 64, 3)).astype(np.uint8)))
    mask = np.zeros((64, 64, 3), np.uint8)
    mask[16:48, 16:48] = 255
    with open("m.png", "wb") as f:
        f.write(encode_png(mask))
    synthetic.write_dataset(str(tmp_path / "d"), 0, [(64, 64)])
    extra = ["--random-init", "--device", "cpu", "--width", "64", "--height", "64", "--steps", "2"]
    if line[0] == "profile":
        extra += ["--warmup", "0", "--runs", "1"]
    if line[0] == "evaluate-lora":
        extra += ["--no-vlm", "--max-samples", "1", "--output-dir", "eval"]
    if line[0] == "outpaint":
        extra += ["--right", "32"]  # the line's padding of 0 is refused by the chain, in JAX's too
    with redirect_stdout(io.StringIO()):
        assert tcli.main(line + extra) == 0
    written = sorted(p for p in os.listdir(tmp_path) if p.endswith(".png") and p not in ("a.png", "m.png"))
    if line[0] in ("inpaint", "outpaint"):
        assert written == ["output.png"]  # -o's default; no <output>_step_NNN.png
        assert decode_png(open("output.png", "rb").read()).shape[2] == 3
    else:
        assert written == []  # -o and --checkpoint-every parse and change nothing
    if line[0] == "evaluate-lora":
        assert os.listdir(tmp_path / "eval") == ["baseline_000.png"]


# -- item 11 ---------------------------------------------------------------------------------------


def test_memory_report_and_peak_bytes_equal_jax():
    """``report()`` byte for byte and ``peak_bytes`` on the same snapshots, with and without a limit."""
    gib = 2**30
    snaps = [("text_encoding", 3 * gib, 5 * gib, 80 * gib), ("denoising", 7 * gib + 123, 9 * gib // 2, 80 * gib),
             ("vae_decoding", gib // 3, 11 * gib, 80 * gib)]
    for limit in (80 * gib, 0):
        tel_t, tel_j = tmem.MemoryTelemetry(), jmem.MemoryTelemetry()
        for tag, used, peak, _ in snaps:
            tel_t.snapshots.append(tmem.MemorySnapshot(tag, used, peak, limit))
            tel_j.snapshots.append(jmem.MemorySnapshot(tag, used, peak, limit))
        assert tel_t.report() == tel_j.report()
        assert tel_t.peak_bytes == tel_j.peak_bytes == 11 * gib
    assert tmem.MemoryTelemetry().report() == jmem.MemoryTelemetry().report()
    assert tmem.MemoryTelemetry().peak_bytes == jmem.MemoryTelemetry().peak_bytes == 0


@pytest.mark.parametrize("d", [{}, {"scaling_factor": 0.3611, "latent_channels": 32},
                               {"block_out_channels": [64, 128], "scaling_factor": 1.0}])
def test_vae_config_scaling_factor_equals_jax(d):
    port, ref = tvae.VAEConfig.from_json_dict(d), jvae.VAEConfig.from_json_dict(d)
    assert port.scaling_factor == ref.scaling_factor == d.get("scaling_factor", 0.18215)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert tvae.VAEConfig().scaling_factor == jvae.VAEConfig().scaling_factor
