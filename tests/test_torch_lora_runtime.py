"""LoRA runtime semantics at the port's user surface (after JAX's
``tests/test_lora_runtime.py``): ``--lora path[:scale]`` on every generating
command, Turbo scheduler overrides from a sidecar JSON, explicit arguments
winning over them, activation-keyword prefixing with ``final_prompt``, the
multi-LoRA conflict warnings and JAX's log lines, and JAX's ``TypeError`` for
a LoRA on a W8A8 DiT. Tiny random-init pipelines on the CPU; the LoRA files
are written here from seeds."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from flux2_tpu.cli import main as jcli
from flux2_tpu_torch.cli import main as tcli
from flux2_tpu_torch.io import safetensors_io as tst
from flux2_tpu_torch.models.flux2.config import Flux2TransformerConfig
from flux2_tpu_torch.models.flux2.vae import VAEConfig
from flux2_tpu_torch.models.text_encoders.config import TINY_DECODER
from flux2_tpu_torch.training import lora_loader as tloader

from tests.test_torch_lora_loader import one_torch_thread  # noqa: F401 (a fixture)

TINY = Flux2TransformerConfig(num_layers=1, num_single_layers=1, num_attention_heads=2, attention_head_dim=128,
                              joint_attention_dim=192, guidance_embeds=False)
TINY_VAE = VAEConfig(block_out_channels=(8, 8, 8, 8), layers_per_block=1, norm_num_groups=4)
# The Klein recipe reads hidden layers (9, 18, 27): 28 layers, hidden 64 -> joint 192.
TINY_QWEN3 = dataclasses.replace(TINY_DECODER, num_hidden_layers=28, vocab_size=600)


@pytest.fixture()
def tiny_cli(monkeypatch):
    """cli.main's build_pipeline at the tiny configs; the pipelines it built."""
    built = []
    original = tcli.build_pipeline

    def build(args, device, generator=None, **kw):
        built.append(original(args, device, generator, transformer_config=TINY, vae_config=TINY_VAE,
                              encoder_config=TINY_QWEN3))
        return built[-1]

    monkeypatch.setattr(tcli, "build_pipeline", build)
    return built


def write_turbo_lora(tmp_path, name="turbo", rank=4, sched=None, keyword="TURBOSTYLE", seed=0):
    """JAX's ``_write_turbo_lora``: double block 0's to_q, with a sidecar."""
    d = TINY.inner_dim
    rng = np.random.RandomState(seed)
    w = {"transformer.transformer_blocks.0.attn.to_q.lora_A.weight": rng.randn(rank, d).astype(np.float32) * 0.01,
         "transformer.transformer_blocks.0.attn.to_q.lora_B.weight": rng.randn(d, rank).astype(np.float32) * 0.01}
    path = str(tmp_path / f"{name}.safetensors")
    tst.save_file(w, path)
    conf = {"alpha": rank}
    if keyword:
        conf["activation_keyword"] = keyword
    if sched:
        conf["scheduler"] = sched
    with open(str(tmp_path / f"{name}.json"), "w") as f:
        json.dump(conf, f)
    return path


def _t2i(tmp_path, *flags):
    out = str(tmp_path / "o.png")
    assert tcli.main(["t2i", "--random-init", "--device", "cpu", "--width", "64", "--height", "64", "-o", out,
                      *flags]) == 0
    return out


def _report(capsys):
    captured = capsys.readouterr()
    return json.loads(captured.out.strip().splitlines()[-1]), captured.err


def test_turbo_lora_changes_the_schedule_through_the_cli(tiny_cli, tmp_path, capsys):
    lora = write_turbo_lora(tmp_path, sched={"custom_sigmas": [1.0, 0.5], "num_steps": 2, "guidance": 1.0})
    out = _t2i(tmp_path, "--lora", lora)
    rec, err = _report(capsys)
    assert rec["steps"] == 2  # klein-4b's default is 4: the LoRA's two-sigma schedule wins, as in JAX
    assert os.path.exists(out)
    assert f"[flux2:info] merged LoRA {lora} (scale 1.000)" in err
    assert "[flux2:info] LoRA scheduler overrides active: steps=2 guidance=1.0 custom_sigmas=yes" in err
    assert "[flux2:info] LoRA activation keyword(s): TURBOSTYLE" in err
    pipe = tiny_cli[0]
    assert (pipe.lora_num_steps, pipe.lora_guidance, pipe.lora_custom_sigmas) == (2, 1.0, [1.0, 0.5])


def test_explicit_steps_beat_the_lora_override(tiny_cli, tmp_path, capsys):
    lora = write_turbo_lora(tmp_path, sched={"num_steps": 2})
    _t2i(tmp_path, "--lora", lora, "--steps", "3")
    assert _report(capsys)[0]["steps"] == 3
    _t2i(tmp_path, "--lora", lora)
    assert _report(capsys)[0]["steps"] == 2


def test_keyword_prefixes_the_encoded_prompt_and_final_prompt(tiny_cli, tmp_path, capsys):
    lora = write_turbo_lora(tmp_path, sched={"num_steps": 1})
    _t2i(tmp_path, "--lora", lora, "--prompt", "a cat")
    _report(capsys)
    pipe = tiny_cli[0]
    seen = []
    encoder = pipe.text_encoder
    pipe.text_encoder = lambda prompt: seen.append(prompt) or encoder(prompt)
    res = pipe.generate(prompt="a cat", height=64, width=64, seed=0, decode=False)
    assert seen == ["TURBOSTYLE, a cat"] and res.final_prompt == "TURBOSTYLE, a cat" and res.num_steps == 1
    res = pipe.generate(prompt="turbostyle cat", height=64, width=64, seed=0, decode=False)
    assert seen[-1] == "turbostyle cat" and res.final_prompt == "turbostyle cat"
    res = pipe.generate(prompt="", height=64, width=64, seed=0, decode=False)
    assert res.final_prompt == "TURBOSTYLE"
    # precomputed embeddings: nothing is encoded, so nothing is prefixed
    res = pipe.generate(prompt="a cat", embeddings=encoder("a cat"), height=64, width=64, seed=0, decode=False)
    assert res.final_prompt == "a cat"


def test_two_loras_warn_on_a_conflict_and_the_last_wins(tiny_cli, tmp_path, capsys):
    first = write_turbo_lora(tmp_path, "a", sched={"num_steps": 2}, keyword="STYLE_A")
    second = write_turbo_lora(tmp_path, "b", sched={"num_steps": 3}, keyword="STYLE_B", seed=1)
    _t2i(tmp_path, "--lora", f"{first}:0.5", "--lora", second)
    rec, err = _report(capsys)
    assert rec["steps"] == 3
    assert "[flux2:warn] multiple LoRAs override num_steps (2 -> 3); using the last" in err
    assert f"merged LoRA {first} (scale 0.500)" in err and "LoRA activation keyword(s): STYLE_A, STYLE_B" in err
    assert tiny_cli[0].lora_keywords == ["STYLE_A", "STYLE_B"]


def test_merged_weights_equal_an_in_memory_merge(tiny_cli, tmp_path, capsys):
    lora = write_turbo_lora(tmp_path, keyword=None)
    args = tcli.parse_args(["t2i", "--random-init", "--device", "cpu"])
    base = tcli.build_pipeline(args, "cpu").transformer
    _t2i(tmp_path, "--lora", f"{lora}:0.8", "--steps", "1")
    merged = tiny_cli[-1].transformer
    assert not torch.equal(merged.double_blocks[0].to_q, base.double_blocks[0].to_q)
    tloader.merge_loras_into_params(base, [tloader.load_lora_file(lora, TINY, user_scale=0.8)], TINY)
    for name, t in base.state_dict().items():
        assert torch.equal(t, merged.state_dict()[name]), name


def test_lora_on_a_w8a8_dit_raises_jax_type_error(tiny_cli, tmp_path):
    lora = write_turbo_lora(tmp_path)
    with pytest.raises(TypeError, match=r"cannot merge LoRA into runtime-format leaf double_blocks/to_q "
                                        r"\(W8A8Tensor\); merge into the storage-format or bf16 params"):
        _t2i(tmp_path, "--lora", lora, "--quantization", "w8a8")


@pytest.mark.parametrize("command", ["t2i", "i2i", "inpaint", "outpaint", "profile"])
def test_lora_flags_on_every_generating_command_equal_jax(command):
    extra = {"i2i": ["--reference", "r.png"], "inpaint": ["--image", "i.png", "--mask", "m.png"],
             "outpaint": ["--image", "i.png"]}.get(command, [])
    argv = [command, *extra, "--lora", "a.safetensors:0.5", "--lora", "b.safetensors", "--dequantize-runtime"]
    port, ref = vars(tcli.parse_args(argv)), vars(jcli.build_parser().parse_args(argv))
    assert port["lora"] == ref["lora"] == ["a.safetensors:0.5", "b.safetensors"]
    assert port["dequantize_runtime"] is ref["dequantize_runtime"] is True
    bare = [command, *extra]
    assert vars(tcli.parse_args(bare))["lora"] is vars(jcli.build_parser().parse_args(bare))["lora"] is None
    assert vars(tcli.parse_args(bare))["steps"] is None  # a Turbo LoRA's num_steps applies only without --steps


def test_export_quantized_flags_equal_jax():
    argv = ["export-quantized", "--quantization", "int4", "--transformer-dir", "T", "--lora", "x:0.3"]
    port, ref = vars(tcli.parse_args(argv)), vars(jcli.build_parser().parse_args(argv))
    for name in ("model", "quantization", "transformer_dir", "lora"):
        assert port[name] == ref[name], name
    for fmt in ("w8a8", "bf16"):
        with pytest.raises(SystemExit):
            tcli.parse_args(["export-quantized", "--quantization", fmt])


def test_i2i_takes_the_lora_too(tiny_cli, tmp_path, capsys):
    from flux2_tpu_torch.io.png import encode_png

    ref = str(tmp_path / "ref.png")
    with open(ref, "wb") as f:
        f.write(encode_png(np.full((64, 64, 3), 128, np.uint8)))
    lora = write_turbo_lora(tmp_path, sched={"num_steps": 2})
    out = str(tmp_path / "i.png")
    assert tcli.main(["i2i", "--random-init", "--device", "cpu", "--reference", ref, "--width", "64", "--height",
                      "64", "--lora", lora, "-o", out]) == 0
    assert _report(capsys)[0]["steps"] == 2 and os.path.exists(out)

