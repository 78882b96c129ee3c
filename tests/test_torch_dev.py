"""FLUX.2-dev prompt -> image in the port against the JAX package, on the CPU.

A tiny Dev-shaped pipeline: test_pipeline's tiny DiT with ``guidance_embeds``
(joint 96 = 3 x the tiny Mistral's hidden 32), the tiny VAE, and a 31-layer
tiny Mistral (the recipe reads hidden layers 10, 20 and 30; llama4 scaling,
untied head) with the byte-fallback Tekken tokenizer, JAX's perturbed init
weights carried across. The prompt goes through the Mistral recipe (system
prompt, LEFT padding to 512) in both packages and the latents must agree at
the golden tolerance, atol 1e-3, with JAX's noise injected; with
``upsample=True`` the rewritten prompt (JAX's uniforms injected) and the
latents agree too. ``load_mistral`` reads a checkpoint directory written
here (HF names under a ``language_model.`` or ``model.language_model.``
prefix, ``lm_head`` beside them, a VLM ``config.json`` with ``text_config``,
and a ``tekken.json`` copied from ``tests/goldens/tekken_fixture.json``) into
the encoder built in memory, equal to the bit. ``t2i --model dev
--random-init --upsample`` runs through the CLI at tiny size.
"""

import dataclasses
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flux2_tpu.models.flux2 import config as jcfg
from flux2_tpu.models.text_encoders import decoder as jdec
from flux2_tpu.models.text_encoders import extractor as jext
from flux2_tpu.models.text_encoders import facade as jfacade
from flux2_tpu.models.text_encoders.tekken import TekkenTokenizer as JTekken
from flux2_tpu.pipeline.pipeline import _seeded_noise_seq
from flux2_tpu_torch.cli import main as tcli
from flux2_tpu_torch.io.jax_params import decoder_from_jax, transformer_from_jax, vae_from_jax
from flux2_tpu_torch.models.flux2.config import Flux2Model, Flux2TransformerConfig
from flux2_tpu_torch.models.flux2.vae import VAEConfig
from flux2_tpu_torch.models.text_encoders import extractor as text
from flux2_tpu_torch.models.text_encoders import facade
from flux2_tpu_torch.models.text_encoders import generation as gen
from flux2_tpu_torch.models.text_encoders.config import DecoderConfig
from flux2_tpu_torch.models.text_encoders.tekken import TekkenTokenizer
from flux2_tpu_torch.pipeline.pipeline import Flux2Pipeline

from test_pipeline import tiny_pipeline
from tests.test_torch_checkpoints import write_checkpoint
from tests.test_torch_generation import jax_uniforms
from tests.test_torch_lora_loader import one_torch_thread  # noqa: F401  (module fixture)
from tests.test_torch_shared_copies import jax_config
from tests.test_torch_transformer import perturbed_numpy

GOLDENS = os.path.join(os.path.dirname(__file__), "goldens")
TINY_MISTRAL = DecoderConfig(vocab_size=1600, hidden_size=32, intermediate_size=64, num_hidden_layers=31,
                             num_attention_heads=4, num_key_value_heads=2, head_dim=8, rms_norm_eps=1e-5,
                             tie_word_embeddings=False, llama4_scaling_beta=0.1, original_max_position_embeddings=8)
TINY_DEV = Flux2TransformerConfig(num_layers=1, num_single_layers=2, num_attention_heads=2, attention_head_dim=128,
                                  joint_attention_dim=96, guidance_embeds=True)
TINY_VAE = VAEConfig(block_out_channels=(8, 8, 16, 16), layers_per_block=1, norm_num_groups=4)
PROMPT = "a red fox in the snow, [IMG] at dawn"


@pytest.fixture(scope="module")
def enc_params():
    return perturbed_numpy(jdec.init_params(jax.random.PRNGKey(9), jax_config(TINY_MISTRAL), dtype=jnp.float32), 9)


@pytest.fixture(scope="module")
def pipes(enc_params):
    """(JAX, port) tiny Dev pipelines on the same weights, each with its Mistral
    encoder attached through its own facade."""
    jpipe = tiny_pipeline(model=jcfg.Flux2Model.DEV)
    jpipe.vae_compute_dtype = jnp.float32
    tpipe = Flux2Pipeline(model=Flux2Model.DEV,
                          transformer=transformer_from_jax(jpipe.transformer_params, jpipe.transformer_config),
                          vae=vae_from_jax(jpipe.vae_params, jpipe.vae_config), device=torch.device("cpu"),
                          vae_compute_dtype=torch.float32)
    jenc = jfacade.TextEncoders()
    jloaded = jenc.attach("mistral", jax.tree_util.tree_map(jnp.asarray, enc_params), jax_config(TINY_MISTRAL),
                          JTekken.byte_fallback(), (10, 20, 30))
    tenc = facade.TextEncoders()
    tloaded = tenc.attach("mistral", decoder_from_jax(enc_params, TINY_MISTRAL), TINY_MISTRAL,
                          TekkenTokenizer.byte_fallback(), (10, 20, 30))
    jpipe.text_encoder, jpipe.text_encoder_name, jpipe.encoders = jloaded.extractor, "mistral", jenc
    tpipe.text_encoder, tpipe.text_encoder_name, tpipe.encoders = tloaded.extractor, "mistral", tenc
    return jpipe, tpipe


def _noise(seed):
    return torch.from_numpy(np.array(_seeded_noise_seq(seed, 64, 64, 1)))


def test_dev_defaults_equal_jax():
    for name in ("default_steps", "default_guidance", "uses_classical_cfg"):
        assert getattr(Flux2Model.DEV, name) == getattr(jcfg.Flux2Model.DEV, name)
    assert (Flux2Model.DEV.default_steps, Flux2Model.DEV.default_guidance) == (28, 4.0)
    assert Flux2Model.DEV.transformer_config.guidance_embeds


def test_mistral_recipe_embeddings_equal_jax(pipes):
    jpipe, tpipe = pipes
    assert tpipe.text_encoder.recipe == jpipe.text_encoder.recipe == "mistral"
    ref = np.asarray(jpipe.text_encoder(PROMPT))
    out = tpipe.text_encoder(PROMPT)
    assert out.shape == (1, 512, 96) and tpipe.text_encoder.embedding_dim == jpipe.text_encoder.embedding_dim
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-4, rtol=0)


def test_prompt_to_latents_equal_jax(pipes):
    jpipe, tpipe = pipes
    ref = jpipe.generate(prompt=PROMPT, height=64, width=64, num_steps=3, seed=1234)
    res = tpipe.generate(prompt=PROMPT, height=64, width=64, num_steps=3, noise=_noise(1234))
    assert res.num_steps == ref.num_steps == 3 and res.final_prompt == ref.final_prompt == PROMPT
    np.testing.assert_allclose(res.latents, np.asarray(ref.latents), atol=1e-3, rtol=0)
    assert np.max(np.abs(res.image - ref.image)) <= 1.0 / 255 + 1e-6


def test_upsampled_prompt_and_latents_equal_jax(pipes, monkeypatch):
    jpipe, tpipe = pipes
    draws = iter(jax_uniforms(3, 256))
    monkeypatch.setattr(gen, "_draw_uniform", lambda generator: torch.tensor(next(draws), dtype=torch.float32))
    ref = jpipe.generate(prompt="a lighthouse", height=64, width=64, num_steps=2, seed=3, upsample=True)
    res = tpipe.generate(prompt="a lighthouse", height=64, width=64, num_steps=2, noise=_noise(3), seed=3,
                         upsample=True)
    assert res.was_upsampled and ref.was_upsampled and res.final_prompt == ref.final_prompt != "a lighthouse"
    np.testing.assert_allclose(res.latents, np.asarray(ref.latents), atol=1e-3, rtol=0)


def test_vision_upsample_and_interpret_raise_jax_errors(pipes):
    jpipe, tpipe = pipes
    image = np.zeros((64, 64, 3), np.float32)
    for kw, match in ((dict(upsample=True, upsample_images=[image]), "vision upsampling requires a VLM"),
                      (dict(interpret_images=[image]), "image interpretation requires a VLM")):
        for pipe in (jpipe, tpipe):
            with pytest.raises(ValueError, match=match):
                pipe.generate(prompt="x", height=64, width=64, num_steps=1, seed=0, **kw)


def _mistral_checkpoint(p: dict, cfg: DecoderConfig, nested: bool) -> dict:
    """HF Mistral names under a VLM's language-model prefix, lm_head untied."""
    pre, head = ("model.language_model.", "lm_head.weight") if nested else ("language_model.model.",
                                                                             "language_model.lm_head.weight")
    w = {f"{pre}embed_tokens.weight": p["embed_tokens"], f"{pre}norm.weight": p["final_norm"],
         head: np.asarray(p["lm_head"]).T, "vision_tower.patch_conv.weight": np.zeros((4, 3, 2, 2), np.float32)}
    L = p["layers"]
    for i in range(cfg.num_hidden_layers):
        li = f"{pre}layers.{i}."
        w[li + "input_layernorm.weight"] = L["input_norm"][i]
        w[li + "post_attention_layernorm.weight"] = L["post_attn_norm"][i]
        for name in ("q_proj", "k_proj", "v_proj", "o_proj"):
            w[f"{li}self_attn.{name}.weight"] = np.asarray(L[name][i]).T
        for name in ("gate_proj", "up_proj", "down_proj"):
            w[f"{li}mlp.{name}.weight"] = np.asarray(L[name][i]).T
    return w


@pytest.mark.parametrize("nested", [False, True], ids=["language_model.model", "model.language_model"])
def test_load_mistral_from_a_directory_equals_the_in_memory_encoder(enc_params, tmp_path, nested):
    text_config = {k: v for k, v in dataclasses.asdict(TINY_MISTRAL).items()
                   if k not in ("qk_norm", "llama4_scaling_beta")}
    write_checkpoint(tmp_path, _mistral_checkpoint(enc_params, TINY_MISTRAL, nested), torch.bfloat16,
                     config={"model_type": "mistral3", "text_config": text_config, "vision_config": {}})
    shutil.copy(os.path.join(GOLDENS, "tekken_fixture.json"), tmp_path / "tekken.json")
    registry = facade.TextEncoders()
    loaded = registry.load_mistral(str(tmp_path), device="cpu")
    assert loaded.name == "mistral" and registry.is_loaded("mistral")
    assert loaded.config == TINY_MISTRAL and isinstance(loaded.tokenizer, TekkenTokenizer)
    assert loaded.tokenizer.vocab_size == 1581 and loaded.extractor.recipe == "mistral"
    memory = decoder_from_jax(enc_params, TINY_MISTRAL).to(torch.bfloat16)
    got = dict(loaded.decoder.named_parameters())
    assert got.keys() == dict(memory.named_parameters()).keys()
    assert all(torch.equal(got[name], w) for name, w in memory.named_parameters())
    tok = TekkenTokenizer.from_pretrained(os.path.join(GOLDENS, "tekken_fixture.json"))
    assert torch.equal(loaded.extractor(PROMPT), text.mistral_extractor(memory, tok)(PROMPT))
    jtok = JTekken.from_pretrained(os.path.join(GOLDENS, "tekken_fixture.json"))
    assert text.prepare_input_ids(loaded.tokenizer, PROMPT)[0].tolist() == jext.prepare_input_ids(jtok, PROMPT)[0].tolist()


@pytest.fixture
def tiny_cli(monkeypatch):
    """cli.main.build_pipeline at the tiny Dev shapes (the CLI passes no configs)."""
    real = tcli.build_pipeline
    monkeypatch.setattr(tcli, "build_pipeline", lambda args, device, generator=None: real(
        args, device, generator, transformer_config=TINY_DEV, vae_config=TINY_VAE, encoder_config=TINY_MISTRAL))


@pytest.mark.parametrize("quant", [[], ["--quantization", "w8a8", "--encoder-quantization", "w8a8"]],
                         ids=["bf16", "w8a8"])
def test_t2i_dev_random_init_upsample_through_the_cli(tiny_cli, tmp_path, capsys, quant):
    from flux2_tpu_torch.io.png import decode_png

    out = str(tmp_path / "dev.png")
    assert tcli.main(["t2i", "--model", "dev", "--random-init", "--upsample", *quant, "--prompt", "a red fox",
                      "--width", "64", "--height", "64", "--steps", "2", "--device", "cpu", "-o", out]) == 0
    printed = capsys.readouterr().out
    lines = printed.strip().splitlines()
    assert lines[-2] == f"saved {out}" and json.loads(lines[-1])["steps"] == 2
    # the random model's rewrite is random bytes, newlines among them: the line opens the text before "saved"
    head, _, rewritten = printed.rpartition(f"\nsaved {out}\n")[0].rpartition("[upsample] final prompt: ")
    assert (head == "" or head.endswith("\n")) and rewritten not in ("", "a red fox")
    with open(out, "rb") as f:
        assert decode_png(f.read()).shape == (64, 64, 3)


def test_build_pipeline_dev_random_init_attaches_a_mistral(tiny_cli):
    args = tcli.parse_args(["t2i", "--model", "dev", "--random-init", "--encoder-quantization", "w8a8",
                            "--device", "cpu"])
    pipe = tcli.build_pipeline(args, "cpu")
    enc = pipe.encoders.get("mistral")
    assert pipe.text_encoder_name == "mistral" and pipe.text_encoder is enc.extractor
    assert enc.extractor.recipe == "mistral" and enc.extractor.hidden_layers == (10, 20, 30)
    assert enc.tokenizer.vocab_size == TINY_MISTRAL.vocab_size and pipe.text_encoder_quantization == "w8a8"
    assert pipe.encode_prompt("a fox").shape == (1, 512, 96)
    no_enc = tcli.build_pipeline(tcli.parse_args(["t2i", "--model", "dev", "--random-init", "--no-text-encoder",
                                                  "--device", "cpu"]), "cpu")
    assert no_enc.text_encoder is None and no_enc.encoders is None


@pytest.fixture(scope="module")
def vl_dir(tmp_path_factory):
    from tests.test_torch_vlm_loader import write_tiny_qwen35_vl

    return write_tiny_qwen35_vl(tmp_path_factory.mktemp("qwen35vl"))


@pytest.mark.parametrize("argv", [["t2i"], ["i2i", "--reference", "REF"]], ids=["t2i", "i2i"])
def test_interpret_exits_naming_the_vision_half(argv, pipes, tiny_cli, vl_dir, tmp_path, monkeypatch):
    """``--interpret IMAGE`` (named when the flag still exited: the VLMs are
    ported now) with a tiny Qwen3.5-VL on disk at the registry's path, found
    by the checkpoint branch's lazy loader: the prompt the DiT gets equals
    JAX's ``interpret_images`` through JAX's facade on the same checkpoint
    (both loaders in f32 here, JAX's uniforms injected into the port's
    sampled analysis)."""
    import functools

    from flux2_tpu_torch.io import registry
    from flux2_tpu_torch.io import weight_mapping as twm

    monkeypatch.setenv("FLUX2_MODELS_DIR", str(tmp_path / "models"))
    shutil.copytree(vl_dir, registry.local_model_path(registry.TEXT_ENCODER_REPOS["qwen35-vlm"]))
    monkeypatch.setattr(facade, "shared", facade.TextEncoders())
    for name in ("load_qwen35", "load_qwen35_vision"):
        monkeypatch.setattr(twm, name, functools.partial(getattr(twm, name), dtype=torch.float32))
    monkeypatch.setattr(jfacade, "_bf16", lambda tree: tree)
    build = tcli.build_pipeline
    monkeypatch.setattr(tcli, "build_pipeline", lambda args, device, generator=None: dataclasses.replace(
        build(args, device, generator), vlm_loader=tcli._make_vlm_loader(None, device)))
    prompts = []
    generate = Flux2Pipeline.generate
    monkeypatch.setattr(Flux2Pipeline, "generate",
                        lambda self, **k: prompts.append((res := generate(self, **k)).final_prompt) or res)
    state = {}

    def draw(generator):  # JAX's uniforms for seed 3, restarting with each decode loop
        if state.get("generator") is not generator:
            state.update(generator=generator, draws=iter(jax_uniforms(3, 128)))
        return torch.tensor(next(state["draws"]), dtype=torch.float32)
    monkeypatch.setattr(gen, "_draw_uniform", draw)

    from PIL import Image

    paths = {}
    for name, seed in (("interpret", 30), ("REF", 31)):
        paths[name] = str(tmp_path / f"{name}.png")
        Image.fromarray((np.random.RandomState(seed).rand(64, 64, 3) * 255).astype(np.uint8)).save(paths[name])
    argv = [paths.get(a, a) for a in argv]
    assert tcli.main([*argv, "--model", "dev", "--random-init", "--interpret", paths["interpret"], "--prompt",
                      "a red fox", "--width", "64", "--height", "64", "--steps", "1", "--seed", "3", "--device", "cpu",
                      "-o", str(tmp_path / "out.png")]) == 0
    jpipe = pipes[0]
    monkeypatch.setattr(jpipe, "vlm", jfacade.TextEncoders().load_qwen35_vlm(
        registry.local_model_path(registry.TEXT_ENCODER_REPOS["qwen35-vlm"])))
    with Image.open(paths["interpret"]) as im:
        image = np.asarray(im.convert("RGB"), np.float32) / 255.0
    want = jpipe.interpret_images([image], "a red fox", seed=3)
    assert want.startswith("Interpret image 1: ") and want.endswith("\n\nUser request: a red fox")
    assert prompts == [want]


class _StubVLM:
    """A vision service stand-in: one description per image."""

    def analyze_image(self, image, prompt, seed=0):
        return f" a {image.shape[0]}x{image.shape[1]} image, seed {seed} "


def test_vlm_prompt_composition_equals_jax(pipes, monkeypatch):
    """With a vision service attached (the vision half brings one), the
    interpret and vision-upsample prompts are JAX's, byte for byte; the
    rewrite itself is replaced by an echo in both facades."""
    jpipe, tpipe = pipes
    image = np.zeros((48, 64, 3), np.float32)
    for pipe in (jpipe, tpipe):
        monkeypatch.setattr(pipe, "vlm", _StubVLM())
        monkeypatch.setattr(pipe.encoders, "upsample_prompt", lambda prompt, name, mode, seed: f"{mode}|{name}|{prompt}")
    assert tpipe.interpret_images([image, image], "a fox", seed=2) == jpipe.interpret_images([image, image], "a fox",
                                                                                                 seed=2)
    assert tpipe.upsample_prompt("a fox", images=[image], mode="upsampling_i2i", seed=1) == jpipe.upsample_prompt(
        "a fox", images=[image], mode="upsampling_i2i", seed=1)
