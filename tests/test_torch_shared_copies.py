"""The port's own copies of the JAX package's JAX-free modules behave as the
originals: model, VAE and encoder configs, the registry's tables, the dev
tokenizer, the training controller and state, safetensors IO (bf16 both
ways), the leveled logger, and what
``train-lora`` takes from the JAX training CLI (YAML schema, checkpoint
pruning, learning-curve SVG, training variant). The I2I slice's copies give
JAX's results to the bit: custom sigma schedules, ``scale_noise``,
``patchify_latents``, the reference position ids, the BatchNorm
normalization and ``_downscale_to_max_pixels`` (both of its branches). The
editing slice's copies: the chains' mask and crop geometry and outpaint
canvas (equal to the bit), their float helpers (within 1e-6), and
``utils/native.py``'s numpy path (equal to JAX's fallback to the bit) and its
C++ path (within 1e-6 of it); the memory estimates are held in
tests/test_torch_hooks.py. The serving slice's copies, equal to the bit: the
web UI (``_DEMO_HTML``), the registry's memory and encoder-variant tables and
functions, ``utils/beacon.py``, every ``utils/quality.py`` metric, and the
subject mask's morphology, saliency heuristic, ``synth_composite`` and
``iou``. The LoRA / prequantized slice's: the loader's Diffusers leaf table,
the prequantized directory and path and the source fingerprint. The
real-data training slice's: ``resolve_encoder_quantization`` (``training/data.py``
and ``training/validation.py`` are held in their own files). Also: the
port's entry points default to the card and take the CPU only when asked.

``jax_config`` builds the JAX package's config class from a port config's
numbers; the other CPU parity tests use it wherever they feed one config to
both packages.
"""

import dataclasses
import inspect
import io
import os
from contextlib import redirect_stderr

import numpy as np
import pytest
import torch

from flux2_tpu.chains import inpaint as jinpaint
from flux2_tpu.chains import outpaint as joutpaint
from flux2_tpu import serve as jserve
from flux2_tpu.chains import segmenter as jseg
from flux2_tpu.chains import subject_mask as jsubject
from flux2_tpu.cli import train as jtrain_cli
from flux2_tpu.io import registry as jregistry
from flux2_tpu.io import safetensors_io as jst
from flux2_tpu.models.flux2 import config as jcfg
from flux2_tpu.models.flux2 import vae as jvae
from flux2_tpu.models.text_encoders import config as jenc
from flux2_tpu.ops import latents as jlu
from flux2_tpu.ops import scheduler as jsch
from flux2_tpu.pipeline import pipeline as jpipeline
from flux2_tpu.training import control as jcontrol
from flux2_tpu.utils import beacon as jbeacon
from flux2_tpu.utils import dev_tokenizer as jtok
from flux2_tpu.utils import logging as jlog
from flux2_tpu.utils import native as jnative
from flux2_tpu.utils import quality as jquality
from flux2_tpu_torch import serve as tserve
from flux2_tpu_torch.chains import inpaint as tinpaint
from flux2_tpu_torch.chains import outpaint as toutpaint
from flux2_tpu_torch.chains import segmenter as tseg
from flux2_tpu_torch.chains import subject_mask as tsubject
from flux2_tpu_torch.chains.subject_mask import _dilate, _inward_ramp
from flux2_tpu_torch.cli import main as tcli
from flux2_tpu_torch.cli import train_config as ttrain_cfg
from flux2_tpu_torch.io import registry as tregistry
from flux2_tpu_torch.io import safetensors_io as tst
from flux2_tpu_torch.models.flux2 import config as tcfg
from flux2_tpu_torch.models.flux2 import vae as tvae
from flux2_tpu_torch.models.text_encoders import config as tenc
from flux2_tpu_torch.ops import latents as tlu
from flux2_tpu_torch.ops import scheduler as tsch
from flux2_tpu_torch.pipeline import pipeline as tpipeline
from flux2_tpu_torch.pipeline.pipeline import Flux2Pipeline
from flux2_tpu_torch.training import control as tcontrol
from flux2_tpu_torch.training.trainer import TrainConfig
from flux2_tpu_torch.utils import beacon as tbeacon
from flux2_tpu_torch.utils import dev_tokenizer as ttok
from flux2_tpu_torch.utils import logging as tlog
from flux2_tpu_torch.utils import native as tnative
from flux2_tpu_torch.utils import quality as tquality


def jax_config(cfg):
    """The JAX package's config (Flux2TransformerConfig or DecoderConfig) with
    the numbers of the port's ``cfg``."""
    cls = {tcfg.Flux2TransformerConfig: jcfg.Flux2TransformerConfig, tenc.DecoderConfig: jenc.DecoderConfig}[type(cfg)]
    return cls(**dataclasses.asdict(cfg))


def _fields(obj) -> dict:
    return dataclasses.asdict(obj)


# -- configs -------------------------------------------------------------------


@pytest.mark.parametrize("name", [m.name for m in jcfg.Flux2Model])
def test_flux2_model_equals_jax(name):
    port, ref = tcfg.Flux2Model[name], jcfg.Flux2Model[name]
    assert port.value == ref.value and port is not ref  # the port's own enum
    assert _fields(port.transformer_config) == _fields(ref.transformer_config)
    for prop in ("default_steps", "default_guidance", "uses_guidance_embeds", "uses_classical_cfg",
                 "supports_kv_cache", "max_reference_images", "joint_attention_dim", "is_commercial_licensed"):
        assert getattr(port, prop) == getattr(ref, prop), prop
    cfg = port.transformer_config
    assert (cfg.inner_dim, cfg.mlp_hidden_dim) == (ref.transformer_config.inner_dim,
                                                  ref.transformer_config.mlp_hidden_dim)


@pytest.mark.parametrize("name", ["FLUX2_DEV", "KLEIN_9B", "KLEIN_4B", "TINY_TEST"])
def test_transformer_configs_equal_jax(name):
    assert _fields(getattr(tcfg, name)) == _fields(getattr(jcfg, name))
    d = {"num_layers": 3, "num_attention_heads": 4, "axes_dims_rope": [16, 16, 16, 16], "guidance_embeds": False}
    assert _fields(tcfg.Flux2TransformerConfig.from_json_dict(d)) == _fields(
        jcfg.Flux2TransformerConfig.from_json_dict(d))


@pytest.mark.parametrize("name", ["QWEN3_4B", "QWEN3_8B", "TINY_DECODER", "MISTRAL_SMALL_3_2"])
def test_decoder_configs_equal_jax(name):
    assert _fields(getattr(tenc, name)) == _fields(getattr(jenc, name))
    assert _fields(jax_config(getattr(tenc, name))) == _fields(getattr(jenc, name))


def test_decoder_config_constants_and_json_equal_jax():
    for name in ("MISTRAL_HIDDEN_LAYERS", "QWEN3_HIDDEN_LAYERS", "MAX_SEQUENCE_LENGTH"):
        assert getattr(tenc, name) == getattr(jenc, name)
    d = {"vocab_size": 1000, "hidden_size": 64, "intermediate_size": 128, "num_hidden_layers": 2,
         "num_attention_heads": 4}
    assert _fields(tenc.DecoderConfig.from_json_dict(d, qk_norm=True, llama4=True)) == _fields(
        jenc.DecoderConfig.from_json_dict(d, qk_norm=True, llama4=True))


@pytest.mark.parametrize("d", [{}, {"block_out_channels": [8, 16], "layers_per_block": 1, "norm_num_groups": 4,
                                  "latent_channels": 4, "norm_eps": 1e-5},
                                 {"decoder_block_out_channels": [96, 192, 384, 384], "scaling_factor": 0.3}],
                         ids=["defaults", "tiny", "small_decoder"])
def test_vae_config_from_json_equals_jax(d):
    port, ref = tvae.VAEConfig.from_json_dict(d), jvae.VAEConfig.from_json_dict(d)
    assert _fields(port) == {f: getattr(ref, f) for f in _fields(port)}
    assert _fields(tvae.FLUX2_VAE) == {f: getattr(jvae.FLUX2_VAE, f) for f in _fields(tvae.FLUX2_VAE)}


def test_registry_tables_equal_jax():
    assert dataclasses.asdict(tregistry.VAE_REPO) == dataclasses.asdict(jregistry.VAE_REPO)
    assert dataclasses.asdict(tregistry.VAE_SMALL_DECODER_REPO) == dataclasses.asdict(jregistry.VAE_SMALL_DECODER_REPO)
    assert {k: dataclasses.asdict(v) for k, v in tregistry.TEXT_ENCODER_REPOS.items()} == {
        k: dataclasses.asdict(v) for k, v in jregistry.TEXT_ENCODER_REPOS.items()}
    assert {(m.name, f): dataclasses.asdict(v) for (m, f), v in tregistry.PREQUANTIZED_TRANSFORMER_REPOS.items()} == {
        (m.name, f): dataclasses.asdict(v) for (m, f), v in jregistry.PREQUANTIZED_TRANSFORMER_REPOS.items()}
    assert tregistry.DEFAULT_MODELS_DIR == jregistry.DEFAULT_MODELS_DIR


def test_registry_memory_tables_equal_jax():
    assert tregistry.ENCODER_VARIANT_REPOS == jregistry.ENCODER_VARIANT_REPOS
    assert tregistry.QUANT_PRESETS == jregistry.QUANT_PRESETS
    assert {m.name: v for m, v in tregistry.MODEL_MIN_MEMORY_GB.items()} == {
        m.name: v for m, v in jregistry.MODEL_MIN_MEMORY_GB.items()}
    for gb in (0, 12.9, 13, 16, 20, 28, 29, 31.9, 32, 47.5, 48, 64, 72, 95.9, 96, 640):
        assert tregistry.recommended_preset(gb) == jregistry.recommended_preset(gb)
        for m in jcfg.Flux2Model:
            assert tregistry.recommended_format_for_model(tcfg.Flux2Model[m.name], gb) == \
                jregistry.recommended_format_for_model(m, gb)


@pytest.mark.parametrize("name", [m.name for m in jcfg.Flux2Model])
def test_training_variant_equals_jax(name):
    assert tregistry.training_variant(tcfg.Flux2Model[name]).name == jregistry.training_variant(
        jcfg.Flux2Model[name]).name


# -- train-lora's YAML, pruning, SVG ---------------------------------------------

YAML = """model: {name: klein-9b, quantization: int8}
lora: {rank: 8, alpha: 4, target_layers: attention}
dataset: {path: /data/x, image_size: 768, trigger_word: sks}
training: {optimizer: lion, learning_rate: 3.0e-5, warmup_steps: 5, lr_scheduler: constant, batch_size: 2,
  gradient_accumulation: 2, max_steps: 40, log_every: 4, keep_only_last_n_checkpoints: 2}
loss: {weighting: bell_shaped, timestep_sampling: logit_normal, diff_output_preservation: true,
  diff_output_preservation_multiplier: 0.5}
memory: {gradient_checkpointing: false, bucketing: {enabled: true, resolutions: [512, 1024]}}
checkpoints: {output: /tmp/out, save_every: 10, learning_curve_smoothing: 5}
validation: {prompt: a cat, every_n_steps: 20, vlm_scoring: {enabled: true, scene_weight: 0.25}}
early_stop: {enabled: true, patience: 4}
ema: {enabled: true, decay: 0.9}
bogus_section: {x: 1}
"""


def test_yaml_training_config_equals_jax(tmp_path):
    path = tmp_path / "cfg.yaml"
    path.write_text(YAML)
    port_err, jax_err = io.StringIO(), io.StringIO()
    with redirect_stderr(port_err):
        port = ttrain_cfg.YAMLTrainingConfig.from_yaml(str(path))
    with redirect_stderr(jax_err):
        ref = jtrain_cli.YAMLTrainingConfig.from_yaml(str(path))
    assert _fields(port) == _fields(ref)
    assert port.dop_weight == 0.5 and port.early_stop_loss_patience == 4 and port.validation_prompts == ["a cat"]
    assert "unknown config section 'bogus_section'" in port_err.getvalue()
    assert port_err.getvalue() == jax_err.getvalue()
    assert _fields(port.override(max_steps=7, output_dir=None)) == _fields(ref.override(max_steps=7, output_dir=None))


@pytest.mark.parametrize("flag,yaml_value", [(None, None), (None, "int8"), (None, "QINT8"), (None, "nf4"), (None, "w8a8"),
                                             (None, "fp8"), ("w4a8", "int8"), ("bf16", None), (None, "int4")])
def test_resolve_encoder_quantization_equals_jax(flag, yaml_value):
    from flux2_tpu_torch.cli import train as ttrain_cli

    assert ttrain_cli.resolve_encoder_quantization(flag, yaml_value) == jtrain_cli.resolve_encoder_quantization(
        flag, yaml_value)


def test_prune_checkpoints_equals_jax(tmp_path):
    dirs = {}
    for label in ("port", "jax"):
        out = tmp_path / label
        for step in (5, 10, 1000000, 20):
            (out / f"checkpoint_{step:06d}").mkdir(parents=True)
        (out / "best").mkdir()
        cfg = ttrain_cfg.YAMLTrainingConfig(output_dir=str(out), keep_last_checkpoints=2)
        prune = ttrain_cfg.prune_checkpoints if label == "port" else jtrain_cli._prune_checkpoints
        prune(cfg, keep=str(out / "checkpoint_000005"))
        dirs[label] = sorted(os.listdir(out))
    assert dirs["port"] == dirs["jax"] == ["best", "checkpoint_000005", "checkpoint_000020", "checkpoint_1000000"]


@pytest.mark.parametrize("n_losses,window", [(1, 20), (30, 5), (50, 20)])
def test_learning_curve_svg_is_byte_equal(tmp_path, n_losses, window):
    losses = list(np.random.RandomState(n_losses).rand(n_losses) * 3 + 0.1)
    ttrain_cfg.write_learning_curve_svg(losses, str(tmp_path / "port.svg"), smoothing_window=window)
    jtrain_cli.write_learning_curve_svg(losses, str(tmp_path / "jax.svg"), smoothing_window=window)
    assert (tmp_path / "port.svg").read_bytes() == (tmp_path / "jax.svg").read_bytes()


# -- I2I: schedules, latents, reference downscale ------------------------------------


def _bits(x) -> np.ndarray:
    """An array's raw bits (float32 or bf16) for equality to the bit."""
    if isinstance(x, torch.Tensor):
        return x.contiguous().view(torch.int16 if x.dtype == torch.bfloat16 else torch.int32).numpy()
    x = np.asarray(x)
    return x.view(np.int16 if x.dtype.name == "bfloat16" else np.int32)


@pytest.mark.parametrize("sigmas", [[1.0, 0.6, 0.2], [0.9, 0.5, 0.0], [0.3]])
def test_custom_sigmas_equal_jax(sigmas):
    port, ref = tsch.set_custom_sigmas(sigmas), jsch.set_custom_sigmas(sigmas)
    assert port.sigmas.dtype == ref.sigmas.dtype == np.float32 and np.array_equal(port.sigmas, ref.sigmas)
    assert (port.num_steps, port.t_start, port.initial_sigma) == (ref.num_steps, ref.t_start, ref.initial_sigma)
    with pytest.raises(ValueError, match="non-empty"):
        tsch.set_custom_sigmas([])


@pytest.mark.parametrize("strength", [1.0, 0.75, 0.5, 0.3, 0.001])
def test_strength_schedule_equals_jax(strength):
    port, ref = tsch.set_timesteps(4, 4096, strength=strength), jsch.set_timesteps(4, 4096, strength=strength)
    assert np.array_equal(port.sigmas, ref.sigmas) and port.t_start == ref.t_start
    assert port.initial_sigma == ref.initial_sigma


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_scale_noise_equals_jax(dtype):
    import jax.numpy as jnp

    rng = np.random.RandomState(0)
    x, noise = rng.randn(2, 16, 128).astype(np.float32), rng.randn(2, 16, 128).astype(np.float32)
    sigma = float(tsch.set_timesteps(4, 16, strength=0.5).initial_sigma)
    ref = jsch.scale_noise(jnp.asarray(x, dtype), sigma, jnp.asarray(noise))
    got = tsch.scale_noise(torch.from_numpy(x).to(getattr(torch, dtype)), sigma, torch.from_numpy(noise))
    assert str(got.dtype) == f"torch.{dtype}" and np.array_equal(_bits(got), _bits(ref))


def test_patchify_latents_equals_jax():
    z = np.random.RandomState(1).randn(2, 32, 8, 12).astype(np.float32)
    got = tlu.patchify_latents(torch.from_numpy(z))
    assert np.array_equal(got.numpy(), np.asarray(jlu.patchify_latents(z)))
    assert torch.equal(tlu.unpatchify_latents(got), torch.from_numpy(z))


def test_position_ids_equal_jax():
    port, ref = tlu.reference_image_position_ids([2, 3], [4, 1]), jlu.reference_image_position_ids([2, 3], [4, 1])
    assert port.dtype == ref.dtype == np.int32 and np.array_equal(port, ref)
    assert np.array_equal(tlu.reference_image_position_ids([2], [2], scale=7), jlu.reference_image_position_ids(
        [2], [2], scale=7))
    assert np.array_equal(tlu.combine_position_ids(5, 64, 96), jlu.combine_position_ids(5, 64, 96))


def test_normalize_with_batchnorm_equals_jax():
    rng = np.random.RandomState(2)
    x = rng.randn(1, 128, 4, 6).astype(np.float32)
    mean, var = rng.randn(128).astype(np.float32), (np.abs(rng.randn(128)) + 0.5).astype(np.float32)
    got = tlu.normalize_with_batchnorm(torch.from_numpy(x), torch.from_numpy(mean), torch.from_numpy(var))
    assert np.array_equal(_bits(got), _bits(jlu.normalize_with_batchnorm(x, mean, var)))
    back = tlu.denormalize_with_batchnorm(got, torch.from_numpy(mean), torch.from_numpy(var))
    assert float((back - torch.from_numpy(x)).abs().max()) < 1e-5


@pytest.mark.parametrize("branch", ["pil", "numpy"])
@pytest.mark.parametrize("hw,max_pixels", [((64, 96), 64 * 64), ((100, 50), 40 * 40), ((64, 64), 64 * 64),
                                           ((37, 300), 1024)])
def test_downscale_to_max_pixels_equals_jax(hw, max_pixels, branch, monkeypatch):
    if branch == "numpy":
        monkeypatch.setitem(__import__("sys").modules, "PIL", None)  # JAX's ImportError fallback
    img = np.random.RandomState(3).rand(*hw, 3).astype(np.float32)
    port = tpipeline._downscale_to_max_pixels(img, max_pixels, multiple=32)
    ref = jpipeline._downscale_to_max_pixels(img, max_pixels, multiple=32)
    assert port.dtype == ref.dtype and port.shape == ref.shape and np.array_equal(port, ref)
    assert port.shape[0] % 32 == 0 and port.shape[1] % 32 == 0


# -- the editing chains' host helpers and native image ops -----------------------------


def _masks() -> dict:
    """Seeded masks of both conventions: grey [H, W] with a soft edge, RGB, RGBA with transparent holes."""
    rng = np.random.RandomState(11)
    grey = np.zeros((80, 96), np.float32)
    grey[20:52, 30:70] = 1.0
    grey[52:60, 30:70] = np.linspace(1.0, 0.0, 8, dtype=np.float32)[:, None]
    rgba = rng.rand(80, 96, 4).astype(np.float32)
    rgba[..., 3] = 1.0
    rgba[10:30, 5:45, 3] = 0.0
    rgba[30:34, 5:45, 3] = 0.4
    return {"grey": (grey, jinpaint.GRAYSCALE_WHITE_INPAINT),
            "rgb": (np.repeat(grey[..., None], 3, axis=2) * rng.uniform(0.9, 1.0, (80, 96, 3)).astype(np.float32),
                    jinpaint.GRAYSCALE_WHITE_INPAINT),
            "alpha": (rgba, jinpaint.ALPHA_TRANSPARENT_INPAINT)}


def _geometry_cases():
    masks = _masks()
    img = np.random.RandomState(12).rand(80, 96, 3).astype(np.float32)
    gen = np.random.RandomState(13).rand(32, 64, 3).astype(np.float32)
    yield "resolve_chain_dimensions", lambda m: [m.resolve_chain_dimensions(w, h, mp) for w, h, mp in (
        (96, 80, 4 << 20), (4000, 3000, 4 << 20), (1000, 37, 1 << 20), (17, 17, 1 << 20), (1023, 2049, 2 << 20))]
    for name, (mask, conv) in masks.items():
        yield f"mask_bounding_box_{name}", lambda m, mask=mask, conv=conv: (
            m.mask_bounding_box(mask, conv), m.mask_bounding_box(mask, conv, threshold=0.3),
            m.mask_bounding_box(np.zeros_like(mask), conv) if conv == jinpaint.GRAYSCALE_WHITE_INPAINT else None)
        yield f"pack_mask_{name}", lambda m, mask=mask, conv=conv: [
            np.asarray(m.pack_mask_for_latent_blending(mask, th, tw, conv)) for th, tw in ((64, 96), (80, 96), (32, 32))]
        yield f"composite_{name}", lambda m, mask=mask, conv=conv: (
            m.composite_on_original(img, gen, mask[32:64, 16:80], (16, 32, 80, 64), conv),
            m.composite_on_original(img, np.random.RandomState(14).rand(80, 96, 3).astype(np.float32), mask, None,
                                    conv))
    yield "expand_crop_region", lambda m: [m.expand_crop_region(b, p, 96, 80) for b, p in (
        ((30, 20, 70, 60), 8), ((0, 0, 5, 5), 0), ((90, 70, 96, 80), 16), ((10, 10, 11, 79), 3), ((1, 1, 95, 79), 40))]
    yield "resize_rgb_pil", lambda m: m._resize_rgb(img, 48, 40)
    yield "round_up_32", lambda m: [m.round_up_32(v) for v in (0, 1, 31, 32, 33, 128, 129)]
    yield "build_outpaint_canvas", lambda m: [m.build_outpaint_canvas(img, t, b, l, r, seed) for t, b, l, r, seed in (
        (32, 0, 32, 64, 0), (0, 32, 0, 0, 1234), (64, 64, 64, 64, -5), (32, 32, 0, 0, 2**40 + 7))]
    yield "build_smart_mask", lambda m: [m.build_smart_mask(*args) for args in (
        (96, 160, 32, 32, 96, 64, 32), (80, 96, 0, 0, 64, 80, 32), (80, 96, 32, 0, 64, 80, 8),
        (64, 64, 16, 16, 32, 32, 64), (48, 48, 0, 16, 48, 1, 32))]


GEOMETRY_CASES = dict(_geometry_cases())
CHAIN_MODULES = {name: (tinpaint, jinpaint) for name in GEOMETRY_CASES}
CHAIN_MODULES.update({name: (toutpaint, joutpaint) for name in GEOMETRY_CASES
                      if name in ("round_up_32", "build_outpaint_canvas", "build_smart_mask")})
FLOAT_HELPERS = ("composite_grey", "composite_rgb", "composite_alpha")


def _flatten(x) -> list:
    if isinstance(x, (list, tuple)):
        return [y for v in x for y in _flatten(v)]
    return [x]


@pytest.mark.parametrize("name", list(GEOMETRY_CASES))
def test_chain_host_helper_equals_jax(name, monkeypatch):
    """Geometry and canvases equal to the bit; the composites and the latent
    masks within 1e-6 (through the native ops, each package its own build)."""
    port_mod, jax_mod = CHAIN_MODULES[name]
    got, ref = _flatten(GEOMETRY_CASES[name](port_mod)), _flatten(GEOMETRY_CASES[name](jax_mod))
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        if isinstance(b, np.ndarray) or hasattr(b, "shape"):
            a, b = np.asarray(a), np.asarray(b)
            assert a.shape == b.shape and a.dtype == b.dtype, name
            if name in FLOAT_HELPERS or name.startswith("pack_mask"):
                np.testing.assert_allclose(a, b, atol=1e-6, rtol=0)
            else:
                assert np.array_equal(a, b), name
        else:
            assert a == b, name


def test_resize_rgb_numpy_branch_equals_jax(monkeypatch):
    monkeypatch.setitem(__import__("sys").modules, "PIL", None)  # JAX's ImportError fallback
    img = np.random.RandomState(15).rand(50, 70, 3).astype(np.float32)
    assert np.array_equal(tinpaint._resize_rgb(img, 32, 96), jinpaint._resize_rgb(img, 32, 96))


def _native_cases():
    rng = np.random.RandomState(16)
    plane, img = rng.rand(97, 53).astype(np.float32), rng.rand(31, 41, 3).astype(np.float32)
    orig, gen, m = rng.rand(40, 30, 3).astype(np.float32), rng.rand(40, 30, 3).astype(np.float32), rng.rand(40, 30)
    u8 = (rng.rand(20, 24, 3) * 255).astype(np.uint8)
    return {
        "area_resize": lambda n: [n.area_resize(plane, dh, dw) for dh, dw in ((8, 8), (97, 53), (5, 13), (40, 30))],
        "resize_bilinear": lambda n: [n.resize_bilinear(img, dh, dw) for dh, dw in ((17, 23), (31, 41), (64, 9))],
        "u8_to_f32": lambda n: n.u8_to_f32(u8),
        "f32_to_u8": lambda n: n.f32_to_u8(np.concatenate([img, -img, img * 3.0], axis=0)),
        "soft_composite": lambda n: n.soft_composite(orig, gen, m.astype(np.float32)),
    }


NATIVE_CASES = _native_cases()


@pytest.mark.parametrize("name", list(NATIVE_CASES))
@pytest.mark.parametrize("path", ["numpy", "cpp"])
def test_native_op_equals_jax(name, path, monkeypatch):
    """Each path against JAX's same path: the numpy fallbacks (forced in both)
    equal to the bit; the port's C++ build within 1e-6 of JAX's (one source,
    JAX's built with -march=native). The two paths differ from each other by
    up to ~2e-6 (bilinear: float32 weights in C++, float64 in numpy)."""
    if path == "numpy":
        monkeypatch.setattr(jnative, "_load", lambda: None)
        monkeypatch.setattr(tnative, "_load", lambda: None)
    else:
        assert tnative.available() and jnative.available(), "g++ should build native/image_ops.cpp"
    for a, b in zip(_flatten(NATIVE_CASES[name](tnative)), _flatten(NATIVE_CASES[name](jnative))):
        assert a.shape == b.shape and a.dtype == b.dtype
        if path == "numpy" or a.dtype == np.uint8:
            assert np.array_equal(a, b), name
        else:
            np.testing.assert_allclose(a, b, atol=1e-6, rtol=0)


def test_subject_mask_morphology_copies_equal_jax():
    """The port's ``_dilate`` / ``_inward_ramp`` (the reference the native ops
    are held against below) and ``saliency_foreground`` equal JAX's to the bit."""
    mask = (np.random.RandomState(18).rand(37, 29) > 0.8).astype(np.float32)
    for r in (0, 1, 4):
        assert np.array_equal(tsubject._dilate(mask, r), jsubject._dilate(mask, r))
        assert np.array_equal(tsubject._inward_ramp(mask, r), jsubject._inward_ramp(mask, r))
    image = np.random.RandomState(19).rand(31, 45, 3).astype(np.float32)
    assert np.array_equal(tsubject.saliency_foreground(image), jsubject.saliency_foreground(image))


@pytest.mark.parametrize("seed,size", [(10_001, 256), (3, 64)])
def test_synth_composite_and_iou_equal_jax(seed, size):
    (img, mask), (jimg, jmask) = (m.synth_composite(np.random.RandomState(seed), size) for m in (tseg, jseg))
    assert np.array_equal(img, jimg) and np.array_equal(mask, jmask) and img.dtype == jimg.dtype
    pred = np.random.RandomState(seed + 1).rand(size, size).astype(np.float32)
    assert tseg.iou(pred, mask) == jseg.iou(pred, jmask) and tseg.iou(pred, mask, 0.7) == jseg.iou(pred, jmask, 0.7)


def test_demo_html_equals_jax():
    assert tserve._DEMO_HTML == jserve._DEMO_HTML


def _quality_cases():
    rng = np.random.RandomState(20)
    a, b = rng.rand(24, 36, 3), rng.rand(24, 36, 3).astype(np.float32)
    chart = jquality.color_chart_image(cell=16)
    return {
        "psnr": lambda q: q.psnr(a, b),
        "psnr_equal": lambda q: q.psnr(a, a),
        "psnr_255": lambda q: q.psnr(a * 255, b * 255, max_val=255.0),
        "mean_rgb_delta": lambda q: q.mean_rgb_delta(a, b),
        "srgb_to_lab": lambda q: q.srgb_to_lab(a),
        "delta_e_cie76": lambda q: q.delta_e_cie76(a, b),
        "color_chart_image": lambda q: q.color_chart_image(cell=8, cols=4),
        "measure_color_chart": lambda q: q.measure_color_chart(chart + 0.01 * a[:1, :1]),
        "color_chart_delta_e": lambda q: q.color_chart_delta_e(np.clip(chart + 0.02, 0, 1)),
        "compare_images": lambda q: q.compare_images(a, b),
        "histogram_similarity": lambda q: q.histogram_similarity(a, b, bins=16),
        "color_moment_similarity": lambda q: q.color_moment_similarity(a, b),
        "color_checker_srgb": lambda q: q.COLOR_CHECKER_SRGB,
    }


QUALITY_CASES = _quality_cases()


@pytest.mark.parametrize("name", list(QUALITY_CASES))
def test_quality_metric_equals_jax(name):
    got, ref = QUALITY_CASES[name](tquality), QUALITY_CASES[name](jquality)
    if isinstance(ref, np.ndarray):
        assert got.dtype == ref.dtype and np.array_equal(got, ref)
    else:
        assert got == ref and type(got) is type(ref)


def test_beacon_dir_and_switch_equal_jax(monkeypatch, tmp_path):
    monkeypatch.delenv("FLUX2_BEACON_DIR", raising=False)
    monkeypatch.setenv("XDG_STATE_HOME", str(tmp_path / "state"))
    assert tbeacon.beacon_dir() == jbeacon.beacon_dir() == str(tmp_path / "state" / "ai-runtime-beacons")
    monkeypatch.setenv("FLUX2_BEACON_DIR", str(tmp_path / "b"))
    assert tbeacon.beacon_dir() == jbeacon.beacon_dir() == str(tmp_path / "b")
    for value, on in (("1", True), ("0", False), ("yes", False)):
        monkeypatch.setenv("FLUX2_RUNTIME_BEACON", value)
        assert tbeacon.enabled() is jbeacon.enabled() is on
    assert tbeacon.list_active() == jbeacon.list_active() == [] and tbeacon.gc_stale_manifests() == 0
    assert not tbeacon.RuntimeBeacon("generate").active  # off unless enabled or forced


def test_native_dilate_ramp_equals_jax_numpy_reference(monkeypatch):
    """Without the library both return None (callers keep their fallback); the
    port's C++ build equals JAX's iterated-erosion reference within 1e-6."""
    monkeypatch.setattr(jnative, "_load", lambda: None)
    mask = (np.random.RandomState(17).rand(48, 64) > 0.85).astype(np.float32)
    assert jnative.dilate_ramp(mask, 3, 4) is None
    for dilation, ramp in ((0, 0), (2, 0), (0, 3), (3, 4), (8, 16)):
        got = tnative.dilate_ramp(mask, dilation, ramp)
        np.testing.assert_allclose(got, _inward_ramp(_dilate(mask, dilation), ramp), atol=1e-6, rtol=0)
    monkeypatch.setattr(tnative, "_load", lambda: None)
    assert tnative.dilate_ramp(mask, 3, 4) is None


def test_native_builds_under_build_not_native():
    """The port's library lives in build/native/, named by the source's hash;
    it never loads the JAX package's native/libflux2_image_ops.so."""
    path = tnative.library_path()
    assert path.parent.parts[-2:] == ("build", "native") and tnative.available()
    assert tnative.path_name() == path.name and path.exists()


# -- training control and state ----------------------------------------------------


def test_config_hash_equals_jax():
    for cfg in (TrainConfig(), TrainConfig(rank=4, alpha=2.0, optimizer="lion", use_ema=True, seed=3)):
        assert tcontrol.config_hash(cfg) == jcontrol.config_hash(cfg)
    assert tcontrol.config_hash({"a": 1, "b": [2]}) == jcontrol.config_hash({"a": 1, "b": [2]})


def test_training_state_and_sentinels_cross_load(tmp_path):
    state = tcontrol.TrainingState(step=7, rng_seed=3, config_hash="abc")
    state.record_loss(0.5)
    state.record_val_loss(7, 0.6, 0.1)
    state.save(str(tmp_path / "port.json"))
    assert _fields(jcontrol.TrainingState.load(str(tmp_path / "port.json"))) == _fields(state)
    jstate = jcontrol.TrainingState(step=2, loss_history=[1.0, 0.9])
    jstate.save(str(tmp_path / "jax.json"))
    assert _fields(tcontrol.TrainingState.load(str(tmp_path / "jax.json"))) == _fields(jstate)
    for writer, reader in ((tcontrol.TrainingController, jcontrol.TrainingController),
                           (jcontrol.TrainingController, tcontrol.TrainingController)):
        out = tmp_path / writer.__module__.replace(".", "_")
        controller = reader(str(out))
        writer.write_sentinel(str(out), "checkpoint")
        assert controller.consume_checkpoint_request() and not controller.consume_checkpoint_request()
        writer.write_sentinel(str(out), "stop")
        assert controller.should_stop()
        writer.clear_sentinel(str(out), "stop")
        assert not controller.should_stop()


# -- safetensors, tokenizer, logging ------------------------------------------------


def _as_torch(x) -> torch.Tensor:
    """A loaded tensor as torch: the port's already are; JAX's numpy arrays
    (bf16 through ml_dtypes) are carried through their bits."""
    if isinstance(x, torch.Tensor):
        return x
    if x.dtype.name == "bfloat16":
        return torch.from_numpy(np.array(x).view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.array(x))


def _for_writer(writer, t: torch.Tensor):
    """What each package's save_file takes: the port torch tensors, JAX numpy (bf16 via ml_dtypes)."""
    if writer is tst:
        return t
    if t.dtype == torch.bfloat16:
        import ml_dtypes

        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def test_lora_and_prequantized_tables_equal_jax(tmp_path):
    """The LoRA loader's Diffusers leaf table, the prequantized directory name,
    path and the source fingerprint: the same in both packages, so each finds
    and accepts the other's files."""
    from flux2_tpu.io import checkpoints as jck
    from flux2_tpu.training import lora_loader as jloader
    from flux2_tpu_torch.io import checkpoints as tck
    from flux2_tpu_torch.training import lora_loader as tloader

    assert tloader._DIFFUSERS_LEAF == jloader._DIFFUSERS_LEAF
    assert tck.PREQUANT_DIRNAME == jck.PREQUANT_DIRNAME == "tpu-prequantized"
    assert tck.prequantized_path("m", "int4") == jck.prequantized_path("m", "int4")
    for name, shape in (("b.safetensors", (3, 2)), ("a.safetensors", (5,)), ("config.json", None)):
        if shape:
            tst.save_file({"w": torch.zeros(shape)}, str(tmp_path / name))
        else:
            (tmp_path / name).write_text("{}")
    os.utime(tmp_path / "a.safetensors", (1_700_000_000.75, 1_700_000_000.75))
    assert tck.source_fingerprint(str(tmp_path)) == jck.source_fingerprint(str(tmp_path))
    assert tck.source_fingerprint(str(tmp_path)).startswith("a.safetensors:") and "config" not in \
        tck.source_fingerprint(str(tmp_path))


@pytest.mark.parametrize("writer,reader", [(tst, jst), (jst, tst)], ids=["port_to_jax", "jax_to_port"])
def test_safetensors_cross_load(tmp_path, writer, reader):
    gen = torch.Generator().manual_seed(0)
    tensors = {"a.b": torch.randn(3, 4, generator=gen), "c": torch.randint(0, 9, (5,), generator=gen).to(torch.int8),
               "d": torch.randn(7, 3, generator=gen).bfloat16()}
    path = str(tmp_path / "x.safetensors")
    writer.save_file({k: _for_writer(writer, v) for k, v in tensors.items()}, path, metadata={"k": "v"})
    loaded = reader.load_file(path)
    assert sorted(loaded) == sorted(tensors)
    for name, value in tensors.items():
        got = _as_torch(loaded[name])
        assert got.dtype == value.dtype and torch.equal(got, value)
    assert reader.load_metadata(path) == {"k": "v"} and sorted(reader.tensor_names(path)) == ["a.b", "c", "d"]
    with open(path, "r+b") as f:  # truncate the payload: both refuse it
        f.truncate(os.path.getsize(path) - 4)
    assert not tst.payload_is_complete(path) and not jst.payload_is_complete(path)
    with pytest.raises(ValueError):
        reader.load_file(path)


def test_dev_tokenizer_gives_jax_ids():
    port, ref = ttok.inline_bpe_tokenizer(), jtok.inline_bpe_tokenizer()
    assert type(port).__name__ == type(ref).__name__
    for text in ("a serene mountain lake at dawn", "warm statue cat toy", "unseen words: ζ and 42"):
        messages = [{"role": "user", "content": text}]
        assert port.apply_chat_template(messages, add_generation_prompt=True) == ref.apply_chat_template(
            messages, add_generation_prompt=True)


def test_logging_equals_jax(capsys):
    for mod in (tlog, jlog):
        mod.set_level("info")
        mod.verbose("hidden")
        mod.info("shown")
        mod.warning("careful")
        with mod.timed("step", level="verbose"):
            pass
    port_lines, jax_lines = np.array_split(capsys.readouterr().err.splitlines(), 2)
    assert list(port_lines) == list(jax_lines) == ["[flux2:info] shown", "[flux2:warn] careful"]
    assert tlog.LEVELS == jlog.LEVELS and tlog.is_loggable("error") and not tlog.is_loggable("verbose")


# -- entry points default to the card -------------------------------------------------


@pytest.mark.parametrize("argv", [["t2i", "--random-init"], ["train-lora", "--config", "x.yaml", "--random-init"],
                                  ["i2i", "--random-init", "--reference", "ref.png"],
                                  ["inpaint", "--random-init", "--image", "a.png", "--mask", "m.png"],
                                  ["outpaint", "--random-init", "--image", "a.png", "--left", "64"],
                                  ["mask-subject", "--image", "a.png"], ["evaluate-lora", "--dataset", "d"],
                                  ["train-lora", "--config", "x.yaml", "--transformer-dir", "t"]],
                         ids=["t2i", "train-lora", "i2i", "inpaint", "outpaint", "mask-subject", "evaluate-lora",
                              "train-lora-checkpoints"])
def test_cli_device_defaults_to_cuda(argv):
    assert tcli.parse_args(argv).device == "cuda"
    assert tcli.parse_args([*argv, "--device", "cpu"]).device == "cpu"


def test_from_random_defaults_to_cuda():
    assert inspect.signature(Flux2Pipeline.from_random).parameters["device"].default == "cuda"


# -- the Dev / text-generation slice: the Tekken tokenizer and the BFL system prompts -------------------


@pytest.mark.parametrize("text", ["", "a red fox", "héllo — テスト 🚀\n\ttabs", "[IMG]<s>[INST]"])
def test_tekken_copy_equals_jax(text):
    """``models/text_encoders/tekken.py`` is a copy of JAX's: the byte
    fallback and the goldens' fixture give JAX's ids, decodes and chat ids
    (the full cases in tests/test_torch_tekken.py)."""
    from flux2_tpu.models.text_encoders.tekken import TekkenTokenizer as JTekken
    from flux2_tpu_torch.models.text_encoders.tekken import TekkenTokenizer

    fixture = os.path.join(os.path.dirname(__file__), "goldens", "tekken_fixture.json")
    for port, ref in ((TekkenTokenizer.byte_fallback(), JTekken.byte_fallback()),
                      (TekkenTokenizer.from_pretrained(fixture), JTekken.from_pretrained(fixture))):
        ids = port.encode(text, add_special_tokens=True)
        assert ids == ref.encode(text, add_special_tokens=True)
        assert port.decode(ids, skip_special_tokens=False) == ref.decode(ids, skip_special_tokens=False)
        messages = [{"role": "system", "content": text}, {"role": "user", "content": text}]
        assert port.apply_chat_template(messages) == ref.apply_chat_template(messages)
        assert (port.vocab_size, port.pad_token_id, port.eos_token_id) == (ref.vocab_size, ref.pad_token_id,
                                                                           ref.eos_token_id)


def test_bfl_system_prompts_equal_jax():
    from flux2_tpu.models.text_encoders import extractor as jext
    from flux2_tpu_torch.models.text_encoders import extractor as text

    for name in ("SYSTEM_MESSAGE_EMBEDDINGS", "SYSTEM_MESSAGE_UPSAMPLING_T2I", "SYSTEM_MESSAGE_UPSAMPLING_I2I"):
        assert getattr(text, name) == getattr(jext, name)


# -- the VLM slice: the copied prompt strings and the prompt builder ------------------------------------------


def test_vlm_service_prompts_equal_jax():
    from flux2_tpu.models.text_encoders import vlm_service as jsvc
    from flux2_tpu_torch.models.text_encoders import vlm_service as tsvc

    for name in ("SCORING_SYSTEM_PROMPT", "FLUX_IMAGE_COMPARISON_SYSTEM_PROMPT"):
        assert getattr(tsvc, name) == getattr(jsvc, name)
    # JAX writes the analyst's system prompt inline in Qwen35VLMService.analyze_image
    assert f'"{tsvc.ANALYST_SYSTEM_PROMPT}"' in inspect.getsource(jsvc.Qwen35VLMService.analyze_image)


def test_vlm_prompt_builder_copy_equals_jax():
    from flux2_tpu.chains import vlm_prompt as jvp
    from flux2_tpu_torch.chains import vlm_prompt as tvp

    assert [i.value for i in tvp.InpaintIntent] == [i.value for i in jvp.InpaintIntent]
    assert {k.value: v for k, v in tvp.SYSTEM_PROMPTS.items()} == {k.value: v for k, v in jvp.SYSTEM_PROMPTS.items()}
    assert tvp.OUTPAINT_SYSTEM_PROMPT == jvp.OUTPAINT_SYSTEM_PROMPT
    calls = []
    for mod in (tvp, jvp):
        builder = mod.VLMPromptBuilder(vlm_chat=lambda s, u, img: calls.append((s, u, img)) or f" {u} ")
        assert builder.is_loaded and not mod.VLMPromptBuilder().is_loaded
        assert builder.build_outpaint_prompt("a street", "IMG", ["top", "left"]) == \
            "Sides being extended: left, top. Scene request: a street"
        assert builder.build_inpaint_prompt(mod.InpaintIntent("remove"), "a table", "IMG") == "a table"
        assert mod.VLMPromptBuilder().build_inpaint_prompt(mod.InpaintIntent.MODIFY, "x", None) is None
        assert mod.VLMPromptBuilder(vlm_chat=lambda *a: 1 / 0).build_outpaint_prompt("x", None, ["top"]) is None
    assert calls[:2] == calls[2:]


@pytest.mark.parametrize("name", ["DIT_RULES", "DECODER_RULES", "VAE_RULES"])
def test_partition_rule_tables_equal_jax(name):
    """The port's copies of JAX's rule tables (flux2_tpu/parallel/sharding.py): each (regex, spec) pair,
    the spec a tuple of mesh axis names where JAX's is a PartitionSpec; the axis names and
    spec_for_path's resolution (a quantized child's flat-index suffix stripped) too."""
    from flux2_tpu.parallel import mesh as jmesh
    from flux2_tpu.parallel import sharding as jsh
    from flux2_tpu_torch.parallel import mesh as tmesh
    from flux2_tpu_torch.parallel import sharding as tsh

    port, ref = getattr(tsh, name), getattr(jsh, name)
    assert [(pattern, tuple(spec)) for pattern, spec in port] == [(pattern, tuple(spec)) for pattern, spec in ref]
    assert tmesh.AXIS_NAMES == jmesh.AXIS_NAMES
    for path in ("double_blocks/to_q", "double_blocks/to_q/[<flat index 1>]", "single_blocks/norm_q",
                 "x_embedder/kernel", "time_embed/linear1", "layers/q_proj", "embed_tokens", "lm_head",
                 "final_norm", "decoder/conv_in"):
        assert tsh.spec_for_path(path, port) == tuple(jsh.spec_for_path(path, ref)), path
