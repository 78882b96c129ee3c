"""The public names the port added so that every JAX name has a counterpart, each against JAX's on the CPU.

``ops/latents.py`` (``generate_patchified_latents``, the Ostris
``normalize_flux2_latents`` / ``denormalize_flux2_latents`` and their two
constants), ``ops/scheduler.py`` (``SigmaSchedule.timesteps``,
``get_velocity``, which the trainer now imports), ``training/lora.py``
(``lora_zeros_like``), ``utils/memory.py`` (``total_hbm_bytes``),
``models/flux2/vae.py`` (``VAEConfig.is_small_decoder``, ``TINY_VAE``,
``param_count``) and ``models/flux2/transformer.py`` (``param_count``).
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flux2_tpu.models.flux2 import config as jcfg
from flux2_tpu.models.flux2 import transformer as jtfm
from flux2_tpu.models.flux2 import vae as jvae
from flux2_tpu.ops import latents as jlu
from flux2_tpu.ops import scheduler as jsch
from flux2_tpu.training import lora as jlora
from flux2_tpu_torch.io.jax_params import lora_from_jax
from flux2_tpu_torch.models.flux2 import transformer as ttfm
from flux2_tpu_torch.models.flux2 import vae as tvae
from flux2_tpu_torch.models.flux2.config import Flux2TransformerConfig
from flux2_tpu_torch.ops import latents as tlu
from flux2_tpu_torch.ops import scheduler as tsch
from flux2_tpu_torch.training import lora as tlora
from flux2_tpu_torch.training import trainer
from flux2_tpu_torch.utils import memory as tmem

TINY = dict(num_layers=1, num_single_layers=2, num_attention_heads=2, attention_head_dim=128,
            joint_attention_dim=96, guidance_embeds=True)


def _size(tree) -> int:
    return sum(int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(tree))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_generate_patchified_latents(dtype):
    """JAX's shape [B, 128, H/16, W/16] and dtype; unit-normal draws that follow the generator."""
    want = jlu.generate_patchified_latents(jax.random.PRNGKey(0), 512, 256, 3, jnp.float32)
    out = tlu.generate_patchified_latents(torch.Generator().manual_seed(0), 512, 256, 3, dtype)
    assert tuple(out.shape) == want.shape == (3, 128, 32, 16) and out.dtype == dtype
    again = tlu.generate_patchified_latents(torch.Generator().manual_seed(0), 512, 256, 3, dtype)
    assert torch.equal(out, again)
    x = out.float()
    assert abs(float(x.mean())) < 0.02 and abs(float(x.std()) - 1) < 0.02


def test_flux2_latent_normalization_equals_jax():
    assert (tlu.FLUX2_SCALING_FACTOR, tlu.FLUX2_SHIFT_FACTOR) == (jlu.FLUX2_SCALING_FACTOR, jlu.FLUX2_SHIFT_FACTOR)
    x = np.random.RandomState(0).standard_normal((2, 32, 4, 4)).astype(np.float32)
    norm = tlu.normalize_flux2_latents(torch.from_numpy(x))
    np.testing.assert_allclose(norm.numpy(), np.asarray(jlu.normalize_flux2_latents(jnp.asarray(x))), rtol=0, atol=1e-6)
    back = tlu.denormalize_flux2_latents(norm)
    np.testing.assert_allclose(back.numpy(), np.asarray(jlu.denormalize_flux2_latents(jnp.asarray(norm.numpy()))),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(back.numpy(), x, rtol=0, atol=1e-5)


@pytest.mark.parametrize("steps,seq,strength", [(4, 4096, 1.0), (28, 1024, 0.6), (4, 1536, 0.35)])
def test_schedule_timesteps_equal_jax(steps, seq, strength):
    got = tsch.set_timesteps(steps, image_seq_len=seq, strength=strength).timesteps
    want = jsch.set_timesteps(steps, image_seq_len=seq, strength=strength).timesteps
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_get_velocity_equals_jax_and_is_the_trainers():
    rng = np.random.RandomState(1)
    sample, noise = (rng.standard_normal((2, 8, 128)).astype(np.float32) for _ in range(2))
    got = tsch.get_velocity(torch.from_numpy(sample), torch.from_numpy(noise))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jsch.get_velocity(jnp.asarray(sample), jnp.asarray(noise))))
    assert trainer.get_velocity is tsch.get_velocity


def test_lora_zeros_like_equals_jax():
    """JAX's zeros tree, adapter for adapter; the adapters it copies the shapes of stay as they were."""
    params = jax.eval_shape(lambda k: jtfm.init_params(k, jcfg.Flux2TransformerConfig(**TINY), dtype=jnp.float32),
                            jax.random.PRNGKey(0))
    jl = jax.jit(lambda k: jlora.init_lora(k, params, jlora.LoRAConfig(4, 8.0)))(jax.random.PRNGKey(1))
    want = lora_from_jax(jax.tree_util.tree_map(np.asarray, jlora.lora_zeros_like(jl)))
    lora = lora_from_jax(jax.tree_util.tree_map(np.asarray, jl))
    before = {k: v.clone() for k, v in lora.state_dict().items()}
    got = tlora.lora_zeros_like(lora)
    assert isinstance(got, tlora.LoRA) and got.targets() == lora.targets() == want.targets()
    gs, ws = got.state_dict(), want.state_dict()
    assert list(gs) == list(ws)
    for k in ws:
        assert torch.equal(gs[k], ws[k]) and gs[k].dtype == ws[k].dtype, k
        assert torch.equal(lora.state_dict()[k], before[k]), k
    assert tlora.num_lora_params(got) == jlora.num_lora_params(jl)


def test_total_hbm_bytes(monkeypatch):
    """The summed CUDA memory (JAX: every device's limit); without CUDA it raises, as the module always has."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmem.total_hbm_bytes()
    sizes = [80 * 2**30, 40 * 2**30]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda i: types.SimpleNamespace(total_memory=sizes[i]))
    assert tmem.total_hbm_bytes() == sum(sizes)


def test_vae_config_is_small_decoder_and_tiny_vae_equal_jax():
    for tcfg, jc in ((tvae.FLUX2_VAE, jvae.FLUX2_VAE), (tvae.FLUX2_VAE_SMALL_DECODER, jvae.FLUX2_VAE_SMALL_DECODER)):
        assert tcfg.is_small_decoder == jc.is_small_decoder
    d = {"decoder_block_out_channels": [96, 192, 384, 384]}
    assert tvae.VAEConfig.from_json_dict(d).is_small_decoder == jvae.VAEConfig.from_json_dict(d).is_small_decoder
    assert not tvae.VAEConfig.from_json_dict({}).is_small_decoder
    assert dataclasses.asdict(tvae.TINY_VAE) == dataclasses.asdict(jvae.TINY_VAE)


@pytest.mark.parametrize("small", [False, True], ids=["full", "small_decoder"])
def test_vae_param_count_equals_jax(small):
    """Both halves and the BatchNorm statistics: JAX's leaf count of ``init_params``."""
    cfg = dataclasses.replace(tvae.TINY_VAE, decoder_block_out_channels=(8, 8) if small else None)
    jc = jvae.VAEConfig(**dataclasses.asdict(cfg))
    want = _size(jax.eval_shape(lambda k: jvae.init_params(k, jc), jax.random.PRNGKey(0)))
    got = tvae.param_count(tvae.VAEDecoder(cfg, device="meta"), tvae.VAEEncoder(cfg, device="meta"))
    assert got == want


@pytest.mark.parametrize("fmt", ["bf16", "w8a8"])
def test_transformer_param_count_equals_jax(fmt):
    """Dense, and W8A8 (JAX counts each quantized leaf's codes and scales)."""
    from flux2_tpu.ops import quant as jquant
    from flux2_tpu_torch.ops import quant as tquant

    kw = dict(TINY, joint_attention_dim=256)
    quantize = (lambda p: p) if fmt == "bf16" else (lambda p: jquant.w8a8_params(p, min_size=1 << 10))
    want = _size(jax.eval_shape(lambda k: quantize(jtfm.init_params(k, jcfg.Flux2TransformerConfig(**kw))),
                                jax.random.PRNGKey(0)))
    model = ttfm.Flux2Transformer(Flux2TransformerConfig(**kw), device="meta", dtype=torch.float32)
    if fmt != "bf16":
        tquant.quantize_params(model, fmt, min_size=1 << 10)
    assert ttfm.param_count(model) == want
