"""Quantized models and serving in the port (CPU).

- The Qwen3 decoder built by ``decoder_from_jax`` from a pytree quantized by
  JAX's ``quantize_encoder_params`` quantizes the same leaves and matches JAX's
  hidden states within 1e-5 max abs (f32), the dense decoder's tolerance. The
  decoder is TINY_DECODER widened to hidden 512: at hidden 64 no stacked
  leaf reaches ``quantize_params``' 65536 elements and nothing would quantize.
- A full-depth Klein-4B DiT at reduced width (4 heads), in bf16, quantized to
  each runtime, with every matmul that passes a kernel gate computed by that
  kernel's plain version (the card's arithmetic, activation quantization
  included), stays within chip_smoke.py's quantized-vs-bf16 tolerances of
  the bf16 forward. The errors measured here (0.033 w8a8, 0.26 w4a8, 0.020
  qint8, 0.21 int4 relative L2) hold within ~10% from 4 to 16 heads; the
  tolerances are about 2-3x these.
- ``cli.main.build_pipeline`` builds a w8a8 pipeline (DiT and encoder) that
  serves requests, exits with JAX's message where no checkpoint is found, and
  refuses what it does not port.
"""

import argparse
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flux2_tpu.models.text_encoders import decoder as jdec
from flux2_tpu.models.text_encoders.facade import quantize_encoder_params as jax_quantize_encoder_params
from flux2_tpu_torch.cli import main as tcli
from flux2_tpu_torch.io.jax_params import decoder_from_jax
from flux2_tpu_torch.io.png import decode_png
from flux2_tpu_torch.models.flux2 import transformer as ttfm
from flux2_tpu_torch.models.flux2.vae import VAEConfig
from flux2_tpu_torch.models.text_encoders.extractor import quantize_encoder_params
from flux2_tpu_torch.ops import latents as lu
from flux2_tpu_torch.ops import quant as tq
from flux2_tpu_torch.ops import quant_kernels as tqk
from flux2_tpu_torch.ops.rope import rope_embeddings
from flux2_tpu_torch.serve import Flux2Server

from flux2_tpu_torch.models.flux2.config import KLEIN_4B, Flux2Model, Flux2TransformerConfig
from flux2_tpu_torch.models.text_encoders.config import TINY_DECODER
from tests.test_torch_shared_copies import jax_config
from tests.test_torch_text_encoder import _ids_mask
from tests.test_torch_transformer import perturbed_numpy

WIDE_DECODER = dataclasses.replace(TINY_DECODER, hidden_size=512, intermediate_size=1024, num_hidden_layers=2,
                                   num_attention_heads=4, num_key_value_heads=2, head_dim=128)
ENCODER_TOL = 1e-5
# Quantized DiT forward against the bf16 one, relative L2; chip_smoke.py holds
# the full-width forward on the card to the same limits.
DIT_QUANT_REL_TOL = {"w8a8": 0.1, "w4a8": 0.5, "qint8": 0.06, "int4": 0.4}


@pytest.mark.parametrize("fmt", ["w8a8", "w4a8", "qint8"])
def test_encoder_on_jax_quantized_params_matches_jax(fmt):
    dense = perturbed_numpy(jdec.init_params(jax.random.PRNGKey(4), jax_config(WIDE_DECODER), dtype=jnp.float32), 4)
    qparams = jax_quantize_encoder_params(jax.tree_util.tree_map(jnp.asarray, dense), fmt)
    decoder = decoder_from_jax(qparams, WIDE_DECODER)
    names = tq.quantized_names(decoder)
    jax_names = {f"layers.{i}.{k}" for k, v in qparams["layers"].items() if _jax_quantized(v)
                 for i in range(WIDE_DECODER.num_hidden_layers)}
    assert set(names) == jax_names != set()
    own = quantize_encoder_params(decoder_from_jax(dense, WIDE_DECODER), fmt)
    assert tq.quantized_names(own) == names

    ids, mask = _ids_mask(np.random.RandomState(5), 2, 12, [12, 7], WIDE_DECODER.vocab_size)
    ref = jdec.forward_hidden_states(qparams, jax_config(WIDE_DECODER), jnp.asarray(ids), jnp.asarray(mask))
    with torch.inference_mode():
        out = decoder.forward_hidden_states(torch.from_numpy(ids).long(), torch.from_numpy(mask))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ENCODER_TOL, rtol=0)


def _jax_quantized(leaf) -> bool:
    return hasattr(leaf, "q") and hasattr(leaf, "orig_in")


def _card_q_linear(x, w):
    """``q_linear`` with the CUDA routes taken on the CPU, through each wrapper's plain version."""
    route = tq.kernel_route(x, w) if tq.is_quantized(w) else None
    if route == "w8a8":
        return tqk.w8a8_matmul(x, w)
    if route == "w4a8":
        return tqk.w4a8_matmul(x, w)
    if route == "dequant":
        return tqk.dequant_matmul(x, w)
    return tq.q_linear(x, w)


@pytest.fixture(scope="module")
def narrow_klein():
    """Klein-4B at full depth, 4 heads, bf16; a 256^2 image and 512 text tokens."""
    config = dataclasses.replace(KLEIN_4B, num_attention_heads=4)
    gen = torch.Generator().manual_seed(0)
    model = ttfm.Flux2Transformer(config, dtype=torch.bfloat16, generator=gen)
    emb = torch.randn(1, 512, config.joint_attention_dim, generator=gen).bfloat16()
    ids = np.concatenate([lu.text_position_ids(512), lu.image_position_ids(256, 256)])
    cos, sin = rope_embeddings(torch.from_numpy(ids))
    inputs = (lu.seeded_noise_seq(0, 256, 256, 1, device="cpu").bfloat16(), emb, torch.full((1,), 0.7), cos, sin)
    with torch.inference_mode():
        ref = model(*inputs).float()
    return config, model.state_dict(), inputs, ref


@pytest.mark.parametrize("fmt", ["w8a8", "w4a8", "qint8", "int4"])
def test_quantized_dit_tracks_bf16_within_the_chip_tolerance(narrow_klein, fmt, monkeypatch):
    config, state, inputs, ref = narrow_klein
    monkeypatch.setenv("FLUX2_PALLAS_DEQUANT", "1")
    monkeypatch.setattr(ttfm, "q_linear", _card_q_linear)
    model = ttfm.Flux2Transformer(config, dtype=torch.bfloat16)
    model.load_state_dict(state)
    tq.quantize_params(model, fmt)
    with torch.inference_mode():
        out = model(*inputs)
    assert out.dtype == torch.bfloat16 and torch.isfinite(out).all()
    rel = float((out.float() - ref).norm() / ref.norm())
    assert rel <= DIT_QUANT_REL_TOL[fmt], rel


TINY_DIT = Flux2TransformerConfig(num_layers=1, num_single_layers=1, num_attention_heads=4,
                                  attention_head_dim=128, joint_attention_dim=192, guidance_embeds=False)
TINY_VAE = VAEConfig(block_out_channels=(8, 8, 8, 8), layers_per_block=1, norm_num_groups=4)
# The Klein recipe reads hidden layers (9, 18, 27): 28 layers, hidden 64 -> joint 192.
TINY_QWEN3 = dataclasses.replace(TINY_DECODER, num_hidden_layers=28, vocab_size=600)


def _args(**kw):
    base = dict(model="klein-4b", quantization="bf16", encoder_quantization="bf16", random_init=True)
    return argparse.Namespace(**{**base, **kw})


def _tiny_pipeline(**kw):
    return tcli.build_pipeline(_args(**kw), "cpu", torch.Generator().manual_seed(0), transformer_config=TINY_DIT,
                               vae_config=TINY_VAE, encoder_config=TINY_QWEN3)


def test_build_pipeline_serves_w8a8_requests():
    pipe = _tiny_pipeline(quantization="w8a8", encoder_quantization="w8a8")
    dense = _tiny_pipeline()
    names = tq.quantized_names(pipe.transformer)
    assert {"x_embedder", "double_blocks.0.to_q", "single_blocks.0.mlp_gate"} <= set(names)
    assert set(names.values()) == {"w8a8"} and "norm_out" not in names
    assert set(tq.quantized_names(pipe.text_encoder.decoder).values()) == {"w8a8"}
    assert tq.param_bytes(pipe.transformer) < 0.6 * tq.param_bytes(dense.transformer)
    server = Flux2Server(pipe, embeddings_fn=pipe.encode_prompt)
    try:
        pngs = [server.generate_png({"prompt": p, "height": 64, "width": 64, "steps": 2, "seed": i})
                for i, p in enumerate(["a red fox", "a blue fox"])]
    finally:
        server.shutdown()
    for png in pngs:
        assert decode_png(png).shape == (64, 64, 3)
    assert server.requests_served == 2


def test_stream_dtype_is_bf16_under_a_quantized_x_embedder(monkeypatch):
    """JAX ``_param_dtype``: a float32 pipeline whose x_embedder is quantized denoises in bf16."""
    pipe = _tiny_pipeline()
    pipe.transformer.float()
    seen = []
    forward = pipe.transformer.forward
    monkeypatch.setattr(pipe.transformer, "forward", lambda x, *a, **k: seen.append(x.dtype) or forward(x, *a, **k))
    emb = torch.zeros(1, 4, TINY_DIT.joint_attention_dim)
    pipe.generate(embeddings=emb, height=32, width=32, num_steps=1, decode=False)
    tq.quantize_params(pipe.transformer, "w8a8")
    assert isinstance(pipe.transformer.x_embedder, tq.W8A8Tensor)
    res = pipe.generate(embeddings=emb, height=32, width=32, num_steps=1, decode=False)
    assert seen == [torch.float32, torch.bfloat16]
    assert res.latents_device.dtype == torch.float32 and torch.isfinite(res.latents_device).all()


def test_build_pipeline_refuses_what_is_not_ported(tmp_path, monkeypatch):
    monkeypatch.setenv("FLUX2_MODELS_DIR", str(tmp_path / "models"))
    monkeypatch.setenv("HF_HOME", str(tmp_path / "hf"))
    with pytest.raises(SystemExit, match="transformer weights for klein-4b not found"):
        tcli.build_pipeline(_args(random_init=False), "cpu")  # no checkpoint anywhere
    with pytest.raises(ValueError):
        tcli.build_pipeline(_args(quantization="fp3"), "cpu")
    with pytest.raises(ValueError):
        tcli.build_pipeline(_args(encoder_quantization="nf4"), "cpu")  # not an encoder choice in JAX
    # Dev builds since the Mistral encoder is ported: a tiny llama4 Mistral (31 layers: the recipe reads
    # hidden layers 10, 20 and 30; joint = 3 x its hidden) with the Mistral recipe, quantized as asked
    mistral = dataclasses.replace(TINY_QWEN3, num_hidden_layers=31, qk_norm=False, tie_word_embeddings=False,
                                  llama4_scaling_beta=0.1, vocab_size=1300)
    dev = tcli.build_pipeline(_args(model=Flux2Model.DEV.value, encoder_quantization="w8a8"), "cpu",
                              torch.Generator().manual_seed(0), encoder_config=mistral,
                              transformer_config=dataclasses.replace(TINY_DIT, guidance_embeds=True),
                              vae_config=TINY_VAE)
    assert dev.text_encoder_name == "mistral" and dev.text_encoder.recipe == "mistral"
    assert tq.quantized_names(dev.text_encoder.decoder) and not tq.is_quantized(dev.text_encoder.decoder.lm_head)
    assert dev.encode_prompt("a fox").shape == (1, 512, TINY_DIT.joint_attention_dim)
    # --shard parses since parallelism is ported; without torchrun the world is one rank, so a larger
    # mesh exits naming the count
    assert tcli._parser().parse_args(["t2i", "--random-init", "--shard", "auto"]).shard == "auto"
    with pytest.raises(SystemExit, match=r"mesh \[1, 2, 4, 1\] does not cover 1 devices: this run has 1 rank"):
        tcli.build_pipeline(_args(shard="1,2,4"), "cpu", torch.Generator().manual_seed(0),
                            transformer_config=TINY_DIT, vae_config=TINY_VAE, encoder_config=TINY_QWEN3)
