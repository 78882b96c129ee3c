"""The loaders' block-by-block fill (``io/weight_mapping.load_transformer`` and
``load_decoder``): with ``quantization=`` each block is quantized as soon as
it is filled, and the result equals a whole load followed by
``quantize_params`` / ``quantize_encoder_params``, to the bit; without it,
the model built on the device and filled whole. Tiny shapes, CPU, one torch
thread."""

from __future__ import annotations

import dataclasses

import pytest
import torch

from flux2_tpu_torch.io import weight_mapping as wm
from flux2_tpu_torch.models.flux2.config import Flux2TransformerConfig
from flux2_tpu_torch.models.flux2.transformer import Flux2Transformer
from flux2_tpu_torch.models.text_encoders.config import MISTRAL_SMALL_3_2
from flux2_tpu_torch.models.text_encoders.decoder import Qwen3Decoder
from flux2_tpu_torch.models.text_encoders.extractor import quantize_encoder_params
from flux2_tpu_torch.ops.quant import quantize_params, quantized_names
from flux2_tpu_torch.utils import synthetic

DIT = Flux2TransformerConfig(num_layers=2, num_single_layers=3, num_attention_heads=2, attention_head_dim=256,
                             joint_attention_dim=512, guidance_embeds=True)
# Mistral-shaped (no q/k norm, llama4 scaling, untied head); a layer's q_proj
# (64 x 64) passes quantize_params' size filter only as one of 31 layers
MISTRAL = dataclasses.replace(MISTRAL_SMALL_3_2, vocab_size=300, hidden_size=64, intermediate_size=128,
                              num_hidden_layers=31, num_attention_heads=4, num_key_value_heads=2, head_dim=16)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _dit_state() -> dict:
    src = Flux2Transformer(DIT, device="cpu", dtype=torch.float32, generator=torch.Generator().manual_seed(3))
    state = synthetic.diffusers_transformer_state(src)
    state["time_guidance_embed.guidance_embedder.linear_1.weight"] = src.guidance_linear1
    state["time_guidance_embed.guidance_embedder.linear_2.weight"] = src.guidance_linear2
    return state


def _decoder_state() -> dict:
    """A Mistral3 checkpoint's language model (``language_model.`` names)."""
    src = Qwen3Decoder(MISTRAL, device="cpu", dtype=torch.float32, generator=torch.Generator().manual_seed(4))
    names = {"input_norm": "input_layernorm", "post_attn_norm": "post_attention_layernorm",
             "q_proj": "self_attn.q_proj", "k_proj": "self_attn.k_proj", "v_proj": "self_attn.v_proj",
             "o_proj": "self_attn.o_proj", "gate_proj": "mlp.gate_proj", "up_proj": "mlp.up_proj",
             "down_proj": "mlp.down_proj"}
    state = {"language_model.model.embed_tokens.weight": src.embed_tokens,
             "language_model.model.norm.weight": src.final_norm, "language_model.lm_head.weight": src.lm_head}
    for i, layer in enumerate(src.layers):
        for attr, name in names.items():
            state[f"language_model.model.layers.{i}.{name}.weight"] = getattr(layer, attr)
    return state


def _tensors(module) -> dict:
    return {**dict(module.named_parameters()), **dict(module.named_buffers())}


def _assert_same(a, b):
    ta, tb = _tensors(a), _tensors(b)
    assert ta.keys() == tb.keys()
    for name in ta:
        assert ta[name].dtype == tb[name].dtype and ta[name].device == tb[name].device, name
        assert torch.equal(ta[name], tb[name]), name
    assert quantized_names(a) == quantized_names(b)


@pytest.mark.parametrize("fmt", ["w8a8", "w4a8", "qint8"])
def test_dit_quantized_per_block_equals_load_then_quantize(fmt):
    state = _dit_state()
    whole = Flux2Transformer(DIT, device="cpu", dtype=torch.bfloat16)
    assert not wm.fill(whole, wm.map_transformer_weights(state, DIT))
    quantize_params(whole, fmt)
    by_block = wm.load_transformer(state, DIT, "cpu", quantization=fmt)
    assert quantized_names(whole), "the tiny DiT must quantize something"
    _assert_same(whole, by_block)


@pytest.mark.parametrize("fmt", ["w8a8", "qint8"])
def test_decoder_quantized_per_layer_equals_load_then_quantize(fmt):
    state = _decoder_state()
    whole = Qwen3Decoder(MISTRAL, device="cpu", dtype=torch.bfloat16)
    assert not wm.fill(whole, wm.map_decoder_weights(state))
    quantize_encoder_params(whole, fmt)
    by_layer = wm.load_decoder(state, MISTRAL, "cpu", quantization=fmt)
    names = quantized_names(whole)
    assert "layers.30.q_proj" in names and not any(n.startswith(("embed", "lm_head")) for n in names)
    _assert_same(whole, by_layer)


def test_quantized_load_keeps_the_missing_weight_error():
    state = _dit_state()
    del state["time_guidance_embed.guidance_embedder.linear_1.weight"]
    with pytest.raises(KeyError, match="guidance embedder"):
        wm.load_transformer(state, DIT, "cpu", quantization="w8a8")
    state = _decoder_state()
    del state["language_model.model.layers.7.mlp.up_proj.weight"]
    with pytest.raises(KeyError, match="layers.7.up_proj"):
        wm.load_decoder(state, MISTRAL, "cpu", quantization="w8a8")


@pytest.mark.parametrize("part", ["dit", "decoder"])
def test_bf16_keyword_is_the_plain_load(part):
    """Unquantized, the block-by-block load equals the model built on the
    device and filled whole (``fill``), with or without the keyword."""
    if part == "dit":
        state, load = _dit_state(), wm.load_transformer
        plain = Flux2Transformer(DIT, device="cpu", dtype=torch.bfloat16)
        assert not wm.fill(plain, wm.map_transformer_weights(state, DIT))
        args = (state, DIT, "cpu")
    else:
        state, load = _decoder_state(), wm.load_decoder
        plain = Qwen3Decoder(MISTRAL, device="cpu", dtype=torch.bfloat16)
        assert not wm.fill(plain, wm.map_decoder_weights(state))
        args = (state, MISTRAL, "cpu")
    _assert_same(plain, load(*args))
    _assert_same(plain, load(*args, quantization="bf16"))
