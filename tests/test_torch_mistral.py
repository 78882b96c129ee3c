"""The port's decoder as Mistral Small 3.2 (llama4 query scaling, untied LM
head, GQA 4:2) against the JAX package's, on the CPU.

Weights: JAX's ``decoder.init_params`` at a tiny llama4 config whose
``original_max_position_embeddings`` is 8, so that the query scale moves
from 1 to 1 + 0.1 log 2 within a 12-token prompt (the published 16384 keeps
it at 1 for any prompt this repo encodes); every leaf perturbed with seeded
noise and carried across by ``decoder_from_jax``. Widths are multiples of
256 where K5's gate needs them, so the w8a8 layers take the kernel's plain
version where it applies. Held in float32 within 1e-4 max abs (hidden
states O(1), logits O(10)): ``forward_hidden_states`` with left padding,
``extract_hidden_layers``, ``forward_logits``, and ``prefill`` followed by 8
``decode_step``s against JAX's. A bf16 run of the port is held against JAX
in float32 within 3e-2 relative L2 (8 bf16 roundings a layer, 2 layers),
and the w8a8 / int4 encoders (``quantize_encoder_params``: the layers only,
the LM head dense) against JAX's quantized ones within 1e-4.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flux2_tpu.models.text_encoders import decoder as jdec
from flux2_tpu.models.text_encoders import facade as jfacade
from flux2_tpu_torch.io.jax_params import decoder_from_jax
from flux2_tpu_torch.models.text_encoders import decoder as tdec
from flux2_tpu_torch.models.text_encoders.config import DecoderConfig
from flux2_tpu_torch.models.text_encoders.extractor import quantize_encoder_params
from flux2_tpu_torch.ops import quant as tq

from tests.test_torch_lora_loader import one_torch_thread  # noqa: F401  (module fixture)
from tests.test_torch_shared_copies import jax_config
from tests.test_torch_transformer import perturbed_numpy

TOL = 1e-4
BF16_REL_TOL = 3e-2

TINY_MISTRAL = DecoderConfig(
    vocab_size=512, hidden_size=256, intermediate_size=512, num_hidden_layers=2, num_attention_heads=4,
    num_key_value_heads=2, head_dim=64, rms_norm_eps=1e-5, tie_word_embeddings=False, qk_norm=False,
    llama4_scaling_beta=0.1, original_max_position_embeddings=8,
)


@pytest.fixture(scope="module")
def params():
    return perturbed_numpy(jdec.init_params(jax.random.PRNGKey(3), jax_config(TINY_MISTRAL), dtype=jnp.float32), 3)


@pytest.fixture(scope="module")
def port(params):
    return decoder_from_jax(params, TINY_MISTRAL)


def _ids_mask(b, s, lengths, seed=1):
    rng = np.random.RandomState(seed)
    ids = rng.randint(1, TINY_MISTRAL.vocab_size, size=(b, s)).astype(np.int32)
    mask = (np.arange(s)[None, :] >= s - np.asarray(lengths)[:, None]).astype(np.int32)  # LEFT padding
    return np.where(mask > 0, ids, 11).astype(np.int32), mask


def _t(a):
    return torch.from_numpy(np.asarray(a)).long()


def test_llama4_scale_moves_and_equals_jax():
    pos = np.arange(40)
    out = tdec.llama4_attention_scale(torch.from_numpy(pos), 0.1, 8).numpy()
    ref = np.asarray(jdec.llama4_attention_scale(jnp.asarray(pos), 0.1, 8))
    np.testing.assert_array_equal(out, ref)
    assert out[7, 0] == 1.0 and out[8, 0] > 1.0 and out[39, 0] > out[16, 0]


def test_hidden_states_left_padded_match_jax(params, port):
    ids, mask = _ids_mask(2, 12, [12, 7])
    ref = jdec.forward_hidden_states(params, jax_config(TINY_MISTRAL), jnp.asarray(ids), jnp.asarray(mask))
    with torch.inference_mode():
        out = port.forward_hidden_states(_t(ids), torch.from_numpy(mask))
    assert out.shape == (3, 2, 12, 256)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=TOL, rtol=0)


def test_extract_hidden_layers_match_jax(params, port):
    ids, mask = _ids_mask(1, 12, [9], seed=2)
    ref = jdec.extract_hidden_layers(params, jax_config(TINY_MISTRAL), jnp.asarray(ids), jnp.asarray(mask), (1, 2))
    with torch.inference_mode():
        out = port.extract_hidden_layers(_t(ids), torch.from_numpy(mask), (1, 2))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=TOL, rtol=0)


def test_forward_logits_match_jax(params, port):
    ids, _ = _ids_mask(1, 12, [12], seed=4)
    ref = np.asarray(jdec.forward_logits(params, jax_config(TINY_MISTRAL), jnp.asarray(ids)))
    with torch.inference_mode():
        out = port.forward_logits(_t(ids))
    assert out.dtype == torch.float32 and out.shape == (1, 12, 512)
    np.testing.assert_allclose(out.numpy(), ref, atol=TOL, rtol=0)


def test_prefill_then_decode_steps_match_jax(params, port):
    """prefill of 6 tokens, then 8 decode_steps, each step's logits and the
    cache against JAX's; every logits row also against forward_logits."""
    ids, _ = _ids_mask(1, 14, [14], seed=5)
    cfg = jax_config(TINY_MISTRAL)
    jcache = jdec.init_kv_cache(cfg, 1, 16, dtype=jnp.float32)
    jlogits, jcache = jdec.prefill(params, cfg, jnp.asarray(ids[:, :6]), jcache)
    cache = tdec.init_kv_cache(TINY_MISTRAL, 1, 16, torch.float32)
    with torch.inference_mode():
        full = port.forward_logits(_t(ids))
        logits, cache = port.prefill(_t(ids[:, :6]), cache)
        rows = [(logits, jlogits, 5)]
        for t in range(6, 14):
            jlogits, jcache = jdec.decode_step(params, cfg, jnp.asarray(ids[:, t:t + 1]), jcache)
            logits, cache = port.decode_step(_t(ids[:, t:t + 1]), cache)
            rows.append((logits, jlogits, t))
    assert cache.length == int(jcache.length) == 14
    for out, ref, t in rows:
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=TOL, rtol=0)
        np.testing.assert_allclose(out.numpy(), full[:, t].numpy(), atol=TOL, rtol=0)
    np.testing.assert_allclose(cache.k.numpy(), np.asarray(jcache.k), atol=TOL, rtol=0)
    np.testing.assert_allclose(cache.v.numpy(), np.asarray(jcache.v), atol=TOL, rtol=0)


def test_prefill_from_inputs_embeds_equals_the_token_prefill(port):
    ids = _t(_ids_mask(1, 6, [6], seed=6)[0])
    with torch.inference_mode():
        a, _ = port.prefill(ids, tdec.init_kv_cache(TINY_MISTRAL, 1, 8, torch.float32))
        b, _ = port.prefill(ids, tdec.init_kv_cache(TINY_MISTRAL, 1, 8, torch.float32),
                            inputs_embeds=port.embed_tokens[ids])
    assert torch.equal(a, b)


def test_bf16_decoder_against_jax_f32(params, port):
    ids, mask = _ids_mask(2, 12, [12, 7], seed=7)
    ref = np.asarray(jdec.forward_hidden_states(params, jax_config(TINY_MISTRAL), jnp.asarray(ids),
                                                jnp.asarray(mask)))
    with torch.inference_mode():
        out = decoder_from_jax(params, TINY_MISTRAL).to(torch.bfloat16).forward_hidden_states(
            _t(ids), torch.from_numpy(mask)).float().numpy()
    rel = np.linalg.norm(out - ref) / np.linalg.norm(ref)
    assert rel <= BF16_REL_TOL, rel


@pytest.mark.parametrize("fmt", ["w8a8", "int4"])
def test_quantized_encoder_matches_jax(params, fmt):
    """JAX's quantize_encoder_params (layers only) carried across equals the
    port's own quantization of the same dense decoder, and both forwards agree."""
    jq = jfacade.quantize_encoder_params(jax.tree_util.tree_map(jnp.asarray, params), fmt)
    carried = decoder_from_jax(jax.tree_util.tree_map(
        lambda x: np.asarray(x) if isinstance(x, jax.Array) else x, jq), TINY_MISTRAL)
    own = quantize_encoder_params(decoder_from_jax(params, TINY_MISTRAL), fmt)
    assert isinstance(own.lm_head, torch.nn.Parameter) and not tq.is_quantized(own.lm_head)
    assert sorted(tq.quantized_names(own)) == sorted(tq.quantized_names(carried))
    ids, mask = _ids_mask(1, 12, [10], seed=8)
    ref = jdec.forward_logits(jq, jax_config(TINY_MISTRAL), jnp.asarray(ids), jnp.asarray(mask))
    with torch.inference_mode():
        for dec in (own, carried):
            out = dec.forward_logits(_t(ids), torch.from_numpy(mask))
            np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=TOL, rtol=0)


def test_random_init_draws_the_head_last():
    """A random Mistral draws what a head-less decoder draws, then lm_head:
    the generator's order of JAX's init_params."""
    small = dataclasses.replace(TINY_MISTRAL, vocab_size=300, hidden_size=32, intermediate_size=64, head_dim=8)
    untied = tdec.Qwen3Decoder(small, generator=torch.Generator().manual_seed(0))
    tied = tdec.Qwen3Decoder(dataclasses.replace(small, tie_word_embeddings=True),
                             generator=torch.Generator().manual_seed(0))
    assert not hasattr(tied, "lm_head") and untied.lm_head.shape == (300, 32)
    drawn = dict(untied.named_parameters())
    assert all(torch.equal(w, drawn[name]) for name, w in tied.named_parameters())
    assert torch.equal(untied.final_norm, torch.ones(32, dtype=torch.bfloat16))
