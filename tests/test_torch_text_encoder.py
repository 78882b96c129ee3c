"""The port's Qwen3 decoder and Klein extractor against the JAX package (CPU, f32).

Weights: the JAX ``decoder.init_params``, every leaf perturbed with seeded
noise, loaded through ``decoder_from_jax``. Inputs are right-padded, as the
Klein recipe pads. Tolerance 1e-5 max abs in float32 for the 4-layer decoder
(hidden states O(1); only the summation order differs) and 1e-4 for the
28-layer recipe, whose states grow to O(10). Tokenization must be equal exactly,
through both branches of ``prepare_klein_input_ids``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flux2_tpu.models.text_encoders import decoder as jdec
from flux2_tpu.models.text_encoders import extractor as jext
from flux2_tpu_torch.io.jax_params import decoder_from_jax
from flux2_tpu_torch.models.text_encoders import extractor as text
from flux2_tpu_torch.models.text_encoders.config import TINY_DECODER
from flux2_tpu_torch.utils import dev_tokenizer

from tests.test_torch_shared_copies import jax_config
from tests.test_torch_transformer import perturbed_numpy

TOL = 1e-5


def _ids_mask(rng, b, s, lengths, vocab):
    ids = rng.randint(1, vocab, size=(b, s)).astype(np.int32)
    mask = (np.arange(s)[None, :] < np.asarray(lengths)[:, None]).astype(np.int32)
    return np.where(mask > 0, ids, 0).astype(np.int32), mask


@pytest.fixture(scope="module")
def tiny_params():
    return perturbed_numpy(jdec.init_params(jax.random.PRNGKey(0), jax_config(TINY_DECODER), dtype=jnp.float32), 0)


def test_hidden_states_match_jax(tiny_params):
    ids, mask = _ids_mask(np.random.RandomState(1), 2, 12, [12, 7], TINY_DECODER.vocab_size)
    ref = jdec.forward_hidden_states(tiny_params, jax_config(TINY_DECODER), jnp.asarray(ids), jnp.asarray(mask))
    with torch.inference_mode():
        out = decoder_from_jax(tiny_params, TINY_DECODER).forward_hidden_states(
            torch.from_numpy(ids).long(), torch.from_numpy(mask))
    assert out.shape == (TINY_DECODER.num_hidden_layers + 1, 2, 12, TINY_DECODER.hidden_size)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=TOL, rtol=0)


def test_extract_hidden_layers_matches_jax(tiny_params):
    ids, mask = _ids_mask(np.random.RandomState(2), 1, 16, [9], TINY_DECODER.vocab_size)
    layers = (1, 2, 4)
    ref = jdec.extract_hidden_layers(tiny_params, jax_config(TINY_DECODER), jnp.asarray(ids), jnp.asarray(mask), layers)
    with torch.inference_mode():
        out = decoder_from_jax(tiny_params, TINY_DECODER).extract_hidden_layers(
            torch.from_numpy(ids).long(), torch.from_numpy(mask), layers)
    assert out.shape == (1, 16, 3 * TINY_DECODER.hidden_size)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=TOL, rtol=0)


class _EncodeTokenizer:
    """Has ``encode``: the rendered chat template is tokenized."""

    pad_token_id = 0

    def encode(self, text):
        return [b % 250 + 3 for b in text.encode()]

    def apply_chat_template(self, messages, add_generation_prompt=False):
        raise AssertionError("the encode branch must be taken")


class _TemplateTokenizer:
    """Only ``apply_chat_template``, like dev_tokenizer's byte stub."""

    pad_token_id = 1

    def apply_chat_template(self, messages, add_generation_prompt=False):
        text = " ".join(m["content"] for m in messages) + ("<gen>" if add_generation_prompt else "")
        return [b % 250 + 3 for b in text.encode()]


@pytest.mark.parametrize("make_tok", [_EncodeTokenizer, _TemplateTokenizer, dev_tokenizer.inline_bpe_tokenizer],
                         ids=["encode", "chat_template", "dev_tokenizer"])
@pytest.mark.parametrize("prompt,max_length", [("a cat [IMG]on a mat", 512), ("x" * 100, 64)])
def test_prepare_klein_input_ids_matches_jax(make_tok, prompt, max_length):
    tok = make_tok()
    ids_j, mask_j = jext.prepare_klein_input_ids(tok, prompt, max_length)
    ids_t, mask_t = text.prepare_klein_input_ids(tok, prompt, max_length)
    np.testing.assert_array_equal(ids_t, ids_j)
    np.testing.assert_array_equal(mask_t, mask_j)
    assert ids_t.dtype == np.int32 and ids_t.shape == (1, max_length)


def test_qwen3_extractor_matches_jax():
    """The whole Klein recipe: 28 layers so hidden layers (9, 18, 27) exist, 512 tokens."""
    cfg = dataclasses.replace(TINY_DECODER, num_hidden_layers=28, vocab_size=600)
    params = perturbed_numpy(jdec.init_params(jax.random.PRNGKey(5), jax_config(cfg), dtype=jnp.float32), 5)
    tok = dev_tokenizer.inline_bpe_tokenizer()
    ref = jext.qwen3_extractor(params, jax_config(cfg), tok)("a serene mountain lake")
    out = text.qwen3_extractor(decoder_from_jax(params, cfg), tok)("a serene mountain lake")
    assert out.shape == (1, 512, 3 * cfg.hidden_size)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4, rtol=0)
