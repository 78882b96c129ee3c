"""The port's VLM services against the JAX package's, on the CPU.

Tiny towers and LMs on the same perturbed JAX weights (``TINY_DECODER`` with
a one-block Pixtral; ``TINY_QWEN35`` with a one-block vision tower whose
image token, 248056, lies outside the LM's 128-id vocabulary, as the real
one lies outside a tiny one; A_log and dt_bias set so that JAX's chunked DeltaNet, NaN under
strong decay, stays finite), a deterministic stub tokenizer that decodes ids
as ``t<id>`` so equal replies mean equal token ids: ``MistralVLMService``'s
greedy ``analyze_image`` and its sampled one with JAX's uniforms injected;
``Qwen35VLMService``'s greedy ``chat`` with no image and with one,
``compare_images_for_flux`` over two images with their "Image N:" labels,
``score_validation_image``, and the sampled ``analyze_image``; the parsers
on a table of replies.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flux2_tpu.models.text_encoders import config as jtc
from flux2_tpu.models.text_encoders import decoder as jdec
from flux2_tpu.models.text_encoders import generation as jgen
from flux2_tpu.models.text_encoders import pixtral as jpx
from flux2_tpu.models.text_encoders import qwen35 as jq
from flux2_tpu.models.text_encoders import qwen35_vision as jqv
from flux2_tpu.models.text_encoders import vlm_service as jsvc
from flux2_tpu_torch.io.jax_params import decoder_from_jax, pixtral_from_jax, qwen35_from_jax, qwen35_vision_from_jax
from flux2_tpu_torch.models.text_encoders import generation as gen
from flux2_tpu_torch.models.text_encoders import vlm_service as tsvc
from flux2_tpu_torch.models.text_encoders.config import TINY_DECODER
from flux2_tpu_torch.models.text_encoders.pixtral import PixtralVisionConfig
from flux2_tpu_torch.models.text_encoders.qwen35 import TINY_QWEN35
from flux2_tpu_torch.models.text_encoders.qwen35_vision import Qwen35VisionConfig

from tests.test_torch_generation import jax_uniforms
from tests.test_torch_lora_loader import one_torch_thread  # noqa: F401  (module fixture)
from tests.test_torch_transformer import perturbed_numpy

PIXTRAL = PixtralVisionConfig(hidden_size=32, intermediate_size=64, num_hidden_layers=1, num_attention_heads=2,
                              patch_size=14, image_size=14 * 8, text_hidden_size=TINY_DECODER.hidden_size)
VISION = Qwen35VisionConfig(depth=1, hidden_size=32, num_heads=2, intermediate_size=64, num_position_embeddings=16,
                            out_hidden_size=TINY_QWEN35.hidden_size)


class StubTokenizer:
    """Deterministic ids from the words' bytes; ``decode`` spells the ids."""

    pad_token_id = 0
    eos_token_id = None

    def apply_chat_template(self, messages, add_generation_prompt=False):
        text = " ".join(m["content"] for m in messages)
        return [sum(w.encode()) % 100 + 11 for w in text.split()][:12]

    def encode(self, text):
        return [ord(c) % 50 + 11 for c in text]

    def decode(self, tokens):
        return " ".join(f"t{t}" for t in tokens)


def _jax_cfg(cfg, cls):
    return cls(**dataclasses.asdict(cfg))


@pytest.fixture(scope="module")
def mistral():
    lm = perturbed_numpy(jdec.init_params(jax.random.PRNGKey(0), _jax_cfg(TINY_DECODER, jtc.DecoderConfig),
                                          dtype=jnp.float32), 0)
    vis = perturbed_numpy(jpx.init_params(jax.random.PRNGKey(1), _jax_cfg(PIXTRAL, jpx.PixtralVisionConfig)), 1)
    tok = StubTokenizer()
    ref = jsvc.MistralVLMService(jax.tree_util.tree_map(jnp.asarray, lm), _jax_cfg(TINY_DECODER, jtc.DecoderConfig),
                                 jax.tree_util.tree_map(jnp.asarray, vis),
                                 _jax_cfg(PIXTRAL, jpx.PixtralVisionConfig), tok, image_token_id=7)
    port = tsvc.MistralVLMService(decoder_from_jax(lm, TINY_DECODER), TINY_DECODER, pixtral_from_jax(vis, PIXTRAL),
                                  PIXTRAL, tok, image_token_id=7)
    return ref, port


@pytest.fixture(scope="module")
def qwen35():
    lm = perturbed_numpy(jq.init_params(jax.random.PRNGKey(2), jq.TINY_QWEN35), 2)
    for lp in lm["layers"]:  # decays mild enough that JAX's chunked DeltaNet stays finite over a 64-token chunk
        if "linear_attn" in lp:
            lp["linear_attn"]["a_log"] = np.linspace(-4.0, -1.5, TINY_QWEN35.linear_num_value_heads, dtype=np.float32)
            lp["linear_attn"]["dt_bias"] = np.linspace(0.2, 1.0, TINY_QWEN35.linear_num_value_heads, dtype=np.float32)
    probe = jax.jit(lambda p, i: jq.forward_logits(p, jq.TINY_QWEN35, i))(jax.tree_util.tree_map(jnp.asarray, lm),
                                                                          jnp.arange(300)[None] % 128)
    assert np.isfinite(np.asarray(probe)).all()  # JAX's reference is finite at these lengths
    vis = perturbed_numpy(jqv.init_params(jax.random.PRNGKey(3), _jax_cfg(VISION, jqv.Qwen35VisionConfig)), 3)
    tok = StubTokenizer()
    ref = jsvc.Qwen35VLMService(jax.tree_util.tree_map(jnp.asarray, lm), jq.TINY_QWEN35,
                                jax.tree_util.tree_map(jnp.asarray, vis), _jax_cfg(VISION, jqv.Qwen35VisionConfig),
                                tok)
    port = tsvc.Qwen35VLMService(qwen35_from_jax(lm, TINY_QWEN35), TINY_QWEN35, qwen35_vision_from_jax(vis, VISION),
                                 VISION, tok)
    return ref, port


def _image(seed, h, w):
    return np.random.RandomState(seed).rand(h, w, 3).astype(np.float32)


@pytest.fixture
def inject(monkeypatch):
    """inject(seed, n): the port's draws are JAX's uniforms for ``seed``, the
    sequence restarting at each decode loop (each gets a new generator)."""
    def _inject(seed, n):
        state = {}

        def draw(generator):
            if state.get("generator") is not generator:
                state.update(generator=generator, draws=iter(jax_uniforms(seed, n)))
            return torch.tensor(next(state["draws"]), dtype=torch.float32)
        monkeypatch.setattr(gen, "_draw_uniform", draw)
    return _inject


def test_mistral_analyze_image_greedy_equals_jax(mistral):
    ref, port = mistral
    greedy = (jgen.GenerateParameters(max_tokens=8, temperature=0.0), gen.GenerateParameters(max_tokens=8,
                                                                                              temperature=0.0))
    for image in (_image(0, 56, 28), _image(1, 28, 84) * 0.1):
        want = ref.analyze_image(image, "describe the scene", gen_params=greedy[0])
        got = port.analyze_image(image, "describe the scene", gen_params=greedy[1])
        assert got == want and len(got.split()) == 8
    np.testing.assert_allclose(port.encode_image(_image(2, 56, 56)).numpy(),
                               np.asarray(ref.encode_image(_image(2, 56, 56))), atol=1e-5, rtol=0)


def test_mistral_analyze_image_sampled_with_jax_uniforms(mistral, inject):
    """The default sampling (temperature 0.2, top-p 0.95, repetition penalty 1.1) at seed 3."""
    ref, port = mistral
    image = _image(3, 56, 56)
    want = ref.analyze_image(image, "what is this", gen_params=jgen.GenerateParameters(max_tokens=12,
                                                                                        temperature=0.2), seed=3)
    inject(3, 12)
    got = port.analyze_image(image, "what is this", gen_params=gen.GenerateParameters(max_tokens=12, temperature=0.2),
                             seed=3)
    assert got == want


def test_qwen35_chat_greedy_equals_jax(qwen35):
    """No image, then one 64^2 image (256^2 after smart_resize: 64 image tokens)."""
    ref, port = qwen35
    assert port.chat("sys", "hello world", max_tokens=6) == ref.chat("sys", "hello world", max_tokens=6)
    image = _image(4, 64, 64)
    want = ref.chat("sys", "look at this", image=image, max_tokens=6)
    assert port.chat("sys", "look at this", image=image, max_tokens=6) == want and len(want.split()) == 6


def test_qwen35_merged_inputs_equal_jax(qwen35):
    """Two images: the "Image N:" labels, 64 + 64 image tokens (id 248056,
    embedded as id 0) and the text, merged by rank."""
    ref, port = qwen35
    images = [_image(5, 64, 64), _image(6, 96, 64)]
    jids, jmerged = ref._merged_inputs([11, 12, 13], images)
    ids, merged = port._merged_inputs([11, 12, 13], images)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    assert int((ids == VISION.image_token_id).sum()) == 64 + 96  # 256^2 and 384 x 256 after smart_resize
    np.testing.assert_allclose(merged.numpy(), np.asarray(jmerged), atol=1e-5, rtol=0)


def test_qwen35_compare_and_score_equal_jax(qwen35):
    ref, port = qwen35
    reference, generated = _image(7, 64, 64), _image(8, 64, 64)
    result = port.compare_images_for_flux(reference, generated, max_tokens=40)
    assert result == ref.compare_images_for_flux(reference, generated, max_tokens=40)
    assert set(result) == {"scene_score", "scene_reason", "style_score", "style_reason"}
    scores = port.score_validation_image(generated, [reference], "a red fox")
    assert scores == ref.score_validation_image(generated, [reference], "a red fox")
    assert all(isinstance(s, float) for s in scores)
    # the replies themselves, token for token
    want, got = (svc.chat(tsvc.FLUX_IMAGE_COMPARISON_SYSTEM_PROMPT, "Compare these two images.",
                          image=[reference, generated], max_tokens=40) for svc in (ref, port))
    assert got == want and len(got.split()) == 40


def test_qwen35_analyze_image_sampled_with_jax_uniforms(qwen35, inject):
    ref, port = qwen35
    image = _image(9, 64, 64)
    want = ref.analyze_image(image, "describe", gen_params=jgen.GenerateParameters(max_tokens=10, temperature=0.2),
                             seed=5)
    inject(5, 10)
    got = port.analyze_image(image, "describe", gen_params=gen.GenerateParameters(max_tokens=10, temperature=0.2),
                             seed=5)
    assert got == want


REPLIES = [
    "scene=8 style=6", "Scene: 7.5, Style: 9", "garbage", "scene=99 style=3", "SCENE = 4.25 and style:10",
    '{"scene_score": 70, "scene_reason": "same pose", "style_score": 55, "style_reason": "warmer"}',
    '<think>hmm</think> {"scene_score": 12, "style_score": null}<|im_end|>',
    'Here: {"scene_score": "x"} then scene_score: 41 and style score = 77', "scene score 5", "{broken json",
]


@pytest.mark.parametrize("text", REPLIES)
def test_parsers_equal_jax(text):
    assert tsvc.parse_scores(text) == jsvc.parse_scores(text)
    assert tsvc.parse_comparison(text) == jsvc.parse_comparison(text)
