"""The port's text generation against the JAX package's, on the CPU.

A tiny Mistral-shaped decoder (llama4 scaling, untied head, GQA 4:2, f32,
JAX's ``init_params`` perturbed with seeded noise) over the byte-fallback
Tekken tokenizer. Greedy decoding gives JAX's tokens exactly, through
``generate`` and through the ``generate_host`` oracle; a sampled run
equals JAX's token for token once JAX's uniforms (one ``jax.random.split``
a token from ``PRNGKey(seed)``) are injected in place of the port's
``torch.Generator`` draws. The sampler, the repetition penalty (an empty
ring slot is not token 0), EOS, streaming, the thinking switch, the think
filter and ``strip_think_tags`` are each held against JAX's function on the
same inputs; ``upsample_prompt`` and ``chat`` run through both facades with
the prompt ids and the replies equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flux2_tpu.models.text_encoders import facade as jfacade
from flux2_tpu.models.text_encoders import decoder as jdec
from flux2_tpu.models.text_encoders import generation as jgen
from flux2_tpu.models.text_encoders.tekken import TekkenTokenizer as JTekken
from flux2_tpu_torch.io.jax_params import decoder_from_jax
from flux2_tpu_torch.models.text_encoders import facade
from flux2_tpu_torch.models.text_encoders import generation as gen
from flux2_tpu_torch.models.text_encoders.config import DecoderConfig
from flux2_tpu_torch.models.text_encoders.tekken import TekkenTokenizer

from tests.test_torch_lora_loader import one_torch_thread  # noqa: F401  (module fixture)
from tests.test_torch_shared_copies import jax_config
from tests.test_torch_transformer import perturbed_numpy

CFG = DecoderConfig(vocab_size=1300, hidden_size=32, intermediate_size=64, num_hidden_layers=2, num_attention_heads=4,
                    num_key_value_heads=2, head_dim=8, rms_norm_eps=1e-5, tie_word_embeddings=False,
                    llama4_scaling_beta=0.1, original_max_position_embeddings=8)
PROMPT = [1, 3, 1097, 1032, 1114, 1101, 1100, 4]


@pytest.fixture(scope="module")
def params():
    return perturbed_numpy(jdec.init_params(jax.random.PRNGKey(5), jax_config(CFG), dtype=jnp.float32), 5, scale=1.0)


@pytest.fixture(scope="module")
def jparams(params):
    return jax.tree_util.tree_map(jnp.asarray, params)


@pytest.fixture(scope="module")
def port(params):
    return decoder_from_jax(params, CFG)


def jax_uniforms(seed: int, n: int) -> list:
    """The uniforms JAX's decode loops draw: split the key, draw from the sub-key, per token."""
    key, out = jax.random.PRNGKey(seed), []
    for _ in range(n):
        key, k = jax.random.split(key)
        out.append(float(jax.random.uniform(k)))
    return out


@pytest.fixture
def inject(monkeypatch):
    """inject(seed, n): the port's next n draws are JAX's uniforms for ``seed``."""
    def _inject(seed, n):
        draws = iter(jax_uniforms(seed, n))
        monkeypatch.setattr(gen, "_draw_uniform", lambda generator: torch.tensor(next(draws), dtype=torch.float32))
    return _inject


@pytest.mark.parametrize("penalty", [1.0, 1.3], ids=["no_penalty", "penalty"])
def test_greedy_tokens_equal_jax(jparams, port, penalty):
    p = gen.GenerateParameters(max_tokens=12, temperature=0.0, repetition_penalty=penalty)
    jp = jgen.GenerateParameters(**dataclasses.asdict(p))
    want = jgen.generate(jparams, jax_config(CFG), PROMPT, jp, seed=3)
    assert gen.generate(port, PROMPT, p, seed=3) == want == jgen.generate_host(jparams, jax_config(CFG), PROMPT, jp)
    assert gen.generate_host(port, PROMPT, p) == want and len(want) == 12


@pytest.mark.parametrize("temperature,top_p", [(0.7, 0.95), (1.0, 1.0), (0.2, 0.5)],
                         ids=["upsampling", "plain", "narrow"])
def test_sampled_tokens_equal_jax_with_its_uniforms(jparams, port, inject, temperature, top_p):
    p = gen.GenerateParameters(max_tokens=16, temperature=temperature, top_p=top_p)
    jp = jgen.GenerateParameters(**dataclasses.asdict(p))
    inject(7, 16)
    assert gen.generate(port, PROMPT, p, seed=7) == jgen.generate(jparams, jax_config(CFG), PROMPT, jp, seed=7)
    inject(7, 16)
    assert gen.generate_host(port, PROMPT, p, seed=7) == jgen.generate_host(jparams, jax_config(CFG), PROMPT, jp,
                                                                            seed=7)


def test_sampling_follows_the_seed(port):
    p = gen.GenerateParameters(max_tokens=12, temperature=1.0, top_p=1.0)
    a, b, c = (gen.generate(port, PROMPT, p, seed=s) for s in (0, 0, 1))
    assert a == b != c


@pytest.mark.parametrize("case", ["greedy", "greedy_token_zero_recent", "sampled_top_p", "sampled_ties"])
def test_sample_device_equals_jax(case):
    rng = np.random.RandomState(11)
    logits = rng.standard_normal(64).astype(np.float32) * 3
    recent = np.array([-1, -1, 0, 5, 5, 17], np.int64)
    p = {"greedy": gen.GenerateParameters(temperature=0.0, repetition_penalty=1.5),
         "greedy_token_zero_recent": gen.GenerateParameters(temperature=0.0, repetition_penalty=2.0),
         "sampled_top_p": gen.GenerateParameters(temperature=0.8, top_p=0.6),
         "sampled_ties": gen.GenerateParameters(temperature=1.0, top_p=0.5, repetition_penalty=1.0)}[case]
    if case == "greedy_token_zero_recent":
        logits = np.array([3.0, 1.0, -2.0, 0.5], np.float32)
        recent = np.array([-1, -1, 0, 2], np.int64)
    if case == "sampled_ties":
        logits = np.repeat(rng.standard_normal(8).astype(np.float32), 8)
    jp = jgen.GenerateParameters(**dataclasses.asdict(p))
    for seed in range(8):
        key = jax.random.PRNGKey(seed)
        u = torch.tensor(float(jax.random.uniform(key)))
        want = int(jgen._sample_device(key, jnp.asarray(logits), jnp.asarray(recent, jnp.int32), jp))
        assert int(gen._sample_device(u, torch.from_numpy(logits), torch.from_numpy(recent), p)) == want
        host = jgen._sample_token(key, logits, [int(r) for r in recent if r >= 0], jp)
        assert gen._sample_token(float(u), logits, [int(r) for r in recent if r >= 0], p) == host


def test_eos_stops_as_jax(jparams, port):
    p = gen.GenerateParameters(max_tokens=20, temperature=0.0)
    full = gen.generate(port, PROMPT, p)
    for eos in ([full[0]], [full[4]]):
        want = jgen.generate(jparams, jax_config(CFG), PROMPT, jgen.GenerateParameters(max_tokens=20, temperature=0.0),
                             eos_token_ids=eos)
        assert gen.generate(port, PROMPT, p, eos_token_ids=eos) == want == full[:full.index(eos[0])]


def test_streaming_sees_the_returned_tokens(jparams, port):
    seen, jseen = [], []
    p = gen.GenerateParameters(max_tokens=7, temperature=0.0)
    out = gen.generate(port, PROMPT, p, on_token=seen.append)
    jout = jgen.generate(jparams, jax_config(CFG), PROMPT, jgen.GenerateParameters(max_tokens=7, temperature=0.0),
                         on_token=jseen.append)
    assert seen == out == jseen == jout


def test_cache_full_stops_as_jax(jparams, port):
    """JAX's device loop stops once a step fills the cache; its host oracle
    samples one token more from the last logits. The port keeps both."""
    p = gen.GenerateParameters(max_tokens=20, temperature=0.0)
    jp = jgen.GenerateParameters(max_tokens=20, temperature=0.0)
    n = len(PROMPT) + 5
    want = jgen.generate(jparams, jax_config(CFG), PROMPT, jp, max_cache_len=n)
    want_host = jgen.generate_host(jparams, jax_config(CFG), PROMPT, jp, max_cache_len=n)
    assert gen.generate(port, PROMPT, p, max_cache_len=n) == want and len(want) == 5
    assert gen.generate_host(port, PROMPT, p, max_cache_len=n) == want_host and len(want_host) == 6


THINK_STREAMS = [["<th", "ink>", "\n\n</th", "ink>", "\n\nhi", " there"], ["<think>step 1", " step 2</think>  answer"],
                 ["hello ", "world"], ["<b>bold</b>", " ok"], ["<th"], ["  ", "<think>", "x", "</think>", " ", "", "y"]]


@pytest.mark.parametrize("pieces", THINK_STREAMS, ids=["empty_block", "block", "plain", "tag", "ambiguous_tail",
                                                       "spaces"])
def test_think_stream_filter_equals_jax(pieces):
    out, jout = [], []
    f, jf = gen.ThinkStreamFilter(out.append), jgen.ThinkStreamFilter(jout.append)
    for piece in pieces:
        f(piece)
        jf(piece)
    f.flush()
    jf.flush()
    assert out == jout


@pytest.mark.parametrize("text", ["<think>\n\n</think>\n\nanswer", "<think>reasoning\nhere</think>  final", "plain",
                                  "<think> the user wants a cat", "preamble <think>cut off", "<think>x</think>ok <think>y"])
def test_strip_think_tags_equals_jax(text):
    assert gen.strip_think_tags(text) == jgen.strip_think_tags(text)


def test_thinking_control_equals_jax():
    msgs = [{"role": "system", "content": "sys"}, {"role": "user", "content": "q1"},
            {"role": "assistant", "content": "a1"}, {"role": "user", "content": "q2"}]
    for enable in (False, True):
        assert gen.apply_thinking_control(msgs, enable) == jgen.apply_thinking_control(msgs, enable)
    assert gen.apply_thinking_control(msgs, True) is msgs and msgs[3]["content"] == "q2"


def test_presets_equal_jax():
    for name in ("creative", "precise", "upsampling"):
        assert dataclasses.asdict(getattr(gen.GenerateParameters, name)()) == dataclasses.asdict(
            getattr(jgen.GenerateParameters, name)())
    assert dataclasses.asdict(gen.GenerateParameters()) == dataclasses.asdict(jgen.GenerateParameters())


def _facades(params, port, name):
    enc = facade.TextEncoders()
    enc.attach(name, port, CFG, TekkenTokenizer.byte_fallback(), (1, 2), recipe="mistral")
    jenc = jfacade.TextEncoders()
    jenc.attach(name, jax.tree_util.tree_map(jnp.asarray, params), jax_config(CFG), JTekken.byte_fallback(), (1, 2))
    return enc, jenc


def _spy(monkeypatch, module, seen):
    real = module.generate

    def spy(decoder_or_params, *args, **kw):
        ids = args[0] if module is gen else args[1]
        seen.append(list(ids))
        return real(decoder_or_params, *args, **kw)
    monkeypatch.setattr(module, "generate", spy)


@pytest.mark.parametrize("mode", ["upsampling_t2i", "upsampling_i2i"])
def test_upsample_prompt_through_the_facade_equals_jax(params, port, inject, monkeypatch, mode):
    enc, jenc = _facades(params, port, "mistral")
    ids, jids = [], []
    _spy(monkeypatch, gen, ids)
    _spy(monkeypatch, jgen, jids)
    inject(4, 256)
    out = enc.upsample_prompt("a lighthouse at dusk", "mistral", mode=mode, seed=4)
    want = jenc.upsample_prompt("a lighthouse at dusk", "mistral", mode=mode, seed=4)
    assert ids == jids and len(ids[0]) > 400 and ids[0][:2] == [1, 17]
    assert out == want


def test_chat_through_the_facade_equals_jax(params, port, inject, monkeypatch):
    """A "qwen3" name gets /no_think on its last user turn in both; the
    streamed pieces and the reply are equal."""
    enc, jenc = _facades(params, port, "qwen3-tiny")
    ids, jids = [], []
    _spy(monkeypatch, gen, ids)
    _spy(monkeypatch, jgen, jids)
    messages = [{"role": "user", "content": "hello"}, {"role": "assistant", "content": "hi"},
                {"role": "user", "content": "a haiku, please"}]
    pieces, jpieces = [], []
    p = gen.GenerateParameters(max_tokens=24)
    inject(9, 24)
    reply = enc.chat(messages, "qwen3-tiny", params=p, seed=9, on_token=pieces.append)
    want = jenc.chat(messages, "qwen3-tiny", params=jgen.GenerateParameters(max_tokens=24), seed=9,
                     on_token=jpieces.append)
    assert ids == jids and reply == want and pieces == jpieces
    assert TekkenTokenizer.byte_fallback().decode(ids[0]).endswith("a haiku, please /no_think")
    assert enc.generate_text("hello", "qwen3-tiny", params=gen.GenerateParameters(max_tokens=4, temperature=0.0)) == \
        jenc.generate_text("hello", "qwen3-tiny", params=jgen.GenerateParameters(max_tokens=4, temperature=0.0))


def test_compare_embeddings_equals_jax():
    rng = np.random.RandomState(2)
    a, b = rng.standard_normal((1, 8, 6)).astype(np.float32), rng.standard_normal((1, 8, 6)).astype(np.float32)
    assert facade.compare_embeddings(torch.from_numpy(a), torch.from_numpy(b)) == jfacade.compare_embeddings(a, b)


def test_registry_and_the_vision_half():
    enc = facade.TextEncoders()
    dec = decoder_from_jax(perturbed_numpy(jdec.init_params(jax.random.PRNGKey(0), jax_config(CFG)), 0), CFG)
    loaded = enc.attach("mistral", dec, CFG, TekkenTokenizer.byte_fallback(), (1, 2))
    assert enc.is_loaded("mistral") and enc.get("mistral") is loaded and loaded.extractor.recipe == "mistral"
    assert enc.extract_flux_embeddings("a fox").shape == (1, 512, 64)
    enc.unload("mistral")
    assert not enc.is_loaded("mistral")
    # the vision half (ported since): no VLM loaded, and a missing checkpoint, raise as JAX's facade does
    from flux2_tpu.models.text_encoders import facade as jfacade

    for reg in (enc, jfacade.TextEncoders()):
        with pytest.raises(ValueError, match="no VLM loaded; call load_mistral_vlm first"):
            reg.analyze_image(None, "x")
        with pytest.raises(ValueError, match="no VLM loaded; call load_qwen35_vlm first"):
            reg.compare_images_for_flux(None, None)
        with pytest.raises(OSError):
            reg.load_qwen35_vlm("d")


def test_chat_ids_takes_a_batch_encoding():
    """Newer transformers return a BatchEncoding from apply_chat_template:
    the ids are its "input_ids", as a list of ints."""
    from flux2_tpu_torch.models.text_encoders.extractor import chat_ids

    class _Encoding(dict):
        pass

    class _HFStyle:
        def apply_chat_template(self, messages, add_generation_prompt=False):
            return _Encoding(input_ids=[5, 6, 7 + add_generation_prompt], attention_mask=[1, 1, 1])

    assert chat_ids(_HFStyle(), [{"role": "user", "content": "x"}], add_generation_prompt=True) == [5, 6, 8]
    assert chat_ids(TekkenTokenizer.byte_fallback(), [{"role": "user", "content": "hi"}]) == [1, 3, 1104, 1105, 4]
