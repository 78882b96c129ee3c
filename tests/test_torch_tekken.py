"""The port's Tekken tokenizer against the JAX package's and the goldens.

The cases of JAX's ``tests/test_tekken.py`` on the same synthetic
``tekken.json`` files: every id list equal to the expected constants and to
JAX's tokenizer, exactly; ``tests/goldens/tekken_goldens.json`` (tiktoken
over ``tekken_fixture.json``) token for token; the Mistral chat template of
the Dev recipe; ``resolve_tokenizer`` preferring ``tekken.json``; and
``random_init_tokenizer`` (the port's own) extending ``byte_fallback``.
"""

import base64
import json
import os

import pytest

from flux2_tpu.models.text_encoders import extractor as jext
from flux2_tpu.models.text_encoders.tekken import TekkenTokenizer as JTekken
from flux2_tpu_torch.models.text_encoders import extractor as text
from flux2_tpu_torch.models.text_encoders import facade
from flux2_tpu_torch.models.text_encoders.tekken import TekkenTokenizer, random_init_tokenizer

GOLDENS = os.path.join(os.path.dirname(__file__), "goldens")
TEKKEN_V7_PATTERN = (
    r"[^\r\n\p{L}\p{N}]?[\p{Lu}\p{Lt}\p{Lm}\p{Lo}\p{M}]*[\p{Ll}\p{Lm}\p{Lo}\p{M}]+|"
    r"[^\r\n\p{L}\p{N}]?[\p{Lu}\p{Lt}\p{Lm}\p{Lo}\p{M}]+[\p{Ll}\p{Lm}\p{Lo}\p{M}]*|"
    r"\p{N}| ?[^\s\p{L}\p{N}]+[\r\n/]*|\s*[\r\n]+|\s+(?!\S)|\s+"
)


def _write_tekken(tmp_path, vocab, pattern=r"[\w]+|[^\w\s]|\s+", num_special=100, vocab_size=None):
    specials = [("<s>", 1), ("</s>", 2), ("[INST]", 3), ("[/INST]", 4), ("<pad>", 11), ("[SYSTEM_PROMPT]", 17),
                ("[/SYSTEM_PROMPT]", 18)]
    data = {
        "config": {"pattern": pattern, "num_vocab_tokens": len(vocab),
                   "default_vocab_size": vocab_size or (len(vocab) + num_special),
                   "default_num_special_tokens": num_special, "version": "v7"},
        "vocab": [{"rank": r, "token_bytes": base64.b64encode(b).decode(), "token_str": b.decode("utf-8", "ignore")}
                  for b, r in vocab],
        "special_tokens": [{"rank": r, "token_str": s, "is_control": True} for s, r in specials],
    }
    path = tmp_path / "tekken.json"
    path.write_text(json.dumps(data))
    return str(path)


AB_VOCAB = [(b"a", 0), (b"b", 1), (b"c", 2), (b"d", 3), (b"ab", 4), (b"cd", 5), (b"abcd", 6)]


def _pair(tmp_path, vocab=AB_VOCAB, **kw):
    path = _write_tekken(tmp_path, vocab, **kw)
    return TekkenTokenizer.from_tekken_json(path), JTekken.from_tekken_json(path)


@pytest.mark.parametrize("text,want", [("abcd", [106]), ("abc", [104, 102]), ("abab", [104, 104]), ("z", [0])],
                         ids=["vocab_hit", "merge_then_byte", "two_merges", "unknown_byte"])
def test_merge_order_and_offset_equal_jax(tmp_path, text, want):
    tok, jtok = _pair(tmp_path)
    assert tok.encode(text) == jtok.encode(text) == want


def test_decode_roundtrip_and_specials_equal_jax(tmp_path):
    tok, jtok = _pair(tmp_path)
    ids = tok.encode("abcd", add_special_tokens=True)
    assert ids == jtok.encode("abcd", add_special_tokens=True) == [1, 106, 2]
    assert tok.decode(ids) == jtok.decode(ids) == "abcd"
    assert tok.decode(ids, skip_special_tokens=False) == jtok.decode(ids, skip_special_tokens=False) == "<s>abcd</s>"


def test_chat_template_ids_equal_jax(tmp_path):
    tok, jtok = _pair(tmp_path)
    messages = [{"role": "system", "content": "ab"}, {"role": "user", "content": "cd"},
                {"role": "assistant", "content": "a"}]
    assert tok.apply_chat_template(messages) == jtok.apply_chat_template(messages) == [1, 17, 104, 18, 3, 105, 4,
                                                                                       100, 2]
    one = [{"role": "user", "content": "hi"}]
    assert tok.apply_chat_template_str(one) == jtok.apply_chat_template_str(one) == "<s>[INST]hi[/INST]"


def test_vocabulary_truncation_equal_jax(tmp_path):
    tok, jtok = _pair(tmp_path, vocab_size=106)
    assert tok.encode("abcd") == jtok.encode("abcd") == [104, 105]


def test_generation_config_overrides_equal_jax(tmp_path):
    path = _write_tekken(tmp_path, AB_VOCAB)
    (tmp_path / "generation_config.json").write_text(json.dumps({"bos_token_id": 7, "eos_token_id": 8,
                                                                 "pad_token_id": 9}))
    for tok in (TekkenTokenizer.from_tekken_json(path), JTekken.from_tekken_json(path)):
        assert (tok.bos_token_id, tok.eos_token_id, tok.pad_token_id) == (7, 8, 9)


def test_byte_fallback_equals_jax_and_is_lossless():
    text = "héllo wörld — テスト 🚀"
    ids = TekkenTokenizer.byte_fallback().encode(text)
    assert ids == JTekken.byte_fallback().encode(text)
    assert TekkenTokenizer.byte_fallback().decode(ids) == text and min(ids) >= 1000


def test_multibyte_utf8_reassembly_equal_jax(tmp_path):
    tok, jtok = _pair(tmp_path, vocab=[(bytes([0xC3]), 0), (bytes([0xA9]), 1)])
    assert tok.encode("é") == jtok.encode("é") == [100, 101]
    assert tok.decode([100, 101]) == "é"


def test_tiktoken_pattern_splitting_equal_jax():
    ranks = {bytes([i]): i for i in range(256)}
    tok = TekkenTokenizer(ranks, pattern=TEKKEN_V7_PATTERN, num_special_tokens=1000)
    jtok = JTekken(ranks, pattern=TEKKEN_V7_PATTERN, num_special_tokens=1000)
    for text in ("Hello world", "It's 2026: tokens\r\nand  spaces!"):
        assert tok.encode(text) == jtok.encode(text)
        assert tok.decode(tok.encode(text)) == text


def _goldens():
    with open(os.path.join(GOLDENS, "tekken_goldens.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("case", _goldens()["cases"], ids=lambda c: c["text"][:24])
def test_goldens_token_for_token(case):
    """The committed tiktoken goldens: ids equal to the goldens and to JAX's tokenizer."""
    tok = TekkenTokenizer.from_pretrained(os.path.join(GOLDENS, "tekken_fixture.json"))
    jtok = JTekken.from_pretrained(os.path.join(GOLDENS, "tekken_fixture.json"))
    offset = _goldens()["num_special_tokens"]
    got = tok.encode(case["text"])
    assert got == [r + offset for r in case["ranks"]] == jtok.encode(case["text"])
    assert tok.decode(got) == case["text"]


@pytest.mark.parametrize("prompt", ["a red fox in the snow", "[IMG]two cats [IMG]on a sofa", "x" * 700],
                         ids=["short", "image_markers", "truncated"])
def test_mistral_recipe_ids_equal_jax(prompt):
    """The Dev recipe on the goldens' tokenizer: system prompt, [IMG] stripped,
    truncation and LEFT padding to 512, ids and mask equal to JAX's."""
    tok = TekkenTokenizer.from_pretrained(os.path.join(GOLDENS, "tekken_fixture.json"))
    jtok = JTekken.from_pretrained(os.path.join(GOLDENS, "tekken_fixture.json"))
    ids, mask = text.prepare_input_ids(tok, prompt)
    jids, jmask = jext.prepare_input_ids(jtok, prompt)
    assert ids.tolist() == jids.tolist() and mask.tolist() == jmask.tolist()
    assert ids.shape == (1, 512) and mask[0, -1] == 1
    assert text.build_messages(prompt, "upsampling_i2i") == jext.build_messages(prompt, "upsampling_i2i")


def test_resolve_tokenizer_prefers_tekken(tmp_path):
    _write_tekken(tmp_path, AB_VOCAB)
    assert isinstance(facade.resolve_tokenizer(str(tmp_path)), TekkenTokenizer)


def test_random_init_tokenizer_extends_byte_fallback_over_the_vocabulary():
    tok = random_init_tokenizer(1000 + 256 + 300)
    assert tok.vocab_size == 1556
    fallback = TekkenTokenizer.byte_fallback()
    assert all(tok.mergeable_ranks[b] == r for b, r in fallback.mergeable_ranks.items())
    assert all(tok.decode([i]) for i in range(1000, 1556))  # every non-special id decodes to text
    text_in = "a red fox — ü"
    assert tok.decode(tok.encode(text_in)) == text_in
