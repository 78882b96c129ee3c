"""Tekken tokenizer: tiktoken-style byte-level BPE for Mistral models.

The port's own copy of ``flux2_tpu/models/text_encoders/tekken.py`` (the
same ids, held in ``tests/test_torch_tekken.py`` and
``tests/test_torch_shared_copies.py``), equivalent to
``mistral_common``'s ``Tekkenizer``:

  - ``tekken.json`` format: ``config.pattern`` (the tiktoken split regex),
    ``config.default_num_special_tokens`` / ``default_vocab_size``
    (vocabulary truncation), base64 ``token_bytes`` ranks, and a
    ``special_tokens`` table mapping control strings to low ranks.
  - Encoding: regex-split chunks -> greedy lowest-rank byte-pair merge ->
    ``rank + num_special_tokens`` offset.
  - Decoding: byte accumulation across tokens so multi-byte UTF-8 sequences
    split across tokens reassemble correctly.
  - Mistral Small 3.2 chat template: ``<s>``, ``[SYSTEM_PROMPT]...`` /
    ``[INST]...[/INST]`` / ``content</s>`` with special-token IDs spliced
    directly (never BPE-encoded).
  - ``generation_config.json`` overrides for bos/eos/pad ids.

Offline fallback: a byte-level vocabulary (256 single-byte ranks), so any
text round-trips losslessly with no files on disk. A ``tekken.json``
pattern needs the ``regex`` package (its ``p{L}`` classes); the fallback's
pattern compiles under ``re`` where ``regex`` is missing.
"""

from __future__ import annotations

import base64
import json
import os
import re
from typing import Dict, List, Optional, Sequence, Tuple

try:  # Tekken / tiktoken split patterns use \p{L} etc.: they need `regex`, not `re`
    import regex as _regex
except ImportError:  # the byte fallback's pattern compiles under `re` alike
    _regex = None

# Default special-token ranks (TekkenTokenizer.swift:46-53); tekken.json's
# special_tokens table and generation_config.json override them.
UNK_ID = 0
DEFAULT_BOS_ID = 1
DEFAULT_EOS_ID = 2
DEFAULT_INST_ID = 3
DEFAULT_END_INST_ID = 4
DEFAULT_PAD_ID = 11
DEFAULT_SYSTEM_ID = 17
DEFAULT_END_SYSTEM_ID = 18

_FALLBACK_PATTERN = r"[\w]+|[^\w\s]|\s+"


class TekkenTokenizer:
    """tiktoken-style BPE with the Tekkenizer special-token offset."""

    def __init__(
        self,
        mergeable_ranks: Dict[bytes, int],
        pattern: str = _FALLBACK_PATTERN,
        num_special_tokens: int = 1000,
        special_tokens: Optional[Dict[str, int]] = None,
    ):
        self.mergeable_ranks = mergeable_ranks
        self.rank_to_bytes = {r: b for b, r in mergeable_ranks.items()}
        self.num_special_tokens = num_special_tokens
        self.pattern = (_regex or re).compile(pattern)
        self.special_tokens = dict(special_tokens or {})
        self.reverse_special = {r: s for s, r in self.special_tokens.items()}

        def _special(name: str, default: int) -> int:
            return self.special_tokens.get(name, default)

        self.bos_token_id = _special("<s>", DEFAULT_BOS_ID)
        self.eos_token_id = _special("</s>", DEFAULT_EOS_ID)
        self.pad_token_id = _special("<pad>", DEFAULT_PAD_ID)
        self.inst_token_id = _special("[INST]", DEFAULT_INST_ID)
        self.end_inst_token_id = _special("[/INST]", DEFAULT_END_INST_ID)
        self.system_token_id = _special("[SYSTEM_PROMPT]", DEFAULT_SYSTEM_ID)
        self.end_system_token_id = _special("[/SYSTEM_PROMPT]", DEFAULT_END_SYSTEM_ID)

    # -- construction --------------------------------------------------------

    @classmethod
    def from_tekken_json(cls, path: str) -> "TekkenTokenizer":
        """Load a mistral-common ``tekken.json`` (TekkenTokenizer.swift:115-185)."""
        with open(path) as f:
            data = json.load(f)
        config = data["config"]
        num_special = int(config["default_num_special_tokens"])
        max_vocab = int(config["default_vocab_size"]) - num_special

        ranks: Dict[bytes, int] = {}
        for tok in data["vocab"][:max_vocab]:
            ranks[base64.b64decode(tok["token_bytes"])] = int(tok["rank"])

        special: Dict[str, int] = {}
        for tok in data.get("special_tokens") or []:
            special[tok["token_str"]] = int(tok["rank"])

        tokenizer = cls(
            ranks,
            pattern=config["pattern"],
            num_special_tokens=num_special,
            special_tokens=special,
        )
        # generation_config.json beside tekken.json overrides ids (:190-198)
        gen_path = os.path.join(os.path.dirname(path), "generation_config.json")
        if os.path.exists(gen_path):
            with open(gen_path) as f:
                gen = json.load(f)
            for attr, key in (
                ("bos_token_id", "bos_token_id"),
                ("eos_token_id", "eos_token_id"),
                ("pad_token_id", "pad_token_id"),
            ):
                if gen.get(key) is not None:
                    setattr(tokenizer, attr, int(gen[key]))
        return tokenizer

    @classmethod
    def byte_fallback(cls) -> "TekkenTokenizer":
        """Offline default: 256 single-byte ranks — lossless with no files
        (replaces the reference's 5-word demo vocab, :201-214)."""
        ranks = {bytes([i]): i for i in range(256)}
        return cls(ranks, pattern=_FALLBACK_PATTERN, num_special_tokens=1000)

    @classmethod
    def from_pretrained(cls, model_path: str) -> "TekkenTokenizer":
        """Resolve ``tekken.json`` under ``model_path`` (file or dir)."""
        path = model_path
        if os.path.isdir(path):
            path = os.path.join(path, "tekken.json")
        if os.path.exists(path):
            return cls.from_tekken_json(path)
        return cls.byte_fallback()

    # -- encoding -------------------------------------------------------------

    def encode(self, text: str, add_special_tokens: bool = False) -> List[int]:
        if not text:
            return []
        raw: List[int] = []
        for chunk in self.pattern.findall(text):
            raw.extend(self._encode_chunk(chunk.encode("utf-8")))
        tokens = [r + self.num_special_tokens for r in raw]
        if add_special_tokens:
            tokens = [self.bos_token_id, *tokens, self.eos_token_id]
        return tokens

    def _encode_chunk(self, chunk: bytes) -> List[int]:
        """Greedy lowest-rank byte-pair merge (TekkenTokenizer.swift:320-387)."""
        rank = self.mergeable_ranks.get(chunk)
        if rank is not None:
            return [rank]
        if len(chunk) == 1:
            return [self.mergeable_ranks.get(chunk, UNK_ID - self.num_special_tokens)]

        word: List[bytes] = [bytes([b]) for b in chunk]
        while len(word) >= 2:
            best_rank = None
            best_i = -1
            for i in range(len(word) - 1):
                r = self.mergeable_ranks.get(word[i] + word[i + 1])
                if r is not None and (best_rank is None or r < best_rank):
                    best_rank, best_i = r, i
            if best_rank is None:
                break
            word[best_i : best_i + 2] = [word[best_i] + word[best_i + 1]]

        out: List[int] = []
        for piece in word:
            r = self.mergeable_ranks.get(piece)
            if r is not None:
                out.append(r)
            else:
                # A merged piece absent from a truncated vocab: emit UNK for
                # the piece rather than silently dropping its bytes.
                # (unk is an ABSOLUTE id; counter the offset the caller adds)
                out.append(UNK_ID - self.num_special_tokens)
        return out or [UNK_ID - self.num_special_tokens]

    # -- decoding -------------------------------------------------------------

    def decode(self, tokens: Sequence[int], skip_special_tokens: bool = True) -> str:
        """Byte-accumulating decode (TekkenTokenizer.swift:394-440)."""
        buf = bytearray()
        for tok in tokens:
            if tok < self.num_special_tokens:
                if not skip_special_tokens and tok in self.reverse_special:
                    buf.extend(self.reverse_special[tok].encode("utf-8"))
                continue
            piece = self.rank_to_bytes.get(tok - self.num_special_tokens)
            if piece is not None:
                buf.extend(piece)
        return buf.decode("utf-8", errors="replace")

    # -- chat template ----------------------------------------------------------

    def apply_chat_template_str(self, messages: Sequence[dict]) -> str:
        """Render the Mistral Small 3.2 template as a string (:466-497)."""
        out = "<s>"
        for msg in messages:
            role, content = msg.get("role"), msg.get("content", "")
            if role == "system":
                out += f"[SYSTEM_PROMPT]{content}[/SYSTEM_PROMPT]"
            elif role == "user":
                out += f"[INST]{content}[/INST]"
            elif role == "assistant":
                out += f"{content}</s>"
        return out

    def apply_chat_template(
        self, messages: Sequence[dict], add_generation_prompt: bool = False
    ) -> List[int]:
        """Token ids with special tokens spliced DIRECTLY — control strings
        are never BPE-encoded (encodeChatMessages, :503-534)."""
        tokens: List[int] = [self.bos_token_id]
        for msg in messages:
            role, content = msg.get("role"), msg.get("content", "")
            if role == "system":
                tokens.append(self.system_token_id)
                tokens.extend(self.encode(content))
                tokens.append(self.end_system_token_id)
            elif role == "user":
                tokens.append(self.inst_token_id)
                tokens.extend(self.encode(content))
                tokens.append(self.end_inst_token_id)
            elif role == "assistant":
                tokens.extend(self.encode(content))
                tokens.append(self.eos_token_id)
        return tokens

    # -- introspection ----------------------------------------------------------

    @property
    def vocab_size(self) -> int:
        return len(self.mergeable_ranks) + self.num_special_tokens


def random_init_tokenizer(vocab_size: int, num_special_tokens: int = 1000) -> TekkenTokenizer:
    """A Tekken tokenizer for a random-init model of ``vocab_size`` ids (the
    port's; JAX's random-init pipelines have no encoder): ``byte_fallback``'s
    256 byte ranks, then byte pairs, then byte triples, in order, until every
    id the model can draw decodes to bytes. With the 256 byte ranks alone,
    all but 256 of Mistral's 130072 non-special ids would decode to nothing."""
    import itertools

    ranks = {bytes([i]): i for i in range(256)}
    need = vocab_size - num_special_tokens
    for n in (2, 3):
        for piece in itertools.islice(itertools.product(range(256), repeat=n), max(0, need - len(ranks))):
            ranks[bytes(piece)] = len(ranks)
    return TekkenTokenizer(ranks, pattern=_FALLBACK_PATTERN, num_special_tokens=num_special_tokens)
