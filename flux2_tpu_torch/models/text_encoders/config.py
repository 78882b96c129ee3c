"""Text-encoder (LLM) configurations: Mistral Small 3.2 24B and Qwen3 4B/8B.

The port's own copy of ``flux2_tpu/models/text_encoders/config.py``, equal
field by field (``tests/test_torch_shared_copies.py``).

Parity with ``Sources/FluxTextEncoders/Configuration/EncoderConfiguration.swift``
(Mistral) and ``Qwen3Configuration.swift`` (Qwen3). One generic decoder config
covers both: Qwen3 adds per-head Q/K RMSNorm before RoPE; Mistral (Ministral3)
adds Llama-4 position-dependent query scaling.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class DecoderConfig:
    vocab_size: int
    hidden_size: int
    intermediate_size: int
    num_hidden_layers: int
    num_attention_heads: int
    num_key_value_heads: int
    head_dim: int
    rms_norm_eps: float = 1e-6
    rope_theta: float = 1_000_000.0
    tie_word_embeddings: bool = False
    qk_norm: bool = False  # Qwen3: per-head RMSNorm on Q/K before RoPE
    llama4_scaling_beta: Optional[float] = None  # Mistral Small 3.2: 0.1
    original_max_position_embeddings: int = 16384

    @classmethod
    def from_json_dict(cls, d: dict, qk_norm: bool = False, llama4: bool = False) -> "DecoderConfig":
        heads = d["num_attention_heads"]
        return cls(
            vocab_size=d["vocab_size"],
            hidden_size=d["hidden_size"],
            intermediate_size=d["intermediate_size"],
            num_hidden_layers=d["num_hidden_layers"],
            num_attention_heads=heads,
            num_key_value_heads=d.get("num_key_value_heads", heads),
            head_dim=d.get("head_dim", d["hidden_size"] // heads),
            rms_norm_eps=d.get("rms_norm_eps", 1e-6),
            rope_theta=d.get("rope_theta", 1_000_000.0),
            tie_word_embeddings=d.get("tie_word_embeddings", False),
            qk_norm=qk_norm,
            llama4_scaling_beta=(d.get("llama4_scaling_beta", 0.1) if llama4 else None),
            original_max_position_embeddings=d.get("original_max_position_embeddings", 16384),
        )


MISTRAL_SMALL_3_2 = DecoderConfig(
    vocab_size=131_072,
    hidden_size=5120,
    intermediate_size=14336,
    num_hidden_layers=40,
    num_attention_heads=32,
    num_key_value_heads=8,
    head_dim=128,
    rms_norm_eps=1e-5,
    rope_theta=1_000_000.0,
    tie_word_embeddings=False,
    qk_norm=False,
    llama4_scaling_beta=0.1,
    original_max_position_embeddings=16384,
)

QWEN3_4B = DecoderConfig(
    vocab_size=151_936,
    hidden_size=2560,
    intermediate_size=9216,
    num_hidden_layers=36,
    num_attention_heads=32,
    num_key_value_heads=8,
    head_dim=80,  # NOT hidden/heads
    rms_norm_eps=1e-6,
    tie_word_embeddings=True,
    qk_norm=True,
)

QWEN3_8B = DecoderConfig(
    vocab_size=151_936,
    hidden_size=4096,
    intermediate_size=12288,
    num_hidden_layers=36,
    num_attention_heads=32,
    num_key_value_heads=8,
    head_dim=128,
    rms_norm_eps=1e-6,
    tie_word_embeddings=True,
    qk_norm=True,
)

TINY_DECODER = DecoderConfig(
    vocab_size=256,
    hidden_size=64,
    intermediate_size=128,
    num_hidden_layers=4,
    num_attention_heads=4,
    num_key_value_heads=2,
    head_dim=16,
    qk_norm=True,
    tie_word_embeddings=True,
)


# FLUX.2 conditioning recipes: which hidden-state layers are concatenated.
# Index 0 is the embedding layer (EmbeddingExtractor.swift:262-270,
# KleinConfig.swift:28-46).
MISTRAL_HIDDEN_LAYERS: Tuple[int, ...] = (10, 20, 30)  # 3 x 5120 = 15360
QWEN3_HIDDEN_LAYERS: Tuple[int, ...] = (9, 18, 27)  # 3 x 2560 / 3 x 4096
MAX_SEQUENCE_LENGTH = 512
