"""FLUX.2 Klein conditioning-embedding extraction.

Port of the Klein recipe of ``flux2_tpu/models/text_encoders/extractor.py``:
the Qwen3 chat template with no system message and the empty think block
(enable_thinking=False), truncation to 512 tokens with RIGHT padding, and
hidden layers (9, 18, 27) concatenated along features -> [1, 512, 7680] for
Qwen3-4B.

A tokenizer with ``encode`` tokenizes the rendered template; one with only
``apply_chat_template`` (such as ``dev_tokenizer``'s byte stub, which is what
a host without ``tokenizers`` gets) renders it itself.
"""

from __future__ import annotations

import dataclasses
from typing import List, Protocol, Tuple

import numpy as np
import torch

from flux2_tpu_torch.models.text_encoders.config import (  # noqa: F401  (QWEN3_4B: re-exported for callers)
    MAX_SEQUENCE_LENGTH,
    QWEN3_4B,
    QWEN3_HIDDEN_LAYERS,
)
from flux2_tpu_torch.models.text_encoders.decoder import Qwen3Decoder
from flux2_tpu_torch.ops.quant import quantize_params


class ChatTokenizer(Protocol):
    pad_token_id: int

    def apply_chat_template(self, messages: List[dict], add_generation_prompt: bool = False) -> List[int]: ...


def format_qwen3_chat_template(prompt: str, add_generation_prompt: bool = True) -> str:
    """Klein chat template: no system message; the assistant turn opens with the
    empty think block, exactly as HF's Qwen3 template emits it."""
    s = f"<|im_start|>user\n{prompt}<|im_end|>\n"
    if add_generation_prompt:
        s += "<|im_start|>assistant\n<think>\n\n</think>\n\n"
    return s


def prepare_klein_input_ids(
    tokenizer: ChatTokenizer,
    prompt: str,
    max_length: int = MAX_SEQUENCE_LENGTH,
) -> Tuple[np.ndarray, np.ndarray]:
    """Tokenize + truncate + RIGHT-pad. Returns (input_ids, attention_mask) int32 [1, L]."""
    cleaned = prompt.replace("[IMG]", "")
    if hasattr(tokenizer, "encode"):
        token_ids = list(tokenizer.encode(format_qwen3_chat_template(cleaned, add_generation_prompt=True)))
    else:  # chat-template-only tokenizers
        token_ids = list(
            tokenizer.apply_chat_template([{"role": "user", "content": cleaned}], add_generation_prompt=True)
        )
    token_ids = token_ids[:max_length]
    pad_count = max_length - len(token_ids)
    ids = token_ids + [tokenizer.pad_token_id] * pad_count
    mask = [1] * len(token_ids) + [0] * pad_count
    return np.asarray(ids, dtype=np.int32)[None], np.asarray(mask, dtype=np.int32)[None]


@dataclasses.dataclass
class EmbeddingExtractor:
    """Prompt -> DiT conditioning [1, max_length, len(hidden_layers) * hidden]."""

    decoder: Qwen3Decoder
    tokenizer: ChatTokenizer
    hidden_layers: Tuple[int, ...] = QWEN3_HIDDEN_LAYERS
    max_length: int = MAX_SEQUENCE_LENGTH

    def __call__(self, prompt: str) -> torch.Tensor:
        ids, mask = prepare_klein_input_ids(self.tokenizer, prompt, self.max_length)
        device = self.decoder.embed_tokens.device
        with torch.inference_mode():
            return self.decoder.extract_hidden_layers(
                torch.from_numpy(ids).long().to(device), torch.from_numpy(mask).to(device), self.hidden_layers
            )


def qwen3_extractor(decoder: Qwen3Decoder, tokenizer: ChatTokenizer) -> EmbeddingExtractor:
    """Klein path: Qwen3 layers (9, 18, 27) with the Klein recipe."""
    return EmbeddingExtractor(decoder, tokenizer, QWEN3_HIDDEN_LAYERS)


def quantize_encoder_params(decoder: Qwen3Decoder, fmt: str) -> Qwen3Decoder:
    """Quantize the decoder's LAYER weights in place (JAX
    ``facade.quantize_encoder_params``): ``embed_tokens`` (gather-indexed) and
    the norms stay dense. Returns ``decoder``."""
    quantize_params(decoder.layers, fmt)
    return decoder
