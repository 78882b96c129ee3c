"""FLUX.2 conditioning-embedding extraction: the Mistral (Dev) and Klein recipes.

Port of ``flux2_tpu/models/text_encoders/extractor.py``.

  Mistral / Dev recipe: chat messages [system: the BFL prompt, user: the
  prompt with any "[IMG]" markers stripped], the chat template WITHOUT a
  generation prompt, truncation to 512 tokens, then LEFT padding to 512
  (mask 0 on padding); hidden layers (10, 20, 30) concatenated along
  features -> [1, 512, 15360] for Mistral Small 3.2.

  Klein / Qwen3 recipe: no system message, the generation prompt ending in
  the empty think block (enable_thinking=False), RIGHT padding; hidden
  layers (9, 18, 27) -> [1, 512, 7680] for Qwen3-4B.

A tokenizer with ``encode`` tokenizes the rendered Klein template; one with
only ``apply_chat_template`` (such as ``dev_tokenizer``'s byte stub, which is
what a host without ``tokenizers`` gets) renders it itself. The BFL system
prompts (also the upsampling ones of ``generation.upsample_prompt``) are
JAX's bytes.
"""

from __future__ import annotations

import dataclasses
from typing import List, Protocol, Tuple

import numpy as np
import torch

from flux2_tpu_torch.models.text_encoders.config import (  # noqa: F401  (QWEN3_4B: re-exported for callers)
    MAX_SEQUENCE_LENGTH,
    MISTRAL_HIDDEN_LAYERS,
    QWEN3_4B,
    QWEN3_HIDDEN_LAYERS,
)
from flux2_tpu_torch.models.text_encoders.decoder import Qwen3Decoder
from flux2_tpu_torch.ops.quant import quantize_params
from flux2_tpu_torch.parallel.sharding import gather

SYSTEM_MESSAGE_EMBEDDINGS = (
    "You are an AI that reasons about image descriptions. You give structured "
    "responses focusing on object relationships, object attribution and "
    "actions without speculation.\n"
)

SYSTEM_MESSAGE_UPSAMPLING_T2I = """You are an expert prompt engineer for FLUX.2 by Black Forest Labs. Rewrite user prompts to be more descriptive while strictly preserving their core subject and intent.

Guidelines:
1. Structure: Keep structured inputs structured (enhance within fields). Convert natural language to detailed paragraphs.
2. Details: Add concrete visual specifics - form, scale, textures, materials, lighting (quality, direction, color), shadows, spatial relationships, and environmental context.
3. Text in Images: Put ALL text in quotation marks, matching the prompt's language. Always provide explicit quoted text for objects that would contain text in reality (signs, labels, screens, etc.) - without it, the model generates gibberish.

Output only the revised prompt and nothing else.
"""

SYSTEM_MESSAGE_UPSAMPLING_I2I = """You are FLUX.2 by Black Forest Labs, an image-editing expert. You convert editing requests into one concise instruction (50-80 words, ~30 for brief requests).

Rules:
- Single instruction only, no commentary
- Use clear, analytical language (avoid "whimsical," "cascading," etc.)
- Specify what changes AND what stays the same (face, lighting, composition)
- Reference actual image elements
- Turn negatives into positives ("don't change X" → "keep X")
- Make abstractions concrete ("futuristic" → "glowing cyan neon, metallic panels")

Output only the final instruction in plain text and nothing else.
"""


class ChatTokenizer(Protocol):
    pad_token_id: int

    def apply_chat_template(self, messages: List[dict], add_generation_prompt: bool = False) -> List[int]: ...


def build_messages(prompt: str, mode: str = "embeddings") -> List[dict]:
    system = {
        "embeddings": SYSTEM_MESSAGE_EMBEDDINGS,
        "upsampling_t2i": SYSTEM_MESSAGE_UPSAMPLING_T2I,
        "upsampling_i2i": SYSTEM_MESSAGE_UPSAMPLING_I2I,
    }[mode]
    return [
        {"role": "system", "content": system},
        {"role": "user", "content": prompt},
    ]


def chat_ids(tokenizer, messages: List[dict], add_generation_prompt: bool = False) -> List[int]:
    """The token ids of ``tokenizer.apply_chat_template``: a list of ints from
    the Tekken and stub tokenizers, a list or, in newer transformers, a
    ``BatchEncoding`` (its "input_ids") from an HF tokenizer."""
    ids = tokenizer.apply_chat_template(messages, add_generation_prompt=add_generation_prompt)
    if hasattr(ids, "keys"):
        ids = ids["input_ids"]
    return [int(t) for t in ids]


def prepare_input_ids(
    tokenizer: ChatTokenizer,
    prompt: str,
    max_length: int = MAX_SEQUENCE_LENGTH,
) -> Tuple[np.ndarray, np.ndarray]:
    """Mistral recipe: tokenize + truncate + LEFT-pad. Returns (input_ids, attention_mask) int32 [1, L]."""
    cleaned = prompt.replace("[IMG]", "")
    token_ids = chat_ids(tokenizer, build_messages(cleaned))
    token_ids = token_ids[:max_length]
    pad_count = max_length - len(token_ids)
    ids = [tokenizer.pad_token_id] * pad_count + token_ids
    mask = [0] * pad_count + [1] * len(token_ids)
    return np.asarray(ids, dtype=np.int32)[None], np.asarray(mask, dtype=np.int32)[None]


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
    """Klein recipe: tokenize + truncate + RIGHT-pad. Returns (input_ids, attention_mask) int32 [1, L]."""
    cleaned = prompt.replace("[IMG]", "")
    if hasattr(tokenizer, "encode"):
        token_ids = list(tokenizer.encode(format_qwen3_chat_template(cleaned, add_generation_prompt=True)))
    else:  # chat-template-only tokenizers
        token_ids = chat_ids(tokenizer, [{"role": "user", "content": cleaned}], add_generation_prompt=True)
    token_ids = token_ids[:max_length]
    pad_count = max_length - len(token_ids)
    ids = token_ids + [tokenizer.pad_token_id] * pad_count
    mask = [1] * len(token_ids) + [0] * pad_count
    return np.asarray(ids, dtype=np.int32)[None], np.asarray(mask, dtype=np.int32)[None]


@dataclasses.dataclass
class EmbeddingExtractor:
    """Prompt -> DiT conditioning [1, max_length, len(hidden_layers) * hidden].
    ``recipe`` is JAX's: "mistral" (system prompt, LEFT padding) or "klein"
    (think block, RIGHT padding); the port's default is "klein", the recipe
    of every encoder it ran before Mistral. It keys train-lora's caption cache."""

    decoder: Qwen3Decoder
    tokenizer: ChatTokenizer
    hidden_layers: Tuple[int, ...] = QWEN3_HIDDEN_LAYERS
    max_length: int = MAX_SEQUENCE_LENGTH
    recipe: str = "klein"

    def __call__(self, prompt: str) -> torch.Tensor:
        """The conditioning as a plain tensor (a sharded decoder's gathered)."""
        prep = prepare_klein_input_ids if self.recipe == "klein" else prepare_input_ids
        ids, mask = prep(self.tokenizer, prompt, self.max_length)
        device = self.decoder.embed_tokens.device
        with torch.inference_mode():
            return gather(self.decoder.extract_hidden_layers(
                torch.from_numpy(ids).long().to(device), torch.from_numpy(mask).to(device), self.hidden_layers
            ))

    @property
    def embedding_dim(self) -> int:
        return len(self.hidden_layers) * self.decoder.cfg.hidden_size


def mistral_extractor(decoder: Qwen3Decoder, tokenizer: ChatTokenizer) -> EmbeddingExtractor:
    """Dev path: Mistral layers (10, 20, 30) with the Mistral recipe -> [1, 512, 15360]."""
    return EmbeddingExtractor(decoder, tokenizer, MISTRAL_HIDDEN_LAYERS, recipe="mistral")


def qwen3_extractor(decoder: Qwen3Decoder, tokenizer: ChatTokenizer) -> EmbeddingExtractor:
    """Klein path: Qwen3 layers (9, 18, 27) with the Klein recipe."""
    return EmbeddingExtractor(decoder, tokenizer, QWEN3_HIDDEN_LAYERS, recipe="klein")


def quantize_encoder_params(decoder: Qwen3Decoder, fmt: str) -> Qwen3Decoder:
    """Quantize the decoder's LAYER weights in place (JAX
    ``facade.quantize_encoder_params``): ``embed_tokens`` (gather-indexed),
    ``lm_head`` and the norms stay dense. Returns ``decoder``."""
    quantize_params(decoder.layers, fmt)
    return decoder
