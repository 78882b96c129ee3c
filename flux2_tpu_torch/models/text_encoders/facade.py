"""Text-encoder loading: Qwen3 checkpoints and their tokenizers.

Port of the Qwen3 half of ``flux2_tpu/models/text_encoders/facade.py``:
``HFTokenizerAdapter`` (``:28-56``), ``resolve_tokenizer`` (``:72-82``) and
``load_qwen3`` / ``_load`` (``:132-183``). The decoder's shape comes from the
checkpoint's ``config.json`` (``text_config`` unwrapped) when there is one,
not from the built-in ``QWEN3_4B``: the published Qwen3-4B has ``head_dim``
128 and ``intermediate_size`` 9728, the built-in random-init shape 80 and
9216. The weights load in bf16 straight onto the device
(``io/weight_mapping.load_decoder``), the layers are quantized with
``quantization``, and the Klein recipe reads ``QWEN3_HIDDEN_LAYERS``.

Mistral (the Dev encoder), its ``tekken.json`` tokenizer and the VLMs are
not ported yet (ROADMAP item 8): those calls raise.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, List, Optional

import torch

from flux2_tpu_torch.models.text_encoders import config as tc
from flux2_tpu_torch.models.text_encoders.decoder import Qwen3Decoder
from flux2_tpu_torch.models.text_encoders.extractor import EmbeddingExtractor, quantize_encoder_params

NOT_PORTED = "is not ported to flux2_tpu_torch yet (ROADMAP item 8)"


class HFTokenizerAdapter:
    """Wraps a transformers tokenizer into the ChatTokenizer protocol."""

    def __init__(self, tokenizer):
        self._tok = tokenizer
        pad = tokenizer.pad_token_id
        if pad is None:
            pad = tokenizer.eos_token_id or 0
        self.pad_token_id = int(pad)
        self.eos_token_id = tokenizer.eos_token_id

    @classmethod
    def from_pretrained(cls, path_or_repo: str) -> "HFTokenizerAdapter":
        from transformers import AutoTokenizer

        return cls(AutoTokenizer.from_pretrained(path_or_repo))

    def encode(self, text: str) -> List[int]:
        return list(self._tok.encode(text, add_special_tokens=False))

    def apply_chat_template(self, messages: List[dict], add_generation_prompt: bool = False) -> List[int]:
        return list(self._tok.apply_chat_template(messages, add_generation_prompt=add_generation_prompt,
                                                  tokenize=True))

    def decode(self, tokens: List[int]) -> str:
        return self._tok.decode(tokens, skip_special_tokens=True)


def resolve_tokenizer(path_or_repo: str):
    """A mistral-common ``tekken.json`` directory raises (not ported); any
    other goes through the HF ``tokenizer.json`` adapter."""
    if os.path.isdir(path_or_repo) and os.path.exists(os.path.join(path_or_repo, "tekken.json")):
        raise NotImplementedError(f"the Tekken tokenizer ({path_or_repo}/tekken.json) {NOT_PORTED}")
    return HFTokenizerAdapter.from_pretrained(path_or_repo)


@dataclasses.dataclass
class LoadedEncoder:
    name: str
    decoder: Qwen3Decoder
    config: tc.DecoderConfig
    tokenizer: Any
    extractor: EmbeddingExtractor


def read_decoder_config(weights_dir: str, default: tc.DecoderConfig, qk_norm: bool) -> tc.DecoderConfig:
    """The checkpoint's ``config.json`` (a VLM's ``text_config`` unwrapped), else ``default``."""
    path = os.path.join(weights_dir, "config.json")
    if not os.path.exists(path):
        return default
    with open(path) as f:
        d = json.load(f)
    return tc.DecoderConfig.from_json_dict(d.get("text_config", d), qk_norm=qk_norm)


def load_qwen3(weights_dir: str, tokenizer_dir: Optional[str] = None, size: str = "4b",
               quantization: str = "bf16", device: "torch.device | str" = "cuda") -> LoadedEncoder:
    """A Qwen3 checkpoint directory -> the Klein-recipe encoder on ``device``."""
    from flux2_tpu_torch.io import checkpoints, weight_mapping

    name = f"qwen3-{size}"
    cfg = read_decoder_config(weights_dir, tc.QWEN3_4B if size == "4b" else tc.QWEN3_8B, qk_norm=True)
    decoder = weight_mapping.load_decoder(checkpoints.WeightsDir(weights_dir), cfg, device)
    if quantization != "bf16":
        quantize_encoder_params(decoder, quantization)
    tok = resolve_tokenizer(tokenizer_dir or weights_dir)
    return LoadedEncoder(name, decoder, cfg, tok, EmbeddingExtractor(decoder, tok, tc.QWEN3_HIDDEN_LAYERS))


def load_mistral(weights_dir: str, tokenizer_dir: Optional[str] = None, quantization: str = "bf16",
                 device: "torch.device | str" = "cuda") -> LoadedEncoder:
    raise NotImplementedError(f"the Mistral-Small-3.2 encoder (Dev's, {weights_dir}) {NOT_PORTED}")
