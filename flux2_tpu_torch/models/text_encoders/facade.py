"""Text encoders: the registry of loaded encoders, their tokenizers, chat and upsampling.

Port of ``flux2_tpu/models/text_encoders/facade.py`` but for its vision
half: ``HFTokenizerAdapter``, ``resolve_tokenizer`` (a ``tekken.json``
directory gets the Tekken tokenizer, anything else the HF adapter),
``quantize_encoder_params`` (in ``extractor.py``), the ``TextEncoders``
registry and its ``shared`` instance (``load_mistral``, ``load_qwen3``,
``attach``, ``get``, ``unload``, ``unload_all``, ``is_loaded``, the FLUX and
Klein embeddings, ``chat`` with streaming and the Qwen3 thinking switch,
``generate_text``, ``upsample_prompt``), and ``compare_embeddings``. The
decoder's shape comes from the checkpoint's ``config.json`` (a VLM's
``text_config`` unwrapped) when there is one, not from the built-in
``QWEN3_4B`` / ``MISTRAL_SMALL_3_2``: the published Qwen3-4B has
``head_dim`` 128 and ``intermediate_size`` 9728 (built-in 80 and 9216), the
published Mistral Small 3.2 ``intermediate_size`` 32768 (built-in 14336).
The weights load in bf16 straight onto the device
(``io/weight_mapping.load_decoder``), the layers are quantized with
``quantization``, and an encoder keeps its recipe: Mistral's (10, 20, 30),
left padded, or Klein's (9, 18, 27), right padded.

The VLMs (Pixtral, Qwen3-VL, Qwen3.5) are the vision half of ROADMAP item
8 (8b), not ported yet: ``load_mistral_vlm``, ``load_qwen35_vlm``,
``analyze_image`` and ``compare_images_for_flux`` raise.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from flux2_tpu_torch.models.text_encoders import config as tc
from flux2_tpu_torch.models.text_encoders import generation
from flux2_tpu_torch.models.text_encoders.decoder import Qwen3Decoder
from flux2_tpu_torch.models.text_encoders.extractor import EmbeddingExtractor, chat_ids, quantize_encoder_params
from flux2_tpu_torch.utils import logging as flog

VISION_NOT_PORTED = "is the vision half of ROADMAP item 8 (8b), not ported to flux2_tpu_torch yet"


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
        return chat_ids(self._tok, messages, add_generation_prompt=add_generation_prompt)

    def decode(self, tokens: List[int]) -> str:
        return self._tok.decode(tokens, skip_special_tokens=True)


def resolve_tokenizer(path_or_repo: str):
    """A mistral-common ``tekken.json`` directory gets the Tekken BPE; any
    other goes through the HF ``tokenizer.json`` adapter (JAX's order)."""
    if os.path.isdir(path_or_repo) and os.path.exists(os.path.join(path_or_repo, "tekken.json")):
        from flux2_tpu_torch.models.text_encoders.tekken import TekkenTokenizer

        return TekkenTokenizer.from_pretrained(path_or_repo)
    return HFTokenizerAdapter.from_pretrained(path_or_repo)


@dataclasses.dataclass
class LoadedEncoder:
    name: str
    decoder: Qwen3Decoder
    config: tc.DecoderConfig
    tokenizer: Any
    extractor: EmbeddingExtractor


def read_decoder_config(weights_dir: str, default: tc.DecoderConfig, qk_norm: bool,
                        llama4: bool = False) -> tc.DecoderConfig:
    """The checkpoint's ``config.json`` (a VLM's ``text_config`` unwrapped), else ``default``."""
    path = os.path.join(weights_dir, "config.json")
    if not os.path.exists(path):
        return default
    with open(path) as f:
        d = json.load(f)
    return tc.DecoderConfig.from_json_dict(d.get("text_config", d), qk_norm=qk_norm, llama4=llama4)


class TextEncoders:
    """Registry of loaded encoder models, keyed by name ("mistral", "qwen3-4b", ...)."""

    def __init__(self):
        self._encoders: Dict[str, LoadedEncoder] = {}

    # -- loading ---------------------------------------------------------------------

    def load_mistral(self, weights_dir: str, tokenizer_dir: Optional[str] = None, quantization: str = "bf16",
                     device: "torch.device | str" = "cuda") -> LoadedEncoder:
        """Mistral Small 3.2 (the Dev encoder, llama4 query scaling), Mistral recipe."""
        return self._load("mistral", weights_dir, tokenizer_dir, tc.MISTRAL_SMALL_3_2, tc.MISTRAL_HIDDEN_LAYERS,
                          llama4=True, quantization=quantization, device=device)

    def load_qwen3(self, weights_dir: str, tokenizer_dir: Optional[str] = None, size: str = "4b",
                   quantization: str = "bf16", device: "torch.device | str" = "cuda") -> LoadedEncoder:
        """Qwen3-4B / 8B (Klein), Klein recipe."""
        return self._load(f"qwen3-{size}", weights_dir, tokenizer_dir, tc.QWEN3_4B if size == "4b" else tc.QWEN3_8B,
                          tc.QWEN3_HIDDEN_LAYERS, qk_norm=True, quantization=quantization, recipe="klein",
                          device=device)

    def _load(self, name, weights_dir, tokenizer_dir, default_cfg, layers, qk_norm=False, llama4=False,
              quantization="bf16", recipe="mistral", device="cuda") -> LoadedEncoder:
        from flux2_tpu_torch.io import checkpoints, weight_mapping

        cfg = read_decoder_config(weights_dir, default_cfg, qk_norm=qk_norm, llama4=llama4)
        decoder = weight_mapping.load_decoder(checkpoints.WeightsDir(weights_dir), cfg, device)
        if quantization != "bf16":
            quantize_encoder_params(decoder, quantization)
        tok = resolve_tokenizer(tokenizer_dir or weights_dir)
        flog.info(f"loaded text encoder {name} ({cfg.num_hidden_layers} layers, "
                  f"{cfg.hidden_size} hidden{', ' + quantization if quantization != 'bf16' else ''})")
        return self.attach(name, decoder, cfg, tok, layers, recipe=recipe)

    def attach(self, name: str, decoder: Qwen3Decoder, cfg: tc.DecoderConfig, tokenizer, hidden_layers,
               recipe: str = "mistral") -> LoadedEncoder:
        """Register an already-built encoder (random-init runs, tests)."""
        enc = LoadedEncoder(name=name, decoder=decoder, config=cfg, tokenizer=tokenizer,
                            extractor=EmbeddingExtractor(decoder, tokenizer, tuple(hidden_layers), recipe=recipe))
        self._encoders[name] = enc
        return enc

    def load_mistral_vlm(self, weights_dir: str, tokenizer_dir: Optional[str] = None):
        raise NotImplementedError(f"the Mistral-Small-3.2 VLM (Pixtral tower, {weights_dir}) {VISION_NOT_PORTED}")

    def load_qwen35_vlm(self, weights_dir: str, tokenizer_dir: Optional[str] = None):
        raise NotImplementedError(f"the Qwen3.5 VLM ({weights_dir}) {VISION_NOT_PORTED}")

    def unload(self, name: str) -> None:
        self._encoders.pop(name, None)

    def unload_all(self) -> None:
        self._encoders.clear()

    def is_loaded(self, name: str) -> bool:
        return name in self._encoders

    def get(self, name: str) -> LoadedEncoder:
        return self._encoders[name]

    # -- extraction --------------------------------------------------------------------

    def extract_flux_embeddings(self, prompt: str, name: str = "mistral") -> torch.Tensor:
        """Dev conditioning: [1, 512, 15360]."""
        return self._encoders[name].extractor(prompt)

    def extract_klein_embeddings(self, prompt: str, name: str = "qwen3-4b") -> torch.Tensor:
        """Klein conditioning: [1, 512, 7680 / 12288]."""
        return self._encoders[name].extractor(prompt)

    # -- generation ----------------------------------------------------------------------

    def chat(self, messages: List[dict], name: str, params: Optional[generation.GenerateParameters] = None,
             seed: int = 0, on_token=None, enable_thinking: bool = False) -> str:
        """One chat turn. Thinking is off by default: a Qwen3 encoder gets
        ``/no_think`` on the last user turn, and ``<think>`` blocks are stripped
        from the reply (and, with thinking off, from the stream) either way.
        ``on_token(text)`` gets each token's decoded piece."""
        enc = self._encoders[name]
        if "qwen3" in name.lower():
            messages = generation.apply_thinking_control(messages, enable_thinking)
        ids = chat_ids(enc.tokenizer, messages, add_generation_prompt=True)
        eos = [enc.tokenizer.eos_token_id] if getattr(enc.tokenizer, "eos_token_id", None) is not None else []
        stream = None
        emit = on_token
        if on_token is not None:
            if not enable_thinking:
                emit = generation.ThinkStreamFilter(on_token)  # the stream matches the stripped reply
            stream = lambda t: emit(enc.tokenizer.decode([t]))  # noqa: E731
        tokens = generation.generate(enc.decoder, ids, params or generation.GenerateParameters(),
                                     eos_token_ids=eos, seed=seed, on_token=stream)
        if isinstance(emit, generation.ThinkStreamFilter):
            emit.flush()  # a reply cut mid-"<think>" prefix is not swallowed
        return generation.strip_think_tags(enc.tokenizer.decode(tokens))

    def generate_text(self, prompt: str, name: str, **kw) -> str:
        return self.chat([{"role": "user", "content": prompt}], name, **kw)

    def analyze_image(self, image, prompt: str, seed: int = 0) -> str:
        raise NotImplementedError(f"VLM image analysis {VISION_NOT_PORTED}")

    def compare_images_for_flux(self, reference, generated) -> dict:
        raise NotImplementedError(f"VLM image comparison {VISION_NOT_PORTED}")

    def upsample_prompt(self, prompt: str, name: str, mode: str = "upsampling_t2i", seed: int = 0,
                        on_token=None) -> str:
        """The BFL prompt rewrite through encoder ``name`` (``on_token(id)``
        sees each generated id)."""
        enc = self._encoders[name]
        return generation.upsample_prompt(enc.decoder, enc.tokenizer, prompt, mode=mode, seed=seed,
                                          qwen3_no_think="qwen3" in name.lower(), on_token=on_token)


shared = TextEncoders()


def load_qwen3(weights_dir: str, tokenizer_dir: Optional[str] = None, size: str = "4b",
               quantization: str = "bf16", device: "torch.device | str" = "cuda") -> LoadedEncoder:
    """A Qwen3 checkpoint directory -> the Klein-recipe encoder on ``device``, registered in ``shared``."""
    return shared.load_qwen3(weights_dir, tokenizer_dir, size=size, quantization=quantization, device=device)


def load_mistral(weights_dir: str, tokenizer_dir: Optional[str] = None, quantization: str = "bf16",
                 device: "torch.device | str" = "cuda") -> LoadedEncoder:
    """A Mistral Small 3.2 checkpoint directory (plain or VLM layout) -> the
    Mistral-recipe encoder on ``device``, registered in ``shared``."""
    return shared.load_mistral(weights_dir, tokenizer_dir, quantization=quantization, device=device)


def compare_embeddings(emb_a, emb_b) -> dict:
    """Cosine similarity and max / mean absolute difference of two encoders'
    conditioning tensors for the same prompt (JAX's CompareEncoders harness)."""
    a = _host(emb_a).reshape(-1)
    b = _host(emb_b).reshape(-1)
    cos = float(np.dot(a, b) / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-12))
    diff = np.abs(a - b)
    return {
        "cosine_similarity": cos,
        "max_abs_diff": float(diff.max()),
        "mean_abs_diff": float(diff.mean()),
        "rel_mean_diff": float(diff.mean() / (np.abs(a).mean() + 1e-12)),
    }


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).cpu().numpy()
    return np.asarray(x, np.float32)
