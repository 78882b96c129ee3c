"""Text encoders: the registry of loaded encoders and VLMs, their tokenizers, chat and upsampling.

Port of ``flux2_tpu/models/text_encoders/facade.py``: ``HFTokenizerAdapter``, ``resolve_tokenizer`` (a ``tekken.json``
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
(``io/weight_mapping.load_decoder``), each layer quantized with
``quantization`` as it is filled, and an encoder keeps its recipe:
Mistral's (10, 20, 30), left padded, or Klein's (9, 18, 27), right padded.

The vision half: ``detect_vlm_family`` ("qwen35" for a checkpoint with a
``vision_config`` and a qwen ``model_type``, else "mistral"),
``load_mistral_vlm`` (the Pixtral tower and projector beside the Mistral LM,
which is reused when loaded, quantized or not), ``load_qwen35_vlm`` (the
hybrid LM and its vision tower from one HF-layout checkpoint; it replaces a
resident VLM of the other family), ``attach_vlm``, ``is_vlm_loaded``,
``unload_vlm``, ``analyze_image`` and ``compare_images_for_flux``, with
JAX's errors. The VLM weights load in bf16 onto the device.
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
from flux2_tpu_torch.models.text_encoders.extractor import (  # noqa: F401  (quantize_encoder_params: JAX facade's name)
    EmbeddingExtractor,
    chat_ids,
    quantize_encoder_params,
)
from flux2_tpu_torch.utils import logging as flog

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


def detect_vlm_family(weights_dir: str) -> str:
    """"qwen35" | "mistral" from a checkpoint directory's config.json: a
    ``vision_config`` and a qwen ``model_type`` (top level or in
    ``text_config``) make a Qwen3.5-VL; anything else is the Mistral/Pixtral VLM."""
    path = os.path.join(weights_dir, "config.json")
    if not os.path.exists(path):
        return "mistral"
    with open(path) as f:
        d = json.load(f)
    if "vision_config" not in d:
        return "mistral"
    mtype = str(d.get("model_type", "")).lower()
    sub = str(d.get("text_config", {}).get("model_type", "")).lower()
    return "qwen35" if ("qwen" in mtype or "qwen" in sub) else "mistral"


class TextEncoders:
    """Registry of loaded encoder models, keyed by name ("mistral", "qwen3-4b", ...), and of one VLM."""

    def __init__(self):
        self._encoders: Dict[str, LoadedEncoder] = {}
        self._vlm = None  # a MistralVLMService or a Qwen35VLMService

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
        # a quantized encoder is quantized layer by layer as it loads (quantize_encoder_params' result)
        decoder = weight_mapping.load_decoder(checkpoints.WeightsDir(weights_dir), cfg, device,
                                              quantization=quantization)
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

    def load_mistral_vlm(self, weights_dir: str, tokenizer_dir: Optional[str] = None,
                         device: "torch.device | str" = "cuda"):
        """The Mistral-Small-3.2 VLM: the Pixtral tower and projector of the
        checkpoint beside its Mistral LM (the loaded "mistral" encoder when
        there is one, in whatever format it was loaded) -> a MistralVLMService."""
        from flux2_tpu_torch.io import checkpoints, weight_mapping
        from flux2_tpu_torch.models.text_encoders.pixtral import PixtralVisionConfig
        from flux2_tpu_torch.models.text_encoders.vlm_service import MistralVLMService

        if self._vlm is not None:
            return self._vlm
        if not self.is_loaded("mistral"):
            self.load_mistral(weights_dir, tokenizer_dir, device=device)
        lm = self._encoders["mistral"]
        vcfg = PixtralVisionConfig(text_hidden_size=lm.config.hidden_size)
        image_token_id = 10
        cfg_json = os.path.join(weights_dir, "config.json")
        if os.path.exists(cfg_json):
            with open(cfg_json) as f:
                d = json.load(f)
            v = d.get("vision_config", {})
            vcfg = PixtralVisionConfig(
                hidden_size=v.get("hidden_size", 1024),
                intermediate_size=v.get("intermediate_size", 4096),
                num_hidden_layers=v.get("num_hidden_layers", 24),
                num_attention_heads=v.get("num_attention_heads", 16),
                patch_size=v.get("patch_size", 14),
                image_size=v.get("image_size", 1540),
                rope_theta=v.get("rope_theta", 10000.0),
                spatial_merge_size=d.get("spatial_merge_size", 2),
                text_hidden_size=lm.config.hidden_size,
            )
            image_token_id = d.get("image_token_index", 10)
        vision = weight_mapping.load_pixtral(checkpoints.WeightsDir(weights_dir), vcfg, lm.decoder.embed_tokens.device)
        self._vlm = MistralVLMService(decoder=lm.decoder, lm_config=lm.config, vision=vision, vision_config=vcfg,
                                      tokenizer=lm.tokenizer, image_token_id=image_token_id)
        flog.info(f"loaded Mistral VLM (Pixtral {vcfg.num_hidden_layers}-layer tower)")
        return self._vlm

    def load_qwen35_vlm(self, weights_dir: str, tokenizer_dir: Optional[str] = None,
                        device: "torch.device | str" = "cuda"):
        """The Qwen3.5 VLM (hybrid Gated DeltaNet LM and Qwen3-VL vision tower)
        from one HF-layout checkpoint -> a Qwen35VLMService. A resident VLM
        of the other family is replaced."""
        from flux2_tpu_torch.io import checkpoints, weight_mapping
        from flux2_tpu_torch.models.text_encoders.qwen35 import Qwen35TextConfig
        from flux2_tpu_torch.models.text_encoders.qwen35_vision import Qwen35VisionConfig
        from flux2_tpu_torch.models.text_encoders.vlm_service import Qwen35VLMService

        if isinstance(self._vlm, Qwen35VLMService):
            return self._vlm
        if self._vlm is not None:
            flog.info("replacing the loaded non-Qwen3.5 VLM with the requested Qwen3.5-VL")
            self._vlm = None
        with open(os.path.join(weights_dir, "config.json")) as f:
            d = json.load(f)
        vis_d = d.get("vision_config")
        if vis_d is None:
            raise ValueError(
                f"{weights_dir}/config.json has no vision_config — not a "
                "Qwen3.5-VL checkpoint (use load_mistral_vlm for Pixtral VLMs)"
            )
        lm_cfg = Qwen35TextConfig.from_json_dict(d.get("text_config", d))
        v_cfg = Qwen35VisionConfig.from_json_dict(vis_d, image_token_id=d.get("image_token_id",
                                                                              d.get("image_token_index")))
        weights = checkpoints.WeightsDir(weights_dir)
        lm = weight_mapping.load_qwen35(weights, lm_cfg, device)
        vision = weight_mapping.load_qwen35_vision(weights, v_cfg, device)
        tok = HFTokenizerAdapter.from_pretrained(tokenizer_dir or weights_dir)
        self._vlm = Qwen35VLMService(lm, lm_cfg, vision, v_cfg, tok)
        flog.info(f"loaded Qwen3.5 VLM ({lm_cfg.num_hidden_layers}-layer hybrid LM, {v_cfg.depth}-layer vision tower)")
        return self._vlm

    def attach_vlm(self, vlm) -> None:
        """Register an already-built vision service (random-init runs, tests)."""
        self._vlm = vlm

    @property
    def is_vlm_loaded(self) -> bool:
        return self._vlm is not None

    def unload_vlm(self) -> None:
        self._vlm = None

    def shard(self, name: str, mesh) -> None:
        """Distribute an encoder's weights over a mesh with DECODER_RULES (JAX's
        ``shard``); its conditioning path then runs sharded and returns the
        gathered embeddings. A mesh of one rank leaves the weights as they are."""
        from flux2_tpu_torch.parallel import sharding as sh

        if not sh.shards_nothing(mesh):
            sh.shard_params(self._encoders[name].decoder, mesh, sh.DECODER_RULES)

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
        """VLM image analysis through the loaded VLM."""
        if self._vlm is None:
            raise ValueError("no VLM loaded; call load_mistral_vlm first")
        return self._vlm.analyze_image(image, prompt, seed=seed)

    def compare_images_for_flux(self, reference, generated) -> dict:
        """The two-image FLUX.2 comparison through the Qwen3.5 VLM."""
        if self._vlm is None:
            raise ValueError("no VLM loaded; call load_qwen35_vlm first")
        if not hasattr(self._vlm, "compare_images_for_flux"):
            raise ValueError("image comparison needs the Qwen3.5 VLM (multi-image)")
        return self._vlm.compare_images_for_flux(reference, generated)

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
