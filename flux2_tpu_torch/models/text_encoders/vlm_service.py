"""VLM services: the vision towers wired to their language models.

Port of ``flux2_tpu/models/text_encoders/vlm_service.py``:

- ``MistralVLMService`` (the Dev path): Pixtral features projected into
  Mistral's embedding space, spliced in at the [IMG] positions, then
  KV-cached generation through the decoder's ``prefill(inputs_embeds=)`` /
  ``decode_step`` and ``generation.decode_loop``: image analysis and
  vision-aware upsampling. A w8a8 Mistral runs its layers on K5.
- ``Qwen35VLMService``: the Qwen3.5 vision tower and hybrid LM; ``chat``
  (the chains' prompt-builder callable, with "Image N:" labels on
  multi-image prompts), ``analyze_image``, ``compare_images_for_flux`` and
  ``score_validation_image`` (the trainer's scorer). Generation streams
  over the hybrid cache, with a (cache, position) carry through
  ``decode_loop``.
- The scoring and comparison system prompts and their parsers.

Each call runs on the device the models sit on, under
``torch.inference_mode()``. The KV cache holds the prompt and
``max_tokens``; JAX rounds its length up to a multiple of 256 to reuse
compiles (masked slots: the same logits).
"""

from __future__ import annotations

import dataclasses
import json
import re
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch

from flux2_tpu_torch.models.text_encoders import generation
from flux2_tpu_torch.models.text_encoders.decoder import Qwen3Decoder, init_kv_cache
from flux2_tpu_torch.models.text_encoders.extractor import chat_ids
from flux2_tpu_torch.models.text_encoders.pixtral import PixtralVision, PixtralVisionConfig
from flux2_tpu_torch.models.text_encoders.qwen35 import Qwen35LM, Qwen35TextConfig, init_hybrid_cache
from flux2_tpu_torch.models.text_encoders.qwen35_vision import (Qwen35Vision, Qwen35VisionConfig,
                                                               merge_image_embeddings, preprocess_image)

SCORING_SYSTEM_PROMPT = (
    "You compare a generated image against reference images for LoRA "
    "training validation. Score two axes from 0 to 10: SCENE (does the "
    "generated image depict the prompt's subject and composition?) and "
    "STYLE (does it match the references' visual style — palette, lighting, "
    "rendering?). Reply with exactly: scene=<n> style=<n>."
)

FLUX_IMAGE_COMPARISON_SYSTEM_PROMPT = (
    "You compare two images for FLUX.2 LoRA training evaluation. Image 1 is "
    "the REFERENCE (target). Image 2 is the GENERATED image (baseline "
    "without LoRA). Score each criterion from 0 to 100. Be STRICT and "
    "PRECISE - small differences matter for LoRA training decisions. "
    "SCENE score = content fidelity (subjects, poses, spatial layout); "
    "STYLE score = visual fidelity (art style, palette, lighting, "
    "textures). Respond ONLY with this exact JSON format, no other text: "
    '{"scene_score": N, "scene_reason": "brief explanation", '
    '"style_score": N, "style_reason": "brief explanation"}'
)

ANALYST_SYSTEM_PROMPT = "You are a precise visual analyst. Answer directly about the attached image."


def parse_comparison(text: str) -> dict:
    """The comparison JSON, with a regex fallback (JAX's ``parse_comparison``)."""
    cleaned = generation.strip_think_tags(text).replace("<|im_end|>", "").strip()
    for candidate in (cleaned, text):
        start, end = candidate.find("{"), candidate.rfind("}")
        if 0 <= start < end:
            try:
                d = json.loads(candidate[start:end + 1])
                return {
                    "scene_score": float(d.get("scene_score", 0) or 0),
                    "scene_reason": str(d.get("scene_reason", "")),
                    "style_score": float(d.get("style_score", 0) or 0),
                    "style_reason": str(d.get("style_reason", "")),
                }
            except (ValueError, TypeError):
                pass
    scene = re.search(r"scene[_ ]?score\D{0,4}(\d{1,3})", cleaned, re.I)
    style = re.search(r"style[_ ]?score\D{0,4}(\d{1,3})", cleaned, re.I)
    return {
        "scene_score": float(scene.group(1)) if scene else 0.0,
        "scene_reason": "",
        "style_score": float(style.group(1)) if style else 0.0,
        "style_reason": "",
    }


def parse_scores(text: str) -> Tuple[float, float]:
    """'scene=<n> style=<n>' -> the two scores clamped to 10, 0 where missing."""
    scene = re.search(r"scene\s*[=:]\s*([0-9]+(?:\.[0-9]+)?)", text, re.I)
    style = re.search(r"style\s*[=:]\s*([0-9]+(?:\.[0-9]+)?)", text, re.I)
    return (
        min(10.0, float(scene.group(1))) if scene else 0.0,
        min(10.0, float(style.group(1))) if style else 0.0,
    )


def _eos(tokenizer) -> Optional[List[int]]:
    eos = getattr(tokenizer, "eos_token_id", None)
    return [eos] if eos is not None else None


@dataclasses.dataclass
class MistralVLMService:
    """Pixtral + Mistral: image analysis by [IMG]-spliced generation."""

    decoder: Qwen3Decoder
    lm_config: Any  # DecoderConfig
    vision: PixtralVision
    vision_config: PixtralVisionConfig
    tokenizer: Any
    image_token_id: int = 10  # Mistral's [IMG]

    def encode_image(self, image: np.ndarray) -> torch.Tensor:
        """[H, W, 3] in [0, 1] -> projected features [1, T, lm_hidden]: the
        image cropped to 14 px multiples (an odd patch grid raises)."""
        pixels = (np.asarray(image, np.float32) - 0.5) / 0.5
        p = self.vision_config.patch_size
        h, w = image.shape[0] // p * p, image.shape[1] // p * p
        x = torch.from_numpy(np.ascontiguousarray(pixels[None, :h, :w])).to(self.decoder.embed_tokens.device)
        with torch.inference_mode():
            return self.vision.encode_and_project(x)

    def prefill(self, image: np.ndarray, prompt: str, max_tokens: int):
        """The image's [IMG] tokens, then the chat-templated prompt, prefilled
        into a KV cache with room for ``max_tokens`` more -> (last logits
        [1, V], the cache, its length)."""
        img_embeds = self.encode_image(image)
        text_ids = chat_ids(self.tokenizer, [{"role": "user", "content": prompt}], add_generation_prompt=True)
        ids = [self.image_token_id] * img_embeds.shape[1] + text_ids
        device = self.decoder.embed_tokens.device
        max_len = len(ids) + max_tokens
        with torch.inference_mode():
            input_ids = torch.tensor([ids], device=device)
            merged = merge_image_embeddings(self.decoder.embed_tokens[input_ids], input_ids, img_embeds,
                                            self.image_token_id)
            cache = init_kv_cache(self.lm_config, 1, max_len, generation._stream_dtype(self.decoder), device)
            logits, cache = generation.prefill_embeds_runner(self.decoder)(input_ids, cache, merged)
        return logits, cache, max_len

    def analyze_image(self, image: np.ndarray, prompt: str,
                      gen_params: Optional[generation.GenerateParameters] = None, seed: int = 0) -> str:
        gp = gen_params or generation.GenerateParameters(max_tokens=128, temperature=0.2)
        logits, cache, max_len = self.prefill(image, prompt, gp.max_tokens)
        step_fn, carry_len = generation.decoder_step_fn(self.decoder)
        out = generation.decode_loop(logits, cache, step_fn, carry_len, max_len, gp,
                                     eos_token_ids=_eos(self.tokenizer), seed=seed)
        return self.tokenizer.decode(out)


@dataclasses.dataclass
class Qwen35VLMService:
    """The Qwen3.5 hybrid VLM: the chains' prompt enrichment and validation scoring."""

    lm: Qwen35LM
    lm_config: Qwen35TextConfig
    vision: Qwen35Vision
    vision_config: Qwen35VisionConfig
    tokenizer: Any

    @property
    def device(self) -> torch.device:
        return self.lm.embed_tokens.device

    def _merged_inputs(self, text_ids: List[int], image) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """image: None, one [H, W, 3] array or a sequence of them. Several
        images are labelled "Image N:" (when the tokenizer can encode); the
        image tokens are filled by rank, so the interleaved text is kept."""
        if image is None:
            return torch.tensor([text_ids], device=self.device), None
        images = [image] if isinstance(image, np.ndarray) or getattr(image, "ndim", 0) == 3 else list(image)
        with torch.inference_mode():
            blocks = [self.vision(torch.from_numpy(preprocess_image(np.asarray(im, np.float32),
                                                                    self.vision_config)[None]).to(self.device))
                      for im in images]
            img_embeds = torch.cat(blocks, dim=1)
            tok_id = self.vision_config.image_token_id
            can_label = len(images) > 1 and hasattr(self.tokenizer, "encode")
            ids: list = []
            for i, blk in enumerate(blocks):
                if can_label:
                    ids += list(self.tokenizer.encode(f"\nImage {i + 1}: "))
                ids += [tok_id] * blk.shape[1]
            if can_label:
                ids += list(self.tokenizer.encode("\n"))
            ids += list(text_ids)
            ids_t = torch.tensor([ids], device=self.device)
            # the image token may lie outside the vocabulary: embed id 0 there, as JAX
            text_embeds = self.lm.embed_tokens[torch.where(ids_t == tok_id, 0, ids_t)]
            return ids_t, merge_image_embeddings(text_embeds, ids_t, img_embeds, tok_id)

    def prefill(self, ids: torch.Tensor, merged: Optional[torch.Tensor], max_len: int):
        """``ids`` [1, S] (and their merged embeddings) into a fresh hybrid
        cache of ``max_len`` slots -> (last logits [1, V], the cache)."""
        cache = init_hybrid_cache(self.lm_config, 1, max_len, device=self.device)
        with torch.inference_mode():
            return self.lm.forward_cached(ids, cache, 0, inputs_embeds=merged)

    def chat(self, system: str, user: str, image: Optional[np.ndarray] = None, max_tokens: int = 128,
             seed: int = 0, gen_params: Optional[generation.GenerateParameters] = None) -> str:
        """(system, user, image) -> the reply: a prefill over the hybrid cache,
        then ``decode_loop`` with a (cache, position) carry. Greedy without
        repetition penalty unless ``gen_params`` says otherwise."""
        text_ids = chat_ids(self.tokenizer, [{"role": "system", "content": system},
                                             {"role": "user", "content": user}], add_generation_prompt=True)
        ids, merged = self._merged_inputs(text_ids, image)
        prompt_len = ids.shape[1]
        max_len = prompt_len + max_tokens
        logits, cache = self.prefill(ids, merged, max_len)

        def step_fn(tok, carry):
            c, pos = carry
            lg, c = self.lm.forward_cached(tok, c, pos)
            return lg, (c, pos + 1)

        gp = (dataclasses.replace(gen_params, max_tokens=max_tokens) if gen_params is not None
              else generation.GenerateParameters(max_tokens=max_tokens, temperature=0.0, repetition_penalty=1.0))
        out = generation.decode_loop(logits, (cache, prompt_len), step_fn, lambda carry: carry[1], max_len, gp,
                                     eos_token_ids=_eos(self.tokenizer), seed=seed)
        return self.tokenizer.decode(out)

    def analyze_image(self, image: np.ndarray, prompt: str,
                      gen_params: Optional[generation.GenerateParameters] = None, seed: int = 0) -> str:
        """Image + prompt -> description: a vision chat turn."""
        gp = gen_params or generation.GenerateParameters(max_tokens=128, temperature=0.2)
        return self.chat(ANALYST_SYSTEM_PROMPT, prompt, image=image, max_tokens=gp.max_tokens, seed=seed,
                         gen_params=gp)

    def compare_images_for_flux(self, reference: np.ndarray, generated: np.ndarray, max_tokens: int = 300) -> dict:
        """Image 1 the reference, image 2 the generated one -> {"scene_score",
        "scene_reason", "style_score", "style_reason"} on the 0-100 scale."""
        reply = self.chat(FLUX_IMAGE_COMPARISON_SYSTEM_PROMPT, "Compare these two images.",
                          image=[reference, generated], max_tokens=max_tokens)
        return parse_comparison(reply)

    def score_validation_image(self, image: np.ndarray, reference_images: Sequence[np.ndarray],
                               prompt: str) -> Tuple[float, float]:
        """(scene, style) on 0-10: the trainer's VLM scorer."""
        reply = self.chat(SCORING_SYSTEM_PROMPT, f"Prompt: {prompt}. Score the attached generated image.",
                          image=image, max_tokens=24)
        return parse_scores(reply)
