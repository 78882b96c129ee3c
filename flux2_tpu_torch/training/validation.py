"""VLM-scored validation for LoRA training + evaluation pipeline.

The port's own copy of ``flux2_tpu/training/validation.py``: the same
prompts, tracker, passes and gap analysis, generating through the port's
``Flux2Pipeline`` (embeddings as tensors on its device). Validation PNGs
carry JAX's pixels (``io.png.to_u8``: truncated, not rounded), and reference
images are read by ``io.png.decode_image`` (Pillow where it imports).
Held against the original in ``tests/test_torch_validation.py``.

Capability parity with the reference's validation machinery
(``SimpleLoRATrainer.swift:1746-2409`` and ``Training/LoRAEvaluator.swift``):

  - Periodic validation-image generation using the DISTILLED sibling model
    (base models train, distilled siblings preview — :1746-2006).
  - VLM scoring of validation images against dataset references on two
    axes, scene and style, 0-10 each (:2008-2409) — the scorer here is
    pluggable: any callable ``(image, reference_images, prompt) ->
    (scene, style)``; a no-op scorer keeps training headless.
  - Best-checkpoint tracking by combined score and early stopping after N
    non-improving validations.
  - Evaluator: describe references -> generate baseline -> compare ->
    recommend training parameters (LoRAEvaluator.swift:13-45).
"""

from __future__ import annotations

import dataclasses
import os
import re
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

# (generated image, reference images, prompt) -> (scene 0-10, style 0-10)
VLMScorer = Callable[[np.ndarray, Sequence[np.ndarray], str], Tuple[float, float]]


@dataclasses.dataclass
class ValidationPrompt:
    """Per-prompt validation config (ValidationPromptConfig,
    LoRATrainingConfig.swift:395-405): per-prompt size/seed, trigger-word
    application, and an optional reference image for I2I validation."""

    prompt: str
    width: Optional[int] = None  # None -> ValidationConfig.width
    height: Optional[int] = None
    seed: Optional[int] = None  # None -> config seed + prompt index
    apply_trigger: bool = True
    reference: Optional[str] = None  # image path -> I2I validation
    vlm_generated: bool = False

    @classmethod
    def normalize(cls, p) -> "ValidationPrompt":
        if isinstance(p, ValidationPrompt):
            return p
        if isinstance(p, str):
            return cls(prompt=p)
        if isinstance(p, dict):
            size = p.get("size")
            # the reference YAML spells these is_512/is_1024
            # (TrainingConfigYAML.swift YAMLValidationPrompt CodingKeys);
            # both spellings are accepted here
            is512 = p.get("is_512", p.get("is512"))
            is1024 = p.get("is_1024", p.get("is1024"))
            if size is None and (is512 or is1024):
                size = 1024 if is1024 else 512
            return cls(
                prompt=p["prompt"],
                width=p.get("width", size),
                height=p.get("height", size),
                seed=p.get("seed"),
                apply_trigger=bool(p.get("apply_trigger", True)),
                reference=p.get("reference") or p.get("reference_image"),
                vlm_generated=bool(p.get("is_vlm_generated", p.get("vlm_generated", False))),
            )
        raise TypeError(f"validation prompt must be str|dict, got {type(p)}")


@dataclasses.dataclass
class ValidationConfig:
    prompts: Sequence[object] = ()  # str or ValidationPrompt-style dicts
    every_n_steps: int = 250
    images_per_prompt: int = 1
    early_stop_patience: int = 3  # non-improving validations before stop
    width: int = 512
    height: int = 512
    steps: int = 4
    seed: int = 1234
    guidance: Optional[float] = None  # None -> model default
    trigger_word: Optional[str] = None  # applied when prompt.apply_trigger


@dataclasses.dataclass
class ValidationRecord:
    step: int
    prompt: str
    scene: float
    style: float

    @property
    def combined(self) -> float:
        return self.scene + self.style


class ValidationTracker:
    """Best-checkpoint tracking + early stopping over validation scores.

    ``patience <= 0`` disables early stopping (best tracking continues).
    ``scene_weight`` weights the combined score 2*(w*scene + (1-w)*style)
    (YAMLVLMScoringConfig.sceneWeight; w=0.5 == scene+style).
    ``min_delta``: a pass only counts as improving when it beats the best by
    this much. ``degradation_threshold`` > 0: stop immediately when the mean
    falls that far below the best (catastrophic-forgetting guard)."""

    def __init__(
        self,
        patience: int = 3,
        scene_weight: float = 0.5,
        min_delta: float = 0.0,
        degradation_threshold: float = 0.0,
    ):
        self.patience = patience
        self.scene_weight = scene_weight
        self.min_delta = min_delta
        self.degradation_threshold = degradation_threshold
        self.records: List[ValidationRecord] = []
        self.best_step: Optional[int] = None
        self.best_score: float = float("-inf")
        self._non_improving = 0

    def combined(self, r: ValidationRecord) -> float:
        w = self.scene_weight
        return 2.0 * (w * r.scene + (1.0 - w) * r.style)

    def mean_combined(self, scores: Sequence[ValidationRecord]) -> float:
        return float(np.mean([self.combined(r) for r in scores])) if scores else 0.0

    def record(self, step: int, scores: Sequence[ValidationRecord]) -> bool:
        """Returns True when training should early-stop."""
        self.records.extend(scores)
        mean = self.mean_combined(scores)
        if mean > self.best_score + (self.min_delta if self.best_step is not None else 0.0):
            self.best_score = mean
            self.best_step = step
            self._non_improving = 0
        else:
            self._non_improving += 1
        # the catastrophic-forgetting guard is independent of patience-based
        # early stopping (separate keys in YAMLVLMScoringConfig): check it
        # BEFORE the patience gate so degradation_threshold fires even with
        # early stopping disabled (patience <= 0)
        if (
            self.degradation_threshold > 0.0
            and self.best_step is not None
            and self.best_score - mean > self.degradation_threshold
        ):
            return True
        if self.patience <= 0:
            return False
        return self._non_improving >= self.patience

    @property
    def should_copy_best(self) -> bool:
        return self.best_step is not None

    def seed_from_history(self, validation_scores: Sequence[dict]) -> None:
        """Resume support: restore best-so-far from persisted score records
        (``TrainingState.validation_scores``), so the first post-resume
        validation can't overwrite ``best/`` with worse weights.

        Step-0 records are the no-LoRA BASELINE pass, which a fresh run never
        feeds to the tracker — including them would make 'best' a bar the
        LoRA may never clear (and step 0 has no checkpoint dir to copy)."""
        per_step: dict = {}
        w = self.scene_weight
        for r in validation_scores:
            if r["step"] > 0:
                per_step.setdefault(r["step"], []).append(
                    2.0 * (w * r["scene"] + (1.0 - w) * r["style"])
                )
        if per_step:
            best = max(per_step, key=lambda s: float(np.mean(per_step[s])))
            self.best_step = best
            self.best_score = float(np.mean(per_step[best]))


def run_validation(
    pipeline,
    config: ValidationConfig,
    step: int,
    embeddings_fn: Callable[[str], object],
    scorer: Optional[VLMScorer] = None,
    reference_images: Sequence[np.ndarray] = (),
    output_dir: Optional[str] = None,
    ref_cache: Optional[dict] = None,
    emb_cache: Optional[dict] = None,
) -> List[ValidationRecord]:
    """Generate validation images with the (distilled) pipeline and score
    them. Each prompt may be a plain string or a per-prompt config (size,
    seed, trigger application, I2I reference — ValidationPrompt).

    ``ref_cache``: pass a persistent dict to reuse per-prompt reference
    encodes across validation passes (the image is constant; re-running the
    VAE every pass just stalls training). ``emb_cache`` is the same pattern
    for prompt embeddings — the prompt set is fixed for the whole run and
    the encoder is unaffected by the LoRA, so embeddings are reusable across
    passes too."""
    records: List[ValidationRecord] = []
    if emb_cache is None:
        emb_cache = {}
    for pi, raw in enumerate(config.prompts):
        vp = ValidationPrompt.normalize(raw)
        prompt = vp.prompt
        if vp.apply_trigger and config.trigger_word:
            # word-boundary match: 'art' inside 'cartoon' must not count as
            # the trigger being present
            has = re.search(rf"(?<!\w){re.escape(config.trigger_word)}(?!\w)", prompt)
            if not has:
                prompt = f"{config.trigger_word} {prompt}"
        ref_kw = {}
        if vp.reference:
            cached = ref_cache.get(vp.reference) if ref_cache is not None else None
            if cached is None:
                from flux2_tpu_torch.io.png import decode_image

                with open(vp.reference, "rb") as f:
                    ref_img = decode_image(f.read())
                cached = pipeline.encode_reference_images([ref_img])
                if ref_cache is not None:
                    ref_cache[vp.reference] = cached
            lat, ids = cached
            ref_kw = {"reference_latents": lat, "reference_ids": ids}
        # one encoder forward per distinct prompt per pass (not per image)
        if prompt not in emb_cache:
            emb_cache[prompt] = embeddings_fn(prompt)
        for vi in range(config.images_per_prompt):
            res = pipeline.generate(
                embeddings=emb_cache[prompt],
                height=vp.height or config.height,
                width=vp.width or config.width,
                num_steps=config.steps,
                guidance=config.guidance,
                seed=(vp.seed if vp.seed is not None else config.seed + pi * 100) + vi,
                **ref_kw,
            )
            if output_dir is not None:
                _save_png(res.image, os.path.join(output_dir, f"val_{step:06d}_p{pi}_{vi}.png"))
            scene, style = (scorer or _null_scorer)(res.image, reference_images, prompt)
            records.append(ValidationRecord(step=step, prompt=prompt, scene=scene, style=style))
    return records


def _null_scorer(image, refs, prompt) -> Tuple[float, float]:
    return 0.0, 0.0


def _save_png(image: np.ndarray, path: str) -> None:
    """JAX's ``(clip(x, 0, 1) * 255).astype(uint8)`` pixels (``io.png.to_u8``)."""
    from flux2_tpu_torch.io.png import encode_png, to_u8

    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "wb") as f:
        f.write(encode_png(to_u8(image)))


# ---------------------------------------------------------------------------
# Evaluation pipeline (LoRAEvaluator.swift)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class GapAnalysis:
    scene_score: float  # how well the base model already renders the scene
    style_score: float
    recommended_rank: int
    recommended_steps: int
    recommended_timestep_sampling: str
    notes: str
    # full training-config recommendation (LoRAEvaluator.swift:395-416)
    recommended_alpha: float = 16.0
    recommended_learning_rate: float = 1e-4
    recommended_warmup_steps: int = 100
    recommended_loss_weighting: str = "bell_shaped"
    recommended_target_layers: str = "attention_ffn"


def evaluate_training_need(
    baseline_scores: Sequence[Tuple[float, float]],
) -> GapAnalysis:
    """Describe reference -> generate baseline -> compare -> recommend.

    The recommendation heuristics mirror the reference's gap analysis: a
    large STYLE gap calls for style-weighted timestep sampling and higher
    rank; a large SCENE gap calls for content sampling; small gaps need
    fewer steps.
    """
    scene = float(np.mean([s for s, _ in baseline_scores])) if baseline_scores else 0.0
    style = float(np.mean([s for _, s in baseline_scores])) if baseline_scores else 0.0
    scene_gap, style_gap = 10.0 - scene, 10.0 - style

    if style_gap > scene_gap + 2:
        sampling = "style"
    elif scene_gap > style_gap + 2:
        sampling = "content"
    else:
        sampling = "balanced"

    worst_gap = max(scene_gap, style_gap)
    rank = 32 if worst_gap > 6 else 16 if worst_gap > 3 else 8
    steps = 2000 if worst_gap > 6 else 1000 if worst_gap > 3 else 500

    return GapAnalysis(
        scene_score=scene,
        style_score=style,
        recommended_rank=rank,
        recommended_steps=steps,
        recommended_timestep_sampling=sampling,
        notes=f"scene gap {scene_gap:.1f}, style gap {style_gap:.1f} -> {sampling} sampling, rank {rank}, {steps} steps",
        recommended_alpha=float(rank),
        recommended_learning_rate=1e-4,
        recommended_warmup_steps=max(10, steps // 10),
        recommended_loss_weighting="bell_shaped",
        # small adapters can afford every linear; big ones focus attention
        recommended_target_layers="attention_ffn" if rank <= 48 else "attention",
    )
