"""BFL-style outpainting: the port of ``flux2_tpu/chains/outpaint.py``.

Per-side paddings are rounded up to multiples of 32. The extended canvas is
mid-grey Gaussian noise (numpy's ``RandomState``, the same draw as JAX's) with
the original pasted at (left, top); the "smart mask" is 1.0 in the new strips,
with a linear transition band inside the keep region on the sides that have
a strip. The original image is the I2I reference, so attention continues its
style into the strips, and the RePaint inpainting chain does the rest. With
``enrich_prompt_with_vlm`` the pipeline's loaded VLM sees the original image
and the extended sides and writes the prompt (JAX's precedence, as in
``chains/inpaint.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from flux2_tpu_torch.chains.inpaint import GRAYSCALE_WHITE_INPAINT, MaskedInpaintingChain, resolve_prompt
from flux2_tpu_torch.pipeline.pipeline import Flux2Pipeline, GenerationResult


def round_up_32(v: int) -> int:
    return -(-v // 32) * 32


def build_outpaint_canvas(image: np.ndarray, top: int, bottom: int, left: int, right: int,
                          seed: int = 0) -> np.ndarray:
    """Extended canvas: mid-grey Gaussian noise, the original pasted at (left, top)."""
    h, w = image.shape[:2]
    ch, cw = h + top + bottom, w + left + right
    rng = np.random.RandomState(seed & 0x7FFFFFFF)
    canvas = np.clip(0.5 + 0.12 * rng.randn(ch, cw, 3), 0.0, 1.0).astype(np.float32)
    canvas[top : top + h, left : left + w] = image[..., :3]
    return canvas


def build_smart_mask(canvas_h: int, canvas_w: int, keep_x: int, keep_y: int, keep_w: int, keep_h: int,
                     transition_pixels: int = 32) -> np.ndarray:
    """1.0 in the strips, 0.0 deep in the keep region, and a linear ramp on
    the keep side of every edge that has a strip."""
    mask = np.ones((canvas_h, canvas_w), np.float32)
    mask[keep_y : keep_y + keep_h, keep_x : keep_x + keep_w] = 0.0

    band_w = max(1, min(transition_pixels, keep_w // 2))
    band_h = max(1, min(transition_pixels, keep_h // 2))
    ramp_w = (band_w - np.arange(band_w, dtype=np.float32)) / band_w  # 1 -> ~0
    ramp_h = (band_h - np.arange(band_h, dtype=np.float32)) / band_h

    region = mask[keep_y : keep_y + keep_h, keep_x : keep_x + keep_w]
    if keep_x > 0:  # left strip
        region[:, :band_w] = np.maximum(region[:, :band_w], ramp_w[None, :])
    if keep_x + keep_w < canvas_w:  # right strip
        region[:, keep_w - band_w :] = np.maximum(region[:, keep_w - band_w :], ramp_w[::-1][None, :])
    if keep_y > 0:  # top strip
        region[:band_h, :] = np.maximum(region[:band_h, :], ramp_h[:, None])
    if keep_y + keep_h < canvas_h:  # bottom strip
        region[keep_h - band_h :, :] = np.maximum(region[keep_h - band_h :, :], ramp_h[::-1][:, None])
    return mask


@dataclasses.dataclass
class OutpaintingChain:
    pipeline: Flux2Pipeline
    image: np.ndarray  # [H, W, 3] float in [0, 1]
    prompt: str
    top: int = 0
    bottom: int = 0
    left: int = 0
    right: int = 0
    steps: int = 4
    guidance: Optional[float] = None
    seed: int = 0
    transition_pixels: int = 32
    max_pixels: int = 4 * 1024 * 1024
    embeddings: Optional[torch.Tensor] = None
    upsample_prompt: bool = False  # text-only rewriting; loses to enrich_prompt_with_vlm
    # image-aware rewriting through a loaded VLM, resolved here on the ORIGINAL
    # image and the extended sides; the inner inpaint chain runs without it
    enrich_prompt_with_vlm: bool = False
    vlm_builder: Optional[object] = None

    def _resolve_final_prompt_and_upsample(self) -> Tuple[str, bool]:
        sides = [name for name, pad in (("top", self.top), ("bottom", self.bottom), ("left", self.left),
                                        ("right", self.right)) if pad > 0]
        return resolve_prompt(self, lambda b: b.build_outpaint_prompt(self.prompt, self.image, sides), "outpaint")

    def run(self) -> GenerationResult:
        if min(self.top, self.bottom, self.left, self.right) < 0:
            raise ValueError("padding values must be non-negative")
        if self.top + self.bottom + self.left + self.right == 0:
            raise ValueError("at least one side must have non-zero padding")
        t, b, l, r = (round_up_32(p) if p else 0 for p in (self.top, self.bottom, self.left, self.right))
        h, w = self.image.shape[:2]
        canvas_h, canvas_w = h + t + b, w + l + r
        if canvas_h % 32 or canvas_w % 32:
            raise ValueError(f"canvas {canvas_w}x{canvas_h} not a multiple of 32 — pad the source image or adjust "
                             "paddings")
        canvas = build_outpaint_canvas(self.image, t, b, l, r, self.seed)
        mask = build_smart_mask(canvas_h, canvas_w, l, t, w, h, self.transition_pixels)
        final_prompt, use_upsample = self._resolve_final_prompt_and_upsample()
        return MaskedInpaintingChain(
            pipeline=self.pipeline,
            prompt=final_prompt,
            upsample_prompt=use_upsample,
            image=canvas,
            mask=mask,
            mask_convention=GRAYSCALE_WHITE_INPAINT,
            reference_images=[self.image],  # I2I conditioning continues the scene
            steps=self.steps,
            guidance=self.guidance,
            seed=self.seed,
            max_pixels=max(self.max_pixels, canvas_w * canvas_h),
            embeddings=self.embeddings,
        ).run()
