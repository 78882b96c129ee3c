"""RePaint masked inpainting (no Fill checkpoint needed): the port of
``flux2_tpu/chains/inpaint.py``.

- The source is VAE-encoded once; the mask is rasterized to the latent token
  grid; the blend noise is drawn once, from the seed.
- A structured step hook (``repaint_step_hook`` and a state of tensors on the
  pipeline's device) forces the latents outside the mask back onto the
  source's trajectory after every step:
  ``(1 - m) * ((1 - sigma_next) * source + sigma_next * noise) + m * latents``.
  The last step has ``sigma_next == 0``, so the kept tokens land exactly on
  the clean source latents.
- Modes: plain T2I, the source as an I2I reference
  (``use_image_as_reference``: the source is encoded a second time, as a
  reference, as in JAX), explicit ``reference_images``.
- ``strength`` < 1 starts from the source latents.
- Crop-and-stitch (``mask_crop_padding``): the mask's bounding box, padded and
  grown to multiples of 32, is inpainted alone and composited back onto the
  untouched original, as is the whole image with ``composite_on_original``.
- Two mask conventions: grey (white = inpaint) and alpha (transparent =
  inpaint).

The mask geometry is host numpy, copied from JAX's module (the copies are
held against it by ``tests/test_torch_shared_copies.py``). The blend noise
comes from a ``torch.Generator`` (``_blend_noise``), where JAX draws it from
``PRNGKey(seed)``: one seed blends other noise in the two packages.

``enrich_prompt_with_vlm`` rewrites the prompt through the pipeline's
ALREADY-LOADED VLM (``chains/vlm_prompt.py``, the system prompt of
``intent``); it never loads one. JAX's precedence: the VLM's prompt wins
over ``upsample_prompt`` and is not upsampled again; no VLM, precomputed
embeddings, or an empty or failed VLM reply warn and keep the caller's
prompt and upsample flag.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from flux2_tpu_torch.pipeline.pipeline import Flux2Pipeline, GenerationResult
from flux2_tpu_torch.utils import logging as flog
from flux2_tpu_torch.utils import native

GRAYSCALE_WHITE_INPAINT = "grayscale_white_inpaint"
ALPHA_TRANSPARENT_INPAINT = "alpha_transparent_inpaint"


def repaint_step_hook(state: dict, latents: torch.Tensor, sigma: torch.Tensor, sigma_next: torch.Tensor,
                      step_idx: int) -> torch.Tensor:
    """The RePaint blend as a structured step hook. ``state``: "image" [B, S,
    128] clean source latents, "mask" [B, S, 1] (1 = inpaint), "noise" [B, S,
    128] the fixed blend noise, all float32 on the latents' device."""
    renoised = (1.0 - sigma_next) * state["image"] + sigma_next * state["noise"]
    return (1.0 - state["mask"]) * renoised + state["mask"] * latents


def _blend_noise(seed: int, shape: Tuple[int, ...], device: "torch.device | str") -> torch.Tensor:
    """The blend noise, N(0, 1) float32 from a generator seeded with ``seed``
    on ``device``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(shape, generator=gen, device=device, dtype=torch.float32)


def resolve_chain_dimensions(width: int, height: int, max_pixels: int = 4 * 1024 * 1024) -> Tuple[int, int]:
    """(height, width) clamped to ``max_pixels``, rounded down to multiples of 32."""
    scale = min(1.0, (max_pixels / max(1, width * height)) ** 0.5)
    w = max(32, int(width * scale) // 32 * 32)
    h = max(32, int(height * scale) // 32 * 32)
    return h, w


def _mask_plane(mask: np.ndarray, convention: str) -> np.ndarray:
    """The inpaint plane of a mask [H, W] or [H, W, C]: 1 - alpha in the alpha
    convention, else the mean of the colour channels."""
    if convention == ALPHA_TRANSPARENT_INPAINT:
        return 1.0 - mask[..., 3]
    return mask[..., :3].mean(axis=-1) if mask.ndim == 3 else mask


def pack_mask_for_latent_blending(mask: np.ndarray, target_height: int, target_width: int,
                                  convention: str = GRAYSCALE_WHITE_INPAINT) -> torch.Tensor:
    """A pixel mask on the latent token grid: float32 [1, seq, 1] in [0, 1] on
    the CPU, 1.0 = inpaint, 0.0 = keep."""
    lh, lw = target_height // 16, target_width // 16
    if convention == ALPHA_TRANSPARENT_INPAINT and (mask.ndim != 3 or mask.shape[2] < 4):
        raise ValueError("alpha convention requires an RGBA mask")
    plane = np.clip(np.asarray(_mask_plane(mask, convention), np.float32), 0.0, 1.0)
    return torch.from_numpy(_area_resize(plane, lh, lw).reshape(1, lh * lw, 1))


def _area_resize(plane: np.ndarray, lh: int, lw: int) -> np.ndarray:
    if plane.shape == (lh, lw):
        return np.asarray(plane, np.float32)
    return native.area_resize(plane, lh, lw)


def mask_bounding_box(mask: np.ndarray, convention: str = GRAYSCALE_WHITE_INPAINT, threshold: float = 0.5):
    """(x0, y0, x1, y1) of the inpaint region, or None when it is empty."""
    ys, xs = np.where(_mask_plane(mask, convention) > threshold)
    if len(ys) == 0:
        return None
    return int(xs.min()), int(ys.min()), int(xs.max()) + 1, int(ys.max()) + 1


def expand_crop_region(bbox: Tuple[int, int, int, int], padding: int, image_width: int,
                       image_height: int) -> Tuple[int, int, int, int]:
    """The bbox padded, clamped to the image and grown to multiples of 32
    (outward where the image allows)."""
    x0, y0, x1, y1 = bbox
    x0 = max(0, x0 - padding)
    y0 = max(0, y0 - padding)
    x1 = min(image_width, x1 + padding)
    y1 = min(image_height, y1 + padding)
    w = -(-(x1 - x0) // 32) * 32
    h = -(-(y1 - y0) // 32) * 32
    x0 = max(0, min(x0, image_width - w))
    y0 = max(0, min(y0, image_height - h))
    return x0, y0, min(image_width, x0 + w), min(image_height, y0 + h)


def composite_on_original(original: np.ndarray, generated: np.ndarray, mask: np.ndarray,
                          crop_rect: Optional[Tuple[int, int, int, int]] = None,
                          convention: str = GRAYSCALE_WHITE_INPAINT) -> np.ndarray:
    """The generated pixels soft-composited by the mask onto a copy of the
    original, inside ``crop_rect`` (the whole image by default)."""
    out = np.array(original, np.float32)
    x0, y0, x1, y1 = crop_rect or (0, 0, original.shape[1], original.shape[0])
    gen = generated
    if gen.shape[:2] != (y1 - y0, x1 - x0):
        gen = _resize_rgb(gen, y1 - y0, x1 - x0)
    plane = _mask_plane(mask, convention)
    if plane.shape != (y1 - y0, x1 - x0):
        plane = _area_resize(np.asarray(plane, np.float32), y1 - y0, x1 - x0)
    out[y0:y1, x0:x1] = native.soft_composite(out[y0:y1, x0:x1], gen[..., :3], np.clip(plane, 0, 1))
    return out


def _resize_rgb(img: np.ndarray, h: int, w: int) -> np.ndarray:
    """Pillow's LANCZOS where Pillow imports, else nearest sampling (as JAX)."""
    try:
        from PIL import Image
    except ImportError:
        ys = (np.arange(h) * img.shape[0] / h).astype(int)
        xs = (np.arange(w) * img.shape[1] / w).astype(int)
        return img[ys][:, xs]
    im = Image.fromarray((np.clip(img, 0, 1) * 255).astype(np.uint8))
    return np.asarray(im.resize((w, h), Image.LANCZOS), np.float32) / 255.0


def _vlm_builder_from_pipeline(pipe):
    """The pipeline's already-loaded vision service as a VLMPromptBuilder, or
    None. Never loads one (``vlm_loader`` is not consulted): the caller owns
    the VLM's lifecycle."""
    from flux2_tpu_torch.chains.vlm_prompt import VLMPromptBuilder

    vlm = getattr(pipe, "vlm", None)
    if vlm is None:
        return None
    if hasattr(vlm, "chat"):  # Qwen35VLMService.chat(system, user, image=)
        return VLMPromptBuilder(vlm_chat=lambda s, u, img: vlm.chat(s, u, image=np.asarray(img)))
    if hasattr(vlm, "analyze_image"):  # MistralVLMService
        return VLMPromptBuilder(vlm_chat=lambda s, u, img: vlm.analyze_image(np.asarray(img), f"{s}\n\n{u}"))
    return None


def _normalize_intent(intent):
    from flux2_tpu_torch.chains.vlm_prompt import InpaintIntent

    if isinstance(intent, InpaintIntent):
        return intent
    return InpaintIntent(str(intent).replace("-", "_"))


def resolve_prompt(chain, build, kind: str, no_vlm_hint: str = "", both_hint: str = "") -> Tuple[str, bool]:
    """(final prompt, downstream upsample flag) of a chain with JAX's
    precedence: VLM enrichment wins over upsampling; no VLM, precomputed
    embeddings or an empty reply fall back to the caller's prompt and flag.
    ``build(builder)`` asks the VLM for the prompt."""
    if not chain.enrich_prompt_with_vlm:
        return chain.prompt, chain.upsample_prompt
    if chain.embeddings is not None:
        flog.warning("enrich_prompt_with_vlm ignored: precomputed embeddings were passed, so the prompt never "
                     "reaches the encoder — drop embeddings= to let the VLM-enriched prompt take effect")
        return chain.prompt, chain.upsample_prompt
    builder = chain.vlm_builder or _vlm_builder_from_pipeline(chain.pipeline)
    if builder is None or not builder.is_loaded:
        flog.warning(f"enrich_prompt_with_vlm=True but no VLM is loaded — falling back to the caller's prompt"
                     f"{no_vlm_hint}")
        return chain.prompt, chain.upsample_prompt
    if chain.upsample_prompt:
        flog.warning(f"both enrich_prompt_with_vlm and upsample_prompt are set — VLM wins{both_hint}")
    built = build(builder)
    if not built:
        flog.warning("VLM returned no prompt — falling back to the caller's prompt")
        return chain.prompt, chain.upsample_prompt
    flog.info(f"VLM-enriched {kind} prompt: {built}")
    return built, False  # the prompt is final: never upsampled again


@dataclasses.dataclass
class MaskedInpaintingChain:
    """RePaint inpainting over a Flux2Pipeline."""

    pipeline: Flux2Pipeline
    prompt: str
    image: np.ndarray  # [H, W, 3] float in [0, 1]
    mask: np.ndarray  # [H, W] or [H, W, C]
    mask_convention: str = GRAYSCALE_WHITE_INPAINT
    reference_images: Optional[Sequence[np.ndarray]] = None
    use_image_as_reference: bool = False
    steps: int = 4
    guidance: Optional[float] = None
    seed: int = 0
    strength: float = 1.0
    mask_crop_padding: Optional[int] = None  # crop-and-stitch when set
    composite_on_original: bool = False
    max_pixels: int = 4 * 1024 * 1024
    embeddings: Optional[torch.Tensor] = None  # precomputed conditioning
    upsample_prompt: bool = False  # text-only rewriting; loses to enrich_prompt_with_vlm
    enrich_prompt_with_vlm: bool = False  # image-aware rewriting through a loaded VLM
    intent: object = "replace"  # InpaintIntent or its value ("change-scene" too)
    vlm_builder: Optional[object] = None  # an explicit VLMPromptBuilder

    def _resolve_final_prompt_and_upsample(self) -> Tuple[str, bool]:
        return resolve_prompt(
            self, lambda b: b.build_inpaint_prompt(_normalize_intent(self.intent), self.prompt, self.image),
            "inpaint", no_vlm_hint=" (attach one to the pipeline or pass vlm_builder= before run())",
            both_hint=" (image-aware enrichment supersedes text-only upsampling)")

    def run(self) -> GenerationResult:
        final_prompt, use_upsample = self._resolve_final_prompt_and_upsample()
        work_image, work_mask = self.image, self.mask
        crop_rect = None
        if self.mask_crop_padding is not None:
            bbox = mask_bounding_box(self.mask, self.mask_convention)
            if bbox is not None:
                crop_rect = expand_crop_region(bbox, self.mask_crop_padding, self.image.shape[1],
                                               self.image.shape[0])
                x0, y0, x1, y1 = crop_rect
                work_image = self.image[y0:y1, x0:x1]
                mh, mw = self.mask.shape[:2]
                ih, iw = self.image.shape[:2]
                work_mask = self.mask[y0 * mh // ih : y1 * mh // ih, x0 * mw // iw : x1 * mw // iw]

        target_h, target_w = resolve_chain_dimensions(work_image.shape[1], work_image.shape[0], self.max_pixels)
        if work_image.shape[:2] != (target_h, target_w):
            work_image = _resize_rgb(work_image, target_h, target_w)

        pipe = self.pipeline
        image_latents = pipe.encode_image_to_packed_sequence(work_image)
        mask_latents = pack_mask_for_latent_blending(work_mask, target_h, target_w, self.mask_convention)
        hook = (repaint_step_hook, {
            "image": image_latents.to(torch.float32),
            "mask": mask_latents.to(pipe.device),
            "noise": _blend_noise(self.seed, tuple(image_latents.shape), pipe.device),
        })

        ref_latents = ref_ids = None
        if self.reference_images:
            ref_latents, ref_ids = pipe.encode_reference_images(self.reference_images)
        elif self.use_image_as_reference:
            ref_latents, ref_ids = pipe.encode_reference_images([work_image])

        result = pipe.generate(
            prompt=final_prompt,
            upsample=use_upsample and self.embeddings is None,
            embeddings=self.embeddings,
            height=target_h,
            width=target_w,
            num_steps=self.steps,
            guidance=self.guidance,
            seed=self.seed,
            reference_latents=ref_latents,
            reference_ids=ref_ids,
            strength=self.strength,
            init_latents=image_latents if self.strength < 1.0 else None,
            step_hook=hook,
        )
        if crop_rect is not None or self.composite_on_original:
            composited = composite_on_original(self.image, result.image, work_mask, crop_rect, self.mask_convention)
            result = dataclasses.replace(result, image=composited)
        return result
