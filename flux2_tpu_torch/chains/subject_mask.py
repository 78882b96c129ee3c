"""Subject-mask auto-segmentation for keep-subject inpainting workflows.

Port of ``flux2_tpu/chains/subject_mask.py``: a keep-subject mask, dilated
and ramped inward so the seam falls outside the subject, in the inpaint
convention (1.0 = regenerate). The segmenter, in order:

  - ``segmenter=callable``: any [H, W, 3] -> [H, W] foreground probability;
  - the committed U-Net (``chains/segmenter.py``) on ``device``, loaded once
    per device by ``default_segmenter`` (``cuda`` unless asked for the CPU);
  - where its weights are missing, ``saliency_foreground`` (colour distance
    from the border's statistics, centre-weighted).

Dilation and ramp run in one pass of the native library
(``utils/native.dilate_ramp``), else through numpy's iterated erosion
(``_dilate`` / ``_inward_ramp``), as in JAX.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np

_DEFAULT_SEGMENTERS: dict = {}  # device -> Segmenter, or None once the weights were found missing


def default_segmenter(device: str = "cuda"):
    """The committed trained U-Net on ``device``, loaded once; None if its weights are absent."""
    key = str(device)
    if key not in _DEFAULT_SEGMENTERS:
        from flux2_tpu_torch.chains import segmenter as seg

        _DEFAULT_SEGMENTERS[key] = seg.load_default(device)
    return _DEFAULT_SEGMENTERS[key]


def saliency_foreground(image: np.ndarray) -> np.ndarray:
    """Heuristic foreground probability: color distance from border stats,
    center-weighted. [H, W, 3] in [0,1] -> [H, W] in [0,1]."""
    h, w = image.shape[:2]
    border = np.concatenate(
        [image[0], image[-1], image[:, 0], image[:, -1]], axis=0
    )  # [N, 3]
    mean = border.mean(axis=0)
    std = border.std(axis=0) + 1e-3
    dist = np.sqrt(((image - mean) / std) ** 2).mean(axis=-1)
    dist = dist / (dist.max() + 1e-6)
    yy, xx = np.mgrid[0:h, 0:w]
    cy, cx = (h - 1) / 2, (w - 1) / 2
    center = 1.0 - 0.5 * (((yy - cy) / (h / 2)) ** 2 + ((xx - cx) / (w / 2)) ** 2) / 2
    return np.clip(dist * center, 0.0, 1.0)


def _dilate(mask: np.ndarray, radius: int) -> np.ndarray:
    """Binary dilation with a square structuring element (pure numpy)."""
    if radius <= 0:
        return mask
    out = mask.copy()
    for _ in range(radius):
        padded = np.pad(out, 1, mode="edge")
        out = np.maximum.reduce(
            [
                padded[0:-2, 1:-1], padded[2:, 1:-1], padded[1:-1, 0:-2], padded[1:-1, 2:],
                padded[1:-1, 1:-1],
            ]
        )
    return out


def _inward_ramp(mask: np.ndarray, ramp: int) -> np.ndarray:
    """Soften the mask edge with a linear ramp INSIDE the masked region."""
    if ramp <= 0:
        return mask
    soft = mask.astype(np.float32)
    inner = mask.copy()
    for i in range(1, ramp + 1):
        eroded = 1.0 - _dilate(1.0 - inner, 1)
        soft = np.where((inner > 0.5) & (eroded <= 0.5), i / (ramp + 1), soft)
        inner = eroded
    return np.clip(soft, 0.0, 1.0)


def subject_mask(
    image: np.ndarray,
    segmenter: Optional[Callable[[np.ndarray], np.ndarray]] = None,
    threshold: float = 0.5,
    dilation_px: int = 8,
    ramp_px: int = 16,
    invert_for_change_scene: bool = True,
    device: str = "cuda",
) -> np.ndarray:
    """Auto-segmentation mask [H, W] float32 for keep-subject workflows.

    Returns a grayscale mask in the inpaint convention (1.0 = regenerate):
    with ``invert_for_change_scene`` the SUBJECT is 0 (kept) and the scene
    around it is 1 (repainted), dilated and ramped so the seam falls outside
    the subject. Without ``segmenter``: the U-Net on ``device``, else the
    saliency heuristic.
    """
    if segmenter is None:
        segmenter = default_segmenter(device) or saliency_foreground
    prob = segmenter(image)
    fg = (prob >= threshold).astype(np.float32)
    from flux2_tpu_torch.utils import native

    ramped = native.dilate_ramp(fg, dilation_px, ramp_px)
    if ramped is None:
        ramped = _inward_ramp(_dilate(fg, dilation_px), ramp_px)
    return np.clip(1.0 - ramped, 0.0, 1.0) if invert_for_change_scene else ramped
