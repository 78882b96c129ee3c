"""Quality metrics: fixed-seed PSNR and the colour-chart delta-E protocol.

The port's copy of ``flux2_tpu/utils/quality.py`` (numpy only;
``tests/test_torch_shared_copies.py`` holds each function against the
original): a fixed-seed comparison of two images (mean RGB delta, PSNR and
mean CIE76 delta-E, ``compare_images``), a colour-chart protocol (render the
24 ColorChecker patches, measure each patch's mean colour, report the mean and
max delta-E against the requested colours), and the headless scene and style
scores ``histogram_similarity`` and ``color_moment_similarity``.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

# The 24 classic ColorChecker sRGB values (public reference data).
COLOR_CHECKER_SRGB: Tuple[Tuple[int, int, int], ...] = (
    (115, 82, 68), (194, 150, 130), (98, 122, 157), (87, 108, 67),
    (133, 128, 177), (103, 189, 170), (214, 126, 44), (80, 91, 166),
    (193, 90, 99), (94, 60, 108), (157, 188, 64), (224, 163, 46),
    (56, 61, 150), (70, 148, 73), (175, 54, 60), (231, 199, 31),
    (187, 86, 149), (8, 133, 161), (243, 243, 242), (200, 200, 200),
    (160, 160, 160), (122, 122, 121), (85, 85, 85), (52, 52, 52),
)


def psnr(a: np.ndarray, b: np.ndarray, max_val: float = 1.0) -> float:
    """Peak signal-to-noise ratio in dB between two [H, W, 3] images."""
    mse = float(np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2))
    if mse == 0:
        return float("inf")
    return 10.0 * np.log10(max_val**2 / mse)


def mean_rgb_delta(a: np.ndarray, b: np.ndarray) -> float:
    """Mean per-channel delta in 0-255 units (the reference's reporting unit)."""
    return float(np.mean(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))) * 255.0)


# ---------------------------------------------------------------------------
# CIE76 Delta-E
# ---------------------------------------------------------------------------


def srgb_to_lab(rgb: np.ndarray) -> np.ndarray:
    """sRGB [..., 3] in [0, 1] -> CIELAB (D65)."""
    rgb = np.asarray(rgb, np.float64)
    linear = np.where(rgb <= 0.04045, rgb / 12.92, ((rgb + 0.055) / 1.055) ** 2.4)
    m = np.array(
        [[0.4124564, 0.3575761, 0.1804375],
         [0.2126729, 0.7151522, 0.0721750],
         [0.0193339, 0.1191920, 0.9503041]]
    )
    xyz = linear @ m.T
    white = np.array([0.95047, 1.0, 1.08883])
    t = xyz / white
    f = np.where(t > (6 / 29) ** 3, np.cbrt(t), t / (3 * (6 / 29) ** 2) + 4 / 29)
    l = 116 * f[..., 1] - 16
    a = 500 * (f[..., 0] - f[..., 1])
    b = 200 * (f[..., 1] - f[..., 2])
    return np.stack([l, a, b], axis=-1)


def delta_e_cie76(rgb_a: np.ndarray, rgb_b: np.ndarray) -> np.ndarray:
    """CIE76 ΔE between sRGB colors in [0, 1]; broadcasting over leading dims."""
    return np.linalg.norm(srgb_to_lab(rgb_a) - srgb_to_lab(rgb_b), axis=-1)


# ---------------------------------------------------------------------------
# Color-chart ("mire") protocol
# ---------------------------------------------------------------------------


def color_chart_image(cell: int = 64, cols: int = 6) -> np.ndarray:
    """Render the 24-patch ColorChecker grid as an [H, W, 3] float image."""
    rows = (len(COLOR_CHECKER_SRGB) + cols - 1) // cols
    img = np.zeros((rows * cell, cols * cell, 3), np.float32)
    for i, rgb in enumerate(COLOR_CHECKER_SRGB):
        r, c = divmod(i, cols)
        img[r * cell : (r + 1) * cell, c * cell : (c + 1) * cell] = np.asarray(rgb, np.float32) / 255.0
    return img


def measure_color_chart(
    image: np.ndarray, cols: int = 6, n_patches: int = 24, center_frac: float = 0.5
) -> np.ndarray:
    """Per-patch mean color [n, 3] sampled from each cell's center region."""
    rows = (n_patches + cols - 1) // cols
    h, w = image.shape[:2]
    ch, cw = h // rows, w // cols
    out = []
    for i in range(n_patches):
        r, c = divmod(i, cols)
        y0 = r * ch + int(ch * (1 - center_frac) / 2)
        x0 = c * cw + int(cw * (1 - center_frac) / 2)
        y1 = y0 + max(1, int(ch * center_frac))
        x1 = x0 + max(1, int(cw * center_frac))
        out.append(image[y0:y1, x0:x1].reshape(-1, 3).mean(axis=0))
    return np.asarray(out)


def color_chart_delta_e(image: np.ndarray) -> Dict[str, float]:
    """Mean/max ΔE of a rendered chart against the reference colors."""
    measured = measure_color_chart(image)
    target = np.asarray(COLOR_CHECKER_SRGB, np.float64) / 255.0
    de = delta_e_cie76(measured, target)
    return {"mean_delta_e": float(de.mean()), "max_delta_e": float(de.max())}


def compare_images(a: np.ndarray, b: np.ndarray) -> Dict[str, float]:
    """The fixed-seed comparison bundle: PSNR + mean RGB delta + mean ΔE."""
    return {
        "psnr_db": psnr(a, b),
        "mean_rgb_delta_255": mean_rgb_delta(a, b),
        "mean_delta_e": float(delta_e_cie76(a, b).mean()),
    }


def histogram_similarity(a: np.ndarray, b: np.ndarray, bins: int = 32) -> float:
    """Luminance-histogram intersection in [0, 1].

    Shape-independent scene-content proxy used as the headless fallback for
    the VLM scene score (evaluate-lora with no VLM on disk).
    """
    la = (0.2126 * a[..., 0] + 0.7152 * a[..., 1] + 0.0722 * a[..., 2]).ravel()
    lb = (0.2126 * b[..., 0] + 0.7152 * b[..., 1] + 0.0722 * b[..., 2]).ravel()
    ha, _ = np.histogram(la, bins=bins, range=(0.0, 1.0), density=False)
    hb, _ = np.histogram(lb, bins=bins, range=(0.0, 1.0), density=False)
    ha = ha / max(1, ha.sum())
    hb = hb / max(1, hb.sum())
    return float(np.minimum(ha, hb).sum())


def color_moment_similarity(a: np.ndarray, b: np.ndarray) -> float:
    """Per-channel mean/std color-moment proximity in [0, 1] — the headless
    style-score fallback (palette + contrast match)."""
    ma, sa = a.reshape(-1, a.shape[-1]).mean(0), a.reshape(-1, a.shape[-1]).std(0)
    mb, sb = b.reshape(-1, b.shape[-1]).mean(0), b.reshape(-1, b.shape[-1]).std(0)
    dist = float(np.abs(ma - mb).mean() + np.abs(sa - sb).mean())
    return max(0.0, 1.0 - dist)
