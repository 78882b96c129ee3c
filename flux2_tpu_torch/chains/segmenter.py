"""Subject segmenter: the small U-Net behind ``subject_mask``, in PyTorch.

Port of ``flux2_tpu/chains/segmenter.py``: a ~0.94M-parameter U-Net trained
on synthetic subject-on-background composites, its weights committed beside
this module (``segmenter_weights.safetensors``, a byte-for-byte copy of the
JAX package's file). It runs at a fixed 256x256 working resolution: the input
is resized on the host, the network and its sigmoid run on the given device,
and the probability is resized back on the host.

Layout: a conv stem, three downsampling blocks (conv stride 2, GroupNorm,
silu, conv, GroupNorm, silu), three upsampling blocks on nearest 2x
upsampling and skip concatenation, a 1x1 head. Parameter names are JAX's
(``stem.kernel``, ``down1.norm.scale``, ...); kernels are kept OIHW, permuted
from the file's HWIO when loaded. JAX's ``"SAME"`` padding at stride 2 pads
asymmetrically (0 before, 1 after on an even size): the stride-2 convs pad
explicitly as XLA does. GroupNorm uses ``min(8, c)`` groups, as JAX's. The
network runs in float32 with TF32 off (``pipeline._full_f32``), so the card's
probabilities stay within float32 rounding of the CPU's.

``_resize_np`` is JAX's: through uint8 and Pillow's ``BILINEAR`` where Pillow
imports (the probability is quantized to 1/255 there), else JAX's
antialiased bilinear resize (``jax.image.resize``), written out in numpy as
the same separable weight matrices.

Not ported: ``init_params``, which draws a fresh network with ``jax.random``
for ``tools/train_segmenter.py`` (a JAX tool outside the package); the port
only runs the trained weights.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

WORK_RES = 256
CHANNELS = (24, 48, 96, 160)  # stem + 3 downsamples
WEIGHTS_FILE = os.path.join(os.path.dirname(__file__), "segmenter_weights.safetensors")


# ---------------------------------------------------------------------------
# Model
# ---------------------------------------------------------------------------


class _Conv(nn.Module):
    """A conv with JAX's "SAME" padding; ``kernel`` [out, in, kh, kw] (OIHW)."""

    def __init__(self, kh: int, kw: int, cin: int, cout: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(cout, cin, kh, kw))
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x: torch.Tensor, stride: int = 1) -> torch.Tensor:
        kh, kw = self.kernel.shape[2:]
        pads = []
        for size, k in ((x.shape[3], kw), (x.shape[2], kh)):  # F.pad order: last dim first
            out = -(-size // stride)
            total = max((out - 1) * stride + k - size, 0)
            pads += [total // 2, total - total // 2]
        return F.conv2d(F.pad(x, pads), self.kernel, self.bias, stride=stride)


class _GroupNorm(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))

    def forward(self, x: torch.Tensor, groups: int = 8) -> torch.Tensor:
        return F.group_norm(x, min(groups, x.shape[1]), self.scale, self.bias, eps=1e-5)


class _Block(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = _Conv(3, 3, cin, cout)
        self.norm = _GroupNorm(cout)
        self.conv2 = _Conv(3, 3, cout, cout)
        self.norm2 = _GroupNorm(cout)

    def forward(self, x: torch.Tensor, stride: int) -> torch.Tensor:
        x = F.silu(self.norm(self.conv(x, stride=stride)))
        return F.silu(self.norm2(self.conv2(x)))


class SegmenterUNet(nn.Module):
    """[B, 3, 256, 256] in [0, 1] (NCHW) -> foreground logits [B, 256, 256]."""

    def __init__(self):
        super().__init__()
        self.stem = _Conv(3, 3, 3, CHANNELS[0])
        for i in range(1, len(CHANNELS)):
            self.add_module(f"down{i}", _Block(CHANNELS[i - 1], CHANNELS[i]))
        for i in range(len(CHANNELS) - 1, 0, -1):
            self.add_module(f"up{i}", _Block(CHANNELS[i] + CHANNELS[i - 1], CHANNELS[i - 1]))  # upsampled + skip
        self.head = _Conv(1, 1, CHANNELS[0], 1)

    def forward(self, img: torch.Tensor) -> torch.Tensor:
        x = img * 2.0 - 1.0
        skips = [F.silu(self.stem(x))]
        for i in range(1, len(CHANNELS)):
            skips.append(getattr(self, f"down{i}")(skips[-1], stride=2))
        x = skips[-1]
        for i in range(len(CHANNELS) - 1, 0, -1):
            up = x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)  # nearest 2x
            x = getattr(self, f"up{i}")(torch.cat([up, skips[i - 1]], dim=1), stride=1)
        return self.head(x)[:, 0]


def _is_kernel(name: str) -> bool:
    return name.endswith(".kernel")


def load_params(model: SegmenterUNet, flat: Dict[str, "torch.Tensor | np.ndarray"]) -> SegmenterUNet:
    """Fill ``model`` from a flat JAX-named dict (kernels HWIO, permuted to OIHW)."""
    state = {}
    for k, v in flat.items():
        t = torch.as_tensor(np.asarray(v, np.float32))
        state[k] = t.permute(3, 2, 0, 1) if _is_kernel(k) else t
    model.load_state_dict(state)
    return model


class Segmenter:
    """Callable [H, W, 3] float image -> [H, W] foreground probability, the
    network on ``device``; it plugs into ``subject_mask(segmenter=...)``."""

    def __init__(self, model: SegmenterUNet, device: "torch.device | str" = "cuda"):
        self.device = torch.device(device)
        self.model = model.to(self.device).eval()

    def predict(self, small: np.ndarray) -> np.ndarray:
        """[B, 256, 256, 3] float32 -> sigmoid probability [B, 256, 256] (JAX ``_predict``)."""
        from flux2_tpu_torch.pipeline.pipeline import _full_f32

        x = torch.from_numpy(np.ascontiguousarray(small, np.float32)).to(self.device).permute(0, 3, 1, 2)
        with torch.inference_mode(), _full_f32():
            return torch.sigmoid(self.model(x.contiguous())).cpu().numpy()

    def __call__(self, image: np.ndarray) -> np.ndarray:
        h, w = image.shape[:2]
        small = _resize_np(image, WORK_RES, WORK_RES)
        prob = self.predict(small[None])[0]
        return _resize_np(prob[..., None], h, w)[..., 0]


def load_default(device: "torch.device | str" = "cuda") -> Optional[Segmenter]:
    """The committed trained weights on ``device``, or None where the file is
    missing (callers fall back to the saliency heuristic)."""
    if not os.path.exists(WEIGHTS_FILE):
        return None
    from flux2_tpu_torch.io import safetensors_io

    return Segmenter(load_params(SegmenterUNet(), safetensors_io.load_file(WEIGHTS_FILE)), device)


def save_weights(model: SegmenterUNet, path: str = WEIGHTS_FILE) -> None:
    """Write ``model``'s parameters as JAX's file holds them: float32, kernels HWIO."""
    from flux2_tpu_torch.io import safetensors_io

    flat = {}
    for k, v in model.state_dict().items():
        v = v.detach().to("cpu", torch.float32)
        flat[k] = (v.permute(2, 3, 1, 0) if _is_kernel(k) else v).contiguous()
    safetensors_io.save_file(flat, path)


def _resize_np(image: np.ndarray, h: int, w: int) -> np.ndarray:
    """[H, W, C] -> [h, w, C] float32: Pillow's BILINEAR on uint8 (C = 3, or 1
    as "L") where Pillow imports, else JAX's antialiased bilinear resize."""
    if image.shape[0] == h and image.shape[1] == w:
        return np.asarray(image, np.float32)
    try:
        from PIL import Image

        mode_in = np.clip(image, 0.0, 1.0)
        if image.shape[-1] == 1:
            im = Image.fromarray((mode_in[..., 0] * 255).astype(np.uint8), "L")
            return (np.asarray(im.resize((w, h), Image.BILINEAR), np.float32) / 255.0)[..., None]
        im = Image.fromarray((mode_in * 255).astype(np.uint8))
        return np.asarray(im.resize((w, h), Image.BILINEAR), np.float32) / 255.0
    except ImportError:
        return _resize_bilinear_antialiased(np.asarray(image, np.float32), h, w)


def resize_path() -> str:
    """Which resize ``_resize_np`` takes on this host: "Pillow" or "numpy"."""
    try:
        import PIL.Image  # noqa: F401
    except ImportError:
        return "numpy"
    return "Pillow"


def _triangle_weights(in_size: int, out_size: int) -> np.ndarray:
    """[in, out] float32 weights of ``jax.image.resize``'s "bilinear" along one
    axis (``compute_weight_mat``: half-pixel centres, the triangle kernel
    widened by the scale when downsampling, each column normalised, samples
    outside the input zeroed)."""
    scale = np.float32(out_size / in_size)
    inv_scale = np.float32(1.0) / scale
    kernel_scale = np.maximum(inv_scale, np.float32(1.0))
    sample_f = (np.arange(out_size, dtype=np.float32) + np.float32(0.5)) * inv_scale - np.float32(0.5)
    x = np.abs(sample_f[None, :] - np.arange(in_size, dtype=np.float32)[:, None]) / kernel_scale
    weights = np.maximum(np.float32(0.0), np.float32(1.0) - np.abs(x))
    total = weights.sum(axis=0, keepdims=True)
    weights = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                       weights / np.where(total != 0, total, np.float32(1.0)), np.float32(0.0))
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return np.where(inside[None, :], weights, np.float32(0.0)).astype(np.float32)


def _resize_bilinear_antialiased(image: np.ndarray, h: int, w: int) -> np.ndarray:
    """[H, W, C] float32 -> [h, w, C]: JAX's ``jax.image.resize(image, (h, w, C), "bilinear")``."""
    wy = _triangle_weights(image.shape[0], h)
    wx = _triangle_weights(image.shape[1], w)
    out = np.einsum("hwc,hy->ywc", image, wy)
    return np.einsum("ywc,wx->yxc", out, wx).astype(np.float32)


# ---------------------------------------------------------------------------
# Synthetic composite data (training and evaluation fixtures)
# ---------------------------------------------------------------------------


def synth_composite(rng: np.random.RandomState, size: int = WORK_RES):
    """(image [S,S,3], mask [S,S]) — random subject on a busy background.

    Backgrounds mix gradients, low-frequency noise, and clutter patches
    (exactly what defeats border-statistics saliency); subjects are unions
    of ellipses/rectangles with their own texture, random size/position,
    sometimes touching the border.
    """
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size

    # background: gradient + band pattern + clutter rectangles
    c0, c1 = rng.rand(3), rng.rand(3)
    ang = rng.rand() * 2 * np.pi
    t = (np.cos(ang) * xx + np.sin(ang) * yy)[..., None]
    bg = c0 * (1 - t) + c1 * t
    if rng.rand() < 0.7:
        freq = rng.uniform(4, 24)
        bands = 0.5 + 0.5 * np.sin(freq * (np.cos(ang) * yy - np.sin(ang) * xx) * 2 * np.pi)
        bg = bg * (0.75 + 0.25 * bands[..., None])
    for _ in range(rng.randint(0, 6)):  # clutter
        ph, pw = rng.randint(size // 16, size // 3, size=2)
        py, px = rng.randint(0, size - ph), rng.randint(0, size - pw)
        bg[py:py + ph, px:px + pw] = rng.rand(3) * 0.9 + 0.05
    bg += rng.randn(size, size, 3) * 0.02

    # subject: union of 1-3 ellipses/rects around a center
    mask = np.zeros((size, size), np.float32)
    cy, cx = rng.uniform(0.25, 0.75, size=2) * size
    for _ in range(rng.randint(1, 4)):
        oy, ox = rng.randn(2) * size * 0.08
        ry, rx = rng.uniform(size * 0.08, size * 0.28, size=2)
        if rng.rand() < 0.3:  # rectangle part
            y0, y1 = int(max(0, cy + oy - ry)), int(min(size, cy + oy + ry))
            x0, x1 = int(max(0, cx + ox - rx)), int(min(size, cx + ox + rx))
            mask[y0:y1, x0:x1] = 1.0
        else:
            e = ((yy * size - cy - oy) / ry) ** 2 + ((xx * size - cx - ox) / rx) ** 2
            mask = np.maximum(mask, (e <= 1.0).astype(np.float32))

    subj = rng.rand(3) * 0.9 + 0.05
    tex = 0.5 + 0.5 * np.sin(
        rng.uniform(6, 30) * (xx + yy) * np.pi + rng.rand() * 6
    )
    subject = subj * (0.8 + 0.2 * tex[..., None]) + rng.randn(size, size, 3) * 0.02
    img = np.where(mask[..., None] > 0.5, subject, bg)
    return np.clip(img, 0.0, 1.0).astype(np.float32), mask


def iou(pred: np.ndarray, target: np.ndarray, threshold: float = 0.5) -> float:
    p = pred >= threshold
    t = target >= 0.5
    inter = float(np.logical_and(p, t).sum())
    union = float(np.logical_or(p, t).sum())
    return inter / union if union else 1.0
