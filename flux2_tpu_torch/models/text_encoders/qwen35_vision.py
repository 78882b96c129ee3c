"""Qwen3.5 vision tower, its image preprocessing and the VLM embedding merge.

Port of ``flux2_tpu/models/text_encoders/qwen35_vision.py``:

- The patch embedding is the Conv3d (kernel = stride, temporal 2 x 16 x 16)
  over a duplicated frame, done as one linear over the flattened
  [t, p, p, c] patch; patches come in spatial-merge order (each 2x2 block
  contiguous).
- A learned 48 x 48 position grid, bilinearly interpolated to the patch
  grid (``_interp_pos_embed``); 2-D rotary embeddings (theta 1e4, the row
  half then the column half, ``_rotary_2d``).
- Pre-LN blocks: fused-QKV attention and a GELU MLP with the **tanh**
  GELU (HF's ``gelu_pytorch_tanh``); the 2x2 spatial merger: LayerNorm,
  group 4 patches, fc1, **exact** GELU (HF's ``nn.GELU()``), fc2.
- ``smart_resize`` / ``preprocess_image``: an aspect-preserving resize to
  multiples of 32 px within [256, 1280] per side (the port's
  ``utils.native.resize_bilinear``), normalized with mean = std = 0.5.
- ``merge_image_embeddings``: text embeddings with each image-token
  position replaced by the image embedding of its rank among them.

Linears go through ``q_linear`` (mixed dtypes promote as in JAX, so float32
pixels run the tower in float32 through bf16 weights). The attention is
plain torch with float32 logits, as JAX's einsum.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from flux2_tpu_torch.models.flux2.transformer import linear_weight, ones_weight
from flux2_tpu_torch.ops.quant import q_linear


@dataclasses.dataclass(frozen=True)
class Qwen35VisionConfig:
    depth: int = 24
    hidden_size: int = 1024
    num_heads: int = 16
    intermediate_size: int = 4096
    patch_size: int = 16
    spatial_merge_size: int = 2
    temporal_patch_size: int = 2
    in_channels: int = 3
    out_hidden_size: int = 2560
    num_position_embeddings: int = 2304  # 48 x 48
    image_token_id: int = 248056

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def patch_dim(self) -> int:
        return self.in_channels * self.temporal_patch_size * self.patch_size**2

    @property
    def merge_factor(self) -> int:
        return self.patch_size * self.spatial_merge_size  # 32

    @classmethod
    def from_json_dict(cls, d: dict, image_token_id: Optional[int] = None) -> "Qwen35VisionConfig":
        """Parse an HF ``vision_config`` section (Qwen3-VL layout)."""
        return cls(
            depth=int(d.get("depth", 24)),
            hidden_size=int(d.get("hidden_size", 1024)),
            num_heads=int(d.get("num_heads", 16)),
            intermediate_size=int(d.get("intermediate_size", 4096)),
            patch_size=int(d.get("patch_size", 16)),
            spatial_merge_size=int(d.get("spatial_merge_size", 2)),
            temporal_patch_size=int(d.get("temporal_patch_size", 2)),
            in_channels=int(d.get("in_channels", d.get("in_chans", 3))),
            out_hidden_size=int(d.get("out_hidden_size", 2560)),
            num_position_embeddings=int(d.get("num_position_embeddings", 2304)),
            image_token_id=int(image_token_id if image_token_id is not None else 248056),
        )


TINY_VISION = Qwen35VisionConfig(
    depth=2, hidden_size=32, num_heads=2, intermediate_size=64,
    num_position_embeddings=16, out_hidden_size=48,
)


# -- preprocessing ---------------------------------------------------------------------


def smart_resize(h: int, w: int, factor: int = 32, min_side: int = 256, max_side: int = 1280) -> Tuple[int, int]:
    """Aspect-preserving target dims: clamp the sides, round to multiples of ``factor``."""
    th, tw = float(h), float(w)
    mx = max(th, tw)
    if mx > max_side:
        s = max_side / mx
        th, tw = th * s, tw * s
    mn = min(th, tw)
    if mn < min_side:
        s = min_side / mn
        th, tw = th * s, tw * s
    th = max(factor, round(th / factor) * factor)
    tw = max(factor, round(tw / factor) * factor)
    return int(th), int(tw)


def preprocess_image(image: np.ndarray, cfg: Qwen35VisionConfig, max_side: int = 1280) -> np.ndarray:
    """[H, W, 3] float in [0, 1] -> resized and normalized to [-1, 1] (mean = std = 0.5)."""
    from flux2_tpu_torch.utils import native

    th, tw = smart_resize(image.shape[0], image.shape[1], cfg.merge_factor, max_side=max_side)
    resized = native.resize_bilinear(np.asarray(image, np.float32), th, tw)
    return (resized - 0.5) / 0.5


# -- forward -----------------------------------------------------------------------------


def _patchify(pixels: torch.Tensor, cfg: Qwen35VisionConfig) -> torch.Tensor:
    """[B, H, W, 3] -> [B, patches, patch_dim] in spatial-merge order; the
    duplicated temporal frame is the flattened patch twice ([t, p, p, c])."""
    b, h, w, c = pixels.shape
    p, m = cfg.patch_size, cfg.spatial_merge_size
    gh, gw = h // p, w // p
    x = pixels.reshape(b, gh, p, gw, p, c).permute(0, 1, 3, 2, 4, 5).reshape(b, gh, gw, p * p * c)
    x = torch.cat([x, x], dim=-1)
    x = x.reshape(b, gh // m, m, gw // m, m, -1).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, gh * gw, -1)


def _interp_pos_embed(pos_embed: torch.Tensor, gh: int, gw: int, m: int) -> torch.Tensor:
    """Bilinear interpolation of the learned grid to [gh * gw, D], merge order."""
    n = int(np.sqrt(pos_embed.shape[0]))
    d = pos_embed.shape[1]
    grid = pos_embed.reshape(n, n, d)
    hi = np.linspace(0, n - 1, gh) if gh > 1 else np.zeros(1)
    wi = np.linspace(0, n - 1, gw) if gw > 1 else np.zeros(1)
    h0, w0 = np.floor(hi).astype(int), np.floor(wi).astype(int)
    h1, w1 = np.minimum(h0 + 1, n - 1), np.minimum(w0 + 1, n - 1)
    dev = pos_embed.device
    dh = torch.from_numpy((hi - h0)[:, None, None].astype(np.float32)).to(dev)
    dw = torch.from_numpy((wi - w0)[None, :, None].astype(np.float32)).to(dev)
    h0, w0, h1, w1 = (torch.from_numpy(a).to(dev) for a in (h0, w0, h1, w1))
    out = (grid[h0][:, w0] * (1 - dh) * (1 - dw) + grid[h0][:, w1] * (1 - dh) * dw
           + grid[h1][:, w0] * dh * (1 - dw) + grid[h1][:, w1] * dh * dw)  # [gh, gw, D]
    out = out.reshape(gh // m, m, gw // m, m, d).permute(0, 2, 1, 3, 4)
    return out.reshape(gh * gw, d)


def _rotary_2d(cfg: Qwen35VisionConfig, gh: int, gw: int, m: int) -> np.ndarray:
    """2-D rotary frequencies [patches, head_dim / 2] in merge order ([row | column] halves)."""
    dim = cfg.head_dim // 2
    inv_freq = 1.0 / 10000.0 ** (np.arange(0, dim, 2, dtype=np.float32) / dim)
    bh, bw = np.meshgrid(np.arange(gh // m), np.arange(gw // m), indexing="ij")
    ih, iw = np.meshgrid(np.arange(m), np.arange(m), indexing="ij")
    rows = (bh[:, :, None, None] * m + ih[None, None]).reshape(-1)
    cols = (bw[:, :, None, None] * m + iw[None, None]).reshape(-1)
    return np.concatenate([rows[:, None] * inv_freq[None, :], cols[:, None] * inv_freq[None, :]],
                          axis=-1).astype(np.float32)


def _apply_vision_rotary(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x [B, S, H, D]; cos / sin [1, S, 1, D/2]: the half-split rotation in float32."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1).to(x.dtype)


def _ln(x: torch.Tensor, norm: "LayerNormParams", eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = (xf - mean).square().mean(-1, keepdim=True)
    return (((xf - mean) / torch.sqrt(var + eps)) * norm.weight + norm.bias).to(x.dtype)


class LayerNormParams(nn.Module):
    def __init__(self, n: int, device, dtype):
        super().__init__()
        self.weight = ones_weight(n, device, dtype)
        self.bias = nn.Parameter(torch.zeros(n, device=device, dtype=dtype), requires_grad=False)


class Dense(nn.Module):
    """A linear with a bias: ``weight`` [out, in]; JAX draws the bias as zeros."""

    def __init__(self, d_in: int, d_out: int, device, dtype, generator):
        super().__init__()
        self.weight = linear_weight(d_in, d_out, device, dtype, generator)
        self.bias = nn.Parameter(torch.zeros(d_out, device=device, dtype=dtype), requires_grad=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return q_linear(x, self.weight) + self.bias


class VisionBlock(nn.Module):
    def __init__(self, cfg: Qwen35VisionConfig, device, dtype, generator):
        super().__init__()
        h = cfg.hidden_size
        self.norm1 = LayerNormParams(h, device, dtype)
        self.qkv = Dense(h, 3 * h, device, dtype, generator)
        self.proj = Dense(h, h, device, dtype, generator)
        self.norm2 = LayerNormParams(h, device, dtype)
        self.fc1 = Dense(h, cfg.intermediate_size, device, dtype, generator)
        self.fc2 = Dense(cfg.intermediate_size, h, device, dtype, generator)


class Merger(nn.Module):
    def __init__(self, cfg: Qwen35VisionConfig, device, dtype, generator):
        super().__init__()
        merged = cfg.hidden_size * cfg.spatial_merge_size**2
        self.norm = LayerNormParams(cfg.hidden_size, device, dtype)
        self.fc1 = Dense(merged, merged, device, dtype, generator)
        self.fc2 = Dense(merged, cfg.out_hidden_size, device, dtype, generator)


class Qwen35Vision(nn.Module):
    """Normalized pixels [B, H, W, 3] -> merged image embeddings [B, patches / 4, out_hidden]."""

    def __init__(self, cfg: Qwen35VisionConfig = TINY_VISION, device: "torch.device | str" = "cpu",
                 dtype: torch.dtype = torch.bfloat16, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        h = cfg.hidden_size
        self.blocks = nn.ModuleList(VisionBlock(cfg, device, dtype, generator) for _ in range(cfg.depth))
        self.patch_embed = Dense(cfg.patch_dim, h, device, dtype, generator)
        pos = torch.empty(cfg.num_position_embeddings, h, device=device, dtype=dtype)
        if generator is not None:
            pos.normal_(generator=generator).mul_(0.02)
        self.pos_embed = nn.Parameter(pos, requires_grad=False)
        self.merger = Merger(cfg, device, dtype, generator)

    @classmethod
    def from_random(cls, cfg: Qwen35VisionConfig, device: "torch.device | str" = "cuda",
                    generator: Optional[torch.Generator] = None, dtype: torch.dtype = torch.bfloat16):
        device = torch.device(device)
        return cls(cfg, device, dtype, generator or torch.Generator(device=device).manual_seed(0))

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        b, h, w, _ = pixels.shape
        p, m = cfg.patch_size, cfg.spatial_merge_size
        gh, gw = h // p, w // p
        x = self.patch_embed(_patchify(pixels, cfg))
        x = x + _interp_pos_embed(self.pos_embed, gh, gw, m)[None]
        freqs = torch.from_numpy(_rotary_2d(cfg, gh, gw, m)).to(x.device)
        cos, sin = torch.cos(freqs)[None, :, None, :], torch.sin(freqs)[None, :, None, :]

        nh, hd = cfg.num_heads, cfg.head_dim
        s = gh * gw
        for blk in self.blocks:
            qkv = blk.qkv(_ln(x, blk.norm1)).reshape(b, s, 3, nh, hd)
            q = _apply_vision_rotary(qkv[:, :, 0], cos, sin).transpose(1, 2)
            k = _apply_vision_rotary(qkv[:, :, 1], cos, sin).transpose(1, 2)
            v = qkv[:, :, 2].transpose(1, 2)
            logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * hd**-0.5
            probs = torch.softmax(logits, dim=-1).to(v.dtype)
            attn = torch.matmul(probs, v).transpose(1, 2).reshape(b, s, nh * hd)
            x = x + blk.proj(attn)
            x = x + blk.fc2(F.gelu(blk.fc1(_ln(x, blk.norm2)), approximate="tanh"))

        # the merger: patches are in merge order already; exact GELU, unlike the blocks'
        x = _ln(x, self.merger.norm).reshape(b, s // (m * m), cfg.hidden_size * m * m)
        return self.merger.fc2(F.gelu(self.merger.fc1(x), approximate="none"))


def num_output_tokens(cfg: Qwen35VisionConfig, height: int, width: int) -> int:
    gh, gw = height // cfg.patch_size, width // cfg.patch_size
    return (gh // cfg.spatial_merge_size) * (gw // cfg.spatial_merge_size)


def merge_image_embeddings(text_embeds: torch.Tensor, input_ids: torch.Tensor, image_embeds: torch.Tensor,
                           image_token_id: int) -> torch.Tensor:
    """text_embeds [B, S, H], input_ids [B, S], image_embeds [1, T_img, H] (all
    images concatenated): each image-token position takes the image embedding
    at its rank among the image tokens."""
    is_img = input_ids == image_token_id
    rank = (torch.cumsum(is_img.to(torch.int64), dim=1) - 1).clamp(0, image_embeds.shape[1] - 1)
    gathered = image_embeds[0][rank].to(text_embeds.dtype)  # [B, S, H]
    return torch.where(is_img[..., None], gathered, text_embeds)
