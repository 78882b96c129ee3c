"""Pixtral vision tower and multimodal projector (the Mistral Small 3.2 VLM).

Port of ``flux2_tpu/models/text_encoders/pixtral.py``: a ViT over 14 px
patches (24 blocks, hidden 1024, 16 heads of 64, image cap 1540 px), the
Pixtral 2-D RoPE (even base frequencies index the patch's row, odd ones its
column; a position id indexes the ``row * max_side + col`` row of the table,
cos / sin in the HF two-half layout), pre-LN RMSNorm blocks without biases
and a SiLU-gated MLP. The projector: RMSNorm, the 2x2 patch merger (a 2x2
block of patches, spatial-major, through one linear), linear, exact-erf
GELU, linear into the language model's width.

Linears are [out, in] and go through ``q_linear``, so mixed dtypes promote
as ``x @ w`` does in JAX: float32 pixels through bf16 weights run the tower
in float32, as JAX's does. The attention is plain torch with float32
logits, as JAX's einsum (no kernel: XLA compiled it).

The 2x2 merger needs an even patch grid. JAX's ``project_to_text_space``
reshapes without checking and fails with a reshape error on an odd grid
(any side that is not a multiple of 28 px after the crop to 14 px
multiples, such as 1024 px: 73 x 73 patches); the port raises a
``ValueError`` that names the grid and the side that works.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from flux2_tpu_torch.models.flux2.transformer import linear_weight, ones_weight
from flux2_tpu_torch.models.text_encoders.decoder import _rotate_half
from flux2_tpu_torch.ops.normalization import rms_norm
from flux2_tpu_torch.ops.quant import q_linear


@dataclasses.dataclass(frozen=True)
class PixtralVisionConfig:
    hidden_size: int = 1024
    intermediate_size: int = 4096
    num_hidden_layers: int = 24
    num_attention_heads: int = 16
    patch_size: int = 14
    image_size: int = 1540  # max side -> 110 patches
    rope_theta: float = 10000.0
    rms_norm_eps: float = 1e-5
    spatial_merge_size: int = 2
    text_hidden_size: int = 5120

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def max_patches_per_side(self) -> int:
        return self.image_size // self.patch_size


TINY_PIXTRAL = PixtralVisionConfig(
    hidden_size=32, intermediate_size=64, num_hidden_layers=2,
    num_attention_heads=2, patch_size=14, image_size=14 * 8, text_hidden_size=48,
)


def pixtral_rope_table(cfg: PixtralVisionConfig) -> np.ndarray:
    """Frequency table [max_side^2, head_dim]: even base frequencies times the
    row, odd ones times the column, then the two halves repeated."""
    d = cfg.head_dim
    base = 1.0 / cfg.rope_theta ** (np.arange(0, d, 2, dtype=np.float32) / d)  # [d/2]
    freqs_h, freqs_w = base[0::2], base[1::2]  # [d/4] each
    side = cfg.max_patches_per_side
    pos = np.arange(side, dtype=np.float32)
    fh = np.tile((pos[:, None] * freqs_h[None])[:, None, :], (1, side, 1))  # [side, side, d/4]
    fw = np.tile((pos[:, None] * freqs_w[None])[None, :, :], (side, 1, 1))
    half = np.concatenate([fh, fw], axis=-1).reshape(side * side, d // 2)
    return np.concatenate([half, half], axis=-1)  # [side^2, d]


def check_patch_grid(cfg: PixtralVisionConfig, grid_h: int, grid_w: int) -> None:
    """Raise a ValueError unless the 2x2 merger tiles the ``grid_h`` x ``grid_w`` patch grid."""
    m, p = cfg.spatial_merge_size, cfg.patch_size
    if grid_h % m or grid_w % m:
        raise ValueError(
            f"Pixtral's {m}x{m} patch merger needs an even patch grid; the image gives {grid_h} x {grid_w} "
            f"patches of {p} px ({grid_h * p} x {grid_w * p} px after the crop to {p} px multiples): give it "
            f"sides that are multiples of {m * p} px, e.g. {grid_h // m * m * p} x {grid_w // m * m * p}")


class PixtralBlock(nn.Module):
    def __init__(self, cfg: PixtralVisionConfig, device, dtype, generator):
        super().__init__()
        h, i = cfg.hidden_size, cfg.intermediate_size
        self.attention_norm = ones_weight(h, device, dtype)
        self.q_proj = linear_weight(h, h, device, dtype, generator)
        self.k_proj = linear_weight(h, h, device, dtype, generator)
        self.v_proj = linear_weight(h, h, device, dtype, generator)
        self.o_proj = linear_weight(h, h, device, dtype, generator)
        self.ffn_norm = ones_weight(h, device, dtype)
        self.gate_proj = linear_weight(h, i, device, dtype, generator)
        self.up_proj = linear_weight(h, i, device, dtype, generator)
        self.down_proj = linear_weight(i, h, device, dtype, generator)


class PixtralProjector(nn.Module):
    def __init__(self, cfg: PixtralVisionConfig, device, dtype, generator):
        super().__init__()
        h, t = cfg.hidden_size, cfg.text_hidden_size
        self.norm = ones_weight(h, device, dtype)
        self.merge = linear_weight(h * cfg.spatial_merge_size**2, h, device, dtype, generator)
        self.linear_1 = linear_weight(h, t, device, dtype, generator)
        self.linear_2 = linear_weight(t, t, device, dtype, generator)


class PixtralVision(nn.Module):
    """Pixels [B, H, W, 3] (normalized) -> vision features, and the projector
    into the language model's embedding space. ``generator`` draws the
    weights (JAX's ``init_params`` scheme: N(0, 1) / sqrt(fan_in) linears,
    unit norms); without one they are left for a loader to fill."""

    def __init__(self, cfg: PixtralVisionConfig = TINY_PIXTRAL, device: "torch.device | str" = "cpu",
                 dtype: torch.dtype = torch.bfloat16, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        h = cfg.hidden_size
        self.blocks = nn.ModuleList(PixtralBlock(cfg, device, dtype, generator) for _ in range(cfg.num_hidden_layers))
        self.patch_conv = linear_weight(3 * cfg.patch_size**2, h, device, dtype, generator)  # conv, kernel = stride
        self.ln_pre = ones_weight(h, device, dtype)
        self.projector = PixtralProjector(cfg, device, dtype, generator)

    @classmethod
    def from_random(cls, cfg: PixtralVisionConfig, device: "torch.device | str" = "cuda",
                    generator: Optional[torch.Generator] = None, dtype: torch.dtype = torch.bfloat16):
        device = torch.device(device)
        return cls(cfg, device, dtype, generator or torch.Generator(device=device).manual_seed(0))

    def encode_image(self, pixels: torch.Tensor) -> torch.Tensor:
        """[B, H, W, 3] -> [B, patches, hidden]."""
        cfg = self.cfg
        b, h, w, c = pixels.shape
        p = cfg.patch_size
        gh, gw = h // p, w // p
        s = gh * gw
        x = pixels.reshape(b, gh, p, gw, p, c).permute(0, 1, 3, 2, 4, 5).reshape(b, s, p * p * c)
        x = rms_norm(q_linear(x, self.patch_conv), self.ln_pre, cfg.rms_norm_eps)

        rows, cols = np.meshgrid(np.arange(gh), np.arange(gw), indexing="ij")
        pos_ids = torch.from_numpy((rows * cfg.max_patches_per_side + cols).reshape(-1)).to(x.device)
        freqs = torch.from_numpy(pixtral_rope_table(cfg)).to(x.device)[pos_ids]  # [S, head_dim]
        cos, sin = torch.cos(freqs)[None, :, None, :], torch.sin(freqs)[None, :, None, :]

        nh, hd = cfg.num_attention_heads, cfg.head_dim
        for blk in self.blocks:
            hidden = rms_norm(x, blk.attention_norm, cfg.rms_norm_eps)
            q = q_linear(hidden, blk.q_proj).reshape(b, s, nh, hd)
            k = q_linear(hidden, blk.k_proj).reshape(b, s, nh, hd)
            v = q_linear(hidden, blk.v_proj).reshape(b, s, nh, hd)
            qf, kf = q.float(), k.float()
            q = (qf * cos + _rotate_half(qf) * sin).to(x.dtype).transpose(1, 2)
            k = (kf * cos + _rotate_half(kf) * sin).to(x.dtype).transpose(1, 2)
            v = v.transpose(1, 2)
            logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * hd**-0.5
            probs = torch.softmax(logits, dim=-1).to(v.dtype)
            attn = torch.matmul(probs, v).transpose(1, 2).reshape(b, s, nh * hd)
            x = x + q_linear(attn, blk.o_proj)
            h2 = rms_norm(x, blk.ffn_norm, cfg.rms_norm_eps)
            x = x + q_linear(F.silu(q_linear(h2, blk.gate_proj)) * q_linear(h2, blk.up_proj), blk.down_proj)
        return x

    def project_to_text_space(self, features: torch.Tensor, grid_h: int, grid_w: int) -> torch.Tensor:
        """RMSNorm -> 2x2 patch merge -> linear -> exact GELU -> linear:
        [B, S, H] -> [B, S/4, text_hidden]."""
        cfg, proj = self.cfg, self.projector
        check_patch_grid(cfg, grid_h, grid_w)
        m = cfg.spatial_merge_size
        b, s, d = features.shape
        x = rms_norm(features, proj.norm, cfg.rms_norm_eps)
        x = x.reshape(b, grid_h // m, m, grid_w // m, m, d).permute(0, 1, 3, 2, 4, 5)
        x = x.reshape(b, (grid_h // m) * (grid_w // m), m * m * d)
        x = q_linear(x, proj.merge)
        x = F.gelu(q_linear(x, proj.linear_1), approximate="none")
        return q_linear(x, proj.linear_2)

    def encode_and_project(self, pixels: torch.Tensor) -> torch.Tensor:
        """[B, H, W, 3] -> [B, H/28 * W/28, text_hidden]; an odd patch grid
        raises before the tower runs."""
        _, h, w, _ = pixels.shape
        gh, gw = h // self.cfg.patch_size, w // self.cfg.patch_size
        check_patch_grid(self.cfg, gh, gw)
        return self.project_to_text_space(self.encode_image(pixels), gh, gw)
