"""Normalization and AdaLN-modulation primitives.

Port of ``flux2_tpu/ops/normalization.py``: statistics in float32, eps 1e-6,
results in the input's dtype. ``group_norm`` takes NCHW (PyTorch's layout)
where the JAX version takes NHWC.
"""

from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm over the last axis with learned scale."""
    xf = x.to(torch.float32)
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * weight.to(torch.float32)).to(x.dtype)


def layer_norm(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Affine-less LayerNorm over the last axis (DiT block norms)."""
    xf = x.to(torch.float32)
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    return ((xf - mean) * torch.rsqrt(var + eps)).to(x.dtype)


def modulate(x: torch.Tensor, shift: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """AdaLN modulation: x * (1 + scale) + shift, broadcasting [B, D] over [B, S, D]."""
    return x * (1.0 + scale[:, None, :]) + shift[:, None, :]


def gate(residual: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Gate a residual branch: residual * g, broadcasting [B, D] over [B, S, D]."""
    return residual * g[:, None, :]


def group_norm(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: torch.Tensor,
    num_groups: int = 32,
    eps: float = 1e-6,
) -> torch.Tensor:
    """GroupNorm for NCHW feature maps (VAE conv stacks); f32 statistics."""
    b, c, h, w = x.shape
    xf = x.to(torch.float32).reshape(b, num_groups, c // num_groups, h, w)
    mean = xf.mean(dim=(2, 3, 4), keepdim=True)
    var = (xf - mean).square().mean(dim=(2, 3, 4), keepdim=True)
    normed = ((xf - mean) * torch.rsqrt(var + eps)).reshape(b, c, h, w)
    out = normed * weight.to(torch.float32)[None, :, None, None] + bias.to(torch.float32)[None, :, None, None]
    return out.to(x.dtype)
