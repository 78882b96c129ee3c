"""Latent-space geometry for FLUX.2: pack/unpack, position ids, normalization.

Port of ``flux2_tpu/ops/latents.py`` (the Ostris training scale/shift and
the JAX noise draw left out) with the same conventions:
  - "patchified" latents: [B, 128, H/16, W/16]   (32 VAE channels x 2x2 patch)
  - "sequence"   latents: [B, (H/16)*(W/16), 128] (transformer tokens)
  - "VAE"        latents: [B, 32, H/8, W/8]
  - position ids: int32 [S, 4] columns (T, H, W, L), built on the host;
    reference image i gets T = 10 * (i + 1).

The initial noise comes from a ``torch.Generator``. JAX draws it with
threefry, so one seed gives different noise, and a different image, in the
two packages; tests hand both the same ``noise=``.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

LATENT_CHANNELS = 32
PATCH_SIZE = 2
PATCHIFIED_CHANNELS = LATENT_CHANNELS * PATCH_SIZE * PATCH_SIZE  # 128

BATCHNORM_EPS = 1e-4  # FLUX.2 batch_norm_eps


def validate_dimensions(height: int, width: int, patch_size: int = PATCH_SIZE) -> Tuple[int, int]:
    """Round requested pixel dims up to a multiple of 8*patch_size (=16)."""
    factor = 8 * patch_size
    return (
        (height + factor - 1) // factor * factor,
        (width + factor - 1) // factor * factor,
    )


def latent_dims(height: int, width: int) -> Tuple[int, int, int]:
    """(latent_h, latent_w, num_patches) for a pixel-space height/width."""
    lh, lw = height // 8, width // 8
    return lh, lw, (lh // PATCH_SIZE) * (lw // PATCH_SIZE)


def seeded_noise_seq(
    seed: int, height: int, width: int, batch: int = 1, device: "torch.device | str" = "cpu"
) -> torch.Tensor:
    """Seed -> unit-normal packed noise [B, S, 128] float32, drawn on ``device``."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    shape = (batch, PATCHIFIED_CHANNELS, height // 16, width // 16)
    noise = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
    return pack_patchified_to_sequence(noise)


def pack_patchified_to_sequence(patchified: torch.Tensor) -> torch.Tensor:
    """[B, C, H, W] -> [B, H*W, C]."""
    b, c, h, w = patchified.shape
    return patchified.permute(0, 2, 3, 1).reshape(b, h * w, c)


def unpack_sequence_to_patchified(sequence: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """[B, S, C] -> [B, C, H/16, W/16] given the pixel-space height/width."""
    b, _, c = sequence.shape
    return sequence.reshape(b, height // 16, width // 16, c).permute(0, 3, 1, 2)


def unpatchify_latents(
    patchified: torch.Tensor, latent_channels: int = LATENT_CHANNELS, patch_size: int = PATCH_SIZE
) -> torch.Tensor:
    """[B, C*p*p, H/16, W/16] -> [B, C, H/8, W/8] (pixel-shuffle)."""
    b, _, ph, pw = patchified.shape
    x = patchified.reshape(b, latent_channels, patch_size, patch_size, ph, pw)
    x = x.permute(0, 1, 4, 2, 5, 3)  # [B, C, H, p, W, p]
    return x.reshape(b, latent_channels, ph * patch_size, pw * patch_size)


def patchify_latents(latents: torch.Tensor, patch_size: int = PATCH_SIZE) -> torch.Tensor:
    """[B, 32, H/8, W/8] -> [B, 128, H/16, W/16] (inverse of unpatchify)."""
    b, c, h, w = latents.shape
    ph, pw = h // patch_size, w // patch_size
    x = latents.reshape(b, c, ph, patch_size, pw, patch_size)
    x = x.permute(0, 2, 4, 1, 3, 5)  # [B, pH, pW, C, p, p]
    x = x.reshape(b, ph, pw, c * patch_size * patch_size)
    return x.permute(0, 3, 1, 2)


def image_position_ids(height: int, width: int, patch_size: int = PATCH_SIZE) -> np.ndarray:
    """Position ids for output-image tokens: T=0, (H, W) grid, L=0."""
    nh, nw = height // (8 * patch_size), width // (8 * patch_size)
    hh, ww = np.meshgrid(np.arange(nh, dtype=np.int32), np.arange(nw, dtype=np.int32), indexing="ij")
    zeros = np.zeros(nh * nw, dtype=np.int32)
    return np.stack([zeros, hh.reshape(-1), ww.reshape(-1), zeros], axis=1)


def text_position_ids(length: int) -> np.ndarray:
    """Position ids for text tokens: T=H=W=0, L = 0..length-1."""
    zeros = np.zeros(length, dtype=np.int32)
    return np.stack([zeros, zeros, zeros, np.arange(length, dtype=np.int32)], axis=1)


def reference_image_position_ids(
    latent_heights: Sequence[int],
    latent_widths: Sequence[int],
    scale: int = 10,
) -> np.ndarray:
    """Position ids for reference-image tokens: image i (patchified grid
    h_i x w_i, H/16 x W/16) gets T = scale * (i + 1), its (H, W) grid, L=0."""
    parts = []
    for i, (h, w) in enumerate(zip(latent_heights, latent_widths)):
        t = np.full(h * w, scale * (i + 1), dtype=np.int32)
        hh, ww = np.meshgrid(np.arange(h, dtype=np.int32), np.arange(w, dtype=np.int32), indexing="ij")
        parts.append(np.stack([t, hh.reshape(-1), ww.reshape(-1), np.zeros(h * w, dtype=np.int32)], axis=1))
    return np.concatenate(parts, axis=0)


def combine_position_ids(text_length: int, height: int, width: int) -> np.ndarray:
    """[txt_ids ; img_ids] for the joint sequence (text first)."""
    return np.concatenate([text_position_ids(text_length), image_position_ids(height, width)], axis=0)


def _std(running_var: torch.Tensor, eps: float) -> torch.Tensor:
    """sqrt(var + eps) [1, C, 1, 1] float32, the sum in float32 and the root
    correctly rounded (taken in float64), as XLA's; torch's CPU float32 sqrt
    is off by an ulp now and then."""
    v = running_var.reshape(1, -1, 1, 1).to(torch.float32) + eps
    return torch.sqrt(v.to(torch.float64)).to(torch.float32)


def normalize_with_batchnorm(
    latents: torch.Tensor,
    running_mean: torch.Tensor,
    running_var: torch.Tensor,
    eps: float = BATCHNORM_EPS,
) -> torch.Tensor:
    """(x - mean) / sqrt(var + eps), with [C] stats broadcast over NCHW."""
    c = running_mean.shape[0]
    mean = running_mean.reshape(1, c, 1, 1).to(torch.float32)
    return ((latents.to(torch.float32) - mean) / _std(running_var, eps)).to(latents.dtype)


def denormalize_with_batchnorm(
    latents: torch.Tensor,
    running_mean: torch.Tensor,
    running_var: torch.Tensor,
    eps: float = BATCHNORM_EPS,
) -> torch.Tensor:
    """x * sqrt(var + eps) + mean, with [C] stats broadcast over NCHW."""
    c = running_mean.shape[0]
    mean = running_mean.reshape(1, c, 1, 1).to(torch.float32)
    return (latents.to(torch.float32) * _std(running_var, eps) + mean).to(latents.dtype)
