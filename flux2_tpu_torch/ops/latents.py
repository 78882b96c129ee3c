"""Latent-space geometry for FLUX.2: pack/unpack, position ids, normalization.

Port of the T2I part of ``flux2_tpu/ops/latents.py`` with the same
conventions:
  - "patchified" latents: [B, 128, H/16, W/16]   (32 VAE channels x 2x2 patch)
  - "sequence"   latents: [B, (H/16)*(W/16), 128] (transformer tokens)
  - "VAE"        latents: [B, 32, H/8, W/8]
  - position ids: int32 [S, 4] columns (T, H, W, L), built on the host.

The initial noise comes from a ``torch.Generator``. JAX draws it with
threefry, so one seed gives different noise, and a different image, in the
two packages; tests hand both the same ``noise=``.
"""

from __future__ import annotations

from typing import Tuple

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


def denormalize_with_batchnorm(
    latents: torch.Tensor,
    running_mean: torch.Tensor,
    running_var: torch.Tensor,
    eps: float = BATCHNORM_EPS,
) -> torch.Tensor:
    """x * sqrt(var + eps) + mean, with [C] stats broadcast over NCHW."""
    c = running_mean.shape[0]
    mean = running_mean.reshape(1, c, 1, 1).to(torch.float32)
    std = torch.sqrt(running_var.reshape(1, c, 1, 1).to(torch.float32) + eps)
    return (latents.to(torch.float32) * std + mean).to(latents.dtype)
