"""4-axis rotary position embeddings for the FLUX.2 DiT.

Port of ``flux2_tpu/ops/rope.py``: axes (T, H, W, L) of 32 dims each,
theta 2000, cos/sin repeat-interleaved by 2 within each axis, and the
rotation treating consecutive pairs as (real, imag). All math in float32.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

DEFAULT_AXES_DIMS = (32, 32, 32, 32)
DEFAULT_THETA = 2000.0


def rope_embeddings(
    ids: torch.Tensor,
    axes_dims: Sequence[int] = DEFAULT_AXES_DIMS,
    theta: float = DEFAULT_THETA,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """int [S, len(axes_dims)] position ids -> (cos, sin) float32 [S, sum(axes_dims)]."""
    cos_parts, sin_parts = [], []
    for axis, dim in enumerate(axes_dims):
        pos = ids[:, axis].to(torch.float32)
        freq_seq = torch.arange(0, dim, 2, dtype=torch.float32, device=ids.device) / dim
        inv_freq = theta ** -freq_seq
        freqs = pos[:, None] * inv_freq[None, :]  # [S, dim/2]
        cos_parts.append(torch.repeat_interleave(torch.cos(freqs), 2, dim=-1))
        sin_parts.append(torch.repeat_interleave(torch.sin(freqs), 2, dim=-1))
    return torch.cat(cos_parts, dim=-1), torch.cat(sin_parts, dim=-1)


def rotate_half_interleaved(x: torch.Tensor) -> torch.Tensor:
    """Pairwise rotation: (x0, x1, x2, x3, ...) -> (-x1, x0, -x3, x2, ...)."""
    x2 = x.reshape(*x.shape[:-1], x.shape[-1] // 2, 2)
    return torch.stack([-x2[..., 1], x2[..., 0]], dim=-1).reshape(x.shape)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate [..., S, D] by cos/sin [S, D]; f32 math, result in x's dtype."""
    xf = x.to(torch.float32)
    return (xf * cos + rotate_half_interleaved(xf) * sin).to(x.dtype)
