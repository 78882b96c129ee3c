"""Scaled dot-product attention dispatch for the DiT. Layout [B, H, S, D].

Port of ``flux2_tpu/ops/attention.py``. Two paths:
  - ``sdpa_reference``: plain attention with float32 logits and softmax, the
    counterpart of ``sdpa_xla``. It runs on the CPU and is the reference.
  - the flash-attention kernel (``flux2_tpu_torch.ops.flash_attention``),
    taken for CUDA tensors that pass its shape gate when there is no bias.

``FLUX2_DISABLE_FLASH=1`` forces the plain path, as in the JAX package.
Ring attention (``ring=``) is not ported yet and raises.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from flux2_tpu_torch.ops import flash_attention as fa


def _flash_enabled() -> bool:
    return os.environ.get("FLUX2_DISABLE_FLASH", "0") != "1"


def sdpa_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    scale: Optional[float] = None,
    bias: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain attention: f32 logits and softmax, probabilities cast to v's dtype."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if bias is not None:
        logits = logits + bias.to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    return torch.matmul(probs.to(v.dtype), v)


def sdpa(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    scale: Optional[float] = None,
    bias: Optional[torch.Tensor] = None,
    blocked_span: Optional[tuple] = None,
    ring: Optional[tuple] = None,
    bounded_logits: bool = False,
) -> torch.Tensor:
    """Dispatching attention ([B, H, S, D]); see the module docstring.

    ``blocked_span=(q0, q1, k0)``: queries in [q0, q1) are blind to keys >= k0.
    ``bounded_logits`` is passed to the kernel, where it changes nothing.
    """
    if ring is not None:
        raise NotImplementedError("ring attention is not ported to flux2_tpu_torch yet")
    if bias is None and _flash_enabled() and q.is_cuda and fa.supported(q, k, v):
        return fa.flash_attention(q, k, v, scale=scale, blocked_span=blocked_span,
                                  bounded_logits=bounded_logits)
    if blocked_span is not None:
        span_bias = fa.blocked_span_bias(q.shape[2], k.shape[2], blocked_span, q.device)
        bias = span_bias if bias is None else bias + span_bias
    return sdpa_reference(q, k, v, scale=scale, bias=bias)
