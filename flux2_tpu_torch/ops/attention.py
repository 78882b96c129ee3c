"""Scaled dot-product attention dispatch for the DiT. Layout [B, H, S, D].

Port of ``flux2_tpu/ops/attention.py``. Two paths:
  - ``sdpa_reference``: plain attention with float32 logits and softmax, the
    counterpart of ``sdpa_xla``. It runs on the CPU and is the reference.
  - the flash-attention kernel (``flux2_tpu_torch.ops.flash_attention``),
    taken for CUDA tensors that pass its shape gate when there is no bias.

``FLUX2_DISABLE_FLASH=1`` forces the plain path, as in the JAX package.

Under a mesh q/k/v are DTensors (heads on tp): the kernel is opaque to
DTensor, so the dense paths run on each rank's local heads under
``local_map``. ``ring=(mesh, axis)`` takes sequence-parallel ring attention
(``flux2_tpu_torch.parallel.ring_attention``: K2 on every step's block) for
unmasked attention whose query and key counts divide the axis; otherwise it
warns once per shape and attends densely, JAX's one fallback.
"""

from __future__ import annotations

import functools
import logging
import os
from typing import Optional

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from flux2_tpu_torch.ops import flash_attention as fa
from flux2_tpu_torch.parallel.ring_attention import ring_attention
from flux2_tpu_torch.parallel.sharding import axis_size


def _flash_enabled() -> bool:
    return os.environ.get("FLUX2_DISABLE_FLASH", "0") != "1"


@functools.lru_cache(maxsize=64)
def _warn_ring_fallback(s_q: int, s_k: int, n: int) -> None:
    """Once per shape: context parallelism was requested but not taken."""
    logging.getLogger("flux2_tpu").warning(
        "ring attention requested but sequence (%d q / %d kv tokens) is not "
        "divisible by the %d-way mesh axis; falling back to dense attention "
        "(no context-parallel memory savings for this shape)", s_q, s_k, n,
    )


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
    ``ring=(mesh, axis)``: ring attention over that mesh axis (a DTensor out).
    ``bounded_logits`` is passed to the kernel, where it changes nothing.
    """
    if ring is not None and bias is None and blocked_span is None:
        mesh, axis = ring
        n = axis_size(mesh, axis)
        if q.shape[2] % n == 0 and k.shape[2] % n == 0:
            return ring_attention(q, k, v, mesh=mesh, axis=axis, scale=scale, bounded_logits=bounded_logits)
        _warn_ring_fallback(q.shape[2], k.shape[2], n)
    if isinstance(q, DTensor):
        return _sdpa_local_heads(q, k, v, scale, bias, blocked_span, bounded_logits)
    if bias is None and _flash_enabled() and q.is_cuda and fa.supported(q, k, v):
        return fa.flash_attention(q, k, v, scale=scale, blocked_span=blocked_span,
                                  bounded_logits=bounded_logits)
    if blocked_span is not None:
        span_bias = fa.blocked_span_bias(q.shape[2], k.shape[2], blocked_span, q.device)
        bias = span_bias if bias is None else bias + span_bias
    return sdpa_reference(q, k, v, scale=scale, bias=bias)


def _sdpa_local_heads(q, k, v, scale, bias, blocked_span, bounded_logits):
    """``sdpa`` of DTensors on each rank's local batch rows and heads: tokens
    and the head dim whole, k and v laid out as q, under ``local_map``."""
    places = [p if isinstance(p, Shard) and p.dim < 2 else Replicate() for p in q.placements]

    def body(q_loc, k_loc, v_loc):
        return sdpa(q_loc.contiguous(), k_loc.contiguous(), v_loc.contiguous(), scale=scale, bias=bias,
                    blocked_span=blocked_span, bounded_logits=bounded_logits)

    fn = local_map(body, out_placements=places, in_placements=(places, places, places), device_mesh=q.device_mesh,
                   redistribute_inputs=True)
    return fn(q, k, v)
