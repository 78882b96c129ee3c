"""Flash-attention forward for the FLUX.2 DiT: a hand-written Hopper kernel.

Replaces the TPU kernel ``flux2_tpu/ops/flash_attention.py:_flash_kernel`` /
``_flash_body`` (forward only). The CUDA source is
``flux2_tpu_torch/csrc/flash_attention.cu``; its header comment says what
bounds it on the card and how the design answers that.

Semantics are those of ``_flash_body``, not its tiling: non-causal
softmax(scale * q k^T) v with an exact online softmax (running row max in
f32), keys past S_k masked on the ragged last tile, and the optional
``blocked_span=(q0, q1, k0)``: queries in [q0, q1) see no key >= k0.

The TPU kernel's exp2 pre-scale of Q, its adaptive ``_pick_block_k`` and its
constant-anchor softmax for ``bounded_logits`` callers are TPU tiling and VPU
choices that the port leaves out. ``bounded_logits`` is accepted and changes
nothing: the exact running max is correct inside and outside that contract,
so ``FLUX2_FLASH_EXACT_MAX`` has nothing to switch here.

On a CPU tensor ``flash_attention`` computes ``flash_attention_reference``;
on a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

NEG_INF = -1e30  # finite, as in the JAX package: a fully blocked row averages, never NaNs
HEAD_DIM = 128  # the only head dim the kernel takes; every FLUX.2 config has it

# Kernel launches by ``flash_attention``; tests and chip_smoke.py reset and read it.
launches = 0


def supported(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> bool:
    """Shape gate, as the JAX kernel's: 4D [B,H,S,D], D multiple of 128, S >= 128."""
    if q.ndim != 4 or k.shape != v.shape:
        return False
    return q.shape[-1] % 128 == 0 and q.shape[2] >= 128 and k.shape[2] >= 128


def blocked_span_bias(
    s_q: int, s_k: int, blocked_span: Tuple[int, int, int], device
) -> torch.Tensor:
    """Additive f32 bias [1, 1, S_q, S_k]: NEG_INF where the span blocks a key."""
    q0, q1, k0 = blocked_span
    row = torch.arange(s_q, device=device)[:, None]
    col = torch.arange(s_k, device=device)[None, :]
    blocked = (row >= q0) & (row < q1) & (col >= k0)
    return torch.where(blocked, NEG_INF, 0.0).to(torch.float32)[None, None]


def flash_attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    scale: Optional[float] = None,
    blocked_span: Optional[Tuple[int, int, int]] = None,
) -> torch.Tensor:
    """Plain float32 attention with the kernel's semantics; output in q's dtype."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if blocked_span is not None:
        logits = logits + blocked_span_bias(q.shape[2], k.shape[2], blocked_span, q.device)
    probs = torch.softmax(logits, dim=-1)
    return torch.matmul(probs, v.float()).to(q.dtype)


def _check_cuda_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda:
            raise ValueError(f"flash_attention: {name} is on {t.device}, q on {q.device}")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"flash_attention: the CUDA kernel takes bfloat16, {name} is {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"flash_attention: {name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"flash_attention: {name} must be 16-byte aligned")
    if q.ndim != 4 or k.shape != v.shape or k.ndim != 4:
        raise ValueError(f"flash_attention: want q [B,H,Sq,D], k = v [B,H,Sk,D]; got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if q.shape[:2] != k.shape[:2] or q.shape[3] != k.shape[3]:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} and k {tuple(k.shape)} disagree")
    if q.shape[3] != HEAD_DIM:
        raise NotImplementedError(f"flash_attention: the CUDA kernel supports D={HEAD_DIM} only, got {q.shape[3]}")
    if q.device != k.device or q.device != v.device:
        raise ValueError("flash_attention: q, k and v must be on one device")


@functools.lru_cache(maxsize=None)
def _kernel():
    """The C entry ``flux2_flash_attention_fwd`` (built on first use), typed:
    q, k, v, out, bh, s_q, s_k, d, scale, q0, q1, k0, has_span, stream."""
    from flux2_tpu_torch.utils.build import load_kernels

    fn = load_kernels().flux2_flash_attention_fwd
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_float] + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    scale: Optional[float] = None,
    blocked_span: Optional[Tuple[int, int, int]] = None,
    bounded_logits: bool = False,
) -> torch.Tensor:
    """Non-causal attention, q [B,H,Sq,D], k/v [B,H,Sk,D] -> [B,H,Sq,D] in q's dtype.

    ``bounded_logits`` is accepted for the JAX signature and has no effect.
    """
    del bounded_logits
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, scale, blocked_span)
    _check_cuda_inputs(q, k, v)
    fn = _kernel()
    b, h, s_q, d = q.shape
    s_k = k.shape[2]
    out = torch.empty_like(q)
    q0, q1, k0 = blocked_span if blocked_span is not None else (0, 0, 0)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 b * h, s_q, s_k, d, float(scale),
                 int(q0), int(q1), int(k0), int(blocked_span is not None), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention: kernel launch failed with cudaError {err}")
    global launches
    launches += 1
    return out
