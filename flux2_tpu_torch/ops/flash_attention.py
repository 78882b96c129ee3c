"""Flash attention for the FLUX.2 DiT: hand-written Hopper kernels, forward and backward.

Replaces the TPU kernels of ``flux2_tpu/ops/flash_attention.py``:
  - K1 ``_flash_kernel`` / ``_flash_body``: the forward with no gradient;
  - K2 ``_flash_kernel_lse``: the forward that also returns the row LSE;
  - K3 ``_bwd_dq_kernel`` and K4 ``_bwd_dkv_kernel``: the backward.
The CUDA sources are ``flux2_tpu_torch/csrc/flash_attention.cu`` (K1, K2)
and ``csrc/flash_attention_bwd.cu`` (K3, K4); their header comments say what
bounds them on the card and how the designs answer that.

Semantics are those of the JAX kernels, not their tiling: non-causal
softmax(scale * q k^T) v with an exact online softmax (running row max in
f32), keys past S_k masked on the ragged last tile, and the optional
``blocked_span=(q0, q1, k0)``: queries in [q0, q1) see no key >= k0. The LSE
is the natural-log row logsumexp of the scaled logits, f32 [B, H, S_q] (the
TPU kernel's 128-lane strip is TPU layout and is dropped).

``flash_attention`` is differentiable, as JAX's custom VJP is
(``_flash_diff``): when grad is enabled and q, k or v requires grad it runs
``FlashAttention``, whose forward is K2 and whose backward is K3 then K4;
otherwise it runs K1. Backward computes delta = rowsum(dO * O) from the O the
forward wrote, in f32, as JAX does outside its Pallas calls.

The TPU kernel's exp2 pre-scale of Q, its adaptive ``_pick_block_k`` and its
constant-anchor softmax for ``bounded_logits`` callers are TPU tiling and VPU
choices that the port leaves out. ``bounded_logits`` is accepted and changes
nothing: the exact running max is correct inside and outside that contract,
so ``FLUX2_FLASH_EXACT_MAX`` has nothing to switch here.

On a CPU tensor every wrapper computes its plain float32 version; on a CUDA
tensor it launches its kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

NEG_INF = -1e30  # finite, as in the JAX package: a fully blocked row averages, never NaNs
HEAD_DIM = 128  # the only head dim the kernels take; every FLUX.2 config has it
LOG2E = 1.4426950408889634

# Kernel launches by the wrappers below; tests and chip_smoke.py reset and read them.
launches = 0  # K1, flash_attention with no gradient
launches_lse = 0  # K2, flash_attention_lse
launches_dq = 0  # K3, flash_attention_backward
launches_dkv = 0  # K4, flash_attention_backward


def reset_launches() -> None:
    global launches, launches_lse, launches_dq, launches_dkv
    launches = launches_lse = launches_dq = launches_dkv = 0


def launch_counts() -> dict:
    return {"flash": launches, "flash_lse": launches_lse, "flash_bwd_dq": launches_dq,
            "flash_bwd_dkv": launches_dkv}


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


def _logits(q, k, scale, blocked_span) -> torch.Tensor:
    """f32 scaled logits [B, H, S_q, S_k], NEG_INF where the span blocks."""
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if blocked_span is not None:
        logits = logits + blocked_span_bias(q.shape[2], k.shape[2], blocked_span, q.device)
    return logits


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
    probs = torch.softmax(_logits(q, k, scale, blocked_span), dim=-1)
    return torch.matmul(probs, v.float()).to(q.dtype)


def flash_attention_lse_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    scale: float,
    blocked_span: Optional[Tuple[int, int, int]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain float32 K2: (out in q's dtype, natural-log row LSE f32 [B, H, S_q])."""
    logits = _logits(q, k, scale, blocked_span)
    lse = torch.logsumexp(logits, dim=-1)
    out = torch.matmul(torch.exp(logits - lse[..., None]), v.float()).to(q.dtype)
    return out, lse


def flash_attention_grads_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    dout: torch.Tensor,
    scale: float,
    blocked_span: Optional[Tuple[int, int, int]] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of softmax attention in float32 from the softmax itself, in
    q/k/v's dtypes: the counterpart of JAX's ``_xla_attention_grads``, and the
    reference K3 and K4 are held against."""
    p = torch.softmax(_logits(q, k, scale, blocked_span), dim=-1)
    g = dout.float()
    dv = torch.matmul(p.transpose(-1, -2), g)
    dp = torch.matmul(g, v.float().transpose(-1, -2))
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))
    dq = torch.matmul(ds, k.float()) * scale
    dk = torch.matmul(ds.transpose(-1, -2), q.float()) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _backward_from_lse(q, k, v, dout, lse, delta, scale, blocked_span):
    """Plain float32 K3 + K4: p recomputed from the LSE in the exp2 domain, as the
    kernels do (logits * scale * log2e - lse * log2e), and the given delta."""
    s2 = torch.matmul(q.float(), k.float().transpose(-1, -2)) * (scale * LOG2E)
    if blocked_span is not None:
        s2 = torch.where(blocked_span_bias(q.shape[2], k.shape[2], blocked_span, q.device) < 0, NEG_INF, s2)
    p = torch.exp2(s2 - (lse * LOG2E)[..., None])
    g = dout.float()
    dv = torch.matmul(p.transpose(-1, -2), g)
    ds = p * (torch.matmul(g, v.float().transpose(-1, -2)) - delta[..., None])
    dq = torch.matmul(ds, k.float()) * scale
    dk = torch.matmul(ds.transpose(-1, -2), q.float()) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check_cuda_inputs(name: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *rest) -> None:
    """Raise on anything the kernels do not take: device, bf16, contiguity,
    16-byte alignment, shapes. ``rest`` holds (label, tensor) pairs shaped as q."""
    for label, t in (("q", q), ("k", k), ("v", v), *rest):
        if not t.is_cuda:
            raise ValueError(f"{name}: {label} is on {t.device}, q on {q.device}")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{name}: the CUDA kernel takes bfloat16, {label} is {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {label} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {label} must be 16-byte aligned")
        if t.device != q.device:
            raise ValueError(f"{name}: q, k, v (and dout, out) must be on one device")
    if q.ndim != 4 or k.shape != v.shape or k.ndim != 4:
        raise ValueError(f"{name}: want q [B,H,Sq,D], k = v [B,H,Sk,D]; got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if q.shape[:2] != k.shape[:2] or q.shape[3] != k.shape[3]:
        raise ValueError(f"{name}: q {tuple(q.shape)} and k {tuple(k.shape)} disagree")
    if q.shape[3] != HEAD_DIM:
        raise NotImplementedError(f"{name}: the CUDA kernel supports D={HEAD_DIM} only, got {q.shape[3]}")
    if q.shape[0] * q.shape[1] > 65535:
        raise ValueError(f"{name}: B*H = {q.shape[0] * q.shape[1]} exceeds the kernel grid's 65535")
    for label, t in rest:
        if t.shape != q.shape:
            raise ValueError(f"{name}: {label} {tuple(t.shape)} is not shaped as q {tuple(q.shape)}")


def _check_row_stats(name: str, q: torch.Tensor, *stats) -> None:
    """lse / delta: contiguous f32 [B, H, S_q] on q's device."""
    for label, t in stats:
        if t.device != q.device or t.dtype != torch.float32 or not t.is_contiguous() or t.shape != q.shape[:3]:
            raise ValueError(f"{name}: {label} must be contiguous float32 {tuple(q.shape[:3])} on {q.device}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")


@functools.lru_cache(maxsize=None)
def _entry(symbol: str, n_ptr: int):
    """The C entry ``symbol`` of the kernel library (built on first use), typed:
    ``n_ptr`` pointers, then bh, s_q, s_k, d, scale, q0, q1, k0, has_span, stream."""
    from flux2_tpu_torch.utils.build import load_kernels

    fn = getattr(load_kernels(), symbol)
    fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 4 + [ctypes.c_float] + [ctypes.c_int] * 4
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _launch(symbol: str, q: torch.Tensor, k: torch.Tensor, ptrs, scale: float, blocked_span) -> None:
    b, h, s_q, d = q.shape
    q0, q1, k0 = blocked_span if blocked_span is not None else (0, 0, 0)
    fn = _entry(symbol, len(ptrs))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(*ptrs, b * h, s_q, k.shape[2], d, float(scale), int(q0), int(q1), int(k0),
                 int(blocked_span is not None), stream)
    if err != 0:
        raise RuntimeError(f"{symbol}: kernel launch failed with cudaError {err}")


def _flash_k1(q, k, v, scale, blocked_span) -> torch.Tensor:
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, scale, blocked_span)
    _check_cuda_inputs("flash_attention", q, k, v)
    out = torch.empty_like(q)
    _launch("flux2_flash_attention_fwd", q, k, (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr()),
            scale, blocked_span)
    global launches
    launches += 1
    return out


def flash_attention_lse(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    scale: float,
    blocked_span: Optional[Tuple[int, int, int]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2: (out [B,H,Sq,D] in q's dtype, natural-log row LSE f32 [B,H,Sq])."""
    if q.device.type == "cpu":
        return flash_attention_lse_reference(q, k, v, scale, blocked_span)
    _check_cuda_inputs("flash_attention_lse", q, k, v)
    out = torch.empty_like(q)
    lse = torch.empty(q.shape[:3], device=q.device, dtype=torch.float32)
    _launch("flux2_flash_attention_fwd_lse", q, k,
            (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr()), scale, blocked_span)
    global launches_lse
    launches_lse += 1
    return out, lse


def flash_attention_backward(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    out: torch.Tensor,
    lse: torch.Tensor,
    dout: torch.Tensor,
    scale: float,
    blocked_span: Optional[Tuple[int, int, int]] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K3 then K4: (dq, dk, dv) in q/k/v's dtypes from the forward's out and LSE.
    delta = rowsum(dO * O) is taken here in f32 from the given ``out``."""
    if q.device.type == "cpu":
        delta = (dout.float() * out.float()).sum(-1)
        return _backward_from_lse(q, k, v, dout, lse, delta, scale, blocked_span)
    _check_cuda_inputs("flash_attention_backward", q, k, v, ("dout", dout), ("out", out))
    delta = (dout.float() * out.float()).sum(-1)
    _check_row_stats("flash_attention_backward", q, ("lse", lse), ("delta", delta))
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    rows = (q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), lse.data_ptr(), delta.data_ptr())
    global launches_dq, launches_dkv
    _launch("flux2_flash_attention_bwd_dq", q, k, (*rows, dq.data_ptr()), scale, blocked_span)
    launches_dq += 1
    _launch("flux2_flash_attention_bwd_dkv", q, k, (*rows, dk.data_ptr(), dv.data_ptr()), scale, blocked_span)
    launches_dkv += 1
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """Differentiable flash attention: K2 forward, K3 + K4 backward (JAX's
    ``_flash_diff`` custom VJP). The residuals go through ``save_for_backward``,
    so ``torch.utils.checkpoint`` can drop and recompute them."""

    @staticmethod
    def forward(ctx, q, k, v, scale, blocked_span):
        out, lse = flash_attention_lse(q, k, v, scale, blocked_span)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale = scale
        ctx.blocked_span = blocked_span
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        # dO arrives non-contiguous (the backward of the caller's head transpose)
        dq, dk, dv = flash_attention_backward(q, k, v, out, lse, dout.contiguous(), ctx.scale, ctx.blocked_span)
        return dq, dk, dv, None, None


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    scale: Optional[float] = None,
    blocked_span: Optional[Tuple[int, int, int]] = None,
    bounded_logits: bool = False,
) -> torch.Tensor:
    """Non-causal attention, q [B,H,Sq,D], k/v [B,H,Sk,D] -> [B,H,Sq,D] in q's dtype.

    Differentiable: with grad enabled and q, k or v requiring grad it is
    ``FlashAttention`` (K2 forward, K3/K4 backward); otherwise K1.
    ``bounded_logits`` is accepted for the JAX signature and has no effect.
    """
    del bounded_logits
    if scale is None:
        scale = q.shape[-1] ** -0.5
    scale = float(scale)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return FlashAttention.apply(q, k, v, scale, blocked_span)
    return _flash_k1(q, k, v, scale, blocked_span)

