"""The DiT block's glue around its projections as two hand-written CUDA kernels.

  - G1 ``adaln_modulate(x, shift, scale)``: ``modulate(layer_norm(x), shift,
    scale)``, the AdaLN of every ``DoubleBlock`` / ``SingleBlock`` stream and
    of ``Flux2Transformer._final``;
  - G2 ``qkv_heads(q, k, v, norm_q, norm_k, cos, sin, out_q, out_k, out_v,
    offset)``: one stream's q, k and v projections [B, S, H*128] written into
    the joint [B, H, S_joint, 128] buffers at token ``offset``, q and k through
    ``rms_norm`` and ``apply_rope`` at their joint positions, v re-laid out;
    a double block calls it once a stream (text at 0, image at S_txt), so the
    joint sequence needs no concatenation.

Neither replaces a TPU kernel: XLA fused this glue on the TPU. The CUDA source
is ``flux2_tpu_torch/csrc/dit_glue.cu``; its header says what bounds the
kernels and how they round.

The blocks take these wrappers on the no-grad path (``transformer._fused``);
with autograd recording they run the chains of ``ops/normalization.py`` and
``ops/rope.py``. On a CPU (or meta) tensor each wrapper computes its plain
version, which is that chain verbatim, so the CPU bits do not depend on the
route; on a CUDA tensor it launches its kernel or raises. The kernels round where the chains
round, and differ from them only by the order of a row's f32 sums.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from flux2_tpu_torch.ops.normalization import layer_norm, modulate, rms_norm
from flux2_tpu_torch.ops.rope import apply_rope

HEAD_DIM = 128  # G2's only head dim; every FLUX.2 config has it

# Kernel launches by the wrappers; tests, chip_smoke.py and the ``dit.step``
# span's ``glue`` attribute read them.
launches = {"adaln_modulate": 0, "qkv_heads": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def launch_counts() -> dict:
    return dict(launches)


def adaln_modulate_reference(x: torch.Tensor, shift: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """G1's plain version: the chain itself."""
    return modulate(layer_norm(x), shift, scale)


def qkv_heads_reference(q, k, v, norm_q, norm_k, cos, sin, out_q, out_k, out_v, offset: int) -> None:
    """G2's plain version: the chain itself, written into the joint buffers."""
    b, s, _ = q.shape
    h = out_q.shape[1]
    rows = slice(offset, offset + s)

    def heads(x):
        return x.reshape(b, s, h, -1).transpose(1, 2).contiguous()

    out_q[:, :, rows] = apply_rope(rms_norm(heads(q), norm_q), cos[rows], sin[rows])
    out_k[:, :, rows] = apply_rope(rms_norm(heads(k), norm_k), cos[rows], sin[rows])
    out_v[:, :, rows] = heads(v)


# (pointers, long longs, ints) before the stream of each C entry.
_SIGNATURES = {
    "flux2_adaln_modulate": [ctypes.c_void_p, ctypes.c_longlong] * 3 + [ctypes.c_void_p] + [ctypes.c_int] * 3,
    "flux2_qkv_heads": [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5,
}


@functools.lru_cache(maxsize=None)
def _kernel(name: str):
    """A C entry of the kernel library (built on first use), typed; its last argument is the stream."""
    from flux2_tpu_torch.utils.build import load_kernels

    fn = getattr(load_kernels(), name)
    fn.argtypes = [*_SIGNATURES[name], ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch(name: str, counter: str, device: torch.device, *args) -> None:
    """Launches on ``device``'s current stream. A served step makes 71 of these
    calls, so the card's own device skips the device switch. The C entry
    checks what it can see (pointer alignment, widths, strides, token bounds)
    and returns cudaErrorInvalidValue (1) where they break its contract."""
    fn = _kernel(name)
    if device.index == torch.cuda.current_device():
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    else:
        with torch.cuda.device(device):
            err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name}: the kernel refused its arguments or failed to launch: cudaError {err} (1: "
                           f"unaligned, a width or stride it does not take, or tokens past the joint buffers)")
    launches[counter] += 1


def _check(name: str, tensors, args, device: int, contiguous: bool) -> None:
    """What the C entries cannot see: each tensor's dtype (``args``: its label
    and dtype), card, and layout (wholly contiguous, or, with ``contiguous``
    false, in its last dimension)."""
    for t, (label, dtype) in zip(tensors, args):
        if t.dtype != dtype:
            raise TypeError(f"{name}: the CUDA kernel takes {dtype} {label}, got {t.dtype}")
        if t.get_device() != device:
            raise ValueError(f"{name}: {label} is on {t.device}, the stream on cuda:{device}")
        if not (t.is_contiguous() if contiguous else t.stride(-1) == 1):
            raise ValueError(f"{name}: {label} must be contiguous{'' if contiguous else ' in its last dimension'}")


_BF16, _F32 = torch.bfloat16, torch.float32
_G1_ARGS = (("x", _BF16), ("shift", _BF16), ("scale", _BF16))
_G2_ARGS = (("q", _BF16), ("k", _BF16), ("v", _BF16), ("norm_q", _BF16), ("norm_k", _BF16), ("cos", _F32),
            ("sin", _F32), ("out_q", _BF16), ("out_k", _BF16), ("out_v", _BF16))


def adaln_modulate(x: torch.Tensor, shift: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """G1: x [B, S, D], shift and scale [B, D] -> ``modulate(layer_norm(x), shift,
    scale)`` [B, S, D]. On the card everything is bf16, D a multiple of 8 up to
    16384 (a CTA of 1024 threads, two 16-byte chunks each), x's rows
    contiguous (its batch stride free: ``_final``'s image slice), shift and
    scale rows of a modulation tensor (any row stride)."""
    if not x.is_cuda:  # the CPU, and the meta device's shape runs
        return adaln_modulate_reference(x, shift, scale)
    name = "adaln_modulate"
    b, s, d = x.shape
    if shift.shape != (b, d) or scale.shape != (b, d) or (s > 1 and x.stride(1) != d):
        raise ValueError(f"{name}: want x [B, S, D] with contiguous rows, shift and scale [B, D]; got "
                         f"{tuple(x.shape)} (strides {x.stride()}), {tuple(shift.shape)}, {tuple(scale.shape)}")
    _check(name, (x, shift, scale), _G1_ARGS, x.get_device(), False)
    out = x.new_empty((b, s, d))
    _launch("flux2_adaln_modulate", name, x.device, x.data_ptr(), x.stride(0), shift.data_ptr(), shift.stride(0),
            scale.data_ptr(), scale.stride(0), out.data_ptr(), b, s, d)
    return out


def qkv_heads(q, k, v, norm_q, norm_k, cos, sin, out_q, out_k, out_v, offset: int) -> None:
    """G2: q, k, v [B, S, H*128] into out_q, out_k, out_v [B, H, S_joint, 128]
    at tokens [offset, offset + S): q and k as ``apply_rope(rms_norm(heads(.),
    norm), cos, sin)`` at their joint positions, v as ``heads(v)``. cos and
    sin are the joint tables [S_joint, 128] (f32 on the card). On the card
    everything else is bf16 and contiguous."""
    if not q.is_cuda:
        return qkv_heads_reference(q, k, v, norm_q, norm_k, cos, sin, out_q, out_k, out_v, offset)
    name = "qkv_heads"
    b, s, hd = q.shape
    _, h, s_joint, d = out_q.shape
    if d != HEAD_DIM:
        raise NotImplementedError(f"{name}: the CUDA kernel supports head dim {HEAD_DIM} only, got {d}")
    if (k.shape != q.shape or v.shape != q.shape or out_k.shape != out_q.shape or out_v.shape != out_q.shape
            or out_q.shape[0] != b or h * d != hd or norm_q.shape != (d,) or norm_k.shape != (d,)
            or sin.shape != cos.shape or cos.ndim != 2 or cos.shape[1] != d or cos.shape[0] < offset + s):
        raise ValueError(f"{name}: want q = k = v [B, S, H*{d}], outputs [B, H, S_joint, {d}], norms [{d}] and "
                         f"tables [>= offset + S, {d}]; got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}, "
                         f"{tuple(out_q.shape)}, {tuple(norm_q.shape)}, {tuple(cos.shape)} at offset {offset}")
    tensors = (q, k, v, norm_q, norm_k, cos, sin, out_q, out_k, out_v)
    _check(name, tensors, _G2_ARGS, q.get_device(), True)
    _launch("flux2_qkv_heads", name, q.device, *(t.data_ptr() for t in tensors), b, s, h, s_joint, offset)
