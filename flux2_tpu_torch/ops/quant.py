"""Weight quantization: the storage formats and the W8A8 / W4A8 runtime formats.

Port of ``flux2_tpu/ops/quant.py``. Codes and scales equal the JAX
package's bit for bit (the same f32 operations, divisions where JAX divides,
round half to even, first index on ``argmin`` ties); only the layout differs.
The port stores linear weights [out, in] = [N, K] (``F.linear``'s layout), so
  - codes are [.., N, K] with K contiguous, int4-family codes packed two per
    byte along K ([.., N, K/2]);
  - group scales and biases are [.., N, K/g], W8A8 scales [.., N], W4A8
    scales [.., N, K/512].
The two int4 packings differ, as in JAX: ``QTensor`` int4 interleaves (low
nibble = even K index), ``W4A8Tensor`` splits each 512-wide K block in halves
(low nibble = index r, high nibble = index r + 256, codes offset by 8).

Each quantized weight is a small ``nn.Module`` holding its tensors as
buffers, so it follows ``.to(device)`` and takes the place of an
``nn.Parameter`` on a block. ``q_linear(x, w)`` is ``q_matmul``'s
counterpart: a dense weight goes to ``F.linear``; a quantized one goes to
its hand-written kernel (``ops/quant_kernels.py``) on a CUDA tensor when
JAX's shape gate admits it, and otherwise to dequantize-then-``F.linear``,
as on JAX's CPU. ``FLUX2_PALLAS_DEQUANT=1`` opts the grouped qint8 / int4
formats into the fused dequant-matmul kernel (K7), as in JAX. A weight
whose tensors are DTensors (``parallel.sharding.shard_params``) goes to
``parallel/quant_partition.py``: a dense, W8A8 or W4A8 one by JAX's column /
row rules (JAX's partitioned runtime, which the port always takes), a stored
``QTensor`` gathered whole first (the replicated body: JAX has no rule for
K7's formats).
"""

from __future__ import annotations

import os
from typing import Optional, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor

from flux2_tpu_torch.ops import quant_kernels as qk

FORMATS = ("bf16", "qint8", "int4", "nf4", "mxfp8", "mxfp4", "nvfp4")

GROUP_SIZES = {"qint8": 64, "int4": 64, "nf4": 64, "mxfp8": 32, "mxfp4": 32, "nvfp4": 16}

_NIBBLE_FORMATS = ("int4", "nf4", "mxfp4", "nvfp4")

# e2m1 (sign + 2-bit exponent + 1-bit mantissa) value table for fp4 codes.
_E2M1_VALUES = np.array(
    [0.0, 0.5, 1.0, 1.5, 2.0, 3.0, 4.0, 6.0, -0.0, -0.5, -1.0, -1.5, -2.0, -3.0, -4.0, -6.0],
    dtype=np.float32,
)

# QLoRA NormalFloat4 (bitsandbytes values), as the JAX package's table.
_NF4_VALUES = np.array(
    [-1.0, -0.6961928009986877, -0.5250730514526367, -0.39491748809814453,
     -0.28444138169288635, -0.18477343022823334, -0.09105003625154495, 0.0,
     0.07958029955625534, 0.16093020141124725, 0.24611230194568634,
     0.33791524171829224, 0.44070982933044434, 0.5626170039176941,
     0.7229568362236023, 1.0],
    dtype=np.float32,
)

W4A8_BLOCK = 512

# XLA computes log2(x) as log(x) times this f32 constant, so an exact power of
# two comes out a little above or below its exponent (log2(2^-13) =
# -12.999999) and the microscaling exponent's ceil moves with it: bf16
# weights hit such group maxima often. The port takes the same product.
_LOG2_E = float(np.float32(1.0 / np.log(2.0)))

# JAX writes the W8A8 / W4A8 weight scales as ``amax / 127.0`` and ``/ 7.0``
# inside ``jax.jit``, where XLA's simplifier turns a division by a constant
# into a multiply by its f32 reciprocal; the port writes that multiply
# (``RUNTIME_SCALE``), so the scales agree bit for bit. ``quantize`` runs
# eagerly in JAX and divides.


class QTensor(nn.Module):
    """Stored weight: codes + per-group scale (+ bias for the affine int formats)."""

    def __init__(self, q: torch.Tensor, scale: torch.Tensor, bias: Optional[torch.Tensor],
                 format: str, group_size: int, orig_in: int):
        super().__init__()
        self.register_buffer("q", q)  # [.., N, K] (qint8 uint8, mxfp8 float8_e4m3fn) or [.., N, K/2] uint8
        self.register_buffer("scale", scale)  # f32 [.., N, K/g]
        self.register_buffer("bias", bias)  # f32 [.., N, K/g] (qint8 / int4) or None
        self.format = format
        self.group_size = group_size
        self.orig_in = orig_in

    @property
    def nbytes(self) -> int:
        return sum(t.nbytes for t in self.buffers())

    def extra_repr(self) -> str:
        return f"{self.format}, g={self.group_size}, q={tuple(self.q.shape)}"


class W8A8Tensor(nn.Module):
    """Runtime W8A8 weight: symmetric int8 codes + one f32 scale per output column.

    Per-column weight scales and per-token activation scales let the kernel
    (K5) sum int32 over all of K and rescale once."""

    format = "w8a8"

    def __init__(self, q: torch.Tensor, scale: torch.Tensor, orig_in: int):
        super().__init__()
        self.register_buffer("q", q)  # int8 [.., N, K]
        self.register_buffer("scale", scale)  # f32 [.., N]
        self.orig_in = orig_in

    @property
    def nbytes(self) -> int:
        return self.q.nbytes + self.scale.nbytes

    def extra_repr(self) -> str:
        return f"q={tuple(self.q.shape)}"


class W4A8Tensor(nn.Module):
    """Runtime W4A8 weight: split-half packed int4 codes in [-7, 7] + one f32
    scale per (output column, 512-wide K block); see the module docstring."""

    format = "w4a8"

    def __init__(self, q: torch.Tensor, scale: torch.Tensor, block: int, orig_in: int):
        super().__init__()
        self.register_buffer("q", q)  # uint8 [.., N, K/2]
        self.register_buffer("scale", scale)  # f32 [.., N, K/block]
        self.block = block
        self.orig_in = orig_in

    @property
    def nbytes(self) -> int:
        return self.q.nbytes + self.scale.nbytes

    def extra_repr(self) -> str:
        return f"block={self.block}, q={tuple(self.q.shape)}"


QuantizedWeight = Union[QTensor, W8A8Tensor, W4A8Tensor]


def is_quantized(w) -> bool:
    return isinstance(w, (QTensor, W8A8Tensor, W4A8Tensor))


# ---------------------------------------------------------------------------
# Quantize / dequantize
# ---------------------------------------------------------------------------


def _pack_nibbles(q: torch.Tensor) -> torch.Tensor:
    """[.., N, K] codes 0..15 -> [.., N, K/2] uint8, low nibble = even K index."""
    return (q[..., 0::2] | (q[..., 1::2] << 4)).to(torch.uint8)


def _unpack_nibbles(q: torch.Tensor, d_in: int) -> torch.Tensor:
    return torch.stack([q & 0xF, q >> 4], dim=-1).reshape(*q.shape[:-1], d_in)


def _encode_e2m1(x: torch.Tensor) -> torch.Tensor:
    """Nearest e2m1 code (0..15); ties take the first index, as ``jnp.argmin``."""
    vals = torch.from_numpy(_E2M1_VALUES).to(x.device)
    return torch.argmin(torch.abs(x[..., None] - vals), dim=-1).to(torch.uint8)


def quantize(w: torch.Tensor, fmt: str, group_size: Optional[int] = None, in_jit: bool = False) -> QTensor:
    """Quantize a weight [.., N, K] along K (JAX ``quantize`` on the transpose).
    ``in_jit`` divides by the constants (levels, the format's max) as XLA
    does inside ``jax.jit``, by a multiply with their f32 reciprocal: JAX's
    LoRA merge requantizes there (``_merge_qtensor_slicewise``)."""

    def by(x: torch.Tensor, c: float) -> torch.Tensor:
        return x * (1.0 / c) if in_jit else x / c

    if fmt == "bf16":
        raise ValueError("bf16 is the unquantized format")
    if fmt not in GROUP_SIZES:
        raise ValueError(f"unknown quantization format {fmt}")
    g = group_size or GROUP_SIZES[fmt]
    *lead, d_out, d_in = w.shape
    if d_in % g:
        raise ValueError(f"in dim {d_in} not divisible by group size {g}")
    wf = w.to(torch.float32).reshape(*lead, d_out, d_in // g, g)

    if fmt in ("qint8", "int4"):
        levels = 255 if fmt == "qint8" else 15
        wmin = torch.amin(wf, dim=-1, keepdim=True)
        wmax = torch.amax(wf, dim=-1, keepdim=True)
        scale = by(wmax - wmin, levels)
        scale = torch.where(scale == 0, 1.0, scale)
        q = torch.clamp(torch.round((wf - wmin) / scale), 0, levels).to(torch.uint8)
        q = q.reshape(*lead, d_out, d_in)
        if fmt == "int4":
            q = _pack_nibbles(q)
        return QTensor(q, scale.squeeze(-1), wmin.squeeze(-1), fmt, g, d_in)

    amax = torch.amax(torch.abs(wf), dim=-1, keepdim=True)
    if fmt == "nf4":
        scale = torch.where(amax == 0, 1.0, amax)
        vals = torch.from_numpy(_NF4_VALUES).to(w.device)
        codes = torch.argmin(torch.abs((wf / scale)[..., None] - vals), dim=-1).to(torch.uint8)
        return QTensor(_pack_nibbles(codes.reshape(*lead, d_out, d_in)), scale.squeeze(-1), None, fmt, g, d_in)

    amax = torch.where(amax == 0, 1.0, amax)
    target_max = 448.0 if fmt == "mxfp8" else 6.0  # e4m3 max / e2m1 max
    if fmt == "nvfp4":  # float (e4m3-representable) scale
        scale = by(amax, target_max).to(torch.float8_e4m3fn).to(torch.float32)
        scale = torch.where(scale == 0, 2.0**-16, scale)
    else:  # power-of-two shared scale (OCP microscaling)
        scale = torch.exp2(torch.ceil(torch.log(by(amax, target_max)) * _LOG2_E))
    scaled = wf / scale
    if fmt == "mxfp8":
        q = scaled.to(torch.float8_e4m3fn).reshape(*lead, d_out, d_in)
    else:
        q = _pack_nibbles(_encode_e2m1(scaled).reshape(*lead, d_out, d_in))
    return QTensor(q, scale.squeeze(-1), None, fmt, g, d_in)


def dequantize(qw: QTensor, dtype: torch.dtype = torch.bfloat16, fused: bool = False) -> torch.Tensor:
    """QTensor -> dense [.., N, K] in ``dtype`` (f32 arithmetic, as JAX's eager
    ``dequantize``). ``fused`` rounds ``codes * scale + bias`` once, as a fused
    multiply-add, which is what XLA compiles inside ``jax.jit``; the product of
    an 8-bit code and an f32 scale is exact in float64, so float64 gives it."""
    fmt, g, d_in = qw.format, qw.group_size, qw.orig_in
    q = qw.q
    if fmt in _NIBBLE_FORMATS:
        q = _unpack_nibbles(q, d_in)
    *lead, d_out, _ = q.shape
    shape = (*lead, d_out, d_in // g, g)
    scale = qw.scale[..., None]
    if fmt in ("qint8", "int4"):
        if fused:
            w = (q.to(torch.float64).reshape(shape) * scale.double() + qw.bias[..., None].double()).to(torch.float32)
        else:
            w = q.to(torch.float32).reshape(shape) * scale + qw.bias[..., None]
    elif fmt == "mxfp8":
        w = q.to(torch.float32).reshape(shape) * scale
    else:
        table = _NF4_VALUES if fmt == "nf4" else _E2M1_VALUES
        w = torch.from_numpy(table).to(q.device)[q.long()].reshape(shape) * scale
    return w.reshape(*lead, d_out, d_in).to(dtype)


def _dense_f32(w) -> torch.Tensor:
    """A dense weight, or a stored QTensor dequantized to bf16 as JAX's
    ``_requant_slicewise`` does it under ``jit``, as float32."""
    if isinstance(w, QTensor):
        return dequantize(w, torch.bfloat16, fused=True).to(torch.float32)
    return w.to(torch.float32)


def to_w8a8(w) -> W8A8Tensor:
    """A dense weight [.., N, K] or a stored QTensor -> the W8A8 compute format."""
    if isinstance(w, W8A8Tensor):
        return w
    d_in = w.orig_in if isinstance(w, QTensor) else w.shape[-1]
    wf = _dense_f32(w)
    amax = torch.amax(torch.abs(wf), dim=-1, keepdim=True)
    scale = torch.clamp(amax, min=1e-30) * (1.0 / 127.0)  # RUNTIME_SCALE
    q = torch.clamp(torch.round(wf / scale), -127, 127).to(torch.int8)
    return W8A8Tensor(q, scale.squeeze(-1), d_in)


def dequantize_w8a8(w: W8A8Tensor, dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    return (w.q.to(torch.float32) * w.scale[..., None]).to(dtype)


def to_w4a8(w, block: int = W4A8_BLOCK):
    """A dense weight or stored QTensor -> W4A8. A weight whose K does not tile
    by ``block`` comes back dense (a QTensor dequantized to bf16), as in JAX."""
    if isinstance(w, W4A8Tensor):
        return w
    d_in = w.orig_in if isinstance(w, QTensor) else w.shape[-1]
    if d_in % block:  # JAX dequantizes eagerly here, unfused
        return dequantize(w, torch.bfloat16) if isinstance(w, QTensor) else w
    half = block // 2
    wf = _dense_f32(w)
    *lead, d_out, _ = wf.shape
    wf = wf.reshape(*lead, d_out, d_in // block, block)
    amax = torch.amax(torch.abs(wf), dim=-1, keepdim=True)
    scale = torch.clamp(amax, min=1e-30) * (1.0 / 7.0)  # RUNTIME_SCALE
    q = torch.clamp(torch.round(wf / scale), -7, 7).to(torch.int32)
    lo = (q[..., :half] + 8).to(torch.uint8)  # offset-by-8 nibbles
    hi = (q[..., half:] + 8).to(torch.uint8)
    packed = (lo | (hi << 4)).reshape(*lead, d_out, d_in // 2)
    return W4A8Tensor(packed, scale.squeeze(-1), block, d_in)


def w4a8_codes(w: W4A8Tensor) -> torch.Tensor:
    """The signed int8 codes [.., N, K] of a W4A8 weight, K in order."""
    *lead, d_out, _ = w.q.shape
    p = w.q.reshape(*lead, d_out, w.orig_in // w.block, w.block // 2).to(torch.int16)
    codes = torch.cat([(p & 0xF) - 8, (p >> 4) - 8], dim=-1)
    return codes.reshape(*lead, d_out, w.orig_in).to(torch.int8)


def dequantize_w4a8(w: W4A8Tensor, dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    *lead, d_out, _ = w.q.shape
    codes = w4a8_codes(w).to(torch.float32).reshape(*lead, d_out, w.orig_in // w.block, w.block)
    return (codes * w.scale[..., None]).reshape(*lead, d_out, w.orig_in).to(dtype)


def dequantize_any(w: QuantizedWeight, dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    if isinstance(w, W8A8Tensor):
        return dequantize_w8a8(w, dtype)
    if isinstance(w, W4A8Tensor):
        return dequantize_w4a8(w, dtype)
    return dequantize(w, dtype)


# ---------------------------------------------------------------------------
# Matmul dispatch
# ---------------------------------------------------------------------------


def _sharded_linear(x: torch.Tensor, w) -> torch.Tensor:
    """``q_linear`` of a weight held as DTensors (see the module docstring)."""
    from flux2_tpu_torch.parallel import quant_partition as qp

    if isinstance(w, torch.Tensor):
        return qp.dense_linear_partitioned(x, w)
    if isinstance(w, W8A8Tensor):
        return qp.w8a8_matmul_partitioned(x, w)
    if isinstance(w, W4A8Tensor):
        return qp.w4a8_matmul_partitioned(x, w)
    return qp.replicated_linear(x, w)


def _pallas_dequant_enabled() -> bool:
    return os.environ.get("FLUX2_PALLAS_DEQUANT", "0") == "1"


def kernel_route(x: torch.Tensor, w: QuantizedWeight) -> Optional[str]:
    """The kernel a CUDA matmul of ``x`` by the quantized ``w`` takes, by JAX's
    gates alone: "w8a8" (K5), "w4a8" (K6), "dequant" (K7), or None for the
    dequantize-then-matmul path."""
    if w.q.ndim != 2:
        return None
    if isinstance(w, W8A8Tensor):
        return "w8a8" if qk.w8a8_supported(x, w) else None
    if isinstance(w, W4A8Tensor):
        return "w4a8" if qk.w4a8_supported(x, w) else None
    if _pallas_dequant_enabled() and w.format in ("qint8", "int4") and qk.supported(x, w):
        return "dequant"
    return None


def q_linear(x: torch.Tensor, w: "torch.Tensor | QuantizedWeight") -> torch.Tensor:
    """``x @ w.T`` for a dense [N, K] weight or a quantized one (JAX ``q_matmul``).

    On a CUDA tensor a quantized weight that passes its gate launches its
    kernel, which raises on failure; nothing falls back. When ``x`` requires
    grad the kernel runs inside ``KernelLinear``, so the gradient reaches
    ``x``. Every other case dequantizes in ``x``'s dtype and calls
    ``F.linear``. Mixed dense dtypes promote, as ``x @ w`` does in JAX (a
    bf16 stream under a quantized x_embedder meets f32 weights in a float32
    model). A weight held as DTensors takes ``_sharded_linear``."""
    if isinstance(w if isinstance(w, torch.Tensor) else w.q, DTensor):
        return _sharded_linear(x, w)
    if isinstance(w, torch.Tensor):
        if x.dtype != w.dtype:
            dtype = torch.promote_types(x.dtype, w.dtype)
            return F.linear(x.to(dtype), w.to(dtype))
        return F.linear(x, w)
    route = kernel_route(x, w) if x.is_cuda else None
    if route is None:
        return F.linear(x, dequantize_any(w, x.dtype))
    kernel = getattr(qk, _ROUTE_KERNELS[route])
    if torch.is_grad_enabled() and x.requires_grad:
        return KernelLinear.apply(x, w, kernel)
    return kernel(x, w)


class KernelLinear(torch.autograd.Function):
    """A quantized projection whose forward is a hand-written kernel (K5 with
    its prologue, K6 or K7, passed in as ``kernel``) and whose backward is
    ``dx = dy @ dequantize_any(w)`` in dy's dtype: what autodiff gives for
    JAX's differentiable ``x @ dequantize(w)``. The activation rounding of K5
    and K6 is in the forward only, and the weight is a frozen buffer, so no
    weight gradient is formed; the dense weight lives for one backward call."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, w, kernel) -> torch.Tensor:
        ctx.w = w
        return kernel(x, w)

    @staticmethod
    def backward(ctx, dy: torch.Tensor):
        return torch.matmul(dy, dequantize_any(ctx.w, dy.dtype)), None, None


_ROUTE_KERNELS = {"w8a8": "w8a8_matmul", "w4a8": "w4a8_matmul", "dequant": "dequant_matmul"}


def param_dtype(w: "torch.Tensor | QuantizedWeight") -> torch.dtype:
    """A weight's float dtype, bfloat16 for a quantized one (JAX ``_param_dtype``)."""
    return w.dtype if isinstance(w, torch.Tensor) else torch.bfloat16


# ---------------------------------------------------------------------------
# Whole-module conversion
# ---------------------------------------------------------------------------

# Names that are never matmul weights: norm scales, biases, token-embedding
# tables, VAE BatchNorm statistics (JAX ``_NON_MATMUL_KEYS``).
_NON_MATMUL_KEYS = ("norm", "bias", "embed_tokens", "embedding", "bn", "running_")


def _name_is_matmul(name: str) -> bool:
    name = name.lower()
    return not any(tag in name for tag in _NON_MATMUL_KEYS)


def _weights(module: nn.Module):
    """(owner, attribute, qualified name, weight, layers) for every parameter and
    quantized weight. ``layers`` is the length of the ``ModuleList`` the owner
    sits in, else 1: JAX stacks such weights into one [L, K, N] leaf, and its
    size filter sees the stack."""
    lists = {name: len(m) for name, m in module.named_modules() if isinstance(m, nn.ModuleList)}
    for mname, mod in list(module.named_modules()):
        if is_quantized(mod):
            continue
        parent, _, last = mname.rpartition(".")
        layers = lists.get(parent, 1) if last.isdigit() else 1
        items = list(mod._parameters.items()) + [(n, m) for n, m in mod._modules.items() if is_quantized(m)]
        for attr, w in items:
            if w is not None:
                yield mod, attr, f"{mname}.{attr}" if mname else attr, w, layers


def _replace(mod: nn.Module, attr: str, new) -> None:
    delattr(mod, attr)
    if isinstance(new, torch.Tensor) and not isinstance(new, nn.Parameter):
        new = nn.Parameter(new, requires_grad=False)
    setattr(mod, attr, new)


def quantize_params(module: nn.Module, fmt: str, min_size: int = 1 << 16, prefix: Optional[str] = None) -> nn.Module:
    """Quantize, in place, every float 2-D matmul weight of ``module`` whose
    stacked size (``layers * numel``) is at least ``min_size``, with JAX's
    name filter and per-format K divisibility; "w8a8" / "w4a8" also convert
    stored QTensors. ``prefix`` limits it to the weights whose qualified
    names start with it (one block of a loader's, ``io/weight_mapping.py``),
    each judged as in the whole module. Returns ``module``."""
    if fmt == "bf16":
        return module
    if fmt not in ("w8a8", "w4a8") and fmt not in GROUP_SIZES:
        raise ValueError(f"unknown quantization format {fmt}")
    chosen = [(mod, attr, name, layers) for mod, attr, name, _, layers in _weights(module)
              if prefix is None or name.startswith(prefix)]
    # the list holds no weight: each dense weight is freed as its quantized one replaces it
    for mod, attr, name, layers in chosen:
        w = getattr(mod, attr)
        if is_quantized(w):
            if isinstance(w, QTensor) and fmt in ("w8a8", "w4a8"):
                _replace(mod, attr, to_w8a8(w) if fmt == "w8a8" else to_w4a8(w))
            continue
        k = w.shape[-1]
        if not (_name_is_matmul(name) and w.ndim == 2 and w.is_floating_point() and layers * w.numel() >= min_size):
            continue
        if fmt == "w8a8":
            _replace(mod, attr, to_w8a8(w))
        elif fmt == "w4a8":
            if k % W4A8_BLOCK == 0:
                _replace(mod, attr, to_w4a8(w))
        elif k % GROUP_SIZES[fmt] == 0:  # every group size is even, as nibble packing needs
            _replace(mod, attr, quantize(w, fmt))
    return module


def quantized_names(module: nn.Module) -> dict:
    """{qualified name: format} of every quantized weight in ``module``."""
    return {name: w.format for _, _, name, w, _ in _weights(module) if is_quantized(w)}


def param_bytes(module: nn.Module) -> int:
    """Bytes of every parameter and buffer (quantized weights at their stored width)."""
    return sum(t.nbytes for t in module.parameters()) + sum(t.nbytes for t in module.buffers())


def dequantize_params(module: nn.Module, dtype: torch.dtype = torch.bfloat16) -> nn.Module:
    """Expand every quantized weight of ``module`` back to a dense parameter, in place."""
    for mod, attr, _, w, _ in list(_weights(module)):
        if is_quantized(w):
            _replace(mod, attr, dequantize_any(w, dtype))
    return module
