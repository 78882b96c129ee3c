"""Quantized matmuls for the port: three hand-written Hopper kernels.

Replaces the TPU kernels of ``flux2_tpu/ops/quant_kernels.py``:
  - K5 ``_kernel_w8a8`` (``w8a8_matmul``): int8 activations x int8 weights,
    int32 sums over all of K, one f32 epilogue ``acc * (xs[row] * ws[col])``;
  - K6 ``_kernel_w4a8`` (``w4a8_matmul``): int8 activations x split-half
    packed int4 weights, an int32 sum per 512-wide K block rescaled by
    ``xs[row, kb] * ws[col, kb]`` into an f32 sum;
  - K7 ``_kernel_int8`` / ``_kernel_int4`` (``dequant_matmul``): grouped
    affine dequant ``codes * scale + bias`` (group 64) to x's dtype, then a
    dot with f32 accumulation.
The CUDA source is ``flux2_tpu_torch/csrc/quant_matmul.cu``; its header says
what bounds each kernel on the card and how the design answers that.

The activation quantization of K5 (per token) and K6 (per (token, 512-block))
is an XLA prologue outside the Pallas call in JAX. In the port it is a fourth
hand-written kernel, ``quantize_activations`` (``csrc/quant_prologue.cu``),
which reads x once and writes the int8 codes and f32 scales, equal to the
plain torch chain ``quantize_rows`` / ``quantize_row_blocks`` to the bit. The
shape gates are JAX's, unchanged; the weights are in the port's [N, K] layout
(``flux2_tpu_torch/ops/quant.py``).

Beside each kernel is its plain torch version, which the CPU path and the
card's checks use. K5's and K6's compute the int32 dot exactly (in float64,
which is exact below 2^53; an f32 matmul is not once |sum| > 2^24). A wrapper
given a CPU tensor returns its plain version; on a CUDA tensor it launches its
kernels or raises.
"""

from __future__ import annotations

import ctypes
import functools
import threading

import torch

# Kernel launches by the wrappers, keyed by kernel; tests and chip_smoke.py
# reset and read it. Request threads (prompt encodes) and the serving worker
# launch concurrently, so increments hold ``_launch_lock``; each thread also
# counts its own (``thread_launches``), so a span on one thread reads its own
# launches alone while another thread's encode launches beside it.
# ``w8a8_grouped`` counts the K5 launches that walked their tiles in groups of
# more than one row band (``w8a8_group``).
launches = {"w8a8": 0, "w8a8_grouped": 0, "w4a8": 0, "dequant_int8": 0, "dequant_int4": 0, "quantize_rows": 0}
_launch_lock = threading.Lock()
_thread = threading.local()

DEQUANT_BLOCK_K = 512  # JAX's DEFAULT_BK: the K7 gate wants K % 512 == 0
DEQUANT_GROUP = 64  # the only group size the K7 kernel takes (qint8 / int4 default)
H100_SMS = 132
L2_BYTES = 50 * 2**20  # the H100's L2


def _rows(x: torch.Tensor) -> int:
    m = 1
    for d in x.shape[:-1]:
        m *= d
    return m


def _count(name: str) -> None:
    with _launch_lock:
        launches[name] += 1
    mine = getattr(_thread, "launches", None)
    if mine is None:
        mine = _thread.launches = dict.fromkeys(launches, 0)
    mine[name] += 1


def thread_launches(name: str) -> int:
    """The launches of kernel ``name`` made so far on the calling thread
    (``reset_launches`` leaves them: a caller reads differences)."""
    return getattr(_thread, "launches", {}).get(name, 0)


def reset_launches() -> None:
    with _launch_lock:
        for name in launches:
            launches[name] = 0


# ---------------------------------------------------------------------------
# Shape gates (JAX's, on the [N, K] layout)
# ---------------------------------------------------------------------------


def supported(x: torch.Tensor, w) -> bool:
    """K7 gate: K % 512, N % 128 and at least 8 rows."""
    if x.shape[-1] != w.orig_in:
        return False
    if w.orig_in % DEQUANT_BLOCK_K or w.q.shape[-2] % 128:
        return False
    return _rows(x) >= 8


def w8a8_supported(x: torch.Tensor, w) -> bool:
    """K5 gate: K % 256 and N % 256, any number of rows."""
    if x.shape[-1] != w.orig_in:
        return False
    n, k = w.q.shape[-2:]
    return k % 256 == 0 and n % 256 == 0


def w4a8_supported(x: torch.Tensor, w) -> bool:
    """K6 gate: K tiles by the weight's block, N % 256, block % 256."""
    if x.shape[-1] != w.orig_in:
        return False
    n, k2 = w.q.shape[-2:]
    return (2 * k2) % w.block == 0 and n % 256 == 0 and w.block % 256 == 0


# ---------------------------------------------------------------------------
# K5's tile order
# ---------------------------------------------------------------------------


def w8a8_tile_shape(m: int, n: int, sms: int = H100_SMS):
    """(BM, BN, stages, CTAs an SM) of K5's tile for an [m, n] output, as
    ``dispatch_w8a8`` and ``W8Layout`` in ``csrc/quant_matmul.cu`` pick them."""
    if m <= 64:
        return 64, 128, 3, 2
    if n % 256 == 0 and -(-m // 128) * (n // 256) >= sms:
        return 128, 256, 3, 1
    return 128, 128, 4, 1


@functools.lru_cache(maxsize=None)
def w8a8_group(m: int, n: int, k: int, sms: int = H100_SMS) -> int:
    """The row bands G that K5 walks its output tiles in groups of (the
    ``group`` of its C entry; 1 is the row-band-major walk).

    A wave of K5's persistent CTAs (``sms`` tiles, or all of them when fewer)
    then covers G row bands by about sms / G weight tiles, and reads each x
    band and each weight tile once, K deep; a wave that spans whole groups
    (when a group holds fewer tiles than the wave) covers every weight tile.
    G is the one whose wave reads the fewest bytes, the smaller on a tie,
    among 1, the powers of two below the number of row bands and that number,
    such that the group's x bands, which every wave of the group reads again,
    and the weight k-slices in the rings of the CTAs in flight fit half the L2
    (each of its two halves holds what the SMs on both sides read). So G is 1
    where M is one band (M <= 64: the modulations and every decode token) and
    where one wave holds every tile."""
    bm, bn, stages, per_sm = w8a8_tile_shape(m, n, sms)
    mt, ntn = -(-m // bm), n // bn
    p = min(sms * per_sm, mt * ntn)  # the CTAs in flight

    def wave_bytes(g):
        if g * ntn >= p:
            return (g * bm + -(-p // g) * bn) * k
        return (min(mt, -(-p // ntn)) * bm + ntn * bn) * k

    def fits(g):
        return g * bm * k + -(-p // g) * bn * 128 * stages <= L2_BYTES // 2

    groups = [g for g in {1 << i for i in range(mt.bit_length()) if 1 << i < mt} | {mt} if g == 1 or fits(g)]
    return min(groups, key=lambda g: (wave_bytes(g), g))


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


# ---------------------------------------------------------------------------
# Activation prologues (plain torch: the CPU path, the references, the yardsticks)
# ---------------------------------------------------------------------------


def quantize_rows(x: torch.Tensor):
    """Symmetric int8 along the last axis: (xq int8, xs f32 without that axis),
    JAX's prologue (``quant_kernels.py:236-239``): the scale is
    ``max(amax, 1e-30) * (1/127)``, the codes ``clip(round(x / scale), +-127)``,
    in f32. The amax is taken on x as given (exact in any float type), and the
    f32 passes run in place on one copy."""
    amax = torch.linalg.vector_norm(x, ord=float("inf"), dim=-1, keepdim=True).to(torch.float32)
    xs = torch.clamp(amax, min=1e-30) * (1.0 / 127.0)
    xq = x.to(torch.float32, copy=True).div_(xs).round_().clamp_(-127.0, 127.0).to(torch.int8)
    return xq, xs[..., 0]


def quantize_row_blocks(x2: torch.Tensor, block: int):
    """Per (row, K block): (xq int8 [M, K], xs f32 [M, K/block]) (``quant_kernels.py:342-350``)."""
    m, k = x2.shape
    xq, xs = quantize_rows(x2.reshape(m, k // block, block))
    return xq.reshape(m, k), xs


def _exact_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """int8 [M, K] . int8 [N, K] -> the int32 sums [M, N] as float32 (rounded
    to nearest like the kernel's int->float conversion), computed in float64."""
    return (a.to(torch.float64) @ b.to(torch.float64).T).to(torch.float32)


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def w8a8_matmul_reference(x: torch.Tensor, w) -> torch.Tensor:
    """Plain K5: x [.., K] by W8A8 [N, K] -> [.., N] in x's dtype."""
    *lead, k = x.shape
    xq, xs = quantize_rows(x.reshape(-1, k))
    out = _exact_dot(xq, w.q) * (xs[:, None] * w.scale[None, :])
    return out.to(x.dtype).reshape(*lead, w.q.shape[0])


def w4a8_matmul_reference(x: torch.Tensor, w) -> torch.Tensor:
    """Plain K6: per K block, an exact int dot times ``xs[row, kb] * ws[col, kb]``,
    summed in f32 block after block, as the TPU kernel's accumulator."""
    from flux2_tpu_torch.ops.quant import w4a8_codes

    *lead, k = x.shape
    bk = w.block
    xq, xs = quantize_row_blocks(x.reshape(-1, k), bk)
    codes = w4a8_codes(w)
    acc = torch.zeros(xq.shape[0], codes.shape[0], dtype=torch.float32, device=x.device)
    for b in range(k // bk):
        cols = slice(b * bk, (b + 1) * bk)
        acc = acc + _exact_dot(xq[:, cols], codes[:, cols]) * (xs[:, b : b + 1] * w.scale[None, :, b])
    return acc.to(x.dtype).reshape(*lead, codes.shape[0])


def dequant_matmul_reference(x: torch.Tensor, w) -> torch.Tensor:
    """Plain K7: dequantize in f32, cast to x's dtype, multiply with f32 accumulation."""
    from flux2_tpu_torch.ops.quant import dequantize

    wd = dequantize(w, torch.float32).to(x.dtype)
    return torch.matmul(x.to(torch.float32), wd.to(torch.float32).T).to(x.dtype)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


# (pointers, ints) before the stream of each C entry. K5: xq, xs, wq, ws, out,
# m, n, k, out_is_f32, group (``w8a8_group``). K6: the same without the group.
# K7: x, codes, scale, bias, out, m, n, k, group, is_int4. The prologue: x, xq,
# xs, m, k, block, x_is_f32.
_SIGNATURES = {"flux2_w8a8_matmul": (5, 5), "flux2_w4a8_matmul": (5, 4), "flux2_dequant_matmul": (5, 5),
               "flux2_quantize_rows": (3, 4)}


@functools.lru_cache(maxsize=None)
def _kernel(name: str):
    """A C entry of the kernel library (built on first use), typed; its last argument is the stream."""
    from flux2_tpu_torch.utils.build import load_kernels

    fn = getattr(load_kernels(), name)
    n_ptrs, n_ints = _SIGNATURES[name]
    fn.argtypes = [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check_tensor(what: str, t: torch.Tensor, device: torch.device, dtype: torch.dtype) -> None:
    if t.device != device:
        raise ValueError(f"{what} is on {t.device}, the activations on {device}")
    if t.dtype != dtype:
        raise TypeError(f"{what} must be {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{what} must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{what} must be 16-byte aligned")


def _launch(name: str, counter: str, device: torch.device, *args) -> None:
    fn = _kernel(name)
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with cudaError {err}")
    _count(counter)


def _out_dtype_flag(x: torch.Tensor, what: str) -> int:
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{what}: the CUDA kernel writes bfloat16 or float32, x is {x.dtype}")
    return int(x.dtype == torch.float32)


def quantize_activations(x2: torch.Tensor, block: int):
    """The prologue of K5 (``block`` = K) and K6 (``block`` = 512): x2 [M, K]
    (bf16 or f32) -> (xq int8 [M, K], xs f32 [M, K / block]), per (row,
    block) as ``quantize_row_blocks``. A CPU tensor takes that plain version;
    a CUDA tensor launches the hand-written kernel (``csrc/quant_prologue.cu``)."""
    if x2.device.type == "cpu":
        return quantize_row_blocks(x2, block)
    m, k = x2.shape
    if x2.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"quantize_activations: the CUDA kernel reads bfloat16 or float32, x is {x2.dtype}")
    if block <= 0 or k % block or block % 8:
        raise ValueError(f"quantize_activations: block {block} must divide K = {k} and be a multiple of 8")
    x2 = x2.contiguous()
    if x2.data_ptr() % 16:  # a view at an odd offset: the kernel reads 16 bytes at a time
        x2 = x2.clone()
    xq = torch.empty(m, k, dtype=torch.int8, device=x2.device)
    xs = torch.empty(m, k // block, dtype=torch.float32, device=x2.device)
    _launch("flux2_quantize_rows", "quantize_rows", x2.device, x2.data_ptr(), xq.data_ptr(), xs.data_ptr(), m, k,
            block, int(x2.dtype == torch.float32))
    return xq, xs


def w8a8_matmul(x: torch.Tensor, w) -> torch.Tensor:
    """K5: x [.., K] (bf16 or f32) by W8A8 [N, K] -> [.., N] in x's dtype,
    after the prologue kernel quantizes x per row."""
    if x.device.type == "cpu":
        return w8a8_matmul_reference(x, w)
    if not w8a8_supported(x, w):
        raise ValueError(f"w8a8_matmul: x {tuple(x.shape)} by codes {tuple(w.q.shape)} fails the K5 gate")
    out_f32 = _out_dtype_flag(x, "w8a8_matmul")
    *lead, k = x.shape
    n = w.q.shape[0]
    _check_tensor("w8a8 codes", w.q, x.device, torch.int8)
    _check_tensor("w8a8 scale", w.scale, x.device, torch.float32)
    xq, xs = quantize_activations(x.reshape(-1, k), k)
    m = xq.shape[0]
    out = torch.empty(m, n, dtype=x.dtype, device=x.device)
    group = w8a8_group(m, n, k, _sm_count(x.device))
    _launch("flux2_w8a8_matmul", "w8a8", x.device, xq.data_ptr(), xs.data_ptr(), w.q.data_ptr(),
            w.scale.data_ptr(), out.data_ptr(), m, n, k, out_f32, group)
    if group > 1:
        _count("w8a8_grouped")
    return out.reshape(*lead, n)


def w4a8_matmul(x: torch.Tensor, w) -> torch.Tensor:
    """K6: x [.., K] (bf16 or f32) by W4A8 [N, K/2] packed -> [.., N] in x's dtype,
    after the prologue kernel quantizes x per (row, 512-block)."""
    if x.device.type == "cpu":
        return w4a8_matmul_reference(x, w)
    if not w4a8_supported(x, w) or w.block != 512:
        raise ValueError(f"w4a8_matmul: x {tuple(x.shape)} by codes {tuple(w.q.shape)} (block {w.block}) "
                         "fails the K6 gate or the kernel's block of 512")
    out_f32 = _out_dtype_flag(x, "w4a8_matmul")
    *lead, k = x.shape
    n = w.q.shape[0]
    _check_tensor("w4a8 codes", w.q, x.device, torch.uint8)
    _check_tensor("w4a8 scale", w.scale, x.device, torch.float32)
    xq, xs = quantize_activations(x.reshape(-1, k), w.block)
    m = xq.shape[0]
    out = torch.empty(m, n, dtype=x.dtype, device=x.device)
    _launch("flux2_w4a8_matmul", "w4a8", x.device, xq.data_ptr(), xs.data_ptr(), w.q.data_ptr(),
            w.scale.data_ptr(), out.data_ptr(), m, n, k, out_f32)
    return out.reshape(*lead, n)


def dequant_matmul(x: torch.Tensor, w) -> torch.Tensor:
    """K7: x [.., K] bf16 by a qint8 / int4 QTensor [N, K(/2)], group 64 -> [.., N] bf16."""
    if x.device.type == "cpu":
        return dequant_matmul_reference(x, w)
    if not supported(x, w):
        raise ValueError(f"dequant_matmul: x {tuple(x.shape)} by codes {tuple(w.q.shape)} fails the K7 gate")
    if w.format not in ("qint8", "int4") or w.group_size != DEQUANT_GROUP:
        raise NotImplementedError(f"dequant_matmul: the CUDA kernel takes qint8 / int4 at group "
                                  f"{DEQUANT_GROUP}, got {w.format} at {w.group_size}")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"dequant_matmul: the CUDA kernel takes bfloat16 activations, x is {x.dtype}")
    *lead, k = x.shape
    n = w.q.shape[0]
    x2 = x.reshape(-1, k).contiguous()
    m = x2.shape[0]
    _check_tensor("x", x2, x.device, torch.bfloat16)
    _check_tensor("dequant codes", w.q, x.device, torch.uint8)
    _check_tensor("dequant scale", w.scale, x.device, torch.float32)
    _check_tensor("dequant bias", w.bias, x.device, torch.float32)
    is_int4 = int(w.format == "int4")
    out = torch.empty(m, n, dtype=x.dtype, device=x.device)
    _launch("flux2_dequant_matmul", "dequant_int4" if is_int4 else "dequant_int8", x.device, x2.data_ptr(),
            w.q.data_ptr(), w.scale.data_ptr(), w.bias.data_ptr(), out.data_ptr(), m, n, k, w.group_size,
            is_int4)
    return out.reshape(*lead, n)
