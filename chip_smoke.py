"""Chip smoke test of the PyTorch port (flux2_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from the sources in this checkout (into
build/kernels/, one nvcc per source, all at once) and checks each against its
plain PyTorch version on the card: K1 (flash attention), K2 / K3 / K4 (the
flash forward with the row LSE, and the dQ and dK/dV backward) at the training
shapes, K5 / K6 / K7 (the W8A8, W4A8 and grouped int8/int4 quantized
matmuls) and the int8 activation prologue of K5 and K6 (equal to the plain
torch chain to the bit). Then, with random weights drawn on the card from a
seed, at full
Klein-4B width: the 1024^2 VAE decode (first and warm), one DiT forward per
quantized runtime against the bf16 forward, bf16 serving through the port's
entry point (Flux2Server -> Qwen3-4B encoder -> DiT -> VAE), one
klein-4b-base request with classical CFG, w8a8 serving through the CLI's
build_pipeline (DiT and encoder quantized), one Klein-4B-base train step at
512^2 on the kernels against the same step on plain attention, and LoRA
training through the CLI (train-lora --random-init: 5 steps at 512^2 with a
checkpoint, then 2 steps at 1024^2). Every path runs with the launch counts
set to 0 just before it and checks them just after. Any failure raises: the
traceback is printed and the exit code is not 0. There is no CPU fallback.

The last two lines of standard output are the card's name and power limit as
nvidia-smi reports them, then {"ok": true, "device": {...}}; the line before
those lists each kernel with its launches on its path (serving for K1, K5
and the prologue, the quantized forwards for K6 and K7, the 512^2 training
run for K2-K4) and
per unit of it (a 1024^2 image, forward or train step), its error against the
plain version, and at the main path's shape its time alone (torch.profiler;
for K5-K7 also CUDA events around its C entry), its wrapper's and the plain
version's, its bound (operations or bytes over
the H100's published peaks) and one PyTorch call that computes the same
function, timed as a yardstick that the port never calls.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time

import torch

# Tolerance of the kernel against its plain f32 version on the same bf16
# inputs, as relative L2 error ||out - ref|| / ||ref||. The kernel rounds P to
# bf16 for the P.V product and its output to bf16, each a relative error of
# at most 2^-9 per element; with N(0,1) q, k, v a model of those two roundings
# gives ~2.3e-3 at every case below. Outputs are softmax-weighted averages of
# the v rows, so they are small (max |out| ~0.1-1 for S_k = 4608..200): an
# absolute limit would be loose. Left unmasked, the 63 zero pad keys of
# S_k = 961 would give ~4e-2 and the 24 of S_k = 1000 ~1.4e-2.
KERNEL_REL_TOL = 1e-2
# A full-width DiT forward with the kernel against the same forward with the
# plain attention path (FLUX2_DISABLE_FLASH=1), relative L2 error of the
# velocity: both run 25 blocks of bf16 math and differ only in attention's
# rounding (a few bf16 epsilons, 7.8e-3 each, compounding over the blocks).
DIT_REL_TOL = 5e-2
# K5 / K6 / K7 against their plain versions on the same inputs, relative L2.
# K5 and K6 compute the same int32 sums and the same f32 products and sums, in
# the same order, as their plain versions (the kernels contract no
# multiply-add), so they should agree to the bit; K7 sums f32 in another order
# than the plain f32 matmul, which flips a bf16 output rounding now and then
# (~1e-4 at K ~ 1000 on the CPU). The check below computes, at every shape,
# the error of a kernel that drops the first 64-wide K tile (the plain version
# with those 64 activations zeroed) and of one that applies a neighbouring
# column's scale, and requires both to exceed this limit.
QMM_REL_TOL = 1e-3
# Quantized DiT forward against the bf16 forward at 1024^2, relative L2 of the
# velocity. The same comparison at full depth and 4-16 heads on the CPU, with
# each kernel's arithmetic (tests/test_torch_quant_pipeline.py), gives 0.033
# (w8a8), 0.26 (w4a8), 0.020 (qint8) and 0.21 (int4), within ~10% across
# widths; the limits are 2-3x those, as in that test.
QUANT_DIT_REL_TOL = {"w8a8": 0.1, "w4a8": 0.5, "qint8": 0.06, "int4": 0.4}
# Kernel launches of one Klein-4B DiT forward, from JAX's gates
# (tests/test_torch_quant.py::test_klein4b_forward_routes): K5 misses
# x_embedder (K=128) and proj_out (N=128); under w4a8 x_embedder and
# time_linear1 stay dense (K % 512) and proj_out misses the gate; K7 also
# misses time_linear2 and the three modulations (M = batch < 8), and
# time_linear1 (K=256). One Qwen3-4B encode: 36 layers x (q, o, gate, up,
# down) on K5; k_proj and v_proj (N=640) dequantize.
FORWARD_LAUNCHES = {"w8a8": 206, "w4a8": 205, "qint8": 202, "int4": 202}
ENCODE_LAUNCHES_W8A8 = 180
QMM_SHAPES = [  # (name, M, K, N) as the served path gives them
    ("image_qkvo_1024", 4096, 3072, 3072),
    ("single_mlp_gate", 4608, 3072, 9216),
    ("ff_out", 4096, 9216, 3072),
    ("context_embedder", 512, 7680, 3072),
    ("modulation_bs1", 1, 3072, 18432),  # K7: M=8, its gate's minimum
    ("qwen3_gate_proj", 512, 2560, 9216),
    ("bn_regression", 16, 512, 2560),  # tests/test_quant.py:201-230
]
SEED = 0
# Published peaks of one H100 SXM (NVIDIA's data sheet; dense, at the full
# 700 W power limit): the bound of each kernel below is computed from them.
BF16_FLOPS = 989e12
INT8_OPS = 1979e12
HBM_BYTES_PER_S = 3.35e12


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[0].strip()


def event_times(fn, reps: int = 20, warmup: int = 3) -> list:
    """Times of ``reps`` calls (ms), CUDA events around each call, after warm-up."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return times


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median time of one call, CUDA events around each call, after warm-up."""
    return statistics.median(event_times(fn, reps, warmup))


def bound_ms(ops: float, nbytes: float, peak_ops: float) -> tuple:
    """The least time the card could take for a function (ms), and what bounds
    it: ``ops`` over the peak rate of their type, or ``nbytes`` (each input read
    once, each output written once) over the memory rate, whichever is larger."""
    t_ops = ops / peak_ops * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def attention_bytes(b: int, h: int, s_q: int, s_k: int, bf16_q_rows: int, bf16_k_rows: int, f32_q_rows: int) -> int:
    """Bytes of an attention kernel's inputs and outputs: ``bf16_q_rows`` bf16
    [B, H, S_q, 128] tensors, ``bf16_k_rows`` [B, H, S_k, 128] ones and
    ``f32_q_rows`` f32 [B, H, S_q] row statistics."""
    return b * h * (2 * 128 * (bf16_q_rows * s_q + bf16_k_rows * s_k) + 4 * f32_q_rows * s_q)


def library_time(fn, label: str, card: str):
    """time_ms of one library call timed as a yardstick (the port never calls
    it), or None, logged, where this build or card refuses the call."""
    try:
        return time_ms(fn)
    except RuntimeError as e:
        log(f"[library] {label} unavailable: {e} [{card}]")
        return None


def library_sdpa(q, k, v, card: str) -> tuple:
    """The faster of F.scaled_dot_product_attention's flash and cuDNN backends
    on the same inputs: (name, ms); timed as a yardstick, the port never calls it."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    best = ("F.scaled_dot_product_attention", None)
    for backend in (SDPBackend.FLASH_ATTENTION, SDPBackend.CUDNN_ATTENTION):
        label = f"F.scaled_dot_product_attention[{backend.name}]"
        with sdpa_kernel(backend):
            ms = library_time(lambda: F.scaled_dot_product_attention(q, k, v), label, card)
        if ms is None:
            continue
        log(f"[library] {label} q={list(q.shape)}: {ms:.4f} ms [{card}]")
        if best[1] is None or ms < best[1]:
            best = (f"F.scaled_dot_product_attention[{backend.name}]", ms)
    return best


def phase_kernel_check(card: str):
    """K1 against flash_attention_reference on the card, same bf16 inputs; at
    the 1024^2 shape also the kernel alone, its bound and the library call."""
    from flux2_tpu_torch.ops import flash_attention as fa
    from flux2_tpu_torch.utils.profile_step import kernel_time_ms

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    cases = [
        ("klein4b_1024px", (1, 24, 4608, 4608), None),
        ("klein4b_256px_bs3", (3, 24, 768, 768), None),
        ("ragged", (1, 24, 777, 1000), None),
        ("ragged_961", (1, 24, 777, 961), None),  # last 128-key tile: 65 real keys, 63 pad
        ("ragged_one_key", (1, 24, 777, 897), None),  # last 128-key tile: 1 real key, 127 pad
        ("blocked_span", (1, 24, 2560, 2560), (512, 1536, 1536)),
        ("span_mid_tile", (1, 24, 2560, 2560), (100, 1300, 1000)),  # the span cuts query and key tiles
    ]
    results = {}
    for name, (b, h, s_q, s_k), span in cases:
        q = torch.randn(b, h, s_q, 128, device="cuda", generator=gen).bfloat16()
        k = torch.randn(b, h, s_k, 128, device="cuda", generator=gen).bfloat16()
        v = torch.randn(b, h, s_k, 128, device="cuda", generator=gen).bfloat16()
        out = fa.flash_attention(q, k, v, blocked_span=span).float()
        torch.cuda.synchronize()
        ref = fa.flash_attention_reference(q, k, v, blocked_span=span).float()
        err = float((out - ref).abs().max())
        rel = float((out - ref).norm() / ref.norm())
        if not torch.isfinite(out).all() or rel > KERNEL_REL_TOL:
            raise AssertionError(f"K1 {name}: relative L2 err {rel} > {KERNEL_REL_TOL} (or non-finite)")
        ms = time_ms(lambda: fa.flash_attention(q, k, v, blocked_span=span))
        plain_ms = time_ms(lambda: fa.flash_attention_reference(q, k, v, blocked_span=span))
        flop = 4.0 * b * h * s_q * s_k * 128
        log(f"[kernel] flash_attention {name} q={[b, h, s_q, 128]} s_k={s_k} span={span}: rel_l2_err={rel} "
            f"(tol {KERNEL_REL_TOL}) max_abs_err={err} (max |ref| {float(ref.abs().max())}) kernel {ms:.4f} ms "
            f"({flop / ms / 1e9:.1f} TFLOP/s) plain f32 {plain_ms:.4f} ms [{card}]")
        results[name] = {"err": err, "ms": ms, "plain_ms": plain_ms}
        if name == "klein4b_1024px":
            alone = kernel_time_ms(lambda: fa.flash_attention(q, k, v), "flash_fwd_kernel")
            bound, bound_by = bound_ms(flop, attention_bytes(b, h, s_q, s_k, 2, 2, 0), BF16_FLOPS)
            library, library_ms = library_sdpa(q, k, v, card)
            log(f"[kernel] K1 {name}: alone {alone:.4f} ms ({flop / alone / 1e9:.1f} TFLOP/s), bound {bound:.4f} ms "
                f"({bound_by}; {bound / alone:.1%} of it), {library} {library_ms} ms [{card}]")
            results[name].update(alone=alone, bound=bound, bound_by=bound_by, library=library,
                                 library_ms=library_ms)
    return results


TRAIN_ATTENTION_CASES = [  # (name, q shape, k/v shape, span)
    ("train_512px", (1, 24, 1056, 128), (1, 24, 1056, 128), None),  # 32 txt + 1024 img, both tails ragged
    ("klein4b_1024px", (1, 24, 4608, 128), (1, 24, 4608, 128), None),
    ("train_512px_txt512_bs2", (2, 24, 1536, 128), (2, 24, 1536, 128), None),
    ("blocked_span", (1, 4, 320, 128), (1, 4, 704, 128), (64, 192, 400)),
    ("one_row_tails", (1, 24, 897, 128), (1, 24, 897, 128), None),  # 897 = 7 * 128 + 1 = 14 * 64 + 1
    ("span_mid_tile", (1, 24, 2560, 128), (1, 24, 2560, 128), (100, 1300, 1000)),  # the span cuts tiles mid-way
    ("ragged_q_ne_k", (1, 24, 777, 128), (1, 24, 1000, 128), None),  # S_q != S_k, both ragged
]
# K2's LSE against the f32 logsumexp: both are f32 sums of the same bf16
# products, ~1e-6 apart at S_k = 4608; a missing ln2 or a log2-domain LSE is
# off by ~4, one dropped key tile by ~1e-2.
LSE_ABS_TOL = 1e-3


def phase_flash_grad_check(card: str):
    """K2 (forward + LSE), K3 (dQ) and K4 (dK, dV) against their plain f32
    versions on the card, same bf16 inputs, at the training shapes. The
    gradients are held at KERNEL_REL_TOL (relative L2): p and dS enter the
    tensor cores as bf16, which a model of those roundings puts at ~3-5e-3;
    one dropped 64-key tile at S = 4608 costs ~sqrt(64 / 4608) = 0.12. A second
    backward on the same inputs must give the same bits (no atomics)."""
    from flux2_tpu_torch.ops import flash_attention as fa
    from flux2_tpu_torch.utils.profile_step import kernel_time_ms

    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    results = {}
    for name, qs, ks, span in TRAIN_ATTENTION_CASES:
        q = torch.randn(*qs, device="cuda", generator=gen).bfloat16()
        k = torch.randn(*ks, device="cuda", generator=gen).bfloat16()
        v = torch.randn(*ks, device="cuda", generator=gen).bfloat16()
        dout = torch.randn(*qs, device="cuda", generator=gen).bfloat16()
        scale = qs[-1] ** -0.5
        before = fa.launch_counts()
        out, lse = fa.flash_attention_lse(q, k, v, scale, span)
        dq, dk, dv = fa.flash_attention_backward(q, k, v, out, lse, dout, scale, span)
        torch.cuda.synchronize()
        after = fa.launch_counts()
        if [after[c] - before[c] for c in ("flash_lse", "flash_bwd_dq", "flash_bwd_dkv")] != [1, 1, 1]:
            raise AssertionError(f"{name}: the wrappers did not launch K2, K3 and K4 once each: {before} -> {after}")
        again = fa.flash_attention_backward(q, k, v, out, lse, dout, scale, span)
        if not all(torch.equal(a, b) for a, b in zip((dq, dk, dv), again)):
            raise AssertionError(f"{name}: a second backward on the same inputs gave other bits")
        del again
        ref_out, ref_lse = fa.flash_attention_lse_reference(q, k, v, scale, span)
        refs = fa.flash_attention_grads_reference(q, k, v, dout, scale, span)
        errs = {"out": float((out.float() - ref_out.float()).norm() / ref_out.float().norm()),
                "lse": float((lse - ref_lse).abs().max())}
        for label, got, ref in zip(("dq", "dk", "dv"), (dq, dk, dv), refs):
            errs[label] = float((got.float() - ref.float()).norm() / ref.float().norm())
        finite = all(bool(torch.isfinite(x).all()) for x in (out, lse, dq, dk, dv))
        if not finite or errs["lse"] > LSE_ABS_TOL or max(errs[x] for x in ("out", "dq", "dk", "dv")) > KERNEL_REL_TOL:
            raise AssertionError(f"{name}: errors {errs} (limits: LSE {LSE_ABS_TOL} max abs, the rest "
                                 f"{KERNEL_REL_TOL} relative L2), finite={finite}")
        max_abs = {"lse": errs["lse"], "out": float((out.float() - ref_out.float()).abs().max())}
        for label, got, ref in zip(("dq", "dk", "dv"), (dq, dk, dv), refs):
            max_abs[label] = float((got.float() - ref.float()).abs().max())
        fwd_ms = time_ms(lambda: fa.flash_attention_lse(q, k, v, scale, span))
        fwd_plain_ms = time_ms(lambda: fa.flash_attention_lse_reference(q, k, v, scale, span))
        bwd_ms = time_ms(lambda: fa.flash_attention_backward(q, k, v, out, lse, dout, scale, span))
        bwd_plain_ms = time_ms(lambda: fa.flash_attention_grads_reference(q, k, v, dout, scale, span))
        alone = {mark: kernel_time_ms(lambda: fa.flash_attention_backward(q, k, v, out, lse, dout, scale, span), mark)
                 for mark in ("flash_bwd_dq_kernel", "flash_bwd_dkv_kernel")}
        alone["flash_fwd_lse_kernel"] = kernel_time_ms(lambda: fa.flash_attention_lse(q, k, v, scale, span),
                                                       "flash_fwd_lse_kernel")
        flop = 2.0 * qs[0] * qs[1] * qs[2] * ks[2] * qs[3]  # one S_q x S_k x D product
        log(f"[kernel] flash training {name} q={list(qs)} k={list(ks)} span={span}: rel_l2_err out "
            f"{errs['out']:.3e} dq {errs['dq']:.3e} dk {errs['dk']:.3e} dv {errs['dv']:.3e} (tol {KERNEL_REL_TOL}), "
            f"lse max_abs_err {errs['lse']:.3e} (tol {LSE_ABS_TOL}); max_abs_err {max_abs}; a repeated backward "
            f"gave the same bits")
        log(f"[kernel] flash training {name}: K2 wrapper {fwd_ms:.4f} ms (alone {alone['flash_fwd_lse_kernel']:.4f} ms, "
            f"{2 * flop / alone['flash_fwd_lse_kernel'] / 1e9:.1f} TFLOP/s) vs plain f32 {fwd_plain_ms:.4f} ms; "
            f"backward wrapper (delta + K3 + K4) {bwd_ms:.4f} ms (K3 alone {alone['flash_bwd_dq_kernel']:.4f} ms, "
            f"{3 * flop / alone['flash_bwd_dq_kernel'] / 1e9:.1f} TFLOP/s; K4 alone "
            f"{alone['flash_bwd_dkv_kernel']:.4f} ms, {4 * flop / alone['flash_bwd_dkv_kernel'] / 1e9:.1f} TFLOP/s) "
            f"vs plain f32 grads {bwd_plain_ms:.4f} ms [{card}]")
        results[name] = {"max_abs": max_abs, "fwd_ms": fwd_ms, "fwd_plain_ms": fwd_plain_ms, "bwd_ms": bwd_ms,
                         "bwd_plain_ms": bwd_plain_ms, "alone": alone}
        if name == "klein4b_1024px":
            results[name].update(_flash_grad_yardsticks(q, k, v, dout, scale, flop, card))
        del q, k, v, dout, out, lse, dq, dk, dv, ref_out, ref_lse, refs
        torch.cuda.empty_cache()
    return results


def _flash_grad_yardsticks(q, k, v, dout, scale: float, flop: float, card: str) -> dict:
    """Bounds of K2, K3 and K4 at one no-span shape, and the library calls
    timed beside them: the flash forward that returns the LSE (K2), and its
    backward, which returns dq, dk and dv at once (K3 + K4)."""
    b, h, s_q, _ = q.shape
    s_k = k.shape[2]
    bounds = {  # (operations: S_q x S_k x 128 products, bytes: bf16 q-/k-shaped tensors, f32 rows)
        "k2": bound_ms(2 * flop, attention_bytes(b, h, s_q, s_k, 2, 2, 1), BF16_FLOPS),
        "k3": bound_ms(3 * flop, attention_bytes(b, h, s_q, s_k, 3, 2, 2), BF16_FLOPS),
        "k4": bound_ms(4 * flop, attention_bytes(b, h, s_q, s_k, 2, 4, 2), BF16_FLOPS),
    }
    fwd = torch.ops.aten._scaled_dot_product_flash_attention
    bwd = torch.ops.aten._scaled_dot_product_flash_attention_backward
    names = ("aten._scaled_dot_product_flash_attention",
             "aten._scaled_dot_product_flash_attention_backward (dq, dk, dv at once: compare with K3 + K4)")
    fwd_ms = bwd_ms = None
    try:
        out, lse, cum_q, cum_k, max_q, max_k, seed, offset = fwd(q, k, v, 0.0, False, False, scale=scale)[:8]
    except RuntimeError as e:
        log(f"[library] {names[0]} unavailable: {e} [{card}]")
    else:
        fwd_ms = library_time(lambda: fwd(q, k, v, 0.0, False, False, scale=scale), names[0], card)
        bwd_ms = library_time(lambda: bwd(dout, q, k, v, out, lse, cum_q, cum_k, max_q, max_k, 0.0, False, seed,
                                          offset, scale=scale), names[1], card)
    log(f"[library] {names[0]} {fwd_ms} ms; {names[1]} {bwd_ms} ms; bounds (ms) "
        + ", ".join(f"{kk} {bd[0]:.4f} ({bd[1]})" for kk, bd in bounds.items()) + f" [{card}]")
    return {"bounds": bounds, "library": {"k2": (names[0], fwd_ms), "k34": (names[1], bwd_ms)}}


# Launch counter of each quantized format's kernel (flux2_tpu_torch.ops.quant_kernels.launches).
COUNTER = {"w8a8": "w8a8", "w4a8": "w4a8", "qint8": "dequant_int8", "int4": "dequant_int4"}


def _qmm(fmt: str):
    """(quantize, kernel, plain version, rebuild with other scales) of one format's kernel."""
    from flux2_tpu_torch.ops import quant as tq
    from flux2_tpu_torch.ops import quant_kernels as qk

    if fmt == "w8a8":
        return tq.to_w8a8, qk.w8a8_matmul, qk.w8a8_matmul_reference, lambda w, s: tq.W8A8Tensor(w.q, s, w.orig_in)
    if fmt == "w4a8":
        return (tq.to_w4a8, qk.w4a8_matmul, qk.w4a8_matmul_reference,
                lambda w, s: tq.W4A8Tensor(w.q, s, w.block, w.orig_in))
    return (lambda w: tq.quantize(w, fmt), qk.dequant_matmul, qk.dequant_matmul_reference,
            lambda w, s: tq.QTensor(w.q, s, w.bias, w.format, w.group_size, w.orig_in))


# Name marks of the quantized-matmul kernels in a torch.profiler trace, and of
# K5's and K6's activation prologue (csrc/quant_prologue.cu).
KERNEL_MARK = {"w8a8": "w8a8_kernel", "w4a8": "w4a8_kernel", "qint8": "dequant_kernel", "int4": "dequant_kernel"}
PROLOGUE_MARK = "quantize_rows_kernel"
# The formats whose wrapper runs the prologue kernel before its matmul.
PROLOGUE_FORMATS = ("w8a8", "w4a8")


def phase_quant_kernel_check(card: str):
    """K5, K6 and K7 (int8, int4) against their plain versions, same inputs, served shapes.
    Each kernel's time alone twice: torch.profiler's mean over 10 calls of the
    wrapper, and CUDA events around 25 calls of its C entry on activations
    quantized beforehand (median, min, max). At every shape its bound and its
    library call (_qmm_yardsticks); beside K7 also the route a qint8 / int4
    weight takes without FLUX2_PALLAS_DEQUANT (dequantize, then F.linear)."""
    import torch.nn.functional as F

    from flux2_tpu_torch.ops import quant as tq
    from flux2_tpu_torch.ops import quant_kernels as qk
    from flux2_tpu_torch.utils import quant_candidate as qc
    from flux2_tpu_torch.utils.profile_step import kernel_time_ms

    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    results = {}
    for kind in ("w8a8", "w4a8", "qint8", "int4"):
        quantize, kernel, plain, with_scale = _qmm(kind)
        counter = COUNTER[kind]
        rows = []
        for name, m, k, n in QMM_SHAPES:
            if kind in ("qint8", "int4"):
                m = max(m, 8)
            x = torch.randn(m, k, device="cuda", generator=gen).bfloat16()
            w = quantize((torch.randn(n, k, device="cuda", generator=gen) * k**-0.5).bfloat16())
            before = dict(qk.launches)
            out = kernel(x, w).float()
            torch.cuda.synchronize()
            launched = {c: qk.launches[c] - before[c] for c in before if qk.launches[c] != before[c]}
            if launched != {counter: 1, **({"quantize_rows": 1} if kind in PROLOGUE_FORMATS else {})}:
                raise AssertionError(f"{kind} {name}: the wrapper launched {launched}")
            ref = plain(x, w).float()
            rel = float((out - ref).norm() / ref.norm())
            x_drop = x.clone()
            x_drop[:, :64] = 0
            drop = float((plain(x_drop, w).float() - ref).norm() / ref.norm())
            wrong = float((plain(x, with_scale(w, w.scale.roll(1, dims=0))).float() - ref).norm() / ref.norm())
            if not torch.isfinite(out).all() or rel > QMM_REL_TOL:
                raise AssertionError(f"{kind} {name} (M,K,N)=({m},{k},{n}): relative L2 {rel} > {QMM_REL_TOL}")
            if min(drop, wrong) <= QMM_REL_TOL:
                raise AssertionError(f"{kind} {name}: the tolerance {QMM_REL_TOL} would pass a dropped K tile "
                                     f"({drop}) or a wrong scale ({wrong})")
            ms = time_ms(lambda: kernel(x, w))
            plain_ms = time_ms(lambda: plain(x, w), reps=5)
            alone_ms = kernel_time_ms(lambda: kernel(x, w), KERNEL_MARK[kind])
            entry, c_args = qk._kernel(qc.ENTRY[kind]), qc.entry_args(kind, x, w)
            buf = torch.empty(m, n, device="cuda", dtype=x.dtype)
            events = event_times(lambda: qc.call(entry, c_args, buf), reps=25, warmup=5)
            events = (statistics.median(events), min(events), max(events))
            err = float((out - ref).abs().max())
            row = {"name": name, "err": err, "ms": ms, "alone": alone_ms, "events": events, "plain_ms": plain_ms}
            route = ""
            if kind in ("qint8", "int4"):
                row["route_ms"] = time_ms(lambda: F.linear(x, tq.dequantize_any(w, x.dtype)))
                route = f", dequantize + F.linear {row['route_ms']:.4f} ms"
            log(f"[kernel] {kind} {name} (M,K,N)=({m},{k},{n}): rel_l2_err={rel} (tol {QMM_REL_TOL}; a dropped "
                f"K tile gives {drop:.3e}, a neighbouring column's scale {wrong:.3e}) max_abs_err={err}; wrapper "
                f"{ms:.4f} ms, kernel alone {alone_ms:.4f} ms by torch.profiler ({2.0 * m * n * k / alone_ms / 1e9:.1f}"
                f" TOPS), by CUDA events median {events[0]:.4f} (min {events[1]:.4f}, max {events[2]:.4f}) ms, "
                f"plain {plain_ms:.4f} ms{route} [{card}]")
            row.update(_qmm_yardsticks(kind, x, w, card))
            rows.append(row)
        results[kind] = rows
    results["prologue"] = _prologue_check(card)
    return results


def _prologue_check(card: str) -> dict:
    """K5's and K6's activation prologue (quant_kernels.quantize_activations)
    against the plain torch chain on the card, at the served shapes, per row
    (K5: block = K) and per 512-block (K6): the int8 codes and the f32 scales
    must be equal to the bit. Row 0 is zero (scale 1e-30 / 127) and row 1
    holds values half-way between two codes. Timed alone (torch.profiler),
    as the wrapper (CUDA events) and as the plain chain; its bound is bytes
    (bf16 x read once, the codes and the scales written once); no single
    PyTorch call computes it."""
    from flux2_tpu_torch.ops import quant_kernels as qk
    from flux2_tpu_torch.utils.profile_step import kernel_time_ms

    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    rows = {}
    for name, m, k, _ in QMM_SHAPES:
        for block in sorted({k, 512}, reverse=True):  # per row (K5), per 512-block (K6)
            x = torch.randn(m, k, device="cuda", generator=gen).bfloat16()
            x[0] = 0
            if m > 1:  # the scale of a 127/64 amax is 2^-6: every (n + 1/2) / 64 is a tie
                ties = (torch.arange(k, device="cuda") % 254 - 127 + 0.5) / 64
                x[1] = ties.bfloat16()
                x[1, ::block] = 127 / 64
            plain = (lambda: qk.quantize_rows(x)) if block == k else (lambda: qk.quantize_row_blocks(x, block))
            before = qk.launches["quantize_rows"]
            xq, xs = qk.quantize_activations(x, block)
            torch.cuda.synchronize()
            if qk.launches["quantize_rows"] != before + 1:
                raise AssertionError(f"prologue {name} block {block}: the wrapper did not launch its kernel")
            ref_q, ref_s = plain()
            ref_s = ref_s.reshape(xs.shape)
            if not (torch.equal(xq, ref_q) and torch.equal(xs.view(torch.int32), ref_s.view(torch.int32))):
                raise AssertionError(f"prologue {name} (M,K)=({m},{k}) block {block}: codes equal "
                                     f"{torch.equal(xq, ref_q)}, scales equal {torch.equal(xs, ref_s)}")
            err = max(float((xq.int() - ref_q.int()).abs().max()), float((xs - ref_s).abs().max()))
            alone = kernel_time_ms(lambda: qk.quantize_activations(x, block), PROLOGUE_MARK)
            ms = time_ms(lambda: qk.quantize_activations(x, block))
            plain_ms = time_ms(plain)
            nbytes = 2 * m * k + m * k + 4 * m * (k // block)
            bound = bound_ms(0.0, nbytes, INT8_OPS)
            log(f"[kernel] prologue {name} (M,K)=({m},{k}) block {block}: codes and scales equal to the plain chain "
                f"to the bit (max_abs_err {err}); alone {alone:.4f} ms ({nbytes / alone / 1e6:.1f} GB/s, "
                f"{bound[0] / alone:.1%} of its {bound[0]:.6f} ms bound, {bound[1]}), wrapper {ms:.4f} ms, plain "
                f"chain {plain_ms:.4f} ms [{card}]")
            rows[(name, block)] = {"err": err, "alone": alone, "ms": ms, "plain_ms": plain_ms, "bound": bound}
    return rows


def _qmm_yardsticks(kind: str, x, w, card: str) -> dict:
    """A quantized matmul's bound from the bytes its kernel reads and writes
    (codes, scales and the activations it is given; the bf16 output) and its
    products at the int8 (K5, K6) or bf16 (K7) peak; and one library call timed
    beside it on the same codes, the product only (no scales, no rounding):
    torch._int_mm on the int8 codes for K5 and K6, a bf16 torch.matmul on the
    weight dequantized beforehand for K7."""
    from flux2_tpu_torch.ops import quant as tq
    from flux2_tpu_torch.ops import quant_kernels as qk

    m, k = x.shape
    n = w.q.shape[0]
    ops = 2.0 * m * n * k
    if kind in ("w8a8", "w4a8"):
        xq, _ = qk.quantize_rows(x)
        codes = w.q if kind == "w8a8" else tq.w4a8_codes(w)
        x_bytes = m * k + 4 * m * (1 if kind == "w8a8" else k // w.block)  # int8 codes, f32 row (block) scales
        bound = bound_ms(ops, x_bytes + w.q.numel() + 4 * w.scale.numel() + 2 * m * n, INT8_OPS)
        wt = codes.t()
        library = "torch._int_mm on the int8 codes (int32 product only: no scales)"
        library_ms = library_time(lambda: torch._int_mm(xq, wt), library, card)
    else:
        bound = bound_ms(ops, 2 * m * k + w.q.numel() + 4 * (w.scale.numel() + w.bias.numel()) + 2 * m * n,
                         BF16_FLOPS)
        wd = tq.dequantize(w, torch.bfloat16).t()
        library = "torch.matmul bf16 on the weight dequantized beforehand (product only)"
        library_ms = library_time(lambda: torch.matmul(x, wd), library, card)
    log(f"[library] {kind} (M,K,N)=({m},{k},{n}): {library} {library_ms} ms; bound {bound[0]:.4f} ms "
        f"({bound[1]}) [{card}]")
    return {"bound": bound, "library": library, "library_ms": library_ms}


def _zero_launches():
    from flux2_tpu_torch.ops import flash_attention as fa
    from flux2_tpu_torch.ops import quant_kernels as qk

    fa.reset_launches()
    qk.reset_launches()


def _launch_counts() -> dict:
    """Every kernel's count: K1 "flash", K2 "flash_lse", K3 "flash_bwd_dq", K4
    "flash_bwd_dkv", and the quantized matmuls' (a path checks all of them)."""
    from flux2_tpu_torch.ops import flash_attention as fa
    from flux2_tpu_torch.ops import quant_kernels as qk

    return {**fa.launch_counts(), **qk.launches}


def phase_quant_model_check(pipe, card: str) -> dict:
    """One full-width Klein-4B DiT forward at 1024^2 per quantized runtime (a
    copy of the bf16 DiT, quantized on the card) against the bf16 forward."""
    import copy

    import numpy as np

    from flux2_tpu_torch.ops import latents as lu
    from flux2_tpu_torch.ops import quant as tq
    from flux2_tpu_torch.ops.rope import rope_embeddings

    emb = pipe.text_encoder("a check of the quantized models")
    noise = lu.seeded_noise_seq(SEED, 1024, 1024, 1, device="cuda").bfloat16()
    ids = np.concatenate([lu.text_position_ids(512), lu.image_position_ids(1024, 1024)])
    cos, sin = rope_embeddings(torch.from_numpy(ids).cuda())
    t = torch.full((1,), 0.7, device="cuda")

    def forward(model):
        with torch.inference_mode():
            out = model(noise, emb, t, cos, sin)
        torch.cuda.synchronize()
        return out

    def timed(model) -> float:
        t0 = time.perf_counter()
        forward(model)
        return time.perf_counter() - t0

    ref = forward(pipe.transformer).float()
    times = {"bf16": timed(pipe.transformer)}
    launches = {}
    for fmt in ("w8a8", "w4a8", "qint8", "int4"):
        t0 = time.perf_counter()
        model = tq.quantize_params(copy.deepcopy(pipe.transformer), fmt)
        torch.cuda.synchronize()
        quant_s = time.perf_counter() - t0
        k7 = fmt in ("qint8", "int4")
        if k7:
            os.environ["FLUX2_PALLAS_DEQUANT"] = "1"  # this phase only
        try:
            _zero_launches()
            out = forward(model).float()
            counts = _launch_counts()
            times[fmt] = timed(model)
        finally:
            os.environ.pop("FLUX2_PALLAS_DEQUANT", None)
        want = {name: 0 for name in counts}
        want["flash"] = 25
        want[COUNTER[fmt]] = FORWARD_LAUNCHES[fmt]
        if fmt in PROLOGUE_FORMATS:
            want["quantize_rows"] = FORWARD_LAUNCHES[fmt]
        if counts != want:
            raise AssertionError(f"{fmt} forward launched {counts}, want {want}")
        rel = float((out - ref).norm() / ref.norm())
        if not torch.isfinite(out).all() or rel > QUANT_DIT_REL_TOL[fmt]:
            raise AssertionError(f"{fmt} DiT vs bf16: relative L2 {rel} > {QUANT_DIT_REL_TOL[fmt]}")
        log(f"[model] Klein-4B DiT forward at 1024^2, {fmt}{' (FLUX2_PALLAS_DEQUANT=1)' if k7 else ''} vs bf16: "
            f"relative L2 {rel:.4e} (tol {QUANT_DIT_REL_TOL[fmt]}); launches {counts}; weights "
            f"{tq.param_bytes(model) / 2**30:.2f} GiB vs {tq.param_bytes(pipe.transformer) / 2**30:.2f} GiB; "
            f"quantized on the card in {quant_s:.2f} s [{card}]")
        launches[fmt] = counts[COUNTER[fmt]]
        del model
        torch.cuda.empty_cache()
    log("[model] 1024^2 DiT step (one warm forward, bs=1): "
        + ", ".join(f"{fmt} {sec:.4f} s" for fmt, sec in times.items()) + f" [{card}]")
    return launches


def build_pipeline():
    """Full-width Klein-4B DiT + FLUX.2 VAE + Qwen3-4B encoder, random, bf16, drawn on the card."""
    from flux2_tpu_torch.models.text_encoders.decoder import Qwen3Decoder
    from flux2_tpu_torch.models.text_encoders.extractor import QWEN3_4B, qwen3_extractor
    from flux2_tpu_torch.pipeline.pipeline import Flux2Model, Flux2Pipeline
    from flux2_tpu_torch.utils import inline_bpe_tokenizer

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    pipe = Flux2Pipeline.from_random(Flux2Model.KLEIN_4B, device="cuda", generator=gen)
    tokenizer = inline_bpe_tokenizer()
    pipe.text_encoder = qwen3_extractor(Qwen3Decoder(QWEN3_4B, device="cuda", generator=gen), tokenizer)
    torch.cuda.synchronize()
    return pipe, type(tokenizer).__name__


def phase_vae_decode(pipe, card: str) -> dict:
    """The 1024^2 decode as the pipeline runs it (its VAE's parameters cast to
    vae_compute_dtype, bf16, as JAX's pipeline casts them): the first decode
    in the process (cuDNN's set-up and the cast copy included), then three
    warm ones; uint8 [1, 1024, 1024, 3] out."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    latents = torch.randn(1, 4096, 128, device="cuda", generator=gen)
    times = []
    for _ in range(4):
        t0 = time.perf_counter()
        img = pipe.decode_latents_u8(latents, 1024, 1024)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    if tuple(img.shape) != (1, 1024, 1024, 3) or img.dtype != torch.uint8 or int(img.max()) == int(img.min()):
        raise AssertionError(f"decode gave {tuple(img.shape)} {img.dtype}, range {int(img.min())}..{int(img.max())}")
    warm = statistics.median(times[1:])
    log(f"[vae] 1024^2 decode, VAE in {pipe.vae_compute_dtype} (cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}): "
        f"first {times[0]:.4f} s, warm {warm:.4f} s (median of {[round(t, 4) for t in times[1:]]}) [{card}]")
    return {"cold_s": times[0], "warm_s": warm}


def phase_cfg_serve(pipe, card: str) -> dict:
    """One klein-4b-base 1024^2 request through Flux2Server on the same
    weights: classical CFG runs cond and uncond (the encoded "" prompt) as two
    batch rows of one forward, so K1 launches 25 blocks x 4 steps = 100 times,
    each over both rows."""
    import dataclasses

    from flux2_tpu_torch.io.png import decode_png
    from flux2_tpu_torch.pipeline.pipeline import Flux2Model
    from flux2_tpu_torch.serve import Flux2Server

    base = dataclasses.replace(pipe, model=Flux2Model.KLEIN_4B_BASE)
    recorder = _RecordingPipeline(base)
    server = Flux2Server(recorder, embeddings_fn=base.encode_prompt, batch_window_s=0.5)
    req = {"prompt": "a lighthouse on a cliff at dusk (base, CFG)", "height": 1024, "width": 1024, "steps": 4,
           "seed": 3}
    try:
        _zero_launches()
        t0 = time.perf_counter()
        png = server.generate_png(req)
        wall = time.perf_counter() - t0
        counts = _launch_counts()
    finally:
        server.shutdown()
    img = decode_png(png)
    if img.shape != (1024, 1024, 3) or int(img.max()) == int(img.min()):
        raise AssertionError(f"CFG request: PNG {img.shape}, range {int(img.min())}..{int(img.max())}")
    (res,) = recorder.results
    if tuple(res.latents.shape) != (1, 4096, 128) or not torch.isfinite(res.latents).all():
        raise AssertionError(f"CFG request: latents {tuple(res.latents.shape)}, finite "
                             f"{bool(torch.isfinite(res.latents).all())}")
    want = {name: 0 for name in counts}
    want["flash"] = 25 * 4
    if counts != want:
        raise AssertionError(f"CFG request launched {counts}, want {want}")
    if "" not in base._prompt_cache:
        raise AssertionError('CFG request: the "" negative was not encoded through the prompt LRU')
    (r,) = server.request_timings
    log(f"[serve cfg] klein-4b-base 1024^2, guidance {base.model.default_guidance}, cond + uncond rows: "
        f"{wall:.3f} s wall; text encoding {r['text_encoding_s']:.4f} s, denoising "
        f"{r['denoising_s'] / r['steps']:.4f} s/step, VAE decoding {r['vae_decoding_s']:.4f} s; launches {counts} "
        f"[{card}]")
    return {"wall_s": wall, "s_per_step": r["denoising_s"] / r["steps"]}


def phase_model_check(pipe, card: str) -> None:
    """The encoder's output, and one full-width DiT forward at 256^2 with the
    kernel against the same forward on the plain attention path."""
    from flux2_tpu_torch.ops import latents as lu
    from flux2_tpu_torch.ops.rope import rope_embeddings
    import numpy as np

    emb = pipe.text_encoder("a check of the encoder")
    if tuple(emb.shape) != (1, 512, 7680) or not torch.isfinite(emb).all():
        raise AssertionError(f"encoder output {tuple(emb.shape)} finite={bool(torch.isfinite(emb).all())}")
    noise = lu.seeded_noise_seq(SEED, 256, 256, 1, device="cuda")
    ids = np.concatenate([lu.text_position_ids(512), lu.image_position_ids(256, 256)])
    cos, sin = rope_embeddings(torch.from_numpy(ids).cuda())
    t = torch.full((1,), 0.7, device="cuda")
    with torch.inference_mode():
        v_kernel = pipe.transformer(noise.bfloat16(), emb, t, cos, sin).float()
        os.environ["FLUX2_DISABLE_FLASH"] = "1"
        try:
            v_plain = pipe.transformer(noise.bfloat16(), emb, t, cos, sin).float()
        finally:
            del os.environ["FLUX2_DISABLE_FLASH"]
    rel = float((v_kernel - v_plain).norm() / v_plain.norm())
    if not torch.isfinite(v_kernel).all() or rel > DIT_REL_TOL:
        raise AssertionError(f"DiT with K1 vs plain attention: relative L2 {rel} > {DIT_REL_TOL}")
    log(f"[model] encoder [1, 512, 7680] finite; Klein-4B DiT forward at 256^2, K1 vs plain attention: "
        f"relative L2 error {rel:.3e} (tol {DIT_REL_TOL}) [{card}]")


# The training step at 512^2 on the kernels against the same step on the plain
# attention path (FLUX2_DISABLE_FLASH=1), same LoRA, batch, sigmas and noise:
# both run 25 blocks of bf16 math and differ only in attention's roundings, as
# the forward check above (DIT_REL_TOL); the loss is a mean over 131,072
# squared errors, so its limit is tighter.
TRAIN_LOSS_REL_TOL = 1e-2
TRAIN_GRAD_REL_TOL = 5e-2
# Flash launches of one train step (one micro-batch) under remat=True: each of
# the 25 blocks runs its attention once with grad (K2), again when
# torch.utils.checkpoint (non-reentrant) recomputes the block in the backward
# (K2), and its backward once (K3, then K4); nothing runs without grad (K1).
STEP_LAUNCHES = {"flash": 0, "flash_lse": 50, "flash_bwd_dq": 25, "flash_bwd_dkv": 25}


def _klein_train_inputs(gen, size: int):
    """Latents [1, S_img, 128], embeddings [1, 32, 7680], sigmas, noise and the RoPE of [txt ; img] on the card."""
    import numpy as np

    from flux2_tpu_torch.ops import latents as lu
    from flux2_tpu_torch.ops.rope import rope_embeddings

    s_img = (size // 16) ** 2
    latents = torch.randn(1, s_img, 128, device="cuda", generator=gen)
    emb = torch.randn(1, 32, 7680, device="cuda", generator=gen)
    noise = torch.randn(1, s_img, 128, device="cuda", generator=gen)
    ids = np.concatenate([lu.text_position_ids(32), lu.image_position_ids(size, size)])
    cos, sin = rope_embeddings(torch.from_numpy(ids).cuda())
    return latents, emb, torch.tensor([0.6], device="cuda"), noise, cos, sin


def phase_train_grad_check(card: str) -> None:
    """One full-width Klein-4B-base train step (loss + backward, remat) at 512^2
    on K2/K3/K4 against the same step with FLUX2_DISABLE_FLASH=1."""
    from flux2_tpu_torch.models.flux2.transformer import Flux2Transformer
    from flux2_tpu_torch.pipeline.pipeline import Flux2Model
    from flux2_tpu_torch.training import lora as lora_mod
    from flux2_tpu_torch.training import trainer

    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    model = Flux2Transformer(Flux2Model.KLEIN_4B_BASE.transformer_config, device="cuda", generator=gen)
    lora = lora_mod.init_lora(model, lora_mod.LoRAConfig(16, 16.0), gen)
    with torch.no_grad():  # b != 0, so that every adapter leaf (a too) has a gradient to compare
        for name, p in lora.named_parameters():
            if name.endswith(".b"):
                p.normal_(generator=gen).mul_(1e-2)
    tcfg = trainer.TrainConfig(rank=16, alpha=16.0, remat=True)
    latents, emb, sigmas, noise, cos, sin = _klein_train_inputs(gen, 512)

    def run():
        for p in lora.parameters():
            p.grad = None
        loss = trainer.flow_matching_loss(model, lora, tcfg, latents, emb, noise, sigmas, cos, sin)
        loss.backward()
        torch.cuda.synchronize()
        return float(loss.detach()), {n: p.grad.detach().clone() for n, p in lora.named_parameters()}

    _zero_launches()
    t0 = time.perf_counter()
    loss_k, grads_k = run()
    sec = time.perf_counter() - t0
    counts = _launch_counts()
    os.environ["FLUX2_DISABLE_FLASH"] = "1"
    try:
        loss_p, grads_p = run()
    finally:
        del os.environ["FLUX2_DISABLE_FLASH"]
    if counts != {name: STEP_LAUNCHES.get(name, 0) for name in counts} or _launch_counts() != counts:
        raise AssertionError(f"train step launched {counts} (then {_launch_counts()} after the plain step), "
                             f"want {STEP_LAUNCHES}")
    leaves = {}  # per stacked leaf, as JAX's: "double_blocks.to_q.a" over the blocks
    for name in grads_k:
        group, _, leaf, ab = name.split(".")
        leaves.setdefault(f"{group}.{leaf}.{ab}", []).append(name)
    diff = sum(float((grads_k[n] - grads_p[n]).square().sum()) for n in grads_k)
    ref = sum(float(grads_p[n].square().sum()) for n in grads_p)
    rel_grad = (diff / ref) ** 0.5
    per_leaf = {}
    for leaf, names in leaves.items():
        d = sum(float((grads_k[n] - grads_p[n]).square().sum()) for n in names)
        r = sum(float(grads_p[n].square().sum()) for n in names)
        per_leaf[leaf] = (d / r) ** 0.5
    worst = max(per_leaf, key=per_leaf.get)
    rel_loss = abs(loss_k - loss_p) / abs(loss_p)
    finite = all(bool(torch.isfinite(g).all()) for g in grads_k.values()) and loss_k == loss_k
    if not finite or rel_loss > TRAIN_LOSS_REL_TOL or rel_grad > TRAIN_GRAD_REL_TOL:
        raise AssertionError(f"train step on the kernels vs plain attention: loss {loss_k} vs {loss_p} (relative "
                             f"{rel_loss}, tol {TRAIN_LOSS_REL_TOL}), LoRA gradient relative L2 {rel_grad} (tol "
                             f"{TRAIN_GRAD_REL_TOL}), finite={finite}")
    log(f"[train] Klein-4B-base train step at 512^2 (1056 tokens, remat), K2/K3/K4 vs plain attention: loss "
        f"{loss_k:.6f} vs {loss_p:.6f} (relative {rel_loss:.3e}, tol {TRAIN_LOSS_REL_TOL}); LoRA gradient relative "
        f"L2 {rel_grad:.3e} (tol {TRAIN_GRAD_REL_TOL}), worst leaf {worst} {per_leaf[worst]:.3e}; launches "
        f"{counts}; first step {sec:.3f} s [{card}]")
    del model, lora, grads_k, grads_p
    torch.cuda.empty_cache()


def _jax_lora_shapes(rank: int) -> dict:
    """JAX's flattened LoRA names and stacked shapes for Klein-4B, attention_ffn targets."""
    from flux2_tpu_torch.pipeline.pipeline import Flux2Model
    from flux2_tpu_torch.training.lora import DEFAULT_TARGETS

    c = Flux2Model.KLEIN_4B_BASE.transformer_config
    d, mlp = c.inner_dim, c.mlp_hidden_dim
    dims = {"ff_in": (d, 2 * mlp), "ff_ctx_in": (d, 2 * mlp), "ff_out": (mlp, d), "ff_ctx_out": (mlp, d),
            "mlp_gate": (d, mlp), "mlp_up": (d, mlp), "out_mlp": (mlp, d)}
    out = {}
    for group, leaf in DEFAULT_TARGETS:
        n = c.num_layers if group == "double_blocks" else c.num_single_layers
        d_in, d_out = dims.get(leaf, (d, d))
        out[f"{group}.{leaf}.a"] = (n, d_in, rank)
        out[f"{group}.{leaf}.b"] = (n, rank, d_out)
    return out


TRAIN_YAML = """model: {{name: klein-4b}}
lora: {{rank: 16, alpha: 16, target_layers: attention_ffn}}
dataset: {{image_size: {size}}}
training: {{optimizer: adamw, learning_rate: 1.0e-4, warmup_steps: 0, lr_scheduler: constant, batch_size: 1,
  max_steps: {steps}, log_every: 1}}
memory: {{gradient_checkpointing: true}}
checkpoints: {{output: {out}, save_every: {save_every}}}
"""


def phase_train_cli(card: str, workdir: str, size: int, steps: int, save_every: int) -> dict:
    """``train-lora --random-init`` through the port's CLI (argument parser and
    run_training, in this process) at full Klein-4B-base width; checks every
    loss, the gradient norms, the launch counts and the checkpoint."""
    import numpy as np

    from flux2_tpu_torch.cli.main import parse_args
    from flux2_tpu_torch.cli.train import run_training

    out = os.path.join(workdir, f"lora_{size}")
    cfg_path = os.path.join(workdir, f"train_{size}.yaml")
    with open(cfg_path, "w") as f:
        f.write(TRAIN_YAML.format(size=size, steps=steps, out=out, save_every=save_every))
    args = parse_args(["train-lora", "--config", cfg_path, "--random-init", "--device", "cuda"])
    torch.cuda.reset_peak_memory_stats()
    _zero_launches()  # count the training path's launches only
    t0 = time.perf_counter()
    history = run_training(args, "cuda")
    wall = time.perf_counter() - t0
    counts = _launch_counts()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30

    if [r["step"] for r in history] != list(range(1, steps + 1)):
        raise AssertionError(f"{size}^2 training ran steps {[r['step'] for r in history]}, want 1..{steps}")
    if not all(np.isfinite(r["loss"]) and r["grad_norm"] > 0 for r in history):
        raise AssertionError(f"{size}^2 training: a loss is not finite or a gradient norm is 0: {history}")
    want = {name: STEP_LAUNCHES.get(name, 0) * steps for name in counts}
    if counts != want:
        raise AssertionError(f"{size}^2 training launched {counts}, want {want} ({steps} steps x {STEP_LAUNCHES})")
    ckpt = os.path.join(out, f"checkpoint_{steps:06d}", "lora.safetensors")
    import safetensors.numpy

    saved = safetensors.numpy.load_file(ckpt)
    shapes = {k: v.shape for k, v in saved.items()}
    if shapes != _jax_lora_shapes(16):
        raise AssertionError(f"{ckpt}: names/shapes {shapes} differ from JAX's {_jax_lora_shapes(16)}")
    zero_b = [k for k, v in saved.items() if k.endswith(".b") and not np.any(v)]
    if zero_b:  # AdamW's first update moves every element with a gradient by ~lr
        raise AssertionError(f"{ckpt}: LoRA b leaves still zero after training: {zero_b}")
    warm = [r["seconds"] for r in history[1:]]
    log(f"[train] train-lora --random-init, Klein-4B-base at {size}^2 ({32 + (size // 16) ** 2} tokens), rank 16, "
        f"AdamW, remat: {steps} steps in {wall:.2f} s (base drawn, steps, checkpoints); losses "
        f"{[round(r['loss'], 5) for r in history]}; grad norms {[round(r['grad_norm'], 5) for r in history]}; "
        f"{statistics.mean(warm):.4f} s/step warm (steps 2-{steps}: {[round(x, 4) for x in warm]}), first step "
        f"{history[0]['seconds']:.3f} s; peak device memory {peak_gib:.2f} GiB; launches {counts}; checkpoint "
        f"{ckpt} has JAX's {len(shapes)} names and shapes, every b leaf non-zero [{card}]")
    return {"counts": counts, "s_per_step": statistics.mean(warm), "peak_gib": peak_gib}


class _RecordingPipeline:
    """Forwards to the pipeline and keeps every generate() result (final latents)."""

    def __init__(self, pipe):
        self._pipe = pipe
        self.results = []

    def __getattr__(self, name):
        return getattr(self._pipe, name)

    def generate(self, **kwargs):
        res = self._pipe.generate(**kwargs)
        self.results.append(res)
        return res


def _concurrent(server, reqs):
    """Send requests from one thread each; return their PNGs, re-raising any failure."""
    pngs, errors = [None] * len(reqs), []

    def send(i):
        try:
            pngs[i] = server.generate_png(reqs[i])
        except BaseException as e:  # re-raised on the main thread below
            errors.append(e)

    threads = [threading.Thread(target=send, args=(i,)) for i in range(len(reqs))]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=600)
    if errors:
        raise errors[0]
    if any(th.is_alive() for th in threads):
        raise TimeoutError("a request did not finish in 600 s")
    return pngs


def phase_serve(pipe, card: str, label: str, expected: dict):
    """Two concurrent 1024^2 requests, then three concurrent 256^2 ones, through
    Flux2Server; ``expected`` holds the launch counts the run must show. The
    prompts name ``label``, so each phase encodes prompts it has not cached."""
    from flux2_tpu_torch.io.png import decode_png
    from flux2_tpu_torch.serve import Flux2Server

    recorder = _RecordingPipeline(pipe)
    server = Flux2Server(recorder, embeddings_fn=pipe.encode_prompt, batch_window_s=2.0)
    big = [{"prompt": f"a lighthouse on a cliff at dusk ({label})", "height": 1024, "width": 1024, "steps": 4,
            "seed": 1},
           {"prompt": f"a bowl of ramen, studio light ({label})", "height": 1024, "width": 1024, "steps": 4,
            "seed": 2}]
    small = [{"prompt": f"a small red fox, variant {i} ({label})", "height": 256, "width": 256, "steps": 4,
              "seed": 10 + i} for i in range(3)]
    torch.cuda.reset_peak_memory_stats()
    try:
        _zero_launches()  # count the served path's launches only
        t0 = time.perf_counter()
        pngs = _concurrent(server, big) + _concurrent(server, small)
        wall = time.perf_counter() - t0
        counts = _launch_counts()
    finally:
        server.shutdown()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30

    for req, png in zip(big + small, pngs):
        img = decode_png(png)
        if img.shape != (req["height"], req["width"], 3):
            raise AssertionError(f"PNG {img.shape} for a {req['height']}x{req['width']} request")
        if int(img.max()) == int(img.min()):
            raise AssertionError("constant image")
    for res in recorder.results:
        if not torch.isfinite(res.latents).all():
            raise AssertionError("non-finite final latents")
    if (server.batches_run, server.requests_served) != (3, 5):
        raise AssertionError(f"{server.requests_served} requests in {server.batches_run} batches, want 5 in 3")
    if [len(r.latents) for r in recorder.results] != [1, 1, 3]:
        raise AssertionError(f"batch sizes {[len(r.latents) for r in recorder.results]}, want [1, 1, 3]")
    want = {name: expected.get(name, 0) for name in counts}
    if counts != want:
        raise AssertionError(f"{label} serve launched {counts}, want {want}")
    for r in server.request_timings:
        log(f"[serve {label}] {r['height']}x{r['width']} batch {r['batch_size']}: text encoding "
            f"{r['text_encoding_s']:.4f} s, denoising {r['denoising_s'] / r['steps']:.4f} s/step ({r['steps']} "
            f"steps, whole batch), VAE decoding {r['vae_decoding_s']:.4f} s [{card}]")
    log(f"[serve {label}] 5 requests in 3 batches, {wall:.3f} s wall; launches {counts}; peak device memory "
        f"{peak_gib:.2f} GiB [{card}]")
    return counts, peak_gib


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA device; torch.cuda.is_available() is False")
    from flux2_tpu_torch.utils.build import build_kernels

    card = nvidia_smi_line()
    log(f"[device] {card}; {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, Python {sys.version.split()[0]}")

    build = build_kernels()
    log(f"[build] {build.path.name}: {build.seconds:.2f} s (0 = already built)")
    for line in build.log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log(f"[build] {line.strip()}")

    checks = phase_kernel_check(card)
    grad_checks = phase_flash_grad_check(card)
    qchecks = phase_quant_kernel_check(card)

    t0 = time.perf_counter()
    pipe, tok_name = build_pipeline()
    log(f"[model] random Klein-4B DiT + FLUX.2 VAE + Qwen3-4B encoder (tokenizer {tok_name}) drawn on the card "
        f"in {time.perf_counter() - t0:.2f} s; {torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated [{card}]")
    decode = phase_vae_decode(pipe, card)
    phase_model_check(pipe, card)
    model_launches = phase_quant_model_check(pipe, card)

    flash_launches = 25 * 4 * 3
    counts, bf16_peak = phase_serve(pipe, card, "bf16", {"flash": flash_launches})
    phase_cfg_serve(pipe, card)
    del pipe
    torch.cuda.empty_cache()

    from flux2_tpu_torch.cli.main import build_pipeline as cli_build_pipeline

    t0 = time.perf_counter()
    args = argparse.Namespace(model="klein-4b", quantization="w8a8", encoder_quantization="w8a8", random_init=True)
    qpipe = cli_build_pipeline(args, "cuda", torch.Generator(device="cuda").manual_seed(SEED))
    torch.cuda.synchronize()
    log(f"[model] w8a8 Klein-4B DiT + VAE + w8a8 Qwen3-4B encoder built by cli.main.build_pipeline in "
        f"{time.perf_counter() - t0:.2f} s; {torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated [{card}]")
    w8a8_launches = FORWARD_LAUNCHES["w8a8"] * 4 * 3 + ENCODE_LAUNCHES_W8A8 * 5
    qcounts, w8a8_peak = phase_serve(qpipe, card, "w8a8", {"flash": flash_launches, "w8a8": w8a8_launches,
                                                           "quantize_rows": w8a8_launches})
    log(f"[serve] peak device memory: w8a8 {w8a8_peak:.2f} GiB vs bf16 {bf16_peak:.2f} GiB [{card}]")
    del qpipe
    torch.cuda.empty_cache()

    phase_train_grad_check(card)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as workdir:
        train = phase_train_cli(card, workdir, size=512, steps=5, save_every=5)
        train_1024 = phase_train_cli(card, workdir, size=1024, steps=2, save_every=0)
    log(f"[train] s/step warm: 512^2 {train['s_per_step']:.4f} s, 1024^2 {train_1024['s_per_step']:.4f} s; peak "
        f"device memory 512^2 {train['peak_gib']:.2f} GiB, 1024^2 {train_1024['peak_gib']:.2f} GiB [{card}]")

    # Each kernel at the main path's shape ((1, 24, 4608, 128) for K1-K4, the
    # 1024^2 image projections (4096, 3072, 3072) for K5-K7): "ms" is the kernel
    # alone (torch.profiler), "wrapper_ms" the wrapper around it (CUDA events);
    # "launches" counts the main path's run, "launches_per_unit" one unit of it.
    k1 = checks["klein4b_1024px"]
    kernels = [{
        "name": "flash_attention_fwd",
        "route": "cuda",
        "source": "flux2_tpu_torch/csrc/flash_attention.cu",
        "replaces": "flux2_tpu/ops/flash_attention.py:84",
        "launches": counts["flash"],
        "launches_per_unit": 25 * 4, "unit": "1024^2 image (25 blocks x 4 steps)",
        "max_abs_err": max(c["err"] for c in checks.values()),
        "ms": k1["alone"], "wrapper_ms": k1["ms"], "plain_ms": k1["plain_ms"],
        "bound_ms": k1["bound"], "bound_by": k1["bound_by"],
        "library": k1["library"], "library_ms": k1["library_ms"],
    }]
    for fmt, name, replaces, launches, per_unit, unit in (
        ("w8a8", "w8a8_matmul", "flux2_tpu/ops/quant_kernels.py:182", qcounts["w8a8"],
         FORWARD_LAUNCHES["w8a8"], f"1024^2 forward (and {ENCODE_LAUNCHES_W8A8} per Qwen3-4B encode)"),
        ("w4a8", "w4a8_matmul", "flux2_tpu/ops/quant_kernels.py:282", model_launches["w4a8"],
         FORWARD_LAUNCHES["w4a8"], "1024^2 forward"),
        ("qint8", "dequant_matmul_int8", "flux2_tpu/ops/quant_kernels.py:41", model_launches["qint8"],
         FORWARD_LAUNCHES["qint8"], "1024^2 forward (FLUX2_PALLAS_DEQUANT=1)"),
        ("int4", "dequant_matmul_int4", "flux2_tpu/ops/quant_kernels.py:66", model_launches["int4"],
         FORWARD_LAUNCHES["int4"], "1024^2 forward (FLUX2_PALLAS_DEQUANT=1)"),
    ):
        rows = qchecks[fmt]
        first = rows[0]  # image_qkvo_1024
        entry = {"name": name, "route": "cuda", "source": "flux2_tpu_torch/csrc/quant_matmul.cu",
                 "replaces": replaces, "launches": launches, "launches_per_unit": per_unit, "unit": unit,
                 "max_abs_err": max(r["err"] for r in rows), "ms": first["alone"], "events_ms": first["events"],
                 "wrapper_ms": first["ms"], "plain_ms": first["plain_ms"], "bound_ms": first["bound"][0],
                 "bound_by": first["bound"][1], "library": first["library"], "library_ms": first["library_ms"]}
        if "route_ms" in first:
            entry["dequantize_then_linear_ms"] = first["route_ms"]
        kernels.append(entry)
    # K5's and K6's activation prologue at K5's main shape (block = K = 3072);
    # launches from the w8a8 serving run (one before each K5 launch).
    pro = qchecks["prologue"][("image_qkvo_1024", 3072)]
    kernels.append({"name": "quantize_activations", "route": "cuda", "source": "flux2_tpu_torch/csrc/quant_prologue.cu",
                    "replaces": "flux2_tpu/ops/quant_kernels.py:235",
                    "note": "the XLA prologue of w8a8_matmul (and of w4a8_matmul at :342), not a Pallas kernel",
                    "launches": qcounts["quantize_rows"], "launches_per_unit": FORWARD_LAUNCHES["w8a8"],
                    "unit": "1024^2 w8a8 forward (and one per K6 launch under w4a8)",
                    "max_abs_err": max(r["err"] for r in qchecks["prologue"].values()), "ms": pro["alone"],
                    "wrapper_ms": pro["ms"], "plain_ms": pro["plain_ms"], "bound_ms": pro["bound"][0],
                    "bound_by": pro["bound"][1], "library": None, "library_ms": None})
    # K2 vs the plain f32 forward with LSE; K3 and K4 vs the plain f32 backward,
    # which computes dq, dk and dv at once, as does their library call. Launches
    # from the 512^2 training run.
    big = grad_checks["klein4b_1024px"]
    for name, source, replaces, counter, mark, errs, key, lib in (
        ("flash_attention_fwd_lse", "flash_attention.cu", ":73", "flash_lse", "flash_fwd_lse_kernel", ("out", "lse"),
         "k2", "k2"),
        ("flash_attention_bwd_dq", "flash_attention_bwd.cu", ":313", "flash_bwd_dq", "flash_bwd_dq_kernel", ("dq",),
         "k3", "k34"),
        ("flash_attention_bwd_dkv", "flash_attention_bwd.cu", ":363", "flash_bwd_dkv", "flash_bwd_dkv_kernel",
         ("dk", "dv"), "k4", "k34"),
    ):
        kernels.append({"name": name, "route": "cuda", "source": f"flux2_tpu_torch/csrc/{source}",
                        "replaces": f"flux2_tpu/ops/flash_attention.py{replaces}", "launches": train["counts"][counter],
                        "launches_per_unit": STEP_LAUNCHES[counter], "unit": "train step (remat)",
                        "max_abs_err": max(r["max_abs"][e] for r in grad_checks.values() for e in errs),
                        "ms": big["alone"][mark], "wrapper_ms": big["fwd_ms"] if key == "k2" else big["bwd_ms"],
                        "plain_ms": big["fwd_plain_ms"] if key == "k2" else big["bwd_plain_ms"],
                        "bound_ms": big["bounds"][key][0], "bound_by": big["bounds"][key][1],
                        "library": big["library"][lib][0], "library_ms": big["library"][lib][1]})
    log(f"[vae] 1024^2 decode: first {decode['cold_s']:.4f} s, warm {decode['warm_s']:.4f} s [{card}]")
    log(json.dumps({"kernels": kernels}))
    log(card)
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
