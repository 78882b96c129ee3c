"""Chip smoke test of the PyTorch port (flux2_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from the sources in this checkout (into
build/kernels/, one nvcc per source, all at once) and checks each against its
plain PyTorch version on the card: K1 (flash attention), K2 / K3 / K4 (the
flash forward with the row LSE, and the dQ and dK/dV backward) at the training
shapes, K5 / K6 / K7 (the W8A8, W4A8 and grouped int8/int4 quantized
matmuls) and the int8 activation prologue of K5 and K6 (equal to the plain
torch chain to the bit); K1 also at the I2I slice's shapes (S = 8704, the KV
extract pass's blocked span, 4608 queries over 8704 keys); the DiT's fused
glue G1 (adaln_modulate) and G2 (qkv_heads) through their wrappers at every
shape of a Klein-4B forward against the chain, timed at the single block's
beside their byte bounds; every no-grad Klein-4B forward below on a bf16
stream launches them 41 and 30 times (Klein-9B 57 and 40), which the
serving, I2I, KV and editing phases check beside K1; K1's device time and
cycles (the SM clock sampled) inside full-width Klein-4B and Klein-9B
forwards on the fused route and on the chain, and alone. Then, with random
weights drawn on the card from a seed, at full
Klein-4B width: the 1024^2 VAE decode (first and warm), one DiT forward per
quantized runtime against the bf16 forward, bf16 serving through the port's
entry point (Flux2Server -> Qwen3-4B encoder -> DiT -> VAE), one
klein-4b-base request with classical CFG, I2I on the same pipeline (the
1024^2 reference's VAE encode, TF32 on against off; one 1024^2 I2I image;
strength 0.5; two I2I requests through Flux2Server with base64 PNG
references), w8a8 serving through the CLI's
build_pipeline (DiT and encoder quantized), one Klein-4B-base train step at
512^2 on the kernels against the same step on plain attention, LoRA
training through the CLI (train-lora --random-init: 5 steps at 512^2 with a
checkpoint, then 2 steps at 1024^2), `i2i --model klein-9b-kv --random-init`
through cli.main at full Klein-9B width (the cached velocity against the
extract velocity, the cache's size, KV s/step against uncached), and a
checkpoint round trip: Klein-4B,
the VAE and Qwen3-4B at its published shape (Qwen/Qwen3-4B's config.json)
serve one 1024^2 request in memory, are written as checkpoint directories
(the DiT in the Diffusers dialect, sharded) and read back by `t2i` through
cli.main (latents and PNG equal to the bit), then `profile --compare
bf16,w8a8` and `profile --trace` run on them. The editing slice (phase_edit,
on the bf16 Klein-4B pipeline): RePaint inpainting at 1024^2 in the process
and through `inpaint` (also with the image as reference at strength 0.5,
and crop-and-stitch), `outpaint` 768^2 -> 1024^2, the per-step callbacks,
checkpoint images, a cancel, the 2048^2 decode dense and tiled and `t2i
--memory-profile conservative` at 2048^2, `t2i --small-decoder`,
`auto_profile` on this card and a served request with a preview id; on
klein-9b-kv, the RePaint hook as the identity. The serving slice (phase_http,
phase_mask, on the same pipeline): the port's HTTP handler over Flux2Server on
127.0.0.1 (every route and error; /generate at 1024^2 equal to the in-process
generate to the bit, a 256^2 batch of three, previews, /embed equal to
encode_prompt, cancel_all mid-batch), `python -m flux2_tpu_torch.serve
--random-init --quantization w8a8 --precompile 256` in a process of its own,
then `mask-subject` on a 1024^2 synthetic composite (the committed U-Net on
the card against the CPU) and `inpaint` with that mask. The LoRA / prequantized
slice (phase_lora_prequant, on the checkpoint phase's directories): a rank-16
LoRA written from a seed in both key dialects with a Turbo sidecar, `t2i
--lora` (2 steps, K1 50, equal to an in-process merge and generate to the bit,
the two dialects merging to the same bits, merged vs unmerged velocity),
`export-quantized` qint8 with the LoRA baked and int4, `t2i` w8a8 / w4a8 from
those files (K5 206 / K6 205 a forward; the w8a8 DiT equal to an in-memory
qint8 -> w8a8 to the bit), `FLUX2_PALLAS_DEQUANT=1 t2i --quantization qint8
--lora` (the QTensor merge, K7 202 a forward), `--dequantize-runtime`, and
QLoRA steps through the library on a w8a8 and a qint8 Klein-4B base (K5 406 /
K7 402 a step, the kernels' input gradient against the plain route). The real-data training slice
(phase_train_real, on the same directories and a dataset written from a seed: six PNGs in two aspect
ratios, [trigger] captions, control images for two, a two-item held-out set): `train-lora
--random-init` on the dataset at 512^2 (control images, caption and control dropout, DOP every 2
steps, EMA, both disk caches, previews at steps 0/2/4 with the pixel scorer and best/, the held-out
loss; the cached latents equal to direct encodes to the bit, the base's bytes unchanged) and its
--resume from step 2 (both caches hit, the uninterrupted run's LoRA to the bit); `train-lora` from the
checkpoints with --quantization w8a8 and qint8 (QLoRA from the CLI, the first step's loss against the
kernel's plain version); remat "dots" against True at 1024^2 (s/step, peak memory, step 1's loss and
gradient); `evaluate-lora --no-vlm` (JAX's JSON keys). The Dev / text-generation slice (phase_dev,
last, once every Klein pipeline is freed): K1 at Dev's (1, 48, 4608, 128); K5, K6 and the prologue at
Mistral's projections as a decode token (M = 1), a 37-token prefill and a 512-token encode, equal to
their plain versions to the bit, with their bounds and a dense bf16 F.linear; Mistral Small 3.2 at the
published width (40 layers, intermediate 32768) random on the card with the byte-fallback Tekken
tokenizer: two prompts encoded to [1, 512, 15360], prefill + 16 decode_steps against forward_logits,
upsample_prompt and chat (32 tokens, streamed), then w8a8 in place (the encode against bf16, a greedy
decode at exactly 280 K5 launches a token); the Dev DiT at full width in bf16 (a 1024^2 forward on K1
against plain attention, a 4-step 1024^2 generate from the Mistral embeddings: 224 K1 launches); and
`t2i --model dev --random-init --quantization w8a8 --encoder-quantization w8a8 --steps 2 --upsample`
in a process of its own (the PNG, the "[upsample] final prompt:" line, exact K1 and K5 counts). /chat
answers 200 on the random-init server (phase_http). The VLM slice (phase_vlm, after phase_dev, while
the checkpoint phase's Klein-4B directories still exist): A, Mistral Small 3.2 at the published width
with Pixtral at its built-in width, random on the card: the tower and projector on a 1008^2 image (1296
image tokens), two images' prefill logits apart, a 1024^2 image refused (73 x 73 patches: an odd grid),
a greedy 32-token analyze_image in bf16 and with the LM at w8a8 (exactly 280 K5 and prologue launches a
pass); B, the built-in Qwen3.5 (32 layers) with its vision tower at out_hidden_size 2048 on a 1024^2
image: prefill, a decode step and chat tokens/s, prefill + 16 steps against forward_logits, the
chunked Gated DeltaNet against the sequential recurrence in f32 at S = 1024 (also under strong decay,
where JAX's chunked form gives NaN), compare_images_for_flux and score_validation_image; C, a random
Qwen3.5-VL checkpoint at full width (depth cut to 4 LM layers and 2 vision blocks) under the registry's
qwen35-vlm path, then `t2i --interpret`, `i2i --upsample`, `flux-encoders vision --image` / `--image2`,
`inpaint --enrich-prompt-with-vlm --intent remove` and `evaluate-lora` (VLM scoring) from the Klein-4B
directories, each with its VLM replies in use. The parallel slice (phase_parallel, on the bf16 Klein-4B
pipeline after phase_mask, on a one-rank NCCL mesh: the card's machine has one GPU): C, a w8a8 and a
w4a8 copy of the DiT sharded by `shard_params` (every partitioned K5 / K6 call equal to the unsharded
one to the bit, 206 / 205 a forward); B, `Flux2Pipeline.shard(context_parallel=True)`, which on a mesh
of one rank leaves the weights plain (K2 100, K1 none, each ring output equal to its K2 output to the
bit); A, the DiT's weights made DTensors by `shard_params`, the path a larger mesh runs (the 1024^2
4-step image's latents against the unsharded run's, K1 100, the host s/step of both), and the ring on
it; the flash ring at (1, 24, 4608, 128) against the einsum ring and its backward against dense
autograd; Qwen3-4B's decoder sharded by `shard_params` (embeddings to the bit); D, `t2i --random-init`
at 512^2 under `--shard 1,1,1`, `auto`, `1,1,1,1 --context-parallel` and `1,1,1 --dcn`, and `serve
--tp 2`, which exits naming the device count. The pipeline-parallel slice (phase_pp, after
phase_parallel on its one-rank NCCL mesh: a pipeline of more stages needs more GPUs): a full-width
Klein-4B-base train step at 512^2, batch 2, through `make_pp_forward(pp = 1, 2 microbatches)` against
the dense step (K2 100, K3 = K4 = 50 against 50 / 25 / 25; loss 1e-2, LoRA gradient 5e-2), a held-out
pass through the pipeline (K1 50), the warm s/step of both, and QLoRA on a w8a8 copy (K5 = prologue =
806); phase_pp_cli, after phase_train_real on its dataset: `train-lora --shard 1,1,1,1` from the
checkpoint directories equal to the bit to the run without it, and `pp: 2` / `pp: 5` on one GPU
exiting with JAX's texts. The last slice: phase_encoder_tp (after phase_pp, on the same one-rank NCCL
mesh): Qwen3-4B at its published shape in bf16, w8a8 and w4a8, a 512-token prefill and 16 greedy tokens
through `generation.generate`, unsharded and with its weights made DTensors by `shard_params` (the
same tokens, every pass's logits equal to the bit, K5 = prologue or K6 = 252 a pass, s/token of both;
every K5 / K6 call of one sharded prefill and step, at Qwen3-4B's projection shapes, equal to its plain
version to the bit),
then `TextEncoders.chat` and `upsample_prompt` after `TextEncoders.shard` against the unsharded text;
phase_segmenter_train: `tools.train_segmenter` for 100 steps at 256^2, batch 16 (step 1's loss
against the CPU, the loss falling, the file read back to the bit); phase_fidelity: `tools.fidelity_gate
--random-init --models klein-4b --quantizations bf16,w8a8,w4a8 --mire` (the fixture rows missing their
reference, each mire row a full-width Klein-4B I2I at 512x768: K1 25, K5 = prologue 206 or K6 205).
Every path runs with the launch
counts set to 0 just before it and checks them just after. Any failure raises: the
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
function, timed as a yardstick that the port never calls; K1's entry also
gives its launches per I2I and klein-9b-kv image and on the editing paths,
and its times and bounds at the slices' four shapes (S = 8704, the blocked
span, 4608 x 8704, and outpainting's S = 6912).
"""

from __future__ import annotations

import argparse
import json
import math
import os
import re
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
KLEIN_4B_BLOCKS, KLEIN_9B_BLOCKS = (5, 20), (8, 24)  # double, single
# G1 and G2 timed at the Klein-4B single block's 1024^2 shape: [txt ; img] tokens, 24 heads x 128.
GLUE_SHAPE = (1, 512 + 4096, 24)
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


def library_sdpa(q, k, v, card: str, attn_mask=None) -> tuple:
    """The fastest of F.scaled_dot_product_attention's flash and cuDNN backends
    (with a boolean ``attn_mask``: its memory-efficient and cuDNN ones) on the
    same inputs: (name, ms); timed as a yardstick, the port never calls it."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    best = ("F.scaled_dot_product_attention", None)
    backends = ((SDPBackend.FLASH_ATTENTION, SDPBackend.CUDNN_ATTENTION) if attn_mask is None
                else (SDPBackend.EFFICIENT_ATTENTION, SDPBackend.CUDNN_ATTENTION))
    for backend in backends:
        label = f"F.scaled_dot_product_attention[{backend.name}]" + (" with attn_mask" if attn_mask is not None else "")
        with sdpa_kernel(backend):
            ms = library_time(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=attn_mask), label, card)
        if ms is None:
            continue
        log(f"[library] {label} q={list(q.shape)}: {ms:.4f} ms [{card}]")
        if best[1] is None or ms < best[1]:
            best = (label, ms)
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
    results.update(_k1_slice_check(gen, card))
    return results


# K1 in the I2I slice's regimes, 1024^2 output and one 1024^2 reference:
# Klein-4B I2I attends 512 text + 4096 output + 4096 reference tokens; the
# klein-9b-kv extract pass the same at 32 heads, its reference queries blind
# to the output keys; a cached step 4608 queries over 8704 keys.
K1_SLICE_CASES = [
    ("i2i_klein4b", (1, 24, 8704, 8704), None),
    ("kv_extract", (1, 32, 8704, 8704), (512, 4608, 4608)),
    ("kv_cached", (1, 32, 4608, 8704), None),
    # outpainting a 768^2 image to a 1024^2 canvas: 512 text + 4096 canvas + 2304 reference tokens
    ("outpaint_klein4b", (1, 24, 6912, 6912), None),
]


def _k1_slice_check(gen, card: str) -> dict:
    """K1 at K1_SLICE_CASES against flash_attention_reference (full f32 logits:
    ~20 GB at 32 heads, so the plain version is timed over 3 calls), each with
    the kernel alone, its bound on the query-key pairs the span leaves and the
    bytes of q, k, v and out, and SDPA beside it (with the span's boolean mask
    where there is one)."""
    from flux2_tpu_torch.ops import flash_attention as fa
    from flux2_tpu_torch.utils.profile_step import kernel_time_ms

    results = {}
    for name, (b, h, s_q, s_k), span in K1_SLICE_CASES:
        q = torch.randn(b, h, s_q, 128, device="cuda", generator=gen).bfloat16()
        k = torch.randn(b, h, s_k, 128, device="cuda", generator=gen).bfloat16()
        v = torch.randn(b, h, s_k, 128, device="cuda", generator=gen).bfloat16()
        out = fa.flash_attention(q, k, v, blocked_span=span).float()
        ref = fa.flash_attention_reference(q, k, v, blocked_span=span).float()
        err = float((out - ref).abs().max())
        rel = float((out - ref).norm() / ref.norm())
        del out, ref
        torch.cuda.empty_cache()
        if not rel <= KERNEL_REL_TOL:
            raise AssertionError(f"K1 {name}: relative L2 err {rel} > {KERNEL_REL_TOL} (or non-finite)")
        alone = kernel_time_ms(lambda: fa.flash_attention(q, k, v, blocked_span=span), "flash_fwd_kernel")
        ms = time_ms(lambda: fa.flash_attention(q, k, v, blocked_span=span))
        plain_ms = time_ms(lambda: fa.flash_attention_reference(q, k, v, blocked_span=span), reps=3, warmup=1)
        pairs = s_q * s_k - ((span[1] - span[0]) * (s_k - span[2]) if span else 0)
        flop = 4.0 * b * h * 128 * pairs
        bound, bound_by = bound_ms(flop, attention_bytes(b, h, s_q, s_k, 2, 2, 0), BF16_FLOPS)
        mask = None
        if span is not None:  # True where a query may attend a key
            mask = fa.blocked_span_bias(s_q, s_k, span, "cuda") == 0
        library, library_ms = library_sdpa(q, k, v, card, attn_mask=mask)
        log(f"[kernel] K1 {name} q={[b, h, s_q, 128]} s_k={s_k} span={span}: rel_l2_err={rel} (tol {KERNEL_REL_TOL}) "
            f"max_abs_err={err}; alone {alone:.4f} ms ({flop / alone / 1e9:.1f} TFLOP/s on the {pairs} query-key "
            f"pairs the span leaves), bound {bound:.4f} ms ({bound_by}; {bound / alone:.1%} of it), wrapper "
            f"{ms:.4f} ms, plain f32 {plain_ms:.4f} ms, {library} {library_ms} ms [{card}]")
        results[name] = {"err": err, "ms": ms, "plain_ms": plain_ms, "alone": alone, "bound": bound,
                         "bound_by": bound_by, "library": library, "library_ms": library_ms}
        del q, k, v, mask
        torch.cuda.empty_cache()
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


def _wrapper_launches(kind: str, m: int, k: int, n: int) -> dict:
    """The launch counters one wrapper call of ``kind`` at (M, K, N) bumps: its
    kernel's, the prologue's, and ``w8a8_grouped`` where K5 walks its tiles in
    groups of row bands (``quant_kernels.w8a8_group``)."""
    from flux2_tpu_torch.ops import quant_kernels as qk

    grouped = kind == "w8a8" and qk.w8a8_group(m, n, k, torch.cuda.get_device_properties(0).multi_processor_count) > 1
    return {COUNTER[kind]: 1, **({"quantize_rows": 1} if kind in PROLOGUE_FORMATS else {}),
            **({"w8a8_grouped": 1} if grouped else {})}


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
            if launched != _wrapper_launches(kind, m, k, n):
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


def _bf16_neighbours(y: torch.Tensor) -> list:
    """The bf16 values one step below and one step above each element of y."""
    bits = y.contiguous().view(torch.int16).to(torch.int32) & 0xFFFF
    neg, zero = bits >= 0x8000, (bits & 0x7FFF) == 0
    down = torch.where(zero, 0x8001, torch.where(neg, bits + 1, bits - 1))
    up = torch.where(zero, 0x0001, torch.where(neg, bits - 1, bits + 1))
    return [torch.where(b >= 0x8000, b - 0x10000, b).to(torch.int16).view(torch.bfloat16) for b in (down, up)]


def _glue_against_chain(label: str, out: torch.Tensor, chain: torch.Tensor, others: list) -> tuple:
    """G1 or G2's ``out`` against the chain: every element must equal the
    chain's arithmetic after its first sum-dependent rounding y applied to y
    or to a bf16 neighbour of y (``others``), and at least 99.9% the chain's
    own (tests/test_torch_cuda.py holds the kernels so). (share equal, largest
    difference)."""
    hit = out == chain
    share = float(hit.float().mean())
    for c in others:
        hit |= out == c
    err = float((out.float() - chain.float()).abs().max())
    if not bool(hit.all()) or share < 0.999:
        raise AssertionError(f"[glue] {label}: {int((~hit).sum())} elements off the chain's roundings, "
                             f"{share:.6f} equal to the chain's")
    return share, err


def phase_glue_check(card: str) -> dict:
    """G1 (adaln_modulate) and G2 (qkv_heads, ops/dit_glue.py) through their
    wrappers at every shape a Klein-4B 1024^2 forward gives them, against the
    chain they replace on the same bf16 inputs (``_glue_against_chain``): G1
    on the single block's [txt ; img], each double block stream (512 and 4096
    tokens) and ``_final``'s image slice of a batch of 2 (its batch stride
    4608 rows); G2 on the single block (4608 tokens at 0) and on a double
    block's two streams written into one joint buffer (text at 0, image at
    512) against the chain's concatenation. Then each timed at the single
    block's shape by CUDA events around 50 back-to-back launches of its C entry
    (one wrapper call costs more host time than G1 takes on the card), beside
    its bound (bytes: inputs read once, outputs written once), one wrapper
    call, the chain, and the host's time a call of the wrapper and of its C
    entry. No single PyTorch call computes either."""
    from flux2_tpu_torch.ops import dit_glue
    from flux2_tpu_torch.ops.normalization import layer_norm, modulate, rms_norm
    from flux2_tpu_torch.ops.rope import apply_rope, rope_embeddings, rotate_half_interleaved
    from flux2_tpu_torch.utils.quant_candidate import host_us

    _, s, h = GLUE_SHAPE
    s_txt, d = 512, h * 128
    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)

    def rand(*shape, scale=1.0):
        return (torch.randn(*shape, device="cuda", generator=gen) * scale).bfloat16()

    x2 = rand(2, s, d, scale=2)  # [txt ; img] of a batch of 2
    mod = rand(2, 1, 3, d, scale=0.5)
    shift2, scale2 = mod[:, 0, 0], mod[:, 0, 1]  # rows of the modulation tensor, as the blocks pass them
    x, shift, scale = x2[:1], shift2[:1], scale2[:1]
    q, k, v = (rand(1, s, d, scale=3) for _ in range(3))
    norm_q, norm_k, norm_added_q, norm_added_k = (
        (1 + 0.2 * torch.randn(128, device="cuda", generator=gen)).bfloat16() for _ in range(4))
    cos, sin = rope_embeddings(torch.randint(0, 64, (s, 4), device="cuda", generator=gen))

    def heads(t):
        return t.reshape(t.shape[0], t.shape[1], h, 128).transpose(1, 2).contiguous()

    def g1_plain():
        return modulate(layer_norm(x), shift, scale)

    def g2_plain():  # as a single block runs it on the chain
        return (apply_rope(rms_norm(heads(q), norm_q), cos, sin), apply_rope(rms_norm(heads(k), norm_k), cos, sin),
                heads(v))

    outs = [torch.empty(1, h, s, 128, device="cuda", dtype=torch.bfloat16) for _ in range(3)]

    def g1():
        return dit_glue.adaln_modulate(x, shift, scale)

    def g2():
        dit_glue.qkv_heads(q, k, v, norm_q, norm_k, cos, sin, *outs, 0)
        return outs

    checked = {}
    for label, xs, sh, sc in (("single block [txt ; img]", x, shift, scale),
                              ("double block text", x[:, :s_txt].contiguous(), shift, scale),
                              ("double block image", x[:, s_txt:].contiguous(), shift, scale),
                              ("_final's image slice, batch 2", x2[:, s_txt:], shift2, scale2)):
        before = dit_glue.launch_counts()["adaln_modulate"]
        out = dit_glue.adaln_modulate(xs, sh, sc)
        torch.cuda.synchronize()
        if dit_glue.launch_counts()["adaln_modulate"] != before + 1:
            raise AssertionError(f"[glue] adaln_modulate, {label}: the wrapper did not launch its kernel")
        y = layer_norm(xs)
        checked[f"adaln_modulate, {label}"] = _glue_against_chain(
            f"adaln_modulate, {label}", out, modulate(y, sh, sc), [modulate(n, sh, sc) for n in _bf16_neighbours(y)])

    def g2_against_chain(label, streams, joint):
        """``streams``: (q, k, v, norm_q, norm_k) in joint order; ``joint``: G2's buffers after them."""
        ys = {"q": [], "k": []}
        for sq, sk, sv, nq, nk in streams:
            ys["q"].append(rms_norm(heads(sq), nq))
            ys["k"].append(rms_norm(heads(sk), nk))
        for i, name in enumerate(("q", "k")):
            y = torch.cat(ys[name], dim=2)
            cands = [y, *_bf16_neighbours(y)]
            rope = [(a.float() * cos + rotate_half_interleaved(b.float()) * sin).to(torch.bfloat16)
                    for a in cands for b in cands]  # a's elements rotated against b's pair elements
            checked[f"qkv_heads {name}, {label}"] = _glue_against_chain(
                f"qkv_heads {name}, {label}", joint[i], apply_rope(y, cos, sin), rope)
        if not torch.equal(joint[2], torch.cat([heads(t[2]) for t in streams], dim=2)):
            raise AssertionError(f"[glue] qkv_heads v, {label}: not the streams' heads")

    before = dit_glue.launch_counts()["qkv_heads"]
    g2()
    torch.cuda.synchronize()
    g2_against_chain("single block", [(q, k, v, norm_q, norm_k)], outs)
    joint = [torch.full((1, h, s, 128), 3.0, device="cuda", dtype=torch.bfloat16) for _ in range(3)]
    streams = [tuple(t[:, :s_txt].contiguous() for t in (q, k, v)) + (norm_added_q, norm_added_k),
               tuple(t[:, s_txt:].contiguous() for t in (q, k, v)) + (norm_q, norm_k)]
    for offset, stream in zip((0, s_txt), streams):
        dit_glue.qkv_heads(*stream, cos, sin, *joint, offset)
    torch.cuda.synchronize()
    if dit_glue.launch_counts()["qkv_heads"] != before + 3:
        raise AssertionError("[glue] qkv_heads: the wrapper did not launch its kernel")
    g2_against_chain("double block, text at 0 and image at 512 in one joint buffer", streams, joint)
    log("[glue] against the chain through the wrappers (share equal to the chain's, largest difference): "
        + "; ".join(f"{label} {share:.6%}, {err}" for label, (share, err) in checked.items()) + f" [{card}]")

    # each C entry with its arguments made once, so that back-to-back launches keep the card busy
    stream = torch.cuda.current_stream().cuda_stream
    g1_out = torch.empty_like(x)
    g1_args = (x.data_ptr(), x.stride(0), shift.data_ptr(), shift.stride(0), scale.data_ptr(), scale.stride(0),
               g1_out.data_ptr(), 1, s, d, stream)
    g2_args = (*(t.data_ptr() for t in (q, k, v, norm_q, norm_k, cos, sin, *outs)), 1, s, h, s, 0, stream)
    rows = {}
    for name, kernel, plain, nbytes, entry in (
        ("adaln_modulate", g1, g1_plain, 2 * (2 * s * d) + 2 * 2 * d,
         lambda: dit_glue._kernel("flux2_adaln_modulate")(*g1_args)),
        ("qkv_heads", g2, g2_plain, 2 * (2 * 3 * s * d) + 2 * 4 * s * 128 + 2 * 2 * 128,
         lambda: dit_glue._kernel("flux2_qkv_heads")(*g2_args)),
    ):
        launch_ms = statistics.median(event_times(lambda: [entry() for _ in range(50)], reps=7)) / 50
        ms, plain_ms = time_ms(kernel), time_ms(plain)
        wrapper_us, entry_us = host_us(kernel), host_us(entry)
        bound = bound_ms(0.0, nbytes, BF16_FLOPS)
        log(f"[glue] {name} at (B, S, H) = {GLUE_SHAPE}: by CUDA events over 50 launches {launch_ms:.4f} ms "
            f"({nbytes / launch_ms / 1e6:.1f} GB/s, {bound[0] / launch_ms:.1%} of its {bound[0]:.6f} ms bound, "
            f"{bound[1]}), one wrapper call {ms:.4f} ms, the chain {plain_ms:.4f} ms; host time a call: the wrapper "
            f"{wrapper_us:.1f} us, its C entry {entry_us:.1f} us [{card}]")
        rows[name] = {"equal": min(v[0] for label, v in checked.items() if label.startswith(name)),
                      "err": max(v[1] for label, v in checked.items() if label.startswith(name)),
                      "launch_ms": launch_ms, "ms": ms, "plain_ms": plain_ms, "bound": bound, "bytes": nbytes,
                      "wrapper_host_us": wrapper_us, "entry_host_us": entry_us}
    return rows


class _SampledClock:
    """While entered: ``nvidia-smi`` samples the SM clock, the power draw and
    the throttle reasons every 20 ms; on exit the median clock, its quartiles,
    the median power and the share of samples under the software power cap
    (reason 0x4), over the samples above 200 W (all, if none is)."""

    def __enter__(self):
        self._proc = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm,power.draw,clocks_throttle_reasons.active",
                                       "--format=csv,noheader,nounits", "-lms", "20"], stdout=subprocess.PIPE,
                                      text=True)
        time.sleep(0.3)
        return self

    def __exit__(self, *exc):
        self._proc.terminate()
        rows = []
        for line in self._proc.communicate()[0].splitlines():
            try:
                mhz, watts, reasons = (f.strip() for f in line.split(","))
                rows.append((float(mhz), float(watts), int(reasons, 16)))
            except ValueError:
                continue
        busy = [r for r in rows if r[1] > 200] or rows
        clocks = [r[0] for r in busy]
        self.mhz = statistics.median(clocks)
        self.quartiles = statistics.quantiles(clocks, n=4) if len(clocks) > 1 else [self.mhz] * 3
        self.watts = statistics.median(r[1] for r in busy)
        self.capped = sum(1 for r in busy if r[2] & 0x4) / len(busy)
        self.samples = len(busy)
        return False


def phase_k1_clock(card: str) -> dict:
    """K1 (flash_fwd_kernel) in back-to-back full-width 1024^2 DiT forwards of
    Klein-4B (40) and Klein-9B (20) under inference_mode, on the fused glue
    route and on the torch chain (``transformer._fused`` forced false: the
    route the parent of G1 / G2 ran; a tree without ``_fused`` runs the chain
    alone), then alone (CUDA events, 50 back-to-back launches at the served
    shape): its device time a launch (torch.profiler), its share of its bound
    and its cycles (time x the median SM clock sampled meanwhile), so that a
    fall of ``flash_fwd_roofline.serve`` can be told apart from the clock."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from flux2_tpu_torch.models.flux2 import transformer as tr
    from flux2_tpu_torch.models.flux2.config import KLEIN_4B, KLEIN_9B
    from flux2_tpu_torch.ops import flash_attention as fa
    from flux2_tpu_torch.ops import latents as lu
    from flux2_tpu_torch.ops.rope import rope_embeddings

    fused = getattr(tr, "_fused", None)
    routes = ("fused", "chain", "fused", "chain") if fused else ("chain", "chain")
    ids = np.concatenate([lu.text_position_ids(512), lu.image_position_ids(1024, 1024)])
    cos, sin = rope_embeddings(torch.from_numpy(ids).cuda())
    out = {}
    try:
        for name, cfg, forwards in (("klein4b", KLEIN_4B, 40), ("klein9b", KLEIN_9B, 20)):
            gen = torch.Generator(device="cuda").manual_seed(SEED)
            model = tr.Flux2Transformer(cfg, device="cuda", dtype=torch.bfloat16, generator=gen)
            img = torch.randn(1, 4096, cfg.in_channels, device="cuda", generator=gen).bfloat16()
            txt = torch.randn(1, 512, cfg.joint_attention_dim, device="cuda", generator=gen).bfloat16()
            t = torch.full((1,), 0.7, device="cuda")
            h = cfg.num_attention_heads
            bound_us = 4 * h * 4608 * 4608 * 128 / BF16_FLOPS * 1e6
            rows = out[name] = []
            for route in routes:
                if fused:
                    tr._fused = fused if route == "fused" else (lambda *tensors: False)
                with torch.inference_mode():
                    for _ in range(3):
                        model(img, txt, t, cos, sin)
                    torch.cuda.synchronize()
                    with _SampledClock() as clk, profile(activities=[ProfilerActivity.CUDA]) as prof:
                        t0 = time.perf_counter()
                        for _ in range(forwards):
                            model(img, txt, t, cos, sin)
                        torch.cuda.synchronize()
                        forward_ms = (time.perf_counter() - t0) / forwards * 1e3
                k1 = [e for e in prof.key_averages() if "flash_fwd_kernel" in e.key]
                n = sum(e.count for e in k1)
                us = sum(getattr(e, "device_time_total", 0) or getattr(e, "cuda_time_total", 0) for e in k1) / n
                rows.append({"route": route, "forward_ms": forward_ms, "k1_us": us, "launches": n, "mhz": clk.mhz,
                             "watts": clk.watts, "capped": clk.capped, "cycles": us * clk.mhz})
                log(f"[k1 clock] {name} {route}: forward {forward_ms:.2f} ms; K1 in the forwards {us:.2f} us x {n} "
                    f"({bound_us / us:.2%} of its bound); SM clock median {clk.mhz:.0f} MHz, quartiles "
                    f"{[round(x) for x in clk.quartiles]}, {clk.watts:.0f} W, power cap in {clk.capped:.0%} of "
                    f"{clk.samples} samples; K1 {us * clk.mhz:.4g} cycles [{card}]")
            q, k, v = (torch.randn(1, h, 4608, 128, device="cuda", generator=gen).bfloat16() for _ in range(3))
            with torch.inference_mode(), _SampledClock() as clk:
                us = statistics.median(event_times(lambda: [fa.flash_attention(q, k, v) for _ in range(50)],
                                                   reps=15)) / 50 * 1e3
            rows.append({"route": "alone", "k1_us": us, "mhz": clk.mhz, "watts": clk.watts, "capped": clk.capped,
                         "cycles": us * clk.mhz})
            log(f"[k1 clock] {name} K1 alone (CUDA events, 50 back-to-back): {us:.2f} us ({bound_us / us:.2%} of its "
                f"bound); SM clock median {clk.mhz:.0f} MHz, {clk.watts:.0f} W, power cap in {clk.capped:.0%}; K1 "
                f"{us * clk.mhz:.4g} cycles [{card}]")
            del model, q, k, v
            torch.cuda.empty_cache()
    finally:
        if fused:
            tr._fused = fused
    return out


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
    from flux2_tpu_torch.ops import dit_glue
    from flux2_tpu_torch.ops import flash_attention as fa
    from flux2_tpu_torch.ops import quant_kernels as qk

    fa.reset_launches()
    qk.reset_launches()
    dit_glue.reset_launches()


def _launch_counts(glue: bool = False) -> dict:
    """Every kernel's count: K1 "flash", K2 "flash_lse", K3 "flash_bwd_dq", K4
    "flash_bwd_dkv", and the quantized matmuls' (a path checks all of them).
    With ``glue`` also G1 "adaln_modulate" and G2 "qkv_heads": the serving,
    I2I, KV and editing phases check them (``_forward_glue``); the other
    phases' expected counts leave them out. K5's "w8a8_grouped" is left out:
    it counts those of K5's own launches that walked grouped row bands, which
    ``_wrapper_launches`` checks a call at a time."""
    from flux2_tpu_torch.ops import dit_glue
    from flux2_tpu_torch.ops import flash_attention as fa
    from flux2_tpu_torch.ops import quant_kernels as qk

    counts = {**fa.launch_counts(), **qk.launches, **(dit_glue.launch_counts() if glue else {})}
    del counts["w8a8_grouped"]
    return counts


def _forward_glue(double: int, single: int, forwards: int = 1) -> dict:
    """G1's and G2's launches in ``forwards`` no-grad DiT forwards on a bf16
    stream (``transformer._fused``), under any runtime: G1 two a stream in each
    double block, one in each single block and one in ``_final``; G2 one a
    stream a block."""
    return {"adaln_modulate": forwards * (4 * double + single + 1), "qkv_heads": forwards * (2 * double + single)}


def phase_quant_model_check(pipe, card: str) -> dict:
    """One full-width Klein-4B DiT forward at 1024^2 per quantized runtime (a
    copy of the bf16 DiT, quantized on the card) against the bf16 forward; each
    forward launches the fused glue as ``_forward_glue`` says."""
    import copy

    import numpy as np

    from flux2_tpu_torch.ops import dit_glue
    from flux2_tpu_torch.ops import latents as lu
    from flux2_tpu_torch.ops import quant as tq
    from flux2_tpu_torch.ops.rope import rope_embeddings

    emb = pipe.text_encoder("a check of the quantized models")
    noise = lu.seeded_noise_seq(SEED, 1024, 1024, 1, device="cuda").bfloat16()
    ids = np.concatenate([lu.text_position_ids(512), lu.image_position_ids(1024, 1024)])
    cos, sin = rope_embeddings(torch.from_numpy(ids).cuda())
    t = torch.full((1,), 0.7, device="cuda")

    def forward(model):
        dit_glue.reset_launches()
        with torch.inference_mode():
            out = model(noise, emb, t, cos, sin)
        torch.cuda.synchronize()
        if dit_glue.launch_counts() != _forward_glue(*KLEIN_4B_BLOCKS):
            raise AssertionError(f"a Klein-4B forward launched {dit_glue.launch_counts()} of the fused glue, want "
                                 f"{_forward_glue(*KLEIN_4B_BLOCKS)}")
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
    """Full-width Klein-4B DiT + FLUX.2 VAE + Qwen3-4B encoder, random, bf16, drawn on the card; the
    encoder with the dev tokenizer in an encoder registry (the chat surface), as ``t2i --random-init``
    attaches it."""
    from flux2_tpu_torch.models.text_encoders.decoder import Qwen3Decoder
    from flux2_tpu_torch.models.text_encoders.extractor import QWEN3_4B
    from flux2_tpu_torch.pipeline.pipeline import Flux2Model, Flux2Pipeline
    from flux2_tpu_torch.utils import inline_bpe_tokenizer

    from flux2_tpu_torch.models.text_encoders import facade
    from flux2_tpu_torch.models.text_encoders.config import QWEN3_HIDDEN_LAYERS

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    pipe = Flux2Pipeline.from_random(Flux2Model.KLEIN_4B, device="cuda", generator=gen)
    tokenizer = inline_bpe_tokenizer()
    # a registry of the pipeline's own: the in-process CLI runs of later phases register theirs in facade.shared
    registry = facade.TextEncoders()
    enc = registry.attach("qwen3-4b", Qwen3Decoder(QWEN3_4B, device="cuda", generator=gen), QWEN3_4B, tokenizer,
                          QWEN3_HIDDEN_LAYERS, recipe="klein")
    pipe.text_encoder, pipe.text_encoder_name, pipe.encoders = enc.extractor, enc.name, registry
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
        counts = _launch_counts(glue=True)
    finally:
        server.shutdown()
    img = decode_png(png)
    if img.shape != (1024, 1024, 3) or int(img.max()) == int(img.min()):
        raise AssertionError(f"CFG request: PNG {img.shape}, range {int(img.min())}..{int(img.max())}")
    (res,) = recorder.results
    if tuple(res.latents_device.shape) != (1, 4096, 128) or not torch.isfinite(res.latents_device).all():
        raise AssertionError(f"CFG request: latents {tuple(res.latents_device.shape)}, finite "
                             f"{bool(torch.isfinite(res.latents_device).all())}")
    want = {name: 0 for name in counts}
    want.update(flash=25 * 4, **_forward_glue(*KLEIN_4B_BLOCKS, 4))
    if counts != want:
        raise AssertionError(f"CFG request launched {counts}, want {want}")
    if "" not in base._prompt_cache:
        raise AssertionError('CFG request: the "" negative was not encoded through the prompt LRU')
    pt = res.phase_timings
    log(f"[serve cfg] klein-4b-base 1024^2, guidance {base.model.default_guidance}, cond + uncond rows: "
        f"{wall:.3f} s wall; text encoding {pt['text_encoding']:.4f} s, denoising "
        f"{pt['denoising'] / res.num_steps:.4f} s/step, VAE decoding {pt['vae_decoding']:.4f} s; launches {counts} "
        f"[{card}]")
    return {"wall_s": wall, "s_per_step": pt["denoising"] / res.num_steps}


# -- I2I, img2img strength and the KV-cached klein-9b-kv path -------------------------------

I2I_PROMPT = "the same lighthouse in winter, heavy snow, at night"


def reference_image(size: int = 1024):
    """A seeded RGB reference image, uint8 [size, size, 3]: 16 x 16 random
    colours, bilinearly upsampled (smooth, as photographs are at that scale)."""
    import torch.nn.functional as F

    small = torch.rand(1, 3, 16, 16, generator=torch.Generator().manual_seed(SEED + 9))
    img = F.interpolate(small, size=(size, size), mode="bilinear", align_corners=False)[0].permute(1, 2, 0)
    return (img * 255.0).round().to(torch.uint8).numpy()


def _s_per_step(res) -> float:
    return res.phase_timings["denoising"] / res.num_steps


def _png_of(image) -> bytes:
    """The server's PNG of a generate() image (JAX's pixels: ``to_u8`` truncates)."""
    from flux2_tpu_torch.io.png import encode_png, to_u8

    return encode_png(to_u8(image))


def _filtered_png(image_u8) -> tuple:
    """uint8 [H, W, 3] -> (PNG bytes with row filters, as users' files have
    them, and the writer's name): Pillow's own choice of filters where Pillow
    imports, else the Paeth filter (type 4) on every row."""
    import io
    import struct
    import zlib

    import numpy as np

    from flux2_tpu_torch.io import png as tpng

    try:
        from PIL import Image
    except ImportError:
        pass
    else:
        buf = io.BytesIO()
        Image.fromarray(image_u8).save(buf, "PNG")
        return buf.getvalue(), "Pillow"
    x = image_u8.astype(np.int16)
    a = np.pad(x, ((0, 0), (1, 0), (0, 0)))[:, :-1]  # left, up, up-left: zero outside the image
    b = np.pad(x, ((1, 0), (0, 0), (0, 0)))[:-1]
    c = np.pad(x, ((1, 0), (1, 0), (0, 0)))[:-1, :-1]
    pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
    pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    h, w, _ = x.shape
    rows = np.concatenate([np.full((h, 1), 4, np.uint8), ((x - pred) & 0xFF).astype(np.uint8).reshape(h, w * 3)], 1)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (tpng.PNG_SIGNATURE + tpng._chunk(b"IHDR", ihdr) + tpng._chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + tpng._chunk(b"IEND", b"")), "the Paeth filter (Pillow not importable)"


def _check_launches(label: str, counts: dict, flash: int, blocks: tuple = KLEIN_4B_BLOCKS) -> None:
    """``counts`` (``_launch_counts(glue=True)``) hold ``flash`` K1 launches, one
    a block of no-grad forwards on a bf16 stream through ``blocks`` (double,
    single), those forwards' G1 and G2 launches, and nothing else."""
    forwards, rest = divmod(flash, sum(blocks))
    want = {name: 0 for name in counts}
    want.update(flash=flash, **_forward_glue(*blocks, forwards))
    if rest or counts != want:
        raise AssertionError(f"{label} launched {counts}, want {want}")


def phase_i2i(pipe, card: str) -> dict:
    """On the bf16 Klein-4B pipeline: the 1024^2 reference's encode (first,
    warm, and TF32 on against off), one 1024^2 I2I generate (exactly 100 K1
    launches at S = 8704), its warm s/step against T2I's, strength 0.5 (2 of
    4 steps, 50 launches), and two same-shape I2I requests through Flux2Server
    (base64 PNG references with row filters, one with strength 0.5, the
    reference's decode timed alone): two batches of one, the first PNG equal
    to a direct generate's to the bit."""
    import base64

    import numpy as np

    from flux2_tpu_torch.io.png import decode_image, decode_png
    from flux2_tpu_torch.pipeline import pipeline as tpl
    from flux2_tpu_torch.serve import Flux2Server

    ref_u8 = reference_image()
    ref = ref_u8.astype(np.float32) / 255.0
    times = []
    for _ in range(4):
        t0 = time.perf_counter()
        packed = pipe.encode_image_to_packed_sequence(ref)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    if tuple(packed.shape) != (1, 4096, 128) or not torch.isfinite(packed).all():
        raise AssertionError(f"encode gave {tuple(packed.shape)}, finite {bool(torch.isfinite(packed).all())}")
    x = torch.tensor(ref, device="cuda")
    by_tf32, tf32_ms = {}, {}
    with torch.inference_mode(), tpl._full_f32():  # the pipeline's encode flags, then TF32 allowed: both restored
        for tf32 in (False, True):
            torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = tf32
            by_tf32[tf32] = tpl.encode_packed(pipe.vae_encoder, pipe.vae, x)
            tf32_ms[tf32] = time_ms(lambda: tpl.encode_packed(pipe.vae_encoder, pipe.vae, x), reps=5, warmup=1)
    tf32_rel = float((by_tf32[True] - by_tf32[False]).norm() / by_tf32[False].norm())
    if not torch.equal(by_tf32[False], packed):
        raise AssertionError("the pipeline's encode differs from encode_packed with TF32 off")
    log(f"[i2i] 1024^2 reference encode (VAE encoder f32, TF32 off): first "
        f"{times[0]:.4f} s, warm {statistics.median(times[1:]):.4f} s (median of {[round(t, 4) for t in times[1:]]}); "
        f"packed latents TF32 on vs off: relative L2 {tf32_rel:.4e}; encode_packed alone TF32 on {tf32_ms[True]:.3f} "
        f"ms, off {tf32_ms[False]:.3f} ms [{card}]")

    lat, ids = pipe.encode_reference_images([ref])
    i2i = dict(prompt=I2I_PROMPT, height=1024, width=1024, num_steps=4, seed=7, reference_latents=lat,
               reference_ids=ids)
    _zero_launches()
    res = pipe.generate(**i2i)
    counts = i2i_counts = _launch_counts(glue=True)
    _check_launches("Klein-4B 1024^2 I2I", counts, 25 * 4)
    if tuple(res.latents_device.shape) != (1, 4096, 128) or not torch.isfinite(res.latents_device).all():
        raise AssertionError(f"I2I latents {tuple(res.latents_device.shape)}, finite "
                             f"{bool(torch.isfinite(res.latents_device).all())}")
    warm_i2i = pipe.generate(**{**i2i, "decode": False})
    warm_t2i = pipe.generate(prompt=I2I_PROMPT, height=1024, width=1024, num_steps=4, seed=7, decode=False)
    log(f"[i2i] Klein-4B 1024^2 with one 1024^2 reference (S = 512 + 4096 + 4096 = 8704): launches {counts}; "
        f"first {_s_per_step(res):.4f} s/step, warm {_s_per_step(warm_i2i):.4f} s/step against T2I "
        f"{_s_per_step(warm_t2i):.4f} s/step on the same pipeline "
        f"({_s_per_step(warm_i2i) / _s_per_step(warm_t2i):.2f}x); phases {({k: round(v, 4) for k, v in res.phase_timings.items()})} [{card}]")

    init = pipe.encode_image_to_packed_sequence(ref)
    _zero_launches()
    strong = pipe.generate(**i2i, strength=0.5, init_latents=init)
    counts = _launch_counts(glue=True)
    _check_launches("strength 0.5", counts, 25 * 2)
    if strong.num_steps != 2 or not torch.isfinite(strong.latents_device).all():
        raise AssertionError(f"strength 0.5 ran {strong.num_steps} steps, finite "
                             f"{bool(torch.isfinite(strong.latents_device).all())}")
    log(f"[i2i] strength 0.5, the reference as init: {strong.num_steps} of 4 steps, launches {counts}, "
        f"{_s_per_step(strong):.4f} s/step [{card}]")

    ref_png, writer = _filtered_png(ref_u8)
    decode_s = {}
    for name, fn in (("decode_image", decode_image), ("decode_png", decode_png)):
        t0 = time.perf_counter()
        got = fn(ref_png)
        decode_s[name] = time.perf_counter() - t0
        if not np.array_equal(got if got.dtype == np.uint8 else np.rint(got * 255.0).astype(np.uint8), ref_u8):
            raise AssertionError(f"{name} of the 1024^2 reference PNG ({writer}) differs from the image")
    log(f"[i2i] 1024^2 reference PNG written by {writer}, {len(ref_png)} bytes: decode_image (the server's reader; "
        f"through {'Pillow' if writer == 'Pillow' else 'decode_png'}) {decode_s['decode_image']:.4f} s, decode_png "
        f"(the port's decoder) {decode_s['decode_png']:.4f} s [{card}]")
    b64 = base64.b64encode(ref_png).decode()
    reqs = [{"prompt": I2I_PROMPT, "height": 1024, "width": 1024, "steps": 4, "seed": 7, "references": [b64]},
            {"prompt": I2I_PROMPT, "height": 1024, "width": 1024, "steps": 4, "seed": 8, "strength": 0.5,
             "references": [b64]}]
    recorder = _RecordingPipeline(pipe)
    server = Flux2Server(recorder, embeddings_fn=pipe.encode_prompt, batch_window_s=1.0)
    try:
        _zero_launches()
        t0 = time.perf_counter()
        pngs = _concurrent(server, reqs)
        wall = time.perf_counter() - t0
        counts = _launch_counts(glue=True)
    finally:
        server.shutdown()
    _check_launches("two I2I requests", counts, 25 * 4 + 25 * 2)
    if ((server.batches_run, server.requests_served) != (2, 2)
            or [len(r.latents_device) for r in recorder.results] != [1, 1]):
        raise AssertionError(f"{server.requests_served} I2I requests in {server.batches_run} batches of "
                             f"{[len(r.latents_device) for r in recorder.results]}, want 2 batches of one")
    for png in pngs:
        img = decode_png(png)
        if img.shape != (1024, 1024, 3) or int(img.max()) == int(img.min()):
            raise AssertionError(f"I2I request: PNG {img.shape}, range {int(img.min())}..{int(img.max())}")
    if pngs[0] != _png_of(res.image):
        raise AssertionError("the first I2I request's PNG differs from the direct generate's")
    log(f"[serve i2i] two same-shape 1024^2 I2I requests (base64 PNG reference by {writer}, one with strength 0.5): "
        f"2 batches of one, {wall:.3f} s wall, launches {counts}; the first PNG equals the direct generate's to the "
        f"bit [{card}]")
    return {"encode_cold_s": times[0], "encode_warm_s": statistics.median(times[1:]), "tf32_rel": tf32_rel,
            "i2i_s_per_step": _s_per_step(warm_i2i), "t2i_s_per_step": _s_per_step(warm_t2i),
            "i2i_launches": i2i_counts["flash"], "decode_s": decode_s}


class _KVSplit:
    """While entered: counts the entries into ``Flux2Pipeline._denoise_kv_cached``
    and the K1 launches made inside ``Flux2Transformer.forward_kv_extract`` and
    ``forward_kv_cached`` (their class attributes wrapped; restored on exit)."""

    def __enter__(self):
        from flux2_tpu_torch.models.flux2.transformer import Flux2Transformer
        from flux2_tpu_torch.pipeline.pipeline import Flux2Pipeline

        self.counts = {"kv_loops": 0, "extract": 0, "cached": 0}
        wrapped = ((Flux2Pipeline, "_denoise_kv_cached", "kv_loops"),
                   (Flux2Transformer, "forward_kv_extract", "extract"), (Flux2Transformer, "forward_kv_cached", "cached"))
        self._saved = [(cls, name, getattr(cls, name)) for cls, name, _ in wrapped]
        for cls, name, key in wrapped:
            setattr(cls, name, self._counting(key, getattr(cls, name)))
        return self

    def _counting(self, key, fn):
        def wrapped(*args, **kwargs):
            before = _launch_counts(glue=True)["flash"]
            try:
                return fn(*args, **kwargs)
            finally:
                self.counts[key] += 1 if key == "kv_loops" else _launch_counts(glue=True)["flash"] - before
        return wrapped

    def __exit__(self, *exc):
        for cls, name, fn in self._saved:
            setattr(cls, name, fn)


def phase_kv_cli(card: str, workdir: str) -> dict:
    """``i2i --model klein-9b-kv --random-init`` through cli.main in the
    process (random Klein-9B and Qwen3-8B drawn on the card, a 1024^2 PNG
    reference): exactly 32 + 3 x 32 K1 launches, measured apart (32 inside
    forward_kv_extract, 96 inside forward_kv_cached, one entry into
    _denoise_kv_cached), and a valid PNG. Then, on the same weights and step
    0's inputs, one forward_kv_extract (32 launches) and one forward_kv_cached
    (32): the cached velocity against the extract one (DIT_REL_TOL), the
    cache's bytes, and the warm KV s/step against the uncached I2I path (the
    model set to klein-9b: 128 launches, none in the KV functions)."""
    import dataclasses

    import numpy as np

    from flux2_tpu_torch.cli import main as cli
    from flux2_tpu_torch.io.png import decode_png, encode_png
    from flux2_tpu_torch.ops import latents as lu
    from flux2_tpu_torch.ops import scheduler as sch
    from flux2_tpu_torch.pipeline.pipeline import Flux2Model

    ref_path, out = os.path.join(workdir, "ref.png"), os.path.join(workdir, "kv.png")
    with open(ref_path, "wb") as f:
        f.write(encode_png(reference_image()))
    built, original = [], cli.build_pipeline

    def recording_build(args, device, *a, **k):
        built.append(original(args, device, *a, **k))
        return built[-1]

    cli.build_pipeline = recording_build
    torch.cuda.reset_peak_memory_stats()
    try:
        with _KVSplit() as split:
            _zero_launches()
            argv = ["i2i", "--model", "klein-9b-kv", "--random-init", "--reference", ref_path, "--height", "1024",
                    "--width", "1024", "--steps", "4", "--prompt", I2I_PROMPT, "-o", out]
            lines = _run_cli(argv, "i2i klein-9b-kv", card)
            counts = _launch_counts(glue=True)
    finally:
        cli.build_pipeline = original
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    _check_launches("i2i --model klein-9b-kv", counts, 32 + 3 * 32, KLEIN_9B_BLOCKS)
    if split.counts != {"kv_loops": 1, "extract": 32, "cached": 3 * 32}:
        raise AssertionError(f"i2i --model klein-9b-kv: {split.counts}, want one KV loop with 32 K1 launches in "
                             f"forward_kv_extract and 96 in forward_kv_cached")
    report = json.loads(lines[-1])
    with open(out, "rb") as f:
        img = decode_png(f.read())
    if (lines[0] != f"saved {out}" or report["steps"] != 4 or img.shape != (1024, 1024, 3)
            or int(img.max()) == int(img.min())):
        raise AssertionError(f"i2i klein-9b-kv printed {lines}; PNG {img.shape}")
    (pipe,) = built
    c = pipe.transformer.config
    weights_gib = sum(t.numel() * t.element_size() for t in pipe.transformer.state_dict().values()) / 2**30

    # step 0's inputs: the CLI's seed (0), prompt, reference and first sigma
    emb = pipe.encode_prompt(I2I_PROMPT)
    lat, ids = pipe.encode_reference_images([reference_image().astype(np.float32) / 255.0])
    x = lu.seeded_noise_seq(0, 1024, 1024, 1, device="cuda").bfloat16()
    t0 = torch.full((1,), float(sch.set_timesteps(4, image_seq_len=4096).sigmas[0]), device="cuda")
    txt_ids, img_ids = lu.text_position_ids(emb.shape[1]), lu.image_position_ids(1024, 1024)
    extract_rope, cached_rope = pipe._rope([txt_ids, ids, img_ids]), pipe._rope([txt_ids, img_ids])
    with torch.inference_mode():
        _zero_launches()
        v_extract, dkv, skv = pipe.transformer.forward_kv_extract(x, lat.bfloat16(), emb, t0, *extract_rope)
        counts_extract = _launch_counts(glue=True)
        _zero_launches()
        v_cached = pipe.transformer.forward_kv_cached(x, emb, t0, *cached_rope, dkv, skv)
        counts_cached = _launch_counts(glue=True)
    _check_launches("one forward_kv_extract", counts_extract, 32, KLEIN_9B_BLOCKS)
    _check_launches("one forward_kv_cached", counts_cached, 32, KLEIN_9B_BLOCKS)
    rel = float((v_cached.float() - v_extract.float()).norm() / v_extract.float().norm())
    cache_gib = sum(t.numel() * t.element_size() for kv in dkv + skv for t in kv) / 2**30
    del dkv, skv, v_extract, v_cached
    if not rel <= DIT_REL_TOL:
        raise AssertionError(f"klein-9b-kv: cached velocity vs extract velocity relative L2 {rel} > {DIT_REL_TOL}")

    i2i = dict(prompt=I2I_PROMPT, height=1024, width=1024, num_steps=4, reference_latents=lat, reference_ids=ids,
               decode=False)
    kv = pipe.generate(**i2i)
    # the RePaint hook with mask 1 everywhere is the identity: the KV loop runs
    # it after the extract step and each cached step, and the latents keep their bits
    from flux2_tpu_torch.chains.inpaint import _blend_noise, repaint_step_hook

    identity = (repaint_step_hook, {"image": lat.float(), "mask": torch.ones(1, lat.shape[1], 1, device="cuda"),
                                    "noise": _blend_noise(SEED, tuple(lat.shape), "cuda")})
    with _KVSplit() as split_hook:
        _zero_launches()
        hooked = pipe.generate(**i2i, step_hook=identity)
        counts_hook = _launch_counts(glue=True)
    _check_launches("klein-9b-kv I2I with the identity RePaint hook", counts_hook, 32 + 3 * 32, KLEIN_9B_BLOCKS)
    if split_hook.counts != split.counts or not torch.equal(hooked.latents_device, kv.latents_device):
        raise AssertionError(f"klein-9b-kv with the identity hook: {split_hook.counts}; latents equal to the "
                             f"unhooked call's: {torch.equal(hooked.latents_device, kv.latents_device)}")
    log(f"[kv] klein-9b-kv I2I with the RePaint hook, mask 1 everywhere: K1 {split_hook.counts['extract']} inside "
        f"forward_kv_extract + {split_hook.counts['cached']} inside forward_kv_cached, as without it; latents equal "
        f"to the unhooked call's to the bit; {_s_per_step(hooked):.4f} s/step [{card}]")
    del hooked
    plain = dataclasses.replace(pipe, model=Flux2Model.KLEIN_9B)
    with _KVSplit() as split_plain:
        _zero_launches()
        plain.generate(**i2i)
        counts_plain = _launch_counts(glue=True)
    _check_launches("klein-9b I2I (uncached)", counts_plain, 32 * 4, KLEIN_9B_BLOCKS)
    if split_plain.counts != {"kv_loops": 0, "extract": 0, "cached": 0}:
        raise AssertionError(f"klein-9b I2I (uncached) went into the KV path: {split_plain.counts}")
    uncached = plain.generate(**i2i)
    log(f"[kv] i2i --model klein-9b-kv --random-init through cli.main ({c.num_layers} double + {c.num_single_layers} "
        f"single blocks, {c.num_attention_heads} heads x {c.attention_head_dim}, joint {c.joint_attention_dim}; "
        f"{weights_gib:.2f} GiB of DiT weights; Qwen3-8B encoder): launches {counts}; _denoise_kv_cached entered "
        f"{split.counts['kv_loops']}x, K1 launches inside forward_kv_extract {split.counts['extract']}, inside "
        f"forward_kv_cached {split.counts['cached']}; duration {report['duration_s']} s, phases {report['phases']}; "
        f"peak device memory {peak_gib:.2f} GiB [{card}]")
    log(f"[kv] one forward_kv_extract launched {counts_extract['flash']} K1, one forward_kv_cached "
        f"{counts_cached['flash']}; the uncached klein-9b path entered the KV functions {split_plain.counts} [{card}]")
    log(f"[kv] step 0, cached vs extract velocity: relative L2 {rel:.4e} (tol {DIT_REL_TOL}); cache "
        f"{cache_gib:.3f} GiB ({2 * (c.num_layers + c.num_single_layers)} tensors [1, {c.num_attention_heads}, "
        f"{lat.shape[1]}, 128] bf16) [{card}]")
    log(f"[kv] warm 1024^2 I2I, 4 steps: KV-cached {_s_per_step(kv):.4f} s/step against uncached (klein-9b, launches "
        f"{counts_plain}) {_s_per_step(uncached):.4f} s/step ({_s_per_step(uncached) / _s_per_step(kv):.2f}x) [{card}]")
    result = {"kv_s_per_step": _s_per_step(kv), "uncached_s_per_step": _s_per_step(uncached), "rel": rel,
              "cache_gib": cache_gib, "peak_gib": peak_gib, "counts": counts,
              "split": {"extract": split.counts["extract"], "cached": split.counts["cached"]}}
    del pipe, plain, built, kv, uncached, lat, emb, x
    gc_cuda()
    return result


# -- the editing slice: RePaint inpaint and outpaint, per-step callbacks, tiled decode, small decoder -----

EDIT_PROMPT = "a red wooden door in an old stone wall"
EDIT_SEED = SEED + 11


def _grey_png(plane_u8) -> bytes:
    """uint8 [H, W] -> an 8-bit grey PNG (colour type 0), filter 0 on every row."""
    import struct
    import zlib

    import numpy as np

    from flux2_tpu_torch.io import png as tpng

    h, w = plane_u8.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8), plane_u8], axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0)
    return (tpng.PNG_SIGNATURE + tpng._chunk(b"IHDR", ihdr) + tpng._chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + tpng._chunk(b"IEND", b""))


def _write_file(path: str, data: bytes) -> str:
    with open(path, "wb") as f:
        f.write(data)
    return path


def _read_png(path: str):
    from flux2_tpu_torch.io.png import decode_png

    with open(path, "rb") as f:
        return decode_png(f.read())


class _HandedPipeline:
    """While entered, ``cli.main.build_pipeline`` hands every command ``pipe``
    (recorded: the ``_RecordingPipeline`` is what ``with`` gives) with the
    command's ``--memory-profile`` attached by the CLI's own
    ``memory_profile``, instead of drawing new weights."""

    def __init__(self, pipe):
        self.pipe, self.recorder = pipe, _RecordingPipeline(pipe)

    def __enter__(self):
        from flux2_tpu_torch.cli import main as cli

        self._cli, self._original = cli, cli.build_pipeline

        def hand(args, device, *a, **k):
            self.pipe.memory_profile = cli.memory_profile(args)
            return self.recorder

        cli.build_pipeline = hand
        return self.recorder

    def __exit__(self, *exc):
        self._cli.build_pipeline = self._original
        self.pipe.memory_profile = None


class _CountDecodes:
    """While entered, counts the calls of ``decoder.decode`` (an instance attribute wraps it)."""

    def __init__(self, decoder):
        self.decoder, self.calls = decoder, 0

    def __enter__(self):
        decode = self.decoder.decode

        def counting(z):
            self.calls += 1
            return decode(z)

        self.decoder.decode = counting
        return self

    def __exit__(self, *exc):
        del self.decoder.decode


def _valid_image(label: str, image, shape) -> None:
    """A generate() image: the shape, finite, in [0, 1], on the 1/255 grid."""
    import numpy as np

    scaled = image * 255.0
    if (image.shape != shape or not np.isfinite(image).all() or image.min() < 0 or image.max() > 1
            or float(np.abs(scaled - np.rint(scaled)).max()) > 1e-3 or float(image.max()) == float(image.min())):
        raise AssertionError(f"{label}: image {image.shape}, range {image.min()}..{image.max()}")


def phase_edit(pipe, card: str, workdir: str, t2i_s_per_step: float, decode_warm_s: float) -> dict:
    """The editing slice on the bf16 Klein-4B pipeline at 1024^2, 4 steps:
    RePaint inpainting in the process (100 K1 launches; the tokens outside
    the mask equal the source latents to the bit) and through ``inpaint``
    (PNG equal to the chain's; with the image as reference and strength 0.5:
    50 launches at S = 8704; crop-and-stitch: the pixels outside the crop are
    the source's); ``outpaint`` 768^2 -> 1024^2 (100 launches at S = 6912);
    the per-step callbacks (checkpoint images equal to the decode of what
    on_latents saw; ``t2i --checkpoint-every 2``; a cancel after step 2: 75
    launches); the 2048^2 decode dense and tiled (25 tile decodes, correlation
    > 0.95), then ``t2i --memory-profile conservative`` at 2048^2; ``t2i
    --small-decoder``; ``auto_profile`` on this card; a served request with a
    preview id."""
    import threading

    import numpy as np

    from flux2_tpu_torch.chains.inpaint import (MaskedInpaintingChain, expand_crop_region, mask_bounding_box,
                                                pack_mask_for_latent_blending)
    from flux2_tpu_torch.chains.outpaint import OutpaintingChain
    from flux2_tpu_torch.cli import main as cli
    from flux2_tpu_torch.io.png import decode_png, encode_png
    from flux2_tpu_torch.pipeline.pipeline import Flux2Model, GenerationCancelled
    from flux2_tpu_torch.serve import Flux2Server
    from flux2_tpu_torch.utils import memory, native

    log(f"[edit] host image ops (utils/native.py): {native.path_name()} [{card}]")
    src_u8 = reference_image()
    src = src_u8.astype(np.float32) / 255.0
    mask_u8 = np.zeros((1024, 1024), np.uint8)
    mask_u8[256:768, 256:768] = 255  # a centred 512^2 square
    mask = mask_u8.astype(np.float32) / 255.0
    paths = {"src": _write_file(os.path.join(workdir, "src.png"), encode_png(src_u8)),
             "mask": _write_file(os.path.join(workdir, "mask.png"), _grey_png(mask_u8)),
             "src768": _write_file(os.path.join(workdir, "src768.png"), encode_png(reference_image(768)))}
    launches, out = {}, {}

    # 1. inpaint in the process (T2I mode)
    _zero_launches()
    t0 = time.perf_counter()
    res = MaskedInpaintingChain(pipe, EDIT_PROMPT, src, mask, seed=EDIT_SEED, steps=4).run()
    wall = time.perf_counter() - t0
    counts = _launch_counts(glue=True)
    _check_launches("inpaint (T2I mode)", counts, 25 * 4)
    launches["inpaint"] = counts["flash"]
    source = pipe.encode_image_to_packed_sequence(src)
    keep = pack_mask_for_latent_blending(mask, 1024, 1024)[0, :, 0].cuda() == 0
    moved = float((res.latents_device[0, ~keep] - source[0, ~keep]).abs().max())
    if not torch.equal(res.latents_device[0, keep], source[0, keep]) or not moved > 0:
        raise AssertionError(f"inpaint: kept tokens equal to the source {torch.equal(res.latents_device[0, keep], source[0, keep])}"
                             f", masked tokens moved by {moved}")
    _valid_image("inpaint", res.image, (1024, 1024, 3))
    out["inpaint_s_per_step"] = _s_per_step(res)
    log(f"[edit] inpaint 1024^2, 512^2 mask, 4 steps: launches {counts}; {int(keep.sum())} of 4096 tokens kept, equal "
        f"to the source latents to the bit; masked tokens moved up to {moved:.4f}; {wall:.3f} s wall, "
        f"{out['inpaint_s_per_step']:.4f} s/step against T2I {t2i_s_per_step:.4f}; phases "
        f"{ {k: round(v, 4) for k, v in res.phase_timings.items()} } [{card}]")

    # 2. the inpaint subcommand, handed this pipeline
    base = ["inpaint", "--random-init", "--image", paths["src"], "--mask", paths["mask"], "--prompt", EDIT_PROMPT,
            "--seed", str(EDIT_SEED), "--steps", "4"]
    with _HandedPipeline(pipe) as rec:
        png_path = os.path.join(workdir, "inpaint.png")
        _zero_launches()
        _run_cli([*base, "-o", png_path], "inpaint", card, tag="edit")
        _check_launches("inpaint subcommand", _launch_counts(glue=True), 25 * 4)
        with open(png_path, "rb") as f:
            if f.read() != _png_of(res.image):
                raise AssertionError("the inpaint subcommand's PNG differs from the in-process chain's")
        ref_path = os.path.join(workdir, "inpaint_ref.png")
        _zero_launches()
        t0 = time.perf_counter()
        _run_cli([*base, "--use-image-as-reference", "--strength", "0.5", "-o", ref_path],
                 "inpaint --use-image-as-reference --strength 0.5", card, tag="edit")
        wall_ref = time.perf_counter() - t0
        counts = _launch_counts(glue=True)
        _check_launches("inpaint --use-image-as-reference --strength 0.5", counts, 25 * 2)
        launches["inpaint_reference_strength"] = counts["flash"]
        s_ref = rec.calls[-1]["reference_latents"].shape[1]
        if 512 + 4096 + s_ref != 8704 or rec.results[-1].num_steps != 2 or _read_png(ref_path).shape != (1024, 1024, 3):
            raise AssertionError(f"inpaint with the image as reference: S = {512 + 4096 + s_ref}, "
                                 f"{rec.results[-1].num_steps} steps")
        out["inpaint_reference_s_per_step"] = _s_per_step(rec.results[-1])
        crop_path = os.path.join(workdir, "inpaint_crop.png")
        _zero_launches()
        _run_cli([*base, "--crop-padding", "64", "--composite", "-o", crop_path], "inpaint --crop-padding 64 "
                 "--composite", card, tag="edit")
        counts = _launch_counts(glue=True)
        _check_launches("inpaint --crop-padding 64 --composite", counts, 25 * 4)
        x0, y0, x1, y1 = expand_crop_region(mask_bounding_box(mask), 64, 1024, 1024)
        outside = np.ones((1024, 1024), bool)
        outside[y0:y1, x0:x1] = False
        got = _read_png(crop_path)
        crop_hw = (rec.calls[-1]["height"], rec.calls[-1]["width"])
        if got.shape != (1024, 1024, 3) or not np.array_equal(got[outside], src_u8[outside]):
            raise AssertionError(f"crop-and-stitch: {got.shape}, pixels outside the crop "
                                 f"{np.array_equal(got[outside], src_u8[outside])} equal to the source")
        log(f"[edit] inpaint subcommand: PNG equal to the in-process chain's to the bit; with --use-image-as-reference "
            f"--strength 0.5: 2 of 4 steps at S = 8704, launches {launches['inpaint_reference_strength']}, "
            f"{out['inpaint_reference_s_per_step']:.4f} s/step, {wall_ref:.3f} s of command (the source encoded "
            f"twice, as init and as reference); --crop-padding 64 --composite: crop ({x0}, {y0}, {x1}, {y1}), "
            f"generated at {crop_hw[0]}x{crop_hw[1]}, the {int(outside.sum())} pixels outside it equal the source's "
            f"[{card}]")

        # 3. the outpaint subcommand: 768^2 -> a 1024^2 canvas
        out_path = os.path.join(workdir, "outpaint.png")
        _zero_launches()
        _run_cli(["outpaint", "--random-init", "--image", paths["src768"], "--top", "128", "--bottom", "128", "--left",
                  "128", "--right", "128", "--prompt", EDIT_PROMPT, "--seed", str(EDIT_SEED), "--steps", "4", "-o",
                  out_path], "outpaint", card, tag="edit")
        counts = _launch_counts(glue=True)
        _check_launches("outpaint 768^2 -> 1024^2", counts, 25 * 4)
        launches["outpaint"] = counts["flash"]
        s_out = 512 + 4096 + rec.calls[-1]["reference_latents"].shape[1]
        if s_out != 6912 or _read_png(out_path).shape != (1024, 1024, 3):
            raise AssertionError(f"outpaint: S = {s_out}, PNG {_read_png(out_path).shape}")
    warm = OutpaintingChain(pipe, reference_image(768).astype(np.float32) / 255.0, EDIT_PROMPT, top=128, bottom=128,
                            left=128, right=128, seed=EDIT_SEED, steps=4).run()
    out["outpaint_s_per_step"] = _s_per_step(warm)
    log(f"[edit] outpaint 768^2 + 128 px a side -> 1024^2 (S = 512 + 4096 + 2304 = {s_out}): launches {counts}; "
        f"{_s_per_step(rec.results[-1]):.4f} s/step first, {out['outpaint_s_per_step']:.4f} warm [{card}]")

    # 4. per-step callbacks on a T2I generate
    t2i = dict(prompt=EDIT_PROMPT, height=1024, width=1024, num_steps=4, seed=EDIT_SEED)
    progress, lats, checkpoints = [], [], []
    _zero_launches()
    pipe.generate(**t2i, on_progress=lambda k, n: progress.append((k, n)),
                  on_latents=lambda k, lat: lats.append((k, lat)), checkpoint_interval=1,
                  on_checkpoint=lambda k, img: checkpoints.append((k, img)))
    _check_launches("T2I with callbacks", _launch_counts(glue=True), 25 * 4)
    if (progress != [(1, 4), (2, 4), (3, 4), (4, 4)] or [k for k, _ in lats] != [1, 2, 3, 4]
            or any(lat.shape != (1, 4096, 128) or lat.dtype != np.float32 for _, lat in lats)
            or [k for k, _ in checkpoints] != [1, 2, 3]):
        raise AssertionError(f"callbacks: progress {progress}, latents {[(k, lat.shape) for k, lat in lats]}, "
                             f"checkpoints {[k for k, _ in checkpoints]}")
    for k, img in checkpoints:
        dec = pipe.decode_latents_u8(torch.from_numpy(lats[k - 1][1]).cuda(), 1024, 1024)[0].cpu().numpy()
        if not np.array_equal(img, dec.astype(np.float32) / 255.0):
            raise AssertionError(f"checkpoint image of step {k} differs from the decode of on_latents' latents")
    plain = [_s_per_step(pipe.generate(**t2i, decode=False)) for _ in range(2)]
    with_latents = [_s_per_step(pipe.generate(**t2i, decode=False, on_latents=lambda k, lat: None)) for _ in range(2)]
    out.update(t2i_s_per_step=min(plain), on_latents_s_per_step=min(with_latents))
    log(f"[edit] T2I callbacks: on_progress {progress}; on_latents 4 host arrays [1, 4096, 128] float32; checkpoint "
        f"images of steps 1-3 equal to the decode of on_latents' latents to the bit; warm s/step without on_latents "
        f"{plain}, with {with_latents} (a 2 MiB device-to-host copy a step) [{card}]")
    with _HandedPipeline(pipe):
        ck_path = os.path.join(workdir, "x.png")
        _zero_launches()
        lines = _run_cli(["t2i", "--random-init", "--prompt", EDIT_PROMPT, "--seed", str(EDIT_SEED), "--steps", "4",
                          "--checkpoint-every", "2", "-o", ck_path], "t2i --checkpoint-every 2", card, tag="edit")
        _check_launches("t2i --checkpoint-every 2", _launch_counts(glue=True), 25 * 4)
    step_path = os.path.join(workdir, "x_step_002.png")
    if (lines[:2] != [f"saved {step_path}", f"saved {ck_path}"] or _read_png(step_path).shape != (1024, 1024, 3)
            or sorted(f for f in os.listdir(workdir) if f.startswith("x")) != ["x.png", "x_step_002.png"]):
        raise AssertionError(f"t2i --checkpoint-every 2 printed {lines}")
    cancel = threading.Event()
    _zero_launches()
    try:
        pipe.generate(**t2i, cancel=cancel, on_progress=lambda k, n: cancel.set() if k >= 2 else None)
        raise AssertionError("the generate was not cancelled")
    except GenerationCancelled as e:
        message = str(e)
    counts = _launch_counts(glue=True)
    _check_launches("cancel after step 2", counts, 25 * 3)
    launches["cancel"] = counts["flash"]
    if message != "cancelled at step 3/4":
        raise AssertionError(f"cancel raised {message!r}")
    log(f"[edit] cancel set by on_progress at step 2 of 4: GenerationCancelled({message!r}), launches {counts} "
        f"(3 steps, as JAX) [{card}]")

    # 6. the 2048^2 decode, dense and tiled
    lat = torch.randn(1, 16384, 128, device="cuda", generator=torch.Generator(device="cuda").manual_seed(SEED + 12))
    vae = pipe._vae_in_compute_dtype()
    decodes = {}
    for name, profile in (("dense", None), ("tiled", memory.MemoryProfile.named("conservative"))):
        pipe.memory_profile = profile
        times, peaks = [], []
        gc_cuda()  # the first decode allocates its memory; the warm ones reuse the allocator's cache
        try:
            with _CountDecodes(vae) as counted:
                for _ in range(3):
                    torch.cuda.reset_peak_memory_stats()
                    before = torch.cuda.memory_allocated()
                    t0 = time.perf_counter()
                    u8 = pipe.decode_latents_u8(lat, 2048, 2048)
                    torch.cuda.synchronize()
                    times.append(time.perf_counter() - t0)
                    peaks.append((torch.cuda.max_memory_allocated() - before) / 2**30)
        finally:
            pipe.memory_profile = None
        decodes[name] = {"u8": u8[0].cpu().numpy(), "first_s": times[0], "warm_s": statistics.median(times[1:]),
                         "peak_gib": max(peaks), "decoder_calls": counted.calls // 3}
    if (decodes["tiled"]["decoder_calls"], decodes["dense"]["decoder_calls"]) != (25, 1):
        raise AssertionError(f"2048^2 decodes: {decodes['tiled']['decoder_calls']} tile decodes, want 25")
    a, b = decodes["dense"]["u8"].astype(np.float64).ravel(), decodes["tiled"]["u8"].astype(np.float64).ravel()
    corr = float(np.corrcoef(a, b)[0, 1])
    diff = np.abs(a - b)
    if not corr > 0.95:
        raise AssertionError(f"tiled 2048^2 decode: correlation {corr} with the dense one, want > 0.95")
    out["decode_2048"] = {k: {kk: v for kk, v in d.items() if kk != "u8"} for k, d in decodes.items()}
    log(f"[edit] 2048^2 decode, VAE bf16: dense first {decodes['dense']['first_s']:.4f} s, warm "
        f"{decodes['dense']['warm_s']:.4f} s, peak {decodes['dense']['peak_gib']:.2f} GiB over the resident; tiled "
        f"('conservative': 25 tiles of 64^2 latents, overlap 8) first {decodes['tiled']['first_s']:.4f} s, warm "
        f"{decodes['tiled']['warm_s']:.4f} s, peak {decodes['tiled']['peak_gib']:.2f} GiB; uint8 tiled vs dense: "
        f"correlation {corr:.6f} (> 0.95), max diff {int(diff.max())}, mean {float(diff.mean()):.4f} [{card}]")
    del decodes, a, b, diff, u8, lat
    with _HandedPipeline(pipe) as rec, _CountDecodes(vae) as counted:
        big_path = os.path.join(workdir, "big.png")
        _zero_launches()
        _run_cli(["t2i", "--random-init", "--height", "2048", "--width", "2048", "--memory-profile", "conservative",
                  "--prompt", EDIT_PROMPT, "--seed", str(EDIT_SEED), "--steps", "4", "-o", big_path],
                 "t2i 2048^2 --memory-profile conservative", card, tag="edit")
        counts = _launch_counts(glue=True)
    _check_launches("t2i 2048^2 --memory-profile conservative", counts, 25 * 4)
    launches["t2i_2048_tiled"] = counts["flash"]
    if counted.calls != 25 or _read_png(big_path).shape != (2048, 2048, 3):
        raise AssertionError(f"t2i 2048^2 conservative: {counted.calls} tile decodes, want 25")
    big = rec.results[-1]
    out["t2i_2048"] = {"s_per_step": _s_per_step(big), "vae_decoding_s": big.phase_timings["vae_decoding"]}
    log(f"[edit] t2i 2048^2 --memory-profile conservative (S = 512 + 16384 = 16896): launches {counts}, "
        f"{counted.calls} tile decodes; {_s_per_step(big):.4f} s/step, decode {big.phase_timings['vae_decoding']:.4f} s "
        f"[{card}]")
    gc_cuda()

    # 7. the small decoder: t2i --small-decoder --random-init, built by the CLI itself
    built, original = [], cli.build_pipeline

    def recording_build(args, device, *a, **k):
        built.append(original(args, device, *a, **k))
        return built[-1]

    cli.build_pipeline = recording_build
    try:
        small_path = os.path.join(workdir, "small.png")
        _zero_launches()
        _run_cli(["t2i", "--small-decoder", "--random-init", "--prompt", EDIT_PROMPT, "--seed", str(EDIT_SEED),
                  "--steps", "4", "-o", small_path], "t2i --small-decoder", card, tag="edit")
        counts = _launch_counts(glue=True)
    finally:
        cli.build_pipeline = original
    _check_launches("t2i --small-decoder", counts, 25 * 4)
    (small,) = built
    widths = small.vae.config.effective_decoder_channels
    if widths != (96, 192, 384, 384) or _read_png(small_path).shape != (1024, 1024, 3):
        raise AssertionError(f"t2i --small-decoder: decoder widths {widths}")
    small_lat = torch.randn(1, 4096, 128, device="cuda", generator=torch.Generator(device="cuda").manual_seed(SEED + 4))
    times = []
    for _ in range(4):
        t0 = time.perf_counter()
        small.decode_latents_u8(small_lat, 1024, 1024)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    out["small_decode"] = {"first_s": times[0], "warm_s": statistics.median(times[1:])}
    log(f"[edit] t2i --small-decoder --random-init: decoder widths {widths}, launches {counts}; 1024^2 decode first "
        f"{times[0]:.4f} s, warm {out['small_decode']['warm_s']:.4f} s against the full decoder's warm "
        f"{decode_warm_s:.4f} s ({decode_warm_s / out['small_decode']['warm_s']:.2f}x) [{card}]")
    del small, built, small_lat
    gc_cuda()

    # 8. auto_profile on this card
    total = memory.total_hbm_bytes()
    for model in (Flux2Model.KLEIN_4B, Flux2Model.KLEIN_9B):
        est = memory.estimate_generation_bytes(model, "bf16")
        chosen = memory.auto_profile(model, "bf16")
        out[f"auto_profile_{model.value}"] = chosen.name
        log(f"[edit] auto_profile({model.value}, bf16): {chosen.name}; estimated {est / 2**30:.2f} GiB of "
            f"{total / 2**30:.2f} GiB on this card ({est / total:.1%}) [{card}]")

    # 9. a served request with a preview id, and one without
    recorder = _RecordingPipeline(pipe)
    server = Flux2Server(recorder, embeddings_fn=pipe.encode_prompt, batch_window_s=0.0)
    req = {"prompt": EDIT_PROMPT, "height": 1024, "width": 1024, "steps": 4, "seed": EDIT_SEED}
    try:
        _zero_launches()
        server.generate_png(req)
        server.generate_png(dict(req, preview_id="edit-preview"))
        counts = _launch_counts(glue=True)
    finally:
        server.shutdown()
    _check_launches("two served requests", counts, 2 * 25 * 4)
    preview = server.get_preview("edit-preview")
    hooks = [c.get("on_latents") for c in recorder.calls]
    if (hooks[0] is not None or hooks[1] is None or preview is None or (preview["step"], preview["total"]) != (4, 4)
            or decode_png(preview["png"]).shape != (128, 128, 3)):
        raise AssertionError(f"previews: on_latents {hooks}, preview {preview and (preview['step'], preview['total'])}")
    log(f"[edit] served 1024^2 requests: without a preview id no on_latents; with one, get_preview gives step "
        f"{preview['step']}/{preview['total']}, a {len(preview['png'])}-byte 128^2 PNG; launches {counts} [{card}]")
    out["launches"] = launches
    return out


class _Http:
    """Requests to a server on 127.0.0.1: each on its own connection, the
    status, headers and body returned whatever the status."""

    def __init__(self, port: int):
        self.port = port

    def __call__(self, method: str, path: str, payload=None, raw: bytes = None, timeout: float = 600.0):
        import http.client

        conn = http.client.HTTPConnection("127.0.0.1", self.port, timeout=timeout)
        try:
            body = raw if raw is not None else (json.dumps(payload).encode() if payload is not None else None)
            conn.request(method, path, body=body, headers={"Content-Type": "application/json"} if body else {})
            resp = conn.getresponse()
            return resp.status, dict(resp.getheaders()), resp.read()
        finally:
            conn.close()


def _serve_thread(server):
    """(ThreadingHTTPServer over ``server`` on 127.0.0.1:0 serving in a thread, its _Http)."""
    from http.server import ThreadingHTTPServer

    from flux2_tpu_torch.serve import make_handler

    httpd = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(server))
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd, _Http(httpd.server_address[1])


def _expect(label: str, status: int, want: int, body: bytes) -> None:
    if status != want:
        raise AssertionError(f"{label}: HTTP {status}, want {want}: {body[:300]!r}")


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


HTTP_PROMPT = "a lighthouse on a cliff at dusk, over HTTP"


def phase_http(pipe, card: str) -> dict:
    """The HTTP layer on the bf16 Klein-4B pipeline: the port's ``make_handler``
    over ``Flux2Server(pipe, embeddings_fn=pipe.encode_prompt)`` on a
    ThreadingHTTPServer at 127.0.0.1:0. GET /health, /info (cuda, the card
    count, klein-4b), /models (the card's memory), / (the page); POST /generate
    at 1024^2, 4 steps, as PNG and as JSON, pixels equal to an in-process
    generate's to the bit (K1 exactly 100 each); three concurrent 256^2 POSTs
    in one batch (K1 100); /preview 404 before the first step, then 200 with
    X-Step in 1..4 and X-Total-Steps 4; /embed equal to encode_prompt to the
    bit (npy) and its stats (json); /chat 200 on the random Qwen3-4B (JSON,
    and chunked with the \\x1e trailer), 503 on the same pipeline without an
    encoder (JSON and streaming); bad JSON 400; a full queue 503; a tiny timeout_s 504; cancel_all during a 1024^2
    batch: 400 "cancelled at step k/4" after 25 k launches. Every request runs
    with the launch counts set to 0 just before it and checked just after.
    Then ``python -m flux2_tpu_torch.serve --random-init --quantization w8a8
    --precompile 256`` in a process of its own: two identical 256^2 requests,
    valid PNGs equal to each other."""
    import base64
    import io

    import numpy as np

    from flux2_tpu_torch.io.png import decode_png, encode_png, to_u8
    from flux2_tpu_torch.serve import _DEMO_HTML, Flux2Server, _Pending

    out = {}
    server = Flux2Server(pipe, embeddings_fn=pipe.encode_prompt, batch_window_s=2.0)
    httpd, http = _serve_thread(server)
    try:
        def counted(label, flash, method, path, payload=None, raw=None):
            _zero_launches()
            t0 = time.perf_counter()
            status, headers, body = http(method, path, payload, raw)
            wall = time.perf_counter() - t0
            counts = _launch_counts(glue=True)
            _check_launches(label, counts, flash)
            out.setdefault("launches", {})[label] = counts["flash"]
            return status, headers, body, wall

        status, _, body, _ = counted("GET /health", 0, "GET", "/health")
        _expect("GET /health", status, 200, body)
        status, _, body, _ = counted("GET /info", 0, "GET", "/info")
        _expect("GET /info", status, 200, body)
        info = json.loads(body)
        if (info["backend"], info["devices"], info["model"]) != ("cuda", torch.cuda.device_count(), "klein-4b"):
            raise AssertionError(f"/info: {info}")
        status, _, body, _ = counted("GET /models", 0, "GET", "/models")
        _expect("GET /models", status, 200, body)
        models = json.loads(body)
        limit = torch.cuda.get_device_properties(0).total_memory
        if models["memory"]["bytes_limit"] != limit or models["loaded"]["model"] != "klein-4b":
            raise AssertionError(f"/models: memory {models['memory']}, loaded {models['loaded']}")
        status, headers, body, _ = counted("GET /", 0, "GET", "/")
        _expect("GET /", status, 200, body)
        if body != _DEMO_HTML.encode() or headers["Content-Type"] != "text/html; charset=utf-8":
            raise AssertionError("GET /: not the web UI")
        log(f"[http] /health, /info {info['backend']} x{info['devices']}, /models (memory "
            f"{models['memory']['bytes_limit'] / 2**30:.2f} GiB, recommended {models['recommended_quantization']}), "
            f"/ ({len(body)} bytes): launches 0 [{card}]")

        # /generate at 1024^2: PNG and JSON, against the in-process generate
        req = {"prompt": HTTP_PROMPT, "height": 1024, "width": 1024, "steps": 4, "seed": 21}
        walls = {"png": [], "json": [], "in_process": []}
        for rep in range(3):
            status, headers, body, wall = counted("POST /generate (PNG)", 100, "POST", "/generate", req)
            _expect("POST /generate", status, 200, body)
            walls["png"].append(wall)
            png = body
            status, headers, body, wall = counted("POST /generate (json)", 100, "POST", "/generate",
                                                  dict(req, format="json"))
            _expect("POST /generate json", status, 200, body)
            walls["json"].append(wall)
            json_png = base64.b64decode(json.loads(body)["image_png_base64"])
            _zero_launches()
            t0 = time.perf_counter()
            direct = server.generate_png(req)
            walls["in_process"].append(time.perf_counter() - t0)
            _check_launches("generate_png in the process", _launch_counts(glue=True), 100)
        res = pipe.generate(prompt=HTTP_PROMPT, height=1024, width=1024, num_steps=4, seed=21)
        want = to_u8(res.image)
        for label, data in (("PNG", png), ("json", json_png), ("generate_png", direct)):
            if not np.array_equal(decode_png(data), want):
                raise AssertionError(f"/generate {label}: pixels differ from the in-process generate's")
        image_u8 = decode_png(png)
        t_encode = [time.perf_counter()]
        for _ in range(5):
            encode_png(image_u8)
            t_encode.append(time.perf_counter())
        out["encode_png_s"] = statistics.median(b - a for a, b in zip(t_encode, t_encode[1:]))
        out["generate_s"] = {k: statistics.median(v[1:]) for k, v in walls.items()}
        log(f"[http] POST /generate 1024^2, 4 steps: PNG and json bodies and generate_png equal to the in-process "
            f"generate to the bit; K1 100 each; warm median of 2 (first in brackets): PNG "
            f"{out['generate_s']['png']:.4f} s ({walls['png'][0]:.4f}), json {out['generate_s']['json']:.4f} s "
            f"({walls['json'][0]:.4f}), in-process generate_png {out['generate_s']['in_process']:.4f} s "
            f"({walls['in_process'][0]:.4f}); the stdlib PNG encode of the 1024^2 image alone "
            f"{out['encode_png_s']:.4f} s; PNG {len(png)} bytes, json {len(body)} [{card}]")

        # three concurrent 256^2 requests: one batch
        small = [{"prompt": f"a small red fox over HTTP, variant {i}", "height": 256, "width": 256, "steps": 4,
                  "seed": 30 + i} for i in range(3)]
        for p in small:
            pipe.encode_prompt(p["prompt"])  # encoded before, so the three reach the queue together
        batches, results = server.batches_run, [None] * 3
        _zero_launches()
        t0 = time.perf_counter()
        threads = [threading.Thread(target=lambda i=i: results.__setitem__(i, http("POST", "/generate", small[i])))
                   for i in range(3)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=600)
        wall = time.perf_counter() - t0
        _check_launches("three concurrent 256^2 requests", _launch_counts(glue=True), 100)
        for r in results:
            _expect("POST /generate 256^2", r[0], 200, r[2])
            if decode_png(r[2]).shape != (256, 256, 3):
                raise AssertionError("256^2 request: wrong shape")
        if server.batches_run != batches + 1:
            raise AssertionError(f"three 256^2 requests ran in {server.batches_run - batches} batches, want 1")
        out["batch3_256_s"] = wall
        log(f"[http] three concurrent 256^2 POSTs: one batch, K1 100, {wall:.4f} s wall (with the 2 s window) "
            f"[{card}]")

        # /preview: 404 before the first step, then 200 with the step
        status, _, body, _ = counted("GET /preview (before)", 0, "GET", "/preview?id=http-preview")
        _expect("GET /preview before the first step", status, 404, body)
        seen, answer = [], []
        sender = threading.Thread(target=lambda: answer.append(http("POST", "/generate",
                                                                    dict(req, preview_id="http-preview"))))
        _zero_launches()
        sender.start()
        while sender.is_alive():
            st, headers, body = http("GET", "/preview?id=http-preview")
            if st == 200:
                seen.append((int(headers["X-Step"]), int(headers["X-Total-Steps"]), decode_png(body).shape))
            time.sleep(0.02)
        sender.join()
        _check_launches("a request with a preview id", _launch_counts(glue=True), 100)
        _expect("POST /generate with a preview id", answer[0][0], 200, answer[0][2])
        if not seen or any(not 1 <= k <= 4 or n != 4 or shape != (128, 128, 3) for k, n, shape in seen):
            raise AssertionError(f"/preview while running: {seen}")
        log(f"[http] /preview: 404 before the first step; while running, steps {sorted(set(k for k, _, _ in seen))} "
            f"of 4 seen in {len(seen)} polls, 128^2 PNGs [{card}]")

        # /embed
        prompt = "a bowl of ramen, embedded over HTTP"
        status, headers, body, wall = counted("POST /embed (npy)", 0, "POST", "/embed",
                                              {"prompt": prompt, "format": "npy"})
        _expect("POST /embed npy", status, 200, body)
        got = np.load(io.BytesIO(body))
        ref = pipe.encode_prompt(prompt).to(torch.float32).cpu().numpy()
        if got.dtype != np.float32 or not np.array_equal(got, ref):
            raise AssertionError(f"/embed npy: {got.dtype} {got.shape}, equal {np.array_equal(got, ref)}")
        status, _, body, wall_hit = counted("POST /embed (json)", 0, "POST", "/embed", {"prompt": prompt})
        _expect("POST /embed json", status, 200, body)
        stats = json.loads(body)
        norms = np.linalg.norm(ref[0], axis=-1)
        want_stats = {"shape": list(ref.shape), "dtype": "float32", "seq_len": int(ref.shape[-2]),
                      "dim": int(ref.shape[-1]), "mean": float(ref.mean()), "std": float(ref.std()),
                      "min": float(ref.min()), "max": float(ref.max()), "token_norm_mean": float(norms.mean()),
                      "token_norm_max": float(norms.max())}
        if stats != want_stats:
            raise AssertionError(f"/embed json {stats} != {want_stats}")
        out["embed_s"] = {"miss": wall, "hit": wall_hit}
        log(f"[http] POST /embed: npy {list(got.shape)} float32 equal to encode_prompt to the bit ({wall:.4f} s, a "
            f"new prompt), json stats equal ({wall_hit:.4f} s, an LRU hit) [{card}]")

        # /chat: the random Qwen3-4B through facade.shared (bf16: no kernel of the port), JSON and streamed
        messages = [{"role": "user", "content": "hello"}]
        chat = {"messages": messages, "max_tokens": 8, "temperature": 0.0}
        status, _, body, wall = counted("POST /chat (json)", 0, "POST", "/chat", chat)
        _expect("POST /chat json", status, 200, body)
        reply = json.loads(body)
        # "tokens" counts the streamed pieces: the dev tokenizer's 512 ids decode the random model's other
        # 151424 to "", which the think filter holds back, as JAX's
        if set(reply) != {"reply", "tokens", "duration_s", "tok_per_s"} or not 0 <= reply["tokens"] <= 8:
            raise AssertionError(f"/chat json: {reply}")
        status, headers, body, wall_stream = counted("POST /chat (stream)", 0, "POST", "/chat", dict(chat, stream=True))
        _expect("POST /chat stream", status, 200, body)
        visible, sep, trailer = body.decode("utf-8", errors="replace").partition("\x1e")
        stats = json.loads(trailer) if sep else {}
        if headers.get("Transfer-Encoding") != "chunked" or set(stats) != {"tokens", "duration_s", "tok_per_s"}:
            raise AssertionError(f"/chat stream: headers {headers}, trailer {trailer!r}")
        out["chat"] = {"json_s": wall, "stream_s": wall_stream, "tokens": reply["tokens"],
                       "tok_per_s": reply["tok_per_s"]}
        log(f"[http] POST /chat on the random-init Qwen3-4B: 200 JSON ({reply['tokens']} tokens, {wall:.4f} s, "
            f"{reply['tok_per_s']} tok/s) and 200 chunked with the \\x1e trailer {stats} ({wall_stream:.4f} s) "
            f"[{card}]")
        status, _, body, _ = counted("bad JSON", 0, "POST", "/generate", raw=b"{bad json")
        _expect("POST /generate with bad JSON", status, 400, body)
    finally:
        httpd.shutdown()
        httpd.server_close()
        server.shutdown()

    # a full queue (503) and a tiny timeout (504) on a server whose worker is stopped; /chat 503 on a
    # pipeline without an encoder, as a --no-text-encoder server's
    import dataclasses

    bare = dataclasses.replace(pipe, text_encoder=None, text_encoder_name=None, encoders=None)
    idle = Flux2Server(bare, embeddings_fn=pipe.encode_prompt, max_queue=1)
    idle.shutdown()
    httpd, http = _serve_thread(idle)
    try:
        _zero_launches()
        status, _, body = http("POST", "/generate", dict(req, timeout_s=1e-6))
        _expect("POST /generate timeout_s=1e-6", status, 504, body)
        status, _, body = http("POST", "/generate", req)  # the abandoned request still fills the one slot
        _expect("POST /generate to a full queue", status, 503, body)
        for stream in (False, True):
            status, _, body = http("POST", "/chat", {"messages": [{"role": "user", "content": "hi"}],
                                                     "stream": stream})
            _expect(f"POST /chat stream={stream} without an encoder", status, 503, body)
        _check_launches("504 and 503", _launch_counts(glue=True), 0)
    finally:
        httpd.shutdown()
        httpd.server_close()
    log(f"[http] bad JSON 400, /chat 503 without an encoder (JSON and streaming), timeout_s=1e-6 504, a full queue "
        f"503: launches 0 [{card}]")

    # cancel_all while a 1024^2 batch runs
    server = Flux2Server(pipe, embeddings_fn=pipe.encode_prompt)
    httpd, http = _serve_thread(server)
    try:
        answer = []
        sender = threading.Thread(target=lambda: answer.append(http("POST", "/generate",
                                                                    dict(req, seed=22, preview_id="cancel"))))
        _zero_launches()
        sender.start()
        deadline = time.time() + 120
        while server.get_preview("cancel") is None and time.time() < deadline:
            time.sleep(0.005)
        cancelled = server.cancel_all()
        sender.join(timeout=120)
        counts = _launch_counts(glue=True)
    finally:
        httpd.shutdown()
        httpd.server_close()
        server.shutdown()
    status, _, body = answer[0]
    _expect("a request cancelled by cancel_all", status, 400, body)
    error = json.loads(body)["error"]
    m = re.fullmatch(r"GenerationCancelled: cancelled at step (\d)/4", error)
    if m is None or cancelled != 1 or not 1 <= int(m.group(1)) < 4:
        raise AssertionError(f"cancel_all: {cancelled} cancelled, answer {error!r}")
    _check_launches("cancel_all during a 1024^2 batch", counts, 25 * int(m.group(1)))
    out["cancel_step"] = int(m.group(1))
    log(f"[http] cancel_all during a 1024^2 batch: 400 {error!r}, K1 {counts['flash']} launches [{card}]")

    # python -m flux2_tpu_torch.serve in a process of its own, w8a8
    out["serve_process"] = _serve_process(card)
    return out


def _serve_process(card: str) -> dict:
    """``python -m flux2_tpu_torch.serve --random-init --quantization w8a8
    --precompile 256 --port P``: its "serving on" line within 600 s, then two
    identical 256^2 requests whose PNGs must be valid and equal; then stopped."""
    import queue

    from flux2_tpu_torch.io.png import decode_png

    port = _free_port()
    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, "-m", "flux2_tpu_torch.serve", "--random-init", "--quantization", "w8a8",
                             "--precompile", "256", "--port", str(port)], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    lines: "queue.Queue" = queue.Queue()
    threading.Thread(target=lambda: [lines.put(line) for line in proc.stdout], daemon=True).start()
    try:
        ready, seen = None, []
        deadline = time.time() + 600
        while ready is None:
            try:
                line = lines.get(timeout=max(0.1, deadline - time.time()))
            except queue.Empty:
                raise AssertionError(f"serve printed no 'serving on' line in 600 s: {seen[-5:]}") from None
            seen.append(line.rstrip())
            if line.strip():
                log(f"[http serve] {line.rstrip()}")
            if "serving on" in line:
                ready = time.perf_counter() - t0
            elif proc.poll() is not None and lines.empty():
                raise AssertionError(f"serve exited {proc.returncode}: {seen[-5:]}")
        http = _Http(port)
        req = {"prompt": "a harbour at dawn, w8a8 over HTTP", "height": 256, "width": 256, "steps": 4, "seed": 3}
        bodies, walls = [], []
        for _ in range(2):
            t1 = time.perf_counter()
            status, headers, body = http("POST", "/generate", req)
            walls.append(time.perf_counter() - t1)
            _expect("serve process POST /generate", status, 200, body)
            bodies.append(body)
        images = [decode_png(b) for b in bodies]
        if images[0].shape != (256, 256, 3) or int(images[0].max()) == int(images[0].min()) or bodies[0] != bodies[1]:
            raise AssertionError(f"serve process: {images[0].shape}, equal {bodies[0] == bodies[1]}")
        precompile = [line for line in seen if line.startswith("precompiled")]
        log(f"[http serve] `python -m flux2_tpu_torch.serve --random-init --quantization w8a8 --precompile 256`: "
            f"'serving on' after {ready:.2f} s ({precompile}); two identical 256^2 requests: equal PNGs, "
            f"{walls[0]:.4f} s and {walls[1]:.4f} s [{card}]")
        return {"ready_s": ready, "request_s": walls}
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()


MASK_SEED = 10_001
SEG_REL_TOL = 1e-4  # the U-Net's probability, card against CPU, relative L2, both float32 without TF32


def phase_mask(pipe, card: str, workdir: str) -> dict:
    """Subject masks at 1024^2: a ``synth_composite`` (seed 10001) written as a
    PNG; ``mask-subject`` on it through cli.main on the card; its PNG equal to
    ``subject_mask`` computed in the process, through the same writer, to the
    bit; the raw subject mask's IoU > 0.5 on JAX's fixture (the same seed at
    256^2; JAX's criterion), the 1024^2 composite's logged; the U-Net's probability on the card against the same weights
    on the CPU in float32 (both with TF32 off) within ``SEG_REL_TOL``; which
    resize ran; then ``inpaint --mask`` with that mask on the composite at
    1024^2, 4 steps: K1 exactly 100, the tokens the mask keeps equal to the
    composite's latents to the bit."""
    import numpy as np

    from flux2_tpu_torch.chains import segmenter as seg
    from flux2_tpu_torch.chains.inpaint import pack_mask_for_latent_blending
    from flux2_tpu_torch.chains.subject_mask import default_segmenter, subject_mask
    from flux2_tpu_torch.io.png import decode_image, encode_png, to_u8

    out = {"resize": seg.resize_path()}
    image, truth = seg.synth_composite(np.random.RandomState(MASK_SEED), size=1024)
    image_path = _write_file(os.path.join(workdir, "composite.png"), encode_png(to_u8(image)))
    mask_path = os.path.join(workdir, "mask.png")
    _zero_launches()
    t0 = time.perf_counter()
    lines = _run_cli(["mask-subject", "--image", image_path, "-o", mask_path], "mask-subject", card, tag="mask")
    out["command_s"] = time.perf_counter() - t0
    _check_launches("mask-subject", _launch_counts(glue=True), 0)
    report = json.loads(lines[-1])
    loaded = decode_image(open(image_path, "rb").read())
    model = default_segmenter("cuda")
    mask = subject_mask(loaded, segmenter=model)
    if not np.array_equal(_read_png(mask_path), to_u8(np.repeat(mask[..., None], 3, axis=-1))):
        raise AssertionError("mask-subject's PNG differs from subject_mask in the process")
    if report["segmenter"] != "unet":
        raise AssertionError(f"mask-subject: {report}")
    # JAX's criterion (tests/test_segmenter.py): seed 10001's composite at the
    # working size, the raw mask's IoU > 0.5; at 1024^2 the same seed's finer
    # texture defeats the trained U-Net in both packages (IoU 0.2172 on the CPU)
    fixture, fixture_truth = seg.synth_composite(np.random.RandomState(MASK_SEED))
    out["iou"] = seg.iou(subject_mask(fixture, segmenter=model, dilation_px=0, ramp_px=0,
                                      invert_for_change_scene=False), fixture_truth)
    if not out["iou"] > 0.5:
        raise AssertionError(f"subject mask IoU {out['iou']} <= 0.5 on JAX's 256^2 fixture")
    out["iou_1024"] = seg.iou(subject_mask(loaded, segmenter=model, dilation_px=0, ramp_px=0,
                                           invert_for_change_scene=False), truth)

    small = seg._resize_np(loaded, seg.WORK_RES, seg.WORK_RES)[None]
    on_card = model.predict(small)
    on_cpu = seg.load_default("cpu").predict(small)
    out["prob_rel_l2"] = float(np.linalg.norm(on_card - on_cpu) / np.linalg.norm(on_cpu))
    flips = int(((on_card >= 0.5) != (on_cpu >= 0.5)).sum())
    if not out["prob_rel_l2"] <= SEG_REL_TOL:
        raise AssertionError(f"U-Net on the card vs the CPU: relative L2 {out['prob_rel_l2']} > {SEG_REL_TOL}")
    x = torch.from_numpy(small).cuda().permute(0, 3, 1, 2).contiguous()
    with torch.inference_mode():
        out["unet_ms"] = time_ms(lambda: model.model(x), reps=20, warmup=3)
    t0 = time.perf_counter()
    for _ in range(3):
        subject_mask(loaded, segmenter=model)
    out["subject_mask_s"] = (time.perf_counter() - t0) / 3
    log(f"[mask] mask-subject 1024^2 composite (seed {MASK_SEED}): {report}; PNG equal to subject_mask in the "
        f"process; raw-mask IoU {out['iou']:.4f} on JAX's 256^2 fixture (> 0.5), {out['iou_1024']:.4f} on the 1024^2 "
        f"composite; resize "
        f"{out['resize']}; U-Net card vs CPU (f32, TF32 off) relative L2 {out['prob_rel_l2']:.3e} (tol "
        f"{SEG_REL_TOL}), {flips} of 65536 pixels flip at 0.5; U-Net forward at 256^2 {out['unet_ms']:.4f} ms "
        f"warm; subject_mask {out['subject_mask_s']:.4f} s; the command {out['command_s']:.3f} s; launches 0 "
        f"[{card}]")

    out_path = os.path.join(workdir, "inpainted.png")
    with _HandedPipeline(pipe) as rec:
        _zero_launches()
        _run_cli(["inpaint", "--random-init", "--image", image_path, "--mask", mask_path, "--prompt",
                  "a sunlit meadow around the subject", "--seed", str(EDIT_SEED), "--steps", "4", "-o", out_path],
                 "inpaint --mask <subject mask>", card, tag="mask")
        counts = _launch_counts(glue=True)
    _check_launches("inpaint with the subject mask", counts, 25 * 4)
    res = rec.results[-1]
    out["inpaint_launches"] = counts["flash"]
    source = pipe.encode_image_to_packed_sequence(loaded)
    plane = _read_png(mask_path)[..., 0].astype(np.float32) / 255.0  # the mask as inpaint read it
    keep = pack_mask_for_latent_blending(plane, 1024, 1024)[0, :, 0].cuda() == 0
    if not torch.equal(res.latents_device[0, keep], source[0, keep]) or not int(keep.sum()) > 0:
        raise AssertionError(f"inpaint with the subject mask: {int(keep.sum())} kept tokens equal to the source "
                             f"{torch.equal(res.latents_device[0, keep], source[0, keep])}")
    _valid_image("inpaint with the subject mask", _read_png(out_path).astype(np.float32) / 255.0, (1024, 1024, 3))
    out["inpaint_s_per_step"] = _s_per_step(res)
    log(f"[mask] inpaint --mask <subject mask> 1024^2, 4 steps: launches {counts}; {int(keep.sum())} of 4096 tokens "
        f"kept, equal to the composite's latents to the bit; {out['inpaint_s_per_step']:.4f} s/step [{card}]")
    return out


def encode_ms(extractor) -> float:
    """Median of 5 warm encodes of one prompt (the extractor itself: no prompt cache), CUDA events."""
    return time_ms(lambda: extractor("a warm encode of one prompt"), reps=5, warmup=2)


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
    log(f"[model] one warm encode (512 tokens), built-in random-init Qwen3-4B shape (head_dim "
        f"{pipe.text_encoder.decoder.cfg.head_dim}): {encode_ms(pipe.text_encoder):.3f} ms [{card}]")
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


# -- checkpoint round trip and `profile` ------------------------------------------------

# Qwen/Qwen3-4B's published config.json (the fields DecoderConfig reads): the
# built-in QWEN3_4B is a random-init shape (head_dim 80, intermediate 9216).
QWEN3_4B_CONFIG_JSON = {
    "architectures": ["Qwen3ForCausalLM"], "model_type": "qwen3", "vocab_size": 151936, "hidden_size": 2560,
    "intermediate_size": 9728, "num_hidden_layers": 36, "num_attention_heads": 32, "num_key_value_heads": 8,
    "head_dim": 128, "rope_theta": 1000000, "rms_norm_eps": 1e-06, "tie_word_embeddings": True,
    "max_position_embeddings": 40960, "torch_dtype": "bfloat16",
}
KLEIN_RECIPE_DEPTH = 28  # the Klein recipe reads hidden layers 9, 18 and 27
ROUND_TRIP = {"prompt": "a lighthouse on a cliff at dusk, from a checkpoint", "seed": 5}


def _run_cli(argv: list, label: str, card: str, tag: str = "ckpt") -> list:
    """cli.main.main(argv) in this process; its standard output is logged
    (``[tag label]``) and returned as lines."""
    import contextlib
    import io

    from flux2_tpu_torch.cli import main as cli

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        if cli.main(argv) != 0:
            raise AssertionError(f"{label} exited non-zero")
    lines = buf.getvalue().strip().splitlines()
    for line in lines:  # a random model's text is random bytes: escaped
        log(f"[{tag} {label}] {line if line.isprintable() else ascii(line)}")
    log(f"[{tag} {label}] {time.perf_counter() - t0:.2f} s of command [{card}]")
    return lines


def _cli_process(argv: list, label: str, card: str) -> dict:
    """``python -m flux2_tpu_torch.cli.main`` as a user runs it, in a process of
    its own: its wall time (start-up, kernel library load, checkpoint load,
    request) and its own peak resident set (``os.wait4``'s rusage)."""
    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, "-m", "flux2_tpu_torch.cli.main", *argv], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    out = proc.stdout.read()
    _, status, usage = os.wait4(proc.pid, 0)
    proc.returncode = os.waitstatus_to_exitcode(status)
    wall = time.perf_counter() - t0
    for line in out.strip().splitlines():
        log(f"[ckpt {label}] {line}")
    if proc.returncode != 0:
        raise AssertionError(f"{label} exited {proc.returncode}")
    peak_gib = usage.ru_maxrss * 1024 / 2**30
    bare = subprocess.run([sys.executable, "-c", "import resource; print(resource.getrusage(resource.RUSAGE_SELF)"
                           ".ru_maxrss * 1024 / 2**30)"], capture_output=True, text=True, timeout=60, check=True)
    log(f"[ckpt {label}] its own process: {wall:.2f} s wall, host peak RSS {peak_gib:.2f} GiB (ru_maxrss by "
        f"os.wait4; a bare python process reads its own as {float(bare.stdout):.3f} GiB) [{card}]")
    return {"wall_s": wall, "host_peak_gib": peak_gib}


def _encode_launches_w8a8(decoder) -> int:
    """K5 launches of one encode (512 tokens): the decoder's w8a8 weights that pass K5's gate."""
    from flux2_tpu_torch.ops import quant as tq

    n = 0
    for name in tq.quantized_names(decoder):
        w = decoder.get_submodule(name)
        x = torch.empty(512, w.orig_in, device="cuda", dtype=torch.bfloat16)
        n += tq.kernel_route(x, w) == "w8a8"
    return n


def phase_checkpoint_round_trip(card: str, workdir: str) -> dict:
    """Full-width Klein-4B, the FLUX.2 VAE and Qwen3-4B at its published shape,
    drawn on the card: one 1024^2 request in memory; the three written as
    checkpoint directories (DiT in the Diffusers dialect, sharded; VAE in
    AutoencoderKL names; Qwen3 in HF names with the dev tokenizer); then
    ``t2i`` from them through cli.main (latents and PNG equal to the
    in-memory request's to the bit, K1 100 launches), ``profile --compare
    bf16,w8a8`` and ``profile --trace``, each with exact launch counts."""
    import dataclasses
    import shutil

    import numpy as np

    from flux2_tpu_torch.cli import main as cli
    from flux2_tpu_torch.io.png import encode_png
    from flux2_tpu_torch.models.text_encoders.config import DecoderConfig
    from flux2_tpu_torch.models.text_encoders.decoder import Qwen3Decoder
    from flux2_tpu_torch.models.text_encoders.extractor import qwen3_extractor
    from flux2_tpu_torch.pipeline.pipeline import Flux2Model, Flux2Pipeline
    from flux2_tpu_torch.utils import inline_bpe_tokenizer
    from flux2_tpu_torch.utils import memory as tmem
    from flux2_tpu_torch.utils import profiler as tprof
    from flux2_tpu_torch.utils import synthetic

    gen = torch.Generator(device="cuda").manual_seed(SEED + 8)
    pipe = Flux2Pipeline.from_random(Flux2Model.KLEIN_4B, device="cuda", generator=gen)
    enc_cfg = DecoderConfig.from_json_dict(QWEN3_4B_CONFIG_JSON, qk_norm=True)
    tokenizer = inline_bpe_tokenizer()
    pipe.text_encoder = qwen3_extractor(Qwen3Decoder(enc_cfg, device="cuda", generator=gen), tokenizer)
    res = pipe.generate(height=1024, width=1024, **ROUND_TRIP)
    latents = res.latents_device.cpu()
    png = encode_png(np.rint(res.image * 255.0).astype(np.uint8))
    log(f"[ckpt] in-memory request, published-shape Qwen3-4B ({enc_cfg.num_hidden_layers} layers, head_dim "
        f"{enc_cfg.head_dim}, intermediate {enc_cfg.intermediate_size}): {res.duration_s:.3f} s, phases "
        f"{ {k: round(v, 4) for k, v in res.phase_timings.items()} } [{card}]")

    log(f"[ckpt] one warm encode (512 tokens), published Qwen3-4B shape: {encode_ms(pipe.text_encoder):.3f} ms "
        f"[{card}]")
    decoder = pipe.text_encoder.decoder
    free = shutil.disk_usage(workdir).free
    need = sum(t.numel() * t.element_size() for m in (pipe.transformer, pipe.vae, pipe.vae_encoder, decoder)
               for t in m.state_dict().values()) + PREQUANT_DISK_BYTES  # phase_lora_prequant's files too
    layers = enc_cfg.num_hidden_layers
    if free < 1.1 * need:
        layers = KLEIN_RECIPE_DEPTH  # layers 28-35 never reach the Klein embedding
        log(f"[ckpt] CUT: {free / 2**30:.1f} GiB free for {need / 2**30:.1f} GiB: the encoder is written with "
            f"{layers} of its {enc_cfg.num_hidden_layers} layers [{card}]")
    dirs = {k: os.path.join(workdir, k) for k in ("transformer", "vae", "text_encoder")}
    t0 = time.perf_counter()
    written = {
        "transformer": synthetic.write_sharded(
            dirs["transformer"], synthetic.diffusers_transformer_state(pipe.transformer), "diffusion_pytorch_model",
            {"_class_name": "Flux2Transformer2DModel", **dataclasses.asdict(pipe.transformer.config)}),
        "vae": synthetic.write_sharded(
            dirs["vae"], synthetic.autoencoder_state(pipe.vae, pipe.vae_encoder), "diffusion_pytorch_model",
            {"_class_name": "AutoencoderKLFlux2", **dataclasses.asdict(pipe.vae.config)}),
        "text_encoder": synthetic.write_sharded(dirs["text_encoder"], synthetic.qwen3_state(decoder, layers), "model",
                                                dict(QWEN3_4B_CONFIG_JSON, num_hidden_layers=layers)),
    }
    tokenizer.save_pretrained(dirs["text_encoder"])
    log(f"[ckpt] wrote {', '.join(f'{k} {v / 2**30:.2f} GiB' for k, v in written.items())} in "
        f"{time.perf_counter() - t0:.2f} s ({free / 2**30:.1f} GiB free before) [{card}]")
    del pipe, decoder, res
    gc_cuda()

    dir_flags = ["--transformer-dir", dirs["transformer"], "--vae-dir", dirs["vae"], "--encoder-dir",
                 dirs["text_encoder"]]
    built, load = [], {}
    original = cli.build_pipeline

    def recording_build(args, device, *a, **k):
        """The CLI's build_pipeline, with its load measured: host peak RSS
        from the start of the build, device memory after it."""
        reset = tmem.reset_host_peak_rss()
        p = original(args, device, *a, **k)
        torch.cuda.synchronize()
        peak, scope = tmem.host_peak_rss_bytes()
        load.update(host_peak_gib=peak / 2**30, host_peak_scope=scope if reset else "ru_maxrss",
                    device_gib=torch.cuda.memory_allocated() / 2**30,
                    encode_w8a8=_encode_launches_w8a8(p.text_encoder.decoder))
        if built is not None:
            built.append(_RecordingPipeline(p))
            return built[-1]
        return p

    cli.build_pipeline = recording_build
    try:
        # t2i: load, one request; the load's phases are read from the shared profiler
        tprof._shared = tprof.PhaseProfiler(enabled=True)
        out_png = os.path.join(workdir, "t2i.png")
        _zero_launches()
        lines = _run_cli(["t2i", *dir_flags, "--prompt", ROUND_TRIP["prompt"], "--seed", str(ROUND_TRIP["seed"]),
                          "-o", out_png], "t2i", card)
        counts = _launch_counts()
        phases = tprof.shared().phases
        (rec,) = built
        built = None  # the profile runs below must free each pipeline
        got = rec.results[0].latents_device.cpu()
        if not torch.equal(got, latents):
            raise AssertionError(f"t2i from the checkpoint: latents differ from the in-memory request's, max abs "
                                 f"{float((got - latents).abs().max())}")
        with open(out_png, "rb") as f:
            if f.read() != png:
                raise AssertionError("t2i from the checkpoint: the PNG differs from the in-memory request's")
        want = {name: 0 for name in counts}
        want["flash"] = 25 * 4
        if counts != want or lines[0] != f"saved {out_png}":
            raise AssertionError(f"t2i launched {counts}, want {want}; printed {lines}")
        report = json.loads(lines[-1])
        log(f"[ckpt load] transformer {phases['4. Load Transformer']:.3f} s, VAE {phases['5. Load VAE']:.3f} s, "
            f"encoder {phases['1. Load Text Encoder']:.3f} s ({sum(written.values()) / 2**30:.2f} GiB); host peak RSS "
            f"{load['host_peak_gib']:.2f} GiB ({load['host_peak_scope']}); device memory after load {load['device_gib']:.2f} GiB [{card}]")
        log(f"[ckpt t2i] 1024^2 from the checkpoint: latents and PNG equal to the in-memory request's to the bit; "
            f"launches {counts}; duration {report['duration_s']} s, phases {report['phases']}, memory_gb "
            f"{report.get('memory_gb')} [{card}]")
        del rec
        gc_cuda()

        # the same t2i as its own process: its PNG, wall time and host peak
        proc_png = os.path.join(workdir, "t2i_process.png")
        proc = _cli_process(["t2i", *dir_flags, "--prompt", ROUND_TRIP["prompt"], "--seed", str(ROUND_TRIP["seed"]),
                             "-o", proc_png], "t2i process", card)
        with open(proc_png, "rb") as f:
            if f.read() != png:
                raise AssertionError("t2i in its own process: the PNG differs from the in-memory request's")

        # profile --compare bf16,w8a8, the encoder in w8a8 in both configurations
        tprof._shared = None
        _zero_launches()
        lines = _run_cli(["profile", *dir_flags, "--prompt", ROUND_TRIP["prompt"], "--compare", "bf16,w8a8",
                          "--encoder-quantization", "w8a8", "--warmup", "1", "--runs", "3"], "profile --compare", card)
        counts = _launch_counts()
        encode = load["encode_w8a8"]
        k5 = FORWARD_LAUNCHES["w8a8"] * 4 * 4 + 2 * encode  # 4 generates of 4 steps in w8a8; one encode a config
        want = {name: 0 for name in counts}
        want.update(flash=25 * 4 * 4 * 2, w8a8=k5, quantize_rows=k5)
        if counts != want:
            raise AssertionError(f"profile --compare launched {counts}, want {want} (one encode: {encode} K5)")
        stats = json.loads(lines[-1])
        log(f"[ckpt profile] phase report of the two configurations, loads included [{card}]")
        log(tprof.shared().report())
        log(f"[ckpt profile] --compare bf16,w8a8 at 1024^2, 4 steps, warmup 1, runs 3: {stats}; launches {counts} "
            f"(K5 {FORWARD_LAUNCHES['w8a8']} a forward, {encode} an encode of the published-shape Qwen3-4B) [{card}]")
        gc_cuda()

        # profile --trace, bf16
        tprof._shared = None
        trace = os.path.join(workdir, "trace.json")
        _zero_launches()
        lines = _run_cli(["profile", *dir_flags, "--prompt", ROUND_TRIP["prompt"], "--runs", "2", "--trace", trace],
                         "profile --trace", card)
        counts = _launch_counts()
        want = {name: 0 for name in counts}
        want["flash"] = 25 * 4 * 3
        with open(trace) as f:
            names = [e["name"] for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
        missing = [p for p in ("1. Text Encoding", "2. Denoising", "3. VAE Decoding") if names.count(p) != 3]
        if counts != want or missing:
            raise AssertionError(f"profile --trace launched {counts}, want {want}; phases short in the trace: {missing}")
        log(f"[ckpt profile] --trace: {len(names)} Chrome-trace events, the three generate phases 3 times each; "
            f"launches {counts} [{card}]")
    finally:
        cli.build_pipeline = original
        tprof._shared = None
    return {"load": load, "phases": phases, "written": written, "compare": stats, "t2i": report, "process": proc,
            "dirs": dirs}


# -- real-data LoRA training -----------------------------------------------------------------


VAL_CAPTIONS = ("a watercolour of a lighthouse", "a red bicycle against a brick wall")
TRIGGER = "sks"
TRAIN_REAL_STEPS = 4
TRAIN_REAL_YAML = """model: {{name: klein-4b}}
lora: {{rank: 16, alpha: 16, target_layers: attention_ffn}}
dataset: {{path: {data}, image_size: 512, trigger_word: sks{control}{validation}}}
training: {{optimizer: adamw, learning_rate: 1.0e-4, warmup_steps: 0, lr_scheduler: constant, batch_size: 1,
  max_steps: {steps}, log_every: 1, caption_dropout: {caption_dropout}}}
loss: {{diff_output_preservation: {dop}, diff_output_preservation_multiplier: 0.5,
  diff_output_preservation_every_n_steps: 2}}
memory: {{gradient_checkpointing: {remat}, cache_latents: true, cache_text_embeddings: true}}
ema: {{enabled: {ema}, decay: 0.9}}
checkpoints: {{output: {out}, save_every: 2}}
{validation_block}"""
PREVIEW = {"prompt": "a portrait of sks, studio light", "is_512": True}


def _train_real_yaml(path: str, data: dict, out: str, *, steps: int, control: bool, validation: bool,
                     remat: str = "true") -> str:
    """A train-lora YAML in the reference schema: the dataset at 512^2 with the
    trigger; with ``control``, its control directory, control and caption
    dropout, DOP every 2 steps and the EMA; with ``validation``, one preview
    prompt (512^2, 4 steps, every 2 steps, the step-0 baseline, the pixel
    scorer) and the held-out dataset."""
    text = TRAIN_REAL_YAML.format(
        data=data["dataset"], steps=steps, out=out, remat=remat,
        control=f", control_path: {data['control']}, control_dropout: 0.25" if control else "",
        validation=f", validation_path: {data['validation']}" if validation else "",
        caption_dropout=0.25 if control else 0.0, dop="true" if control else "false", ema="true" if control else "false",
        validation_block=(f"validation: {{prompts: [{json.dumps(PREVIEW)}], every_n_steps: 2, steps: 4, size: 512,\n"
                          "  vlm_scoring: {enabled: true, compare_to_baseline: true}}\n") if validation else "")
    with open(path, "w") as f:
        f.write(text)
    return path


class _Calls:
    """Counts the calls of ``owner.name`` (a method or function) while active."""

    def __init__(self, owner, name: str):
        self.owner, self.name, self.n = owner, name, 0

    def __enter__(self):
        self.original = getattr(self.owner, self.name)
        original = self.original

        def counted(*args, **kw):
            self.n += 1
            return original(*args, **kw)

        setattr(self.owner, self.name, counted)
        return self

    def __exit__(self, *exc):
        setattr(self.owner, self.name, self.original)


def _set_launches(counts: dict) -> None:
    """Put the kernels' counts back (after launches that compared a kernel with its plain version)."""
    from flux2_tpu_torch.ops import flash_attention as fa
    from flux2_tpu_torch.ops import quant_kernels as qk

    fa.launches, fa.launches_lse = counts["flash"], counts["flash_lse"]
    fa.launches_dq, fa.launches_dkv = counts["flash_bwd_dq"], counts["flash_bwd_dkv"]
    qk.launches.update({k: counts[k] for k in qk.launches if k in counts})


class _FirstStepAgainstPlain:
    """Wraps ``trainer.make_train_step`` so that, before the first step, the
    same step's loss (its draws from a copy of the step's generator) runs
    with the quantized kernel's plain version in its place; those launches
    are taken back out of the counts."""

    def __init__(self, kernel: str):
        self.kernel, self.pair = kernel, None

    def __enter__(self):
        from flux2_tpu_torch.training import trainer

        self.make = trainer.make_train_step
        trainer.make_train_step = self._make
        return self

    def __exit__(self, *exc):
        from flux2_tpu_torch.training import trainer

        trainer.make_train_step = self.make

    def _make(self, transformer, tcfg, forward_fn=None):
        from flux2_tpu_torch.ops import quant_kernels as qk
        from flux2_tpu_torch.training import trainer

        step = self.make(transformer, tcfg, forward_fn=forward_fn)

        def first_checked(lora, optimizer, batch, gen):
            if self.pair is not None:
                return step(lora, optimizer, batch, gen)
            g = torch.Generator(gen.device)
            g.set_state(gen.get_state())
            saved = _launch_counts()
            launch = getattr(qk, self.kernel)
            setattr(qk, self.kernel, getattr(qk, self.kernel + "_reference"))
            try:
                with torch.no_grad():
                    sigmas, noise = trainer._draw(tcfg, g, batch["latents"])
                    plain = trainer.flow_matching_loss(transformer, lora, tcfg, batch["latents"], batch["embeddings"],
                                                       noise, sigmas, batch["rope_cos"], batch["rope_sin"],
                                                       guidance=batch.get("guidance"), control=batch.get("control"),
                                                       forward_fn=forward_fn)
                    plain = float(plain)
            finally:
                setattr(qk, self.kernel, launch)
                _set_launches(saved)
            metrics = step(lora, optimizer, batch, gen)
            self.pair = (float(metrics["loss"]), plain)
            return metrics

        return first_checked


def _train(argv: list, label: str, card: str) -> tuple:
    """``train-lora`` through the port's parser and run_training in this
    process: (history, launches, seconds, peak GiB, captured log lines)."""
    import contextlib
    import io

    from flux2_tpu_torch.cli.main import parse_args
    from flux2_tpu_torch.cli.train import run_training

    args = parse_args(["train-lora", *argv, "--device", "cuda"])
    torch.cuda.reset_peak_memory_stats()
    err = io.StringIO()
    _zero_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(err):
        history = run_training(args, "cuda")
    wall = time.perf_counter() - t0
    counts = _launch_counts()
    for line in err.getvalue().strip().splitlines():
        log(f"[train-real {label}] {line}")
    if not history or not all(r["loss"] == r["loss"] and abs(r["loss"]) < float("inf") and r["grad_norm"] > 0
                              for r in history):
        raise AssertionError(f"{label}: a loss is not finite or a gradient norm is 0: {history}")
    for r in history:
        log(f"[train-real {label}] step {r['step']}: loss {r['loss']:.6f}, dop_loss {r['dop_loss']:.6f}, grad_norm "
            f"{r['grad_norm']:.6f}, {r['seconds']:.4f} s [{card}]")
    return history, counts, wall, torch.cuda.max_memory_allocated() / 2**30, err.getvalue()


def _loras_equal(a: dict, b: dict) -> tuple:
    import numpy as np

    if sorted(a) != sorted(b):
        raise AssertionError(f"LoRA names differ: {sorted(a)[:3]} vs {sorted(b)[:3]}")
    equal = all(np.array_equal(a[k], b[k]) for k in a)
    rel = max(float(np.linalg.norm(a[k] - b[k]) / max(np.linalg.norm(b[k]), 1e-30)) for k in a)
    return equal, rel


def _phase_random_real(card: str, workdir: str, data: dict) -> dict:
    """A: ``train-lora --random-init`` on the dataset (control images, caption
    and control dropout, DOP every 2 steps, EMA, both disk caches, previews at
    steps 0, 2 and 4, the held-out loss), then ``--resume`` from step 2 in the
    same output directory."""
    import numpy as np
    import safetensors.numpy

    from flux2_tpu_torch.cli import train as cli_train
    from flux2_tpu_torch.models.text_encoders.extractor import EmbeddingExtractor
    from flux2_tpu_torch.pipeline.pipeline import Flux2Pipeline
    from flux2_tpu_torch.training import data as td

    out = os.path.join(workdir, "real")
    cfg = _train_real_yaml(os.path.join(workdir, "real.yaml"), data, out, steps=TRAIN_REAL_STEPS, control=True,
                           validation=True)
    captured = {}
    build = cli_train._build_random_pipeline

    def capture(*a, **kw):
        pipe = build(*a, **kw)
        torch.cuda.synchronize()
        captured["pipe"] = pipe
        captured["base"] = [t.clone() for t in pipe.transformer.state_dict().values()]
        captured["k5_per_encode"] = _encode_launches_w8a8(pipe.text_encoder.decoder)
        return pipe

    cli_train._build_random_pipeline = capture
    try:
        with _Calls(Flux2Pipeline, "encode_image_to_packed_sequence") as vae, _Calls(EmbeddingExtractor, "__call__") as enc:
            history, counts, wall, peak, err = _train(["--config", cfg, "--random-init"], "A", card)
        pipe, k5 = captured["pipe"], captured["k5_per_encode"]
        base_unchanged = all(torch.equal(a, b) for a, b in zip(captured.pop("base"), pipe.transformer.state_dict().values()))
        if not base_unchanged:
            raise AssertionError("A: the training base's bytes changed across the run (validation merged into it: R5)")
        # 2 paired items (one per bucket) + their control images; captions: 2 items, "" (caption dropout), 2 DOP,
        # 2 held-out items, the preview prompt and the "" of its classical CFG on the validation pipeline
        steps, dop_steps, passes, val_passes, n_val = TRAIN_REAL_STEPS, TRAIN_REAL_STEPS // 2, 3, 2, 2
        want = {"flash_lse": 50 * (steps + dop_steps), "flash_bwd_dq": 25 * (steps + dop_steps),
                "flash_bwd_dkv": 25 * (steps + dop_steps),
                "flash": 25 * dop_steps + 100 * passes + 25 * n_val * val_passes,
                "w8a8": 9 * k5, "quantize_rows": 9 * k5}
        if (vae.n, enc.n) != (4 + 2, 9):
            raise AssertionError(f"A: {vae.n} VAE encodes (want 4 + 2 held-out) and {enc.n} caption encodes (want 9)")
        _expect_counts("A: train-lora --random-init on the dataset", counts, want)
        cache = os.path.join(out, "latent_cache")
        npy = sorted(f for f in os.listdir(cache) if f.endswith(".npy"))
        buckets = td.scaled_buckets(512)
        items = [it for it in td.load_dataset(data["dataset"], trigger=TRIGGER, control_dir=data["control"],
                                              buckets=buckets) if it.control_path]
        lc = td.LatentCache(cache, "flux2-vae32-v1")
        images = items + [td.DatasetItem(it.control_path, "", it.bucket) for it in items]
        if len(npy) != len(images) or sorted(lc._key(it) + ".npy" for it in images) != npy:
            raise AssertionError(f"A: latent cache holds {npy}, want one .npy per image ({len(images)})")
        worst = 0.0
        for it in images:
            direct = pipe.encode_image_to_packed_sequence(td.load_image(it.image_path, *it.bucket)).cpu().numpy()
            cached = np.load(os.path.join(cache, lc._key(it) + ".npy"))
            if not np.array_equal(direct, cached):
                raise AssertionError(f"A: the cached latents of {it.image_path} differ from a direct encode "
                                     f"(max abs {np.abs(direct - cached).max()})")
        pngs = sorted(os.listdir(os.path.join(out, "validation")))
        want_png = [f"val_{s:06d}_p0_0.png" for s in (0, 2, 4)]
        meta = json.load(open(os.path.join(out, "checkpoint_000004", "training_state.json")))
        if pngs != want_png or not os.path.isdir(os.path.join(out, "best")) or len(meta["val_loss_history"]) != 2:
            raise AssertionError(f"A: validation PNGs {pngs} (want {want_png}), best/ "
                                 f"{os.path.isdir(os.path.join(out, 'best'))}, val_loss_history "
                                 f"{meta['val_loss_history']}")
        opt_keys = sorted(safetensors.numpy.load_file(os.path.join(out, "checkpoint_000002", "optimizer.safetensors")))
        if not all(k.startswith("[1][") for k in opt_keys) or "[1][0].count" not in opt_keys:
            raise AssertionError(f"A: optimizer.safetensors holds {opt_keys[:4]}, not JAX's optax tree paths")
        log(f"[train-real A] train-lora --random-init, Klein-4B-base + random w8a8 Qwen3-4B, {len(items)} paired items "
            f"in 2 buckets at 512^2, {steps} steps (DOP on {dop_steps}), previews at 0/2/4, held-out loss at 2/4: "
            f"{wall:.2f} s; losses {[round(r['loss'], 5) for r in history]}; {statistics.mean(r['seconds'] for r in history[1:]):.4f} "
            f"s/step warm; peak {peak:.2f} GiB; {vae.n} VAE encodes, {enc.n} caption encodes ({k5} K5 each); "
            f"launches {counts}; cached latents equal to direct encodes to the bit ({len(images)}); the base's bytes "
            f"unchanged (R5); val_loss_history {[round(v['loss'], 5) for v in meta['val_loss_history']]}; optimizer "
            f"keys JAX's ({len(opt_keys)}) [{card}]")
        final = safetensors.numpy.load_file(os.path.join(out, "checkpoint_000004", "lora.safetensors"))
        del pipe
        captured.clear()
        gc_cuda()

        # the same run resumed from step 2: both disk caches hit, the LoRA of the uninterrupted run
        with _Calls(Flux2Pipeline, "encode_image_to_packed_sequence") as vae, _Calls(EmbeddingExtractor, "__call__") as enc:
            history_r, counts_r, wall_r, _, _ = _train(
                ["--config", cfg, "--random-init", "--resume", os.path.join(out, "checkpoint_000002")], "A resume", card)
        k5 = captured["k5_per_encode"]
        want_r = {"flash_lse": 50 * 3, "flash_bwd_dq": 25 * 3, "flash_bwd_dkv": 25 * 3, "flash": 25 + 100 + 25 * n_val,
                  "w8a8": 2 * k5, "quantize_rows": 2 * k5}  # the preview prompt and its "" only
        if [r["step"] for r in history_r] != [3, 4] or vae.n or enc.n != 2:
            raise AssertionError(f"A resume: steps {[r['step'] for r in history_r]}, {vae.n} VAE encodes (want 0), "
                                 f"{enc.n} caption encodes (want 2: the preview prompt and its '')")
        _expect_counts("A resume", counts_r, want_r)
        equal, rel = _loras_equal(safetensors.numpy.load_file(os.path.join(out, "checkpoint_000004", "lora.safetensors")),
                                  final)
        if not equal and rel > 1e-6:
            raise AssertionError(f"A resume: the LoRA differs from the uninterrupted run's: relative {rel}")
        log(f"[train-real A resume] --resume checkpoint_000002 (JAX-keyed optimizer state, strict): steps 3-4 in "
            f"{wall_r:.2f} s, {vae.n} VAE encodes and no caption encode (both disk caches hit); launches {counts_r}; "
            f"final LoRA {'equal to the bit to' if equal else f'within {rel:.3e} relative of'} the uninterrupted "
            f"run's [{card}]")
    finally:
        cli_train._build_random_pipeline = build
        captured.clear()
        gc_cuda()
    return {"counts": counts, "counts_resume": counts_r, "s_per_step": statistics.mean(r["seconds"] for r in history[1:]),
            "wall_s": wall, "peak_gib": peak, "resume_equal": equal}


def _phase_qlora_cli(card: str, workdir: str, data: dict, dir_flags: list) -> dict:
    """B: ``train-lora`` from the checkpoint directories on the dataset with
    ``--quantization w8a8`` and, under FLUX2_PALLAS_DEQUANT=1, ``qint8``
    (QLoRA from the CLI): 3 steps each, exact launches, the first step's loss
    against the same step with the kernel's plain version in its place."""
    out = {}
    for fmt, kernel, counter in (("w8a8", "w8a8_matmul", "w8a8"), ("qint8", "dequant_matmul", "dequant_int8")):
        run_dir = os.path.join(workdir, f"qlora_{fmt}")
        cfg = _train_real_yaml(os.path.join(workdir, f"qlora_{fmt}.yaml"), data, run_dir, steps=QLORA_STEPS,
                               control=False, validation=False)
        if fmt == "qint8":
            os.environ["FLUX2_PALLAS_DEQUANT"] = "1"
        try:
            with _FirstStepAgainstPlain(kernel) as first:
                history, counts, wall, peak, _ = _train(["--config", cfg, *dir_flags, "--quantization", fmt],
                                                        f"B {fmt}", card)
        finally:
            os.environ.pop("FLUX2_PALLAS_DEQUANT", None)
        want = {name: n * QLORA_STEPS for name, n in {**STEP_LAUNCHES, **QLORA_STEP_LAUNCHES[fmt]}.items()}
        _expect_counts(f"B: train-lora --quantization {fmt} from checkpoints", counts, want)
        loss_k, loss_p = first.pair
        rel = abs(loss_k - loss_p) / abs(loss_p)
        if rel > TRAIN_LOSS_REL_TOL:
            raise AssertionError(f"B {fmt}: first-step loss {loss_k} vs {loss_p} with the plain {kernel} (relative "
                                 f"{rel}, tol {TRAIN_LOSS_REL_TOL})")
        s_per_step = statistics.mean(r["seconds"] for r in history[1:])
        log(f"[train-real B {fmt}] train-lora from checkpoints, --quantization {fmt}, 6 items in 2 buckets at 512^2, "
            f"{QLORA_STEPS} steps in {wall:.2f} s (load, encodes, steps); {s_per_step:.4f} s/step warm; peak "
            f"{peak:.2f} GiB; launches {counts} ({QLORA_STEP_LAUNCHES[fmt][counter]} {counter} a step); first-step "
            f"loss {loss_k:.6f} vs {loss_p:.6f} with the plain {kernel} (relative {rel:.3e}, tol "
            f"{TRAIN_LOSS_REL_TOL}) [{card}]")
        out[fmt] = {"counts": counts, "s_per_step": s_per_step, "rel_loss": rel, "peak_gib": peak}
        gc_cuda()
    return out


def _phase_remat_dots(card: str, tdir: str) -> dict:
    """C: ``remat: "dots"`` against ``remat: True`` on the Klein-4B DiT read
    from its checkpoint (bf16), a rank-16 LoRA, 1024^2: two loss + backward
    steps of each, in turns; step 1's loss and LoRA gradient compared, s/step
    and peak memory of the warm step, launches."""
    from flux2_tpu_torch.cli.main import _read_config_json
    from flux2_tpu_torch.io import checkpoints as tck
    from flux2_tpu_torch.io import weight_mapping
    from flux2_tpu_torch.pipeline.pipeline import Flux2Model
    from flux2_tpu_torch.training import lora as lora_mod
    from flux2_tpu_torch.training import trainer

    model = weight_mapping.load_transformer(tck.WeightsDir(tdir), _read_config_json(tdir, Flux2Model.KLEIN_4B.transformer_config),
                                            "cuda")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 21)
    lora = lora_mod.init_lora(model, lora_mod.LoRAConfig(16, 16.0), gen)
    with torch.no_grad():  # b != 0: every adapter leaf has a gradient
        for name, p in lora.named_parameters():
            if name.endswith(".b"):
                p.normal_(generator=gen).mul_(1e-2)
    latents, emb, sigmas, noise, cos, sin = _klein_train_inputs(gen, 1024)
    rows = {True: [], "dots": []}
    for _ in range(2):
        for remat in (True, "dots"):
            tcfg = trainer.TrainConfig(rank=16, alpha=16.0, remat=remat)
            for p in lora.parameters():
                p.grad = None
            gc_cuda()
            torch.cuda.reset_peak_memory_stats()
            _zero_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss = trainer.flow_matching_loss(model, lora, tcfg, latents, emb, noise, sigmas, cos, sin)
            loss.backward()
            torch.cuda.synchronize()
            rows[remat].append({"s": time.perf_counter() - t0, "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                                "counts": _launch_counts(), "loss": float(loss.detach()),
                                "grads": [p.grad.detach().clone() for p in lora.parameters()]})
    for remat, want in ((True, STEP_LAUNCHES), ("dots", STEP_LAUNCHES)):
        for r in rows[remat]:
            _expect_counts(f"C: a 1024^2 step under remat={remat!r}", r["counts"], want)
    a, b = rows[True][0], rows["dots"][0]
    equal = a["loss"] == b["loss"] and all(torch.equal(x, y) for x, y in zip(a["grads"], b["grads"]))
    rel_grad = (sum(float((x - y).square().sum()) for x, y in zip(a["grads"], b["grads"]))
                / sum(float(x.square().sum()) for x in a["grads"])) ** 0.5
    rel_loss = abs(a["loss"] - b["loss"]) / abs(a["loss"])
    if not equal and (rel_loss > 1e-3 or rel_grad > 1e-3):
        raise AssertionError(f"C: dots vs True at step 1: loss relative {rel_loss}, LoRA gradient relative L2 {rel_grad}")
    warm = {k: v[1] for k, v in rows.items()}
    log(f"[train-real C] remat dots vs True, Klein-4B from its checkpoint (bf16), 1024^2 (4128 tokens), rank 16, "
        f"loss + backward in turns: warm s/step dots {warm['dots']['s']:.4f} vs True {warm[True]['s']:.4f}; peak "
        f"memory dots {warm['dots']['peak_gib']:.2f} GiB vs True {warm[True]['peak_gib']:.2f} GiB; step 1 "
        f"{'equal to the bit' if equal else f'loss relative {rel_loss:.3e}, LoRA gradient relative L2 {rel_grad:.3e}'}"
        f" (loss {a['loss']:.6f}); launches a step, both: {warm['dots']['counts']} [{card}]")
    del model, lora, rows
    gc_cuda()
    return {"s_per_step": {"dots": warm["dots"]["s"], "true": warm[True]["s"]},
            "peak_gib": {"dots": warm["dots"]["peak_gib"], "true": warm[True]["peak_gib"]}, "equal": equal,
            "rel_grad": rel_grad, "counts": warm["dots"]["counts"]}


def _phase_evaluate_lora(card: str, workdir: str, data: dict, dir_flags: list) -> dict:
    """D: ``evaluate-lora --no-vlm`` from the checkpoints on the dataset, 512^2, 2 samples."""
    out = os.path.join(workdir, "lora_eval")
    _zero_launches()
    lines = _run_cli(["evaluate-lora", *dir_flags, "--dataset", data["dataset"], "--width", "512", "--height", "512",
                      "--max-samples", "2", "--no-vlm", "--output-dir", out], "evaluate-lora", card, tag="train-real D")
    counts = _launch_counts()
    _expect_counts("D: evaluate-lora", counts, {"flash": 2 * 25 * 4})
    result = json.loads(lines[-1])
    keys = ["scene_score", "style_score", "recommended_rank", "recommended_steps", "recommended_timestep_sampling",
            "recommended_alpha", "recommended_learning_rate", "recommended_warmup_steps", "recommended_loss_weighting",
            "recommended_target_layers", "notes"]
    samples = [ln for ln in lines if re.match(r"\[\d/2\] scene=", ln)]
    if list(result) != keys or len(samples) != 2 or sorted(os.listdir(out)) != ["baseline_000.png", "baseline_001.png"]:
        raise AssertionError(f"D: evaluate-lora printed {result} / {samples}, wrote {sorted(os.listdir(out))}")
    log(f"[train-real D] evaluate-lora --no-vlm: JAX's keys, 2 samples, 2 baseline PNGs; launches {counts} [{card}]")
    return {"counts": counts, "result": result}


def phase_train_real(card: str, workdir: str, dirs: dict) -> dict:
    """Real-data LoRA training at full Klein-4B-base width on the checkpoint
    phase's directories and a dataset written from a seed (six PNGs in two
    aspect ratios, captions with [trigger], control images for two, a
    two-item held-out set): A random-init on the dataset and its resume, B
    QLoRA from the CLI (w8a8, qint8), C remat dots against True, D
    evaluate-lora."""
    from flux2_tpu_torch.utils.synthetic import write_dataset

    t0 = time.perf_counter()
    root = os.path.join(workdir, "train_real")
    data = write_dataset(os.path.join(root, "dataset"), SEED + 20, [(512, 512), (384, 672)] * 3, control=(0, 1))
    data["validation"] = write_dataset(os.path.join(root, "held_out"), SEED + 21, [(512, 512)] * 2,
                                       captions=VAL_CAPTIONS)["dataset"]
    dir_flags = ["--transformer-dir", dirs["transformer"], "--vae-dir", dirs["vae"], "--encoder-dir", dirs["text_encoder"]]
    a = _phase_random_real(card, root, data)
    b = _phase_qlora_cli(card, root, data, dir_flags)
    c = _phase_remat_dots(card, dirs["transformer"])
    d = _phase_evaluate_lora(card, root, data, dir_flags)
    log(f"[train-real] phase: {time.perf_counter() - t0:.2f} s [{card}]")
    return {"random": a, "qlora": b, "dots": c, "evaluate": d, "data": data}


# -- LoRA inference, prequantized checkpoints and QLoRA ------------------------------------

LORA_RANK = 16
LORA_USER_SCALE = 0.8
LORA_SIDECAR = {"activation_keyword": "CHIPSTYLE", "scheduler": {"num_steps": 2}}
LORA_REQUEST = {"prompt": "a lighthouse on a cliff at dusk, with a LoRA", "seed": 6}
# Disk the phase adds beside the checkpoint: the qint8 file (~4.5 GB at
# Klein-4B), the int4 file (~2.5 GB) and two LoRA files (~0.13 GB each).
PREQUANT_DISK_BYTES = 7.5e9
QLORA_STEPS = 3
# A QLoRA train step on a quantized Klein-4B base under remat: the forward runs
# every projection that passes its kernel's gate once (206 for K5 and its
# prologue, 202 for K7: FORWARD_LAUNCHES), and torch.utils.checkpoint recomputes
# each block whole in the backward, its 200 projections (5 double blocks x 12,
# 20 single blocks x 7) all on the kernel again; the backward itself launches
# none (dy @ dequantize(w), ops.quant.KernelLinear). Attention: STEP_LAUNCHES.
QLORA_RECOMPUTED = 5 * 12 + 20 * 7
QLORA_STEP_LAUNCHES = {"w8a8": {"w8a8": FORWARD_LAUNCHES["w8a8"] + QLORA_RECOMPUTED,
                                "quantize_rows": FORWARD_LAUNCHES["w8a8"] + QLORA_RECOMPUTED},
                       "qint8": {"dequant_int8": FORWARD_LAUNCHES["qint8"] + QLORA_RECOMPUTED}}
# The kernel route's input gradient (dy @ dequantize(w) after the kernel's
# forward) against autograd of the dequantize-then-F.linear route, relative L2:
# the two differ by the forward's int8 activation rounding (K5, K6) or f32
# summation order (K7) carried through dy.
XGRAD_REL_TOL = 1e-2


def _bfl_lora_state(config, rank: int, gen: torch.Generator) -> dict:
    """A BFL-native LoRA on every default target of every block, drawn from
    ``gen`` on the CPU: A [r, in] ~ N(0, 1/in), B [out, r] ~ N(0, 4e-4), f32."""
    d, mlp = config.inner_dim, config.mlp_hidden_dim
    dims = {"img_attn.qkv": (d, 3 * d), "txt_attn.qkv": (d, 3 * d), "img_attn.proj": (d, d),
            "txt_attn.proj": (d, d), "img_mlp.0": (d, 2 * mlp), "img_mlp.2": (mlp, d), "txt_mlp.0": (d, 2 * mlp),
            "txt_mlp.2": (mlp, d)}
    out = {}

    def pair(key, d_in, d_out):
        out[f"{key}.lora_A.weight"] = torch.randn(rank, d_in, generator=gen) * d_in**-0.5
        out[f"{key}.lora_B.weight"] = torch.randn(d_out, rank, generator=gen) * 2e-2

    for i in range(config.num_layers):
        for name, (d_in, d_out) in dims.items():
            pair(f"double_blocks.{i}.{name}", d_in, d_out)
    for i in range(config.num_single_layers):
        pair(f"single_blocks.{i}.linear1", d, 3 * d + 2 * mlp)
        pair(f"single_blocks.{i}.linear2", d + mlp, d)
    return out


def _diffusers_lora_state(bfl: dict, config) -> dict:
    """The same adapters in the Diffusers dialect: each fused qkv as three pairs
    sharing A, linear1 / linear2 as the fused to_qkv_mlp_proj / to_out."""
    d = config.inner_dim
    double = {"img_attn.proj": "attn.to_out.0", "txt_attn.proj": "attn.to_add_out", "img_mlp.0": "ff.linear_in",
              "img_mlp.2": "ff.linear_out", "txt_mlp.0": "ff_context.linear_in", "txt_mlp.2": "ff_context.linear_out"}
    qkv = {"img_attn.qkv": ("attn.to_q", "attn.to_k", "attn.to_v"),
           "txt_attn.qkv": ("attn.add_q_proj", "attn.add_k_proj", "attn.add_v_proj")}
    out = {}

    def put(key, a, b):
        out[f"transformer.{key}.lora_A.weight"] = a.clone()
        out[f"transformer.{key}.lora_B.weight"] = b.contiguous()

    for i in range(config.num_layers):
        src = f"double_blocks.{i}."
        for fused, names in qkv.items():
            a, b = bfl[src + fused + ".lora_A.weight"], bfl[src + fused + ".lora_B.weight"]
            for j, name in enumerate(names):
                put(f"transformer_blocks.{i}.{name}", a, b[j * d:(j + 1) * d])
        for name, target in double.items():
            put(f"transformer_blocks.{i}.{target}", bfl[src + name + ".lora_A.weight"],
                bfl[src + name + ".lora_B.weight"])
    for i in range(config.num_single_layers):
        for name, target in (("linear1", "attn.to_qkv_mlp_proj"), ("linear2", "attn.to_out")):
            put(f"single_transformer_blocks.{i}.{target}", bfl[f"single_blocks.{i}.{name}.lora_A.weight"],
                bfl[f"single_blocks.{i}.{name}.lora_B.weight"])
    return out


def _write_lora(path: str, state: dict) -> int:
    from flux2_tpu_torch.io import safetensors_io

    safetensors_io.save_file(state, path)
    with open(os.path.splitext(path)[0] + ".json", "w") as f:
        json.dump(LORA_SIDECAR, f)
    return os.path.getsize(path)


def _dit_state(model) -> dict:
    """Every parameter and buffer of a DiT by name (quantized weights' codes and scales too)."""
    return dict(model.named_parameters()) | dict(model.named_buffers())


def _states_equal(a, b) -> bool:
    sa, sb = _dit_state(a), _dit_state(b)
    return sorted(sa) == sorted(sb) and all(sa[k].dtype == sb[k].dtype and torch.equal(sa[k], sb[k]) for k in sa)


def _rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).norm() / b.float().norm())


def _velocity_inputs(gen):
    """A 1024^2 DiT forward's inputs on the card: latents, 512 text tokens, sigma, RoPE."""
    import numpy as np

    from flux2_tpu_torch.ops import latents as lu
    from flux2_tpu_torch.ops.rope import rope_embeddings

    x = torch.randn(1, 4096, 128, device="cuda", generator=gen).bfloat16()
    emb = torch.randn(1, 512, 7680, device="cuda", generator=gen).bfloat16()
    ids = np.concatenate([lu.text_position_ids(512), lu.image_position_ids(1024, 1024)])
    cos, sin = rope_embeddings(torch.from_numpy(ids).cuda())
    return x, emb, torch.tensor([0.7], device="cuda"), cos, sin


def _velocity(model, inputs, **kw) -> torch.Tensor:
    with torch.inference_mode():
        v = model(*inputs, **kw).float()
    torch.cuda.synchronize()
    return v


def _run_cli_logged(argv: list, label: str, card: str, tag: str = "lora") -> tuple:
    """``_run_cli`` with the command's log lines (standard error) captured,
    logged and returned with its standard output's lines."""
    import contextlib
    import io

    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        lines = _run_cli(argv, label, card, tag=tag)
    for line in err.getvalue().strip().splitlines():
        log(f"[{tag} {label}] {line[:300] if line.isprintable() else ascii(line)[:300]}")
    return lines, err.getvalue()


def _expect_counts(label: str, counts: dict, want: dict) -> None:
    full = {name: 0 for name in counts}
    full.update(want)
    if counts != full:
        raise AssertionError(f"{label} launched {counts}, want {full}")


def _xgrad_check(w, k: int, label: str, card: str) -> float:
    """The R2 check: x.grad through one quantized projection on its kernel
    (ops.quant.KernelLinear) against autograd of the plain route, at a 512^2
    training shape (1056 rows)."""
    from flux2_tpu_torch.ops import quant as tq

    gen = torch.Generator(device="cuda").manual_seed(SEED + 13)
    x0 = torch.randn(1, 1056, k, device="cuda", generator=gen).bfloat16()

    def grad(plain: bool):
        x = x0.clone().requires_grad_(True)
        route = tq.kernel_route
        if plain:
            tq.kernel_route = lambda x_, w_: None
        try:
            y = tq.q_linear(x, w)
        finally:
            tq.kernel_route = route
        y.float().square().sum().backward()
        return x.grad

    _zero_launches()
    gk = grad(False)
    counts = _launch_counts()
    gp = grad(True)
    rel = _rel_l2(gk, gp)
    kernel = {"w8a8": "w8a8", "w4a8": "w4a8"}.get(w.format, "dequant_int8")
    if counts[kernel] != 1 or not bool(torch.isfinite(gk).all()) or float(gk.abs().max()) == 0 or rel > XGRAD_REL_TOL:
        raise AssertionError(f"{label}: x.grad through the kernel vs the plain route, relative L2 {rel} (tol "
                             f"{XGRAD_REL_TOL}); launches {counts}")
    log(f"[qlora] R2 {label}: x.grad through {kernel} (one launch) vs the plain route, relative L2 {rel:.3e} (tol "
        f"{XGRAD_REL_TOL}) [{card}]")
    return rel


def _wrapper_host_us(card: str) -> dict:
    """The host's time per call of q_linear on a W8A8 weight at the shape of
    PERF.md's wrapper figures, (M, K, N) = (16, 512, 2560), under
    inference_mode (the R2 check only) and with x requiring grad (through
    KernelLinear.apply), beside the parent's q_linear restated, w8a8_matmul
    alone and F.linear."""
    import torch.nn.functional as F

    from flux2_tpu_torch.ops import quant as tq
    from flux2_tpu_torch.ops import quant_kernels as qk
    from flux2_tpu_torch.utils.quant_candidate import host_us

    gen = torch.Generator(device="cuda").manual_seed(SEED + 16)
    x = torch.randn(16, 512, device="cuda", generator=gen).bfloat16()
    w = (torch.randn(2560, 512, device="cuda", generator=gen) * 512**-0.5).bfloat16()
    w8 = tq.to_w8a8(w)
    xg = x.clone().requires_grad_(True)

    def parent_q_linear(x, w):
        """The parent's q_linear for a quantized weight, restated: the gate, then the kernel."""
        if isinstance(w, torch.Tensor):
            return F.linear(x, w)
        route = tq.kernel_route(x, w) if x.is_cuda else None
        if route == "w8a8":
            return qk.w8a8_matmul(x, w)
        return F.linear(x, tq.dequantize_any(w, x.dtype))

    with torch.inference_mode():  # as the pipeline serves
        times = {"F.linear (bf16)": host_us(lambda: F.linear(x, w)),
                 "w8a8_matmul": host_us(lambda: qk.w8a8_matmul(x, w8)),
                 "q_linear before R2": host_us(lambda: parent_q_linear(x, w8)),
                 "q_linear": host_us(lambda: tq.q_linear(x, w8))}
    times["q_linear, x requiring grad (KernelLinear)"] = host_us(lambda: tq.q_linear(xg, w8))
    log("[host] us of host a call at (M,K,N)=(16,512,2560): " + ", ".join(f"{k} {v:.1f}" for k, v in times.items())
        + f" [{card}]")
    return times


def _qlora_run(fmt: str, card: str, bf16_s_per_step: float) -> dict:
    """QLoRA through the library on a random Klein-4B-base DiT quantized to
    ``fmt``: init_train_state and QLORA_STEPS steps of make_train_step at 512^2,
    bs 1, rank 16, remat, with exact launch counts; one step's loss and LoRA
    gradient against the same step with each kernel's plain version in its
    place (the train-step limits), and against q_linear's dequantize-then-
    F.linear route (the loss at the train-step limit; the gradient at the
    format's forward limit, QUANT_DIT_REL_TOL: that route leaves out the int8
    activation rounding of K5, which moved the w8a8 gradient by 5.3e-2 at
    full Klein-4B width on an H100); the R2 check."""
    from flux2_tpu_torch.models.flux2.transformer import Flux2Transformer
    from flux2_tpu_torch.ops import quant as tq
    from flux2_tpu_torch.ops import quant_kernels as qk
    from flux2_tpu_torch.pipeline.pipeline import Flux2Model
    from flux2_tpu_torch.training import lora as lora_mod
    from flux2_tpu_torch.training import trainer

    gen = torch.Generator(device="cuda").manual_seed(SEED + 14)
    model = Flux2Transformer(Flux2Model.KLEIN_4B_BASE.transformer_config, device="cuda", generator=gen)
    tq.quantize_params(model, fmt)
    tcfg = trainer.TrainConfig(rank=16, alpha=16.0, remat=True)
    latents, emb, sigmas, noise, cos, sin = _klein_train_inputs(gen, 512)
    batch = {"latents": latents, "embeddings": emb, "rope_cos": cos, "rope_sin": sin}
    state = trainer.init_train_state(model, tcfg, gen)
    step = trainer.make_train_step(model, tcfg)
    torch.cuda.synchronize()
    _zero_launches()
    times, history = [], []
    for _ in range(QLORA_STEPS):
        t0 = time.perf_counter()
        m = step(state.lora, state.optimizer, batch, gen)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        history.append({k: float(v) for k, v in m.items()})
    counts = _launch_counts()
    want = {name: n * QLORA_STEPS for name, n in {**STEP_LAUNCHES, **QLORA_STEP_LAUNCHES[fmt]}.items()}
    _expect_counts(f"QLoRA on a {fmt} base, {QLORA_STEPS} steps", counts, want)
    if not all(h["loss"] == h["loss"] and h["grad_norm"] > 0 for h in history):
        raise AssertionError(f"QLoRA on a {fmt} base: {history}")

    # one step's loss and LoRA gradient, kernel route against q_linear's plain route
    lora = lora_mod.init_lora(model, lora_mod.LoRAConfig(16, 16.0), gen)
    with torch.no_grad():  # b != 0, so that every adapter leaf has a gradient to compare
        for name, p in lora.named_parameters():
            if name.endswith(".b"):
                p.normal_(generator=gen).mul_(1e-2)

    def run():
        for p in lora.parameters():
            p.grad = None
        loss = trainer.flow_matching_loss(model, lora, tcfg, latents, emb, noise, sigmas, cos, sin)
        loss.backward()
        torch.cuda.synchronize()
        return float(loss.detach()), {n: p.grad.detach().clone() for n, p in lora.named_parameters()}

    def rel(other):
        (loss_o, grads_o) = other
        diff = sum(float((grads_k[n] - grads_o[n]).square().sum()) for n in grads_k)
        return abs(loss_k - loss_o) / abs(loss_o), (diff / sum(float(g.square().sum()) for g in grads_o.values())) ** 0.5

    loss_k, grads_k = run()
    kernel = {"w8a8": "w8a8_matmul", "qint8": "dequant_matmul"}[fmt]
    launch = getattr(qk, kernel)
    setattr(qk, kernel, getattr(qk, kernel + "_reference"))  # the kernel's plain version in its place
    try:
        plain = run()
    finally:
        setattr(qk, kernel, launch)
    route = tq.kernel_route
    tq.kernel_route = lambda x, w: None  # q_linear's dequantize-then-F.linear route: no activation rounding
    try:
        dense = run()
    finally:
        tq.kernel_route = route
    (rel_loss, rel_grad), (rel_loss_d, rel_grad_d) = rel(plain), rel(dense)
    zero = [n for n, g in grads_k.items() if not bool(g.any())]
    if (rel_loss > TRAIN_LOSS_REL_TOL or rel_grad > TRAIN_GRAD_REL_TOL or rel_loss_d > TRAIN_LOSS_REL_TOL
            or rel_grad_d > QUANT_DIT_REL_TOL[fmt] or zero):
        raise AssertionError(f"QLoRA on a {fmt} base: kernel route vs its plain version: loss {loss_k} vs {plain[0]} "
                             f"(relative {rel_loss}, tol {TRAIN_LOSS_REL_TOL}), gradient relative L2 {rel_grad} (tol "
                             f"{TRAIN_GRAD_REL_TOL}); vs the dequantize route: loss relative {rel_loss_d} (tol "
                             f"{TRAIN_LOSS_REL_TOL}), gradient {rel_grad_d} (tol {QUANT_DIT_REL_TOL[fmt]}); zero "
                             f"gradients: {zero[:4]}")
    w = model.double_blocks[0].to_q
    xgrad = _xgrad_check(w, w.orig_in, f"{fmt} double_blocks.0.to_q", card)
    s_per_step = statistics.mean(times[1:])
    log(f"[qlora] Klein-4B-base on a {fmt} base ({tq.param_bytes(model) / 2**30:.2f} GiB), 512^2 bs 1, rank 16, "
        f"remat: {QLORA_STEPS} steps {[round(t, 4) for t in times]} s, losses {[round(h['loss'], 5) for h in history]}, "
        f"grad norms {[round(h['grad_norm'], 5) for h in history]}; {s_per_step:.4f} s/step warm against bf16 "
        f"{bf16_s_per_step:.4f} (train-lora, 512^2); launches {counts} (a step: {STEP_LAUNCHES} + "
        f"{QLORA_STEP_LAUNCHES[fmt]}); one step on the kernels vs their plain versions: loss {loss_k:.6f} vs "
        f"{plain[0]:.6f} (relative {rel_loss:.3e}, tol {TRAIN_LOSS_REL_TOL}), LoRA gradient relative L2 "
        f"{rel_grad:.3e} (tol {TRAIN_GRAD_REL_TOL}); vs q_linear's dequantize route: loss relative {rel_loss_d:.3e} "
        f"(tol {TRAIN_LOSS_REL_TOL}), gradient {rel_grad_d:.3e} (tol {QUANT_DIT_REL_TOL[fmt]}, the {fmt} forward's "
        f"limit) [{card}]")
    del model, state, lora, grads_k, plain, dense
    gc_cuda()
    return {"counts": counts, "s_per_step": s_per_step, "rel_loss": rel_loss, "rel_grad": rel_grad,
            "rel_loss_dequant_route": rel_loss_d, "rel_grad_dequant_route": rel_grad_d, "xgrad_rel": xgrad}


def phase_lora_prequant(card: str, workdir: str, dirs: dict, bf16_train_s_per_step: float) -> dict:
    """LoRA inference, prequantized checkpoints and QLoRA at full Klein-4B
    width, on the checkpoint directories ``phase_checkpoint_round_trip`` wrote:
    a rank-16 LoRA written from a seed in both dialects; ``t2i --lora`` (its
    Turbo steps, K1 50) equal to an in-process merge and generate to the bit,
    both dialects merging to the same bits, the merged velocity against the
    unmerged ``forward(lora=)``; ``export-quantized`` (qint8 with the LoRA
    baked, int4) and ``t2i`` from those files (w8a8: K5 206 a forward, its
    weights equal to an in-memory qint8 -> w8a8 of the merged weights; w4a8:
    K6 205); ``FLUX2_PALLAS_DEQUANT=1 t2i --quantization qint8 --lora`` (the
    slice-wise QTensor merge, K7 202 a forward); ``--dequantize-runtime`` (no
    K5-K7); then QLoRA through the library on a w8a8 and a qint8 base."""
    from flux2_tpu_torch.cli import main as cli
    from flux2_tpu_torch.io import checkpoints as tck
    from flux2_tpu_torch.io import weight_mapping
    from flux2_tpu_torch.io.png import encode_png, to_u8
    from flux2_tpu_torch.ops import quant as tq
    from flux2_tpu_torch.pipeline.pipeline import Flux2Model
    from flux2_tpu_torch.training import lora_loader
    from flux2_tpu_torch.utils import profiler as tprof

    out = {"launches": {}}
    tdir = dirs["transformer"]
    dir_flags = ["--transformer-dir", tdir, "--vae-dir", dirs["vae"], "--encoder-dir", dirs["text_encoder"]]
    request = ["--prompt", LORA_REQUEST["prompt"], "--seed", str(LORA_REQUEST["seed"])]
    config = cli._read_config_json(tdir, Flux2Model.KLEIN_4B.transformer_config)

    # 1. the LoRA, from a seed, in both dialects, each with the Turbo sidecar
    t0 = time.perf_counter()
    bfl = _bfl_lora_state(config, LORA_RANK, torch.Generator().manual_seed(SEED + 12))
    files = {"bfl": os.path.join(workdir, "lora_bfl.safetensors"),
             "diffusers": os.path.join(workdir, "lora_diffusers.safetensors")}
    sizes = {"bfl": _write_lora(files["bfl"], bfl),
             "diffusers": _write_lora(files["diffusers"], _diffusers_lora_state(bfl, config))}
    del bfl
    log(f"[lora] rank-{LORA_RANK} LoRA on every default target of every block written in both dialects "
        f"({', '.join(f'{k} {v / 1e9:.3f} GB' for k, v in sizes.items())}) with the sidecar {LORA_SIDECAR} in "
        f"{time.perf_counter() - t0:.2f} s [{card}]")

    # 2. in process: the checkpoint's pipeline, the unmerged forward, the BFL merge, a generate
    pipe = cli.build_pipeline(cli.parse_args(["t2i", *dir_flags]), "cuda")
    inputs = _velocity_inputs(torch.Generator(device="cuda").manual_seed(SEED + 15))
    v_base = _velocity(pipe.transformer, inputs)
    t0 = time.perf_counter()
    loaded = {k: lora_loader.load_lora_file(f, config, user_scale=LORA_USER_SCALE) for k, f in files.items()}
    load_s = (time.perf_counter() - t0) / 2
    v_unmerged = _velocity(pipe.transformer, inputs, lora=lora_loader.to_stacked_lora(loaded["diffusers"], config, "cuda"),
                           lora_scale=loaded["diffusers"].scale)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lora_loader.merge_loras_into_params(pipe.transformer, [loaded["bfl"]], config)
    torch.cuda.synchronize()
    merge_s = time.perf_counter() - t0
    v_merged = _velocity(pipe.transformer, inputs)
    merge_rel, lora_effect = _rel_l2(v_merged, v_unmerged), _rel_l2(v_merged, v_base)
    if merge_rel > DIT_REL_TOL or lora_effect <= merge_rel:
        raise AssertionError(f"merged velocity vs the unmerged forward(lora=): relative L2 {merge_rel} (tol "
                             f"{DIT_REL_TOL}); the LoRA moves it by {lora_effect} from the base")
    overrides, keywords, _ = lora_loader.merge_runtime_semantics([loaded["bfl"]])
    pipe.lora_num_steps, pipe.lora_keywords = overrides.num_steps, keywords
    res = pipe.generate(height=1024, width=1024, **LORA_REQUEST)
    png = encode_png(to_u8(res.image))
    log(f"[lora] load {load_s:.3f} s a file; merge {merge_s:.3f} s (rank {LORA_RANK}, {len(loaded['bfl'].pairs)} "
        f"targets x 25 blocks, scale {loaded['bfl'].scale:.3f}); 1024^2 velocity merged vs unmerged forward(lora=) "
        f"relative L2 {merge_rel:.3e} (tol {DIT_REL_TOL}), the LoRA moves it {lora_effect:.3e} from the base; "
        f"in-process generate {res.num_steps} steps, final_prompt {res.final_prompt!r} [{card}]")

    # 3. t2i --lora through cli.main: Turbo steps, keyword, PNG and merged weights equal to the bit
    built = []
    original = cli.build_pipeline

    def recording_build(args, device, *a, **k):
        built.append(_RecordingPipeline(original(args, device, *a, **k)))
        return built[-1]

    def run(label, argv, want, check=None):
        """One cli.main command with its launches counted and checked; its pipeline is freed after ``check``."""
        built.clear()
        cli.build_pipeline = recording_build
        try:
            _zero_launches()
            lines, err = _run_cli_logged(argv, label, card)
            counts = _launch_counts()
        finally:
            cli.build_pipeline = original
        _expect_counts(label, counts, want)
        out["launches"][label] = counts
        if check is not None:
            check(built[0] if built else None, lines, err)
        built.clear()
        gc_cuda()
        return lines, err

    def check_lora_t2i(rec, lines, err):
        with open(lines[0].split(" ", 1)[1], "rb") as f:
            if f.read() != png:
                raise AssertionError("t2i --lora: the PNG differs from the in-process merge and generate")
        if not _states_equal(rec.transformer, pipe.transformer):
            raise AssertionError("t2i --lora (Diffusers dialect): the merged DiT differs from the BFL merge")
        got = rec.results[0]
        if got.num_steps != 2 or not got.final_prompt.startswith("CHIPSTYLE, "):
            raise AssertionError(f"t2i --lora: {got.num_steps} steps, final_prompt {got.final_prompt!r}")
        if f"merged LoRA {files['diffusers']} (scale {loaded['diffusers'].scale:.3f})" not in err:
            raise AssertionError("t2i --lora: no merge line")

    run("t2i --lora", ["t2i", *dir_flags, *request, "--lora", f"{files['diffusers']}:{LORA_USER_SCALE}", "-o",
                       os.path.join(workdir, "lora.png")], {"flash": 25 * 2}, check_lora_t2i)
    log(f"[lora t2i] --lora (Diffusers dialect) through cli.main: 2 Turbo steps, K1 50, the keyword in final_prompt, "
        f"PNG equal to the in-process generate and DiT equal to the BFL file's merge, both to the bit [{card}]")

    # 4. export-quantized qint8 with the LoRA baked, then t2i --quantization w8a8 from the file
    t0 = time.perf_counter()
    lines, _ = run("export-quantized qint8 --lora", ["export-quantized", "--transformer-dir", tdir, "--quantization",
                                                     "qint8", "--lora", f"{files['diffusers']}:{LORA_USER_SCALE}"], {})
    export_s = time.perf_counter() - t0
    want_lines = [f"baked LoRA {files['diffusers']} (scale {loaded['diffusers'].scale:.3f})",
                  f"exported qint8 checkpoint -> {tck.prequantized_path(tdir, 'qint8')} ("]
    if len(lines) != 2 or lines[0] != want_lines[0] or not lines[1].startswith(want_lines[1]):
        raise AssertionError(f"export-quantized printed {lines}")
    qint8_gb = os.path.getsize(tck.prequantized_path(tdir, "qint8")) / 1e9
    tq.quantize_params(pipe.transformer, "qint8")  # the in-memory route: merged bf16 -> qint8 -> w8a8
    tq.quantize_params(pipe.transformer, "w8a8")
    v_w8a8 = {}

    def check_w8a8(rec, lines, err):
        if f"loaded prequantized qint8 transformer from {tck.prequantized_path(tdir, 'qint8')}" not in err:
            raise AssertionError("t2i --quantization w8a8 did not read the prequantized file")
        if not _states_equal(rec.transformer, pipe.transformer):
            raise AssertionError("t2i w8a8 from the file: the DiT differs from the in-memory qint8 -> w8a8")
        v_w8a8["v"] = _velocity(rec.transformer, inputs)

    tprof._shared = tprof.PhaseProfiler(enabled=True)
    try:
        k5 = FORWARD_LAUNCHES["w8a8"] * 4
        run("t2i w8a8 (prequantized)", ["t2i", *dir_flags, *request, "--quantization", "w8a8", "-o",
                                        os.path.join(workdir, "w8a8.png")],
            {"flash": 100, "w8a8": k5, "quantize_rows": k5}, check_w8a8)
        cli_load_s = tprof.shared().phases["4. Load Transformer"]
    finally:
        tprof._shared = None
    w8a8_rel = _rel_l2(v_w8a8["v"], v_merged)
    if w8a8_rel > QUANT_DIT_REL_TOL["w8a8"]:
        raise AssertionError(f"w8a8 (qint8 file -> w8a8) velocity vs bf16: {w8a8_rel} (tol "
                             f"{QUANT_DIT_REL_TOL['w8a8']})")
    del pipe
    gc_cuda()
    # the two loads alone, in process, in turns, twice: the prequantized file, the checkpoint quantized on the fly
    def load_prequant():
        tree, _ = tck.load_prequantized(tck.prequantized_path(tdir, "qint8"), expected_source_dir=tdir)
        return tq.quantize_params(tck.transformer_from_tree(tree, config, "cuda"), "w8a8")

    def load_dense():
        return tq.quantize_params(weight_mapping.load_transformer(tck.WeightsDir(tdir), config, "cuda"), "w8a8")

    load_times = {"prequantized": [], "dense": []}
    for _ in range(2):
        for name, load in (("prequantized", load_prequant), ("dense", load_dense)):
            t0 = time.perf_counter()
            model = load()
            torch.cuda.synchronize()
            load_times[name].append(time.perf_counter() - t0)
            del model
            gc_cuda()
    prequant_load_s, dense_load_s = load_times["prequantized"], load_times["dense"]
    log(f"[lora export] export-quantized qint8 --lora: {export_s:.2f} s of command, {qint8_gb:.3f} GB; t2i w8a8 "
        f"from it: K5 {k5} (206 a forward), DiT equal to the in-memory qint8 -> w8a8 of the merged weights to the "
        f"bit, velocity vs bf16 relative L2 {w8a8_rel:.4e} (tol {QUANT_DIT_REL_TOL['w8a8']}); load phase in the "
        f"CLI {cli_load_s:.3f} s; in process, in turns: prequantized file -> w8a8 "
        f"{[round(t, 3) for t in prequant_load_s]} s, dense checkpoint + on-the-fly w8a8 "
        f"{[round(t, 3) for t in dense_load_s]} s [{card}]")

    # 5. int4 -> w4a8; the QTensor merge on K7; --dequantize-runtime
    t0 = time.perf_counter()
    run("export-quantized int4", ["export-quantized", "--transformer-dir", tdir, "--quantization", "int4"], {})
    int4_s, int4_gb = time.perf_counter() - t0, os.path.getsize(tck.prequantized_path(tdir, "int4")) / 1e9

    def check_w4a8(rec, lines, err):
        if f"loaded prequantized int4 transformer from {tck.prequantized_path(tdir, 'int4')}" not in err:
            raise AssertionError("t2i --quantization w4a8 did not read the prequantized int4 file")
        v_w8a8["w4a8"] = _rel_l2(_velocity(rec.transformer, inputs), v_base)

    k6 = FORWARD_LAUNCHES["w4a8"] * 4
    run("t2i w4a8 (prequantized)", ["t2i", *dir_flags, *request, "--quantization", "w4a8", "-o",
                                    os.path.join(workdir, "w4a8.png")],
        {"flash": 100, "w4a8": k6, "quantize_rows": k6}, check_w4a8)
    if v_w8a8["w4a8"] > QUANT_DIT_REL_TOL["w4a8"]:
        raise AssertionError(f"w4a8 (int4 file) velocity vs bf16: {v_w8a8['w4a8']} (tol {QUANT_DIT_REL_TOL['w4a8']})")

    def check_qtensor_merge(rec, lines, err):
        kinds = {(type(w).__name__, w.format) for w in (rec.transformer.get_submodule(n)
                                                        for n in tq.quantized_names(rec.transformer))}
        if kinds != {("QTensor", "qint8")} or "merged LoRA" not in err:
            raise AssertionError(f"t2i qint8 --lora: weights {kinds}")

    os.environ["FLUX2_PALLAS_DEQUANT"] = "1"
    try:
        k7 = FORWARD_LAUNCHES["qint8"] * 2
        run("t2i qint8 --lora (K7)", ["t2i", *dir_flags, *request, "--quantization", "qint8", "--lora",
                                      f"{files['bfl']}:{LORA_USER_SCALE}", "-o", os.path.join(workdir, "k7.png")],
            {"flash": 50, "dequant_int8": k7}, check_qtensor_merge)

        def check_dense(rec, lines, err):
            if tq.quantized_names(rec.transformer) or "dequantized to bf16 at load" not in err:
                raise AssertionError("t2i --dequantize-runtime left quantized weights")

        run("t2i qint8 --dequantize-runtime", ["t2i", *dir_flags, *request, "--quantization", "qint8",
                                               "--dequantize-runtime", "-o", os.path.join(workdir, "deq.png")],
            {"flash": 100}, check_dense)
    finally:
        del os.environ["FLUX2_PALLAS_DEQUANT"]
    log(f"[lora export] export-quantized int4: {int4_s:.2f} s, {int4_gb:.3f} GB; t2i w4a8 from it: K6 {k6} (205 a "
        f"forward), velocity vs bf16 {v_w8a8['w4a8']:.4e} (tol {QUANT_DIT_REL_TOL['w4a8']}); FLUX2_PALLAS_DEQUANT=1 "
        f"t2i qint8 --lora (the LoRA merged into the file's QTensors): K7 {k7} (202 a forward, 2 Turbo steps); "
        f"--dequantize-runtime: no K5-K7 launch [{card}]")
    for name in ("lora_diffusers", "lora_bfl"):
        os.unlink(os.path.join(workdir, name + ".safetensors"))

    # 6. QLoRA through the library, on a w8a8 and on a qint8 base (K7)
    out["qlora"] = {"w8a8": _qlora_run("w8a8", card, bf16_train_s_per_step)}
    os.environ["FLUX2_PALLAS_DEQUANT"] = "1"
    try:
        out["qlora"]["qint8"] = _qlora_run("qint8", card, bf16_train_s_per_step)
    finally:
        del os.environ["FLUX2_PALLAS_DEQUANT"]
    w = tq.to_w4a8(torch.randn(3072, 3072, device="cuda", generator=torch.Generator(device="cuda").manual_seed(SEED))
                   .mul_(3072**-0.5).bfloat16())
    out["xgrad_w4a8"] = _xgrad_check(w, 3072, "w4a8 [3072, 3072]", card)
    out["host_us"] = _wrapper_host_us(card)
    out.update(load_s=load_s, merge_s=merge_s, merge_rel=merge_rel, export_s=export_s, qint8_gb=qint8_gb,
               w8a8_rel=w8a8_rel, prequant_load_s=prequant_load_s, dense_load_s=dense_load_s, cli_load_s=cli_load_s,
               int4_gb=int4_gb, w4a8_rel=v_w8a8["w4a8"])
    return out


# -- the Dev / text-generation slice ------------------------------------------------------------------

# Mistral Small 3.2 at the published width (mistralai/Mistral-Small-3.2-24B-Instruct-2506's text_config:
# intermediate 32768; the built-in MISTRAL_SMALL_3_2, JAX's, has 14336).
MISTRAL_PUBLISHED_INTERMEDIATE = 32768
# K5, K6 and the prologue at Mistral's projections: (name, M, K, N) for a decode token (M = 1), a
# 37-token prefill and a 512-token encode.
MISTRAL_QMM_SHAPES = [
    ("decode_q_proj", 1, 5120, 4096),
    ("decode_k_proj", 1, 5120, 1024),
    ("decode_gate_proj", 1, 5120, 32768),
    ("decode_down_proj", 1, 32768, 5120),
    ("prefill37_gate_proj", 37, 5120, 32768),
    ("encode_down_proj", 512, 32768, 5120),
]
DEV_K1_SHAPE = (1, 48, 4608, 4608)  # Dev's 48 heads over 512 text + 4096 image tokens (1024^2)
# K5 at the Dev DiT's products (1024^2: 4096 image + 512 text tokens), whose weights (113-340 MB) are past the
# L2: the single blocks' MLP gate / up and q / k / v, the double blocks' image and text ff_in, the single
# blocks' output, the context embedder; then a ragged M whose last group of row bands is short.
DEV_K5_SHAPES = [
    ("single_mlp_gate", 4608, 6144, 18432),
    ("double_img_ff_in", 4096, 6144, 36864),
    ("double_txt_ff_in", 512, 6144, 36864),
    ("single_qkv", 4608, 6144, 6144),
    ("single_out", 4608, 18432, 6144),
    ("context_embedder", 512, 15360, 6144),
    ("ragged_m4100", 4100, 6144, 18432),
]
# A w8a8 Mistral encode against the bf16 one, relative L2 of the [1, 512, 15360] conditioning: the
# DiT's w8a8 limit (QUANT_DIT_REL_TOL); 40 layers of per-token int8 activations and per-channel int8
# weights, each a relative rounding of at most 1/254.
ENCODE_W8A8_REL_TOL = 0.1
# prefill + decode_step logits against forward_logits on the same tokens, bf16, relative L2 a row. A
# decode step multiplies one row (M = 1), the forward 51: cuBLAS takes other kernels, so already layer
# 0's k_proj differs (max abs 1.2e-4) and the bf16 roundings part ways, more with depth: 6.1e-3 after 1
# layer, 1.2e-2 after 10, 1.8e-2 after 40 on this random Mistral (phase_dev_encoder logs the error of
# the first 1 and 10 layers beside the 40's). A cache or mask error is O(1): a token written one slot
# late is checked to exceed the limit.
TEACHER_FORCED_REL_TOL = 3e-2
DEV_PROMPTS = ("a red fox in fresh snow at dawn, telephoto", "a lighthouse on a cliff at dusk")
DEV_STEPS = 4
# t2i in a process of its own, counting the launches of the whole command
DEV_CLI_CHILD = r"""
import json, sys, time
from flux2_tpu_torch.cli import main as cli
from flux2_tpu_torch.models.text_encoders import generation
from flux2_tpu_torch.ops import flash_attention as fa, quant_kernels as qk
made, real = [], generation.generate
def counted(*a, **k):
    t0 = time.perf_counter()
    out = real(*a, **k)
    made.append([len(out), time.perf_counter() - t0])
    return out
generation.generate = counted
rc = cli.main(sys.argv[1:])
counts = {**fa.launch_counts(), **qk.launches}
del counts["w8a8_grouped"]  # a share of K5's launches, left out as _launch_counts leaves it out
print("LAUNCHES " + json.dumps({"counts": counts, "generated": made}), flush=True)
sys.exit(rc)
"""


def _w8a8_launches(module, m: int) -> int:
    """K5 launches of one pass through ``module`` at M rows: its weights that
    take K5 once quantized to w8a8, counted on a meta-device copy of its shapes."""
    from flux2_tpu_torch.ops import quant as tq
    from flux2_tpu_torch.ops import quant_kernels as qk

    tq.quantize_params(module, "w8a8")
    n = 0
    for name in tq.quantized_names(module):
        w = module.get_submodule(name)
        n += qk.w8a8_supported(torch.empty(m, w.orig_in, device="meta", dtype=torch.bfloat16), w)
    return n


def phase_dev_kernels(card: str) -> dict:
    """K1 at Dev's (1, 48, 4608, 128) against its plain f32 version (relative L2,
    KERNEL_REL_TOL), alone, its bound and cuDNN's SDPA; K5, K6 and the prologue
    (per row and per 512-block) at MISTRAL_QMM_SHAPES equal to their plain
    versions to the bit (at M = 1 the C entry also writes into a 128-row
    buffer of canaries, which must keep all rows past 0), each alone
    (torch.profiler), as its wrapper, its bound and a dense bf16 F.linear of
    the same product (torch._int_mm takes no M <= 16); then K5 on both of its
    tile orders at the Dev DiT's shapes (``_dev_k5_order``)."""
    from flux2_tpu_torch.ops import flash_attention as fa
    from flux2_tpu_torch.ops import quant as tq
    from flux2_tpu_torch.ops import quant_kernels as qk
    from flux2_tpu_torch.utils import quant_candidate as qc
    from flux2_tpu_torch.utils.profile_step import kernel_time_ms

    gen = torch.Generator(device="cuda").manual_seed(SEED + 14)
    b, h, s_q, s_k = DEV_K1_SHAPE
    q, k, v = (torch.randn(b, h, s, 128, device="cuda", generator=gen).bfloat16() for s in (s_q, s_k, s_k))
    before = fa.launches
    out = fa.flash_attention(q, k, v).float()
    torch.cuda.synchronize()
    if fa.launches != before + 1:
        raise AssertionError("K1 at 48 heads: the wrapper did not launch its kernel")
    ref = fa.flash_attention_reference(q, k, v).float()
    rel, err = float((out - ref).norm() / ref.norm()), float((out - ref).abs().max())
    del out, ref
    if not rel <= KERNEL_REL_TOL:
        raise AssertionError(f"K1 dev_1024px: relative L2 err {rel} > {KERNEL_REL_TOL} (or non-finite)")
    flop = 4.0 * b * h * s_q * s_k * 128
    alone = kernel_time_ms(lambda: fa.flash_attention(q, k, v), "flash_fwd_kernel")
    ms = time_ms(lambda: fa.flash_attention(q, k, v))
    plain_ms = time_ms(lambda: fa.flash_attention_reference(q, k, v), reps=3, warmup=1)
    bound, bound_by = bound_ms(flop, attention_bytes(b, h, s_q, s_k, 2, 2, 0), BF16_FLOPS)
    library, library_ms = library_sdpa(q, k, v, card)
    log(f"[dev kernel] K1 dev_1024px q={[b, h, s_q, 128]}: rel_l2_err={rel} (tol {KERNEL_REL_TOL}) max_abs_err={err}; "
        f"alone {alone:.4f} ms ({flop / alone / 1e9:.1f} TFLOP/s), bound {bound:.4f} ms ({bound_by}; "
        f"{bound / alone:.1%} of it), wrapper {ms:.4f} ms, plain f32 {plain_ms:.4f} ms, {library} {library_ms} ms "
        f"[{card}]")
    results = {"k1": {"err": err, "rel": rel, "alone": alone, "ms": ms, "plain_ms": plain_ms, "bound": bound,
                      "bound_by": bound_by, "library": library, "library_ms": library_ms}}
    del q, k, v
    torch.cuda.empty_cache()

    rows = {}
    for name, m, kk, n in MISTRAL_QMM_SHAPES:
        x = torch.randn(m, kk, device="cuda", generator=gen).bfloat16()
        w = (torch.randn(n, kk, device="cuda", generator=gen) * kk**-0.5).bfloat16()
        row = {"dense_ms": library_time(lambda: torch.nn.functional.linear(x, w), "F.linear bf16", card)}
        for fmt, quantize, kernel, plain, mark in (
                ("w8a8", tq.to_w8a8, qk.w8a8_matmul, qk.w8a8_matmul_reference, "w8a8_kernel"),
                ("w4a8", tq.to_w4a8, qk.w4a8_matmul, qk.w4a8_matmul_reference, "w4a8_kernel")):
            qw = quantize(w)
            before = dict(qk.launches)
            out = kernel(x, qw)
            torch.cuda.synchronize()
            launched = {c: qk.launches[c] - before[c] for c in before if qk.launches[c] != before[c]}
            if launched != _wrapper_launches(fmt, m, kk, n):
                raise AssertionError(f"{fmt} {name}: the wrapper launched {launched}")
            if not torch.equal(out, plain(x, qw)):
                raise AssertionError(f"{fmt} {name} (M,K,N)=({m},{kk},{n}): not equal to its plain version "
                                     f"(max abs {float((out.float() - plain(x, qw).float()).abs().max())})")
            if m == 1:  # a decode row is 1 of a 128-row tile: its C entry writes into a 128-row canary buffer
                buf = torch.full((128, n), 7.0, device="cuda", dtype=torch.bfloat16)
                qc.call(qk._kernel(qc.ENTRY[fmt]), qc.entry_args(fmt, x, qw), buf)
                torch.cuda.synchronize()
                if not (torch.equal(buf[:1], out) and bool((buf[1:] == 7.0).all())):
                    raise AssertionError(f"{fmt} {name}: the epilogue stored past row 0 of an M = 1 product")
            a = kernel_time_ms(lambda: kernel(x, qw), mark)
            wms = time_ms(lambda: kernel(x, qw))
            pms = time_ms(lambda: plain(x, qw), reps=5)
            codes = qw.q.numel()  # int8 codes (w8a8) or packed bytes (w4a8)
            scales = 4 * qw.scale.numel()
            xb = m * kk + 4 * m * (1 if fmt == "w8a8" else kk // 512)
            bnd = bound_ms(2.0 * m * n * kk, xb + codes + scales + 2 * m * n, INT8_OPS)
            log(f"[dev kernel] {fmt} {name} (M,K,N)=({m},{kk},{n}): equal to its plain version to the bit; alone "
                f"{a:.4f} ms ({(xb + codes + scales + 2 * m * n) / a / 1e6:.1f} GB/s), bound {bnd[0]:.4f} ms "
                f"({bnd[1]}; {bnd[0] / a:.1%} of it), wrapper {wms:.4f} ms, plain {pms:.4f} ms, dense bf16 "
                f"F.linear {row['dense_ms']} ms [{card}]")
            row[fmt] = {"alone": a, "ms": wms, "plain_ms": pms, "bound": bnd, "err": 0.0}
            del qw
        for block, plain in ((kk, lambda: qk.quantize_rows(x)), (512, lambda: qk.quantize_row_blocks(x, 512))):
            xq, xs = qk.quantize_activations(x, block)
            ref_q, ref_s = plain()
            if not (torch.equal(xq, ref_q) and torch.equal(xs.reshape(ref_s.shape).view(torch.int32),
                                                           ref_s.view(torch.int32))):
                raise AssertionError(f"prologue {name} block {block}: not equal to the plain chain")
            a = kernel_time_ms(lambda: qk.quantize_activations(x, block), PROLOGUE_MARK)
            nbytes = 2 * m * kk + m * kk + 4 * m * (kk // block)
            bnd = bound_ms(0.0, nbytes, INT8_OPS)
            log(f"[dev kernel] prologue {name} (M,K)=({m},{kk}) block {block}: equal to the plain chain to the bit; "
                f"alone {a:.4f} ms, bound {bnd[0]:.6f} ms ({bnd[1]}; {bnd[0] / a:.1%} of it), plain chain "
                f"{time_ms(plain):.4f} ms [{card}]")
            row[f"prologue_{block}"] = {"alone": a, "bound": bnd}
        rows[name] = row
        del x, w
        torch.cuda.empty_cache()
    results["qmm"] = rows
    results["k5_order"] = _dev_k5_order(gen, card)
    return results


def _dev_k5_order(gen, card: str) -> dict:
    """K5 at DEV_K5_SHAPES on both tile orders of its C entry: ``group`` 1 (row
    band major, the order before ``quant_kernels.w8a8_group``) and the group
    the wrapper takes. Each order writes into outputs filled with canaries, bf16
    and f32, which must equal the plain version to the bit (a tile never written,
    or written from a wrong map, fails); the wrapper must count the grouped
    launch; then each order alone (torch.profiler, in turns: 1, G, G, 1) and its
    share of the bound."""
    from flux2_tpu_torch.ops import quant as tq
    from flux2_tpu_torch.ops import quant_kernels as qk
    from flux2_tpu_torch.utils import quant_candidate as qc
    from flux2_tpu_torch.utils.profile_step import kernel_time_ms

    entry = qk._kernel(qc.ENTRY["w8a8"])
    rows = {}
    for name, m, k, n in DEV_K5_SHAPES:
        x = torch.randn(m, k, device="cuda", generator=gen).bfloat16()
        qw = tq.to_w8a8((torch.randn(n, k, device="cuda", generator=gen) * k**-0.5).bfloat16())
        args = qc.entry_args("w8a8", x, qw)
        group = args[-1]
        orders = {1: args[:-1] + (1,), group: args}
        for dtype in (torch.bfloat16, torch.float32):
            ref = qk.w8a8_matmul_reference(x.to(dtype), qw)
            for g, a in orders.items():
                out = qc.call(entry, a, torch.full((m, n), 7.0, device="cuda", dtype=dtype))
                torch.cuda.synchronize()
                if not torch.equal(out, ref):
                    raise AssertionError(f"K5 {name} (M,K,N)=({m},{k},{n}) group {g} {dtype}: not equal to its plain "
                                         f"version ({int((out != ref).sum())} elements differ)")
            del ref, out
        before = dict(qk.launches)
        qk.w8a8_matmul(x, qw)
        torch.cuda.synchronize()
        launched = {c: qk.launches[c] - before[c] for c in before if qk.launches[c] != before[c]}
        if launched != _wrapper_launches("w8a8", m, k, n):
            raise AssertionError(f"K5 {name}: the wrapper launched {launched} at group {group}")
        buf = torch.empty(m, n, device="cuda", dtype=torch.bfloat16)
        times = {g: [] for g in (1, group)}
        for g in (1, group, group, 1):
            times[g].append(kernel_time_ms(lambda: qc.call(entry, orders[g], buf), "w8a8_kernel"))
        bnd = bound_ms(2.0 * m * n * k, m * k + 4 * m + n * k + 4 * n + 2 * m * n, INT8_OPS)
        row = {"group": group, "bound": bnd, **{f"alone_g{g}": t for g, t in times.items()}}
        log(f"[dev kernel] K5 order {name} (M,K,N)=({m},{k},{n}): both orders equal to the plain version to the bit "
            f"(bf16, f32, canaries); alone, row-band major (group 1) "
            + " / ".join(f"{t:.4f}" for t in times[1]) + f" ms ({bnd[0] / statistics.mean(times[1]):.1%} of the "
            f"bound), groups of {group} bands " + " / ".join(f"{t:.4f}" for t in times[group])
            + f" ms ({bnd[0] / statistics.mean(times[group]):.1%}); bound {bnd[0]:.4f} ms ({bnd[1]}) [{card}]")
        rows[name] = row
        del x, qw, args, orders, buf
        torch.cuda.empty_cache()
    return rows


def phase_dev_encoder(card: str) -> dict:
    """Mistral Small 3.2 at the published width (40 layers, 5120 hidden, 32 x 128
    heads, 8 KV heads, intermediate 32768, vocab 131072), random bf16 from a seed
    on the card, with the byte-fallback Tekken tokenizer, registered in
    facade.shared: two prompts encoded to [1, 512, 15360]; prefill + 16
    decode_steps against forward_logits on the same tokens; upsample_prompt
    and chat with max_tokens 32, streamed; then quantize_encoder_params(w8a8)
    in place: the encode against bf16, and a greedy 16-token decode with
    exactly 280 K5 launches a token. Returns the bf16 embeddings and the
    numbers; the encoder is unloaded."""
    import dataclasses

    from flux2_tpu_torch.models.text_encoders import facade, generation
    from flux2_tpu_torch.models.text_encoders.config import MISTRAL_HIDDEN_LAYERS, MISTRAL_SMALL_3_2
    from flux2_tpu_torch.models.text_encoders.decoder import Qwen3Decoder, init_kv_cache
    from flux2_tpu_torch.models.text_encoders.extractor import build_messages, quantize_encoder_params
    from flux2_tpu_torch.models.text_encoders.tekken import TekkenTokenizer
    from flux2_tpu_torch.ops import quant as tq

    cfg = dataclasses.replace(MISTRAL_SMALL_3_2, intermediate_size=MISTRAL_PUBLISHED_INTERMEDIATE)
    out = {}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    decoder = Qwen3Decoder(cfg, device="cuda", generator=torch.Generator(device="cuda").manual_seed(SEED + 20))
    torch.cuda.synchronize()
    tok = TekkenTokenizer.byte_fallback()
    enc = facade.shared.attach("mistral", decoder, cfg, tok, MISTRAL_HIDDEN_LAYERS, recipe="mistral")
    log(f"[dev encoder] random Mistral Small 3.2 at the published width drawn on the card in "
        f"{time.perf_counter() - t0:.2f} s: {tq.param_bytes(decoder) / 2**30:.2f} GiB, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated [{card}]")

    embeds = []
    for prompt in DEV_PROMPTS:
        e = enc.extractor(prompt)
        if tuple(e.shape) != (1, 512, 15360) or not torch.isfinite(e).all():
            raise AssertionError(f"Mistral encode: {tuple(e.shape)}, finite {bool(torch.isfinite(e).all())}")
        embeds.append(e)
    out["encode_ms"] = time_ms(lambda: enc.extractor(DEV_PROMPTS[0]), reps=3, warmup=1)
    log(f"[dev encoder] two prompts -> [1, 512, 15360] finite; a warm 512-token encode {out['encode_ms']:.3f} ms "
        f"[{card}]")

    # teacher forcing: a chat prompt and 16 tokens drawn from the vocabulary
    prompt_ids = tok.apply_chat_template([{"role": "user", "content": DEV_PROMPTS[0]}], add_generation_prompt=True)
    extra = torch.randint(0, cfg.vocab_size, (16,), device="cuda",
                          generator=torch.Generator(device="cuda").manual_seed(SEED + 21))
    ids = torch.cat([torch.tensor(prompt_ids, device="cuda"), extra])[None]
    p = len(prompt_ids)
    with torch.inference_mode():
        full = decoder.forward_logits(ids)
        cache = init_kv_cache(cfg, 1, ids.shape[1], torch.bfloat16, "cuda")
        rows = [decoder.prefill(ids[:, :p], cache)[0]]
        rows += [decoder.decode_step(ids[:, t:t + 1], cache)[0] for t in range(p, ids.shape[1])]
        rels = [float((r - full[:, p - 1 + i]).norm() / full[:, p - 1 + i].norm()) for i, r in enumerate(rows)]
        if max(rels) > TEACHER_FORCED_REL_TOL or not all(torch.isfinite(r).all() for r in rows):
            raise AssertionError(f"prefill + decode_step vs forward_logits: relative L2 {rels} > "
                                 f"{TEACHER_FORCED_REL_TOL}")
        by_depth = {}
        layers = decoder.layers
        try:  # the same check through the first layers only: how the bf16 difference grows with depth
            for depth in (1, 10):
                decoder.layers, decoder.cfg = layers[:depth], dataclasses.replace(cfg, num_hidden_layers=depth)
                ref_d = decoder.forward_logits(ids)
                c = init_kv_cache(decoder.cfg, 1, ids.shape[1], torch.bfloat16, "cuda")
                got = [decoder.prefill(ids[:, :p], c)[0]] + [decoder.decode_step(ids[:, t:t + 1], c)[0]
                                                             for t in range(p, ids.shape[1])]
                by_depth[depth] = max(float((r - ref_d[:, p - 1 + i]).norm() / ref_d[:, p - 1 + i].norm())
                                      for i, r in enumerate(got))
        finally:
            decoder.layers, decoder.cfg = layers, cfg
        by_depth[cfg.num_hidden_layers] = max(rels)
        late = init_kv_cache(cfg, 1, ids.shape[1] + 1, torch.bfloat16, "cuda")
        decoder.prefill(ids[:, :p], late)
        late.length += 1  # the first decoded token one slot (and one position) late
        wrong = decoder.decode_step(ids[:, p:p + 1], late)[0]
        wrong_rel = float((wrong - full[:, p]).norm() / full[:, p].norm())
        if not wrong_rel > TEACHER_FORCED_REL_TOL:
            raise AssertionError(f"the tolerance {TEACHER_FORCED_REL_TOL} would pass a token one slot late "
                                 f"({wrong_rel})")
        up_ids = torch.tensor([tok.apply_chat_template(build_messages(DEV_PROMPTS[1], "upsampling_t2i"),
                                                       add_generation_prompt=True)], device="cuda")
        out["prefill_tokens"] = up_ids.shape[1]
        out["prefill_ms"] = time_ms(lambda: decoder.prefill(up_ids, init_kv_cache(cfg, 1, up_ids.shape[1] + 1,
                                                                                    torch.bfloat16, "cuda")),
                                    reps=3, warmup=1)

        def step_ms():
            cache = init_kv_cache(cfg, 1, p + 1, torch.bfloat16, "cuda")
            decoder.prefill(ids[:, :p], cache)
            tok1 = ids[:, p:p + 1]

            def one():
                cache.length = p
                decoder.decode_step(tok1, cache)
            return time_ms(one, reps=10, warmup=2)
        out["decode_step_ms_bf16"] = step_ms()
    out.update(teacher_forced_rel=max(rels), teacher_forced_by_depth=by_depth, one_slot_late_rel=wrong_rel)
    log(f"[dev encoder] prefill ({p} tokens) + 16 decode_steps vs forward_logits: relative L2 max {max(rels):.3e} "
        f"(tol {TEACHER_FORCED_REL_TOL}; through the first 1 / 10 / 40 layers "
        f"{' / '.join(f'{v:.3e}' for v in by_depth.values())}; a token one slot late gives {wrong_rel:.3e}); prefill of the {out['prefill_tokens']}-token upsampling prompt "
        f"{out['prefill_ms']:.3f} ms; a bf16 decode_step {out['decode_step_ms_bf16']:.3f} ms [{card}]")

    params = dataclasses.replace(generation.GenerateParameters.upsampling(), max_tokens=32)
    made = []
    t0 = time.perf_counter()
    text = generation.upsample_prompt(decoder, tok, DEV_PROMPTS[1], gen_params=params, seed=SEED, on_token=made.append)
    torch.cuda.synchronize()
    up_s = time.perf_counter() - t0
    pieces = []
    t0 = time.perf_counter()
    reply = facade.shared.chat([{"role": "user", "content": "Describe a lighthouse in one sentence."}], "mistral",
                               params=generation.GenerateParameters(max_tokens=32), seed=SEED,
                               on_token=pieces.append, enable_thinking=True)
    torch.cuda.synchronize()
    chat_s = time.perf_counter() - t0
    if not 1 <= len(made) <= 32 or not 1 <= len(pieces) <= 32 or not isinstance(reply, str) or not text:
        raise AssertionError(f"upsample {len(made)} tokens, chat {len(pieces)} pieces")
    out.update(upsample={"tokens": len(made), "s": up_s, "tok_per_s": len(made) / up_s},
               chat={"tokens": len(pieces), "s": chat_s, "tok_per_s": len(pieces) / chat_s})
    log(f"[dev encoder] upsample_prompt (max_tokens 32, streamed): {len(made)} tokens in {up_s:.3f} s "
        f"({len(made) / up_s:.2f} tok/s, its {out['prefill_tokens']}-token prefill included); chat: {len(pieces)} "
        f"tokens in {chat_s:.3f} s ({len(pieces) / chat_s:.2f} tok/s) [{card}]")

    t0 = time.perf_counter()
    quantize_encoder_params(decoder, "w8a8")
    torch.cuda.synchronize()
    quant_s = time.perf_counter() - t0
    if tq.is_quantized(decoder.lm_head) or not tq.quantized_names(decoder):
        raise AssertionError("quantize_encoder_params: the layers quantized, the LM head dense")
    eq = enc.extractor(DEV_PROMPTS[0])
    rel = float((eq.float() - embeds[0].float()).norm() / embeds[0].float().norm())
    if not rel <= ENCODE_W8A8_REL_TOL:
        raise AssertionError(f"w8a8 encode vs bf16: relative L2 {rel} > {ENCODE_W8A8_REL_TOL}")
    out["encode_ms_w8a8"] = time_ms(lambda: enc.extractor(DEV_PROMPTS[0]), reps=3, warmup=1)
    per_pass = _w8a8_launches(Qwen3Decoder(cfg, device="meta").layers, 1)
    with torch.inference_mode():
        cache = init_kv_cache(cfg, 1, p + 1, torch.bfloat16, "cuda")
        decoder.prefill(ids[:, :p], cache)
        tok1 = ids[:, p:p + 1]

        def one():
            cache.length = p
            decoder.decode_step(tok1, cache)
        out["decode_step_ms_w8a8"] = time_ms(one, reps=10, warmup=2)
    _zero_launches()
    t0 = time.perf_counter()
    greedy = generation.generate(decoder, prompt_ids, generation.GenerateParameters(max_tokens=16, temperature=0.0))
    torch.cuda.synchronize()
    greedy_s = time.perf_counter() - t0
    counts = _launch_counts()
    n = len(greedy)
    _expect_counts("greedy w8a8 decode", counts, {"w8a8": per_pass * (1 + n), "quantize_rows": per_pass * (1 + n)})
    if per_pass != 280 or n != 16:
        raise AssertionError(f"{per_pass} K5 launches a pass (want 280), {n} tokens (want 16)")
    out.update(w8a8_rel=rel, quantize_s=quant_s, greedy={"tokens": n, "s": greedy_s, "counts": counts,
                                                         "k5_per_token": (counts["w8a8"] - per_pass) / n})
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    log(f"[dev encoder] quantize_encoder_params w8a8 in place {quant_s:.2f} s ({tq.param_bytes(decoder) / 2**30:.2f} "
        f"GiB); encode vs bf16 relative L2 {rel:.4e} (tol {ENCODE_W8A8_REL_TOL}), warm encode "
        f"{out['encode_ms_w8a8']:.3f} ms; greedy decode of {n} tokens {greedy_s:.3f} s ({n / greedy_s:.2f} tok/s, "
        f"prefill included), launches {counts}: K5 {per_pass} for the prefill and {per_pass} a token; a w8a8 "
        f"decode_step {out['decode_step_ms_w8a8']:.3f} ms; peak device memory {out['peak_gib']:.2f} GiB [{card}]")
    facade.shared.unload_all()
    del enc, decoder, full, rows, eq
    gc_cuda()
    out["embeddings"] = [e.detach() for e in embeds]
    return out


def phase_dev_dit(card: str, workdir: str, embeddings) -> dict:
    """The Dev DiT at full width (8 double + 48 single blocks, 48 heads, joint
    15360) in bf16 from a seed on the card, with the FLUX.2 VAE: one 1024^2
    forward on K1 against plain attention (DIT_REL_TOL), then a 1024^2 generate
    of DEV_STEPS steps at guidance 4.0 from the Mistral embeddings, decoded to a
    PNG: exactly 56 K1 launches a step; s/step and the peak per step."""
    import numpy as np

    from flux2_tpu_torch.ops import latents as lu
    from flux2_tpu_torch.ops import quant as tq
    from flux2_tpu_torch.ops.rope import rope_embeddings
    from flux2_tpu_torch.pipeline.pipeline import Flux2Model, Flux2Pipeline

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    pipe = Flux2Pipeline.from_random(Flux2Model.DEV, device="cuda",
                                     generator=torch.Generator(device="cuda").manual_seed(SEED + 22))
    torch.cuda.synchronize()
    cfg = pipe.transformer.config
    log(f"[dev dit] random Dev DiT ({cfg.num_layers} + {cfg.num_single_layers} blocks, {cfg.num_attention_heads} "
        f"heads, joint {cfg.joint_attention_dim}) + FLUX.2 VAE drawn in {time.perf_counter() - t0:.2f} s: DiT "
        f"{tq.param_bytes(pipe.transformer) / 2**30:.2f} GiB, {torch.cuda.memory_allocated() / 2**30:.2f} GiB "
        f"allocated [{card}]")
    emb = embeddings[0]
    noise = lu.seeded_noise_seq(SEED, 1024, 1024, 1, device="cuda").bfloat16()
    ids = np.concatenate([lu.text_position_ids(512), lu.image_position_ids(1024, 1024)])
    cos, sin = rope_embeddings(torch.from_numpy(ids).cuda())
    t = torch.full((1,), 0.7, device="cuda")
    g = torch.full((1,), 4.0, device="cuda")
    with torch.inference_mode():
        _zero_launches()
        v_kernel = pipe.transformer(noise, emb, t, cos, sin, guidance=g).float()
        torch.cuda.synchronize()
        _expect_counts("Dev forward", _launch_counts(), {"flash": cfg.num_layers + cfg.num_single_layers})
        os.environ["FLUX2_DISABLE_FLASH"] = "1"
        try:
            v_plain = pipe.transformer(noise, emb, t, cos, sin, guidance=g).float()
        finally:
            del os.environ["FLUX2_DISABLE_FLASH"]
    rel = float((v_kernel - v_plain).norm() / v_plain.norm())
    if not torch.isfinite(v_kernel).all() or rel > DIT_REL_TOL:
        raise AssertionError(f"Dev DiT with K1 vs plain attention: relative L2 {rel} > {DIT_REL_TOL}")
    del v_kernel, v_plain
    log(f"[dev dit] 1024^2 forward, K1 vs plain attention: relative L2 {rel:.3e} (tol {DIT_REL_TOL}); peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{card}]")
    gc_cuda()
    torch.cuda.reset_peak_memory_stats()
    peaks = []
    _zero_launches()
    res = pipe.generate(embeddings=emb, height=1024, width=1024, num_steps=DEV_STEPS, guidance=4.0, seed=SEED,
                        on_progress=lambda k, n: peaks.append(torch.cuda.max_memory_allocated() / 2**30))
    counts = _launch_counts()
    want = DEV_STEPS * (cfg.num_layers + cfg.num_single_layers)
    _expect_counts(f"Dev 1024^2 generate of {DEV_STEPS} steps", counts, {"flash": want})
    _valid_image("Dev 1024^2 image", res.image, (1024, 1024, 3))
    path = _write_file(os.path.join(workdir, "dev_1024.png"), _png_of(res.image))
    out = {"forward_rel": rel, "s_per_step": _s_per_step(res), "launches": counts["flash"], "peaks_gib": peaks,
           "phases": res.phase_timings}
    log(f"[dev dit] 1024^2 generate, {DEV_STEPS} steps at guidance 4.0 from the Mistral embeddings: K1 "
        f"{counts['flash']} launches ({want} = {DEV_STEPS} x 56), {out['s_per_step']:.4f} s/step, phases "
        f"{ {k: round(v, 4) for k, v in res.phase_timings.items()} }, peak device memory after each step "
        f"{[round(x, 2) for x in peaks]} GiB; {path} [{card}]")
    del pipe, res
    gc_cuda()
    return out


def phase_dev_cli(card: str, workdir: str) -> dict:
    """``t2i --model dev --random-init --quantization w8a8 --encoder-quantization
    w8a8 --steps 2 --upsample`` at 1024^2 in a process of its own (the launch
    counts read there, from 0): the PNG, the "[upsample] final prompt:" line,
    K1 2 x 56 and K5 (and the prologue) 2 x 440 for the DiT plus 280 for each
    Mistral pass: the upsample's prefill, one a generated token, the encode."""
    from flux2_tpu_torch.io.png import decode_png
    from flux2_tpu_torch.models.flux2.config import Flux2Model
    from flux2_tpu_torch.models.flux2.transformer import Flux2Transformer
    from flux2_tpu_torch.models.text_encoders.config import MISTRAL_SMALL_3_2
    from flux2_tpu_torch.models.text_encoders.decoder import Qwen3Decoder

    dit_pass = _w8a8_launches(Flux2Transformer(Flux2Model.DEV.transformer_config, device="meta"), 4096)
    enc_pass = _w8a8_launches(Qwen3Decoder(MISTRAL_SMALL_3_2, device="meta").layers, 1)
    out_png = os.path.join(workdir, "dev_cli.png")
    argv = ["t2i", "--model", "dev", "--random-init", "--quantization", "w8a8", "--encoder-quantization", "w8a8",
            "--steps", "2", "--upsample", "--prompt", DEV_PROMPTS[0], "-o", out_png]
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", DEV_CLI_CHILD, *argv], capture_output=True, text=True, timeout=900,
                          cwd=os.path.dirname(os.path.abspath(__file__)))
    wall = time.perf_counter() - t0
    for line in (proc.stdout + proc.stderr).strip().splitlines():
        if not line.startswith("LAUNCHES "):  # the random model's rewrite is random bytes: escaped
            log(f"[dev cli] {line[:300] if line.isprintable() else ascii(line)[:300]}")
    if proc.returncode != 0:
        raise AssertionError(f"t2i --model dev exited {proc.returncode}")
    report = json.loads(next(l for l in proc.stdout.splitlines() if l.startswith("LAUNCHES "))[len("LAUNCHES "):])
    (n, gen_s), = report["generated"]
    counts = report["counts"]
    k5 = 2 * dit_pass + enc_pass * (n + 2)
    _expect_counts("t2i --model dev", counts, {"flash": 2 * 56, "w8a8": k5, "quantize_rows": k5})
    if "[upsample] final prompt: " not in proc.stdout:
        raise AssertionError("t2i --upsample printed no '[upsample] final prompt:' line")
    with open(out_png, "rb") as f:
        img = decode_png(f.read())
    if img.shape != (1024, 1024, 3) or int(img.max()) == int(img.min()):
        raise AssertionError(f"t2i --model dev: PNG {img.shape}")
    log(f"[dev cli] t2i --model dev --random-init w8a8/w8a8 --steps 2 --upsample in its own process: {wall:.2f} s "
        f"wall; the upsample generated {n} tokens in {gen_s:.3f} s ({n / gen_s:.2f} tok/s with its prefill); "
        f"launches {counts} (K5 a DiT forward {dit_pass}, a Mistral pass {enc_pass}); 1024^2 PNG written [{card}]")
    return {"wall_s": wall, "tokens": n, "upsample_s": gen_s, "counts": counts, "dit_pass": dit_pass,
            "enc_pass": enc_pass}


def phase_dev(card: str) -> dict:
    """The Dev / text-generation slice: A kernels, B the Mistral encoder and
    generation, C the Dev DiT from B's embeddings, D ``t2i --model dev`` in a
    process of its own; each part's seconds."""
    out, secs = {}, {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_dev_") as workdir:
        for name, fn in (("kernels", lambda: phase_dev_kernels(card)), ("encoder", lambda: phase_dev_encoder(card)),
                         ("dit", lambda: phase_dev_dit(card, workdir, out["encoder"]["embeddings"])),
                         ("cli", lambda: phase_dev_cli(card, workdir))):
            t0 = time.perf_counter()
            out[name] = fn()
            secs[name] = time.perf_counter() - t0
            gc_cuda()
    out["encoder"].pop("embeddings")
    out["seconds"] = secs
    log(f"[dev] phase: {sum(secs.values()):.2f} s ({ {k: round(v, 2) for k, v in secs.items()} }) [{card}]")
    return out


# -- the VLM slice ------------------------------------------------------------------------------------

# Pixtral at a 1008^2 image: 72 x 72 patches of 14 px, merged 2x2 into 1296 image tokens. A 1024^2 image
# gives 73 x 73 patches: an odd grid the 2x2 merger cannot tile (the port's ValueError).
VLM_PIXTRAL_SIDE = 1008
VLM_ODD_SIDE = 1024
VLM_TOKENS = 32
VLM_PROMPT = "Describe this image in detail."
# Qwen3.5 at a 1024^2 image: 64 x 64 patches of 16 px, merged 2x2 into 1024 image tokens.
VLM_QWEN35_SIDE = 1024
VLM_TEACHER_STEPS = 16
# prefill + 16 decode steps against forward_logits of the whole sequence, relative L2 the worst row. With
# the weights in f32 (TF32 off) both paths run f32 and differ only in summation order: a cache, mask or
# position error is O(1e-1) and more. The bf16 model is held against that f32 forward: this random Qwen3.5
# amplifies bf16 rounding (a first chip run measured its bf16 forward_logits 0.149 from the f32 one, the
# service's path 0.091: f32 conv and KV caches, JAX's init_hybrid_cache, make it f32 after layer 3), so
# the bound is the bf16 forward's own distance with a third of margin.
VLM_TEACHER_FORCED_F32_TOL = 1e-3
VLM_TEACHER_FORCED_REL_TOL = 0.2
# the chunked Gated DeltaNet against the sequential recurrence, f32 (TF32 off), over S >= 1024 tokens of
# one layer's q, k, v and beta: max abs error of y (and of the final state) over max |y| (|state|). Once
# with the layer's own g, once with g drawn in DELTA_STRONG_G: there a 64-token chunk's decay sums past
# -88.72 (log of float32's largest), the exponent JAX's chunked form takes above the diagonal overflows
# (its NaN), while neighbouring tokens still interact (ratios 0.1-0.2).
DELTA_S = 1024
DELTA_REL_TOL = 1e-4
DELTA_STRONG_G = (0.1, 0.2)
# the CLI's Qwen3.5-VL checkpoint: full width, the depth cut to one period of the hybrid stack (3
# DeltaNet layers + 1 full-attention layer) and 2 vision blocks
VLM_CLI_LM_LAYERS = 4
VLM_CLI_VISION_DEPTH = 2
VLM_CLI_SIDE = 512


def _number(tag: str, what: str, value: float, unit: str, card: str, note: str = "") -> float:
    """Log one measured number on a line of its own; returns it."""
    log(f"[{tag}] {what}: {value:.6g} {unit}{f' ({note})' if note else ''} [{card}]")
    return value


class _ReplyRecorder:
    """Records every reply a VLM service's ``chat`` / ``analyze_image`` gives
    (patched on the class for the block)."""

    def __init__(self, *classes):
        self.classes, self.replies, self.saved = classes, [], []

    def __enter__(self):
        for cls in self.classes:
            for name in ("chat", "analyze_image"):
                if name in vars(cls):
                    real = vars(cls)[name]
                    self.saved.append((cls, name, real))
                    setattr(cls, name, self._wrap(real, f"{cls.__name__}.{name}"))
        return self

    def _wrap(self, real, label):
        def wrapped(svc, *a, **k):
            reply = real(svc, *a, **k)
            self.replies.append((label, reply))
            return reply
        return wrapped

    def __exit__(self, *exc):
        for cls, name, real in self.saved:
            setattr(cls, name, real)


def _k5_prefill_against_plain(svc, image, per_pass: int, card: str) -> dict:
    """Every K5 call of one w8a8 VLM prefill (the image tokens and the prompt:
    M = 1320 rows, ten full 128-row tiles and a ragged one, at K 5120 and
    32768) held against ``w8a8_matmul_reference`` on the same activations:
    equal to the bit, as K5 is at the served shapes."""
    from flux2_tpu_torch.ops import quant_kernels as qk

    real, shapes = qk.w8a8_matmul, {}

    def held(x, w):
        y = real(x, w)
        ref = qk.w8a8_matmul_reference(x, w)
        mkn = (x.numel() // x.shape[-1], x.shape[-1], w.q.shape[0])
        if not torch.equal(y, ref):
            raise AssertionError(f"K5 in the VLM prefill, (M,K,N)={mkn}: max abs "
                                 f"{float((y.float() - ref.float()).abs().max())} from its plain version, want equal")
        shapes[mkn] = shapes.get(mkn, 0) + 1
        return y
    qk.w8a8_matmul = held
    try:
        with torch.inference_mode():
            svc.prefill(image, VLM_PROMPT, 1)
    finally:
        qk.w8a8_matmul = real
    calls = sum(shapes.values())
    if calls != per_pass:
        raise AssertionError(f"the w8a8 VLM prefill made {calls} K5 calls, want {per_pass}")
    log(f"[vlm A] w8a8 prefill: all {calls} K5 calls equal to w8a8_matmul_reference to the bit, (M,K,N) x calls "
        f"{ {'x'.join(map(str, k)): v for k, v in sorted(shapes.items())} } [{card}]")
    _number("vlm A", "w8a8 prefill, K5 calls equal to their plain version to the bit", calls, "", card)
    return {"calls": calls, "shapes": {"x".join(map(str, k)): v for k, v in shapes.items()}}


def phase_vlm_mistral(card: str) -> dict:
    """A: Mistral Small 3.2 at the published width with Pixtral at its built-in
    width (24 blocks, hidden 1024), random from a seed on the card: the tower
    and projector on a 1008^2 image (1296 image tokens), greedy
    ``analyze_image`` of 32 tokens in bf16, the prefill logits of two
    different images apart, a 1024^2 image refused (odd patch grid), then the
    LM quantized to w8a8 in place: every K5 call of a prefill equal to its
    plain version to the bit, then the same analysis at exactly 280 K5 (and
    prologue) launches a pass (the prefill and each stepped token)."""
    import dataclasses

    import numpy as np

    from flux2_tpu_torch.models.text_encoders import generation
    from flux2_tpu_torch.models.text_encoders.config import MISTRAL_SMALL_3_2
    from flux2_tpu_torch.models.text_encoders.decoder import Qwen3Decoder
    from flux2_tpu_torch.models.text_encoders.extractor import quantize_encoder_params
    from flux2_tpu_torch.models.text_encoders.pixtral import PixtralVision, PixtralVisionConfig
    from flux2_tpu_torch.models.text_encoders.tekken import random_init_tokenizer
    from flux2_tpu_torch.models.text_encoders.vlm_service import MistralVLMService
    from flux2_tpu_torch.ops import quant as tq

    cfg = dataclasses.replace(MISTRAL_SMALL_3_2, intermediate_size=MISTRAL_PUBLISHED_INTERMEDIATE)
    vcfg = PixtralVisionConfig(text_hidden_size=cfg.hidden_size)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 30)
    decoder = Qwen3Decoder(cfg, device="cuda", generator=gen)
    vision = PixtralVision.from_random(vcfg, "cuda", gen)
    torch.cuda.synchronize()
    svc = MistralVLMService(decoder, cfg, vision, vcfg, random_init_tokenizer(cfg.vocab_size))
    log(f"[vlm A] random Mistral Small 3.2 (published width) + Pixtral ({vcfg.num_hidden_layers} blocks, hidden "
        f"{vcfg.hidden_size}) drawn in {time.perf_counter() - t0:.2f} s: Pixtral {tq.param_bytes(vision) / 2**30:.2f} "
        f"GiB, {torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated [{card}]")
    images = [reference_image(VLM_PIXTRAL_SIDE), np.ascontiguousarray(reference_image(VLM_PIXTRAL_SIDE)[::-1])]
    images = [im.astype(np.float32) / 255.0 for im in images]
    feats = svc.encode_image(images[0])
    n_img = (VLM_PIXTRAL_SIDE // vcfg.patch_size // 2) ** 2
    if tuple(feats.shape) != (1, n_img, cfg.hidden_size) or not torch.isfinite(feats).all():
        raise AssertionError(f"Pixtral: {tuple(feats.shape)}, want (1, {n_img}, {cfg.hidden_size}), finite")
    out = {"image_tokens": n_img, "tower_ms": time_ms(lambda: svc.encode_image(images[0]), reps=3, warmup=1)}
    with torch.inference_mode():
        rows = [svc.prefill(im, VLM_PROMPT, 1)[0].float() for im in images]
    out["logit_diff"] = float((rows[0] - rows[1]).abs().max())
    if not all(torch.isfinite(r).all() for r in rows) or not out["logit_diff"] > 0:
        raise AssertionError(f"two images' prefill logits: max abs difference {out['logit_diff']}")
    out["prefill_ms"] = time_ms(lambda: svc.prefill(images[0], VLM_PROMPT, 1), reps=3, warmup=1)
    try:
        svc.encode_image(reference_image(VLM_ODD_SIDE).astype(np.float32) / 255.0)
    except ValueError as e:
        if "even patch grid" not in str(e):
            raise
        out["odd_grid_error"] = str(e)
    else:
        raise AssertionError(f"a {VLM_ODD_SIDE}^2 image (73 x 73 patches) was not refused")
    log(f"[vlm A] Pixtral + projector at {VLM_PIXTRAL_SIDE}^2 -> (1, {n_img}, {cfg.hidden_size}), finite; "
        f"{VLM_ODD_SIDE}^2 refused: {out['odd_grid_error']} [{card}]")
    _number("vlm A", f"Pixtral + projector at {VLM_PIXTRAL_SIDE}^2, warm", out["tower_ms"], "ms", card)
    _number("vlm A", f"bf16 prefill of {n_img} image + prompt tokens, tower included", out["prefill_ms"], "ms", card)
    _number("vlm A", "two images' last logits, max abs difference", out["logit_diff"], "", card)

    greedy = generation.GenerateParameters(max_tokens=VLM_TOKENS, temperature=0.0)
    for fmt in ("bf16", "w8a8"):
        if fmt == "w8a8":
            quantize_encoder_params(decoder, "w8a8")
            per_pass = _w8a8_launches(Qwen3Decoder(cfg, device="meta").layers, 1)
            out["k5_prefill"] = _k5_prefill_against_plain(svc, images[0], per_pass, card)
        made = []
        real = generation.decode_loop

        def counting(*a, **k):
            res = real(*a, **k)
            made.append(len(res))
            return res
        generation.decode_loop = counting
        try:
            _zero_launches()
            t0 = time.perf_counter()
            reply = svc.analyze_image(images[0], VLM_PROMPT, gen_params=greedy)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            counts = _launch_counts()
        finally:
            generation.decode_loop = real
        n = made[0]
        if not 1 <= n <= VLM_TOKENS or not isinstance(reply, str):
            raise AssertionError(f"{fmt} analyze_image: {n} tokens")
        want = {} if fmt == "bf16" else {"w8a8": per_pass * (1 + n), "quantize_rows": per_pass * (1 + n)}
        _expect_counts(f"Mistral VLM {fmt} analyze_image", counts, want)
        if fmt == "w8a8" and per_pass != 280:
            raise AssertionError(f"{per_pass} K5 launches a Mistral pass, want 280")
        with torch.inference_mode():  # one decode step at the analysis' length, its slot rewritten each time
            _, cache, _ = svc.prefill(images[0], VLM_PROMPT, 1)
            length, tok1 = cache.length, torch.zeros(1, 1, dtype=torch.long, device="cuda")

            def one():
                cache.length = length
                decoder.decode_step(tok1, cache)
            step_ms = time_ms(one, reps=10, warmup=2)
        del cache
        out[fmt] = {"tokens": n, "s": secs, "tok_per_s": n / secs, "counts": counts, "reply_chars": len(reply),
                    "decode_step_ms": step_ms}
        log(f"[vlm A] {fmt} analyze_image, greedy: {n} tokens, launches {counts}"
            f"{f' (280 x (1 + {n}))' if fmt == 'w8a8' else ''}; reply {ascii(reply[:60])} [{card}]")
        _number("vlm A", f"{fmt} analyze_image of {n} tokens, tower and prefill included", secs, "s", card)
        _number("vlm A", f"{fmt} analyze_image", n / secs, "tok/s", card, "tower and prefill included")
        _number("vlm A", f"{fmt} decode_step after the {length}-token image prompt", step_ms, "ms", card)
    out["peak_gib"] = _number("vlm A", "peak device memory", torch.cuda.max_memory_allocated() / 2**30, "GiB", card)
    del svc, decoder, vision, feats, rows
    gc_cuda()
    return out


def phase_vlm_qwen35(card: str) -> dict:
    """B: the built-in Qwen35TextConfig (32 layers: 24 Gated DeltaNet + 8 full
    attention, hidden 2048, vocab 248320) with the built-in
    Qwen35VisionConfig at out_hidden_size 2048, random from a seed on the
    card: a 1024^2 image (1024 image tokens) -> prefill, a decode step and
    greedy chat tokens/s; prefill + 16 steps against forward_logits
    (VLM_TEACHER_FORCED_REL_TOL); the chunked DeltaNet against the sequential
    recurrence in f32 at S = 1024 (a layer's own q/k/v/g/beta, and with g
    drawn in DELTA_STRONG_G, where JAX's chunked form overflows);
    compare_images_for_flux and score_validation_image."""
    import copy
    import dataclasses

    import numpy as np

    from flux2_tpu_torch.models.text_encoders.facade import HFTokenizerAdapter
    from flux2_tpu_torch.models.text_encoders.qwen35 import (Qwen35LM, Qwen35TextConfig, gated_delta_update,
                                                             gated_delta_update_chunked, init_hybrid_cache)
    from flux2_tpu_torch.models.text_encoders.qwen35_vision import Qwen35Vision, Qwen35VisionConfig
    from flux2_tpu_torch.models.text_encoders.vlm_service import Qwen35VLMService
    from flux2_tpu_torch.ops import quant as tq
    from flux2_tpu_torch.pipeline.pipeline import _full_f32
    from flux2_tpu_torch.utils.synthetic import vocab_tokenizer

    lm_cfg = Qwen35TextConfig()
    v_cfg = dataclasses.replace(Qwen35VisionConfig(), out_hidden_size=lm_cfg.hidden_size)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 31)
    lm = Qwen35LM.from_random(lm_cfg, "cuda", gen)
    vision = Qwen35Vision.from_random(v_cfg, "cuda", gen)
    tok = HFTokenizerAdapter(vocab_tokenizer(lm_cfg.vocab_size))
    svc = Qwen35VLMService(lm, lm_cfg, vision, v_cfg, tok)
    torch.cuda.synchronize()
    log(f"[vlm B] random Qwen3.5 ({lm_cfg.num_hidden_layers} layers, hidden {lm_cfg.hidden_size}, vocab "
        f"{lm_cfg.vocab_size}) + vision tower ({v_cfg.depth} blocks, hidden {v_cfg.hidden_size}, out "
        f"{v_cfg.out_hidden_size}) drawn in {time.perf_counter() - t0:.2f} s: LM {tq.param_bytes(lm) / 2**30:.2f} "
        f"GiB, tower {tq.param_bytes(vision) / 2**30:.2f} GiB [{card}]")
    image = reference_image(VLM_QWEN35_SIDE).astype(np.float32) / 255.0
    other = np.ascontiguousarray(image[:, ::-1])
    from flux2_tpu_torch.models.text_encoders.extractor import chat_ids

    text_ids = chat_ids(tok, [{"role": "system", "content": "You are terse."},
                              {"role": "user", "content": VLM_PROMPT}], add_generation_prompt=True)
    ids, merged = svc._merged_inputs(text_ids, image)
    p = ids.shape[1]
    n_img = int((ids == v_cfg.image_token_id).sum())
    if n_img != 1024:
        raise AssertionError(f"{n_img} image tokens for a 1024^2 image, want 1024")
    out = {"image_tokens": n_img, "prompt_tokens": p}
    out["tower_ms"] = time_ms(lambda: svc._merged_inputs(text_ids, image), reps=3, warmup=1)
    out["prefill_ms"] = time_ms(lambda: svc.prefill(ids, merged, p + 1), reps=3, warmup=1)
    with torch.inference_mode():
        extra = torch.randint(0, lm_cfg.vocab_size, (1, VLM_TEACHER_STEPS), device="cuda",
                              generator=torch.Generator(device="cuda").manual_seed(SEED + 32))
        ids_all, emb_all = torch.cat([ids, extra], 1), torch.cat([merged, lm.embed_tokens[extra]], 1)
        lm32 = copy.deepcopy(lm).float()  # the same weights in f32

        def teacher(model, dtype, embeds):
            """The prefill and 16 steps of ``model`` over a hybrid cache of ``dtype``: logits rows p - 1 ... p + 15."""
            cache = init_hybrid_cache(lm_cfg, 1, p + VLM_TEACHER_STEPS, dtype=dtype, device="cuda")
            rows = [model.forward_cached(ids, cache, 0, inputs_embeds=embeds[:, :p])[0]]
            return rows + [model.forward_cached(extra[:, i:i + 1], cache, p + i)[0] for i in range(VLM_TEACHER_STEPS)]

        def rel(rows, ref):
            return max(float((r - ref[:, p - 1 + i]).norm() / ref[:, p - 1 + i].norm()) for i, r in enumerate(rows))
        with _full_f32():
            full32 = lm32.forward_logits(ids_all, inputs_embeds=emb_all.float())
            exact = rel(teacher(lm32, torch.float32, emb_all.float()), full32)
        del lm32
        full = lm.forward_logits(ids_all, inputs_embeds=emb_all)  # bf16 throughout
        rows32, rows16 = teacher(lm, torch.float32, emb_all), teacher(lm, torch.bfloat16, emb_all)
        teacher_forced = {"f32_model_vs_f32_forward": exact, "service_vs_f32_forward": rel(rows32, full32),
                          "forward_vs_f32_forward": rel([full[:, p - 1 + i] for i in range(len(rows16))], full32),
                          "bf16_cache_vs_forward": rel(rows16, full), "service_vs_forward": rel(rows32, full)}
        if not all(torch.isfinite(r).all() for r in rows32 + rows16):
            raise AssertionError("Qwen3.5 prefill + decode: non-finite logits")
        if not (exact <= VLM_TEACHER_FORCED_F32_TOL and teacher_forced["service_vs_f32_forward"]
                <= VLM_TEACHER_FORCED_REL_TOL):
            raise AssertionError(f"Qwen3.5 prefill + {VLM_TEACHER_STEPS} steps vs forward_logits: {teacher_forced} "
                                 f"(limits: f32 {VLM_TEACHER_FORCED_F32_TOL}, the bf16 service against the f32 "
                                 f"forward {VLM_TEACHER_FORCED_REL_TOL})")
        del full, full32, rows16
        cache = svc.prefill(ids, merged, p + 1)[1]
        tok1 = extra[:, :1]

        def one():
            for lc in cache:  # back to the prefill's length: the step rewrites the same slot
                if "len" in lc:
                    lc["len"] = p
            lm.forward_cached(tok1, cache, p)
        out["decode_step_ms"] = time_ms(one, reps=10, warmup=2)
    out["teacher_forced"] = teacher_forced
    t0 = time.perf_counter()
    reply = svc.chat("You are terse.", VLM_PROMPT, image=image, max_tokens=VLM_TOKENS)
    torch.cuda.synchronize()
    out["chat"] = {"s": time.perf_counter() - t0, "reply_chars": len(reply)}
    log(f"[vlm B] 1024^2 image -> {n_img} image tokens ({p} with the prompt) [{card}]")
    _number("vlm B", "tower + merge (preprocessing included), warm", out["tower_ms"], "ms", card)
    _number("vlm B", f"prefill of {p} tokens", out["prefill_ms"], "ms", card)
    _number("vlm B", "decode step", out["decode_step_ms"], "ms", card)
    _number("vlm B", "decode", 1000 / out["decode_step_ms"], "tok/s", card, "one step's time")
    _number("vlm B", f"greedy chat of at most {VLM_TOKENS} tokens, tower and prefill included", out["chat"]["s"], "s",
            card)
    for name, value in teacher_forced.items():
        _number("vlm B", f"prefill + {VLM_TEACHER_STEPS} steps, relative L2 (worst row), {name}", value, "", card,
                f"limits {VLM_TEACHER_FORCED_F32_TOL} for f32_model_vs_f32_forward, {VLM_TEACHER_FORCED_REL_TOL} "
                "for service_vs_f32_forward")

    # the chunked delta rule against the sequential recurrence, f32, on layer 0's own projections
    layer = copy.deepcopy(lm.layers[0].linear_attn).float()
    x = torch.randn(1, DELTA_S, lm_cfg.hidden_size, device="cuda", generator=gen)
    captured = {}

    def capture(q, k, v, g, beta, state):
        captured.update(q=q, k=k, v=v, g=g, beta=beta, state=state)
        return gated_delta_update_chunked(q, k, v, g, beta, state)
    from flux2_tpu_torch.models.text_encoders import qwen35 as q35

    f32_exp_max = math.log(torch.finfo(torch.float32).max)
    with torch.inference_mode(), _full_f32():
        real = q35.gated_delta_update_chunked
        q35.gated_delta_update_chunked = capture
        try:
            layer(x)
        finally:
            q35.gated_delta_update_chunked = real
        c = captured
        strong = torch.empty_like(c["g"]).uniform_(*DELTA_STRONG_G, generator=gen)
    deltas = {}
    for label, g in (("layer 0", c["g"]), ("layer 0, strong decay", strong)):
        with torch.inference_mode(), _full_f32():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            y_c, s_c = gated_delta_update_chunked(c["q"], c["k"], c["v"], g, c["beta"], c["state"])
            torch.cuda.synchronize()
            chunked_ms = (time.perf_counter() - t0) * 1e3
            t0 = time.perf_counter()
            y_s, s_s = gated_delta_update(c["q"], c["k"], c["v"], g, c["beta"], c["state"])
            torch.cuda.synchronize()
            seq_ms = (time.perf_counter() - t0) * 1e3
            y_max, s_max = float(y_s.abs().max()), float(s_s.abs().max())
            err = max(float((y_c - y_s).abs().max()) / y_max, float((s_c - s_s).abs().max()) / s_max)
            # the largest exponent lg_t - lg_i (i > t) of a chunk: minus the decay summed over its last 63 tokens
            logs = torch.log(g[:, :DELTA_S // 64 * 64]).reshape(g.shape[0], -1, 64, g.shape[-1])
            span = float(-logs[:, :, 1:].sum(2).max())
            g_min, g_max = float(g.min()), float(g.max())
            if not (torch.isfinite(y_c).all() and err <= DELTA_REL_TOL):
                raise AssertionError(f"chunked vs sequential DeltaNet ({label}): {err} of max |y| > {DELTA_REL_TOL}")
            if g is strong and not (g_max <= DELTA_STRONG_G[1] and span > f32_exp_max):
                raise AssertionError(f"the strong-decay case: g up to {g_max}, chunk exponents up to {span}; want "
                                     f"g <= {DELTA_STRONG_G[1]} and an exponent past {f32_exp_max:.2f}")
            deltas[label] = {"rel_err": err, "g_max": g_max, "g_min": g_min, "exponent_max": span,
                             "chunked_ms": chunked_ms, "sequential_ms": seq_ms, "y_max_abs": y_max}
            log(f"[vlm B] DeltaNet {label}, S = {DELTA_S}, f32: |y| up to {y_max:.3e}, g in [{g_min:.3e}, "
                f"{g_max:.3e}] [{card}]")
            _number("vlm B", f"DeltaNet {label}, largest in-chunk exponent JAX's chunked form takes", span, "", card,
                    f"exp overflows float32 past {f32_exp_max:.2f}")
            _number("vlm B", f"DeltaNet {label}, chunked vs sequential, max abs over max |y|", err, "", card,
                    f"tol {DELTA_REL_TOL}")
            _number("vlm B", f"DeltaNet {label}, chunked, one call", chunked_ms, "ms", card)
            _number("vlm B", f"DeltaNet {label}, sequential, one call", seq_ms, "ms", card)
    out["delta"] = deltas
    del layer, x, captured, c, strong

    t0 = time.perf_counter()
    result = svc.compare_images_for_flux(image, other)
    compare_s = time.perf_counter() - t0
    if set(result) != {"scene_score", "scene_reason", "style_score", "style_reason"}:
        raise AssertionError(f"compare_images_for_flux: {result}")
    t0 = time.perf_counter()
    scores = svc.score_validation_image(image, [other], "a red fox")
    score_s = time.perf_counter() - t0
    if len(scores) != 2 or not all(isinstance(s, float) for s in scores):
        raise AssertionError(f"score_validation_image: {scores}")
    out.update(compare={"s": compare_s, "result": result}, score={"s": score_s, "scores": list(scores)},
               peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    log(f"[vlm B] compare_images_for_flux -> {result}; score_validation_image -> {scores} [{card}]")
    _number("vlm B", "compare_images_for_flux, two 1024^2 images, max_tokens 300", compare_s, "s", card)
    _number("vlm B", "score_validation_image", score_s, "s", card)
    _number("vlm B", "peak device memory", out["peak_gib"], "GiB", card)
    del svc, lm, vision, rows32, cache, merged
    gc_cuda()
    return out


def _vlm_cli(argv: list, label: str, card: str, recorder: _ReplyRecorder, flash: int, encoders: bool = False):
    """One command in this process with its launch counts from 0: K1 ``flash``
    and nothing else; the VLM replies it used must be non-empty."""
    import contextlib
    import io

    from flux2_tpu_torch.cli import encoders as enc_cli

    before = len(recorder.replies)
    _zero_launches()
    t0 = time.perf_counter()
    if encoders:
        buf, err = io.StringIO(), io.StringIO()
        with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(err):
            if enc_cli.main(argv) != 0:
                raise AssertionError(f"{label} exited non-zero")
        lines, stderr = buf.getvalue().strip().splitlines(), err.getvalue()
        for line in lines + stderr.strip().splitlines():
            log(f"[vlm C {label}] {line[:300] if line.isprintable() else ascii(line)[:300]}")
    else:
        lines, stderr = _run_cli_logged(argv, label, card, tag="vlm C")
    secs = time.perf_counter() - t0
    counts = _launch_counts()
    _expect_counts(f"C: {label}", counts, {"flash": flash} if flash else {})
    replies = recorder.replies[before:]
    if not replies or not all(r.strip() for _, r in replies):
        raise AssertionError(f"C: {label}: VLM replies {replies}")
    if "falling back" in stderr:
        raise AssertionError(f"C: {label} fell back to the caller's prompt")
    log(f"[vlm C {label}] {len(replies)} VLM repl{'y' if len(replies) == 1 else 'ies'} "
        f"({', '.join(sorted({lbl for lbl, _ in replies}))}), launches {counts} [{card}]")
    _number(f"vlm C {label}", "command", secs, "s", card)
    return {"s": secs, "counts": counts, "replies": len(replies), "lines": lines, "stderr": stderr}


def phase_vlm_cli(card: str, workdir: str, dirs: dict) -> dict:
    """C: a random Qwen3.5-VL checkpoint at full width (depth cut to one period
    of the hybrid stack, 3 DeltaNet + 1 full-attention layer, and 2 vision
    blocks) written at the registry's qwen35-vlm path under a models dir, the
    dev tokenizer's chat template over a vocabulary-wide tokenizer; then, from
    the checkpoint phase's Klein-4B directories through cli.main at 512^2 and
    2 steps: ``t2i --interpret``, ``i2i --reference --upsample``, ``inpaint
    --enrich-prompt-with-vlm --intent remove`` and ``evaluate-lora`` (VLM
    scoring), and ``flux-encoders vision --image`` / ``--image2``: each with
    its VLM replies non-empty and in use (no fallback), K1 50 launches a
    generating command."""
    import dataclasses

    import numpy as np

    from flux2_tpu_torch.io import registry
    from flux2_tpu_torch.models.text_encoders import facade
    from flux2_tpu_torch.models.text_encoders.qwen35 import Qwen35TextConfig
    from flux2_tpu_torch.models.text_encoders.qwen35_vision import Qwen35VisionConfig
    from flux2_tpu_torch.models.text_encoders.vlm_service import Qwen35VLMService
    from flux2_tpu_torch.pipeline.pipeline import Flux2Pipeline
    from flux2_tpu_torch.utils.synthetic import vocab_tokenizer, write_dataset, write_qwen35_vl_checkpoint

    lm_cfg = dataclasses.replace(Qwen35TextConfig(), num_hidden_layers=VLM_CLI_LM_LAYERS)
    v_cfg = dataclasses.replace(Qwen35VisionConfig(), depth=VLM_CLI_VISION_DEPTH, out_hidden_size=lm_cfg.hidden_size)
    models = os.path.join(workdir, "vlm_models")
    saved_env = os.environ.get("FLUX2_MODELS_DIR")
    os.environ["FLUX2_MODELS_DIR"] = models
    vdir = registry.local_model_path(registry.TEXT_ENCODER_REPOS["qwen35-vlm"])
    t0 = time.perf_counter()
    nbytes = write_qwen35_vl_checkpoint(vdir, lm_cfg, v_cfg, torch.Generator(device="cuda").manual_seed(SEED + 33),
                                        vocab_tokenizer(lm_cfg.vocab_size))
    log(f"[vlm C] CUT: a Qwen3.5-VL checkpoint at full width with {VLM_CLI_LM_LAYERS} of 32 LM layers and "
        f"{VLM_CLI_VISION_DEPTH} of 24 vision blocks: {nbytes / 2**30:.2f} GiB written in "
        f"{time.perf_counter() - t0:.2f} s to {vdir} [{card}]")
    if registry.find_model_path(registry.TEXT_ENCODER_REPOS["qwen35-vlm"]) != vdir:
        raise AssertionError("the registry does not find the written Qwen3.5-VL checkpoint")
    ref = os.path.join(workdir, "vlm_ref.png")
    _write_file(ref, _png_of(reference_image(VLM_CLI_SIDE).astype(np.float32) / 255.0))
    other = os.path.join(workdir, "vlm_other.png")
    _write_file(other, _png_of(reference_image(VLM_CLI_SIDE)[:, ::-1].astype(np.float32) / 255.0))
    mask = np.zeros((VLM_CLI_SIDE, VLM_CLI_SIDE), np.uint8)
    mask[128:384, 128:384] = 255
    mask_path = _write_file(os.path.join(workdir, "vlm_mask.png"), _grey_png(mask))
    data = write_dataset(os.path.join(workdir, "vlm_data"), SEED + 34, [(VLM_CLI_SIDE, VLM_CLI_SIDE)])
    dir_flags = ["--transformer-dir", dirs["transformer"], "--vae-dir", dirs["vae"], "--encoder-dir",
                 dirs["text_encoder"]]
    size = ["--width", str(VLM_CLI_SIDE), "--height", str(VLM_CLI_SIDE), "--steps", "2"]
    prompts = []
    real_generate = Flux2Pipeline.generate

    def recording_generate(pipe, *a, **k):
        res = real_generate(pipe, *a, **k)
        prompts.append(res.final_prompt)
        return res
    out = {}
    Flux2Pipeline.generate = recording_generate
    try:
        with _ReplyRecorder(Qwen35VLMService) as rec:
            for label, argv, flash, encoders in (
                    ("t2i --interpret", ["t2i", *dir_flags, *size, "--interpret", ref, "--prompt", "a red fox",
                                         "-o", os.path.join(workdir, "vlm_t2i.png")], 50, False),
                    ("i2i --upsample", ["i2i", *dir_flags, *size, "--reference", ref, "--upsample", "--prompt",
                                        "the same scene at night", "-o", os.path.join(workdir, "vlm_i2i.png")], 50,
                     False),
                    ("vision --image", ["vision", "--encoder-dir", vdir, "--image", ref], 0, True),
                    ("vision --image2", ["vision", "--encoder-dir", vdir, "--image", ref, "--image2", other], 0, True),
                    ("inpaint --enrich-prompt-with-vlm", ["inpaint", *dir_flags, "--image", ref, "--mask", mask_path,
                                                          "--enrich-prompt-with-vlm", "--intent", "remove",
                                                          "--prompt", "an empty table", "--steps", "2", "-o",
                                                          os.path.join(workdir, "vlm_inpaint.png")], 50, False),
                    ("evaluate-lora", ["evaluate-lora", *dir_flags, *size, "--dataset", data["dataset"],
                                       "--max-samples", "1", "--output-dir", os.path.join(workdir, "vlm_eval")], 50,
                     False)):
                facade.shared.unload_vlm()  # each command loads the VLM itself
                n_prompts = len(prompts)
                res = _vlm_cli(argv, label, card, rec, flash, encoders)
                if label == "t2i --interpret":
                    reply = rec.replies[-1][1].strip()
                    if prompts[n_prompts:] != [f"Interpret image 1: {reply}\n\nUser request: a red fox"]:
                        raise AssertionError(f"t2i --interpret: final prompt {prompts[n_prompts:]}")
                if label.startswith("inpaint") and "VLM-enriched inpaint prompt: " not in res["stderr"]:
                    raise AssertionError("inpaint: no 'VLM-enriched inpaint prompt:' line")
                if label == "vision --image2" and set(json.loads("\n".join(res["lines"]))) != {
                        "scene_score", "scene_reason", "style_score", "style_reason"}:
                    raise AssertionError(f"vision --image2 printed {res['lines']}")
                if label == "evaluate-lora" and not any(re.match(r"\[1/1\] scene=", ln) for ln in res["lines"]):
                    raise AssertionError(f"evaluate-lora printed {res['lines']}")
                out[label] = {k: v for k, v in res.items() if k not in ("lines", "stderr")}
    finally:
        Flux2Pipeline.generate = real_generate
        facade.shared.unload_vlm()
        if saved_env is None:
            os.environ.pop("FLUX2_MODELS_DIR", None)
        else:
            os.environ["FLUX2_MODELS_DIR"] = saved_env
    return out


def phase_vlm(card: str, workdir: str, dirs: dict) -> dict:
    """The VLM slice: A the Mistral VLM, B the Qwen3.5 VLM, C the CLI end to
    end on the Klein-4B checkpoint directories; each part's seconds."""
    out, secs = {}, {}
    for name, fn in (("mistral", lambda: phase_vlm_mistral(card)), ("qwen35", lambda: phase_vlm_qwen35(card)),
                     ("cli", lambda: phase_vlm_cli(card, workdir, dirs))):
        t0 = time.perf_counter()
        out[name] = fn()
        secs[name] = time.perf_counter() - t0
        gc_cuda()
    out["seconds"] = secs
    for name, value in secs.items():
        _number("vlm", f"part {name}", value, "s", card)
    _number("vlm", "phase", sum(secs.values()), "s", card)
    return out


# -- the parallel slice: the mesh, sharding, partitioned K5/K6, ring attention on K2 -------------------------------

PARALLEL_PROMPT = "a lighthouse on a cliff at dusk, sharded"
PARALLEL_SEED = SEED + 16
# The pipeline's bf16 tolerance (tests/test_torch_i2i.py's BF16_LATENT_MAX): the latents of two
# runs that round their bf16 intermediates in other places, at |x| ~ 6, where bf16's step is 2^-5.
PARALLEL_LATENT_TOL = 0.06
# The flash ring (K2 on each step's block, the blocks merged in f32 by LSE) against the einsum
# ring (f32 logits and accumulators) on the same bf16 inputs, relative L2: K2's bf16 rounding of P
# and of its output, as KERNEL_REL_TOL.
RING_REL_TOL = KERNEL_REL_TOL
# The ring's gradient on bf16 inputs (K2 forward; the backward recomputes through the einsum ring, f32
# inside, bf16 out) against dense f32 autograd on the same values, relative L2 per input: the bf16
# rounding of the output and of each gradient, as KERNEL_REL_TOL.
RING_GRAD_REL_TOL = KERNEL_REL_TOL
RING_SHAPE = (1, 24, 4608, 128)


def _bits(t: torch.Tensor) -> tuple:
    """A fingerprint of a tensor's bits: (int64 sum of its 16- or 32-bit words, its shape)."""
    t = t.detach().contiguous()
    words = t.view(torch.int16) if t.element_size() == 2 else t.view(torch.int32)
    return int(words.to(torch.int64).sum()), tuple(t.shape)


class _KernelOutputs:
    """Wraps a kernel wrapper of ``module`` (by name) and keeps each call's output fingerprint."""

    def __init__(self, module, name: str, index=None):
        self.module, self.name, self.index = module, name, index
        self.outputs = []

    def __enter__(self):
        self.orig = getattr(self.module, self.name)
        self.own = self.name in vars(self.module)  # else inherited (an autograd Function's apply)

        def wrapped(*a, **k):
            out = self.orig(*a, **k)
            self.outputs.append(_bits(out if self.index is None else out[self.index]))
            return out

        setattr(self.module, self.name, wrapped)
        return self

    def __exit__(self, *exc):
        if self.own:
            setattr(self.module, self.name, self.orig)
        else:
            delattr(self.module, self.name)


def _parallel_quant(pipe, mesh, card: str) -> dict:
    """C: a w8a8 and a w4a8 copy of the DiT, one 1024^2 forward unsharded, then the same copy sharded on the
    one-rank mesh by ``shard_params`` (its products partitioned): every K5 / K6 call and the velocity equal
    to the bit. Both forwards run the block's glue on the torch chain (``transformer._fused`` forced false),
    the route the sharded DTensors take, so that both feed each product the same bits; G1 / G2 against the
    chain are ``phase_glue_check``'s."""
    import copy

    import numpy as np

    from flux2_tpu_torch.models.flux2 import transformer as tr
    from flux2_tpu_torch.ops import latents as lu
    from flux2_tpu_torch.ops import quant as tq
    from flux2_tpu_torch.ops import quant_kernels as qk
    from flux2_tpu_torch.ops.rope import rope_embeddings
    from flux2_tpu_torch.parallel import sharding as sh

    emb = pipe.text_encoder(PARALLEL_PROMPT)
    noise = lu.seeded_noise_seq(PARALLEL_SEED, 1024, 1024, 1, device="cuda").bfloat16()
    ids = np.concatenate([lu.text_position_ids(512), lu.image_position_ids(1024, 1024)])
    cos, sin = rope_embeddings(torch.from_numpy(ids).cuda())
    t = torch.full((1,), 0.7, device="cuda")
    out = {}
    for fmt, kernel in (("w8a8", "w8a8_matmul"), ("w4a8", "w4a8_matmul")):
        model = tq.quantize_params(copy.deepcopy(pipe.transformer), fmt)
        runs = []
        fused, tr._fused = tr._fused, (lambda *tensors: False)
        try:
            for sharded in (False, True):
                if sharded:
                    sh.shard_params(model, mesh, sh.DIT_RULES)
                _zero_launches()
                with _KernelOutputs(qk, kernel) as rec, torch.inference_mode():
                    t0 = time.perf_counter()
                    v = sh.gather(model(noise, emb, t, cos, sin))
                    torch.cuda.synchronize()
                    sec = time.perf_counter() - t0
                runs.append({"v": v, "calls": rec.outputs, "counts": _launch_counts(), "s": sec})
        finally:
            tr._fused = fused
        want = {name: 0 for name in runs[0]["counts"]}
        want.update(flash=25, quantize_rows=FORWARD_LAUNCHES[fmt])
        want[COUNTER[fmt]] = FORWARD_LAUNCHES[fmt]
        for label, run in zip(("unsharded", "sharded"), runs):
            if run["counts"] != want:
                raise AssertionError(f"[parallel C] {fmt} {label} forward launched {run['counts']}, want {want}")
            if len(run["calls"]) != FORWARD_LAUNCHES[fmt]:
                raise AssertionError(f"[parallel C] {fmt} {label} forward: {len(run['calls'])} {kernel} calls "
                                     f"recorded, want {FORWARD_LAUNCHES[fmt]}")
        if runs[0]["calls"] != runs[1]["calls"]:
            differ = [i for i, (a, b) in enumerate(zip(runs[0]["calls"], runs[1]["calls"])) if a != b]
            raise AssertionError(f"[parallel C] {fmt}: {len(differ)} of {len(runs[0]['calls'])} partitioned {kernel} "
                                 f"calls differ from the unsharded ones, the first call {differ[0]} (out shape "
                                 f"{runs[0]['calls'][differ[0]][1]})")
        if not torch.equal(runs[0]["v"], runs[1]["v"]):
            raise AssertionError(f"[parallel C] {fmt}: the sharded velocity differs, max abs "
                                 f"{(runs[0]['v'].float() - runs[1]['v'].float()).abs().max().item()}")
        log(f"[parallel C] {fmt} Klein-4B DiT forward at 1024^2 on the one-rank mesh, products partitioned: "
            f"{len(runs[1]['calls'])} {kernel} calls each equal to the unsharded call to the bit, the velocity "
            f"too; launches {runs[1]['counts']}; host+device s: unsharded {runs[0]['s']:.4f}, sharded "
            f"{runs[1]['s']:.4f} [{card}]")
        out[fmt] = {"launches": runs[1]["counts"][COUNTER[fmt]], "prologue": runs[1]["counts"]["quantize_rows"],
                    "k1": runs[1]["counts"]["flash"], "s": (runs[0]["s"], runs[1]["s"])}
        del model
        gc_cuda()
    return out


def _ring_kernel_checks(mesh, card: str) -> dict:
    """B's kernel checks: the flash ring at RING_SHAPE against the einsum ring (its plain version) and, on
    a ring of one, against K2 alone to the bit; the ring's backward at a small shape against dense
    autograd."""
    from flux2_tpu_torch.ops import flash_attention as fa
    from flux2_tpu_torch.parallel import ring_attention as ra
    from flux2_tpu_torch.parallel.sharding import gather

    g = torch.Generator(device="cuda").manual_seed(PARALLEL_SEED)
    q, k, v = (torch.randn(RING_SHAPE, generator=g, device="cuda", dtype=torch.bfloat16) for _ in range(3))
    scale = RING_SHAPE[-1] ** -0.5
    with torch.inference_mode():
        _zero_launches()
        flash = gather(ra.ring_attention(q, k, v, mesh, axis="tp"))
        launches = _launch_counts()["flash_lse"]
        plain = gather(ra.ring_attention(q, k, v, mesh, axis="tp", use_flash=False))
        alone, _ = fa.flash_attention_lse(q, k, v, scale)
        ms = time_ms(lambda: ra.ring_attention(q, k, v, mesh, axis="tp"))
        plain_ms = time_ms(lambda: ra.ring_attention(q, k, v, mesh, axis="tp", use_flash=False), reps=5)
        k2_ms = time_ms(lambda: fa.flash_attention_lse(q, k, v, scale))
    if launches != 1:
        raise AssertionError(f"[parallel B] the flash ring of one launched K2 {launches} times, want 1")
    rel = float((flash.float() - plain.float()).norm() / plain.float().norm())
    if not rel <= RING_REL_TOL:
        raise AssertionError(f"[parallel B] flash ring vs einsum ring: relative L2 {rel} > {RING_REL_TOL}")
    if not torch.equal(flash, alone):
        raise AssertionError("[parallel B] the flash ring of one differs from K2 alone")
    flop = 4 * RING_SHAPE[0] * RING_SHAPE[1] * RING_SHAPE[2] ** 2 * RING_SHAPE[3]
    bound = bound_ms(flop, attention_bytes(1, RING_SHAPE[1], RING_SHAPE[2], RING_SHAPE[2], 2, 2, 1), BF16_FLOPS)
    log(f"[parallel B] flash ring (K2) at {list(RING_SHAPE)} on a ring of one: relative L2 {rel:.4e} vs the "
        f"einsum ring (tol {RING_REL_TOL}), equal to K2 alone to the bit; {ms:.4f} ms (K2 alone {k2_ms:.4f} ms, "
        f"einsum ring {plain_ms:.4f} ms, bound {bound[0]:.4f} ms by {bound[1]}) [{card}]")

    small = (1, 2, 256, 128)
    leaves = [torch.randn(small, generator=g, device="cuda", dtype=torch.bfloat16).requires_grad_() for _ in range(3)]
    _zero_launches()
    o = gather(ra.ring_attention(*leaves, mesh, axis="tp", use_flash=True))
    (o.float() ** 2).sum().backward()
    if _launch_counts()["flash_lse"] != 1:
        raise AssertionError(f"[parallel B] the ring's backward pass launched {_launch_counts()}, want K2 once")
    dense_in = [t.detach().float().requires_grad_() for t in leaves]
    s = torch.einsum("bhqd,bhkd->bhqk", dense_in[0], dense_in[1]) * small[-1] ** -0.5
    dense = torch.einsum("bhqk,bhkd->bhqd", torch.softmax(s, -1), dense_in[2])
    (dense * dense).sum().backward()
    err = max(float((t.grad.float() - d.grad).norm() / d.grad.norm()) for t, d in zip(leaves, dense_in))
    if not err <= RING_GRAD_REL_TOL:
        raise AssertionError(f"[parallel B] ring gradient vs dense autograd: relative L2 {err} > {RING_GRAD_REL_TOL}")
    log(f"[parallel B] ring backward at {list(small)} bf16 (K2 forward, einsum recompute) vs dense f32 autograd: "
        f"relative L2 {err:.3e} (tol {RING_GRAD_REL_TOL}) [{card}]")
    return {"rel": rel, "ms": ms, "plain_ms": plain_ms, "k2_ms": k2_ms, "bound": bound, "grad_err": err}


def _parallel_cli(card: str, workdir: str) -> dict:
    """D: t2i --random-init at 512^2, 2 steps, under each --shard form, in this process (one rank)."""
    from flux2_tpu_torch.io.png import decode_png

    counts = {}
    for label, flags, want in (
        ("shard 1,1,1", ["--shard", "1,1,1"], {"flash": 50}),
        ("shard auto", ["--shard", "auto"], {"flash": 50}),
        ("shard 1,1,1,1 context-parallel", ["--shard", "1,1,1,1", "--context-parallel"], {"flash_lse": 50}),
        ("shard 1,1,1 dcn", ["--shard", "1,1,1", "--dcn"], {"flash": 50}),
    ):
        path = os.path.join(workdir, f"{label.replace(' ', '_').replace(',', '')}.png")
        _zero_launches()
        _run_cli(["t2i", "--random-init", "--width", "512", "--height", "512", "--steps", "2", "--seed",
                  str(PARALLEL_SEED), "--prompt", PARALLEL_PROMPT, "-o", path, *flags], label, card, tag="parallel D")
        got = _launch_counts()
        _expect_counts(f"[parallel D] {label}", got, want)
        with open(path, "rb") as f:
            img = decode_png(f.read())
        if img.shape != (512, 512, 3) or int(img.max()) == int(img.min()):
            raise AssertionError(f"[parallel D] {label}: PNG {img.shape}, constant {int(img.max()) == int(img.min())}")
        counts[label] = got
        drop_encoders()
    proc = subprocess.run([sys.executable, "-m", "flux2_tpu_torch.serve", "--tp", "2", "--random-init"],
                          capture_output=True, text=True, timeout=120)
    n = torch.cuda.device_count()
    if proc.returncode == 0 or f"--tp 2 needs 2 CUDA devices" not in proc.stderr or f"has {n}" not in proc.stderr:
        raise AssertionError(f"[parallel D] serve --tp 2 on {n} device(s): rc {proc.returncode}, {proc.stderr[-400:]}")
    log(f"[parallel D] serve --tp 2 exits {proc.returncode}: {proc.stderr.strip().splitlines()[-1]} [{card}]")
    return counts


def phase_parallel(pipe, card: str, workdir: str) -> dict:
    """The parallel slice on the full-width Klein-4B pipeline, on a one-rank NCCL mesh. C (first, on copies
    of the DiT): w8a8 and w4a8 sharded by ``shard_params``. Then a 1024^2 4-step image unsharded, and B:
    ``pipe.shard(context_parallel=True)``, which leaves the weights plain on a mesh of one rank: K2 25 a
    forward (100), K1 none, each ring output equal to its K2 output to the bit, the image within the bf16
    tolerance of the unsharded one. A: the DiT's weights made DTensors by ``shard_params`` (what a larger
    mesh runs; ``pipe.shard`` skips it here): the same latents, K1 100, the host s/step of both, then the
    ring on the DTensors (K2 100). The flash ring against the einsum ring and the ring's backward; Qwen3-4B
    sharded by ``shard_params`` (embeddings to the bit); D, the CLI. ``pipe`` is left sharded."""
    from torch.distributed.tensor import DTensor

    from flux2_tpu_torch.ops import flash_attention as fa
    from flux2_tpu_torch.parallel import ring_attention as ra
    from flux2_tpu_torch.parallel import sharding as sh
    from flux2_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(1, 1, 1, 1)
    out = {"quant": _parallel_quant(pipe, mesh, card)}
    emb = pipe.text_encoder(PARALLEL_PROMPT)

    def image(label: str, want: dict, record: bool = False):
        _zero_launches()
        if record:
            with _KernelOutputs(fa, "flash_attention_lse", index=0) as k2, \
                    _KernelOutputs(ra._RingFlash, "apply") as rings:
                res = pipe.generate(embeddings=emb, height=1024, width=1024, num_steps=4, seed=PARALLEL_SEED)
            if k2.outputs != rings.outputs or len(rings.outputs) != 100:
                raise AssertionError(f"[parallel B] {label}: {len(rings.outputs)} ring outputs, "
                                     f"{sum(a != b for a, b in zip(k2.outputs, rings.outputs))} unequal to K2's")
        else:
            res = pipe.generate(embeddings=emb, height=1024, width=1024, num_steps=4, seed=PARALLEL_SEED)
        counts = _launch_counts()
        _expect_counts(f"[parallel] {label}", counts, want)
        if not torch.isfinite(res.latents_device).all():
            raise AssertionError(f"[parallel] {label}: non-finite latents")
        return res, counts

    def dtensors(module) -> int:
        return sum(isinstance(t, DTensor) for t in list(module.parameters()) + list(module.buffers()))

    ref, _ = image("unsharded", {"flash": 100})
    pipe.shard(mesh, context_parallel=True)
    if dtensors(pipe.transformer):
        raise AssertionError("[parallel B] pipe.shard on a mesh of one rank made DTensors of the weights")
    b, b_counts = image("B context-parallel", {"flash_lse": 100}, record=True)
    bdiff = float((b.latents_device - ref.latents_device).abs().max())
    if bdiff > PARALLEL_LATENT_TOL:
        raise AssertionError(f"[parallel B] ring latents vs unsharded: max abs {bdiff} > {PARALLEL_LATENT_TOL}")
    host = {"unsharded": _s_per_step(ref), "ring": _s_per_step(b)}
    log(f"[parallel B] pipe.shard(mesh of one rank, context_parallel=True): weights left plain; K2 launches "
        f"{b_counts['flash_lse']}, K1 {b_counts['flash']}; 100 ring outputs equal to their K2 outputs to the bit; "
        f"latents vs unsharded max abs {bdiff:.3e} (tol {PARALLEL_LATENT_TOL}), image "
        f"{float(abs(b.image - ref.image).max()):.4f}; s/step unsharded {host['unsharded']:.4f}, ring "
        f"{host['ring']:.4f} [{card}]")

    pipe.shard(mesh)
    sh.shard_params(pipe.transformer, mesh, sh.DIT_RULES)
    a, a_counts = image("A sharded", {"flash": 100})
    diff = float((a.latents_device - ref.latents_device).abs().max())
    if diff:
        log(f"[parallel A] sharded latents differ from the unsharded ones: max abs {diff:.3e} (the DTensor "
            f"path's elementwise ops in another order) [{card}]")
        if diff > PARALLEL_LATENT_TOL:
            raise AssertionError(f"[parallel A] latents max abs {diff} > {PARALLEL_LATENT_TOL}")
    host["sharded"] = _s_per_step(a)
    log(f"[parallel A] Klein-4B 1024^2 4 steps, {dtensors(pipe.transformer)} weights made DTensors by "
        f"shard_params on the one-rank mesh: latents {'equal to the bit' if not diff else diff} vs unsharded; K1 "
        f"launches {a_counts['flash']}; s/step unsharded {host['unsharded']:.4f}, sharded {host['sharded']:.4f} "
        f"(DTensor dispatch {host['sharded'] - host['unsharded']:+.4f}) [{card}]")
    pipe.shard(mesh, context_parallel=True)
    a_ring, a_ring_counts = image("A sharded, context-parallel", {"flash_lse": 100}, record=True)
    rdiff = float((a_ring.latents_device - b.latents_device).abs().max())
    if rdiff > PARALLEL_LATENT_TOL:
        raise AssertionError(f"[parallel A] DTensor ring latents vs B's: max abs {rdiff} > {PARALLEL_LATENT_TOL}")
    host["sharded_ring"] = _s_per_step(a_ring)
    log(f"[parallel A] the ring on the DTensor weights: K2 launches {a_ring_counts['flash_lse']}, K1 "
        f"{a_ring_counts['flash']}; each ring output equal to its K2 output to the bit; latents vs B max abs "
        f"{rdiff:.3e}; s/step {host['sharded_ring']:.4f} [{card}]")
    out.update(host=host, k1=a_counts["flash"], k2=b_counts["flash_lse"], k2_sharded=a_ring_counts["flash_lse"],
               ring=_ring_kernel_checks(mesh, card))

    before = pipe.text_encoder(PARALLEL_PROMPT + " (encoder)")
    decoder = pipe.encoders.get(pipe.text_encoder_name).decoder
    pipe.encoders.shard(pipe.text_encoder_name, mesh)
    if dtensors(decoder):
        raise AssertionError("[parallel] TextEncoders.shard on a mesh of one rank made DTensors of the weights")
    sh.shard_params(decoder, mesh, sh.DECODER_RULES)
    after = pipe.text_encoder(PARALLEL_PROMPT + " (encoder)")
    if not torch.equal(before, after):
        raise AssertionError(f"[parallel] sharded Qwen3-4B embeddings differ: max abs "
                             f"{(before.float() - after.float()).abs().max().item()}")
    log(f"[parallel] Qwen3-4B: TextEncoders.shard on the mesh of one rank leaves its weights plain; "
        f"{dtensors(decoder)} weights made DTensors by shard_params give embeddings {list(after.shape)} equal "
        f"to the unsharded ones to the bit [{card}]")
    out["cli"] = _parallel_cli(card, workdir)
    return out


# -- pipeline-parallel training ----------------------------------------------------------------------

PP_MICROBATCHES = 2
PP_BATCH = 2
# A train step through make_pp_forward(pp = 1, M microbatches), remat: each microbatch runs the 25
# blocks' attention with grad (K2), again in the recompute (K2), and backward (K3, K4); the dense
# step at the same batch runs each once over both rows (STEP_LAUNCHES). A held-out pass: K1 25 x M.
PP_STEP_LAUNCHES = {"flash_lse": 2 * 25 * PP_MICROBATCHES, "flash_bwd_dq": 25 * PP_MICROBATCHES,
                    "flash_bwd_dkv": 25 * PP_MICROBATCHES}
PP_EVAL_LAUNCHES = {"flash": 25 * PP_MICROBATCHES}
# QLoRA on w8a8 through the pipeline: the prelude and head once (206 - 200), the 200 block
# projections forward and recomputed per microbatch; the prologue once before each K5 launch.
PP_QLORA_K5 = FORWARD_LAUNCHES["w8a8"] - QLORA_RECOMPUTED + 2 * PP_MICROBATCHES * QLORA_RECOMPUTED
PP_TIMED_STEPS = 3


def _pp_batch(gen, size: int = 512) -> dict:
    """A Klein-4B-base training batch of PP_BATCH rows at ``size`` on the card."""
    import numpy as np

    from flux2_tpu_torch.ops import latents as lu
    from flux2_tpu_torch.ops.rope import rope_embeddings

    ids = np.concatenate([lu.text_position_ids(32), lu.image_position_ids(size, size)])
    cos, sin = rope_embeddings(torch.from_numpy(ids).cuda())
    return {"latents": torch.randn(PP_BATCH, (size // 16) ** 2, 128, device="cuda", generator=gen),
            "embeddings": torch.randn(PP_BATCH, 32, 7680, device="cuda", generator=gen),
            "rope_cos": cos, "rope_sin": sin}


def _pp_step(model, tcfg, batch: dict, forward_fn, label: str, want: dict) -> dict:
    """One train step from the same LoRA and generator seeds: loss, the LoRA gradient and update, launches."""
    from flux2_tpu_torch.training import trainer

    state = trainer.init_train_state(model, tcfg, torch.Generator(device="cuda").manual_seed(SEED + 18))
    before = {n: p.detach().clone() for n, p in state.lora.named_parameters()}
    step = trainer.make_train_step(model, tcfg, forward_fn=forward_fn)
    _zero_launches()
    metrics = step(state.lora, state.optimizer, dict(batch), torch.Generator(device="cuda").manual_seed(SEED + 19))
    torch.cuda.synchronize()
    counts = _launch_counts()
    _expect_counts(f"[pp] {label}", counts, want)
    out = {"loss": float(metrics["loss"]), "counts": counts,
           "grads": {n: p.grad.detach().clone() for n, p in state.lora.named_parameters()},
           "update": {n: p.detach() - before[n] for n, p in state.lora.named_parameters()}}
    if not math.isfinite(out["loss"]) or not all(bool(torch.isfinite(g).all()) for g in out["grads"].values()):
        raise AssertionError(f"[pp] {label}: loss {out['loss']}, or a gradient is not finite")
    return out


def _rel_tree(a: dict, b: dict) -> float:
    """Relative L2 of ``a`` against ``b`` over every leaf."""
    diff = sum(float((a[n].float() - b[n].float()).square().sum()) for n in b)
    ref = sum(float(b[n].float().square().sum()) for n in b)
    return (diff / ref) ** 0.5


def _s_per_train_step(model, tcfg, batch: dict, forward_fn) -> float:
    """Warm s/step: one step, then the mean of PP_TIMED_STEPS, each synchronised."""
    from flux2_tpu_torch.training import trainer

    state = trainer.init_train_state(model, tcfg, torch.Generator(device="cuda").manual_seed(SEED + 18))
    step = trainer.make_train_step(model, tcfg, forward_fn=forward_fn)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 19)
    step(state.lora, state.optimizer, dict(batch), gen)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(PP_TIMED_STEPS):
        step(state.lora, state.optimizer, dict(batch), gen)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / PP_TIMED_STEPS


def phase_pp(card: str) -> dict:
    """Pipeline-parallel LoRA training on the one-rank NCCL mesh (the card's machine has one GPU, so a
    pipeline of more stages cannot run here): ``make_pp_mesh(1)``, ``place_stages`` (which keeps every
    block and makes no DTensor on one rank) and ``make_pp_forward(mesh, 2)``, on a full-width
    Klein-4B-base DiT (bf16, 512^2, batch 2, remat, rank 16). A: the pipelined step against the dense step
    from the same seeds (loss 1e-2, LoRA gradient 5e-2 relative L2), K2 / K3 / K4 counted, a held-out pass
    through the pipeline (K1), warm s/step of both. B: QLoRA on a w8a8 copy of the base through the
    pipeline against the dense QLoRA step, K5 launches equal to the prologue's."""
    from flux2_tpu_torch.models.flux2.transformer import Flux2Transformer
    from flux2_tpu_torch.ops import quant
    from flux2_tpu_torch.parallel import pipeline as pp_mod
    from flux2_tpu_torch.pipeline.pipeline import Flux2Model
    from flux2_tpu_torch.training import trainer

    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 17)
    model = Flux2Transformer(Flux2Model.KLEIN_4B_BASE.transformer_config, device="cuda", generator=gen)
    mesh = pp_mod.make_pp_mesh(1, 1, 1)
    pp_mod.place_stages(model, mesh)
    tensors = list(model.parameters()) + list(model.buffers())
    if any(t.is_meta or isinstance(t, pp_mod.sh.DTensor) for t in tensors):
        raise AssertionError("[pp] place_stages on the one-rank mesh freed a block or made a DTensor")
    fwd = pp_mod.make_pp_forward(mesh, PP_MICROBATCHES)
    tcfg = trainer.TrainConfig(rank=16, alpha=16.0, remat=True)
    batch = _pp_batch(gen)

    dense = _pp_step(model, tcfg, batch, None, "A dense step", STEP_LAUNCHES)
    piped = _pp_step(model, tcfg, batch, fwd, "A pipelined step", PP_STEP_LAUNCHES)
    rel_loss = abs(piped["loss"] - dense["loss"]) / abs(dense["loss"])
    rel_grad = _rel_tree(piped["grads"], dense["grads"])
    rel_update = _rel_tree(piped["update"], dense["update"])
    if rel_loss > TRAIN_LOSS_REL_TOL or rel_grad > TRAIN_GRAD_REL_TOL:
        raise AssertionError(f"[pp A] pipelined vs dense step: loss {piped['loss']} vs {dense['loss']} (relative "
                             f"{rel_loss}, tol {TRAIN_LOSS_REL_TOL}), gradient relative L2 {rel_grad} (tol "
                             f"{TRAIN_GRAD_REL_TOL})")
    eval_loss = trainer.make_eval_loss(model, tcfg, forward_fn=fwd)
    eval_dense = trainer.make_eval_loss(model, tcfg)
    state = trainer.init_train_state(model, tcfg, torch.Generator(device="cuda").manual_seed(SEED + 18))
    _zero_launches()
    held = float(eval_loss(state.lora, dict(batch), torch.Generator(device="cuda").manual_seed(SEED + 20)))
    eval_counts = _launch_counts()
    _expect_counts("[pp] A held-out pass through the pipeline", eval_counts, PP_EVAL_LAUNCHES)
    held_dense = float(eval_dense(state.lora, dict(batch), torch.Generator(device="cuda").manual_seed(SEED + 20)))
    rel_held = abs(held - held_dense) / abs(held_dense)
    if rel_held > TRAIN_LOSS_REL_TOL:
        raise AssertionError(f"[pp A] held-out loss {held} vs dense {held_dense} (relative {rel_held})")
    s_dense = _s_per_train_step(model, tcfg, batch, None)
    s_pp = _s_per_train_step(model, tcfg, batch, fwd)
    log(f"[pp A] Klein-4B-base at 512^2, batch {PP_BATCH}, remat, rank 16, on a one-rank (data 1, pp 1) mesh with "
        f"{PP_MICROBATCHES} microbatches: loss {piped['loss']:.6f} vs dense {dense['loss']:.6f} (relative "
        f"{rel_loss:.3e}, tol {TRAIN_LOSS_REL_TOL}); LoRA gradient relative L2 {rel_grad:.3e} (tol "
        f"{TRAIN_GRAD_REL_TOL}); the first AdamW update (lr x g / |g| elementwise) relative L2 {rel_update:.3e}; "
        f"launches pipelined {piped['counts']}, dense {dense['counts']}; held-out pass K1 {eval_counts['flash']}, "
        f"loss {held:.6f} vs dense {held_dense:.6f} ({rel_held:.3e}); warm s/step pipelined {s_pp:.4f} vs dense "
        f"{s_dense:.4f} (x{s_pp / s_dense:.3f}) [{card}]")

    quant.quantize_params(model, "w8a8")
    qdense = _pp_step(model, tcfg, batch, None, "B dense QLoRA step (w8a8)",
                      {**STEP_LAUNCHES, "w8a8": QLORA_STEP_LAUNCHES["w8a8"]["w8a8"],
                       "quantize_rows": QLORA_STEP_LAUNCHES["w8a8"]["w8a8"]})
    qpiped = _pp_step(model, tcfg, batch, fwd, "B pipelined QLoRA step (w8a8)",
                      {**PP_STEP_LAUNCHES, "w8a8": PP_QLORA_K5, "quantize_rows": PP_QLORA_K5})
    q_rel = abs(qpiped["loss"] - qdense["loss"]) / abs(qdense["loss"])
    q_grad = _rel_tree(qpiped["grads"], qdense["grads"])
    if q_rel > TRAIN_LOSS_REL_TOL or q_grad > TRAIN_GRAD_REL_TOL:
        raise AssertionError(f"[pp B] pipelined QLoRA step: loss {qpiped['loss']} vs dense {qdense['loss']} "
                             f"(relative {q_rel}), gradient relative L2 {q_grad}")
    q_s = _s_per_train_step(model, tcfg, batch, fwd)
    log(f"[pp B] QLoRA on the w8a8 base through the pipeline: loss {qpiped['loss']:.6f} vs dense QLoRA "
        f"{qdense['loss']:.6f} (relative {q_rel:.3e}, tol {TRAIN_LOSS_REL_TOL}); gradient relative L2 "
        f"{q_grad:.3e}; K5 {qpiped['counts']['w8a8']} = prologue {qpiped['counts']['quantize_rows']} (dense step "
        f"{qdense['counts']['w8a8']}); warm s/step pipelined {q_s:.4f} [{card}]")
    out = {"counts": piped["counts"], "qlora_counts": qpiped["counts"], "eval_counts": eval_counts,
           "s_dense": s_dense, "s_pp": s_pp, "qlora_s_pp": q_s}
    del model, dense, piped, qdense, qpiped, state
    gc_cuda()
    log(f"[pp] phase A-B: {time.perf_counter() - t0:.2f} s [{card}]")
    return out


PP_CLI_YAML = """model: {{name: klein-4b}}
lora: {{rank: 16, alpha: 16, target_layers: attention_ffn}}
dataset: {{path: {data}, image_size: 512, trigger_word: sks}}
training: {{optimizer: adamw, learning_rate: 1.0e-4, warmup_steps: 0, lr_scheduler: constant, batch_size: 1,
  max_steps: 2, log_every: 1{pp}}}
memory: {{gradient_checkpointing: true, cache_latents: true, cache_text_embeddings: true}}
checkpoints: {{output: {out}, save_every: 0}}
"""


def phase_pp_cli(card: str, workdir: str, dirs: dict, dataset: str) -> dict:
    """C: ``train-lora --shard 1,1,1,1`` from the checkpoint phase's directories on phase_train_real's dataset
    (2 steps at 512^2), its history equal to the bit to the same command without ``--shard`` (the second
    run reads the first's latent and caption caches, so both train on the same inputs); then ``pp: 2`` on
    this one GPU, which exits with JAX's text."""
    t0 = time.perf_counter()
    out_dir = os.path.join(workdir, "pp_cli")
    cfg = os.path.join(workdir, "pp_cli.yaml")
    with open(cfg, "w") as f:
        f.write(PP_CLI_YAML.format(data=dataset, out=out_dir, pp=""))
    dir_flags = ["--transformer-dir", dirs["transformer"], "--vae-dir", dirs["vae"], "--encoder-dir", dirs["text_encoder"]]
    plain, plain_counts, _, _, _ = _train(["--config", cfg, *dir_flags], "C without --shard", card)
    sharded, shard_counts, _, _, log_text = _train(["--config", cfg, *dir_flags, "--shard", "1,1,1,1"],
                                                   "C --shard 1,1,1,1", card)
    keys = ("step", "loss", "dop_loss", "grad_norm")
    if [[r[k] for k in keys] for r in sharded] != [[r[k] for k in keys] for r in plain]:
        raise AssertionError(f"[pp C] --shard 1,1,1,1 history {sharded} differs from {plain}")
    _expect_counts("[pp C] train-lora --shard 1,1,1,1", shard_counts, {n: 2 * c for n, c in STEP_LAUNCHES.items()})
    if plain_counts != shard_counts or "sharded over mesh {'data': 1, 'fsdp': 1, 'tp': 1, 'sp': 1}" not in log_text:
        raise AssertionError(f"[pp C] launches {shard_counts} vs {plain_counts}, or no 'sharded over mesh' line")
    from flux2_tpu_torch.cli.main import parse_args
    from flux2_tpu_torch.cli.train import run_training

    n = torch.cuda.device_count()
    exits = {  # JAX's texts (flux2_tpu/cli/train.py:697-709): Klein-4B's stacks (5, 20) take pp = 5 only
        2: "pp=2 must divide both block stacks of klein-4b (5 double, 20 single): klein-4b (5/20) supports pp=5; "
           "klein-9b (8/24) and dev (8/48) pp=2/4/8",
        5: f"pp*pp_tp=5*1 does not divide {n} devices"}
    for stages, want in exits.items():
        pp_cfg = os.path.join(workdir, f"pp{stages}.yaml")
        with open(pp_cfg, "w") as f:
            f.write(PP_CLI_YAML.format(data=dataset, out=os.path.join(workdir, f"pp{stages}"), pp=f", pp: {stages}"))
        try:
            run_training(parse_args(["train-lora", "--config", pp_cfg, *dir_flags, "--device", "cuda"]), "cuda")
        except SystemExit as e:
            if str(e) != want:
                raise AssertionError(f"[pp C] pp: {stages} on {n} GPU exited with {e!r}, want {want!r}")
        else:
            raise AssertionError(f"[pp C] pp: {stages} on {n} GPU trained")
        gc_cuda()
    log(f"[pp C] train-lora --shard 1,1,1,1 from the checkpoint directories: losses "
        f"{[round(r['loss'], 6) for r in sharded]} equal to the bit to the run without --shard, launches "
        f"{shard_counts}; on {n} GPU pp: 2 exits with '{exits[2]}', pp: 5 with '{exits[5]}' (JAX's texts); "
        f"{time.perf_counter() - t0:.2f} s [{card}]")
    gc_cuda()
    return {"counts": shard_counts}


# -- the last slice: generation on a sharded decoder, segmenter training, the fidelity gate --------------------

ENCODER_TP_PROMPT = 512
ENCODER_TP_TOKENS = 16
# K5 (each with its prologue) or K6 launches of one pass through Qwen3-4B at its published shape, derived
# before the run: 36 layers x 7 projections, every K (2560, 4096, 9728) and N (1024 to 9728) past both
# gates, at M = 512 (the prefill) as at M = 1 (a decode step). A greedy 16-token decode is 17 passes: the
# prefill, then every sampled token is stepped, the last too (the cache holds 512 + 16 slots).
ENCODER_TP_PASS_LAUNCHES = 36 * 7
ENCODER_TP_PASSES = 1 + ENCODER_TP_TOKENS
# The (M, K, N) of those projections: q (2560 -> 32 x 128), k and v (2560 -> 8 x 128), o (4096 -> 2560),
# gate and up (2560 -> 9728), down (9728 -> 2560), at the prefill's M = 512 and a decode step's M = 1;
# every K5 / K6 call of one prefill and one step is held against its plain version (_qwen3_qmm_against_plain).
QWEN3_4B_QMM_SHAPES = {(m, k, n): calls for m in (ENCODER_TP_PROMPT, 1)
                       for k, n, calls in ((2560, 4096, 36), (2560, 1024, 72), (4096, 2560, 36), (2560, 9728, 72),
                                           (9728, 2560, 36))}
ENCODER_TP_LOGITS_REL_TOL = 1e-3  # held only where a logits row is not equal to the bit
ENCODER_TP_UPSAMPLE = "a lighthouse on a cliff at dusk, rewritten on a sharded encoder"


class _RecordDecoder:
    """A decoder's ``prefill`` and ``decode_step`` wrapped on the instance: each call's logits (a float32
    copy) and its seconds (after a synchronise) are kept."""

    def __init__(self, decoder):
        self.decoder, self.logits, self.seconds = decoder, [], []

    def _wrap(self, fn):
        def call(*args, **kwargs):
            t0 = time.perf_counter()
            logits, cache = fn(*args, **kwargs)
            torch.cuda.synchronize()
            self.seconds.append(time.perf_counter() - t0)
            self.logits.append(logits.float().clone())
            return logits, cache
        return call

    def __enter__(self):
        d = self.decoder
        d.prefill, d.decode_step = self._wrap(d.prefill), self._wrap(d.decode_step)
        return self

    def __exit__(self, *exc):
        del self.decoder.prefill, self.decoder.decode_step


def _greedy_on_card(decoder, ids: list, label: str, want: dict) -> dict:
    """``generation.generate`` (greedy, ENCODER_TP_TOKENS) with the launch counts set to 0 just before."""
    from flux2_tpu_torch.models.text_encoders import generation

    params = generation.GenerateParameters(max_tokens=ENCODER_TP_TOKENS, temperature=0.0)
    with _RecordDecoder(decoder) as rec:
        _zero_launches()
        tokens = generation.generate(decoder, ids, params)
        counts = _launch_counts()
    _expect_counts(label, counts, want)
    if len(tokens) != ENCODER_TP_TOKENS or len(rec.logits) != ENCODER_TP_PASSES:
        raise AssertionError(f"{label}: {len(tokens)} tokens, {len(rec.logits)} passes")
    if not all(torch.isfinite(x).all() for x in rec.logits):
        raise AssertionError(f"{label}: non-finite logits")
    return {"tokens": tokens, "logits": rec.logits, "counts": counts, "passes": len(rec.logits),
            "prefill_s": rec.seconds[0], "s_per_token": statistics.mean(rec.seconds[1:])}


def _qwen3_qmm_against_plain(decoder, fmt: str, ids: list, card: str) -> dict:
    """Every K5 (with its prologue) or K6 call of one 512-token prefill and one decode step of the sharded
    decoder held against ``w8a8_matmul_reference`` / ``w4a8_matmul_reference`` on the same activations and
    local weights: equal to the bit, at exactly QWEN3_4B_QMM_SHAPES."""
    from flux2_tpu_torch.models.text_encoders import generation
    from flux2_tpu_torch.ops import quant_kernels as qk

    name = f"{fmt}_matmul"
    real, plain, shapes = getattr(qk, name), getattr(qk, f"{name}_reference"), {}

    def held(x, w):
        y = real(x, w)
        ref = plain(x, w)
        mkn = (x.numel() // x.shape[-1], x.shape[-1], y.shape[-1])
        if not torch.equal(y, ref):
            raise AssertionError(f"[encoder_tp] {fmt} (M,K,N)={mkn}: max abs "
                                 f"{float((y.float() - ref.float()).abs().max())} from its plain version, want equal")
        shapes[mkn] = shapes.get(mkn, 0) + 1
        return y
    setattr(qk, name, held)
    try:
        with torch.inference_mode():
            cache = decoder.new_cache(1, len(ids) + 1, generation._stream_dtype(decoder), "cuda")
            logits, cache = decoder.prefill(torch.tensor([ids], device="cuda"), cache)
            decoder.decode_step(logits.argmax(-1, keepdim=True), cache)
    finally:
        setattr(qk, name, real)
    if shapes != QWEN3_4B_QMM_SHAPES:
        raise AssertionError(f"[encoder_tp] {fmt}: (M,K,N) calls {shapes}, want {QWEN3_4B_QMM_SHAPES}")
    calls = sum(shapes.values())
    log(f"[encoder_tp] {fmt} sharded: all {calls} {name} calls of a {len(ids)}-token prefill and one decode step "
        f"equal to {name}_reference to the bit, (M,K,N) x calls "
        f"{ {'x'.join(map(str, k)): v for k, v in sorted(shapes.items())} } [{card}]")
    return {"calls": calls, "shapes": {"x".join(map(str, k)): v for k, v in shapes.items()}}


def _sampler_scan_repeats(card: str, repeats: int = 200) -> dict:
    """The sampler's prefix sums over Qwen3's 151936 probabilities on ``repeats`` runs: ``_prefix_sums`` held
    to the same bits every run; a one-dimensional ``torch.cumsum`` (which the sampler no longer uses) counted
    for the runs that differ from its first; both timed."""
    from flux2_tpu_torch.models.text_encoders import generation

    g = torch.Generator(device="cuda").manual_seed(SEED + 22)
    probs = torch.softmax(torch.randn(151936, device="cuda", generator=g) * 0.01, dim=0)
    out = {}
    for name, fn in (("prefix_sums", lambda: generation._prefix_sums(probs)),
                     ("torch_cumsum", lambda: torch.cumsum(probs, 0))):
        first = fn()
        out[name] = {"differ": sum(not torch.equal(fn(), first) for _ in range(repeats)), "ms": time_ms(fn)}
    if out["prefix_sums"]["differ"]:
        raise AssertionError(f"[encoder_tp] the sampler's prefix sums differ on {out['prefix_sums']['differ']} of "
                             f"{repeats} runs")
    log(f"[encoder_tp] sampler prefix sums over 151936 probabilities, {repeats} runs: _prefix_sums the same bits "
        f"every run, {out['prefix_sums']['ms']:.4f} ms; a 1-D torch.cumsum differs from its first on "
        f"{out['torch_cumsum']['differ']}, {out['torch_cumsum']['ms']:.4f} ms [{card}]")
    return out


def _kernel_projections(decoder, fmt: str) -> int:
    """The decoder's quantized projections that take K5 ("w8a8") or K6 ("w4a8"), the same at M = 512 and 1."""
    from flux2_tpu_torch.ops import quant as tq

    counts = []
    for m in (ENCODER_TP_PROMPT, 1):
        counts.append(sum(tq.kernel_route(torch.empty(m, w.orig_in, device="cuda", dtype=torch.bfloat16), w) == fmt
                          for w in (decoder.get_submodule(n) for n in tq.quantized_names(decoder))))
    if counts != [ENCODER_TP_PASS_LAUNCHES] * 2:
        raise AssertionError(f"[encoder_tp] {fmt}: {counts} projections take the kernel at M = 512 / 1, derived "
                             f"{ENCODER_TP_PASS_LAUNCHES}")
    return counts[0]


def phase_encoder_tp(card: str) -> dict:
    """Text generation on a sharded decoder, on the one-rank NCCL mesh (the card's machine has one GPU):
    Qwen3-4B at its published shape (QWEN3_4B_CONFIG_JSON), random from seed 0, in bf16, w8a8 and w4a8. Each
    prefills a 512-token prompt and greedily generates 16 tokens through ``generation.generate``, unsharded,
    then with its weights made DTensors by ``shard_params(DECODER_RULES)`` (``TextEncoders.shard`` leaves a
    one-rank mesh's weights plain): the same tokens, every pass's logits equal to the bit (else within
    ENCODER_TP_LOGITS_REL_TOL), K5 = prologue or K6 = 252 a pass, 17 passes, in both runs; s/token of both;
    before the sharded run, every K5 / K6 call of one prefill and step equal to its plain version to the bit
    (``_qwen3_qmm_against_plain``). First the sampler's prefix sums the same bits on 200 runs
    (``_sampler_scan_repeats``). Last, on bf16 weights, through the facade: ``chat`` (greedy) and
    ``upsample_prompt`` (sampled) after ``TextEncoders.shard`` give the unsharded text and ids, and ``chat``
    once more on DTensor weights."""
    from torch.distributed.tensor import DTensor

    from flux2_tpu_torch.models.text_encoders import generation
    from flux2_tpu_torch.models.text_encoders.config import DecoderConfig
    from flux2_tpu_torch.models.text_encoders.decoder import Qwen3Decoder
    from flux2_tpu_torch.models.text_encoders.extractor import quantize_encoder_params
    from flux2_tpu_torch.models.text_encoders.facade import TextEncoders
    from flux2_tpu_torch.parallel import sharding as sh
    from flux2_tpu_torch.parallel.mesh import make_mesh
    from flux2_tpu_torch.utils import inline_bpe_tokenizer

    t0 = time.perf_counter()
    cfg = DecoderConfig.from_json_dict(QWEN3_4B_CONFIG_JSON, qk_norm=True)
    mesh = make_mesh(1, 1, 1, 1)
    ids = torch.randint(0, cfg.vocab_size, (ENCODER_TP_PROMPT,), generator=torch.Generator().manual_seed(SEED + 21))
    ids = ids.tolist()

    def dtensors(module) -> int:
        return sum(isinstance(t, DTensor) for t in list(module.parameters()) + list(module.buffers()))

    out = {"scan": _sampler_scan_repeats(card)}
    for fmt in ("bf16", "w8a8", "w4a8"):
        dec = Qwen3Decoder(cfg, device="cuda", generator=torch.Generator(device="cuda").manual_seed(SEED))
        want = {}
        if fmt != "bf16":
            quantize_encoder_params(dec, fmt)
            n = _kernel_projections(dec, fmt) * ENCODER_TP_PASSES
            want = {fmt: n, "quantize_rows": n}
        plain = _greedy_on_card(dec, ids, f"[encoder_tp] {fmt} unsharded", want)
        sh.shard_params(dec, mesh, sh.DECODER_RULES)
        n_dt = dtensors(dec)
        held = _qwen3_qmm_against_plain(dec, fmt, ids, card) if fmt != "bf16" else None
        sharded = _greedy_on_card(dec, ids, f"[encoder_tp] {fmt} sharded", want)
        if sharded["tokens"] != plain["tokens"]:
            raise AssertionError(f"[encoder_tp] {fmt}: sharded tokens {sharded['tokens']} != {plain['tokens']}")
        unequal = [i for i, (a, b) in enumerate(zip(sharded["logits"], plain["logits"])) if not torch.equal(a, b)]
        rel = max(_rel_l2(a, b) for a, b in zip(sharded["logits"], plain["logits"]))
        if unequal:
            log(f"[encoder_tp] {fmt}: sharded logits differ from the unsharded ones at passes {unequal} (0 = the "
                f"prefill), max relative L2 {rel:.3e} [{card}]")
            if rel > ENCODER_TP_LOGITS_REL_TOL:
                raise AssertionError(f"[encoder_tp] {fmt}: logits relative L2 {rel} > {ENCODER_TP_LOGITS_REL_TOL}")
        log(f"[encoder_tp] Qwen3-4B (published shape) {fmt}, {n_dt} weights made DTensors by shard_params on the "
            f"one-rank mesh: {ENCODER_TP_PROMPT}-token prefill + {ENCODER_TP_TOKENS} greedy tokens equal to the "
            f"unsharded run's; logits of all {sharded['passes']} passes "
            f"{'equal to the bit' if not unequal else f'within {rel:.3e}'}; launches {sharded['counts']} (each run); "
            f"prefill {plain['prefill_s']:.4f} s unsharded, {sharded['prefill_s']:.4f} s sharded; s/token "
            f"unsharded {plain['s_per_token']:.4f}, sharded {sharded['s_per_token']:.4f} "
            f"(x{sharded['s_per_token'] / plain['s_per_token']:.2f}) [{card}]")
        out[fmt] = {"counts": sharded["counts"], "s_per_token": {"unsharded": plain["s_per_token"],
                                                                 "sharded": sharded["s_per_token"]},
                    "prefill_s": {"unsharded": plain["prefill_s"], "sharded": sharded["prefill_s"]},
                    "bit_equal": not unequal, "passes": sharded["passes"], "against_plain": held}
        del dec, plain, sharded
        gc_cuda()

    dec = Qwen3Decoder(cfg, device="cuda", generator=torch.Generator(device="cuda").manual_seed(SEED))
    enc = TextEncoders()
    enc.attach("qwen3-4b", dec, cfg, inline_bpe_tokenizer(), (9, 18, 27), recipe="klein")
    messages = [{"role": "user", "content": "a haiku about a lighthouse"}]
    chat_params = generation.GenerateParameters(max_tokens=ENCODER_TP_TOKENS, temperature=0.0)
    real_generate = generation.generate

    def replies(label: str) -> dict:
        seen = []

        def spy(*args, **kwargs):
            tokens = real_generate(*args, **kwargs)
            seen.append(tokens)
            return tokens
        generation.generate = spy
        try:
            t = time.perf_counter()
            chat = enc.chat(messages, "qwen3-4b", params=chat_params)
            t_chat = time.perf_counter() - t
            t = time.perf_counter()
            up = enc.upsample_prompt(ENCODER_TP_UPSAMPLE, "qwen3-4b", seed=SEED) if label != "dtensors" else None
            t_up = time.perf_counter() - t
        finally:
            generation.generate = real_generate
        return {"chat": chat, "upsample": up, "ids": seen, "chat_s": t_chat, "upsample_s": t_up}

    before = replies("unsharded")
    enc.shard("qwen3-4b", mesh)
    if dtensors(dec):
        raise AssertionError("[encoder_tp] TextEncoders.shard on a mesh of one rank made DTensors of the weights")
    after = replies("shard")
    if (after["chat"], after["upsample"], after["ids"]) != (before["chat"], before["upsample"], before["ids"]):
        raise AssertionError(f"[encoder_tp] chat / upsample_prompt after TextEncoders.shard differ: {after} vs {before}")
    sh.shard_params(dec, mesh, sh.DECODER_RULES)
    _zero_launches()
    on_dt = replies("dtensors")
    _expect_counts("[encoder_tp] chat on DTensor weights", _launch_counts(), {})
    if (on_dt["chat"], on_dt["ids"]) != (before["chat"], before["ids"][:1]):
        raise AssertionError(f"[encoder_tp] chat on DTensor weights: {on_dt} vs {before}")
    log(f"[encoder_tp] facade, Qwen3-4B bf16 with the dev tokenizer: chat ({ENCODER_TP_TOKENS} greedy ids "
        f"{before['ids'][0]}) and upsample_prompt ({len(before['ids'][1])} sampled ids, "
        f"{len(before['upsample'])} characters) after TextEncoders.shard (weights left plain on one rank) equal to "
        f"the unsharded replies; chat on DTensor weights equal too; chat {before['chat_s']:.2f} s unsharded, "
        f"{on_dt['chat_s']:.2f} s on DTensors; upsample_prompt {before['upsample_s']:.2f} s [{card}]")
    del dec, enc
    gc_cuda()
    log(f"[encoder_tp] phase: {time.perf_counter() - t0:.2f} s [{card}]")
    return out


SEG_TRAIN_STEPS = 100
SEG_TRAIN_BATCH = 16
SEG_FIRST_LOSS_REL_TOL = 1e-4  # step 1's loss on the card against the CPU, both float32 without TF32


def phase_segmenter_train(card: str, workdir: str) -> dict:
    """``tools.train_segmenter`` on the card: 100 steps at 256^2, batch 16, from seed 0 (``train``, what its
    ``main`` runs, its lines logged). Holds step 1's loss within SEG_FIRST_LOSS_REL_TOL of the same step on
    the CPU (the same network, drawn on the CPU's generator, and the same batch), the loss at step 100 below
    step 1's, and the file read back by ``load_params`` equal to the trained network to the bit; no kernel
    of the port runs. Prints ms a step and the held-out IoU (not held at 100 steps)."""
    import numpy as np

    from flux2_tpu_torch.chains import segmenter as seg
    from flux2_tpu_torch.io import safetensors_io
    from flux2_tpu_torch.tools import train_segmenter as ts

    path = os.path.join(workdir, "segmenter.safetensors")
    args = ts.build_parser().parse_args(["--steps", str(SEG_TRAIN_STEPS), "--batch", str(SEG_TRAIN_BATCH),
                                         "--seed", str(SEED), "--out", path])
    t0 = time.perf_counter()
    _zero_launches()
    hist = ts.train(args, log=lambda line: log(f"[segmenter] {line}"))
    _expect_counts("[segmenter] training", _launch_counts(), {})
    wall = time.perf_counter() - t0
    losses = hist["losses"]
    imgs, masks = ts.make_batch(np.random.RandomState(SEED), SEG_TRAIN_BATCH)
    with torch.no_grad():
        cpu_loss = float(ts.loss_fn(seg.init_params(torch.Generator().manual_seed(SEED)), imgs, masks))
    rel = abs(losses[0] - cpu_loss) / abs(cpu_loss)
    if rel > SEG_FIRST_LOSS_REL_TOL:
        raise AssertionError(f"[segmenter] step 1 loss {losses[0]} on the card vs {cpu_loss} on the CPU (relative "
                             f"{rel}, tol {SEG_FIRST_LOSS_REL_TOL})")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"[segmenter] loss at step {len(losses)} {losses[-1]} not below step 1's {losses[0]}")
    trained = {k: v.cpu() for k, v in hist["model"].state_dict().items()}
    back = seg.load_params(seg.SegmenterUNet(), safetensors_io.load_file(path)).state_dict()
    if set(back) != set(trained) or any(not torch.equal(back[k], v) for k, v in trained.items()):
        raise AssertionError(f"[segmenter] {path} read back by load_params differs from the trained network")
    log(f"[segmenter] tools.train_segmenter on the card, {SEG_TRAIN_STEPS} steps at 256^2, batch {SEG_TRAIN_BATCH}: "
        f"step 1 loss {losses[0]:.6f} vs {cpu_loss:.6f} on the CPU (relative {rel:.3e}, tol "
        f"{SEG_FIRST_LOSS_REL_TOL}); step {SEG_TRAIN_STEPS} {losses[-1]:.6f}; {hist['s_per_step'] * 1e3:.2f} ms a "
        f"step (steps 2-{SEG_TRAIN_STEPS}, the host's composites included); held-out IoU model "
        f"{hist['iou']['model']:.4f} vs heuristic {hist['iou']['heuristic']:.4f} (not held); the file read back "
        f"to the bit; {wall:.2f} s [{card}]")
    return {"losses": [losses[0], losses[-1]], "ms_per_step": hist["s_per_step"] * 1e3, "iou": hist["iou"]}


FIDELITY_QUANTS = ("bf16", "w8a8", "w4a8")
# A mire row's I2I: 4 steps at strength 0.35 keep the last of the 4 sigmas (set_timesteps' t_start 3):
# one forward, K1 25 and, on the quantized DiT, one forward's K5 = prologue (206) or K6 (205).
FIDELITY_STEPS = 1


def phase_fidelity(card: str, workdir: str) -> dict:
    """``tools.fidelity_gate --random-init --models klein-4b --quantizations bf16,w8a8,w4a8 --mire`` on the
    card against a reference tree this phase makes (empty: the fixture rows report the reference image
    missing, as JAX's gate does without the tree). Each mire row builds the full-width Klein-4B through
    ``cli.main.build_pipeline`` and runs the 512x768 chart's I2I (4 steps, strength 0.35), marked
    no_checkpoint, with its ΔE. Holds exit 0, the rows, and each mire row's launches."""
    import contextlib
    import io

    from flux2_tpu_torch.ops.scheduler import set_timesteps
    from flux2_tpu_torch.tools import fidelity_gate as fg

    steps = set_timesteps(4, image_seq_len=(512 // 16) * (768 // 16), strength=0.35).num_steps
    if steps != FIDELITY_STEPS:
        raise AssertionError(f"[fidelity] strength 0.35 of 4 steps leaves {steps}, derived {FIDELITY_STEPS}")
    tree = os.path.join(workdir, "reference_tree")
    os.makedirs(tree)
    report_path = os.path.join(workdir, "fidelity.json")
    rows = {}
    real_mire = fg.run_mire

    def counted(model, quantization, args):
        gc_cuda()
        _zero_launches()
        t = time.perf_counter()
        row = real_mire(model, quantization, args)
        torch.cuda.synchronize()
        rows[quantization] = {"counts": _launch_counts(), "s": time.perf_counter() - t}
        return row

    fg.run_mire = counted
    buf = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            rc = fg.main(["--random-init", "--models", "klein-4b", "--quantizations", ",".join(FIDELITY_QUANTS),
                          "--mire", "--reference-tree", tree, "--out", report_path])
    finally:
        fg.run_mire = real_mire
    for line in buf.getvalue().strip().splitlines():
        log(f"[fidelity] {line}")
    if rc != 0:
        raise AssertionError(f"[fidelity] the gate exited {rc}")
    with open(report_path) as f:
        report = json.load(f)
    fixtures = [r for r in report["rows"] if not r["fixture"].startswith("mire_")]
    mires = {r["quantization"]: r for r in report["rows"] if r["fixture"].startswith("mire_")}
    if sorted(r["quantization"] for r in fixtures) != sorted(FIDELITY_QUANTS) or \
            any(r.get("error") != "reference image missing" for r in fixtures):
        raise AssertionError(f"[fidelity] fixture rows: {fixtures}")
    forward = {"bf16": {}, "w8a8": {"w8a8": FORWARD_LAUNCHES["w8a8"], "quantize_rows": FORWARD_LAUNCHES["w8a8"]},
               "w4a8": {"w4a8": FORWARD_LAUNCHES["w4a8"], "quantize_rows": FORWARD_LAUNCHES["w4a8"]}}
    for q in FIDELITY_QUANTS:
        r = mires.get(q, {})
        if not r.get("no_checkpoint") or "error" in r or not all(math.isfinite(r.get(k, math.nan))
                                                                for k in ("delta_e_mean", "delta_e_max")):
            raise AssertionError(f"[fidelity] mire row {q}: {r}")
        want = {"flash": 25 * FIDELITY_STEPS, **{k: v * FIDELITY_STEPS for k, v in forward[q].items()}}
        _expect_counts(f"[fidelity] mire {q}", rows[q]["counts"], want)
    if report["gate"] != {"scored": 0, "passed": 0, "no_checkpoint": 3, "errors": 3} or report["ok"]:
        raise AssertionError(f"[fidelity] gate summary {report['gate']}, ok {report['ok']}")
    log(f"[fidelity] tools.fidelity_gate --random-init on klein-4b: the {len(fixtures)} fixture rows report the "
        f"reference image missing; mire rows (512x768 chart, 4 steps at strength 0.35: {FIDELITY_STEPS} forward), "
        f"no_checkpoint: " + "; ".join(f"{q} ΔE mean {mires[q]['delta_e_mean']} max {mires[q]['delta_e_max']}, "
                                      f"launches {rows[q]['counts']}, {rows[q]['s']:.2f} s (the pipeline built)"
                                      for q in FIDELITY_QUANTS) +
        f"; exit 0 in {time.perf_counter() - t0:.2f} s [{card}]")
    return {"rows": rows, "mire": {q: {k: mires[q][k] for k in ("delta_e_mean", "delta_e_max")}
                                   for q in FIDELITY_QUANTS}}


def drop_encoders() -> None:
    """After a phase whose pipelines are gone: the encoders that ``cli.main``
    registered in ``facade.shared`` (JAX's registry keeps them, as the
    port's does) go too, then gc_cuda."""
    from flux2_tpu_torch.models.text_encoders import facade

    facade.shared.unload_all()
    gc_cuda()


def gc_cuda() -> None:
    import gc

    gc.collect()
    torch.cuda.empty_cache()


class _RecordingPipeline:
    """Forwards to the pipeline and keeps every generate() call's arguments
    (``calls``) and result (``results``, final latents)."""

    def __init__(self, pipe):
        self._pipe = pipe
        self.results, self.calls = [], []

    def __getattr__(self, name):
        return getattr(self._pipe, name)

    def generate(self, **kwargs):
        self.calls.append(kwargs)
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
        counts = _launch_counts(glue=True)
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
        if not torch.isfinite(res.latents_device).all():
            raise AssertionError("non-finite final latents")
    if (server.batches_run, server.requests_served) != (3, 5):
        raise AssertionError(f"{server.requests_served} requests in {server.batches_run} batches, want 5 in 3")
    if [len(r.latents_device) for r in recorder.results] != [1, 1, 3]:
        raise AssertionError(f"batch sizes {[len(r.latents_device) for r in recorder.results]}, want [1, 1, 3]")
    want = {name: expected.get(name, 0) for name in counts}
    if counts != want:
        raise AssertionError(f"{label} serve launched {counts}, want {want}")
    for call, res in zip(recorder.calls, recorder.results):
        pt = res.phase_timings
        log(f"[serve {label}] {call['height']}x{call['width']} batch {len(res.latents_device)}: text encoding "
            f"{pt['text_encoding']:.4f} s, denoising {pt['denoising'] / res.num_steps:.4f} s/step ({res.num_steps} "
            f"steps, whole batch), VAE decoding {pt['vae_decoding']:.4f} s [{card}]")
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
    glue = phase_glue_check(card)
    phase_k1_clock(card)

    t0 = time.perf_counter()
    pipe, tok_name = build_pipeline()
    log(f"[model] random Klein-4B DiT + FLUX.2 VAE + Qwen3-4B encoder (tokenizer {tok_name}) drawn on the card "
        f"in {time.perf_counter() - t0:.2f} s; {torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated [{card}]")
    decode = phase_vae_decode(pipe, card)
    phase_model_check(pipe, card)
    model_launches = phase_quant_model_check(pipe, card)

    flash_launches = 25 * 4 * 3
    serve_glue = _forward_glue(*KLEIN_4B_BLOCKS, 4 * 3)
    counts, bf16_peak = phase_serve(pipe, card, "bf16", {"flash": flash_launches, **serve_glue})
    phase_cfg_serve(pipe, card)
    t0 = time.perf_counter()
    i2i = phase_i2i(pipe, card)
    log(f"[i2i] phase: {time.perf_counter() - t0:.2f} s [{card}]")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_edit_") as workdir:
        edit = phase_edit(pipe, card, workdir, i2i["t2i_s_per_step"], decode["warm_s"])
    log(f"[edit] phase: {time.perf_counter() - t0:.2f} s [{card}]")
    t0 = time.perf_counter()
    http = phase_http(pipe, card)
    log(f"[http] phase: {time.perf_counter() - t0:.2f} s [{card}]")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_mask_") as workdir:
        mask = phase_mask(pipe, card, workdir)
    log(f"[mask] phase: {time.perf_counter() - t0:.2f} s [{card}]")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_parallel_") as workdir:
        par = phase_parallel(pipe, card, workdir)  # leaves pipe sharded: it goes next
    log(f"[parallel] phase: {time.perf_counter() - t0:.2f} s [{card}]")
    del pipe
    drop_encoders()
    gc_cuda()
    pp = phase_pp(card)  # on phase_parallel's one-rank NCCL group
    enc_tp = phase_encoder_tp(card)  # on the same group
    import torch.distributed as dist

    dist.destroy_process_group()  # the one-rank NCCL group phase_parallel's make_mesh started
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_last_") as workdir:
        seg_train = phase_segmenter_train(card, workdir)
        fidelity = phase_fidelity(card, workdir)
    drop_encoders()
    log(f"[last] segmenter training and fidelity gate phases: {time.perf_counter() - t0:.2f} s [{card}]")

    from flux2_tpu_torch.cli.main import build_pipeline as cli_build_pipeline

    t0 = time.perf_counter()
    args = argparse.Namespace(model="klein-4b", quantization="w8a8", encoder_quantization="w8a8", random_init=True)
    qpipe = cli_build_pipeline(args, "cuda", torch.Generator(device="cuda").manual_seed(SEED))
    torch.cuda.synchronize()
    log(f"[model] w8a8 Klein-4B DiT + VAE + w8a8 Qwen3-4B encoder built by cli.main.build_pipeline in "
        f"{time.perf_counter() - t0:.2f} s; {torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated [{card}]")
    w8a8_launches = FORWARD_LAUNCHES["w8a8"] * 4 * 3 + ENCODE_LAUNCHES_W8A8 * 5
    qcounts, w8a8_peak = phase_serve(qpipe, card, "w8a8", {"flash": flash_launches, "w8a8": w8a8_launches,
                                                           "quantize_rows": w8a8_launches, **serve_glue})
    log(f"[serve] peak device memory: w8a8 {w8a8_peak:.2f} GiB vs bf16 {bf16_peak:.2f} GiB [{card}]")
    del qpipe
    drop_encoders()

    phase_train_grad_check(card)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as workdir:
        train = phase_train_cli(card, workdir, size=512, steps=5, save_every=5)
        train_1024 = phase_train_cli(card, workdir, size=1024, steps=2, save_every=0)
    log(f"[train] s/step warm: 512^2 {train['s_per_step']:.4f} s, 1024^2 {train_1024['s_per_step']:.4f} s; peak "
        f"device memory 512^2 {train['peak_gib']:.2f} GiB, 1024^2 {train_1024['peak_gib']:.2f} GiB [{card}]")
    gc_cuda()

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_kv_") as workdir:
        kv = phase_kv_cli(card, workdir)
    log(f"[kv] phase: {time.perf_counter() - t0:.2f} s [{card}]")
    drop_encoders()

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as workdir:
        ckpt = phase_checkpoint_round_trip(card, workdir)
        log(f"[ckpt] checkpoint round trip and profile phase: {time.perf_counter() - t0:.2f} s [{card}]")
        drop_encoders()
        real = phase_train_real(card, workdir, ckpt["dirs"])
        drop_encoders()
        pp_cli = phase_pp_cli(card, workdir, ckpt["dirs"], real["data"]["dataset"])
        drop_encoders()
        t0 = time.perf_counter()
        lora = phase_lora_prequant(card, workdir, ckpt["dirs"], train["s_per_step"])
        log(f"[lora] LoRA, prequantized checkpoints and QLoRA phase: {time.perf_counter() - t0:.2f} s [{card}]")
        drop_encoders()  # every Klein pipeline is gone: the Dev phase takes the card
        dev = phase_dev(card)
        drop_encoders()  # the Dev DiT and its Mistral are gone: the VLM phase takes the card
        vlm = phase_vlm(card, workdir, ckpt["dirs"])  # C reads the Klein-4B checkpoint directories
        drop_encoders()

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
        # the I2I slice's paths, as counted in this run: a Klein-4B 1024^2 I2I
        # image (S = 8704) and the klein-9b-kv CLI image (launches inside
        # forward_kv_extract and inside forward_kv_cached), with K1's time and
        # bound at their shapes
        "launches_per_unit_i2i": {"klein4b_i2i_1024px": i2i["i2i_launches"], "klein9b_kv_1024px": kv["split"]},
        "launches_kv_cli": kv["counts"]["flash"],
        # the editing slice's paths as counted in this run: inpaint, inpaint with the
        # image as reference at strength 0.5 (S = 8704), outpaint (S = 6912), a
        # cancel after step 2 of 4, and t2i at 2048^2 (S = 16896) with the tiled decode
        "launches_edit": edit["launches"],
        # this slice's paths: one 1024^2 POST /generate, and the inpaint on a subject mask
        "launches_http_generate_1024px": http["launches"]["POST /generate (PNG)"],
        "launches_mask_inpaint": mask["inpaint_launches"],
        # the LoRA / prequantized slice: each cli.main command of phase_lora_prequant
        "launches_lora_prequant": {label: c["flash"] for label, c in lora["launches"].items() if c["flash"]},
        # the real-data training slice: DOP's no-grad base forward, the previews and the held-out loss
        # (train-lora --random-init on the dataset, then its resume), and evaluate-lora's baselines
        "launches_train_real": {"random_init": real["random"]["counts"]["flash"],
                                "random_init_resume": real["random"]["counts_resume"]["flash"],
                                "evaluate_lora": real["evaluate"]["counts"]["flash"]},
        # the Dev / text-generation slice: a 4-step 1024^2 Dev image (56 a step) and t2i --model dev in its
        # own process (2 steps), with K1's time and bound at Dev's 48 heads
        "launches_dev": {"dev_1024px_4_steps": dev["dit"]["launches"],
                         "t2i_dev_cli_2_steps": dev["cli"]["counts"]["flash"]},
        # the VLM slice: each generating command of phase_vlm C (Klein-4B, 512^2, 2 steps; the VLM runs none)
        "launches_vlm_cli": {label: r["counts"]["flash"] for label, r in vlm["cli"].items() if r["counts"]["flash"]},
        # the parallel slice (phase_parallel, one-rank NCCL mesh): the sharded 1024^2 4-step image, the
        # sharded quantized forwards (25 each) and the CLI's --shard runs (512^2, 2 steps)
        # the pp slice (phase_pp): a held-out pass through the pipeline (M = 2) on the one-rank mesh
        "launches_pp": {"held_out_pass_pipelined_512px_batch2": pp["eval_counts"]["flash"]},
        # the last slice (phase_fidelity): each mire row's I2I (512x768, 4 steps at strength 0.35: one forward)
        "launches_fidelity_mire": {q: r["counts"]["flash"] for q, r in fidelity["rows"].items()},
        "launches_parallel": {"sharded_1024px_4_steps": par["k1"],
                              **{f"{fmt}_sharded_forward": q["k1"] for fmt, q in par["quant"].items()},
                              **{f"t2i_{label}": c["flash"] for label, c in par["cli"].items() if c["flash"]}},
        "dev_shape": {"q": list(DEV_K1_SHAPE[:3]) + [128], "s_k": DEV_K1_SHAPE[3], "ms": dev["kernels"]["k1"]["alone"],
                      "wrapper_ms": dev["kernels"]["k1"]["ms"], "plain_ms": dev["kernels"]["k1"]["plain_ms"],
                      "bound_ms": dev["kernels"]["k1"]["bound"], "bound_by": dev["kernels"]["k1"]["bound_by"],
                      "library": dev["kernels"]["k1"]["library"], "library_ms": dev["kernels"]["k1"]["library_ms"],
                      "max_abs_err": dev["kernels"]["k1"]["err"]},
        "slice_shapes": {name: {"q": list(shape[:3]) + [128], "s_k": shape[3], "span": span,
                                "ms": checks[name]["alone"], "wrapper_ms": checks[name]["ms"],
                                "plain_ms": checks[name]["plain_ms"], "bound_ms": checks[name]["bound"],
                                "bound_by": checks[name]["bound_by"], "library": checks[name]["library"],
                                "library_ms": checks[name]["library_ms"], "max_abs_err": checks[name]["err"]}
                         for name, shape, span in K1_SLICE_CASES},
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
        # the LoRA / prequantized slice: t2i from the prequantized files, the QTensor merge on K7, QLoRA steps
        counter = COUNTER[fmt]
        entry["launches_lora_prequant"] = {label: c[counter] for label, c in lora["launches"].items() if c[counter]}
        qlora = {base: r["counts"][counter] for base, r in lora["qlora"].items() if r["counts"][counter]}
        # the real-data training slice: QLoRA from the CLI, and the random w8a8 caption encoder (K5)
        real_launches = {f"train_lora_{base}": r["counts"][counter] for base, r in real["qlora"].items()
                         if r["counts"][counter]}
        if fmt == "w8a8":
            real_launches.update(random_init_captions=real["random"]["counts"]["w8a8"],
                                 random_init_resume=real["random"]["counts_resume"]["w8a8"])
        if real_launches:
            entry["launches_train_real"] = real_launches
        if qlora:
            entry["launches_qlora"] = qlora
            entry["launches_per_qlora_step"] = FORWARD_LAUNCHES[fmt] + QLORA_RECOMPUTED
        if fmt in ("w8a8", "w4a8"):  # the Dev / text-generation slice: Mistral's shapes, M = 1 decode rows
            entry["dev_shapes"] = {name: {"m_k_n": [m, k, n], "ms": dev["kernels"]["qmm"][name][fmt]["alone"],
                                          "wrapper_ms": dev["kernels"]["qmm"][name][fmt]["ms"],
                                          "plain_ms": dev["kernels"]["qmm"][name][fmt]["plain_ms"],
                                          "bound_ms": dev["kernels"]["qmm"][name][fmt]["bound"][0],
                                          "bound_by": dev["kernels"]["qmm"][name][fmt]["bound"][1],
                                          "dense_bf16_linear_ms": dev["kernels"]["qmm"][name]["dense_ms"],
                                          "max_abs_err": 0.0}
                                   for name, m, k, n in MISTRAL_QMM_SHAPES}
        if fmt == "w8a8":  # the pp slice: one pipelined QLoRA step (M = 2) on the one-rank mesh
            entry["launches_pp"] = {"pipelined_qlora_step_512px_batch2": pp["qlora_counts"]["w8a8"]}
        if fmt in par["quant"]:  # the parallel slice: one partitioned forward on the one-rank mesh
            entry["launches_parallel"] = {"sharded_partitioned_forward": par["quant"][fmt]["launches"]}
        if fmt in enc_tp:  # the last slice: Qwen3-4B's 512-token prefill + 16 greedy tokens on DTensor weights,
            # and the fidelity gate's mire row (one forward)
            entry["launches_encoder_tp"] = {"qwen3_4b_sharded_greedy_16_tokens": enc_tp[fmt]["counts"][counter],
                                            "per_pass": enc_tp[fmt]["counts"][counter] // enc_tp[fmt]["passes"],
                                            "passes": enc_tp[fmt]["passes"]}
            entry["qwen3_4b_shapes_against_plain"] = {"calls": enc_tp[fmt]["against_plain"]["calls"],
                                                      "m_k_n_calls": enc_tp[fmt]["against_plain"]["shapes"],
                                                      "max_abs_err": 0.0}
            entry["launches_fidelity_mire"] = fidelity["rows"][fmt]["counts"][counter]
        if fmt == "w8a8":
            entry["launches_dev"] = {"mistral_w8a8_greedy_16_tokens": dev["encoder"]["greedy"]["counts"]["w8a8"],
                                     "t2i_dev_cli": dev["cli"]["counts"]["w8a8"]}
            entry["launches_per_decode_token"] = dev["encoder"]["greedy"]["k5_per_token"]
            # the VLM slice: the w8a8 Mistral VLM's greedy analyze_image (280 a pass: the prefill and each token)
            entry["launches_vlm"] = {"mistral_vlm_w8a8_analyze_image": vlm["mistral"]["w8a8"]["counts"]["w8a8"],
                                     "tokens_stepped": vlm["mistral"]["w8a8"]["tokens"]}
            entry["launches_per_dev_forward"] = dev["cli"]["dit_pass"]
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
                    "bound_by": pro["bound"][1], "library": None, "library_ms": None,
                    "launches_lora_prequant": {label: c["quantize_rows"] for label, c in lora["launches"].items()
                                               if c["quantize_rows"]},
                    "launches_qlora": lora["qlora"]["w8a8"]["counts"]["quantize_rows"],
                    "launches_train_real": {"train_lora_w8a8": real["qlora"]["w8a8"]["counts"]["quantize_rows"],
                                            "random_init_captions": real["random"]["counts"]["quantize_rows"],
                                            "random_init_resume": real["random"]["counts_resume"]["quantize_rows"]},
                    "launches_dev": {"mistral_w8a8_greedy_16_tokens":
                                     dev["encoder"]["greedy"]["counts"]["quantize_rows"],
                                     "t2i_dev_cli": dev["cli"]["counts"]["quantize_rows"]},
                    "launches_vlm": {"mistral_vlm_w8a8_analyze_image":
                                     vlm["mistral"]["w8a8"]["counts"]["quantize_rows"]},
                    "launches_parallel": {f"{fmt}_sharded_partitioned_forward": q["prologue"]
                                          for fmt, q in par["quant"].items()},
                    "launches_pp": {"pipelined_qlora_step_512px_batch2": pp["qlora_counts"]["quantize_rows"]},
                    "launches_encoder_tp": {f"qwen3_4b_{fmt}_sharded_greedy_16_tokens": enc_tp[fmt]["counts"][
                        "quantize_rows"] for fmt in ("w8a8", "w4a8")},
                    "launches_fidelity_mire": {q: fidelity["rows"][q]["counts"]["quantize_rows"]
                                               for q in ("w8a8", "w4a8")},
                    "dev_shapes": {f"{name}_block_{block}": {"m_k": [m, k], "ms": dev["kernels"]["qmm"][name][
                                       f"prologue_{block}"]["alone"],
                                   "bound_ms": dev["kernels"]["qmm"][name][f"prologue_{block}"]["bound"][0]}
                                   for name, m, k, _ in MISTRAL_QMM_SHAPES for block in (k, 512)}})
    # K2 vs the plain f32 forward with LSE; K3 and K4 vs the plain f32 backward,
    # which computes dq, dk and dv at once, as does their library call. Launches
    # from the 512^2 training run.
    big = grad_checks["klein4b_1024px"]
    ring = par["ring"]
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
                        "library": big["library"][lib][0], "library_ms": big["library"][lib][1],
                        "launches_qlora": {base: r["counts"][counter] for base, r in lora["qlora"].items()},
                        "launches_train_real": {
                            "random_init": real["random"]["counts"][counter],
                            "random_init_resume": real["random"]["counts_resume"][counter],
                            **{f"train_lora_{base}": r["counts"][counter] for base, r in real["qlora"].items()},
                            "remat_dots_1024px_step": real["dots"]["counts"][counter]}})
        # the pp slice (phase_pp, one-rank mesh, M = 2): the pipelined step, the pipelined QLoRA step, and
        # train-lora --shard 1,1,1,1 (2 steps)
        kernels[-1]["launches_pp"] = {"pipelined_step_512px_batch2": pp["counts"][counter],
                                      "pipelined_qlora_w8a8_step": pp["qlora_counts"][counter],
                                      "train_lora_shard_1111_2_steps": pp_cli["counts"][counter]}
        if key == "k2":  # the parallel slice: K2 on every ring step's block (a ring of one here)
            kernels[-1]["launches_parallel"] = {
                "ring_1024px_4_steps": par["k2"], "ring_on_dtensors_1024px_4_steps": par["k2_sharded"],
                **{f"t2i_{label}": c["flash_lse"] for label, c in par["cli"].items() if c["flash_lse"]}}
            kernels[-1]["ring_shape"] = {"q": list(RING_SHAPE), "ms": ring["ms"], "k2_alone_ms": ring["k2_ms"],
                                         "plain_ms": ring["plain_ms"], "plain": "the einsum ring",
                                         "bound_ms": ring["bound"][0], "bound_by": ring["bound"][1],
                                         "rel_l2_vs_plain": ring["rel"], "grad_rel_l2": ring["grad_err"]}
    log(f"[vae] 1024^2 decode: first {decode['cold_s']:.4f} s, warm {decode['warm_s']:.4f} s [{card}]")
    log(f"[i2i] 1024^2 encode: first {i2i['encode_cold_s']:.4f} s, warm {i2i['encode_warm_s']:.4f} s, TF32 on vs off "
        f"{i2i['tf32_rel']:.4e}; Klein-4B s/step I2I {i2i['i2i_s_per_step']:.4f} vs T2I {i2i['t2i_s_per_step']:.4f}; "
        f"klein-9b-kv s/step {kv['kv_s_per_step']:.4f} vs uncached {kv['uncached_s_per_step']:.4f}; 1024^2 reference "
        f"PNG decode {i2i['decode_s']['decode_image']:.4f} s (decode_png {i2i['decode_s']['decode_png']:.4f} s) "
        f"[{card}]")
    log(f"[edit] s/step at 1024^2: T2I {edit['t2i_s_per_step']:.4f} (with on_latents "
        f"{edit['on_latents_s_per_step']:.4f}), inpaint {edit['inpaint_s_per_step']:.4f}, inpaint with the image as "
        f"reference {edit['inpaint_reference_s_per_step']:.4f}, outpaint (S = 6912) {edit['outpaint_s_per_step']:.4f}; "
        f"2048^2: t2i {edit['t2i_2048']['s_per_step']:.4f} s/step; decode dense "
        f"{edit['decode_2048']['dense']['warm_s']:.4f} s / {edit['decode_2048']['dense']['peak_gib']:.2f} GiB, tiled "
        f"{edit['decode_2048']['tiled']['warm_s']:.4f} s / {edit['decode_2048']['tiled']['peak_gib']:.2f} GiB; small "
        f"decoder 1024^2 {edit['small_decode']['warm_s']:.4f} s against {decode['warm_s']:.4f} s; auto_profile "
        f"klein-4b {edit['auto_profile_klein-4b']}, klein-9b {edit['auto_profile_klein-9b']} [{card}]")
    # G1 and G2 at the Klein-4B single block's shape (GLUE_SHAPE), timed by CUDA events; launches as counted
    # in the bf16 serving run (3 batches of 4 steps) and the klein-9b-kv CLI image
    for name in ("adaln_modulate", "qkv_heads"):
        row = glue[name]
        kernels.append({"name": name, "route": "cuda", "source": "flux2_tpu_torch/csrc/dit_glue.cu",
                        "replaces": "no TPU kernel: XLA fused this glue on the TPU", "launches": counts[name],
                        "launches_per_unit": _forward_glue(*KLEIN_4B_BLOCKS, 4)[name],
                        "unit": "1024^2 image (4 Klein-4B forwards)", "launches_kv_cli": kv["counts"][name],
                        "equal_to_chain": row["equal"], "max_abs_err": row["err"], "events_ms": row["launch_ms"],
                        "wrapper_ms": row["ms"], "wrapper_host_us": row["wrapper_host_us"],
                        "entry_host_us": row["entry_host_us"],
                        "plain_ms": row["plain_ms"], "bound_ms": row["bound"][0], "bound_by": row["bound"][1]})
    log(json.dumps({"kernels": kernels}))
    log(card)
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
