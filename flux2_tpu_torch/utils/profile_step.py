"""Where the device time of the port's served and training paths goes, on one CUDA card.

    python3 -m flux2_tpu_torch.utils.profile_step [--quantization w8a8|w4a8|qint8|int4]
    python3 -m flux2_tpu_torch.utils.profile_step --train [--quantization w8a8|...]

Draws a random full-width Klein-4B DiT and FLUX.2 VAE decoder (bf16, on the
card, from seed 0; the DiT quantized with ``quantize_params`` under
``--quantization``, with ``FLUX2_PALLAS_DEQUANT=1`` for qint8 and int4 so
their kernel runs) and random text embeddings [B, 512, 7680] in place of
the encoder. For one denoising step (``Flux2Pipeline._denoise`` over one
sigma pair: DiT forward + Euler update) at 1024^2 batch 1 and at 256^2
batch 3, and for a warm VAE decode at 1024^2, it prints:

- the host-clock time (mean of 3 after a warm-up, synchronised);
- the device time of one profiled run (``torch.profiler``), summed over its
  kernels and split into classes by kernel name: K1 (``flash_fwd_kernel``),
  the quantized matmuls K5 / K6 / K7, their activation prologue
  (``quantize_rows_kernel``, before each K5 and K6), convolutions, GEMMs, and
  the rest (elementwise, reductions, copies);
- the device's idle share, 1 - device time / host-clock time;
- the GEMM FLOP that ``torch.profiler`` counts for ``aten::mm``-family ops.

With ``--train`` it profiles instead one LoRA train step of the full-width
Klein-4B base (rank 16 on every attention and FFN target, AdamW:
``trainer.make_train_step``) on synthetic data with 32 text tokens, at
512^2 and at 1024^2 (batch 1), under each remat policy (``True``: each
block recomputed whole; ``"dots"``: recomputed but its 2-D products), with
the peak device memory of the measured steps, and splits the device time
into K2 (``flash_fwd_lse_kernel``), K3 + K4 (``flash_bwd_*``), GEMMs and the
rest; with ``--quantization`` the base is quantized (QLoRA: K5 / K6 / K7
forward, ``dy @ dequantize(w)`` backward).

Each line carries the card's name and power limit; the last line is one JSON
object with every number.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import time

import numpy as np
import torch

SEED = 0
K1_KERNEL = "flash_fwd_kernel"
K2_KERNEL = "flash_fwd_lse_kernel"
K34_MARK = "flash_bwd_"  # flash_bwd_dq_kernel (K3), flash_bwd_dkv_kernel (K4)
_QUANT_MARKS = ("w8a8_kernel", "w4a8_kernel", "dequant_kernel")  # csrc/quant_matmul.cu
PROLOGUE_KERNEL = "quantize_rows_kernel"  # csrc/quant_prologue.cu: K5's and K6's activation prologue
_CONV_MARKS = ("conv", "fprop", "dgrad", "wgrad", "winograd", "implicit_gemm", "cudnn")
_GEMM_MARKS = ("gemm", "nvjet", "cutlass", "xmma", "cublas")
_GEMM_OPS = ("aten::mm", "aten::addmm", "aten::bmm", "aten::baddbmm")


def kernel_class(name: str) -> str:
    low = name.lower()
    if K1_KERNEL in low:
        return "k1"
    if K2_KERNEL in low:
        return "k2"
    if K34_MARK in low:
        return "k34"
    if any(m in low for m in _QUANT_MARKS):
        return "quant"
    if PROLOGUE_KERNEL in low:
        return "prologue"
    if any(m in low for m in _CONV_MARKS):
        return "conv"
    if any(m in low for m in _GEMM_MARKS):
        return "gemm"
    return "other"


def device_breakdown(prof) -> dict:
    """Device ms by kernel class, and the GEMM FLOP counted by the profiler."""
    ms = {"k1": 0.0, "k2": 0.0, "k34": 0.0, "quant": 0.0, "prologue": 0.0, "conv": 0.0, "gemm": 0.0, "other": 0.0}
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            ms[kernel_class(evt.name)] += evt.time_range.elapsed_us() / 1e3
    gemm_flop = sum(e.flops for e in prof.key_averages() if e.key in _GEMM_OPS and e.flops)
    ms["total"] = sum(ms.values())
    ms["gemm_flop"] = float(gemm_flop)
    return ms


def kernel_time_ms(fn, mark: str = "", reps: int = 10) -> float:
    """Mean device time of the kernels whose name holds ``mark`` (all of them
    by default) in one call of ``fn`` (torch.profiler over ``reps`` calls):
    a kernel alone, without its wrapper's other launches or the host's time
    between launches."""
    fn()
    torch.cuda.synchronize()
    for _ in range(6):  # a trace now and then comes back without device events, up to three in a row; a sixth raises
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = sum(e.time_range.elapsed_us() for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA and mark in e.name)
        if us > 0:
            return us / reps / 1e3
    raise RuntimeError(f"torch.profiler recorded no {mark or 'kernel'} device time in six traces")


def measure(fn, label: str, card: str) -> dict:
    fn()  # warm-up (first-call set-up stays out of both numbers)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) / 3 * 1e3
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA,
                                            torch.profiler.ProfilerActivity.CPU], with_flops=True) as prof:
        fn()
        torch.cuda.synchronize()
    dev = device_breakdown(prof)
    if dev["total"] <= 0:
        raise RuntimeError(f"{label}: torch.profiler recorded no device time")
    row = {"label": label, "host_ms": host_ms, "device_ms": dev, "idle_share": 1.0 - dev["total"] / host_ms}
    classes = ("k1", "k2", "k34", "quant", "prologue", "gemm", "conv", "other")
    shares = ", ".join(f"{k} {dev[k]:.3f} ms ({dev[k] / dev['total']:.1%})" for k in classes if dev[k] or k == "k1")
    gemm_rate = f"{dev['gemm_flop'] / dev['gemm'] / 1e9:.1f} TFLOP/s" if dev["gemm"] else "no GEMM"
    print(f"[profile] {label}: host {host_ms:.3f} ms, device {dev['total']:.3f} ms (idle {row['idle_share']:.1%}); "
          f"{shares}; GEMM {dev['gemm_flop'] / 1e12:.2f} TFLOP at {gemm_rate} [{card}]", flush=True)
    return row


def _card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]


def profile_train(card: str, fmt: str = "bf16") -> list:
    """One LoRA train step of the full-width Klein-4B base at 512^2 and 1024^2
    under remat True and "dots", the base quantized to ``fmt`` (QLoRA: the
    quantized projections run their kernels forward and ``dy @
    dequantize(w)`` backward)."""
    from flux2_tpu_torch.models.flux2.transformer import Flux2Transformer
    from flux2_tpu_torch.ops import latents as lu
    from flux2_tpu_torch.ops.quant import quantize_params
    from flux2_tpu_torch.ops.rope import rope_embeddings
    from flux2_tpu_torch.pipeline.pipeline import Flux2Model
    from flux2_tpu_torch.training import trainer

    device = torch.device("cuda")
    gen = torch.Generator(device=device).manual_seed(SEED)
    config = Flux2Model.KLEIN_4B_BASE.transformer_config
    model = Flux2Transformer(config, device=device, generator=gen)
    quantize_params(model, fmt)
    if fmt in ("qint8", "int4"):
        os.environ["FLUX2_PALLAS_DEQUANT"] = "1"
    cfg = trainer.TrainConfig(rank=16, alpha=16.0, remat=True)
    state = trainer.init_train_state(model, cfg, gen)
    rows = []
    for size in (512, 1024):
        s_img = (size // 16) ** 2
        ids = np.concatenate([lu.text_position_ids(32), lu.image_position_ids(size, size)])
        cos, sin = rope_embeddings(torch.from_numpy(ids).to(device))
        batch = {"latents": torch.randn(1, s_img, 128, device=device, generator=gen),
                 "embeddings": torch.randn(1, 32, config.joint_attention_dim, device=device, generator=gen),
                 "rope_cos": cos, "rope_sin": sin}
        for remat in (True, "dots"):
            step = trainer.make_train_step(model, dataclasses.replace(cfg, remat=remat))
            torch.cuda.reset_peak_memory_stats()
            row = measure(lambda: step(state.lora, state.optimizer, batch, gen),
                          f"LoRA train step {size}^2 bs=1 ({32 + s_img} tokens, rank 16, remat={remat!r}, {fmt} base)",
                          card)
            row["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
            print(f"[profile] peak device memory {row['peak_gib']:.2f} GiB [{card}]", flush=True)
            rows.append(row)
    return rows


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--quantization", default="bf16", choices=("bf16", "w8a8", "w4a8", "qint8", "int4"))
    parser.add_argument("--train", action="store_true", help="profile LoRA train steps instead of serving")
    args = parser.parse_args(argv)
    fmt = args.quantization
    if not torch.cuda.is_available():
        raise RuntimeError("profile_step needs a CUDA device")
    if args.train:
        card = _card()
        rows = profile_train(card, fmt)
        print(json.dumps({"card": card, "torch": torch.__version__, "train": True, "quantization": fmt,
                          "rows": rows}), flush=True)
        return 0

    from flux2_tpu_torch.ops import latents as lu
    from flux2_tpu_torch.ops.quant import quantize_params
    from flux2_tpu_torch.ops.rope import rope_embeddings
    from flux2_tpu_torch.pipeline.pipeline import Flux2Model, Flux2Pipeline

    card = _card()
    device = torch.device("cuda")
    gen = torch.Generator(device=device).manual_seed(SEED)
    pipe = Flux2Pipeline.from_random(Flux2Model.KLEIN_4B, device=device, generator=gen)
    quantize_params(pipe.transformer, fmt)
    if fmt in ("qint8", "int4"):
        os.environ["FLUX2_PALLAS_DEQUANT"] = "1"
    joint = pipe.transformer.config.joint_attention_dim
    rows = []
    for size, batch in ((1024, 1), (256, 3)):
        emb = torch.randn(batch, 512, joint, device=device, generator=gen).bfloat16()
        noise = lu.seeded_noise_seq(SEED, size, size, batch, device=device)
        ids = np.concatenate([lu.text_position_ids(512), lu.image_position_ids(size, size)])
        cos, sin = rope_embeddings(torch.from_numpy(ids).to(device))
        guidance = pipe.model.default_guidance
        g = torch.full((batch,), guidance, device=device) if pipe.model.uses_guidance_embeds else None
        step = lambda: pipe._denoise(noise, emb, None, [(0.7, 0.5)], guidance, cos, sin, g, None)  # noqa: E731
        rows.append(measure(step, f"DiT step {size}^2 bs={batch} {fmt}", card))
        if size == 1024:
            with torch.inference_mode():
                latents = step()
            rows.append(measure(lambda: pipe.decode_latents_u8(latents, size, size), f"VAE decode {size}^2", card))
    print(json.dumps({"card": card, "torch": torch.__version__, "quantization": fmt, "rows": rows}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
