"""Where the device time of the port's served path goes, on one CUDA card.

    python3 -m flux2_tpu_torch.utils.profile_step [--quantization w8a8|w4a8|qint8|int4]

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
  the quantized matmuls K5 / K6 / K7, convolutions, GEMMs, and the rest
  (elementwise, reductions, copies, the quantized matmuls' activation
  prologues);
- the device's idle share, 1 - device time / host-clock time;
- the GEMM FLOP that ``torch.profiler`` counts for ``aten::mm``-family ops.

Each line carries the card's name and power limit; the last line is one JSON
object with every number.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import time

import numpy as np
import torch

SEED = 0
K1_KERNEL = "flash_fwd_kernel"
_QUANT_MARKS = ("w8a8_kernel", "w4a8_kernel", "dequant_kernel")  # csrc/quant_matmul.cu
_CONV_MARKS = ("conv", "fprop", "dgrad", "wgrad", "winograd", "implicit_gemm", "cudnn")
_GEMM_MARKS = ("gemm", "nvjet", "cutlass", "xmma", "cublas")
_GEMM_OPS = ("aten::mm", "aten::addmm", "aten::bmm", "aten::baddbmm")


def kernel_class(name: str) -> str:
    low = name.lower()
    if K1_KERNEL in low:
        return "k1"
    if any(m in low for m in _QUANT_MARKS):
        return "quant"
    if any(m in low for m in _CONV_MARKS):
        return "conv"
    if any(m in low for m in _GEMM_MARKS):
        return "gemm"
    return "other"


def device_breakdown(prof) -> dict:
    """Device ms by kernel class, and the GEMM FLOP counted by the profiler."""
    ms = {"k1": 0.0, "quant": 0.0, "conv": 0.0, "gemm": 0.0, "other": 0.0}
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            ms[kernel_class(evt.name)] += evt.time_range.elapsed_us() / 1e3
    gemm_flop = sum(e.flops for e in prof.key_averages() if e.key in _GEMM_OPS and e.flops)
    ms["total"] = sum(ms.values())
    ms["gemm_flop"] = float(gemm_flop)
    return ms


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
    shares = ", ".join(f"{k} {dev[k]:.3f} ms ({dev[k] / dev['total']:.1%})" for k in ("k1", "quant", "gemm", "conv", "other"))
    gemm_rate = f"{dev['gemm_flop'] / dev['gemm'] / 1e9:.1f} TFLOP/s" if dev["gemm"] else "no GEMM"
    print(f"[profile] {label}: host {host_ms:.3f} ms, device {dev['total']:.3f} ms (idle {row['idle_share']:.1%}); "
          f"{shares}; GEMM {dev['gemm_flop'] / 1e12:.2f} TFLOP at {gemm_rate} [{card}]", flush=True)
    return row


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--quantization", default="bf16", choices=("bf16", "w8a8", "w4a8", "qint8", "int4"))
    fmt = parser.parse_args(argv).quantization
    if not torch.cuda.is_available():
        raise RuntimeError("profile_step needs a CUDA device")

    from flux2_tpu_torch.ops import latents as lu
    from flux2_tpu_torch.ops.quant import quantize_params
    from flux2_tpu_torch.ops.rope import rope_embeddings
    from flux2_tpu_torch.pipeline.pipeline import Flux2Model, Flux2Pipeline

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
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
        guidance = (torch.full((batch,), pipe.model.default_guidance, device=device)
                    if pipe.model.uses_guidance_embeds else None)
        step = lambda: pipe._denoise(noise, emb, [(0.7, 0.5)], cos, sin, guidance, None)  # noqa: E731
        rows.append(measure(step, f"DiT step {size}^2 bs={batch} {fmt}", card))
        if size == 1024:
            with torch.inference_mode():
                latents = step()
            rows.append(measure(lambda: pipe.decode_latents_u8(latents, size, size), f"VAE decode {size}^2", card))
    print(json.dumps({"card": card, "torch": torch.__version__, "quantization": fmt, "rows": rows}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
