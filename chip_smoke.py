"""Chip smoke test of the PyTorch port (flux2_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernel from the sources in this checkout (into
build/kernels/), checks it against its plain PyTorch version on the card, then
serves Klein-4B text-to-image at full width through the port's entry point
(Flux2Server -> Qwen3-4B encoder -> DiT -> VAE) with random weights drawn on
the card from a seed, and checks what comes out. Any failure raises: the
traceback is printed and the exit code is not 0. There is no CPU fallback.

The last two lines of standard output are the card's name and power limit as
nvidia-smi reports them, then {"ok": true, "device": {...}}; the line before
those lists each kernel with its launches on the served path, its error
against the plain version, and both times.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
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
SEED = 0


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[0].strip()


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median time of one call, CUDA events around each call, after warm-up."""
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
    return statistics.median(times)


def phase_kernel_check(card: str):
    """K1 against flash_attention_reference on the card, same bf16 inputs."""
    from flux2_tpu_torch.ops import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    cases = [
        ("klein4b_1024px", (1, 24, 4608, 4608), None),
        ("klein4b_256px_bs3", (3, 24, 768, 768), None),
        ("ragged", (1, 24, 777, 1000), None),
        ("ragged_mostly_pad", (1, 24, 777, 961), None),  # last key tile: 1 real key, 63 pad
        ("blocked_span", (1, 24, 2560, 2560), (512, 1536, 1536)),
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
        results[name] = (err, ms, plain_ms)
    return results


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


def phase_serve(pipe, card: str):
    from flux2_tpu_torch.io.png import decode_png
    from flux2_tpu_torch.ops import flash_attention as fa
    from flux2_tpu_torch.serve import Flux2Server

    recorder = _RecordingPipeline(pipe)
    server = Flux2Server(recorder, embeddings_fn=pipe.encode_prompt, batch_window_s=2.0)
    big = [{"prompt": "a lighthouse on a cliff at dusk", "height": 1024, "width": 1024, "steps": 4, "seed": 1},
           {"prompt": "a bowl of ramen, studio light", "height": 1024, "width": 1024, "steps": 4, "seed": 2}]
    small = [{"prompt": f"a small red fox, variant {i}", "height": 256, "width": 256, "steps": 4, "seed": 10 + i}
             for i in range(3)]
    torch.cuda.reset_peak_memory_stats()
    try:
        fa.launches = 0  # count the served path's launches only
        t0 = time.perf_counter()
        pngs = _concurrent(server, big) + _concurrent(server, small)
        wall = time.perf_counter() - t0
        launches = fa.launches
    finally:
        server.shutdown()

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
    if launches != 25 * 4 * 3:
        raise AssertionError(f"K1 launched {launches} times on the served path, want 300")
    for r in server.request_timings:
        log(f"[serve] {r['height']}x{r['width']} batch {r['batch_size']}: text encoding {r['text_encoding_s']:.4f} s, "
            f"denoising {r['denoising_s'] / r['steps']:.4f} s/step ({r['steps']} steps, whole batch), "
            f"VAE decoding {r['vae_decoding_s']:.4f} s [{card}]")
    log(f"[serve] 5 requests in 3 batches, {wall:.3f} s wall; K1 launches {launches}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{card}]")
    return launches


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
        if "registers" in line or "spill" in line:
            log(f"[build] {line.strip()}")

    checks = phase_kernel_check(card)

    t0 = time.perf_counter()
    pipe, tok_name = build_pipeline()
    log(f"[model] random Klein-4B DiT + FLUX.2 VAE + Qwen3-4B encoder (tokenizer {tok_name}) drawn on the card "
        f"in {time.perf_counter() - t0:.2f} s; {torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated [{card}]")
    phase_model_check(pipe, card)

    launches = phase_serve(pipe, card)

    _, ms, plain_ms = checks["klein4b_1024px"]
    kernels = [{
        "name": "flash_attention_fwd",
        "route": "cuda",
        "source": "flux2_tpu_torch/csrc/flash_attention.cu",
        "replaces": "flux2_tpu/ops/flash_attention.py:84",
        "launches": launches,
        "max_abs_err": max(e for e, _, _ in checks.values()),
        "ms": ms,
        "plain_ms": plain_ms,
    }]
    log(json.dumps({"kernels": kernels}))
    log(card)
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
