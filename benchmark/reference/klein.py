"""The plain reference of a served FLUX.2 Klein text-to-image request:
prompt -> Qwen3 conditioning -> Euler denoising from the request's seed ->
VAE decode, float32 with TF32 off, the weights drawn again from the run's
seed by ``benchmark/weights.py``. It imports nothing of the program.

Each stage runs from that stage's input as the program served it (the
conditioning it gave, the latents it gave), so each stage's own error is
what is compared; the conditioning itself runs from the prompt alone.
``reference_requests`` runs one component at a time over every sampled
request, so only one component's float32 weights are alive at once.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List

import torch

from benchmark import weights as W
from benchmark.reference import dit, text, vae


@contextlib.contextmanager
def full_f32():
    """Matmuls and convolutions in float32, TF32 off, restored after."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def reference_requests(config: dict, seed: int, device, served: List[dict],
                       fp8_control: bool = False) -> List[Dict[str, torch.Tensor]]:
    """Each stage of each served request again, from that stage's input:
    "cond" [1, 512, joint] from the request's prompt; "noise" and "latents"
    [1, S_img, 128] from the request's seed and the conditioning the program
    gave it ("cond" of ``served``); "image" uint8 [H, W, 3] from the latents
    the program gave it ("latents"). With ``fp8_control`` also
    "latents_fp8" and "image_fp8", the same stages with fp8 operands (their
    control). Float32, TF32 off; results on the host."""
    ck = W.checkpoints(config, seed, device)
    enc = config["text_encoder"]
    out: List[Dict[str, torch.Tensor]] = [{} for _ in served]
    with torch.no_grad(), full_f32():
        tok = text.WordTokenizer()
        for s, o in zip(served, out):
            ids, mask = text.klein_ids(tok, s["request"]["prompt"], enc["max_length"])
            o["cond"] = text.qwen3_conditioning(ck["text_encoder"], enc, ids, mask, enc["hidden_layers"])
        del ck["text_encoder"]
        for s, o in zip(served, out):
            r = s["request"]
            if s.get("cond") is not None:
                o["noise"], o["latents"] = dit.denoise(ck["transformer"], config["transformer"], s["cond"],
                                                       r["seed"], r["height"], r["width"], r["steps"])
                if fp8_control:
                    o["latents_fp8"] = dit.denoise(ck["transformer"], config["transformer"], s["cond"], r["seed"],
                                                   r["height"], r["width"], r["steps"], fp8_control=True)[1]
        del ck["transformer"]
        for s, o in zip(served, out):
            r = s["request"]
            if s.get("latents") is not None:
                o["image"] = vae.decode_u8(ck["vae"], config["vae"], s["latents"], r["height"], r["width"])[0]
                if fp8_control:
                    o["image_fp8"] = vae.decode_u8(ck["vae"], config["vae"], s["latents"], r["height"], r["width"],
                                                   fp8_control=True)[0]
    return [{k: t.cpu() for k, t in o.items()} for o in out]
