"""Command line of the PyTorch port: random-init text-to-image, bf16 or
quantized, and random-init LoRA training.

Port of the random-init branch of ``flux2_tpu/cli/main.py``'s
``build_pipeline`` (``:94-104``) with ``--model``, ``--quantization``
(``:815``), ``--encoder-quantization`` (``:840-843``) and ``--random-init``,
on an explicit device and ``torch.Generator``. Where JAX's random-init
pipeline has no text encoder, the port attaches a random Qwen3 encoder of the
model's family (as ``chip_smoke.py`` serves it) and quantizes its layer
weights with ``--encoder-quantization`` (JAX ``attach_text_encoder``'s
quantization, ``:276-306``).

    python -m flux2_tpu_torch.cli.main t2i --random-init --quantization w8a8 \\
        --encoder-quantization w8a8 --prompt "a red fox" -o fox.png

``train-lora`` takes the JAX command's flags (``flux2_tpu/cli/main.py``
:1016-1040) and runs ``flux2_tpu_torch.cli.train.run_training``: with
``--random-init`` and no dataset directory, a LoRA trained on synthetic data
(``cli/train.py`` says what else it refuses, and why).

    python -m flux2_tpu_torch.cli.main train-lora --config cfg.yaml --random-init

Loading checkpoints, prequantized load and export, LoRA inference, memory
profiles and ``--shard`` are not ported yet: without ``--random-init``
``build_pipeline`` raises, and argparse refuses the other flags.
"""

from __future__ import annotations

import argparse
import sys
from typing import Optional, Sequence

import torch

from flux2_tpu.models.flux2.config import Flux2Model, Flux2TransformerConfig
from flux2_tpu.models.text_encoders.config import QWEN3_4B, QWEN3_8B, DecoderConfig
from flux2_tpu_torch.models.flux2.vae import VAEConfig
from flux2_tpu_torch.models.text_encoders.decoder import Qwen3Decoder
from flux2_tpu_torch.models.text_encoders.extractor import qwen3_extractor, quantize_encoder_params
from flux2_tpu_torch.ops.quant import quantize_params
from flux2_tpu_torch.pipeline.pipeline import Flux2Pipeline

QUANTIZATIONS = ("bf16", "qint8", "w8a8", "int4", "nf4", "w4a8", "mxfp8", "mxfp4", "nvfp4")
ENCODER_QUANTIZATIONS = ("bf16", "qint8", "w8a8", "int4", "w4a8", "mxfp8")


def _encoder_config(model: Flux2Model) -> DecoderConfig:
    """The Qwen3 encoder of a Klein model (JAX ``registry.ENCODER_FOR_MODEL``)."""
    if "4b" in model.value:
        return QWEN3_4B
    if "9b" in model.value:
        return QWEN3_8B
    raise NotImplementedError(f"{model.value}'s text encoder (Mistral-24B) is not ported yet")


def build_pipeline(
    args: argparse.Namespace,
    device: "torch.device | str",
    generator: Optional[torch.Generator] = None,
    *,
    transformer_config: Optional[Flux2TransformerConfig] = None,
    vae_config: Optional[VAEConfig] = None,
    encoder_config: Optional[DecoderConfig] = None,
) -> Flux2Pipeline:
    """Random-init pipeline for ``args.model`` on ``device``: DiT and VAE, then
    the text encoder, drawn in that order from ``generator`` (seed 0 on the
    device by default), the DiT quantized to ``args.quantization`` and the
    encoder's layers to ``args.encoder_quantization``. The config overrides
    give checkpoint-free runs at reduced size."""
    if not getattr(args, "random_init", False):
        raise NotImplementedError("loading checkpoints is not ported to flux2_tpu_torch yet; pass --random-init")
    fmt = getattr(args, "quantization", "bf16")
    enc_fmt = getattr(args, "encoder_quantization", "bf16")
    if fmt not in QUANTIZATIONS:
        raise ValueError(f"--quantization {fmt!r}: choose from {QUANTIZATIONS}")
    if enc_fmt not in ENCODER_QUANTIZATIONS:
        raise ValueError(f"--encoder-quantization {enc_fmt!r}: choose from {ENCODER_QUANTIZATIONS}")
    from flux2_tpu_torch.utils import inline_bpe_tokenizer

    model = Flux2Model(args.model)
    encoder_config = encoder_config or _encoder_config(model)
    device = torch.device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    pipe = Flux2Pipeline.from_random(model, device=device, generator=generator,
                                     transformer_config=transformer_config, vae_config=vae_config)
    quantize_params(pipe.transformer, fmt)
    decoder = Qwen3Decoder(encoder_config, device=device, generator=generator)
    pipe.text_encoder = qwen3_extractor(quantize_encoder_params(decoder, enc_fmt), inline_bpe_tokenizer())
    return pipe


def _parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="flux2_tpu_torch", description="flux2-tpu's PyTorch port")
    sub = parser.add_subparsers(dest="command", required=True)
    p = sub.add_parser("t2i", help="text to image")
    p.add_argument("--model", default="klein-4b", choices=[m.value for m in Flux2Model])
    p.add_argument("--quantization", default="bf16", choices=QUANTIZATIONS)
    p.add_argument("--encoder-quantization", default="bf16", choices=ENCODER_QUANTIZATIONS)
    p.add_argument("--random-init", action="store_true", help="random weights (smoke test; required for now)")
    p.add_argument("--prompt", default="")
    p.add_argument("--width", type=int, default=1024)
    p.add_argument("--height", type=int, default=1024)
    p.add_argument("--steps", type=int, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda" if torch.cuda.is_available() else "cpu")
    p.add_argument("-o", "--output", default="out.png")

    p = sub.add_parser("train-lora", help="flow-matching LoRA training")
    p.add_argument("--config", required=True, help="YAML training config")
    p.add_argument("--output-dir")
    p.add_argument("--resume")
    p.add_argument("--max-steps", type=int)
    p.add_argument("--random-init", action="store_true", help="random weights; synthetic data (required for now)")
    p.add_argument("--dataset-dir", help="override the YAML's dataset.path")
    p.add_argument("--transformer-dir", help="base-variant transformer weights dir")
    p.add_argument("--vae-dir")
    p.add_argument("--encoder-dir")
    p.add_argument("--encoder-tokenizer-dir")
    p.add_argument("--quantization", default="bf16", choices=["bf16", "qint8", "w8a8", "int4", "nf4", "w4a8"])
    p.add_argument("--encoder-quantization", default=None, choices=list(ENCODER_QUANTIZATIONS))
    p.add_argument("--allow-partial-resume", action="store_true",
                   help="resume even when the saved optimizer state does not match (unmatched state restarts)")
    p.add_argument("--shard", help="mesh spec 'data,fsdp,tp[,sp]' or 'auto'")
    p.add_argument("--device", default="cuda" if torch.cuda.is_available() else "cpu")
    return parser


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    return _parser().parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> int:
    import numpy as np

    from flux2_tpu_torch.io.png import encode_png

    args = parse_args(argv)
    if args.command == "train-lora":
        from flux2_tpu_torch.cli.train import run_training

        run_training(args, args.device)
        return 0
    pipe = build_pipeline(args, args.device)
    res = pipe.generate(prompt=args.prompt, height=args.height, width=args.width, num_steps=args.steps,
                        seed=args.seed)
    with open(args.output, "wb") as f:
        f.write(encode_png(np.rint(res.image * 255.0).astype(np.uint8)))
    timings = ", ".join(f"{k} {v:.3f} s" for k, v in res.phase_timings.items())
    print(f"wrote {args.output} ({args.width}x{args.height}, {res.num_steps} steps, {args.quantization}): {timings}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
