"""The text-encoder tools of the port: ``python -m flux2_tpu_torch.cli.encoders``.

Port of ``flux2_tpu/cli/encoders.py`` (JAX's ``flux-encoders``), with its
flags and printed lines, plus ``--device`` (``cuda`` unless the CPU is asked
for):

    python -m flux2_tpu_torch.cli.encoders generate --family mistral \\
        --encoder-dir E --prompt "a haiku about foxes" [--max-tokens 256 --temperature 0.7]
    python -m flux2_tpu_torch.cli.encoders chat --family qwen3-4b --encoder-dir E [--thinking]
    python -m flux2_tpu_torch.cli.encoders embed --family mistral --encoder-dir E --prompt P -o emb.npy
    python -m flux2_tpu_torch.cli.encoders upsample --family mistral --encoder-dir E --prompt P [--i2i]
    python -m flux2_tpu_torch.cli.encoders compare --family qwen3-4b --encoder-dir A \\
        --family-b qwen3-4b --encoder-dir-b B --prompt P
    python -m flux2_tpu_torch.cli.encoders vision --encoder-dir VLM --image a.png [--image2 b.png]
    python -m flux2_tpu_torch.cli.encoders models

``generate`` prints the reply; ``chat`` streams each reply from standard
input until an empty line; ``embed`` saves the conditioning as ``.npy`` and
prints its shape, dtype and path as JSON (float32: numpy has no bfloat16
without ``ml_dtypes``, which JAX's file takes); ``upsample`` prints
the rewritten prompt; ``compare`` prints ``compare_embeddings``' JSON;
``models`` lists the registry's encoder repositories. ``vision`` loads the
VLM of ``--encoder-dir`` (Qwen3.5-VL or the Mistral/Pixtral VLM, told apart
by ``facade.detect_vlm_family``) and prints its description of ``--image``,
or with ``--image2`` the FLUX.2 comparison of the two as JSON (JAX's
``cmd_vision``).
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch


def _load_encoder(args):
    from flux2_tpu_torch.models.text_encoders.facade import shared

    if args.encoder_dir:
        if args.family == "mistral":
            return shared.load_mistral(args.encoder_dir, args.tokenizer_dir, device=args.device)
        return shared.load_qwen3(args.encoder_dir, args.tokenizer_dir, size=args.family.split("-")[-1],
                                 device=args.device)
    raise SystemExit("pass --encoder-dir pointing at downloaded weights")


def _params(args):
    from flux2_tpu_torch.models.text_encoders.generation import GenerateParameters

    return GenerateParameters(max_tokens=args.max_tokens, temperature=args.temperature)


def cmd_generate(args):
    from flux2_tpu_torch.models.text_encoders.facade import shared

    enc = _load_encoder(args)
    print(shared.generate_text(args.prompt, enc.name, params=_params(args), seed=args.seed))


def cmd_chat(args):
    from flux2_tpu_torch.models.text_encoders.facade import shared

    enc = _load_encoder(args)
    messages = []
    print("interactive chat — empty line to exit")
    while True:
        try:
            user = input("> ").strip()
        except EOFError:
            break
        if not user:
            break
        messages.append({"role": "user", "content": user})
        reply = shared.chat(messages, enc.name, params=_params(args), seed=args.seed,
                            on_token=lambda piece: print(piece, end="", flush=True),
                            enable_thinking=getattr(args, "thinking", False))
        print()
        messages.append({"role": "assistant", "content": reply})


def cmd_embed(args):
    enc = _load_encoder(args)
    emb = enc.extractor(args.prompt).to(torch.float32).cpu().numpy()
    np.save(args.output, emb)
    print(json.dumps({"shape": list(emb.shape), "dtype": str(emb.dtype), "output": args.output}))


def cmd_upsample(args):
    from flux2_tpu_torch.models.text_encoders.facade import shared

    enc = _load_encoder(args)
    mode = "upsampling_i2i" if args.i2i else "upsampling_t2i"
    print(shared.upsample_prompt(args.prompt, enc.name, mode=mode, seed=args.seed))


def cmd_vision(args):
    """VLM image analysis: --image and --prompt -> the description; with
    --image2, the comparison of --image (the reference) and --image2."""
    from flux2_tpu_torch.io.png import decode_image
    from flux2_tpu_torch.models.text_encoders.facade import detect_vlm_family, shared

    with open(args.image, "rb") as f:
        image = decode_image(f.read())
    if not shared.is_vlm_loaded:
        if not args.encoder_dir:
            raise SystemExit(
                "pass --encoder-dir pointing at a VLM checkpoint (Mistral-Small "
                "w/ Pixtral tower, or Qwen3.5-VL for --image2 comparison)"
            )
        if detect_vlm_family(args.encoder_dir) == "qwen35":
            shared.load_qwen35_vlm(args.encoder_dir, args.tokenizer_dir, device=args.device)
        else:
            shared.load_mistral_vlm(args.encoder_dir, args.tokenizer_dir, device=args.device)
    if getattr(args, "image2", None):
        with open(args.image2, "rb") as f:
            generated = decode_image(f.read())
        print(json.dumps(shared.compare_images_for_flux(image, generated), indent=2))
        return
    print(shared.analyze_image(image, args.prompt, seed=args.seed))


def cmd_compare(args):
    """Two encoders' embeddings of one prompt (JAX's CompareEncoders)."""
    from flux2_tpu_torch.models.text_encoders.facade import compare_embeddings

    a = _load_encoder(args)
    emb_a = a.extractor(args.prompt)
    args_b = argparse.Namespace(**vars(args))
    args_b.family, args_b.encoder_dir = args.family_b, args.encoder_dir_b
    b = _load_encoder(args_b)
    print(json.dumps(compare_embeddings(emb_a, b.extractor(args.prompt)), indent=2))


def cmd_models(args):
    from flux2_tpu_torch.io import registry

    for name, spec in registry.TEXT_ENCODER_REPOS.items():
        found = registry.find_model_path(spec)
        print(f"  {name:<20} {spec.repo_id:<50} "
              f"{'[downloaded]' if found else '[not downloaded]'}{' [gated]' if spec.gated else ''}")


def _common(p):
    p.add_argument("--family", default="qwen3-4b", choices=["mistral", "qwen3-4b", "qwen3-8b"])
    p.add_argument("--encoder-dir")
    p.add_argument("--tokenizer-dir")
    p.add_argument("--max-tokens", type=int, default=256)
    p.add_argument("--temperature", type=float, default=0.7)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu; the CPU only when asked")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="flux-encoders", description="FLUX.2 text-encoder tools")
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("generate", help="one-shot text generation")
    _common(p)
    p.add_argument("--prompt", required=True)
    p.set_defaults(fn=cmd_generate)

    p = sub.add_parser("chat", help="interactive streaming chat")
    _common(p)
    p.add_argument("--thinking", action="store_true",
                   help="enable Qwen3 thinking mode (default off: /no_think appended, direct responses)")
    p.set_defaults(fn=cmd_chat)

    p = sub.add_parser("embed", help="export FLUX conditioning embeddings (.npy)")
    _common(p)
    p.add_argument("--prompt", required=True)
    p.add_argument("-o", "--output", default="embeddings.npy")
    p.set_defaults(fn=cmd_embed)

    p = sub.add_parser("upsample", help="BFL prompt upsampling")
    _common(p)
    p.add_argument("--prompt", required=True)
    p.add_argument("--i2i", action="store_true", help="image-editing instruction mode")
    p.set_defaults(fn=cmd_upsample)

    p = sub.add_parser("vision", help="VLM image analysis (image + prompt -> description)")
    _common(p)
    p.add_argument("--image", required=True, help="image path to analyze")
    p.add_argument("--image2", help="second image: compare --image (reference) vs --image2 (generated)")
    p.add_argument("--prompt", default="Describe this image in detail.")
    p.set_defaults(fn=cmd_vision)

    p = sub.add_parser("compare", help="compare two encoders' embeddings")
    _common(p)
    p.add_argument("--prompt", required=True)
    p.add_argument("--family-b", default="qwen3-4b", choices=["mistral", "qwen3-4b", "qwen3-8b"])
    p.add_argument("--encoder-dir-b")
    p.set_defaults(fn=cmd_compare)

    p = sub.add_parser("models", help="list encoder repos + download status")
    p.set_defaults(fn=cmd_models)
    return parser


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    args.fn(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
