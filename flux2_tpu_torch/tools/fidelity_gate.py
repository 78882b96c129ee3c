"""Real-weights fidelity gate: the port of ``tools/fidelity_gate.py``.

Regenerates the reference's own fixed-seed example images and scores them
against the shipped PNGs with PSNR, CIE76 ΔE and the mean-RGB delta
(``flux2_tpu_torch.utils.quality``). The fixtures are the reference's
``docs/examples/quantization-benchmark/README.md`` visual-comparison rows
(prompt "A fluffy orange tabby cat sitting on a windowsill at sunset", seed
42, 1024x1024, Klein 4 steps, Dev 28), plus the mire colour-chart I2I
protocol of the same README: a synthetic patch chart through image-to-image
at strength 0.35, ΔE per patch on each cell's central region.

Usage (on the card; ``--device cpu`` elsewhere):

  # the real gate, once the checkpoints are on disk:
  python -m flux2_tpu_torch.tools.fidelity_gate --reference-tree <reference>/docs/examples \\
      --models klein-4b --quantizations bf16,w8a8 --out fidelity.json

  # harness validation without checkpoints (no-checkpoint rows, never
  # scored against the PSNR gate; the mire rows run the full I2I):
  python -m flux2_tpu_torch.tools.fidelity_gate --random-init --models klein-4b --mire

  # the checkpoint-availability probe:
  python -m flux2_tpu_torch.tools.fidelity_gate --attempt-download klein-4b --out dl.json

The pipelines come from the port's ``cli.main.build_pipeline``. Under
``--random-init`` the conditioning is [1, 64, joint] bf16 noise drawn from a
``torch.Generator`` seeded 0 on the device (JAX draws it from
``jax.random.PRNGKey(0)``: the same shape and dtype, other values).

Exit status: 0 when every scored row passes its threshold (PSNR >= 30 dB for
bf16, >= 28 dB quantized) or no row was scored, 1 otherwise. Rows of a
``--random-init`` run are marked ``no_checkpoint`` and exempt.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
from typing import Optional, Sequence

import numpy as np

PSNR_GATE_BF16 = 30.0  # dB
PSNR_GATE_QUANT = 28.0

CAT_PROMPT = "A fluffy orange tabby cat sitting on a windowsill at sunset"
# the reference repository's examples, checked out beside the working directory
DEFAULT_REFERENCE_TREE = os.path.join("reference", "docs", "examples")


@dataclasses.dataclass(frozen=True)
class Fixture:
    name: str
    model: str  # flux2 model id
    quantization: str  # runtime format to load / run with
    reference_png: str  # path under --reference-tree
    prompt: str = CAT_PROMPT
    seed: int = 42
    steps: int = 4
    width: int = 1024
    height: int = 1024


# quantization-benchmark/README.md "Visual Comparison" (seed 42, 1024^2). The
# reference's storage formats map onto the runtime formats: qint8 -> w8a8,
# int4 -> w4a8; bf16 is bf16 on both sides.
FIXTURES = [
    Fixture("klein4b_bf16", "klein-4b", "bf16", "quantization-benchmark/images/klein4b_bf16.png"),
    Fixture("klein4b_qint8", "klein-4b", "w8a8", "quantization-benchmark/images/klein4b_qint8.png"),
    Fixture("klein4b_int4", "klein-4b", "w4a8", "quantization-benchmark/images/klein4b_int4.png"),
    Fixture("klein9b_bf16", "klein-9b", "bf16", "quantization-benchmark/images/klein9b_bf16.png"),
    Fixture("klein9b_qint8", "klein-9b", "w8a8", "quantization-benchmark/images/klein9b_qint8.png"),
    Fixture("klein9b_int4", "klein-9b", "w4a8", "quantization-benchmark/images/klein9b_int4.png"),
    Fixture("dev_bf16", "dev", "bf16", "quantization-benchmark/images/dev_bf16.png", steps=28),
    Fixture("dev_qint8", "dev", "w8a8", "quantization-benchmark/images/dev_qint8.png", steps=28),
    Fixture("dev_int4", "dev", "w4a8", "quantization-benchmark/images/dev_int4.png", steps=28),
]


def _load_png(path: str) -> np.ndarray:
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"), np.float32) / 255.0


def _build_pipeline(model: str, quantization: str, args) -> "object":
    from flux2_tpu_torch.cli.main import build_pipeline

    ns = argparse.Namespace(
        model=model,
        quantization=quantization,
        random_init=args.random_init,
        small_decoder=False,
        transformer_dir=args.transformer_dir,
        vae_dir=args.vae_dir,
        models_dir=None,
        encoder_dir=args.encoder_dir,
        encoder_tokenizer_dir=None,
        encoder_quantization="bf16",
        no_text_encoder=args.random_init,
        dequantize_runtime=False,
        lora=[],
        shard=None,
    )
    return build_pipeline(ns, args.device)


def _random_embeddings(pipe) -> "object":
    """[1, 64, joint] bf16 unit-normal conditioning from a generator seeded 0 on the pipeline's device."""
    import torch

    gen = torch.Generator(device=pipe.device).manual_seed(0)
    shape = (1, 64, pipe.transformer.config.joint_attention_dim)
    return torch.randn(shape, generator=gen, device=pipe.device, dtype=torch.float32).to(torch.bfloat16)


def _free_device_memory() -> None:
    import torch

    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def run_fixture(fx: Fixture, tree: str, args, pipe_cache: dict) -> dict:
    from flux2_tpu_torch.utils import quality

    ref_path = os.path.join(tree, fx.reference_png)
    row: dict = {
        "fixture": fx.name,
        "model": fx.model,
        "quantization": fx.quantization,
        "seed": fx.seed,
        "steps": fx.steps,
        "reference": ref_path,
    }
    if not os.path.exists(ref_path):
        row["error"] = "reference image missing"
        return row

    key = (fx.model, fx.quantization)
    try:
        if key not in pipe_cache:
            pipe_cache.clear()  # one resident pipeline at a time (device memory)
            _free_device_memory()
            pipe_cache[key] = _build_pipeline(fx.model, fx.quantization, args)
        pipe = pipe_cache[key]
    except SystemExit as e:  # build_pipeline exits on missing weights
        row["error"] = f"no checkpoint: {e}"
        row["no_checkpoint"] = True
        return row

    t0 = time.perf_counter()
    if args.random_init:
        res = pipe.generate(embeddings=_random_embeddings(pipe), height=fx.height, width=fx.width,
                            num_steps=fx.steps, seed=fx.seed)
        row["no_checkpoint"] = True
    else:
        res = pipe.generate(prompt=fx.prompt, height=fx.height, width=fx.width, num_steps=fx.steps, seed=fx.seed)
    row["wall_s"] = round(time.perf_counter() - t0, 2)

    ours = np.asarray(res.image, np.float32)
    ref = _load_png(ref_path)
    if ours.shape != ref.shape:
        row["note"] = f"shape mismatch ours={ours.shape} ref={ref.shape}; resized for scoring"
        from PIL import Image

        ours = np.asarray(
            Image.fromarray((ours * 255).astype(np.uint8)).resize((ref.shape[1], ref.shape[0]), Image.BILINEAR),
            np.float32,
        ) / 255.0
    row.update({k: round(float(v), 3) for k, v in quality.compare_images(ours, ref).items()})
    gate = PSNR_GATE_BF16 if fx.quantization == "bf16" else PSNR_GATE_QUANT
    row["psnr_gate_db"] = gate
    row["pass"] = bool(row.get("psnr_db", 0.0) >= gate) and not row.get("no_checkpoint", False)
    if args.save_images:
        os.makedirs(args.save_images, exist_ok=True)
        from PIL import Image

        out_png = os.path.join(args.save_images, f"{fx.name}.png")
        Image.fromarray((np.clip(np.asarray(res.image), 0, 1) * 255).astype(np.uint8)).save(out_png)
        row["generated"] = out_png
    return row


def run_mire(model: str, quantization: str, args) -> dict:
    """Colour-chart I2I fidelity: the synthetic patch chart (512x768) through
    a 4-step I2I at strength 0.35, ΔE per patch against the chart itself on
    each cell's centre (the VAE-softened edges left out). Random-init runs
    exercise the protocol; the ΔE numbers mean something only with real
    weights."""
    from flux2_tpu_torch.utils import quality

    row: dict = {"fixture": f"mire_{quantization}", "model": model, "quantization": quantization}
    chart = quality.color_chart_image(cell=128, cols=6)  # 512x768 up-sized chart
    try:
        pipe = _build_pipeline(model, quantization, args)
    except SystemExit as e:
        row["error"] = f"no checkpoint: {e}"
        row["no_checkpoint"] = True
        return row

    h, w = chart.shape[0], chart.shape[1]
    init_lat = pipe.encode_image_to_packed_sequence(chart)
    kwargs = dict(height=h, width=w, num_steps=4, seed=42, strength=0.35, init_latents=init_lat)
    if args.random_init:
        res = pipe.generate(embeddings=_random_embeddings(pipe), **kwargs)
        row["no_checkpoint"] = True
    else:
        res = pipe.generate(
            prompt="a faithful reproduction of this color calibration chart, flat uniform patches, exact colors",
            **kwargs,
        )
    ours = np.asarray(res.image, np.float32)
    measured = quality.measure_color_chart(ours, center_frac=0.6)
    target = quality.measure_color_chart(chart, center_frac=0.6)
    de = quality.delta_e_cie76(measured, target)
    row["delta_e_mean"] = round(float(de.mean()), 2)
    row["delta_e_max"] = round(float(de.max()), 2)
    return row


def attempt_download(model: str) -> dict:
    """Probe checkpoint availability (network-gated; records an honest outcome
    either way: only a payload verified complete counts as downloaded)."""
    t0 = time.perf_counter()
    try:
        from flux2_tpu_torch.io import registry
        from flux2_tpu_torch.models.flux2.config import Flux2Model

        spec = registry.TRANSFORMER_REPOS[Flux2Model(model)]
        found = registry.find_model_path(spec, None)
        if found:
            return {"model": model, "outcome": "already_present", "path": found}
        path = registry.download(spec)
        # huggingface_hub returns a stale local_dir when the network is
        # unreachable: only a completeness-verified payload counts
        n_files = sum(1 for f in os.listdir(path) if f.endswith(".safetensors")) if os.path.isdir(path) else 0
        complete, missing = registry.verify_completeness(path)
        if n_files == 0:
            complete, missing = False, ["<no .safetensors present>"]
        if not complete:
            return {"model": model, "outcome": "unavailable", "path": path,
                    "error": f"download incomplete (missing {missing[:3]})",
                    "wall_s": round(time.perf_counter() - t0, 1)}
        return {"model": model, "outcome": "downloaded", "path": path,
                "wall_s": round(time.perf_counter() - t0, 1)}
    except Exception as e:
        return {"model": model, "outcome": "unavailable",
                "error": str(e)[:200], "wall_s": round(time.perf_counter() - t0, 1)}


def attempt_tekken_probe() -> dict:
    """Probe for a real Mistral ``tekken.json`` (``hf_hub_download``) and, when
    one lands, check ``TekkenTokenizer.from_tekken_json`` on it."""
    t0 = time.perf_counter()
    try:
        from huggingface_hub import hf_hub_download

        path = hf_hub_download("mistralai/Mistral-Small-3.2-24B-Instruct-2506", "tekken.json")
        from flux2_tpu_torch.models.text_encoders.tekken import TekkenTokenizer

        tok = TekkenTokenizer.from_tekken_json(path)
        ids = tok.encode("a serene mountain lake at dawn")
        rt = tok.decode(ids)
        return {"outcome": "validated", "path": path, "n_tokens": len(ids),
                "roundtrip_ok": "serene mountain" in rt,
                "wall_s": round(time.perf_counter() - t0, 1)}
    except Exception as e:
        return {"outcome": "unavailable", "error": str(e)[:200],
                "wall_s": round(time.perf_counter() - t0, 1)}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reference-tree", default=DEFAULT_REFERENCE_TREE)
    ap.add_argument("--models", default="klein-4b", help="comma-separated flux2 model ids to gate")
    ap.add_argument("--quantizations", default="bf16", help="comma-separated runtime formats (bf16,w8a8,w4a8)")
    ap.add_argument("--random-init", action="store_true",
                    help="run the harness without checkpoints (no-checkpoint rows)")
    ap.add_argument("--mire", action="store_true", help="include the color-chart I2I row")
    ap.add_argument("--attempt-download", default=None, metavar="MODEL",
                    help="probe checkpoint download for MODEL and record the outcome")
    ap.add_argument("--transformer-dir", default=None)
    ap.add_argument("--vae-dir", default=None)
    ap.add_argument("--encoder-dir", default=None)
    ap.add_argument("--save-images", default=None, help="directory for generated PNGs")
    ap.add_argument("--out", default=None, help="write the JSON report here")
    ap.add_argument("--device", default="cuda", help="torch device (default cuda; cpu on a host without a card)")
    return ap


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    report: dict = {"reference_tree": args.reference_tree, "rows": []}

    if args.attempt_download:
        report["download_probe"] = attempt_download(args.attempt_download)
        report["tekken_probe"] = attempt_tekken_probe()

    models = {m.strip() for m in args.models.split(",") if m.strip()}
    quants = {q.strip() for q in args.quantizations.split(",") if q.strip()}
    pipe_cache: dict = {}
    for fx in FIXTURES:
        if fx.model in models and fx.quantization in quants:
            row = run_fixture(fx, args.reference_tree, args, pipe_cache)
            report["rows"].append(row)
            print(json.dumps(row), flush=True)
    pipe_cache.clear()

    if args.mire:
        for q in sorted(quants):
            _free_device_memory()
            row = run_mire(sorted(models)[0], q, args)
            report["rows"].append(row)
            print(json.dumps(row), flush=True)

    scored = [r for r in report["rows"] if "pass" in r and not r.get("no_checkpoint")]
    report["gate"] = {
        "scored": len(scored),
        "passed": sum(1 for r in scored if r["pass"]),
        "no_checkpoint": sum(1 for r in report["rows"] if r.get("no_checkpoint")),
        "errors": sum(1 for r in report["rows"] if "error" in r),
    }
    report["ok"] = bool(scored) and all(r["pass"] for r in scored)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=2)
    print(json.dumps({"fidelity_gate": report["gate"], "ok": report["ok"]}))
    return 0 if (report["ok"] or not scored) else 1


if __name__ == "__main__":
    sys.exit(main())
