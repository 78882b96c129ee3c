"""Command line of the PyTorch port: text-to-image, multi-reference
image-to-image (``i2i``) and ``profile`` from checkpoint directories or random
weights, bf16 or quantized, LoRA training (``train-lora``) and its gap
analysis (``evaluate-lora``).

Port of ``flux2_tpu/cli/main.py``'s ``build_pipeline`` (``:84-164``): the
checkpoint branch resolves each component's directory through the registry
(``--transformer-dir``, ``--vae-dir``, ``--encoder-dir``, else the models dir,
else the HF cache), reads its ``config.json``, maps BFL or Diffusers
transformer weights, the Diffusers VAE (decoder and encoder) and HF Qwen3 or
Mistral Small 3.2 (Dev's encoder, its ``tekken.json``) straight onto the
device (``io/weight_mapping.py``), and quantizes the DiT to
``--quantization`` and the encoder's layers to ``--encoder-quantization`` on
the fly. Missing weights exit with JAX's messages. ``--random-init`` draws
the same modules from a seed instead; where JAX's random-init pipeline has no
text encoder, the port attaches a random encoder of the model's family (as
``chip_smoke.py`` serves it): Qwen3 with the dev tokenizer for Klein, Mistral
at the built-in ``MISTRAL_SMALL_3_2`` shape with a Tekken tokenizer whose
ranks fill its vocabulary for Dev. The DiT is quantized before the encoder is
drawn, so a bf16 Dev DiT (~63 GB) never shares the card with the encoder.
The encoder registers in ``facade.shared``, which gives the pipeline its
chat and upsampling surface.

``t2i --upsample`` rewrites the prompt through that encoder with the BFL
protocol first and prints ``[upsample] final prompt: ...`` when it changed;
``i2i --upsample`` has the VLM describe the references first, and
``--interpret IMAGE`` (t2i and i2i, repeatable) puts the VLM's description of
each image before the prompt. The VLM comes from the checkpoint branch's
lazy loader (JAX's ``_make_vlm_loader``): a Qwen3.5-VL checkpoint under the
registry's ``qwen35-vlm`` path when there is one, else the Mistral-Small
VLM (``--encoder-dir`` for Dev, else the registry's path), else a
``SystemExit`` naming both. A random-init pipeline has no loader, as JAX's,
so its ``--interpret`` raises JAX's "requires a VLM" error. Dev on one 80 GB
card:

    python -m flux2_tpu_torch.cli.main t2i --model dev --random-init \
        --quantization w8a8 --encoder-quantization w8a8 --upsample \
        --prompt "a red fox" -o fox.png

    python -m flux2_tpu_torch.cli.main t2i --transformer-dir T --vae-dir V \\
        --encoder-dir E --prompt "a red fox" -o fox.png
    python -m flux2_tpu_torch.cli.main profile --transformer-dir T --vae-dir V \\
        --encoder-dir E --compare bf16,w8a8 --warmup 1 --runs 3

    python -m flux2_tpu_torch.cli.main i2i --random-init --reference ref.png \\
        --prompt "the same fox in snow" [--strength 0.6] -o out.png

``t2i`` prints ``saved <path>`` and JAX's JSON line (seed, steps, duration_s,
phases, memory_gb); ``i2i`` (JAX's ``cmd_i2i``, ``:419-451``: every
``--reference`` VAE-encoded within ``--max-ref-megapixels``, the first also
the img2img init when ``--strength`` < 1; klein-9b-kv takes the KV-cached
path) prints the same two lines. ``profile`` (JAX's ``cmd_profile`` /
``_profile_once``, ``:720-778``) runs warmup and timed generations per
configuration and prints JAX's report, table and JSON, ``--trace`` writing
the phases as a Chrome trace.

``train-lora`` takes the JAX command's flags (``:1016-1040``) and runs
``flux2_tpu_torch.cli.train.run_training``: on a dataset directory from
checkpoint directories (``--quantization`` quantizes the base: QLoRA), on a
dataset with random weights (``--random-init``), or on synthetic data
(``--random-init`` and no dataset), with validation previews, the held-out
loss and ``--resume`` of either package's checkpoints; the YAML's ``pp``
keys (pipeline parallelism, ``parallel/pipeline.py``) and ``--shard`` run one
process per rank under torchrun. It refuses ``--quantization`` with
``--random-init`` (a recorded difference: JAX ignores the flag there).
``evaluate-lora --dataset D [--no-vlm]`` (JAX's ``cmd_evaluate_lora``,
``:544-595``) generates a baseline per dataset image, scores it (the VLM's
``score_validation_image`` when the loader finds a VLM on disk, else the
pixel scorer) and prints JAX's lines and JSON:

    python -m flux2_tpu_torch.cli.main train-lora --config lora.yaml \
        --transformer-dir T --vae-dir V --encoder-dir E [--quantization w8a8]
    python -m torch.distributed.run --standalone --nproc-per-node 4 \
        -m flux2_tpu_torch.cli.main train-lora --config pp.yaml ...  # training: {pp: 2}
    python -m flux2_tpu_torch.cli.main evaluate-lora --transformer-dir T \
        --vae-dir V --encoder-dir E --dataset D --no-vlm

``inpaint`` and ``outpaint`` (JAX's ``cmd_inpaint`` / ``cmd_outpaint``,
``:454-510``, with their flags and defaults, ``--steps`` 4) run the RePaint
chains of ``flux2_tpu_torch/chains/`` and write ``-o``. With
``--enrich-prompt-with-vlm`` the command loads the pipeline's VLM first and
the chain has it rewrite the prompt for ``--intent`` (inpaint) or the
extended sides (outpaint); JAX's command never loads one, so there the flag
warns and keeps the prompt, as the port's chain does without a VLM:

    python -m flux2_tpu_torch.cli.main inpaint --random-init --image in.png \
        --mask mask.png --prompt "a red door" [--crop-padding 64 --composite] -o out.png
    python -m flux2_tpu_torch.cli.main outpaint --random-init --image in.png \
        --left 128 --right 128 --prompt "a wider street" -o out.png

``t2i`` and ``i2i`` also take ``--checkpoint-every N`` (intermediate images
as ``<output>_step_NNN.png``); every generating command takes
``--small-decoder`` (the distilled VAE decoder: ``FLUX2_VAE_SMALL_DECODER``
with ``--random-init``, else the small-decoder repository's directory and
``config.json``) and ``--memory-profile`` (``auto`` reads the card's memory;
``conservative`` tiles the decode above 1024 px).

The small subcommands (JAX's, with their flags): ``info`` (the backend as
torch sees it, ``cuda, devices: N`` or ``cpu, devices: 1``, probed under a
20 s watchdog; then one line per model), ``download [--quantization F]
[--token T]`` (``registry.download``), ``training-control
pause|resume|stop|checkpoint --output-dir D`` (sentinel files),
``beacons`` (runtime manifests) and ``mask-subject --image I -o M``
(``chains/subject_mask.py``: the committed U-Net on ``--device``; the mask
PNG is white where ``inpaint`` regenerates). The global flags
``--models-dir``, ``--token`` and ``--beacon`` set ``FLUX2_MODELS_DIR``,
``HF_TOKEN`` and ``FLUX2_RUNTIME_BEACON``; ``t2i`` writes a beacon manifest
while it denoises. Every PNG is written with JAX's pixels (``io.png.to_u8``).

Every generating command takes ``--lora path[:scale]`` (repeatable: each
file merged into the DiT in turn, its sidecar's Turbo overrides and
activation keyword applied; a W8A8 / W4A8 DiT raises JAX's ``TypeError``) and
``--dequantize-runtime``. ``export-quantized --quantization F [--lora L]``
writes the checkpoint's DiT, LoRAs baked in, as a prequantized file beside
it (``<transformer dir>/tpu-prequantized/F/transformer.safetensors``, JAX's
layout), which a quantized ``t2i`` then reads (qint8 for w8a8, int4 for
w4a8), as JAX's does:

    python -m flux2_tpu_torch.cli.main export-quantized --transformer-dir T \\
        --quantization qint8 --lora style.safetensors:0.8
    python -m flux2_tpu_torch.cli.main t2i --transformer-dir T --vae-dir V \\
        --encoder-dir E --quantization w8a8 --prompt "a red fox" -o fox.png

Every generating command takes ``--shard 'data,fsdp,tp[,sp]' | auto``,
``--context-parallel`` and ``--dcn`` (JAX's ``build_pipeline`` branch,
``:213-236``): ``Flux2Pipeline.shard`` over the mesh of the run's ranks.
Torch runs one process per rank, so a sharded run starts under torchrun,
every rank runs the command, and rank 0 alone writes files and prints the
result lines; without torchrun the world is one rank and a larger spec
exits naming the count:

    python -m torch.distributed.run --standalone --nproc-per-node 8 \
        -m flux2_tpu_torch.cli.main t2i --random-init --shard 1,1,8 \
        --context-parallel --prompt "a red fox" -o fox.png

Images are read by Pillow
where it imports (any format it reads), else PNG only, by the port's own
decoder; so are masks (grey, grey + alpha, RGB or RGBA PNGs without Pillow).
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import os
import sys
import time
from typing import Optional, Sequence

import torch

from flux2_tpu_torch.io import registry
from flux2_tpu_torch.models.flux2.config import Flux2Model, Flux2TransformerConfig
from flux2_tpu_torch.models.text_encoders.config import (
    MISTRAL_HIDDEN_LAYERS, MISTRAL_SMALL_3_2, QWEN3_4B, QWEN3_8B, QWEN3_HIDDEN_LAYERS, DecoderConfig)
from flux2_tpu_torch.models.flux2.vae import FLUX2_VAE, FLUX2_VAE_SMALL_DECODER, VAEConfig
from flux2_tpu_torch.models.text_encoders.decoder import Qwen3Decoder
from flux2_tpu_torch.models.text_encoders.extractor import quantize_encoder_params
from flux2_tpu_torch.ops.quant import dequantize_params, quantize_params
from flux2_tpu_torch.pipeline.pipeline import Flux2Pipeline
from flux2_tpu_torch.utils import logging as flog
from flux2_tpu_torch.utils.profiler import shared as profiler

QUANTIZATIONS = ("bf16", "qint8", "w8a8", "int4", "nf4", "w4a8", "mxfp8", "mxfp4", "nvfp4")
ENCODER_QUANTIZATIONS = ("bf16", "qint8", "w8a8", "int4", "w4a8", "mxfp8")


def _encoder_config(model: Flux2Model) -> DecoderConfig:
    """The built-in shape of a model's encoder (JAX ``registry.ENCODER_FOR_MODEL``):
    Qwen3-4B / 8B for Klein, Mistral Small 3.2 for Dev."""
    if "4b" in model.value:
        return QWEN3_4B
    if "9b" in model.value:
        return QWEN3_8B
    return MISTRAL_SMALL_3_2


def build_pipeline(
    args: argparse.Namespace,
    device: "torch.device | str",
    generator: Optional[torch.Generator] = None,
    *,
    transformer_config: Optional[Flux2TransformerConfig] = None,
    vae_config: Optional[VAEConfig] = None,
    encoder_config: Optional[DecoderConfig] = None,
) -> Flux2Pipeline:
    """The pipeline of ``args.model`` on ``device``, the DiT quantized to
    ``args.quantization`` and the encoder's layers to
    ``args.encoder_quantization``: from checkpoint directories, or with
    ``args.random_init`` drawn from ``generator`` (seed 0 on the device by
    default; DiT, VAE decoder and VAE encoder, then the text encoder). The
    config overrides give random-init runs at reduced size."""
    fmt = getattr(args, "quantization", "bf16")
    enc_fmt = getattr(args, "encoder_quantization", "bf16") or "bf16"
    if fmt not in QUANTIZATIONS:
        raise ValueError(f"--quantization {fmt!r}: choose from {QUANTIZATIONS}")
    if enc_fmt not in ENCODER_QUANTIZATIONS:
        raise ValueError(f"--encoder-quantization {enc_fmt!r}: choose from {ENCODER_QUANTIZATIONS}")
    model = Flux2Model(args.model)
    device = torch.device(device)
    spec = getattr(args, "shard", None)
    if spec:  # under torchrun each rank builds on its own card (cuda:LOCAL_RANK)
        from flux2_tpu_torch.parallel import mesh as mesh_mod

        mesh_mod.ensure_process_group(device.type)
        if device.type == "cuda":
            device = torch.device("cuda", torch.cuda.current_device())
    if not getattr(args, "random_init", False):
        pipe = _load_pipeline(args, model, device, fmt, enc_fmt)
    else:
        encoder_config = encoder_config or _encoder_config(model)
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        if vae_config is None and getattr(args, "small_decoder", False):
            vae_config = FLUX2_VAE_SMALL_DECODER
        pipe = Flux2Pipeline.from_random(model, device=device, generator=generator,
                                         transformer_config=transformer_config, vae_config=vae_config)
        quantize_params(pipe.transformer, fmt)  # before the encoder is drawn: the peak is one component's
        if not getattr(args, "no_text_encoder", False):
            decoder = Qwen3Decoder(encoder_config, device=device, generator=generator)
            attach_random_encoder(pipe, quantize_encoder_params(decoder, enc_fmt), enc_fmt)
    apply_loras(pipe, getattr(args, "lora", None) or [])
    pipe.memory_profile = memory_profile(args)
    if spec:
        mesh = _mesh_from_spec(spec, getattr(args, "dcn", False), device.type)
        pipe.shard(mesh, context_parallel=getattr(args, "context_parallel", False))
        from flux2_tpu_torch.parallel.mesh import mesh_shape

        flog.info(f"sharded over mesh {mesh_shape(mesh)}")
    return pipe


def _mesh_from_spec(spec: str, dcn: bool, device_type: str):
    """``--shard 'data,fsdp,tp[,sp]' | auto`` (with ``--dcn``: the data axis
    over contiguous groups of ranks) -> the mesh, as JAX's ``build_pipeline``;
    a mesh the ranks do not fill exits naming the rank count."""
    import torch.distributed as dist

    from flux2_tpu_torch.parallel import mesh as mesh_mod

    if spec == "auto":
        return mesh_mod.best_mesh_for_inference(device_type=device_type)
    try:
        dims = [int(x) for x in spec.split(",")]
    except ValueError:
        dims = []
    if len(dims) not in (3, 4):
        raise SystemExit("--shard expects 'data,fsdp,tp' or 'data,fsdp,tp,sp' or 'auto'")
    sp = dims[3] if len(dims) == 4 else 1
    try:
        if dcn:
            return mesh_mod.make_multislice_mesh(num_slices=dims[0], fsdp=dims[1], tp=dims[2], sp=sp,
                                                 device_type=device_type)
        return mesh_mod.make_mesh(data=dims[0], fsdp=dims[1], tp=dims[2], sp=sp, device_type=device_type)
    except ValueError as e:
        raise SystemExit(f"--shard {spec}: {e}: this run has {dist.get_world_size()} rank(s); start one process "
                         f"per rank with torchrun (python -m torch.distributed.run --nproc-per-node N ...)")


def _writes_files() -> bool:
    """Rank 0 (or a run without torchrun) writes the files and prints the result lines."""
    return int(os.environ.get("RANK", "0")) == 0


def _lora_spec(spec: str):
    """``path[:scale]`` -> (path, scale), as JAX splits it."""
    parts = spec.split(":")
    return parts[0], float(parts[1]) if len(parts) > 1 else 1.0


def apply_loras(pipe: Flux2Pipeline, specs: Sequence[str]) -> None:
    """Merge each ``--lora path[:scale]`` into the DiT, one file at a time, and
    set the pipeline's LoRA runtime semantics (Turbo scheduler overrides,
    activation keywords), with JAX's log lines (``build_pipeline``,
    ``:166-198``). A W8A8 / W4A8 DiT raises JAX's ``TypeError``: merge into
    the storage format first (``export-quantized --lora``)."""
    if not specs:
        return
    from flux2_tpu_torch.training import lora_loader

    config = pipe.transformer.config
    loaded_loras = []
    for spec in specs:
        path, scale = _lora_spec(spec)
        loaded = lora_loader.load_lora_file(path, config, user_scale=scale)
        lora_loader.merge_loras_into_params(pipe.transformer, [loaded], config)
        loaded_loras.append(loaded)
        flog.info(f"merged LoRA {path} (scale {loaded.scale:.3f})")
    overrides, keywords, warnings = lora_loader.merge_runtime_semantics(loaded_loras)
    for w in warnings:
        flog.warning(w)
    pipe.lora_custom_sigmas = overrides.custom_sigmas
    pipe.lora_num_steps = overrides.num_steps
    pipe.lora_guidance = overrides.guidance
    pipe.lora_keywords = keywords
    if overrides.num_steps or overrides.custom_sigmas or overrides.guidance is not None:
        flog.info(
            f"LoRA scheduler overrides active: steps={overrides.num_steps} "
            f"guidance={overrides.guidance} custom_sigmas="
            f"{'yes' if overrides.custom_sigmas else 'no'}"
        )
    if keywords:
        flog.info(f"LoRA activation keyword(s): {', '.join(keywords)}")


def memory_profile(args: argparse.Namespace):
    """The ``--memory-profile`` of ``args`` as a ``MemoryProfile`` (``auto``:
    chosen by ``args.model``'s estimate against this card's memory), or None."""
    name = getattr(args, "memory_profile", None)
    if not name:
        return None
    from flux2_tpu_torch.utils import memory

    profile = (memory.auto_profile(Flux2Model(args.model), getattr(args, "quantization", "bf16"))
               if name == "auto" else memory.MemoryProfile.named(name))
    flog.info(f"memory profile: {profile.name}")
    return profile


def _load_pipeline(args, model: Flux2Model, device: torch.device, fmt: str, enc_fmt: str) -> Flux2Pipeline:
    """JAX ``build_pipeline``'s checkpoint branch (``:105-164``); each
    component is timed as JAX's phases. A quantized DiT is read from the
    prequantized file beside the checkpoint when there is one (the storage
    format: qint8 for w8a8, int4 for w4a8), checked against the checkpoint's
    fingerprint and converted to the runtime format, or to bf16 under
    ``--dequantize-runtime``; else it is quantized on the fly."""
    from flux2_tpu_torch.io import checkpoints, weight_mapping

    with_encoder = not getattr(args, "no_text_encoder", False)
    with profiler().phase("4. Load Transformer"):
        t0 = _load_start()
        tdir = registry.find_model_path(registry.TRANSFORMER_REPOS[model], getattr(args, "transformer_dir", None))
        if tdir is None:
            raise SystemExit(
                f"transformer weights for {model.value} not found; run "
                f"`flux2 download --model {model.value}` or pass --transformer-dir"
            )
        tconfig = _read_config_json(tdir, model.transformer_config)
        storage_fmt = {"w8a8": "qint8", "w4a8": "int4"}.get(fmt, fmt)
        prequant = checkpoints.prequantized_path(tdir, storage_fmt)
        if fmt != "bf16" and os.path.exists(prequant):
            tree, _ = checkpoints.load_prequantized(prequant, expected_source_dir=tdir)
            transformer = checkpoints.transformer_from_tree(tree, tconfig, device)
            del tree
            flog.info(f"loaded prequantized {storage_fmt} transformer from {prequant}")
            if fmt in ("w8a8", "w4a8"):
                quantize_params(transformer, fmt)
                flog.info(f"converted to the {fmt} runtime format (int8 tensor cores)")
            elif getattr(args, "dequantize_runtime", False):
                dequantize_params(transformer)
                flog.info("dequantized to bf16 at load (speed-first runtime)")
            _log_load("transformer", os.path.dirname(prequant), t0, device, fmt)
        else:
            # quantized block by block as it loads: a bf16 Dev DiT alone fills most of an 80 GB card
            transformer = weight_mapping.load_transformer(checkpoints.WeightsDir(tdir), tconfig, device,
                                                          quantization=fmt)
            _log_load("transformer", tdir, t0, device, fmt)
    with profiler().phase("5. Load VAE"):
        t0 = _load_start()
        small = getattr(args, "small_decoder", False)
        vdir = registry.find_model_path(registry.VAE_SMALL_DECODER_REPO if small else registry.VAE_REPO,
                                        getattr(args, "vae_dir", None))
        if vdir is None:
            raise SystemExit("VAE weights not found; run `flux2 download` or pass --vae-dir")
        weights = checkpoints.WeightsDir(vdir)
        vae_config = _read_vae_config_json(vdir, FLUX2_VAE_SMALL_DECODER if small else FLUX2_VAE)
        vae = weight_mapping.load_vae(weights, vae_config, device)
        vae_encoder = weight_mapping.load_vae_encoder(weights, vae_config, device)
        _log_load("VAE", vdir, t0, device, "float32")
    pipe = Flux2Pipeline(model=model, transformer=transformer, vae=vae, device=device, vae_encoder=vae_encoder)
    if with_encoder:
        with profiler().phase("1. Load Text Encoder"):
            attach_text_encoder(pipe, getattr(args, "encoder_dir", None), getattr(args, "encoder_tokenizer_dir", None),
                                enc_fmt)
    return pipe


def _read_config_json(model_dir: str, default: Flux2TransformerConfig) -> Flux2TransformerConfig:
    """A diffusers ``config.json`` beside the weights, else ``default``."""
    path = os.path.join(model_dir, "config.json")
    if os.path.exists(path):
        with open(path) as f:
            return Flux2TransformerConfig.from_json_dict(json.load(f))
    return default


def _read_vae_config_json(vae_dir: str, default: VAEConfig) -> VAEConfig:
    path = os.path.join(vae_dir, "config.json")
    if os.path.exists(path):
        with open(path) as f:
            return VAEConfig.from_json_dict(json.load(f))
    return default


def attach_random_encoder(pipe: Flux2Pipeline, decoder: Qwen3Decoder, quantization: str) -> None:
    """Register a random-init encoder in ``facade.shared`` and attach it with
    its recipe: Mistral (``llama4_scaling_beta`` set) as "mistral" with
    ``tekken.random_init_tokenizer`` over its vocabulary, else Qwen3 under its
    registry name with the dev tokenizer."""
    from flux2_tpu_torch.models.text_encoders import facade

    cfg = decoder.cfg
    if cfg.llama4_scaling_beta is not None:
        from flux2_tpu_torch.models.text_encoders.tekken import random_init_tokenizer

        enc = facade.shared.attach("mistral", decoder, cfg, random_init_tokenizer(cfg.vocab_size),
                                   MISTRAL_HIDDEN_LAYERS, recipe="mistral")
    else:
        from flux2_tpu_torch.utils import inline_bpe_tokenizer

        enc = facade.shared.attach(registry.ENCODER_FOR_MODEL[pipe.model], decoder, cfg, inline_bpe_tokenizer(),
                                   QWEN3_HIDDEN_LAYERS, recipe="klein")
    pipe.text_encoder = enc.extractor
    pipe.text_encoder_name = enc.name
    pipe.text_encoder_quantization = quantization
    pipe.encoders = facade.shared


def attach_text_encoder(pipe: Flux2Pipeline, encoder_dir: Optional[str] = None, tokenizer_dir: Optional[str] = None,
                        quantization: str = "bf16") -> None:
    """Load the model family's encoder (Qwen3, or Mistral for Dev) onto the
    pipeline's device, register it in ``facade.shared`` and attach it with
    the facade: explicit ``encoder_dir``, then the models dir, then the HF
    cache, and set the pipeline's lazy VLM loader (JAX ``attach_text_encoder``,
    ``:276-309``)."""
    from flux2_tpu_torch.models.text_encoders import facade

    t0 = _load_start()
    name = registry.ENCODER_FOR_MODEL[pipe.model]
    edir = registry.find_model_path(registry.TEXT_ENCODER_REPOS[name], encoder_dir)
    if edir is None:
        raise SystemExit(
            f"text encoder {name} weights not found; run `flux2 download --model "
            f"{pipe.model.value}`, pass --encoder-dir, or pass --no-text-encoder "
            f"to run with precomputed embeddings"
        )
    if name == "mistral-small-3.2":
        enc = facade.load_mistral(edir, tokenizer_dir, quantization=quantization, device=pipe.device)
    else:
        enc = facade.load_qwen3(edir, tokenizer_dir, size="4b" if "4b" in name else "8b",
                                quantization=quantization, device=pipe.device)
    pipe.text_encoder = enc.extractor
    pipe.text_encoder_name = enc.name
    pipe.text_encoder_quantization = quantization
    pipe.encoders = facade.shared
    pipe.vlm_loader = _make_vlm_loader(encoder_dir if name == "mistral-small-3.2" else None, pipe.device)
    _log_load(f"text encoder {enc.name} ({enc.config.num_hidden_layers} layers, {enc.config.hidden_size} hidden)",
              edir, t0, pipe.device, quantization)


def _make_vlm_loader(mistral_dir_hint: Optional[str] = None, device: "torch.device | str" = "cuda"):
    """The lazy VLM loader of ``--interpret``, vision ``--upsample`` and VLM
    scoring (JAX's, ``:312-337``): the Qwen3.5 VLM when a Qwen3.5-VL
    checkpoint sits at the registry's ``qwen35-vlm`` path, else the
    Mistral-Small Pixtral VLM (``mistral_dir_hint``, else the registry's
    path), else ``SystemExit``. The VLM loads onto ``device``."""
    def load():
        from flux2_tpu_torch.models.text_encoders import facade

        qdir = registry.find_model_path(registry.TEXT_ENCODER_REPOS["qwen35-vlm"])
        if qdir is not None and facade.detect_vlm_family(qdir) == "qwen35":
            return facade.shared.load_qwen35_vlm(qdir, device=device)
        mdir = registry.find_model_path(registry.TEXT_ENCODER_REPOS["mistral-small-3.2"], mistral_dir_hint)
        if mdir is None:
            raise SystemExit(
                "--interpret/--upsample with images needs a VLM checkpoint "
                "on disk (Qwen3.5-VL or Mistral-Small); run "
                "`flux2 download --model dev` or set FLUX2_MODELS_DIR"
            )
        return facade.shared.load_mistral_vlm(mdir, device=device)

    return load


def _load_start() -> float:
    from flux2_tpu_torch.utils.memory import reset_host_peak_rss

    reset_host_peak_rss()
    return time.perf_counter()


def _log_load(what: str, path: str, t0: float, device: torch.device, fmt: str) -> None:
    """One line per component: bytes read, seconds, the host's peak resident
    set during the load and the device memory allocated after it."""
    from flux2_tpu_torch.io.checkpoints import safetensors_files
    from flux2_tpu_torch.utils.memory import device_memory_stats, host_peak_rss_bytes

    if device.type == "cuda":
        torch.cuda.synchronize(device)
    gib = 2**30
    nbytes = sum(os.path.getsize(f) for f in safetensors_files(path))
    peak, scope = host_peak_rss_bytes()
    flog.info(f"loaded {what} ({fmt}) from {path}: {nbytes / gib:.2f} GiB read "
              f"in {time.perf_counter() - t0:.2f} s; host peak RSS {peak / gib:.2f} GiB ({scope}); "
              f"{device_memory_stats(device)['bytes_in_use'] / gib:.2f} GiB allocated on {device}")


def _parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="flux2_tpu_torch", description="flux2-tpu's PyTorch port")
    sub = parser.add_subparsers(dest="command", required=True)
    p = sub.add_parser("t2i", help="text to image")
    _add_common(p)

    p = sub.add_parser("i2i", help="multi-reference image-to-image")
    _add_common(p)
    p.add_argument("--reference", action="append", required=True, help="reference image path (repeatable)")
    p.add_argument("--strength", type=float, default=1.0)
    p.add_argument("--max-ref-megapixels", type=float, default=1.0,
                   help="VAE encode budget per reference image in MP (1.0 = 1024^2)")

    p = sub.add_parser("inpaint", help="RePaint masked inpainting")
    _add_common(p)
    p.add_argument("--image", required=True)
    p.add_argument("--mask", required=True)
    p.add_argument("--alpha-mask", action="store_true", help="transparent = inpaint")
    p.add_argument("--strength", type=float, default=1.0)
    p.add_argument("--crop-padding", type=int, help="crop-and-stitch padding px")
    p.add_argument("--composite", action="store_true", help="pixel-composite onto original")
    p.add_argument("--use-image-as-reference", action="store_true")
    p.add_argument("--max-pixels", type=int, default=4 * 1024 * 1024,
                   help="working-resolution cap in total pixels (inputs above it are Lanczos-downscaled to "
                        "multiples of 32)")
    p.add_argument("--upsample-prompt", action="store_true",
                   help="text-encoder-only prompt rewriting (no VLM)")
    p.add_argument("--enrich-prompt-with-vlm", action="store_true",
                   help="image-aware prompt rewriting via a VLM (wins over --upsample-prompt); with no VLM on "
                        "disk it warns and keeps --prompt")
    p.add_argument("--intent", default="replace", choices=["replace", "remove", "modify", "change-scene"],
                   help="edit intent: drives --enrich-prompt-with-vlm's system prompt")

    p = sub.add_parser("outpaint", help="BFL-style outpainting")
    _add_common(p)
    p.add_argument("--image", required=True)
    p.add_argument("--top", type=int, default=0)
    p.add_argument("--bottom", type=int, default=0)
    p.add_argument("--left", type=int, default=0)
    p.add_argument("--right", type=int, default=0)
    p.add_argument("--max-pixels", type=int, default=4 * 1024 * 1024,
                   help="canvas working-pixel cap (the canvas itself is never cropped)")
    p.add_argument("--upsample-prompt", action="store_true",
                   help="text-encoder-only prompt rewriting (no VLM)")
    p.add_argument("--enrich-prompt-with-vlm", action="store_true",
                   help="image-aware prompt rewriting via a VLM (wins over --upsample-prompt); with no VLM on "
                        "disk it warns and keeps --prompt")

    p = sub.add_parser("export-quantized", help="export a prequantized checkpoint")
    p.add_argument("--model", default="klein-4b", choices=[m.value for m in Flux2Model])
    p.add_argument("--quantization", required=True, choices=["qint8", "int4", "nf4", "mxfp8", "mxfp4", "nvfp4"])
    p.add_argument("--transformer-dir")
    p.add_argument("--lora", action="append", metavar="PATH[:SCALE]",
                   help="bake this LoRA into the exported weights (repeatable)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu; the CPU only when asked")

    p = sub.add_parser("profile", help="benchmark generation (warmup + N runs)")
    _add_common(p)
    p.add_argument("--warmup", type=int, default=1)
    p.add_argument("--runs", type=int, default=3)
    p.add_argument("--trace", help="export Chrome-trace JSON here")
    p.add_argument("--no-decode", action="store_true")
    p.add_argument("--compare", metavar="FMT,FMT,...",
                   help="cross-config comparison over quantization formats (e.g. bf16,w8a8)")

    p = sub.add_parser("evaluate-lora", help="LoRA training-need gap analysis")
    _add_common(p)
    p.add_argument("--dataset", required=True, help="images + .txt captions (or manifest.jsonl)")
    p.add_argument("--output-dir", default="lora_eval")
    p.add_argument("--max-samples", type=int, default=4)
    p.add_argument("--no-vlm", action="store_true", help="skip VLM scoring (pixel-stat fallback)")

    p = sub.add_parser("train-lora", help="flow-matching LoRA training")
    p.add_argument("--config", required=True, help="YAML training config")
    p.add_argument("--output-dir")
    p.add_argument("--resume")
    p.add_argument("--max-steps", type=int)
    p.add_argument("--random-init", action="store_true",
                   help="random weights; with an existing dataset.path runs the full real data path, else a synthetic "
                        "smoke run")
    p.add_argument("--dataset-dir", help="override the YAML's dataset.path")
    p.add_argument("--transformer-dir", help="base-variant transformer weights dir")
    p.add_argument("--vae-dir")
    p.add_argument("--encoder-dir")
    p.add_argument("--encoder-tokenizer-dir")
    # nf4 included: the QLoRA storage format trains on a quantized base
    p.add_argument("--quantization", default="bf16", choices=["bf16", "qint8", "w8a8", "int4", "nf4", "w4a8"])
    p.add_argument("--encoder-quantization", default=None, choices=list(ENCODER_QUANTIZATIONS))
    p.add_argument("--allow-partial-resume", action="store_true",
                   help="resume even when the saved optimizer state does not match (unmatched state restarts)")
    p.add_argument("--shard", help="mesh spec 'data,fsdp,tp[,sp]' or 'auto'")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu; the CPU only when asked")

    p = sub.add_parser("download", help="download model weights from HF")
    p.add_argument("--model", default="klein-4b", choices=[m.value for m in Flux2Model])
    p.add_argument("--quantization", default="bf16", choices=QUANTIZATIONS)
    p.add_argument("--token", help="HF token (or env HF_TOKEN)")
    p.add_argument("--models-dir", help="custom models directory (env FLUX2_MODELS_DIR)")

    p = sub.add_parser("info", help="models / device info")
    p.add_argument("--models-dir", help="custom models directory (env FLUX2_MODELS_DIR)")
    p.add_argument("--beacon", action="store_true", help="write a runtime activity beacon manifest")

    p = sub.add_parser("mask-subject", help="auto-segmentation subject mask")
    p.add_argument("--image", required=True)
    p.add_argument("-o", "--output", default="mask.png")
    p.add_argument("--threshold", type=float, default=0.5)
    p.add_argument("--dilation", type=int, default=8)
    p.add_argument("--ramp", type=int, default=16)
    p.add_argument("--keep-scene", action="store_true", help="mask the subject instead of the scene")
    p.add_argument("--quiet", action="store_true")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu; the CPU only when asked")

    p = sub.add_parser("training-control", help="pause/resume/stop/checkpoint a training run")
    p.add_argument("action", choices=["pause", "resume", "stop", "checkpoint"])
    p.add_argument("--output-dir", required=True)

    sub.add_parser("beacons", help="list/GC runtime activity beacons")
    return parser


def _add_common(p: argparse.ArgumentParser) -> None:
    """The flags of JAX's ``_add_common`` (``:813-876``), given to all six
    generating subcommands as there, and ``--device``. Only ``t2i`` and ``i2i``
    act on ``--checkpoint-every``; ``profile`` and ``evaluate-lora`` ignore
    ``-o``, as JAX's do."""
    p.add_argument("--model", default="klein-4b", choices=[m.value for m in Flux2Model])
    p.add_argument("--quantization", default="bf16", choices=QUANTIZATIONS)
    p.add_argument("--transformer-dir")
    p.add_argument("--vae-dir")
    p.add_argument("--small-decoder", action="store_true", help="distilled VAE decoder (faster)")
    p.add_argument("--random-init", action="store_true", help="random weights (smoke test)")
    p.add_argument(
        "--dequantize-runtime", action="store_true",
        help="load quantized checkpoints but run bf16 (fast); default keeps weights quantized in device memory",
    )
    p.add_argument("--lora", action="append", help="path[:scale], repeatable")
    p.add_argument("--shard", help="mesh spec 'data,fsdp,tp[,sp]' or 'auto' (all ranks on tp); run under torchrun, "
                                   "one process per rank")
    p.add_argument("--context-parallel", action="store_true",
                   help="ring attention over the sp (or tp) axis for long sequences")
    p.add_argument("--dcn", action="store_true",
                   help="multi-slice: --shard's data axis spans contiguous groups of ranks (model collectives stay "
                        "inside each group)")
    p.add_argument("--memory-profile", choices=["auto", "performance", "balanced", "conservative"],
                   help="memory/speed trade-off preset (VAE tiling threshold etc.)")
    p.add_argument("--encoder-dir", help="text-encoder weights dir (default: registry resolution)")
    p.add_argument("--encoder-tokenizer-dir", help="tokenizer dir when separate from weights")
    p.add_argument("--encoder-quantization", default="bf16", choices=ENCODER_QUANTIZATIONS)
    p.add_argument("--no-text-encoder", action="store_true",
                   help="skip encoder load (requires precomputed embeddings via the library API)")
    p.add_argument("--models-dir", help="custom models directory (env FLUX2_MODELS_DIR)")
    p.add_argument("--token", help="HF token for gated models (env HF_TOKEN)")
    p.add_argument("--beacon", action="store_true",
                   help="write a runtime activity beacon manifest (env FLUX2_RUNTIME_BEACON=1)")
    p.add_argument("--prompt", default="")
    p.add_argument("--upsample", action="store_true", help="VLM prompt upsampling (BFL protocol)")
    p.add_argument("--interpret", action="append", metavar="IMAGE",
                   help="VLM-describe this image and inject into the prompt (repeatable)")
    p.add_argument("--width", type=int, default=1024)
    p.add_argument("--height", type=int, default=1024)
    p.add_argument("--steps", type=int)
    p.add_argument("--guidance", type=float)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("-o", "--output", default="output.png")
    p.add_argument("--checkpoint-every", type=int, metavar="N",
                   help="save intermediate images every N denoising steps as <output>_step_NNN.png")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu; the CPU only when asked")


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    return _parser().parse_args(argv)


def _generate(pipe: Flux2Pipeline, args, seed: int, decode: bool = True):
    return pipe.generate(prompt=args.prompt, height=args.height, width=args.width, num_steps=args.steps,
                         guidance=args.guidance, seed=seed, decode=decode)


def _save_png(image, path: str) -> None:
    """Write an image [H, W, 3] in [0, 1] as a PNG, its pixels JAX's
    ``_save_image``'s (``io.png.to_u8``: truncated), and print ``saved <path>``."""
    from flux2_tpu_torch.io.png import encode_png, to_u8

    if not _writes_files():
        return
    with open(path, "wb") as f:
        f.write(encode_png(to_u8(image)))
    print(f"saved {path}")


def _checkpoint_callback(args):
    """``--checkpoint-every N`` -> (N, a callback writing <output stem>_step_NNN.png), else (None, None)."""
    interval = getattr(args, "checkpoint_every", None)
    if not interval:
        return None, None
    stem, _ = os.path.splitext(args.output)
    return interval, lambda step, image: _save_png(image, f"{stem}_step_{step:03d}.png")


def _report(res, path: str) -> None:
    """Write the first image as a PNG and print JAX's ``t2i`` lines: ``saved
    <path>``, then the JSON of seed, steps, duration and phases."""
    _save_png(res.image, path)
    out = {"seed": res.seed, "steps": res.num_steps, "duration_s": round(res.duration_s, 2),
           "phases": {k: round(v, 2) for k, v in res.phase_timings.items()}}
    if res.memory_stats and any(v["peak_gb"] for v in res.memory_stats.values()):
        out["memory_gb"] = {k: v["peak_gb"] for k, v in res.memory_stats.items()}
    print(json.dumps(out))


def cmd_t2i(args) -> None:
    from flux2_tpu_torch.utils.beacon import RuntimeBeacon

    pipe = build_pipeline(args, args.device)
    interval, on_ckpt = _checkpoint_callback(args)
    with RuntimeBeacon("generate", model=args.model) as beacon:
        beacon.update(phase="denoising", total_steps=args.steps or pipe.model.default_steps)
        res = pipe.generate(prompt=args.prompt, height=args.height, width=args.width, num_steps=args.steps,
                            guidance=args.guidance, seed=args.seed, upsample=args.upsample,
                            interpret_images=_interpret_images(args), checkpoint_interval=interval,
                            on_checkpoint=on_ckpt)
    _print_upsampled(res)
    _report(res, args.output)


def _print_upsampled(res) -> None:
    if res.was_upsampled:
        print(f"[upsample] final prompt: {res.final_prompt}")


def _interpret_images(args):
    """The ``--interpret`` images, read, or None."""
    return [_load_image(p) for p in getattr(args, "interpret", None) or []] or None


def _load_image(path: str):
    """Image file -> float32 [H, W, 3] in [0, 1] (``io.png.decode_image``)."""
    from flux2_tpu_torch.io.png import decode_image

    with open(path, "rb") as f:
        return decode_image(f.read())


def cmd_i2i(args) -> None:
    pipe = build_pipeline(args, args.device)
    refs = [_load_image(p) for p in args.reference]
    ref_lat, ref_ids = pipe.encode_reference_images(refs, max_pixels=int(args.max_ref_megapixels * 1024 * 1024))
    init = pipe.encode_image_to_packed_sequence(refs[0]) if args.strength < 1.0 else None
    interval, on_ckpt = _checkpoint_callback(args)
    res = pipe.generate(prompt=args.prompt, height=args.height, width=args.width, num_steps=args.steps,
                        guidance=args.guidance, seed=args.seed, reference_latents=ref_lat, reference_ids=ref_ids,
                        strength=args.strength, init_latents=init, upsample=args.upsample,
                        upsample_images=refs if args.upsample else None,
                        interpret_images=_interpret_images(args), checkpoint_interval=interval,
                        on_checkpoint=on_ckpt)
    _print_upsampled(res)
    _report(res, args.output)


def _load_mask(path: str, alpha: bool):
    """A mask file -> float32 in [0, 1]: RGBA [H, W, 4] with ``alpha``, else
    grey [H, W], as JAX's ``convert("RGBA")`` / ``convert("L")``. Without
    Pillow, PNG only: grey is Pillow's luma (R 19595 + G 38470 + B 7471 +
    0x8000) >> 16, and a PNG without alpha gets alpha 255."""
    import numpy as np

    with open(path, "rb") as f:
        data = f.read()
    try:
        from PIL import Image
    except ImportError:
        from flux2_tpu_torch.io.png import decode_png_pixels

        px = decode_png_pixels(data).astype(np.uint32)
        ch = px.shape[2]
        rgb = px[..., :3] if ch >= 3 else np.repeat(px[..., :1], 3, axis=2)
        if alpha:
            a = px[..., -1:] if ch in (2, 4) else np.full_like(px[..., :1], 255)
            return np.concatenate([rgb, a], axis=2).astype(np.float32) / 255.0
        grey = px[..., 0] if ch <= 2 else (rgb[..., 0] * 19595 + rgb[..., 1] * 38470 + rgb[..., 2] * 7471 + 0x8000) >> 16
        return grey.astype(np.float32) / 255.0
    import io

    with Image.open(io.BytesIO(data)) as im:
        return np.asarray(im.convert("RGBA" if alpha else "L"), np.float32) / 255.0


def cmd_inpaint(args) -> None:
    from flux2_tpu_torch.chains.inpaint import ALPHA_TRANSPARENT_INPAINT, GRAYSCALE_WHITE_INPAINT, MaskedInpaintingChain

    pipe = build_pipeline(args, args.device)
    chain = MaskedInpaintingChain(
        pipeline=pipe,
        prompt=args.prompt,
        image=_load_image(args.image),
        mask=_load_mask(args.mask, args.alpha_mask),
        mask_convention=ALPHA_TRANSPARENT_INPAINT if args.alpha_mask else GRAYSCALE_WHITE_INPAINT,
        steps=args.steps or 4,
        guidance=args.guidance,
        seed=args.seed,
        strength=args.strength,
        mask_crop_padding=args.crop_padding,
        composite_on_original=args.composite,
        use_image_as_reference=args.use_image_as_reference,
        max_pixels=args.max_pixels,
        upsample_prompt=args.upsample_prompt,
        enrich_prompt_with_vlm=_vlm_for_enrichment(pipe, args),
        intent=args.intent,
    )
    _save_png(chain.run().image, args.output)


def _vlm_for_enrichment(pipe: Flux2Pipeline, args) -> bool:
    """``--enrich-prompt-with-vlm``: load the pipeline's VLM through its
    loader before the chain runs (the chain only uses a VLM already loaded);
    with no VLM checkpoint on disk, say so and let the chain fall back.
    Returns the flag."""
    if args.enrich_prompt_with_vlm and pipe.vlm is None and pipe.vlm_loader is not None:
        try:
            pipe._get_vlm()
        except SystemExit as e:
            flog.warning(str(e))
    return args.enrich_prompt_with_vlm


def cmd_outpaint(args) -> None:
    from flux2_tpu_torch.chains.outpaint import OutpaintingChain

    pipe = build_pipeline(args, args.device)
    chain = OutpaintingChain(
        pipeline=pipe,
        image=_load_image(args.image),
        prompt=args.prompt,
        top=args.top,
        bottom=args.bottom,
        left=args.left,
        right=args.right,
        steps=args.steps or 4,
        guidance=args.guidance,
        seed=args.seed,
        max_pixels=args.max_pixels,
        upsample_prompt=args.upsample_prompt,
        enrich_prompt_with_vlm=_vlm_for_enrichment(pipe, args),
    )
    _save_png(chain.run().image, args.output)


def cmd_export_quantized(args) -> None:
    """The checkpoint's DiT in bf16, each ``--lora`` baked in, quantized to
    ``--quantization`` and written atomically beside the checkpoint
    (``io.checkpoints.export_prequantized``), with JAX's printed lines."""
    from flux2_tpu_torch.io import checkpoints, weight_mapping

    model = Flux2Model(args.model)
    tdir = registry.find_model_path(registry.TRANSFORMER_REPOS[model], args.transformer_dir)
    if tdir is None:
        raise SystemExit("transformer weights not found")
    tconfig = _read_config_json(tdir, model.transformer_config)
    transformer = weight_mapping.load_transformer(checkpoints.WeightsDir(tdir), tconfig, torch.device(args.device))
    lora_specs = args.lora or []
    if lora_specs:
        from flux2_tpu_torch.training import lora_loader

        for spec in lora_specs:
            lpath, scale = _lora_spec(spec)
            loaded = lora_loader.load_lora_file(lpath, tconfig, user_scale=scale)
            lora_loader.merge_loras_into_params(transformer, [loaded], tconfig)
            print(f"baked LoRA {lpath} (scale {loaded.scale:.3f})")
    quantize_params(transformer, args.quantization)
    path = checkpoints.export_prequantized(transformer, tdir, args.quantization, source_dir=tdir,
                                           lora_baked=bool(lora_specs))
    size_gb = os.path.getsize(path) / 1e9
    print(f"exported {args.quantization} checkpoint -> {path} ({size_gb:.2f} GB)")


def _profile_once(args, quantization: Optional[str] = None):
    """One profiled configuration: build, warmup, N timed runs -> stats dict."""
    import numpy as np

    prof = profiler()
    prof.enabled = True
    if quantization is not None:
        args.quantization = quantization
    pipe = build_pipeline(args, args.device)
    durations = []
    for run in range(args.warmup + args.runs):
        with prof.phase(f"run {run}"):
            res = _generate(pipe, args, args.seed + run, decode=not args.no_decode)
        if run >= args.warmup:
            durations.append(res.duration_s)
    stats = {
        "runs": len(durations),
        "mean_s": round(float(np.mean(durations)), 3) if durations else None,
        "min_s": round(float(np.min(durations)), 3) if durations else None,
        "max_s": round(float(np.max(durations)), 3) if durations else None,
    }
    return pipe, prof, stats


def cmd_profile(args) -> None:
    os.environ["FLUX2_PROFILE"] = "1"
    if args.compare:
        # same prompt, shape and steps across quantization formats, one table
        rows = []
        for fmt in args.compare.split(","):
            fmt = fmt.strip()
            pipe, prof, stats = _profile_once(args, quantization=fmt)
            rows.append((fmt, stats))
            del pipe  # free device memory before the next config
            gc.collect()
            if torch.cuda.is_available():
                torch.cuda.empty_cache()
        base = rows[0][1]["mean_s"] or 1.0
        print(f"{'config':<10} {'mean_s':>8} {'min_s':>8} {'max_s':>8} {'vs_first':>9}")
        for fmt, s in rows:
            rel = base / s["mean_s"] if s["mean_s"] else float("nan")
            print(f"{fmt:<10} {s['mean_s']:>8} {s['min_s']:>8} {s['max_s']:>8} {rel:>8.2f}x")
        print(json.dumps({fmt: s for fmt, s in rows}))
        return
    pipe, prof, stats = _profile_once(args)
    print(prof.report())
    if stats["runs"]:
        print(json.dumps(stats))
    if args.trace and _writes_files():
        prof.export_chrome_trace(args.trace)
        print(f"chrome trace -> {args.trace} (open in Perfetto)")


def cmd_mask_subject(args) -> None:
    """A subject mask of ``--image`` (the committed U-Net on ``--device``, else
    the saliency heuristic), written as a grey RGB PNG (JAX ``cmd_mask_subject``)."""
    import numpy as np

    from flux2_tpu_torch.chains.subject_mask import default_segmenter, subject_mask

    image = _load_image(args.image)
    model = default_segmenter(args.device)
    mask = subject_mask(image, segmenter=model, threshold=args.threshold, dilation_px=args.dilation,
                        ramp_px=args.ramp, invert_for_change_scene=not args.keep_scene)
    _save_png(np.repeat(mask[..., None], 3, axis=-1), args.output)
    covered = float((mask > 0.5).mean())
    print(json.dumps({
        "mask_coverage": round(covered, 3),
        "convention": "white = regenerate",
        "segmenter": "unet" if model is not None else "saliency-heuristic",
    }))
    if model is None and not args.quiet:
        print(
            "note: trained segmenter weights missing — falling back to the "
            "saliency heuristic (busy backgrounds degrade it); pass a model "
            "via chains.subject_mask.subject_mask(segmenter=...)"
        )


def cmd_evaluate_lora(args) -> None:
    """LoRA training-need gap analysis (JAX ``cmd_evaluate_lora``, ``:544-595``):
    read the dataset's captions, generate a baseline image per sample with
    the base model, score it against the dataset image (the VLM scorer when
    one is loaded, else ``_pixel_scorer``), and print JAX's per-sample lines
    and the JSON recommendation of ``evaluate_training_need``. Under
    ``--random-init`` the random encoder embeds each caption, as ``t2i``'s
    does (JAX embeds ``hash(prompt)``)."""
    from flux2_tpu_torch.training.data import load_dataset
    from flux2_tpu_torch.training.validation import evaluate_training_need

    entries = load_dataset(args.dataset)
    if not entries:
        raise SystemExit(f"no (image, caption) pairs found under {args.dataset}")
    entries = entries[: args.max_samples]

    pipe = build_pipeline(args, args.device)
    scorer = _vlm_scorer(pipe) if not args.no_vlm else None

    baseline_scores = []
    os.makedirs(args.output_dir, exist_ok=True)
    for i, entry in enumerate(entries):
        ref_img = _load_image(entry.image_path)
        res = pipe.generate(prompt=entry.caption, height=args.height, width=args.width, num_steps=args.steps,
                            seed=args.seed + i)
        _save_png(res.image, os.path.join(args.output_dir, f"baseline_{i:03d}.png"))
        if scorer is not None:
            scene, style = scorer(res.image, [ref_img], entry.caption)
        else:
            scene, style = _pixel_scorer(res.image, ref_img)
        baseline_scores.append((scene, style))
        print(f"[{i+1}/{len(entries)}] scene={scene:.1f} style={style:.1f}  {entry.caption[:60]}")

    gap = evaluate_training_need(baseline_scores)
    print(json.dumps({
        "scene_score": round(gap.scene_score, 2),
        "style_score": round(gap.style_score, 2),
        "recommended_rank": gap.recommended_rank,
        "recommended_steps": gap.recommended_steps,
        "recommended_timestep_sampling": gap.recommended_timestep_sampling,
        "recommended_alpha": gap.recommended_alpha,
        "recommended_learning_rate": gap.recommended_learning_rate,
        "recommended_warmup_steps": gap.recommended_warmup_steps,
        "recommended_loss_weighting": gap.recommended_loss_weighting,
        "recommended_target_layers": gap.recommended_target_layers,
        "notes": gap.notes,
    }))


def _vlm_scorer(pipe):
    """The VLM scene/style scorer when a scoring service is reachable (the
    pipeline's ``vlm_service``, else what its ``vlm_loader`` loads; a loader
    that finds no checkpoint exits, which gives None), else None: the caller
    falls back to the pixel scorer (JAX's, ``:598-607``)."""
    service = getattr(pipe, "vlm_service", None)
    if service is None and getattr(pipe, "vlm_loader", None) is not None:
        try:
            service = pipe.vlm_loader()
        except SystemExit:
            return None
    if service is None or not hasattr(service, "score_validation_image"):
        return None
    return service.score_validation_image


def _pixel_scorer(image, reference):
    """Headless fallback scorer: luminance-histogram + color-moment
    similarity mapped to the 0-10 scene/style axes (JAX's, over the port's
    copy of ``utils/quality.py``)."""
    from flux2_tpu_torch.utils.quality import color_moment_similarity, histogram_similarity

    scene = 10.0 * histogram_similarity(image, reference)
    style = 10.0 * color_moment_similarity(image, reference)
    return float(scene), float(style)


def cmd_download(args) -> None:
    """The transformer (its ``--quantization`` variant where one is published),
    the VAE and the model's text encoder, through ``registry.download``."""
    model = Flux2Model(args.model)
    fmt = getattr(args, "quantization", "bf16") or "bf16"
    spec, on_the_fly = registry.variant_for_quantization(model, fmt)
    if on_the_fly:
        print(f"no pre-quantized {fmt} repo for {model.value}; downloading bf16 (quantize on load)")
    print(f"downloading {spec.repo_id} (~{spec.approx_size_gb} GB, gated={spec.gated})")
    path = registry.download(spec, token=args.token)
    print(f"transformer -> {path}")
    vpath = registry.download(registry.VAE_REPO, token=args.token)
    print(f"vae -> {vpath}")
    enc = registry.TEXT_ENCODER_REPOS[registry.ENCODER_FOR_MODEL[model]]
    epath = registry.download(enc, token=args.token)
    print(f"text encoder -> {epath}")


def _backend_line() -> str:
    """``cuda, devices: N`` where torch sees a CUDA device, else ``cpu, devices: 1``."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    return f"cuda, devices: {n}" if n else "cpu, devices: 1"


def cmd_info(args) -> None:
    """The backend, the models dir and one line per model (JAX ``cmd_info``).
    The device probe runs under a 20 s watchdog, as JAX's, so ``info`` answers
    even when the driver hangs."""
    import threading

    probe: dict = {}

    def _probe():
        try:
            probe["msg"] = _backend_line()
        except Exception as e:
            probe["msg"] = f"unavailable ({e})"

    t = threading.Thread(target=_probe, daemon=True)
    t.start()
    t.join(20.0)
    print(f"flux2-tpu — backend: {probe.get('msg', 'unavailable (init timed out — tunnel down?)')}")
    print(f"models dir: {registry.models_dir()}")
    for model in Flux2Model:
        spec = registry.TRANSFORMER_REPOS[model]
        found = registry.find_model_path(spec)
        cfg = model.transformer_config
        print(
            f"  {model.value:<16} {cfg.num_layers}+{cfg.num_single_layers} blocks, "
            f"D={cfg.inner_dim:<5} steps={model.default_steps:<3} "
            f"guidance={model.default_guidance:<4} "
            f"{'[downloaded]' if found else '[not downloaded]'}"
            f"{' [gated]' if spec.gated else ''}"
        )


def cmd_training_control(args) -> None:
    """Write (or, for ``resume``, clear the pause of) a training run's sentinel file."""
    from flux2_tpu_torch.training.control import TrainingController

    if args.action == "resume":
        TrainingController.clear_sentinel(args.output_dir, "pause")
        print("cleared pause sentinel")
    else:
        path = TrainingController.write_sentinel(args.output_dir, args.action)
        print(f"wrote {path}")


def cmd_beacons(args) -> None:
    """Remove the manifests of dead processes and list the live ones."""
    from flux2_tpu_torch.utils import beacon

    removed = beacon.gc_stale_manifests()
    active = beacon.list_active()
    print(f"gc removed {removed} stale manifest(s); {len(active)} active:")
    for m in active:
        print(f"  pid {m.get('pid')} {m.get('task')} {m.get('model')} {m.get('phase')} "
              f"step {m.get('step')}/{m.get('total_steps')}")


COMMANDS = {"t2i": cmd_t2i, "i2i": cmd_i2i, "inpaint": cmd_inpaint, "outpaint": cmd_outpaint,
            "profile": cmd_profile, "export-quantized": cmd_export_quantized, "download": cmd_download,
            "info": cmd_info, "mask-subject": cmd_mask_subject, "evaluate-lora": cmd_evaluate_lora,
            "training-control": cmd_training_control, "beacons": cmd_beacons}


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = parse_args(argv)
    # the flags' environment counterparts (JAX's main): a set flag wins over the environment
    if getattr(args, "models_dir", None):
        os.environ["FLUX2_MODELS_DIR"] = args.models_dir
    if getattr(args, "token", None):
        os.environ["HF_TOKEN"] = args.token
    if getattr(args, "beacon", False):
        os.environ["FLUX2_RUNTIME_BEACON"] = "1"
    import torch.distributed as dist

    # a group that this command starts (a sharded run) ends with it; a caller's own group is left
    own_group = not dist.is_initialized()
    stdout = sys.stdout
    with contextlib.ExitStack() as stack:
        if not _writes_files():  # the other ranks of a torchrun run: rank 0 prints the results
            sys.stdout = stack.enter_context(open(os.devnull, "w"))
        try:
            if args.command == "train-lora":
                from flux2_tpu_torch.cli.train import run_training

                run_training(args, args.device)
            else:
                COMMANDS[args.command](args)
        finally:
            sys.stdout = stdout
            if own_group and dist.is_initialized():
                dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
