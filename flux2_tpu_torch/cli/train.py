"""``train-lora``: LoRA training of the FLUX.2 DiT, on a dataset or on synthetic data.

Port of ``flux2_tpu/cli/train.py`` (``run_training`` :608,
``_prepare_real_data`` :323, ``_build_random_pipeline`` :553,
``_prepare_synthetic_data`` :499, ``_make_scorer`` :1109, ``_save`` :1130).
The training variant of the YAML's model (klein-4b -> klein-4b-base) trains;
its base comes from one of three branches:

- checkpoint directories (``--transformer-dir``, ``--vae-dir``,
  ``--encoder-dir``, ``--encoder-tokenizer-dir``, else the registry) through
  ``cli.main.build_pipeline``, the DiT quantized to ``--quantization``
  (QLoRA: the base projections run their kernels, ``ops.quant.KernelLinear``)
  and the encoder to ``--encoder-quantization`` or the YAML's
  ``model.quantization``; this branch needs a dataset, as JAX's;
- ``--random-init`` with an existing dataset directory: a random bf16
  pipeline with a random W8A8 Qwen3 encoder at the family's conditioning
  shape and the dev tokenizer, on the real data path;
- ``--random-init`` alone: a random bf16 DiT on synthetic tensors.

The data path (``_prepare_real_data``): aspect-ratio buckets, control
images, VAE latents through ``training/data.py``'s ``LatentCache`` (JAX's
file names, so one cache serves both packages) or in memory, caption
embeddings with a disk cache keyed as JAX's, the "" embedding for caption
dropout, DOP preservation captions, and ``sample_batch`` making JAX's
``RandomState`` draws in JAX's order. The loop: per-step draws, epochs,
``dop_every_n_steps``, EMA, JAX's log line, checkpoints in JAX's files
(optimizer state included), pruning, the learning-curve SVG, the loss
plateau stop, the ``TrainingController`` sentinels, ``--resume`` of either
package's checkpoints, a ``RuntimeBeacon``; validation previews
(``training/validation.py``: the distilled sibling when its weights are on
disk, else the training base, with the LoRA or its EMA merged into a copy so
the training base is never touched), the pixel scorer until a VLM is ported,
``best/``, the tracker's early stops; and the held-out loss on
``validation_path`` with its overfit-gap and stagnation stops.

Pipeline parallelism (the YAML's ``pp``, ``pp_tp``, ``pp_microbatches``,
``pp_over_dcn``; ``parallel/pipeline.py``) runs one process per rank under
torchrun, with JAX's checks and messages: the stage knobs without ``pp > 1``
exit before any build; after the base is built, ``pp`` with ``--shard``,
stacks, ranks, heads and the batch split; then each rank keeps its stage's
blocks (``place_stages``) and the step, the held-out loss and the previews
run through the pipeline. ``--shard`` in the checkpoint branch trains on the
sharded DiT (``Flux2Pipeline.shard``); the random-init branches ignore it,
as JAX's do. Under torchrun every rank draws the same batches, and rank 0
alone writes checkpoints, images and the log; it reads the control
sentinels and the stop decisions are its own.

JAX's random-init base is f32; the port's is bf16, as the checkpoint branch
trains and as the kernels take it. Refused with ``SystemExit``:
``--quantization`` with ``--random-init`` (a recorded difference: JAX's
random-init base ignores the flag). ``lora.dropout`` warns and trains
without it, as JAX does.
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import os
import shutil
import time
from typing import List, Optional

import numpy as np
import torch
import torch.distributed as dist

from flux2_tpu_torch.models.flux2.config import Flux2TransformerConfig


def _refuse_unsupported(cfg, args: argparse.Namespace) -> None:
    """SystemExit for ``--quantization`` with ``--random-init`` (a recorded
    difference), and JAX's for the pipeline-stage knobs without ``pp > 1``
    (checked before any build, as JAX does)."""
    if cfg.pp <= 1 and (cfg.pp_tp > 1 or cfg.pp_microbatches or cfg.pp_over_dcn):
        raise SystemExit("pp_tp/pp_microbatches/pp_over_dcn only take effect with pp > 1 — set pp: N in the YAML "
                         "(for tensor parallelism without pipeline stages use --shard instead)")
    if getattr(args, "random_init", False) and (getattr(args, "quantization", None) or "bf16") != "bf16":
        raise SystemExit(f"train-lora in flux2_tpu_torch: --quantization {args.quantization} with --random-init is "
                         "refused (a recorded difference: JAX's random-init base ignores the flag and trains an "
                         "unquantized base; QLoRA quantizes a base read from checkpoints)")


def resolve_encoder_quantization(flag_value, yaml_value) -> str:
    """model.quantization in the YAML is TEXT-ENCODER quantization only
    (TrainingConfigYAML.swift:33-35); an explicit CLI flag wins (the
    train-lora flag defaults to None exactly so the YAML applies).
    Reference spellings int8/qint8 map to the weight-only qint8 runtime."""
    if flag_value:
        return flag_value
    return {
        "int8": "qint8", "qint8": "qint8", "int4": "int4", "nf4": "nf4",
        "bf16": "bf16", "w8a8": "w8a8", "w4a8": "w4a8", "mxfp8": "mxfp8",
    }.get((yaml_value or "bf16").lower(), "bf16")


def _build_random_pipeline(train_model, device: torch.device, transformer_config: Optional[Flux2TransformerConfig] = None,
                           vae_config=None):
    """Random-init pipeline WITH a working text encoder for checkpoint-free
    real-data runs (``--random-init`` + an existing dataset.path), JAX's
    ``_build_random_pipeline``: the encoder is random at the model family's
    conditioning shape (klein-4b -> Qwen3-4B [9,18,27] concat 7680, klein-9b
    -> Qwen3-8B; a config of another joint width gets a 3-layer decoder at
    hidden = joint/3 reading layers (1, 2, 3)), drawn first from seed 7 and
    quantized to W8A8 before the DiT and VAE are drawn (seed 0); tokenization
    runs the dev tokenizer's BPE and chat template. The Dev model (Mistral
    encoder) exits, as in JAX."""
    from flux2_tpu_torch.models.text_encoders import config as tenc_cfg
    from flux2_tpu_torch.models.text_encoders.decoder import Qwen3Decoder
    from flux2_tpu_torch.models.text_encoders.extractor import EmbeddingExtractor, quantize_encoder_params
    from flux2_tpu_torch.pipeline.pipeline import Flux2Pipeline
    from flux2_tpu_torch.utils import inline_bpe_tokenizer

    tconfig = transformer_config or train_model.transformer_config
    joint = tconfig.joint_attention_dim
    by_dim = {3 * tenc_cfg.QWEN3_4B.hidden_size: tenc_cfg.QWEN3_4B, 3 * tenc_cfg.QWEN3_8B.hidden_size: tenc_cfg.QWEN3_8B}
    if joint == 3 * tenc_cfg.MISTRAL_SMALL_3_2.hidden_size:
        raise SystemExit("random-init real-data training for dev needs the Mistral-24B encoder resident (multi-chip "
                         "mesh); use a klein model for single-chip checkpoint-free runs")
    if joint in by_dim:
        enc_cfg, layers = by_dim[joint], tenc_cfg.QWEN3_HIDDEN_LAYERS
    else:
        if joint % 3:
            raise SystemExit(f"joint_attention_dim {joint} is not 3*hidden")
        enc_cfg = tenc_cfg.DecoderConfig(vocab_size=512, hidden_size=joint // 3, intermediate_size=2 * joint // 3,
                                         num_hidden_layers=3, num_attention_heads=2, num_key_value_heads=1,
                                         head_dim=64, qk_norm=True)
        layers = (1, 2, 3)
    decoder = Qwen3Decoder(enc_cfg, device=device, generator=torch.Generator(device).manual_seed(7))
    extractor = EmbeddingExtractor(quantize_encoder_params(decoder, "w8a8"), inline_bpe_tokenizer(), tuple(layers))
    pipe = Flux2Pipeline.from_random(train_model, device=device, transformer_config=tconfig, vae_config=vae_config)
    pipe.text_encoder = extractor
    return pipe


def _prepare_real_data(pipe, cfg, tconfig: Flux2TransformerConfig):
    """VAE-encode the dataset and encode its captions through ``pipe`` (JAX's
    ``_prepare_real_data``); both stay on the host, as JAX's do, and a batch
    goes to the pipeline's device when drawn. Returns (sample_batch(rng, bs)
    -> batch dict, items): latents [B, S, 128] and embeddings [B, S_txt,
    joint] float32, optional control / dop_embeddings / guidance, and the
    RoPE of [txt ; img (; control on reference ids, T=10)]."""
    from flux2_tpu_torch.ops import latents as lu
    from flux2_tpu_torch.ops.rope import rope_embeddings
    from flux2_tpu_torch.training import data as td
    from flux2_tpu_torch.utils import logging as flog

    device = pipe.device
    resolutions = [int(r) for r in (cfg.bucket_resolutions or [cfg.resolution])]
    buckets = []
    for r in resolutions:
        for b in td.scaled_buckets(r):
            if b not in buckets:
                buckets.append(b)
    buckets = tuple(buckets)
    if len(resolutions) > 1:
        flog.info(f"multi-resolution bucketing: {resolutions} -> {len(buckets)} buckets")
    items = td.load_dataset(cfg.dataset_dir, trigger=cfg.trigger_word, control_dir=cfg.control_dir, buckets=buckets)
    if not items:
        raise SystemExit(f"no (image, caption) pairs found under {cfg.dataset_dir}")
    if cfg.control_dir:
        paired = [it for it in items if it.control_path]
        if len(paired) < len(items):
            flog.warning(f"{len(items) - len(paired)} item(s) have no control image; "
                         f"training I2I on the {len(paired)} paired item(s)")
        items = paired
        if not items:
            raise SystemExit(f"control_dir {cfg.control_dir} matches no dataset images")
    flog.info(f"dataset: {len(items)} items in {len(td.group_by_bucket(items))} buckets")

    # VAE latents through the disk cache; memory.cache_latents=false keeps them in memory only
    cache = td.LatentCache(cfg.cache_dir or os.path.join(cfg.output_dir, "latent_cache"),
                           encoder_version="flux2-vae32-v1")

    def encode(image):
        return pipe.encode_image_to_packed_sequence(image).cpu().numpy()

    def encode_item(it):
        if cfg.cache_latents:
            return cache.get_or_encode(it, encode)
        w, h = it.bucket
        return encode(td.load_image(it.image_path, w, h))

    latents = {it.image_path: np.asarray(encode_item(it), np.float32)[0] for it in items}
    flog.info(f"encoded {len(latents)} latents"
              + (f" -> {cache.cache_dir}" if cfg.cache_latents else " (in-memory, cache_latents: false)"))

    # captions (and DOP preservation captions) through the text encoder
    if pipe.text_encoder is None:
        raise SystemExit("training needs the text encoder (it encodes captions)")
    emb_cache = {}
    emb_dir = None
    if cfg.cache_text_embeddings:
        emb_dir = os.path.join(cfg.cache_dir or os.path.join(cfg.output_dir, "latent_cache"), "text_embeddings")
        os.makedirs(emb_dir, exist_ok=True)

    def embed(caption: str) -> np.ndarray:
        if caption not in emb_cache:
            path = None
            if emb_dir is not None:
                # JAX's key: quantization and recipe change the values at the same shape
                recipe = getattr(pipe.text_encoder, "recipe", "mistral")
                tag = f"{pipe.text_encoder_name or 'enc'}|{recipe}|{pipe.text_encoder_quantization}|{caption}"
                path = os.path.join(emb_dir, hashlib.sha256(tag.encode()).hexdigest()[:24] + ".npy")
                if os.path.exists(path):
                    emb_cache[caption] = np.load(path)
                    return emb_cache[caption]
            emb_cache[caption] = pipe.encode_prompt(caption).float().cpu().numpy()[0]
            if path is not None:
                np.save(path, emb_cache[caption])
        return emb_cache[caption]

    for it in items:
        embed(it.caption)
    if cfg.caption_dropout > 0:
        embed("")  # unconditional embedding for caption dropout
    dop_caps = {}
    if cfg.dop_weight > 0 and cfg.trigger_word:
        # DOP preservation caption: trigger -> class swap (SimpleLoRATrainer.swift:524-605)
        for it in items:
            dop_caps[it.image_path] = it.caption.replace(cfg.trigger_word, cfg.dop_preservation_class)
            embed(dop_caps[it.image_path])
    flog.info(f"encoded {len(emb_cache)} caption embedding(s)")

    # I2I control images: clean latents at the item's bucket dims
    control = {}
    if cfg.control_dir:
        for it in items:
            citem = td.DatasetItem(image_path=it.control_path, caption="", bucket=it.bucket)
            control[it.image_path] = np.asarray(encode_item(citem), np.float32)[0]

    s_txt = next(iter(emb_cache.values())).shape[0]
    rope_cache = {}

    def rope_for(bucket, with_control):
        k = (bucket, with_control)
        if k not in rope_cache:
            w, h = bucket
            ids = [lu.text_position_ids(s_txt), lu.image_position_ids(h, w)]
            if with_control:  # control tokens ride reference-image position ids (T=10)
                ids.append(lu.reference_image_position_ids([h // 16], [w // 16]))
            rope_cache[k] = rope_embeddings(torch.from_numpy(np.concatenate(ids, axis=0)).to(device))
        return rope_cache[k]

    grouped = td.group_by_bucket(items)
    bucket_list = list(grouped.keys())
    weights = np.asarray([len(grouped[b]) for b in bucket_list], np.float64)
    weights /= weights.sum()

    def stack(arrays) -> torch.Tensor:
        return torch.from_numpy(np.stack(arrays)).to(device)

    def sample_batch(rng: np.random.RandomState, bs: int) -> dict:
        b = bucket_list[rng.choice(len(bucket_list), p=weights)]
        group = grouped[b]
        chosen = [group[i] for i in rng.randint(0, len(group), size=bs)]
        # caption dropout: train some samples on the empty caption (LoRATrainingConfig.swift:246)
        caps = ["" if cfg.caption_dropout > 0 and rng.uniform() < cfg.caption_dropout else it.caption
                for it in chosen]
        batch = {"latents": stack([latents[it.image_path] for it in chosen]),
                 "embeddings": stack([embed(c) for c in caps])}
        use_control = bool(control) and rng.uniform() >= cfg.control_dropout
        if use_control:
            batch["control"] = stack([control[it.image_path] for it in chosen])
        if dop_caps:
            batch["dop_embeddings"] = stack([embed(dop_caps[it.image_path]) for it in chosen])
        if tconfig.guidance_embeds:
            batch["guidance"] = torch.ones(bs, device=device)
        batch["rope_cos"], batch["rope_sin"] = rope_for(b, use_control)
        return batch

    return sample_batch, items


def _prepare_synthetic_data(cfg, tconfig: Flux2TransformerConfig, device: torch.device):
    """Synthetic latents [4, S_img, 128] and embeddings [4, 32, joint] (f32,
    drawn on ``device`` from seeds 1 and 2), the RoPE of the [txt ; img] ids,
    and sample_batch(rng, bs) picking rows with ``rng.randint`` as JAX does."""
    from flux2_tpu_torch.ops import latents as lu
    from flux2_tpu_torch.ops.rope import rope_embeddings

    h = w = cfg.resolution
    s_img = (h // 16) * (w // 16)
    s_txt = 32
    latents = torch.randn(4, s_img, 128, device=device, generator=torch.Generator(device).manual_seed(1))
    embeddings = torch.randn(4, s_txt, tconfig.joint_attention_dim, device=device,
                             generator=torch.Generator(device).manual_seed(2))
    ids = np.concatenate([lu.text_position_ids(s_txt), lu.image_position_ids(h, w)], axis=0)
    cos, sin = rope_embeddings(torch.from_numpy(ids).to(device))

    def sample_batch(rng: np.random.RandomState, bs: int) -> dict:
        idx = torch.from_numpy(rng.randint(0, latents.shape[0], size=bs)).to(device)
        batch = {"latents": latents[idx], "embeddings": embeddings[idx], "rope_cos": cos, "rope_sin": sin}
        if tconfig.guidance_embeds:
            batch["guidance"] = torch.ones(bs, device=device)
        return batch

    return sample_batch


def _train_config(cfg):
    from flux2_tpu_torch.training.trainer import TrainConfig

    return TrainConfig(
        rank=cfg.rank, alpha=cfg.alpha, target_layers=cfg.target_layers, learning_rate=cfg.learning_rate,
        weight_decay=cfg.weight_decay, max_grad_norm=cfg.max_grad_norm, optimizer=cfg.optimizer,
        warmup_steps=cfg.warmup_steps, lr_scheduler=cfg.lr_scheduler, lr_num_cycles=cfg.lr_num_cycles,
        total_steps=cfg.max_steps, timestep_sampling=cfg.timestep_sampling,
        logit_normal_mean=cfg.logit_normal_mean, logit_normal_std=cfg.logit_normal_std, flux_shift=cfg.flux_shift,
        loss_weighting=("bell" if cfg.loss_weighting in ("bell", "bellShaped", "bell_shaped", "weighted")
                        else "snr" if cfg.loss_weighting == "snr" else "none"),
        snr_gamma=cfg.snr_gamma, grad_accumulation=cfg.grad_accumulation, dop_weight=cfg.dop_weight,
        use_ema=cfg.use_ema, ema_decay=cfg.ema_decay, remat=cfg.remat, seed=cfg.seed,
    )


def _save(cfg, tstate, state, tcfg) -> str:
    """checkpoint_{step:06d}/ with the training state's fields in training_state.json, then prune
    (rank 0 alone writes)."""
    from flux2_tpu_torch.cli.main import _writes_files
    from flux2_tpu_torch.cli.train_config import prune_checkpoints
    from flux2_tpu_torch.training import trainer

    path = os.path.join(cfg.output_dir, f"checkpoint_{tstate.step:06d}")
    state.step = tstate.step
    if not _writes_files():
        return path
    trainer.save_checkpoint(path, state, tcfg, extra=dataclasses.asdict(tstate))
    print(f"checkpoint -> {path}", flush=True)
    prune_checkpoints(cfg, keep=path)
    return path


def _make_scorer(pipe):
    """VLM scene/style scorer when available, else the pixel-stat fallback
    averaged over the reference set (LoRAEvaluator.swift scoring)."""
    from flux2_tpu_torch.cli.main import _pixel_scorer, _vlm_scorer

    vlm = _vlm_scorer(pipe)
    if vlm is not None:
        return vlm

    def scorer(image, refs, prompt):
        if not len(refs):
            return 0.0, 0.0
        pairs = [_pixel_scorer(image, r) for r in refs]
        return float(np.mean([p[0] for p in pairs])), float(np.mean([p[1] for p in pairs]))

    return scorer


def _world() -> int:
    """The number of ranks of this run (1 without a process group)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def _agree(value):
    """Rank 0's ``value`` on every rank of a multi-rank run: the control
    sentinels and the early stops are decided once, so no rank leaves the
    loop alone."""
    if _world() == 1:
        return value
    box = [value]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def _rank0_first(fn):
    """``fn()`` on rank 0, then on the other ranks: the latent and caption
    caches are written once, then read."""
    from flux2_tpu_torch.cli.main import _writes_files

    if _world() > 1 and not _writes_files():
        dist.barrier()
    out = fn()
    if _world() > 1 and _writes_files():
        dist.barrier()
    return out


def _pipeline_parallel(cfg, tconfig, transformer, args):
    """JAX's pp branch (``:679-747``): its checks and messages in its order,
    then the (data, pp[, tp]) mesh over the run's ranks, this rank's stage
    placed (``place_stages``) and the pipelined forward. Returns (mesh, forward)."""
    from flux2_tpu_torch.parallel import pipeline as pp_mod
    from flux2_tpu_torch.utils import logging as flog

    if getattr(args, "shard", None):
        raise SystemExit("pp and --shard are mutually exclusive (pp builds its own mesh)")
    if tconfig.num_layers % cfg.pp or tconfig.num_single_layers % cfg.pp:
        raise SystemExit(
            f"pp={cfg.pp} must divide both block stacks of {cfg.model} "
            f"({tconfig.num_layers} double, {tconfig.num_single_layers} single): "
            f"klein-4b (5/20) supports pp=5; klein-9b (8/24) and dev (8/48) pp=2/4/8")
    n_dev = _world()
    tp = max(1, cfg.pp_tp)
    if n_dev % (cfg.pp * tp):
        raise SystemExit(f"pp*pp_tp={cfg.pp}*{tp} does not divide {n_dev} devices")
    if tconfig.num_attention_heads % tp:
        raise SystemExit(f"pp_tp={tp} must divide the attention head count "
                         f"({tconfig.num_attention_heads} for {cfg.model})")
    m_micro = cfg.pp_microbatches or cfg.pp
    data_ax = n_dev // (cfg.pp * tp)
    if cfg.batch_size % m_micro or (cfg.batch_size // m_micro) % data_ax:
        raise SystemExit(
            f"batch_size {cfg.batch_size} must split into {m_micro} microbatches "
            f"each divisible by the data axis {data_ax} (pp={cfg.pp}, tp={tp}, "
            f"{n_dev} devices)")
    device_type = next(t for t in transformer.parameters()).device.type
    mesh = pp_mod.make_pp_mesh(pp=cfg.pp, data=data_ax, tp=tp, pp_over_dcn=cfg.pp_over_dcn, device_type=device_type)
    pp_mod.place_stages(transformer, mesh)
    from flux2_tpu_torch.parallel.mesh import mesh_shape

    flog.info(f"pipeline parallelism: mesh {mesh_shape(mesh)}, {m_micro} microbatches "
              f"(bubble {(cfg.pp - 1) / (m_micro + cfg.pp - 1):.0%})" + (f", tp={tp} inside each stage" if tp > 1 else ""))
    return mesh, pp_mod.make_pp_forward(mesh, cfg.pp_microbatches or None)


def _checkpoint_pipeline(args, cfg, train_model, device: torch.device):
    """JAX's checkpoint branch: ``cli.main.build_pipeline`` for the training
    variant, the DiT quantized to ``--quantization`` (QLoRA) and sharded by
    ``--shard`` (with ``--dcn`` as ``build_pipeline`` reads it)."""
    from flux2_tpu_torch.cli.main import build_pipeline

    build_args = argparse.Namespace(
        model=train_model.value, quantization=getattr(args, "quantization", "bf16") or "bf16",
        transformer_dir=getattr(args, "transformer_dir", None), vae_dir=getattr(args, "vae_dir", None),
        small_decoder=False, random_init=False, encoder_dir=getattr(args, "encoder_dir", None),
        encoder_tokenizer_dir=getattr(args, "encoder_tokenizer_dir", None),
        encoder_quantization=resolve_encoder_quantization(getattr(args, "encoder_quantization", None),
                                                          cfg.encoder_quantization),
        no_text_encoder=False, lora=[], memory_profile=None, dequantize_runtime=False,
        shard=getattr(args, "shard", None), dcn=getattr(args, "dcn", False))
    return build_pipeline(build_args, device)


def _validation_base(pipe, train_model, device: torch.device):
    """(model, DiT) the previews run: the distilled sibling's bf16 weights and
    ``config.json`` when they are on disk, else the training base (JAX's
    warning). Either is only ever copied, never merged into."""
    from flux2_tpu_torch.cli.main import _read_config_json
    from flux2_tpu_torch.io import checkpoints, registry, weight_mapping
    from flux2_tpu_torch.utils import logging as flog

    sib = registry.distilled_sibling(train_model)
    if sib != train_model:
        sdir = registry.find_model_path(registry.TRANSFORMER_REPOS[sib])
        if sdir is not None:
            sconfig = _read_config_json(sdir, sib.transformer_config)
            transformer = weight_mapping.load_transformer(checkpoints.WeightsDir(sdir), sconfig, device)
            flog.info(f"validation previews use the distilled sibling {sib.value}")
            return sib, transformer
        flog.warning(f"distilled sibling {sib.value} weights not found; validating with the training base variant")
    return train_model, pipe.transformer


def run_training(
    args: argparse.Namespace,
    device: "torch.device | str",
    transformer_config: Optional[Flux2TransformerConfig] = None,
    vae_config=None,
) -> List[dict]:
    """Train as ``flux2 train-lora`` does, on ``device``; returns one dict per
    step run here (step, loss, dop_loss, grad_norm, lr, seconds).
    ``transformer_config`` / ``vae_config`` replace the random-init branches'
    (tests run tiny ones). Under torchrun the ranks other than 0 log warnings
    only; a process group this call starts ends with it."""
    from flux2_tpu_torch.cli.main import _writes_files
    from flux2_tpu_torch.utils import logging as flog

    own_group = not dist.is_initialized()
    level = flog._level
    if not _writes_files():
        flog.set_level("warning")
    try:
        return _run_training(args, device, transformer_config, vae_config)
    finally:
        flog._level = level
        if own_group and dist.is_initialized():
            dist.destroy_process_group()


def _run_training(args, device, transformer_config, vae_config) -> List[dict]:
    from flux2_tpu_torch.cli.main import _writes_files
    from flux2_tpu_torch.cli.train_config import YAMLTrainingConfig, write_learning_curve_svg
    from flux2_tpu_torch.io.registry import training_variant
    from flux2_tpu_torch.models.flux2.config import Flux2Model
    from flux2_tpu_torch.models.flux2.transformer import Flux2Transformer
    from flux2_tpu_torch.parallel import pipeline as pp_mod
    from flux2_tpu_torch.pipeline.pipeline import Flux2Pipeline
    from flux2_tpu_torch.training import data as td
    from flux2_tpu_torch.training import lora as lora_mod
    from flux2_tpu_torch.training import trainer
    from flux2_tpu_torch.training.control import TrainingController, TrainingState, config_hash
    from flux2_tpu_torch.training.validation import ValidationConfig, ValidationTracker, run_validation
    from flux2_tpu_torch.utils import logging as flog
    from flux2_tpu_torch.utils.beacon import RuntimeBeacon

    cfg = YAMLTrainingConfig.from_yaml(args.config).override(
        output_dir=args.output_dir, max_steps=args.max_steps, dataset_dir=getattr(args, "dataset_dir", None))
    _refuse_unsupported(cfg, args)
    requested = Flux2Model(cfg.model)
    train_model = training_variant(requested)
    if train_model != requested:
        flog.info(f"resolved training variant: {requested.value} -> {train_model.value}")
    os.makedirs(cfg.output_dir, exist_ok=True)

    # --- base model ---
    device = torch.device(device)
    if cfg.pp > 1 or (getattr(args, "shard", None) and not getattr(args, "random_init", False)):
        # one process per rank under torchrun, each on its own card (cuda:LOCAL_RANK)
        from flux2_tpu_torch.parallel.mesh import ensure_process_group

        ensure_process_group(device.type)
        if device.type == "cuda":
            device = torch.device("cuda", torch.cuda.current_device())
    has_dataset = bool(cfg.dataset_dir and os.path.isdir(cfg.dataset_dir))
    pipe = None
    if getattr(args, "random_init", False):
        if has_dataset:
            pipe = _build_random_pipeline(train_model, device, transformer_config, vae_config)
            flog.warning("random-init weights + real dataset: full data path, untrained outputs "
                         "(checkpoint-free e2e mode)")
            transformer = pipe.transformer
        else:
            if getattr(args, "encoder_quantization", None) or cfg.encoder_quantization:
                flog.warning("encoder quantization has no effect here: synthetic data needs no text encoder")
            if cfg.dop_weight > 0:
                flog.warning("dop_weight > 0 has no effect here: synthetic batches carry no preservation captions")
            transformer = Flux2Transformer(transformer_config or train_model.transformer_config, device=device,
                                           dtype=torch.bfloat16, generator=torch.Generator(device).manual_seed(0))
            flog.warning("training against random-init base (smoke test): synthetic tensors")
    else:
        pipe = _checkpoint_pipeline(args, cfg, train_model, device)
        transformer = pipe.transformer
    tconfig = transformer.config

    # --- pipeline parallelism (GPipe stages over the DiT's block stacks) ---
    pp_mesh = pp_forward = None
    if cfg.pp > 1:
        pp_mesh, pp_forward = _pipeline_parallel(cfg, tconfig, transformer, args)

    # --- data ---
    if pipe is not None:
        if not has_dataset:
            raise SystemExit("train-lora needs dataset_dir (images + .txt captions or manifest.jsonl); "
                             "use --random-init for a checkpoint-free smoke run")
        sample_batch, items = _rank0_first(lambda: _prepare_real_data(pipe, cfg, tconfig))
    else:
        sample_batch, items = _prepare_synthetic_data(cfg, tconfig, device), []
    if cfg.epochs > 0 and items and getattr(args, "max_steps", None) is None:
        # epochs -> steps given the effective batch; an explicit --max-steps beats YAML epochs
        eff = cfg.batch_size * max(1, cfg.grad_accumulation)
        steps = cfg.epochs * max(1, -(-len(items) // eff))
        flog.info(f"epochs={cfg.epochs} -> {steps} steps ({len(items)} items, effective batch {eff})")
        cfg = dataclasses.replace(cfg, max_steps=steps)
    tcfg = _train_config(cfg)

    # --- validation previews (the LoRA merged into a copy of the base per pass) ---
    val_every = cfg.validation_every or cfg.save_every
    val_enabled = pipe is not None and bool(cfg.validation_prompts)
    if val_every <= 0 and (val_enabled or cfg.validation_dataset_dir):
        flog.warning("validation is configured but validation_every/save_every are 0 — no validation passes (or "
                     "validation-based early stops) will run; set validation_every: N to re-enable them")
        val_enabled = False
    if cfg.vlm_scoring:  # the vlm_scoring block's knobs own the tracker
        tracker = ValidationTracker(
            patience=cfg.vlm_early_stopping_patience if cfg.vlm_early_stopping else 0,
            scene_weight=cfg.vlm_scene_weight, min_delta=cfg.vlm_early_stopping_min_delta,
            degradation_threshold=cfg.vlm_degradation_threshold)
    else:
        tracker = ValidationTracker(patience=cfg.early_stop_patience)
    val_cfg = ValidationConfig(
        prompts=tuple(cfg.validation_prompts), every_n_steps=val_every,
        width=cfg.validation_width or cfg.validation_size, height=cfg.validation_height or cfg.validation_size,
        steps=cfg.validation_steps, seed=cfg.validation_seed, guidance=cfg.validation_guidance,
        early_stop_patience=cfg.early_stop_patience, trigger_word=cfg.trigger_word)
    val_pipe = val_base = scorer = None
    pp_previews = False
    ref_images = []
    if val_enabled:
        val_model, val_base = _validation_base(pipe, train_model, device)
        # the training base under pp: each rank holds its stage, so the previews run pipelined
        pp_previews = pp_mesh is not None and val_base is transformer
        val_pipe = Flux2Pipeline(model=val_model, transformer=val_base, vae=pipe.vae, device=device,
                                 text_encoder=pipe.text_encoder, text_encoder_name=pipe.text_encoder_name,
                                 vae_encoder=pipe.vae_encoder)
        scorer = _make_scorer(pipe)
        if cfg.vlm_reference_images:
            from flux2_tpu_torch.io.png import decode_image

            for p in list(cfg.vlm_reference_images)[: cfg.vlm_max_reference_images]:
                with open(p, "rb") as f:
                    ref_images.append(decode_image(f.read()))
        else:
            ref_images = [td.load_image(it.image_path, *it.bucket) for it in items[: cfg.vlm_max_reference_images]]

    # --- validation loss on a held-out dataset (overfit / stagnation stops) ---
    val_loss_fn = None
    val_batches = []
    if pipe is not None and cfg.validation_dataset_dir:
        vcfg = dataclasses.replace(cfg, dataset_dir=cfg.validation_dataset_dir, dop_weight=0.0, control_dir=None,
                                   caption_dropout=0.0, cache_dir=os.path.join(cfg.output_dir, "val_latent_cache"))
        val_sample, val_items = _rank0_first(lambda: _prepare_real_data(pipe, vcfg, tconfig))
        val_loss_fn = trainer.make_eval_loss(transformer, tcfg, forward_fn=pp_forward)
        vr = np.random.RandomState(cfg.validation_seed)
        n_val = min(4, max(1, len(val_items)))
        val_batches = [val_sample(vr, cfg.batch_size) for _ in range(n_val)]  # FIXED: comparable across steps
        flog.info(f"validation loss: {len(val_items)} held-out item(s), {n_val} fixed batch(es)")

    # --- state / resume ---
    controller = TrainingController(cfg.output_dir)
    if args.resume:
        state_path = os.path.join(args.resume, "training_state.json")
        with open(state_path) as f:
            ck_meta = json.load(f)
        for field, ours in (("rank", tcfg.rank), ("alpha", tcfg.alpha), ("optimizer", tcfg.optimizer)):
            theirs = ck_meta.get(field)
            if theirs is not None and theirs != ours:
                raise SystemExit(f"resume: checkpoint was trained with {field}={theirs} but the config says {ours} "
                                 "— restoring optimizer state across that change corrupts it; match the config or "
                                 "start fresh")
        state = trainer.load_checkpoint(args.resume, tcfg, device,
                                        allow_partial=getattr(args, "allow_partial_resume", False))
        tstate = TrainingState.load(state_path)
        if tstate.config_hash and tstate.config_hash != config_hash(tcfg):
            flog.warning("resume: training config differs from the checkpoint's (non-structural change, e.g. "
                         "max_steps/LR schedule) — continuing")
            tstate.config_hash = config_hash(tcfg)
        flog.info(f"resumed from {args.resume} at step {state.step}")
    else:
        state = trainer.init_train_state(transformer, tcfg, torch.Generator(device).manual_seed(cfg.seed))
        tstate = TrainingState(rng_seed=cfg.seed, config_hash=config_hash(tcfg))
    flog.info(f"LoRA rank {tcfg.rank} on {len(state.lora.targets())} targets: "
              f"{lora_mod.num_lora_params(state.lora):,} parameters")
    step_fn = trainer.make_train_step(transformer, tcfg, forward_fn=pp_forward)
    lora_scale = lora_mod.LoRAConfig(tcfg.rank, tcfg.alpha).scale

    history: List[dict] = []
    plateau_best, plateau_bad = float("inf"), 0
    gap_bad, best_val, val_bad = 0, float("inf"), 0
    bs = cfg.batch_size * max(1, cfg.grad_accumulation)
    # Per-step draws (step-seeded RandomState and generator), so a resumed run
    # draws what an uninterrupted one would; the persisted seed wins on resume.
    rng_seed = tstate.rng_seed if args.resume else cfg.seed
    if args.resume and rng_seed != cfg.seed:
        flog.warning(f"resume: using the checkpoint's rng_seed={rng_seed} (YAML seed differs)")
    t_start = time.time() - (tstate.elapsed_s if args.resume else 0.0)
    val_dir = os.path.join(cfg.output_dir, "validation")
    val_ref_cache: dict = {}  # per-prompt I2I reference encodes, reused across passes
    val_emb_cache: dict = {}  # per-prompt embeddings (the prompt set is run-constant)
    if args.resume and tstate.validation_scores:
        tracker.seed_from_history(tstate.validation_scores)

    def validate(step: int, eval_lora):
        """One preview pass; with a LoRA, on a merged COPY of the base (R5).
        Under pp every rank runs it through the pipeline (its own stage merged);
        rank 0 writes the images."""
        base = val_base
        if eval_lora is not None:
            base = lora_mod.merged_copy(val_base, eval_lora, lora_scale)
        val_pipe.transformer = pp_mod.PipelinedDiT(base, pp_mesh) if pp_previews else base
        try:
            return run_validation(val_pipe, val_cfg, step, embeddings_fn=val_pipe.encode_prompt, scorer=scorer,
                                  reference_images=ref_images, output_dir=val_dir if _writes_files() else None,
                                  ref_cache=val_ref_cache, emb_cache=val_emb_cache)
        finally:
            val_pipe.transformer = val_base

    with RuntimeBeacon("train-lora", model=cfg.model) as beacon:
        if val_enabled and not args.resume and cfg.vlm_compare_to_baseline:
            flog.info("generating baseline validation images (no LoRA)")
            for r in validate(0, None):
                tstate.record_validation(0, r.scene, r.style, r.prompt)

        for step in range(tstate.step + 1, cfg.max_steps + 1):
            if _agree(_writes_files() and controller.should_stop()):
                flog.info("stop requested — checkpointing and exiting")
                break
            if _writes_files():
                controller.wait_while_paused()
            seed = (rng_seed * 1_000_003 + step) % (2**32)
            batch = sample_batch(np.random.RandomState(seed), bs)
            if cfg.dop_every_n_steps > 1 and step % cfg.dop_every_n_steps:
                batch.pop("dop_embeddings", None)  # DOP only every Nth step
            t0 = time.perf_counter()
            lr = state.optimizer.schedule(state.optimizer.count)
            metrics = step_fn(state.lora, state.optimizer, batch, torch.Generator(device).manual_seed(seed))
            if tcfg.use_ema:
                trainer.ema_update(state.ema, state.lora, tcfg.ema_decay)
            loss = float(metrics["loss"])  # waits for the step
            history.append({"step": step, "loss": loss, "dop_loss": float(metrics["dop_loss"]),
                            "grad_norm": float(metrics["grad_norm"]), "lr": lr, "seconds": time.perf_counter() - t0})
            tstate.step = step
            tstate.elapsed_s = time.time() - t_start
            tstate.record_loss(loss)
            beacon.update(phase="training", step=step, total_steps=cfg.max_steps)

            if step % max(1, cfg.log_every) == 0 or step == 1:
                eta = tstate.eta_seconds(cfg.max_steps)
                flog.info(f"step {step}/{cfg.max_steps} loss {loss:.4f} eta {eta and round(eta)}s")

            if cfg.early_stop_loss_patience > 0 and step % 20 == 0 and len(tstate.loss_history) >= 20:
                ma = float(np.mean(tstate.loss_history[-20:]))
                if ma < plateau_best - cfg.early_stop_min_delta:
                    plateau_best, plateau_bad = ma, 0
                else:
                    plateau_bad += 1
                if _agree(plateau_bad >= cfg.early_stop_loss_patience):
                    flog.info(f"early stop: loss plateau ({plateau_bad} checks without "
                              f"{cfg.early_stop_min_delta} improvement on the 20-step mean)")
                    break

            saved_path = None
            if (cfg.save_every > 0 and step % cfg.save_every == 0) or (
                    _writes_files() and controller.consume_checkpoint_request()):
                saved_path = _save(cfg, tstate, state, tcfg)
                if cfg.learning_curve and _writes_files():
                    write_learning_curve_svg(tstate.loss_history, os.path.join(cfg.output_dir, "learning_curve.svg"),
                                             smoothing_window=cfg.learning_curve_smoothing)

            eval_lora = state.ema if (tcfg.use_ema and state.ema is not None) else state.lora
            if val_enabled and val_every > 0 and step % val_every == 0:
                records = validate(step, eval_lora)
                for r in records:
                    tstate.record_validation(step, r.scene, r.style, r.prompt)
                stop_early = _agree(tracker.record(step, records))
                mean = tracker.mean_combined(records)
                flog.info(f"validation @ {step}: combined {mean:.2f} (best {tracker.best_score:.2f} @ "
                          f"{tracker.best_step})")
                if tracker.best_step == step and cfg.vlm_save_best_checkpoint and _writes_files():
                    if saved_path is None:  # improved at a non-save step: checkpoint so best/ holds these weights
                        saved_path = _save(cfg, tstate, state, tcfg)
                    best_dir = os.path.join(cfg.output_dir, "best")
                    shutil.rmtree(best_dir, ignore_errors=True)
                    shutil.copytree(saved_path, best_dir)
                    flog.info(f"best checkpoint -> {best_dir}")
                if stop_early:
                    flog.info(f"early stop: {cfg.early_stop_patience} non-improving validation(s)")
                    break

            if val_loss_fn is not None and val_every > 0 and step % val_every == 0:
                vloss = float(np.mean([
                    float(val_loss_fn(eval_lora, vb, torch.Generator(device).manual_seed(cfg.validation_seed + i)))
                    for i, vb in enumerate(val_batches)]))
                train_ma = float(np.mean(tstate.loss_history[-20:])) if tstate.loss_history else vloss
                gap = vloss - train_ma
                tstate.record_val_loss(step, vloss, gap)
                flog.info(f"val loss @ {step}: {vloss:.4f} (train MA {train_ma:.4f}, gap {gap:+.4f})")
                stop = False
                if cfg.early_stop_on_overfit:
                    if gap > cfg.early_stop_max_val_gap:
                        gap_bad += 1
                        if gap_bad >= cfg.early_stop_gap_patience:
                            flog.info(f"early stop: val-train gap {gap:.3f} > {cfg.early_stop_max_val_gap} for "
                                      f"{gap_bad} check(s) (overfitting)")
                            stop = True
                    else:
                        gap_bad = 0
                if cfg.early_stop_on_val_stagnation:
                    if vloss < best_val - cfg.early_stop_min_val_improvement:
                        best_val, val_bad = vloss, 0
                    else:
                        val_bad += 1
                        if val_bad >= cfg.early_stop_val_stagnation_patience:
                            flog.info(f"early stop: val loss stagnant for {val_bad} check(s)")
                            stop = True
                if _agree(stop):
                    break

    _save(cfg, tstate, state, tcfg)
    if cfg.learning_curve and _writes_files():
        write_learning_curve_svg(tstate.loss_history, os.path.join(cfg.output_dir, "learning_curve.svg"),
                                 smoothing_window=cfg.learning_curve_smoothing)
    flog.info(f"training done at step {tstate.step}; output in {cfg.output_dir}")
    return history
