"""``train-lora --random-init``: LoRA training of the FLUX.2 DiT on synthetic data.

Port of the random-init synthetic branch of ``flux2_tpu/cli/train.py``
(``run_training`` :608, ``_prepare_synthetic_data`` :499, ``_save`` :1130):
the training variant of the YAML's model (klein-4b -> klein-4b-base), a
random bf16 base drawn on ``device`` from seed 0, synthetic latents and
text embeddings, and the step loop with JAX's per-step batch draws, log
lines, checkpoints, learning-curve SVG, EMA, loss-plateau early stop,
``TrainingController`` stop / pause / checkpoint sentinels and ``--resume``
of the port's own checkpoints.

The YAML schema, the SVG writer, the checkpoint pruning and the training
variant (``cli/train_config.py``) and the controller (``training/control.py``)
are the port's own copies of the JAX package's, held against them by the CPU
tests.

JAX's random-init base is f32; the port's is bf16, as the checkpoint branch
trains and as the kernels take it. What this slice does not carry raises
``SystemExit`` naming its ROADMAP queue: a dataset directory or control
images (``training/data.py`` and ``_prepare_real_data`` are not ported,
queue 13), validation prompts, VLM scoring and validation-loss datasets
(queues 13 and 15), pipeline parallelism and ``--shard`` (queue 16),
``--quantization`` (queue 13: JAX quantizes the base only when it loads
checkpoints, and its ``--random-init`` base ignores the flag; the library's
``init_train_state`` / ``make_train_step`` do train on a quantized base),
adapter dropout (queue 13) and checkpoint directories (queue 13: JAX trains
on real data whenever it loads checkpoints).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
from typing import List, Optional

import numpy as np
import torch

from flux2_tpu_torch.models.flux2.config import Flux2TransformerConfig


def _refuse_unsupported(cfg, args: argparse.Namespace) -> None:
    """SystemExit, naming the ROADMAP queue, for what the port does not carry yet."""
    def refuse(what: str, queue: str) -> None:
        raise SystemExit(f"train-lora in flux2_tpu_torch: {what} is not ported yet (ROADMAP queue {queue})")

    if not getattr(args, "random_init", False):
        refuse("training from checkpoints (pass --random-init)", "13")
    for flag in ("transformer_dir", "vae_dir", "encoder_dir", "encoder_tokenizer_dir"):
        if getattr(args, flag, None):
            refuse(f"--{flag.replace('_', '-')} (reading checkpoints)", "13")
    if cfg.dataset_dir and os.path.isdir(cfg.dataset_dir):
        refuse(f"real-data training (dataset {cfg.dataset_dir}: training/data.py and _prepare_real_data)", "13")
    if cfg.control_dir:
        refuse("I2I control-image training (training/data.py and _prepare_real_data)", "13")
    if cfg.validation_prompts or cfg.vlm_scoring:
        refuse("validation previews and VLM scoring", "13/15")
    if cfg.validation_dataset_dir:
        refuse("the validation-loss dataset", "13")
    if cfg.pp > 1 or cfg.pp_tp > 1 or cfg.pp_microbatches or cfg.pp_over_dcn or getattr(args, "shard", None):
        refuse("pipeline parallelism and --shard", "16")
    if (getattr(args, "quantization", None) or "bf16") != "bf16":
        # JAX quantizes the base only in its checkpoint branch; its --random-init base ignores --quantization
        refuse(f"training on a {args.quantization} base from checkpoints (QLoRA; with --random-init JAX trains "
               "an unquantized base)", "13")
    if cfg.lora_dropout:
        refuse("adapter dropout (lora.dropout > 0)", "13")


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
    """checkpoint_{step:06d}/ with the training state's fields in training_state.json, then prune."""
    from flux2_tpu_torch.cli.train_config import prune_checkpoints
    from flux2_tpu_torch.training import trainer

    path = os.path.join(cfg.output_dir, f"checkpoint_{tstate.step:06d}")
    state.step = tstate.step
    trainer.save_checkpoint(path, state, tcfg, extra=dataclasses.asdict(tstate))
    print(f"checkpoint -> {path}", flush=True)
    prune_checkpoints(cfg, keep=path)
    return path


def run_training(
    args: argparse.Namespace,
    device: "torch.device | str",
    transformer_config: Optional[Flux2TransformerConfig] = None,
) -> List[dict]:
    """Train as ``flux2 train-lora --random-init`` does, on ``device``; returns
    one dict per step run here (step, loss, dop_loss, grad_norm, lr, seconds).
    ``transformer_config`` replaces the model's (tests run a tiny one)."""
    from flux2_tpu_torch.cli.train_config import YAMLTrainingConfig, write_learning_curve_svg
    from flux2_tpu_torch.io.registry import training_variant
    from flux2_tpu_torch.models.flux2.config import Flux2Model
    from flux2_tpu_torch.training.control import TrainingController, TrainingState, config_hash
    from flux2_tpu_torch.utils import logging as flog
    from flux2_tpu_torch.models.flux2.transformer import Flux2Transformer
    from flux2_tpu_torch.training import lora as lora_mod
    from flux2_tpu_torch.training import trainer

    cfg = YAMLTrainingConfig.from_yaml(args.config).override(
        output_dir=args.output_dir, max_steps=args.max_steps, dataset_dir=getattr(args, "dataset_dir", None))
    _refuse_unsupported(cfg, args)
    requested = Flux2Model(cfg.model)
    train_model = training_variant(requested)
    if train_model != requested:
        flog.info(f"resolved training variant: {requested.value} -> {train_model.value}")
    if getattr(args, "encoder_quantization", None) or cfg.encoder_quantization:
        flog.warning("encoder quantization has no effect here: synthetic data needs no text encoder")
    if cfg.dop_weight > 0:
        flog.warning("dop_weight > 0 has no effect here: synthetic batches carry no preservation captions")
    os.makedirs(cfg.output_dir, exist_ok=True)

    device = torch.device(device)
    tconfig = transformer_config or train_model.transformer_config
    transformer = Flux2Transformer(tconfig, device=device, dtype=torch.bfloat16,
                                   generator=torch.Generator(device).manual_seed(0))
    flog.warning("training against random-init base (smoke test): synthetic tensors")
    sample_batch = _prepare_synthetic_data(cfg, tconfig, device)
    tcfg = _train_config(cfg)

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
    step_fn = trainer.make_train_step(transformer, tcfg)

    history: List[dict] = []
    plateau_best, plateau_bad = float("inf"), 0
    bs = cfg.batch_size * max(1, cfg.grad_accumulation)
    # Per-step draws (step-seeded RandomState and generator), so a resumed run
    # draws what an uninterrupted one would; the persisted seed wins on resume.
    rng_seed = tstate.rng_seed if args.resume else cfg.seed
    if args.resume and rng_seed != cfg.seed:
        flog.warning(f"resume: using the checkpoint's rng_seed={rng_seed} (YAML seed differs)")
    t_start = time.time() - (tstate.elapsed_s if args.resume else 0.0)

    for step in range(tstate.step + 1, cfg.max_steps + 1):
        if controller.should_stop():
            flog.info("stop requested — checkpointing and exiting")
            break
        controller.wait_while_paused()
        seed = (rng_seed * 1_000_003 + step) % (2**32)
        batch = sample_batch(np.random.RandomState(seed), bs)
        t0 = time.perf_counter()
        lr = state.optimizer.schedule(state.optimizer.count)
        metrics = step_fn(state.lora, state.optimizer, batch, torch.Generator(device).manual_seed(seed))
        if tcfg.use_ema:
            trainer.ema_update(state.ema, state.lora, tcfg.ema_decay)
        loss = float(metrics["loss"])  # waits for the step
        row = {"step": step, "loss": loss, "dop_loss": float(metrics["dop_loss"]),
               "grad_norm": float(metrics["grad_norm"]), "lr": lr, "seconds": time.perf_counter() - t0}
        history.append(row)
        tstate.step = step
        tstate.elapsed_s = time.time() - t_start
        tstate.record_loss(loss)

        if step % max(1, cfg.log_every) == 0 or step == 1:
            eta = tstate.eta_seconds(cfg.max_steps)
            flog.info(f"step {step}/{cfg.max_steps} loss {loss:.4f} grad_norm {row['grad_norm']:.4f} "
                      f"{row['seconds']:.3f} s/step eta {eta and round(eta)}s")

        if cfg.early_stop_loss_patience > 0 and step % 20 == 0 and len(tstate.loss_history) >= 20:
            ma = float(np.mean(tstate.loss_history[-20:]))
            if ma < plateau_best - cfg.early_stop_min_delta:
                plateau_best, plateau_bad = ma, 0
            else:
                plateau_bad += 1
                if plateau_bad >= cfg.early_stop_loss_patience:
                    flog.info(f"early stop: loss plateau ({plateau_bad} checks without "
                              f"{cfg.early_stop_min_delta} improvement on the 20-step mean)")
                    break

        if (cfg.save_every > 0 and step % cfg.save_every == 0) or controller.consume_checkpoint_request():
            _save(cfg, tstate, state, tcfg)
            if cfg.learning_curve:
                write_learning_curve_svg(tstate.loss_history, os.path.join(cfg.output_dir, "learning_curve.svg"),
                                         smoothing_window=cfg.learning_curve_smoothing)

    _save(cfg, tstate, state, tcfg)
    if cfg.learning_curve:
        write_learning_curve_svg(tstate.loss_history, os.path.join(cfg.output_dir, "learning_curve.svg"),
                                 smoothing_window=cfg.learning_curve_smoothing)
    flog.info(f"training done at step {tstate.step}; output in {cfg.output_dir}")
    return history
