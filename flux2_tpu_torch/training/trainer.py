"""Flow-matching LoRA trainer for the FLUX.2 DiT.

Port of ``flux2_tpu/training/trainer.py``: rectified-flow velocity loss with
optional bell or min-SNR weighting, the timestep samplers, DOP, gradient
accumulation, clip by global norm, AdamW or Lion on an LR schedule, EMA,
and checkpoints whose ``lora.safetensors`` (and ``lora_ema.safetensors``)
hold JAX's flattened names and shapes, so either package reads the other's.

JAX runs a train step as one jitted program; the port runs it eagerly: the
unmerged LoRA forward (``transformer.forward(lora=..., remat=...)``),
``backward``, then the optimizer update in place on the adapters' float32
parameters. On the card every DiT attention of the step runs the flash
kernels: K2 forward, K3 and K4 backward (``ops/flash_attention.py``).
``forward_fn=`` replaces the DiT's forward, as JAX's does: under pipeline
parallelism ``parallel/pipeline.make_pp_forward``, whose ``reduce_grads``
runs after the backward; a sharded DiT's velocity is gathered whole.

The optimizer follows optax's semantics, not torch's defaults:
``clip_by_global_norm`` keeps g when ||g|| < max and else takes
(g / ||g||) * max (no epsilon); the schedule is read at the update count
before the increment, so with warmup step 1 has lr 0; AdamW decays every
adapter leaf. ``optimizer.safetensors`` holds JAX's optax tree paths
(``Optimizer.state_arrays``), so either package resumes the other's
checkpoint, moments and counts included; the port's older keys still load.

Random draws come from a ``torch.Generator``, not threefry: one seed gives
other sigmas and noise than JAX's, so tests inject both. A step draws the
sigmas and noise of its whole batch at once and splits them over the
micro-batches, so gradient accumulation reproduces the full batch's step.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import math
import os
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from flux2_tpu_torch.training import lora as lora_mod


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """JAX's ``TrainConfig``, field for field (``control.config_hash`` hashes it)."""

    rank: int = 16
    alpha: float = 16.0
    learning_rate: float = 1e-4
    weight_decay: float = 0.01
    optimizer: str = "adamw"  # or "lion"
    timestep_sampling: str = "balanced"  # uniform|logit_normal|flux_shift|content|style|balanced
    loss_weighting: str = "none"  # none|bell|snr
    snr_gamma: float = 5.0
    max_grad_norm: float = 1.0
    grad_accumulation: int = 1
    dop_weight: float = 0.0
    remat: bool = True
    seed: int = 42
    target_layers: str = "attention_ffn"
    warmup_steps: int = 0
    lr_scheduler: str = "constant"  # constant|linear|cosine|cosine_with_restarts
    lr_num_cycles: int = 3
    total_steps: int = 1000
    logit_normal_mean: float = 0.0
    logit_normal_std: float = 1.0
    flux_shift: float = 1.0
    use_ema: bool = False
    ema_decay: float = 0.99


TIMESTEP_MODES = ("uniform", "logit_normal", "flux_shift", "content", "style", "balanced")


# ---------------------------------------------------------------------------
# Timestep sampling and loss weights
# ---------------------------------------------------------------------------


def sample_timesteps(
    generator: torch.Generator,
    batch: int,
    mode: str,
    *,
    logit_mean: float = 0.0,
    logit_std: float = 1.0,
    shift: float = 1.0,
) -> torch.Tensor:
    """Sigmas [B] f32 in [0, 1) on the generator's device, by JAX's rules per mode."""
    if mode not in TIMESTEP_MODES:
        raise ValueError(f"unknown timestep sampling mode {mode}")
    dev = generator.device
    if mode == "uniform":
        return torch.randint(0, 1000, (batch,), generator=generator, device=dev).float() / 1000.0
    if mode == "logit_normal":
        z = torch.randn(batch, generator=generator, device=dev)
        return torch.clamp(torch.sigmoid(logit_mean + logit_std * z), 0.0, 0.999)
    if mode == "flux_shift":
        u = torch.rand(batch, generator=generator, device=dev)
        return torch.clamp(shift * u / (1.0 + (shift - 1.0) * u), 0.0, 0.999)
    u = torch.rand(batch, generator=generator, device=dev)
    cubic = u**3
    if mode == "content":  # favors low t (fine detail)
        t = cubic * 1000.0
    elif mode == "style":  # favors high t (global structure)
        t = (1.0 - cubic) * 1000.0
    else:  # balanced: 50/50 mix
        style = torch.rand(batch, generator=generator, device=dev) > 0.5
        t = torch.where(style, (1.0 - cubic) * 1000.0, cubic * 1000.0)
    return torch.clamp(t, 0.0, 999.0) / 1000.0


def bell_weights(sigmas: torch.Tensor) -> torch.Tensor:
    """Ostris bell curve: exp(-2 ((t - 500)/1000)^2) with t = sigma*1000."""
    centered = (sigmas * 1000.0 - 500.0) / 1000.0
    return torch.exp(-2.0 * centered * centered)


def snr_weights(sigmas: torch.Tensor, gamma: float = 5.0) -> torch.Tensor:
    """Min-SNR-gamma weights for the velocity objective: min(SNR, gamma) / (SNR + 1),
    SNR = ((1 - sigma) / sigma)^2."""
    s = torch.clamp(sigmas, 1e-3, 1.0 - 1e-3)
    snr = ((1.0 - s) / s) ** 2
    return torch.minimum(snr, torch.full_like(snr, gamma)) / (snr + 1.0)


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------


def _stream_dtype(transformer: nn.Module) -> torch.dtype:
    """The DiT stream dtype: the x_embedder's (bf16 when it is quantized)."""
    w = transformer.x_embedder
    return w.dtype if isinstance(w, torch.Tensor) else torch.bfloat16


def _forward(transformer: nn.Module, forward_fn: Optional[Callable], *args, **kwargs) -> torch.Tensor:
    """The velocity as a plain tensor: ``forward_fn(transformer, ...)`` or the
    DiT's own forward, a sharded DiT's DTensor gathered whole."""
    from flux2_tpu_torch.parallel.sharding import gather

    if forward_fn is not None:
        return gather(forward_fn(transformer, *args, **kwargs))
    return gather(transformer(*args, **kwargs))


def _noisy(latents, noise, sigmas):
    s = sigmas[:, None, None]
    return (1.0 - s) * latents + s * noise


def flow_matching_loss(
    transformer: nn.Module,
    lora: Optional[lora_mod.LoRA],
    train_cfg: TrainConfig,
    latents: torch.Tensor,  # [B, S, 128] clean packed latents, f32
    embeddings: torch.Tensor,  # [B, S_txt, joint]
    noise: torch.Tensor,  # [B, S, 128] f32
    sigmas: torch.Tensor,  # [B] f32
    rope_cos: torch.Tensor,
    rope_sin: torch.Tensor,
    guidance: Optional[torch.Tensor] = None,
    control: Optional[torch.Tensor] = None,  # [B, S_ctl, 128] clean control tokens (I2I)
    forward_fn: Optional[Callable] = None,  # Flux2Transformer.forward-compatible (e.g. pp)
) -> torch.Tensor:
    """MSE(model(noisy, t)[:, :S], noise - latents) in f32, optionally bell- or
    SNR-weighted; the DiT runs in its weights' dtype with the LoRA unmerged,
    through ``forward_fn(transformer, ...)`` when given. A sharded DiT's
    velocity (a DTensor) is gathered whole first."""
    scale = lora_mod.LoRAConfig(train_cfg.rank, train_cfg.alpha).scale
    s_out = latents.shape[1]
    x = _noisy(latents, noise, sigmas)
    if control is not None:
        x = torch.cat([x, control], dim=1)
    pred = _forward(transformer, forward_fn, x.to(_stream_dtype(transformer)), embeddings, sigmas, rope_cos,
                    rope_sin, guidance=guidance, remat=train_cfg.remat, lora=lora, lora_scale=scale)[:, :s_out]
    target = noise - latents  # ops/scheduler.get_velocity
    sq = torch.square(pred.float() - target.float())
    if train_cfg.loss_weighting in ("bell", "snr"):
        w = bell_weights(sigmas) if train_cfg.loss_weighting == "bell" else snr_weights(sigmas, train_cfg.snr_gamma)
        w = w[:, None, None]
        return torch.sum(w * sq) / (torch.sum(w) * sq.shape[1] * sq.shape[2])
    return torch.mean(sq)


def dop_loss(
    transformer: nn.Module,
    lora: lora_mod.LoRA,
    train_cfg: TrainConfig,
    latents: torch.Tensor,
    preservation_embeddings: torch.Tensor,
    noise: torch.Tensor,
    sigmas: torch.Tensor,
    rope_cos: torch.Tensor,
    rope_sin: torch.Tensor,
    guidance: Optional[torch.Tensor] = None,
    forward_fn: Optional[Callable] = None,
) -> torch.Tensor:
    """Differential Output Preservation: MSE(LoRA out, base out) on the
    preservation captions; the base forward runs without gradient (JAX's
    ``stop_gradient``), so on the card it launches K1, not K2."""
    scale = lora_mod.LoRAConfig(train_cfg.rank, train_cfg.alpha).scale
    noisy = _noisy(latents, noise, sigmas).to(_stream_dtype(transformer))
    joint = preservation_embeddings.shape[1] + latents.shape[1]
    rope_cos, rope_sin = rope_cos[:joint], rope_sin[:joint]
    pred_lora = _forward(transformer, forward_fn, noisy, preservation_embeddings, sigmas, rope_cos, rope_sin,
                         guidance=guidance, remat=train_cfg.remat, lora=lora, lora_scale=scale)
    with torch.no_grad():
        pred_base = _forward(transformer, forward_fn, noisy, preservation_embeddings, sigmas, rope_cos, rope_sin,
                             guidance=guidance)
    return torch.mean(torch.square(pred_lora.float() - pred_base.float()))


# ---------------------------------------------------------------------------
# LR schedule and optimizer (optax semantics)
# ---------------------------------------------------------------------------


def _linear(init: float, end: float, steps: int) -> Callable[[int], float]:
    """optax.linear_schedule."""
    if steps <= 0:
        return lambda count: init
    return lambda count: (init - end) * (1 - min(max(count, 0), steps) / steps) + end


def _cosine(init: float, decay_steps: int) -> Callable[[int], float]:
    """optax.cosine_decay_schedule (alpha 0, exponent 1)."""
    return lambda count: init * (0.5 * (1 + math.cos(math.pi * min(count, decay_steps) / decay_steps)))


def _join(schedules: Sequence[Callable], boundaries: Sequence[int]) -> Callable[[int], float]:
    """optax.join_schedules: past each boundary, the next schedule counts from it."""
    def schedule(count):
        out = schedules[0](count)
        for boundary, fn in zip(boundaries, schedules[1:]):
            if count >= boundary:
                out = fn(count - boundary)
        return out
    return schedule


def lr_schedule(cfg: TrainConfig) -> Callable[[int], float]:
    """The learning rate as a function of the update count (JAX's ``lr_schedule``):
    linear warmup, then constant, linear to 0, cosine, or cosine with
    ``lr_num_cycles`` hard restarts over ``total_steps - warmup_steps``."""
    base = cfg.learning_rate
    decay_steps = max(1, cfg.total_steps - cfg.warmup_steps)
    if cfg.lr_scheduler == "constant":
        main = lambda count: base  # noqa: E731
    elif cfg.lr_scheduler == "linear":
        main = _linear(base, 0.0, decay_steps)
    elif cfg.lr_scheduler == "cosine":
        main = _cosine(base, decay_steps)
    elif cfg.lr_scheduler == "cosine_with_restarts":
        cycles = max(1, cfg.lr_num_cycles)
        per = max(1, decay_steps // cycles)
        main = _join([_cosine(base, per)] * cycles, [per * (i + 1) for i in range(cycles - 1)])
    else:
        raise ValueError(f"unknown lr_scheduler {cfg.lr_scheduler}")
    if cfg.warmup_steps > 0:
        return _join([_linear(0.0, base, cfg.warmup_steps), main], [cfg.warmup_steps])
    return main


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element (optax.global_norm), f32."""
    return torch.sqrt(sum(torch.sum(torch.square(t.float())) for t in tensors))


class Optimizer:
    """optax ``chain(clip_by_global_norm(max_grad_norm), adamw | lion(lr_schedule,
    weight_decay))`` over named float32 parameters, updated in place. AdamW:
    b1 0.9, b2 0.999, eps 1e-8; Lion: b1 0.9, b2 0.99 (optax's defaults)."""

    def __init__(self, cfg: TrainConfig, named_params: Sequence[Tuple[str, nn.Parameter]]):
        if cfg.optimizer not in ("adamw", "lion"):
            raise ValueError(f"unknown optimizer {cfg.optimizer}")
        self.kind = cfg.optimizer
        self.max_norm = cfg.max_grad_norm
        self.weight_decay = cfg.weight_decay
        self.schedule = lr_schedule(cfg)
        self.b1, self.b2 = (0.9, 0.999) if self.kind == "adamw" else (0.9, 0.99)
        self.names = [n for n, _ in named_params]
        self.params = [p for _, p in named_params]
        self.count = 0
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params] if self.kind == "adamw" else []

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor]) -> None:
        """One update from ``grads`` (unclipped, one per parameter)."""
        g_norm = global_norm(grads)
        clip = g_norm < self.max_norm
        grads = [torch.where(clip, g, (g / g_norm) * self.max_norm) for g in grads]
        lr = self.schedule(self.count)
        self.count += 1
        b1, b2, wd = self.b1, self.b2, self.weight_decay
        for i, (p, g) in enumerate(zip(self.params, grads)):
            mu = self.mu[i]
            if self.kind == "adamw":
                nu = self.nu[i]
                mu.copy_((1 - b1) * g + b1 * mu)
                nu.copy_((1 - b2) * torch.square(g) + b2 * nu)
                update = (mu / (1 - b1**self.count)) / (torch.sqrt(nu / (1 - b2**self.count)) + 1e-8)
            else:
                update = torch.sign((1 - b1) * g + b1 * mu)
                mu.copy_((1 - b2) * g + b2 * mu)
            p.add_(-lr * (update + wd * p))

    # optax's state of chain(clip_by_global_norm, adamw | lion): [0] is empty,
    # [1][0] the moments' ScaleByAdamState / ScaleByLionState, [1][2] the
    # schedule's count (JAX's ``_opt_state_by_path`` keys).
    COUNT_KEYS = ("[1][0].count", "[1][2].count")

    def _stacks(self) -> Dict[str, list]:
        """JAX's stacked leaf path ``['group']['leaf']['a']`` -> the indices of
        its per-block parameters, in block order."""
        stacks: Dict[str, list] = {}
        for i, name in enumerate(self.names):
            group, block, leaf, ab = name.split(".")
            stacks.setdefault(f"['{group}']['{leaf}']['{ab}']", []).append((int(block), i))
        return {path: [i for _, i in sorted(pairs)] for path, pairs in stacks.items()}

    def state_arrays(self) -> Dict[str, torch.Tensor]:
        """Flat state for ``optimizer.safetensors`` under JAX's optax tree paths:
        the two int32 counts, ``[1][0].mu[...]`` (and ``.nu[...]`` for AdamW)
        stacked over the blocks as JAX's leaves are."""
        out = {k: torch.tensor(self.count, dtype=torch.int32) for k in self.COUNT_KEYS}
        for slot, moments in (("mu", self.mu), ("nu", self.nu)):
            if moments:
                out.update({f"[1][0].{slot}{path}": torch.stack([moments[i] for i in idx])
                            for path, idx in self._stacks().items()})
        return out

    def load_state_arrays(self, saved: Dict[str, "object"], allow_partial: bool = False) -> None:
        """Restore from JAX's path keys (written by either package) or from the
        port's keys of PRs 3-12 (``count``, ``mu.<param>``, ``nu.<param>``);
        refuse on any missing, extra or misshapen entry unless ``allow_partial``
        (those then keep fresh state). Sizes are compared, as JAX's loader does:
        a count round-trips () <-> (1,)."""
        if "count" in saved or any(k.startswith(("mu.", "nu.")) for k in saved):
            return self._load_port_keys(saved, allow_partial)
        expected = {k: tuple(v.shape) for k, v in self.state_arrays().items()}
        ok = self._check(saved, expected, allow_partial, "")
        counts = [k for k in self.COUNT_KEYS if ok(k)]
        if counts:
            self.count = int(torch.as_tensor(saved[counts[0]]).reshape(-1)[0])
        stacks = self._stacks()
        for slot, moments in (("mu", self.mu), ("nu", self.nu)):
            for path, idx in stacks.items():
                key = f"[1][0].{slot}{path}"
                if moments and ok(key):
                    full = torch.as_tensor(saved[key]).reshape(expected[key])
                    for j, i in enumerate(idx):
                        moments[i].copy_(full[j].to(moments[i].device, moments[i].dtype))

    @staticmethod
    def _check(saved, expected: Dict[str, tuple], allow_partial: bool, hint: str):
        """Raise on missing / extra / misshapen (by size) keys unless
        ``allow_partial``; returns ``ok(key)``: restorable from ``saved``."""
        size = lambda shape: int(math.prod(shape))  # noqa: E731
        missing = sorted(set(expected) - set(saved))
        extra = sorted(set(saved) - set(expected))
        misshapen = sorted(k for k in set(expected) & set(saved) if size(tuple(saved[k].shape)) != size(expected[k]))
        if (missing or extra or misshapen) and not allow_partial:
            raise ValueError(
                f"optimizer state does not match (missing={missing[:4]}, unexpected={extra[:4]}, "
                f"shape-mismatch={misshapen[:4]}): the optimizer or config changed since the save{hint}. Match it, "
                "or resume with allow_partial=True (--allow-partial-resume) to start the unmatched state fresh")
        return lambda k: k in saved and k not in misshapen

    def _load_port_keys(self, saved, allow_partial: bool) -> None:
        """The port's keys of PRs 3-12: ``count`` and one ``mu.<param>`` /
        ``nu.<param>`` per block's adapter."""
        expected = {"count": (1,)}
        for prefix, moments in (("mu", self.mu), ("nu", self.nu)):
            expected.update({f"{prefix}.{n}": tuple(m.shape) for n, m in zip(self.names, moments)})
        ok = self._check(saved, expected, allow_partial, " (a checkpoint in the port's keys of PRs 3-12)")
        if ok("count"):
            self.count = int(torch.as_tensor(saved["count"]).reshape(-1)[0])
        for prefix, moments in (("mu", self.mu), ("nu", self.nu)):
            for n, m in zip(self.names, moments):
                if ok(f"{prefix}.{n}"):
                    m.copy_(torch.as_tensor(saved[f"{prefix}.{n}"]).reshape(m.shape).to(m.device, m.dtype))


def make_optimizer(cfg: TrainConfig, lora: lora_mod.LoRA) -> Optimizer:
    return Optimizer(cfg, list(lora.named_parameters()))


def lora_targets(cfg: TrainConfig) -> Tuple[Tuple[str, str], ...]:
    """target_layers -> adapter leaves (attention|attention_output: Q/K/V/out;
    attention_ffn|all: + the FFN projections)."""
    if cfg.target_layers in ("attention", "attention_output"):
        return lora_mod.ATTENTION_ONLY_TARGETS
    if cfg.target_layers in ("attention_ffn", "all"):
        return lora_mod.DEFAULT_TARGETS
    raise ValueError(f"unknown target_layers {cfg.target_layers}")


# ---------------------------------------------------------------------------
# State, step, EMA
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class TrainState:
    lora: lora_mod.LoRA
    optimizer: Optimizer
    step: int
    ema: Optional[lora_mod.LoRA] = None  # EMA of the adapters when cfg.use_ema


@torch.no_grad()
def ema_update(ema: lora_mod.LoRA, lora: lora_mod.LoRA, decay: float) -> lora_mod.LoRA:
    """ema <- decay * ema + (1 - decay) * lora, in place."""
    for e, p in zip(ema.parameters(), lora.parameters()):
        e.copy_(decay * e + (1.0 - decay) * p)
    return ema


def _copy_lora(lora: lora_mod.LoRA) -> lora_mod.LoRA:
    ema = copy.deepcopy(lora)
    ema.requires_grad_(False)
    return ema


def init_train_state(transformer: nn.Module, cfg: TrainConfig, generator: torch.Generator) -> TrainState:
    """Fresh adapters drawn from ``generator`` (on its device), their optimizer, and the EMA copy."""
    lora = lora_mod.init_lora(transformer, lora_mod.LoRAConfig(cfg.rank, cfg.alpha, lora_targets(cfg)), generator)
    return TrainState(lora=lora, optimizer=make_optimizer(cfg, lora), step=0,
                      ema=_copy_lora(lora) if cfg.use_ema else None)


BATCHED_KEYS = ("latents", "embeddings", "guidance", "control", "dop_embeddings")


def _draw(train_cfg: TrainConfig, generator: torch.Generator, latents: torch.Tensor):
    """(sigmas [B], noise [B, S, 128] f32) for a batch, on latents' device."""
    sigmas = sample_timesteps(generator, latents.shape[0], train_cfg.timestep_sampling,
                              logit_mean=train_cfg.logit_normal_mean, logit_std=train_cfg.logit_normal_std,
                              shift=train_cfg.flux_shift)
    noise = torch.randn(latents.shape, generator=generator, device=generator.device, dtype=torch.float32)
    return sigmas.to(latents.device), noise.to(latents.device)


def make_train_step(transformer: nn.Module, train_cfg: TrainConfig, forward_fn: Optional[Callable] = None) -> Callable:
    """step(lora, optimizer, batch, generator) -> metrics {loss, dop_loss, grad_norm}
    (0-d tensors), updating the adapters in place. ``batch``: latents [B,S,128],
    embeddings [B,S_txt,J], rope_cos/rope_sin, optional guidance / control /
    dop_embeddings. With ``grad_accumulation`` n > 1 the batch splits into n
    micro-batches whose gradients sum into the adapters' ``.grad`` / n.
    ``forward_fn`` replaces the DiT's forward (``parallel.pipeline.
    make_pp_forward``: every rank draws and holds the whole batch, its
    ``reduce_grads`` gives every rank the dense gradient after the backward,
    so the adapters, the optimizer state and the metrics agree on every rank)."""

    def loss_fn(lora, batch, sigmas, noise):
        main = flow_matching_loss(transformer, lora, train_cfg, batch["latents"], batch["embeddings"], noise,
                                  sigmas, batch["rope_cos"], batch["rope_sin"], guidance=batch.get("guidance"),
                                  control=batch.get("control"), forward_fn=forward_fn)
        dop = torch.zeros((), device=main.device)
        if train_cfg.dop_weight > 0.0 and "dop_embeddings" in batch:
            dop = dop_loss(transformer, lora, train_cfg, batch["latents"], batch["dop_embeddings"], noise, sigmas,
                           batch["rope_cos"], batch["rope_sin"], guidance=batch.get("guidance"),
                           forward_fn=forward_fn)
            return main + train_cfg.dop_weight * dop, main, dop
        return main, main, dop

    def step(lora: lora_mod.LoRA, optimizer: Optimizer, batch: dict, generator: torch.Generator) -> dict:
        n = max(1, train_cfg.grad_accumulation)
        b = batch["latents"].shape[0]
        if b % n:
            raise ValueError(f"batch {b} does not split into {n} micro-batches")
        sigmas, noise = _draw(train_cfg, generator, batch["latents"])
        params = list(lora.parameters())
        for p in params:
            p.grad = None
        loss_sum = dop_sum = 0.0
        for i in range(n):
            sl = slice(i * b // n, (i + 1) * b // n)
            mb = {k: (v[sl] if k in BATCHED_KEYS else v) for k, v in batch.items()}
            total, main, dop = loss_fn(lora, mb, sigmas[sl], noise[sl])
            (total / n).backward()
            loss_sum = loss_sum + main.detach()
            dop_sum = dop_sum + dop.detach()
        if hasattr(forward_fn, "reduce_grads"):
            forward_fn.reduce_grads(params)
        grads = [p.grad for p in params]
        metrics = {"loss": loss_sum / n, "dop_loss": dop_sum / n, "grad_norm": global_norm(grads)}
        optimizer.step(grads)
        return metrics

    return step


def make_eval_loss(transformer: nn.Module, train_cfg: TrainConfig, forward_fn: Optional[Callable] = None) -> Callable:
    """eval_loss(lora, batch, generator) -> the training objective with no
    gradient (so on the card the attention runs K1), through ``forward_fn``
    when given."""

    @torch.no_grad()
    def eval_loss(lora, batch, generator):
        sigmas, noise = _draw(train_cfg, generator, batch["latents"])
        return flow_matching_loss(transformer, lora, dataclasses.replace(train_cfg, remat=False), batch["latents"],
                                  batch["embeddings"], noise, sigmas, batch["rope_cos"], batch["rope_sin"],
                                  guidance=batch.get("guidance"), control=batch.get("control"),
                                  forward_fn=forward_fn)

    return eval_loss


# ---------------------------------------------------------------------------
# Checkpoints (JAX's file names and LoRA keys)
# ---------------------------------------------------------------------------


def _np(tensors: Dict[str, torch.Tensor]):
    return {k: v.detach().cpu().numpy() for k, v in tensors.items()}


def save_checkpoint(path: str, state: TrainState, train_cfg: TrainConfig, extra: Optional[dict] = None) -> None:
    """lora.safetensors (+ lora_ema.safetensors) in JAX's flat names and
    stacked shapes, optimizer.safetensors in JAX's optax tree paths, and
    training_state.json with JAX's keys (+ ``extra``)."""
    from flux2_tpu_torch.io import safetensors_io
    from flux2_tpu_torch.io.jax_params import lora_to_flat

    os.makedirs(path, exist_ok=True)
    safetensors_io.save_file(lora_to_flat(state.lora), os.path.join(path, "lora.safetensors"))
    if state.ema is not None:
        safetensors_io.save_file(lora_to_flat(state.ema), os.path.join(path, "lora_ema.safetensors"))
    safetensors_io.save_file(_np(state.optimizer.state_arrays()), os.path.join(path, "optimizer.safetensors"))
    meta = {"step": state.step, "rank": train_cfg.rank, "alpha": train_cfg.alpha,
            "optimizer": train_cfg.optimizer, "learning_rate": train_cfg.learning_rate}
    if extra:
        meta.update(extra)
    with open(os.path.join(path, "training_state.json"), "w") as f:
        json.dump(meta, f, indent=2)


def load_checkpoint(path: str, cfg: TrainConfig, device: "torch.device | str",
                    allow_partial: bool = False) -> TrainState:
    """Restore the LoRA, the optimizer state (strict, see
    ``Optimizer.load_state_arrays``) and the EMA, written by either package."""
    from flux2_tpu_torch.io import safetensors_io
    from flux2_tpu_torch.io.jax_params import lora_from_flat

    with open(os.path.join(path, "training_state.json")) as f:
        meta = json.load(f)
    lora = lora_from_flat(safetensors_io.load_file(os.path.join(path, "lora.safetensors")), device)
    optimizer = make_optimizer(cfg, lora)
    opt_file = os.path.join(path, "optimizer.safetensors")
    if os.path.exists(opt_file):
        optimizer.load_state_arrays(safetensors_io.load_file(opt_file), allow_partial)
    ema_file = os.path.join(path, "lora_ema.safetensors")
    ema = None
    if os.path.exists(ema_file):
        ema = lora_from_flat(safetensors_io.load_file(ema_file), device).requires_grad_(False)
    elif cfg.use_ema:
        ema = _copy_lora(lora)
    return TrainState(lora=lora, optimizer=optimizer, step=int(meta["step"]), ema=ema)

