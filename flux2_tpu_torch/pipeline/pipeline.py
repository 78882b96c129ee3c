"""FLUX.2 generation pipeline in PyTorch: T2I, multi-reference I2I, img2img strength.

Port of ``flux2_tpu/pipeline/pipeline.py``: prompt -> text encoder
(LRU-cached) -> seeded noise -> Euler denoising over the FLUX.2 sigma
schedule (or ``custom_sigmas``) -> VAE decode -> uint8, with JAX's classical
CFG for the base models (cond and uncond as batch rows of one forward, the ""
negative encoded through the same LRU). I2I: reference images go through the
VAE encoder (``encode_reference_images``) and their clean tokens follow the
output tokens in every step, RoPE ids in [txt ; img ; ref] order; with
``init_latents`` and ``strength`` < 1 the schedule is cut and the start is
the init noised to its first sigma. klein-9b-kv with references extracts the
references' K/V at step 0 and reuses them in steps 1+ (``_denoise_kv_cached``).
Where JAX compiles the denoise loop into one ``lax.scan``, the port runs a
Python loop over the schedule under ``torch.inference_mode()``. After each
step's Euler update, in both loops and in JAX's order: the step hook
(``step_hook``, structured or legacy), the cancel check, ``on_progress`` and
``on_latents`` (live previews); every ``checkpoint_interval``-th step's
latents are kept and decoded after the loop (``on_checkpoint``). The decode
is tiled above the memory profile's threshold (``memory_profile``).
``upsample=True`` rewrites the prompt through the attached encoder facade
(``encoders``, ``text_encoder_name``) with the BFL protocol before it is
encoded (``final_prompt``, ``was_upsampled``). ``interpret_images`` and the
image branch of ``upsample_prompt`` describe images through the vision
service (``vlm``, loaded on first use by ``vlm_loader``: the CLI's checkpoint
branch sets it); with neither they raise JAX's "requires a VLM" errors.

``shard(mesh, context_parallel=)`` distributes the DiT over a device mesh
(``flux2_tpu_torch/parallel/``; JAX's ``shard``): every rank runs
``generate`` with the same arguments, each forward's velocity is gathered
from its DTensor, and under context parallelism every unmasked attention is
ring attention (``ring``; the KV extract step stays dense).

The noise comes from a ``torch.Generator`` seeded with ``seed``: JAX uses
threefry, so one seed gives different images in the two packages. Pass
``noise=`` to reproduce a JAX run.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import threading
import time
from collections import OrderedDict
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from flux2_tpu_torch.models.flux2.config import Flux2Model, Flux2TransformerConfig
from flux2_tpu_torch.models.flux2.transformer import Flux2Transformer
from flux2_tpu_torch.models.flux2.vae import FLUX2_VAE, VAEConfig, VAEDecoder, VAEEncoder, decode_tiled
from flux2_tpu_torch.ops import latents as lu
from flux2_tpu_torch.ops.quant import param_dtype
from flux2_tpu_torch.ops import scheduler as sch
from flux2_tpu_torch.ops.rope import rope_embeddings
from flux2_tpu_torch.parallel.sharding import gather
from flux2_tpu_torch.utils.memory import MemoryTelemetry, telemetry as _mem_telemetry
from flux2_tpu_torch.utils.profiler import shared as _profiler

# Largest total pixel count decoded as one dense batch; above it the decode
# runs image by image to bound the decoder's peak activation memory.
DECODE_BATCH_BUDGET_PIXELS = 1024 * 1024


# A step hook rewrites the latent sequence after every step's Euler update (the
# port of JAX's ``StepHook``, ``flux2_tpu/pipeline/pipeline.py:75-104``). Two forms:
#   - structured: a ``(fn, state)`` pair, ``fn(state, latents, sigma, sigma_next,
#     step_idx) -> latents`` with ``state`` a dict of tensors on the latents' device
#     (``chains.inpaint.repaint_step_hook``);
#   - legacy: a bare callable ``hook(latents, sigma, sigma_next, step_idx)``.
# ``latents`` is float32 [B, S, 128]; ``sigma`` and ``sigma_next`` are 0-d float32
# tensors on the latents' device (JAX's traced scalars), ``step_idx`` the step's
# index from 0 (an int where JAX passes a traced int32).
StepHook = Callable[..., torch.Tensor]


def _normalize_hook(step_hook):
    """Split ``step_hook`` into (fn, state); state is None for a legacy hook."""
    if step_hook is None:
        return None, None
    if isinstance(step_hook, tuple):
        if len(step_hook) != 2 or not callable(step_hook[0]):
            raise TypeError("structured step_hook must be (fn, state_pytree)")
        return step_hook
    return step_hook, None


class GenerationCancelled(RuntimeError):
    """Raised when the ``cancel`` flag is found set after a denoising step."""


@dataclasses.dataclass
class GenerationResult:
    image: np.ndarray  # [H, W, 3] float32 in [0, 1], 1/255 steps (first batch row)
    latents_device: torch.Tensor  # final packed latents [B, S, 128] float32, on the device
    seed: int
    num_steps: int
    duration_s: float
    phase_timings: Dict[str, float]
    images: Optional[np.ndarray] = None  # [B, H, W, 3] when batch > 1
    memory_stats: Optional[Dict[str, Dict[str, float]]] = None  # per-phase device memory (GiB)
    final_prompt: Optional[str] = None  # the prompt actually encoded (after LoRA keywords and upsampling)
    was_upsampled: bool = False

    @property
    def latents(self) -> np.ndarray:
        """The final packed latents [B, S, 128] as a host array (JAX's
        ``GenerationResult.latents``), copied from the device when read."""
        return self.latents_device.cpu().numpy()


def _cancel_requested(cancel) -> bool:
    if cancel is None:
        return False
    return bool(getattr(cancel, "is_set", cancel)())


class _StepEnd:
    """What follows each step's Euler update, in the order of JAX's scan body
    and progress callback (``flux2_tpu/pipeline/pipeline.py:788-797``,
    ``:1028-1054``): the step hook, the cancel check, ``on_progress``,
    ``on_latents``; then, every ``collect_every``-th step below the last, a
    copy of the latents for a checkpoint image (``checkpoints``: (step, latents))."""

    def __init__(self, step_hook, cancel, on_progress, on_latents, sigma_pairs: np.ndarray, device: torch.device,
                 collect_every: Optional[int] = None):
        self.hook, self.state = _normalize_hook(step_hook)
        self.cancel, self.on_progress, self.on_latents = cancel, on_progress, on_latents
        self.total = len(sigma_pairs)
        self.collect_every = collect_every
        self.checkpoints: list = []
        # the hook's sigmas: float32 on the device, copied there once a call
        self.sigmas = (torch.tensor(sigma_pairs, dtype=torch.float32, device=device)
                       if self.hook is not None else None)

    def __call__(self, latents: torch.Tensor, step_idx: int) -> torch.Tensor:
        if self.hook is not None:
            sigma, sigma_next = self.sigmas[step_idx, 0], self.sigmas[step_idx, 1]
            if self.state is not None:
                latents = self.hook(self.state, latents, sigma, sigma_next, step_idx)
            else:
                latents = self.hook(latents, sigma, sigma_next, step_idx)
        step = step_idx + 1
        if _cancel_requested(self.cancel):
            raise GenerationCancelled(f"cancelled at step {step}/{self.total}")
        if self.on_progress is not None:
            self.on_progress(step, self.total)
        if self.on_latents is not None:
            self.on_latents(step, latents.to("cpu", copy=True).numpy())
        if self.collect_every and step % self.collect_every == 0 and step < self.total:
            self.checkpoints.append((step, latents.clone()))  # an in-place hook must not reach it
        return latents


@dataclasses.dataclass
class Flux2Pipeline:
    """Holds the DiT, the VAE decoder, an optional VAE encoder (I2I and
    img2img) and an optional text encoder; exposes generate()."""

    model: Flux2Model
    transformer: Flux2Transformer
    vae: VAEDecoder
    device: torch.device
    text_encoder: Optional[Callable[[str], torch.Tensor]] = None  # prompt -> [1, S, joint]
    text_encoder_name: Optional[str] = None  # the registry's key of the attached encoder ("qwen3-4b")
    text_encoder_quantization: str = "bf16"  # the attached encoder's format (keys train-lora's caption cache)
    encoders: Optional[Any] = None  # facade.TextEncoders holding the attached encoder (chat / upsample surface)
    vlm: Optional[Any] = None  # a vision service with analyze_image() (models/text_encoders/vlm_service.py)
    vlm_loader: Optional[Callable[[], Any]] = None  # lazy VLM load
    vae_encoder: Optional[VAEEncoder] = None
    max_pixels: int = 4096 * 4096
    # VAE compute dtype: the decode casts the VAE's float parameters and the
    # latents to it, as the JAX pipeline does (bf16 throughout, f32 GroupNorm
    # statistics); float32 for full-precision comparisons.
    vae_compute_dtype: torch.dtype = torch.bfloat16
    # utils.memory.MemoryProfile: the decode is tiled above its vae_tile_threshold_px
    memory_profile: Optional[Any] = None
    # LoRA runtime semantics of merged LoRAs (Turbo scheduler overrides and
    # activation keywords, set by cli.main.build_pipeline): explicit generate()
    # arguments win, then these, then the model's defaults.
    lora_custom_sigmas: Optional[Sequence[float]] = None
    lora_num_steps: Optional[int] = None
    lora_guidance: Optional[float] = None
    lora_keywords: Sequence[str] = ()
    # set by shard(): the DeviceMesh the DiT is sharded over, and (mesh, axis)
    # of ring attention under context parallelism
    mesh: Optional[Any] = None
    ring: Optional[Any] = None

    PROMPT_CACHE_SIZE = 8

    def __post_init__(self):
        self._prompt_cache: "OrderedDict[str, torch.Tensor]" = OrderedDict()
        self._prompt_lock = threading.Lock()
        self._cache_encoder = None
        self._cast_vae = (None, None, None)  # (source VAE, dtype, its cast copy)

    @classmethod
    def from_random(
        cls,
        model: Flux2Model = Flux2Model.KLEIN_4B,
        device: "torch.device | str" = "cuda",
        generator: Optional[torch.Generator] = None,
        dtype: torch.dtype = torch.bfloat16,
        transformer_config: Optional[Flux2TransformerConfig] = None,
        vae_config: Optional[VAEConfig] = None,
    ) -> "Flux2Pipeline":
        """Random-init pipeline drawn on ``device`` (default generator: seed 0
        there): the DiT, the VAE decoder, then the VAE encoder, so the first two
        draw what they drew before the encoder existed. The VAE keeps float32
        parameters, as JAX's ``from_random``."""
        device = torch.device(device)
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        tc = transformer_config or model.transformer_config
        vc = vae_config or FLUX2_VAE
        transformer = Flux2Transformer(tc, device=device, dtype=dtype, generator=generator)
        vae = VAEDecoder(vc, device=device, generator=generator)
        return cls(model=model, transformer=transformer, vae=vae, device=device,
                   vae_encoder=VAEEncoder(vc, device=device, generator=generator))

    def shard(self, mesh, context_parallel: bool = False) -> "Flux2Pipeline":
        """Distribute the DiT over a (data, fsdp, tp, sp) mesh (JAX's ``shard``):
        DIT_RULES shard its weights (heads and MLP hidden over tp, weights at
        rest over fsdp) and every rank keeps its chunk; the VAE stays
        replicated. A mesh whose axes all have size 1 shards nothing, so it
        leaves the weights as they are (as JAX's costs nothing on one device).
        ``context_parallel=True`` runs every unmasked attention as ring
        attention on ``sp`` when the mesh sizes it, else on ``tp``. Every
        rank calls ``generate`` with the same arguments, and so draws the
        same noise from the same seed."""
        from flux2_tpu_torch.parallel import sharding as sh
        from flux2_tpu_torch.parallel.mesh import SP_AXIS, TP_AXIS

        if not sh.shards_nothing(mesh):
            sh.shard_params(self.transformer, mesh, sh.DIT_RULES)
        self.mesh = mesh
        if context_parallel:
            self.ring = (mesh, SP_AXIS if sh.axis_size(mesh, SP_AXIS) > 1 else TP_AXIS)
        else:
            self.ring = None
        return self

    # -- phase 1: text encoding ------------------------------------------------

    def encode_prompt(self, prompt: str) -> torch.Tensor:
        """Prompt -> embeddings through ``text_encoder``, with a small LRU keyed by
        prompt (cleared when the encoder is swapped). Thread-safe: the server
        encodes on each request's own thread. A miss is a ``pipeline.encode``
        span, from the lock's acquisition to the synchronise, with the wait
        for the lock as ``lock_wait_s``."""
        if self.text_encoder is None:
            raise ValueError("no text encoder attached; pass `embeddings=` to generate()")
        asked = time.perf_counter()
        with self._prompt_lock:
            acquired = time.perf_counter()
            cache = self._prompt_cache
            if self._cache_encoder is not self.text_encoder:
                cache.clear()
                self._cache_encoder = self.text_encoder
            if prompt in cache:
                cache.move_to_end(prompt)
                return cache[prompt]
            with torch.inference_mode():
                emb = self.text_encoder(prompt)
            _sync(self.device)
            _profiler().record("pipeline.encode", acquired, time.perf_counter(), lock_wait_s=acquired - asked)
            cache[prompt] = emb
            while len(cache) > self.PROMPT_CACHE_SIZE:
                cache.popitem(last=False)
            return emb

    # -- VLM prompt services (interpret / upsample) -------------------------------

    VLM_ANALYSIS_PROMPT = (
        "Describe this image in detail. Focus on the main subject, colors, "
        "style, and any notable elements."
    )

    def _get_vlm(self):
        """The vision service, loaded by ``vlm_loader`` on first use."""
        if self.vlm is None and self.vlm_loader is not None:
            self.vlm = self.vlm_loader()
        return self.vlm

    def interpret_images(self, images: Sequence[np.ndarray], prompt: str, seed: int = 0) -> str:
        """VLM descriptions of ``images`` injected before the prompt (JAX's
        ``interpret_images``); raises JAX's error with no VLM."""
        vlm = self._get_vlm()
        if vlm is None:
            raise ValueError(
                "image interpretation requires a VLM (Mistral+Pixtral); none "
                "attached and no vlm_loader configured"
            )
        descs = []
        for i, img in enumerate(images):
            d = vlm.analyze_image(np.asarray(img), self.VLM_ANALYSIS_PROMPT, seed=seed).strip()
            if d:
                descs.append(f"Interpret image {i + 1}: {d}")
        if not descs:
            return prompt
        return "\n".join(descs) + f"\n\nUser request: {prompt}"

    def upsample_prompt(self, prompt: str, images: Optional[Sequence[np.ndarray]] = None,
                        mode: str = "upsampling_t2i", seed: int = 0) -> str:
        """The BFL prompt rewrite (``--upsample``, JAX's ``upsample_prompt``):
        text-only, a chat through the attached encoder facade; with reference
        ``images`` each is described by the VLM first and the enriched
        request is upsampled in T2I mode."""
        if self.encoders is None or self.text_encoder_name is None:
            raise ValueError("prompt upsampling requires an attached text encoder facade")
        if images:
            vlm = self._get_vlm()
            if vlm is None:
                raise ValueError(
                    "vision upsampling requires a VLM (Mistral+Pixtral); none "
                    "attached and no vlm_loader configured"
                )
            descs = []
            for i, img in enumerate(images):
                d = vlm.analyze_image(np.asarray(img), self.VLM_ANALYSIS_PROMPT, seed=seed).strip()
                if d:
                    descs.append(f"Image {i + 1}: {d}")
            if descs:
                prompt = (
                    "Reference images context:\n" + "\n".join(descs)
                    + f"\n\nUser request: {prompt}\n\n"
                    + "Generate an image that combines elements from the "
                    + "reference images according to the user's request."
                )
            mode = "upsampling_t2i"
        return self.encoders.upsample_prompt(prompt, self.text_encoder_name, mode=mode, seed=seed)

    # -- phases 2 + 3: denoise + decode ------------------------------------------

    def generate(
        self,
        prompt: Optional[str] = None,
        embeddings: Optional[torch.Tensor] = None,
        negative_embeddings: Optional[torch.Tensor] = None,  # classical CFG's uncond rows
        height: int = 1024,
        width: int = 1024,
        num_steps: Optional[int] = None,
        guidance: Optional[float] = None,
        seed: int = 0,
        reference_latents: Optional[torch.Tensor] = None,  # [B or 1, S_ref, 128] packed + normalized
        reference_ids: Optional[np.ndarray] = None,  # [S_ref, 4]
        strength: float = 1.0,
        init_latents: Optional[torch.Tensor] = None,  # [B or 1, S_img, 128] packed + normalized
        noise: Optional[torch.Tensor] = None,  # [B, S_img, 128] initial noise (overrides seed)
        custom_sigmas: Optional[Sequence[float]] = None,
        decode: bool = True,
        cancel: Optional[Any] = None,  # threading.Event-like or () -> bool
        step_hook: Optional[StepHook] = None,
        on_progress: Optional[Callable[[int, int], None]] = None,
        on_latents: Optional[Callable[[int, np.ndarray], None]] = None,  # per-step packed latents, on the host
        checkpoint_interval: Optional[int] = None,
        on_checkpoint: Optional[Callable[[int, np.ndarray], None]] = None,
        upsample: bool = False,
        upsample_images: Optional[Sequence[np.ndarray]] = None,
        interpret_images: Optional[Sequence[np.ndarray]] = None,
    ) -> GenerationResult:
        """Generate images: T2I by default; I2I with ``reference_latents`` and
        ``reference_ids`` (``encode_reference_images``); img2img with
        ``init_latents`` and ``strength`` < 1. ``custom_sigmas`` replaces the
        schedule (and ``strength``'s cut). The batch follows ``embeddings``'
        leading axis. A base model (``uses_classical_cfg``) guides with
        ``negative_embeddings``, or with the encoded "" prompt when an encoder
        is attached. Each phase is timed by the shared profiler (when it
        records: ``FLUX2_PROFILE=1``, or a ``torch.profiler`` running) and
        closed by a device-memory snapshot (``memory_stats``), as in JAX;
        inside "2. Denoising" each step is a ``dit.step`` span (``step``,
        ``batch``) from its top to the return of its step end, which without
        a hook or previews holds no synchronise: the host's dispatch of the
        step.

        After each step (k of n): ``step_hook`` rewrites the latents; a set
        ``cancel`` raises ``GenerationCancelled("cancelled at step k/n")``;
        ``on_progress(k, n)``; ``on_latents(k, latents)`` with the latents
        copied to the host (a device-to-host copy a step). With
        ``checkpoint_interval`` N and ``on_checkpoint``, the latents of steps
        N, 2N, ... below n stay on the device and are decoded after the loop:
        ``on_checkpoint(step, image)``, the image [H, W, 3] float32 in 1/255
        steps (first batch row). ``interpret_images`` (VLM descriptions put
        before the prompt) and ``upsample`` (the BFL rewrite, with vision when
        ``upsample_images`` is given) apply only when the prompt is encoded
        here, in that order after the LoRA keywords, as in JAX.

        ``num_steps``, ``guidance`` and ``custom_sigmas`` left None take the
        merged LoRAs' overrides (``lora_num_steps``, ...), then the model's
        defaults; a prompt encoded here is prefixed with each of
        ``lora_keywords`` it lacks, and ``final_prompt`` reports it."""
        prof = _profiler()
        mem = MemoryTelemetry(enabled=_mem_telemetry().enabled, device=self.device)  # per call
        t0 = time.perf_counter()
        timings: Dict[str, float] = {}
        height, width = lu.validate_dimensions(height, width)
        if height * width > self.max_pixels:
            raise ValueError(f"{width}x{height} exceeds max pixels {self.max_pixels}")
        if num_steps is None:
            num_steps = self.lora_num_steps if self.lora_num_steps else self.model.default_steps
        if guidance is None:
            guidance = self.lora_guidance if self.lora_guidance is not None else self.model.default_guidance
        if custom_sigmas is None and self.lora_custom_sigmas:
            custom_sigmas = self.lora_custom_sigmas

        t = time.perf_counter()
        prof.start("1. Text Encoding")
        final_prompt = prompt
        was_upsampled = False
        if embeddings is None:
            for kw in self.lora_keywords or ():  # the merged LoRAs' activation keywords
                if kw and kw.lower() not in (final_prompt or "").lower():
                    final_prompt = f"{kw}, {final_prompt}" if final_prompt else kw
            if interpret_images:
                final_prompt = self.interpret_images(interpret_images, final_prompt or "", seed=seed)
            if upsample:
                rewritten = self.upsample_prompt(final_prompt or "", images=upsample_images, seed=seed)
                was_upsampled = rewritten != final_prompt
                final_prompt = rewritten
            embeddings = self.encode_prompt(final_prompt or "")
        if self.model.uses_classical_cfg and negative_embeddings is None and self.text_encoder is not None:
            negative_embeddings = self.encode_prompt("")
        embeddings = torch.as_tensor(embeddings).to(self.device)
        if negative_embeddings is not None:
            negative_embeddings = torch.as_tensor(negative_embeddings).to(self.device)
        _sync(self.device)
        prof.end("1. Text Encoding")
        timings["text_encoding"] = time.perf_counter() - t
        mem.snapshot("text_encoding")

        _, _, num_patches = lu.latent_dims(height, width)
        if custom_sigmas is not None:
            schedule = sch.set_custom_sigmas(custom_sigmas)
        else:
            schedule = sch.set_timesteps(num_steps, image_seq_len=num_patches, strength=strength)
        batch = int(embeddings.shape[0])
        if noise is not None:
            latents = torch.as_tensor(noise).to(self.device, torch.float32)
        else:
            latents = lu.seeded_noise_seq(seed, height, width, batch, device=self.device)
        if init_latents is not None and strength < 1.0:
            # img2img: the encoded image noised to the schedule's first sigma
            init = torch.as_tensor(init_latents).to(self.device)
            latents = sch.scale_noise(init, schedule.initial_sigma, latents).to(torch.float32)

        # RoPE ids in the sequence's order: [txt ; img ; ref] (the references
        # follow the output tokens in every step); the KV path reorders them.
        txt_ids, img_ids = lu.text_position_ids(embeddings.shape[1]), lu.image_position_ids(height, width)
        if reference_latents is not None:
            if reference_ids is None:
                raise ValueError("reference_latents requires reference_ids")
            reference_latents = torch.as_tensor(reference_latents).to(self.device)
            reference_ids = np.asarray(reference_ids)
        kv_cached = reference_latents is not None and self.model.supports_kv_cache

        t = time.perf_counter()
        prof.start("2. Denoising")
        g = (torch.full((batch,), guidance, dtype=torch.float32, device=self.device)
             if self.model.uses_guidance_embeds else None)
        step_end = _StepEnd(step_hook, cancel, on_progress, on_latents, schedule.sigma_pairs(), self.device,
                            checkpoint_interval if on_checkpoint is not None else None)
        if kv_cached:
            # klein-9b-kv: step 0 extracts the references' K/V, steps 1+ reuse it
            extract_rope = self._rope([txt_ids, reference_ids, img_ids])
            cached_rope = self._rope([txt_ids, img_ids])
            latents = self._denoise_kv_cached(latents, embeddings, reference_latents, schedule.sigma_pairs(),
                                              extract_rope, cached_rope, g, step_end)
        else:
            ids = [txt_ids, img_ids] + ([reference_ids] if reference_latents is not None else [])
            cos, sin = self._rope(ids)
            negative = negative_embeddings if self.model.uses_classical_cfg else None
            latents = self._denoise(latents, embeddings, negative, schedule.sigma_pairs(), guidance, cos, sin, g,
                                    step_end, reference_latents)
        _sync(self.device)
        prof.end("2. Denoising")
        if schedule.num_steps:
            prof.record_step((time.perf_counter() - t) / schedule.num_steps)
        timings["denoising"] = time.perf_counter() - t
        mem.snapshot("denoising")

        # checkpoint images: decoded after the loop, as JAX decodes after its scan
        for step, kept in step_end.checkpoints:
            u8 = self.decode_latents_u8(kept, height, width).cpu().numpy()
            on_checkpoint(step, u8[0].astype(np.float32) / 255.0)

        t = time.perf_counter()
        prof.start("3. VAE Decoding")
        image = images = None
        if decode:
            u8 = self.decode_latents_u8(latents, height, width).cpu().numpy()
            images = u8.astype(np.float32) / 255.0
            image = images[0]
        prof.end("3. VAE Decoding")
        timings["vae_decoding"] = time.perf_counter() - t
        mem.snapshot("vae_decoding")

        return GenerationResult(
            image=image,
            latents_device=latents,
            seed=seed,
            num_steps=schedule.num_steps,
            duration_s=time.perf_counter() - t0,
            phase_timings=timings,
            images=images if images is not None and images.shape[0] > 1 else None,
            memory_stats=mem.as_dict() if mem.enabled else None,
            final_prompt=final_prompt,
            was_upsampled=was_upsampled,
        )

    def _rope(self, ids: Sequence[np.ndarray]) -> Tuple[torch.Tensor, torch.Tensor]:
        """cos/sin on the device for the concatenated position-id tables."""
        return rope_embeddings(torch.from_numpy(np.concatenate(ids, axis=0)).to(self.device))

    def _denoise(self, latents, embeddings, negative, sigma_pairs, guidance, cos, sin, g, step_end,
                 reference_latents=None) -> torch.Tensor:
        """Euler loop over (sigma, sigma_next) pairs; latents stay float32. For
        a base model, cond and uncond are batch rows of one forward and
        ``v = v_uncond + guidance * (v_cond - v_uncond)`` in the forward's dtype,
        as JAX's ``_denoise``; ``g`` is the guidance embedding's input or None.
        Reference tokens, broadcast over the batch, follow the output tokens in
        every forward, and the velocity is sliced back to the output tokens.
        ``step_end`` (``_StepEnd``) runs after every Euler update."""
        use_cfg = self.model.uses_classical_cfg
        if use_cfg and negative is None:
            raise ValueError("classical CFG requires negative embeddings")
        dtype = param_dtype(self.transformer.x_embedder)  # bf16 when x_embedder is quantized
        b, s_img = latents.shape[:2]
        ref = None
        if reference_latents is not None:
            ref = reference_latents.to(dtype).expand(b, -1, -1)
        if use_cfg:
            embeddings = torch.cat([embeddings, negative])
            g = torch.cat([g, g]) if g is not None else None
        prof = _profiler()
        with torch.inference_mode():
            for i, (sigma, sigma_next) in enumerate(sigma_pairs):
                with prof.span("dit.step", step=i, batch=b):
                    tstep = torch.full((b,), float(sigma), dtype=torch.float32, device=self.device)
                    x = latents.to(dtype)
                    if ref is not None:
                        x = torch.cat([x, ref], dim=1)
                    if use_cfg:
                        v2 = gather(self.transformer(torch.cat([x, x]), embeddings, torch.cat([tstep, tstep]), cos,
                                                     sin, guidance=g, ring=self.ring))
                        v_cond, v_uncond = v2[:b], v2[b:]
                        scale = torch.tensor(guidance, dtype=torch.float32, device=self.device).to(v2.dtype)
                        v = v_uncond + scale * (v_cond - v_uncond)
                    else:
                        v = gather(self.transformer(x, embeddings, tstep, cos, sin, guidance=g, ring=self.ring))
                    latents = sch.euler_step(latents, v[:, :s_img].to(torch.float32), sigma, sigma_next)
                    latents = step_end(latents, i)
        return latents

    def _denoise_kv_cached(self, latents, embeddings, reference_latents, sigma_pairs, extract_rope, cached_rope, g,
                           step_end) -> torch.Tensor:
        """klein-9b-kv denoising (JAX ``_denoise_kv_cached``): step 0 runs
        ``forward_kv_extract`` over [txt ; ref ; img] (``extract_rope``) and
        keeps every block's reference K/V; steps 1+ run ``forward_kv_cached``
        over [txt ; img] (``cached_rope``) with that cache. Classical CFG does
        not apply: klein-9b-kv is distilled. ``step_end`` runs after every
        Euler update, step 0's included."""
        dtype = param_dtype(self.transformer.x_embedder)
        b = latents.shape[0]
        ref = reference_latents.to(dtype).expand(b, -1, -1)
        cache = None
        prof = _profiler()
        with torch.inference_mode():
            for i, (sigma, sigma_next) in enumerate(sigma_pairs):
                with prof.span("dit.step", step=i, batch=b):
                    tstep = torch.full((b,), float(sigma), dtype=torch.float32, device=self.device)
                    x = latents.to(dtype)
                    if cache is None:
                        v, double_kv, single_kv = self.transformer.forward_kv_extract(
                            x, ref, embeddings, tstep, *extract_rope, guidance=g)
                        cache = (double_kv, single_kv)
                    else:
                        v = self.transformer.forward_kv_cached(x, embeddings, tstep, *cached_rope, *cache,
                                                               guidance=g, ring=self.ring)
                    v = gather(v)
                    latents = sch.euler_step(latents, v.to(torch.float32), sigma, sigma_next)
                    latents = step_end(latents, i)
        return latents

    # -- VAE encode: I2I references and img2img init ----------------------------

    def _require_vae_encoder(self) -> VAEEncoder:
        if self.vae_encoder is None:
            raise ValueError("no VAE encoder attached: I2I and img2img need one (Flux2Pipeline.vae_encoder)")
        return self.vae_encoder

    def encode_image_to_packed_sequence(self, image: np.ndarray, sample_posterior: bool = False,
                                        generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Image [H, W, 3] in [0, 1] (float, or uint8 / 255) -> packed normalized
        latents [1, S, 128] float32 on the device (JAX ``_encode_image_jit``),
        the VAE in float32 with TF32 off (see ``_full_f32``)."""
        encoder = self._require_vae_encoder()
        x = np.asarray(image)
        x = torch.tensor(x if x.dtype == np.uint8 else np.asarray(x, np.float32), device=self.device)
        with torch.inference_mode(), _full_f32():
            return encode_packed(encoder, self.vae, x, sample_posterior, generator)

    def encode_reference_images(
        self,
        images: Sequence[np.ndarray],
        max_pixels: int = 1024 * 1024,
    ) -> Tuple[torch.Tensor, np.ndarray]:
        """VAE-encode reference images for I2I: (packed reference latents [1,
        S_ref, 128], position ids [S_ref, 4] with T = 10 * (i + 1) for image
        i). Each image is first area-downscaled to at most ``max_pixels``,
        sides a multiple of 32."""
        self._require_vae_encoder()
        if len(images) > self.model.max_reference_images:
            raise ValueError(f"{len(images)} reference images > max {self.model.max_reference_images}")
        seqs, hs, ws = [], [], []
        for img in images:
            img = _downscale_to_max_pixels(img, max_pixels, multiple=32)
            seqs.append(self.encode_image_to_packed_sequence(img))
            hs.append(img.shape[0] // 16)
            ws.append(img.shape[1] // 16)
        return torch.cat(seqs, dim=1), lu.reference_image_position_ids(hs, ws)

    def _tiled(self, height: int, width: int) -> bool:
        """Whether a decode at this size is tiled: the memory profile's
        ``vae_tile_threshold_px`` is below its longer side (JAX ``decode_latents``)."""
        return bool(self.memory_profile is not None
                    and max(height, width) > self.memory_profile.vae_tile_threshold_px)

    def decode_latents(self, latents_seq: torch.Tensor, height: int, width: int) -> torch.Tensor:
        """Packed sequence [B, S, 128] -> float32 image [B, H, W, 3] in [0, 1]
        on the device (JAX ``decode_latents``: not quantized to 1/255).

        Tiled (``decode_tiled``) above the memory profile's threshold; else a
        dense batched decode while B*H*W <= 1024^2, image by image above it."""
        with torch.inference_mode():
            patched = lu.unpack_sequence_to_patchified(torch.as_tensor(latents_seq).to(self.device), height, width)
            mean, var = self.vae.get_batchnorm_stats()
            z = lu.unpatchify_latents(lu.denormalize_with_batchnorm(patched, mean, var))
            z = z.to(self.vae_compute_dtype)
            vae = self._vae_in_compute_dtype()
            if self._tiled(height, width):
                img = decode_tiled(vae, z)
            elif z.shape[0] * height * width > DECODE_BATCH_BUDGET_PIXELS:
                img = torch.cat([vae.decode(z[i : i + 1]) for i in range(z.shape[0])])
            else:
                img = vae.decode(z)
            return torch.clamp(img.to(torch.float32) * 0.5 + 0.5, 0.0, 1.0).permute(0, 2, 3, 1)

    def decode_latents_u8(self, latents_seq: torch.Tensor, height: int, width: int) -> torch.Tensor:
        """Packed sequence [B, S, 128] -> uint8 image [B, H, W, 3] on the device:
        ``decode_latents`` rounded to the nearest level, as JAX's device-side convert."""
        img = self.decode_latents(latents_seq, height, width)
        with torch.inference_mode():
            return torch.clamp(img * 255.0 + 0.5, 0.0, 255.0).to(torch.uint8)

    def _vae_in_compute_dtype(self) -> VAEDecoder:
        """The VAE with its float parameters in ``vae_compute_dtype``: JAX's
        ``_decode_latents_jit`` casts every VAE parameter before it decodes, so
        its default decode runs in bf16 to the end (GroupNorm's scale and shift
        rounded to bf16 as well). A copy, made once per VAE and dtype."""
        if self.vae.post_quant_conv.weight.dtype == self.vae_compute_dtype:
            return self.vae
        source, dtype, cast = self._cast_vae
        if source is not self.vae or dtype != self.vae_compute_dtype:
            cast = copy.deepcopy(self.vae).to(self.vae_compute_dtype)
            self._cast_vae = (self.vae, self.vae_compute_dtype, cast)
        return cast


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def _full_f32():
    """cuDNN and cuBLAS in full f32 (no TF32) inside the block; the process's
    flags are restored after it. The VAE encode runs under it: JAX encodes in f32, and
    TF32 convolutions moved the 1024^2 packed latents by 1.4e-3 relative L2
    on the H100 (PERF.md §6)."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def encode_packed(encoder: VAEEncoder, vae: VAEDecoder, image: torch.Tensor, sample_posterior: bool = False,
                  generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Image [H, W, 3] (float in [0, 1], or uint8) -> packed normalized latents
    [1, S, 128] float32, with ``vae``'s BatchNorm statistics; the math of JAX's
    ``_encode_image_jit``, computed under the caller's precision flags."""
    if image.dtype == torch.uint8:
        image = image.to(torch.float32) / 255.0
    # contiguous NCHW whatever the image's strides: a channels-last tensor
    # takes other cuDNN kernels, whose latents differ in the last bits
    x = (image[None].permute(0, 3, 1, 2) * 2.0 - 1.0).contiguous()
    z = encoder.encode(x, sample_posterior=sample_posterior, generator=generator)
    mean, var = vae.get_batchnorm_stats()
    return lu.pack_patchified_to_sequence(lu.normalize_with_batchnorm(lu.patchify_latents(z), mean, var))


def _downscale_to_max_pixels(image: np.ndarray, max_pixels: int, multiple: int = 32) -> np.ndarray:
    """Area-downscale so H*W <= max_pixels, sides rounded down to a multiple
    (JAX's copy: PIL's LANCZOS where PIL imports, else nearest sampling)."""
    h, w = image.shape[:2]
    scale = min(1.0, (max_pixels / (h * w)) ** 0.5)
    nh = max(multiple, int(h * scale) // multiple * multiple)
    nw = max(multiple, int(w * scale) // multiple * multiple)
    if (nh, nw) == (h, w):
        return image
    try:
        from PIL import Image

        im = Image.fromarray((np.clip(image, 0, 1) * 255).astype(np.uint8))
        return np.asarray(im.resize((nw, nh), Image.LANCZOS), dtype=np.float32) / 255.0
    except ImportError:
        # numpy fallback: nearest sampling
        ys = (np.arange(nh) * h / nh).astype(int)
        xs = (np.arange(nw) * w / nw).astype(int)
        return image[ys][:, xs]
