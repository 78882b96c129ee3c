"""FLUX.2 text-to-image pipeline in PyTorch.

Port of the T2I branch of ``flux2_tpu/pipeline/pipeline.py``: prompt ->
text encoder (LRU-cached) -> seeded noise -> Euler denoising over the
FLUX.2 sigma schedule -> VAE decode -> uint8, with JAX's classical CFG for
the base models (cond and uncond as batch rows of one forward, the "" negative
encoded through the same LRU). Where JAX compiles the denoise loop into one
``lax.scan``, the port runs a Python loop over the schedule under
``torch.inference_mode()``; cancellation is checked on the host between steps.
I2I, img2img strength, step hooks, previews and checkpoint images are not
ported yet.

The noise comes from a ``torch.Generator`` seeded with ``seed``: JAX uses
threefry, so one seed gives different images in the two packages. Pass
``noise=`` to reproduce a JAX run.
"""

from __future__ import annotations

import copy
import dataclasses
import threading
import time
from collections import OrderedDict
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from flux2_tpu_torch.models.flux2.config import Flux2Model, Flux2TransformerConfig
from flux2_tpu_torch.models.flux2.transformer import Flux2Transformer
from flux2_tpu_torch.models.flux2.vae import FLUX2_VAE, VAEConfig, VAEDecoder
from flux2_tpu_torch.ops import latents as lu
from flux2_tpu_torch.ops.quant import param_dtype
from flux2_tpu_torch.ops import scheduler as sch
from flux2_tpu_torch.ops.rope import rope_embeddings
from flux2_tpu_torch.utils.memory import MemoryTelemetry, telemetry as _mem_telemetry
from flux2_tpu_torch.utils.profiler import shared as _profiler

# Largest total pixel count decoded as one dense batch; above it the decode
# runs image by image to bound the decoder's peak activation memory.
DECODE_BATCH_BUDGET_PIXELS = 1024 * 1024


class GenerationCancelled(RuntimeError):
    """Raised when the ``cancel`` flag is set between two denoising steps."""


@dataclasses.dataclass
class GenerationResult:
    image: np.ndarray  # [H, W, 3] float32 in [0, 1], 1/255 steps (first batch row)
    latents: torch.Tensor  # final packed latents [B, S, 128] float32, on the device
    seed: int
    num_steps: int
    duration_s: float
    phase_timings: Dict[str, float]
    images: Optional[np.ndarray] = None  # [B, H, W, 3] when batch > 1
    memory_stats: Optional[Dict[str, Dict[str, float]]] = None  # per-phase device memory (GiB)


def _cancel_requested(cancel) -> bool:
    if cancel is None:
        return False
    return bool(getattr(cancel, "is_set", cancel)())


@dataclasses.dataclass
class Flux2Pipeline:
    """Holds the DiT, the VAE decoder and an optional text encoder; exposes generate()."""

    model: Flux2Model
    transformer: Flux2Transformer
    vae: VAEDecoder
    device: torch.device
    text_encoder: Optional[Callable[[str], torch.Tensor]] = None  # prompt -> [1, S, joint]
    max_pixels: int = 4096 * 4096
    # VAE compute dtype: the decode casts the VAE's float parameters and the
    # latents to it, as the JAX pipeline does (bf16 throughout, f32 GroupNorm
    # statistics); float32 for full-precision comparisons.
    vae_compute_dtype: torch.dtype = torch.bfloat16

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
        """Random-init pipeline drawn on ``device`` (default generator: seed 0 there).
        The VAE keeps float32 parameters, as JAX's ``from_random``."""
        device = torch.device(device)
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        tc = transformer_config or model.transformer_config
        return cls(
            model=model,
            transformer=Flux2Transformer(tc, device=device, dtype=dtype, generator=generator),
            vae=VAEDecoder(vae_config or FLUX2_VAE, device=device, generator=generator),
            device=device,
        )

    # -- phase 1: text encoding ------------------------------------------------

    def encode_prompt(self, prompt: str) -> torch.Tensor:
        """Prompt -> embeddings through ``text_encoder``, with a small LRU keyed by
        prompt (cleared when the encoder is swapped). Thread-safe: the server
        encodes on each request's own thread."""
        if self.text_encoder is None:
            raise ValueError("no text encoder attached; pass `embeddings=` to generate()")
        with self._prompt_lock:
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
            cache[prompt] = emb
            while len(cache) > self.PROMPT_CACHE_SIZE:
                cache.popitem(last=False)
            return emb

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
        noise: Optional[torch.Tensor] = None,  # [B, S_img, 128] initial noise (overrides seed)
        decode: bool = True,
        cancel: Optional[Any] = None,  # threading.Event-like or () -> bool
    ) -> GenerationResult:
        """Text to image. The batch follows ``embeddings``' leading axis. A
        base model (``uses_classical_cfg``) guides with ``negative_embeddings``,
        or with the encoded "" prompt when an encoder is attached. Each phase
        is timed by the shared profiler (when ``FLUX2_PROFILE=1``) and closed
        by a device-memory snapshot (``memory_stats``), as in JAX."""
        prof = _profiler()
        mem = MemoryTelemetry(enabled=_mem_telemetry().enabled, device=self.device)  # per call
        t0 = time.perf_counter()
        timings: Dict[str, float] = {}
        height, width = lu.validate_dimensions(height, width)
        if height * width > self.max_pixels:
            raise ValueError(f"{width}x{height} exceeds max pixels {self.max_pixels}")
        if num_steps is None:
            num_steps = self.model.default_steps
        if guidance is None:
            guidance = self.model.default_guidance

        t = time.perf_counter()
        prof.start("1. Text Encoding")
        if embeddings is None:
            embeddings = self.encode_prompt(prompt or "")
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
        schedule = sch.set_timesteps(num_steps, image_seq_len=num_patches)
        batch = int(embeddings.shape[0])
        if noise is not None:
            latents = torch.as_tensor(noise).to(self.device, torch.float32)
        else:
            latents = lu.seeded_noise_seq(seed, height, width, batch, device=self.device)

        ids = np.concatenate([lu.text_position_ids(embeddings.shape[1]), lu.image_position_ids(height, width)])
        cos, sin = rope_embeddings(torch.from_numpy(ids).to(self.device))

        t = time.perf_counter()
        prof.start("2. Denoising")
        g = (torch.full((batch,), guidance, dtype=torch.float32, device=self.device)
             if self.model.uses_guidance_embeds else None)
        negative = negative_embeddings if self.model.uses_classical_cfg else None
        latents = self._denoise(latents, embeddings, negative, schedule.sigma_pairs(), guidance, cos, sin, g,
                                cancel)
        _sync(self.device)
        prof.end("2. Denoising")
        if schedule.num_steps:
            prof.record_step((time.perf_counter() - t) / schedule.num_steps)
        timings["denoising"] = time.perf_counter() - t
        mem.snapshot("denoising")

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
            latents=latents,
            seed=seed,
            num_steps=schedule.num_steps,
            duration_s=time.perf_counter() - t0,
            phase_timings=timings,
            images=images if images is not None and images.shape[0] > 1 else None,
            memory_stats=mem.as_dict() if mem.enabled else None,
        )

    def _denoise(self, latents, embeddings, negative, sigma_pairs, guidance, cos, sin, g, cancel) -> torch.Tensor:
        """Euler loop over (sigma, sigma_next) pairs; latents stay float32. For
        a base model, cond and uncond are batch rows of one forward and
        ``v = v_uncond + guidance * (v_cond - v_uncond)`` in the forward's dtype,
        as JAX's ``_denoise``; ``g`` is the guidance embedding's input or None."""
        use_cfg = self.model.uses_classical_cfg
        if use_cfg and negative is None:
            raise ValueError("classical CFG requires negative embeddings")
        dtype = param_dtype(self.transformer.x_embedder)  # bf16 when x_embedder is quantized
        b = latents.shape[0]
        if use_cfg:
            embeddings = torch.cat([embeddings, negative])
            g = torch.cat([g, g]) if g is not None else None
        with torch.inference_mode():
            for i, (sigma, sigma_next) in enumerate(sigma_pairs):
                if _cancel_requested(cancel):
                    raise GenerationCancelled(f"cancelled at step {i + 1}/{len(sigma_pairs)}")
                tstep = torch.full((b,), float(sigma), dtype=torch.float32, device=self.device)
                x = latents.to(dtype)
                if use_cfg:
                    v2 = self.transformer(torch.cat([x, x]), embeddings, torch.cat([tstep, tstep]), cos, sin,
                                          guidance=g)
                    v_cond, v_uncond = v2[:b], v2[b:]
                    scale = torch.tensor(guidance, dtype=torch.float32, device=self.device).to(v2.dtype)
                    v = v_uncond + scale * (v_cond - v_uncond)
                else:
                    v = self.transformer(x, embeddings, tstep, cos, sin, guidance=g)
                latents = sch.euler_step(latents, v.to(torch.float32), sigma, sigma_next)
        return latents

    def decode_latents_u8(self, latents_seq: torch.Tensor, height: int, width: int) -> torch.Tensor:
        """Packed sequence [B, S, 128] -> uint8 image [B, H, W, 3] on the device.

        Dense batched decode while B*H*W <= 1024^2, image by image above it."""
        with torch.inference_mode():
            patched = lu.unpack_sequence_to_patchified(latents_seq, height, width)
            mean, var = self.vae.get_batchnorm_stats()
            z = lu.unpatchify_latents(lu.denormalize_with_batchnorm(patched, mean, var))
            z = z.to(self.vae_compute_dtype)
            vae = self._vae_in_compute_dtype()
            if z.shape[0] * height * width > DECODE_BATCH_BUDGET_PIXELS:
                img = torch.cat([vae.decode(z[i : i + 1]) for i in range(z.shape[0])])
            else:
                img = vae.decode(z)
            img = torch.clamp(img.to(torch.float32) * 0.5 + 0.5, 0.0, 1.0).permute(0, 2, 3, 1)
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
