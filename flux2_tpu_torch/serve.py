"""Micro-batching image server: the generation core of ``flux2_tpu/serve.py``.

Requests go through ``Flux2Server.generate_png``: the prompt is encoded on
the caller's thread (``embeddings_fn``), the request is queued, and one
worker thread coalesces queued requests of the same (height, width, steps,
guidance) into one batched ``Flux2Pipeline.generate`` call. Each row's noise
comes from its own request's seed, so a coalesced row equals a solo
generate with that seed. The batch cap is the JAX server's MXU-fill rule:
images above ``SATURATION_TOKENS`` image tokens run alone; smaller ones batch
up to ``FILL_TOKENS`` image tokens. Those constants were measured on a TPU
v5e and have not been re-measured on the H100.

I2I: a request's ``"references"`` (base64 images, data URLs too; read by
Pillow where it imports, else PNG only, by the port's own decoder) are
VAE-encoded when its batch runs, and with ``"strength"`` < 1 the first
reference is also the img2img init. Every I2I request runs as a batch of one:
its references are its own, and its noise row assumes it. A non-numeric
``"strength"`` is refused with ValueError before queueing. PNGs are written
with the standard library (``flux2_tpu_torch.io.png``). The HTTP handler,
chat, embed, previews and the web UI are not ported yet.
"""

from __future__ import annotations

import base64
import collections
import math
import threading
import time
from typing import Optional

import numpy as np
import torch

from flux2_tpu_torch.io.png import decode_image, encode_png
from flux2_tpu_torch.ops import latents as lu


class QueueFullError(RuntimeError):
    pass


class _Pending:
    __slots__ = ("req", "emb", "refs", "strength", "encode_s", "event", "cancelled", "image", "error",
                 "enqueued_at")

    def __init__(self, req: dict, emb: Optional[torch.Tensor], encode_s: float = 0.0, refs: Optional[list] = None,
                 strength: float = 1.0):
        self.req = req
        self.emb = emb
        self.refs = refs  # reference images [H, W, 3] float32 (I2I), or None
        self.strength = strength  # the request's "strength", checked by generate_png
        self.encode_s = encode_s
        self.event = threading.Event()
        self.cancelled = threading.Event()
        self.image = None
        self.error = None
        self.enqueued_at = time.time()


class _BatchCancel:
    """True once EVERY request in the batch has been abandoned: one run serves
    the whole batch, so a single waiting client keeps it going."""

    def __init__(self, batch):
        self.batch = batch

    def __call__(self) -> bool:
        return all(p.cancelled.is_set() for p in self.batch)


class Flux2Server:
    # Batch cap (see the module docstring): bs=1 above SATURATION_TOKENS
    # image tokens, else up to FILL_TOKENS image tokens per batch.
    SATURATION_TOKENS = 512
    FILL_TOKENS = 2048

    def __init__(
        self,
        pipeline,
        embeddings_fn=None,
        max_batch: int = 8,
        batch_window_s: float = 0.05,
        max_queue: int = 64,
        max_wait_s: float = 10.0,
    ):
        self.pipeline = pipeline
        self.embeddings_fn = embeddings_fn  # prompt -> [1, S_txt, joint] embeddings
        self.lock = threading.Lock()
        self.requests_served = 0
        self.batches_run = 0
        # Per-request phase times of the most recent requests (newest last).
        self.request_timings: collections.deque = collections.deque(maxlen=256)
        self.max_batch = max_batch
        self.batch_window_s = batch_window_s
        self.max_queue = max_queue
        self.max_wait_s = max_wait_s
        self._queue: list = []
        self._queue_cv = threading.Condition()
        self._shutdown = False
        self._worker = threading.Thread(target=self._serve_loop, daemon=True)
        self._worker.start()

    def shutdown(self) -> None:
        """Stop the batching worker."""
        with self._queue_cv:
            self._shutdown = True
            self._queue_cv.notify_all()
        self._worker.join(timeout=60)

    # -- micro-batching worker ------------------------------------------------

    def _shape_key(self, p: _Pending):
        """Requests of one key may share a batch: (height, width, steps,
        guidance, strength), and for an I2I request its own identity, so that
        it always runs alone. JAX's key has no strength: there, T2I requests
        of different strengths share a batch and all run the first one's."""
        req = p.req
        key = (int(req.get("height", 1024)), int(req.get("width", 1024)), req.get("steps"), req.get("guidance"),
               p.strength)
        return key + (id(p),) if p.refs is not None else key

    def _batch_cap(self, key) -> int:
        h, w = key[0], key[1]
        img_tokens = max(1, (h // 16) * (w // 16))
        if img_tokens > self.SATURATION_TOKENS:
            return 1
        return max(1, min(self.max_batch, self.FILL_TOKENS // img_tokens))

    def _pick_batch(self) -> list:
        """Run the largest same-shape group, unless the oldest request has waited
        past ``max_wait_s``: then its group goes first. Abandoned requests are
        dropped here. Called with ``_queue_cv`` held."""
        self._queue = [p for p in self._queue if not p.cancelled.is_set()]
        if not self._queue:
            return []
        groups = self._groups()
        oldest = self._queue[0]
        if time.time() - oldest.enqueued_at > self.max_wait_s:
            key = self._shape_key(oldest)
        else:
            key = max(groups, key=lambda k: (len(groups[k]), -groups[k][0].enqueued_at))
        batch = groups[key][: self._batch_cap(key)]
        for p in batch:
            self._queue.remove(p)
        return batch

    def _groups(self) -> dict:
        """Queued requests by shape key, oldest first within each group."""
        groups: dict = {}
        for p in self._queue:
            groups.setdefault(self._shape_key(p), []).append(p)
        return groups

    def _full_batch_queued(self) -> bool:
        return any(len(g) >= self._batch_cap(key) for key, g in self._groups().items())

    def _serve_loop(self):
        while True:
            with self._queue_cv:
                while not self._queue and not self._shutdown:
                    self._queue_cv.wait()
                # Coalescing window from the first queued request. Unlike the
                # JAX server's single wait, a new arrival does not end it; a
                # full batch does.
                deadline = time.monotonic() + self.batch_window_s
                while not self._shutdown and not self._full_batch_queued():
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        break
                    self._queue_cv.wait(remaining)
                if self._shutdown:
                    return
                batch = self._pick_batch()
            if batch:
                self._run_batch(batch)

    def _run_batch(self, batch):
        try:
            h, w, steps, guidance, strength = self._shape_key(batch[0])[:5]
            req0 = batch[0].req
            emb = None
            if batch[0].emb is not None:
                emb = torch.cat([p.emb for p in batch], dim=0)
            hv, wv = lu.validate_dimensions(h, w)
            device = self.pipeline.device
            noise = torch.cat([
                lu.seeded_noise_seq(int(p.req.get("seed", 0)), hv, wv, 1, device=device) for p in batch
            ])
            # I2I (a batch of one by its key): the references are encoded here,
            # and with strength < 1 the first one is also the init
            ref_lat = ref_ids = init = None
            refs = batch[0].refs
            if refs is not None:
                ref_lat, ref_ids = self.pipeline.encode_reference_images(refs)
                if strength < 1.0:
                    init = self.pipeline.encode_image_to_packed_sequence(refs[0])
            res = self.pipeline.generate(
                prompt=req0.get("prompt", ""),
                embeddings=emb,
                height=h,
                width=w,
                num_steps=steps,
                guidance=guidance,
                seed=int(req0.get("seed", 0)),
                noise=noise,
                reference_latents=ref_lat,
                reference_ids=ref_ids,
                strength=strength,
                init_latents=init,
                cancel=_BatchCancel(batch),
            )
            images = res.images if res.images is not None else res.image[None]
            pt = res.phase_timings
            for i, p in enumerate(batch):
                p.image = images[i]
                self.request_timings.append({
                    "height": hv, "width": wv, "steps": res.num_steps, "batch_size": len(batch),
                    "text_encoding_s": p.encode_s, "denoising_s": pt["denoising"],
                    "vae_decoding_s": pt["vae_decoding"],
                })
        except Exception as e:  # surfaced to every request of the batch
            for p in batch:
                p.error = e
        finally:
            with self.lock:
                self.requests_served += len(batch)
                self.batches_run += 1
            for p in batch:
                p.event.set()

    # -- request path -----------------------------------------------------------

    def generate_png(self, req: dict) -> bytes:
        """One request ({"prompt", "height", "width", "steps", "guidance", "seed",
        "references", "strength", "timeout_s"}) -> PNG bytes. Blocks until its
        batch has run."""
        emb, encode_s = None, 0.0
        if self.embeddings_fn is not None:
            t = time.perf_counter()
            emb = self.embeddings_fn(req.get("prompt", ""))
            encode_s = time.perf_counter() - t
        pending = _Pending(req, emb, encode_s, refs=_decode_references(req), strength=_strength(req))
        with self._queue_cv:
            if len(self._queue) >= self.max_queue:
                raise QueueFullError(f"queue full ({self.max_queue} pending); retry later")
            self._queue.append(pending)
            self._queue_cv.notify_all()
        timeout = req.get("timeout_s")
        if not pending.event.wait(timeout=float(timeout) if timeout else None):
            # abandoned: dropped if still queued; a running batch stops once all
            # of its requests are abandoned
            pending.cancelled.set()
            raise TimeoutError(f"generation exceeded timeout_s={timeout}")
        if pending.error is not None:
            raise pending.error
        return encode_png(np.rint(np.clip(pending.image, 0.0, 1.0) * 255.0).astype(np.uint8))


def _strength(req: dict) -> float:
    """The request's "strength" as a float (1.0 when absent); ValueError for
    anything else, raised to the caller before the request is queued."""
    value = req.get("strength", 1.0)
    try:
        strength = float(value)
    except (TypeError, ValueError):
        strength = math.nan
    if isinstance(value, bool) or not math.isfinite(strength):
        raise ValueError(f'"strength" must be a finite number (clamped to [0.01, 1]), got {value!r}')
    return strength


def _decode_references(req: dict) -> Optional[list]:
    """The request's base64 reference images -> [H, W, 3] float32 arrays, or None."""
    refs_b64 = req.get("references") or []
    if not refs_b64:
        return None
    refs = []
    for b in refs_b64:
        if isinstance(b, str) and "," in b and b.lstrip().startswith("data:"):
            b = b.split(",", 1)[1]  # a data URL
        refs.append(decode_image(base64.b64decode(b)))
    return refs
