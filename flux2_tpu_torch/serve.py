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
with the standard library (``flux2_tpu_torch.io.png``).

Live previews: a request with a ``"preview_id"`` makes its batch pass
``on_latents`` to ``generate`` (a batch without one passes none, and pays no
device-to-host copy a step); after each step its row's latents become a small
PNG (``packed_to_rgb_preview``: three latent channels at h/8 x w/8, no VAE)
that ``get_preview(preview_id)`` returns with the step and the total. The
store keeps at most 256 previews; past that, those older than 300 s go, then
the oldest. The HTTP handler (``/preview`` among its routes), chat, embed and
the web UI are not ported yet.
"""

from __future__ import annotations

import base64
import collections
import functools
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


PREVIEW_CAP = 256  # previews kept
PREVIEW_MAX_AGE_S = 300.0  # age past which a preview may go once the store is over its cap


def packed_to_rgb_preview(seq: np.ndarray, height: int, width: int) -> np.ndarray:
    """Packed latent row [S, 128] -> [height/8, width/8, 3] RGB in [0, 1]: the
    first three latent channels, stretched between their 2nd and 98th
    percentiles (JAX ``packed_to_rgb_preview``: no VAE decode per step)."""
    patchified = lu.unpack_sequence_to_patchified(torch.from_numpy(np.asarray(seq, np.float32))[None], height, width)
    lat = lu.unpatchify_latents(patchified)[0].numpy()  # [C, h/8, w/8]
    rgb = np.transpose(lat[:3], (1, 2, 0))
    lo, hi = np.percentile(rgb, 2.0), np.percentile(rgb, 98.0)
    return np.clip((rgb - lo) / max(hi - lo, 1e-6), 0.0, 1.0)


class _Pending:
    __slots__ = ("req", "emb", "refs", "strength", "encode_s", "event", "cancelled", "image", "error",
                 "enqueued_at", "preview_id")

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
        self.preview_id = req.get("preview_id")  # opt-in live previews


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
        self._previews: dict = {}  # preview id -> {"step", "total", "png", "t"}
        self._previews_lock = threading.Lock()
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
            watchers = [(i, p.preview_id) for i, p in enumerate(batch) if p.preview_id]
            on_latents = functools.partial(self._preview_dispatch, watchers, hv, wv, steps or 0) if watchers else None
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
                on_latents=on_latents,
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

    # -- live previews ------------------------------------------------------------

    def _preview_dispatch(self, watchers, height: int, width: int, total: int, step: int, lat: np.ndarray) -> None:
        """``on_latents`` of a batch with previews: one PNG per watching row."""
        for row, pid in watchers:
            png = encode_png(np.rint(packed_to_rgb_preview(lat[row], height, width) * 255.0).astype(np.uint8))
            self._store_preview(pid, step, total, png)

    def _store_preview(self, pid, step: int, total: int, png: bytes) -> None:
        now = time.time()
        with self._previews_lock:
            self._previews[str(pid)[:64]] = {"step": step, "total": total, "png": png, "t": now}
            if len(self._previews) > PREVIEW_CAP:
                # the stale ones first, then the oldest: age alone never shrinks
                # the store under a stream of fresh ids
                for k in [k for k, v in self._previews.items() if now - v["t"] > PREVIEW_MAX_AGE_S]:
                    del self._previews[k]
                while len(self._previews) > PREVIEW_CAP:
                    del self._previews[min(self._previews, key=lambda k: self._previews[k]["t"])]

    def get_preview(self, pid):
        """The latest preview of ``pid`` ({"step", "total", "png", "t"}), or None."""
        with self._previews_lock:
            return self._previews.get(pid)

    # -- request path -----------------------------------------------------------

    def generate_png(self, req: dict) -> bytes:
        """One request ({"prompt", "height", "width", "steps", "guidance", "seed",
        "references", "strength", "preview_id", "timeout_s"}) -> PNG bytes.
        Blocks until its batch has run."""
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
