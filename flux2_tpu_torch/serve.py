"""HTTP serving endpoint of the PyTorch port: ``flux2_tpu/serve.py`` on the card.

    python -m flux2_tpu_torch.serve --random-init --port 8080 [--device cpu]

A small JSON-over-HTTP API (standard library only: ``http.server``) over a
resident pipeline, with JAX's routes, status codes and bodies
(``make_handler``; ``tests/test_torch_serve_http.py`` holds them against
JAX's byte for byte):

  GET  /health, /info, /models   status; device and model info; the model
                                 inventory (registry repos on disk, device memory)
  GET  / (or /index.html)        the web UI (JAX's ``_DEMO_HTML``)
  GET  /preview?id=...           the latest preview PNG of a request with a
                                 "preview_id" (X-Step / X-Total-Steps), 404 before
  POST /generate                 {"prompt", "width", "height", "steps", "guidance",
                                 "seed", "format": "png"|"json", "references",
                                 "strength", "timeout_s", "preview_id"} -> PNG or
                                 base64 JSON; 503 on a full queue, 504 past
                                 timeout_s, 400 otherwise
  POST /embed                    {"prompt", "format": "json"|"npy"}: the conditioning
                                 embeddings' stats, or the [1, S, dim] float32 array
  POST /chat                     chat on the attached encoder through its facade
                                 (JSON, or chunked with a \\x1e stats trailer);
                                 503 without one (--no-text-encoder)

Micro-batching (``Flux2Server.generate_png``): the prompt is encoded on the
caller's thread (``embeddings_fn``), the request is queued, and one worker
thread coalesces queued requests of the same (height, width, steps, guidance,
strength) into one batched ``Flux2Pipeline.generate`` call. Each row's noise
comes from its own request's seed, so a coalesced row equals a solo generate
with that seed. The batch cap is the JAX server's MXU-fill rule: images above
``SATURATION_TOKENS`` image tokens run alone; smaller ones batch up to
``FILL_TOKENS`` image tokens. Those constants were measured on a TPU v5e and
have not been re-measured on the H100. ``chip_lock`` is held around each
batch's device work and around ``embed`` and ``chat``; ``cancel_all``
abandons every queued request and the running batch, which stops at its next
step end (``_BatchCancel``). While the shared profiler records
(``utils/profiler.py``), each request taken leaves a ``serve.queue`` span
(its enqueue to its pick, with the batch's size) and each PNG written a
``serve.png`` span.

I2I: a request's ``"references"`` (base64 images, data URLs too; read by
Pillow where it imports, else PNG only, by the port's own decoder) are
VAE-encoded when its batch runs, and with ``"strength"`` < 1 the first
reference is also the img2img init. Every I2I request runs as a batch of one:
its references are its own, and its noise row assumes it. A non-numeric
``"strength"`` is refused with ValueError before queueing. PNGs are written
with the standard library (``flux2_tpu_torch.io.png``), their pixels JAX's
(``to_u8``: truncated).

Live previews: a request with a ``"preview_id"`` makes its batch pass
``on_latents`` to ``generate`` (a batch without one passes none, and pays no
device-to-host copy a step); after each step its row's latents become a small
PNG (``packed_to_rgb_preview``: three latent channels at h/8 x w/8, no VAE)
that ``get_preview(preview_id)`` returns with the step and the total. The
store keeps at most 256 previews; past that, those older than 300 s go, then
the oldest.

``main`` takes JAX's flags and ``--device`` (``cuda`` unless asked for the
CPU). With ``--random-init`` the pipeline carries a random encoder of the
model's family in ``facade.shared`` (``cli.main.build_pipeline``), so
``/embed`` and ``/chat`` answer where JAX's random-init server answers 503.

``--tp N`` (N > 1) shards the pipeline's DiT over a (1, 1, N) mesh, as JAX's
``main`` does. JAX's one process drives every chip; the port runs one
process per rank under torchrun (``python -m torch.distributed.run
--nproc-per-node N -m flux2_tpu_torch.serve --tp N ...``). Rank 0 runs the
server and the HTTP layer through ``_Leader``, which broadcasts each batch's
``generate`` arguments (``broadcast_object_list`` for the plain ones, one
``broadcast`` per tensor: the embeddings, the noise, the references) before
it calls ``generate``; the other ranks run ``_follow``, which receives them
and makes the same call, so every collective of the sharded forward meets
its partners. Between batches a follower waits on the process group's store
(``_await_call``), never inside a collective: a collective gives up after the
group's timeout (10 minutes on NCCL, 30 on gloo), and a server may sit idle
far longer. Rank 0 counts each call up in the store (``_send_call``) just
before it broadcasts it. The cancel check of every step is broadcast from
rank 0 (``_SyncedCancel``), and so is shutdown. Previews and the decoded
image are rank 0's; the followers skip the decode. A machine with fewer CUDA
devices than N exits naming both counts.
"""

from __future__ import annotations

import argparse
import base64
import functools
import io
import json
import logging
import math
import os
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np
import torch

from flux2_tpu_torch.io.png import decode_image, encode_png, to_u8
from flux2_tpu_torch.ops import latents as lu
from flux2_tpu_torch.pipeline.pipeline import GenerationCancelled, _cancel_requested
from flux2_tpu_torch.utils.profiler import shared as _profiler


class ChatUnavailableError(RuntimeError):
    """Raised by /chat and /embed when no text encoder is attached."""


class QueueFullError(RuntimeError):
    pass


_NO_CHAT = ("no text encoder attached — start serve with real weights "
            "(not --random-init / --no-text-encoder) to enable chat")


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
    __slots__ = ("req", "emb", "refs", "strength", "event", "cancelled", "image", "error", "enqueued_at",
                 "preview_id")

    def __init__(self, req: dict, emb: Optional[torch.Tensor], refs: Optional[list] = None, strength: float = 1.0):
        self.req = req
        self.emb = emb
        self.refs = refs  # reference images [H, W, 3] float32 (I2I), or None
        self.strength = strength  # the request's "strength", checked by generate_png
        self.event = threading.Event()
        self.cancelled = threading.Event()
        self.image = None
        self.error = None
        self.enqueued_at = time.perf_counter()  # the profiler's clock, for the serve.queue span
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
        chat_fn=None,
    ):
        self.pipeline = pipeline
        self.embeddings_fn = embeddings_fn  # prompt -> [1, S_txt, joint] embeddings
        self.chat_fn = chat_fn  # (messages, max_tokens=, temperature=, seed=, on_token=) -> reply
        self.lock = threading.Lock()
        # the card runs one thing at a time: batches (worker thread), embed and
        # chat (handler threads) take this lock around their device work
        self.chip_lock = threading.Lock()
        self.started = time.time()
        self.requests_served = 0
        self.batches_run = 0
        self.chats_served = 0
        self.embeds_served = 0
        self.max_batch = max_batch
        self.batch_window_s = batch_window_s
        self.max_queue = max_queue
        self.max_wait_s = max_wait_s
        self._previews: dict = {}  # preview id -> {"step", "total", "png", "t"}
        self._previews_lock = threading.Lock()
        self._queue: list = []
        self._running_batch: Optional[list] = None  # the batch in flight (cancel_all)
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
        dropped here, and their callers released with ``GenerationCancelled``.
        The batch becomes ``_running_batch``, and each request taken a
        ``serve.queue`` span (enqueue to pick, ``batch``: the batch's size).
        Called with ``_queue_cv`` held."""
        for p in self._queue:
            if p.cancelled.is_set():
                p.error = GenerationCancelled("cancelled before it ran")
                p.event.set()
        self._queue = [p for p in self._queue if not p.cancelled.is_set()]
        if not self._queue:
            return []
        groups = self._groups()
        oldest = self._queue[0]
        now = time.perf_counter()
        if now - oldest.enqueued_at > self.max_wait_s:
            key = self._shape_key(oldest)
        else:
            key = max(groups, key=lambda k: (len(groups[k]), -groups[k][0].enqueued_at))
        batch = groups[key][: self._batch_cap(key)]
        prof = _profiler()
        for p in batch:
            self._queue.remove(p)
            prof.record("serve.queue", p.enqueued_at, now, batch=len(batch))
        self._running_batch = batch  # visible to cancel_all during the run
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
                try:
                    self._run_batch(batch)
                finally:
                    self._running_batch = None

    def _run_batch(self, batch):
        try:
            h, w, steps, guidance, strength = self._shape_key(batch[0])[:5]
            req0 = batch[0].req
            hv, wv = lu.validate_dimensions(h, w)
            watchers = [(i, p.preview_id) for i, p in enumerate(batch) if p.preview_id]
            on_latents = functools.partial(self._preview_dispatch, watchers, hv, wv, steps or 0) if watchers else None
            with self.chip_lock:
                emb = None
                if batch[0].emb is not None:
                    emb = torch.cat([p.emb for p in batch], dim=0)
                device = self.pipeline.device
                noise = torch.cat([
                    lu.seeded_noise_seq(int(p.req.get("seed", 0)), hv, wv, 1, device=device) for p in batch
                ])
                # I2I (a batch of one by its key): the references are encoded
                # here, and with strength < 1 the first one is also the init
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
                    on_latents=on_latents,
                )
            images = res.images if res.images is not None else res.image[None]
            for i, p in enumerate(batch):
                p.image = images[i]
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
            png = encode_png(to_u8(packed_to_rgb_preview(lat[row], height, width)))
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

    def cancel_all(self) -> int:
        """Abandon every queued request and the running batch; returns how many.
        The running batch was taken off the queue by ``_pick_batch``, so it is
        tracked apart: its ``_BatchCancel`` stops it at the next step end."""
        with self._queue_cv:
            pending = list(self._queue) + list(self._running_batch or ())
            for p in pending:
                p.cancelled.set()
            self._queue_cv.notify_all()
        return len(pending)

    def info(self) -> dict:
        """Device and serving counters (JAX ``info``): the backend is the
        pipeline's device type, "cuda" or "cpu"."""
        device = torch.device(self.pipeline.device)
        return {
            "model": self.pipeline.model.value,
            "backend": device.type,
            "devices": torch.cuda.device_count() if device.type == "cuda" else 1,
            "sharded": False,
            "uptime_s": round(time.time() - self.started, 1),
            "requests_served": self.requests_served,
            "batches_run": self.batches_run,
            "chats_served": self.chats_served,
            "embeds_served": self.embeds_served,
            "max_batch": self.max_batch,
            "queue_depth": len(self._queue),
        }

    # -- chat -------------------------------------------------------------------

    def chat_available(self) -> bool:
        """True with a ``chat_fn``, or with an encoder facade (``pipeline.encoders``)
        and the attached encoder's name in it."""
        return self.chat_fn is not None or (
            getattr(self.pipeline, "encoders", None) is not None
            and getattr(self.pipeline, "text_encoder_name", None) is not None
        )

    def chat(self, messages, *, max_tokens: int = 512, temperature: float = 0.7,
             seed: int = 0, on_token=None, thinking: bool = False) -> dict:
        """One chat turn -> {"reply", "tokens", "duration_s", "tok_per_s"},
        ``on_token(piece)`` called per streamed piece (JAX ``chat``). Through
        ``chat_fn``, else the pipeline's encoder facade (``encoders.chat`` on
        ``text_encoder_name``), under ``chip_lock`` either way; with neither,
        ``ChatUnavailableError`` (a ``--no-text-encoder`` server)."""
        if not isinstance(messages, list) or not messages:
            raise ValueError("messages must be a non-empty list of {role, content}")
        if not self.chat_available():
            raise ChatUnavailableError(_NO_CHAT)
        t0 = time.time()
        ntok = [0]

        def counting(piece):
            ntok[0] += 1
            if on_token is not None:
                on_token(piece)

        with self.chip_lock:  # decoding and image batches share the card
            if self.chat_fn is not None:
                reply = self.chat_fn(messages, max_tokens=max_tokens, temperature=temperature, seed=seed,
                                     on_token=counting)
            else:
                from flux2_tpu_torch.models.text_encoders.generation import GenerateParameters

                pipe = self.pipeline
                reply = pipe.encoders.chat(
                    messages, pipe.text_encoder_name,
                    params=GenerateParameters(max_tokens=int(max_tokens), temperature=float(temperature)),
                    seed=int(seed), on_token=counting, enable_thinking=thinking)
        dur = max(time.time() - t0, 1e-6)
        with self.lock:
            self.chats_served += 1
        return {"reply": reply, "tokens": ntok[0], "duration_s": round(dur, 2),
                "tok_per_s": round(ntok[0] / dur, 1)}

    # -- embeddings ---------------------------------------------------------------

    def embed(self, prompt: str) -> np.ndarray:
        """A prompt's conditioning embeddings through the attached encoder
        (``pipeline.encode_prompt``, LRU-cached): the [1, S, dim] float32 array."""
        if not isinstance(prompt, str) or not prompt.strip():
            raise ValueError("prompt must be a non-empty string")
        pipe = self.pipeline
        if pipe.text_encoder is None:
            raise ChatUnavailableError(
                "no text encoder attached — start serve with real weights "
                "(not --random-init / --no-text-encoder) to extract embeddings"
            )
        with self.chip_lock:  # the encoder's forward shares the card with batches
            emb = pipe.encode_prompt(prompt).to(torch.float32).cpu().numpy()
        with self.lock:
            self.embeds_served += 1
        return emb

    # -- model inventory ----------------------------------------------------------

    def models(self) -> dict:
        """Every registry repo with its download state and size on disk, the
        loaded model and encoder, the device's memory and the recommended
        quantization (JAX ``models``). Memory and the recommendation are the
        card's; on the CPU, zeros and the host's physical memory."""
        from flux2_tpu_torch.io import registry
        from flux2_tpu_torch.utils import memory as mem

        pipe = self.pipeline
        device = torch.device(pipe.device)
        transformers = []
        for model, spec in registry.TRANSFORMER_REPOS.items():
            path = registry.find_model_path(spec)
            transformers.append({
                "model": model.value,
                "repo": spec.repo_id,
                "gated": spec.gated,
                "approx_size_gb": spec.approx_size_gb,
                "downloaded": path is not None,
                "size_bytes": _disk_size(path),
                "prequantized": sorted(fmt for (m, fmt) in registry.PREQUANTIZED_TRANSFORMER_REPOS if m is model),
                "loaded": model is pipe.model,
            })
        encoders = []
        for name, spec in registry.TEXT_ENCODER_REPOS.items():
            path = registry.find_model_path(spec)
            encoders.append({
                "name": name,
                "repo": spec.repo_id,
                "gated": spec.gated,
                "approx_size_gb": spec.approx_size_gb,
                "downloaded": path is not None,
                "size_bytes": _disk_size(path),
                "variants": sorted(registry.ENCODER_VARIANT_REPOS.get(name, {})),
                "loaded": name == pipe.text_encoder_name,
            })
        vae_path = registry.find_model_path(registry.VAE_REPO)
        memory = mem.device_memory_stats(device)
        plan_bytes = None if device.type == "cuda" else os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
        return {
            "loaded": {
                "model": pipe.model.value,
                "encoder": pipe.text_encoder_name,
                "sharded": False,
                "chat_available": self.chat_available(),
            },
            "memory": memory,
            "recommended_quantization": mem.recommended_quantization(pipe.model, hbm_bytes=plan_bytes),
            "models_dir": registry.models_dir(),
            "transformers": transformers,
            "text_encoders": encoders,
            "vae": {
                "repo": registry.VAE_REPO.repo_id,
                "downloaded": vae_path is not None,
                "size_bytes": _disk_size(vae_path),
            },
        }

    # -- request path -----------------------------------------------------------

    def generate_png(self, req: dict) -> bytes:
        """One request ({"prompt", "height", "width", "steps", "guidance", "seed",
        "references", "strength", "preview_id", "timeout_s"}) -> PNG bytes.
        Blocks until its batch has run."""
        emb = None
        if self.embeddings_fn is not None:
            emb = self.embeddings_fn(req.get("prompt", ""))
        pending = _Pending(req, emb, refs=_decode_references(req), strength=_strength(req))
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
        with _profiler().span("serve.png"):
            return encode_png(to_u8(pending.image))


def _disk_size(path: Optional[str]) -> int:
    """Bytes of every file under ``path`` (0 for None)."""
    if not path:
        return 0
    total = 0
    for root, _, files in os.walk(path):
        for f in files:
            try:
                total += os.path.getsize(os.path.join(root, f))
            except OSError:
                pass
    return total


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


# The web UI: JAX's page as it is (tests/test_torch_shared_copies.py holds the
# string equal): prompt, size, steps, seed, references and live previews;
# chat, embeddings and the model inventory in tabs; status from /info.
_DEMO_HTML = """<!doctype html>
<html><head><meta charset="utf-8"><title>flux2-tpu</title>
<style>
 body{font-family:system-ui,sans-serif;max-width:760px;margin:2rem auto;padding:0 1rem;color:#1a1a2e}
 h1{font-size:1.3rem} .row{display:flex;gap:.6rem;flex-wrap:wrap;margin:.5rem 0}
 input,select,button{padding:.45rem .6rem;font-size:.95rem;border:1px solid #bbb;border-radius:6px}
 #prompt{flex:1;min-width:320px} button{background:#2d4a8a;color:#fff;border:none;cursor:pointer}
 button:disabled{background:#999} #out img{max-width:100%;border-radius:8px;margin-top:1rem}
 #status{color:#666;font-size:.85rem;white-space:pre-wrap}
 nav{display:flex;gap:.4rem;margin:.8rem 0} nav button{background:#eee;color:#1a1a2e}
 nav button.on{background:#2d4a8a;color:#fff} .pane{display:none} .pane.on{display:block}
 #chatlog{border:1px solid #ddd;border-radius:8px;padding:.6rem;min-height:180px;max-height:420px;
  overflow-y:auto;margin:.5rem 0;font-size:.95rem;white-space:pre-wrap}
 .msg-u{color:#2d4a8a;font-weight:600} .msg-a{color:#1a1a2e}
 table{border-collapse:collapse;width:100%;font-size:.85rem;margin:.5rem 0}
 th,td{border-bottom:1px solid #ddd;padding:.3rem .5rem;text-align:left}
 .badge{font-size:.75rem;padding:.1rem .4rem;border-radius:4px;background:#e6efe6;color:#22662a}
 .badge.off{background:#f0f0f0;color:#888}
</style></head><body>
<h1>flux2-tpu</h1>
<nav>
 <button id="tab-gen" class="on" onclick="tab('gen')">Generate</button>
 <button id="tab-chat" onclick="tab('chat')">Chat</button>
 <button id="tab-emb" onclick="tab('emb')">Embeddings</button>
 <button id="tab-models" onclick="tab('models')">Models</button>
</nav>
<div id="pane-gen" class="pane on">
<div class="row"><input id="prompt" placeholder="prompt" value="a serene mountain lake at dawn"></div>
<div class="row">
 <select id="size"><option>512</option><option selected>1024</option><option>2048</option></select>
 <input id="steps" type="number" value="4" min="1" max="50" style="width:5rem" title="steps">
 <input id="guidance" type="number" value="" step="0.5" placeholder="guid" style="width:5rem" title="guidance (blank = model default)">
 <input id="seed" type="number" value="0" style="width:7rem" title="seed">
 <button id="go" onclick="gen()">Generate</button>
</div>
<div class="row">
 <input id="refs" type="file" accept="image/*" multiple title="reference images (I2I)">
 <label>strength <input id="strength" type="range" min="0.1" max="1" step="0.05" value="1"
  oninput="document.getElementById('sv').textContent=this.value"> <span id="sv">1</span></label>
 <label><input id="preview" type="checkbox" checked> live preview</label>
</div>
<div id="status"></div><div id="out"></div>
</div>
<div id="pane-chat" class="pane">
 <div id="chatlog"></div>
 <div class="row">
  <input id="chatin" placeholder="message" style="flex:1;min-width:280px"
   onkeydown="if(event.key==='Enter')sendChat()">
  <input id="maxtok" type="number" value="512" min="16" max="4096" style="width:6rem" title="max tokens">
  <input id="temp" type="number" value="0.7" step="0.1" min="0" max="2" style="width:5rem" title="temperature">
  <label title="Qwen3 thinking mode"><input id="think" type="checkbox"> thinking</label>
  <button id="send" onclick="sendChat()">Send</button>
  <button onclick="chatMsgs=[];document.getElementById('chatlog').textContent=''">Clear</button>
 </div>
 <div id="chatstats" style="color:#666;font-size:.85rem"></div>
</div>
<div id="pane-emb" class="pane">
 <div class="row">
  <input id="embprompt" placeholder="prompt to embed" style="flex:1;min-width:320px"
   onkeydown="if(event.key==='Enter')inspectEmb()">
  <button onclick="inspectEmb()">Inspect</button>
  <button onclick="downloadEmb()">Download .npy</button>
 </div>
 <div id="embout" style="color:#666;font-size:.9rem"></div>
</div>
<div id="pane-models" class="pane"><div id="modelsout">loading…</div></div>
<script>
async function embReq(fmt){const p=document.getElementById('embprompt').value.trim();
 if(!p)throw new Error('enter a prompt');
 const r=await fetch('/embed',{method:'POST',headers:{'Content-Type':'application/json'},
  body:JSON.stringify({prompt:p,format:fmt})});
 if(!r.ok)throw new Error((await r.json()).error||r.statusText);return r;}
async function inspectEmb(){const out=document.getElementById('embout');out.textContent='encoding…';
 try{const j=await(await embReq('json')).json();
  out.innerHTML=`<table><tr><th>shape</th><th>dtype</th><th>mean</th><th>std</th>`+
   `<th>min</th><th>max</th><th>token ‖·‖ mean</th></tr>`+
   `<tr><td>[${j.shape}]</td><td>${j.dtype}</td><td>${j.mean.toFixed(4)}</td>`+
   `<td>${j.std.toFixed(4)}</td><td>${j.min.toFixed(3)}</td><td>${j.max.toFixed(3)}</td>`+
   `<td>${j.token_norm_mean.toFixed(2)}</td></tr></table>`;
 }catch(e){out.textContent='error: '+e.message;}}
async function downloadEmb(){const out=document.getElementById('embout');
 try{const blob=await(await embReq('npy')).blob();
  const a=document.createElement('a');a.href=URL.createObjectURL(blob);
  a.download='embeddings.npy';a.click();URL.revokeObjectURL(a.href);
 }catch(e){out.textContent='error: '+e.message;}}
function tab(t){for(const x of ['gen','chat','emb','models']){
 document.getElementById('tab-'+x).classList.toggle('on',x===t);
 document.getElementById('pane-'+x).classList.toggle('on',x===t);}
 if(t==='models')loadModels();}
let chatMsgs=[];
async function sendChat(){const inp=document.getElementById('chatin'),log=document.getElementById('chatlog');
 const text=inp.value.trim();if(!text)return;inp.value='';
 chatMsgs.push({role:'user',content:text});
 log.innerHTML+=`<div class="msg-u">you: ${text.replace(/</g,'&lt;')}</div><div class="msg-a" id="cur"></div>`;
 const b=document.getElementById('send');b.disabled=true;
 try{const r=await fetch('/chat',{method:'POST',headers:{'Content-Type':'application/json'},
   body:JSON.stringify({messages:chatMsgs,stream:true,
     max_tokens:+document.getElementById('maxtok').value,
     temperature:+document.getElementById('temp').value,
     thinking:document.getElementById('think').checked})});
  if(!r.ok){throw new Error((await r.json()).error||r.statusText)}
  const rd=r.body.getReader(),dec=new TextDecoder();let full='';
  for(;;){const{done,value}=await rd.read();if(done)break;
   full+=dec.decode(value,{stream:true});
   const vis=full.split('\\x1e')[0];
   document.getElementById('cur').textContent='model: '+vis;
   log.scrollTop=log.scrollHeight;}
  const parts=full.split('\\x1e');
  chatMsgs.push({role:'assistant',content:parts[0].trimEnd()});
  if(parts[1]){const s=JSON.parse(parts[1]);
   document.getElementById('chatstats').textContent=
    `${s.tokens} tokens in ${s.duration_s}s (${s.tok_per_s} tok/s)`;}
 }catch(e){document.getElementById('cur').textContent='error: '+e;chatMsgs.pop();}
 document.getElementById('cur').removeAttribute('id');b.disabled=false;}
function gb(n){return n? (n/1073741824).toFixed(1)+' GB':'—';}
async function loadModels(){const out=document.getElementById('modelsout');
 try{const j=await(await fetch('/models')).json();
  const row=m=>`<tr><td>${m.model||m.name}${m.loaded?' <span class="badge">loaded</span>':''}</td>`+
   `<td>${m.repo}${m.gated?' 🔒':''}</td>`+
   `<td><span class="badge${m.downloaded?'':' off'}">${m.downloaded?gb(m.size_bytes):'not downloaded'}</span></td>`+
   `<td>${(m.prequantized||m.variants||[]).join(' ')||''}</td></tr>`;
  const mem=j.memory&&j.memory.bytes_limit?
   ` | HBM ${gb(j.memory.bytes_in_use)} / ${gb(j.memory.bytes_limit)}`:'';
  out.innerHTML=`<div id="status">model ${j.loaded.model} | encoder ${j.loaded.encoder||'none'}`+
   ` | chat ${j.loaded.chat_available?'available':'unavailable'}${mem}`+
   ` | recommended quantization: ${j.recommended_quantization}</div>`+
   `<table><tr><th>transformer</th><th>repo</th><th>local</th><th>prequantized</th></tr>`+
   j.transformers.map(row).join('')+`</table>`+
   `<table><tr><th>text encoder</th><th>repo</th><th>local</th><th>variants</th></tr>`+
   j.text_encoders.map(row).join('')+`</table>`+
   `<div id="status">VAE ${j.vae.repo}: ${j.vae.downloaded?gb(j.vae.size_bytes):'not downloaded'}`+
   ` | models dir ${j.models_dir}</div>`;
 }catch(e){out.textContent='error: '+e;}}
</script>
<script>
async function refresh(){try{const r=await fetch('/info');const j=await r.json();
 document.getElementById('status').textContent=`model ${j.model} | ${j.backend} x${j.devices}`+
 ` | served ${j.requests_served} in ${j.batches_run} batches | queue ${j.queue_depth}`;}catch(e){}}
function readRefs(){const fs=document.getElementById('refs').files;
 return Promise.all([...fs].map(f=>new Promise((res,rej)=>{const rd=new FileReader();
  rd.onload=()=>res(rd.result);rd.onerror=rej;rd.readAsDataURL(f);})));}
let pollTimer=null;
function pollPreview(pid){pollTimer=setInterval(async()=>{
 try{const r=await fetch(`/preview?id=${pid}&_=${Date.now()}`);if(!r.ok)return;
  const step=r.headers.get('X-Step'),tot=r.headers.get('X-Total-Steps');
  const blob=await r.blob();
  document.getElementById('out').innerHTML=
   `<img src="${URL.createObjectURL(blob)}" style="image-rendering:pixelated;width:100%">`;
  document.getElementById('status').textContent=`denoising… step ${step}${+tot?`/${tot}`:''}`;
 }catch(e){}},400);}
async function gen(){const b=document.getElementById('go');b.disabled=true;const t0=Date.now();
 try{const s=+document.getElementById('size').value;
  const refs=await readRefs();
  const body={prompt:document.getElementById('prompt').value,width:s,height:s,
    steps:+document.getElementById('steps').value,seed:+document.getElementById('seed').value};
  const g=document.getElementById('guidance').value; if(g!=='')body.guidance=+g;
  if(refs.length){body.references=refs;body.strength=+document.getElementById('strength').value;}
  if(document.getElementById('preview').checked){
   body.preview_id=Math.random().toString(36).slice(2);pollPreview(body.preview_id);}
  const r=await fetch('/generate',{method:'POST',headers:{'Content-Type':'application/json'},
   body:JSON.stringify(body)});
  if(pollTimer){clearInterval(pollTimer);pollTimer=null;}
  if(!r.ok){throw new Error(await r.text())}
  const blob=await r.blob();
  document.getElementById('out').innerHTML=`<img src="${URL.createObjectURL(blob)}">`;
  document.getElementById('status').textContent=`done in ${((Date.now()-t0)/1000).toFixed(1)}s`;
 }catch(e){if(pollTimer){clearInterval(pollTimer);pollTimer=null;}
  document.getElementById('status').textContent=String(e);}b.disabled=false;refresh();}
refresh();setInterval(refresh,5000);
</script></body></html>"""


def make_handler(server: Flux2Server):
    """The request handler class over ``server``: JAX's routes, statuses,
    headers and bodies (``flux2_tpu/serve.py`` ``make_handler``)."""
    class Handler(BaseHTTPRequestHandler):
        # chunked transfer coding (the streaming /chat response) is only
        # valid for HTTP/1.1 — browsers do NOT de-chunk an HTTP/1.0 body, so
        # the demo page would render raw hex chunk framing. Every non-chunked
        # response sets Content-Length, which HTTP/1.1 keep-alive requires.
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):  # quiet
            pass

        def _json(self, code: int, payload: dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/health":
                self._json(200, {"status": "ok"})
            elif self.path == "/info":
                self._json(200, server.info())
            elif self.path.startswith("/preview"):
                from urllib.parse import parse_qs, urlparse

                pid = (parse_qs(urlparse(self.path).query).get("id") or [""])[0]
                entry = server.get_preview(pid)
                if entry is None:
                    self._json(404, {"error": "no preview yet"})
                    return
                self.send_response(200)
                self.send_header("Content-Type", "image/png")
                self.send_header("Content-Length", str(len(entry["png"])))
                self.send_header("X-Step", str(entry["step"]))
                self.send_header("X-Total-Steps", str(entry["total"]))
                self.end_headers()
                self.wfile.write(entry["png"])
            elif self.path == "/models":
                try:
                    self._json(200, server.models())
                except Exception as e:
                    self._json(500, {"error": f"{type(e).__name__}: {e}"})
            elif self.path in ("/", "/index.html"):
                body = _DEMO_HTML.encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/html; charset=utf-8")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            else:
                self._json(404, {"error": "not found"})

        def do_POST(self):
            if self.path == "/chat":
                self._do_chat()
                return
            if self.path == "/embed":
                self._do_embed()
                return
            if self.path != "/generate":
                self._json(404, {"error": "not found"})
                return
            try:
                length = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(length) or b"{}")
                png = server.generate_png(req)
            except QueueFullError as e:  # backpressure: let clients retry
                self._json(503, {"error": str(e)})
                return
            except TimeoutError as e:  # per-request timeout_s exceeded
                self._json(504, {"error": str(e)})
                return
            except Exception as e:  # surface errors as JSON, keep serving
                self._json(400, {"error": f"{type(e).__name__}: {e}"})
                return
            if req.get("format") == "json":
                self._json(200, {"image_png_base64": base64.b64encode(png).decode()})
            else:
                self.send_response(200)
                self.send_header("Content-Type", "image/png")
                self.send_header("Content-Length", str(len(png)))
                self.end_headers()
                self.wfile.write(png)

        def _do_embed(self):
            """POST /embed: {"prompt", "format": "json"|"npy"}.

            json (default) -> shape/stats summary for the embeddings panel;
            npy -> the raw [1, S, dim] array as a downloadable .npy
            (the app's EmbeddingsView export / `flux-encoders embed`)."""
            try:
                length = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(length) or b"{}")
                emb = server.embed(req.get("prompt", ""))
                if req.get("format") == "npy":
                    buf = io.BytesIO()
                    np.save(buf, emb)
                    body = buf.getvalue()
                    self.send_response(200)
                    self.send_header("Content-Type", "application/octet-stream")
                    self.send_header(
                        "Content-Disposition", 'attachment; filename="embeddings.npy"'
                    )
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                    return
                tok_norms = np.linalg.norm(emb[0], axis=-1)
                self._json(200, {
                    "shape": list(emb.shape),
                    "dtype": str(emb.dtype),
                    "seq_len": int(emb.shape[-2]),
                    "dim": int(emb.shape[-1]),
                    "mean": float(emb.mean()),
                    "std": float(emb.std()),
                    "min": float(emb.min()),
                    "max": float(emb.max()),
                    "token_norm_mean": float(tok_norms.mean()),
                    "token_norm_max": float(tok_norms.max()),
                })
            except ChatUnavailableError as e:
                self._json(503, {"error": str(e)})
            except (ValueError, TypeError, KeyError) as e:
                self._json(400, {"error": f"{type(e).__name__}: {e}"})
            except BrokenPipeError:  # client went away mid-download
                pass
            except Exception as e:
                try:  # the response may already be started (npy path)
                    self._json(500, {"error": f"{type(e).__name__}: {e}"})
                except Exception:
                    pass

        def _do_chat(self):
            """POST /chat: {"messages": [{role, content}, ...], "max_tokens",
            "temperature", "seed", "stream": bool}.

            stream=false -> JSON {"reply", "tokens", "duration_s", "tok_per_s"}.
            stream=true  -> chunked text/plain token pieces as they decode
            (the web counterpart of ChatViewModel's streaming tokens)."""
            streaming = False  # True once the chunked response headers are out
            try:
                length = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(length) or b"{}")
                kwargs = dict(
                    max_tokens=int(req.get("max_tokens", 512)),
                    temperature=float(req.get("temperature", 0.7)),
                    seed=int(req.get("seed", 0)),
                    thinking=bool(req.get("thinking", False)),
                )
                if not req.get("stream"):
                    self._json(200, server.chat(req.get("messages"), **kwargs))
                    return
                if not server.chat_available():
                    raise ChatUnavailableError(
                        "no text encoder attached — start serve with real weights "
                        "(not --random-init / --no-text-encoder) to enable chat"
                    )
                self.send_response(200)
                self.send_header("Content-Type", "text/plain; charset=utf-8")
                self.send_header("Transfer-Encoding", "chunked")
                self.send_header("X-Accel-Buffering", "no")
                self.end_headers()

                def emit(piece: str):
                    data = piece.encode("utf-8")
                    if data:
                        self.wfile.write(f"{len(data):x}\r\n".encode() + data + b"\r\n")
                        self.wfile.flush()

                streaming = True
                stats = server.chat(req.get("messages"), on_token=emit, **kwargs)
                # final chunk carries the stats as a JSON trailer line the
                # demo page strips from the visible text
                emit("\n\x1e" + json.dumps(
                    {k: stats[k] for k in ("tokens", "duration_s", "tok_per_s")}
                ))
                self.wfile.write(b"0\r\n\r\n")
            except ChatUnavailableError as e:
                self._json(503, {"error": str(e)})
            except (ValueError, TypeError, KeyError) as e:
                self._json(400, {"error": f"{type(e).__name__}: {e}"})
            except BrokenPipeError:  # client went away mid-stream
                pass
            except Exception as e:
                try:
                    if streaming:
                        # headers already sent: a second status line would
                        # corrupt the chunk stream — emit the error in-band
                        # and terminate the chunked body instead
                        emit("\n\x1e" + json.dumps({"error": f"{type(e).__name__}: {e}"}))
                        self.wfile.write(b"0\r\n\r\n")
                    else:
                        self._json(500, {"error": f"{type(e).__name__}: {e}"})
                except Exception:
                    pass

    return Handler


class _SyncedCancel:
    """A batch's cancel check, taken on rank 0 (``fn``) and broadcast, so that
    every rank stops at the same step end; the followers pass ``fn`` None."""

    def __init__(self, fn=None):
        self.fn = fn

    def __call__(self) -> bool:
        import torch.distributed as dist

        flag = [bool(self.fn()) if self.fn is not None else None]
        dist.broadcast_object_list(flag, src=0)
        return bool(flag[0])


# the store key rank 0 counts its calls in; a follower that has taken n calls waits for n + 1
_CALLS_KEY = "flux2_serve/calls"
_POLL_S = 0.005


def _send_call(kwargs: Optional[dict], device: torch.device) -> None:
    """Rank 0: post one ``generate`` call (None: shut down) in the store, then
    broadcast it. The plain arguments go by ``broadcast_object_list``, each
    tensor by ``broadcast``."""
    import torch.distributed as dist

    dist.distributed_c10d._get_default_store().add(_CALLS_KEY, 1)
    if kwargs is None:
        dist.broadcast_object_list([None], src=0)
        return
    tensors = {k: v for k, v in kwargs.items() if isinstance(v, torch.Tensor)}
    plain = {k: v for k, v in kwargs.items() if k not in tensors and not callable(v)}
    plain["cancel"] = kwargs.get("cancel") is not None
    specs = {k: (tuple(v.shape), v.dtype) for k, v in tensors.items()}
    dist.broadcast_object_list([(plain, specs)], src=0)
    for k in sorted(tensors):
        dist.broadcast(tensors[k].to(device).contiguous(), src=0)


def _await_call(taken: int) -> None:
    """A follower that has taken ``taken`` calls: poll the store until rank 0
    posts the next one, however long the server stays idle."""
    import torch.distributed as dist

    store = dist.distributed_c10d._get_default_store()
    while store.add(_CALLS_KEY, 0) <= taken:
        time.sleep(_POLL_S)


def _receive_call(device: torch.device) -> Optional[dict]:
    """A follower: the next ``generate`` call's arguments, or None to stop
    (once ``_await_call`` has seen it posted)."""
    import torch.distributed as dist

    msg = [None]
    dist.broadcast_object_list(msg, src=0)
    if msg[0] is None:
        return None
    plain, specs = msg[0]
    kwargs = dict(plain)
    for k in sorted(specs):
        shape, dtype = specs[k]
        kwargs[k] = torch.empty(shape, dtype=dtype, device=device)
        dist.broadcast(kwargs[k], src=0)
    kwargs["cancel"] = _SyncedCancel() if plain["cancel"] else None
    return kwargs


class _Leader:
    """Rank 0's view of a sharded pipeline: ``generate`` broadcasts its call
    to the followers first; everything else is the pipeline's. It is made
    once every follower has read the store's count (the barrier)."""

    def __init__(self, pipeline):
        import torch.distributed as dist

        dist.barrier()
        self._pipeline = pipeline

    def __getattr__(self, name):
        return getattr(self._pipeline, name)

    def generate(self, **kwargs):
        cancel = kwargs.get("cancel")
        if cancel is not None:
            kwargs["cancel"] = _SyncedCancel(functools.partial(_cancel_requested, cancel))
        _send_call(kwargs, self._pipeline.device)
        return self._pipeline.generate(**kwargs)


def _follow(pipe) -> None:
    """A follower rank's loop: the same ``generate`` calls as rank 0, until
    shutdown. It reads the store's count of calls before the barrier that
    ``_Leader`` meets, so no call is posted before it is counted."""
    import torch.distributed as dist

    taken = dist.distributed_c10d._get_default_store().add(_CALLS_KEY, 0)
    dist.barrier()
    while True:
        _await_call(taken)
        taken += 1
        kwargs = _receive_call(pipe.device)
        if kwargs is None:
            return
        kwargs["decode"] = False
        try:
            pipe.generate(**kwargs)
        except GenerationCancelled:  # rank 0's cancel, broadcast at the same step end
            pass
        except Exception:  # rank 0 meets the same error at the same point and answers the request with it
            logging.getLogger("flux2_tpu").exception("follower rank: generate failed")


def _shard_for_tp(args):
    """``--tp N``: the process group of the torchrun ranks (the mesh must be
    (1, 1, N) over them) and this rank's device. Exits when the machine has
    fewer CUDA devices than N."""
    from flux2_tpu_torch.parallel import mesh as mesh_mod

    device = torch.device(args.device)
    if device.type == "cuda":
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n < args.tp:
            raise SystemExit(f"--tp {args.tp} needs {args.tp} CUDA devices, one per rank; this machine has {n}")
    mesh_mod.ensure_process_group(device.type)
    if device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def main(argv=None, **build_kwargs):
    """``python -m flux2_tpu_torch.serve``: JAX's flags and ``--device``.
    ``build_kwargs`` go to ``cli.main.build_pipeline`` (``transformer_config=``,
    ``vae_config=``, ``encoder_config=``: a reduced random-init model)."""
    parser = argparse.ArgumentParser(description="flux2-tpu serving endpoint (PyTorch port)")
    parser.add_argument("--port", type=int, default=8080)
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--model", default="klein-4b")
    parser.add_argument("--quantization", default="bf16")
    parser.add_argument("--random-init", action="store_true")
    parser.add_argument("--transformer-dir")
    parser.add_argument("--vae-dir")
    parser.add_argument("--encoder-dir")
    parser.add_argument("--no-text-encoder", action="store_true")
    parser.add_argument("--small-decoder", action="store_true")
    parser.add_argument("--tp", type=int, default=0, help="shard over N devices (0 = no sharding)")
    parser.add_argument(
        "--precompile", metavar="PX,PX,...",
        help="one generation per square size at startup (builds the kernels and sets up cuDNN)",
    )
    parser.add_argument("--steps-default", type=int, default=None,
                        help="steps used for --precompile warmup (default: model default)")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu; the CPU only when asked")
    args = parser.parse_args(argv)
    import torch.distributed as dist

    # the group a sharded server starts is ended on the way out; a caller's own group is left
    own_group = args.tp > 1 and not dist.is_initialized()
    device = _shard_for_tp(args) if args.tp > 1 else args.device

    from flux2_tpu_torch.cli.main import build_pipeline

    pipe = build_pipeline(args, device, **build_kwargs)
    if args.tp > 1:
        from flux2_tpu_torch.parallel.mesh import make_mesh

        try:
            mesh = make_mesh(data=1, fsdp=1, tp=args.tp, device_type=pipe.device.type)
        except ValueError as e:
            raise SystemExit(f"--tp {args.tp}: {e}: this run has {dist.get_world_size()} rank(s); start one "
                             f"process per rank with torchrun --nproc-per-node {args.tp}")
        pipe.shard(mesh)
        if dist.get_rank() != 0:
            _follow(pipe)
            if own_group:
                dist.destroy_process_group()
            return
        pipe = _Leader(pipe)
    # the prompt is encoded on each request's thread, so the worker only sees embeddings
    emb_fn = pipe.encode_prompt if pipe.text_encoder is not None else None

    if args.precompile:
        joint = pipe.transformer.config.joint_attention_dim
        for px in args.precompile.split(","):
            px = int(px)
            t0 = time.time()
            emb = (emb_fn("warmup") if emb_fn is not None
                   else torch.zeros(1, 512, joint, dtype=torch.bfloat16, device=pipe.device))
            pipe.generate(embeddings=emb, height=px, width=px, num_steps=args.steps_default, seed=0)
            print(f"precompiled {px}x{px} in {time.time() - t0:.1f}s", flush=True)

    server = Flux2Server(pipe, emb_fn)
    httpd = ThreadingHTTPServer((args.host, args.port), make_handler(server))
    print(f"flux2-tpu serving on http://{args.host}:{args.port} (model {args.model})", flush=True)
    try:
        httpd.serve_forever()
    finally:
        server.shutdown()
        if args.tp > 1:  # the followers leave their loop
            _send_call(None, pipe.device)
            if own_group:
                dist.destroy_process_group()


if __name__ == "__main__":
    main()
