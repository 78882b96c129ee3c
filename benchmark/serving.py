"""Drives the program's server (``serve.Flux2Server.generate_png``, in
process, one thread per request in flight) with a traffic mix, and records
what the window did.

Spans are taken here, around the calls into each layer: ``Recorder`` wraps
the pipeline instance the server holds (as a deployment's own wrapper
would), timing each prompt encode (``encode_prompt``, on the request's
thread) and each batch (``generate``, on the server's worker thread). For
the output check it keeps the conditioning and the final latents of the
requests the check will compare, and of no other: those are drawn from the
seed before the window (``check.positions``), so what the harness holds on
the device does not grow with the images served.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Dict, List, Optional, Sequence

import torch

from benchmark import traffic as traffic_mod
from benchmark.reference import dit


@dataclasses.dataclass
class Span:
    name: str
    start: float  # host perf_counter
    end: float
    info: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class Completion:
    request: dict
    due: float  # when it was sent
    done: float  # PNG bytes in hand, or the failure seen; inf when it never came
    index: int = -1  # its position in the request stream
    png: Optional[bytes] = None
    error: Optional[str] = None


class Recorder:
    """Forwards to the pipeline; records spans, and the outputs of the
    requests in ``keep`` (found by prompt and by noise)."""

    def __init__(self, pipe, keep: Sequence[dict] = (), device=None):
        self._pipe = pipe
        self.spans: List[Span] = []
        self._keep_prompts = {r["prompt"] for r in keep}
        self._keep_tags = torch.stack([dit.noise(r["seed"], r["height"], r["width"], device)[0, 0, :8]
                                       for r in keep]) if keep else None
        self.conds: Dict[str, torch.Tensor] = {}  # kept prompt -> conditioning (device)
        self.latents: Dict[int, torch.Tensor] = {}  # index in keep -> final latents [S, 128] (device)
        self._lock = threading.Lock()

    def __getattr__(self, name):
        return getattr(self._pipe, name)

    def encode_prompt(self, prompt: str):
        t = time.perf_counter()
        emb = self._pipe.encode_prompt(prompt)
        span = Span("encode_prompt", t, time.perf_counter())
        with self._lock:
            self.spans.append(span)
            if prompt in self._keep_prompts:
                self.conds.setdefault(prompt, emb)
        return emb

    def generate(self, **kw):
        t = time.perf_counter()
        res = self._pipe.generate(**kw)
        end = time.perf_counter()
        noise = kw.get("noise")
        rows = int(res.latents_device.shape[0])
        kept = {}
        if self._keep_tags is not None and noise is not None:  # the batch has synchronised: no wait here
            hits = (noise[:, 0, :8][:, None, :] == self._keep_tags[None]).all(-1).nonzero().tolist()
            kept = {j: res.latents_device[row].clone() for row, j in hits}
        with self._lock:
            self.spans.append(Span("generate", t, end, {
                "batch": rows, "height": kw.get("height"), "width": kw.get("width"), "steps": res.num_steps,
                "denoising_s": res.phase_timings["denoising"], "vae_decoding_s": res.phase_timings["vae_decoding"]}))
            for j, lat in kept.items():
                self.latents.setdefault(j, lat)
        return res


def _send(server, c: Completion) -> None:
    try:
        c.png = server.generate_png(dict(c.request))
    except Exception as e:  # a refused or failed request: counted as failed
        c.error = f"{type(e).__name__}: {e}"
    c.done = time.perf_counter()


def run_closed(server, traffic: dict, seed: int, seconds: float, on_start=None, trace_s: float = 0.0,
               on_trace_end=None, need: int = 0) -> dict:
    """``clients`` closed-loop clients. The window runs from the first
    completion to the first completion at or after ``seconds`` later; then
    no new request is sent, once the first ``need`` of the stream have
    been, and the ones in flight are waited for. With ``on_trace_end``, it
    is called once ``trace_s`` of the window have passed, with the traced
    part's bounds."""
    reqs = traffic_mod.closed_requests(traffic, seed)
    lock, cv = threading.Lock(), threading.Condition()
    done: List[Completion] = []
    stop = threading.Event()
    sent = 0

    def client():
        nonlocal sent
        while True:
            with lock:
                if stop.is_set() and sent >= need:
                    return
                c = Completion(next(reqs), time.perf_counter(), float("inf"), sent)
                sent += 1
            _send(server, c)
            with cv:
                done.append(c)
                cv.notify_all()

    if on_start is not None:
        on_start()
    threads = [threading.Thread(target=client, daemon=True) for _ in range(traffic["clients"])]
    started = time.perf_counter()
    for th in threads:
        th.start()
    with cv:
        cv.wait_for(lambda: done, timeout=600)
        if not done:
            raise RuntimeError("no request completed in 600 s")
        t0 = min(c.done for c in done)
    if on_trace_end is not None:  # called without the lock, so the clients go on
        traced = min(trace_s, seconds)
        with cv:
            cv.wait_for(lambda: any(c.done >= t0 + traced for c in done), timeout=seconds + 600)
            tt1 = min(c.done for c in done if c.done >= t0 + traced)
        on_trace_end(t0, tt1)
    with cv:
        cv.wait_for(lambda: any(c.done >= t0 + seconds for c in done), timeout=seconds + 600)
        stop.set()
        t1 = min(c.done for c in done if c.done >= t0 + seconds)
    for th in threads:
        th.join(timeout=600)
    window = [c for c in done if t0 < c.done <= t1]
    return {"t0": t0, "t1": t1, "started": started, "completions": done, "window": window}


def warm_up(pipe, server, traffic: dict) -> None:
    """Every shape this traffic makes the server run: for each size, each
    batch the server may form from it (1 to its cap), end to end (encode,
    denoise, decode, PNG) through the pipeline, then one request through the
    server."""
    from flux2_tpu_torch.io.png import encode_png, to_u8

    emb = pipe.encode_prompt("warm up the encoder and every served shape")
    for size in traffic["sizes"]:
        px = size["px"]
        cap = min(server._batch_cap((px, px)), traffic["clients"])  # the server's own rule, at most the clients
        for b in range(1, cap + 1):
            res = pipe.generate(embeddings=emb.repeat(b, 1, 1), height=px, width=px, num_steps=traffic["steps"],
                                seed=0)
            encode_png(to_u8(res.image))
    server.generate_png({"prompt": "one request through the server", "height": traffic["sizes"][0]["px"],
                         "width": traffic["sizes"][0]["px"], "steps": traffic["steps"], "seed": 1})
