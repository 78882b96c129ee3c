"""Whether what the timed path served is correct: a sample of the requests
the window served, against the plain reference, each number beside its limit.

The sample is drawn from the seed before the window, by position in the
request stream (``positions``), so the harness keeps the outputs of those
requests alone. For each, three layers are compared, at the size and in
the batch the window served it, each against the reference run from that
layer's input as the program served it: the conditioning the encoder gave,
against the reference's from the prompt (``cond_rel_l2``); the DiT's
latents after the last step, found in its batch by the request's noise,
against the reference's denoising from the program's conditioning and the
request's seed (``latents_rel_l2``); the PNG the client received, against
the reference's decode of the program's latents (``image_rel_l2``, on
pixel levels centred at 127.5). Each is the relative L2 distance, the
widest over the sample; a layer whose output never came reads infinite.
Every request of the window must also have come back as a PNG of its size
(``unanswered``, ``malformed``: limit 0).
"""

from __future__ import annotations

import random
import zlib
from typing import Dict, List, Tuple

import numpy as np
import torch

from benchmark import png
from benchmark import traffic as traffic_mod


def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double(), b.double()
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b).clamp_min(1e-30))


def positions(traffic: dict, seed: int) -> List[Tuple[int, dict]]:
    """The requests the check compares, drawn from the seed before the
    window: ``check.requests`` stream positions among the ``check.among``
    that follow the clients' first requests (so each is sent after the
    window's first completion), one of them of the largest size there;
    with their requests."""
    clients, c = traffic["clients"], traffic["check"]
    stream = traffic_mod.closed_requests(traffic, seed)
    reqs = [next(stream) for _ in range(clients + c["among"])]
    cand = list(range(clients, clients + c["among"]))
    rng = random.Random(f"check:{seed}")

    def area(i):
        return reqs[i]["height"] * reqs[i]["width"]

    largest = max(area(i) for i in cand)
    first = rng.choice([i for i in cand if area(i) == largest])
    rest = rng.sample([i for i in cand if i != first], min(c["requests"] - 1, len(cand) - 1))
    return [(i, reqs[i]) for i in [first] + rest]


def take_served(recorder, keep: List[Tuple[int, dict]], completions) -> List[Dict]:
    """The program's outputs for the kept requests, copied to the host
    before its state is freed: conditioning, latents row, decoded PNG (None
    where the program gave none)."""
    by_index = {c.index: c for c in completions}
    out = []
    for j, (i, r) in enumerate(keep):
        c = by_index.get(i)
        lat, cond = recorder.latents.get(j), recorder.conds.get(r["prompt"])
        try:
            image = torch.from_numpy(png.decode_rgb(c.png)) if c is not None and c.png is not None else None
        except (ValueError, zlib.error):
            image = None
        out.append({"request": r, "cond": None if cond is None else cond.float().cpu(),
                    "latents": None if lat is None else lat[None].float().cpu(), "image": image})
    return out


def compare_served(model, config: dict, seed: int, device, served: List[Dict],
                   fp8_control: bool = False) -> Tuple[Dict[str, float], Dict[str, float]]:
    """(the widest distance of each layer over the sample, readings beside).
    ``fp8_control``: the denoising and decode stages' control, the
    reference's fp8 stages in the program's place (``reference/dit.py``,
    ``reference/vae.py``); the conditioning stays the program's (its control
    is the program's w8a8). The program's own latents are then read beside,
    as "latents_rel_l2.program", outside the numbers the verdict judges."""
    refs = model.reference_requests(config, seed, device, served, fp8_control)
    worst = {"cond_rel_l2": 0.0, "latents_rel_l2": 0.0, "image_rel_l2": 0.0}
    beside: Dict[str, float] = {}
    for s, ref in zip(served, refs):
        image = ref.get("image_fp8") if fp8_control else s["image"]
        latents = ref.get("latents_fp8") if fp8_control else s["latents"]
        pairs = (("cond_rel_l2", s["cond"], ref["cond"]), ("latents_rel_l2", latents, ref.get("latents")),
                 ("image_rel_l2", None if image is None else image.double() - 127.5,
                  None if ref.get("image") is None else ref["image"].double() - 127.5))
        for name, got, want in pairs:
            if got is None or want is None or tuple(got.shape) != tuple(want.shape):
                worst[name] = float("inf")  # the layer's output never came, or came in another shape
            else:
                worst[name] = max(worst[name], rel_l2(got, want))
        if fp8_control and s["latents"] is not None and ref.get("latents") is not None:
            beside["latents_rel_l2.program"] = max(beside.get("latents_rel_l2.program", 0.0),
                                                   rel_l2(s["latents"], ref["latents"]))
    return worst, beside


def answered(window) -> Tuple[int, int]:
    """(requests with no answer, answers that are no PNG of the request's size)."""
    unanswered = sum(c.png is None for c in window)
    malformed = sum(c.png is not None and png.size(c.png) != (c.request["width"], c.request["height"])
                    for c in window)
    return unanswered, malformed


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> Tuple[bool, Dict[str, Dict[str, float]]]:
    """(correct, {name: {"value", "limit"}}): correct when every number is
    at or under its limit; a number with no limit fails."""
    table = {k: {"value": v, "limit": limits.get(k)} for k, v in numbers.items()}
    ok = all(t["limit"] is not None and np.isfinite(t["value"]) and t["value"] <= t["limit"] for t in table.values())
    return ok, table
