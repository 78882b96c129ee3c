"""Drives the program's LoRA train step (``training.trainer.make_train_step``)
through its first steps in set-up and then through the window, and keeps
what the check compares.

Set-up builds one train step (the DiT, the adapters, AdamW) and feeds it
the first ``check.steps`` batches of the feed: those steps warm every shape
up, and their losses, the first step's gradient as the optimizer took it
(its first moment after one step, over 1 - b1) and the adapters after them
are copied to the host for the check. The window then runs the same object
on, batch after batch of the feed, each step ended by a synchronise: from
the first step end to the first step end at or after ``seconds`` later.
"""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from benchmark import weights as W


def rope(config: dict, px: int, device):
    from flux2_tpu_torch.ops import latents as lu
    from flux2_tpu_torch.ops.rope import rope_embeddings

    ids = np.concatenate([lu.text_position_ids(config["text_encoder"]["max_length"]),
                          lu.image_position_ids(px, px)])
    return rope_embeddings(torch.from_numpy(ids).to(device))


def run_train(model, config: dict, traffic: dict, seed: int, seconds: float, device, quantization=None,
              on_start=None, trace_s: float = 0.0, on_trace_end=None) -> dict:
    step, lora, optimizer = model.build_trainer(config, traffic, seed, device, quantization)
    feed = model.train_batches(config, traffic, seed, device, traffic["pool"])
    cos, sin = rope(config, traffic["px"], device)
    batches = [dict(b, rope_cos=cos, rope_sin=sin) for b in feed]
    draw_seed = W.group_seed(seed, "draws", 0)
    gen = torch.Generator(device=device).manual_seed(draw_seed)
    names = [n for n, _ in lora.named_parameters()]
    start = {n: p.detach().cpu().clone() for n, p in lora.named_parameters()}
    k = traffic["check"]["steps"]
    losses, first = [], None
    for i in range(k):
        m = step(lora, optimizer, batches[i % len(batches)], gen)
        losses.append(float(m["loss"]))
        if i == 0:
            first = {n: (mu / (1 - optimizer.b1)).cpu() for n, mu in zip(names, optimizer.mu)}
    after = {n: p.detach().cpu().clone() for n, p in lora.named_parameters()}
    if device.type == "cuda":
        torch.cuda.synchronize()
    if on_start is not None:
        on_start()
    ends: List[float] = []
    bad = 0
    started = time.perf_counter()
    i = k
    while not ends or ends[-1] < ends[0] + seconds:
        m = step(lora, optimizer, batches[i % len(batches)], gen)
        if device.type == "cuda":
            torch.cuda.synchronize()
        ends.append(time.perf_counter())
        bad += not bool(torch.isfinite(m["loss"]))
        i += 1
        if on_trace_end is not None and ends[-1] >= ends[0] + min(trace_s, seconds):
            on_trace_end(ends[0], ends[-1])
            on_trace_end = None
    check_batches = [{name: v.cpu() for name, v in b.items()} for b in feed[:k]]
    return {"t0": ends[0], "t1": ends[-1], "started": started, "steps": len(ends) - 1, "ends": ends, "nonfinite": bad,
            "losses": losses, "first_grads": first, "start": start, "after": after, "draw_seed": draw_seed,
            "check_batches": check_batches}


def compare_train(model, config: dict, traffic: dict, seed: int, device, rec: dict) -> Dict[str, float]:
    """The three numbers of a train cell: the widest relative gap of a step's
    loss, and for the first gradient and for the adapters' change over the
    steps the widest gap between the program's norm of a leaf and the
    reference's, over the larger of that leaf's and the median leaf's
    reference norm. Leaves whose reference gradient is under a thousandth
    of the median leaf's are left out of both."""
    ref = model.reference_train(config, traffic, seed, device, rec["check_batches"], rec["draw_seed"])
    out = {"loss_rel_gap": max(abs(p - r) / abs(r) for p, r in zip(rec["losses"], ref["losses"]))}
    g_ref, g_got, d_ref, d_got = {}, {}, {}, {}
    for key, (ga, gb) in ref["first_grads"].items():
        for j, g in ((".a", ga), (".b", gb)):
            g_ref[key + j] = float(g.double().norm())
            g_got[key + j] = float(rec["first_grads"][key + j].double().norm())
    for key, (a, b) in ref["after"].items():
        for j, p in ((".a", a), (".b", b)):
            d_ref[key + j] = float((p.cpu().double() - rec["start"][key + j].double()).norm())
            d_got[key + j] = float((rec["after"][key + j].double() - rec["start"][key + j].double()).norm())
    med_g = float(np.median(list(g_ref.values())))
    kept = [n for n, v in g_ref.items() if v >= 1e-3 * med_g]
    med_d = float(np.median([d_ref[n] for n in kept]))
    out["grad_leaf_gap"] = max(abs(g_got[n] - g_ref[n]) / max(g_ref[n], med_g) for n in kept)
    out["change_leaf_gap"] = max(abs(d_got[n] - d_ref[n]) / max(d_ref[n], med_d) for n in kept)
    return out
