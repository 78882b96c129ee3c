"""Plain reference of a FLUX.2 LoRA train step, float32, TF32 off.

The rectified-flow velocity loss on the unmerged adapters
(``reference/dit.py``'s ``lora``): x_t = (1 - sigma) x_0 + sigma noise, target
noise - x_0, mean squared error over the batch; its gradient through every
adapter (each row on its own, each block recomputed in the backward, so the
float32 activations of one block are alive at a time); then optax's
``chain(clip_by_global_norm, adamw)``: clip to ``max_grad_norm`` (no
epsilon), Adam (b1 0.9, b2 0.999, eps 1e-8, bias-corrected), decoupled
weight decay, a constant learning rate.

The sigmas and noise are the ones the step's generator gives, drawn again
in the same order: per step the "balanced" timesteps (u ~ U[0, 1), a coin
per row between 1000 u^3 and 1000 (1 - u^3), clamped to [0, 999], / 1000),
then the noise N(0, 1) of the batch's latents.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.utils.checkpoint as cp

from benchmark.reference import dit


def draw_balanced(gen: torch.Generator, batch: int, shape) -> Tuple[torch.Tensor, torch.Tensor]:
    u = torch.rand(batch, generator=gen, device=gen.device)
    cubic = u ** 3
    style = torch.rand(batch, generator=gen, device=gen.device) > 0.5
    t = torch.where(style, (1.0 - cubic) * 1000.0, cubic * 1000.0)
    sigmas = torch.clamp(t, 0.0, 999.0) / 1000.0
    noise = torch.randn(shape, generator=gen, device=gen.device, dtype=torch.float32)
    return sigmas, noise


def loss_and_grads(ckpt, t: dict, lora: Dict[str, Tuple[torch.Tensor, torch.Tensor]], scale: float,
                   latents: torch.Tensor, emb: torch.Tensor, sigmas: torch.Tensor, noise: torch.Tensor,
                   cos: torch.Tensor, sin: torch.Tensor) -> Tuple[float, Dict[str, Tuple[torch.Tensor, torch.Tensor]]]:
    """(mean loss, {key: (d a, d b)}) of one batch."""
    params = [p for ab in lora.values() for p in ab]
    for p in params:
        p.grad = None

    def wrap(fn, *args):
        return cp.checkpoint(fn, *args, use_reentrant=False)

    b = latents.shape[0]
    total = 0.0
    for r in range(b):
        s = sigmas[r:r + 1]
        x = (1.0 - s[:, None, None]) * latents[r:r + 1] + s[:, None, None] * noise[r:r + 1]
        pred = dit.velocity(ckpt, t, x, emb[r:r + 1].float(), s, cos, sin, lora, scale, wrap)
        loss = torch.mean(torch.square(pred - (noise[r:r + 1] - latents[r:r + 1])))
        (loss / b).backward()
        total += loss.item() / b
    return total, {k: (a.grad.detach().clone(), bb.grad.detach().clone()) for k, (a, bb) in lora.items()}


def adamw(lora, grads, state: dict, cfg: dict) -> Dict[str, Tuple[torch.Tensor, torch.Tensor]]:
    """One update in place; returns the clipped gradient the moments took."""
    flat = [g for ab in grads.values() for g in ab]
    norm = torch.sqrt(sum(torch.sum(g.double() ** 2) for g in flat)).float()
    factor = 1.0 if norm < cfg["max_grad_norm"] else cfg["max_grad_norm"] / norm
    state["count"] = state.get("count", 0) + 1
    n, b1, b2, lr, wd = state["count"], 0.9, 0.999, cfg["learning_rate"], cfg["weight_decay"]
    clipped = {}
    with torch.no_grad():
        for key, (a, bb) in lora.items():
            gs = tuple(g * factor for g in grads[key])
            clipped[key] = gs
            for j, (p, g) in enumerate(zip((a, bb), gs)):
                mu, nu = state.setdefault((key, j), (torch.zeros_like(p), torch.zeros_like(p)))
                mu.mul_(b1).add_((1 - b1) * g)
                nu.mul_(b2).add_((1 - b2) * g * g)
                update = (mu / (1 - b1 ** n)) / (torch.sqrt(nu / (1 - b2 ** n)) + 1e-8)
                p.sub_(lr * (update + wd * p))
    return clipped


def follow(ckpt, t: dict, lora: Dict[str, Tuple[torch.Tensor, torch.Tensor]], scale: float, cfg: dict,
           batches: List[dict], gen: torch.Generator, cos, sin) -> dict:
    """The first ``len(batches)`` steps from ``lora`` (updated in place):
    each step's loss, the first step's clipped gradient, the adapters after."""
    state: dict = {}
    losses, first = [], None
    for i, batch in enumerate(batches):
        lat = batch["latents"].float()
        sigmas, noise = draw_balanced(gen, lat.shape[0], lat.shape)
        loss, grads = loss_and_grads(ckpt, t, lora, scale, lat, batch["embeddings"], sigmas, noise, cos, sin)
        clipped = adamw(lora, grads, state, cfg)
        losses.append(loss)
        if i == 0:
            first = clipped
    return {"losses": losses, "first_grads": first, "after": {k: (a.detach().clone(), b.detach().clone())
                                                                for k, (a, b) in lora.items()}}
