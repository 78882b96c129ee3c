"""Train the subject segmenter U-Net on synthetic composites and save its weights.

The port of ``tools/train_segmenter.py``. Run on the card, or on the CPU with
``--device cpu``:

    python -m flux2_tpu_torch.tools.train_segmenter --steps 1500 --batch 16 --out seg.safetensors

The default ``--out`` is the committed ``chains/segmenter_weights.safetensors``,
as JAX's tool writes its own package's file.

Loss: the mean BCE-with-logits plus the mean soft-Dice (+1 smoothing) on
256x256 composites from ``chains.segmenter.synth_composite`` (a
``RandomState(seed)`` stream; the held-out IoU uses 16 composites from
``RandomState(10_000)``, the test fixtures' seeds). The optimizer is optax's
``adam`` (b1 0.9, b2 0.999, eps 1e-8 outside the square root) on
``cosine_decay_schedule(lr, steps, alpha=0.05)``: the first update uses step
0's rate. The network starts from ``segmenter.init_params`` drawn on the
CPU's generator (a seed gives the same weights on every device) and trains
in float32 with TF32 off. The printed lines are JAX's.
"""

from __future__ import annotations

import argparse
import math
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from flux2_tpu_torch.chains import segmenter as seg


def make_batch(rng: np.random.RandomState, batch: int, device: "torch.device | str" = "cpu"):
    """``batch`` composites -> (images [B, 3, 256, 256], masks [B, 256, 256]) on ``device``."""
    imgs, masks = zip(*(seg.synth_composite(rng) for _ in range(batch)))
    x = torch.from_numpy(np.stack(imgs)).permute(0, 3, 1, 2).contiguous()
    return x.to(device), torch.from_numpy(np.stack(masks)).to(device)


def loss_fn(model: seg.SegmenterUNet, imgs: torch.Tensor, masks: torch.Tensor) -> torch.Tensor:
    """BCE-with-logits (mean) + soft-Dice (mean over the batch), JAX's ``loss_fn``."""
    logits = model(imgs)
    bce = F.binary_cross_entropy_with_logits(logits, masks)
    prob = torch.sigmoid(logits)
    inter = (prob * masks).sum(dim=(1, 2))
    dice = 1.0 - (2 * inter + 1.0) / (prob.sum(dim=(1, 2)) + masks.sum(dim=(1, 2)) + 1.0)
    return bce + dice.mean()


def cosine_decay_schedule(init_value: float, decay_steps: int, alpha: float = 0.0) -> Callable[[int], float]:
    """optax's ``cosine_decay_schedule`` (exponent 1), in float32 as XLA computes it."""
    def schedule(count: int) -> float:
        frac = np.float32(min(count, decay_steps)) / np.float32(decay_steps)
        cosine = np.float32(0.5) * (np.float32(1.0) + np.cos(np.float32(math.pi) * frac, dtype=np.float32))
        return float(np.float32(init_value) * ((np.float32(1.0) - np.float32(alpha)) * cosine + np.float32(alpha)))
    return schedule


class Adam:
    """optax ``adam(schedule)`` over float32 parameters, updated in place:
    bias-corrected moments, eps added outside the square root, the rate of
    the update count before this update."""

    def __init__(self, params: Sequence[torch.nn.Parameter], schedule: Callable[[int], float],
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.params, self.schedule = list(params), schedule
        self.b1, self.b2, self.eps = b1, b2, eps
        self.count = 0
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor]) -> None:
        lr = self.schedule(self.count)
        self.count += 1
        b1, b2 = self.b1, self.b2
        for p, g, mu, nu in zip(self.params, grads, self.mu, self.nu):
            mu.copy_((1 - b1) * g + b1 * mu)
            nu.copy_((1 - b2) * torch.square(g) + b2 * nu)
            update = (mu / (1 - b1**self.count)) / (torch.sqrt(nu / (1 - b2**self.count)) + self.eps)
            p.add_(-lr * update)


def held_out_iou(model: seg.SegmenterUNet, device: "torch.device | str", n: int = 16) -> Dict[str, float]:
    """Mean IoU of the model and of the saliency heuristic on ``n`` composites
    from ``RandomState(10_000)``."""
    from flux2_tpu_torch.chains.subject_mask import saliency_foreground

    segmenter = seg.Segmenter(model, device)
    rng = np.random.RandomState(10_000)
    ious_m, ious_h = [], []
    for _ in range(n):
        img, mask = seg.synth_composite(rng)
        ious_m.append(seg.iou(segmenter(img), mask))
        ious_h.append(seg.iou(saliency_foreground(img), mask))
    model.train()
    return {"model": float(np.mean(ious_m)), "heuristic": float(np.mean(ious_h))}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="Train the subject segmenter U-Net on synthetic composites.")
    ap.add_argument("--steps", type=int, default=1500)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--lr", type=float, default=2e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=seg.WEIGHTS_FILE)
    ap.add_argument("--device", default="cuda", help="torch device (default cuda; cpu on a host without a card)")
    return ap


def train(args: argparse.Namespace, log: Callable[[str], None] = print) -> dict:
    """The run of ``main``: returns each step's loss, seconds a step (after the
    first), the held-out IoUs, the trained network and the path written."""
    from flux2_tpu_torch.pipeline.pipeline import _full_f32

    device = torch.device(args.device)
    model = seg.init_params(torch.Generator().manual_seed(args.seed)).to(device)
    params = list(model.parameters())
    log(f"segmenter params: {sum(p.numel() for p in params) / 1e6:.2f}M")
    opt = Adam(params, cosine_decay_schedule(args.lr, args.steps, 0.05))
    rng = np.random.RandomState(args.seed)
    losses: List[float] = []
    t0 = time.time()
    t1: Optional[float] = None
    with _full_f32():
        for i in range(1, args.steps + 1):
            imgs, masks = make_batch(rng, args.batch, device)
            loss = loss_fn(model, imgs, masks)
            grads = torch.autograd.grad(loss, params)
            opt.step(grads)
            losses.append(float(loss.detach()))
            if i == 1:
                t1 = time.time()
            if i % 100 == 0 or i == 1:
                log(f"step {i}/{args.steps} loss {losses[-1]:.4f} ({time.time() - t0:.0f}s)")
    if device.type == "cuda":
        torch.cuda.synchronize()
    s_per_step = (time.time() - t1) / (args.steps - 1) if args.steps > 1 else None
    iou = held_out_iou(model, device)
    log(f"held-out IoU: model {iou['model']:.3f} vs heuristic {iou['heuristic']:.3f}")
    seg.save_weights(model, args.out)
    log(f"weights -> {args.out}")
    return {"losses": losses, "s_per_step": s_per_step, "iou": iou, "model": model, "out": args.out}


def main(argv: Optional[Sequence[str]] = None) -> int:
    import sys

    train(build_parser().parse_args(argv), log=lambda line: print(line, flush=True))
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
