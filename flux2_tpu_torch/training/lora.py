"""LoRA adapters for the FLUX.2 DiT: targets, init, merge.

Port of ``flux2_tpu/training/lora.py``. The adapters are an ``nn.Module`` of
trainable float32 ``nn.Parameter``s, one ``Adapter`` (a, b) per block and
target: ``lora.double_blocks[i]["to_q"].a``. Each keeps JAX's orientation,
``a [in, r]`` and ``b [r, out]``, so JAX's stacked leaf ``a [L, in, r]`` is a
plain stack of the port's (``flux2_tpu_torch.io.jax_params.lora_from_jax``).

Training applies them UNMERGED (``transformer.forward(lora=...)``:
y = x W^T + scale * (x a) b); ``merge_into_params`` folds them into a dense
base for inference. A quantized base (QTensor merge, QLoRA training) is
ROADMAP queue 12 and raises.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
from torch import nn

# DiT leaves that take LoRA adapters, keyed (block_group, leaf), as in JAX.
DEFAULT_TARGETS: Tuple[Tuple[str, str], ...] = (
    ("double_blocks", "to_q"),
    ("double_blocks", "to_k"),
    ("double_blocks", "to_v"),
    ("double_blocks", "to_out"),
    ("double_blocks", "add_q"),
    ("double_blocks", "add_k"),
    ("double_blocks", "add_v"),
    ("double_blocks", "add_out"),
    ("double_blocks", "ff_in"),
    ("double_blocks", "ff_out"),
    ("double_blocks", "ff_ctx_in"),
    ("double_blocks", "ff_ctx_out"),
    ("single_blocks", "to_q"),
    ("single_blocks", "to_k"),
    ("single_blocks", "to_v"),
    ("single_blocks", "mlp_gate"),
    ("single_blocks", "mlp_up"),
    ("single_blocks", "out_attn"),
    ("single_blocks", "out_mlp"),
)

ATTENTION_ONLY_TARGETS: Tuple[Tuple[str, str], ...] = tuple(
    t for t in DEFAULT_TARGETS if t[1] not in ("ff_in", "ff_out", "ff_ctx_in", "ff_ctx_out", "mlp_gate", "mlp_up", "out_mlp")
)
GROUPS = ("double_blocks", "single_blocks")


@dataclasses.dataclass(frozen=True)
class LoRAConfig:
    rank: int = 16
    alpha: float = 16.0
    targets: Tuple[Tuple[str, str], ...] = DEFAULT_TARGETS

    @property
    def scale(self) -> float:
        return self.alpha / self.rank


class Adapter(nn.Module):
    """One target's pair: a [in, r], b [r, out]."""

    def __init__(self, a: torch.Tensor, b: torch.Tensor):
        super().__init__()
        self.a = nn.Parameter(a)
        self.b = nn.Parameter(b)


class LoRA(nn.Module):
    """Adapters of a DiT: ``double_blocks`` and ``single_blocks`` are lists (one
    entry per block) of ``ModuleDict``s keyed by target leaf."""

    def __init__(self, blocks: Dict[str, list]):
        super().__init__()
        for group in GROUPS:
            setattr(self, group, nn.ModuleList(nn.ModuleDict(d) for d in blocks.get(group, [])))

    def block(self, group: str, i: int) -> Optional[nn.ModuleDict]:
        """Block ``i``'s adapters, or None when the group has none."""
        blocks = getattr(self, group)
        return blocks[i] if len(blocks) else None

    def targets(self) -> Tuple[Tuple[str, str], ...]:
        return tuple((group, name) for group in GROUPS
                     for name in (getattr(self, group)[0].keys() if len(getattr(self, group)) else ()))


def _dims(w, group: str, leaf: str) -> Tuple[int, int]:
    """(in, out) of a base weight stored [out, in]."""
    if not isinstance(w, torch.Tensor):
        raise NotImplementedError(
            f"LoRA on a quantized base ({group}.{leaf} is {type(w).__name__}) is QLoRA, ROADMAP queue 12")
    return w.shape[1], w.shape[0]


def init_lora(
    transformer: nn.Module,
    config: LoRAConfig,
    generator: torch.Generator,
) -> LoRA:
    """Adapters for every target of ``config`` on ``transformer``'s blocks:
    ``a ~ U(-1/sqrt(in), 1/sqrt(in))``, ``b = 0`` (training starts at the
    base), float32 on the generator's device, drawn from ``generator`` target
    by target, block by block."""
    device = generator.device
    blocks: Dict[str, list] = {group: [{} for _ in getattr(transformer, group)] for group in GROUPS}
    for group, leaf in config.targets:
        for i, block in enumerate(getattr(transformer, group)):
            d_in, d_out = _dims(getattr(block, leaf), group, leaf)
            bound = d_in**-0.5
            a = torch.rand(d_in, config.rank, generator=generator, device=device, dtype=torch.float32)
            blocks[group][i][leaf] = Adapter(a.mul_(2 * bound).sub_(bound),
                                             torch.zeros(config.rank, d_out, device=device, dtype=torch.float32))
    return LoRA({g: v for g, v in blocks.items() if any(v)})


@torch.no_grad()
def merge_into_params(transformer: nn.Module, lora: LoRA, scale: float) -> nn.Module:
    """Fold the adapters into the dense base IN PLACE (the port holds one copy
    of the weights, where JAX returns a new pytree): W[out, in] +=
    scale * (a @ b)^T, computed in float32 and cast back to W's dtype."""
    for group in GROUPS:
        for i, adapters in enumerate(getattr(lora, group)):
            block = getattr(transformer, group)[i]
            for leaf, ad in adapters.items():
                w = getattr(block, leaf)
                _dims(w, group, leaf)
                delta = (ad.a.float() @ ad.b.float()).T
                w.copy_((w.float() + scale * delta.to(w.device)).to(w.dtype))
    return transformer


def num_lora_params(lora: LoRA) -> int:
    return sum(p.numel() for p in lora.parameters())
