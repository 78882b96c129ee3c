"""LoRA adapters for the FLUX.2 DiT: targets, init, merge.

Port of ``flux2_tpu/training/lora.py``. The adapters are an ``nn.Module`` of
trainable float32 ``nn.Parameter``s, one ``Adapter`` (a, b) per block and
target: ``lora.double_blocks[i]["to_q"].a``. Each keeps JAX's orientation,
``a [in, r]`` and ``b [r, out]``, so JAX's stacked leaf ``a [L, in, r]`` is a
plain stack of the port's (``flux2_tpu_torch.io.jax_params.lora_from_jax``).

Training applies them UNMERGED (``transformer.forward(lora=...)``:
y = x W^T + scale * (x a) b), on a dense or a quantized base (QLoRA: the
base projections run their kernels, ``ops.quant.KernelLinear`` carries the
gradient to x). ``merge_into_params`` folds them into the base for
inference: a dense weight in float32, a stored ``QTensor`` dequantized,
summed and requantized in its format one block at a time (JAX's
``_merge_qtensor_slicewise``); a runtime W8A8 / W4A8 weight raises JAX's
``TypeError``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
from torch import nn
from torch.distributed.tensor import DTensor

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


def _dims(w) -> Tuple[int, int]:
    """(in, out) of a base weight stored [out, in], dense or quantized."""
    if isinstance(w, torch.Tensor):
        return w.shape[1], w.shape[0]
    return w.orig_in, w.q.shape[-2]


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
            d_in, d_out = _dims(getattr(block, leaf))
            bound = d_in**-0.5
            a = torch.rand(d_in, config.rank, generator=generator, device=device, dtype=torch.float32)
            blocks[group][i][leaf] = Adapter(a.mul_(2 * bound).sub_(bound),
                                             torch.zeros(config.rank, d_out, device=device, dtype=torch.float32))
    return LoRA({g: v for g, v in blocks.items() if any(v)})


@torch.no_grad()
def merge_into_params(transformer: nn.Module, lora: LoRA, scale: float) -> nn.Module:
    """Fold the adapters into the base IN PLACE (the port holds one copy of
    the weights, where JAX returns a new pytree): W[out, in] +=
    scale * (a @ b)^T, the product in float32 (TF32 off). A dense W is summed
    in float32 and cast back to its dtype; a stored QTensor is dequantized,
    summed and requantized in its format and group size, and the new module
    takes the old one's place (the float32 transient is one block's [N, K]);
    a W8A8 / W4A8 weight raises ``TypeError``, as in JAX. A block on ``meta``
    (another pipeline stage's) is skipped; a weight held as DTensors merges
    on its whole value and keeps its placements. Each merged weight is a new
    tensor in its block, so a copy that shares the old ones leaves them as
    they were (``merged_copy``)."""
    from flux2_tpu_torch.ops import quant

    for group in GROUPS:
        for i, adapters in enumerate(getattr(lora, group)):
            block = getattr(transformer, group)[i]
            if any(t.is_meta for t in block.parameters()):
                continue  # another pipeline stage's block (parallel.pipeline.place_stages)
            for leaf, ad in adapters.items():
                w = getattr(block, leaf)
                if isinstance(w, (quant.W8A8Tensor, quant.W4A8Tensor)):
                    raise TypeError(
                        f"cannot merge LoRA into runtime-format leaf {group}/{leaf} "
                        f"({type(w).__name__}); merge into the storage-format or "
                        "bf16 params before converting to w8a8/w4a8"
                    )
                device = w.device if isinstance(w, torch.Tensor) else w.q.device
                delta = _delta(ad.a.to(device), ad.b.to(device))
                if isinstance(w if isinstance(w, torch.Tensor) else w.q, DTensor):
                    _merge_sharded(block, leaf, w, delta, scale)
                elif isinstance(w, torch.Tensor):
                    block._parameters[leaf] = nn.Parameter((w.float() + scale * delta).to(w.dtype), requires_grad=False)
                else:
                    quant._replace(block, leaf, _merge_qtensor(w, delta, scale))
    return transformer


def merged_copy(transformer: nn.Module, lora: LoRA, scale: float) -> nn.Module:
    """A copy of ``transformer`` with the adapters folded in, the original
    untouched (the previews' R5): the copy shares every tensor (and mesh) of
    the original but the merged weights, which are new."""
    import copy

    from torch.distributed.device_mesh import DeviceMesh

    memo = {id(t): t for t in [*transformer.parameters(), *transformer.buffers()]}
    for mod in transformer.modules():
        memo.update({id(v): v for v in vars(mod).values() if isinstance(v, DeviceMesh)})
    return merge_into_params(copy.deepcopy(transformer, memo), lora, scale)


def _merge_sharded(block: nn.Module, leaf: str, w, delta: torch.Tensor, scale: float) -> None:
    """Merge into a weight held as DTensors (a sharded DiT): on its whole
    value, then each rank keeps its chunk with the old placements again."""
    import copy

    from flux2_tpu_torch.ops import quant
    from flux2_tpu_torch.parallel import sharding as sh

    if isinstance(w, torch.Tensor):
        full = w.full_tensor()
        merged = sh.distribute((full.float() + scale * delta).to(full.dtype), w.device_mesh, w.placements)
        block._parameters[leaf] = nn.Parameter(merged, requires_grad=False)
        return
    whole = copy.copy(w)
    whole._buffers = {k: (b.full_tensor() if b is not None else None) for k, b in w._buffers.items()}
    merged = _merge_qtensor(whole, delta, scale)
    for k, b in merged._buffers.items():
        old = w._buffers.get(k)
        if b is not None and isinstance(old, DTensor):
            merged._buffers[k] = sh.distribute(b, old.device_mesh, old.placements)
    quant._replace(block, leaf, merged)


def _delta(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a @ b)^T [out, in] in float32, with TF32 off for the product."""
    flag = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return (a.float() @ b.float()).T
    finally:
        torch.backends.cuda.matmul.allow_tf32 = flag


def _merge_qtensor(w, delta: torch.Tensor, scale: float):
    """dequantize -> add -> requantize one block's stored QTensor: JAX's
    ``_merge_qtensor_slicewise`` on one slice of its ``lax.map``, so with
    XLA's in-``jit`` arithmetic (the fused dequantize, the reciprocal scale)."""
    from flux2_tpu_torch.ops import quant

    dense = quant.dequantize(w, torch.float32, fused=True)
    return quant.quantize(dense + scale * delta, w.format, group_size=w.group_size, in_jit=True)


def num_lora_params(lora: LoRA) -> int:
    return sum(p.numel() for p in lora.parameters())
