"""Inference-side LoRA loading: safetensors files in either key dialect -> the
port's ``LoRA`` adapters, merged into the DiT.

Port of ``flux2_tpu/training/lora_loader.py``:
  - both key dialects: Diffusers / PEFT (``transformer.transformer_blocks.N
    .attn.to_q.lora_A.weight``, ``base_model.model.`` prefixes,
    ``lora_A``/``lora_B`` or ``lora_down``/``lora_up``, the fused single-block
    ``to_qkv_mlp_proj`` and ``to_out``) and BFL native (``double_blocks.N
    .img_attn.qkv`` with its B split three ways, ``single_blocks.N.linear1``
    split at [inner, 2 inner, 3 inner, 3 inner + mlp], ``linear2`` with A
    split into its attention and MLP halves);
  - alpha from the metadata (``alpha`` / ``lora_alpha``, else the rank) or a
    sidecar ``<stem>.json``, ``scale = alpha / rank * user_scale``;
  - the sidecar's scheduler overrides (custom sigmas, steps, guidance, as
    Turbo LoRAs carry) and activation keyword;
  - target-model detection by block counts, the runtime semantics of several
    LoRAs, and their additive merge.

Pairs keep JAX's orientation, ``a [in, r]`` and ``b [r, out]``, as float
tensors on the CPU. ``to_stacked_lora`` builds the port's ``LoRA`` module
(``training/lora.py``): one ``Adapter`` per block and target, zeros where the
file does not cover a block, as JAX's stacked leaves hold them.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import torch

from flux2_tpu_torch.models.flux2.config import Flux2TransformerConfig
from flux2_tpu_torch.training.lora import GROUPS, LoRA, Adapter, merge_into_params

Pairs = Dict[Tuple[str, str], Dict[int, Tuple[torch.Tensor, torch.Tensor]]]


@dataclasses.dataclass
class LoRASchedulerOverrides:
    """Turbo-LoRA style overrides."""

    custom_sigmas: Optional[List[float]] = None
    num_steps: Optional[int] = None
    guidance: Optional[float] = None


@dataclasses.dataclass
class LoadedLoRA:
    pairs: Pairs
    rank: int
    alpha: float
    scale: float  # alpha / rank * user_scale
    target_layers: int
    overrides: LoRASchedulerOverrides = dataclasses.field(default_factory=LoRASchedulerOverrides)
    activation_keyword: Optional[str] = None

    def apply_prompt_prefix(self, prompt: str) -> str:
        """Prefix the activation keyword when the prompt lacks it (any case)."""
        kw = self.activation_keyword
        if kw and kw.lower() not in prompt.lower():
            return f"{kw}, {prompt}"
        return prompt


# canonical (group, leaf) targets by normalized layer suffix
_DIFFUSERS_LEAF = {
    "attn.to_q": ("double_blocks", "to_q"),
    "attn.to_k": ("double_blocks", "to_k"),
    "attn.to_v": ("double_blocks", "to_v"),
    "attn.to_out.0": ("double_blocks", "to_out"),
    "attn.to_out": ("double_blocks", "to_out"),
    "attn.add_q_proj": ("double_blocks", "add_q"),
    "attn.add_k_proj": ("double_blocks", "add_k"),
    "attn.add_v_proj": ("double_blocks", "add_v"),
    "attn.to_add_out": ("double_blocks", "add_out"),
    "ff.linear_in": ("double_blocks", "ff_in"),
    "ff.linear_out": ("double_blocks", "ff_out"),
    "ff_context.linear_in": ("double_blocks", "ff_ctx_in"),
    "ff_context.linear_out": ("double_blocks", "ff_ctx_out"),
}

# BFL native double-block names -> leaves (the fused qkv splits three ways)
_BFL_DOUBLE = {
    "img_attn.proj": "to_out",
    "txt_attn.proj": "add_out",
    "img_mlp.0": "ff_in",
    "img_mlp.2": "ff_out",
    "txt_mlp.0": "ff_ctx_in",
    "txt_mlp.2": "ff_ctx_out",
}
_FUSED_SINGLE = ("to_q", "to_k", "to_v", "mlp_gate", "mlp_up")


def load_lora_file(
    path: str,
    config: Flux2TransformerConfig,
    user_scale: float = 1.0,
    config_path: Optional[str] = None,
) -> LoadedLoRA:
    """A LoRA safetensors file (either dialect) with its metadata and its
    sidecar JSON (``config_path``, else ``<stem>.json`` beside the file)."""
    from flux2_tpu_torch.io import safetensors_io

    weights = safetensors_io.load_file(path)
    metadata = safetensors_io.load_metadata(path)
    lora = parse_lora_weights(weights, config)

    rank = lora["rank"]
    alpha = float(metadata.get("alpha", metadata.get("lora_alpha", rank)))
    overrides = LoRASchedulerOverrides()
    keyword = metadata.get("activation_keyword") or metadata.get("trigger")

    cfg_file = config_path or os.path.splitext(path)[0] + ".json"
    if os.path.exists(cfg_file):
        with open(cfg_file) as f:
            cfg = json.load(f)
        alpha = float(cfg.get("alpha", alpha))
        keyword = cfg.get("activation_keyword", keyword)
        sched = cfg.get("scheduler", cfg)
        overrides = LoRASchedulerOverrides(
            custom_sigmas=sched.get("custom_sigmas"),
            num_steps=sched.get("num_steps"),
            guidance=sched.get("guidance"),
        )

    return LoadedLoRA(
        pairs=lora["pairs"],
        rank=rank,
        alpha=alpha,
        scale=alpha / rank * user_scale,
        target_layers=lora["target_layers"],
        overrides=overrides,
        activation_keyword=keyword,
    )


def parse_lora_weights(weights: Mapping[str, "torch.Tensor"], config: Flux2TransformerConfig) -> dict:
    """Group lora_A/lora_B keys into canonical (group, leaf, layer) pairs:
    {"pairs": {(group, leaf): {layer: (a [in, r], b [r, out])}}, "rank",
    "target_layers"}. Values may be torch tensors or numpy arrays."""
    inner = config.inner_dim
    mlp = config.mlp_hidden_dim
    fused_sections = [inner, 2 * inner, 3 * inner, 3 * inner + mlp]
    groups: Dict[str, Dict[str, torch.Tensor]] = {}
    for key, v in weights.items():
        if key.endswith(".lora_A.weight") or key.endswith(".lora_down.weight"):
            base, part = re.sub(r"\.(lora_A|lora_down)\.weight$", "", key), "a"
        elif key.endswith(".lora_B.weight") or key.endswith(".lora_up.weight"):
            base, part = re.sub(r"\.(lora_B|lora_up)\.weight$", "", key), "b"
        else:
            continue
        base = re.sub(r"^(base_model\.model\.|transformer\.|diffusion_model\.)", "", base)
        groups.setdefault(base, {})[part] = torch.as_tensor(v)

    pairs: Pairs = {}
    rank = 0
    max_layer = -1

    def put(group: str, leaf: str, idx: int, a: torch.Tensor, b: torch.Tensor) -> None:
        # torch convention: lora_A [r, in], lora_B [out, r]; ours: a [in, r], b [r, out]
        pairs.setdefault((group, leaf), {})[idx] = (a.T.contiguous(), b.T.contiguous())

    for base, ab in groups.items():
        if "a" not in ab or "b" not in ab:
            continue
        a, b = ab["a"], ab["b"]
        rank = max(rank, a.shape[0])

        m = re.match(r"transformer_blocks\.(\d+)\.(.+)", base)
        if m:
            idx, rest = int(m.group(1)), m.group(2)
            max_layer = max(max_layer, idx)
            tgt = _DIFFUSERS_LEAF.get(rest)
            if tgt:
                put(tgt[0], tgt[1], idx, a, b)
            continue
        m = re.match(r"single_transformer_blocks\.(\d+)\.(.+)", base)
        if m:
            idx, rest = int(m.group(1)), m.group(2)
            max_layer = max(max_layer, idx)
            if rest == "attn.to_qkv_mlp_proj":
                # fused projection: B's out axis splits into q/k/v/gate/up
                for leaf, bseg in zip(_FUSED_SINGLE, torch.tensor_split(b, fused_sections, dim=0)):
                    put("single_blocks", leaf, idx, a, bseg)
            elif rest in ("attn.to_out", "attn.to_out.0"):
                # fused output: A's in axis splits into the attention and MLP halves
                put("single_blocks", "out_attn", idx, a[:, :inner], b)
                put("single_blocks", "out_mlp", idx, a[:, inner:], b)
            continue
        m = re.match(r"double_blocks\.(\d+)\.(.+)", base)
        if m:  # BFL native
            idx, rest = int(m.group(1)), m.group(2)
            max_layer = max(max_layer, idx)
            if rest in ("img_attn.qkv", "txt_attn.qkv"):
                # fused QKV: B [3 inner, r] splits, A is shared
                leaves = ("to_q", "to_k", "to_v") if "img" in rest else ("add_q", "add_k", "add_v")
                for leaf, bseg in zip(leaves, torch.tensor_split(b, 3, dim=0)):
                    put("double_blocks", leaf, idx, a, bseg)
            elif rest in _BFL_DOUBLE:
                put("double_blocks", _BFL_DOUBLE[rest], idx, a, b)
            continue
        m = re.match(r"single_blocks\.(\d+)\.(.+)", base)
        if m:
            idx, rest = int(m.group(1)), m.group(2)
            max_layer = max(max_layer, idx)
            if rest == "linear1":
                for leaf, bseg in zip(_FUSED_SINGLE, torch.tensor_split(b, fused_sections, dim=0)):
                    put("single_blocks", leaf, idx, a, bseg)
            elif rest == "linear2":
                put("single_blocks", "out_attn", idx, a[:, :inner], b)
                put("single_blocks", "out_mlp", idx, a[:, inner:], b)
            continue

    return {"pairs": pairs, "rank": rank, "target_layers": max_layer + 1}


def detect_target_model(pairs: Pairs, config_candidates: Sequence[Tuple[str, Flux2TransformerConfig]]) -> Optional[str]:
    """The first candidate whose block counts hold every layer the LoRA touches."""
    max_double = -1
    max_single = -1
    for (group, _leaf), layers in pairs.items():
        hi = max(layers) if layers else -1
        if group == "double_blocks":
            max_double = max(max_double, hi)
        else:
            max_single = max(max_single, hi)
    for name, cfg in config_candidates:
        if max_double < cfg.num_layers and max_single < cfg.num_single_layers:
            return name
    return None


def to_stacked_lora(loaded: LoadedLoRA, config: Flux2TransformerConfig,
                    device: "torch.device | str" = "cpu") -> LoRA:
    """Per-layer pairs -> the port's ``LoRA`` (float32 on ``device``): one
    ``Adapter`` per block and target; blocks the file does not cover get
    zeros (an identity contribution), layers beyond the model are dropped."""
    blocks: Dict[str, list] = {}
    for (group, leaf), layers in loaded.pairs.items():
        n = config.num_layers if group == "double_blocks" else config.num_single_layers
        sample_a, sample_b = next(iter(layers.values()))
        r = sample_a.shape[1]
        per_block = blocks.setdefault(group, [{} for _ in range(n)])
        for i in range(n):
            a = torch.zeros(sample_a.shape[0], r, dtype=torch.float32, device=device)
            b = torch.zeros(r, sample_b.shape[1], dtype=torch.float32, device=device)
            if i in layers:
                a.copy_(layers[i][0])
                b.copy_(layers[i][1])
            per_block[i][leaf] = Adapter(a, b)
    return LoRA({g: blocks[g] for g in GROUPS if g in blocks})


def merge_loras_into_params(transformer: torch.nn.Module, loaded_loras: Sequence[LoadedLoRA],
                            config: Flux2TransformerConfig) -> torch.nn.Module:
    """Merge LoRAs additively, in place: W += sum_i scale_i * (a_i @ b_i),
    one LoRA after another (``training.lora.merge_into_params``)."""
    device = next(transformer.parameters()).device  # the norm scales: never quantized
    for lora in loaded_loras:
        merge_into_params(transformer, to_stacked_lora(lora, config, device), lora.scale)
    return transformer


def merge_runtime_semantics(
    loaded_loras: Sequence[LoadedLoRA],
) -> Tuple[LoRASchedulerOverrides, List[str], List[str]]:
    """Combine scheduler overrides and activation keywords across LoRAs.

    Per override field the last LoRA wins; a conflict (two LoRAs setting the
    same field to different values) produces a warning string. Returns
    (overrides, keywords, warnings)."""
    merged = LoRASchedulerOverrides()
    keywords: List[str] = []
    warnings: List[str] = []
    for lora in loaded_loras:
        ov = lora.overrides
        for field in ("custom_sigmas", "num_steps", "guidance"):
            new = getattr(ov, field)
            if new is None:
                continue
            old = getattr(merged, field)
            if old is not None and old != new:
                warnings.append(
                    f"multiple LoRAs override {field} ({old!r} -> {new!r}); using the last"
                )
            setattr(merged, field, new)
        kw = lora.activation_keyword
        if kw and kw not in keywords:
            keywords.append(kw)
    return merged, keywords, warnings
