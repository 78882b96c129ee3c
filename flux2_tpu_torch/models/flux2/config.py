"""FLUX.2 model-family configuration: the port's own copy of
``flux2_tpu/models/flux2/config.py``, equal field by field
(``tests/test_torch_shared_copies.py``).

Mirrors the reference's model enum and transformer configs
(``Sources/Flux2Core/Configuration/Flux2Config.swift:9-329``): Dev 32B,
Klein 9B/4B (+ non-distilled base variants for training, + the KV-cached
Klein-9B variant), with per-model generation defaults.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class Flux2TransformerConfig:
    patch_size: int = 1
    in_channels: int = 128
    out_channels: int = 128
    num_layers: int = 8  # double-stream blocks
    num_single_layers: int = 48
    attention_head_dim: int = 128
    num_attention_heads: int = 48
    joint_attention_dim: int = 15360
    pooled_projection_dim: int = 768
    guidance_embeds: bool = True
    axes_dims_rope: Tuple[int, ...] = (32, 32, 32, 32)
    rope_theta: float = 2000.0
    mlp_ratio: float = 3.0
    time_embed_channels: int = 256

    @property
    def inner_dim(self) -> int:
        return self.num_attention_heads * self.attention_head_dim

    @property
    def mlp_hidden_dim(self) -> int:
        return int(self.inner_dim * self.mlp_ratio)

    @classmethod
    def from_json_dict(cls, d: dict) -> "Flux2TransformerConfig":
        """Parse a diffusers transformer config.json (Flux2Config.swift:333-374)."""
        return cls(
            patch_size=d.get("patch_size", 1),
            in_channels=d.get("in_channels", 128),
            out_channels=d.get("out_channels", 128),
            num_layers=d.get("num_layers", 8),
            num_single_layers=d.get("num_single_layers", 48),
            attention_head_dim=d.get("attention_head_dim", 128),
            num_attention_heads=d.get("num_attention_heads", 48),
            joint_attention_dim=d.get("joint_attention_dim", 15360),
            pooled_projection_dim=d.get("pooled_projection_dim", 768),
            guidance_embeds=d.get("guidance_embeds", True),
            axes_dims_rope=tuple(d.get("axes_dims_rope", (32, 32, 32, 32))),
            rope_theta=d.get("rope_theta", 2000.0),
            mlp_ratio=d.get("mlp_ratio", 3.0),
        )


FLUX2_DEV = Flux2TransformerConfig()

KLEIN_9B = Flux2TransformerConfig(
    num_layers=8,
    num_single_layers=24,
    num_attention_heads=32,  # 32 x 128 = 4096
    joint_attention_dim=12288,  # Qwen3-8B: 3 x 4096
    guidance_embeds=False,
)

KLEIN_4B = Flux2TransformerConfig(
    num_layers=5,
    num_single_layers=20,
    num_attention_heads=24,  # 24 x 128 = 3072
    joint_attention_dim=7680,  # Qwen3-4B: 3 x 2560
    guidance_embeds=False,
)

# Tiny config for hermetic tests (not a real checkpoint shape).
TINY_TEST = Flux2TransformerConfig(
    num_layers=2,
    num_single_layers=3,
    attention_head_dim=128,
    num_attention_heads=2,
    joint_attention_dim=384,
    guidance_embeds=True,
)


class Flux2Model(enum.Enum):
    """Model variants with per-model generation defaults (Flux2Config.swift:9-205)."""

    DEV = "dev"
    KLEIN_4B = "klein-4b"
    KLEIN_4B_BASE = "klein-4b-base"
    KLEIN_9B = "klein-9b"
    KLEIN_9B_BASE = "klein-9b-base"
    KLEIN_9B_KV = "klein-9b-kv"

    @property
    def transformer_config(self) -> Flux2TransformerConfig:
        if self is Flux2Model.DEV:
            return FLUX2_DEV
        if self in (Flux2Model.KLEIN_4B, Flux2Model.KLEIN_4B_BASE):
            return KLEIN_4B
        return KLEIN_9B

    @property
    def default_steps(self) -> int:
        return 28 if self is Flux2Model.DEV else 4

    @property
    def default_guidance(self) -> float:
        if self is Flux2Model.DEV:
            return 4.0
        if self in (Flux2Model.KLEIN_4B_BASE, Flux2Model.KLEIN_9B_BASE):
            return 3.5  # classical CFG scale for non-distilled base models
        return 1.0

    @property
    def uses_guidance_embeds(self) -> bool:
        return self is Flux2Model.DEV

    @property
    def uses_classical_cfg(self) -> bool:
        """Base (non-distilled) models run a two-pass cond/uncond CFG."""
        return self in (Flux2Model.KLEIN_4B_BASE, Flux2Model.KLEIN_9B_BASE)

    @property
    def supports_kv_cache(self) -> bool:
        return self is Flux2Model.KLEIN_9B_KV

    @property
    def max_reference_images(self) -> int:
        return 6 if self is Flux2Model.DEV else 4

    @property
    def joint_attention_dim(self) -> int:
        return self.transformer_config.joint_attention_dim

    @property
    def is_commercial_licensed(self) -> bool:
        """Klein models are Apache-2.0; Dev is the BFL non-commercial license."""
        return self is not Flux2Model.DEV
