"""Seeded checkpoints of a FLUX.2-dev configuration (``benchmark/weights.py``'s
scheme): the Diffusers DiT and VAE decoder of ``weights.py``, and the text
encoder as the language model of an HF ``Mistral3ForConditionalGeneration``
checkpoint, under its published ``language_model.`` names (the vision tower
and projector, which text-to-image never runs, are left out).
"""

from __future__ import annotations

from typing import Dict, List

import torch

from benchmark import weights as W


def mistral_groups(e: dict) -> List[W.Group]:
    """The language model of a Mistral-Small-3.2 checkpoint of config ``e``
    (the ``text_encoder`` entry: the published ``text_config``'s keys): no
    q/k norm, an untied ``lm_head``."""
    h, hd, inter = e["hidden_size"], e["head_dim"], e["intermediate_size"]
    q_dim, kv_dim = e["num_attention_heads"] * hd, e["num_key_value_heads"] * hd
    pre = "language_model.model."
    groups = [W.Group("embed", (W.Leaf(pre + "embed_tokens.weight", (e["vocab_size"], h), "normal", 0.02),))]
    for i in range(e["num_hidden_layers"]):
        p = f"{pre}layers.{i}."
        leaves = (
            W.Leaf(p + "input_layernorm.weight", (h,), "ones"),
            W._lin(p + "self_attn.q_proj.weight", q_dim, h),
            W._lin(p + "self_attn.k_proj.weight", kv_dim, h),
            W._lin(p + "self_attn.v_proj.weight", kv_dim, h),
            W._lin(p + "self_attn.o_proj.weight", h, q_dim),
            W.Leaf(p + "post_attention_layernorm.weight", (h,), "ones"),
            W._lin(p + "mlp.gate_proj.weight", inter, h),
            W._lin(p + "mlp.up_proj.weight", inter, h),
            W._lin(p + "mlp.down_proj.weight", h, inter),
        )
        groups.append(W.Group(f"layer.{i}", leaves))
    groups.append(W.Group("tail", (W.Leaf(pre + "norm.weight", (h,), "ones"),
                                   W._lin("language_model.lm_head.weight", e["vocab_size"], h))))
    return groups


def checkpoints(config: dict, seed: int, device) -> Dict[str, W.SeededCheckpoint]:
    """"transformer" (with the guidance embedder) and "text_encoder" in the
    configuration's dtype, "vae" in float32, as ``weights.checkpoints``."""
    dtype = W.DTYPES[config["dtype"]]
    return {
        "transformer": W.SeededCheckpoint(W.dit_groups(config["transformer"]), seed, "transformer", device, dtype),
        "vae": W.SeededCheckpoint(W.vae_decoder_groups(config["vae"]), seed, "vae", device, torch.float32),
        "text_encoder": W.SeededCheckpoint(mistral_groups(config["text_encoder"]), seed, "text_encoder", device, dtype),
    }
