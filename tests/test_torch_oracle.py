"""Independent torch oracle for the FLUX.2 DiT (VERDICT r3 missing #2).

The encoders are cross-validated elementwise against HF torch
(test_hf_parity.py); these tests do the same for the core transformer. A
from-scratch torch implementation (tests/torch_flux2_oracle.py, written
against the reference semantics / diffusers' Flux2Transformer2DModel)
consumes a RANDOM checkpoint in the raw diffusers naming; the same raw dict
goes through io/weight_mapping.map_transformer_weights into the JAX forward.
Elementwise agreement therefore validates BOTH the forward math AND the
checkpoint mapping (QKV paths, fused single-block split, adaLN ordering,
the BFL [shift|scale] half-swap) against an implementation that shares no
code with the product path.

Unlike test_weight_mapping.py (JAX -> ckpt -> JAX roundtrips) and
test_transformer.py (self-generated goldens), nothing here is derived from
the JAX implementation.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flux2_tpu.io import weight_mapping as wm
from flux2_tpu.models.flux2 import transformer as tfm
from flux2_tpu.ops.rope import rope_embeddings
from flux2_tpu_torch.models.flux2.config import Flux2TransformerConfig

from tests.torch_flux2_oracle import (
    TorchFlux2Oracle,
    image_position_ids,
    random_diffusers_checkpoint,
    text_position_ids,
    to_bfl_format,
)
from tests.test_torch_shared_copies import jax_config

TINY = Flux2TransformerConfig(
    num_layers=2, num_single_layers=3, num_attention_heads=2,
    attention_head_dim=128, joint_attention_dim=96, guidance_embeds=True,
)
# Klein-4B cross-section: real head_dim/mlp_ratio and the Klein joint dim
# at reduced head count and depth — wide enough to exercise real-geometry
# reshapes/splits, small enough for CPU CI.
KLEIN_SLICE = Flux2TransformerConfig(
    num_layers=1, num_single_layers=2, num_attention_heads=8,
    attention_head_dim=128, joint_attention_dim=7680, guidance_embeds=False,
)


def _run_both(config: Flux2TransformerConfig, seed: int, h: int = 4, w_: int = 4, s_txt: int = 6):
    """(torch oracle output, JAX output) on an identical random checkpoint."""
    ckpt = random_diffusers_checkpoint(
        seed,
        num_layers=config.num_layers,
        num_single_layers=config.num_single_layers,
        num_heads=config.num_attention_heads,
        head_dim=config.attention_head_dim,
        joint_dim=config.joint_attention_dim,
        mlp_ratio=config.mlp_ratio,
        guidance_embeds=config.guidance_embeds,
    )

    rng = np.random.RandomState(seed + 1)
    b = 2
    lat = rng.randn(b, h * w_, config.in_channels).astype(np.float32)
    txt = rng.randn(b, s_txt, config.joint_attention_dim).astype(np.float32) * 0.2
    sigma = np.array([0.7, 0.25], np.float32)
    guid = np.array([4.0, 4.0], np.float32) if config.guidance_embeds else None

    img_ids = image_position_ids(h, w_)
    txt_ids = text_position_ids(s_txt)

    oracle = TorchFlux2Oracle(
        ckpt,
        num_layers=config.num_layers,
        num_single_layers=config.num_single_layers,
        num_heads=config.num_attention_heads,
        head_dim=config.attention_head_dim,
        guidance_embeds=config.guidance_embeds,
    )
    ref = oracle.forward(
        torch.from_numpy(lat), torch.from_numpy(txt), torch.from_numpy(sigma),
        img_ids, txt_ids,
        guidance=torch.from_numpy(guid) if guid is not None else None,
    ).numpy()

    raw = {k: v.numpy() for k, v in ckpt.items()}
    params = wm.map_transformer_weights(raw, jax_config(config), dtype=np.float32)
    ids = np.concatenate([txt_ids.numpy(), img_ids.numpy()], axis=0)
    cos, sin = rope_embeddings(jnp.asarray(ids))
    out = tfm.forward(
        params, jax_config(config), jnp.asarray(lat), jnp.asarray(txt), jnp.asarray(sigma),
        cos, sin, guidance=jnp.asarray(guid) if guid is not None else None,
    )
    return ref, np.asarray(out), raw, params


def test_dit_forward_matches_torch_oracle_tiny():
    ref, out, _, _ = _run_both(TINY, seed=0)
    assert np.max(np.abs(ref - out)) < 5e-4, f"max |diff| = {np.max(np.abs(ref - out))}"


def test_dit_forward_matches_torch_oracle_klein_slice():
    ref, out, _, _ = _run_both(KLEIN_SLICE, seed=7, h=4, w_=6, s_txt=8)
    assert np.max(np.abs(ref - out)) < 5e-4, f"max |diff| = {np.max(np.abs(ref - out))}"


def test_bfl_dialect_matches_torch_oracle():
    """BFL-native checkpoint keys (fused QKV / fused single linear1+linear2 /
    adaLN stored [shift|scale]) must land on the SAME oracle output — this is
    the independent check of the mapper's split-and-swap logic
    (WeightLoader.swift:80-205)."""
    config = TINY
    ckpt = random_diffusers_checkpoint(
        3,
        num_layers=config.num_layers,
        num_single_layers=config.num_single_layers,
        num_heads=config.num_attention_heads,
        head_dim=config.attention_head_dim,
        joint_dim=config.joint_attention_dim,
        mlp_ratio=config.mlp_ratio,
        guidance_embeds=config.guidance_embeds,
    )
    bfl = {k: v.numpy() for k, v in to_bfl_format(ckpt, config.num_layers, config.num_single_layers).items()}
    assert wm.is_bfl_format(bfl)
    params = wm.map_transformer_weights(bfl, jax_config(config), dtype=np.float32)

    rng = np.random.RandomState(11)
    lat = rng.randn(1, 16, config.in_channels).astype(np.float32)
    txt = rng.randn(1, 6, config.joint_attention_dim).astype(np.float32) * 0.2
    sigma = np.array([0.5], np.float32)
    guid = np.array([4.0], np.float32)
    img_ids, txt_ids = image_position_ids(4, 4), text_position_ids(6)

    oracle = TorchFlux2Oracle(
        ckpt, num_layers=config.num_layers, num_single_layers=config.num_single_layers,
        num_heads=config.num_attention_heads, head_dim=config.attention_head_dim,
    )
    ref = oracle.forward(
        torch.from_numpy(lat), torch.from_numpy(txt), torch.from_numpy(sigma),
        img_ids, txt_ids, guidance=torch.from_numpy(guid),
    ).numpy()

    ids = np.concatenate([txt_ids.numpy(), img_ids.numpy()], axis=0)
    cos, sin = rope_embeddings(jnp.asarray(ids))
    out = np.asarray(
        tfm.forward(params, jax_config(config), jnp.asarray(lat), jnp.asarray(txt), jnp.asarray(sigma),
                    cos, sin, guidance=jnp.asarray(guid))
    )
    assert np.max(np.abs(ref - out)) < 5e-4, f"max |diff| = {np.max(np.abs(ref - out))}"


def test_oracle_is_sensitive():
    """Guard against a vacuous oracle: perturbing ONE mapped leaf must move
    the output far beyond the parity tolerance."""
    config = TINY
    ref, out, raw, params = _run_both(config, seed=5)
    raw2 = dict(raw)
    # sign-flip one double-block Q projection in the raw checkpoint
    raw2["transformer_blocks.0.attn.to_q.weight"] = -raw2["transformer_blocks.0.attn.to_q.weight"]
    params2 = wm.map_transformer_weights(raw2, jax_config(config), dtype=np.float32)

    rng = np.random.RandomState(6)
    lat = rng.randn(2, 16, config.in_channels).astype(np.float32)
    txt = rng.randn(2, 6, config.joint_attention_dim).astype(np.float32) * 0.2
    sigma = np.array([0.7, 0.25], np.float32)
    guid = np.array([4.0, 4.0], np.float32)
    ids = np.concatenate([text_position_ids(6).numpy(), image_position_ids(4, 4).numpy()], axis=0)
    cos, sin = rope_embeddings(jnp.asarray(ids))

    a = tfm.forward(params, jax_config(config), jnp.asarray(lat), jnp.asarray(txt), jnp.asarray(sigma),
                    cos, sin, guidance=jnp.asarray(guid))
    b = tfm.forward(params2, jax_config(config), jnp.asarray(lat), jnp.asarray(txt), jnp.asarray(sigma),
                    cos, sin, guidance=jnp.asarray(guid))
    assert np.max(np.abs(np.asarray(a) - np.asarray(b))) > 1e-2
