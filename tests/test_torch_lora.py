"""The port's LoRA adapters (``flux2_tpu_torch/training/lora.py``) against JAX's.

Weights come from the JAX package's ``init_params`` (f32) perturbed with
seeded numpy noise and carried into the port by ``io/jax_params``; adapters
from JAX's ``init_lora`` with seeded non-zero ``b``, carried by
``lora_from_jax``. Tolerances: merge 1e-6 absolute (one f32 matmul and add
per weight in both packages); unmerged against merged forward 2e-5, as
tests/test_training.py holds JAX's own.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flux2_tpu.models.flux2 import transformer as jtfm
from flux2_tpu.training import lora as jlora
from flux2_tpu.training import trainer as jtrainer
from flux2_tpu_torch.models.flux2.config import Flux2TransformerConfig
from flux2_tpu_torch.io.jax_params import lora_from_flat, lora_from_jax, lora_to_flat, transformer_from_jax
from flux2_tpu_torch.ops import quant as tq
from flux2_tpu_torch.training import lora as tlora

from tests.test_torch_transformer import perturbed_numpy
from tests.test_torch_shared_copies import jax_config

CONFIG = Flux2TransformerConfig(num_layers=2, num_single_layers=2, num_attention_heads=2,
                                attention_head_dim=128, joint_attention_dim=96, guidance_embeds=False)
MERGE_ATOL = 1e-6
FORWARD_ATOL = 2e-5


@pytest.fixture(scope="module")
def jax_params():
    return perturbed_numpy(jtfm.init_params(jax.random.PRNGKey(0), jax_config(CONFIG), dtype=jnp.float32), 0)


def jax_lora(params, config=tlora.LoRAConfig(rank=4, alpha=8.0), seed=1):
    """JAX's adapters with seeded non-zero b, as numpy."""
    lora = jlora.init_lora(jax.random.PRNGKey(seed), params, jlora.LoRAConfig(config.rank, config.alpha,
                                                                                config.targets))
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(lambda x: np.asarray(x) + 0.02 * rng.standard_normal(x.shape).astype(np.float32),
                                  lora)


@pytest.mark.parametrize("targets", [tlora.DEFAULT_TARGETS, tlora.ATTENTION_ONLY_TARGETS], ids=["all", "attention"])
def test_init_lora_shapes_bounds_and_targets_follow_jax(jax_params, targets):
    assert tlora.DEFAULT_TARGETS == jlora.DEFAULT_TARGETS
    assert tlora.ATTENTION_ONLY_TARGETS == jlora.ATTENTION_ONLY_TARGETS
    model = transformer_from_jax(jax_params, CONFIG)
    lora = tlora.init_lora(model, tlora.LoRAConfig(rank=4, alpha=8.0, targets=targets), torch.Generator().manual_seed(0))
    ref = jlora.init_lora(jax.random.PRNGKey(0), jax_params, jlora.LoRAConfig(4, 8.0, targets))
    flat = lora_to_flat(lora)
    ref_flat = jtrainer._flatten(ref)
    assert {k: v.shape for k, v in flat.items()} == {k: tuple(v.shape) for k, v in ref_flat.items()}
    assert lora.targets() == targets
    for name, arr in flat.items():
        assert arr.dtype == np.float32
        if name.endswith(".b"):
            assert not arr.any()
        else:
            bound = arr.shape[1] ** -0.5
            assert np.abs(arr).max() <= bound and np.abs(arr).max() > 0.9 * bound
    assert all(p.requires_grad for p in lora.parameters())
    assert tlora.num_lora_params(lora) == jlora.num_lora_params(ref)
    assert tlora.LoRAConfig(rank=4, alpha=8.0).scale == jlora.LoRAConfig(4, 8.0).scale == 2.0


def test_merge_into_params_matches_jax(jax_params):
    lj = jax_lora(jax_params)
    merged = jlora.merge_into_params(jax_params, lj, 2.0)
    model = tlora.merge_into_params(transformer_from_jax(jax_params, CONFIG), lora_from_jax(lj), 2.0)
    for group, n in (("double_blocks", CONFIG.num_layers), ("single_blocks", CONFIG.num_single_layers)):
        for leaf in merged[group]:
            for i in range(n):
                got = getattr(getattr(model, group)[i], leaf).detach().numpy()
                want = np.asarray(merged[group][leaf])[i]
                np.testing.assert_allclose(got, want.T if want.ndim == 2 else want, atol=MERGE_ATOL, rtol=0)
    untouched = np.asarray(jax_params["x_embedder"]["kernel"]).T
    np.testing.assert_array_equal(model.x_embedder.detach().numpy(), untouched)


def _forward(model, lora=None, scale=1.0, remat=False):
    from flux2_tpu.ops import latents as jlu
    from flux2_tpu.ops.rope import rope_embeddings

    rng = np.random.RandomState(3)
    lat = torch.from_numpy(rng.randn(1, 16, 128).astype(np.float32))
    txt = torch.from_numpy(rng.randn(1, 6, 96).astype(np.float32))
    ids = np.concatenate([jlu.text_position_ids(6), jlu.image_position_ids(64, 64)])
    cos, sin = (torch.from_numpy(np.asarray(x)) for x in rope_embeddings(jnp.asarray(ids)))
    with torch.no_grad():
        return model(lat, txt, torch.tensor([0.5]), cos, sin, lora=lora, lora_scale=scale, remat=remat)


def test_unmerged_forward_equals_merged(jax_params):
    lj = jax_lora(jax_params)
    base = _forward(transformer_from_jax(jax_params, CONFIG))
    unmerged = _forward(transformer_from_jax(jax_params, CONFIG), lora_from_jax(lj), 2.0)
    remat = _forward(transformer_from_jax(jax_params, CONFIG), lora_from_jax(lj), 2.0, remat=True)
    merged = _forward(tlora.merge_into_params(transformer_from_jax(jax_params, CONFIG), lora_from_jax(lj), 2.0))
    assert float((merged - base).abs().max()) > 1e-3  # the adapters do something
    np.testing.assert_allclose(unmerged.numpy(), merged.numpy(), atol=FORWARD_ATOL, rtol=0)
    np.testing.assert_allclose(remat.numpy(), merged.numpy(), atol=FORWARD_ATOL, rtol=0)


def test_flat_names_round_trip_through_jax_layout(jax_params):
    lj = jax_lora(jax_params)
    flat = lora_to_flat(lora_from_jax(lj))
    ref = jtrainer._flatten(lj)
    assert sorted(flat) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(flat[k], np.asarray(ref[k]))
    again = lora_to_flat(lora_from_flat(flat))
    assert all(np.array_equal(again[k], flat[k]) for k in flat)


@pytest.mark.parametrize("fmt", ["qint8", "int4", "w8a8"])  # w4a8 takes no weight at this width (K < 512)
def test_init_lora_on_quantized_base_follows_jax(jax_params, fmt):
    """QLoRA: adapters on a quantized base take (orig_in, N) from each weight,
    as JAX's ``init_lora`` reads a QTensor's."""
    bf16 = jax.tree_util.tree_map(lambda x: jnp.asarray(x).astype(jnp.bfloat16), jax_params)
    model = transformer_from_jax(jax.tree_util.tree_map(np.asarray, bf16), CONFIG)
    tq.quantize_params(model, fmt)
    assert tq.quantized_names(model)
    lora = tlora.init_lora(model, tlora.LoRAConfig(rank=4), torch.Generator().manual_seed(0))
    ref = jlora.init_lora(jax.random.PRNGKey(0), jax.tree_util.tree_map(np.asarray, bf16), jlora.LoRAConfig(4))
    flat, ref_flat = lora_to_flat(lora), jtrainer._flatten(ref)
    assert {k: v.shape for k, v in flat.items()} == {k: tuple(v.shape) for k, v in ref_flat.items()}
    assert all(not v.any() for k, v in flat.items() if k.endswith(".b"))


def test_merge_into_quantized_base_stays_quantized_and_keeps_the_delta(jax_params):
    """JAX's ``test_merge_into_params_quantized_base`` on the port: a qint8
    leaf dequantizes, adds and requantizes in place, within int8 noise."""
    bf16 = jax.tree_util.tree_map(lambda x: jnp.asarray(x).astype(jnp.bfloat16), jax_params)
    model = transformer_from_jax(jax.tree_util.tree_map(np.asarray, bf16), CONFIG)
    tq.quantize_params(model, "qint8")
    lora = tlora.init_lora(model, tlora.LoRAConfig(rank=4), torch.Generator().manual_seed(0))
    for blk in lora.double_blocks:
        blk["to_q"].b.data.fill_(0.01)
    before = [tq.dequantize(b.to_q, torch.float32) for b in model.double_blocks]
    tlora.merge_into_params(model, lora, 1.0)
    for i, blk in enumerate(model.double_blocks):
        assert isinstance(blk.to_q, tq.QTensor) and blk.to_q.format == "qint8"
        delta = (lora.double_blocks[i]["to_q"].a @ lora.double_blocks[i]["to_q"].b).T.detach()
        err = (tq.dequantize(blk.to_q, torch.float32) - before[i] - delta).abs()
        assert float(err.max()) < 0.01


def test_remat_dots_is_not_ported(jax_params):
    """Ported since: "dots" runs (JAX's ``checkpoint_dots_with_no_batch_dims``)
    and gives remat=False's velocity to the bit; its gradients are held in
    tests/test_torch_train_real.py."""
    model = transformer_from_jax(jax_params, CONFIG)
    assert torch.equal(_forward(model, remat="dots"), _forward(model, remat=False))
