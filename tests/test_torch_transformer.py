"""The port's DiT forward against the JAX ``transformer.forward`` (CPU, float32).

The JAX package's own ``init_params`` makes the weights; every leaf is then
perturbed with seeded numpy noise (so the ones/zeros of the init cannot hide
a swapped or transposed leaf) and loaded into the port through
``flux2_tpu_torch.io.jax_params``. Configs are tests/test_torch_oracle.py's
TINY and KLEIN_SLICE; tolerance <= 5e-4 max abs, as that file's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flux2_tpu.models.flux2 import transformer as jtfm
from flux2_tpu.ops.rope import rope_embeddings
from flux2_tpu.ops import latents as jlu
from flux2_tpu_torch.io.jax_params import transformer_from_jax
from flux2_tpu_torch.models.flux2 import transformer as ttfm

from tests.test_torch_oracle import KLEIN_SLICE, TINY
from tests.test_torch_shared_copies import jax_config

TOL = 5e-4


def perturbed_numpy(params, seed, scale=0.1):
    """Every leaf as float32 numpy plus seeded noise (same shapes)."""
    rng = np.random.RandomState(seed)
    leaves, treedef = jax.tree_util.tree_flatten(params)
    out = []
    for x in leaves:
        x = np.asarray(x, np.float32)
        out.append(x + scale * rng.standard_normal(x.shape).astype(np.float32) * max(float(x.std()), 0.1))
    return jax.tree_util.tree_unflatten(treedef, out)


@pytest.mark.parametrize("config,seed,hw,s_txt", [(TINY, 0, (4, 4), 6), (KLEIN_SLICE, 7, (4, 6), 8)],
                         ids=["tiny", "klein_slice"])
def test_forward_matches_jax(config, seed, hw, s_txt):
    params = perturbed_numpy(jtfm.init_params(jax.random.PRNGKey(seed), jax_config(config), dtype=jnp.float32), seed)
    rng = np.random.RandomState(seed + 1)
    h, w = hw
    lat = rng.randn(2, h * w, config.in_channels).astype(np.float32)
    txt = rng.randn(2, s_txt, config.joint_attention_dim).astype(np.float32) * 0.2
    sigma = np.array([0.7, 0.25], np.float32)
    guid = np.array([4.0, 3.0], np.float32) if config.guidance_embeds else None
    ids = np.concatenate([jlu.text_position_ids(s_txt), jlu.image_position_ids(16 * h, 16 * w)])
    cos, sin = rope_embeddings(jnp.asarray(ids))

    ref = jtfm.forward(params, jax_config(config), jnp.asarray(lat), jnp.asarray(txt), jnp.asarray(sigma), cos, sin,
                       guidance=jnp.asarray(guid) if guid is not None else None)
    model = transformer_from_jax(params, config)
    with torch.inference_mode():
        out = model(torch.from_numpy(lat), torch.from_numpy(txt), torch.from_numpy(sigma),
                    torch.from_numpy(np.asarray(cos)), torch.from_numpy(np.asarray(sin)),
                    guidance=torch.from_numpy(guid) if guid is not None else None)
    assert out.shape == (2, h * w, config.out_channels)
    err = np.max(np.abs(out.numpy() - np.asarray(ref)))
    assert err <= TOL, f"max |diff| = {err}"


def test_time_embedding_matches_jax():
    params = perturbed_numpy(jtfm.init_params(jax.random.PRNGKey(3), jax_config(TINY), dtype=jnp.float32), 3)
    t = np.array([0.0, 0.31, 1.0], np.float32)
    g = np.array([1.0, 3.5, 4.0], np.float32)
    np.testing.assert_allclose(ttfm.sinusoidal_embedding(torch.from_numpy(t * 1000)).numpy(),
                               np.asarray(jtfm.sinusoidal_embedding(jnp.asarray(t * 1000))), atol=1e-4, rtol=0)
    ref = jtfm.time_guidance_embedding(params, jax_config(TINY), jnp.asarray(t), jnp.asarray(g))
    with torch.inference_mode():
        out = transformer_from_jax(params, TINY).time_guidance_embedding(torch.from_numpy(t), torch.from_numpy(g))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=TOL, rtol=0)


def test_random_init_scales_follow_jax():
    """Random init draws N(0,1) * d_in**-0.5 per linear, in the model dtype, on the given device."""
    gen = torch.Generator().manual_seed(0)
    model = ttfm.Flux2Transformer(TINY, device="cpu", dtype=torch.float32, generator=gen)
    w = model.double_blocks[0].ff_out  # [out, in] = [d, mlp]
    assert w.shape == (TINY.inner_dim, TINY.mlp_hidden_dim)
    assert abs(float(w.std()) * TINY.mlp_hidden_dim**0.5 - 1.0) < 0.02
    assert torch.equal(model.single_blocks[1].norm_q, torch.ones(TINY.attention_head_dim))
