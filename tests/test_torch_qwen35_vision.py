"""The port's Qwen3.5 vision tower, preprocessing and merge against the JAX package's, on the CPU.

JAX's perturbed ``TINY_VISION`` weights carried into the port
(``io.jax_params.qwen35_vision_from_jax``), seeded numpy pixels:
``smart_resize`` and ``preprocess_image``, ``_patchify`` (the duplicated
frame in spatial-merge order), ``_interp_pos_embed``, ``_rotary_2d``, the
tower (tanh GELU in the blocks, exact GELU in the merger),
``num_output_tokens`` and ``merge_image_embeddings``, f32 within 1e-5; an HF
Qwen3-VL tower's keys mapped by both packages to the same parameters.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flux2_tpu.io import weight_mapping as jwm
from flux2_tpu.models.text_encoders import qwen35_vision as jqv
from flux2_tpu_torch.io import weight_mapping as twm
from flux2_tpu_torch.io.jax_params import qwen35_vision_from_jax
from flux2_tpu_torch.models.text_encoders import qwen35_vision as tqv

from tests.test_torch_lora_loader import one_torch_thread  # noqa: F401  (module fixture)
from tests.test_torch_transformer import perturbed_numpy

CFG = tqv.TINY_VISION
JCFG = jqv.TINY_VISION
TOL = 1e-5


@pytest.fixture(scope="module")
def models():
    params = perturbed_numpy(jqv.init_params(jax.random.PRNGKey(1), JCFG), 1)
    return jax.tree_util.tree_map(jnp.asarray, params), qwen35_vision_from_jax(params, CFG)


def _pixels(seed, h, w):
    return np.random.RandomState(seed).uniform(-1, 1, (1, h, w, 3)).astype(np.float32)


@pytest.mark.parametrize("d", [{}, {"depth": 2, "hidden_size": 32, "num_heads": 2, "intermediate_size": 64,
                                    "in_chans": 3, "out_hidden_size": 48, "num_position_embeddings": 16}])
def test_config_from_json_equals_jax(d):
    assert dataclasses.asdict(tqv.Qwen35VisionConfig.from_json_dict(d, 599)) == dataclasses.asdict(
        jqv.Qwen35VisionConfig.from_json_dict(d, 599))
    assert dataclasses.asdict(tqv.Qwen35VisionConfig.from_json_dict(d)) == dataclasses.asdict(
        jqv.Qwen35VisionConfig.from_json_dict(d))
    assert dataclasses.asdict(CFG) == dataclasses.asdict(JCFG)


@pytest.mark.parametrize("hw,kw", [((1000, 1000), {}), ((4000, 2000), {"max_side": 1280}), ((100, 100), {}),
                                   ((64, 97), {}), ((1024, 1024), {}), ((300, 2000), {"factor": 28})])
def test_smart_resize_equals_jax(hw, kw):
    assert tqv.smart_resize(*hw, **kw) == jqv.smart_resize(*hw, **kw)


@pytest.mark.parametrize("hw,max_side", [((64, 64), 1280), ((50, 90), 128), ((300, 200), 256)])
def test_preprocess_image_equals_jax(hw, max_side):
    img = np.random.RandomState(0).rand(*hw, 3).astype(np.float32)
    ref = jqv.preprocess_image(img, JCFG, max_side=max_side)
    out = tqv.preprocess_image(img, CFG, max_side=max_side)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=TOL, rtol=0)


@pytest.mark.parametrize("hw", [(64, 64), (32, 96)])
def test_patchify_pos_embed_and_rotary_equal_jax(models, hw):
    jparams, tower = models
    x = _pixels(2, *hw)
    np.testing.assert_array_equal(tqv._patchify(torch.from_numpy(x), CFG).numpy(),
                                  np.asarray(jqv._patchify(jnp.asarray(x), JCFG)))
    gh, gw = hw[0] // 16, hw[1] // 16
    np.testing.assert_allclose(tqv._interp_pos_embed(tower.pos_embed, gh, gw, 2).detach().numpy(),
                               np.asarray(jqv._interp_pos_embed(jparams["pos_embed"], gh, gw, 2)), atol=1e-6, rtol=0)
    np.testing.assert_allclose(tqv._rotary_2d(CFG, gh, gw, 2), np.asarray(jqv._rotary_2d(JCFG, gh, gw, 2)),
                               atol=0, rtol=0)
    assert tqv.num_output_tokens(CFG, *hw) == jqv.num_output_tokens(JCFG, *hw) == gh * gw // 4


@pytest.mark.parametrize("hw", [(64, 64), (32, 96), (96, 64)], ids=["square", "wide", "tall"])
def test_tower_equals_jax(models, hw):
    jparams, tower = models
    x = _pixels(3, *hw)
    ref = np.asarray(jqv.encode_image(jparams, JCFG, jnp.asarray(x)))
    with torch.inference_mode():
        out = tower(torch.from_numpy(x)).numpy()
    assert np.isfinite(ref).all() and out.shape == ref.shape == (1, hw[0] * hw[1] // 1024, CFG.out_hidden_size)
    np.testing.assert_allclose(out, ref, atol=TOL, rtol=0)


def test_gelu_flavours_are_tanh_in_the_blocks_and_exact_in_the_merger(models):
    """Each GELU swapped for the other flavour moves the output past the tolerance."""
    _, tower = models
    x = torch.from_numpy(_pixels(4, 64, 64))
    real = torch.nn.functional.gelu
    with torch.inference_mode():
        ref = tower(x)
        for flip in ("tanh", "none"):  # the blocks' calls, then the merger's, take the other flavour
            def gelu(t, approximate="none", flip=flip):
                swapped = {"tanh": "none", "none": "tanh"}[approximate]
                return real(t, approximate=swapped if approximate == flip else approximate)
            try:
                torch.nn.functional.gelu = gelu
                moved = float((tower(x) - ref).abs().max())
            finally:
                torch.nn.functional.gelu = real
            assert moved > 10 * TOL, flip


def test_merge_image_embeddings_equals_jax():
    rng = np.random.RandomState(5)
    text = rng.randn(2, 7, 8).astype(np.float32)
    ids = np.array([[5, 99, 99, 7, 99, 8, 1], [99, 2, 3, 99, 4, 5, 6]], np.int32)
    img = rng.randn(1, 3, 8).astype(np.float32)
    ref = np.asarray(jqv.merge_image_embeddings(jnp.asarray(text), jnp.asarray(ids), jnp.asarray(img), 99))
    out = tqv.merge_image_embeddings(torch.from_numpy(text), torch.from_numpy(ids).long(), torch.from_numpy(img), 99)
    np.testing.assert_array_equal(out.numpy(), ref)


def qwen3vl_vision_checkpoint(cfg, seed: int, prefix: str = "model.visual.") -> dict:
    """An HF Qwen3-VL vision tower's keys (names and layouts) from seeded numpy."""
    rng = np.random.default_rng(seed)
    d, i, m2 = cfg.hidden_size, cfg.intermediate_size, cfg.hidden_size * cfg.spatial_merge_size**2

    def draw(*shape, scale=0.05, shift=0.0):
        return (rng.standard_normal(shape) * scale + shift).astype(np.float32)

    w = {"patch_embed.proj.weight": draw(d, cfg.in_channels, cfg.temporal_patch_size, cfg.patch_size, cfg.patch_size),
         "patch_embed.proj.bias": draw(d), "pos_embed.weight": draw(cfg.num_position_embeddings, d)}
    for b in range(cfg.depth):
        p = f"blocks.{b}."
        for name, shape in (("norm1", (d,)), ("norm2", (d,))):
            w[f"{p}{name}.weight"], w[f"{p}{name}.bias"] = draw(*shape, shift=1.0), draw(*shape)
        for name, (o, n) in (("attn.qkv", (3 * d, d)), ("attn.proj", (d, d)), ("mlp.linear_fc1", (i, d)),
                             ("mlp.linear_fc2", (d, i))):
            w[f"{p}{name}.weight"], w[f"{p}{name}.bias"] = draw(o, n), draw(o)
    w["merger.norm.weight"], w["merger.norm.bias"] = draw(d, shift=1.0), draw(d)
    w["merger.linear_fc1.weight"], w["merger.linear_fc1.bias"] = draw(m2, m2), draw(m2)
    w["merger.linear_fc2.weight"], w["merger.linear_fc2.bias"] = draw(cfg.out_hidden_size, m2), draw(cfg.out_hidden_size)
    return {prefix + k: v for k, v in w.items()}


@pytest.mark.parametrize("prefix", ["model.visual.", "visual.", ""])
def test_map_qwen35_vision_weights_equal_jax_leaf_for_leaf(prefix):
    """The Conv3d patch embedding [D, C, T, P, P] flattened to (t, ph, pw, c):
    both packages' mappings give the same module, and the same embeddings."""
    w = qwen3vl_vision_checkpoint(CFG, 12, prefix)
    jparams = jwm.map_qwen35_vision_weights(w, JCFG)
    ref = qwen35_vision_from_jax(jparams, CFG)
    got = twm.load_qwen35_vision({k: torch.from_numpy(v) for k, v in w.items()}, CFG, "cpu", dtype=torch.float32)
    want = dict(ref.named_parameters())
    assert dict(got.named_parameters()).keys() == want.keys()
    for name, p in got.named_parameters():
        assert torch.equal(p, want[name]), name
    x = _pixels(6, 64, 32)
    with torch.inference_mode():
        out = got(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, np.asarray(jqv.encode_image(jparams, JCFG, jnp.asarray(x))), atol=TOL, rtol=0)
