"""The port's Pixtral tower and projector against the JAX package's, on the CPU.

JAX's perturbed ``TINY_PIXTRAL`` weights carried into the port
(``io.jax_params.pixtral_from_jax``), seeded numpy pixels: the RoPE table,
the tower, the projector (2x2 merge, exact-erf GELU) and ``encode_and_project``
at f32 within 1e-5; a Mistral3 checkpoint's vision keys mapped by both
packages to the same parameters, leaf for leaf; and JAX's odd-grid defect:
at 42^2 (3 x 3 patches) JAX's reshape raises and the port raises its
``ValueError``, at 56^2 both give the same (1, 4, .) features.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flux2_tpu.io import weight_mapping as jwm
from flux2_tpu.models.text_encoders import pixtral as jpx
from flux2_tpu_torch.io import weight_mapping as twm
from flux2_tpu_torch.io.jax_params import pixtral_from_jax
from flux2_tpu_torch.models.text_encoders import pixtral as tpx

from tests.test_torch_lora_loader import one_torch_thread  # noqa: F401  (module fixture)
from tests.test_torch_transformer import perturbed_numpy

CFG = tpx.TINY_PIXTRAL
TOL = 1e-5


@pytest.fixture(scope="module")
def models():
    params = perturbed_numpy(jpx.init_params(jax.random.PRNGKey(0), jpx.TINY_PIXTRAL), 0)
    return jax.tree_util.tree_map(jnp.asarray, params), pixtral_from_jax(params, CFG)


def _pixels(seed, h, w):
    return np.random.RandomState(seed).uniform(-1, 1, (1, h, w, 3)).astype(np.float32)


def test_config_and_rope_table_equal_jax():
    assert CFG == tpx.PixtralVisionConfig(**jpx.TINY_PIXTRAL.__dict__)
    assert tpx.PixtralVisionConfig() == tpx.PixtralVisionConfig(**jpx.PixtralVisionConfig().__dict__)
    for cfg in (CFG, tpx.PixtralVisionConfig()):
        np.testing.assert_array_equal(tpx.pixtral_rope_table(cfg), jpx.pixtral_rope_table(cfg))


@pytest.mark.parametrize("hw", [(56, 56), (28, 84), (70, 42)], ids=["square", "wide", "tall_crop"])
def test_tower_equals_jax(models, hw):
    jparams, tower = models
    x = _pixels(1, *hw)
    ref = np.asarray(jpx.encode_image(jparams, jpx.TINY_PIXTRAL, jnp.asarray(x)))
    with torch.inference_mode():
        out = tower.encode_image(torch.from_numpy(x)).numpy()
    assert np.isfinite(ref).all() and out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=TOL, rtol=0)


@pytest.mark.parametrize("hw", [(56, 56), (28, 84)], ids=["square", "wide"])
def test_projector_and_encode_and_project_equal_jax(models, hw):
    jparams, tower = models
    x = _pixels(2, *hw)
    feats = jpx.encode_image(jparams, jpx.TINY_PIXTRAL, jnp.asarray(x))
    gh, gw = hw[0] // 14, hw[1] // 14
    ref = np.asarray(jpx.project_to_text_space(jparams, jpx.TINY_PIXTRAL, feats, gh, gw))
    with torch.inference_mode():
        out = tower.project_to_text_space(torch.from_numpy(np.array(feats)), gh, gw).numpy()
        both = tower.encode_and_project(torch.from_numpy(x)).numpy()
    assert np.isfinite(ref).all() and out.shape == ref.shape == (1, gh * gw // 4, CFG.text_hidden_size)
    np.testing.assert_allclose(out, ref, atol=TOL, rtol=0)
    np.testing.assert_allclose(both, ref, atol=TOL, rtol=0)


def test_projector_gelu_is_exact_erf(models):
    """tanh GELU would move the projector's output well past the tolerance."""
    _, tower = models
    x = torch.from_numpy(_pixels(3, 56, 56))
    with torch.inference_mode():
        feats = tower.encode_image(x)
        exact = tower.project_to_text_space(feats, 4, 4)
        real = torch.nn.functional.gelu
        try:
            torch.nn.functional.gelu = lambda t, approximate="none": real(t, approximate="tanh")
            tanh = tower.project_to_text_space(feats, 4, 4)
        finally:
            torch.nn.functional.gelu = real
    assert float((exact - tanh).abs().max()) > 10 * TOL


def test_odd_patch_grid_raises_as_jax(models):
    """JAX's projector reshapes a 3 x 3 patch grid into 2 x 2 blocks and fails
    (a defect of the reference); the port refuses the same image with a
    ValueError naming the grid. At 56^2 both give the same features."""
    jparams, tower = models
    odd = _pixels(4, 42, 42)
    with pytest.raises(TypeError):
        jpx.encode_and_project(jparams, jpx.TINY_PIXTRAL, jnp.asarray(odd))
    with pytest.raises(ValueError, match=r"even patch grid; the image gives 3 x 3 patches .* multiples of 28 px"):
        tower.encode_and_project(torch.from_numpy(odd))
    even = _pixels(4, 56, 56)
    ref = np.asarray(jpx.encode_and_project(jparams, jpx.TINY_PIXTRAL, jnp.asarray(even)))
    with torch.inference_mode():
        out = tower.encode_and_project(torch.from_numpy(even)).numpy()
    assert ref.shape == out.shape == (1, 4, CFG.text_hidden_size)
    np.testing.assert_allclose(out, ref, atol=TOL, rtol=0)


def mistral3_vision_checkpoint(cfg, seed: int) -> dict:
    """A Mistral3 checkpoint's vision keys (HF names and layouts) from seeded numpy."""
    rng = np.random.default_rng(seed)
    d, m, p, i = cfg.hidden_size, cfg.spatial_merge_size, cfg.patch_size, cfg.intermediate_size

    def draw(*shape, scale=0.05, shift=0.0):
        return (rng.standard_normal(shape) * scale + shift).astype(np.float32)

    w = {"vision_tower.patch_conv.weight": draw(d, 3, p, p), "vision_tower.ln_pre.weight": draw(d, shift=1.0)}
    for layer in range(cfg.num_hidden_layers):
        pre = f"vision_tower.transformer.layers.{layer}."
        for name in ("q_proj", "k_proj", "v_proj", "o_proj"):
            w[f"{pre}attention.{name}.weight"] = draw(d, d)
        w[pre + "attention_norm.weight"] = draw(d, shift=1.0)
        w[pre + "ffn_norm.weight"] = draw(d, shift=1.0)
        w[pre + "feed_forward.gate_proj.weight"] = draw(i, d)
        w[pre + "feed_forward.up_proj.weight"] = draw(i, d)
        w[pre + "feed_forward.down_proj.weight"] = draw(d, i)
    w["multi_modal_projector.norm.weight"] = draw(d, shift=1.0)
    w["multi_modal_projector.patch_merger.merging_layer.weight"] = draw(d, d * m * m)
    w["multi_modal_projector.linear_1.weight"] = draw(cfg.text_hidden_size, d)
    w["multi_modal_projector.linear_2.weight"] = draw(cfg.text_hidden_size, cfg.text_hidden_size)
    return w


def test_map_pixtral_weights_equal_jax_leaf_for_leaf():
    """The OIHW patch conv and the merger's channel-major -> spatial-major column
    permutation: both packages' mappings give the same module, parameter for
    parameter, and the same projected features. The LM's keys are not read."""
    w = mistral3_vision_checkpoint(CFG, 11)
    ref = pixtral_from_jax(jwm.map_pixtral_weights(w, jpx.TINY_PIXTRAL), CFG)
    reads = []

    class Spy(dict):
        def __getitem__(self, key):
            reads.append(key)
            return super().__getitem__(key)

    tensors = Spy({k: torch.from_numpy(v) for k, v in w.items()})
    tensors["language_model.model.embed_tokens.weight"] = torch.zeros(3, 3)
    got = twm.load_pixtral(tensors, CFG, "cpu", dtype=torch.float32)
    assert not any(k.startswith("language_model.") for k in reads)
    want = dict(ref.named_parameters())
    assert dict(got.named_parameters()).keys() == want.keys()
    for name, p in got.named_parameters():
        assert torch.equal(p, want[name]), name
    x = _pixels(5, 28, 56)
    with torch.inference_mode():
        out = got.encode_and_project(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, np.asarray(jpx.encode_and_project(jwm.map_pixtral_weights(w, jpx.TINY_PIXTRAL),
                                                                       jpx.TINY_PIXTRAL, jnp.asarray(x))),
                               atol=TOL, rtol=0)
