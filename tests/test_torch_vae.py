"""The port's VAE decoder against the JAX ``vae.decode`` (CPU, float32 and bf16).

The JAX ``init_params`` makes the weights, every leaf perturbed with seeded
noise (biases and GroupNorm scales are zeros/ones at init), and they load
into the port through ``vae_from_jax`` (HWIO -> OIHW). The port decodes
NCHW -> NCHW, as JAX's public ``decode``. Tolerance 1e-4 max abs in float32:
the convolutions sum in another order than XLA's.

bf16 latents with float32 parameters follow JAX's type promotion: the
mid-block attention multiplies bf16 activations by f32 kernels, so the
result is f32 from there on (``_conv2d`` casts each kernel to x's dtype).
The pipeline instead casts every parameter to its compute dtype first, as
JAX's ``_decode_latents_jit`` does, and stays bf16 to the end.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from flux2_tpu.models.flux2 import vae as jvae
from flux2_tpu_torch.io.jax_params import transformer_from_jax, vae_from_jax
from flux2_tpu_torch.models.flux2.config import Flux2Model
from flux2_tpu_torch.pipeline.pipeline import Flux2Pipeline

from tests.test_torch_transformer import perturbed_numpy

TOL = 1e-4
CONFIG = jvae.VAEConfig(block_out_channels=(8, 8, 16, 16), layers_per_block=1, norm_num_groups=4)


def _perturbed(config):
    p = perturbed_numpy(jvae.init_params(jax.random.PRNGKey(0), config, dtype=jnp.float32), 0)
    p["bn"]["running_var"] = np.abs(p["bn"]["running_var"]) + 0.5
    return p


@pytest.fixture(scope="module")
def params():
    return _perturbed(CONFIG)


@pytest.mark.parametrize("shape", [(1, 32, 8, 8), (2, 32, 4, 6)])
def test_decode_matches_jax(params, shape):
    z = np.random.RandomState(shape[0]).randn(*shape).astype(np.float32)
    ref = jvae.decode(params, jnp.asarray(z), CONFIG)
    with torch.inference_mode():
        out = vae_from_jax(params, CONFIG).decode(torch.from_numpy(z))
    assert out.shape == (shape[0], 3, shape[2] * 8, shape[3] * 8)
    err = np.max(np.abs(out.numpy() - np.asarray(ref)))
    assert err <= TOL, f"max |diff| = {err}"


def test_batchnorm_stats_match(params):
    mean, var = vae_from_jax(params, CONFIG).get_batchnorm_stats()
    ref_mean, ref_var = jvae.get_batchnorm_stats(params)
    np.testing.assert_array_equal(mean.numpy(), np.asarray(ref_mean))
    np.testing.assert_array_equal(var.numpy(), np.asarray(ref_var))


def _u8(img) -> np.ndarray:
    """[-1, 1] NCHW -> uint8 levels, as the pipelines convert."""
    x = np.clip(np.asarray(img, np.float32) * 0.5 + 0.5, 0.0, 1.0)
    return np.clip(x * 255.0 + 0.5, 0.0, 255.0).astype(np.uint8).astype(np.int32)


def _xla_cpu_silu(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.silu as XLA lowers it on the CPU for bf16: x * (1 / (1 + exp(-x)))
    with every operation rounded to bf16 (torch's silu rounds once)."""
    return x * (1 / (1 + torch.exp(-x))) if x.dtype == torch.bfloat16 else x * torch.sigmoid(x)


# bf16 latents, f32 parameters: uint8 levels between the port and JAX. The
# layers before the mid-block attention run in bf16, where JAX's silu (on the
# CPU) rounds each of its four operations to bf16 and torch's rounds once;
# that alone gives 2-3 levels at both sizes (measured), and with JAX's
# decomposition substituted the port is within one level.
BF16_DECODE_LEVELS = 3


@pytest.mark.parametrize("size", ["tiny", "flux2"])
def test_bf16_decode_promotes_to_f32_as_jax(params, size, monkeypatch):
    config = CONFIG if size == "tiny" else jvae.VAEConfig()
    p = params if size == "tiny" else _perturbed(config)
    z = np.random.RandomState(1).randn(1, 32, 8, 8).astype(np.float32)
    ref = jvae.decode(jax.tree_util.tree_map(jnp.asarray, p), jnp.asarray(z).astype(jnp.bfloat16), config)
    vae = vae_from_jax(p, config)
    zb = torch.from_numpy(z).bfloat16()
    with torch.inference_mode():
        out = vae.decode(zb)
        monkeypatch.setattr(F, "silu", _xla_cpu_silu)
        out_xla_silu = vae.decode(zb)
    assert ref.dtype == jnp.float32 and out.dtype == torch.float32
    assert out.shape == (1, 3, 64, 64)
    levels = np.abs(_u8(out) - _u8(ref)).max()
    assert levels <= BF16_DECODE_LEVELS, levels
    assert np.abs(_u8(out_xla_silu) - _u8(ref)).max() <= 1


# The pipeline's bf16 decode (parameters cast to bf16) against JAX's on the
# tiny pipeline's weights: every layer rounds to bf16 in both, in other places
# (silu's operations, the GroupNorm and softmax outputs); measured 8-10 levels
# at most and 0.91-0.95 on average over four draws of latents.
PIPELINE_BF16_LEVELS_MAX = 10
PIPELINE_BF16_LEVELS_MEAN = 1.0


def test_pipeline_bf16_decode_casts_parameters_as_jax():
    from test_pipeline import tiny_pipeline

    jpipe = tiny_pipeline()
    tpipe = Flux2Pipeline(model=Flux2Model.KLEIN_4B,
                          transformer=transformer_from_jax(jpipe.transformer_params, jpipe.transformer_config),
                          vae=vae_from_jax(jpipe.vae_params, jpipe.vae_config), device=torch.device("cpu"))
    assert jpipe.vae_compute_dtype == jnp.bfloat16 and tpipe.vae_compute_dtype == torch.bfloat16
    cast = tpipe._vae_in_compute_dtype()
    assert cast is tpipe._vae_in_compute_dtype()  # made once
    assert all(t.dtype == torch.bfloat16 for t in cast.parameters())
    assert tpipe.vae.post_quant_conv.weight.dtype == torch.float32  # the pipeline's own VAE stays f32
    lat = np.random.RandomState(0).randn(2, 16, 128).astype(np.float32)
    with torch.inference_mode():
        assert cast.decode(torch.zeros(1, 32, 8, 8, dtype=torch.bfloat16)).dtype == torch.bfloat16
    want = np.asarray(jpipe.decode_latents_u8(jnp.asarray(lat), 64, 64)).astype(np.int32)
    got = tpipe.decode_latents_u8(torch.from_numpy(lat), 64, 64).numpy().astype(np.int32)
    diff = np.abs(got - want)
    assert diff.max() <= PIPELINE_BF16_LEVELS_MAX and diff.mean() <= PIPELINE_BF16_LEVELS_MEAN, (diff.max(), diff.mean())
