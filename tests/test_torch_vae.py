"""The port's VAE decoder against the JAX ``vae.decode`` (CPU, float32).

The JAX ``init_params`` makes the weights, every leaf perturbed with seeded
noise (biases and GroupNorm scales are zeros/ones at init), and they load
into the port through ``vae_from_jax`` (HWIO -> OIHW). The port decodes
NCHW -> NCHW, as JAX's public ``decode``. Tolerance 1e-4 max abs in float32:
the convolutions sum in another order than XLA's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flux2_tpu.models.flux2 import vae as jvae
from flux2_tpu_torch.io.jax_params import vae_from_jax

from tests.test_torch_transformer import perturbed_numpy

TOL = 1e-4
CONFIG = jvae.VAEConfig(block_out_channels=(8, 8, 16, 16), layers_per_block=1, norm_num_groups=4)


@pytest.fixture(scope="module")
def params():
    p = perturbed_numpy(jvae.init_params(jax.random.PRNGKey(0), CONFIG, dtype=jnp.float32), 0)
    p["bn"]["running_var"] = np.abs(p["bn"]["running_var"]) + 0.5
    return p


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
