"""The port's VAE encoder against the JAX ``vae.encode_moments`` / ``encode``
and ``Flux2Pipeline.encode_image_to_packed_sequence`` (CPU, float32).

The weights are JAX's VAE parameter tree filled from a seeded numpy RNG,
and ``vae_encoder_from_jax`` carries the encoder half and
``quant_conv`` into the port (HWIO -> OIHW). Tolerance 1e-4 max abs, as the
decoder's: the convolutions sum in another order than XLA's. Images of 64x96
pixels make every level's height and width differ, so a downsample padded on
all four sides (instead of bottom and right only) or a missing ``quant_conv``
moves the result far past it; ``test_a_symmetric_downsample_pad_is_caught``
shows the first on the full FLUX.2 VAE.

The encoder half of a Diffusers ``AutoencoderKL`` checkpoint (the names
``tests/test_weight_mapping.py`` writes) loads through ``load_vae_encoder``
to the bit of what JAX's ``map_vae_weights`` gives, carried through
``vae_encoder_from_jax``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from flux2_tpu.io import checkpoints as jckpt
from flux2_tpu.io import weight_mapping as jwm
from flux2_tpu.models.flux2 import vae as jvae
from flux2_tpu.pipeline.pipeline import Flux2Pipeline as JaxPipeline
from flux2_tpu_torch.io import checkpoints as tckpt
from flux2_tpu_torch.io import weight_mapping as twm
from flux2_tpu_torch.io.jax_params import vae_encoder_from_jax, vae_from_jax
from flux2_tpu_torch.models.flux2 import vae as tvae
from flux2_tpu_torch.models.flux2.config import Flux2Model
from flux2_tpu_torch.pipeline.pipeline import Flux2Pipeline

from tests.test_torch_checkpoints import VAE_CONFIG, _assert_state_equal, jax_config_vae, vae_checkpoint, write_checkpoint

TOL = 1e-4
TINY = jax_config_vae(VAE_CONFIG)  # tiny_pipeline's VAE: (8, 8, 16, 16), one resnet a level
CONFIGS = {"tiny": TINY, "flux2": jvae.VAEConfig()}


@functools.lru_cache(maxsize=None)
def _params(name: str) -> dict:
    """JAX's VAE parameter tree for ``CONFIGS[name]`` (its shapes from
    ``jax.eval_shape`` of ``init_params``, whose eager run takes 10-20 s on
    the CPU) filled from a seeded numpy RNG: kernels N(0, 1 / fan_in), norm
    scales 1 + N(0, 0.1^2), biases and the BatchNorm mean N(0, 0.1^2), its
    variance in [0.5, 1.5)."""
    shapes = jax.eval_shape(lambda key: jvae.init_params(key, CONFIGS[name], dtype=jnp.float32),
                            jax.random.PRNGKey(0))
    rng = np.random.RandomState(3)

    def fill(path, leaf):
        kind = path[-1].key
        if kind == "kernel":
            return (rng.standard_normal(leaf.shape) / np.sqrt(np.prod(leaf.shape[:-1]))).astype(np.float32)
        if kind == "running_var":
            return (0.5 + rng.rand(*leaf.shape)).astype(np.float32)
        noise = (0.1 * rng.standard_normal(leaf.shape)).astype(np.float32)
        return noise + np.float32(1.0) if kind == "scale" else noise

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _image(h: int, w: int, seed: int = 0) -> np.ndarray:
    return np.random.RandomState(seed).rand(h, w, 3).astype(np.float32)


def _nchw(img: np.ndarray) -> np.ndarray:
    return (img[None].transpose(0, 3, 1, 2) * 2.0 - 1.0).astype(np.float32)


@pytest.mark.parametrize("hw", [(64, 64), (64, 96)], ids=["64x64", "64x96"])
@pytest.mark.parametrize("name", ["tiny", "flux2"])
def test_encode_matches_jax(name, hw):
    params, config = _params(name), CONFIGS[name]
    x = _nchw(_image(*hw))
    ref_moments = np.asarray(jvae.encode_moments(params, jnp.asarray(x), config))
    ref_mean = np.asarray(jvae.encode(params, jnp.asarray(x), config))
    enc = vae_encoder_from_jax(params, config)
    with torch.inference_mode():
        moments = enc.encode_moments(torch.from_numpy(x)).numpy()
        mean = enc.encode(torch.from_numpy(x)).numpy()
    assert moments.shape == (1, 64, hw[0] // 8, hw[1] // 8) and mean.shape == (1, 32, hw[0] // 8, hw[1] // 8)
    assert float(np.max(np.abs(moments - ref_moments))) <= TOL
    assert float(np.max(np.abs(mean - ref_mean))) <= TOL


def test_a_symmetric_downsample_pad_is_caught(monkeypatch):
    """A ``padding=1`` stride-2 conv in place of the bottom/right pad moves the
    moments of the full VAE at 64x96 far past TOL: the parity test above sees it."""
    params, config = _params("flux2"), CONFIGS["flux2"]
    x = _nchw(_image(64, 96))
    ref = np.asarray(jvae.encode_moments(params, jnp.asarray(x), config))
    enc = vae_encoder_from_jax(params, config)

    def symmetric(self, h):
        return F.conv2d(h, self.weight, stride=2, padding=1) + self.bias[:, None, None]

    monkeypatch.setattr(tvae.Downsample, "forward", symmetric)
    with torch.inference_mode():
        wrong = enc.encode_moments(torch.from_numpy(x)).numpy()
    assert wrong.shape == ref.shape
    assert float(np.max(np.abs(wrong - ref))) > 100 * TOL


def _pipelines(name: str):
    """(JAX, port) pipelines holding only the VAE (the encode reads nothing else)."""
    params, config = _params(name), CONFIGS[name]
    jpipe = JaxPipeline(model=None, transformer_params=None, transformer_config=None, vae_params=params,
                        vae_config=config)
    tpipe = Flux2Pipeline(model=Flux2Model.KLEIN_4B, transformer=None, vae=vae_from_jax(params, config),
                          device=torch.device("cpu"), vae_encoder=vae_encoder_from_jax(params, config))
    return jpipe, tpipe


@pytest.mark.parametrize("kind", ["float", "uint8", "uint8_as_float"])
def test_encode_image_to_packed_sequence_matches_jax(kind):
    jpipe, tpipe = _pipelines("tiny")
    img = _image(64, 96, seed=4)
    if kind != "float":
        img = np.rint(img * 255.0).astype(np.uint8)
    if kind == "uint8_as_float":  # JAX uploads these as uint8; the port as float32: same values
        img = img.astype(np.float32) / np.float32(255.0)
    ref = np.asarray(jpipe.encode_image_to_packed_sequence(img))
    got = tpipe.encode_image_to_packed_sequence(img)
    assert got.dtype == torch.float32 and tuple(got.shape) == ref.shape == (1, 24, 128)
    assert float(np.max(np.abs(got.numpy() - ref))) <= TOL


def test_posterior_sample_draws_from_the_generator():
    """sample_posterior: mean + exp(logvar / 2) * N(0, 1) from the torch.Generator
    (JAX draws from a PRNG key: the samples differ by design)."""
    _, tpipe = _pipelines("tiny")
    img = _image(64, 64, seed=5)
    mean = tpipe.encode_image_to_packed_sequence(img)
    a = tpipe.encode_image_to_packed_sequence(img, sample_posterior=True, generator=torch.Generator().manual_seed(1))
    b = tpipe.encode_image_to_packed_sequence(img, sample_posterior=True, generator=torch.Generator().manual_seed(1))
    assert torch.equal(a, b) and not torch.equal(a, mean)
    x = torch.from_numpy(_nchw(img))
    with torch.inference_mode():
        moments = tpipe.vae_encoder.encode_moments(x)
        eps = torch.randn((1, 32, 8, 8), generator=torch.Generator().manual_seed(1))
        z = tpipe.vae_encoder.encode(x, sample_posterior=True, generator=torch.Generator().manual_seed(1))
    torch.testing.assert_close(z, moments[:, :32] + torch.exp(0.5 * moments[:, 32:]) * eps, rtol=0, atol=0)
    with pytest.raises(ValueError, match="torch.Generator"):
        tpipe.vae_encoder.encode(x, sample_posterior=True)


def test_encode_without_an_encoder_raises():
    _, tpipe = _pipelines("tiny")
    tpipe.vae_encoder = None
    with pytest.raises(ValueError, match="no VAE encoder attached"):
        tpipe.encode_image_to_packed_sequence(_image(64, 64))
    with pytest.raises(ValueError, match="no VAE encoder attached"):
        tpipe.encode_reference_images([_image(64, 64)])


@pytest.mark.parametrize("to_out", ["to_out.0", "to_out"])
def test_encoder_half_loads_from_a_diffusers_checkpoint_as_jax(to_out, tmp_path):
    path = write_checkpoint(tmp_path / "vae", vae_checkpoint(_params("tiny"), to_out), torch.float32)
    jparams = jwm.map_vae_weights(jckpt.load_weights_dir(path), TINY)
    enc = twm.load_vae_encoder(tckpt.WeightsDir(path), VAE_CONFIG, "cpu")
    assert all(t.dtype == torch.float32 for t in enc.state_dict().values())
    _assert_state_equal(enc, vae_encoder_from_jax(jparams, TINY))


def test_missing_encoder_weight_raises_naming_it(tmp_path):
    ckpt = vae_checkpoint(_params("tiny"))
    del ckpt["encoder.down_blocks.1.downsamplers.0.conv.weight"]
    path = write_checkpoint(tmp_path / "vae", ckpt, torch.float32, files=1)
    with pytest.raises(KeyError, match=r"down_blocks\.1\.downsample\.weight"):
        twm.load_vae_encoder(tckpt.WeightsDir(path), VAE_CONFIG, "cpu")


def test_encode_input_is_contiguous_nchw_whatever_the_image_layout(monkeypatch):
    """A channel-planar image (an HWC view of CHW memory) and a C-ordered one
    reach the encoder as the same contiguous NCHW tensor: on the card a
    channels-last input takes other cuDNN kernels, whose latents differ."""
    _, tpipe = _pipelines("tiny")
    seen, encode = [], tpipe.vae_encoder.encode
    monkeypatch.setattr(tpipe.vae_encoder, "encode", lambda x, **kw: seen.append(x.is_contiguous()) or encode(x, **kw))
    img = _image(64, 96, seed=6)
    planar = np.ascontiguousarray(img.transpose(2, 0, 1)).transpose(1, 2, 0)
    assert not planar.flags["C_CONTIGUOUS"]
    a, b = tpipe.encode_image_to_packed_sequence(img), tpipe.encode_image_to_packed_sequence(planar)
    assert seen == [True, True] and torch.equal(a, b)
