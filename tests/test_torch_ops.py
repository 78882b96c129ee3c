"""Parity of the PyTorch port's ops with the JAX package (CPU, float32).

Inputs come from numpy with a seed and go to both packages. Tolerance: 1e-5
absolute in float32 (elementwise math in the same order; only the
transcendental implementations differ). Position ids and sigma schedules are
host math and must be equal exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flux2_tpu.ops import latents as jlu
from flux2_tpu.ops import normalization as jnorm
from flux2_tpu.ops import rope as jrope
from flux2_tpu.ops import scheduler as jsch
from flux2_tpu_torch.ops import latents as tlu
from flux2_tpu_torch.ops import normalization as tnorm
from flux2_tpu_torch.ops import rope as trope
from flux2_tpu_torch.ops import scheduler as tsch

ATOL = 1e-5


def _rand(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _close(t, j, atol=ATOL):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=atol, rtol=0)


def test_rope_embeddings_match():
    ids = np.concatenate([jlu.text_position_ids(7), jlu.image_position_ids(64, 96)])
    cos_j, sin_j = jrope.rope_embeddings(jnp.asarray(ids))
    cos_t, sin_t = trope.rope_embeddings(torch.from_numpy(ids))
    _close(cos_t, cos_j)
    _close(sin_t, sin_j)


def test_apply_rope_matches():
    ids = np.concatenate([jlu.text_position_ids(5), jlu.image_position_ids(48, 48)])
    cos, sin = jrope.rope_embeddings(jnp.asarray(ids))
    x = _rand(0, 2, 3, ids.shape[0], 128)
    ref = jrope.apply_rope(jnp.asarray(x), cos, sin)
    out = trope.apply_rope(torch.from_numpy(x), torch.from_numpy(np.asarray(cos)), torch.from_numpy(np.asarray(sin)))
    _close(out, ref)


@pytest.mark.parametrize("name", ["layer_norm", "rms_norm", "modulate", "gate"])
def test_dit_norms_match(name):
    x = _rand(1, 2, 9, 64) * 3.0 + 0.5
    w = _rand(2, 64)
    shift, scale = _rand(3, 2, 64), _rand(4, 2, 64)
    if name == "layer_norm":
        ref, out = jnorm.layer_norm(jnp.asarray(x)), tnorm.layer_norm(torch.from_numpy(x))
    elif name == "rms_norm":
        ref, out = jnorm.rms_norm(jnp.asarray(x), jnp.asarray(w)), tnorm.rms_norm(torch.from_numpy(x), torch.from_numpy(w))
    elif name == "modulate":
        ref = jnorm.modulate(jnp.asarray(x), jnp.asarray(shift), jnp.asarray(scale))
        out = tnorm.modulate(torch.from_numpy(x), torch.from_numpy(shift), torch.from_numpy(scale))
    else:
        ref, out = jnorm.gate(jnp.asarray(x), jnp.asarray(scale)), tnorm.gate(torch.from_numpy(x), torch.from_numpy(scale))
    _close(out, ref)


def test_group_norm_nchw_matches_jax_nhwc():
    x = _rand(5, 2, 16, 6, 5) * 2.0 + 1.0  # NCHW
    w, b = _rand(6, 16), _rand(7, 16)
    ref = jnorm.group_norm(jnp.asarray(x.transpose(0, 2, 3, 1)), jnp.asarray(w), jnp.asarray(b), num_groups=4)
    out = tnorm.group_norm(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b), num_groups=4)
    _close(out.permute(0, 2, 3, 1), ref)


@pytest.mark.parametrize("hw", [(64, 64), (48, 80), (1024, 1024)])
def test_latent_geometry_matches(hw):
    h, w = hw
    assert tlu.validate_dimensions(h - 3, w - 5) == jlu.validate_dimensions(h - 3, w - 5)
    assert tlu.latent_dims(h, w) == jlu.latent_dims(h, w)
    np.testing.assert_array_equal(tlu.image_position_ids(h, w), jlu.image_position_ids(h, w))
    np.testing.assert_array_equal(tlu.text_position_ids(h // 16), jlu.text_position_ids(h // 16))


def test_pack_unpack_unpatchify_match():
    h, w = 64, 96
    p = _rand(8, 2, 128, h // 16, w // 16)
    seq_j = jlu.pack_patchified_to_sequence(jnp.asarray(p))
    seq_t = tlu.pack_patchified_to_sequence(torch.from_numpy(p))
    _close(seq_t, seq_j, atol=0)
    back = tlu.unpack_sequence_to_patchified(seq_t, h, w)
    _close(back, jlu.unpack_sequence_to_patchified(seq_j, h, w), atol=0)
    _close(tlu.unpatchify_latents(back), jlu.unpatchify_latents(jnp.asarray(p)), atol=0)


def test_denormalize_with_batchnorm_matches():
    x = _rand(9, 2, 128, 4, 4)
    mean, var = _rand(10, 128), np.abs(_rand(11, 128)) + 0.1
    ref = jlu.denormalize_with_batchnorm(jnp.asarray(x), jnp.asarray(mean), jnp.asarray(var))
    out = tlu.denormalize_with_batchnorm(torch.from_numpy(x), torch.from_numpy(mean), torch.from_numpy(var))
    _close(out, ref)


def test_seeded_noise_is_a_seeded_standard_normal():
    a = tlu.seeded_noise_seq(3, 64, 64, batch=2)
    b = tlu.seeded_noise_seq(3, 64, 64, batch=2)
    c = tlu.seeded_noise_seq(4, 64, 64, batch=2)
    assert a.shape == (2, 16, 128) and a.dtype == torch.float32
    assert torch.equal(a, b) and not torch.equal(a, c)


@pytest.mark.parametrize("steps,seq_len", [(4, 4096), (4, 256), (28, 4096), (50, 1024), (4, 16384), (1, 16), (8, 4301)])
def test_sigmas_equal_jax_bit_for_bit(steps, seq_len):
    ref = jsch.set_timesteps(steps, image_seq_len=seq_len)
    out = tsch.set_timesteps(steps, image_seq_len=seq_len)
    assert out.sigmas.dtype == np.float32
    np.testing.assert_array_equal(out.sigmas, ref.sigmas)
    np.testing.assert_array_equal(out.sigma_pairs(), ref.sigma_pairs())
    assert out.mu == ref.mu and out.num_steps == ref.num_steps


def test_euler_step_matches():
    x, v = _rand(12, 2, 16, 128), _rand(13, 2, 16, 128)
    sig = jsch.set_timesteps(4, image_seq_len=16).sigma_pairs()
    for s, s_next in sig:
        ref = jsch.euler_step(jnp.asarray(x), jnp.asarray(v), jnp.float32(s), jnp.float32(s_next))
        _close(tsch.euler_step(torch.from_numpy(x), torch.from_numpy(v), s, s_next), ref, atol=1e-6)
