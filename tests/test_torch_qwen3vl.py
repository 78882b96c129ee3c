"""The port's Qwen3-VL tower against the JAX package's, on the CPU.

JAX's perturbed ``TINY_DECODER`` weights (head_dim 16) carried into the
port's generic decoder (``io.jax_params.decoder_from_jax``): both MRoPE
conventions (the reference's per-section pair-interleaved ladders,
``mrope_cos_sin``, and HF's strided global ladder, ``mrope_cos_sin_hf``) at
text-only and at distinct (t, h, w) position ids within 1e-5, and
``forward_hidden_states`` / ``extract_klein_vl_embeddings`` in each
convention, with a padded row, within 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flux2_tpu.models.text_encoders import decoder as jdec
from flux2_tpu.models.text_encoders import qwen3vl as jvl
from flux2_tpu_torch.io.jax_params import decoder_from_jax
from flux2_tpu_torch.models.text_encoders import qwen3vl as tvl
from flux2_tpu_torch.models.text_encoders.config import TINY_DECODER

from tests.test_torch_lora_loader import one_torch_thread  # noqa: F401  (module fixture)
from tests.test_torch_shared_copies import jax_config
from tests.test_torch_transformer import perturbed_numpy

SECTION = (4, 2, 2)  # 2 * (4 + 2 + 2) = 16 = head_dim
TOL = 1e-5
LM_TOL = 1e-4


@pytest.fixture(scope="module")
def models():
    params = perturbed_numpy(jdec.init_params(jax.random.PRNGKey(0), jax_config(TINY_DECODER), dtype=jnp.float32), 0)
    return jax.tree_util.tree_map(jnp.asarray, params), decoder_from_jax(params, TINY_DECODER)


def test_text_only_position_ids_equal_jax():
    for n, offset in ((4, 2), (7, 0)):
        np.testing.assert_array_equal(tvl.text_only_position_ids(n, offset).numpy(),
                                      np.asarray(jvl.text_only_position_ids(n, offset)))


@pytest.mark.parametrize("convention", ["reference", "hf"])
@pytest.mark.parametrize("head_dim,section", [(16, (4, 2, 2)), (20, (4, 2, 2)), (128, (24, 20, 20))])
def test_mrope_tables_equal_jax(convention, head_dim, section):
    """Text-only ids and distinct (t, h, w) ids; head_dim 20 leaves 4 dims past the sections."""
    port, ref = {"reference": (tvl.mrope_cos_sin, jvl.mrope_cos_sin),
                 "hf": (tvl.mrope_cos_sin_hf, jvl.mrope_cos_sin_hf)}[convention]
    rng = np.random.RandomState(1)
    for pos in (np.asarray(jvl.text_only_position_ids(9)), rng.randint(0, 40, (3, 9))):
        cos, sin = port(torch.from_numpy(np.array(pos)), head_dim, 1e6, section)
        jcos, jsin = ref(jnp.asarray(pos), head_dim, 1e6, section)
        np.testing.assert_allclose(cos.numpy(), np.asarray(jcos), atol=TOL, rtol=0)
        np.testing.assert_allclose(sin.numpy(), np.asarray(jsin), atol=TOL, rtol=0)


@pytest.mark.parametrize("hf_canonical", [False, True], ids=["reference", "hf"])
def test_forward_hidden_states_and_extraction_equal_jax(models, hf_canonical):
    """Two rows, the second right-padded (its last two keys masked)."""
    jparams, decoder = models
    ids = np.random.RandomState(2).randint(0, TINY_DECODER.vocab_size, (2, 7))
    mask = np.ones((2, 7), np.int32)
    mask[1, 5:] = 0
    fwd = jax.jit(lambda p, i, m: jvl.forward_hidden_states(p, jax_config(TINY_DECODER), i, m, section=SECTION,
                                                              hf_canonical=hf_canonical))
    ref = np.asarray(fwd(jparams, jnp.asarray(ids), jnp.asarray(mask)))
    with torch.inference_mode():
        hs = tvl.forward_hidden_states(decoder, torch.from_numpy(ids), torch.from_numpy(mask), section=SECTION,
                                       hf_canonical=hf_canonical).numpy()
        emb = tvl.extract_klein_vl_embeddings(decoder, torch.from_numpy(ids), torch.from_numpy(mask),
                                              layer_indices=(1, 2, 4), section=SECTION,
                                              hf_canonical=hf_canonical).numpy()
    assert np.isfinite(ref).all() and hs.shape == ref.shape == (5, 2, 7, TINY_DECODER.hidden_size)
    np.testing.assert_allclose(hs, ref, atol=LM_TOL, rtol=0)
    jemb = jvl.extract_klein_vl_embeddings(jparams, jax_config(TINY_DECODER), jnp.asarray(ids), jnp.asarray(mask),
                                           layer_indices=(1, 2, 4), section=SECTION, hf_canonical=hf_canonical)
    np.testing.assert_allclose(emb, np.asarray(jemb), atol=LM_TOL, rtol=0)


def test_the_two_conventions_differ(models):
    """Past position 0 the two tables rotate differently, so the towers do."""
    _, decoder = models
    ids = torch.arange(6)[None]
    with torch.inference_mode():
        a = tvl.forward_hidden_states(decoder, ids, torch.ones_like(ids), section=SECTION)
        b = tvl.forward_hidden_states(decoder, ids, torch.ones_like(ids), section=SECTION, hf_canonical=True)
    assert float((a[-1, :, 1:] - b[-1, :, 1:]).abs().max()) > 100 * LM_TOL
