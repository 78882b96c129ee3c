"""The port's classical CFG (base models) against the JAX pipeline (CPU, float32).

The tiny klein-4b-base pipeline of tests/test_golden_regression.py is made by
the JAX package and converted with ``flux2_tpu_torch.io.jax_params``; JAX's
threefry noise for seed 1234 goes to the port as ``noise=``. Cond and uncond
run as batch rows of one forward and ``v = v_uncond + guidance * (v_cond -
v_uncond)``: the final latents must match ``tiny_cfg_latents_seed1234.npy``
at the golden's tolerance, atol 1e-3.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flux2_tpu.models.flux2 import config as jcfg
from flux2_tpu.pipeline.pipeline import _seeded_noise_seq
from flux2_tpu_torch.io.jax_params import transformer_from_jax, vae_from_jax
from flux2_tpu_torch.io.png import decode_png
from flux2_tpu_torch.models.flux2.config import Flux2Model
from flux2_tpu_torch.pipeline.pipeline import Flux2Pipeline
from flux2_tpu_torch.serve import Flux2Server

from test_golden_regression import GOLDEN_CFG
from test_pipeline import _emb, tiny_pipeline


@pytest.fixture(scope="module")
def pipes():
    """(JAX, port) tiny pipelines of each model, on the same weights."""
    out = {}
    for model in (jcfg.Flux2Model.KLEIN_4B_BASE, jcfg.Flux2Model.KLEIN_4B):
        jpipe = tiny_pipeline(model=model)
        tpipe = Flux2Pipeline(
            model=Flux2Model(model.value),
            transformer=transformer_from_jax(jpipe.transformer_params, jpipe.transformer_config),
            vae=vae_from_jax(jpipe.vae_params, jpipe.vae_config),
            device=torch.device("cpu"),
            vae_compute_dtype=torch.float32,
        )
        out[model.value] = (jpipe, tpipe)
    return out


class _CountingEncoder:
    """prompt -> fixed [1, 8, 96] embeddings (seeded by the prompt); records each call."""

    def __init__(self):
        self.calls = []

    def __call__(self, prompt: str) -> torch.Tensor:
        self.calls.append(prompt)
        seed = sum(map(ord, prompt)) + 1
        return torch.from_numpy(np.random.RandomState(seed).randn(1, 8, 96).astype(np.float32))


def _noise():
    return torch.from_numpy(np.array(_seeded_noise_seq(1234, 64, 64, 1)))


def test_cfg_latents_match_golden_and_jax(pipes):
    jpipe, tpipe = pipes["klein-4b-base"]
    emb, neg = np.array(_emb(jpipe)), np.array(_emb(jpipe, seed=99))
    jpipe.vae_compute_dtype = jnp.float32
    ref = jpipe.generate(embeddings=jnp.asarray(emb), negative_embeddings=jnp.asarray(neg), guidance=3.5,
                         height=64, width=64, num_steps=3, seed=1234)
    res = tpipe.generate(embeddings=torch.from_numpy(emb), negative_embeddings=torch.from_numpy(neg),
                         guidance=3.5, height=64, width=64, num_steps=3, noise=_noise())
    np.testing.assert_allclose(res.latents, np.load(GOLDEN_CFG), atol=1e-3, rtol=0)
    np.testing.assert_allclose(res.latents, np.asarray(ref.latents), atol=1e-3, rtol=0)
    assert np.max(np.abs(res.image - ref.image)) <= 1.0 / 255 + 1e-6


def test_cfg_without_negative_or_encoder_raises_as_jax(pipes):
    jpipe, tpipe = pipes["klein-4b-base"]
    emb = np.array(_emb(jpipe))
    with pytest.raises(ValueError, match="classical CFG requires negative embeddings"):
        jpipe.generate(embeddings=jnp.asarray(emb), height=64, width=64, num_steps=1, seed=0)
    with pytest.raises(ValueError, match="classical CFG requires negative embeddings"):
        tpipe.generate(embeddings=torch.from_numpy(emb), height=64, width=64, num_steps=1, noise=_noise())


@pytest.mark.parametrize("model,want_calls", [("klein-4b-base", ["a fox", ""]), ("klein-4b", ["a fox"])])
def test_empty_negative_is_encoded_once_through_the_lru(pipes, model, want_calls):
    """A base model encodes "" as its negative once and then serves it from the
    prompt LRU, as JAX's encode_prompt does; a distilled model never encodes it."""
    _, tpipe = pipes[model]
    enc = _CountingEncoder()
    tpipe.text_encoder = enc
    try:
        first = tpipe.generate(prompt="a fox", height=64, width=64, num_steps=2, noise=_noise(), decode=False)
        again = tpipe.generate(prompt="a fox", height=64, width=64, num_steps=2, noise=_noise(), decode=False)
        assert enc.calls == want_calls
        assert torch.equal(first.latents_device, again.latents_device)
        if model == "klein-4b-base":
            explicit = tpipe.generate(embeddings=enc("a fox"), negative_embeddings=enc(""), height=64, width=64,
                                      num_steps=2, noise=_noise(), decode=False)
            assert torch.equal(first.latents_device, explicit.latents_device)
    finally:
        tpipe.text_encoder = None


def test_server_runs_a_base_model_request_with_the_empty_negative(pipes):
    """Flux2Server passes the request's embeddings and no negative, as the JAX
    server (flux2_tpu/serve.py:302); the pipeline encodes "" itself."""
    _, tpipe = pipes["klein-4b-base"]
    enc = _CountingEncoder()
    tpipe.text_encoder = enc
    server = Flux2Server(tpipe, embeddings_fn=tpipe.encode_prompt, batch_window_s=0.0)
    try:
        png = server.generate_png({"prompt": "a fox", "height": 64, "width": 64, "steps": 2, "seed": 5})
        solo = tpipe.generate(prompt="a fox", height=64, width=64, num_steps=2, seed=5)
        assert decode_png(png).shape == (64, 64, 3)
        assert np.max(np.abs(decode_png(png).astype(np.int32) - np.rint(solo.image * 255).astype(np.int32))) == 0
        assert enc.calls == ["a fox", ""]
    finally:
        server.shutdown()
        tpipe.text_encoder = None
