"""The port's T2I pipeline and server against the JAX pipeline (CPU, float32).

The tiny pipeline of tests/test_pipeline.py is made by the JAX package and
converted with ``flux2_tpu_torch.io.jax_params``. JAX's threefry noise for
seed 1234 and the same embeddings go to the port as ``noise=`` and
``embeddings=`` (the port's own seeds give other noise, by design). The final
latents must match the golden fixture of tests/test_golden_regression.py at
its tolerance, atol 1e-3; the decoded uint8 image, with the VAE computing in
float32 in both, must be within one level (1/255) of JAX's.
"""

import threading
import time
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flux2_tpu.pipeline.pipeline import _seeded_noise_seq
from flux2_tpu_torch.io.jax_params import transformer_from_jax, vae_from_jax
from flux2_tpu_torch.io.png import decode_png
from flux2_tpu_torch.pipeline.pipeline import Flux2Pipeline, GenerationCancelled
from flux2_tpu_torch.serve import Flux2Server

from test_golden_regression import GOLDEN
from test_pipeline import _emb, tiny_pipeline


@pytest.fixture(scope="module")
def pipes():
    jpipe = tiny_pipeline()
    tpipe = Flux2Pipeline(
        model=jpipe.model,
        transformer=transformer_from_jax(jpipe.transformer_params, jpipe.transformer_config),
        vae=vae_from_jax(jpipe.vae_params, jpipe.vae_config),
        device=torch.device("cpu"),
    )
    return jpipe, tpipe


def test_t2i_latents_match_golden_and_image_matches_jax(pipes):
    jpipe, tpipe = pipes
    emb = np.array(_emb(jpipe))
    noise = np.array(_seeded_noise_seq(1234, 64, 64, 1))
    jpipe.vae_compute_dtype = jnp.float32
    tpipe.vae_compute_dtype = torch.float32
    ref = jpipe.generate(embeddings=jnp.asarray(emb), height=64, width=64, num_steps=3, seed=1234)
    res = tpipe.generate(embeddings=torch.from_numpy(emb), height=64, width=64, num_steps=3,
                         noise=torch.from_numpy(noise))
    np.testing.assert_allclose(res.latents.numpy(), np.load(GOLDEN), atol=1e-3, rtol=0)
    assert res.image.shape == (64, 64, 3) and res.num_steps == 3
    assert set(res.phase_timings) == {"text_encoding", "denoising", "vae_decoding"}
    assert np.max(np.abs(res.image - ref.image)) <= 1.0 / 255 + 1e-6


def test_batched_decode_above_the_pixel_budget_runs_per_image(pipes, monkeypatch):
    """B*H*W above the budget decodes image by image; the result is the dense one."""
    from flux2_tpu_torch.pipeline import pipeline as tpl

    _, tpipe = pipes
    tpipe.vae_compute_dtype = torch.float32
    lat = torch.from_numpy(np.random.RandomState(0).randn(3, 16, 128).astype(np.float32))
    dense = tpipe.decode_latents_u8(lat, 64, 64)
    monkeypatch.setattr(tpl, "DECODE_BATCH_BUDGET_PIXELS", 2 * 64 * 64)
    calls = []
    decode = tpipe.vae.decode
    monkeypatch.setattr(tpipe.vae, "decode", lambda z: calls.append(z.shape[0]) or decode(z))
    per_image = tpipe.decode_latents_u8(lat, 64, 64)
    assert calls == [1, 1, 1] and per_image.shape == (3, 64, 64, 3) and per_image.dtype == torch.uint8
    assert int((per_image.int() - dense.int()).abs().max()) <= 1


def test_generate_cancel_raises(pipes):
    _, tpipe = pipes
    with pytest.raises(GenerationCancelled):
        tpipe.generate(embeddings=torch.zeros(1, 8, 96), height=64, width=64, num_steps=2, cancel=lambda: True)


def test_server_coalesces_concurrent_requests_and_honours_each_seed(pipes):
    _, tpipe = pipes
    embs = {f"p{i}": torch.from_numpy(np.random.RandomState(i).randn(1, 8, 96).astype(np.float32))
            for i in range(3)}
    server = Flux2Server(tpipe, embeddings_fn=embs.__getitem__, batch_window_s=3.0)
    try:
        pngs, errors = {}, []

        def request(i):
            try:
                pngs[i] = server.generate_png({"prompt": f"p{i}", "height": 64, "width": 64, "steps": 2,
                                               "seed": 10 + i})
            except Exception as e:  # reported below
                errors.append(e)

        threads = [threading.Thread(target=request, args=(i,)) for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not errors and not any(t.is_alive() for t in threads)
        assert server.batches_run == 1 and server.requests_served == 3
        assert [r["batch_size"] for r in server.request_timings] == [3, 3, 3]
        for i in range(3):
            solo = tpipe.generate(embeddings=embs[f"p{i}"], height=64, width=64, num_steps=2, seed=10 + i)
            got = decode_png(pngs[i]).astype(np.int32)
            want = np.rint(solo.image * 255).astype(np.int32)
            assert got.shape == (64, 64, 3)
            assert np.max(np.abs(got - want)) <= 1  # batched vs solo matmuls may round apart
    finally:
        server.shutdown()


class _StubPipeline:
    """Records the batch size of each generate(); returns black images at once."""

    device = torch.device("cpu")

    def __init__(self):
        self.batch_sizes = []

    def generate(self, noise, height, width, num_steps, **_):
        self.batch_sizes.append(len(noise))
        return types.SimpleNamespace(
            images=np.zeros((len(noise), height, width, 3), np.float32), image=None, num_steps=num_steps or 4,
            phase_timings={"denoising": 0.0, "vae_decoding": 0.0},
        )


def test_server_window_outlasts_arrivals_and_ends_on_a_full_batch():
    """The port's coalescing rule (the JAX server's window ends at the next
    arrival, flux2_tpu/serve.py:241-250): an arrival does not end the window,
    so requests 0.2 s apart inside a 1.5 s window run as one batch; a full
    batch ends it, so a 1024^2 request (cap 1) does not wait out a 30 s window."""
    stub = _StubPipeline()
    server = Flux2Server(stub, batch_window_s=1.5)
    try:
        threads = []
        for i in range(3):
            threads.append(threading.Thread(
                target=server.generate_png, args=({"height": 64, "width": 64, "steps": 2, "seed": i},)))
            threads[-1].start()
            time.sleep(0.2)
        for t in threads:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in threads) and stub.batch_sizes == [3]

        server.batch_window_s = 30.0
        t0 = time.monotonic()
        server.generate_png({"height": 1024, "width": 1024, "steps": 4, "seed": 0})
        assert time.monotonic() - t0 < 10.0 and stub.batch_sizes == [3, 1]
    finally:
        server.shutdown()


@pytest.mark.parametrize("hw", [(64, 64), (256, 256), (512, 512), (384, 640), (1024, 1024)])
def test_batch_cap_matches_jax_server(hw):
    from flux2_tpu.serve import Flux2Server as JaxServer

    jax_server, port_server = JaxServer(None), Flux2Server(None)
    try:
        key = (hw[0], hw[1], 4, None)
        assert port_server._batch_cap(key) == jax_server._batch_cap(key)
    finally:
        jax_server.shutdown()
        port_server.shutdown()
