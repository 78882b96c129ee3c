"""The port's KV-cached forwards (klein-9b-kv) against JAX's (CPU, float32).

``forward_kv_extract`` runs [txt ; ref ; img] with the reference queries blind
to the output keys and returns each block's post-RoPE reference K/V;
``forward_kv_cached`` runs [txt ; img] with that K/V inserted between the text
and image keys. On JAX's perturbed init weights, carried into the port, the
extract velocity, both caches (the port's per-block lists stacked as JAX's
[L, B, H, S_ref, 128]) and the cached velocity are held within 5e-4 of JAX's,
the DiT tolerance. Then the four properties of ``tests/test_kv_cache.py`` on
the port alone, and the tiny klein-9b-kv pipeline's latents against
``tiny_kv_latents_seed1234.npy`` and JAX's run at atol 1e-3 (JAX's noise
injected).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flux2_tpu.models.flux2 import config as jcfg
from flux2_tpu.models.flux2 import transformer as jtfm
from flux2_tpu.ops.rope import rope_embeddings as jrope
from flux2_tpu_torch.io.jax_params import transformer_from_jax
from flux2_tpu_torch.models.flux2.config import Flux2TransformerConfig
from flux2_tpu_torch.ops import latents as lu
from flux2_tpu_torch.ops.rope import rope_embeddings

from tests.test_torch_shared_copies import jax_config
from tests.test_torch_transformer import perturbed_numpy

DIT_TOL = 5e-4
# tests/test_kv_cache.py's configuration and shapes: 2 double and 2 single
# blocks, 2 heads; 4 text, 8 reference (a 2x4 grid) and 16 image tokens
CONFIG = Flux2TransformerConfig(num_layers=2, num_single_layers=2, num_attention_heads=2, attention_head_dim=128,
                                joint_attention_dim=96, guidance_embeds=False)
S_TXT, S_REF, S_IMG = 4, 8, 16


@pytest.fixture(scope="module")
def setup():
    params = perturbed_numpy(jtfm.init_params(jax.random.PRNGKey(0), jax_config(CONFIG), dtype=jnp.float32), 0)
    rng = np.random.RandomState(1)
    hidden = rng.randn(1, S_IMG, 128).astype(np.float32)
    ref = rng.randn(1, S_REF, 128).astype(np.float32)
    txt = rng.randn(1, S_TXT, 96).astype(np.float32)
    ref_ids = lu.reference_image_position_ids([2], [4])
    ids_extract = np.concatenate([lu.text_position_ids(S_TXT), ref_ids, lu.image_position_ids(64, 64)])
    ids_cached = np.concatenate([lu.text_position_ids(S_TXT), lu.image_position_ids(64, 64)])
    return {"params": params, "model": transformer_from_jax(params, CONFIG), "hidden": hidden, "ref": ref, "txt": txt,
            "ids_extract": ids_extract, "ids_cached": ids_cached, "t": np.array([0.9], np.float32)}


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.asarray(x, np.float32))


def _extract(s, hidden=None, ref=None):
    cos, sin = rope_embeddings(torch.from_numpy(s["ids_extract"]))
    with torch.inference_mode():
        return s["model"].forward_kv_extract(_t(s["hidden"] if hidden is None else hidden),
                                             _t(s["ref"] if ref is None else ref), _t(s["txt"]), _t(s["t"]), cos, sin)


def _cached(s, double_kv, single_kv, hidden=None):
    cos, sin = rope_embeddings(torch.from_numpy(s["ids_cached"]))
    with torch.inference_mode():
        return s["model"].forward_kv_cached(_t(s["hidden"] if hidden is None else hidden), _t(s["txt"]), _t(s["t"]),
                                            cos, sin, double_kv, single_kv)


def _stacked(kvs) -> tuple:
    """The port's per-block [(k, v)] -> JAX's stacked (k [L, ...], v [L, ...])."""
    return tuple(torch.stack([kv[i] for kv in kvs]).numpy() for i in (0, 1))


def _max_abs(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a, np.float32) - np.asarray(b, np.float32))))


def test_extract_and_cached_match_jax(setup):
    s = setup
    jp, cfg = jax.tree_util.tree_map(jnp.asarray, s["params"]), jax_config(CONFIG)
    cos_e, sin_e = jrope(jnp.asarray(s["ids_extract"]))
    cos_c, sin_c = jrope(jnp.asarray(s["ids_cached"]))
    hidden, ref, txt, t = (jnp.asarray(s[k]) for k in ("hidden", "ref", "txt", "t"))
    v_ref, dkv_ref, skv_ref = jtfm.forward_kv_extract(jp, cfg, hidden, ref, txt, t, cos_e, sin_e)
    vc_ref = jtfm.forward_kv_cached(jp, cfg, hidden, txt, t, cos_c, sin_c, dkv_ref, skv_ref)

    v, dkv, skv = _extract(s)
    assert _max_abs(v, v_ref) <= DIT_TOL
    for got, want in zip(_stacked(dkv) + _stacked(skv), tuple(dkv_ref) + tuple(skv_ref)):
        assert got.shape == want.shape
        assert _max_abs(got, want) <= DIT_TOL
    assert _max_abs(_cached(s, dkv, skv), vc_ref) <= DIT_TOL


def test_extract_shapes(setup):
    v, dkv, skv = _extract(setup)
    assert v.shape == (1, S_IMG, 128) and torch.isfinite(v).all()
    assert len(dkv) == CONFIG.num_layers and len(skv) == CONFIG.num_single_layers
    for k, vv in dkv + skv:
        assert k.shape == vv.shape == (1, 2, S_REF, 128) and k.is_contiguous()


def test_cached_matches_extract_velocity(setup):
    """At the same latents and timestep the cached pass, fed the extract pass's
    cache, gives the extract pass's velocity (JAX's test, same atol 2e-4)."""
    v_extract, dkv, skv = _extract(setup)
    torch.testing.assert_close(_cached(setup, dkv, skv), v_extract, atol=2e-4, rtol=0)


def test_cache_carries_reference_information(setup):
    _, dkv1, skv1 = _extract(setup)
    _, dkv2, skv2 = _extract(setup, ref=setup["ref"] + 1.0)
    assert float((_cached(setup, dkv1, skv1) - _cached(setup, dkv2, skv2)).abs().max()) > 1e-5


def test_extraction_mask_blocks_ref_from_output(setup):
    """The first double block's reference K/V depend on the reference alone:
    other output latents leave them unchanged."""
    _, dkv1, _ = _extract(setup)
    _, dkv2, _ = _extract(setup, hidden=setup["hidden"] * 2.0 + 1.0)
    torch.testing.assert_close(dkv1[0][0], dkv2[0][0], atol=1e-5, rtol=0)
    torch.testing.assert_close(dkv1[0][1], dkv2[0][1], atol=1e-5, rtol=0)


def test_kv_pipeline_latents_match_golden_and_jax():
    from flux2_tpu.pipeline.pipeline import _seeded_noise_seq

    from tests.test_golden_regression import GOLDEN_KV, _ref_image
    from tests.test_torch_i2i import port_of, tiny_pipelines

    jpipe = dataclasses.replace(tiny_pipelines()[0], model=jcfg.Flux2Model.KLEIN_9B_KV)
    tpipe = port_of(jpipe)
    emb = np.array(jax.random.normal(jax.random.PRNGKey(3), (1, 8, 96)))
    jlat, jids = jpipe.encode_reference_images([_ref_image()])
    ref = jpipe.generate(embeddings=jnp.asarray(emb), height=64, width=64, num_steps=3, seed=1234,
                         reference_latents=jlat, reference_ids=jids, decode=False)
    tlat, tids = tpipe.encode_reference_images([_ref_image()])
    np.testing.assert_array_equal(tids, jids)
    noise = torch.from_numpy(np.array(_seeded_noise_seq(1234, 64, 64, 1)))
    res = tpipe.generate(embeddings=torch.from_numpy(emb), height=64, width=64, num_steps=3, noise=noise,
                         reference_latents=tlat, reference_ids=tids, decode=False)
    np.testing.assert_allclose(res.latents, np.load(GOLDEN_KV), atol=1e-3, rtol=0)
    np.testing.assert_allclose(res.latents, np.asarray(ref.latents), atol=1e-3, rtol=0)


@pytest.mark.parametrize("model,with_refs,calls", [
    ("klein-9b-kv", True, {"kv_loops": 1, "extract": 1, "cached": 2}),
    ("klein-9b", True, {"kv_loops": 0, "extract": 0, "cached": 0}),
    ("klein-9b-kv", False, {"kv_loops": 0, "extract": 0, "cached": 0}),
], ids=["kv_with_references", "uncached_model", "kv_without_references"])
def test_generate_takes_the_kv_loop_only_for_a_kv_model_with_references(monkeypatch, model, with_refs, calls):
    """3 steps: one _denoise_kv_cached, one forward_kv_extract (step 0) and two
    forward_kv_cached; the uncached model, and T2I on the KV model, run none."""
    from flux2_tpu_torch.models.flux2.config import Flux2Model
    from flux2_tpu_torch.models.flux2.transformer import Flux2Transformer
    from flux2_tpu_torch.models.flux2.vae import VAEConfig
    from flux2_tpu_torch.pipeline.pipeline import Flux2Pipeline

    seen = {"kv_loops": 0, "extract": 0, "cached": 0}
    for cls, name, key in ((Flux2Pipeline, "_denoise_kv_cached", "kv_loops"),
                           (Flux2Transformer, "forward_kv_extract", "extract"),
                           (Flux2Transformer, "forward_kv_cached", "cached")):
        def wrapped(*args, _fn=getattr(cls, name), _key=key, **kwargs):
            seen[_key] += 1
            return _fn(*args, **kwargs)
        monkeypatch.setattr(cls, name, wrapped)
    tc = Flux2TransformerConfig(num_layers=1, num_single_layers=1, num_attention_heads=2, attention_head_dim=128,
                                joint_attention_dim=96, guidance_embeds=False)
    vc = VAEConfig(block_out_channels=(8, 8, 16, 16), layers_per_block=1, norm_num_groups=4)
    pipe = Flux2Pipeline.from_random(Flux2Model(model), device="cpu", generator=torch.Generator().manual_seed(0),
                                     transformer_config=tc, vae_config=vc)
    refs = {}
    if with_refs:
        lat, ids = pipe.encode_reference_images([np.random.RandomState(0).rand(32, 32, 3).astype(np.float32)])
        refs = {"reference_latents": lat, "reference_ids": ids}
    res = pipe.generate(embeddings=torch.zeros(1, 4, 96), height=32, width=32, num_steps=3, seed=1, decode=False,
                        **refs)
    assert seen == calls and torch.isfinite(res.latents_device).all()
