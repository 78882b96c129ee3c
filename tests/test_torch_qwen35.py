"""The port's Qwen3.5 hybrid LM against the JAX package's, on the CPU.

JAX's perturbed ``TINY_QWEN35`` weights (4 layers: 3 Gated DeltaNet + 1
full attention) carried into the port (``io.jax_params.qwen35_from_jax``),
seeded numpy inputs, f32: the config, the causal depthwise conv, the
sequential and the chunked delta rule, the DeltaNet layer with and without
carried states, the interleaved MRoPE and the partial rotary (1e-5), the
gated full attention, ``forward_logits`` and the hybrid cache's prefill and
decode steps (1e-4); an HF qwen3_next checkpoint mapped by both packages to
the same parameters. JAX's chunked delta rule turns NaN under strong decay
(``exp`` of a positive exponent before the mask); the port's does not
(``test_chunked_delta_masks_before_exp``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flux2_tpu.io import weight_mapping as jwm
from flux2_tpu.models.text_encoders import qwen35 as jq
from flux2_tpu_torch.io import weight_mapping as twm
from flux2_tpu_torch.io.jax_params import qwen35_from_jax
from flux2_tpu_torch.models.text_encoders import qwen35 as tq

from tests.test_torch_lora_loader import one_torch_thread  # noqa: F401  (module fixture)
from tests.test_torch_transformer import perturbed_numpy

CFG = tq.TINY_QWEN35
JCFG = jq.TINY_QWEN35
TOL = 1e-5
LM_TOL = 1e-4
# JAX's references jitted: eager JAX re-traces each lax.scan on every call (~5x slower here)
_jax_logits = jax.jit(lambda p, ids, e: jq.forward_logits(p, JCFG, ids, inputs_embeds=e))
_jax_cached = jax.jit(lambda p, ids, c, pos: jq.forward_cached(p, JCFG, ids, c, pos))
_jax_deltanet = jax.jit(lambda lp, x, c, r: jq.gated_deltanet_forward(lp, JCFG, x, conv_state=c, rec_state=r))


@pytest.fixture(scope="module")
def models():
    params = perturbed_numpy(jq.init_params(jax.random.PRNGKey(2), JCFG), 2)
    for lp in params["layers"]:  # a spread of decays, mild enough that JAX's chunked form stays finite at 40
        if "linear_attn" in lp:
            lp["linear_attn"]["a_log"] = np.linspace(-3.0, -0.5, CFG.linear_num_value_heads).astype(np.float32)
            lp["linear_attn"]["dt_bias"] = np.linspace(0.2, 1.0, CFG.linear_num_value_heads).astype(np.float32)
    return jax.tree_util.tree_map(jnp.asarray, params), qwen35_from_jax(params, CFG)


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def _np(x) -> np.ndarray:
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("d", [{"vocab_size": 9, "hidden_size": 4, "intermediate_size": 8, "num_hidden_layers": 2,
                                "num_attention_heads": 2, "num_key_value_heads": 1},
                               {"vocab_size": 9, "hidden_size": 4, "intermediate_size": 8, "num_hidden_layers": 8,
                                "num_attention_heads": 2, "num_key_value_heads": 1, "head_dim": 32,
                                "rope_scaling": {"mrope_section": [2, 1, 1]}, "linear_num_key_heads": 2,
                                "full_attention_interval": 2, "tie_word_embeddings": False}])
def test_config_equals_jax(d):
    port, ref = tq.Qwen35TextConfig.from_json_dict(d), jq.Qwen35TextConfig.from_json_dict(d)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert [port.is_linear_layer(i) for i in range(8)] == [ref.is_linear_layer(i) for i in range(8)]
    assert (port.rotary_dim, port.conv_dim) == (ref.rotary_dim, ref.conv_dim)
    assert dataclasses.asdict(CFG) == dataclasses.asdict(JCFG)
    assert dataclasses.asdict(tq.Qwen35TextConfig()) == dataclasses.asdict(jq.Qwen35TextConfig())


def test_causal_depthwise_conv_equals_jax():
    rng = np.random.RandomState(0)
    x, kernel = rng.randn(2, 9, 6).astype(np.float32), rng.randn(4, 6).astype(np.float32)
    np.testing.assert_allclose(_np(tq._causal_depthwise_conv(_t(x), _t(kernel))),
                               np.asarray(jq._causal_depthwise_conv(jnp.asarray(x), jnp.asarray(kernel))),
                               atol=TOL, rtol=0)


def _delta_inputs(seed, b, t, hv, dk, dv, g=None, beta=None, unit_keys=False):
    rng = np.random.RandomState(seed)
    q = rng.randn(b, t, hv, dk).astype(np.float32)
    k = rng.randn(b, t, hv, dk).astype(np.float32) * 0.3
    if unit_keys:
        q /= np.linalg.norm(q, axis=-1, keepdims=True)
        k /= np.linalg.norm(k, axis=-1, keepdims=True)
    v = rng.randn(b, t, hv, dv).astype(np.float32)
    g = (1 / (1 + np.exp(-(rng.randn(b, t, hv) - 0.5)))).astype(np.float32) if g is None else np.full((b, t, hv), g,
                                                                                                      np.float32)
    beta = (1 / (1 + np.exp(-rng.randn(b, t, hv)))).astype(np.float32) if beta is None else np.full((b, t, hv), beta,
                                                                                                    np.float32)
    s0 = (rng.randn(b, hv, dv, dk) * 0.1).astype(np.float32)
    return q, k, v, g, beta, s0


@pytest.mark.parametrize("t", [1, 5, 37])
def test_sequential_delta_rule_equals_jax(t):
    args = _delta_inputs(3, 2, t, 3, 16, 8)
    y_ref, s_ref = jq.gated_delta_update(*map(jnp.asarray, args))
    y, s = tq.gated_delta_update(*map(_t, args))
    np.testing.assert_allclose(_np(y), np.asarray(y_ref), atol=LM_TOL, rtol=0)
    np.testing.assert_allclose(_np(s), np.asarray(s_ref), atol=LM_TOL, rtol=0)


@pytest.mark.parametrize("chunk", [8, 16, 64])
def test_chunked_delta_rule_equals_jax(chunk):
    """T = 37 pads the last chunk (g = 1, beta = 0 there)."""
    args = _delta_inputs(4, 2, 37, 3, 16, 8)
    y_ref, s_ref = jq.gated_delta_update_chunked(*map(jnp.asarray, args), chunk_size=chunk)
    assert np.isfinite(np.asarray(y_ref)).all()
    y, s = tq.gated_delta_update_chunked(*map(_t, args), chunk_size=chunk)
    np.testing.assert_allclose(_np(y), np.asarray(y_ref), atol=LM_TOL, rtol=0)
    np.testing.assert_allclose(_np(s), np.asarray(s_ref), atol=LM_TOL, rtol=0)
    y_seq, s_seq = tq.gated_delta_update(*map(_t, args))
    np.testing.assert_allclose(_np(y), _np(y_seq), atol=LM_TOL, rtol=0)


@pytest.mark.parametrize("g", [0.9, 0.2, 1e-3])
def test_chunked_delta_masks_before_exp(g):
    """T = 64, 2 heads of 8, beta 0.5, unit-norm keys: at g = 0.2 and 1e-3
    JAX's chunked form overflows exp(lg_t - lg_i) above the diagonal and
    gives NaN (a defect of the reference); the port's masks the exponent
    first and equals JAX's sequential recurrence. At g = 0.9 it also equals
    JAX's chunked output."""
    args = _delta_inputs(5, 1, 64, 2, 8, 8, g=g, beta=0.5, unit_keys=True)
    y_seq, s_seq = jq.gated_delta_update(*map(jnp.asarray, args))
    y_chk, s_chk = jq.gated_delta_update_chunked(*map(jnp.asarray, args))
    y, s = tq.gated_delta_update_chunked(*map(_t, args))
    assert torch.isfinite(y).all() and torch.isfinite(s).all()
    np.testing.assert_allclose(_np(y), np.asarray(y_seq), atol=LM_TOL, rtol=0)
    np.testing.assert_allclose(_np(s), np.asarray(s_seq), atol=LM_TOL, rtol=0)
    if g == 0.9:
        assert np.isfinite(np.asarray(y_chk)).all()
        np.testing.assert_allclose(_np(y), np.asarray(y_chk), atol=TOL, rtol=0)
    else:
        assert np.isnan(np.asarray(y_chk)).any()


def test_chunked_delta_survives_a_decay_that_underflows():
    """g = 0 exactly (exp of a decay past float32's range): the sequential
    recurrence forgets the state; the chunked form stays finite and agrees."""
    args = list(_delta_inputs(6, 1, 20, 2, 8, 8))
    args[3][:, 5] = 0.0
    y_seq, s_seq = tq.gated_delta_update(*map(_t, args))
    y, s = tq.gated_delta_update_chunked(*map(_t, args))
    assert torch.isfinite(y).all()
    np.testing.assert_allclose(_np(y), _np(y_seq), atol=LM_TOL, rtol=0)
    np.testing.assert_allclose(_np(s), _np(s_seq), atol=LM_TOL, rtol=0)


@pytest.mark.parametrize("s", [6, 12])
def test_deltanet_layer_equals_jax_with_and_without_states(models, s):
    """s = 6 takes the sequential rule, 12 the chunked one; the second half
    runs from the first half's conv and recurrent states."""
    jparams, lm = models
    lp = jparams["layers"][0]["linear_attn"]
    x = np.random.RandomState(7).randn(1, s, CFG.hidden_size).astype(np.float32)
    ref, jconv, jrec = _jax_deltanet(lp, jnp.asarray(x), None, None)
    layer = lm.layers[0].linear_attn
    with torch.inference_mode():
        out, conv, rec = layer(_t(x))
        np.testing.assert_allclose(_np(out), np.asarray(ref), atol=LM_TOL, rtol=0)
        np.testing.assert_allclose(_np(conv), np.asarray(jconv), atol=TOL, rtol=0)
        np.testing.assert_allclose(_np(rec), np.asarray(jrec), atol=LM_TOL, rtol=0)
        h = s // 2
        o1, c1, r1 = layer(_t(x[:, :h]))
        o2, _, _ = layer(_t(x[:, h:]), conv_state=c1, rec_state=r1)
    ref2, _, _ = _jax_deltanet(lp, jnp.asarray(x[:, h:]), jnp.asarray(_np(c1)), jnp.asarray(_np(r1)))
    np.testing.assert_allclose(_np(o2), np.asarray(ref2), atol=LM_TOL, rtol=0)
    np.testing.assert_allclose(_np(torch.cat([o1, o2], 1)), np.asarray(ref), atol=LM_TOL, rtol=0)


def test_mrope_and_partial_rotary_equal_jax():
    """Frequency i takes position axis i mod 3: distinct (t, h, w) ids."""
    rng = np.random.RandomState(8)
    pos = rng.randint(0, 50, (3, 2, 5))
    for cfg, jcfg in ((CFG, JCFG), (tq.Qwen35TextConfig(), jq.Qwen35TextConfig())):
        cos, sin = tq.mrope_cos_sin(cfg, _t(pos))
        jcos, jsin = jq.mrope_cos_sin(jcfg, jnp.asarray(pos))
        np.testing.assert_allclose(_np(cos), np.asarray(jcos), atol=TOL, rtol=0)
        np.testing.assert_allclose(_np(sin), np.asarray(jsin), atol=TOL, rtol=0)
        x = rng.randn(2, 3, 5, cfg.head_dim).astype(np.float32)
        np.testing.assert_allclose(_np(tq._apply_partial_rotary(_t(x), cos, sin, cfg.rotary_dim)),
                                   np.asarray(jq._apply_partial_rotary(jnp.asarray(x), jcos, jsin, cfg.rotary_dim)),
                                   atol=TOL, rtol=0)
        np.testing.assert_array_equal(_np(tq.text_position_ids(2, 5)), np.asarray(jq.text_position_ids(2, 5)))


def test_full_attention_equals_jax(models):
    jparams, lm = models
    x = np.random.RandomState(9).randn(1, 7, CFG.hidden_size).astype(np.float32)
    pos = np.random.RandomState(10).randint(0, 20, (3, 1, 7))
    ref = jq.full_attention_forward(jparams["layers"][3]["self_attn"], JCFG, jnp.asarray(x), jnp.asarray(pos))
    with torch.inference_mode():
        out = lm.layers[3].self_attn(_t(x), _t(pos))
    np.testing.assert_allclose(_np(out), np.asarray(ref), atol=LM_TOL, rtol=0)


@pytest.mark.parametrize("s", [5, 40])
def test_forward_logits_equal_jax(models, s):
    jparams, lm = models
    ids = np.random.RandomState(11).randint(0, CFG.vocab_size, (2, s))
    ref = np.asarray(_jax_logits(jparams, jnp.asarray(ids), None))
    with torch.inference_mode():
        out = _np(lm.forward_logits(_t(ids)))
        emb = lm.embed_tokens[_t(ids)] * 0.5
        with_embeds = _np(lm.forward_logits(_t(ids), inputs_embeds=emb))
    assert np.isfinite(ref).all() and out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=LM_TOL, rtol=0)
    np.testing.assert_allclose(with_embeds, np.asarray(_jax_logits(jparams, jnp.asarray(ids), jnp.asarray(_np(emb)))),
                               atol=LM_TOL, rtol=0)


def test_hybrid_cache_prefill_and_decode_equal_jax(models):
    """A 30-token prefill (chunked DeltaNet) then 4 decode steps (sequential),
    each against JAX's forward_cached and against the full forward."""
    jparams, lm = models
    ids = np.random.RandomState(12).randint(0, CFG.vocab_size, (1, 34))
    full = np.asarray(_jax_logits(jparams, jnp.asarray(ids), None))
    cache = tq.init_hybrid_cache(CFG, 1, 40)
    jcache = jq.init_hybrid_cache(JCFG, 1, 40)
    assert [sorted(c) for c in cache] == [sorted(c) for c in jcache]
    assert [tuple(v.shape) for c in cache for k, v in sorted(c.items()) if k != "len"] == \
        [tuple(v.shape) for c in jcache for k, v in sorted(c.items()) if k != "len"]
    assert cache[0]["rec"].dtype == torch.float32
    with torch.inference_mode():
        lg, cache = lm.forward_cached(_t(ids[:, :30]), cache, 0)
        jl, jcache = _jax_cached(jparams, jnp.asarray(ids[:, :30]), jcache, jnp.int32(0))
        np.testing.assert_allclose(_np(lg), np.asarray(jl), atol=LM_TOL, rtol=0)
        for t in range(30, 34):
            lg, cache = lm.forward_cached(_t(ids[:, t:t + 1]), cache, t)
            jl, jcache = _jax_cached(jparams, jnp.asarray(ids[:, t:t + 1]), jcache, jnp.int32(t))
            np.testing.assert_allclose(_np(lg), np.asarray(jl), atol=LM_TOL, rtol=0)
            np.testing.assert_allclose(_np(lg), full[:, t], atol=LM_TOL, rtol=0)
    assert cache[3]["len"] == 34
    with pytest.raises(ValueError, match="full"):
        lm.forward_cached(_t(ids[:, :8]), cache, 34)


def qwen35_checkpoint(cfg, seed: int, prefix: str) -> dict:
    """An HF qwen3_next checkpoint's LM keys (packed qkvz / ba, conv1d [C, 1, K],
    zero-centred norms) from seeded numpy."""
    rng = np.random.default_rng(seed)
    h, i = cfg.hidden_size, cfg.intermediate_size
    hk, hv, dk, dv = cfg.linear_num_key_heads, cfg.linear_num_value_heads, cfg.linear_key_head_dim, \
        cfg.linear_value_head_dim
    rep = hv // hk

    def draw(*shape, scale=0.05, shift=0.0):
        return (rng.standard_normal(shape) * scale + shift).astype(np.float32)

    w = {"embed_tokens.weight": draw(cfg.vocab_size, h), "norm.weight": draw(h)}
    for layer in range(cfg.num_hidden_layers):
        p = f"layers.{layer}."
        w[p + "input_layernorm.weight"], w[p + "post_attention_layernorm.weight"] = draw(h), draw(h)
        w[p + "mlp.gate_proj.weight"], w[p + "mlp.up_proj.weight"] = draw(i, h), draw(i, h)
        w[p + "mlp.down_proj.weight"] = draw(h, i)
        if cfg.is_linear_layer(layer):
            a = p + "linear_attn."
            w[a + "in_proj_qkvz.weight"] = draw(hk * (2 * dk + 2 * rep * dv), h)
            w[a + "in_proj_ba.weight"] = draw(hk * 2 * rep, h)
            w[a + "out_proj.weight"] = draw(h, hv * dv)
            w[a + "conv1d.weight"] = draw(cfg.conv_dim, 1, cfg.linear_conv_kernel_dim, scale=0.2)
            w[a + "norm.weight"] = draw(dv, shift=1.0)
            w[a + "A_log"], w[a + "dt_bias"] = draw(hv, scale=0.5), draw(hv, shift=1.0)
        else:
            a, hd = p + "self_attn.", cfg.head_dim
            w[a + "q_proj.weight"] = draw(2 * cfg.num_attention_heads * hd, h)
            w[a + "k_proj.weight"] = draw(cfg.num_key_value_heads * hd, h)
            w[a + "v_proj.weight"] = draw(cfg.num_key_value_heads * hd, h)
            w[a + "o_proj.weight"] = draw(h, cfg.num_attention_heads * hd)
            w[a + "q_norm.weight"], w[a + "k_norm.weight"] = draw(hd), draw(hd)
    return {prefix + k: v for k, v in w.items()}


@pytest.mark.parametrize("prefix", ["model.language_model.", "language_model.", "model."])
def test_map_qwen35_weights_equal_jax_leaf_for_leaf(prefix):
    """The per-key-head split of in_proj_qkvz / in_proj_ba, the conv kernel's
    transpose and the +1 of the zero-centred norms: both packages' mappings
    give the same module and the same logits; vision keys are not read."""
    w = qwen35_checkpoint(CFG, 13, prefix)
    jparams = jwm.map_qwen35_weights(w, JCFG)
    ref = qwen35_from_jax(jparams, CFG)
    tensors = {k: torch.from_numpy(v) for k, v in w.items()}
    tensors["model.visual.pos_embed.weight"] = torch.zeros(2, 2)
    got = twm.load_qwen35(tensors, CFG, "cpu", dtype=torch.float32)
    want = dict(ref.named_parameters())
    assert dict(got.named_parameters()).keys() == want.keys()
    for name, p in got.named_parameters():
        assert torch.equal(p, want[name]), name
    ids = np.arange(12)[None] % CFG.vocab_size
    with torch.inference_mode():
        np.testing.assert_allclose(_np(got.forward_logits(_t(ids))),
                                   np.asarray(_jax_logits(jparams, jnp.asarray(ids), None)), atol=LM_TOL, rtol=0)
