"""The port's quantization against the JAX package's (CPU).

- Codes, scales and biases of every storage format (``quantize``) and of the
  runtime formats (``to_w8a8``, ``to_w4a8``) equal JAX's bit for bit, on 2-D
  and stacked weights, in the port's [N, K] layout; dequantization too.
- The plain versions of K5, K6 and K7 match JAX's Pallas kernels run with
  ``interpret=True`` (as tests/test_quant.py runs them): relative L2 <= 1e-6
  with f32 activations (K5 is exact; K6 and K7 sum f32 in another order), and
  <= 1e-3 with bf16 ones, where a sum that lands within an f32 rounding of a
  bf16 boundary rounds the other way (~1e-4 seen).
- ``quantize_params`` picks the same leaves as JAX's, name for name, including
  where only the stacked [L, K, N] size reaches ``min_size``.
- A DiT built by ``transformer_from_jax`` from a JAX-quantized pytree matches
  JAX's ``forward`` within 5e-4 max abs (f32), the dense DiT's tolerance, and
  the carried codes equal the port's own quantization of the dense weights.
- The kernel each matmul of a full-width Klein-4B forward (bs=1, 1024^2) and
  a Qwen3-4B prompt encode would take on the card, by the gates alone, run on
  the ``meta`` device: K5 206, K6 205, K7 202 (qint8 and int4), encoder K5 180.
"""

import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flux2_tpu.models.flux2 import transformer as jtfm
from flux2_tpu.ops import latents as jlu
from flux2_tpu.ops import quant as jq
from flux2_tpu.ops import quant_kernels as jqk
from flux2_tpu.ops.rope import rope_embeddings
from flux2_tpu_torch.io.jax_params import transformer_from_jax
from flux2_tpu_torch.models.flux2 import transformer as ttfm
from flux2_tpu_torch.models.flux2.config import KLEIN_4B, TINY_TEST
from flux2_tpu_torch.models.text_encoders.config import QWEN3_4B
from flux2_tpu_torch.models.text_encoders import decoder as tdec
from flux2_tpu_torch.models.text_encoders.extractor import quantize_encoder_params
from flux2_tpu_torch.ops import quant as tq
from flux2_tpu_torch.ops import quant_kernels as tqk

from tests.test_torch_oracle import KLEIN_SLICE, TINY
from tests.test_torch_shared_copies import jax_config
from tests.test_torch_transformer import perturbed_numpy

STORAGE = ("qint8", "int4", "nf4", "mxfp8", "mxfp4", "nvfp4")
FORWARD_TOL = 5e-4


def _t(a) -> np.ndarray:
    """JAX [.., K, N] -> the port's [.., N, K]."""
    return np.ascontiguousarray(np.swapaxes(np.asarray(a), -1, -2))


def _bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.uint8) if a.dtype.name == "float8_e4m3fn" else a


def _port_bits(t: torch.Tensor) -> np.ndarray:
    return (t.view(torch.uint8) if t.dtype == torch.float8_e4m3fn else t).numpy()


def _weight(shape, seed):
    rng = np.random.RandomState(seed)
    w = (rng.randn(*shape) * 0.05).astype(np.float32)
    w[..., :64, 3] = 0.0  # an all-zero group: the scale == 0 branches
    w[..., 64, 5] = 1.5  # an outlier
    return w


@pytest.mark.parametrize("shape", [(512, 256), (3, 256, 512)], ids=["2d", "stacked"])
@pytest.mark.parametrize("fmt", STORAGE)
def test_quantize_codes_equal_jax(fmt, shape):
    w = _weight(shape, seed=len(shape))
    j = jq.quantize(jnp.asarray(w), fmt)
    t = tq.quantize(torch.from_numpy(_t(w)), fmt)
    assert (t.format, t.group_size, t.orig_in) == (j.format, j.group_size, j.orig_in)
    assert np.array_equal(_t(_bits(j.q)), _port_bits(t.q))
    assert np.array_equal(_t(j.scale), t.scale.numpy())
    assert (j.bias is None) == (t.bias is None)
    if j.bias is not None:
        assert np.array_equal(_t(j.bias), t.bias.numpy())
    assert np.array_equal(_t(jq.dequantize(j, jnp.float32)), tq.dequantize(t, torch.float32).numpy())


@pytest.mark.parametrize("shape", [(1024, 256), (2, 512, 768)], ids=["2d", "stacked"])
def test_runtime_formats_equal_jax(shape):
    w = _weight(shape, seed=7)
    tw = torch.from_numpy(_t(w))
    j8, t8 = jq.to_w8a8(jnp.asarray(w)), tq.to_w8a8(tw)
    assert np.array_equal(_t(j8.q), t8.q.numpy())
    assert np.array_equal(np.asarray(j8.scale)[..., 0, :], t8.scale.numpy())
    assert np.array_equal(_t(jq.dequantize_w8a8(j8, jnp.float32)), tq.dequantize_w8a8(t8, torch.float32).numpy())
    j4, t4 = jq.to_w4a8(jnp.asarray(w)), tq.to_w4a8(tw)
    assert (t4.block, t4.orig_in) == (j4.block, j4.orig_in)
    assert np.array_equal(_t(j4.q), t4.q.numpy())
    assert np.array_equal(_t(j4.scale), t4.scale.numpy())
    assert np.array_equal(_t(jq.dequantize_w4a8(j4, jnp.float32)), tq.dequantize_w4a8(t4, torch.float32).numpy())


@pytest.mark.parametrize("stored", ["qint8", "int4"])
def test_runtime_formats_from_stored_qtensor_equal_jax(stored):
    w = _weight((1024, 512), seed=9)
    jw, tw = jq.quantize(jnp.asarray(w), stored), tq.quantize(torch.from_numpy(_t(w)), stored)
    j8, t8 = jq.to_w8a8(jw), tq.to_w8a8(tw)
    assert np.array_equal(_t(j8.q), t8.q.numpy())
    assert np.array_equal(np.asarray(j8.scale)[0], t8.scale.numpy())
    j4, t4 = jq.to_w4a8(jw), tq.to_w4a8(tw)
    assert np.array_equal(_t(j4.q), t4.q.numpy()) and np.array_equal(_t(j4.scale), t4.scale.numpy())


def test_w4a8_keeps_a_k_that_does_not_tile_dense():
    w = torch.from_numpy(_t(_weight((768, 256), seed=3)))
    assert tq.to_w4a8(w) is w
    stored = tq.quantize(w, "qint8")
    assert torch.equal(tq.to_w4a8(stored), tq.dequantize(stored, torch.bfloat16))


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _mm_inputs(m, k, n, seed):
    rng = np.random.RandomState(seed)
    return rng.randn(m, k).astype(np.float32), (rng.randn(k, n) / np.sqrt(k)).astype(np.float32)


def _x_pair(x, dtype):
    """The same activations for JAX and the port, in f32 or rounded to bf16."""
    jx = jnp.asarray(x).astype(dtype)
    tx = torch.from_numpy(np.asarray(jx.astype(jnp.float32)))
    return jx, tx.to(torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32)


MM_TOL = {jnp.float32: 1e-6, jnp.bfloat16: 1e-3}


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("m,k,n", [(24, 1024, 256), (16, 512, 2560), (3, 1536, 512)])
def test_w8a8_reference_matches_jax_kernel(m, k, n, dtype):
    x, w = _mm_inputs(m, k, n, seed=m + k)
    jx, tx = _x_pair(x, dtype)
    jw, tw = jq.to_w8a8(jnp.asarray(w)), tq.to_w8a8(torch.from_numpy(_t(w)))
    assert jqk.w8a8_supported(jx, jw) and tqk.w8a8_supported(tx, tw)
    ref = jqk.w8a8_matmul(jx, jw, interpret=True)
    out = tqk.w8a8_matmul(tx, tw)  # a CPU tensor: the plain version
    assert out.dtype == tx.dtype and out.shape == (m, n)
    assert _rel(out.float(), ref.astype(jnp.float32)) <= MM_TOL[dtype]


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("m,k,n", [(24, 1024, 256), (16, 1024, 2560), (3, 1536, 512)])
def test_w4a8_reference_matches_jax_kernel(m, k, n, dtype):
    x, w = _mm_inputs(m, k, n, seed=m + k + 1)
    jx, tx = _x_pair(x, dtype)
    jw, tw = jq.to_w4a8(jnp.asarray(w)), tq.to_w4a8(torch.from_numpy(_t(w)))
    assert jqk.w4a8_supported(jx, jw) and tqk.w4a8_supported(tx, tw)
    ref = jqk.w4a8_matmul(jx, jw, interpret=True)
    out = tqk.w4a8_matmul(tx, tw)
    assert _rel(out.float(), ref.astype(jnp.float32)) <= MM_TOL[dtype]


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("fmt", ["qint8", "int4"])
@pytest.mark.parametrize("m,k,n", [(24, 1024, 256), (16, 512, 640)])
def test_dequant_reference_matches_jax_kernel(m, k, n, fmt, dtype):
    x, w = _mm_inputs(m, k, n, seed=m + k + 2)
    jx, tx = _x_pair(x, dtype)
    jw, tw = jq.quantize(jnp.asarray(w), fmt), tq.quantize(torch.from_numpy(_t(w)), fmt)
    assert jqk.supported(jx, jw) and tqk.supported(tx, tw)
    ref = jqk.dequant_matmul(jx, jw, interpret=True)
    out = tqk.dequant_matmul(tx, tw)
    assert _rel(out.float(), ref.astype(jnp.float32)) <= MM_TOL[dtype]


def test_gates_match_jax():
    """The three shape gates agree with JAX's on the [N, K] layout, M, K and N alike."""
    for m, k, n in [(1, 3072, 18432), (7, 512, 640), (8, 512, 640), (8, 2560, 640), (4, 128, 3072),
                    (4096, 3072, 128), (16, 768, 512), (512, 7680, 3072)]:
        x = np.zeros((m, k), np.float32)
        w = np.zeros((k, n), np.float32)
        jx, tx = jnp.asarray(x), torch.from_numpy(x)
        tw = torch.from_numpy(_t(w))
        assert tqk.w8a8_supported(tx, tq.to_w8a8(tw)) == jqk.w8a8_supported(jx, jq.to_w8a8(jnp.asarray(w)))
        if k % 512 == 0:
            assert tqk.w4a8_supported(tx, tq.to_w4a8(tw)) == jqk.w4a8_supported(jx, jq.to_w4a8(jnp.asarray(w)))
        if k % 64 == 0:
            assert tqk.supported(tx, tq.quantize(tw, "qint8")) == jqk.supported(jx, jq.quantize(jnp.asarray(w), "qint8"))


def test_wrappers_take_their_plain_version_on_the_cpu():
    x, w = _mm_inputs(8, 512, 256, seed=5)
    tx, tw = torch.from_numpy(x), torch.from_numpy(_t(w))
    before = dict(tqk.launches)
    w8, w4, q8 = tq.to_w8a8(tw), tq.to_w4a8(tw), tq.quantize(tw, "int4")
    assert torch.equal(tqk.w8a8_matmul(tx, w8), tqk.w8a8_matmul_reference(tx, w8))
    assert torch.equal(tqk.w4a8_matmul(tx, w4), tqk.w4a8_matmul_reference(tx, w4))
    assert torch.equal(tqk.dequant_matmul(tx, q8), tqk.dequant_matmul_reference(tx, q8))
    assert tqk.launches == before  # the plain versions count no launch


# ---------------------------------------------------------------------------
# quantize_params: the same leaves as JAX, name for name
# ---------------------------------------------------------------------------


def _jax_quantized_names(params, config) -> dict:
    """{port name: format} of the quantized leaves of a JAX DiT pytree."""
    top = {("x_embedder", "kernel"): "x_embedder", ("context_embedder", "kernel"): "context_embedder",
           ("time_embed", "linear1"): "time_linear1", ("time_embed", "linear2"): "time_linear2",
           ("guidance_embed", "linear1"): "guidance_linear1", ("guidance_embed", "linear2"): "guidance_linear2",
           ("double_mod_img", "kernel"): "double_mod_img", ("double_mod_txt", "kernel"): "double_mod_txt",
           ("single_mod", "kernel"): "single_mod", ("norm_out", "kernel"): "norm_out",
           ("proj_out", "kernel"): "proj_out"}
    layers = {"double_blocks": config.num_layers, "single_blocks": config.num_single_layers}
    out = {}
    leaves, _ = jax.tree_util.tree_flatten_with_path(params, is_leaf=jq.is_quantized)
    for path, leaf in leaves:
        if not jq.is_quantized(leaf):
            continue
        keys = tuple(p.key for p in path)
        fmt = getattr(leaf, "format", "w8a8" if isinstance(leaf, jq.W8A8Tensor) else "w4a8")
        if keys[0] in layers:
            out.update({f"{keys[0]}.{i}.{keys[1]}": fmt for i in range(layers[keys[0]])})
        else:
            out[top[keys]] = fmt
    return out


@pytest.mark.parametrize("fmt", ["w8a8", "w4a8", "qint8"])
@pytest.mark.parametrize("config,min_size", [(TINY_TEST, 1 << 16), (KLEIN_SLICE, 1 << 16), (TINY, 100_000)],
                         ids=["tiny_test", "klein_slice", "stacked_size_only"])
def test_quantized_leaf_set_equals_jax(config, min_size, fmt):
    """With TINY at min_size 100000 a block's [256, 256] weight (65536) is below
    the limit and only the stacked [L, 256, 256] leaf reaches it."""
    params = jtfm.init_params(jax.random.PRNGKey(0), jax_config(config), dtype=jnp.float32)
    jnames = _jax_quantized_names(jq.quantize_params(params, fmt, min_size=min_size), config)
    model = ttfm.Flux2Transformer(config, device="meta", dtype=torch.float32)
    tnames = tq.quantized_names(tq.quantize_params(model, fmt, min_size=min_size))
    assert tnames == jnames
    assert "norm_out" not in tnames  # named "norm": stays dense
    if config is TINY and fmt != "w4a8":  # TINY has no K % 512 block weight
        assert any(name.startswith("double_blocks.") for name in tnames)


@pytest.mark.parametrize("stored,runtime", [("qint8", "w8a8"), ("int4", "w4a8")])
def test_runtime_conversion_of_stored_weights_equals_jax(stored, runtime):
    """``quantize_params(.., "w8a8" / "w4a8")`` converts QTensor leaves, as JAX's
    ``w8a8_params`` / ``w4a8_params`` do for a prequantized checkpoint."""
    dense = perturbed_numpy(jtfm.init_params(jax.random.PRNGKey(6), jax_config(KLEIN_SLICE), dtype=jnp.float32), 6)
    jstored = jq.quantize_params(jax.tree_util.tree_map(jnp.asarray, dense), stored)
    jruntime = jq.quantize_params(jstored, runtime)
    model = tq.quantize_params(transformer_from_jax(jstored, KLEIN_SLICE), runtime)
    carried = transformer_from_jax(jruntime, KLEIN_SLICE)
    assert tq.quantized_names(model) == tq.quantized_names(carried) == _jax_quantized_names(jruntime, KLEIN_SLICE)
    for name in tq.quantized_names(model):
        for a, b in zip(model.get_submodule(name).buffers(), carried.get_submodule(name).buffers()):
            assert torch.equal(a, b), name
    for name, p in model.named_parameters():  # stored leaves that w4a8 cannot tile come back dense
        assert torch.equal(p, carried.get_parameter(name)), name


# ---------------------------------------------------------------------------
# The DiT on a JAX-quantized pytree
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fmt,config", [("w8a8", TINY), ("qint8", TINY), ("int4", TINY), ("nf4", TINY),
                                        ("mxfp8", TINY), ("w4a8", KLEIN_SLICE)])
def test_forward_on_jax_quantized_params_matches_jax(fmt, config):
    seed = 11
    dense = perturbed_numpy(jtfm.init_params(jax.random.PRNGKey(seed), jax_config(config), dtype=jnp.float32), seed)
    qparams = jq.quantize_params(jax.tree_util.tree_map(jnp.asarray, dense), fmt)
    model = transformer_from_jax(qparams, config)
    assert tq.quantized_names(model) == _jax_quantized_names(qparams, config) != {}

    # the carried codes are the port's own quantization of the carried dense weights
    own = tq.quantize_params(transformer_from_jax(dense, config), fmt)
    for name in tq.quantized_names(model):
        carried, mine = model.get_submodule(name), own.get_submodule(name)
        for (bname, a), (_, b) in zip(carried.named_buffers(), mine.named_buffers()):
            assert a.dtype == b.dtype and torch.equal(_bits_t(a), _bits_t(b)), (name, bname)

    rng = np.random.RandomState(seed + 1)
    h, w, s_txt = 4, 4, 6
    lat = rng.randn(2, h * w, config.in_channels).astype(np.float32)
    txt = rng.randn(2, s_txt, config.joint_attention_dim).astype(np.float32) * 0.2
    sigma = np.array([0.7, 0.25], np.float32)
    guid = np.array([4.0, 3.0], np.float32) if config.guidance_embeds else None
    ids = np.concatenate([jlu.text_position_ids(s_txt), jlu.image_position_ids(16 * h, 16 * w)])
    cos, sin = rope_embeddings(jnp.asarray(ids))
    ref = jtfm.forward(qparams, jax_config(config), jnp.asarray(lat), jnp.asarray(txt), jnp.asarray(sigma), cos, sin,
                       guidance=jnp.asarray(guid) if guid is not None else None)
    with torch.inference_mode():
        out = model(torch.from_numpy(lat), torch.from_numpy(txt), torch.from_numpy(sigma),
                    torch.from_numpy(np.asarray(cos)), torch.from_numpy(np.asarray(sin)),
                    guidance=torch.from_numpy(guid) if guid is not None else None)
    assert out.dtype == torch.float32
    err = np.max(np.abs(out.numpy() - np.asarray(ref)))
    assert err <= FORWARD_TOL, f"max |diff| = {err}"


def _bits_t(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.uint8) if t.dtype == torch.float8_e4m3fn else t


def test_param_bytes_and_dequantize_params_match_jax():
    dense = jtfm.init_params(jax.random.PRNGKey(2), jax_config(TINY), dtype=jnp.float32)
    qparams = jq.quantize_params(dense, "qint8")
    model = transformer_from_jax(qparams, TINY)
    assert tq.param_bytes(model) == jq.param_bytes(qparams)
    back = jq.dequantize_params(qparams, jnp.float32)
    tq.dequantize_params(model, torch.float32)
    assert tq.quantized_names(model) == {}
    np.testing.assert_array_equal(model.double_blocks[1].ff_in.detach().numpy(),
                                  _t(np.asarray(back["double_blocks"]["ff_in"])[1]))


# ---------------------------------------------------------------------------
# Kernel routes of the full-width models, by the gates alone
# ---------------------------------------------------------------------------


def _routes(monkeypatch, module, run) -> collections.Counter:
    """Run ``run()`` with ``module``'s ``q_linear`` recording the route of each quantized matmul."""
    routes = collections.Counter()
    real = tq.q_linear

    def recording(x, w):
        if tq.is_quantized(w):
            routes[tq.kernel_route(x, w)] += 1
        return real(x, w)

    monkeypatch.setattr(module, "q_linear", recording)
    with torch.inference_mode():
        run()
    return routes


@pytest.mark.parametrize("fmt,pallas_dequant,expected", [
    ("w8a8", False, {"w8a8": 206, None: 2}),  # x_embedder (K=128), proj_out (N=128)
    ("w4a8", False, {"w4a8": 205, None: 1}),  # proj_out; x_embedder and time_linear1 (K % 512) stay dense
    ("qint8", True, {"dequant": 202, None: 6}),  # x_embedder, time_linear1 (K % 512); time_linear2 and mods (M < 8)
    ("int4", True, {"dequant": 202, None: 6}),
    ("qint8", False, {None: 208}),  # without FLUX2_PALLAS_DEQUANT every matmul dequantizes
])
def test_klein4b_forward_routes(monkeypatch, fmt, pallas_dequant, expected):
    if pallas_dequant:
        monkeypatch.setenv("FLUX2_PALLAS_DEQUANT", "1")
    else:
        monkeypatch.delenv("FLUX2_PALLAS_DEQUANT", raising=False)
    model = tq.quantize_params(ttfm.Flux2Transformer(KLEIN_4B, device="meta"), fmt)
    s_img, s_txt = 4096, 512  # 1024^2, bs=1
    hd = KLEIN_4B.attention_head_dim

    def run():
        model(torch.empty(1, s_img, 128, device="meta", dtype=torch.bfloat16),
              torch.empty(1, s_txt, KLEIN_4B.joint_attention_dim, device="meta", dtype=torch.bfloat16),
              torch.empty(1, device="meta"), torch.empty(s_txt + s_img, hd, device="meta"),
              torch.empty(s_txt + s_img, hd, device="meta"))

    assert dict(_routes(monkeypatch, ttfm, run)) == expected


def test_qwen3_4b_encode_routes(monkeypatch):
    """36 layers x (q, o, gate, up, down) on K5; k_proj and v_proj (N = 640) dequantize."""
    decoder = quantize_encoder_params(tdec.Qwen3Decoder(QWEN3_4B, device="meta"), "w8a8")
    assert isinstance(decoder.embed_tokens, torch.nn.Parameter)  # the embedding table stays dense
    ids = torch.zeros(1, 512, dtype=torch.long, device="meta")
    mask = torch.ones(1, 512, dtype=torch.int32, device="meta")
    routes = _routes(monkeypatch, tdec, lambda: decoder.forward_hidden_states(ids, mask))
    assert dict(routes) == {"w8a8": 180, None: 72}
