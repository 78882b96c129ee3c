"""The port's mesh and sharding (``flux2_tpu_torch/parallel/``) against JAX's
``tests/test_parallel.py``: eight torch ranks joined by gloo on the CPU
(``tests/torch_rank_pool.py``, one pool for the file), JAX's references on
its eight virtual devices in this process.

Placements are compared per logical dimension (K, N) with JAX's
``make_shardings``: the port's weights are [out, in] per block where JAX's
are stacked [L, in, out]. JAX's three ahead-of-time fit proofs become
per-rank parameter bytes from ``sharding.local_shape`` on ``meta`` tensors,
under JAX's own bounds.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flux2_tpu.models.flux2 import config as jcfg
from flux2_tpu.models.flux2 import transformer as jtfm
from flux2_tpu.models.text_encoders import config as jtcfg
from flux2_tpu.models.text_encoders import decoder as jdec
from flux2_tpu.ops import latents as jlu
from flux2_tpu.ops import quant as jquant
from flux2_tpu.ops.rope import rope_embeddings
from flux2_tpu.parallel import mesh as jmesh
from flux2_tpu.parallel import sharding as jsh
from flux2_tpu_torch.io.jax_params import decoder_from_jax, transformer_from_jax
from flux2_tpu_torch.models.flux2.config import FLUX2_DEV, Flux2TransformerConfig
from flux2_tpu_torch.models.flux2.transformer import Flux2Transformer
from flux2_tpu_torch.models.text_encoders.config import MISTRAL_SMALL_3_2, DecoderConfig
from flux2_tpu_torch.models.text_encoders.decoder import Qwen3Decoder
from flux2_tpu_torch.models.text_encoders.extractor import quantize_encoder_params
from flux2_tpu_torch.ops import quant as tquant
from flux2_tpu_torch.parallel import sharding as tsh

from tests.test_torch_transformer import perturbed_numpy
from tests.torch_rank_pool import RankPool

CASES = "tests.torch_parallel_cases"
# JAX's tests/test_parallel.py configuration: 4 heads of 128, joint 384
CFG = dict(num_layers=1, num_single_layers=2, num_attention_heads=4, attention_head_dim=128,
           joint_attention_dim=384, guidance_embeds=False)
MESH_SHAPE = {"data": 1, "fsdp": 2, "tp": 4, "sp": 1}


@pytest.fixture(scope="module")
def pool():
    p = RankPool(8)
    yield p
    p.close()


def _spec(named_sharding) -> tuple:
    return tuple(named_sharding.spec)


def _jax_leaves(tree, shardings):
    """{JAX path: (leaf, spec)} over the tree's leaves (quantized children by flat index)."""
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    shard = jax.tree_util.tree_leaves(shardings)
    return {jsh._path_str(path): (leaf, _spec(s)) for (path, leaf), s in zip(flat, shard)}


def _logical(spec: tuple, ndim: int, stacked: bool, transposed: bool) -> tuple:
    """JAX's spec of a leaf as the port's per-dimension spec: the stacked axis
    dropped, [in, out] reversed to [out, in]."""
    spec = tuple(spec) + (None,) * (ndim - len(spec))
    if stacked:
        spec = spec[1:]
    return spec[::-1] if transposed else spec


def _dit_jax_params(config_kw=CFG, seed=0):
    return perturbed_numpy(jtfm.init_params(jax.random.PRNGKey(seed), jcfg.Flux2TransformerConfig(**config_kw),
                                            dtype=jnp.float32), seed)


def _dit_inputs(h=64, w=64, s_txt=8, joint=384, seed=1):
    rng = np.random.RandomState(seed)
    ids = np.concatenate([jlu.text_position_ids(s_txt), jlu.image_position_ids(h, w)], axis=0)
    cos, sin = (np.asarray(a) for a in rope_embeddings(jnp.asarray(ids)))
    return {"hidden": rng.randn(1, (h // 16) * (w // 16), 128).astype(np.float32),
            "txt": rng.randn(1, s_txt, joint).astype(np.float32), "t": np.array([0.5], np.float32),
            "cos": cos, "sin": sin}


def _jax_forward(params, inputs, config_kw=CFG):
    return np.asarray(jtfm.forward(jax.tree_util.tree_map(jnp.asarray, params), jcfg.Flux2TransformerConfig(
        **config_kw), inputs["hidden"], inputs["txt"], inputs["t"], inputs["cos"], inputs["sin"]))


def _jax_quantized_forward(params, inputs, fmt: str, config_kw=CFG):
    """JAX's unsharded forward on its W8A8 / W4A8 / qint8 tree (min_size 1 << 10, as its tests), jitted."""
    quantize = {"w8a8": jquant.w8a8_params, "w4a8": jquant.w4a8_params,
                "qint8": lambda p, min_size: jquant.quantize_params(p, "qint8", min_size=min_size)}[fmt]
    config = jcfg.Flux2TransformerConfig(**config_kw)
    jp = quantize(jax.tree_util.tree_map(jnp.asarray, params), min_size=1 << 10)
    fwd = jax.jit(lambda p, x, e: jtfm.forward(p, config, x, e, inputs["t"], inputs["cos"], inputs["sin"]))
    return np.asarray(fwd(jp, inputs["hidden"], inputs["txt"]))


# -- the mesh --------------------------------------------------------------------------


def test_make_mesh_shapes(pool):
    """Shapes and the -1 sizing equal JAX's on eight devices, and so do the error texts."""
    got = [{k: v for k, v in g.items() if k != "single"} for g in pool.run(f"{CASES}:mesh_shapes")]
    assert all(g == got[0] for g in got)
    got = got[0]
    assert got["2,2,2"] == dict(jmesh.make_mesh(data=2, fsdp=2, tp=2).shape)
    assert got["tp=-1"] == dict(jmesh.make_mesh(data=1, fsdp=1, tp=-1).shape) == \
        {"data": 1, "fsdp": 1, "tp": 8, "sp": 1}
    assert got["sp=4"] == dict(jmesh.make_mesh(data=1, fsdp=1, tp=2, sp=4).shape)
    assert got["best"] == dict(jmesh.best_mesh_for_inference().shape)
    errors = []
    for kw in ({"data": 3, "fsdp": 1, "tp": 1}, {"data": -1, "fsdp": -1}, {"data": 3, "fsdp": 1, "tp": -1},
               {"data": 1, "fsdp": 1, "tp": 16}):
        with pytest.raises(ValueError) as e:
            jmesh.make_mesh(**kw)
        errors.append(str(e.value))
    assert got["errors"] == errors


def test_single_device_mesh(pool):
    shape, ranks = pool.run(f"{CASES}:mesh_shapes")[3]["single"]
    assert shape == dict(jmesh.single_device_mesh().shape) == {"data": 1, "fsdp": 1, "tp": 1, "sp": 1}
    assert ranks == [3]  # this rank


def test_multislice_mesh_layout(pool):
    """data over two contiguous groups of ranks (JAX's virtual branch: no slice_index), fsdp/tp inside;
    JAX's error texts. Its train step is pipeline-parallel training's (not ported)."""
    got = pool.run(f"{CASES}:multislice_layout")[0]
    jm = jmesh.make_multislice_mesh(num_slices=2, fsdp=2, tp=2, sp=1)
    assert got["shape"] == dict(jm.shape) == {"data": 2, "fsdp": 2, "tp": 2, "sp": 1}
    assert got["ranks"] == np.vectorize(lambda d: d.id)(jm.devices).tolist()
    first, second = np.array(got["ranks"][0]).ravel(), np.array(got["ranks"][1]).ravel()
    assert first.max() < second.min()
    errors = []
    for args in ((3,), (2, 3, 1, 1)):
        with pytest.raises(ValueError) as e:
            jmesh.make_multislice_mesh(*args)
        errors.append(str(e.value))
    assert got["errors"] == errors


# -- the rules ---------------------------------------------------------------------------


@pytest.mark.parametrize("fmt", ["bf16", "w8a8", "w4a8", "qint8"])
def test_dit_param_sharding_resolves(fmt):
    """Every leaf of the port's DiT gets, per logical dimension, the mesh axis
    JAX's ``make_shardings`` gives its stacked [L, in, out] leaf: dense and
    each quantized format's codes and scales (the W8A8 scale's size-1 row axis
    dropped, the tp axis kept), at fsdp=2, tp=4."""
    kw = dict(CFG, joint_attention_dim=512)  # W4A8 wants K % 512
    quantize = {"bf16": lambda p: p, "w8a8": lambda p: jquant.w8a8_params(p, min_size=1 << 10),
                "w4a8": lambda p: jquant.w4a8_params(p, min_size=1 << 10),
                "qint8": lambda p: jquant.quantize_params(p, "qint8", min_size=1 << 10)}[fmt]
    # shapes only, both sides: JAX's tree from eval_shape, the port's on the meta device
    jp = jax.eval_shape(lambda k: quantize(jtfm.init_params(k, jcfg.Flux2TransformerConfig(**kw), dtype=jnp.float32)),
                        jax.random.PRNGKey(0))
    mesh = jmesh.make_mesh(data=1, fsdp=2, tp=4)
    jleaves = _jax_leaves(jp, jsh.make_shardings(jp, mesh, jsh.DIT_RULES))

    port = Flux2Transformer(Flux2TransformerConfig(**kw), device="meta", dtype=torch.float32)
    if fmt != "bf16":
        tquant.quantize_params(port, fmt, min_size=1 << 10)
    specs = tsh.make_shardings(port, MESH_SHAPE, tsh.DIT_RULES)
    children = {"q": 0, "scale": 1, "bias": 2}
    checked = 0
    for owner, attr, name, t, path, stacked, transposed in tsh._leaves(port):
        if tquant.is_quantized(owner):
            jpath = f"{path}/[<flat index {children[attr]}>]"
        else:
            jpath = path
        leaf, jspec = jleaves[jpath]
        want = _logical(jspec, leaf.ndim, stacked, transposed)[: t.ndim]
        assert specs[name] == want, (name, jpath, jspec)
        checked += 1
    assert checked == len(specs)
    if fmt == "w8a8":  # JAX's own assertions on the port's leaves
        assert specs["double_blocks.0.to_q.q"] == ("tp", "fsdp")
        assert specs["double_blocks.0.to_q.scale"] == ("tp",)
    if fmt == "bf16":
        assert specs["double_blocks.0.to_q"] == ("tp", "fsdp")
        assert specs["double_blocks.0.to_out"] == ("fsdp", "tp")
        assert specs["single_blocks.0.out_mlp"] == ("fsdp", "tp")
        assert specs["double_blocks.0.norm_q"] == (None,)


def test_dit_shard_params_places_as_resolved(pool):
    """``shard_params`` on every rank: each leaf a DTensor with the resolved
    spec's placements on the mesh's axes larger than one (fsdp, tp)."""
    params = _dit_jax_params()
    got = pool.run(f"{CASES}:dit_placements", params, CFG, (1, 2, 4, 1), "w8a8")[0]
    port = transformer_from_jax(params, Flux2TransformerConfig(**CFG))
    tquant.quantize_params(port, "w8a8", min_size=1 << 10)
    specs = tsh.make_shardings(port, MESH_SHAPE, tsh.DIT_RULES)
    assert set(got) == set(specs)
    for name, spec in specs.items():
        want = [f"S({spec.index(a)})" if a in spec else "R" for a in ("fsdp", "tp")]
        assert [p.replace("Shard(dim=", "S(").replace("Replicate()", "R") for p in got[name]] == want, name


def test_indivisible_dims_fall_back_to_replication():
    """JAX's case: a stacked to_q of [2, 6, 10] at tp=8 (10 % 8 != 0) keeps its N whole; the port's [10, 6]."""
    jspec = jsh.make_shardings({"double_blocks": {"to_q": jnp.zeros((2, 6, 10))}},
                               jmesh.make_mesh(data=1, fsdp=1, tp=8), jsh.DIT_RULES)["double_blocks"]["to_q"].spec
    assert jspec[-1] is None
    spec = tsh.resolve_spec((10, 6), "double_blocks/to_q", True, True, {"data": 1, "fsdp": 1, "tp": 8, "sp": 1},
                            tsh.DIT_RULES)
    assert spec == _logical(tuple(jspec), 3, True, True) == (None, "fsdp")  # N whole; K over fsdp (size 1)


def test_decoder_sharding_rules():
    """DECODER_RULES on the tiny decoder, per logical dimension, against JAX's (embed_tokens unreversed)."""
    params = jdec.init_params(jax.random.PRNGKey(0), jtcfg.TINY_DECODER, dtype=jnp.float32)
    jleaves = _jax_leaves(params, jsh.make_shardings(params, jmesh.make_mesh(data=1, fsdp=2, tp=4),
                                                     jsh.DECODER_RULES))
    port = decoder_from_jax(jax.tree_util.tree_map(np.asarray, params),
                            DecoderConfig(**dataclasses.asdict(jtcfg.TINY_DECODER)))
    specs = tsh.make_shardings(port, MESH_SHAPE, tsh.DECODER_RULES)
    for owner, attr, name, t, path, stacked, transposed in tsh._leaves(port):
        leaf, jspec = jleaves[path]
        assert specs[name] == _logical(jspec, leaf.ndim, stacked, transposed), name
    assert specs["layers.0.q_proj"] == ("tp", "fsdp") and specs["layers.0.o_proj"] == ("fsdp", "tp")
    assert specs["layers.0.input_norm"] == (None,)
    assert specs["embed_tokens"] == ("tp", "fsdp")


# -- sharded forwards against JAX -----------------------------------------------------------


def test_sharded_forward_matches_single_device(pool):
    """The DiT sharded over (fsdp=2, tp=4) on eight ranks == JAX's single-device forward (atol 2e-3, JAX's)."""
    params, inputs = _dit_jax_params(), _dit_inputs()
    ref = _jax_forward(params, inputs)
    outs = pool.run(f"{CASES}:dit_forward", params, CFG, inputs, (1, 2, 4, 1))
    for out in outs:
        np.testing.assert_allclose(out["value"], ref, atol=2e-3, rtol=0)


def test_lora_train_step_on_the_sharded_dit_matches_dense(pool):
    """``train-lora --shard``'s step (the LoRA unmerged on the DiT sharded over fsdp=2 x tp=4, its adapters
    replicated on the DiT's mesh) on eight ranks against the unsharded step from the same seeds: the loss (rtol
    1e-5) and every adapter's gradient (within 1e-4 of its largest entry, f32 sums in another order), the same on
    every rank. Without the sum of the column-parallel input's cotangents over the ranks (``_SumGrads``) it
    fails."""
    params, inputs = _dit_jax_params(), _dit_inputs()
    for r in pool.run(f"{CASES}:dit_train_step", params, CFG, inputs, (1, 2, 4, 1)):
        np.testing.assert_allclose(r["sharded"]["loss"], r["dense"]["loss"], rtol=1e-5)
        for name, g in r["dense"]["grads"].items():
            assert np.any(g) or name.endswith(".a"), name
            np.testing.assert_allclose(r["sharded"]["grads"][name], g, rtol=0, atol=1e-4 * max(np.abs(g).max(), 1e-30),
                                       err_msg=name)


@pytest.mark.parametrize("kw", [
    dict(vocab_size=256, hidden_size=128, intermediate_size=256, num_hidden_layers=2, num_attention_heads=8,
         num_key_value_heads=4, head_dim=16, qk_norm=True, tie_word_embeddings=True),
    # k_proj / v_proj (N = 6) stay whole at tp=4 while q_proj splits one head a rank: each local query
    # head must still read KV head (global head) // 4
    dict(vocab_size=64, hidden_size=32, intermediate_size=64, num_hidden_layers=2, num_attention_heads=4,
         num_key_value_heads=1, head_dim=6, qk_norm=True, tie_word_embeddings=True),
], ids=["jax_config", "kv_heads_replicated"])
def test_sharded_decoder_forward_matches(pool, kw):
    """The decoder sharded over (fsdp=2, tp=4), vocab-parallel embedding included, == JAX's unsharded
    ``forward_hidden_states`` (atol 2e-4, JAX's)."""
    cfg_d = jtcfg.DecoderConfig(**kw)
    params = perturbed_numpy(jdec.init_params(jax.random.PRNGKey(0), cfg_d, dtype=jnp.float32), 0)
    ids = np.array([[1, 2, 3, 4]], np.int32)
    ref = np.asarray(jdec.forward_hidden_states(jax.tree_util.tree_map(jnp.asarray, params), cfg_d, ids,
                                                np.ones_like(ids)))
    outs = pool.run(f"{CASES}:decoder_hidden_states", params, dataclasses.asdict(cfg_d), ids.astype(np.int64),
                    (1, 2, 4, 1))
    for out in outs:
        np.testing.assert_allclose(out["value"], ref, atol=2e-4, rtol=0)


def test_quantized_params_shard_over_mesh(pool):
    """A W8A8 DiT sharded over (fsdp=2, tp=4) == JAX's unsharded W8A8 forward (atol 3e-4, JAX's)."""
    params, inputs = _dit_jax_params(), _dit_inputs(256, 256, 16)
    ref = _jax_quantized_forward(params, inputs, "w8a8")
    outs = pool.run(f"{CASES}:dit_forward", params, CFG, inputs, (1, 2, 4, 1), None, "w8a8")
    for out in outs:
        np.testing.assert_allclose(out["value"], ref, atol=3e-4, rtol=0)


def test_stored_qtensor_weights_are_gathered_whole(pool):
    """A qint8 DiT (K7's format, which no partition rule covers) sharded over (fsdp=2, tp=4): each weight
    is gathered whole on every rank (the replicated body, as XLA does around an opaque call), and the
    forward == JAX's unsharded qint8 forward (atol 3e-4, as the W8A8 case)."""
    params, inputs = _dit_jax_params(), _dit_inputs(256, 256, 16)
    ref = _jax_quantized_forward(params, inputs, "qint8")
    outs = pool.run(f"{CASES}:dit_forward", params, CFG, inputs, (1, 2, 4, 1), None, "qint8")
    for out in outs:
        np.testing.assert_allclose(out["value"], ref, atol=3e-4, rtol=0)


# -- the pipeline and the facade ---------------------------------------------------------------


def _assert_generation_close(out, ref):
    """JAX's ``_assert_generation_close``: latents 1e-4; the image 0.06, mean 0.01 (the tiny VAE's
    GroupNorms amplify latent noise)."""
    np.testing.assert_allclose(out["latents"], ref.latents, atol=1e-4, rtol=0)
    np.testing.assert_allclose(out["image"], ref.image, atol=0.06, rtol=0)
    assert np.abs(out["image"] - ref.image).mean() < 0.01


def pipeline_case(model=jcfg.Flux2Model.KLEIN_4B, steps=2, reference=None):
    """(JAX's tiny pipeline's unsharded result, the arguments of ``pipeline_generate``): JAX's
    ``_emb(pipe, s_txt=8)``, seed 7 (its noise handed to the port), 64^2."""
    from flux2_tpu.pipeline.pipeline import _seeded_noise_seq

    from tests.test_torch_i2i import tiny_pipelines

    jpipe = dataclasses.replace(tiny_pipelines()[0], model=model)
    emb = np.asarray(jax.random.normal(jax.random.PRNGKey(3), (1, 8, 96)))
    kw = {}
    if reference is not None:
        kw["reference_latents"], kw["reference_ids"] = jpipe.encode_reference_images([reference])
    ref = jpipe.generate(embeddings=jnp.asarray(emb), height=64, width=64, num_steps=steps, seed=7, **kw)
    gen = dict(embeddings=emb, height=64, width=64, num_steps=steps, noise=np.array(_seeded_noise_seq(7, 64, 64, 1)))
    args = (jax.tree_util.tree_map(np.asarray, jpipe.transformer_params),
            jax.tree_util.tree_map(np.asarray, jpipe.vae_params), model.value,
            dataclasses.asdict(jpipe.transformer_config), dataclasses.asdict(jpipe.vae_config), gen)
    return ref, args


def test_sharded_pipeline_generate(pool):
    """``Flux2Pipeline.shard`` over (fsdp=2, tp=4): generate == JAX's unsharded generate."""
    ref, args = pipeline_case()
    outs = pool.run(f"{CASES}:pipeline_generate", *args, (1, 2, 4, 1))
    for out in outs:
        assert out["ring"] is None
        _assert_generation_close(out, ref)


def test_facade_shard_encoder(pool):
    """After ``tests/test_facade_serve.py::test_facade_shard_encoder``: a tiny Qwen3 attached to the
    facade, sharded over (fsdp=2, tp=4): the Klein embeddings within 2e-4 of the unsharded ones and of
    JAX's facade on the same weights."""
    from flux2_tpu.models.text_encoders import facade as jfacade

    from tests.torch_parallel_cases import VOCAB, WordTokenizer

    cfg_d = dataclasses.replace(jtcfg.TINY_DECODER, num_hidden_layers=4)
    params = perturbed_numpy(jdec.init_params(jax.random.PRNGKey(0), cfg_d, dtype=jnp.float32), 0)
    enc = jfacade.TextEncoders()
    enc.attach("tiny", jax.tree_util.tree_map(jnp.asarray, params), cfg_d, WordTokenizer(VOCAB), (1, 2, 3),
               recipe="klein")
    ref = np.asarray(enc.extract_klein_embeddings("a cat", name="tiny"))
    outs = pool.run(f"{CASES}:facade_shard_encoder", params, dataclasses.asdict(cfg_d), "a cat", (1, 2, 3),
                    (1, 2, 4, 1))
    for out in outs:
        np.testing.assert_allclose(out["after"], out["before"], atol=2e-4, rtol=0)
        np.testing.assert_allclose(out["after"], ref, atol=2e-4, rtol=0)


# -- fit proofs: per-rank parameter bytes from the shard shapes -----------------------------


def _rank_bytes(module, rules, tp: int) -> int:
    mesh_shape = {"data": 1, "fsdp": 1, "tp": tp, "sp": 1}
    specs = tsh.make_shardings(module, mesh_shape, rules)
    tensors = dict(module.named_parameters())
    tensors.update(module.named_buffers())
    return sum(int(np.prod(tsh.local_shape(tensors[name].shape, spec, mesh_shape))) * tensors[name].element_size()
               for name, spec in specs.items())


def _meta_dit(fmt: str) -> Flux2Transformer:
    with torch.device("meta"):
        model = Flux2Transformer(FLUX2_DEV, device="meta", dtype=torch.bfloat16)
    return tquant.quantize_params(model, fmt)


def test_dev32b_bf16_fits_tp8():
    """JAX's ``test_dev32b_sharded_aot_compile``: Dev-32B bf16 over tp=8, under 16 GB a rank."""
    gb = _rank_bytes(_meta_dit("bf16"), tsh.DIT_RULES, 8) / 1e9
    assert 7.0 < gb < 16.0, gb


def test_dev32b_w4a8_fits_tp2():
    """JAX's ``test_dev32b_w4a8_fits_two_chips_aot``: Dev-32B in W4A8 over tp=2, under 12 GB a rank."""
    model = _meta_dit("w4a8")
    assert set(tquant.quantized_names(model).values()) == {"w4a8"}
    gb = _rank_bytes(model, tsh.DIT_RULES, 2) / 1e9
    assert 6.0 < gb < 12.0, gb


def test_dev32b_plus_mistral24b_w8a8_fit_tp8():
    """JAX's ``test_dev32b_plus_mistral24b_w8a8_coexist_aot``: Dev-32B and Mistral-24B, both W8A8 (the
    encoder's layers only), resident together over tp=8: under 16 GB a rank."""
    dit = _rank_bytes(_meta_dit("w8a8"), tsh.DIT_RULES, 8)
    with torch.device("meta"):
        enc = Qwen3Decoder(MISTRAL_SMALL_3_2, device="meta", dtype=torch.bfloat16)
    enc = _rank_bytes(quantize_encoder_params(enc, "w8a8"), tsh.DECODER_RULES, 8)
    assert (dit + enc) / 1e9 < 16.0, (dit / 1e9, enc / 1e9)


def test_serve_followers_run_the_leaders_batches(pool):
    """``serve --tp``'s protocol on eight ranks of a tp=8 mesh: rank 0's ``_Leader`` broadcasts each
    ``generate`` call (the embeddings and noise as tensors), every follower runs it; rank 0's cancel
    at step 1 stops every rank at the same step end; the uncancelled call's latents equal JAX's
    unsharded generate's; the shutdown ends every follower's loop."""
    ref, args = pipeline_case()
    params, vae_params, _, cfg_kw, vae_kw, gen = args
    outs = pool.run(f"{CASES}:serve_leader_and_followers", params, vae_params, cfg_kw, vae_kw, gen, (1, 1, 8, 1))
    assert outs[1:] == [{"followed": True}] * 7
    assert outs[0]["cancelled"] == "cancelled at step 1/2" and outs[0]["steps"] == []
    np.testing.assert_allclose(outs[0]["latents"], ref.latents, atol=1e-4, rtol=0)
