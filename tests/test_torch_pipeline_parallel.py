"""The port's pipeline parallelism (``flux2_tpu_torch/parallel/pipeline.py``)
against JAX's ``tests/test_pipeline_parallel.py``: eight torch ranks joined
by gloo on the CPU (``tests/torch_rank_pool.py``, one pool for the file;
the rank-side code is ``tests/torch_pipeline_cases.py``), JAX's references
on its eight virtual devices in this process.

One case after each of JAX's tests, under JAX's own bounds: the mesh
layouts, the specs of ``pp_param_sharding``, the forward against JAX's
``pipelined_forward`` (pp=2 x data=4, and M=4 on four ranks), the LoRA
gradients through the pipeline with remat, pp x tp = 2 x 2 against the
dense forward, a train step against the dense step, QLoRA through pp, the
validation errors and the Dev-32B fit (per-rank bytes of ``meta`` modules);
and two more: a rank holds its stage's blocks only, and the previews' merged
stage copy through ``PipelinedDiT``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flux2_tpu.models.flux2 import config as jcfg
from flux2_tpu.models.flux2 import transformer as jtfm
from flux2_tpu.ops import latents as jlu
from flux2_tpu.ops.rope import rope_embeddings
from flux2_tpu.parallel import pipeline as jpp
from flux2_tpu.training import lora as jlora
from flux2_tpu_torch.models.flux2.config import FLUX2_DEV
from flux2_tpu_torch.models.flux2.transformer import Flux2Transformer
from flux2_tpu_torch.parallel import pipeline as tpp

from tests.test_torch_transformer import perturbed_numpy
from tests.torch_rank_pool import RankPool

CASES = "tests.torch_pipeline_cases"
# JAX's tests/test_pipeline_parallel.py configuration
CFG = dict(num_layers=2, num_single_layers=4, num_attention_heads=2, attention_head_dim=128, joint_attention_dim=96,
           guidance_embeds=False)
ODD = dict(CFG, num_layers=3)


@pytest.fixture(scope="module")
def pool():
    p = RankPool(8)
    yield p
    p.close()


@pytest.fixture(scope="module")
def params():
    return perturbed_numpy(jtfm.init_params(jax.random.PRNGKey(0), jcfg.Flux2TransformerConfig(**CFG),
                                            dtype=jnp.float32), 0)


def _inputs(batch, h=64, w=64, s_txt=8, seed=7):
    rng = np.random.RandomState(seed)
    ids = np.concatenate([jlu.text_position_ids(s_txt), jlu.image_position_ids(h, w)], axis=0)
    cos, sin = (np.asarray(a) for a in rope_embeddings(jnp.asarray(ids)))
    return {"hidden": rng.randn(batch, (h // 16) * (w // 16), 128).astype(np.float32),
            "txt": rng.randn(batch, s_txt, CFG["joint_attention_dim"]).astype(np.float32),
            "t": rng.uniform(0.1, 0.9, batch).astype(np.float32), "cos": cos, "sin": sin}


def _jax(params):
    return jax.tree_util.tree_map(jnp.asarray, params)


def _jax_dense(params, inputs):
    i = inputs
    return np.asarray(jtfm.forward(_jax(params), jcfg.Flux2TransformerConfig(**CFG), i["hidden"], i["txt"], i["t"],
                                   i["cos"], i["sin"]))


def _same_on_every_rank(outs, n=8):
    got = [o for o in outs[:n] if o is not None]
    assert len(got) == n
    for o in got[1:]:
        np.testing.assert_array_equal(o, got[0])
    return got[0]


def test_make_pp_mesh_layouts(pool):
    """Every rank sits where JAX puts that device id, in both layouts and with tp; JAX's ValueError texts."""
    got = pool.run(f"{CASES}:mesh_layouts")[0]
    for key, kw in {"4x2": dict(pp=4, data=2), "4x2_dcn": dict(pp=4, data=2, pp_over_dcn=True),
                    "2x2x2": dict(pp=2, data=2, tp=2), "2x2x2_dcn": dict(pp=2, data=2, tp=2, pp_over_dcn=True)}.items():
        m = jpp.make_pp_mesh(**kw)
        shape, ranks = got[key]
        assert shape == dict(m.shape)
        assert ranks == np.vectorize(lambda d: d.id)(m.devices).tolist(), key
    errors = []
    for kw in (dict(pp=3, data=2), dict(pp=2, data=2, tp=3)):
        with pytest.raises(ValueError) as e:
            jpp.make_pp_mesh(**kw)
        errors.append(str(e.value))
    assert got["errors"] == errors


@pytest.mark.parametrize("dims", [(2, 4), (2, 2, 2)], ids=["pp", "pp_tp"])
def test_pp_param_sharding_specs(pool, params, dims):
    """The port's specs equal JAX's ``pp_param_sharding`` leaf for leaf: ("pp",) on the stacks, () off them,
    and under tp the rule's column / row placements."""
    kw = dict(pp=dims[1], data=dims[0], tp=dims[2] if len(dims) > 2 else 1)
    got = pool.run(f"{CASES}:specs", params, CFG, dims)[0]
    mesh = jpp.make_pp_mesh(**kw)
    flat = jax.tree_util.tree_flatten_with_path(jpp.pp_param_sharding(mesh, _jax(params)))[0]
    from flux2_tpu.parallel import sharding as jsh

    want = {jsh._path_str(path): tuple(s.spec) for path, s in flat}
    assert got == want
    if len(dims) > 2:
        assert got["double_blocks/to_q"] == ("pp", None, "tp") and got["double_blocks/to_out"] == ("pp", "tp", None)


def test_a_rank_holds_its_stage_only(pool, params):
    """``place_stages`` keeps blocks [p L/P, (p+1) L/P) of each stack and frees the rest: a rank's bytes are
    its stage's share (prelude and head whole, tp chunks of its blocks), well under the whole model's."""
    for dims in ((4, 2), (2, 2, 2)):
        out = pool.run(f"{CASES}:stage_bytes", params, CFG, dims)
        for r in out:
            assert r["local"] == r["expected"] < r["full"]
            p = r["stage"]
            assert r["kept"] == {"double_blocks": [p], "single_blocks": [2 * p, 2 * p + 1]}
    qint8 = pool.run(f"{CASES}:stage_bytes", params, CFG, (4, 2), "qint8")
    assert all(r["local"] == r["expected"] < r["full"] for r in qint8)


def test_pipelined_forward_matches_jax(pool, params):
    """pp=2 x data=4 (M = P = 2) and pp=2 x data=2 on four ranks with M=4, against JAX's
    ``pipelined_forward`` on the same meshes (JAX's bound: atol 2e-5)."""
    inputs = _inputs(batch=8)
    i = inputs
    config = jcfg.Flux2TransformerConfig(**CFG)
    mesh = jpp.make_pp_mesh(pp=2, data=4)
    p_pp = jax.device_put(_jax(params), jpp.pp_param_sharding(mesh, _jax(params)))
    want = np.asarray(jax.jit(lambda p, h, tx, ts: jpp.pipelined_forward(p, config, h, tx, ts, i["cos"], i["sin"],
                                                                         mesh=mesh))(p_pp, i["hidden"], i["txt"], i["t"]))
    got = _same_on_every_rank(pool.run(f"{CASES}:forward", params, CFG, inputs, (4, 2)))
    np.testing.assert_allclose(got, want, atol=2e-5)

    mesh4 = jpp.make_pp_mesh(pp=2, data=2, devices=jax.devices()[:4])
    want4 = np.asarray(jax.jit(lambda p, h, tx, ts: jpp.pipelined_forward(
        p, config, h, tx, ts, i["cos"], i["sin"], mesh=mesh4, num_microbatches=4))(_jax(params), i["hidden"], i["txt"],
                                                                                    i["t"]))
    got4 = _same_on_every_rank(pool.run(f"{CASES}:forward", params, CFG, inputs, (2, 2), 4, 4), n=4)
    np.testing.assert_allclose(got4, want4, atol=2e-5)


def test_pipelined_forward_with_lora_and_grads(pool, params):
    """A random LoRA on two targets through the pipeline (pp=2 x data=2, remat): the loss and every rank's
    gradient after ``reduce_grads`` equal the dense ones (JAX's bounds: rtol 1e-6, atol 3e-4)."""
    lcfg = jlora.LoRAConfig(rank=2, alpha=4.0, targets=(("double_blocks", "to_q"), ("single_blocks", "mlp_gate")))
    lora = jlora.init_lora(jax.random.PRNGKey(1), _jax(params), lcfg)
    lora = jax.tree.map(lambda x: np.asarray(jax.random.normal(jax.random.PRNGKey(2), x.shape) * 0.02), lora)
    out = pool.run(f"{CASES}:lora_grads", params, CFG, _inputs(batch=4), lora, lcfg.scale, (2, 2), 4)
    for r in out[:4]:
        (l_d, g_d), (l_p, g_p) = r["dense"], r["piped"]
        np.testing.assert_allclose(l_p, l_d, rtol=1e-6)
        assert sorted(g_p) == sorted(g_d) and len(g_d) == 2 * (2 + 4)
        for name in g_d:
            assert np.any(g_d[name]), name
            np.testing.assert_allclose(g_p[name], g_d[name], atol=3e-4, err_msg=name)


def test_pipelined_forward_pp_tp_matches_dense(pool, params):
    """tp inside each stage on the (data, pp, tp) = (2, 2, 2) mesh against JAX's dense forward (atol 5e-5)."""
    inputs = _inputs(batch=8)
    got = _same_on_every_rank(pool.run(f"{CASES}:forward", params, CFG, inputs, (2, 2, 2)))
    np.testing.assert_allclose(got, _jax_dense(params, inputs), atol=5e-5)


def test_train_step_with_pp_forward_matches_dense(pool, params):
    """``make_train_step(forward_fn=make_pp_forward(mesh))`` against the dense step from the same generator:
    the loss (rtol 1e-5) and the updated LoRA (atol 1e-5), the same on every rank; then the held-out loss
    through ``make_eval_loss(forward_fn=...)`` against the dense one (rtol 1e-5)."""
    i = _inputs(batch=4)
    batch = {"latents": i["hidden"], "embeddings": i["txt"], "rope_cos": i["cos"], "rope_sin": i["sin"]}
    out = pool.run(f"{CASES}:train_step", params, CFG, batch, (2, 2), 4)
    for r in out[:4]:
        np.testing.assert_allclose(r["pp"]["loss"], r["dense"]["loss"], rtol=1e-5)
        np.testing.assert_allclose(r["pp"]["grad_norm"], r["dense"]["grad_norm"], rtol=1e-4)
        np.testing.assert_allclose(r["pp"]["held_out"], r["dense"]["held_out"], rtol=1e-5)
        for name, a in r["dense"]["lora"].items():
            np.testing.assert_allclose(r["pp"]["lora"][name], a, atol=1e-5, err_msg=name)
        for name, a in out[0]["pp"]["lora"].items():
            np.testing.assert_array_equal(r["pp"]["lora"][name], a)


def test_qlora_train_step_through_pp(pool, params):
    """A qint8 base (its codes and scales with the stage's blocks) trains through pp: a finite loss, and the
    zero-initialised b leaves move."""
    i = _inputs(batch=4)
    batch = {"latents": i["hidden"], "embeddings": i["txt"], "rope_cos": i["cos"], "rope_sin": i["sin"]}
    out = pool.run(f"{CASES}:train_step", params, CFG, batch, (2, 2), 4, "qint8")
    for r in out[:4]:
        assert np.isfinite(r["pp"]["loss"])
        assert np.abs(r["pp"]["lora"]["double_blocks.0.to_q.b"]).max() > 0


def test_previews_run_a_merged_stage_copy_through_the_pipeline(pool, params):
    """The previews under pp: ``merged_copy`` of each rank's stage (the other stages' blocks stay freed) run as
    ``PipelinedDiT`` on a batch of one, on every rank of pp=2 x data=4, equals the dense DiT with the LoRA merged
    (atol 2e-5), and the placed base keeps its weights (R5)."""
    lcfg = jlora.LoRAConfig(rank=2, alpha=4.0)
    lora = jlora.init_lora(jax.random.PRNGKey(1), _jax(params), lcfg)
    lora = jax.tree.map(lambda x: np.asarray(jax.random.normal(jax.random.PRNGKey(3), x.shape) * 0.02), lora)
    out = pool.run(f"{CASES}:preview_forward", params, CFG, _inputs(batch=2), lora, lcfg.scale, (4, 2))
    for r in out:
        np.testing.assert_allclose(r["piped"], r["dense"], atol=2e-5)
        assert r["base_kept"] and r["bytes"][0] == r["bytes"][1]


def test_pipelined_forward_validation_errors(pool, params):
    """JAX's ValueError texts, for 3 microbatches of a batch of 8 and for an odd stack on pp=2."""
    inputs = _inputs(batch=8)
    got = pool.run(f"{CASES}:validation_errors", params, CFG, ODD, inputs)[0]
    i = inputs
    mesh = jpp.make_pp_mesh(pp=2, data=4)
    want = []
    for cfg_kw, m in ((CFG, 3), (ODD, None)):
        with pytest.raises(ValueError) as e:
            jpp.pipelined_forward(_jax(params), jcfg.Flux2TransformerConfig(**cfg_kw), i["hidden"], i["txt"], i["t"],
                                  i["cos"], i["sin"], mesh=mesh, num_microbatches=m)
        want.append(str(e.value))
    assert got == want
    assert "microbatches" in want[0] and "divide" in want[1]


def test_dev32b_pp_tp_fit_proof():
    """Dev-32B bf16 at pp=4 x tp=2: a rank of any stage holds < 12 GB of parameters (``stage_param_bytes``
    on a ``meta`` model), where the dense model holds > 50 GB (JAX's bounds)."""
    with torch.device("meta"):
        model = Flux2Transformer(FLUX2_DEV, device="meta", dtype=torch.bfloat16)
    dense = sum(t.nbytes for t in model.parameters())
    assert dense / 1e9 > 50.0
    per_rank = [tpp.stage_param_bytes(model, 4, 2, stage) for stage in range(4)]
    assert max(per_rank) / 1e9 < 12.0, per_rank
