"""Ring attention and context parallelism in the port
(``flux2_tpu_torch/parallel/ring_attention.py``, ``sdpa(ring=)``,
``Flux2Pipeline.shard(context_parallel=True)``) against JAX's ring tests of
``tests/test_parallel.py``: eight torch ranks joined by gloo on the CPU, one
pool for the file, JAX's references in this process. On the CPU the flash
ring's K2 is its plain version (``flash_attention_lse_reference``), as JAX's
test runs its kernel in interpret mode.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from flux2_tpu.models.flux2 import config as jcfg
from flux2_tpu.ops import attention as jattn
from flux2_tpu.ops.attention import sdpa_xla

from tests.test_torch_parallel import (CASES, CFG, _assert_generation_close, _dit_inputs, _dit_jax_params,
                                       _jax_forward, pipeline_case)
from tests.torch_rank_pool import RankPool

RING_CFG = dict(CFG, num_attention_heads=2, joint_attention_dim=96)  # JAX's ring forward configuration


@pytest.fixture(scope="module")
def pool():
    p = RankPool(8)
    yield p
    p.close()


def _qkv(shape, seed=0):
    ks = jax.random.split(jax.random.PRNGKey(seed), 3)
    return [np.asarray(jax.random.normal(k, shape)) for k in ks]


def test_ring_attention_matches_full(pool):
    """The einsum ring over tp=8 (8 tokens a rank) == JAX's dense attention (atol 2e-5, JAX's)."""
    q, k, v = _qkv((1, 2, 64, 32))
    ref = np.asarray(sdpa_xla(q, k, v))
    for out in pool.run(f"{CASES}:ring_forward", q, k, v, (1, 1, 8, 1), "tp"):
        np.testing.assert_allclose(out["value"], ref, atol=2e-5, rtol=0)


def test_ring_attention_flash_path_matches_dense(pool):
    """The flash ring (K2's plain version on every block, LSE merge) == dense (relative 2e-5, JAX's)."""
    q, k, v = _qkv((1, 2, 1024, 128))
    ref = np.asarray(sdpa_xla(q, k, v))
    for out in pool.run(f"{CASES}:ring_forward", q, k, v, (1, 1, 8, 1), "tp", True):
        assert np.linalg.norm(out["value"] - ref) / np.linalg.norm(ref) < 2e-5


@pytest.mark.parametrize("flash", [False, True], ids=["einsum", "flash"])
def test_ring_attention_gradient_matches_dense(pool, flash):
    """d(sum o^2) through the ring on (data=2, tp=4) == JAX's dense autograd (max abs 2e-4, JAX's):
    the shift's backward sends the gradient back round the ring; the flash ring recomputes through
    the einsum one."""
    q, k, v = (np.asarray(jax.random.normal(jax.random.PRNGKey(i), (1, 2, 32, 128))) for i in range(3))

    def dense(q, k, v):
        s = jnp.einsum("bhqd,bhkd->bhqk", q, k) * 128**-0.5
        return jnp.einsum("bhqk,bhkd->bhqd", jax.nn.softmax(s, -1), v)

    want = jax.grad(lambda a, b, c: jnp.sum(dense(a, b, c) ** 2), argnums=(0, 1, 2))(q, k, v)
    for grads in pool.run(f"{CASES}:ring_grad", q, k, v, (2, 1, 4, 1), "tp", flash):
        for got, ref in zip(grads, want):
            assert float(np.max(np.abs(got - np.asarray(ref)))) < 2e-4


def test_ring_attention_rejects_indivisible(pool):
    """60 tokens over tp=8: JAX's ValueError text."""
    x = jnp.zeros((1, 2, 60, 32))
    with pytest.raises(ValueError) as e:
        from flux2_tpu.parallel import mesh as jmesh
        from flux2_tpu.parallel import ring_attention as jra

        jra.ring_attention(x, x, x, mesh=jmesh.make_mesh(data=1, fsdp=1, tp=8))
    assert pool.run(f"{CASES}:ring_rejects_indivisible", (1, 1, 8, 1)) == [str(e.value)] * 8


def test_sdpa_ring_falls_back_to_dense_with_jax_warning(pool, caplog):
    """``sdpa(ring=)`` on 60 tokens over tp=8: JAX's warning, once per shape however many calls, and
    the dense result."""
    q, k, v = _qkv((1, 2, 60, 32), seed=5)
    jattn._warn_ring_fallback.cache_clear()
    with caplog.at_level("WARNING", logger="flux2_tpu"):
        jattn._warn_ring_fallback(60, 60, 8)
    outs = pool.run(f"{CASES}:sdpa_ring_fallback", q, k, v, (1, 1, 8, 1))
    ref = np.asarray(sdpa_xla(q, k, v))
    for out in outs:
        assert out["warnings"] == [caplog.records[-1].getMessage()]
        np.testing.assert_allclose(out["value"], ref, atol=2e-5, rtol=0)


def test_ring_forward_matches_dense(pool):
    """The DiT with ring attention on tp=8 in every block (24 joint tokens, 3 a rank) == JAX's dense
    forward (atol 2e-4, JAX's)."""
    params, inputs = _dit_jax_params(RING_CFG), _dit_inputs(joint=96)
    ref = _jax_forward(params, inputs, RING_CFG)
    for out in pool.run(f"{CASES}:dit_forward", params, RING_CFG, inputs, (1, 1, 8, 1), "tp"):
        np.testing.assert_allclose(out["value"], ref, atol=2e-4, rtol=0)


def test_seq_sharded_activations_end_to_end(pool):
    """Ring on sp=4 with heads on tp=2: the token axis stays sharded outside attention too; the
    forward == the dense sharded one (atol 3e-4, JAX's) and each rank's share of the output is at most
    half the dense layout's (1/sp here)."""
    params, inputs = _dit_jax_params(), _dit_inputs(256, 256, 16)
    dense = pool.run(f"{CASES}:dit_forward", params, CFG, inputs, (1, 1, 2, 4))
    ring = pool.run(f"{CASES}:dit_forward", params, CFG, inputs, (1, 1, 2, 4), "sp")
    for d, r in zip(dense, ring):
        np.testing.assert_allclose(r["value"], d["value"], atol=3e-4, rtol=0)
        assert r["local_bytes"] * 2 <= d["local_bytes"]
    np.testing.assert_allclose(ring[0]["value"], _jax_forward(params, inputs), atol=2e-3, rtol=0)


def test_context_parallel_pipeline_generate(pool):
    """``shard(mesh, context_parallel=True)`` on tp=8 (24 joint tokens): generate == JAX's unsharded."""
    ref, args = pipeline_case()
    for out in pool.run(f"{CASES}:pipeline_generate", *args, (1, 1, 8, 1), True):
        assert out["ring"] == "tp"
        _assert_generation_close(out, ref)


@pytest.mark.parametrize("context_parallel", [False, True], ids=["dense", "ring"])
def test_a_one_rank_mesh_shards_nothing(context_parallel):
    """``shard`` on a mesh of one rank (in this process, gloo on a HashStore) leaves every weight of the
    DiT a plain tensor, as JAX's shard on one device costs nothing; under context parallelism the ring
    of one runs on the plain tensors. generate == JAX's unsharded (JAX's tolerances)."""
    from tests.torch_parallel_cases import pipeline_generate

    ref, args = pipeline_case()
    out = pipeline_generate(*args, (1, 1, 1, 1), context_parallel)
    assert out["dtensors"] == 0
    assert out["ring"] == ("tp" if context_parallel else None)
    _assert_generation_close(out, ref)


def test_context_parallel_prefers_sp_axis(pool):
    """With sp sized (tp=2, sp=4) the ring runs on sp, heads stay on tp; generate == JAX's unsharded."""
    ref, args = pipeline_case()
    for out in pool.run(f"{CASES}:pipeline_generate", *args, (1, 1, 2, 4), True):
        assert out["ring"] == "sp"
        _assert_generation_close(out, ref)


def test_context_parallel_composes_with_kv_cache(pool):
    """klein-9b-kv with a reference on the ring (tp=8): the extract step dense, steps 1+ ride the ring
    with the cached reference K/V (24 queries, 40 keys); == JAX's unsharded KV-cached generate."""
    ref_img = np.random.RandomState(0).rand(64, 64, 3).astype(np.float32)
    ref, args = pipeline_case(jcfg.Flux2Model.KLEIN_9B_KV, steps=3, reference=ref_img)
    for out in pool.run(f"{CASES}:pipeline_generate", *args, (1, 1, 8, 1), True, ref_img):
        assert out["ring"] == "tp"
        _assert_generation_close(out, ref)
