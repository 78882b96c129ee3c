"""Partitioned W8A8 / W4A8 matmuls in the port (``flux2_tpu_torch/parallel/quant_partition.py``,
which ``ops.quant.q_linear`` takes for every sharded weight) against JAX's ``test_partitioned_w8a8_matmul_exact`` and
``_w4a8_matmul_exact``: eight torch ranks joined by gloo on the CPU, one pool for the file,
JAX's references in this process. On the CPU each shard's body dequantizes, as JAX's does.
"""

import numpy as np
import pytest

from tests.test_torch_parallel import CASES, CFG, _dit_inputs, _dit_jax_params, _jax_quantized_forward
from tests.torch_rank_pool import RankPool


@pytest.fixture(scope="module")
def pool():
    p = RankPool(8)
    yield p
    p.close()


@pytest.mark.parametrize("fmt,joint", [("w8a8", 384), ("w4a8", 512)])
def test_partitioned_matmul_exact(pool, fmt, joint):
    """The quantized DiT sharded over (fsdp=2, tp=4), its products partitioned (W8A8 column- and
    row-parallel, W4A8 column-parallel with K gathered) == JAX's unpartitioned quantized forward,
    relative L2 < 1e-4 (JAX's bound for its partitioned forward)."""
    cfg = dict(CFG, joint_attention_dim=joint)
    params, inputs = _dit_jax_params(cfg), _dit_inputs(256, 256, 16, joint=joint)
    ref = _jax_quantized_forward(params, inputs, fmt, cfg)
    for out in pool.run(f"{CASES}:dit_forward", params, cfg, inputs, (1, 2, 4, 1), None, fmt):
        assert np.linalg.norm(out["value"] - ref) / np.linalg.norm(ref) < 1e-4


@pytest.mark.parametrize("axes", [(1, 1, 8, 1), (1, 2, 4, 1)], ids=["tp8", "fsdp2_tp4"])
def test_row_parallel_sums_the_per_shard_plain_versions(pool, axes):
    """Row-parallel W8A8 (K over tp): each rank's prologue quantizes its own K slice with its own
    per-row scale, so the all-reduced result is the sum of ``w8a8_matmul_reference`` over the K shards,
    not the unsharded kernel's result, as JAX's per-shard TPU body."""
    for out in pool.run(f"{CASES}:row_parallel_w8a8", axes):
        np.testing.assert_allclose(out["partitioned"], out["per_shard_sum"], rtol=1e-6, atol=1e-5)
        assert np.abs(out["partitioned"] - out["unsharded"]).max() > 0
        assert out["k_local"] * out["shards"] == out["k"]


def test_column_parallel_keeps_n_sharded(pool):
    """Column-parallel W8A8 (N over tp=8): no collective, the output stays N-sharded, each rank's
    slice its columns of the unsharded kernel's plain version to the bit."""
    for out in pool.run(f"{CASES}:column_parallel_w8a8", (1, 1, 8, 1)):
        assert out["placement"] == "S(1)"
        np.testing.assert_array_equal(out["local"], out["unsharded_columns"])
