"""The int8 activation prologue of K5 and K6, on the CPU.

The CUDA prologue (``csrc/quant_prologue.cu``, ``quant_kernels.quantize_activations``)
must equal the plain torch chain ``quantize_rows`` / ``quantize_row_blocks`` to
the bit on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``). Here
that chain is pinned to JAX's prologue expressions (``flux2_tpu/ops/
quant_kernels.py:236-239`` for K5, ``:342-350`` for K6), evaluated on the CPU
op by op and under ``jit``: the codes and the f32 scales agree bit for bit, in
bf16 and f32, at the served widths, on a zero row, on a row with one large
outlier, and on values engineered to fall exactly half-way between two codes
(both round half to even). On CPU tensors the wrappers take the plain
versions and count no launch.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flux2_tpu_torch.ops import quant as tq
from flux2_tpu_torch.ops import quant_kernels as tqk

WIDTHS = [512, 2560, 3072, 9216]  # bn_regression / Qwen3-4B hidden / Klein-4B inner / its MLP hidden
DTYPES = {"bf16": (jnp.bfloat16, torch.bfloat16), "f32": (jnp.float32, torch.float32)}


def _jax_rows(x):
    """K5's prologue, as flux2_tpu/ops/quant_kernels.py:236-239 writes it."""
    xf = x.astype(jnp.float32)
    amax = jnp.max(jnp.abs(xf), axis=-1, keepdims=True)
    xs = jnp.maximum(amax, 1e-30) * (1.0 / 127.0)
    xq = jnp.clip(jnp.round(xf / xs), -127.0, 127.0).astype(jnp.int8)
    return xq, xs[:, 0]


def _jax_row_blocks(x, bk):
    """K6's prologue, as flux2_tpu/ops/quant_kernels.py:342-350 writes it."""
    m, k = x.shape
    xr = x.astype(jnp.float32).reshape(m, k // bk, bk)
    amax = jnp.max(jnp.abs(xr), axis=-1)
    xs = jnp.maximum(amax, 1e-30) * (1.0 / 127.0)
    xq = jnp.clip(jnp.round(xr / xs[:, :, None]), -127.0, 127.0).astype(jnp.int8).reshape(m, k)
    return xq, xs


def _round_to(x: np.ndarray, tdtype: torch.dtype) -> np.ndarray:
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(tdtype).float().numpy()


def _scale(amax: np.float32) -> np.float32:
    return np.float32(np.maximum(amax, np.float32(1e-30)) * np.float32(1.0 / 127.0))


def _ties(amax: float, tdtype: torch.dtype, width: int) -> np.ndarray:
    """Up to ``width`` values of the dtype within [-amax, amax] whose quotient
    by the scale of a segment with that amax is exactly n + 1/2 in f32."""
    amax = _round_to(np.array([amax]), tdtype)[0]
    scale = _scale(amax)
    cand = _round_to((np.arange(-127, 127, dtype=np.float32) + np.float32(0.5)) * scale, tdtype)
    if tdtype == torch.bfloat16:  # few bf16 values sit on a tie: search every bf16 value below amax
        bits = np.arange(0, 1 << 15, dtype=np.uint32) << 16
        pos = bits.view(np.float32)
        pos = pos[np.isfinite(pos) & (pos <= amax)]
        cand = np.concatenate([cand, pos, -pos])
    q = cand / scale
    ties = np.unique(cand[(np.abs(cand) <= amax) & (q - np.floor(q) == np.float32(0.5))])
    return np.resize(ties, width) if ties.size else ties


def _rows(k: int, tdtype: torch.dtype, segment: int, seed: int) -> np.ndarray:
    """[8, k] activations in the dtype: Gaussian rows, a zero row, a row with one
    outlier 300x its neighbours, and rows whose segments hold a tie every other
    value (the segment's amax at its first position)."""
    rng = np.random.RandomState(seed)
    x = rng.randn(8, k).astype(np.float32)
    x[1] = 0.0
    x[2] *= 0.01
    x[2, k // 3] = -300.0
    for r, amax in ((3, 127 / 64), (4, 3.0), (5, 1e-3)):  # 127 / 64: the scale is 2^-6, every (n + 1/2) / 64 a tie
        for s in range(0, k, segment):
            ties = _ties(amax, tdtype, segment // 2)
            x[r, s:s + segment] = 0.0
            x[r, s] = amax
            x[r, s + 1:s + 1 + 2 * ties.size:2] = ties
    return _round_to(x, tdtype)


def _pair(x: np.ndarray, dtype: str):
    jdt, tdt = DTYPES[dtype]
    return jnp.asarray(x).astype(jdt), torch.from_numpy(x).to(tdt)


def _assert_bitwise(port, ref):
    (tq_, ts), (jq, js) = port, ref
    assert tq_.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq_.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy().view(np.uint32), np.asarray(js, np.float32).view(np.uint32))


@pytest.mark.parametrize("mode", ["eager", "jit"])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("k", WIDTHS)
def test_quantize_rows_equals_jax_prologue_bit_for_bit(k, dtype, mode):
    x = _rows(k, DTYPES[dtype][1], k, seed=k)
    jx, tx = _pair(x, dtype)
    ref = jax.jit(_jax_rows)(jx) if mode == "jit" else _jax_rows(jx)
    _assert_bitwise(tqk.quantize_rows(tx), ref)


@pytest.mark.parametrize("mode", ["eager", "jit"])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("k", WIDTHS)
def test_quantize_row_blocks_equals_jax_prologue_bit_for_bit(k, dtype, mode):
    x = _rows(k, DTYPES[dtype][1], 512, seed=k + 1)
    jx, tx = _pair(x, dtype)
    ref = jax.jit(_jax_row_blocks, static_argnums=1)(jx, 512) if mode == "jit" else _jax_row_blocks(jx, 512)
    _assert_bitwise(tqk.quantize_row_blocks(tx, 512), ref)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_ties_round_half_to_even_and_zero_rows_keep_the_floor_scale(dtype):
    tdt = DTYPES[dtype][1]
    x = _rows(512, tdt, 512, seed=3)
    xq, xs = tqk.quantize_rows(torch.from_numpy(x).to(tdt))
    for r in (3, 4, 5):
        ties = x[r, 1::2][x[r, 1::2] != 0]
        assert ties.size > 0  # the search found half-way values in this dtype
        codes = xq[r, 1::2][torch.from_numpy(x[r, 1::2] != 0)]
        q = ties / xs[r].numpy()
        assert np.array_equal(q - np.floor(q), np.full(q.shape, 0.5, np.float32))
        assert (codes.int() % 2 == 0).all()  # half to even, never away from zero
        assert np.array_equal(codes.numpy(), np.round(q).astype(np.int8))
    assert xs[1].item() == _scale(np.float32(0.0)) and not xq[1].any()  # zero row: 1e-30 / 127, codes 0
    assert xq[2].abs().max().item() == 127 and xq[2, 512 // 3].item() == -127  # the outlier takes the range


@pytest.mark.parametrize("block", [512, 3072])
def test_quantize_activations_on_a_cpu_tensor_is_the_plain_version(block):
    x = torch.from_numpy(_rows(3072, torch.bfloat16, block, seed=7)).bfloat16()
    tqk.reset_launches()
    xq, xs = tqk.quantize_activations(x, block)
    ref_q, ref_s = tqk.quantize_row_blocks(x, block)
    assert torch.equal(xq, ref_q) and torch.equal(xs, ref_s) and xs.shape == (8, 3072 // block)
    assert all(v == 0 for v in tqk.launches.values())


def test_wrappers_on_cpu_tensors_launch_nothing():
    rng = np.random.RandomState(11)
    x = torch.from_numpy(rng.randn(4, 512).astype(np.float32))
    w = torch.from_numpy(rng.randn(256, 512).astype(np.float32) * 512**-0.5)
    tqk.reset_launches()
    for dtype in (torch.float32, torch.bfloat16):
        tqk.w8a8_matmul(x.to(dtype), tq.to_w8a8(w))
        tqk.w4a8_matmul(x.to(dtype), tq.to_w4a8(w))
        tqk.dequant_matmul(x.to(dtype), tq.quantize(w, "qint8"))
        tqk.quantize_activations(x.to(dtype), 512)
    assert tqk.launches == {name: 0 for name in tqk.launches} and "quantize_rows" in tqk.launches


# Kernel names as the profiler reports them (the builds' mangled names).
K5_NAME = ("_ZN48_GLOBAL__N__758c9654_15_quant_matmul_cu_80cc577511w8a8_kernelILi256ELi2E13__nv_bfloat16EEv14CUtensor"
           "Map_stS2_S2_PKfS4_ii")
K6_NAME = "_ZN48_GLOBAL__N__758c9654_15_quant_matmul_cu_80cc577511w4a8_kernelIfEEv14CUtensorMap_stS1_PKfS3_PT_iii"
PROLOGUE_NAME = ("_ZN50_GLOBAL__N__00314884_17_quant_prologue_cu_9802ed2420quantize_rows_kernelI13__nv_bfloat16Li32ELi4"
                 "EEEvPKT_PaPfxi")


def test_profiler_marks_part_the_prologue_from_k5_and_k6():
    """chip_smoke times K5 / K6 / the prologue alone by name marks, and
    profile_step files the prologue in its own column, not in "quant" or "other"."""
    import chip_smoke
    from flux2_tpu_torch.utils import profile_step

    assert profile_step.kernel_class(PROLOGUE_NAME) == "prologue"
    assert profile_step.kernel_class(K5_NAME) == profile_step.kernel_class(K6_NAME) == "quant"
    assert chip_smoke.PROLOGUE_MARK in PROLOGUE_NAME
    for kind, name in (("w8a8", K5_NAME), ("w4a8", K6_NAME)):
        assert chip_smoke.KERNEL_MARK[kind] in name and chip_smoke.KERNEL_MARK[kind] not in PROLOGUE_NAME
        assert chip_smoke.PROLOGUE_MARK not in name


@pytest.mark.parametrize("recorded", [[5, 10], [0, 0, 10], [10]], ids=["part", "none", "whole"])
def test_kernel_time_takes_again_a_trace_that_lost_launches(monkeypatch, recorded):
    """``kernel_time_ms`` reads only a trace that holds a whole number of the
    marked launches a call: one that lost some of its device events (which
    would read too short) or all of them is taken again."""
    from types import SimpleNamespace

    from flux2_tpu_torch.utils import profile_step

    traces = iter(recorded)

    class FakeProfile:
        def __init__(self, activities):
            self.n = next(traces)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def events(self):
            def event(name, us):
                return SimpleNamespace(device_type=torch.autograd.DeviceType.CUDA, name=name,
                                       time_range=SimpleNamespace(elapsed_us=lambda: us))

            return [event(K5_NAME, 300.0)] * self.n + [event(PROLOGUE_NAME, 7.0)] * 10

    monkeypatch.setattr(torch.profiler, "profile", FakeProfile)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    assert profile_step.kernel_time_ms(lambda: None, "w8a8_kernel", reps=10) == pytest.approx(0.3)
    assert next(traces, None) is None
