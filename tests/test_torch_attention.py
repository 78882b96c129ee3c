"""The port's flash attention (K1) and attention dispatch against the JAX package.

On the CPU the port's ``flash_attention`` computes its plain float32 version,
``flash_attention_reference``; it is held against the JAX Pallas kernel run
in interpret mode (as tests/test_pallas_kernels.py runs it) and against
``sdpa_xla``. Tolerance 2e-5 absolute in float32, as that file's. The CUDA
kernel itself is checked on the card (tests/test_torch_cuda.py, chip_smoke.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flux2_tpu.ops import flash_attention as jfa
from flux2_tpu.ops.attention import sdpa_xla
from flux2_tpu_torch.ops import attention as tattn
from flux2_tpu_torch.ops import flash_attention as tfa

ATOL = 2e-5


def _qkv(seed, s_q, s_k=None, b=1, h=2, d=128):
    rng = np.random.RandomState(seed)
    s_k = s_q if s_k is None else s_k
    return (rng.randn(b, h, s_q, d).astype(np.float32), rng.randn(b, h, s_k, d).astype(np.float32),
            rng.randn(b, h, s_k, d).astype(np.float32))


def _t(*xs):
    return [torch.from_numpy(x) for x in xs]


@pytest.mark.parametrize(
    "case",
    [
        dict(s=256),
        dict(s=200),  # ragged: pad keys masked in the last tile
        dict(s=256, scale=0.5),
        dict(s=256, blocked_span=(32, 96, 160)),
        dict(s=200, blocked_span=(0, 64, 128)),
        dict(s=256, bounded_logits=True),
    ],
    ids=["plain", "ragged", "scale", "span", "ragged_span", "bounded"],
)
def test_flash_reference_matches_jax_kernel_interpret(case):
    q, k, v = _qkv(case["s"], case["s"])
    kw = {key: case[key] for key in ("scale", "blocked_span", "bounded_logits") if key in case}
    ref = jfa.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), block_q=128, block_k=128,
                              interpret=True, **kw)
    out = tfa.flash_attention(*_t(q, k, v), **kw)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


def test_flash_reference_ragged_q_and_k_matches_sdpa_xla():
    q, k, v = _qkv(3, 150, 230, b=2, h=3)
    ref = sdpa_xla(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    out = tfa.flash_attention_reference(*_t(q, k, v))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


def test_sdpa_span_matches_sdpa_xla_with_bias():
    q, k, v = _qkv(4, 192)
    q0, q1, k0 = 16, 80, 100
    row, col = np.arange(192)[:, None], np.arange(192)[None, :]
    bias = np.where((row >= q0) & (row < q1) & (col >= k0), -1e30, 0.0).astype(np.float32)[None, None]
    ref = sdpa_xla(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), bias=jnp.asarray(bias))
    out = tattn.sdpa(*_t(q, k, v), blocked_span=(q0, q1, k0), bounded_logits=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=0)
    out_bias = tattn.sdpa_reference(*_t(q, k, v), bias=torch.from_numpy(bias))
    np.testing.assert_allclose(out_bias.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


@pytest.mark.parametrize(
    "shapes",
    [
        ((1, 2, 256, 128), (1, 2, 256, 128)),
        ((1, 2, 127, 128), (1, 2, 256, 128)),
        ((1, 2, 256, 128), (1, 2, 100, 128)),
        ((1, 2, 256, 64), (1, 2, 256, 64)),
        ((1, 2, 256, 256), (1, 2, 256, 256)),
        ((2, 256, 128), (2, 256, 128)),
    ],
)
def test_supported_agrees_with_jax_gate(shapes):
    qs, ks = shapes
    q, k = np.zeros(qs, np.float32), np.zeros(ks, np.float32)
    assert tfa.supported(*_t(q, k, k)) == jfa.supported(jnp.asarray(q), jnp.asarray(k), jnp.asarray(k))


def test_sdpa_on_cpu_takes_the_plain_path_and_launches_nothing():
    q, k, v = _qkv(5, 256)
    before = tfa.launches
    out = tattn.sdpa(*_t(q, k, v), bounded_logits=True)
    assert tfa.launches == before
    ref = sdpa_xla(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


def test_sdpa_ring_is_not_ported():
    q, k, v = _t(*_qkv(6, 128))
    with pytest.raises(NotImplementedError):
        tattn.sdpa(q, k, v, ring=("mesh", "sp"))


def test_flash_fwd_candidate_refuses_to_run_without_a_card(monkeypatch):
    from flux2_tpu_torch.utils import flash_fwd_candidate

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        flash_fwd_candidate.main(["--source", "candidate.cu"])


def test_flash_bwd_candidate_refuses_to_run_without_a_card(monkeypatch):
    from flux2_tpu_torch.utils import flash_bwd_candidate

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        flash_bwd_candidate.main(["--source", "candidate.cu"])
