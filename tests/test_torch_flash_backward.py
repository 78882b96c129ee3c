"""The port's differentiable flash attention (K2 forward, K3/K4 backward) against JAX.

On the CPU the wrappers compute their plain float32 versions: K2's is
``flash_attention_lse_reference``; the backward recomputes p from the LSE in
the exp2 domain and takes delta = rowsum(dO * O), as K3 and K4 do. They are
held against the JAX package's Pallas kernels run in interpret mode (as
tests/test_pallas_kernels.py runs them) and against ``_xla_attention_grads``.
Tolerances: the LSE forward 1e-5 absolute in float32; gradients 3e-4
absolute, JAX's own limit for its flash VJP (tests/test_pallas_kernels.py:108);
plain against plain 2e-5. The CUDA kernels are checked on the card
(tests/test_torch_cuda.py, chip_smoke.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.checkpoint import checkpoint

from flux2_tpu.ops import flash_attention as jfa
from flux2_tpu_torch.ops import attention as tattn
from flux2_tpu_torch.ops import flash_attention as tfa

LSE_ATOL = 1e-5
GRAD_ATOL = 3e-4
PLAIN_ATOL = 2e-5

CASES = [
    dict(s=128),
    dict(s=200),  # ragged: pad keys (and pad queries in JAX's backward) masked
    dict(s=128, blocked_span=(32, 96, 64)),
    dict(s=200, blocked_span=(0, 64, 128)),
]
IDS = ["s128", "ragged_s200", "span", "ragged_span"]


def _inputs(seed, s, b=1, h=2, d=128):
    rng = np.random.RandomState(seed)
    q, k, v, g = (rng.randn(b, h, s, d).astype(np.float32) for _ in range(4))
    return q, k, v, g


def _jax_grads(q, k, v, g, span):
    def loss(q, k, v):
        out = jfa.flash_attention(q, k, v, block_q=128, block_k=128, interpret=True, blocked_span=span)
        return jnp.sum(out * jnp.asarray(g))

    return jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))


def _leaves(*xs):
    return [torch.from_numpy(x).requires_grad_() for x in xs]


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_lse_reference_matches_jax_kernel_interpret(case):
    q, k, v, _ = _inputs(1, case["s"])
    span = case.get("blocked_span")
    ref_out, ref_lse = jfa._flash_impl(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 128**-0.5, block_q=128,
                                       block_k=128, interpret=True, blocked_span=span, return_lse=True)
    out, lse = tfa.flash_attention_lse(*(torch.from_numpy(x) for x in (q, k, v)), 128**-0.5, span)
    assert lse.shape == (1, 2, case["s"]) and lse.dtype == torch.float32
    np.testing.assert_allclose(lse.numpy(), np.asarray(ref_lse), atol=LSE_ATOL, rtol=0)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out), atol=LSE_ATOL, rtol=0)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_autograd_function_matches_jax_grad(case):
    q, k, v, g = _inputs(2, case["s"])
    span = case.get("blocked_span")
    tq, tk, tv = _leaves(q, k, v)
    out = tfa.flash_attention(tq, tk, tv, blocked_span=span, bounded_logits=True)
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    out.backward(torch.from_numpy(g))
    for got, ref in zip((tq.grad, tk.grad, tv.grad), _jax_grads(q, k, v, g, span)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=GRAD_ATOL, rtol=0)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_grads_reference_matches_xla_attention_grads(case):
    q, k, v, g = _inputs(3, case["s"])
    span = case.get("blocked_span")
    ref = jfa._xla_attention_grads(*(jnp.asarray(x) for x in (q, k, v, g)), 128**-0.5, span)
    got = tfa.flash_attention_grads_reference(*(torch.from_numpy(x) for x in (q, k, v, g)), 128**-0.5, span)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=PLAIN_ATOL, rtol=0)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_backward_from_lse_matches_softmax_grads(case):
    """The wrapper's backward (p from the LSE, delta from O) against the softmax
    grads; a natural-log LSE used in the exp2 domain would be off everywhere."""
    q, k, v, g = (torch.from_numpy(x) for x in _inputs(4, case["s"]))
    span = case.get("blocked_span")
    out, lse = tfa.flash_attention_lse(q, k, v, 128**-0.5, span)
    got = tfa.flash_attention_backward(q, k, v, out, lse, g, 128**-0.5, span)
    ref = tfa.flash_attention_grads_reference(q, k, v, g, 128**-0.5, span)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=PLAIN_ATOL, rtol=0)
    wrong = tfa.flash_attention_backward(q, k, v, out, lse * 1.4426950408889634, g, 128**-0.5, span)
    assert float((wrong[0] - ref[0]).abs().max()) > 100 * PLAIN_ATOL


def test_grads_under_checkpoint_equal_plain_grads():
    q, k, v, g = _inputs(5, 200, b=2)

    def f(q, k, v):
        return tfa.flash_attention(q, k, v, blocked_span=(0, 64, 128)) * 2.0

    grads = []
    for remat in (False, True):
        tq, tk, tv = _leaves(q, k, v)
        out = checkpoint(f, tq, tk, tv, use_reentrant=False) if remat else f(tq, tk, tv)
        out.backward(torch.from_numpy(g))
        grads.append((tq.grad, tk.grad, tv.grad))
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, atol=0, rtol=0)


def test_no_grad_takes_the_forward_alone():
    q, k, v, _ = _inputs(6, 128)
    tq, tk, tv = _leaves(q, k, v)
    with torch.no_grad():
        out = tfa.flash_attention(tq, tk, tv)
    assert out.grad_fn is None
    out2 = tfa.flash_attention(*(torch.from_numpy(x) for x in (q, k, v)))
    assert out2.grad_fn is None
    torch.testing.assert_close(out, out2, atol=0, rtol=0)


def test_sdpa_on_cpu_is_differentiable_through_the_plain_path():
    """On the CPU ``sdpa`` takes the plain path (FLUX2_DISABLE_FLASH's path on the card), which
    autograd differentiates through torch ops; its grads agree with the flash VJP's."""
    q, k, v, g = _inputs(7, 160)
    tq, tk, tv = _leaves(q, k, v)
    tattn.sdpa(tq, tk, tv, bounded_logits=True).backward(torch.from_numpy(g))
    ref = tfa.flash_attention_grads_reference(*(torch.from_numpy(x) for x in (q, k, v, g)), 128**-0.5)
    for a, b in zip((tq.grad, tk.grad, tv.grad), ref):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=PLAIN_ATOL, rtol=0)


def test_launch_counters_reset_and_stay_zero_on_cpu():
    tfa.reset_launches()
    q, k, v, g = _inputs(8, 128)
    tq, tk, tv = _leaves(q, k, v)
    tfa.flash_attention(tq, tk, tv).backward(torch.from_numpy(g))
    assert tfa.launch_counts() == {"flash": 0, "flash_lse": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
