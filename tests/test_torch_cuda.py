"""The port's CUDA kernels on the card (marker ``cuda``): K1 (flash attention),
K2 / K3 / K4 (its forward with the LSE and its backward) and K5 / K6 / K7
(quantized matmuls).

Skips without a CUDA device. Imports no JAX, so it runs where JAX is absent:
    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
Kernel vs ``flash_attention_reference`` from the same bf16 inputs, tolerance
1e-2 relative L2 (||out - ref|| / ||ref||): the kernel rounds P to bf16 for
the P V product and its output to bf16, which a model of those roundings puts
at ~2.3e-3. Outputs are softmax-weighted averages, small next to |v| (max
|out| ~0.1-1), so the limit is relative; unmasked pad keys would give
~1.4e-2 at S_k = 1000 and ~4e-2 at S_k = 961.
"""

import os

import pytest
import torch

from flux2_tpu_torch.ops import attention as tattn
from flux2_tpu_torch.ops import flash_attention as tfa
from flux2_tpu_torch.ops import quant as tq
from flux2_tpu_torch.ops import quant_kernels as tqk

pytestmark = pytest.mark.cuda
REL_TOL = 1e-2


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _qkv(device, b, h, s_q, s_k, d=128, dtype=torch.bfloat16):
    g = torch.Generator(device=device).manual_seed(s_q * 7 + s_k)
    return [torch.randn(b, h, s, d, device=device, generator=g).to(dtype) for s in (s_q, s_k, s_k)]


@pytest.mark.parametrize("b,h,s_q,s_k,span", [
    (1, 24, 512, 512, None),
    (3, 24, 768, 768, None),  # the 256^2 served shape, batch 3
    (2, 3, 777, 1000, None),
    (2, 3, 777, 961, None),  # last key tile: 1 real key, 63 pad
    (1, 2, 2560, 2560, (512, 1536, 1536)),
    (2, 3, 128, 200, (0, 64, 0)),  # fully blocked rows: uniform over the real keys
])
def test_kernel_matches_reference(device, b, h, s_q, s_k, span):
    q, k, v = _qkv(device, b, h, s_q, s_k)
    before = tfa.launches
    out = tfa.flash_attention(q, k, v, blocked_span=span)
    torch.cuda.synchronize()
    assert tfa.launches == before + 1
    ref = tfa.flash_attention_reference(q, k, v, blocked_span=span).float()
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    assert float((out.float() - ref).norm() / ref.norm()) <= REL_TOL


def test_wrapper_raises_on_what_the_kernel_does_not_take(device):
    q, k, v = _qkv(device, 1, 2, 256, 256)
    with pytest.raises(TypeError):
        tfa.flash_attention(q.float(), k.float(), v.float())
    with pytest.raises(NotImplementedError):
        tfa.flash_attention(*_qkv(device, 1, 2, 256, 256, d=64))
    with pytest.raises(ValueError):
        tfa.flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2), k, v)
    with pytest.raises(ValueError):
        tfa.flash_attention(q, k.cpu(), v)


def test_sdpa_dispatch_on_cuda(device, monkeypatch):
    q, k, v = _qkv(device, 1, 2, 256, 256)
    before = tfa.launches
    tattn.sdpa(q, k, v, bounded_logits=True)
    assert tfa.launches == before + 1
    monkeypatch.setenv("FLUX2_DISABLE_FLASH", "1")
    out = tattn.sdpa(q, k, v)
    assert tfa.launches == before + 1
    assert os.environ["FLUX2_DISABLE_FLASH"] == "1" and out.shape == q.shape


# K2 / K3 / K4 against their plain f32 versions, as chip_smoke.py holds them:
# out and the gradients within REL_TOL (p and dS enter the tensor cores as
# bf16, ~2.6e-3 measured; one dropped 64-key tile costs ~sqrt(64 / S_k)), the
# LSE within 1e-3 absolute (two f32 sums of the same products, ~1e-6 apart).
@pytest.mark.parametrize("q_shape,k_len,span", [
    ((1, 24, 1056, 128), 1056, None),  # 512^2 training: 32 txt + 1024 img, both tails ragged
    ((1, 4, 320, 128), 704, (64, 192, 400)),
])
def test_training_kernels_match_reference(device, q_shape, k_len, span):
    q, k, v = _qkv(device, q_shape[0], q_shape[1], q_shape[2], k_len)
    dout = torch.randn(q.shape, device=device, generator=torch.Generator(device=device).manual_seed(1)).bfloat16()
    scale = 128**-0.5
    before = tfa.launch_counts()
    out, lse = tfa.flash_attention_lse(q, k, v, scale, span)
    grads = tfa.flash_attention_backward(q, k, v, out, lse, dout, scale, span)
    torch.cuda.synchronize()
    after = tfa.launch_counts()
    assert [after[c] - before[c] for c in ("flash", "flash_lse", "flash_bwd_dq", "flash_bwd_dkv")] == [0, 1, 1, 1]
    ref_out, ref_lse = tfa.flash_attention_lse_reference(q, k, v, scale, span)
    assert _rel(out, ref_out) <= REL_TOL and float((lse - ref_lse).abs().max()) <= 1e-3
    for got, ref in zip(grads, tfa.flash_attention_grads_reference(q, k, v, dout, scale, span)):
        assert got.dtype == torch.bfloat16 and got.shape == ref.shape
        assert _rel(got, ref) <= REL_TOL


def test_autograd_takes_k2_k3_k4_with_grad_and_k1_without(device):
    q, k, v = (t.requires_grad_() for t in _qkv(device, 1, 2, 256, 256))
    before = tfa.launch_counts()
    out = tattn.sdpa(q, k, v, bounded_logits=True)
    out.float().sum().backward()
    with torch.no_grad():
        tattn.sdpa(q, k, v, bounded_logits=True)
    after = tfa.launch_counts()
    assert {c: after[c] - before[c] for c in after} == {"flash": 1, "flash_lse": 1, "flash_bwd_dq": 1,
                                                        "flash_bwd_dkv": 1}
    assert q.grad.dtype == torch.bfloat16 and torch.isfinite(q.grad.float()).all()


def test_backward_wrapper_raises_on_what_the_kernels_do_not_take(device):
    q, k, v = _qkv(device, 1, 2, 256, 256)
    out, lse = tfa.flash_attention_lse(q, k, v, 0.1)
    with pytest.raises(ValueError):
        tfa.flash_attention_backward(q, k, v, out, lse, q.transpose(2, 3), 0.1)  # dout not contiguous
    with pytest.raises(ValueError):
        tfa.flash_attention_backward(q, k, v, out, lse[:, :, :128].contiguous(), q, 0.1)
    with pytest.raises(TypeError):
        tfa.flash_attention_backward(q, k, v, out.float(), lse, q, 0.1)


# K5 / K6 / K7 against their plain versions, relative L2 error, as chip_smoke.py
# holds them. K5 and K6 compute the same int32 sums and the same f32 products
# and sums in the same order as their plain versions (no contracted
# multiply-add), so they should agree exactly; K7's f32 sums run in another
# order than the plain f32 matmul, which flips a bf16 output rounding now and
# then (~1e-4). 1e-3 is 40x below what one dropped 64-wide K tile gives at
# K = 3072 (~0.14) and below a neighbouring column's or group's scale (~1e-2).
QMM_REL_TOL = 1e-3


def _qmm_inputs(device, m, k, n, dtype=torch.bfloat16):
    g = torch.Generator(device=device).manual_seed(m * 31 + k * 7 + n)
    x = torch.randn(m, k, device=device, generator=g).to(dtype)
    w = (torch.randn(n, k, device=device, generator=g) * k**-0.5).bfloat16()
    return x, w


def _rel(out, ref):
    return float((out.float() - ref.float()).norm() / ref.float().norm())


@pytest.mark.parametrize("kind", ["w8a8", "w4a8", "qint8", "int4"])
@pytest.mark.parametrize("m,k,n,dtype", [
    (1, 3072, 18432, torch.bfloat16),  # bs=1 modulation (K7: M=8, its gate)
    (300, 2560, 9216, torch.bfloat16),  # ragged M, Qwen3-4B gate_proj
    (3, 1024, 3072, torch.float32),  # f32 activations: the quantized time embedding
])
def test_quantized_matmul_matches_reference(device, kind, m, k, n, dtype):
    if kind in ("qint8", "int4"):
        if dtype != torch.bfloat16:
            pytest.skip("K7 takes bf16 activations only")
        m = max(m, 8)
    x, w = _qmm_inputs(device, m, k, n, dtype)
    fmt = {"w8a8": tq.to_w8a8, "w4a8": tq.to_w4a8}.get(kind)
    qw = fmt(w) if fmt else tq.quantize(w, kind)
    kernel, reference, counter = {
        "w8a8": (tqk.w8a8_matmul, tqk.w8a8_matmul_reference, "w8a8"),
        "w4a8": (tqk.w4a8_matmul, tqk.w4a8_matmul_reference, "w4a8"),
        "qint8": (tqk.dequant_matmul, tqk.dequant_matmul_reference, "dequant_int8"),
        "int4": (tqk.dequant_matmul, tqk.dequant_matmul_reference, "dequant_int4"),
    }[kind]
    before = tqk.launches[counter]
    out = kernel(x, qw)
    torch.cuda.synchronize()
    assert tqk.launches[counter] == before + 1
    ref = reference(x, qw)
    assert out.dtype == x.dtype and out.shape == (m, n)
    assert torch.isfinite(out).all()
    assert _rel(out, ref) <= QMM_REL_TOL


def test_q_linear_routes_on_cuda(device, monkeypatch):
    """q_linear launches the kernel its gate picks and dequantizes otherwise."""
    x, w = _qmm_inputs(device, 16, 512, 640)
    before = dict(tqk.launches)
    tq.q_linear(x, tq.to_w8a8(w))  # N = 640 fails the K5 gate: dequant path
    monkeypatch.setenv("FLUX2_PALLAS_DEQUANT", "1")
    tq.q_linear(x, tq.quantize(w, "qint8"))  # K7 takes N % 128
    assert tqk.launches["w8a8"] == before["w8a8"]
    assert tqk.launches["dequant_int8"] == before["dequant_int8"] + 1


def test_quantized_wrappers_raise_on_what_the_kernels_do_not_take(device):
    x, w = _qmm_inputs(device, 16, 512, 256)
    with pytest.raises(ValueError):
        tqk.w8a8_matmul(x[:, :256], tq.to_w8a8(w))  # K disagrees
    with pytest.raises(TypeError):
        tqk.dequant_matmul(x.float(), tq.quantize(w, "qint8"))
    with pytest.raises(ValueError):
        tqk.w4a8_matmul(x, tq.to_w4a8(w).cpu())
