"""The port's CUDA flash-attention kernel on the card (marker ``cuda``).

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
