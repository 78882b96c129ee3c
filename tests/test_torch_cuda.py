"""The port's CUDA kernels on the card (marker ``cuda``): K1 (flash attention),
K2 / K3 / K4 (its forward with the LSE and its backward) and K5 / K6 / K7
(quantized matmuls); K1 at the I2I and klein-9b-kv shapes, and a tiny I2I and
klein-9b-kv generate on the card with exact K1 launch counts; a tiny POST
/generate over HTTP equal to the in-process generate, the subject U-Net
on the card against the CPU, a tiny real-data ``train-lora`` and a
``remat: "dots"`` step against ``remat=True`` on the kernels; K5, K6 and
the prologue at Mistral's M = 1 decode shapes (equal to the bit), K1 at
Dev's 48 heads, and a tiny Mistral's KV-cached decode on the card.

Skips without a CUDA device. Imports no JAX, so it runs where JAX is absent:
    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
Kernel vs ``flash_attention_reference`` from the same bf16 inputs, tolerance
1e-2 relative L2 (||out - ref|| / ||ref||): the kernel rounds P to bf16 for
the P V product and its output to bf16, which a model of those roundings puts
at ~2.3e-3. Outputs are softmax-weighted averages, small next to |v| (max
|out| ~0.1-1), so the limit is relative; unmasked pad keys would give
~1.4e-2 at S_k = 1000 and more where the last 128-key tile holds fewer
real keys (S_k = 961: 65 of 128, S_k = 897: 1 of 128).
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
    (2, 3, 777, 961, None),  # last 128-key tile: 65 real keys, 63 pad
    (2, 3, 777, 897, None),  # last 128-key tile: 1 real key, 127 pad
    (1, 2, 2560, 2560, (512, 1536, 1536)),
    (1, 2, 2560, 2560, (100, 1300, 1000)),  # the span cuts query and key tiles mid-way
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


# The I2I slice's regimes at Klein-9B's 32 heads: the KV extract pass (512
# text + 4096 reference + 4096 output tokens, the reference queries blind to
# the output keys) and a cached step (4608 queries over 8704 keys).
@pytest.mark.parametrize("s_q,s_k,span", [(8704, 8704, (512, 4608, 4608)), (4608, 8704, None)],
                         ids=["kv_extract", "kv_cached"])
def test_kernel_matches_reference_at_the_kv_shapes(device, s_q, s_k, span):
    q, k, v = _qkv(device, 1, 32, s_q, s_k)
    before = tfa.launches
    out = tfa.flash_attention(q, k, v, blocked_span=span)
    torch.cuda.synchronize()
    assert tfa.launches == before + 1
    for h in range(0, 32, 8):  # the plain f32 version over 8 heads at a time (its logits: 2.4 GB)
        ref = tfa.flash_attention_reference(q[:, h : h + 8], k[:, h : h + 8], v[:, h : h + 8], blocked_span=span)
        assert _rel(out[:, h : h + 8], ref) <= REL_TOL


def _tiny_pipeline(device, model):
    """A tiny random pipeline on the card (1 double + 2 single blocks, 2 heads; a 4-level VAE)."""
    from flux2_tpu_torch.models.flux2.config import Flux2Model, Flux2TransformerConfig
    from flux2_tpu_torch.models.flux2.vae import VAEConfig
    from flux2_tpu_torch.pipeline.pipeline import Flux2Pipeline

    tc = Flux2TransformerConfig(num_layers=1, num_single_layers=2, num_attention_heads=2, attention_head_dim=128,
                                joint_attention_dim=96, guidance_embeds=False)
    vc = VAEConfig(block_out_channels=(8, 8, 16, 16), layers_per_block=1, norm_num_groups=4)
    return Flux2Pipeline.from_random(Flux2Model(model), device=device, generator=torch.Generator(device).manual_seed(0),
                                     transformer_config=tc, vae_config=vc)


@pytest.mark.parametrize("model,steps,launches,split", [
    ("klein-4b", 2, 3 * 2, {"kv_loops": 0, "extract": 0, "cached": 0}),
    ("klein-9b-kv", 3, 3 + 3 * 2, {"kv_loops": 1, "extract": 3, "cached": 3 * 2}),
], ids=["i2i", "kv"])
def test_tiny_i2i_generate_launches_k1_on_every_attention(device, monkeypatch, model, steps, launches, split):
    """256^2 output and reference, 8 text tokens: I2I attends 8 + 256 + 256
    tokens in each of the 3 blocks a step; klein-9b-kv extracts at step 0 (3
    launches inside forward_kv_extract) and attends 264 queries over 520 keys
    after it (3 a step inside forward_kv_cached), all in one _denoise_kv_cached."""
    import numpy as np

    from flux2_tpu_torch.models.flux2.transformer import Flux2Transformer
    from flux2_tpu_torch.pipeline.pipeline import Flux2Pipeline

    seen = {"kv_loops": 0, "extract": 0, "cached": 0}

    def counting(cls, name, key):
        fn = getattr(cls, name)

        def wrapped(*args, **kwargs):
            before = tfa.launch_counts()["flash"]
            try:
                return fn(*args, **kwargs)
            finally:
                seen[key] += 1 if key == "kv_loops" else tfa.launch_counts()["flash"] - before
        monkeypatch.setattr(cls, name, wrapped)

    counting(Flux2Pipeline, "_denoise_kv_cached", "kv_loops")
    counting(Flux2Transformer, "forward_kv_extract", "extract")
    counting(Flux2Transformer, "forward_kv_cached", "cached")
    pipe = _tiny_pipeline(device, model)
    ref = np.random.RandomState(0).rand(256, 256, 3).astype(np.float32)
    lat, ids = pipe.encode_reference_images([ref])
    emb = torch.randn(1, 8, 96, device=device, generator=torch.Generator(device).manual_seed(1))
    before = tfa.launch_counts()
    res = pipe.generate(embeddings=emb, height=256, width=256, num_steps=steps, seed=3, reference_latents=lat,
                        reference_ids=ids)
    after = tfa.launch_counts()
    assert {c: after[c] - before[c] for c in after} == {"flash": launches, "flash_lse": 0, "flash_bwd_dq": 0,
                                                        "flash_bwd_dkv": 0}
    assert seen == split
    assert res.latents_device.shape == (1, 256, 128) and torch.isfinite(res.latents_device).all()
    assert res.image.shape == (256, 256, 3)


def test_tiny_inpaint_keeps_the_source_tokens_to_the_bit(device):
    """A 256^2 RePaint inpaint on the card, the source as I2I reference: the
    tokens outside the mask equal the clean source latents to the bit (the
    hook's float32 blend at sigma_next == 0), those inside moved; K1 launched
    3 times a step."""
    import numpy as np

    from flux2_tpu_torch.chains.inpaint import MaskedInpaintingChain, pack_mask_for_latent_blending

    pipe = _tiny_pipeline(device, "klein-4b")
    image = np.random.RandomState(2).rand(256, 256, 3).astype(np.float32)
    mask = np.zeros((256, 256), np.float32)
    mask[64:192, 64:192] = 1.0
    emb = torch.randn(1, 8, 96, device=device, generator=torch.Generator(device).manual_seed(1))
    before = tfa.launch_counts()["flash"]
    res = MaskedInpaintingChain(pipe, "x", image, mask, embeddings=emb, use_image_as_reference=True, steps=4).run()
    assert tfa.launch_counts()["flash"] - before == 3 * 4
    source = pipe.encode_image_to_packed_sequence(image)
    keep = pack_mask_for_latent_blending(mask, 256, 256)[0, :, 0].to(device) == 0
    assert torch.equal(res.latents_device[0, keep], source[0, keep])
    assert float((res.latents_device[0, ~keep] - source[0, ~keep]).abs().max()) > 0.1


def test_cancel_after_step_2_of_4_runs_3_steps_of_k1(device):
    """on_progress sets the flag at step 2: the flag is read after step 3, as
    JAX reads it, so 3 steps of 3 K1 launches run."""
    import threading

    from flux2_tpu_torch.pipeline.pipeline import GenerationCancelled

    pipe = _tiny_pipeline(device, "klein-4b")
    cancel = threading.Event()
    emb = torch.randn(1, 8, 96, device=device, generator=torch.Generator(device).manual_seed(1))
    before = tfa.launch_counts()["flash"]
    with pytest.raises(GenerationCancelled, match=r"^cancelled at step 3/4$"):
        pipe.generate(embeddings=emb, height=256, width=256, num_steps=4, cancel=cancel,
                      on_progress=lambda k, n: cancel.set() if k >= 2 else None)
    assert tfa.launch_counts()["flash"] - before == 3 * 3


def test_http_generate_pixels_equal_the_in_process_generate(device):
    """POST /generate at 256^2 through the port's handler on a tiny card
    pipeline: the PNG's pixels equal the in-process generate written through
    JAX's conversion (``to_u8``) to the bit; K1 3 launches a step."""
    import json
    import threading
    import urllib.request
    from http.server import ThreadingHTTPServer

    import numpy as np

    from flux2_tpu_torch.io.png import decode_png, to_u8
    from flux2_tpu_torch.serve import Flux2Server, make_handler

    pipe = _tiny_pipeline(device, "klein-4b")
    emb = torch.randn(1, 8, 96, device=device, generator=torch.Generator(device).manual_seed(1))
    server = Flux2Server(pipe, embeddings_fn=lambda prompt: emb)
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(server))
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        req = {"prompt": "x", "height": 256, "width": 256, "steps": 4, "seed": 9}
        before = tfa.launch_counts()["flash"]
        post = urllib.request.Request(f"http://127.0.0.1:{httpd.server_address[1]}/generate",
                                      data=json.dumps(req).encode(), method="POST")
        with urllib.request.urlopen(post) as r:
            png = r.read()
        assert tfa.launch_counts()["flash"] - before == 3 * 4
    finally:
        httpd.shutdown()
        httpd.server_close()
        server.shutdown()
    res = pipe.generate(embeddings=emb, height=256, width=256, num_steps=4, seed=9)
    assert np.array_equal(decode_png(png), to_u8(res.image))


def test_segmenter_on_the_card_matches_the_cpu(device):
    """The committed U-Net on the card against the same weights on the CPU,
    both float32 with TF32 off: the probabilities within 1e-4 relative L2."""
    import numpy as np

    from flux2_tpu_torch.chains import segmenter as seg

    small = seg.synth_composite(np.random.RandomState(10_001))[0][None]
    on_card, on_cpu = seg.load_default(device).predict(small), seg.load_default("cpu").predict(small)
    assert float(np.linalg.norm(on_card - on_cpu) / np.linalg.norm(on_cpu)) <= 1e-4


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
    with pytest.raises(ValueError):  # the forward kernels take its row max before the scaling
        tfa.flash_attention(q, k, v, scale=-0.1)


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
# bf16, ~2.6e-3 measured; one dropped 64-row tile costs ~sqrt(64 / S)), the
# LSE within 1e-3 absolute (two f32 sums of the same products, ~1e-6 apart).
TRAINING_CASES = [  # (q shape, S_k, span), as chip_smoke.TRAIN_ATTENTION_CASES
    ((1, 24, 1056, 128), 1056, None),  # 512^2 training: 32 txt + 1024 img, both tails ragged
    ((1, 4, 320, 128), 704, (64, 192, 400)),
    ((1, 24, 897, 128), 897, None),  # one real query and one real key in the last 64- and 128-row tiles
    ((1, 24, 2560, 128), 2560, (100, 1300, 1000)),  # the span cuts query and key tiles mid-way
    ((1, 24, 777, 128), 1000, None),  # S_q != S_k, both ragged
]


def _training_inputs(device, q_shape, k_len):
    q, k, v = _qkv(device, q_shape[0], q_shape[1], q_shape[2], k_len)
    dout = torch.randn(q.shape, device=device, generator=torch.Generator(device=device).manual_seed(1)).bfloat16()
    return q, k, v, dout


@pytest.mark.parametrize("q_shape,k_len,span", TRAINING_CASES)
def test_training_kernels_match_reference(device, q_shape, k_len, span):
    q, k, v, dout = _training_inputs(device, q_shape, k_len)
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


def test_backward_kernels_are_deterministic(device):
    """K3 owns its dQ rows and K4 its dK/dV rows (no atomics): a second call gives the same bits."""
    q, k, v, dout = _training_inputs(device, (1, 24, 777, 128), 1000)
    out, lse = tfa.flash_attention_lse(q, k, v, 128**-0.5, (100, 500, 600))
    first = tfa.flash_attention_backward(q, k, v, out, lse, dout, 128**-0.5, (100, 500, 600))
    second = tfa.flash_attention_backward(q, k, v, out, lse, dout, 128**-0.5, (100, 500, 600))
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


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


# K6 and K7 at the gates' edge shapes (one 512-block, the narrowest N each
# gate takes, one row, a ragged last M tile) and at chip_smoke.QMM_SHAPES.
QMM_SERVED = [(4096, 3072, 3072), (4608, 3072, 9216), (4096, 9216, 3072), (512, 7680, 3072), (1, 3072, 18432),
              (512, 2560, 9216), (16, 512, 2560)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m,k,n", [(1, 512, 256), (8, 512, 256), (100, 512, 256), (4095, 512, 256), *QMM_SERVED])
def test_w4a8_kernel_equals_its_plain_version_to_the_bit(device, m, k, n, dtype):
    """K6's s32 block sums are exact in any order and its f32 fold keeps the
    plain version's operations and order, so both output types agree to the bit."""
    x, w = _qmm_inputs(device, m, k, n, dtype)
    qw = tq.to_w4a8(w)
    out = tqk.w4a8_matmul(x, qw)
    again = tqk.w4a8_matmul(x, qw)
    torch.cuda.synchronize()
    assert out.dtype == dtype and out.shape == (m, n)
    assert torch.equal(out, tqk.w4a8_matmul_reference(x, qw))
    assert torch.equal(out, again)


@pytest.mark.parametrize("fmt", ["qint8", "int4"])
@pytest.mark.parametrize("m,k,n", [(8, 512, 128), (100, 512, 128), (4095, 512, 128),
                                   *[(max(m, 8), k, n) for m, k, n in QMM_SERVED]])
def test_dequant_kernel_matches_reference_and_repeats(device, fmt, m, k, n):
    """K7 at the edge shapes (M = 8 is its gate's least) and the served ones:
    within QMM_REL_TOL, and a second call gives the same bits."""
    x, w = _qmm_inputs(device, m, k, n)
    qw = tq.quantize(w, fmt)
    out = tqk.dequant_matmul(x, qw)
    again = tqk.dequant_matmul(x, qw)
    torch.cuda.synchronize()
    assert out.dtype == torch.bfloat16 and out.shape == (m, n) and torch.isfinite(out).all()
    assert _rel(out, tqk.dequant_matmul_reference(x, qw)) <= QMM_REL_TOL
    assert torch.equal(out, again)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m,k,n", [(1, 512, 256), (8, 512, 256), (100, 512, 256), (4095, 512, 256), *QMM_SERVED])
def test_w8a8_kernel_equals_its_plain_version_to_the_bit(device, m, k, n, dtype):
    """K5's s32 sums are exact and its epilogue is the plain version's
    float(acc) * (xs * ws), so both output types agree to the bit."""
    x, w = _qmm_inputs(device, m, k, n, dtype)
    qw = tq.to_w8a8(w)
    out = tqk.w8a8_matmul(x, qw)
    again = tqk.w8a8_matmul(x, qw)
    torch.cuda.synchronize()
    assert out.dtype == dtype and out.shape == (m, n)
    assert torch.equal(out, tqk.w8a8_matmul_reference(x, qw))
    assert torch.equal(out, again)


def _tie_values(amax: float, dtype: torch.dtype) -> torch.Tensor:
    """Values of ``dtype`` within [-amax, amax] whose f32 quotient by the scale
    of a segment with that amax is exactly n + 1/2 (searched on the CPU)."""
    amax = torch.tensor(amax).to(dtype).float()
    scale = torch.clamp(amax, min=1e-30) * (1.0 / 127.0)
    if dtype == torch.bfloat16:  # every positive bf16 value up to amax
        cand = (torch.arange(0, 1 << 15, dtype=torch.int32) << 16).view(torch.float32)
    else:
        cand = (torch.arange(-127, 127, dtype=torch.float32) + 0.5) * scale
    cand = cand[torch.isfinite(cand) & (cand.abs() <= amax)]
    cand = torch.cat([cand, -cand])
    q = cand / scale
    return cand[(q - q.floor()) == 0.5].to(dtype)


def _prologue_input(device, m, k, block, dtype):
    """Gaussian rows, with row 0 zero and row 1's segments holding half-way values (each at its segment's amax)."""
    g = torch.Generator(device=device).manual_seed(m * 13 + k + block)
    x = torch.randn(m, k, device=device, generator=g).to(dtype)
    x[0] = 0
    if m > 1:
        ties = _tie_values(127 / 64, dtype)  # the scale is 2^-6: every (n + 1/2) / 64 is a tie
        assert ties.numel() > 0
        row = ties.repeat(k // ties.numel() + 1)[:k].reshape(k // block, block).clone()
        row[:, 0] = 127 / 64
        x[1] = row.reshape(k).to(device)
    return x


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("per_block", [False, True], ids=["block_k", "block_512"])
@pytest.mark.parametrize("m,k", [(1, 512), (100, 512), (4095, 512), *sorted({(m, k) for m, k, _ in QMM_SERVED})])
def test_prologue_kernel_equals_the_plain_chain_to_the_bit(device, m, k, per_block, dtype):
    """The hand-written prologue against quantize_rows / quantize_row_blocks
    (the torch chain on the card): the same int8 codes and the same f32
    scales, a zero row (scale 1e-30 / 127, codes 0) and exact ties included."""
    block = 512 if per_block else k
    x = _prologue_input(device, m, k, block, dtype)
    before = tqk.launches["quantize_rows"]
    xq, xs = tqk.quantize_activations(x, block)
    torch.cuda.synchronize()
    assert tqk.launches["quantize_rows"] == before + 1
    ref_q, ref_s = tqk.quantize_row_blocks(x, block) if per_block else tqk.quantize_rows(x)
    assert torch.equal(xq, ref_q)
    assert torch.equal(xs.view(torch.int32).reshape(ref_s.shape), ref_s.view(torch.int32))
    assert not xq[0].any() and xs[0, 0].item() == (torch.tensor(1e-30) * (1.0 / 127.0)).item()


def test_quantized_wrappers_bump_the_prologue_and_their_own_counter(device):
    x, w = _qmm_inputs(device, 64, 1024, 512)
    for kernel, fmt, counter in ((tqk.w8a8_matmul, tq.to_w8a8, "w8a8"), (tqk.w4a8_matmul, tq.to_w4a8, "w4a8")):
        before = dict(tqk.launches)
        kernel(x, fmt(w))
        torch.cuda.synchronize()
        assert {c: tqk.launches[c] - before[c] for c in before} == {
            c: int(c in (counter, "quantize_rows")) for c in before}


# -- QLoRA's input gradient (R2), LoRA inference and prequantized checkpoints ----------


@pytest.mark.parametrize("fmt", ["w8a8", "w4a8", "qint8"])
def test_kernel_route_carries_the_input_gradient(device, fmt, monkeypatch):
    """q_linear on K5 / K6 / K7 under autograd (ops.quant.KernelLinear): x.grad
    within 1e-2 relative L2 of autograd's on the dequantize-then-F.linear route
    (they differ by the forward's rounding carried through dy), not zero, and
    the kernel launched once."""
    x0, w = _qmm_inputs(device, 1056, 3072, 3072)
    qw = {"w8a8": tq.to_w8a8, "w4a8": tq.to_w4a8}.get(fmt, lambda t: tq.quantize(t, "qint8"))(w)
    monkeypatch.setenv("FLUX2_PALLAS_DEQUANT", "1")
    counter = {"w8a8": "w8a8", "w4a8": "w4a8"}.get(fmt, "dequant_int8")

    def grad():
        x = x0.clone().requires_grad_(True)
        y = tq.q_linear(x, qw)
        y.float().square().sum().backward()
        return x.grad

    before = tqk.launches[counter]
    kernel_grad = grad()
    assert tqk.launches[counter] == before + 1
    monkeypatch.setattr(tq, "kernel_route", lambda x, w: None)
    plain_grad = grad()
    assert tqk.launches[counter] == before + 1
    assert float(kernel_grad.abs().max()) > 0 and torch.isfinite(kernel_grad).all()
    assert _rel(kernel_grad, plain_grad) <= REL_TOL


def _tiny_cli_pipeline(device, quantization="bf16"):
    """A tiny random-init pipeline built by cli.main.build_pipeline on the card
    (1 double + 2 single blocks, 2 heads, a 28-layer tiny Qwen3 encoder)."""
    import argparse
    import dataclasses

    from flux2_tpu_torch.cli import main as cli
    from flux2_tpu_torch.models.flux2.config import Flux2TransformerConfig
    from flux2_tpu_torch.models.flux2.vae import VAEConfig
    from flux2_tpu_torch.models.text_encoders.config import TINY_DECODER

    tc = Flux2TransformerConfig(num_layers=1, num_single_layers=2, num_attention_heads=2, attention_head_dim=128,
                                joint_attention_dim=192, guidance_embeds=False)
    vc = VAEConfig(block_out_channels=(8, 8, 16, 16), layers_per_block=1, norm_num_groups=4)
    args = argparse.Namespace(model="klein-4b", quantization=quantization, random_init=True)
    return cli.build_pipeline(args, device, torch.Generator(device).manual_seed(0), transformer_config=tc,
                              vae_config=vc, encoder_config=dataclasses.replace(TINY_DECODER, num_hidden_layers=28,
                                                                                vocab_size=600))


def test_tiny_lora_t2i_runs_its_turbo_steps_on_k1(device, tmp_path):
    """A LoRA with a Turbo sidecar (num_steps 2) merged through cli.main's
    apply_loras: 3 K1 launches a step for 2 steps, the keyword prefixed."""
    import chip_smoke
    from flux2_tpu_torch.cli import main as cli

    pipe = _tiny_cli_pipeline(device)
    path = str(tmp_path / "lora.safetensors")
    chip_smoke._write_lora(path, chip_smoke._bfl_lora_state(pipe.transformer.config, 4, torch.Generator().manual_seed(1)))
    before = pipe.transformer.double_blocks[0].to_q.clone()
    cli.apply_loras(pipe, [f"{path}:0.8"])
    assert not torch.equal(before, pipe.transformer.double_blocks[0].to_q)
    counts = tfa.launch_counts()
    res = pipe.generate(prompt="a fox", height=256, width=256, seed=0)
    assert tfa.launch_counts()["flash"] - counts["flash"] == 3 * 2 and res.num_steps == 2
    assert res.final_prompt == "CHIPSTYLE, a fox" and torch.isfinite(res.latents_device).all()


def test_tiny_prequantized_w8a8_forward_launches_k5(device, tmp_path):
    """A qint8 DiT exported on the card, read back (JAX's layout) and converted
    to w8a8: equal to the in-memory conversion to the bit, one K5 launch per
    weight that passes K5's gate in a forward."""
    import numpy as np

    from flux2_tpu_torch.io import checkpoints as tck
    from flux2_tpu_torch.ops import latents as lu
    from flux2_tpu_torch.ops.rope import rope_embeddings

    pipe = _tiny_cli_pipeline(device)
    model = tq.quantize_params(pipe.transformer, "qint8", min_size=1)
    path = tck.export_prequantized(model, str(tmp_path), "qint8")
    tree, meta = tck.load_prequantized(path)
    loaded = tq.quantize_params(tck.transformer_from_tree(tree, model.config, device), "w8a8")
    tq.quantize_params(model, "w8a8")
    state, want = dict(loaded.named_buffers()) | dict(loaded.named_parameters()), dict(model.named_buffers())
    want.update(model.named_parameters())
    assert sorted(state) == sorted(want) and all(torch.equal(state[k], want[k]) for k in want)
    g = torch.Generator(device).manual_seed(2)
    x = torch.randn(1, 256, 128, device=device, generator=g).bfloat16()
    emb = torch.randn(1, 8, 192, device=device, generator=g).bfloat16()
    ids = np.concatenate([lu.text_position_ids(8), lu.image_position_ids(256, 256)])
    cos, sin = rope_embeddings(torch.from_numpy(ids).to(device))
    gated = sum(tq.kernel_route(torch.empty(8, loaded.get_submodule(n).orig_in, device=device, dtype=torch.bfloat16),
                                loaded.get_submodule(n)) == "w8a8" for n in tq.quantized_names(loaded))
    before = tqk.launches["w8a8"]
    with torch.inference_mode():
        v = loaded(x, emb, torch.tensor([0.5], device=device), cos, sin)
    assert tqk.launches["w8a8"] - before == gated > 0 and torch.isfinite(v).all()


def test_tiny_real_data_training_on_the_card(device, tmp_path):
    """train-lora --random-init on a dataset at a tiny size on the card: the
    real data path (VAE encodes, the random encoder, control images) and two
    steps on K2 / K3 / K4 (2 blocks: K2 4, K3 2, K4 2 a step under remat)."""
    from flux2_tpu_torch.cli.main import parse_args
    from flux2_tpu_torch.cli.train import run_training
    from flux2_tpu_torch.models.flux2.config import Flux2TransformerConfig
    from flux2_tpu_torch.models.flux2.vae import VAEConfig
    from flux2_tpu_torch.utils import synthetic

    data = synthetic.write_dataset(str(tmp_path / "data"), 0, [(64, 64), (64, 96)], control=(0, 1))
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text(f"model: {{name: klein-4b}}\nlora: {{rank: 4}}\ndataset: {{path: {data['dataset']}, image_size: 64, "
                   f"control_path: {data['control']}}}\ntraining: {{max_steps: 2}}\ncheckpoints: {{output: "
                   f"{tmp_path / 'out'}, save_every: 0}}\n")
    tc = Flux2TransformerConfig(num_layers=1, num_single_layers=1, num_attention_heads=2, attention_head_dim=128,
                                joint_attention_dim=96, guidance_embeds=True)
    vc = VAEConfig(block_out_channels=(8, 8, 16, 16), layers_per_block=1, norm_num_groups=4)
    tfa.reset_launches()
    history = run_training(parse_args(["train-lora", "--config", str(cfg), "--random-init"]), device,
                           transformer_config=tc, vae_config=vc)
    assert [r["step"] for r in history] == [1, 2] and all(r["loss"] == r["loss"] and r["grad_norm"] > 0
                                                          for r in history)
    assert tfa.launch_counts() == {"flash": 0, "flash_lse": 8, "flash_bwd_dq": 4, "flash_bwd_dkv": 4}


def test_tiny_remat_dots_step_equals_block_remat_on_the_card(device):
    """remat "dots" against True on the kernels: the same loss and LoRA
    gradient to the bit, and the same K2 / K3 / K4 launches (the policy keeps
    the 2-D products only; the attention is recomputed)."""
    import numpy as np

    from flux2_tpu_torch.models.flux2.config import Flux2TransformerConfig
    from flux2_tpu_torch.models.flux2.transformer import Flux2Transformer
    from flux2_tpu_torch.ops import latents as lu
    from flux2_tpu_torch.ops.rope import rope_embeddings
    from flux2_tpu_torch.training import lora as tlora
    from flux2_tpu_torch.training import trainer

    tc = Flux2TransformerConfig(num_layers=1, num_single_layers=2, num_attention_heads=2, attention_head_dim=128,
                                joint_attention_dim=96, guidance_embeds=False)
    g = torch.Generator(device).manual_seed(5)
    model = Flux2Transformer(tc, device=device, generator=g)
    lora = tlora.init_lora(model, tlora.LoRAConfig(4, 8.0), g)
    with torch.no_grad():
        for name, p in lora.named_parameters():
            if name.endswith(".b"):
                p.normal_(generator=g).mul_(1e-2)
    ids = np.concatenate([lu.text_position_ids(16), lu.image_position_ids(256, 256)])
    cos, sin = rope_embeddings(torch.from_numpy(ids).to(device))
    lat, noise = (torch.randn(1, 256, 128, device=device, generator=g) for _ in range(2))
    emb = torch.randn(1, 16, 96, device=device, generator=g)
    out = {}
    for remat in (True, "dots"):
        for p in lora.parameters():
            p.grad = None
        tfa.reset_launches()
        loss = trainer.flow_matching_loss(model, lora, trainer.TrainConfig(rank=4, alpha=8.0, remat=remat), lat, emb,
                                          noise, torch.tensor([0.4], device=device), cos, sin)
        loss.backward()
        out[remat] = (float(loss.detach()), [p.grad.clone() for p in lora.parameters()], tfa.launch_counts())
    assert out[True][0] == out["dots"][0] and all(torch.equal(a, b) for a, b in zip(out[True][1], out["dots"][1]))
    assert out[True][2] == out["dots"][2] == {"flash": 0, "flash_lse": 6, "flash_bwd_dq": 3, "flash_bwd_dkv": 3}


# -- the Dev / text-generation slice -------------------------------------------------------------------

# Mistral Small 3.2's projections at the published width, as a decode token (M = 1), a 37-token
# prefill and a 512-token encode give them: (M, K, N).
MISTRAL_SHAPES = [(1, 5120, 4096), (1, 5120, 1024), (1, 5120, 32768), (1, 32768, 5120), (37, 5120, 32768),
                  (512, 32768, 5120)]


@pytest.mark.parametrize("m,k,n", MISTRAL_SHAPES)
def test_k5_k6_and_the_prologue_at_the_mistral_shapes_equal_their_plain_versions(device, m, k, n):
    """A decode row is 1 row of a 128-row tile: the rows past M must read as
    zeros and never be stored, and row 0's scale is the only one read. K5,
    K6 and the prologue (per row, and per 512-block) equal to the bit."""
    x, w = _qmm_inputs(device, m, k, n)
    for fmt, kernel, plain in (("w8a8", tqk.w8a8_matmul, tqk.w8a8_matmul_reference),
                               ("w4a8", tqk.w4a8_matmul, tqk.w4a8_matmul_reference)):
        qw = tq.to_w8a8(w) if fmt == "w8a8" else tq.to_w4a8(w)
        out = kernel(x, qw)
        torch.cuda.synchronize()
        assert out.shape == (m, n) and torch.equal(out, plain(x, qw)), fmt
    for block, plain in ((k, lambda: tqk.quantize_rows(x)), (512, lambda: tqk.quantize_row_blocks(x, 512))):
        xq, xs = tqk.quantize_activations(x, block)
        ref_q, ref_s = plain()
        assert torch.equal(xq, ref_q) and torch.equal(xs.reshape(ref_s.shape), ref_s)


def test_k1_at_48_heads_matches_reference(device):
    """Dev's 48 heads (hidden 6144) at a small sequence."""
    q, k, v = _qkv(device, 1, 48, 640, 640)
    before = tfa.launches
    out = tfa.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert tfa.launches == before + 1
    assert _rel(out, tfa.flash_attention_reference(q, k, v)) <= REL_TOL


def test_mistral_decode_on_the_card(device):
    """A tiny llama4 Mistral in bf16 on the card: prefill + 8 decode_steps
    against forward_logits on the same tokens (relative L2 1e-2 a row: the
    cache holds bf16 keys, as forward_logits' stream); under w8a8 a greedy
    decode launches K5 7 times a layer for the prefill and for each step
    (the widths pass K5's gate; the LM head stays dense)."""
    from flux2_tpu_torch.models.text_encoders import generation as gen
    from flux2_tpu_torch.models.text_encoders.config import DecoderConfig
    from flux2_tpu_torch.models.text_encoders.decoder import Qwen3Decoder, init_kv_cache
    from flux2_tpu_torch.models.text_encoders.extractor import quantize_encoder_params

    cfg = DecoderConfig(vocab_size=1300, hidden_size=512, intermediate_size=1024, num_hidden_layers=3,
                        num_attention_heads=8, num_key_value_heads=4, head_dim=64, rms_norm_eps=1e-5,
                        llama4_scaling_beta=0.1, original_max_position_embeddings=8)
    dec = Qwen3Decoder(cfg, device=device, generator=torch.Generator(device=device).manual_seed(0))
    ids = torch.randint(0, 1300, (1, 20), device=device, generator=torch.Generator(device=device).manual_seed(1))
    with torch.inference_mode():
        full = dec.forward_logits(ids)
        cache = init_kv_cache(cfg, 1, 24, torch.bfloat16, device)
        rows = [dec.prefill(ids[:, :12], cache)[0]]
        rows += [dec.decode_step(ids[:, t:t + 1], cache)[0] for t in range(12, 20)]
    for i, row in enumerate(rows):
        assert _rel(row, full[:, 11 + i]) <= REL_TOL
    quantize_encoder_params(dec, "w8a8")
    before = tqk.launches["w8a8"]
    out = gen.generate(dec, ids[0].tolist(), gen.GenerateParameters(max_tokens=6, temperature=0.0))
    torch.cuda.synchronize()
    assert len(out) == 6 and tqk.launches["w8a8"] - before == 7 * 3 * (1 + 6)  # the prefill, then 6 steps


def test_tiny_mistral_vlm_w8a8_on_the_card(device, monkeypatch):
    """A tiny Mistral VLM (the decoder above, a one-block Pixtral) with its LM
    at w8a8: a greedy analyze_image launches K5 (and the prologue) exactly 7 a
    layer for the prefill and for each stepped token, and its reply equals the
    same run with K5 replaced by its plain version (equal to the bit)."""
    from flux2_tpu_torch.models.text_encoders import generation as gen
    from flux2_tpu_torch.models.text_encoders.config import DecoderConfig
    from flux2_tpu_torch.models.text_encoders.decoder import Qwen3Decoder
    from flux2_tpu_torch.models.text_encoders.extractor import quantize_encoder_params
    from flux2_tpu_torch.models.text_encoders.pixtral import PixtralVision, PixtralVisionConfig
    from flux2_tpu_torch.models.text_encoders.tekken import TekkenTokenizer
    from flux2_tpu_torch.models.text_encoders.vlm_service import MistralVLMService

    cfg = DecoderConfig(vocab_size=1300, hidden_size=512, intermediate_size=1024, num_hidden_layers=3,
                        num_attention_heads=8, num_key_value_heads=4, head_dim=64, rms_norm_eps=1e-5,
                        llama4_scaling_beta=0.1, original_max_position_embeddings=8)
    g = torch.Generator(device=device).manual_seed(0)
    dec = quantize_encoder_params(Qwen3Decoder(cfg, device=device, generator=g), "w8a8")
    vcfg = PixtralVisionConfig(hidden_size=64, intermediate_size=128, num_hidden_layers=1, num_attention_heads=2,
                               text_hidden_size=cfg.hidden_size)
    svc = MistralVLMService(dec, cfg, PixtralVision.from_random(vcfg, device, g), vcfg, TekkenTokenizer.byte_fallback())
    image = torch.rand(56, 84, 3, generator=torch.Generator().manual_seed(2)).numpy()
    greedy = gen.GenerateParameters(max_tokens=6, temperature=0.0)
    made = []
    loop = gen.decode_loop
    monkeypatch.setattr(gen, "decode_loop", lambda *a, **k: made.append(loop(*a, **k)) or made[-1])
    tqk.reset_launches()
    reply = svc.analyze_image(image, "describe", gen_params=greedy)
    torch.cuda.synchronize()
    n = len(made[0])
    assert 1 <= n <= 6 and tqk.launches["w8a8"] == tqk.launches["quantize_rows"] == 7 * 3 * (1 + n)
    monkeypatch.setattr(tqk, "w8a8_matmul", tqk.w8a8_matmul_reference)
    assert svc.analyze_image(image, "describe", gen_params=greedy) == reply


def test_ring_of_one_on_the_card_equals_k2(device):
    """``ring_attention`` on a one-rank NCCL mesh at the 1024^2 shape: one K2 launch inside the ring,
    its output equal to K2's alone to the bit (the LSE merge of one block is exact)."""
    from flux2_tpu_torch.parallel.mesh import make_mesh
    from flux2_tpu_torch.parallel.ring_attention import ring_attention
    from flux2_tpu_torch.parallel.sharding import gather

    import torch.distributed as dist

    q, k, v = _qkv(device, 1, 24, 4608, 4608)
    before = tfa.launch_counts()
    try:
        with torch.inference_mode():
            out = gather(ring_attention(q, k, v, make_mesh(1, 1, 1, 1), axis="sp"))
            alone, _ = tfa.flash_attention_lse(q, k, v, 128**-0.5)
    finally:
        dist.destroy_process_group()  # the one-rank NCCL group make_mesh started
    assert tfa.launches_lse == before["flash_lse"] + 2 and tfa.launches == before["flash"]
    assert torch.equal(out, alone)


def test_device_sampling_gives_the_same_token_on_every_run(device):
    """``_sample_device`` over a Qwen3-size vocabulary (151936) with one draw: the same prefix sums to
    the bit and the same token on 50 runs (a one-dimensional CUDA ``torch.cumsum`` adds in an order that
    varies from run to run)."""
    from flux2_tpu_torch.models.text_encoders import generation as gen

    g = torch.Generator(device=device).manual_seed(5)
    probs = torch.softmax(torch.randn(151936, device=device, generator=g) * 0.01, dim=0)
    sums = gen._prefix_sums(probs)
    logits = torch.randn(151936, device=device, generator=g)
    p = gen.GenerateParameters(temperature=0.7, top_p=0.95, repetition_penalty=1.0)
    u = torch.rand((), device=device, generator=g)
    token = gen._sample_device(u, logits, torch.full((4,), -1, device=device), p)
    for _ in range(50):
        assert torch.equal(gen._prefix_sums(probs), sums)
        assert torch.equal(gen._sample_device(u, logits, torch.full((4,), -1, device=device), p), token)
