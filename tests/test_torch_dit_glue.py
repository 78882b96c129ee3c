"""The DiT's fused glue route (``flux2_tpu_torch/ops/dit_glue.py``) on the CPU,
at tiny widths in bf16, no JAX.

- With autograd recording off the blocks call G1 (``adaln_modulate``) and G2
  (``qkv_heads``), with it on the torch chain. On a CPU tensor the wrappers
  compute the chain itself, so both routes give the same bits: the plain
  forward, the CFG batch of 2 and the klein-9b-kv pair.
- A LoRA step with grad never calls the wrappers, and its backward runs.
- The ``dit.step`` span's ``glue`` attribute is the step's G1 + G2 launches.
- G2's plain version writes only its stream's rows of the joint buffers.
"""

import numpy as np
import pytest
import torch

from flux2_tpu_torch.models.flux2.config import Flux2Model, Flux2TransformerConfig
from flux2_tpu_torch.models.flux2.transformer import Flux2Transformer
from flux2_tpu_torch.models.flux2.vae import VAEConfig
from flux2_tpu_torch.ops import dit_glue
from flux2_tpu_torch.ops import latents as lu
from flux2_tpu_torch.ops.normalization import rms_norm
from flux2_tpu_torch.ops.rope import apply_rope, rope_embeddings
from flux2_tpu_torch.pipeline.pipeline import Flux2Pipeline
from flux2_tpu_torch.training import lora as tlora
from flux2_tpu_torch.utils import profiler as tprof

CONFIG = Flux2TransformerConfig(num_layers=2, num_single_layers=2, num_attention_heads=2, attention_head_dim=128,
                                joint_attention_dim=96, guidance_embeds=False)
G1_CALLS = 4 * CONFIG.num_layers + CONFIG.num_single_layers + 1  # two a stream a double block, one a single, _final
G2_CALLS = 2 * CONFIG.num_layers + CONFIG.num_single_layers
S_TXT = 8


@pytest.fixture(scope="module")
def model():
    return Flux2Transformer(CONFIG, dtype=torch.bfloat16, generator=torch.Generator().manual_seed(0))


@pytest.fixture
def calls(monkeypatch):
    """Counts the blocks' calls of the two wrappers (the CPU launches none)."""
    seen = {"adaln_modulate": 0, "qkv_heads": 0}
    for name in seen:
        fn = getattr(dit_glue, name)

        def spy(*args, _fn=fn, _name=name):
            seen[_name] += 1
            return _fn(*args)

        monkeypatch.setattr(dit_glue, name, spy)
    return seen


def _inputs(batch: int, seed: int):
    g = torch.Generator().manual_seed(seed)
    img = torch.randn(batch, 16, CONFIG.in_channels, generator=g).bfloat16()
    txt = torch.randn(batch, S_TXT, CONFIG.joint_attention_dim, generator=g).bfloat16()
    t = torch.rand(batch, generator=g)
    return img, txt, t


def _rope(*ids):
    return rope_embeddings(torch.from_numpy(np.concatenate(ids)))


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.detach().view(torch.int16).numpy()


@pytest.mark.parametrize("batch", [1, 2], ids=["batch1", "cfg_batch2"])
def test_the_no_grad_forward_takes_the_kernels_and_equals_the_chain_to_the_bit(model, calls, batch):
    img, txt, t = _inputs(batch, seed=batch)
    cos, sin = _rope(lu.text_position_ids(S_TXT), lu.image_position_ids(64, 64))
    with torch.enable_grad():
        chain = model(img, txt, t, cos, sin)
    assert calls == {"adaln_modulate": 0, "qkv_heads": 0}
    with torch.no_grad():
        fused = model(img, txt, t, cos, sin)
    assert calls == {"adaln_modulate": G1_CALLS, "qkv_heads": G2_CALLS}
    with torch.inference_mode():
        served = model(img, txt, t, cos, sin)
    assert fused.dtype == torch.bfloat16
    np.testing.assert_array_equal(_bits(fused), _bits(chain))
    np.testing.assert_array_equal(_bits(served), _bits(chain))


def test_the_kv_pair_on_the_fused_route_equals_the_chain_to_the_bit(model, calls):
    img, txt, t = _inputs(1, seed=3)
    ref = torch.randn(1, 16, CONFIG.in_channels, generator=torch.Generator().manual_seed(4)).bfloat16()
    txt_ids, img_ids = lu.text_position_ids(S_TXT), lu.image_position_ids(64, 64)
    ref_ids = img_ids + np.array([1, 0, 0, 0], img_ids.dtype)
    extract_rope, cached_rope = _rope(txt_ids, ref_ids, img_ids), _rope(txt_ids, img_ids)
    runs = []
    for grad in (True, False):
        with torch.set_grad_enabled(grad):
            v0, double_kv, single_kv = model.forward_kv_extract(img, ref, txt, t, *extract_rope)
            v1 = model.forward_kv_cached(img, txt, t, *cached_rope, double_kv, single_kv)
        runs.append([v0, v1, *(x for kv in double_kv + single_kv for x in kv)])
    assert calls == {"adaln_modulate": 2 * G1_CALLS, "qkv_heads": 2 * G2_CALLS}
    for chain, fused in zip(*runs):
        np.testing.assert_array_equal(_bits(fused), _bits(chain))


def test_a_lora_step_with_grad_keeps_the_chain_and_its_backward_runs(model, monkeypatch):
    def refuse(*args):
        raise AssertionError("a wrapper of the fused glue was called with autograd recording")

    monkeypatch.setattr(dit_glue, "adaln_modulate", refuse)
    monkeypatch.setattr(dit_glue, "qkv_heads", refuse)
    lora = tlora.init_lora(model, tlora.LoRAConfig(rank=4, alpha=4.0), torch.Generator().manual_seed(1))
    img, txt, t = _inputs(2, seed=5)
    cos, sin = _rope(lu.text_position_ids(S_TXT), lu.image_position_ids(64, 64))
    for remat in (False, True):
        lora.zero_grad(set_to_none=True)
        loss = model(img, txt, t, cos, sin, remat=remat, lora=lora).float().square().mean()
        loss.backward()
        grads = [p.grad for p in lora.parameters()]
        assert all(g is not None for g in grads) and any(bool(g.abs().sum() > 0) for g in grads)


def test_the_dit_step_span_counts_the_steps_glue_launches(monkeypatch):
    """On the CPU the wrappers launch nothing; here each call counts as one
    launch, as on the card, and each step's span carries their sum."""
    rec = tprof.PhaseProfiler(enabled=True)
    monkeypatch.setattr(tprof, "_shared", rec)
    for name in ("adaln_modulate", "qkv_heads"):
        fn = getattr(dit_glue, name)

        def launching(*args, _fn=fn, _name=name):
            dit_glue.launches[_name] += 1
            return _fn(*args)

        monkeypatch.setattr(dit_glue, name, launching)
    monkeypatch.setattr(dit_glue, "launches", {"adaln_modulate": 0, "qkv_heads": 0})
    vae = VAEConfig(block_out_channels=(8, 8, 16, 16), layers_per_block=1, norm_num_groups=4)
    pipe = Flux2Pipeline.from_random(Flux2Model.KLEIN_4B, device="cpu", generator=torch.Generator().manual_seed(0),
                                     dtype=torch.bfloat16, transformer_config=CONFIG, vae_config=vae)
    pipe.generate(embeddings=torch.zeros(1, S_TXT, 96), height=64, width=64, num_steps=2, seed=1)
    steps = rec.spans("dit.step")
    assert [dict(s.attrs) for s in steps] == [{"step": i, "batch": 1, "glue": G1_CALLS + G2_CALLS, "w8a8": 0,
                                               "w8a8_grouped": 0} for i in range(2)]
    assert sum(dit_glue.launches.values()) == 2 * (G1_CALLS + G2_CALLS)


def test_qkv_heads_plain_version_writes_its_rows_only():
    g = torch.Generator().manual_seed(6)
    b, s, h, d, s_joint, offset = 2, 5, 3, 128, 12, 4
    q, k, v = (torch.randn(b, s, h * d, generator=g).bfloat16() for _ in range(3))
    norm_q, norm_k = ((1 + 0.1 * torch.randn(d, generator=g)).bfloat16() for _ in range(2))
    cos, sin = torch.randn(s_joint, d, generator=g), torch.randn(s_joint, d, generator=g)
    outs = [torch.full((b, h, s_joint, d), 7.0, dtype=torch.bfloat16) for _ in range(3)]
    dit_glue.qkv_heads(q, k, v, norm_q, norm_k, cos, sin, *outs, offset)
    rows = slice(offset, offset + s)

    def heads(x):
        return x.reshape(b, s, h, d).transpose(1, 2)

    for out, x, w in ((outs[0], q, norm_q), (outs[1], k, norm_k)):
        torch.testing.assert_close(out[:, :, rows], apply_rope(rms_norm(heads(x), w), cos[rows], sin[rows]),
                                   rtol=0, atol=0)
    torch.testing.assert_close(outs[2][:, :, rows], heads(v), rtol=0, atol=0)
    for out in outs:
        assert bool((out[:, :, :offset] == 7).all() and (out[:, :, offset + s:] == 7).all())
