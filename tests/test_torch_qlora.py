"""QLoRA in the port: a LoRA train step on a quantized base against JAX's
``make_train_step`` (after ``tests/test_training.py::
test_qlora_train_step_on_quantized_base``), and the backward of the
quantized projections' kernel route (``ops.quant.KernelLinear``).

The base is JAX's f32 init, perturbed, quantized to qint8 by JAX and carried
into the port; at this width the x_embedder stays dense (below
``quantize_params``' size floor), so both packages run the stream in f32 and
the trainer tests' tolerances hold: loss 1e-5 relative, LoRA gradients 1e-4
relative L2 per stacked leaf. JAX's draws (sigmas and noise from the step's
key) are injected into the port's step.

``KernelLinear`` is tested with a kernel's plain version injected as its
forward, since the kernels run only on the card (``tests/test_torch_cuda.py``
holds the real ones): its input gradient equals autograd's of the
dequantize-then-``F.linear`` route to the bit, for a W8A8, a W4A8 and a qint8
weight.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from flux2_tpu.models.flux2 import transformer as jtfm
from flux2_tpu.ops import quant as jq
from flux2_tpu.training import trainer as jtrainer
from flux2_tpu_torch.io.jax_params import lora_from_jax, lora_to_flat, transformer_from_jax
from flux2_tpu_torch.models.flux2.config import Flux2TransformerConfig
from flux2_tpu_torch.ops import quant as tq
from flux2_tpu_torch.ops import quant_kernels as tqk
from flux2_tpu_torch.training import trainer as ttrainer

from tests.test_torch_lora import jax_lora
from tests.test_torch_lora_loader import one_torch_thread  # noqa: F401 (a fixture)
from tests.test_torch_shared_copies import jax_config
from tests.test_torch_trainer import _batch, _flat_grads, _rel, _t
from tests.test_torch_transformer import perturbed_numpy

CONFIG = Flux2TransformerConfig(num_layers=1, num_single_layers=1, num_attention_heads=2,
                                attention_head_dim=128, joint_attention_dim=96, guidance_embeds=False)


@pytest.fixture(scope="module")
def jax_params():
    return perturbed_numpy(jtfm.init_params(jax.random.PRNGKey(0), jax_config(CONFIG), dtype=jnp.float32), 0)


@pytest.mark.parametrize("fmt", ["qint8"])
def test_qlora_step_matches_jax_make_train_step(jax_params, fmt, monkeypatch):
    qbase = jq.quantize_params(jax.tree_util.tree_map(jnp.asarray, jax_params), fmt)
    model = transformer_from_jax(jax.tree_util.tree_map(np.asarray, qbase), CONFIG)
    assert isinstance(model.double_blocks[0].to_q, tq.QTensor) and isinstance(model.x_embedder, torch.Tensor)
    lj = jax_lora(jax_params)
    cfg = dict(rank=4, alpha=8.0, remat=True, learning_rate=1e-3)
    batch = _batch(b=1)
    key = jax.random.PRNGKey(5)

    jcfg = jtrainer.TrainConfig(**cfg)
    opt = jtrainer.make_optimizer(jcfg)
    lora0 = jax.tree_util.tree_map(jnp.asarray, lj)
    step = jtrainer.make_train_step(qbase, jax_config(CONFIG), jcfg, opt)
    new_lora, _, metrics = step(lora0, opt.init(lora0), jax.tree_util.tree_map(jnp.asarray, batch), key)
    # the step's own draws (trainer.make_train_step's loss_fn), for the port and for JAX's gradients
    k_t, k_n = jax.random.split(key)
    sigmas = jtrainer.sample_timesteps(k_t, 1, jcfg.timestep_sampling)
    noise = jax.random.normal(k_n, batch["latents"].shape, jnp.float32)

    def jloss(lora):
        return jtrainer.flow_matching_loss(qbase, lora, jax_config(CONFIG), jcfg, jnp.asarray(batch["latents"]),
                                           jnp.asarray(batch["embeddings"]), noise, sigmas,
                                           jnp.asarray(batch["rope_cos"]), jnp.asarray(batch["rope_sin"]))

    ref_grads = jtrainer._flatten(jax.grad(jloss)(lora0))

    monkeypatch.setattr(ttrainer, "_draw", lambda *a: (torch.from_numpy(np.array(sigmas)),
                                                       torch.from_numpy(np.array(noise))))
    tcfg = ttrainer.TrainConfig(**cfg)
    lora = lora_from_jax(lj)
    got = ttrainer.make_train_step(model, tcfg)(lora, ttrainer.make_optimizer(tcfg, lora), _t(batch),
                                                torch.Generator().manual_seed(0))
    assert abs(float(got["loss"]) - float(metrics["loss"])) <= 1e-5 * abs(float(metrics["loss"]))
    assert abs(float(got["grad_norm"]) - float(metrics["grad_norm"])) <= 1e-4 * float(metrics["grad_norm"])
    grads = _flat_grads(lora)
    assert sorted(grads) == sorted(ref_grads)
    for name in grads:
        assert _rel(grads[name], ref_grads[name]) <= 1e-4, name
    # both steps moved the adapters; the port's b leaves by JAX's update
    moved, ref_moved = lora_to_flat(lora), jtrainer._flatten(new_lora)
    for name in moved:
        assert not np.array_equal(moved[name], np.asarray(jtrainer._flatten(lora0)[name])), name
        if name.endswith(".b"):
            assert _rel(moved[name], ref_moved[name]) <= 1e-4, name


def _weight(fmt):
    w = (0.05 * torch.randn(512, 512, generator=torch.Generator().manual_seed(3))).to(torch.bfloat16)
    return {"w8a8": tq.to_w8a8, "w4a8": tq.to_w4a8}.get(fmt, lambda x: tq.quantize(x, fmt))(w)


@pytest.mark.parametrize("fmt,plain", [("w8a8", tqk.w8a8_matmul_reference), ("w4a8", tqk.w4a8_matmul_reference),
                                       ("qint8", tqk.dequant_matmul_reference)])
def test_kernel_linear_backward_is_dy_times_the_dequantized_weight(fmt, plain):
    w = _weight(fmt)
    x = (0.5 * torch.randn(3, 16, 512, generator=torch.Generator().manual_seed(4))).to(torch.bfloat16)
    dy = torch.randn(3, 16, 512, generator=torch.Generator().manual_seed(5)).to(torch.bfloat16)
    xk = x.clone().requires_grad_(True)
    y = tq.KernelLinear.apply(xk, w, plain)
    assert torch.equal(y.detach(), plain(x, w))  # the forward is the kernel's (here its plain version)
    y.backward(dy)
    xr = x.clone().requires_grad_(True)
    F.linear(xr, tq.dequantize_any(w, xr.dtype)).backward(dy)
    assert torch.equal(xk.grad, xr.grad) and float(xk.grad.abs().max()) > 0
    assert all(t.grad is None for t in w.buffers())  # frozen codes and scales get no gradient
    with torch.no_grad():
        assert q_linear_grad_fn(x, w) is None


def q_linear_grad_fn(x, w):
    return tq.q_linear(x.requires_grad_(False), w).grad_fn
