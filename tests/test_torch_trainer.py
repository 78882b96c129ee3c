"""The port's trainer (``flux2_tpu_torch/training/trainer.py``) against JAX's.

Same weights (JAX ``init_params``, f32, perturbed, carried by ``io/jax_params``),
same adapters (JAX ``init_lora`` with seeded non-zero b), same numpy batch,
sigmas and noise. Tolerances, each with its reason:
  - LoRA DiT forward 5e-4 absolute, the DiT parity limit (test_torch_transformer.py);
  - loss 1e-5 relative, LoRA gradients 1e-4 relative L2 per stacked leaf: the
    same f32 math in another order;
  - optimizer 1e-6 absolute after four steps, three of them clipped (f32 in
    optax against the port's float64 step arithmetic); schedules 1e-6 of the
    base rate (optax evaluates 1 + cos in f32, which loses digits where a
    cosine cycle nears 0);
  - loss weights 1e-6; everything within the port (remat, accumulation,
    checkpoints, EMA) to rounding.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from flux2_tpu.io import safetensors_io
from flux2_tpu.models.flux2 import transformer as jtfm
from flux2_tpu.ops import latents as jlu
from flux2_tpu.ops.rope import rope_embeddings
from flux2_tpu.training import lora as jlora
from flux2_tpu.training import trainer as jtrainer
from flux2_tpu_torch.models.flux2.config import Flux2TransformerConfig
from flux2_tpu_torch.io.jax_params import lora_from_jax, lora_to_flat, transformer_from_jax
from flux2_tpu_torch.training import lora as tlora
from flux2_tpu_torch.training import trainer as ttrainer

from tests.test_torch_lora import jax_lora
from tests.test_torch_shared_copies import jax_config
from tests.test_torch_transformer import perturbed_numpy

CONFIG = Flux2TransformerConfig(num_layers=1, num_single_layers=1, num_attention_heads=2,
                                attention_head_dim=128, joint_attention_dim=96, guidance_embeds=False)
LCFG = tlora.LoRAConfig(rank=4, alpha=8.0)


@pytest.fixture(scope="module")
def jax_params():
    return perturbed_numpy(jtfm.init_params(jax.random.PRNGKey(0), jax_config(CONFIG), dtype=jnp.float32), 0)


def _batch(b=2, s_txt=6, size=64, seed=5):
    rng = np.random.RandomState(seed)
    s_img = (size // 16) ** 2
    ids = np.concatenate([jlu.text_position_ids(s_txt), jlu.image_position_ids(size, size)])
    cos, sin = (np.asarray(x) for x in rope_embeddings(jnp.asarray(ids)))
    return {"latents": rng.randn(b, s_img, 128).astype(np.float32),
            "embeddings": (0.5 * rng.randn(b, s_txt, 96)).astype(np.float32),
            "rope_cos": cos, "rope_sin": sin}


def _t(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _rel(a, b):
    return float(np.linalg.norm(np.asarray(a) - np.asarray(b)) / np.linalg.norm(np.asarray(b)))


def _flat_grads(lora):
    """{"group.leaf.a": [L, in, r]} of the adapters' .grad, JAX's layout."""
    out = {}
    for group in tlora.GROUPS:
        blocks = getattr(lora, group)
        for leaf in (blocks[0].keys() if len(blocks) else ()):
            for ab in ("a", "b"):
                out[f"{group}.{leaf}.{ab}"] = np.stack([getattr(blk[leaf], ab).grad.numpy() for blk in blocks])
    return out


def test_lora_forward_matches_jax(jax_params):
    lj = jax_lora(jax_params)
    batch = _batch(b=1)
    t = np.array([0.4], np.float32)
    ref = jtfm.forward(jax_params, jax_config(CONFIG), jnp.asarray(batch["latents"]), jnp.asarray(batch["embeddings"]),
                       jnp.asarray(t), jnp.asarray(batch["rope_cos"]), jnp.asarray(batch["rope_sin"]),
                       lora=lj, lora_scale=LCFG.scale)
    tb = _t(batch)
    with torch.no_grad():
        out = transformer_from_jax(jax_params, CONFIG)(tb["latents"], tb["embeddings"], torch.from_numpy(t),
                                                        tb["rope_cos"], tb["rope_sin"], lora=lora_from_jax(lj),
                                                        lora_scale=LCFG.scale)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=5e-4, rtol=0)


@pytest.mark.parametrize("weighting", ["none", "snr"])  # bell takes snr's path with bell_weights
def test_loss_and_grads_match_jax_value_and_grad(jax_params, weighting):
    lj = jax_lora(jax_params)
    cfg = dict(rank=4, alpha=8.0, remat=True, loss_weighting=weighting)
    batch = _batch()
    rng = np.random.RandomState(11)
    noise = rng.randn(*batch["latents"].shape).astype(np.float32)
    sigmas = np.array([0.3, 0.8], np.float32)

    def jloss(lora):
        return jtrainer.flow_matching_loss(jax_params, lora, jax_config(CONFIG), jtrainer.TrainConfig(**cfg),
                                           jnp.asarray(batch["latents"]), jnp.asarray(batch["embeddings"]),
                                           jnp.asarray(noise), jnp.asarray(sigmas), jnp.asarray(batch["rope_cos"]),
                                           jnp.asarray(batch["rope_sin"]))

    ref_loss, ref_grads = jax.value_and_grad(jloss)(jax.tree_util.tree_map(jnp.asarray, lj))
    lora = lora_from_jax(lj)
    tb = _t(batch)
    loss = ttrainer.flow_matching_loss(transformer_from_jax(jax_params, CONFIG), lora, ttrainer.TrainConfig(**cfg),
                                       tb["latents"], tb["embeddings"], torch.from_numpy(noise),
                                       torch.from_numpy(sigmas), tb["rope_cos"], tb["rope_sin"])
    loss.backward()
    assert abs(float(loss.detach()) - float(ref_loss)) <= 1e-5 * abs(float(ref_loss))
    grads, ref_flat = _flat_grads(lora), jtrainer._flatten(ref_grads)
    assert sorted(grads) == sorted(ref_flat)
    for name in grads:
        assert _rel(grads[name], ref_flat[name]) <= 1e-4, name


def _grads_of(model, lora, cfg, batch, noise, sigmas):
    for p in lora.parameters():
        p.grad = None
    loss = ttrainer.flow_matching_loss(model, lora, cfg, batch["latents"], batch["embeddings"], noise, sigmas,
                                       batch["rope_cos"], batch["rope_sin"])
    loss.backward()
    return float(loss.detach()), _flat_grads(lora)


def test_remat_gives_the_same_grads(jax_params):
    model, lora = transformer_from_jax(jax_params, CONFIG), lora_from_jax(jax_lora(jax_params))
    tb = _t(_batch())
    noise, sigmas = torch.randn(tb["latents"].shape, generator=torch.Generator().manual_seed(0)), torch.tensor([.2, .9])
    cfg = ttrainer.TrainConfig(rank=4, alpha=8.0)
    l0, g0 = _grads_of(model, lora, dataclasses.replace(cfg, remat=False), tb, noise, sigmas)
    l1, g1 = _grads_of(model, lora, dataclasses.replace(cfg, remat=True), tb, noise, sigmas)
    assert l0 == l1
    for name in g0:
        np.testing.assert_allclose(g1[name], g0[name], atol=1e-7, rtol=0)


def test_grad_accumulation_equals_the_full_batch(jax_params):
    model = transformer_from_jax(jax_params, CONFIG)
    lj = jax_lora(jax_params)
    tb = _t(_batch(b=4))
    results = []
    for n in (1, 2):
        cfg = ttrainer.TrainConfig(rank=4, alpha=8.0, remat=False, grad_accumulation=n, timestep_sampling="uniform")
        lora = lora_from_jax(lj)
        step = ttrainer.make_train_step(model, cfg)
        metrics = step(lora, ttrainer.make_optimizer(cfg, lora), tb, torch.Generator().manual_seed(3))
        results.append((metrics, _flat_grads(lora), lora_to_flat(lora)))
    (m1, g1, p1), (m2, g2, p2) = results
    np.testing.assert_allclose(float(m2["loss"]), float(m1["loss"]), rtol=1e-6)
    np.testing.assert_allclose(float(m2["grad_norm"]), float(m1["grad_norm"]), rtol=1e-5)
    for name in g1:
        np.testing.assert_allclose(g2[name], g1[name], atol=1e-6, rtol=1e-5)
        np.testing.assert_allclose(p2[name], p1[name], atol=1e-6, rtol=0)


@pytest.mark.parametrize("optimizer", ["adamw", "lion"])
def test_clipped_steps_match_optax(optimizer):
    cfg = jtrainer.TrainConfig(optimizer=optimizer, learning_rate=1e-2, weight_decay=0.1, max_grad_norm=0.5,
                               warmup_steps=1, lr_scheduler="linear", total_steps=6)
    rng = np.random.RandomState(4)
    params = {"double_blocks": {"to_q": {"a": rng.randn(2, 8, 4).astype(np.float32),
                                         "b": rng.randn(2, 4, 8).astype(np.float32)}}}
    grads = [jax.tree_util.tree_map(lambda x: (s * rng.randn(*x.shape)).astype(np.float32), params)
             for s in (1.0, 0.01, 2.0, 3.0)]  # the second is below max_grad_norm, the rest are clipped
    opt = jtrainer.make_optimizer(cfg)
    jp, state = jax.tree_util.tree_map(jnp.asarray, params), None
    state = opt.init(jp)
    lora = lora_from_jax(params)
    port = ttrainer.make_optimizer(ttrainer.TrainConfig(**dataclasses.asdict(cfg)), lora)
    flat_names = [n for n, _ in lora.named_parameters()]
    for g in grads:
        updates, state = opt.update(jax.tree_util.tree_map(jnp.asarray, g), state, jp)
        jp = optax.apply_updates(jp, updates)
        by_name = {f"double_blocks.{i}.to_q.{ab}": torch.from_numpy(g["double_blocks"]["to_q"][ab][i])
                   for i in range(2) for ab in ("a", "b")}
        port.step([by_name[n] for n in flat_names])
    got, want = lora_to_flat(lora), jtrainer._flatten(jp)
    for name in want:
        np.testing.assert_allclose(got[name], np.asarray(want[name]), atol=1e-6, rtol=0)
    assert port.count == len(grads)


@pytest.mark.parametrize("warmup", [0, 5])
@pytest.mark.parametrize("scheduler", ["constant", "linear", "cosine", "cosine_with_restarts"])
def test_lr_schedule_matches_optax(scheduler, warmup):
    kw = dict(learning_rate=3e-4, lr_scheduler=scheduler, warmup_steps=warmup, total_steps=40, lr_num_cycles=3)
    ref = jtrainer.lr_schedule(jtrainer.TrainConfig(**kw))
    got = ttrainer.lr_schedule(ttrainer.TrainConfig(**kw))
    counts = range(0, 50)
    np.testing.assert_allclose([got(c) for c in counts], [float(ref(c)) for c in counts], rtol=0,
                               atol=1e-6 * kw["learning_rate"])
    if warmup:
        assert got(0) == 0.0  # step 1 reads the count before its increment


def test_loss_weights_match_jax():
    s = np.array([0.0, 1e-4, 0.2, 0.5, 0.77, 0.999, 1.0], np.float32)
    np.testing.assert_allclose(ttrainer.bell_weights(torch.from_numpy(s)).numpy(),
                               np.asarray(jtrainer.bell_weights(jnp.asarray(s))), rtol=1e-6)
    for gamma in (1.0, 5.0):
        np.testing.assert_allclose(ttrainer.snr_weights(torch.from_numpy(s), gamma).numpy(),
                                   np.asarray(jtrainer.snr_weights(jnp.asarray(s), gamma)), rtol=1e-6)


@pytest.mark.parametrize("mode", ttrainer.TIMESTEP_MODES)
def test_sample_timesteps_every_mode(mode):
    s = ttrainer.sample_timesteps(torch.Generator().manual_seed(0), 4096, mode, logit_std=1.0, shift=3.0)
    assert s.shape == (4096,) and s.dtype == torch.float32
    assert float(s.min()) >= 0.0 and float(s.max()) < 1.0
    mean = float(s.mean())
    expected = {"content": (0.0, 0.35), "style": (0.65, 1.0), "flux_shift": (0.6, 0.9)}.get(mode, (0.4, 0.6))
    assert expected[0] < mean < expected[1], mean
    again = ttrainer.sample_timesteps(torch.Generator().manual_seed(0), 4096, mode, logit_std=1.0, shift=3.0)
    assert torch.equal(s, again)


def test_unknown_timestep_mode_raises():
    with pytest.raises(ValueError):
        ttrainer.sample_timesteps(torch.Generator(), 2, "nope")


def test_dop_loss_zero_at_init_and_not_after(jax_params):
    model = transformer_from_jax(jax_params, CONFIG)
    cfg = ttrainer.TrainConfig(rank=4, alpha=8.0, remat=False)
    lora = tlora.init_lora(model, LCFG, torch.Generator().manual_seed(0))
    tb = _t(_batch())
    noise, sigmas = torch.randn(tb["latents"].shape), torch.tensor([0.5, 0.5])
    args = (tb["latents"], tb["embeddings"], noise, sigmas, tb["rope_cos"], tb["rope_sin"])
    assert float(ttrainer.dop_loss(model, lora, cfg, *args).detach()) < 1e-12
    lora = lora_from_jax(jax_lora(jax_params))
    assert float(ttrainer.dop_loss(model, lora, cfg, *args).detach()) > 1e-6


def test_train_step_with_dop_reports_it(jax_params):
    model = transformer_from_jax(jax_params, CONFIG)
    cfg = ttrainer.TrainConfig(rank=4, alpha=8.0, remat=False, dop_weight=0.5, learning_rate=1e-2)
    state = ttrainer.init_train_state(model, cfg, torch.Generator().manual_seed(0))
    step = ttrainer.make_train_step(model, cfg)
    tb = _t(_batch())
    tb["dop_embeddings"] = tb["embeddings"] * 0.5
    m1 = step(state.lora, state.optimizer, tb, torch.Generator().manual_seed(1))
    m2 = step(state.lora, state.optimizer, tb, torch.Generator().manual_seed(2))
    assert float(m1["dop_loss"]) < 1e-12 < float(m2["dop_loss"])


def test_ema_update_matches_jax(jax_params):
    a, b = jax_lora(jax_params, seed=1), jax_lora(jax_params, seed=2)
    ref = jtrainer.ema_update(jax.tree_util.tree_map(jnp.asarray, a), jax.tree_util.tree_map(jnp.asarray, b),
                              jnp.float32(0.9))
    ema = ttrainer.ema_update(lora_from_jax(a), lora_from_jax(b), 0.9)
    got, want = lora_to_flat(ema), jtrainer._flatten(ref)
    for name in want:
        np.testing.assert_allclose(got[name], np.asarray(want[name]), atol=1e-7, rtol=0)


def test_eval_loss_is_deterministic_per_generator(jax_params):
    model = transformer_from_jax(jax_params, CONFIG)
    cfg = ttrainer.TrainConfig(rank=4, alpha=8.0)
    lora = lora_from_jax(jax_lora(jax_params))
    ev = ttrainer.make_eval_loss(model, cfg)
    tb = _t(_batch())
    l1 = float(ev(lora, tb, torch.Generator().manual_seed(7)))
    assert l1 == float(ev(lora, tb, torch.Generator().manual_seed(7)))
    assert l1 != float(ev(lora, tb, torch.Generator().manual_seed(8)))


def test_checkpoint_round_trip_continues_identically(jax_params, tmp_path):
    model = transformer_from_jax(jax_params, CONFIG)
    cfg = ttrainer.TrainConfig(rank=4, alpha=8.0, remat=False, use_ema=True, learning_rate=1e-2)
    state = ttrainer.init_train_state(model, cfg, torch.Generator().manual_seed(0))
    step = ttrainer.make_train_step(model, cfg)
    tb = _t(_batch())
    step(state.lora, state.optimizer, tb, torch.Generator().manual_seed(1))
    ttrainer.ema_update(state.ema, state.lora, cfg.ema_decay)
    state.step = 1
    path = str(tmp_path / "checkpoint_000001")
    ttrainer.save_checkpoint(path, state, cfg, extra={"rng_seed": 42})
    restored = ttrainer.load_checkpoint(path, cfg, "cpu")
    assert restored.step == 1 and restored.optimizer.count == 1
    for a, b in ((restored.lora, state.lora), (restored.ema, state.ema)):
        assert all(np.array_equal(lora_to_flat(a)[k], v) for k, v in lora_to_flat(b).items())
    m_a = step(state.lora, state.optimizer, tb, torch.Generator().manual_seed(2))
    m_b = step(restored.lora, restored.optimizer, tb, torch.Generator().manual_seed(2))
    assert float(m_a["loss"]) == float(m_b["loss"])
    assert all(np.array_equal(lora_to_flat(restored.lora)[k], v) for k, v in lora_to_flat(state.lora).items())
    with open(os.path.join(path, "training_state.json")) as f:
        meta = __import__("json").load(f)
    assert {"step", "rank", "alpha", "optimizer", "learning_rate", "rng_seed"} <= set(meta)


def test_lora_checkpoints_load_across_packages(jax_params, tmp_path):
    """A port-written lora.safetensors read by the JAX package, and the reverse."""
    model = transformer_from_jax(jax_params, CONFIG)
    cfg = ttrainer.TrainConfig(rank=4, alpha=8.0)
    state = ttrainer.init_train_state(model, cfg, torch.Generator().manual_seed(0))
    with torch.no_grad():
        for p in state.lora.parameters():
            p.add_(0.01)
    port_dir = str(tmp_path / "port")
    ttrainer.save_checkpoint(port_dir, state, cfg)
    tree = jtrainer._unflatten(safetensors_io.load_file(os.path.join(port_dir, "lora.safetensors")))
    ref = jlora.init_lora(jax.random.PRNGKey(0), jax_params, jlora.LoRAConfig(4, 8.0))
    assert jax.tree_util.tree_structure(tree) == jax.tree_util.tree_structure(ref)
    assert [x.shape for x in jax.tree_util.tree_leaves(tree)] == [x.shape for x in jax.tree_util.tree_leaves(ref)]
    flat = lora_to_flat(state.lora)
    assert all(np.array_equal(np.asarray(v), flat[k]) for k, v in jtrainer._flatten(tree).items())

    jcfg = jtrainer.TrainConfig(rank=4, alpha=8.0)
    jstate, _ = jtrainer.init_train_state(jax.random.PRNGKey(1), jax_params, jcfg)
    jax_dir = str(tmp_path / "jax")
    jtrainer.save_checkpoint(jax_dir, jtrainer.TrainState(lora=jax_lora(jax_params), opt_state=jstate.opt_state,
                                                          step=3), jcfg)
    restored = ttrainer.load_checkpoint(jax_dir, cfg, "cpu")  # optax's tree paths, strictly
    assert restored.step == 3 and restored.optimizer.count == 0
    want = jtrainer._flatten(jax_lora(jax_params))
    assert all(np.array_equal(lora_to_flat(restored.lora)[k], np.asarray(v)) for k, v in want.items())
