"""Real-data LoRA training in the port against the JAX package (CPU, tiny sizes).

- ``_prepare_real_data`` on one tiny pipeline per package (the same f32
  weights, ``tests/test_torch_validation.tiny_pipelines``) over a dataset with
  two buckets, control images, the trigger, DOP and caption dropout: for
  several ``RandomState`` seeds the batches hold the same keys and shapes,
  latents and control latents within 1e-4 (the VAE's limit), embeddings
  within 1e-5 (the encoder's), RoPE within 1e-5 with the control tokens on
  reference ids; both disk caches hold JAX's file names. One step's
  ``flow_matching_loss`` + ``dop_loss`` on such a batch, control included,
  with JAX's sigmas and noise, within 5e-4 of JAX's (the DiT's limit).
- ``remat: "dots"``: the LoRA gradient within 5e-4 of JAX's under the same
  policy and equal to the port's ``remat=True`` gradient to the bit; the
  backward re-runs no 2-D product of the forward under "dots", and all of
  them under True (counted by a dispatch mode).
- Resume across packages: JAX's optax state (AdamW and Lion) loads strictly
  with equal counts and moments and the next update equal to JAX's within
  1e-6; the port's file loads in JAX's strict ``load_checkpoint``; a
  checkpoint in the port's keys of PRs 3-12 still resumes.
- The slice through ``cli.main``: ``train-lora`` from a tiny checkpoint tree
  (``tests/test_torch_checkpoints.write_tiny_tree``) on a dataset with
  previews and a held-out set writes what JAX's
  ``tests/test_training_e2e.py::test_train_lora_real_data_e2e`` asserts;
  QLoRA from the CLI; ``--random-init`` on a dataset, its resume (both disk
  caches hit, the uninterrupted run's LoRA to the bit); R5 (a validation pass
  leaves the base's bytes and the later losses as they were);
  ``evaluate-lora`` (the parser against JAX's, the pixel scorer, JAX's JSON
  keys and rounding).
"""

import dataclasses
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import chip_smoke
from flux2_tpu.cli import main as jcli
from flux2_tpu.cli import train as jtrain_cli
from flux2_tpu.training import trainer as jtrainer
from flux2_tpu_torch.cli import main as tcli
from flux2_tpu_torch.cli import train as ttrain_cli
from flux2_tpu_torch.cli.train_config import YAMLTrainingConfig
from flux2_tpu_torch.io import safetensors_io as tst
from flux2_tpu_torch.io.jax_params import lora_from_jax, lora_to_flat
from flux2_tpu_torch.models.flux2.vae import VAEConfig
from flux2_tpu_torch.training import trainer as ttrainer
from flux2_tpu_torch.utils import synthetic

import tests.test_torch_checkpoints as ckpt_tests
from tests.test_torch_lora import jax_lora
from tests.test_torch_validation import TC, one_torch_thread, tiny_pipelines  # noqa: F401 (module fixture)
from tests.test_torch_vae_encoder import _params as vae_params

LATENT_TOL = 1e-4
EMB_TOL = 1e-5
ROPE_TOL = 1e-5
LOSS_TOL = 5e-4
VC = VAEConfig(block_out_channels=(8, 8, 16, 16), layers_per_block=1, norm_num_groups=4)
SIZES = [(64, 64), (64, 96), (64, 64), (64, 96)]


def _yaml(path, body: str) -> str:
    with open(path, "w") as f:
        f.write(body)
    return str(path)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("real")
    data = synthetic.write_dataset(str(root / "data"), 0, SIZES, control=(0, 1, 3))
    data["validation"] = synthetic.write_dataset(str(root / "held_out"), 1, [(64, 64)] * 2,
                                                  captions=chip_smoke.VAL_CAPTIONS)["dataset"]
    return data


# -- _prepare_real_data against JAX's ---------------------------------------------

def _prep_yaml(path, data, out) -> str:
    return _yaml(path, f"""model: {{name: klein-4b}}
lora: {{rank: 4, alpha: 8}}
dataset: {{path: {data['dataset']}, image_size: 64, trigger_word: sks, control_path: {data['control']},
  control_dropout: 0.3}}
training: {{batch_size: 2, caption_dropout: 0.4}}
loss: {{diff_output_preservation: true, diff_output_preservation_class: dog}}
checkpoints: {{output: {out}}}
""")


@pytest.fixture(scope="module")
def prepared(dataset, tmp_path_factory):
    """(JAX's sample_batch, the port's, their output dirs): _prepare_real_data of each package."""
    root = tmp_path_factory.mktemp("prep")
    jpipe, tpipe = tiny_pipelines("klein-4b-base")
    path = _prep_yaml(root / "cfg.yaml", dataset, root / "out")
    jc = jtrain_cli.YAMLTrainingConfig.from_yaml(path).override(output_dir=str(root / "jax"))
    tc = YAMLTrainingConfig.from_yaml(path).override(output_dir=str(root / "port"))
    jsample, jitems = jtrain_cli._prepare_real_data(jpipe, jc, jpipe.transformer_config)
    tsample, titems = ttrain_cli._prepare_real_data(tpipe, tc, tpipe.transformer.config)
    assert [it.image_path for it in titems] == [it.image_path for it in jitems] and len(titems) == 3
    return jsample, tsample, str(root / "jax"), str(root / "port")


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 5, 8])
def test_prepare_real_data_batches_equal_jax(prepared, seed):
    jsample, tsample, _, _ = prepared
    ref = jsample(np.random.RandomState(seed), 2)
    ours = tsample(np.random.RandomState(seed), 2)
    assert sorted(ours) == sorted(ref)
    assert {"latents", "embeddings", "dop_embeddings", "rope_cos", "rope_sin", "guidance"} <= set(ours)
    for k in ours:
        a, b = ours[k].numpy(), np.asarray(ref[k])
        assert a.shape == b.shape and a.dtype == np.float32, k
        tol = {"latents": LATENT_TOL, "control": LATENT_TOL, "embeddings": EMB_TOL, "dop_embeddings": EMB_TOL}.get(
            k, ROPE_TOL)
        np.testing.assert_allclose(a, b, atol=tol, rtol=0, err_msg=k)


def test_prepare_real_data_draws_both_control_flags_and_both_buckets(prepared):
    """The seeds above reach both branches: with and without control, both buckets."""
    _, tsample, _, _ = prepared
    seen = {(b["latents"].shape[1], "control" in b) for b in (tsample(np.random.RandomState(s), 2)
                                                            for s in (0, 1, 2, 3, 5, 8))}
    assert {s for s, _ in seen} == {16, 24} and {c for _, c in seen} == {False, True}


def test_prepare_real_data_caches_hold_jax_file_names(prepared):
    _, _, jdir, tdir = prepared
    for sub in ("latent_cache", os.path.join("latent_cache", "text_embeddings")):
        ours = sorted(f for f in os.listdir(os.path.join(tdir, sub)) if f.endswith(".npy"))
        assert ours and ours == sorted(f for f in os.listdir(os.path.join(jdir, sub)) if f.endswith(".npy"))
    # 3 items + 3 control images; 3 captions, "" and 3 DOP captions
    assert len([f for f in os.listdir(os.path.join(tdir, "latent_cache")) if f.endswith(".npy")]) == 6
    assert len(os.listdir(os.path.join(tdir, "latent_cache", "text_embeddings"))) == 7


@pytest.mark.parametrize("seed", [0, 3])
def test_one_step_loss_with_dop_and_control_equals_jax(prepared, seed):
    jsample, tsample, _, _ = prepared
    jpipe, tpipe = tiny_pipelines("klein-4b-base")
    ref, ours = jsample(np.random.RandomState(seed), 2), tsample(np.random.RandomState(seed), 2)
    assert "control" in ours
    rng = np.random.RandomState(seed + 10)
    noise = rng.randn(*ours["latents"].shape).astype(np.float32)
    sigmas = np.array([0.35, 0.8], np.float32)
    lj = jax_lora(jax.tree_util.tree_map(np.asarray, jpipe.transformer_params))
    kw = dict(rank=4, alpha=8.0, remat=False, dop_weight=0.5)
    jcfg = jtrainer.TrainConfig(**kw)
    jl = jax.tree_util.tree_map(jnp.asarray, lj)
    j_main = jtrainer.flow_matching_loss(jpipe.transformer_params, jl, jpipe.transformer_config, jcfg, ref["latents"],
                                         ref["embeddings"], jnp.asarray(noise), jnp.asarray(sigmas), ref["rope_cos"],
                                         ref["rope_sin"], guidance=ref["guidance"], control_seq=ref["control"])
    j_dop = jtrainer.dop_loss(jpipe.transformer_params, jl, jpipe.transformer_config, jcfg, ref["latents"],
                              ref["dop_embeddings"], jnp.asarray(noise), jnp.asarray(sigmas), ref["rope_cos"],
                              ref["rope_sin"], guidance=ref["guidance"])
    tcfg = ttrainer.TrainConfig(**kw)
    lora = lora_from_jax(lj)
    with torch.no_grad():
        t_main = ttrainer.flow_matching_loss(tpipe.transformer, lora, tcfg, ours["latents"], ours["embeddings"],
                                             torch.from_numpy(noise), torch.from_numpy(sigmas), ours["rope_cos"],
                                             ours["rope_sin"], guidance=ours["guidance"], control=ours["control"])
        t_dop = ttrainer.dop_loss(tpipe.transformer, lora, tcfg, ours["latents"], ours["dop_embeddings"],
                                  torch.from_numpy(noise), torch.from_numpy(sigmas), ours["rope_cos"], ours["rope_sin"],
                                  guidance=ours["guidance"])
    assert abs(float(t_main) - float(j_main)) <= LOSS_TOL and abs(float(t_dop) - float(j_dop)) <= LOSS_TOL
    assert abs(float(t_main + 0.5 * t_dop) - float(j_main + 0.5 * j_dop)) <= LOSS_TOL and float(t_dop) > 0


# -- remat "dots" ------------------------------------------------------------------

class _MMCount(TorchDispatchMode):
    """Counts aten mm / addmm dispatches (the 2-D products)."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
            self.n += 1
        return func(*args, **(kwargs or {}))


def _dots_inputs():
    jpipe, tpipe = tiny_pipelines("klein-4b-base")
    rng = np.random.RandomState(4)
    from flux2_tpu.ops import latents as jlu
    from flux2_tpu.ops.rope import rope_embeddings

    ids = np.concatenate([jlu.text_position_ids(8), jlu.image_position_ids(64, 32)])
    cos, sin = (np.asarray(x) for x in rope_embeddings(jnp.asarray(ids)))
    arrays = dict(latents=rng.randn(2, 8, 128).astype(np.float32), emb=(0.5 * rng.randn(2, 8, 96)).astype(np.float32),
                  noise=rng.randn(2, 8, 128).astype(np.float32), sigmas=np.array([0.3, 0.7], np.float32), cos=cos,
                  sin=sin, guidance=np.ones(2, np.float32))
    return jpipe, tpipe, arrays


def _port_grads(tpipe, lora, remat, a):
    for p in lora.parameters():
        p.grad = None
    t = {k: torch.from_numpy(np.array(v)) for k, v in a.items()}
    loss = ttrainer.flow_matching_loss(tpipe.transformer, lora, ttrainer.TrainConfig(rank=4, alpha=8.0, remat=remat),
                                       t["latents"], t["emb"], t["noise"], t["sigmas"], t["cos"], t["sin"],
                                       guidance=t["guidance"])
    backward = _MMCount()
    with backward:
        loss.backward()
    return float(loss.detach()), {n: p.grad.clone() for n, p in lora.named_parameters()}, backward.n


def test_remat_dots_gradient_equals_jax_and_block_remat():
    jpipe, tpipe, a = _dots_inputs()
    lj = jax_lora(jax.tree_util.tree_map(np.asarray, jpipe.transformer_params))

    def jloss(lora):
        return jtrainer.flow_matching_loss(
            jpipe.transformer_params, lora, jpipe.transformer_config,
            jtrainer.TrainConfig(rank=4, alpha=8.0, remat="dots"), jnp.asarray(a["latents"]), jnp.asarray(a["emb"]),
            jnp.asarray(a["noise"]), jnp.asarray(a["sigmas"]), jnp.asarray(a["cos"]), jnp.asarray(a["sin"]),
            guidance=jnp.asarray(a["guidance"]))

    ref_loss, ref_grads = jax.value_and_grad(jloss)(jax.tree_util.tree_map(jnp.asarray, lj))
    lora = lora_from_jax(lj)
    loss_d, grads_d, _ = _port_grads(tpipe, lora, "dots", a)
    loss_b, grads_b, _ = _port_grads(tpipe, lora, True, a)
    assert loss_d == loss_b and all(torch.equal(grads_d[n], grads_b[n]) for n in grads_d)
    assert abs(loss_d - float(ref_loss)) <= LOSS_TOL
    for p in lora.parameters():
        p.grad = None
    for n, p in lora.named_parameters():
        p.grad = grads_d[n]
    flat = {}
    for group in ("double_blocks", "single_blocks"):
        blocks = getattr(lora, group)
        for leaf in blocks[0].keys():
            for ab in ("a", "b"):
                flat[f"{group}.{leaf}.{ab}"] = np.stack([getattr(blk[leaf], ab).grad.numpy() for blk in blocks])
    ref_flat = jtrainer._flatten(ref_grads)
    assert sorted(flat) == sorted(ref_flat)
    for k in flat:
        np.testing.assert_allclose(flat[k], np.asarray(ref_flat[k]), atol=LOSS_TOL, rtol=0, err_msg=k)


def test_remat_dots_backward_reruns_no_2d_product():
    """remat=True re-runs each block's forward in the backward, 2-D products
    included; "dots" keeps their outputs, so its backward issues exactly the
    products of remat=False's backward (the gradients' own)."""
    jpipe, tpipe, a = _dots_inputs()
    lora = lora_from_jax(jax_lora(jax.tree_util.tree_map(np.asarray, jpipe.transformer_params)))
    counts = {}
    for remat in (False, True, "dots"):
        counts[remat] = _port_grads(tpipe, lora, remat, a)[2]
    forward = _MMCount()
    with forward, torch.no_grad():
        t = {k: torch.from_numpy(np.array(v)) for k, v in a.items()}
        tpipe.transformer(t["latents"], t["emb"], t["sigmas"], t["cos"], t["sin"], guidance=t["guidance"], lora=lora,
                          lora_scale=2.0)
    assert counts["dots"] == counts[False] and counts[True] > counts[False]
    # the blocks' products (all but the prelude's and _final's) are what remat=True recomputes
    assert 0 < counts[True] - counts[False] < forward.n


def test_remat_value_outside_jax_policies_raises():
    _, tpipe, a = _dots_inputs()
    t = {k: torch.from_numpy(np.array(v)) for k, v in a.items()}
    with pytest.raises(ValueError, match="dots"):
        tpipe.transformer(t["latents"], t["emb"], t["sigmas"], t["cos"], t["sin"], guidance=t["guidance"],
                          remat="nothing")


# -- resume across packages ------------------------------------------------------------

def _jax_state(optimizer: str, updates: int):
    """JAX's LoRA on the tiny DiT and its optax state after ``updates`` updates with seeded gradients."""
    jpipe, _ = tiny_pipelines("klein-4b-base")
    lj = jax.tree_util.tree_map(jnp.asarray, jax_lora(jax.tree_util.tree_map(np.asarray, jpipe.transformer_params)))
    cfg = jtrainer.TrainConfig(rank=4, alpha=8.0, optimizer=optimizer, warmup_steps=1, lr_scheduler="cosine",
                               total_steps=10, learning_rate=1e-2, max_grad_norm=0.5)
    opt = jtrainer.make_optimizer(cfg)
    state = opt.init(lj)
    rng = np.random.RandomState(9)
    for _ in range(updates):
        grads = jax.tree_util.tree_map(lambda x: jnp.asarray(rng.randn(*x.shape).astype(np.float32)), lj)
        upd, state = opt.update(grads, state, lj)
        lj = optax.apply_updates(lj, upd)
    return cfg, opt, lj, state


def _port_cfg(jcfg) -> ttrainer.TrainConfig:
    return ttrainer.TrainConfig(**{f.name: getattr(jcfg, f.name) for f in dataclasses.fields(ttrainer.TrainConfig)})


@pytest.mark.parametrize("optimizer", ["adamw", "lion"])
def test_jax_checkpoint_resumes_in_the_port_with_its_optimizer_state(tmp_path, optimizer):
    jcfg, opt, lj, state = _jax_state(optimizer, 2)
    jtrainer.save_checkpoint(str(tmp_path), jtrainer.TrainState(lora=lj, opt_state=state, step=2), jcfg)
    restored = ttrainer.load_checkpoint(str(tmp_path), _port_cfg(jcfg), "cpu")  # strict
    assert restored.step == 2 and restored.optimizer.count == 2
    ours = {k: v.numpy() for k, v in restored.optimizer.state_arrays().items()}
    ref = {k: np.asarray(v) for k, v in jtrainer._opt_state_by_path(state).items()}
    assert sorted(ours) == sorted(ref)
    assert all(np.array_equal(ours[k].reshape(ref[k].shape), ref[k]) for k in ref)
    # the next update, from the same gradients, lands where JAX's does
    rng = np.random.RandomState(10)
    grads = jax.tree_util.tree_map(lambda x: jnp.asarray(rng.randn(*x.shape).astype(np.float32)), lj)
    upd, _ = opt.update(grads, state, lj)
    want = lora_to_flat(lora_from_jax(jax.tree_util.tree_map(np.asarray, optax.apply_updates(lj, upd))))
    flat = jtrainer._flatten(jax.tree_util.tree_map(np.asarray, grads))
    restored.optimizer.step([torch.from_numpy(np.array(flat[_stacked_name(n)][int(n.split(".")[1])]))
                             for n in restored.optimizer.names])
    got = lora_to_flat(restored.lora)
    assert all(np.abs(got[k] - want[k]).max() <= 1e-6 for k in want)


def _stacked_name(name: str) -> str:
    group, _, leaf, ab = name.split(".")
    return f"{group}.{leaf}.{ab}"


@pytest.mark.parametrize("optimizer", ["adamw", "lion"])
def test_port_checkpoint_loads_in_jax_strict_loader(tmp_path, optimizer):
    jcfg, _, lj, _ = _jax_state(optimizer, 0)
    cfg = _port_cfg(jcfg)
    state = ttrainer.TrainState(lora=lora_from_jax(jax.tree_util.tree_map(np.asarray, lj)), optimizer=None, step=3)
    state.optimizer = ttrainer.make_optimizer(cfg, state.lora)
    gen = torch.Generator().manual_seed(3)
    for _ in range(3):
        state.optimizer.step([torch.randn(p.shape, generator=gen) for p in state.optimizer.params])
    ttrainer.save_checkpoint(str(tmp_path), state, cfg)
    jpipe, _ = tiny_pipelines("klein-4b-base")
    restored = jtrainer.load_checkpoint(str(tmp_path), jpipe.transformer_params, jcfg)  # strict
    ref = {k: np.asarray(v) for k, v in jtrainer._opt_state_by_path(restored.opt_state).items()}
    ours = {k: v.numpy() for k, v in state.optimizer.state_arrays().items()}
    assert sorted(ref) == sorted(ours) and int(ref["[1][0].count"]) == int(ref["[1][2].count"]) == 3
    assert all(np.array_equal(ref[k], ours[k]) for k in ref)


def test_checkpoint_in_the_old_port_keys_still_resumes(tmp_path):
    jcfg, _, lj, _ = _jax_state("adamw", 0)
    cfg = _port_cfg(jcfg)
    lora = lora_from_jax(jax.tree_util.tree_map(np.asarray, lj))
    opt = ttrainer.make_optimizer(cfg, lora)
    gen = torch.Generator().manual_seed(4)
    opt.step([torch.randn(p.shape, generator=gen) for p in opt.params])
    opt.step([torch.randn(p.shape, generator=gen) for p in opt.params])
    old = {"count": np.array([opt.count], np.int64)}  # the keys PRs 3-12 wrote
    for prefix, moments in (("mu", opt.mu), ("nu", opt.nu)):
        old.update({f"{prefix}.{n}": m.numpy() for n, m in zip(opt.names, moments)})
    ttrainer.save_checkpoint(str(tmp_path), ttrainer.TrainState(lora=lora, optimizer=opt, step=2), cfg)
    tst.save_file(old, os.path.join(str(tmp_path), "optimizer.safetensors"))
    restored = ttrainer.load_checkpoint(str(tmp_path), cfg, "cpu")
    assert restored.optimizer.count == 2
    assert all(torch.equal(a, b) for a, b in zip(restored.optimizer.mu + restored.optimizer.nu, opt.mu + opt.nu))
    del old["nu." + opt.names[0]]
    tst.save_file(old, os.path.join(str(tmp_path), "optimizer.safetensors"))
    with pytest.raises(ValueError, match="missing"):
        ttrainer.load_checkpoint(str(tmp_path), cfg, "cpu")


# -- the slice through cli.main: checkpoints, QLoRA, random-init, R5, evaluate-lora -----

@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """The tiny checkpoint tree (DiT, VAE, 28-layer Qwen3, dev tokenizer); its
    VAE filled from ``jax.eval_shape`` (JAX's eager VAE init takes ~18 s)."""
    saved = ckpt_tests.perturbed_vae_params
    ckpt_tests.perturbed_vae_params = lambda: vae_params("tiny")
    try:
        return ckpt_tests.write_tiny_tree(tmp_path_factory.mktemp("tree"))
    finally:
        ckpt_tests.perturbed_vae_params = saved


def _jax_e2e_yaml(tmp_path, dataset_dir, validation_dir, **extra) -> str:
    """JAX's ``tests/test_training_e2e.py::_write_config``, field for field."""
    import yaml

    cfg = {
        "model": "klein-4b",
        "dataset": {"dataset_dir": dataset_dir, "trigger_word": "tpz", "resolution": 64},
        "lora": {"rank": 2, "alpha": 2.0},
        "training": {"max_steps": 2, "batch_size": 1, "learning_rate": 1e-3, "save_every": 2, "seed": 7,
                     "remat": False, "lr_scheduler": "cosine", "warmup_steps": 1, "use_ema": True, "ema_decay": 0.9,
                     "caption_dropout": 0.5, "keep_last_checkpoints": 1},
        "validation": {"prompts": ["a tpz photo"], "every": 2, "steps": 1, "size": 64, "early_stop_patience": 2},
        "validation_dataset_dir": validation_dir,
    }
    cfg.update(extra)
    path = tmp_path / "train.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


def test_train_lora_from_checkpoints_on_a_dataset_writes_what_jax_asserts(tree, dataset, tmp_path, capsys):
    out = tmp_path / "run"
    cfg = _jax_e2e_yaml(tmp_path, dataset["dataset"], dataset["validation"])
    assert tcli.main(["train-lora", "--config", cfg, "--output-dir", str(out), *ckpt_tests.tree_argv(tree),
                      "--device", "cpu"]) == 0
    ckpt = out / "checkpoint_000002"
    assert all((ckpt / f).exists() for f in ("lora.safetensors", "optimizer.safetensors", "lora_ema.safetensors"))
    assert (out / "learning_curve.svg").exists()
    assert [d for d in os.listdir(out) if d.startswith("checkpoint_")] == ["checkpoint_000002"]
    cache_files = [f for f in os.listdir(out / "latent_cache") if f.endswith(".npy")]
    assert len(cache_files) == len(SIZES)
    assert {np.load(str(out / "latent_cache" / f)).shape for f in cache_files} == {(1, 16, 128), (1, 24, 128)}
    emb_files = os.listdir(out / "latent_cache" / "text_embeddings")
    assert len(emb_files) >= 2 and all(f.endswith(".npy") for f in emb_files)
    state = json.loads((ckpt / "training_state.json").read_text())
    vlh = state["val_loss_history"]
    assert vlh and vlh[-1]["step"] == 2 and np.isfinite(vlh[-1]["loss"])
    assert {r["step"] for r in state["validation_scores"]} == {0, 2}
    pngs = os.listdir(out / "validation")
    assert any(f.startswith("val_000000_") for f in pngs) and any(f.startswith("val_000002_") for f in pngs)
    assert (out / "best" / "lora.safetensors").exists()
    err = capsys.readouterr().err
    assert "distilled sibling klein-4b weights not found; validating with the training base variant" in err
    assert "validation loss: 2 held-out item(s), 2 fixed batch(es)" in err


def test_checkpoint_branch_without_a_dataset_exits_as_jax(tree, tmp_path):
    cfg = _jax_e2e_yaml(tmp_path, str(tmp_path / "missing"), None)
    with pytest.raises(SystemExit, match="train-lora needs dataset_dir"):
        tcli.main(["train-lora", "--config", cfg, *ckpt_tests.tree_argv(tree), "--device", "cpu"])


def _qlora_yaml(tmp_path, dataset, steps=2, validation=False) -> str:
    extra = "validation: {prompts: [a sks photo], every_n_steps: 1, steps: 1, size: 64}\n" if validation else ""
    return _yaml(tmp_path / "q.yaml", f"""model: {{name: klein-4b}}
lora: {{rank: 2, alpha: 2}}
dataset: {{path: {dataset['dataset']}, image_size: 64, trigger_word: sks}}
training: {{max_steps: {steps}, learning_rate: 1.0e-3, warmup_steps: 0, log_every: 1}}
checkpoints: {{output: {tmp_path / 'out'}, save_every: 0}}
{extra}""")


@pytest.mark.parametrize("fmt", ["qint8", "nf4", "w8a8", "int4"])
def test_qlora_from_the_cli_quantizes_the_checkpoint_base(tree, dataset, tmp_path, fmt, monkeypatch):
    from flux2_tpu_torch.ops import quant as tq

    built = []
    build = tcli.build_pipeline
    monkeypatch.setattr(tcli, "build_pipeline", lambda args, device, *a, **k: built.append(build(args, device, *a, **k))
                        or built[-1])
    history = ttrain_cli.run_training(tcli.parse_args(["train-lora", "--config", _qlora_yaml(tmp_path, dataset),
                                                       *ckpt_tests.tree_argv(tree), "--quantization", fmt,
                                                       "--device", "cpu"]), "cpu")
    assert [r["step"] for r in history] == [1, 2] and all(np.isfinite(r["loss"]) and r["grad_norm"] > 0
                                                          for r in history)
    names = sorted(tq.quantized_names(built[0].transformer))
    assert names and all(getattr(built[0].transformer.get_submodule(n), "format", None) == fmt for n in names[:3])


def test_validation_on_a_w8a8_base_raises_jax_type_error(tree, dataset, tmp_path):
    args = tcli.parse_args(["train-lora", "--config", _qlora_yaml(tmp_path, dataset, validation=True),
                            *ckpt_tests.tree_argv(tree), "--quantization", "w8a8", "--device", "cpu"])
    with pytest.raises(TypeError, match="runtime-format"):
        ttrain_cli.run_training(args, "cpu")


def _random_yaml(tmp_path, dataset, out, validation: bool, steps=3, extra="") -> str:
    val = ("validation: {prompts: [a sks photo], every_n_steps: 1, steps: 1, size: 64}\n" if validation else "")
    return _yaml(tmp_path / f"r_{out}.yaml", f"""model: {{name: klein-4b}}
lora: {{rank: 2, alpha: 2}}
dataset: {{path: {dataset['dataset']}, image_size: 64, trigger_word: sks, control_path: {dataset['control']}}}
training: {{max_steps: {steps}, learning_rate: 1.0e-2, warmup_steps: 0, log_every: 1, caption_dropout: 0.5}}
loss: {{diff_output_preservation: true, diff_output_preservation_every_n_steps: 2}}
memory: {{gradient_checkpointing: dots}}
ema: {{enabled: true}}
checkpoints: {{output: {tmp_path / out}, save_every: 1}}
{val}{extra}""")


def _random_run(cfg, *flags):
    return ttrain_cli.run_training(tcli.parse_args(["train-lora", "--config", cfg, "--random-init", *flags,
                                                    "--device", "cpu"]), "cpu", transformer_config=TC, vae_config=VC)


def test_random_init_on_a_dataset_validation_leaves_the_base_and_the_losses_alone(dataset, tmp_path, monkeypatch):
    """R5: a validation pass merges the LoRA into a copy; the base's bytes and
    every later step's loss equal a run without validation, to the bit."""
    pipes = []
    build = ttrain_cli._build_random_pipeline
    monkeypatch.setattr(ttrain_cli, "_build_random_pipeline",
                        lambda *a, **k: pipes.append(build(*a, **k)) or pipes[-1])
    plain = _random_run(_random_yaml(tmp_path, dataset, "plain", validation=False))
    validated = _random_run(_random_yaml(tmp_path, dataset, "val", validation=True))
    assert [r["loss"] for r in plain] == [r["loss"] for r in validated]
    assert [r["dop_loss"] > 0 for r in validated] == [False, True, False]
    before = {k: v.clone() for k, v in pipes[0].transformer.state_dict().items()}
    after = pipes[1].transformer.state_dict()
    assert all(torch.equal(before[k], after[k]) for k in before)  # the same seed: the same base, unchanged
    assert sorted(os.listdir(tmp_path / "val" / "validation")) == [f"val_{s:06d}_p0_0.png" for s in range(4)]
    a, b = (tst.load_file(str(tmp_path / d / "checkpoint_000003" / "lora.safetensors")) for d in ("plain", "val"))
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_random_init_on_a_dataset_resumes_from_its_caches(dataset, tmp_path, monkeypatch):
    """A run resumed from step 2 in the same output directory reads both disk
    caches (no VAE encode, no caption encode) and ends with the uninterrupted
    run's LoRA and EMA, to the bit."""
    from flux2_tpu_torch.pipeline.pipeline import Flux2Pipeline

    cfg = _random_yaml(tmp_path, dataset, "out", validation=False, steps=4)
    _random_run(cfg)
    final = {f: tst.load_file(str(tmp_path / "out" / "checkpoint_000004" / f))
             for f in ("lora.safetensors", "lora_ema.safetensors")}
    calls = {"vae": 0, "text": 0}
    encode = Flux2Pipeline.encode_image_to_packed_sequence
    monkeypatch.setattr(Flux2Pipeline, "encode_image_to_packed_sequence",
                        lambda self, *a, **k: calls.__setitem__("vae", calls["vae"] + 1) or encode(self, *a, **k))
    prompt = Flux2Pipeline.encode_prompt
    monkeypatch.setattr(Flux2Pipeline, "encode_prompt",
                        lambda self, p: calls.__setitem__("text", calls["text"] + 1) or prompt(self, p))
    history = _random_run(cfg, "--resume", str(tmp_path / "out" / "checkpoint_000002"))
    assert [r["step"] for r in history] == [3, 4] and calls == {"vae": 0, "text": 0}
    for f, want in final.items():
        got = tst.load_file(str(tmp_path / "out" / "checkpoint_000004" / f))
        assert all(torch.equal(got[k], want[k]) for k in want), f


def test_epochs_set_the_steps_and_an_explicit_max_steps_wins(dataset, tmp_path, capsys):
    cfg = _random_yaml(tmp_path, dataset, "ep", validation=False, steps=50, extra="epochs: 2\n")
    history = _random_run(cfg)
    assert len(history) == 2 * 3  # 3 paired items, batch 1
    assert "epochs=2 -> 6 steps (3 items, effective batch 1)" in capsys.readouterr().err
    assert len(_random_run(cfg, "--max-steps", "1", "--output-dir", str(tmp_path / "ep2"))) == 1


def test_random_init_builds_jax_tiny_encoder_and_refuses_dev():
    from flux2_tpu_torch.models.flux2.config import Flux2Model

    pipe = ttrain_cli._build_random_pipeline(Flux2Model.KLEIN_4B_BASE, torch.device("cpu"), TC, VC)
    dec = pipe.text_encoder.decoder
    assert pipe.text_encoder.hidden_layers == (1, 2, 3) and len(dec.layers) == 3 and pipe.text_encoder.recipe == "klein"
    assert dec.cfg.hidden_size == 32 and dec.cfg.head_dim == 64 and dec.cfg.vocab_size == 512
    assert pipe.encode_prompt("a sks photo").shape == (1, 512, 96)
    with pytest.raises(SystemExit, match="Mistral-24B"):
        ttrain_cli._build_random_pipeline(Flux2Model.DEV, torch.device("cpu"))


# -- evaluate-lora ----------------------------------------------------------------------

EVAL_ARGV = ["evaluate-lora", "--dataset", "d", "--output-dir", "o", "--max-samples", "2", "--no-vlm", "--width", "64",
             "--height", "32", "--steps", "2", "--seed", "3"]


def test_evaluate_lora_parser_equals_jax():
    ours, ref = vars(tcli.parse_args(EVAL_ARGV)), vars(jcli.build_parser().parse_args(EVAL_ARGV))
    for k in ("dataset", "output_dir", "max_samples", "no_vlm", "width", "height", "steps", "seed", "model",
              "quantization", "prompt"):
        assert ours[k] == ref[k], k
    defaults = vars(tcli.parse_args(["evaluate-lora", "--dataset", "d"]))
    ref_defaults = vars(jcli.build_parser().parse_args(["evaluate-lora", "--dataset", "d"]))
    assert [defaults[k] for k in ("output_dir", "max_samples", "no_vlm")] == [
        ref_defaults[k] for k in ("output_dir", "max_samples", "no_vlm")] == ["lora_eval", 4, False]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pixel_scorer_equals_jax(seed):
    rng = np.random.RandomState(seed)
    image, ref = rng.rand(32, 48, 3).astype(np.float32), rng.rand(40, 24, 3).astype(np.float32) ** (seed + 1)
    assert tcli._pixel_scorer(image, ref) == jcli._pixel_scorer(image, ref)


def test_evaluate_lora_prints_jax_lines_and_json(tree, dataset, tmp_path, capsys, monkeypatch):
    scores = []
    scorer = tcli._pixel_scorer
    monkeypatch.setattr(tcli, "_pixel_scorer", lambda img, ref: scores.append(scorer(img, ref)) or scores[-1])
    out = tmp_path / "eval"
    assert tcli.main(["evaluate-lora", *ckpt_tests.tree_argv(tree), "--dataset", dataset["dataset"], "--output-dir",
                      str(out), "--max-samples", "2", "--no-vlm", "--width", "64", "--height", "64", "--steps", "1",
                      "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert sorted(os.listdir(out)) == ["baseline_000.png", "baseline_001.png"]
    from flux2_tpu.training import validation as jval

    gap = jval.evaluate_training_need(scores)
    captions = [open(os.path.join(dataset["dataset"], f"image_0{i}.txt")).read().replace("[trigger]", "")
                .replace("  ", " ").strip() for i in range(2)]
    assert lines[:-1] == [f"saved {out}/baseline_000.png",
                          f"[1/2] scene={scores[0][0]:.1f} style={scores[0][1]:.1f}  {captions[0][:60]}",
                          f"saved {out}/baseline_001.png",
                          f"[2/2] scene={scores[1][0]:.1f} style={scores[1][1]:.1f}  {captions[1][:60]}"]
    assert json.loads(lines[-1]) == {
        "scene_score": round(gap.scene_score, 2), "style_score": round(gap.style_score, 2),
        "recommended_rank": gap.recommended_rank, "recommended_steps": gap.recommended_steps,
        "recommended_timestep_sampling": gap.recommended_timestep_sampling, "recommended_alpha": gap.recommended_alpha,
        "recommended_learning_rate": gap.recommended_learning_rate,
        "recommended_warmup_steps": gap.recommended_warmup_steps,
        "recommended_loss_weighting": gap.recommended_loss_weighting,
        "recommended_target_layers": gap.recommended_target_layers, "notes": gap.notes}
    assert list(json.loads(lines[-1])) == list(_jax_evaluate_json_keys())


@functools.lru_cache(maxsize=1)
def _jax_evaluate_json_keys():
    """The keys, in order, of the JSON line JAX's cmd_evaluate_lora prints (read from its source)."""
    import inspect
    import re

    src = inspect.getsource(jcli.cmd_evaluate_lora)
    return tuple(re.findall(r'^\s+"(\w+)":', src[src.index("json.dumps"):], re.M))


# -- the loop's validation-driven stops, best/, the save_every: 0 warning, the beacon ---

def test_best_is_saved_at_a_non_save_step_and_the_tracker_stops(dataset, tmp_path, monkeypatch, capsys):
    """Constant scores: step 2's pass sets best (checkpointed there though
    save_every is 4, then copied to best/), step 4's does not improve, and
    patience 1 stops the run there; the beacon follows every step."""
    monkeypatch.setattr(ttrain_cli, "_make_scorer", lambda pipe: lambda image, refs, prompt: (5.0, 5.0))
    updates = []
    from flux2_tpu_torch.utils import beacon

    monkeypatch.setattr(beacon.RuntimeBeacon, "update", lambda self, **kw: updates.append(kw))
    cfg = _random_yaml(tmp_path, dataset, "best", validation=False, steps=8,
                       extra="validation: {prompts: [a sks photo], every_n_steps: 2, steps: 1, size: 64, "
                             "early_stop_patience: 1}\n")
    cfg = _yaml(tmp_path / "best.yaml", open(cfg).read().replace("save_every: 1", "save_every: 4"))
    history = _random_run(cfg)
    out = tmp_path / "best"
    assert [r["step"] for r in history] == [1, 2, 3, 4]
    assert "early stop: 1 non-improving validation(s)" in capsys.readouterr().err
    assert sorted(d for d in os.listdir(out) if d.startswith("checkpoint_")) == ["checkpoint_000002", "checkpoint_000004"]
    best = tst.load_file(str(out / "best" / "lora.safetensors"))
    step2 = tst.load_file(str(out / "checkpoint_000002" / "lora.safetensors"))
    assert all(torch.equal(best[k], step2[k]) for k in best)
    assert updates == [{"phase": "training", "step": s, "total_steps": 8} for s in (1, 2, 3, 4)]


@pytest.mark.parametrize("early_stop,stopped_at,message", [
    ("{on_overfit: true, max_gap: -100.0, gap_patience: 1}", 1, "early stop: val-train gap"),
    ("{on_val_stagnation: true, min_val_improvement: 100.0, val_patience: 1}", 2, "early stop: val loss stagnant"),
], ids=["overfit", "stagnation"])
def test_held_out_loss_early_stops(dataset, tmp_path, capsys, early_stop, stopped_at, message):
    cfg = _random_yaml(tmp_path, dataset, "held", validation=False, steps=5,
                       extra=f"validation_dataset_dir: {dataset['validation']}\nvalidation: {{every_n_steps: 1}}\n"
                             f"early_stop: {early_stop}\n")
    history = _random_run(cfg)
    err = capsys.readouterr().err
    assert len(history) == stopped_at and message in err
    state = json.loads((tmp_path / "held" / f"checkpoint_{stopped_at:06d}" / "training_state.json").read_text())
    assert [v["step"] for v in state["val_loss_history"]] == list(range(1, stopped_at + 1))


def test_save_every_0_warns_and_runs_no_validation(dataset, tmp_path, capsys):
    cfg = _random_yaml(tmp_path, dataset, "zero", validation=False, steps=2,
                       extra=f"validation_dataset_dir: {dataset['validation']}\n"
                             "validation: {prompts: [a sks photo], steps: 1, size: 64}\n")
    cfg = _yaml(tmp_path / "zero.yaml", open(cfg).read().replace("save_every: 1", "save_every: 0"))
    assert len(_random_run(cfg)) == 2
    assert "validation is configured but validation_every/save_every are 0" in capsys.readouterr().err
    assert not os.path.exists(tmp_path / "zero" / "validation")
