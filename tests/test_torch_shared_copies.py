"""The port's own copies of the JAX package's JAX-free modules behave as the
originals: model and encoder configs, the dev tokenizer, the training
controller and state, safetensors IO, the leveled logger, and what
``train-lora`` takes from the JAX training CLI (YAML schema, checkpoint
pruning, learning-curve SVG, training variant). Also: the port's entry points
default to the card and take the CPU only when asked.

``jax_config`` builds the JAX package's config class from a port config's
numbers; the other CPU parity tests use it wherever they feed one config to
both packages.
"""

import dataclasses
import inspect
import io
import os
from contextlib import redirect_stderr

import numpy as np
import pytest

from flux2_tpu.cli import train as jtrain_cli
from flux2_tpu.io import registry as jregistry
from flux2_tpu.io import safetensors_io as jst
from flux2_tpu.models.flux2 import config as jcfg
from flux2_tpu.models.text_encoders import config as jenc
from flux2_tpu.training import control as jcontrol
from flux2_tpu.utils import dev_tokenizer as jtok
from flux2_tpu.utils import logging as jlog
from flux2_tpu_torch.cli import main as tcli
from flux2_tpu_torch.cli import train_config as ttrain_cfg
from flux2_tpu_torch.io import safetensors_io as tst
from flux2_tpu_torch.models.flux2 import config as tcfg
from flux2_tpu_torch.models.text_encoders import config as tenc
from flux2_tpu_torch.pipeline.pipeline import Flux2Pipeline
from flux2_tpu_torch.training import control as tcontrol
from flux2_tpu_torch.training.trainer import TrainConfig
from flux2_tpu_torch.utils import dev_tokenizer as ttok
from flux2_tpu_torch.utils import logging as tlog


def jax_config(cfg):
    """The JAX package's config (Flux2TransformerConfig or DecoderConfig) with
    the numbers of the port's ``cfg``."""
    cls = {tcfg.Flux2TransformerConfig: jcfg.Flux2TransformerConfig, tenc.DecoderConfig: jenc.DecoderConfig}[type(cfg)]
    return cls(**dataclasses.asdict(cfg))


def _fields(obj) -> dict:
    return dataclasses.asdict(obj)


# -- configs -------------------------------------------------------------------


@pytest.mark.parametrize("name", [m.name for m in jcfg.Flux2Model])
def test_flux2_model_equals_jax(name):
    port, ref = tcfg.Flux2Model[name], jcfg.Flux2Model[name]
    assert port.value == ref.value and port is not ref  # the port's own enum
    assert _fields(port.transformer_config) == _fields(ref.transformer_config)
    for prop in ("default_steps", "default_guidance", "uses_guidance_embeds", "uses_classical_cfg",
                 "supports_kv_cache", "max_reference_images", "joint_attention_dim", "is_commercial_licensed"):
        assert getattr(port, prop) == getattr(ref, prop), prop
    cfg = port.transformer_config
    assert (cfg.inner_dim, cfg.mlp_hidden_dim) == (ref.transformer_config.inner_dim,
                                                  ref.transformer_config.mlp_hidden_dim)


@pytest.mark.parametrize("name", ["FLUX2_DEV", "KLEIN_9B", "KLEIN_4B", "TINY_TEST"])
def test_transformer_configs_equal_jax(name):
    assert _fields(getattr(tcfg, name)) == _fields(getattr(jcfg, name))
    d = {"num_layers": 3, "num_attention_heads": 4, "axes_dims_rope": [16, 16, 16, 16], "guidance_embeds": False}
    assert _fields(tcfg.Flux2TransformerConfig.from_json_dict(d)) == _fields(
        jcfg.Flux2TransformerConfig.from_json_dict(d))


@pytest.mark.parametrize("name", ["QWEN3_4B", "QWEN3_8B", "TINY_DECODER", "MISTRAL_SMALL_3_2"])
def test_decoder_configs_equal_jax(name):
    assert _fields(getattr(tenc, name)) == _fields(getattr(jenc, name))
    assert _fields(jax_config(getattr(tenc, name))) == _fields(getattr(jenc, name))


def test_decoder_config_constants_and_json_equal_jax():
    for name in ("MISTRAL_HIDDEN_LAYERS", "QWEN3_HIDDEN_LAYERS", "MAX_SEQUENCE_LENGTH"):
        assert getattr(tenc, name) == getattr(jenc, name)
    d = {"vocab_size": 1000, "hidden_size": 64, "intermediate_size": 128, "num_hidden_layers": 2,
         "num_attention_heads": 4}
    assert _fields(tenc.DecoderConfig.from_json_dict(d, qk_norm=True, llama4=True)) == _fields(
        jenc.DecoderConfig.from_json_dict(d, qk_norm=True, llama4=True))


@pytest.mark.parametrize("name", [m.name for m in jcfg.Flux2Model])
def test_training_variant_equals_jax(name):
    assert ttrain_cfg.training_variant(tcfg.Flux2Model[name]).name == jregistry.training_variant(
        jcfg.Flux2Model[name]).name


# -- train-lora's YAML, pruning, SVG ---------------------------------------------

YAML = """model: {name: klein-9b, quantization: int8}
lora: {rank: 8, alpha: 4, target_layers: attention}
dataset: {path: /data/x, image_size: 768, trigger_word: sks}
training: {optimizer: lion, learning_rate: 3.0e-5, warmup_steps: 5, lr_scheduler: constant, batch_size: 2,
  gradient_accumulation: 2, max_steps: 40, log_every: 4, keep_only_last_n_checkpoints: 2}
loss: {weighting: bell_shaped, timestep_sampling: logit_normal, diff_output_preservation: true,
  diff_output_preservation_multiplier: 0.5}
memory: {gradient_checkpointing: false, bucketing: {enabled: true, resolutions: [512, 1024]}}
checkpoints: {output: /tmp/out, save_every: 10, learning_curve_smoothing: 5}
validation: {prompt: a cat, every_n_steps: 20, vlm_scoring: {enabled: true, scene_weight: 0.25}}
early_stop: {enabled: true, patience: 4}
ema: {enabled: true, decay: 0.9}
bogus_section: {x: 1}
"""


def test_yaml_training_config_equals_jax(tmp_path):
    path = tmp_path / "cfg.yaml"
    path.write_text(YAML)
    port_err, jax_err = io.StringIO(), io.StringIO()
    with redirect_stderr(port_err):
        port = ttrain_cfg.YAMLTrainingConfig.from_yaml(str(path))
    with redirect_stderr(jax_err):
        ref = jtrain_cli.YAMLTrainingConfig.from_yaml(str(path))
    assert _fields(port) == _fields(ref)
    assert port.dop_weight == 0.5 and port.early_stop_loss_patience == 4 and port.validation_prompts == ["a cat"]
    assert "unknown config section 'bogus_section'" in port_err.getvalue()
    assert port_err.getvalue() == jax_err.getvalue()
    assert _fields(port.override(max_steps=7, output_dir=None)) == _fields(ref.override(max_steps=7, output_dir=None))


def test_prune_checkpoints_equals_jax(tmp_path):
    dirs = {}
    for label in ("port", "jax"):
        out = tmp_path / label
        for step in (5, 10, 1000000, 20):
            (out / f"checkpoint_{step:06d}").mkdir(parents=True)
        (out / "best").mkdir()
        cfg = ttrain_cfg.YAMLTrainingConfig(output_dir=str(out), keep_last_checkpoints=2)
        prune = ttrain_cfg.prune_checkpoints if label == "port" else jtrain_cli._prune_checkpoints
        prune(cfg, keep=str(out / "checkpoint_000005"))
        dirs[label] = sorted(os.listdir(out))
    assert dirs["port"] == dirs["jax"] == ["best", "checkpoint_000005", "checkpoint_000020", "checkpoint_1000000"]


@pytest.mark.parametrize("n_losses,window", [(1, 20), (30, 5), (50, 20)])
def test_learning_curve_svg_is_byte_equal(tmp_path, n_losses, window):
    losses = list(np.random.RandomState(n_losses).rand(n_losses) * 3 + 0.1)
    ttrain_cfg.write_learning_curve_svg(losses, str(tmp_path / "port.svg"), smoothing_window=window)
    jtrain_cli.write_learning_curve_svg(losses, str(tmp_path / "jax.svg"), smoothing_window=window)
    assert (tmp_path / "port.svg").read_bytes() == (tmp_path / "jax.svg").read_bytes()


# -- training control and state ----------------------------------------------------


def test_config_hash_equals_jax():
    for cfg in (TrainConfig(), TrainConfig(rank=4, alpha=2.0, optimizer="lion", use_ema=True, seed=3)):
        assert tcontrol.config_hash(cfg) == jcontrol.config_hash(cfg)
    assert tcontrol.config_hash({"a": 1, "b": [2]}) == jcontrol.config_hash({"a": 1, "b": [2]})


def test_training_state_and_sentinels_cross_load(tmp_path):
    state = tcontrol.TrainingState(step=7, rng_seed=3, config_hash="abc")
    state.record_loss(0.5)
    state.record_val_loss(7, 0.6, 0.1)
    state.save(str(tmp_path / "port.json"))
    assert _fields(jcontrol.TrainingState.load(str(tmp_path / "port.json"))) == _fields(state)
    jstate = jcontrol.TrainingState(step=2, loss_history=[1.0, 0.9])
    jstate.save(str(tmp_path / "jax.json"))
    assert _fields(tcontrol.TrainingState.load(str(tmp_path / "jax.json"))) == _fields(jstate)
    for writer, reader in ((tcontrol.TrainingController, jcontrol.TrainingController),
                           (jcontrol.TrainingController, tcontrol.TrainingController)):
        out = tmp_path / writer.__module__.replace(".", "_")
        controller = reader(str(out))
        writer.write_sentinel(str(out), "checkpoint")
        assert controller.consume_checkpoint_request() and not controller.consume_checkpoint_request()
        writer.write_sentinel(str(out), "stop")
        assert controller.should_stop()
        writer.clear_sentinel(str(out), "stop")
        assert not controller.should_stop()


# -- safetensors, tokenizer, logging ------------------------------------------------


@pytest.mark.parametrize("writer,reader", [(tst, jst), (jst, tst)], ids=["port_to_jax", "jax_to_port"])
def test_safetensors_cross_load(tmp_path, writer, reader):
    rng = np.random.RandomState(0)
    tensors = {"a.b": rng.randn(3, 4).astype(np.float32), "c": rng.randint(0, 9, (5,)).astype(np.int8)}
    path = str(tmp_path / "x.safetensors")
    writer.save_file(tensors, path, metadata={"k": "v"})
    loaded = reader.load_file(path)
    assert sorted(loaded) == sorted(tensors)
    for name, value in tensors.items():
        assert loaded[name].dtype == value.dtype and np.array_equal(loaded[name], value)
    assert reader.load_metadata(path) == {"k": "v"} and sorted(reader.tensor_names(path)) == ["a.b", "c"]
    with open(path, "r+b") as f:  # truncate the payload: both refuse it
        f.truncate(os.path.getsize(path) - 4)
    assert not tst.payload_is_complete(path) and not jst.payload_is_complete(path)
    with pytest.raises(ValueError):
        reader.load_file(path)


def test_dev_tokenizer_gives_jax_ids():
    port, ref = ttok.inline_bpe_tokenizer(), jtok.inline_bpe_tokenizer()
    assert type(port).__name__ == type(ref).__name__
    for text in ("a serene mountain lake at dawn", "warm statue cat toy", "unseen words: ζ and 42"):
        messages = [{"role": "user", "content": text}]
        assert port.apply_chat_template(messages, add_generation_prompt=True) == ref.apply_chat_template(
            messages, add_generation_prompt=True)


def test_logging_equals_jax(capsys):
    for mod in (tlog, jlog):
        mod.set_level("info")
        mod.verbose("hidden")
        mod.info("shown")
        mod.warning("careful")
        with mod.timed("step", level="verbose"):
            pass
    port_lines, jax_lines = np.array_split(capsys.readouterr().err.splitlines(), 2)
    assert list(port_lines) == list(jax_lines) == ["[flux2:info] shown", "[flux2:warn] careful"]
    assert tlog.LEVELS == jlog.LEVELS and tlog.is_loggable("error") and not tlog.is_loggable("verbose")


# -- entry points default to the card -------------------------------------------------


@pytest.mark.parametrize("argv", [["t2i", "--random-init"], ["train-lora", "--config", "x.yaml", "--random-init"]],
                         ids=["t2i", "train-lora"])
def test_cli_device_defaults_to_cuda(argv):
    assert tcli.parse_args(argv).device == "cuda"
    assert tcli.parse_args([*argv, "--device", "cpu"]).device == "cpu"


def test_from_random_defaults_to_cuda():
    assert inspect.signature(Flux2Pipeline.from_random).parameters["device"].default == "cuda"
