"""The port's model registry (``flux2_tpu_torch/io/registry.py``) against the
JAX package's (CPU): the tables per model, where a model directory is found
(explicit directory, then ``FLUX2_MODELS_DIR``, then an HF-cache snapshot),
and ``verify_completeness`` on a truncated file."""

import dataclasses
import os

import numpy as np
import pytest

from flux2_tpu.io import registry as jreg
from flux2_tpu.io import safetensors_io as jst
from flux2_tpu.models.flux2 import config as jcfg
from flux2_tpu_torch.io import registry as treg
from flux2_tpu_torch.models.flux2 import config as tcfg

MODELS = [m.name for m in jcfg.Flux2Model]


@pytest.mark.parametrize("name", MODELS)
def test_tables_equal_jax(name):
    port, ref = tcfg.Flux2Model[name], jcfg.Flux2Model[name]
    assert dataclasses.asdict(treg.TRANSFORMER_REPOS[port]) == dataclasses.asdict(jreg.TRANSFORMER_REPOS[ref])
    assert treg.ENCODER_FOR_MODEL[port] == jreg.ENCODER_FOR_MODEL[ref]
    assert treg.training_variant(port).name == jreg.training_variant(ref).name
    assert treg.distilled_sibling(port).name == jreg.distilled_sibling(ref).name
    for fmt in ("bf16", "qint8", "int4", "w8a8"):
        (pspec, pfly), (rspec, rfly) = treg.variant_for_quantization(port, fmt), jreg.variant_for_quantization(ref, fmt)
        assert (dataclasses.asdict(pspec), pfly) == (dataclasses.asdict(rspec), rfly)


def _weights_dir(path) -> str:
    os.makedirs(path, exist_ok=True)
    jst.save_file({"w": np.zeros(4, np.float32)}, os.path.join(str(path), "model.safetensors"))
    return str(path)


@pytest.fixture
def homes(tmp_path, monkeypatch):
    monkeypatch.setenv("FLUX2_MODELS_DIR", str(tmp_path / "models"))
    monkeypatch.setenv("HF_HOME", str(tmp_path / "hf"))
    return tmp_path


def test_find_model_path_resolution_order(homes):
    spec = treg.TRANSFORMER_REPOS[tcfg.Flux2Model.KLEIN_4B]
    jspec = jreg.TRANSFORMER_REPOS[jcfg.Flux2Model.KLEIN_4B]
    assert treg.find_model_path(spec) is None and jreg.find_model_path(jspec) is None

    snap = _weights_dir(homes / "hf" / "hub" / "models--black-forest-labs--FLUX.2-klein-4B" / "snapshots" / "abc"
                        / "transformer")
    assert treg.find_model_path(spec) == jreg.find_model_path(jspec) == snap

    local = _weights_dir(treg.local_model_path(spec))
    assert local == str(homes / "models" / "black-forest-labs" / "FLUX.2-klein-4B" / "transformer")
    assert treg.local_model_path(spec) == jreg.local_model_path(jspec)
    assert treg.find_model_path(spec) == jreg.find_model_path(jspec) == local

    explicit = _weights_dir(homes / "mine")
    assert treg.find_model_path(spec, explicit) == jreg.find_model_path(jspec, explicit) == explicit
    empty = homes / "empty"
    empty.mkdir()
    assert treg.find_model_path(spec, str(empty)) == local  # a directory without weights is passed over
    assert treg.models_dir() == jreg.models_dir() == str(homes / "models")


def test_verify_completeness_finds_a_truncated_file(tmp_path):
    path = _weights_dir(tmp_path / "w")
    jst.save_file({"v": np.ones((64, 64), np.float32)}, os.path.join(path, "b.safetensors"))
    assert treg.verify_completeness(path) == jreg.verify_completeness(path) == (True, [])
    target = os.path.join(path, "b.safetensors")
    with open(target, "r+b") as f:
        f.truncate(os.path.getsize(target) - 100)
    assert treg.verify_completeness(path) == jreg.verify_completeness(path) == (False, ["b.safetensors"])


def test_download_is_refused_without_the_network(monkeypatch):
    """Without ``huggingface_hub`` (the only way the registry reaches the
    network), ``download`` raises JAX's RuntimeError; the fetch itself is
    tested with ``snapshot_download`` patched (tests/test_torch_cli_small.py)."""
    monkeypatch.setitem(__import__("sys").modules, "huggingface_hub", None)
    for reg in (treg, jreg):
        with pytest.raises(RuntimeError, match="huggingface_hub not available"):
            reg.download(reg.VAE_REPO)
