"""Checkpoints into the port, against the JAX package's loaders (CPU).

Weights come from the JAX package's ``init_params``, perturbed with seeded
noise, and are written as safetensors in each dialect by the JAX tests' own
checkpoint writers (``tests/test_weight_mapping.py``), in bf16 or float32,
split over two files. The port's loaders (``flux2_tpu_torch/io``) must give, to the bit, the
state that JAX's mapping gives carried through ``io/jax_params.py``:
- DiT: ``transformer_from_jax(_to_bf16(map_transformer_weights(raw)))`` for
  BFL, Diffusers and quanto ``._data``/``._scale`` files; its forward (cast to
  float32) within 5e-4 of JAX's on the same rounded weights;
- VAE decoder: ``vae_from_jax(map_vae_weights(raw))``, ``to_out.0`` and
  ``to_out``, with and without ``bn`` statistics; a decode within 1e-4;
- Qwen3: ``decoder_from_jax(map_decoder_weights(raw))`` with ``model.``,
  ``language_model.`` and no prefix; hidden states within 1e-5 in float32
  and within ``ENCODER_BF16_TOL`` in bf16.
Then a whole checkpoint tree (``write_tiny_tree``) through the port's and
JAX's ``build_pipeline``: latents within atol 1e-3 with JAX's noise injected,
``t2i`` writing a PNG, JAX's exit messages for a missing directory, a
truncated file refused before any module is built, and a bf16 file read with
``ml_dtypes`` blocked.
"""

import argparse
import dataclasses
import functools
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests.test_weight_mapping as jwm_tests
from flux2_tpu.cli import main as jcli
from flux2_tpu.io import checkpoints as jckpt
from flux2_tpu.io import weight_mapping as jwm
from flux2_tpu.models.flux2 import transformer as jtfm
from flux2_tpu.models.flux2 import vae as jvae
from flux2_tpu.models.text_encoders import decoder as jdec
from flux2_tpu.ops import latents as jlu
from flux2_tpu.ops.rope import rope_embeddings
from flux2_tpu.pipeline.pipeline import _seeded_noise_seq
from flux2_tpu_torch.cli import main as tcli
from flux2_tpu_torch.io import checkpoints as tckpt
from flux2_tpu_torch.io import safetensors_io as tst
from flux2_tpu_torch.io import weight_mapping as twm
from flux2_tpu_torch.io.jax_params import decoder_from_jax, transformer_from_jax, vae_from_jax
from flux2_tpu_torch.io.png import decode_png
from flux2_tpu_torch.models.flux2.config import TINY_TEST, Flux2TransformerConfig
from flux2_tpu_torch.models.flux2.vae import VAEConfig
from flux2_tpu_torch.models.text_encoders.config import TINY_DECODER

from tests.test_torch_shared_copies import jax_config
from tests.test_torch_text_encoder import _ids_mask
from tests.test_torch_transformer import perturbed_numpy

DIT_TOL = 5e-4
VAE_TOL = 1e-4
ENCODER_TOL = 1e-5
# bf16 hidden states of the port against JAX's on the same bf16 weights, max
# abs over the embedding and the four layers of TINY_DECODER: each package
# rounds its own intermediates to bf16 (torch's CPU kernels and XLA's in other
# places). Measured 0.109 (layer 4; 0.016-0.078 before it) where |h| reaches
# 6.6 and bf16's step is 2^-5; the tolerance is about twice that.
ENCODER_BF16_TOL = 0.25
LATENT_TOL = 1e-3
DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}


def _torch(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, np.float32))


def write_checkpoint(path, weights: dict, dtype: torch.dtype, files: int = 2, config: dict = None) -> str:
    """``weights`` (name -> array) as ``files`` safetensors shards in ``dtype``
    (integer arrays keep theirs), with an optional ``config.json``."""
    os.makedirs(path, exist_ok=True)
    names = list(weights)
    for i in range(files):
        shard = {k: (lambda t: t.to(dtype) if t.is_floating_point() else t)(torch.from_numpy(np.array(weights[k])))
                 for k in names[i::files]}
        tst.save_file(shard, os.path.join(path, f"model-{i + 1:05d}-of-{files:05d}.safetensors"))
    if config is not None:
        with open(os.path.join(path, "config.json"), "w") as f:
            json.dump(config, f)
    return str(path)


def _to_quanto(weights: dict) -> dict:
    """Every 2-D weight as int8 ``._data`` with a per-row ``._scale`` (optimum-quanto's layout)."""
    out = {}
    for k, v in weights.items():
        v = np.asarray(v, np.float32)
        if v.ndim == 2:
            scale = np.abs(v).max(axis=1, keepdims=True) / 127.0
            out[k + "._data"] = np.clip(np.rint(v / scale), -127, 127).astype(np.int8)
            out[k + "._scale"] = scale.astype(np.float32)
        else:
            out[k] = v
    return out


def _assert_state_equal(port: torch.nn.Module, ref: torch.nn.Module) -> None:
    got, want = port.state_dict(), ref.state_dict()
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name].dtype == want[name].dtype, name
        assert torch.equal(got[name], want[name]), name


# -- DiT ---------------------------------------------------------------------------------


@pytest.fixture(scope="module")
def dit_params():
    return perturbed_numpy(jtfm.init_params(jax.random.PRNGKey(0), jax_config(TINY_TEST), dtype=jnp.float32), 0)


def _dit_checkpoint(params, dialect: str, monkeypatch) -> dict:
    monkeypatch.setattr(jwm_tests, "CONFIG", jax_config(TINY_TEST))  # the writers' layer counts
    if dialect == "bfl":
        return jwm_tests.make_bfl_ckpt(params)
    ckpt = jwm_tests.make_diffusers_ckpt(params)
    return _to_quanto(ckpt) if dialect == "quanto" else ckpt


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
@pytest.mark.parametrize("dialect", ["bfl", "diffusers", "quanto"])
def test_transformer_maps_as_jax(dit_params, dialect, dtype, tmp_path, monkeypatch):
    path = write_checkpoint(tmp_path / "t", _dit_checkpoint(dit_params, dialect, monkeypatch), DTYPES[dtype])
    raw = jckpt.load_weights_dir(path)
    jparams = jcli._to_bf16(jwm.map_transformer_weights(raw, jax_config(TINY_TEST)))
    model = twm.load_transformer(tckpt.WeightsDir(path), TINY_TEST, "cpu")
    _assert_state_equal(model, transformer_from_jax(jparams, TINY_TEST))
    folded, ref = twm.dequantize_quanto(tckpt.load_weights_dir(path)), jwm.dequantize_quanto(raw)
    assert sorted(folded) == sorted(ref)
    assert all(torch.equal(folded[k].float(), _torch(ref[k])) for k in ref)  # the f32 products, to the bit

    rng = np.random.RandomState(1)
    lat = rng.randn(2, 16, 128).astype(np.float32)
    txt = rng.randn(2, 6, TINY_TEST.joint_attention_dim).astype(np.float32) * 0.2
    sigma, guid = np.array([0.7, 0.25], np.float32), np.array([4.0, 3.0], np.float32)
    cos, sin = rope_embeddings(jnp.asarray(np.concatenate([jlu.text_position_ids(6), jlu.image_position_ids(64, 64)])))
    f32 = jax.tree_util.tree_map(lambda x: x.astype(jnp.float32), jparams)
    ref = jtfm.forward(f32, jax_config(TINY_TEST), jnp.asarray(lat), jnp.asarray(txt), jnp.asarray(sigma), cos, sin,
                       guidance=jnp.asarray(guid))
    with torch.inference_mode():
        out = model.float()(torch.from_numpy(lat), torch.from_numpy(txt), torch.from_numpy(sigma),
                            _torch(cos), _torch(sin), guidance=torch.from_numpy(guid))
    assert float(np.max(np.abs(out.numpy() - np.asarray(ref)))) <= DIT_TOL


def test_transformer_missing_key_raises_naming_it(dit_params, tmp_path, monkeypatch):
    ckpt = _dit_checkpoint(dit_params, "diffusers", monkeypatch)
    del ckpt["transformer_blocks.0.attn.to_q.weight"]
    path = write_checkpoint(tmp_path / "t", ckpt, torch.bfloat16)
    with pytest.raises(KeyError, match="double_blocks.0.to_q"):
        twm.load_transformer(tckpt.WeightsDir(path), TINY_TEST, "cpu")
    with pytest.raises(KeyError):
        jwm.map_transformer_weights(jckpt.load_weights_dir(path), jax_config(TINY_TEST))


def test_guidance_config_without_guidance_embedder_raises(dit_params, tmp_path, monkeypatch):
    ckpt = {k: v for k, v in _dit_checkpoint(dit_params, "bfl", monkeypatch).items() if "guidance_in" not in k}
    path = write_checkpoint(tmp_path / "t", ckpt, torch.bfloat16)
    with pytest.raises(KeyError, match="guidance_embeds=True but checkpoint has no guidance embedder"):
        twm.load_transformer(tckpt.WeightsDir(path), TINY_TEST, "cpu")
    # a config without guidance skips the embedder's weights, as JAX does
    no_guidance = dataclasses.replace(TINY_TEST, guidance_embeds=False)
    assert not hasattr(twm.load_transformer(tckpt.WeightsDir(path), no_guidance, "cpu"), "guidance_linear1")


def test_bfl_final_adaln_is_half_swapped(dit_params, tmp_path, monkeypatch):
    path = write_checkpoint(tmp_path / "t", _dit_checkpoint(dit_params, "bfl", monkeypatch), torch.float32)
    raw = tckpt.load_weights_dir(path)["final_layer.adaLN_modulation.1.weight"]
    d = raw.shape[0] // 2
    norm_out = twm.load_transformer(tckpt.WeightsDir(path), TINY_TEST, "cpu", dtype=torch.float32).norm_out
    assert torch.equal(norm_out[:d], raw[d:]) and torch.equal(norm_out[d:], raw[:d])
    assert torch.equal(norm_out, _torch(dit_params["norm_out"]["kernel"]).T)


# -- VAE ---------------------------------------------------------------------------------

VAE_CONFIG = VAEConfig(block_out_channels=(8, 8, 16, 16), layers_per_block=1, norm_num_groups=4)


def vae_checkpoint(p: dict, to_out: str = "to_out.0") -> dict:
    """A diffusers AutoencoderKL checkpoint (encoder and decoder) from JAX's VAE params."""
    w = {}

    def conv(key, c):
        w[key + ".weight"] = np.transpose(np.asarray(c["kernel"]), (3, 2, 0, 1))
        w[key + ".bias"] = np.asarray(c["bias"])

    def gn(key, g):
        w[key + ".weight"], w[key + ".bias"] = np.asarray(g["scale"]), np.asarray(g["bias"])

    def dense(key, d):
        w[key + ".weight"], w[key + ".bias"] = np.asarray(d["kernel"]).T, np.asarray(d["bias"])

    def resnet(key, r):
        for name in ("norm1", "norm2"):
            gn(f"{key}.{name}", r[name])
        for name in ("conv1", "conv2", "conv_shortcut"):
            if name in r:
                conv(f"{key}.{name}", r[name])

    def mid(prefix, m):
        resnet(f"{prefix}.mid_block.resnets.0", m["resnet1"])
        resnet(f"{prefix}.mid_block.resnets.1", m["resnet2"])
        a = f"{prefix}.mid_block.attentions.0"
        gn(a + ".group_norm", m["attn"]["group_norm"])
        for name in ("to_q", "to_k", "to_v"):
            dense(f"{a}.{name}", m["attn"][name])
        dense(f"{a}.{to_out}", m["attn"]["to_out"])

    enc, dec = p["encoder"], p["decoder"]
    conv("encoder.conv_in", enc["conv_in"])
    for i, blk in enumerate(enc["down_blocks"]):
        for j, r in enumerate(blk["resnets"]):
            resnet(f"encoder.down_blocks.{i}.resnets.{j}", r)
        if "downsample" in blk:
            conv(f"encoder.down_blocks.{i}.downsamplers.0.conv", blk["downsample"])
    mid("encoder", enc["mid"])
    gn("encoder.conv_norm_out", enc["norm_out"])
    conv("encoder.conv_out", enc["conv_out"])
    conv("decoder.conv_in", dec["conv_in"])
    mid("decoder", dec["mid"])
    for i, blk in enumerate(dec["up_blocks"]):
        for j, r in enumerate(blk["resnets"]):
            resnet(f"decoder.up_blocks.{i}.resnets.{j}", r)
        if "upsample" in blk:
            conv(f"decoder.up_blocks.{i}.upsamplers.0.conv", blk["upsample"])
    gn("decoder.conv_norm_out", dec["norm_out"])
    conv("decoder.conv_out", dec["conv_out"])
    conv("quant_conv", p["quant_conv"])
    conv("post_quant_conv", p["post_quant_conv"])
    w["bn.running_mean"], w["bn.running_var"] = np.asarray(p["bn"]["running_mean"]), np.asarray(p["bn"]["running_var"])
    return w


@functools.lru_cache(maxsize=1)
def perturbed_vae_params() -> dict:
    """JAX's VAE init takes ~18 s on the CPU: made once per process, read only."""
    p = perturbed_numpy(jvae.init_params(jax.random.PRNGKey(1), jax_config_vae(VAE_CONFIG), dtype=jnp.float32), 1)
    p["bn"]["running_var"] = np.abs(p["bn"]["running_var"]) + 0.5
    return p


@pytest.fixture(scope="module")
def vae_params():
    return perturbed_vae_params()


def jax_config_vae(config: VAEConfig) -> jvae.VAEConfig:
    return jvae.VAEConfig(**dataclasses.asdict(config))


@pytest.mark.parametrize("to_out,with_bn", [("to_out.0", True), ("to_out", True), ("to_out.0", False)],
                         ids=["to_out.0", "to_out", "no_bn"])
def test_vae_decoder_maps_as_jax(vae_params, to_out, with_bn, tmp_path):
    ckpt = vae_checkpoint(vae_params, to_out)
    if not with_bn:
        del ckpt["bn.running_mean"], ckpt["bn.running_var"]
    path = write_checkpoint(tmp_path / "vae", ckpt, torch.float32)
    jparams = jwm.map_vae_weights(jckpt.load_weights_dir(path), jax_config_vae(VAE_CONFIG))
    vae = twm.load_vae(tckpt.WeightsDir(path), VAE_CONFIG, "cpu")
    _assert_state_equal(vae, vae_from_jax(jparams, VAE_CONFIG))
    assert torch.equal(vae.bn_running_var, _torch(vae_params["bn"]["running_var"]) if with_bn else torch.ones(128))

    z = np.random.RandomState(2).randn(1, 32, 4, 6).astype(np.float32)
    ref = jvae.decode(jparams, jnp.asarray(z), jax_config_vae(VAE_CONFIG))
    with torch.inference_mode():
        out = vae.decode(torch.from_numpy(z))
    assert float(np.max(np.abs(out.numpy() - np.asarray(ref)))) <= VAE_TOL


# -- Qwen3 -------------------------------------------------------------------------------


def decoder_checkpoint(p: dict, cfg, prefix: str = "model.") -> dict:
    """HF Qwen3 names (tied embeddings: no lm_head) from JAX's decoder params."""
    w = {f"{prefix}embed_tokens.weight": np.asarray(p["embed_tokens"]), f"{prefix}norm.weight": np.asarray(p["final_norm"])}
    L = p["layers"]
    for i in range(cfg.num_hidden_layers):
        pre = f"{prefix}layers.{i}."
        w[pre + "input_layernorm.weight"] = np.asarray(L["input_norm"][i])
        w[pre + "post_attention_layernorm.weight"] = np.asarray(L["post_attn_norm"][i])
        for name in ("q_proj", "k_proj", "v_proj", "o_proj"):
            w[f"{pre}self_attn.{name}.weight"] = np.asarray(L[name][i]).T
        for name in ("q_norm", "k_norm"):
            w[f"{pre}self_attn.{name}.weight"] = np.asarray(L[name][i])
        for name in ("gate_proj", "up_proj", "down_proj"):
            w[f"{pre}mlp.{name}.weight"] = np.asarray(L[name][i]).T
    return w


@pytest.fixture(scope="module")
def decoder_params():
    return perturbed_numpy(jdec.init_params(jax.random.PRNGKey(2), jax_config(TINY_DECODER), dtype=jnp.float32), 2)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("prefix", ["model.", "language_model.model.", ""], ids=["model", "language_model", "bare"])
def test_qwen3_maps_as_jax(decoder_params, prefix, dtype, tmp_path):
    path = write_checkpoint(tmp_path / "enc", decoder_checkpoint(decoder_params, TINY_DECODER, prefix), torch.float32)
    raw = jwm.strip_language_model_prefix(jckpt.load_weights_dir(path))
    jparams = jwm.map_decoder_weights(raw, jax_config(TINY_DECODER))
    if dtype == "bf16":
        jparams = jcli._to_bf16(jparams)
    decoder = twm.load_decoder(tckpt.WeightsDir(path), TINY_DECODER, "cpu", dtype=DTYPES[dtype])
    _assert_state_equal(decoder, decoder_from_jax(jparams, TINY_DECODER))

    ids, mask = _ids_mask(np.random.RandomState(3), 2, 12, [12, 7], TINY_DECODER.vocab_size)
    ref = jdec.forward_hidden_states(jparams, jax_config(TINY_DECODER), jnp.asarray(ids), jnp.asarray(mask))
    with torch.inference_mode():
        out = decoder.forward_hidden_states(torch.from_numpy(ids).long(), torch.from_numpy(mask))
    err = float(np.max(np.abs(out.float().numpy() - np.asarray(ref, np.float32))))
    assert err <= (ENCODER_TOL if dtype == "f32" else ENCODER_BF16_TOL), err


# -- a whole checkpoint tree ---------------------------------------------------------------

TREE_DIT = Flux2TransformerConfig(num_layers=1, num_single_layers=1, num_attention_heads=2, attention_head_dim=128,
                                  joint_attention_dim=192, guidance_embeds=False)
# The Klein recipe reads hidden layers (9, 18, 27): 28 layers, hidden 64 -> joint 192.
TREE_QWEN3 = dataclasses.replace(TINY_DECODER, num_hidden_layers=28, vocab_size=600)


def write_tiny_tree(root) -> dict:
    """transformer/ (Diffusers, bf16), vae/ (float32) and text_encoder/ (HF
    Qwen3, bf16, with the dev tokenizer saved by ``save_pretrained``), each
    with its config.json: JAX's perturbed init weights at tiny shapes."""
    from flux2_tpu_torch.utils import inline_bpe_tokenizer

    dirs = {k: os.path.join(str(root), k) for k in ("transformer", "vae", "text_encoder")}
    # the Diffusers writer emits a guidance embedder; Klein's checkpoints have none
    guided = jax_config(dataclasses.replace(TREE_DIT, guidance_embeds=True))
    dit = perturbed_numpy(jtfm.init_params(jax.random.PRNGKey(5), guided, dtype=jnp.float32), 5)
    saved = jwm_tests.CONFIG
    jwm_tests.CONFIG = guided
    try:
        ckpt = {k: v for k, v in jwm_tests.make_diffusers_ckpt(dit).items() if "guidance_embedder" not in k}
    finally:
        jwm_tests.CONFIG = saved
    write_checkpoint(dirs["transformer"], ckpt, torch.bfloat16, config=dataclasses.asdict(TREE_DIT))
    write_checkpoint(dirs["vae"], vae_checkpoint(perturbed_vae_params()), torch.float32, files=1, config=dataclasses.asdict(VAE_CONFIG))
    enc = perturbed_numpy(jdec.init_params(jax.random.PRNGKey(7), jax_config(TREE_QWEN3), dtype=jnp.float32), 7)
    enc_json = {k: v for k, v in dataclasses.asdict(TREE_QWEN3).items() if k not in ("qk_norm", "llama4_scaling_beta")}
    write_checkpoint(dirs["text_encoder"], decoder_checkpoint(enc, TREE_QWEN3), torch.bfloat16, config=enc_json)
    inline_bpe_tokenizer().save_pretrained(dirs["text_encoder"])
    return dirs


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return write_tiny_tree(tmp_path_factory.mktemp("tree"))


def tree_argv(dirs: dict) -> list:
    return ["--transformer-dir", dirs["transformer"], "--vae-dir", dirs["vae"], "--encoder-dir", dirs["text_encoder"]]


def _jax_args(dirs: dict) -> argparse.Namespace:
    return jcli.build_parser().parse_args(["t2i", *tree_argv(dirs)])


def test_tree_latents_match_jax_build_pipeline(tree):
    tpipe = tcli.build_pipeline(tcli.parse_args(["t2i", *tree_argv(tree), "--device", "cpu"]), "cpu")
    jpipe = jcli.build_pipeline(_jax_args(tree))
    assert tpipe.transformer.x_embedder.dtype == torch.bfloat16 and tpipe.vae.conv_in.weight.dtype == torch.float32
    assert tpipe.text_encoder.decoder.cfg == TREE_QWEN3
    # both compute in float32 on the checkpoint's bf16-rounded weights
    to_f32 = lambda tree_: jax.tree_util.tree_map(lambda x: x.astype(jnp.float32), tree_)  # noqa: E731
    jpipe.transformer_params = to_f32(jpipe.transformer_params)
    jpipe.text_encoder.params = to_f32(jpipe.text_encoder.params)
    tpipe.transformer.float()
    tpipe.text_encoder.decoder.float()
    prompt = "a serene mountain lake at dawn"
    np.testing.assert_allclose(tpipe.encode_prompt(prompt).numpy(), np.asarray(jpipe.encode_prompt(prompt)),
                               atol=ENCODER_TOL * 10, rtol=0)
    noise = np.array(_seeded_noise_seq(1234, 64, 64, 1))
    ref = jpipe.generate(prompt=prompt, height=64, width=64, num_steps=2, seed=1234, decode=False)
    res = tpipe.generate(prompt=prompt, height=64, width=64, num_steps=2, noise=torch.from_numpy(noise), decode=False)
    np.testing.assert_allclose(res.latents, np.asarray(ref.latents), atol=LATENT_TOL, rtol=0)


def test_t2i_from_tree_writes_png_and_jax_json(tree, tmp_path, capsys):
    out = str(tmp_path / "x.png")
    assert tcli.main(["t2i", *tree_argv(tree), "--prompt", "a red fox", "--width", "64", "--height", "64",
                      "--steps", "2", "--seed", "3", "--device", "cpu", "-o", out]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[-2] == f"saved {out}"
    report = json.loads(lines[-1])
    assert sorted(report) == ["duration_s", "phases", "seed", "steps"]  # no memory_gb on the CPU, as JAX's
    assert (report["seed"], report["steps"]) == (3, 2)
    assert sorted(report["phases"]) == ["denoising", "text_encoding", "vae_decoding"]
    assert decode_png(open(out, "rb").read()).shape == (64, 64, 3)


@pytest.mark.parametrize("missing", ["transformer", "vae", "text_encoder"])
def test_missing_directory_exits_with_jax_message(tree, missing, tmp_path, monkeypatch):
    monkeypatch.setenv("FLUX2_MODELS_DIR", str(tmp_path / "models"))
    monkeypatch.setenv("HF_HOME", str(tmp_path / "hf"))
    dirs = dict(tree, **{missing: str(tmp_path / "nowhere")})
    with pytest.raises(SystemExit) as port:
        tcli.build_pipeline(tcli.parse_args(["t2i", *tree_argv(dirs), "--device", "cpu"]), "cpu")
    with pytest.raises(SystemExit) as ref:
        jcli.build_pipeline(_jax_args(dirs))
    assert str(port.value) == str(ref.value) and "not found" in str(port.value)


def test_truncated_file_is_refused_before_any_module_is_built(tree, tmp_path, monkeypatch):
    import shutil

    tdir = str(tmp_path / "transformer")
    shutil.copytree(tree["transformer"], tdir)
    shard = tckpt.safetensors_files(tdir)[0]
    with open(shard, "r+b") as f:
        f.truncate(os.path.getsize(shard) - 16)
    monkeypatch.setattr(twm, "Flux2Transformer", lambda *a, **k: pytest.fail("a module was built"))
    with pytest.raises(ValueError, match="payload incomplete"):
        tcli.build_pipeline(tcli.parse_args(["t2i", *tree_argv(dict(tree, transformer=tdir)), "--device", "cpu"]), "cpu")


BF16_WITHOUT_ML_DTYPES = r"""
import sys
sys.modules["ml_dtypes"] = None  # any import of ml_dtypes now fails
import json, torch
from flux2_tpu_torch.io import checkpoints, safetensors_io
t = torch.load(sys.argv[2])
loaded = safetensors_io.load_file(sys.argv[1])["w"]
merged = checkpoints.load_weights_dir(sys.argv[3])["w"]
print(json.dumps({"dtype": str(loaded.dtype), "equal": bool(torch.equal(loaded.view(torch.int16), t.view(torch.int16))
                  and torch.equal(merged.view(torch.int16), t.view(torch.int16)))}))
"""


def test_bf16_file_loads_to_the_bit_without_ml_dtypes(tmp_path):
    from safetensors.torch import save_file

    t = torch.randn(33, 17, generator=torch.Generator().manual_seed(0)).bfloat16()
    t[0, :4] = torch.tensor([float("inf"), -0.0, float("nan"), 1e-40])
    os.makedirs(tmp_path / "d")
    save_file({"w": t}, str(tmp_path / "d" / "w.safetensors"))
    torch.save(t, str(tmp_path / "t.pt"))
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", BF16_WITHOUT_ML_DTYPES, str(tmp_path / "d" / "w.safetensors"),
                           str(tmp_path / "t.pt"), str(tmp_path / "d")],
                          cwd=root, env=dict(os.environ, PYTHONPATH=root), capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == {"dtype": "torch.bfloat16", "equal": True}
