"""Prequantized checkpoints in the port (``flux2_tpu_torch/io/checkpoints.py``,
``export-quantized`` and the prequantized branch of ``cli.main.build_pipeline``)
against JAX's ``flux2_tpu/io/checkpoints.py`` and CLI.

Both packages write and read one format: JAX's flat names and layout. The
port's flat dict equals JAX's ``flatten_pytree`` of the same weights name by
name and byte by byte in every storage format; each package's file loads in
the other, tensor for tensor; truncated and stale files are refused with
JAX's messages; ``export-quantized`` prints JAX's lines and writes JAX's
bytes; ``t2i`` reads the file as JAX's ``build_pipeline`` does (qint8 for
w8a8, its runtime codes equal to JAX's, or bf16 under
``--dequantize-runtime``). Everything here is equal to the bit. The tiny
checkpoint directories are written from the port's random modules by
``chip_smoke.py``'s writers, which both packages read.
"""

import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flux2_tpu.cli import main as jcli
from flux2_tpu.io import checkpoints as jck
from flux2_tpu.io import safetensors_io as jst
from flux2_tpu.models.flux2 import transformer as jtfm
from flux2_tpu.ops import quant as jq
from flux2_tpu_torch.cli import main as tcli
from flux2_tpu_torch.io import checkpoints as tck
from flux2_tpu_torch.io import safetensors_io as tst
from flux2_tpu_torch.io.jax_params import transformer_from_jax
from flux2_tpu_torch.models.flux2.config import Flux2TransformerConfig
from flux2_tpu_torch.models.flux2.transformer import Flux2Transformer
from flux2_tpu_torch.ops import quant as tq

from tests.test_torch_checkpoints import TREE_DIT, VAE_CONFIG
from tests.test_torch_lora_loader import bfl_lora, one_torch_thread  # noqa: F401 (a fixture)
from tests.test_torch_shared_copies import jax_config
from tests.test_torch_transformer import perturbed_numpy

CONFIG = Flux2TransformerConfig(num_layers=2, num_single_layers=2, num_attention_heads=2,
                                attention_head_dim=128, joint_attention_dim=96, guidance_embeds=False)
STORAGE = ("qint8", "int4", "nf4", "mxfp8", "mxfp4", "nvfp4")


@pytest.fixture(scope="module")
def bf16_params():
    p = perturbed_numpy(jtfm.init_params(jax.random.PRNGKey(0), jax_config(CONFIG), dtype=jnp.float32), 0)
    return jax.tree_util.tree_map(lambda x: jnp.asarray(x).astype(jnp.bfloat16), p)


_JAX_QUANTIZED = {}


def _jax_quantized(params, fmt):
    """JAX's quantize_params of the module's weights, once per format."""
    if fmt not in _JAX_QUANTIZED:
        _JAX_QUANTIZED[fmt] = jq.quantize_params(params, fmt)
    return _JAX_QUANTIZED[fmt]


def _port_model(jax_tree, fmt="bf16"):
    model = transformer_from_jax(jax.tree_util.tree_map(np.asarray, jax_tree), CONFIG)
    return tq.quantize_params(model, fmt)


def _bytes(x) -> bytes:
    if isinstance(x, torch.Tensor):
        return x.contiguous().view(torch.uint8).numpy().tobytes()
    return np.ascontiguousarray(np.asarray(x)).tobytes()


def _state(model) -> dict:
    """Every parameter and buffer of a port module by name."""
    return dict(model.named_parameters()) | dict(model.named_buffers())


def _assert_same_model(a, b) -> None:
    sa, sb = _state(a), _state(b)
    assert sorted(sa) == sorted(sb)
    for k in sa:
        assert sa[k].dtype == sb[k].dtype and sa[k].shape == sb[k].shape and _bytes(sa[k]) == _bytes(sb[k]), k
    assert tq.quantized_names(a) == tq.quantized_names(b)


@pytest.mark.parametrize("fmt", ("bf16",) + STORAGE)
def test_flat_dict_equals_jax_flatten_pytree(bf16_params, fmt):
    flat, meta = jck.flatten_pytree(_jax_quantized(bf16_params, fmt))
    tflat, tmeta = tck.flatten_transformer(_port_model(bf16_params, fmt))
    assert tmeta == meta and sorted(tflat) == sorted(flat)
    for name, arr in flat.items():
        got = tflat[name]
        assert tuple(got.shape) == tuple(np.shape(arr)) and _bytes(got) == _bytes(arr), name


def test_runtime_formats_are_never_written(bf16_params, tmp_path):
    with pytest.raises(ValueError, match="only storage formats"):
        tck.export_prequantized(_port_model(bf16_params, "w8a8"), str(tmp_path), "w8a8")


@pytest.mark.parametrize("fmt", ["qint8", "int4"])
def test_port_export_loads_in_jax(bf16_params, fmt, tmp_path):
    path = tck.export_prequantized(_port_model(bf16_params, fmt), str(tmp_path), fmt, lora_baked=True)
    assert path == jck.prequantized_path(str(tmp_path), fmt)
    tree, meta = jck.load_prequantized(path)
    assert (meta["format"], meta["lora_baked"]) == (fmt, "1")
    ref = _jax_quantized(bf16_params, fmt)
    leaves, ref_leaves = (jax.tree_util.tree_leaves_with_path(t) for t in (tree, ref))
    assert [p for p, _ in leaves] == [p for p, _ in ref_leaves]
    for (p, a), (_, b) in zip(leaves, ref_leaves):
        assert a.dtype == b.dtype and _bytes(a) == _bytes(b), p
    # and through JAX's template-checked path
    rebuilt = jck.unflatten_to_like(*tst_flat(path), bf16_params)
    assert isinstance(rebuilt["double_blocks"]["to_q"], jq.QTensor)


def tst_flat(path):
    return jst.load_file(path), jst.load_metadata(path)


@pytest.mark.parametrize("fmt", ["qint8", "int4", "mxfp8"])
def test_jax_export_loads_into_the_port(bf16_params, fmt, tmp_path):
    qparams = _jax_quantized(bf16_params, fmt)
    path = jck.export_prequantized(qparams, str(tmp_path), fmt)
    tree, meta = tck.load_prequantized(path)
    assert meta["format"] == fmt
    _assert_same_model(tck.transformer_from_tree(tree, CONFIG), transformer_from_jax(qparams, CONFIG))
    template = Flux2Transformer(CONFIG, device="meta")
    _assert_same_model(tck.unflatten_to_like(tst.load_file(path), meta, template), transformer_from_jax(qparams, CONFIG))


def test_unflatten_checks_every_leaf_before_building(bf16_params, tmp_path):
    flat, meta = tck.flatten_transformer(_port_model(bf16_params, "qint8"))
    template = Flux2Transformer(CONFIG, device="meta")
    with pytest.raises(KeyError, match="checkpoint missing tensor: double_blocks/norm_q"):
        tck.unflatten_to_like({k: v for k, v in flat.items() if k != "double_blocks/norm_q"}, meta, template)
    bad = dict(flat, **{"double_blocks/norm_q": flat["double_blocks/norm_q"][:1]})
    with pytest.raises(ValueError, match="shape mismatch at double_blocks/norm_q"):
        tck.unflatten_to_like(bad, meta, template)


def _refusals(load, export, src, tmp_path, params):
    """(truncated message, stale message) of one package's loader."""
    path = export(params, str(tmp_path), "qint8", source_dir=str(src))
    load(path, expected_source_dir=str(src))  # unchanged source: fine
    out = []
    cut = str(tmp_path / "cut.safetensors")
    shutil.copy(path, cut)
    with open(cut, "r+b") as f:
        f.truncate(os.path.getsize(cut) - 64)
    with pytest.raises(ValueError) as e:
        load(cut)
    out.append(str(e.value).replace(str(tmp_path), "<dir>"))
    jst.save_file({"w": np.ones((4, 4), np.float32)}, str(src / "model.safetensors"))
    os.utime(src / "model.safetensors", (1, 1))  # a changed source: other size and mtime
    with pytest.raises(ValueError) as e:
        load(path, expected_source_dir=str(src))
    out.append(str(e.value).replace(str(tmp_path), "<dir>"))
    return out


def test_truncated_and_stale_files_are_refused_with_jax_messages(bf16_params, tmp_path):
    msgs = []
    for name, load, export, params in (
        ("jax", jck.load_prequantized, jck.export_prequantized, _jax_quantized(bf16_params, "qint8")),
        ("port", tck.load_prequantized, tck.export_prequantized, _port_model(bf16_params, "qint8")),
    ):
        (tmp_path / name / "src").mkdir(parents=True)
        jst.save_file({"w": np.zeros((2, 2), np.float32)}, str(tmp_path / name / "src" / "model.safetensors"))
        msgs.append(_refusals(load, export, tmp_path / name / "src", tmp_path / name, params))
    assert msgs[0] == msgs[1]
    assert "payload incomplete" in msgs[1][0] and "is stale" in msgs[1][1]


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """Two copies (mtimes kept, so their fingerprints agree) of a tiny
    transformer (Diffusers, bf16) and VAE directory, written from the port's
    random modules by utils/synthetic.py's writers, and a LoRA file."""
    import dataclasses

    from flux2_tpu_torch.models.flux2.vae import VAEDecoder, VAEEncoder
    from flux2_tpu_torch.utils import synthetic

    root = tmp_path_factory.mktemp("prequant")
    gen = torch.Generator().manual_seed(5)
    dit = Flux2Transformer(TREE_DIT, dtype=torch.bfloat16, generator=gen)
    vae, vae_encoder = VAEDecoder(VAE_CONFIG, generator=gen), VAEEncoder(VAE_CONFIG, generator=gen)
    port = {k: str(root / "port" / k) for k in ("transformer", "vae")}
    synthetic.write_sharded(port["transformer"], synthetic.diffusers_transformer_state(dit),
                            "diffusion_pytorch_model", dataclasses.asdict(TREE_DIT))
    synthetic.write_sharded(port["vae"], synthetic.autoencoder_state(vae, vae_encoder), "diffusion_pytorch_model",
                            dataclasses.asdict(VAE_CONFIG))
    shutil.copytree(root / "port", root / "jax", copy_function=shutil.copy2)
    lora = str(root / "style.safetensors")
    tst.save_file(bfl_lora(TREE_DIT, seed=3), lora, metadata={"alpha": "8"})
    return port, {k: v.replace(str(root / "port"), str(root / "jax")) for k, v in port.items()}, lora


def test_export_quantized_prints_jax_lines_and_writes_jax_bytes(trees, capsys):
    port, jax_dirs, lora = trees
    out = {}
    for name, main, tdir in (("port", tcli.main, port["transformer"]), ("jax", jcli.main, jax_dirs["transformer"])):
        argv = ["export-quantized", "--transformer-dir", tdir, "--quantization", "qint8", "--lora", f"{lora}:0.5"]
        main(argv + (["--device", "cpu"] if name == "port" else []))
        out[name] = [line.replace(tdir, "<T>") for line in capsys.readouterr().out.strip().splitlines()]
    assert out["port"] == out["jax"] and len(out["port"]) == 2
    assert out["port"][0] == f"baked LoRA {lora} (scale 1.000)"
    assert out["port"][1].startswith("exported qint8 checkpoint -> <T>/tpu-prequantized/qint8/transformer.safetensors (")
    files = [tck.prequantized_path(d["transformer"], "qint8") for d in (port, jax_dirs)]
    (pf, pm), (jf, jm) = (tst_flat(f) for f in files)
    assert pm == jm and pm["lora_baked"] == "1" and pm["source_fingerprint"]
    assert sorted(pf) == sorted(jf) and all(_bytes(pf[k]) == _bytes(jf[k]) for k in jf)


@pytest.mark.parametrize("fmt,flags", [("w8a8", []), ("qint8", ["--dequantize-runtime"]), ("qint8", [])],
                         ids=["w8a8", "qint8_dequantized", "qint8"])
def test_t2i_reads_the_prequantized_file_as_jax(trees, fmt, flags, capsys):
    """The port's build_pipeline reads the file and converts it as JAX's
    prequantized branch (``flux2_tpu/cli/main.py:115-131``): load_prequantized
    against the source, then w8a8_params or, under --dequantize-runtime,
    dequantize_params."""
    port, _, _ = trees
    path = tck.prequantized_path(port["transformer"], "qint8")
    if not os.path.exists(path):
        tcli.main(["export-quantized", "--transformer-dir", port["transformer"], "--quantization", "qint8",
                   "--device", "cpu"])
    argv = ["t2i", "--transformer-dir", port["transformer"], "--vae-dir", port["vae"], "--no-text-encoder",
            "--quantization", fmt, *flags, "--device", "cpu"]
    pipe = tcli.build_pipeline(tcli.parse_args(argv), "cpu")
    assert f"loaded prequantized qint8 transformer from {path}" in capsys.readouterr().err
    ref, _ = jck.load_prequantized(path, expected_source_dir=port["transformer"])
    if fmt == "w8a8":
        ref = jq.w8a8_params(ref)
    elif flags:
        ref = jq.dequantize_params(ref)
    _assert_same_model(pipe.transformer, transformer_from_jax(ref, TREE_DIT))
    kinds = {type(pipe.transformer.get_submodule(n)).__name__ for n in tq.quantized_names(pipe.transformer)}
    assert kinds == ({"W8A8Tensor"} if fmt == "w8a8" else set() if flags else {"QTensor"})
