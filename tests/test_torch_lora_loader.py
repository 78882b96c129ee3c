"""The port's LoRA loader (``flux2_tpu_torch/training/lora_loader.py``) and
its merges against JAX's (after JAX's ``tests/test_checkpoints.py`` LoRA
cases and ``tests/test_training.py::test_merge_into_params_quantized_base``).

The LoRA files are written here from seeds, in both key dialects, and fed to
both packages. Tolerances, each with its reason:
  - parsed pairs, alpha, scale, overrides, keyword: equal;
  - a merge into an f32 base: 1e-6 absolute (one f32 rank-r product and add
    per weight in both packages, perhaps summed in another order);
  - a merge into a bf16 base: elements whose bf16 rounding flips (the f32 sum
    an ulp apart at a tie) are counted: fewer than 1e-4 of the total, each one
    bf16 ulp; this run flips none;
  - a merge into a stored QTensor (qint8, int4): flipped codes counted the
    same way, each one quantization step, and the scales and biases equal; the
    port takes XLA's in-``jit`` arithmetic (the fused dequantize, the
    reciprocal of the level count), and this run flips none.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flux2_tpu.io import safetensors_io as jst
from flux2_tpu.models.flux2 import config as jcfg
from flux2_tpu.models.flux2 import transformer as jtfm
from flux2_tpu.ops import quant as jq
from flux2_tpu.training import lora_loader as jloader
from flux2_tpu_torch.io import safetensors_io as tst
from flux2_tpu_torch.io.jax_params import transformer_from_jax
from flux2_tpu_torch.models.flux2 import config as tcfg
from flux2_tpu_torch.models.flux2.config import Flux2TransformerConfig
from flux2_tpu_torch.ops import quant as tq
from flux2_tpu_torch.training import lora as tlora
from flux2_tpu_torch.training import lora_loader as tloader

from tests.test_torch_shared_copies import jax_config
from tests.test_torch_transformer import perturbed_numpy

CONFIG = Flux2TransformerConfig(num_layers=2, num_single_layers=2, num_attention_heads=2,
                                attention_head_dim=128, joint_attention_dim=96, guidance_embeds=False)
MERGE_ATOL = 1e-6
FLIP_SHARE = 1e-4

# BFL native double-block names and their port leaves (the fused qkv aside)
BFL_DOUBLE = {"img_attn.proj": "to_out", "txt_attn.proj": "add_out", "img_mlp.0": "ff_in", "img_mlp.2": "ff_out",
              "txt_mlp.0": "ff_ctx_in", "txt_mlp.2": "ff_ctx_out"}
DIFFUSERS_DOUBLE = {"to_q": "attn.to_q", "to_k": "attn.to_k", "to_v": "attn.to_v", "to_out": "attn.to_out.0",
                    "add_q": "attn.add_q_proj", "add_k": "attn.add_k_proj", "add_v": "attn.add_v_proj",
                    "add_out": "attn.to_add_out", "ff_in": "ff.linear_in", "ff_out": "ff.linear_out",
                    "ff_ctx_in": "ff_context.linear_in", "ff_ctx_out": "ff_context.linear_out"}


def bfl_lora(config=CONFIG, rank=4, seed=0, scale=0.05) -> dict:
    """A BFL-native LoRA on every default target of every block, torch's
    orientation (A [r, in], B [out, r]), f32."""
    rng = np.random.RandomState(seed)
    d, mlp = config.inner_dim, config.mlp_hidden_dim
    dims = {"to_out": (d, d), "add_out": (d, d), "ff_in": (d, 2 * mlp), "ff_out": (mlp, d),
            "ff_ctx_in": (d, 2 * mlp), "ff_ctx_out": (mlp, d)}

    def pair(key, d_in, d_out):
        w[f"{key}.lora_A.weight"] = (scale * rng.randn(rank, d_in)).astype(np.float32)
        w[f"{key}.lora_B.weight"] = (scale * rng.randn(d_out, rank)).astype(np.float32)

    w = {}
    for i in range(config.num_layers):
        pair(f"double_blocks.{i}.img_attn.qkv", d, 3 * d)
        pair(f"double_blocks.{i}.txt_attn.qkv", d, 3 * d)
        for name, leaf in BFL_DOUBLE.items():
            pair(f"double_blocks.{i}.{name}", *dims[leaf])
    for i in range(config.num_single_layers):
        pair(f"single_blocks.{i}.linear1", d, 3 * d + 2 * mlp)
        pair(f"single_blocks.{i}.linear2", d + mlp, d)
    return w


def diffusers_from_bfl(w: dict, config=CONFIG, peft: bool = False) -> dict:
    """The same adapters in the Diffusers dialect (``transformer.`` prefix;
    with ``peft``, ``base_model.model.`` and lora_down / lora_up): the fused
    qkv written as three pairs sharing A, linear1 / linear2 as the fused
    ``to_qkv_mlp_proj`` / ``to_out``."""
    d = config.inner_dim
    prefix, a_name, b_name = ("base_model.model.", "lora_down", "lora_up") if peft else ("transformer.", "lora_A",
                                                                                        "lora_B")
    out = {}

    def put(key, a, b):  # copies: a file holds each tensor once
        out[f"{prefix}{key}.{a_name}.weight"] = a.copy()
        out[f"{prefix}{key}.{b_name}.weight"] = np.ascontiguousarray(b)

    for i in range(config.num_layers):
        for fused, leaves in (("img_attn.qkv", ("to_q", "to_k", "to_v")), ("txt_attn.qkv", ("add_q", "add_k", "add_v"))):
            a, b = w[f"double_blocks.{i}.{fused}.lora_A.weight"], w[f"double_blocks.{i}.{fused}.lora_B.weight"]
            for j, leaf in enumerate(leaves):
                put(f"transformer_blocks.{i}.{DIFFUSERS_DOUBLE[leaf]}", a, b[j * d:(j + 1) * d])
        for name, leaf in BFL_DOUBLE.items():
            put(f"transformer_blocks.{i}.{DIFFUSERS_DOUBLE[leaf]}", w[f"double_blocks.{i}.{name}.lora_A.weight"],
                w[f"double_blocks.{i}.{name}.lora_B.weight"])
    for i in range(config.num_single_layers):
        for bfl, diff in (("linear1", "attn.to_qkv_mlp_proj"), ("linear2", "attn.to_out")):
            put(f"single_transformer_blocks.{i}.{diff}", w[f"single_blocks.{i}.{bfl}.lora_A.weight"],
                w[f"single_blocks.{i}.{bfl}.lora_B.weight"])
    return out


def partial_lora(rank=4, seed=0) -> dict:
    """JAX's ``_fake_diffusers_lora``: double block 0's to_q and single block
    1's fused projection only."""
    d, mlp = CONFIG.inner_dim, CONFIG.mlp_hidden_dim
    rng = np.random.RandomState(seed)
    return {
        "transformer.transformer_blocks.0.attn.to_q.lora_A.weight": rng.randn(rank, d).astype(np.float32),
        "transformer.transformer_blocks.0.attn.to_q.lora_B.weight": rng.randn(d, rank).astype(np.float32),
        "transformer.single_transformer_blocks.1.attn.to_qkv_mlp_proj.lora_A.weight":
            rng.randn(rank, d).astype(np.float32),
        "transformer.single_transformer_blocks.1.attn.to_qkv_mlp_proj.lora_B.weight":
            rng.randn(3 * d + 2 * mlp, rank).astype(np.float32),
    }


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """torch on one thread for the module: these tests run many tiny ops, and
    beside five other busy workers torch's default pool (a thread a core)
    oversubscribes the host: on 8 cores the runtime tests took 166 s against
    14 s on one thread. The other LoRA / prequantized test files import it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def jax_params():
    return perturbed_numpy(jtfm.init_params(jax.random.PRNGKey(0), jax_config(CONFIG), dtype=jnp.float32), 0)


def _assert_pairs_equal(port: dict, ref: dict) -> None:
    assert (port["rank"], port["target_layers"]) == (ref["rank"], ref["target_layers"])
    assert list(port["pairs"]) == list(ref["pairs"])
    for key, layers in ref["pairs"].items():
        assert sorted(port["pairs"][key]) == sorted(layers), key
        for idx, (a, b) in layers.items():
            pa, pb = port["pairs"][key][idx]
            assert np.array_equal(pa.numpy(), a) and np.array_equal(pb.numpy(), b), (key, idx)


@pytest.mark.parametrize("dialect", ["bfl", "diffusers", "peft", "partial"])
def test_parsed_pairs_equal_jax(dialect):
    assert tloader._DIFFUSERS_LEAF == jloader._DIFFUSERS_LEAF
    w = {"bfl": bfl_lora(), "partial": partial_lora()}.get(dialect) or diffusers_from_bfl(bfl_lora(),
                                                                                          peft=dialect == "peft")
    _assert_pairs_equal(tloader.parse_lora_weights(w, CONFIG), jloader.parse_lora_weights(w, jax_config(CONFIG)))


def test_bfl_split_follows_jax_qkv_split():
    """JAX's ``test_lora_bfl_qkv_split``: A shared, B split three ways."""
    d = CONFIG.inner_dim
    rng = np.random.RandomState(1)
    w = {"double_blocks.0.img_attn.qkv.lora_A.weight": rng.randn(4, d).astype(np.float32),
         "double_blocks.0.img_attn.qkv.lora_B.weight": rng.randn(3 * d, 4).astype(np.float32)}
    pairs = tloader.parse_lora_weights(w, CONFIG)["pairs"]
    assert set(pairs) == {("double_blocks", leaf) for leaf in ("to_q", "to_k", "to_v")}
    a_q, b_q = pairs[("double_blocks", "to_q")][0]
    np.testing.assert_array_equal(a_q.numpy(), w["double_blocks.0.img_attn.qkv.lora_A.weight"].T)
    np.testing.assert_array_equal(b_q.numpy(), w["double_blocks.0.img_attn.qkv.lora_B.weight"][:d].T)


@pytest.mark.parametrize("source", ["metadata", "lora_alpha", "rank", "sidecar", "config_path"])
def test_load_lora_file_equals_jax(source, tmp_path):
    w = partial_lora()
    path = str(tmp_path / "style.safetensors")
    meta = {"metadata": {"alpha": "8", "trigger": "TRIG"}, "lora_alpha": {"lora_alpha": "2"}}.get(source, {})
    jst.save_file(w, path, metadata=meta or None)
    sidecar = {"alpha": 16, "activation_keyword": "TURBOSTYLE",
               "scheduler": {"custom_sigmas": [1.0, 0.5], "num_steps": 2, "guidance": 1.0}}
    config_path = None
    if source == "sidecar":
        with open(tmp_path / "style.json", "w") as f:
            json.dump(sidecar, f)
    if source == "config_path":
        config_path = str(tmp_path / "elsewhere.json")
        with open(config_path, "w") as f:
            json.dump({"num_steps": 3, "guidance": 2.5}, f)  # no "scheduler" block: the top level is read
    port = tloader.load_lora_file(path, CONFIG, user_scale=0.8, config_path=config_path)
    ref = jloader.load_lora_file(path, jax_config(CONFIG), user_scale=0.8, config_path=config_path)
    for field in ("rank", "alpha", "scale", "target_layers", "activation_keyword"):
        assert getattr(port, field) == getattr(ref, field), field
    assert vars(port.overrides) == vars(ref.overrides)
    _assert_pairs_equal({"pairs": port.pairs, "rank": port.rank, "target_layers": port.target_layers},
                        {"pairs": ref.pairs, "rank": ref.rank, "target_layers": ref.target_layers})
    for prompt in ("a cat", "turbostyle cat", "TRIG on a mat", ""):
        assert port.apply_prompt_prefix(prompt) == ref.apply_prompt_prefix(prompt)
    if source == "sidecar":
        assert port.overrides.num_steps == 2 and port.scale == pytest.approx(16 / 4 * 0.8)


def test_detect_target_model_equals_jax():
    candidates = [("tiny", CONFIG), ("klein-4b", tcfg.KLEIN_4B)]
    jcandidates = [("tiny", jax_config(CONFIG)), ("klein-4b", jcfg.KLEIN_4B)]
    cfg = dataclasses.replace(CONFIG, num_layers=3)  # parses each of them
    for w in (partial_lora(), bfl_lora(), bfl_lora(cfg, seed=2)):
        port = tloader.detect_target_model(tloader.parse_lora_weights(w, cfg)["pairs"], candidates)
        ref = jloader.detect_target_model(jloader.parse_lora_weights(w, jax_config(cfg))["pairs"], jcandidates)
        assert port == ref
    assert port == "klein-4b"  # three double blocks exceed the tiny config's two


@pytest.mark.parametrize("warn", [True, False])
def test_merge_runtime_semantics_equals_jax(warn):
    def loaded(pkg, steps, guidance, keyword):
        return pkg.LoadedLoRA(pairs={}, rank=4, alpha=4, scale=1.0, target_layers=1,
                              overrides=pkg.LoRASchedulerOverrides(num_steps=steps, guidance=guidance),
                              activation_keyword=keyword)

    specs = [(2, 1.0, "STYLE_A"), (8 if warn else 2, None, "STYLE_A"), (None, None, "STYLE_B")]
    port = tloader.merge_runtime_semantics([loaded(tloader, *s) for s in specs])
    ref = jloader.merge_runtime_semantics([loaded(jloader, *s) for s in specs])
    assert vars(port[0]) == vars(ref[0]) and port[1:] == ref[1:]
    assert port[2] == (["multiple LoRAs override num_steps (2 -> 8); using the last"] if warn else [])


def _merged_jax(params, w, path, fmt=None):
    jst.save_file(w, path, metadata={"alpha": "8"})
    loaded = jloader.load_lora_file(path, jax_config(CONFIG))
    if fmt:
        params = jq.quantize_params(params, fmt)
    return params, jloader.merge_loras_into_params(params, [loaded], jax_config(CONFIG))


def _merged_port(jax_tree, path):
    model = transformer_from_jax(jax.tree_util.tree_map(np.asarray, jax_tree), CONFIG)
    return tloader.merge_loras_into_params(model, [tloader.load_lora_file(path, CONFIG)], CONFIG)


def _leaf(model, group, leaf, i):
    return getattr(getattr(model, group)[i], leaf)


def test_merge_into_f32_base_matches_jax(jax_params, tmp_path):
    _, merged = _merged_jax(jax_params, bfl_lora(), str(tmp_path / "l.safetensors"))
    model = _merged_port(jax_params, str(tmp_path / "l.safetensors"))
    for group, n in (("double_blocks", CONFIG.num_layers), ("single_blocks", CONFIG.num_single_layers)):
        for leaf in merged[group]:
            for i in range(n):
                want = np.asarray(merged[group][leaf])[i]
                got = _leaf(model, group, leaf, i).detach().numpy()
                np.testing.assert_allclose(got, want.T if want.ndim == 2 else want, atol=MERGE_ATOL, rtol=0)


def test_merge_into_bf16_base_flips_under_1e4_of_elements_by_one_ulp(jax_params, tmp_path):
    bf16 = jax.tree_util.tree_map(lambda x: jnp.asarray(x).astype(jnp.bfloat16), jax_params)
    _, merged = _merged_jax(bf16, bfl_lora(), str(tmp_path / "l.safetensors"))
    model = _merged_port(bf16, str(tmp_path / "l.safetensors"))
    total = flipped = 0
    for (group, leaf) in tlora.DEFAULT_TARGETS:
        for i in range(2):
            want = np.asarray(merged[group][leaf][i].astype(jnp.float32)).T
            got = _leaf(model, group, leaf, i).float().numpy()
            diff = got != want
            total, flipped = total + diff.size, flipped + int(diff.sum())
            ulp = np.abs(want) * 2.0**-7  # a bf16 ulp is at most 2^-7 of the value
            assert np.all(np.abs(got - want)[diff] <= ulp[diff])
    assert flipped <= FLIP_SHARE * total, (flipped, total)  # 0 flips of 5111808 in this run


@pytest.mark.parametrize("fmt", ["qint8", "int4"])
def test_merge_into_qtensor_matches_jax(jax_params, fmt, tmp_path):
    bf16 = jax.tree_util.tree_map(lambda x: jnp.asarray(x).astype(jnp.bfloat16), jax_params)
    qparams, merged = _merged_jax(bf16, bfl_lora(), str(tmp_path / "l.safetensors"), fmt)
    model = _merged_port(qparams, str(tmp_path / "l.safetensors"))
    total = flipped = 0
    for (group, leaf) in tlora.DEFAULT_TARGETS:
        ref = merged[group][leaf]
        assert isinstance(ref, jq.QTensor) and ref.format == fmt
        for i in range(2):
            w = _leaf(model, group, leaf, i)
            assert isinstance(w, tq.QTensor) and (w.format, w.group_size) == (fmt, ref.group_size)
            jcodes = torch.from_numpy(np.ascontiguousarray(np.asarray(ref.q[i]).T))
            codes = [tq._unpack_nibbles(c, w.orig_in) if fmt == "int4" else c for c in (w.q, jcodes)]
            np.testing.assert_array_equal(w.scale.numpy(), np.asarray(ref.scale[i]).T)
            np.testing.assert_array_equal(w.bias.numpy(), np.asarray(ref.bias[i]).T)
            diff = (codes[0].int() - codes[1].int()).abs().numpy()
            assert diff.max() <= 1
            total, flipped = total + diff.size, flipped + int((diff > 0).sum())
    assert flipped <= FLIP_SHARE * total, (flipped, total)  # 0 flipped codes in this run, both formats


def test_merge_changes_only_targeted_layers(jax_params, tmp_path):
    """JAX's ``test_lora_merge_changes_only_targeted_layers`` on the port."""
    path = str(tmp_path / "lora.safetensors")
    tst.save_file(partial_lora(), path, metadata={"alpha": "8"})
    loaded = tloader.load_lora_file(path, CONFIG)
    assert loaded.alpha == 8.0 and loaded.scale == pytest.approx(8.0 / 4.0)
    base = transformer_from_jax(jax_params, CONFIG)
    merged = tloader.merge_loras_into_params(transformer_from_jax(jax_params, CONFIG), [loaded], CONFIG)
    d0 = (_leaf(merged, "double_blocks", "to_q", 0) - _leaf(base, "double_blocks", "to_q", 0)).abs().max()
    assert float(d0) > 1e-3
    assert torch.equal(_leaf(merged, "double_blocks", "to_q", 1), _leaf(base, "double_blocks", "to_q", 1))
    assert torch.equal(_leaf(merged, "double_blocks", "to_k", 0), _leaf(base, "double_blocks", "to_k", 0))
    lora = tloader.to_stacked_lora(loaded, CONFIG)
    assert not lora.single_blocks[0]["to_q"].b.any() and lora.single_blocks[1]["to_q"].b.any()


@pytest.mark.parametrize("fmt", ["bf16", "qint8"])
def test_bfl_and_diffusers_files_merge_to_the_same_weights(jax_params, fmt, tmp_path):
    w = bfl_lora(seed=4)
    models = []
    for name, weights in (("bfl", w), ("diffusers", diffusers_from_bfl(w))):
        path = str(tmp_path / f"{name}.safetensors")
        tst.save_file(weights, path)
        model = transformer_from_jax(jax.tree_util.tree_map(lambda x: np.asarray(x).astype(jnp.bfloat16),
                                                            jax_params), CONFIG)
        tq.quantize_params(model, fmt)
        models.append(tloader.merge_loras_into_params(model, [tloader.load_lora_file(path, CONFIG, 0.8)], CONFIG))
    a, b = (dict(m.named_buffers()) | dict(m.named_parameters()) for m in models)
    assert sorted(a) == sorted(b) and all(torch.equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("fmt", ["w8a8", "w4a8"])
def test_runtime_format_merge_raises_jax_type_error(jax_params, fmt, tmp_path):
    """A LoRA on a runtime-format weight raises JAX's TypeError, naming the
    leaf and its type, before anything is merged."""
    path = str(tmp_path / "l.safetensors")
    jst.save_file(partial_lora(), path)  # its first pair is double block 0's to_q
    convert = {"w8a8": (jq.to_w8a8, tq.to_w8a8), "w4a8": (jq.to_w4a8, tq.to_w4a8)}[fmt]
    jparams = dict(jax_params, double_blocks=dict(jax_params["double_blocks"],
                                                  to_q=convert[0](jnp.zeros((2, 512, 256), jnp.bfloat16))))
    with pytest.raises(TypeError) as ref:
        jloader.merge_loras_into_params(jparams, [jloader.load_lora_file(path, jax_config(CONFIG))], jax_config(CONFIG))
    model = transformer_from_jax(jax_params, CONFIG)
    for blk in model.double_blocks:
        tq._replace(blk, "to_q", convert[1](torch.zeros(256, 512, dtype=torch.bfloat16)))
    before = model.double_blocks[0].to_q
    with pytest.raises(TypeError) as port:
        tloader.merge_loras_into_params(model, [tloader.load_lora_file(path, CONFIG)], CONFIG)
    assert str(port.value) == str(ref.value)
    assert f"leaf double_blocks/to_q ({'W8A8' if fmt == 'w8a8' else 'W4A8'}Tensor)" in str(port.value)
    assert model.double_blocks[0].to_q is before
