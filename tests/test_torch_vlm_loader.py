"""The VLMs from disk, through both packages' facades and the CLI, on the CPU.

Hand-written tiny checkpoints in HF layout (``utils/synthetic.py``'s writers and
the parity tests' numpy draws, f32 safetensors): a Qwen3.5-VL
(``model.language_model.*`` qwen3_next names, ``model.visual.*``, a
``config.json`` with ``text_config`` / ``vision_config``, a vocabulary-wide
byte-level tokenizer) and a Mistral3 VLM (``language_model.*``,
``vision_tower.*``, ``multi_modal_projector.*``, the goldens' ``tekken.json``).
Both facades load them to the same bf16 parameters, leaf for leaf; the
Mistral VLM reuses the loaded LM, quantized or not; ``detect_vlm_family``,
the replacement of a resident VLM of the other family, the errors without a
VLM and the CLI's lazy loader are JAX's. ``_vlm_scorer`` consults the
pipeline's loader (JAX's, a repair), so ``evaluate-lora`` and
``train-lora``'s ``vlm_scoring`` score through the tiny Qwen3.5 VLM.
"""

import dataclasses
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flux2_tpu.cli import main as jcli
from flux2_tpu.models.text_encoders import facade as jfacade
from flux2_tpu_torch.cli import main as tcli
from flux2_tpu_torch.io import registry
from flux2_tpu_torch.io.jax_params import decoder_from_jax, pixtral_from_jax, qwen35_from_jax, qwen35_vision_from_jax
from flux2_tpu_torch.models.text_encoders import facade
from flux2_tpu_torch.models.text_encoders.config import TINY_DECODER
from flux2_tpu_torch.models.text_encoders.pixtral import PixtralVisionConfig
from flux2_tpu_torch.models.text_encoders.qwen35 import TINY_QWEN35
from flux2_tpu_torch.models.text_encoders.qwen35_vision import Qwen35VisionConfig
from flux2_tpu_torch.models.text_encoders.vlm_service import MistralVLMService, Qwen35VLMService
from flux2_tpu_torch.utils import synthetic

from tests.test_torch_checkpoints import write_checkpoint
from tests.test_torch_dev import GOLDENS, TINY_MISTRAL, _mistral_checkpoint
from tests.test_torch_lora_loader import one_torch_thread  # noqa: F401  (module fixture)
from tests.test_torch_pixtral import mistral3_vision_checkpoint
from tests.test_torch_shared_copies import jax_config
from tests.test_torch_transformer import perturbed_numpy

VL_TEXT = dataclasses.replace(TINY_QWEN35, vocab_size=600)
VL_VISION = Qwen35VisionConfig(depth=1, hidden_size=32, num_heads=2, intermediate_size=64, num_position_embeddings=16,
                               out_hidden_size=VL_TEXT.hidden_size)
# a Klein-recipe encoder for the tiny DiT (joint 96 = 3 x 32: layers 9, 18, 27 of 28)
KLEIN_ENCODER = dataclasses.replace(TINY_DECODER, hidden_size=32, num_hidden_layers=28, vocab_size=600)
PIXTRAL = PixtralVisionConfig(hidden_size=32, intermediate_size=64, num_hidden_layers=1, num_attention_heads=2,
                              image_size=14 * 8, text_hidden_size=TINY_MISTRAL.hidden_size)


def write_tiny_qwen35_vl(path) -> str:
    """The tiny Qwen3.5-VL checkpoint directory (f32 files), its tokenizer covering the 600 ids."""
    synthetic.write_qwen35_vl_checkpoint(str(path), VL_TEXT, VL_VISION, torch.Generator().manual_seed(21),
                                         synthetic.vocab_tokenizer(VL_TEXT.vocab_size), dtype=torch.float32)
    return str(path)


@pytest.fixture(scope="module")
def vl_dir(tmp_path_factory):
    return write_tiny_qwen35_vl(tmp_path_factory.mktemp("qwen35vl"))


@pytest.fixture(scope="module")
def mistral_vl_dir(tmp_path_factory):
    import jax.random

    from flux2_tpu.models.text_encoders import decoder as jdec

    path = tmp_path_factory.mktemp("mistral_vl")
    lm = perturbed_numpy(jdec.init_params(jax.random.PRNGKey(9), jax_config(TINY_MISTRAL), dtype=jnp.float32), 9)
    weights = {**_mistral_checkpoint(lm, TINY_MISTRAL, nested=False), **mistral3_vision_checkpoint(PIXTRAL, 4)}
    text_config = {k: v for k, v in dataclasses.asdict(TINY_MISTRAL).items()
                   if k not in ("qk_norm", "llama4_scaling_beta")}
    vision_config = {k: getattr(PIXTRAL, k) for k in ("hidden_size", "intermediate_size", "num_hidden_layers",
                                                      "num_attention_heads", "patch_size", "image_size")}
    write_checkpoint(path, weights, torch.float32, config={"model_type": "mistral3", "text_config": text_config,
                                                           "vision_config": vision_config, "image_token_index": 10,
                                                           "spatial_merge_size": 2})
    shutil.copy(os.path.join(GOLDENS, "tekken_fixture.json"), path / "tekken.json")
    return str(path)


def _equal_modules(got, want) -> None:
    want = dict(want.named_parameters())
    assert dict(got.named_parameters()).keys() == want.keys()
    for name, p in got.named_parameters():
        assert p.dtype == want[name].dtype == torch.bfloat16 and torch.equal(p, want[name]), name


def test_load_qwen35_vlm_through_both_facades_equal(vl_dir):
    ref = jfacade.TextEncoders().load_qwen35_vlm(vl_dir)
    reg = facade.TextEncoders()
    svc = reg.load_qwen35_vlm(vl_dir, device="cpu")
    assert isinstance(svc, Qwen35VLMService) and reg.is_vlm_loaded and reg.load_qwen35_vlm(vl_dir) is svc
    assert dataclasses.asdict(svc.lm_config) == dataclasses.asdict(ref.lm_config)
    assert dataclasses.asdict(svc.vision_config) == dataclasses.asdict(ref.vision_config)
    assert svc.vision_config.image_token_id == 248056
    _equal_modules(svc.lm, qwen35_from_jax(ref.lm_params, VL_TEXT))
    _equal_modules(svc.vision, qwen35_vision_from_jax(ref.vision_params, VL_VISION))
    messages = [{"role": "system", "content": "s"}, {"role": "user", "content": "look"}]
    assert svc.tokenizer.apply_chat_template(messages, add_generation_prompt=True) == list(
        ref.tokenizer.apply_chat_template(messages, add_generation_prompt=True))
    reg.unload_vlm()
    assert not reg.is_vlm_loaded


# Two periods of the hybrid stack: layers 4-7 run after the first full-attention layer, whose f32 KV cache
# makes the residual stream f32 (JAX's promotion, kept by the port).
BF16_TEXT = dataclasses.replace(VL_TEXT, num_hidden_layers=8)
# The bf16 loads, port against JAX, relative L2 of the worst logits row. Both run bf16 weights with f32 caches
# and differ only in where the CPU rounds to bf16 (torch after each op, XLA after each fusion); this random
# model amplifies such roundings. The cached rows (prefill + 3 steps, XLA-compiled): 0.052 measured. The full
# forward is held to twice JAX's own spread, its eager forward against its compiled one (0.238 worst row on
# this draw, against the port's 0.259). What values this noisy cannot see, the per-layer dtype flow checks.
BF16_CACHED_TOL = 0.1


def test_bf16_qwen35_vlm_dtype_flow_and_logits_equal_jax(tmp_path, monkeypatch):
    """Both facades' bf16 loads (JAX's ``_bf16`` in place) of an 8-layer
    Qwen3.5-VL, the same merged image + text embeddings: every layer of the
    cached prefill and of 3 decode steps takes and returns JAX's dtypes and
    leaves JAX's cache dtypes; the cached logits are JAX's within
    BF16_CACHED_TOL and ``forward_logits`` within twice JAX's own eager
    against compiled spread; and, as on the card, the random model's bf16
    forward is as far from its f32 one in JAX as in the port."""
    import copy

    from flux2_tpu.models.text_encoders import qwen35 as jq
    from flux2_tpu_torch.models.text_encoders import qwen35 as tq

    path = str(tmp_path / "vl8")
    synthetic.write_qwen35_vl_checkpoint(path, BF16_TEXT, VL_VISION, torch.Generator().manual_seed(23),
                                         synthetic.vocab_tokenizer(BF16_TEXT.vocab_size), dtype=torch.float32)
    ref = jfacade.TextEncoders().load_qwen35_vlm(path)
    svc = facade.TextEncoders().load_qwen35_vlm(path, device="cpu")
    cfg = ref.lm_config
    ids, merged = svc._merged_inputs(list(range(5, 17)), np.random.RandomState(3).rand(64, 64, 3).astype(np.float32))
    jids, jmerged = jnp.asarray(ids.numpy()), jnp.asarray(merged.float().numpy()).astype(jnp.bfloat16)
    p, steps = ids.shape[1], 3
    extra = np.random.RandomState(4).randint(0, cfg.vocab_size, (1, steps))

    flows = {"jax": [], "port": []}

    def dtypes(*xs):
        return tuple(str(x.dtype).replace("torch.", "") for x in xs)

    real_delta, real_full = jq.gated_deltanet_forward, jq._full_attention_cached

    def j_delta(lp, c, h, conv_state=None, rec_state=None):
        out = real_delta(lp, c, h, conv_state=conv_state, rec_state=rec_state)
        flows["jax"].append(("delta",) + dtypes(h, *out))
        return out

    def j_full(lp, c, h, position_ids, layer_cache):
        attn, lc = real_full(lp, c, h, position_ids, layer_cache)
        flows["jax"].append(("full",) + dtypes(h, attn, lc["k"], lc["v"]))
        return attn, lc
    monkeypatch.setattr(jq, "gated_deltanet_forward", j_delta)
    monkeypatch.setattr(jq, "_full_attention_cached", j_full)
    t_delta, t_full = tq.GatedDeltaNet.forward, tq.GatedAttention.forward_cached

    def p_delta(self, x, conv_state=None, rec_state=None):
        out = t_delta(self, x, conv_state=conv_state, rec_state=rec_state)
        flows["port"].append(("delta",) + dtypes(x, *out))
        return out

    def p_full(self, x, position_ids, layer_cache):
        attn = t_full(self, x, position_ids, layer_cache)
        flows["port"].append(("full",) + dtypes(x, attn, layer_cache["k"], layer_cache["v"]))
        return attn
    monkeypatch.setattr(tq.GatedDeltaNet, "forward", p_delta)
    monkeypatch.setattr(tq.GatedAttention, "forward_cached", p_full)

    prefill = jax.jit(lambda pp, i, c, e: jq.forward_cached(pp, cfg, i, c, jnp.int32(0), inputs_embeds=e))
    step = jax.jit(lambda pp, i, c, pos: jq.forward_cached(pp, cfg, i, c, pos))

    def jax_rows(params, embeds):
        cache = jq.init_hybrid_cache(cfg, 1, p + steps)
        lg, cache = prefill(params, jids, cache, embeds)
        rows = [lg]
        for i in range(steps):
            lg, cache = step(params, jnp.asarray(extra[:, i:i + 1]), cache, jnp.int32(p + i))
            rows.append(lg)
        return np.stack([np.asarray(r, np.float32)[0] for r in rows]), cache

    def port_rows(lm):
        cache = tq.init_hybrid_cache(cfg, 1, p + steps)
        with torch.inference_mode():
            rows = [lm.forward_cached(ids, cache, 0, inputs_embeds=merged.to(lm.embed_tokens.dtype))[0]]
            rows += [lm.forward_cached(torch.from_numpy(extra[:, i:i + 1]), cache, p + i)[0] for i in range(steps)]
        return torch.cat(rows).float().numpy(), cache

    jrows, jcache = jax_rows(ref.lm_params, jmerged)
    trows, tcache = port_rows(svc.lm)
    # the prefill's layers (traced once), then each step's: JAX traces the step once
    n = cfg.num_hidden_layers
    assert flows["port"][:2 * n] == flows["jax"] and len(flows["port"]) == (1 + steps) * n
    assert flows["port"][2 * n:] == flows["port"][n:2 * n] * (steps - 1)
    assert [f[1] for f in flows["port"][:n]] == ["bfloat16"] * 4 + ["float32"] * 4  # the promotion at layer 3
    assert [dtypes(*(v for k, v in sorted(c.items()) if k != "len")) for c in tcache] == \
        [dtypes(*(v for k, v in sorted(c.items()) if k != "len")) for c in jcache]
    monkeypatch.undo()

    def rel(a, b):
        return max(float(np.linalg.norm(a[i] - b[i]) / np.linalg.norm(b[i])) for i in range(len(b)))
    assert np.isfinite(jrows).all() and rel(trows, jrows) <= BF16_CACHED_TOL
    all_ids = np.concatenate([ids.numpy(), extra], 1)

    def jax_forward(params, embeds, jit=True):
        e = jnp.concatenate([embeds, params["embed_tokens"][jnp.asarray(extra)]], 1)
        fn = lambda pp, i, x: jq.forward_logits(pp, cfg, i, inputs_embeds=x)  # noqa: E731
        return np.asarray((jax.jit(fn) if jit else fn)(params, jnp.asarray(all_ids), e), np.float32)[0]

    def port_forward(lm):
        with torch.inference_mode():
            e = torch.cat([merged.to(lm.embed_tokens.dtype), lm.embed_tokens[torch.from_numpy(extra)]], 1)
            return lm.forward_logits(torch.from_numpy(all_ids), inputs_embeds=e)[0].float().numpy()
    jfull, tfull = jax_forward(ref.lm_params, jmerged), port_forward(svc.lm)
    spread = rel(jax_forward(ref.lm_params, jmerged, jit=False), jfull)
    assert np.isfinite(jfull).all() and rel(tfull, jfull) <= 2 * spread, (rel(tfull, jfull), spread)
    jp32 = jax.tree_util.tree_map(lambda x: x.astype(jnp.float32) if jnp.issubdtype(x.dtype, jnp.floating) else x,
                                  ref.lm_params)
    jgap = rel(jfull, jax_forward(jp32, jmerged.astype(jnp.float32)))
    pgap = rel(tfull, port_forward(copy.deepcopy(svc.lm).float()))
    assert jgap > BF16_CACHED_TOL and pgap > BF16_CACHED_TOL and 0.5 < pgap / jgap < 2.0, (jgap, pgap)


def test_load_mistral_vlm_through_both_facades_equal(mistral_vl_dir):
    ref = jfacade.TextEncoders().load_mistral_vlm(mistral_vl_dir)
    reg = facade.TextEncoders()
    svc = reg.load_mistral_vlm(mistral_vl_dir, device="cpu")
    assert isinstance(svc, MistralVLMService) and svc.image_token_id == ref.image_token_id == 10
    assert svc.vision_config == PixtralVisionConfig(**ref.vision_config.__dict__)
    assert svc.decoder is reg.get("mistral").decoder  # the LM loaded once, shared with the encoder
    _equal_modules(svc.vision, pixtral_from_jax(ref.vision_params, PIXTRAL))
    _equal_modules(svc.decoder, decoder_from_jax(ref.lm_params, TINY_MISTRAL))


def test_load_mistral_vlm_reuses_a_quantized_lm(mistral_vl_dir, monkeypatch):
    """An encoder loaded with --encoder-quantization w8a8 is the VLM's LM (its
    layers quantized as the loader fills them; the tiny ones pass min_size=0
    to be)."""
    from flux2_tpu_torch.io import weight_mapping
    from flux2_tpu_torch.models.text_encoders.generation import GenerateParameters
    from flux2_tpu_torch.ops import quant

    monkeypatch.setattr(weight_mapping, "quantize_params",
                        lambda module, fmt, prefix=None: quant.quantize_params(module, fmt, min_size=0, prefix=prefix))
    reg = facade.TextEncoders()
    enc = reg.load_mistral(mistral_vl_dir, quantization="w8a8", device="cpu")
    svc = reg.load_mistral_vlm(mistral_vl_dir, device="cpu")
    assert svc.decoder is enc.decoder and set(quant.quantized_names(svc.decoder).values()) == {"w8a8"}
    image = np.random.RandomState(0).rand(56, 28, 3).astype(np.float32)
    reply = svc.analyze_image(image, "describe", gen_params=GenerateParameters(max_tokens=3, temperature=0.0))
    assert isinstance(reply, str) and quant.quantize_params is not weight_mapping.quantize_params


@pytest.mark.parametrize("config", [None, {}, {"vision_config": {}}, {"vision_config": {}, "model_type": "qwen3_vl"},
                                    {"vision_config": {}, "text_config": {"model_type": "Qwen3_Next"}},
                                    {"vision_config": {}, "model_type": "mistral3"}])
def test_detect_vlm_family_equals_jax(config, tmp_path):
    if config is not None:
        (tmp_path / "config.json").write_text(json.dumps(config))
    assert facade.detect_vlm_family(str(tmp_path)) == jfacade.detect_vlm_family(str(tmp_path))


def test_load_qwen35_vlm_replaces_a_vlm_of_the_other_family(tmp_path, capsys):
    """A resident non-Qwen3.5 VLM is not handed back: the loader goes on (and
    here fails on the missing directory), as JAX's."""
    reg = facade.TextEncoders()
    reg.attach_vlm(object())
    with pytest.raises((FileNotFoundError, OSError)):
        reg.load_qwen35_vlm(str(tmp_path / "nope"), device="cpu")
    assert "replacing the loaded non-Qwen3.5 VLM" in capsys.readouterr().err
    (tmp_path / "config.json").write_text("{}")
    for registry_ in (reg, jfacade.TextEncoders()):
        with pytest.raises(ValueError, match="has no vision_config"):
            registry_.load_qwen35_vlm(str(tmp_path))


def test_facade_errors_without_a_vlm_equal_jax():
    messages = []
    for reg in (facade.TextEncoders(), jfacade.TextEncoders()):
        for call in (lambda: reg.analyze_image(np.zeros((28, 28, 3)), "x"),
                     lambda: reg.compare_images_for_flux(np.zeros((8, 8, 3)), np.zeros((8, 8, 3)))):
            with pytest.raises(ValueError) as err:
                call()
            messages.append(str(err.value))
        reg.attach_vlm(type("Mistral", (), {"analyze_image": None})())
        with pytest.raises(ValueError) as err:
            reg.compare_images_for_flux(None, None)
        messages.append(str(err.value))
    assert messages[:3] == messages[3:]


class _Pipe:
    def __init__(self, loader=None, service=None):
        self.vlm_loader, self.vlm_service = loader, service


def _exits():
    raise SystemExit("no VLM on disk")


class _Scorer:
    def score_validation_image(self, image, refs, prompt):
        return 1.0, 2.0


@pytest.mark.parametrize("case", ["loader", "loader_exits", "service_wins", "no_scorer", "nothing"])
def test_vlm_scorer_consults_the_loader_as_jax(case):
    """Repair: the port's _vlm_scorer ignored ``vlm_loader``; JAX's (and now
    the port's) loads the VLM through it, and a loader that exits gives None."""
    svc = _Scorer()
    pipe = {"loader": _Pipe(loader=lambda: svc), "loader_exits": _Pipe(loader=_exits),
            "service_wins": _Pipe(loader=_exits, service=svc), "no_scorer": _Pipe(loader=lambda: object()),
            "nothing": _Pipe()}[case]
    port, ref = tcli._vlm_scorer(pipe), jcli._vlm_scorer(pipe)
    assert port == ref
    assert (port is not None) == (case in ("loader", "service_wins"))


def test_vlm_loader_prefers_the_qwen35_checkpoint(vl_dir, mistral_vl_dir, tmp_path, monkeypatch, capsys):
    """The registry's qwen35-vlm path first, then the Mistral hint, then JAX's SystemExit."""
    models = tmp_path / "models"
    monkeypatch.setenv("FLUX2_MODELS_DIR", str(models))
    monkeypatch.setenv("HF_HOME", str(tmp_path / "hf"))
    monkeypatch.setattr(facade, "shared", facade.TextEncoders())
    with pytest.raises(SystemExit) as port_exit:
        tcli._make_vlm_loader(None, "cpu")()
    with pytest.raises(SystemExit) as jax_exit:
        jcli._make_vlm_loader(None)()
    assert str(port_exit.value) == str(jax_exit.value)
    assert isinstance(tcli._make_vlm_loader(mistral_vl_dir, "cpu")(), MistralVLMService)
    facade.shared.unload_vlm()
    shutil.copytree(vl_dir, registry.local_model_path(registry.TEXT_ENCODER_REPOS["qwen35-vlm"]))
    assert isinstance(tcli._make_vlm_loader(mistral_vl_dir, "cpu")(), Qwen35VLMService)


def test_attach_text_encoder_sets_the_lazy_vlm_loader(vl_dir, tmp_path, monkeypatch):
    """The checkpoint branch's encoder attach gives the pipeline JAX's loader."""
    from flux2_tpu_torch.models.flux2.config import Flux2Model

    monkeypatch.setenv("FLUX2_MODELS_DIR", str(tmp_path))
    monkeypatch.setattr(facade, "shared", facade.TextEncoders())
    shutil.copytree(vl_dir, registry.local_model_path(registry.TEXT_ENCODER_REPOS["qwen35-vlm"]))
    loaded = facade.LoadedEncoder("qwen3-4b", None, TINY_MISTRAL, None, None)
    monkeypatch.setattr(facade, "load_qwen3", lambda *a, **k: loaded)
    monkeypatch.setattr(tcli, "_log_load", lambda *a, **k: None)
    pipe = type("P", (), {"model": Flux2Model.KLEIN_4B, "device": torch.device("cpu")})()
    tcli.attach_text_encoder(pipe, vl_dir)  # any directory with safetensors: load_qwen3 is stubbed
    assert pipe.encoders is facade.shared and isinstance(pipe.vlm_loader(), Qwen35VLMService)


# -- VLM scoring from the CLI: evaluate-lora and train-lora's vlm_scoring ---------------------------------------


@pytest.fixture
def vlm_models(vl_dir, tmp_path, monkeypatch):
    """A models dir holding the tiny Qwen3.5-VL at the registry's path, the
    facade's registry fresh, and a tally of the VLM's scoring calls."""
    monkeypatch.setenv("FLUX2_MODELS_DIR", str(tmp_path / "models"))
    shutil.copytree(vl_dir, registry.local_model_path(registry.TEXT_ENCODER_REPOS["qwen35-vlm"]))
    monkeypatch.setattr(facade, "shared", facade.TextEncoders())
    scored = []
    real = Qwen35VLMService.score_validation_image

    def score(svc, image, refs, prompt):
        out = real(svc, image, refs, prompt)
        scored.append((prompt, out))
        return out
    monkeypatch.setattr(Qwen35VLMService, "score_validation_image", score)
    return scored


def test_evaluate_lora_scores_through_the_vlm(vlm_models, tmp_path, monkeypatch, capsys):
    """evaluate-lora without --no-vlm: each baseline scored by the tiny Qwen3.5
    VLM (the pipeline's loader), its (scene, style) printed as JAX prints them."""
    from tests.test_torch_dev import TINY_VAE
    from tests.test_torch_validation import TC

    data = synthetic.write_dataset(str(tmp_path / "data"), 0, [(64, 64), (64, 64)])
    real = tcli.build_pipeline

    def build(args, device, generator=None):  # the tiny random pipeline with the checkpoint branch's VLM loader
        pipe = real(args, device, generator, transformer_config=TC, vae_config=TINY_VAE,
                    encoder_config=KLEIN_ENCODER)
        pipe.vlm_loader = tcli._make_vlm_loader(None, device)
        return pipe
    monkeypatch.setattr(tcli, "build_pipeline", build)
    assert tcli.main(["evaluate-lora", "--random-init", "--dataset", data["dataset"], "--width", "64", "--height",
                      "64", "--steps", "1", "--max-samples", "2", "--output-dir", str(tmp_path / "eval"),
                      "--device", "cpu"]) == 0
    lines = [ln for ln in capsys.readouterr().out.strip().splitlines() if not ln.startswith("saved ")]
    assert len(vlm_models) == 2
    for i, (caption, (scene, style)) in enumerate(vlm_models):
        assert lines[i] == f"[{i + 1}/2] scene={scene:.1f} style={style:.1f}  {caption[:60]}"
    assert set(json.loads(lines[-1])) >= {"scene_score", "style_score", "recommended_rank"}


def test_train_lora_vlm_scoring_scores_through_the_vlm(vlm_models, tmp_path, monkeypatch):
    """train-lora with a vlm_scoring block: the step-0 baseline pass and every
    validation pass score through the VLM, and the best checkpoint follows
    its combined score."""
    from flux2_tpu_torch.cli import train as ttrain
    from tests.test_torch_dev import TINY_VAE
    from tests.test_torch_validation import TC

    build = ttrain._build_random_pipeline

    def with_loader(*a, **k):  # the checkpoint branch's pipeline carries the lazy loader
        pipe = build(*a, **k)
        pipe.vlm_loader = tcli._make_vlm_loader(None, "cpu")
        return pipe
    monkeypatch.setattr(ttrain, "_build_random_pipeline", with_loader)
    data = synthetic.write_dataset(str(tmp_path / "data"), 1, [(64, 64), (64, 64)])
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text(f"""model: {{name: klein-4b}}
lora: {{rank: 2, alpha: 2}}
dataset: {{path: {data['dataset']}, image_size: 64}}
training: {{max_steps: 2, learning_rate: 1.0e-2, warmup_steps: 0, log_every: 1}}
checkpoints: {{output: {tmp_path / 'out'}, save_every: 1}}
validation: {{prompts: [a sks photo], every_n_steps: 1, steps: 1, size: 64,
  vlm_scoring: {{enabled: true, compare_to_baseline: true, save_best_checkpoint: true}}}}
""")
    ttrain.run_training(tcli.parse_args(["train-lora", "--config", str(cfg), "--random-init", "--device", "cpu"]),
                        "cpu", transformer_config=TC, vae_config=TINY_VAE)
    # the baseline (step 0) and the passes at steps 1 and 2, one prompt each
    assert [p for p, _ in vlm_models] == ["a sks photo"] * 3
    assert os.path.isdir(tmp_path / "out" / "best")
