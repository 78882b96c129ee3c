"""``flux2_tpu_torch/training/validation.py`` against the JAX package's.

The host logic equals JAX's exactly: ``ValidationPrompt.normalize`` (both
``is_512`` spellings, per-prompt size, seed, trigger and reference), the
tracker's decisions (patience, ``scene_weight``, ``min_delta``,
``degradation_threshold``, ``seed_from_history``) over score sequences, and
``evaluate_training_need`` over a grid of scores. ``run_validation`` runs on
one tiny pipeline per package with the same weights (JAX's perturbed init,
carried by ``io/jax_params.py``) and JAX's threefry noise given to the port
as ``noise=``: the same file names and records, one plain and one I2I prompt
(its reference encoded once across passes through ``ref_cache``), images
within 2 levels of 255 (f32 latents within 1e-3, the goldens' limit, move a
pixel by at most a level or two after the decode), and its PNGs written with
JAX's writer's pixels (``_save_png``, F5).
"""

import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flux2_tpu.models.flux2 import config as jcfg
from flux2_tpu.models.flux2 import transformer as jtfm
from flux2_tpu.models.text_encoders import decoder as jdec
from flux2_tpu.models.text_encoders import extractor as jext
from flux2_tpu.pipeline import pipeline as jpipeline
from flux2_tpu.training import validation as jval
from flux2_tpu.utils import dev_tokenizer as jtok
from flux2_tpu_torch.io.jax_params import decoder_from_jax, transformer_from_jax, vae_encoder_from_jax, vae_from_jax
from flux2_tpu_torch.io.png import decode_png
from flux2_tpu_torch.models.flux2.config import Flux2Model, Flux2TransformerConfig
from flux2_tpu_torch.models.text_encoders.config import DecoderConfig
from flux2_tpu_torch.models.text_encoders.extractor import EmbeddingExtractor
from flux2_tpu_torch.pipeline.pipeline import Flux2Pipeline
from flux2_tpu_torch.training import validation as tval
from flux2_tpu_torch.utils import inline_bpe_tokenizer, synthetic

from tests.test_torch_shared_copies import jax_config
from tests.test_torch_transformer import perturbed_numpy
from tests.test_torch_vae_encoder import TINY as JAX_VAE, _params as vae_params

# The tiny DiT of tests/test_torch_train_cli.py and the encoder that
# cli/train.py's _build_random_pipeline gives its joint width (96 = 3 x 32).
TC = Flux2TransformerConfig(num_layers=1, num_single_layers=1, num_attention_heads=2, attention_head_dim=128,
                            joint_attention_dim=96, guidance_embeds=True)
ENC = DecoderConfig(vocab_size=512, hidden_size=32, intermediate_size=64, num_hidden_layers=3, num_attention_heads=2,
                    num_key_value_heads=1, head_dim=64, qk_norm=True)
ENC_LAYERS = (1, 2, 3)
PIXEL_LEVELS = 2


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Tiny ops beside the suite's other workers: a thread a core oversubscribes the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def tiny_pipelines(model: str = "klein-4b-base"):
    """(JAX pipeline, the port's) on the same f32 weights: the DiT, the VAE
    (decoder and encoder) and a 3-layer Qwen3 encoder with the dev
    tokenizer. Callers must not mutate them."""
    dit = perturbed_numpy(jtfm.init_params(jax.random.PRNGKey(0), jax_config(TC), dtype=jnp.float32), 0)
    vae = vae_params("tiny")
    enc = perturbed_numpy(jdec.init_params(jax.random.PRNGKey(7), jax_config(ENC), dtype=jnp.float32), 7)
    jpipe = jpipeline.Flux2Pipeline(
        model=jcfg.Flux2Model(model), transformer_params=jax.tree_util.tree_map(jnp.asarray, dit),
        transformer_config=jax_config(TC), vae_params=jax.tree_util.tree_map(jnp.asarray, vae), vae_config=JAX_VAE,
        text_encoder=jext.EmbeddingExtractor(jax.tree_util.tree_map(jnp.asarray, enc), jax_config(ENC),
                                             jtok.inline_bpe_tokenizer(), ENC_LAYERS, recipe="klein"),
        vae_compute_dtype=jnp.float32)
    tpipe = Flux2Pipeline(
        model=Flux2Model(model), transformer=transformer_from_jax(dit, TC), vae=vae_from_jax(vae, JAX_VAE),
        vae_encoder=vae_encoder_from_jax(vae, JAX_VAE), device=torch.device("cpu"), vae_compute_dtype=torch.float32,
        text_encoder=EmbeddingExtractor(decoder_from_jax(enc, ENC), inline_bpe_tokenizer(), ENC_LAYERS))
    return jpipe, tpipe


def with_jax_noise(tpipe: Flux2Pipeline) -> Flux2Pipeline:
    """A copy of the port's pipeline whose generate() takes JAX's threefry noise for its seed."""
    pipe = dataclasses.replace(tpipe)
    generate = pipe.generate

    def generate_with_jax_noise(**kw):
        noise = jpipeline._seeded_noise_seq(kw.get("seed", 0), kw["height"], kw["width"], 1)
        return generate(noise=torch.from_numpy(np.array(noise)), **kw)

    pipe.generate = generate_with_jax_noise
    return pipe


# -- host logic ------------------------------------------------------------------

PROMPTS = ["a red fox", {"prompt": "a fox", "is_512": True}, {"prompt": "a fox", "is512": True},
           {"prompt": "a fox", "is_1024": True, "seed": 3}, {"prompt": "a fox", "size": 256, "apply_trigger": False},
           {"prompt": "a fox", "width": 64, "height": 96, "reference": "ref.png"},
           {"prompt": "a fox", "reference_image": "r.png", "is_vlm_generated": True},
           {"prompt": "a fox", "vlm_generated": True, "is_512": False, "is_1024": False}]


@pytest.mark.parametrize("raw", PROMPTS, ids=range(len(PROMPTS)))
def test_validation_prompt_normalize_equals_jax(raw):
    assert dataclasses.asdict(tval.ValidationPrompt.normalize(raw)) == dataclasses.asdict(
        jval.ValidationPrompt.normalize(raw))


def test_validation_prompt_normalize_refuses_what_jax_refuses():
    for mod in (tval, jval):
        with pytest.raises(TypeError, match="str|dict"):
            mod.ValidationPrompt.normalize(3)


SCORES = [[(5, 5)], [(6, 4)], [(6, 5), (4, 5)], [(3, 3)], [(7, 2)], [(7, 7)], [(1, 1)], [(7.05, 7)], [(2, 9)]]


@pytest.mark.parametrize("knobs", [dict(patience=3), dict(patience=0), dict(patience=1, scene_weight=0.8),
                                   dict(patience=2, min_delta=0.5), dict(patience=0, degradation_threshold=4.0),
                                   dict(patience=5, scene_weight=0.2, min_delta=0.05, degradation_threshold=8.0)],
                         ids=["p3", "p0", "w08", "delta", "degrade", "all"])
def test_tracker_decisions_equal_jax(knobs):
    ours, ref = tval.ValidationTracker(**knobs), jval.ValidationTracker(**knobs)
    for step, scores in enumerate(SCORES, start=1):
        recs = [tval.ValidationRecord(step, f"p{i}", *s) for i, s in enumerate(scores)]
        jrecs = [jval.ValidationRecord(step, f"p{i}", *s) for i, s in enumerate(scores)]
        assert ours.record(step, recs) == ref.record(step, jrecs)
        assert (ours.best_step, ours.best_score, ours._non_improving) == (ref.best_step, ref.best_score,
                                                                          ref._non_improving)
        assert ours.mean_combined(recs) == ref.mean_combined(jrecs) and ours.should_copy_best == ref.should_copy_best


@pytest.mark.parametrize("scene_weight", [0.5, 0.3])
def test_tracker_seed_from_history_equals_jax(scene_weight):
    history = [{"step": 0, "scene": 9.0, "style": 9.0, "prompt": "a"}, {"step": 2, "scene": 4.0, "style": 6.0},
               {"step": 2, "scene": 5.0, "style": 1.0}, {"step": 4, "scene": 6.0, "style": 3.0},
               {"step": 6, "scene": 2.0, "style": 7.5}]
    ours, ref = tval.ValidationTracker(scene_weight=scene_weight), jval.ValidationTracker(scene_weight=scene_weight)
    ours.seed_from_history(history)
    ref.seed_from_history(history)
    assert (ours.best_step, ours.best_score) == (ref.best_step, ref.best_score) and ours.best_step != 0


@pytest.mark.parametrize("scene", [0.0, 2.5, 4.0, 6.9, 7.0, 10.0])
@pytest.mark.parametrize("style", [0.0, 3.0, 5.5, 8.0, 10.0])
def test_evaluate_training_need_equals_jax(scene, style):
    scores = [(scene, style), (scene * 0.5, min(10.0, style + 1.0))]
    assert dataclasses.asdict(tval.evaluate_training_need(scores)) == dataclasses.asdict(
        jval.evaluate_training_need(scores))


def test_evaluate_training_need_of_no_scores_equals_jax():
    assert dataclasses.asdict(tval.evaluate_training_need([])) == dataclasses.asdict(jval.evaluate_training_need([]))


def test_save_png_writes_jax_pixels(tmp_path):
    """F5: truncation, not rounding; values off the 1/255 grid and out of [0, 1]."""
    img = np.random.RandomState(0).uniform(-0.1, 1.1, (24, 40, 3)).astype(np.float32)
    tval._save_png(img, str(tmp_path / "a" / "ours.png"))
    jval._save_png(img, str(tmp_path / "b" / "jax.png"))
    from PIL import Image

    ours = decode_png((tmp_path / "a" / "ours.png").read_bytes())
    assert np.array_equal(ours, np.asarray(Image.open(tmp_path / "b" / "jax.png")))
    assert not np.array_equal(ours, np.rint(np.clip(img, 0, 1) * 255).astype(np.uint8))


# -- run_validation ----------------------------------------------------------------


@pytest.mark.parametrize("trigger", [None, "sks"])
def test_run_validation_equals_jax(tmp_path, trigger):
    jpipe, tpipe = tiny_pipelines("klein-4b")
    ref_path = synthetic.write_dataset(str(tmp_path / "refs"), 4, [(64, 64)])["dataset"] + "/image_00.png"
    config = dict(prompts=("a red fox", {"prompt": "sks on a boat", "seed": 5, "width": 64, "height": 32},
                           {"prompt": "cartoon of a cat", "reference": ref_path}),
                  every_n_steps=2, width=32, height=32, steps=2, seed=11, trigger_word=trigger)
    rng = np.random.RandomState(2)
    table = {}

    def embeddings(prompt):  # one numpy draw per prompt, given to both packages
        if prompt not in table:
            table[prompt] = (0.5 * rng.randn(1, 8, 96)).astype(np.float32)
        return table[prompt]

    seen = {"jax": [], "port": []}

    def scorer(name):
        def score(image, refs, prompt):
            seen[name].append(np.asarray(image))
            return float(np.mean(image)) * 10, float(len(refs)) + len(prompt) / 100

        return score

    refs = [np.full((16, 16, 3), 0.5, np.float32)]
    tdir, jdir = str(tmp_path / "port"), str(tmp_path / "jax")
    t_ref_cache, j_ref_cache, pipe = {}, {}, with_jax_noise(tpipe)
    encodes = []
    encode = pipe.encode_reference_images
    pipe.encode_reference_images = lambda images, *a, **k: encodes.append(1) or encode(images, *a, **k)
    for step in (0, 2):
        ours = tval.run_validation(pipe, tval.ValidationConfig(**config), step,
                                   embeddings_fn=lambda p: torch.from_numpy(embeddings(p)), scorer=scorer("port"),
                                   reference_images=refs, output_dir=tdir, ref_cache=t_ref_cache)
        ref = jval.run_validation(jpipe, jval.ValidationConfig(**config), step,
                                  embeddings_fn=lambda p: jnp.asarray(embeddings(p)), scorer=scorer("jax"),
                                  reference_images=refs, output_dir=jdir, ref_cache=j_ref_cache)
        assert [(r.step, r.prompt, r.style) for r in ours] == [(r.step, r.prompt, r.style) for r in ref]
        assert all(abs(a.scene - b.scene) <= 10 * PIXEL_LEVELS / 255 for a, b in zip(ours, ref))
    assert len(encodes) == 1 and list(t_ref_cache) == list(j_ref_cache) == [ref_path]
    prompts = [r.prompt for r in ours]
    assert prompts[1] == "sks on a boat" and prompts[2] == ("sks cartoon of a cat" if trigger else "cartoon of a cat")
    assert sorted(os.listdir(tdir)) == sorted(os.listdir(jdir)) == [
        f"val_{s:06d}_p{p}_0.png" for s in (0, 2) for p in range(3)]
    for a, b, name in zip(seen["port"], seen["jax"], sorted(os.listdir(tdir))):
        assert a.shape == b.shape and np.abs(a - b).max() <= PIXEL_LEVELS / 255 + 1e-6, name
    from PIL import Image

    for name in os.listdir(tdir):  # each PNG: JAX's writer's pixels of the port's image
        ours_png = decode_png(open(os.path.join(tdir, name), "rb").read())
        jval._save_png(seen["port"][sorted(os.listdir(tdir)).index(name)], str(tmp_path / "check" / name))
        assert np.array_equal(ours_png, np.asarray(Image.open(tmp_path / "check" / name)))
