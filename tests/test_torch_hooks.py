"""The port's step hooks and per-step callbacks, tiled decode, small decoder,
memory profiles and live previews against the JAX package (CPU).

The tiny pipeline of tests/test_pipeline.py is made by the JAX package and
carried into the port (``tests/test_torch_i2i.tiny_pipelines``); JAX's noise
for seed 1234 goes to the port as ``noise=``. Hooked latents and the latents
handed to ``on_latents`` must match JAX's at the goldens' tolerance, atol
1e-3, in float32, and within tests/test_torch_i2i.py's bf16 limits with
the DiT in bf16; the tiled decode within the VAE's 1e-4. The cancel point
must run as many transformer forwards as JAX's and raise its callback's
message.
"""

import dataclasses
import functools
import json
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flux2_tpu import serve as jserve
from flux2_tpu.chains import inpaint as jinpaint
from flux2_tpu.cli import main as jcli
from flux2_tpu.io import checkpoints as jckpt
from flux2_tpu.io import weight_mapping as jwm
from flux2_tpu.models.flux2 import config as jcfg
from flux2_tpu.models.flux2 import transformer as jtfm
from flux2_tpu.models.flux2 import vae as jvae
from flux2_tpu.pipeline import pipeline as jpl
from flux2_tpu.utils import memory as jmem
from flux2_tpu_torch import serve as tserve
from flux2_tpu_torch.chains import inpaint as tinpaint
from flux2_tpu_torch.cli import main as tcli
from flux2_tpu_torch.io import checkpoints as tckpt
from flux2_tpu_torch.io import weight_mapping as twm
from flux2_tpu_torch.io.jax_params import vae_from_jax
from flux2_tpu_torch.io.png import decode_png
from flux2_tpu_torch.models.flux2 import vae as tvae
from flux2_tpu_torch.models.flux2.config import Flux2Model
from flux2_tpu_torch.pipeline import pipeline as tpl
from flux2_tpu_torch.utils import memory as tmem
from flux2_tpu_torch.utils import synthetic

from tests.test_golden_regression import _ref_image
from tests.test_pipeline import _emb
from tests.test_torch_i2i import BF16_LATENT_MAX, BF16_LATENT_MEAN, _noise, port_of, tiny_pipelines

LATENT_TOL = 1e-3
VAE_TOL = 1e-4
STEPS = 4


def _legacy_jax(lat, sigma, sigma_next, step_idx):
    """tests/test_pipeline.py's legacy hook: the first half of the tokens forced to 0."""
    return lat.at[:, : lat.shape[1] // 2].set(0.0)


def _legacy_port(lat, sigma, sigma_next, step_idx):
    lat = lat.clone()
    lat[:, : lat.shape[1] // 2] = 0.0
    return lat


def _repaint_state() -> dict:
    """Seeded RePaint state on the 4x4 token grid: source latents, a mask with
    0, 1 and fractional tokens, blend noise."""
    rng = np.random.RandomState(5)
    mask = np.zeros((64, 64), np.float32)
    mask[8:40, 16:56] = 1.0
    mask[40:48, 16:56] = 0.5
    return {"image": rng.randn(1, 16, 128).astype(np.float32),
            "mask": jinpaint._area_resize(mask, 4, 4).reshape(1, 16, 1),
            "noise": rng.randn(1, 16, 128).astype(np.float32)}


def _hooks(kind: str) -> tuple:
    """(JAX hook, port hook) of a kind: "legacy" or "repaint" (structured)."""
    if kind == "legacy":
        return _legacy_jax, _legacy_port
    state = _repaint_state()
    return ((jinpaint.repaint_step_hook, {k: jnp.asarray(v) for k, v in state.items()}),
            (tinpaint.repaint_step_hook, {k: torch.from_numpy(v) for k, v in state.items()}))


def _pipes(dtype: str) -> tuple:
    """(JAX, port) tiny pipelines; with "bfloat16" the DiT in bf16 in both, the VAE float32."""
    jpipe, tpipe = tiny_pipelines()
    if dtype == "float32":
        return jpipe, tpipe
    jbf = dataclasses.replace(jpipe, transformer_params=jax.tree_util.tree_map(
        lambda x: x.astype(jnp.bfloat16), jpipe.transformer_params))
    return jbf, port_of(jbf)


class _Seen:
    """Records every per-step callback of one generate."""

    def __init__(self):
        self.progress, self.latents, self.checkpoints = [], [], []

    def kwargs(self) -> dict:
        return dict(on_progress=lambda k, n: self.progress.append((k, n)),
                    on_latents=lambda k, lat: self.latents.append((k, np.array(lat))),
                    checkpoint_interval=2, on_checkpoint=lambda k, img: self.checkpoints.append((k, img)))


@functools.lru_cache(maxsize=None)
def hooked_runs(kind: str, dtype: str) -> tuple:
    """One hooked 4-step generate in each package, every callback on: (JAX
    result, its callbacks, port result, its callbacks)."""
    jpipe, tpipe = _pipes(dtype)
    jhook, thook = _hooks(kind)
    emb = np.array(_emb(jpipe))
    jseen, tseen = _Seen(), _Seen()
    ref = jpipe.generate(embeddings=jnp.asarray(emb), height=64, width=64, num_steps=STEPS, seed=1234,
                         step_hook=jhook, **jseen.kwargs())
    res = tpipe.generate(embeddings=torch.from_numpy(emb), height=64, width=64, num_steps=STEPS, noise=_noise(),
                         step_hook=thook, **tseen.kwargs())
    return ref, jseen, res, tseen


@pytest.mark.parametrize("kind", ["legacy", "repaint"])
def test_hooked_latents_match_jax(kind):
    ref, _, res, _ = hooked_runs(kind, "float32")
    np.testing.assert_allclose(res.latents, np.asarray(ref.latents), atol=LATENT_TOL, rtol=0)
    assert np.max(np.abs(res.image - ref.image)) <= 1.0 / 255 + 1e-6
    if kind == "legacy":  # the hook ran after the last step: exactly 0 there
        assert float(np.abs(res.latents[:, :8]).max()) == 0.0 and float(np.abs(res.latents[:, 8:]).max()) > 0.0


@pytest.mark.parametrize("kind", ["legacy", "repaint"])
def test_bf16_hooked_latents_match_jax_bf16(kind):
    ref, _, res, _ = hooked_runs(kind, "bfloat16")
    assert res.latents_device.dtype == torch.float32  # the hook's arithmetic stays float32
    diff = np.abs(res.latents - np.asarray(ref.latents, np.float32))
    assert diff.max() <= BF16_LATENT_MAX and diff.mean() <= BF16_LATENT_MEAN, (diff.max(), diff.mean())


def test_repaint_hook_lands_kept_tokens_on_the_source():
    """The last sigma_next is 0.0: tokens with mask 0 equal the source to the bit."""
    _, _, res, _ = hooked_runs("repaint", "float32")
    state = _repaint_state()
    keep = state["mask"][0, :, 0] == 0.0
    assert keep.any() and not keep.all()
    assert np.array_equal(res.latents[0, keep], state["image"][0, keep])


def test_progress_and_checkpoint_callbacks_equal_jax():
    _, jseen, _, tseen = hooked_runs("repaint", "float32")
    assert tseen.progress == jseen.progress == [(1, 4), (2, 4), (3, 4), (4, 4)]
    # step 2 only: step 4 is the final image, not a checkpoint
    assert [k for k, _ in tseen.checkpoints] == [k for k, _ in jseen.checkpoints] == [2]
    (_, timg), (_, jimg) = tseen.checkpoints[0], jseen.checkpoints[0]
    assert timg.shape == jimg.shape == (64, 64, 3) and timg.dtype == np.float32
    assert np.max(np.abs(timg - jimg)) <= 1.0 / 255 + 1e-6


def test_on_latents_arrays_equal_jax():
    _, jseen, _, tseen = hooked_runs("repaint", "float32")
    assert [k for k, _ in tseen.latents] == [k for k, _ in jseen.latents] == [1, 2, 3, 4]
    for (_, t), (_, j) in zip(tseen.latents, jseen.latents):
        assert isinstance(t, np.ndarray) and t.dtype == np.float32 and t.shape == (1, 16, 128)
        np.testing.assert_allclose(t, j, atol=LATENT_TOL, rtol=0)


def test_kv_cached_path_runs_hook_and_callbacks_as_jax():
    """klein-9b-kv with a reference (tests/test_pipeline.py:239-275): the hook
    after step 0's extract pass and every cached step; progress and checkpoints."""
    jpipe = dataclasses.replace(tiny_pipelines()[0], model=jcfg.Flux2Model.KLEIN_9B_KV)
    tpipe = port_of(jpipe)
    emb = np.array(_emb(jpipe))
    jlat, jids = jpipe.encode_reference_images([_ref_image()])
    tlat, tids = tpipe.encode_reference_images([_ref_image()])

    def jhook(lat, sigma, sigma_next, step_idx):
        return lat.at[:, :4].set(0.0)

    def thook(lat, sigma, sigma_next, step_idx):
        lat = lat.clone()
        lat[:, :4] = 0.0
        return lat

    jseen, tseen = _Seen(), _Seen()
    ref = jpipe.generate(embeddings=jnp.asarray(emb), height=64, width=64, num_steps=STEPS, seed=1234,
                         reference_latents=jlat, reference_ids=jids, step_hook=jhook, **jseen.kwargs())
    res = tpipe.generate(embeddings=torch.from_numpy(emb), height=64, width=64, num_steps=STEPS, noise=_noise(),
                         reference_latents=tlat, reference_ids=tids, step_hook=thook, **tseen.kwargs())
    np.testing.assert_allclose(res.latents, np.asarray(ref.latents), atol=LATENT_TOL, rtol=0)
    assert float(np.abs(res.latents[:, :4]).max()) == 0.0 and float(np.abs(res.latents[:, 4:]).max()) > 0.0
    assert tseen.progress == jseen.progress == [(1, 4), (2, 4), (3, 4), (4, 4)]
    assert [k for k, _ in tseen.checkpoints] == [k for k, _ in jseen.checkpoints] == [2]
    for (_, t), (_, j) in zip(tseen.latents, jseen.latents):
        np.testing.assert_allclose(t, j, atol=LATENT_TOL, rtol=0)


def test_cancel_runs_as_many_forwards_as_jax(monkeypatch):
    """on_progress sets the flag at step 2 of 8: both packages run 3 forwards
    (the flag is read after step 3's update) and stop with "cancelled at step 3/8"."""
    jpipe, tpipe = tiny_pipelines()
    emb = np.array(_emb(jpipe))
    counts = {"jax": 0, "port": 0}

    def progress(cancel):
        return lambda k, n: cancel.set() if k >= 2 else None

    forward = jtfm.forward

    def jax_counting(*args, **kwargs):
        out = forward(*args, **kwargs)
        jax.debug.callback(lambda: counts.__setitem__("jax", counts["jax"] + 1), ordered=True)
        return out

    monkeypatch.setattr(jtfm, "forward", jax_counting)
    cancel = threading.Event()
    with pytest.raises(jpl.GenerationCancelled) as jerr:
        jpipe.generate(embeddings=jnp.asarray(emb), height=64, width=64, num_steps=8, seed=0,
                       on_progress=progress(cancel), cancel=cancel, decode=False)
    tforward = tpipe.transformer.forward

    def port_counting(*args, **kwargs):
        counts["port"] += 1
        return tforward(*args, **kwargs)

    monkeypatch.setattr(tpipe.transformer, "forward", port_counting)
    cancel = threading.Event()
    with pytest.raises(tpl.GenerationCancelled) as terr:
        tpipe.generate(embeddings=torch.from_numpy(emb), height=64, width=64, num_steps=8, seed=0,
                       on_progress=progress(cancel), cancel=cancel, decode=False)
    assert counts == {"jax": 3, "port": 3}
    # JAX's runtime wraps its callback's exception; the callback's message is the port's
    assert str(terr.value) == "cancelled at step 3/8" and "cancelled at step 3/8" in str(jerr.value.__cause__)


@pytest.mark.parametrize("hook", [(tinpaint.repaint_step_hook,), (tinpaint.repaint_step_hook, {}, 1), ("fn", {})],
                         ids=["one", "three", "not_callable"])
def test_malformed_structured_hook_raises_type_error_as_jax(hook):
    with pytest.raises(TypeError, match=r"structured step_hook must be \(fn, state_pytree\)"):
        jpl._normalize_hook(hook)
    _, tpipe = tiny_pipelines()
    with pytest.raises(TypeError, match=r"structured step_hook must be \(fn, state_pytree\)"):
        tpipe.generate(embeddings=torch.zeros(1, 8, 96), height=64, width=64, num_steps=1, step_hook=hook,
                       decode=False)


# -- tiled decode and the small decoder -------------------------------------------------------


@functools.lru_cache(maxsize=1)
def tiny_vaes() -> tuple:
    """JAX's TINY_VAE (2 levels, 4 latent channels) and the port's copy."""
    params = jvae.init_params(jax.random.PRNGKey(0), jvae.TINY_VAE)
    return params, vae_from_jax(params, jvae.TINY_VAE)


@pytest.mark.parametrize("hw", [(24, 24), (24, 40)])
def test_decode_tiled_matches_jax(hw):
    """tests/test_vae.py's tiling (16-latent tiles, overlap 8, threshold 8):
    24 latents at stride 8 put the last tile's start off the stride grid."""
    params, decoder = tiny_vaes()
    z = np.random.RandomState(4).randn(1, 4, *hw).astype(np.float32)
    jt = jvae.TilingConfig(tile_size=16, tile_overlap=8, min_tile_threshold=8)
    tt = tvae.TilingConfig(tile_size=16, tile_overlap=8, min_tile_threshold=8)
    ref = np.asarray(jvae.decode_tiled(params, jnp.asarray(z), jvae.TINY_VAE, jt))
    with torch.inference_mode():
        got = tvae.decode_tiled(decoder, torch.from_numpy(z), tt).numpy()
        dense = decoder.decode(torch.from_numpy(z)).numpy()
    assert got.shape == ref.shape == (1, 3, 2 * hw[0], 2 * hw[1])
    assert _max_abs(got, ref) <= VAE_TOL
    assert np.corrcoef(got.ravel(), dense.ravel())[0, 1] > 0.95  # JAX's criterion (tests/test_vae.py)
    # below the threshold the dense decode, unchanged
    with torch.inference_mode():
        small = tvae.decode_tiled(decoder, torch.from_numpy(z)).numpy()
    assert np.array_equal(small, dense)


def _max_abs(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a, np.float32) - np.asarray(b, np.float32))))


@pytest.mark.parametrize("name", ["performance", "balanced", "conservative"])
def test_pipeline_tiles_the_decode_as_jax_under_each_profile(name, monkeypatch):
    """A 1040 x 16 image: "conservative" (1024 px) tiles it, the others (2048
    px) do not; the uint8 images equal JAX's decode_latents_u8 under the same
    profile within a level (f32 VAE in both)."""
    jpipe, tpipe = tiny_pipelines()
    profile = tmem.MemoryProfile.named(name)
    lat = np.random.RandomState(6).randn(1, 65, 128).astype(np.float32)
    calls = []
    tiled = tpl.decode_tiled
    monkeypatch.setattr(tpl, "decode_tiled", lambda vae, z: calls.append(tuple(z.shape)) or tiled(vae, z))
    monkeypatch.setattr(tpipe, "memory_profile", profile)
    got = tpipe.decode_latents_u8(torch.from_numpy(lat), 1040, 16).numpy()
    assert calls == ([(1, 32, 130, 2)] if name == "conservative" else [])
    jprofile = jmem.MemoryProfile.named(name)
    ref = np.asarray(dataclasses.replace(jpipe, memory_profile=jprofile).decode_latents_u8(jnp.asarray(lat), 1040, 16))
    assert got.shape == ref.shape == (1, 1040, 16, 3)
    assert int(np.abs(got.astype(int) - ref.astype(int)).max()) <= 1
    for h, w in ((1024, 1024), (1040, 16), (2048, 2048), (2064, 512)):
        assert tpipe._tiled(h, w) == (max(h, w) > jprofile.vae_tile_threshold_px)


SMALL_VAE = tvae.VAEConfig(block_out_channels=(8, 8, 16, 16), decoder_block_out_channels=(4, 8, 8, 8),
                           layers_per_block=1, norm_num_groups=4)


def test_small_decoder_directory_loads_in_both_clis(tmp_path):
    """A tiny small-decoder AutoencoderKL directory (decoder and encoder) read
    by each CLI's VAE path; the decoders decode alike within 1e-4."""
    gen = torch.Generator().manual_seed(3)
    decoder = tvae.VAEDecoder(SMALL_VAE, generator=gen)
    encoder = tvae.VAEEncoder(SMALL_VAE, generator=gen)
    vdir = str(tmp_path / "vae")
    synthetic.write_sharded(vdir, synthetic.autoencoder_state(decoder, encoder), "diffusion_pytorch_model",
                            {"_class_name": "AutoencoderKLFlux2", **dataclasses.asdict(SMALL_VAE)})
    tconfig = tcli._read_vae_config_json(vdir, tvae.FLUX2_VAE_SMALL_DECODER)
    jconfig = jcli._read_vae_config_json(vdir, jvae.FLUX2_VAE_SMALL_DECODER)
    assert tconfig == SMALL_VAE and jconfig.effective_decoder_channels == (4, 8, 8, 8)
    tdec = twm.load_vae(tckpt.WeightsDir(vdir), tconfig, "cpu")
    twm.load_vae_encoder(tckpt.WeightsDir(vdir), tconfig, "cpu")
    jparams = jwm.map_vae_weights(jckpt.load_weights_dir(vdir), jconfig)
    z = np.random.RandomState(8).randn(1, 32, 6, 10).astype(np.float32)
    with torch.inference_mode():
        got = tdec.decode(torch.from_numpy(z)).numpy()
    ref = np.asarray(jvae.decode(jparams, jnp.asarray(z), jconfig))
    assert got.shape == ref.shape == (1, 3, 48, 80)
    assert _max_abs(got, ref) <= VAE_TOL


def test_small_decoder_flag_picks_the_small_widths(monkeypatch):
    """--small-decoder --random-init draws FLUX2_VAE_SMALL_DECODER, JAX's constant."""
    seen = []

    def from_random(model, **kwargs):
        seen.append(kwargs["vae_config"])
        raise RuntimeError("stop")

    monkeypatch.setattr(tpl.Flux2Pipeline, "from_random", staticmethod(from_random))
    for argv, want in ((["t2i", "--random-init", "--small-decoder"], tvae.FLUX2_VAE_SMALL_DECODER),
                       (["t2i", "--random-init"], None)):
        with pytest.raises(RuntimeError, match="stop"):
            tcli.build_pipeline(tcli.parse_args(argv), "cpu")
        assert seen.pop() == want
    assert tvae.FLUX2_VAE_SMALL_DECODER.effective_decoder_channels == \
        jvae.FLUX2_VAE_SMALL_DECODER.effective_decoder_channels == (96, 192, 384, 384)


def test_memory_profile_flag_attaches_the_profile():
    """build_pipeline attaches --memory-profile's profile (none without the flag)."""
    from flux2_tpu_torch.models.flux2.config import Flux2TransformerConfig
    from flux2_tpu_torch.models.text_encoders.config import TINY_DECODER

    tc = Flux2TransformerConfig(num_layers=1, num_single_layers=1, num_attention_heads=1, attention_head_dim=128,
                                joint_attention_dim=32, guidance_embeds=False)
    vc = tvae.VAEConfig(block_out_channels=(8, 8, 8, 8), layers_per_block=1, norm_num_groups=4)
    enc = dataclasses.replace(TINY_DECODER, num_hidden_layers=28, vocab_size=600)
    for flags, want in ((["--memory-profile", "conservative"], tmem.MEMORY_PROFILES["conservative"]), ([], None)):
        args = tcli.parse_args(["t2i", "--random-init", "--device", "cpu", *flags])
        pipe = tcli.build_pipeline(args, "cpu", torch.Generator().manual_seed(0), transformer_config=tc,
                                   vae_config=vc, encoder_config=enc)
        assert pipe.memory_profile == want
    auto = tcli.parse_args(["t2i", "--memory-profile", "auto", "--model", "klein-9b"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="pass hbm_bytes"):
            tcli.memory_profile(auto)


EDIT_FLAGS = ["--small-decoder", "--memory-profile", "conservative", "--checkpoint-every", "2", "-o", "x.png"]


@pytest.mark.parametrize("command", ["t2i", "i2i"])
def test_edit_flags_parse_as_jax(command):
    argv = [command, *EDIT_FLAGS] + (["--reference", "a.png"] if command == "i2i" else [])
    port, ref = vars(tcli.parse_args(argv)), vars(jcli.build_parser().parse_args(argv))
    for name in ("small_decoder", "memory_profile", "checkpoint_every", "output"):
        assert port[name] == ref[name], name
    plain = [command] + (["--reference", "a.png"] if command == "i2i" else [])
    port, ref = vars(tcli.parse_args(plain)), vars(jcli.build_parser().parse_args(plain))
    assert (port["small_decoder"], port["memory_profile"], port["checkpoint_every"]) == \
        (ref["small_decoder"], ref["memory_profile"], ref["checkpoint_every"]) == (False, None, None)


class _FixedEncoder:
    def __call__(self, prompt: str) -> torch.Tensor:
        return torch.from_numpy(np.array(_emb(tiny_pipelines()[0])))


def test_t2i_checkpoint_every_writes_step_pngs(tmp_path, monkeypatch, capsys):
    """``t2i --checkpoint-every 2`` at 4 steps writes <stem>_step_002.png: the
    checkpoint image of a direct generate; the memory profile is attached."""
    _, tpipe = tiny_pipelines()
    pipe = dataclasses.replace(tpipe, text_encoder=_FixedEncoder())
    built = []

    def build(args, device):
        built.append(args)
        return pipe

    monkeypatch.setattr(tcli, "build_pipeline", build)
    out = str(tmp_path / "x.png")
    assert tcli.main(["t2i", "--width", "64", "--height", "64", "--steps", "4", "--seed", "3",
                      "--checkpoint-every", "2", "--device", "cpu", "-o", out]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    step_png = str(tmp_path / "x_step_002.png")
    assert lines[:2] == [f"saved {step_png}", f"saved {out}"] and json.loads(lines[-1])["steps"] == 4
    assert sorted(os.listdir(tmp_path)) == ["x.png", "x_step_002.png"]
    seen = []
    pipe.generate(prompt="", height=64, width=64, num_steps=4, seed=3, checkpoint_interval=2,
                  on_checkpoint=lambda k, img: seen.append(img))
    with open(step_png, "rb") as f:
        assert np.array_equal(decode_png(f.read()), np.rint(seen[0] * 255.0).astype(np.uint8))


# -- memory profiles ------------------------------------------------------------------------


def test_memory_tables_equal_jax():
    assert tmem.BYTES_PER_PARAM == jmem.BYTES_PER_PARAM
    assert {m.value: v for m, v in tmem.APPROX_PARAMS.items()} == {m.value: v for m, v in jmem.APPROX_PARAMS.items()}
    assert {k: dataclasses.asdict(v) for k, v in tmem.MEMORY_PROFILES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jmem.MEMORY_PROFILES.items()}
    for name in tmem.MEMORY_PROFILES:
        assert dataclasses.asdict(tmem.MemoryProfile.named(name)) == dataclasses.asdict(jmem.MemoryProfile.named(name))


@pytest.mark.parametrize("gib", [16, 40, 80])
def test_memory_decisions_equal_jax(gib):
    """Every model at three device sizes: the estimate, the feasibility report
    (JAX's suggestions, the sharding one included), the
    recommended format and the auto profile."""
    hbm = gib * 2**30
    for tm in Flux2Model:
        jm = jcfg.Flux2Model(tm.value)
        for fmt in ("bf16", "qint8", "int4", "w8a8"):
            for h, w, refs in ((1024, 1024, 0), (2048, 2048, 0), (1024, 1024, 3)):
                assert tmem.estimate_generation_bytes(tm, fmt, h, w, refs) == \
                    jmem.estimate_generation_bytes(jm, fmt, h, w, refs)
                t = tmem.check_feasibility(tm, fmt, h, w, refs, hbm_bytes=hbm)
                j = jmem.check_feasibility(jm, fmt, h, w, refs, hbm_bytes=hbm)
                assert (t.feasible, t.required_gb, t.available_gb) == (j.feasible, j.required_gb, j.available_gb)
                assert t.suggestions == j.suggestions
            assert tmem.auto_profile(tm, fmt, hbm_bytes=hbm).name == jmem.auto_profile(jm, fmt, hbm_bytes=hbm).name
        assert tmem.recommended_quantization(tm, hbm_bytes=hbm) == jmem.recommended_quantization(jm, hbm_bytes=hbm)


def test_memory_decisions_without_a_card_need_hbm_bytes():
    """No 16 GiB per-device default (JAX's v5e number): without CUDA, a caller passes hbm_bytes."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: its memory is read")
    for fn in (lambda: tmem.auto_profile(Flux2Model.KLEIN_4B), lambda: tmem.check_feasibility(Flux2Model.KLEIN_4B),
               lambda: tmem.recommended_quantization(Flux2Model.KLEIN_4B)):
        with pytest.raises(RuntimeError, match="pass hbm_bytes"):
            fn()


# -- live previews ------------------------------------------------------------------------


@pytest.mark.parametrize("hw", [(64, 64), (96, 160)])
def test_packed_to_rgb_preview_equals_jax(hw):
    h, w = hw
    seq = np.random.RandomState(h + w).randn((h // 16) * (w // 16), 128).astype(np.float32) * 1.7
    got = tserve.packed_to_rgb_preview(seq, h, w)
    ref = jserve.packed_to_rgb_preview(seq, h, w)
    assert got.shape == ref.shape == (h // 8, w // 8, 3)
    np.testing.assert_allclose(got, np.asarray(ref), atol=1e-6, rtol=0)


class _Recording:
    def __init__(self, pipe):
        self._pipe, self.calls = pipe, []

    def __getattr__(self, name):
        return getattr(self._pipe, name)

    def generate(self, **kwargs):
        self.calls.append(kwargs)
        return self._pipe.generate(**kwargs)


def test_previews_only_for_requests_with_a_preview_id():
    _, tpipe = tiny_pipelines()
    recorder = _Recording(tpipe)
    emb = torch.from_numpy(np.array(_emb(tiny_pipelines()[0])))
    server = tserve.Flux2Server(recorder, embeddings_fn=lambda prompt: emb, batch_window_s=0.0)
    try:
        req = {"prompt": "a", "height": 64, "width": 64, "steps": 2, "seed": 5}
        server.generate_png(req)
        assert recorder.calls[-1]["on_latents"] is None and server.get_preview("p1") is None
        server.generate_png(dict(req, preview_id="p1"))
        assert recorder.calls[-1]["on_latents"] is not None
    finally:
        server.shutdown()
    preview = server.get_preview("p1")
    assert (preview["step"], preview["total"]) == (2, 2)
    assert decode_png(preview["png"]).shape == (8, 8, 3)


def test_preview_store_caps_at_256_and_drops_stale_entries_first(monkeypatch):
    _, tpipe = tiny_pipelines()
    server = tserve.Flux2Server(tpipe, batch_window_s=0.0)
    server.shutdown()
    clock = [1000.0]
    monkeypatch.setattr(tserve.time, "time", lambda: clock[0])
    for i in range(200):
        server._store_preview(f"old{i}", 1, 4, b"png")
    clock[0] += 301.0  # the first 200 are now stale
    for i in range(100):
        clock[0] += 1.0
        server._store_preview(f"new{i}", 1, 4, b"png")
    # at the 57th fresh id the store passed 256: every stale entry went
    assert len(server._previews) == 100 and server.get_preview("old0") is None
    for i in range(200):
        clock[0] += 1.0
        server._store_preview(f"more{i}", 2, 4, b"png")
    assert len(server._previews) == 256 and server.get_preview("new0") is None  # the oldest went
    assert server.get_preview("more199") == {"step": 2, "total": 4, "png": b"png", "t": clock[0]}
    server._store_preview("x" * 100, 3, 4, b"png")
    assert server.get_preview("x" * 64)["step"] == 3  # ids are cut to 64 characters, as JAX's
