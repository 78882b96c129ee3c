"""The port's I2I, img2img strength and custom sigmas against the JAX
pipeline (CPU, float32 unless stated), then the server's and the CLI's I2I.

The tiny pipeline of tests/test_pipeline.py is made by the JAX package and
carried into the port with ``io/jax_params.py`` (DiT, VAE decoder and
encoder). JAX's threefry noise for seed 1234 goes to the port as ``noise=``,
and the reference images are JAX's own draws
(tests/test_golden_regression.py). The final latents must match
``tiny_{i2i,strength,customsigmas}_latents_seed1234.npy`` and JAX's run at
the goldens' tolerance, atol 1e-3; encoded references within 1e-4 (the VAE's
tolerance) with JAX's position ids to the bit.
"""

import base64
import dataclasses
import functools
import json
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flux2_tpu.cli import main as jcli
from flux2_tpu.models.flux2 import config as jcfg
from flux2_tpu.pipeline.pipeline import _seeded_noise_seq
from flux2_tpu_torch.cli import main as tcli
from flux2_tpu_torch.io.jax_params import transformer_from_jax, vae_encoder_from_jax, vae_from_jax
from flux2_tpu_torch.io.png import decode_png, encode_png
from flux2_tpu_torch.models.flux2.config import Flux2Model
from flux2_tpu_torch.pipeline.pipeline import Flux2Pipeline
from flux2_tpu_torch.serve import Flux2Server

from tests.test_golden_regression import GOLDEN_I2I, GOLDEN_SIGMAS, GOLDEN_STRENGTH, _ref_image
from tests.test_pipeline import _emb, tiny_pipeline

LATENT_TOL = 1e-3
VAE_TOL = 1e-4
# bf16 DiT (weights and stream), f32 latents and VAE: the port's tiny I2I
# latents against JAX's on the same bf16 weights after 3 steps. Each package
# rounds its own intermediates to bf16 (XLA fuses and rounds in other places
# than torch's CPU kernels); measured 0.022-0.027 max abs and 0.0039-0.0040
# mean over three reference images, where the latents reach |x| ~ 6.4 and
# bf16's step there is 2^-5. The limits are about twice those.
BF16_LATENT_MAX = 0.06
BF16_LATENT_MEAN = 0.008


@functools.lru_cache(maxsize=1)
def tiny_pipelines():
    """(JAX tiny klein-4b pipeline, float32; the port's copy of it). Made once a
    process (JAX's VAE init takes ~20 s on the CPU); callers must not mutate them."""
    jpipe = tiny_pipeline()
    jpipe.vae_compute_dtype = jnp.float32
    return jpipe, port_of(jpipe)


def port_of(jpipe, model=None) -> Flux2Pipeline:
    """The port's pipeline on the JAX pipeline's weights (VAE decoder and encoder included)."""
    return Flux2Pipeline(
        model=Flux2Model((model or jpipe.model).value),
        transformer=transformer_from_jax(jpipe.transformer_params, jpipe.transformer_config),
        vae=vae_from_jax(jpipe.vae_params, jpipe.vae_config),
        vae_encoder=vae_encoder_from_jax(jpipe.vae_params, jpipe.vae_config),
        device=torch.device("cpu"),
        vae_compute_dtype=torch.float32,
    )


def _noise() -> torch.Tensor:
    return torch.from_numpy(np.array(_seeded_noise_seq(1234, 64, 64, 1)))


def _strength_image() -> np.ndarray:
    return np.asarray(jax.random.uniform(jax.random.PRNGKey(21), (64, 64, 3)), np.float32)


def _max_abs(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a, np.float32) - np.asarray(b, np.float32))))


def test_i2i_latents_match_golden_and_jax():
    jpipe, tpipe = tiny_pipelines()
    emb = np.array(_emb(jpipe))
    jlat, jids = jpipe.encode_reference_images([_ref_image()])
    tlat, tids = tpipe.encode_reference_images([_ref_image()])
    np.testing.assert_array_equal(tids, jids)
    assert _max_abs(tlat, jlat) <= VAE_TOL
    ref = jpipe.generate(embeddings=jnp.asarray(emb), height=64, width=64, num_steps=3, seed=1234,
                         reference_latents=jlat, reference_ids=jids)
    res = tpipe.generate(embeddings=torch.from_numpy(emb), height=64, width=64, num_steps=3, noise=_noise(),
                         reference_latents=tlat, reference_ids=tids)
    np.testing.assert_allclose(res.latents, np.load(GOLDEN_I2I), atol=LATENT_TOL, rtol=0)
    np.testing.assert_allclose(res.latents, np.asarray(ref.latents), atol=LATENT_TOL, rtol=0)
    assert np.max(np.abs(res.image - ref.image)) <= 1.0 / 255 + 1e-6


def test_strength_latents_match_golden_and_jax():
    """strength 0.5 of 4 steps: 2 steps from the encoded image noised to the first sigma."""
    jpipe, tpipe = tiny_pipelines()
    emb = np.array(_emb(jpipe))
    jinit = jpipe.encode_image_to_packed_sequence(_strength_image())
    tinit = tpipe.encode_image_to_packed_sequence(_strength_image())
    assert _max_abs(tinit, jinit) <= VAE_TOL
    ref = jpipe.generate(embeddings=jnp.asarray(emb), height=64, width=64, num_steps=4, seed=1234,
                         init_latents=jinit, strength=0.5, decode=False)
    res = tpipe.generate(embeddings=torch.from_numpy(emb), height=64, width=64, num_steps=4, noise=_noise(),
                         init_latents=tinit, strength=0.5, decode=False)
    assert res.num_steps == ref.num_steps == 2
    np.testing.assert_allclose(res.latents, np.load(GOLDEN_STRENGTH), atol=LATENT_TOL, rtol=0)
    np.testing.assert_allclose(res.latents, np.asarray(ref.latents), atol=LATENT_TOL, rtol=0)


def test_custom_sigmas_latents_match_golden_and_jax():
    jpipe, tpipe = tiny_pipelines()
    emb = np.array(_emb(jpipe))
    ref = jpipe.generate(embeddings=jnp.asarray(emb), height=64, width=64, custom_sigmas=[1.0, 0.6, 0.2], seed=1234,
                         decode=False)
    res = tpipe.generate(embeddings=torch.from_numpy(emb), height=64, width=64, custom_sigmas=[1.0, 0.6, 0.2],
                         noise=_noise(), decode=False)
    assert res.num_steps == ref.num_steps == 3
    np.testing.assert_allclose(res.latents, np.load(GOLDEN_SIGMAS), atol=LATENT_TOL, rtol=0)
    np.testing.assert_allclose(res.latents, np.asarray(ref.latents), atol=LATENT_TOL, rtol=0)


def test_two_references_of_different_sizes_encode_as_jax():
    """A 64x64 and a 96x32 reference: T = 10 and 20, each on its own grid; then
    both downscaled to at most 48x48 pixels first (sides in 32s)."""
    jpipe, tpipe = tiny_pipelines()
    rng = np.random.RandomState(7)
    refs = [rng.rand(64, 64, 3).astype(np.float32), rng.rand(96, 32, 3).astype(np.float32)]
    for max_pixels, tokens in ((64 * 64, 16 + 12), (48 * 48, 4 + 8)):
        jlat, jids = jpipe.encode_reference_images(refs, max_pixels=max_pixels)
        tlat, tids = tpipe.encode_reference_images(refs, max_pixels=max_pixels)
        np.testing.assert_array_equal(tids, jids)
        assert sorted(set(tids[:, 0].tolist())) == [10, 20] and tuple(tlat.shape) == jlat.shape == (1, tokens, 128)
        assert _max_abs(tlat, jlat) <= VAE_TOL


def test_more_references_than_the_model_takes_are_refused_as_jax():
    jpipe, tpipe = tiny_pipelines()
    refs = [np.zeros((32, 32, 3), np.float32)] * (Flux2Model.KLEIN_4B.max_reference_images + 1)
    with pytest.raises(ValueError, match="5 reference images > max 4"):
        jpipe.encode_reference_images(refs)
    with pytest.raises(ValueError, match="5 reference images > max 4"):
        tpipe.encode_reference_images(refs)


def test_reference_latents_without_ids_raise():
    jpipe, tpipe = tiny_pipelines()
    tlat, _ = tpipe.encode_reference_images([_ref_image()])
    with pytest.raises(ValueError, match="reference_latents requires reference_ids"):
        tpipe.generate(embeddings=torch.zeros(1, 8, 96), height=64, width=64, num_steps=1, reference_latents=tlat)


def test_i2i_with_classical_cfg_matches_jax():
    """A base model's I2I: cond and uncond rows each carry the references."""
    jbase = dataclasses.replace(tiny_pipelines()[0], model=jcfg.Flux2Model.KLEIN_4B_BASE)
    tbase = dataclasses.replace(tiny_pipelines()[1], model=Flux2Model.KLEIN_4B_BASE)
    emb, neg = np.array(_emb(jbase)), np.array(_emb(jbase, seed=99))
    jlat, jids = jbase.encode_reference_images([_ref_image()])
    tlat, tids = tbase.encode_reference_images([_ref_image()])
    ref = jbase.generate(embeddings=jnp.asarray(emb), negative_embeddings=jnp.asarray(neg), guidance=3.5, height=64,
                         width=64, num_steps=2, seed=1234, reference_latents=jlat, reference_ids=jids, decode=False)
    res = tbase.generate(embeddings=torch.from_numpy(emb), negative_embeddings=torch.from_numpy(neg), guidance=3.5,
                         height=64, width=64, num_steps=2, noise=_noise(), reference_latents=tlat,
                         reference_ids=tids, decode=False)
    np.testing.assert_allclose(res.latents, np.asarray(ref.latents), atol=LATENT_TOL, rtol=0)


def test_bf16_i2i_matches_jax_bf16():
    """The DiT in bf16 in both (weights and stream), as served; the VAE in f32."""
    jpipe = tiny_pipelines()[0]
    jbf = dataclasses.replace(jpipe, transformer_params=jax.tree_util.tree_map(
        lambda x: x.astype(jnp.bfloat16), jpipe.transformer_params))
    tbf = port_of(jbf)
    assert tbf.transformer.x_embedder.dtype == torch.bfloat16
    emb = np.array(_emb(jpipe))
    jlat, jids = jbf.encode_reference_images([_ref_image()])
    tlat, tids = tbf.encode_reference_images([_ref_image()])
    ref = jbf.generate(embeddings=jnp.asarray(emb), height=64, width=64, num_steps=3, seed=1234,
                       reference_latents=jlat, reference_ids=jids, decode=False)
    res = tbf.generate(embeddings=torch.from_numpy(emb), height=64, width=64, num_steps=3, noise=_noise(),
                       reference_latents=tlat, reference_ids=tids, decode=False)
    diff = np.abs(res.latents - np.asarray(ref.latents, np.float32))
    assert diff.max() <= BF16_LATENT_MAX and diff.mean() <= BF16_LATENT_MEAN, (diff.max(), diff.mean())


# -- the server -----------------------------------------------------------------------------


def _b64_png(img: np.ndarray) -> str:
    return base64.b64encode(encode_png(np.rint(img * 255.0).astype(np.uint8))).decode()


def _u8(image: np.ndarray) -> np.ndarray:
    return np.rint(np.clip(image, 0.0, 1.0) * 255.0).astype(np.uint8)


def test_i2i_requests_run_alone_and_equal_a_direct_generate():
    """Two same-shape I2I requests (one with strength 0.5, its reference as a
    data URL) run as two batches of one; each PNG equals a direct generate
    with that request's seed, references and init."""
    _, tpipe = tiny_pipelines()
    emb = torch.from_numpy(np.array(_emb(tiny_pipelines()[0])))
    rng = np.random.RandomState(3)
    refs = [_u8(rng.rand(64, 64, 3)).astype(np.float32) / 255.0 for _ in range(2)]
    server = Flux2Server(tpipe, embeddings_fn=lambda prompt: emb, batch_window_s=1.0)
    reqs = [{"prompt": "a", "height": 64, "width": 64, "steps": 2, "seed": 5, "references": [_b64_png(refs[0])]},
            {"prompt": "b", "height": 64, "width": 64, "steps": 2, "seed": 6, "strength": 0.5,
             "references": ["data:image/png;base64," + _b64_png(refs[1])]}]
    pngs, errors = [None, None], []

    def send(i):
        try:
            pngs[i] = server.generate_png(reqs[i])
        except Exception as e:  # reported below
            errors.append(e)

    try:
        threads = [threading.Thread(target=send, args=(i,)) for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not errors and not any(t.is_alive() for t in threads)
        assert (server.batches_run, server.requests_served) == (2, 2)
        assert [r["batch_size"] for r in server.request_timings] == [1, 1]
    finally:
        server.shutdown()
    lat, ids = tpipe.encode_reference_images([refs[0]])
    solo = tpipe.generate(embeddings=emb, height=64, width=64, num_steps=2, seed=5, reference_latents=lat,
                          reference_ids=ids)
    assert np.array_equal(decode_png(pngs[0]), _u8(solo.image))
    lat, ids = tpipe.encode_reference_images([refs[1]])
    init = tpipe.encode_image_to_packed_sequence(refs[1])
    solo = tpipe.generate(embeddings=emb, height=64, width=64, num_steps=2, seed=6, reference_latents=lat,
                          reference_ids=ids, strength=0.5, init_latents=init)
    assert np.array_equal(decode_png(pngs[1]), _u8(solo.image))


def test_server_shape_key_puts_each_i2i_request_alone():
    from flux2_tpu_torch.serve import _Pending

    server = Flux2Server(None)
    try:
        req = {"height": 64, "width": 64, "steps": 2}
        t2i = [_Pending(req, None), _Pending(dict(req), None)]
        i2i = [_Pending(req, None, refs=[np.zeros((8, 8, 3))]), _Pending(req, None, refs=[np.zeros((8, 8, 3))])]
        assert server._shape_key(t2i[0]) == server._shape_key(t2i[1])
        assert len({server._shape_key(p) for p in i2i + t2i[:1]}) == 3
        assert server._shape_key(_Pending(dict(req, strength=0.5), None, strength=0.5)) != server._shape_key(t2i[0])
    finally:
        server.shutdown()


@pytest.mark.parametrize("strength", [None, "strong", float("nan"), True], ids=["null", "text", "nan", "bool"])
def test_a_bad_strength_is_refused_before_queueing(strength):
    """generate_png raises ValueError to its caller; nothing is queued, and
    the worker goes on serving (a good request after it runs)."""
    _, tpipe = tiny_pipelines()
    emb = torch.from_numpy(np.array(_emb(tiny_pipelines()[0])))
    server = Flux2Server(tpipe, embeddings_fn=lambda prompt: emb, batch_window_s=0.0)
    try:
        req = {"prompt": "a", "height": 64, "width": 64, "steps": 1, "seed": 5}
        with pytest.raises(ValueError, match='"strength" must be a finite number'):
            server.generate_png(dict(req, strength=strength))
        assert not server._queue and server._worker.is_alive()
        assert decode_png(server.generate_png(dict(req, strength="0.5"))).shape == (64, 64, 3)
        assert server.requests_served == 1
    finally:
        server.shutdown()


# -- the CLI --------------------------------------------------------------------------------

I2I_ARGV = ["i2i", "--reference", "a.png", "--reference", "b.png", "--strength", "0.6", "--max-ref-megapixels",
            "0.5", "--prompt", "a fox", "--width", "512", "--height", "768", "--steps", "3", "--guidance", "2.5",
            "--seed", "9", "-o", "x.png", "--model", "klein-9b-kv", "--quantization", "w8a8"]


def test_i2i_flags_equal_jax():
    port, ref = vars(tcli.parse_args(I2I_ARGV)), vars(jcli.build_parser().parse_args(I2I_ARGV))
    assert port["command"] == ref["command"] == "i2i"
    for name in ("reference", "strength", "max_ref_megapixels", "prompt", "width", "height", "steps", "guidance",
                 "seed", "output", "model", "quantization", "random_init", "transformer_dir", "vae_dir"):
        assert port[name] == ref[name], name
    defaults = vars(tcli.parse_args(["i2i", "--reference", "a.png"]))
    jdefaults = vars(jcli.build_parser().parse_args(["i2i", "--reference", "a.png"]))
    assert (defaults["strength"], defaults["max_ref_megapixels"]) == (jdefaults["strength"],
                                                                     jdefaults["max_ref_megapixels"]) == (1.0, 1.0)


@pytest.mark.parametrize("extra", [[], ["--upsample"], ["--interpret", "c.png"], ["--shard", "auto"]],
                         ids=["no_reference", "upsample", "interpret", "shard"])
def test_unported_i2i_flags_are_refused(extra, capsys):
    """JAX's flags that the port does not run are refused by its parser;
    ``--upsample`` runs since the encoder facade is ported, ``--interpret``
    since the VLMs are, ``--shard`` since parallelism is: they parse as JAX's."""
    argv = ["i2i", *extra] if not extra else ["i2i", "--reference", "a.png", *extra]
    if extra:
        jcli.build_parser().parse_args(argv)  # JAX's flags, which the port does not run
    if extra[:1] in (["--upsample"], ["--interpret"], ["--shard"]):
        port, ref = vars(tcli.parse_args(argv)), vars(jcli.build_parser().parse_args(argv))
        assert (port["upsample"], port["interpret"], port["shard"]) == (ref["upsample"], ref["interpret"],
                                                                        ref["shard"])
        assert port["upsample"] or port["interpret"] == ["c.png"] or port["shard"] == "auto"
        return
    with pytest.raises(SystemExit):
        tcli.parse_args(argv)


class _FixedEncoder:
    """prompt -> the tiny pipeline's [1, 8, 96] test embeddings."""

    def __call__(self, prompt: str) -> torch.Tensor:
        return torch.from_numpy(np.array(_emb(tiny_pipelines()[0])))


def test_i2i_command_writes_the_png_and_prints_t2i_lines(tmp_path, monkeypatch, capsys):
    _, tpipe = tiny_pipelines()
    pipe = dataclasses.replace(tpipe, text_encoder=_FixedEncoder())
    monkeypatch.setattr(tcli, "build_pipeline", lambda args, device: pipe)
    ref = _u8(np.random.RandomState(4).rand(64, 64, 3))
    ref_path, out = str(tmp_path / "ref.png"), str(tmp_path / "out.png")
    with open(ref_path, "wb") as f:
        f.write(encode_png(ref))
    assert tcli.main(["i2i", "--reference", ref_path, "--width", "64", "--height", "64", "--steps", "4",
                      "--strength", "0.5", "--seed", "2", "--device", "cpu", "-o", out]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[-2] == f"saved {out}"
    report = json.loads(lines[-1])
    assert (report["seed"], report["steps"]) == (2, 2)
    img = ref.astype(np.float32) / 255.0
    lat, ids = pipe.encode_reference_images([img])
    want = pipe.generate(prompt="", height=64, width=64, num_steps=4, seed=2, reference_latents=lat,
                         reference_ids=ids, strength=0.5, init_latents=pipe.encode_image_to_packed_sequence(img))
    with open(out, "rb") as f:
        assert np.array_equal(decode_png(f.read()), _u8(want.image))


# -- reference images: the port's PNG reader, Pillow for the rest -----------------------------


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else (b if pb <= pc else c)


def _filtered_png(px: np.ndarray, colour_type: int, kinds) -> bytes:
    """An 8-bit PNG of ``px`` [H, W, C] whose row y uses filter ``kinds[y % len(kinds)]``
    (the PNG specification's forward filters, byte by byte)."""
    import struct
    import zlib

    from flux2_tpu_torch.io import png as tpng

    h, w, bpp = px.shape
    rows, prev = [], [0] * (w * bpp)
    for y in range(h):
        line, kind, out = px[y].reshape(-1).tolist(), kinds[y % len(kinds)], []
        for i, x in enumerate(line):
            a = line[i - bpp] if i >= bpp else 0
            c = prev[i - bpp] if i >= bpp else 0
            pred = (0, a, prev[i], (a + prev[i]) >> 1, _paeth(a, prev[i], c))[kind]
            out.append((x - pred) & 0xFF)
        rows.append(bytes([kind] + out))
        prev = line
    ihdr = struct.pack(">IIBBBBB", w, h, 8, colour_type, 0, 0, 0)
    return (tpng.PNG_SIGNATURE + tpng._chunk(b"IHDR", ihdr) + tpng._chunk(b"IDAT", zlib.compress(b"".join(rows)))
            + tpng._chunk(b"IEND", b""))


@pytest.mark.parametrize("colour_type,channels", [(0, 1), (2, 3), (4, 2), (6, 4)],
                         ids=["grey", "rgb", "grey_alpha", "rgba"])
def test_png_decoder_undoes_every_row_filter(colour_type, channels):
    px = np.random.RandomState(colour_type).randint(0, 256, (9, 7, channels)).astype(np.uint8)
    got = decode_png(_filtered_png(px, colour_type, kinds=[0, 1, 2, 3, 4, 4, 3, 2, 1]))
    want = np.repeat(px[:, :, :1], 3, axis=2) if channels < 3 else px[:, :, :3]
    assert got.dtype == np.uint8 and np.array_equal(got, want)


@pytest.mark.parametrize("h,w", [(40, 3), (3, 40), (1, 1)], ids=["tall", "wide", "one_pixel"])
def test_png_decoder_undoes_every_row_filter_tall_and_wide(h, w):
    """The decoder works one anti-diagonal at a time: images taller than wide,
    wider than tall and of one pixel."""
    px = np.random.RandomState(h * 100 + w).randint(0, 256, (h, w, 3)).astype(np.uint8)
    assert np.array_equal(decode_png(_filtered_png(px, 2, kinds=[4, 3, 1, 0, 2, 4])), px)


def test_reference_images_read_as_pillow_reads_them(monkeypatch):
    """decode_image gives what Pillow's convert("RGB") gives, through Pillow
    where it imports; a Pillow-written PNG (its own filter choice) gives the
    same through the port's decoder, which decode_image uses without Pillow,
    and without Pillow a JPEG is refused with a clear error."""
    import io

    from PIL import Image

    from flux2_tpu_torch.io.png import decode_image

    img = (np.random.RandomState(5).rand(24, 40, 3) * 64 + np.linspace(0, 180, 40)[None, :, None]).astype(np.uint8)
    files = {}
    for fmt, mode in (("PNG", "RGBA"), ("PNG", "RGB"), ("JPEG", "RGB")):
        buf = io.BytesIO()
        Image.fromarray(img).convert(mode).save(buf, fmt, **({"optimize": True} if fmt == "PNG" else {}))
        with Image.open(io.BytesIO(buf.getvalue())) as im:
            want = np.asarray(im.convert("RGB"))
        files[fmt, mode] = buf.getvalue(), want
        got = decode_image(buf.getvalue())
        assert got.dtype == np.float32 and np.array_equal(got, want.astype(np.float32) / 255.0), (fmt, mode)
        if fmt == "PNG":
            assert np.array_equal(decode_png(buf.getvalue()), want), mode
    monkeypatch.setitem(__import__("sys").modules, "PIL", None)
    for mode in ("RGBA", "RGB"):
        data, want = files["PNG", mode]
        assert np.array_equal(decode_image(data), want.astype(np.float32) / 255.0), mode
    with pytest.raises(ValueError, match="only PNG images can be read without Pillow"):
        decode_image(files["JPEG", "RGB"][0])
