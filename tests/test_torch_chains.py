"""The port's RePaint inpainting and outpainting chains against the JAX
package's, end to end on the tiny pipeline (CPU, float32), and their
subcommands.

Both chains draw two kinds of noise: the initial noise (the pipeline's seed)
and the blend noise (``_blend_noise``). The port draws both from
``torch.Generator``s, JAX from threefry keys, so the tests patch the port's
draws with JAX's. The final latents must match JAX's at atol 1e-3 and the
images within one uint8 level; the kept tokens equal the source latents to
the bit. The chains' host helpers (mask geometry, canvas, native image ops)
are held against JAX's in tests/test_torch_shared_copies.py.
"""

import dataclasses
import functools
import io
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flux2_tpu.chains import inpaint as jinpaint
from flux2_tpu.chains import outpaint as joutpaint
from flux2_tpu.cli import main as jcli
from flux2_tpu.pipeline.pipeline import _seeded_noise_seq
from flux2_tpu_torch.chains import inpaint as tinpaint
from flux2_tpu_torch.chains import outpaint as toutpaint
from flux2_tpu_torch.cli import main as tcli
from flux2_tpu_torch.io.png import decode_png, encode_png
from flux2_tpu_torch.ops import latents as tlu

from tests.test_golden_regression import _ref_image
from tests.test_pipeline import _emb
from tests.test_torch_i2i import tiny_pipelines

LATENT_TOL = 1e-3
LEVEL = 1.0 / 255 + 1e-6


@pytest.fixture
def jax_draws(monkeypatch):
    """The port's initial and blend noise replaced by JAX's draws for the same seeds."""
    monkeypatch.setattr(tinpaint, "_blend_noise", lambda seed, shape, device: torch.from_numpy(
        np.array(jax.random.normal(jax.random.PRNGKey(seed), shape, jnp.float32))).to(device))
    monkeypatch.setattr(tlu, "seeded_noise_seq", lambda seed, h, w, batch=1, device="cpu": torch.from_numpy(
        np.array(_seeded_noise_seq(seed, h, w, batch))).to(device))


def _image(h: int, w: int, seed: int = 21) -> np.ndarray:
    return np.random.RandomState(seed).rand(h, w, 3).astype(np.float32)


def _grey_mask(h: int, w: int) -> np.ndarray:
    """White inside a box with a soft lower edge, black elsewhere."""
    mask = np.zeros((h, w), np.float32)
    mask[h // 4 : h // 2, w // 4 : 3 * w // 4] = 1.0
    mask[h // 2 : h // 2 + 8, w // 4 : 3 * w // 4] = np.linspace(1.0, 0.0, 8, dtype=np.float32)[:, None]
    return mask


def _alpha_mask(h: int, w: int) -> np.ndarray:
    rgba = np.ones((h, w, 4), np.float32)
    rgba[..., 3] = 1.0 - _grey_mask(h, w)  # transparent = inpaint
    return rgba


# mode -> (image size, mask, chain arguments)
MODES = {
    "t2i": ((64, 64), "grey", {}),
    "image_as_reference": ((64, 64), "grey", {"use_image_as_reference": True}),
    "reference_images": ((64, 64), "grey", {"reference_images": "ref"}),
    "strength": ((64, 64), "grey", {"strength": 0.5}),
    "crop_and_stitch": ((96, 96), "grey", {"mask_crop_padding": 8, "composite_on_original": True}),
    "alpha_composite": ((64, 64), "alpha", {"composite_on_original": True}),
}


def _chain_kwargs(mode: str) -> dict:
    (h, w), mask_kind, extra = MODES[mode]
    kwargs = dict(prompt="", image=_image(h, w), mask=(_grey_mask if mask_kind == "grey" else _alpha_mask)(h, w),
                  seed=1234, steps=4, **extra)
    if mask_kind == "alpha":
        kwargs["mask_convention"] = tinpaint.ALPHA_TRANSPARENT_INPAINT
    if extra.get("reference_images") == "ref":
        kwargs["reference_images"] = [_ref_image()]
    return kwargs


@functools.lru_cache(maxsize=None)
def jax_inpaint(mode: str):
    jpipe = tiny_pipelines()[0]
    return jinpaint.MaskedInpaintingChain(pipeline=jpipe, embeddings=_emb(jpipe), **_chain_kwargs(mode)).run()


def _port_emb() -> torch.Tensor:
    return torch.from_numpy(np.array(_emb(tiny_pipelines()[0])))


@pytest.mark.parametrize("mode", list(MODES))
def test_inpaint_chain_matches_jax(mode, jax_draws):
    tpipe = tiny_pipelines()[1]
    ref = jax_inpaint(mode)
    res = tinpaint.MaskedInpaintingChain(pipeline=tpipe, embeddings=_port_emb(), **_chain_kwargs(mode)).run()
    assert res.num_steps == ref.num_steps == (2 if mode == "strength" else 4)
    np.testing.assert_allclose(res.latents, np.asarray(ref.latents), atol=LATENT_TOL, rtol=0)
    assert res.image.shape == ref.image.shape and np.max(np.abs(res.image - ref.image)) <= LEVEL


@pytest.mark.parametrize("mode", ["t2i", "image_as_reference", "alpha_composite"])
def test_kept_tokens_land_on_the_source_latents(mode, jax_draws):
    """Tokens whose latent-grid mask is exactly 0 equal the clean source
    latents to the bit (the last sigma_next is 0.0); the masked ones moved."""
    tpipe = tiny_pipelines()[1]
    kwargs = _chain_kwargs(mode)
    res = tinpaint.MaskedInpaintingChain(pipeline=tpipe, embeddings=_port_emb(), **kwargs).run()
    source = tpipe.encode_image_to_packed_sequence(kwargs["image"])
    mask = tinpaint.pack_mask_for_latent_blending(kwargs["mask"], 64, 64, kwargs.get(
        "mask_convention", tinpaint.GRAYSCALE_WHITE_INPAINT))[0, :, 0]
    keep = mask == 0
    assert keep.any() and not keep.all()
    assert torch.equal(res.latents_device[0, keep], source[0, keep])
    assert float((res.latents_device[0, ~keep] - source[0, ~keep]).abs().max()) > 0.1


def test_crop_and_stitch_leaves_the_rest_of_the_image_untouched(jax_draws):
    tpipe = tiny_pipelines()[1]
    kwargs = _chain_kwargs("crop_and_stitch")
    res = tinpaint.MaskedInpaintingChain(pipeline=tpipe, embeddings=_port_emb(), **kwargs).run()
    x0, y0, x1, y1 = tinpaint.expand_crop_region(tinpaint.mask_bounding_box(kwargs["mask"]), 8, 96, 96)
    assert (x0, y0, x1, y1) == (16, 16, 80, 80) and tuple(res.latents.shape) == (1, 16, 128)
    outside = np.ones((96, 96), bool)
    outside[y0:y1, x0:x1] = False
    assert res.image.shape == (96, 96, 3) and np.array_equal(res.image[outside], kwargs["image"][outside])


@functools.lru_cache(maxsize=None)
def jax_outpaint():
    jpipe = tiny_pipelines()[0]
    return joutpaint.OutpaintingChain(pipeline=jpipe, image=_image(32, 64), prompt="", top=20, left=32, right=5,
                                      seed=1234, embeddings=_emb(jpipe)).run()


def test_outpaint_chain_matches_jax(jax_draws):
    """A 32 x 64 image padded 20 / 0 / 32 / 5 px (top, bottom, left, right),
    rounded up to 32: a 64 x 128 canvas, the image as the I2I reference."""
    tpipe = tiny_pipelines()[1]
    ref = jax_outpaint()
    res = toutpaint.OutpaintingChain(pipeline=tpipe, image=_image(32, 64), prompt="", top=20, left=32, right=5,
                                     seed=1234, embeddings=_port_emb()).run()
    assert res.image.shape == ref.image.shape == (64, 128, 3) and tuple(res.latents.shape) == (1, 32, 128)
    np.testing.assert_allclose(res.latents, np.asarray(ref.latents), atol=LATENT_TOL, rtol=0)
    assert np.max(np.abs(res.image - ref.image)) <= LEVEL


@pytest.mark.parametrize("pads,shape", [((-1, 0, 0, 0), (64, 64)), ((0, 0, 0, 0), (64, 64)), ((32, 0, 0, 0), (40, 64))],
                         ids=["negative", "none", "canvas_not_32"])
def test_outpaint_refusals_equal_jax(pads, shape):
    t, b, l, r = pads
    msgs = []
    for mod, pipe in ((joutpaint, tiny_pipelines()[0]), (toutpaint, tiny_pipelines()[1])):
        with pytest.raises(ValueError) as err:
            mod.OutpaintingChain(pipeline=pipe, image=_image(*shape), prompt="", top=t, bottom=b, left=l,
                                 right=r).run()
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]


def test_vlm_enrichment_warns_and_keeps_the_prompt_as_jax(capsys):
    """No VLM is loaded: both chains warn and keep the prompt and the upsample
    flag; with precomputed embeddings, the same warning in both."""
    jpipe, tpipe = tiny_pipelines()
    common = dict(prompt="a red door", image=_image(64, 64), mask=_grey_mask(64, 64), enrich_prompt_with_vlm=True,
                  upsample_prompt=True)
    for emb in (None, _emb(jpipe)):
        ref = jinpaint.MaskedInpaintingChain(pipeline=jpipe, embeddings=emb, **common)
        jout = ref._resolve_final_prompt_and_upsample()
        jwarn = capsys.readouterr().err
        chain = tinpaint.MaskedInpaintingChain(pipeline=tpipe, embeddings=None if emb is None else _port_emb(),
                                               **common)
        tout = chain._resolve_final_prompt_and_upsample()
        twarn = capsys.readouterr().err
        assert tout == jout == ("a red door", True)
        assert twarn == jwarn
        assert ("no VLM is loaded" if emb is None else "enrich_prompt_with_vlm ignored") in twarn


class _EchoVLM:
    """A vision service stand-in whose reply spells its inputs: the system
    prompt's first words, the user text and the image's shape and mean."""

    def __init__(self, kind: str, reply: str = None):
        self.kind, self.reply, self.calls = kind, reply, []

    def _answer(self, system, user, image):
        self.calls.append((system, user, image.shape))
        if self.reply is not None:
            return self.reply
        return f" {' '.join(system.split()[:12])} | {user} | {image.shape} {float(image.mean()):.6f} "

    def chat(self, system, user, image=None):
        return self._answer(system, user, image)


class _EchoMistral(_EchoVLM):
    def analyze_image(self, image, prompt, seed=0):
        return self._answer(prompt, "", image)


@pytest.mark.parametrize("intent", ["replace", "remove", "modify", "change-scene", "outpaint"])
def test_vlm_enrichment_through_the_cli_equals_jax(intent, cli_pipe, tmp_path, capsys, monkeypatch):
    """``inpaint --enrich-prompt-with-vlm --intent X`` (and ``outpaint
    --enrich-prompt-with-vlm``) through cli.main, the VLM loaded by the
    pipeline's loader: the prompt the DiT gets is JAX's chain's on the same
    reply, the intent's system prompt and the ORIGINAL image (outpaint: the
    sorted extended sides), and wins over --upsample-prompt."""
    vlm = _EchoVLM("qwen35")
    monkeypatch.setattr(cli_pipe, "vlm_loader", lambda: vlm)
    prompts = []
    generate = type(cli_pipe).generate
    monkeypatch.setattr(type(cli_pipe), "generate",
                        lambda self, **k: prompts.append((k["prompt"], k["upsample"])) or generate(self, **k))
    src = _image(64, 64)
    src_path = str(tmp_path / "src.png")
    with open(src_path, "wb") as f:
        f.write(encode_png(_u8(src)))
    mask_path = str(tmp_path / "mask.png")
    with open(mask_path, "wb") as f:
        f.write(encode_png(_u8(np.repeat(_grey_mask(64, 64)[..., None], 3, axis=-1))))
    image = decode_png(open(src_path, "rb").read()).astype(np.float32) / 255.0
    jpipe = tiny_pipelines()[0]
    monkeypatch.setattr(jpipe, "vlm", vlm)
    if intent == "outpaint":
        argv = ["outpaint", "--image", src_path, "--left", "32", "--top", "32"]
        ref = joutpaint.OutpaintingChain(pipeline=jpipe, image=image, prompt="a wider street", left=32, top=32,
                                         upsample_prompt=True, enrich_prompt_with_vlm=True)
    else:
        argv = ["inpaint", "--image", src_path, "--mask", mask_path, "--intent", intent]
        ref = jinpaint.MaskedInpaintingChain(pipeline=jpipe, prompt="a wider street", image=image,
                                             mask=_grey_mask(64, 64), upsample_prompt=True,
                                             enrich_prompt_with_vlm=True, intent=intent)
    want = ref._resolve_final_prompt_and_upsample()
    jwarn = capsys.readouterr().err
    assert tcli.main([*argv, "--prompt", "a wider street", "--upsample-prompt", "--enrich-prompt-with-vlm",
                      "--steps", "1", "-o", str(tmp_path / "out.png")]) == 0
    assert prompts[0] == want and want[0] != "a wider street" and not want[1]
    twarn = capsys.readouterr().err
    assert [ln for ln in twarn.splitlines() if "VLM" in ln] == [ln for ln in jwarn.splitlines() if "VLM" in ln]
    assert len(vlm.calls) == 2 and vlm.calls[0] == vlm.calls[1]  # JAX's chain, then the port's


@pytest.mark.parametrize("case", ["mistral", "empty_reply", "failing", "no_vlm_on_disk"])
def test_vlm_enrichment_fallbacks_equal_jax(case, capsys, monkeypatch):
    """The Mistral VLM's analyze_image route, an empty reply, a VLM that
    raises (the builder's fallback), and the CLI's loader finding no VLM: the
    same prompts and warnings as JAX's chain."""
    jpipe, tpipe = tiny_pipelines()
    vlm = {"mistral": _EchoMistral("mistral"), "empty_reply": _EchoVLM("qwen35", reply="  "),
           "failing": type("Failing", (), {"chat": lambda self, *a, **k: 1 / 0})(), "no_vlm_on_disk": None}[case]
    monkeypatch.setattr(jpipe, "vlm", vlm)
    tpipe = dataclasses.replace(tpipe, vlm=None, vlm_loader=(lambda: vlm) if vlm is not None else _no_vlm_on_disk)
    kwargs = dict(prompt="a red door", image=_image(64, 64), mask=_grey_mask(64, 64), enrich_prompt_with_vlm=True,
                  intent="modify")
    want = jinpaint.MaskedInpaintingChain(pipeline=jpipe, **kwargs)._resolve_final_prompt_and_upsample()
    jwarn = capsys.readouterr().err
    args = types.SimpleNamespace(enrich_prompt_with_vlm=True)
    assert tcli._vlm_for_enrichment(tpipe, args) is True
    got = tinpaint.MaskedInpaintingChain(pipeline=tpipe, **kwargs)._resolve_final_prompt_and_upsample()
    twarn = capsys.readouterr().err
    assert got == want
    assert [ln for ln in twarn.splitlines() if "VLM" in ln and "disk" not in ln] == jwarn.splitlines()
    assert (got[0] != "a red door") == (case == "mistral")


def _no_vlm_on_disk():
    raise SystemExit("--interpret/--upsample with images needs a VLM checkpoint on disk")


class _FixedEncoder:
    """prompt -> the tiny pipeline's [1, 8, 96] test embeddings."""

    def __call__(self, prompt: str) -> torch.Tensor:
        return _port_emb()


def test_upsample_prompt_raises_jax_error():
    """Prompt upsampling needs a text encoder facade: neither tiny pipeline has one."""
    jpipe, tpipe = tiny_pipelines()
    msgs = []
    with pytest.raises(ValueError) as err:
        jinpaint.MaskedInpaintingChain(pipeline=jpipe, prompt="x", image=_image(64, 64), mask=_grey_mask(64, 64),
                                       upsample_prompt=True).run()
    msgs.append(str(err.value))
    with pytest.raises(ValueError) as err:
        tinpaint.MaskedInpaintingChain(pipeline=dataclasses.replace(tpipe, text_encoder=_FixedEncoder()), prompt="x",
                                       image=_image(64, 64), mask=_grey_mask(64, 64), upsample_prompt=True).run()
    msgs.append(str(err.value))
    assert msgs[0] == msgs[1] == "prompt upsampling requires an attached text encoder facade"


# -- the subcommands ---------------------------------------------------------------------------


def _png_file(path, image_u8: np.ndarray, mode: str = None) -> str:
    from PIL import Image

    Image.fromarray(image_u8, mode).save(path) if mode else Image.fromarray(image_u8).save(path)
    return str(path)


def _u8(x: np.ndarray) -> np.ndarray:
    """The pixels JAX's CLI writer (``_save_image``: clip, scale, truncate)
    stores for ``x`` ([H, W], RGB or RGBA), read back as written."""
    import contextlib
    import os
    import tempfile

    from PIL import Image

    with tempfile.TemporaryDirectory() as d, contextlib.redirect_stdout(io.StringIO()):
        path = os.path.join(d, "x.png")
        jcli._save_image(x, path)
        with Image.open(path) as im:
            return np.asarray(im)


@pytest.fixture
def cli_pipe(monkeypatch):
    pipe = dataclasses.replace(tiny_pipelines()[1], text_encoder=_FixedEncoder())
    monkeypatch.setattr(tcli, "build_pipeline", lambda args, device: pipe)
    return pipe


@pytest.mark.parametrize("mode", ["grey", "alpha", "crop_composite"])
def test_inpaint_command_writes_the_chain_image(mode, cli_pipe, tmp_path, capsys):
    """inpaint through cli.main: the PNG is the chain's image on the same
    inputs; with --crop-padding --composite the pixels outside the crop are
    the source's."""
    size = 96 if mode == "crop_composite" else 64
    src = _u8(_image(size, size))
    image_path = _png_file(tmp_path / "in.png", src)
    grey = _grey_mask(size, size)
    if mode == "alpha":
        mask_path = _png_file(tmp_path / "mask.png", _u8(_alpha_mask(size, size)), "RGBA")
    else:
        mask_path = _png_file(tmp_path / "mask.png", _u8(grey), "L")
    out = str(tmp_path / "out.png")
    flags = {"grey": [], "alpha": ["--alpha-mask"], "crop_composite": ["--crop-padding", "8", "--composite"]}[mode]
    assert tcli.main(["inpaint", "--image", image_path, "--mask", mask_path, "--seed", "7", "--device", "cpu",
                      "-o", out, *flags]) == 0
    assert capsys.readouterr().out.strip().splitlines()[-1] == f"saved {out}"
    with open(out, "rb") as f:
        got = decode_png(f.read())
    chain = tinpaint.MaskedInpaintingChain(
        pipeline=cli_pipe, prompt="", image=src.astype(np.float32) / 255.0, seed=7,
        mask=tcli._load_mask(mask_path, mode == "alpha"),
        mask_convention=tinpaint.ALPHA_TRANSPARENT_INPAINT if mode == "alpha" else tinpaint.GRAYSCALE_WHITE_INPAINT,
        mask_crop_padding=8 if mode == "crop_composite" else None, composite_on_original=mode == "crop_composite")
    assert np.array_equal(got, _u8(chain.run().image))
    if mode == "crop_composite":
        x0, y0, x1, y1 = tinpaint.expand_crop_region(tinpaint.mask_bounding_box(grey), 8, 96, 96)
        outside = np.ones((96, 96), bool)
        outside[y0:y1, x0:x1] = False
        assert outside.any() and np.array_equal(got[outside], src[outside])


def test_outpaint_command_writes_the_chain_image(cli_pipe, tmp_path):
    src = _u8(_image(32, 64))
    image_path = _png_file(tmp_path / "in.png", src)
    out = str(tmp_path / "out.png")
    assert tcli.main(["outpaint", "--image", image_path, "--top", "32", "--right", "32", "--seed", "3",
                      "--device", "cpu", "-o", out]) == 0
    with open(out, "rb") as f:
        got = decode_png(f.read())
    want = toutpaint.OutpaintingChain(pipeline=cli_pipe, image=src.astype(np.float32) / 255.0, prompt="", top=32,
                                      right=32, seed=3).run()
    assert got.shape == (64, 96, 3) and np.array_equal(got, _u8(want.image))


INPAINT_ARGV = ["inpaint", "--image", "a.png", "--mask", "m.png", "--alpha-mask", "--strength", "0.7",
                "--crop-padding", "32", "--composite", "--use-image-as-reference", "--max-pixels", "1000000",
                "--upsample-prompt", "--enrich-prompt-with-vlm", "--intent", "change-scene", "--prompt", "a door",
                "--steps", "6", "--seed", "4", "-o", "x.png", "--model", "klein-9b"]
OUTPAINT_ARGV = ["outpaint", "--image", "a.png", "--top", "10", "--bottom", "20", "--left", "30", "--right", "40",
                 "--max-pixels", "500000", "--upsample-prompt", "--enrich-prompt-with-vlm", "--prompt", "a street",
                 "--seed", "2", "-o", "y.png"]


@pytest.mark.parametrize("argv", [INPAINT_ARGV, OUTPAINT_ARGV, INPAINT_ARGV[:5], OUTPAINT_ARGV[:3]],
                         ids=["inpaint", "outpaint", "inpaint_defaults", "outpaint_defaults"])
def test_edit_command_flags_equal_jax(argv):
    port, ref = vars(tcli.parse_args(argv)), vars(jcli.build_parser().parse_args(argv))
    shared = set(port) & set(ref) - {"fn"}
    assert {"image", "prompt", "seed", "steps", "output", "max_pixels", "upsample_prompt",
            "enrich_prompt_with_vlm"} <= shared
    assert {k: port[k] for k in shared} == {k: ref[k] for k in shared}


@pytest.mark.parametrize("pil_mode", ["L", "LA", "RGB", "RGBA"])
def test_masks_read_without_pillow_as_pillow_reads_them(pil_mode, tmp_path, monkeypatch):
    """Grey (JAX's convert("L")) and RGBA (convert("RGBA")) from every PNG
    colour type, Pillow's and the port's own reader alike."""
    from PIL import Image

    rng = np.random.RandomState(9)
    channels = {"L": 1, "LA": 2, "RGB": 3, "RGBA": 4}[pil_mode]
    px = rng.randint(0, 256, (20, 30, channels)).astype(np.uint8)
    path = str(tmp_path / "m.png")
    Image.fromarray(px[..., 0] if channels == 1 else px, pil_mode).save(path)
    with_pil = [tcli._load_mask(path, alpha) for alpha in (False, True)]
    monkeypatch.setitem(__import__("sys").modules, "PIL", None)
    without = [tcli._load_mask(path, alpha) for alpha in (False, True)]
    for a, b in zip(with_pil, without):
        assert a.dtype == b.dtype == np.float32 and np.array_equal(a, b)
    assert with_pil[0].shape == (20, 30) and with_pil[1].shape == (20, 30, 4)


def test_png_pixels_keep_their_channels():
    rng = np.random.RandomState(10)
    for channels, mode in ((1, "L"), (2, "LA"), (3, "RGB"), (4, "RGBA")):
        from PIL import Image

        px = rng.randint(0, 256, (7, 9, channels)).astype(np.uint8)
        buf = io.BytesIO()
        Image.fromarray(px[..., 0] if channels == 1 else px, mode).save(buf, "PNG")
        from flux2_tpu_torch.io.png import decode_png_pixels

        assert np.array_equal(decode_png_pixels(buf.getvalue()), px)
    assert decode_png(encode_png(px[..., :3])).shape == (7, 9, 3)
