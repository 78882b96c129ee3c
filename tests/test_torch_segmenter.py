"""The port's subject segmenter and subject masks against the JAX package's (CPU).

The committed U-Net (``flux2_tpu_torch/chains/segmenter_weights.safetensors``,
a byte-for-byte copy of JAX's file) gives JAX's logits within 1e-4 at [2, 256,
256, 3] in float32; a symmetric stride-2 pad in place of XLA's "SAME" one
would move them by ~13. ``Segmenter.__call__`` is within one uint8 level of
JAX's (Pillow quantizes the probability); with Pillow hidden the numpy resize
is within 1e-5 of ``jax.image.resize``. ``subject_mask`` equals JAX's to the
bit with the same segmenter callable. JAX's IoU tests run on the port's
model, and ``mask-subject --device cpu`` writes JAX's pixels and JSON line on
JAX's held-out fixture (seed 10001 at 256^2).
"""

import contextlib
import inspect
import io
import json
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from flux2_tpu.chains import segmenter as jseg
from flux2_tpu.chains import subject_mask as jsm
from flux2_tpu.cli import main as jcli
from flux2_tpu.utils import native as jnative
from flux2_tpu_torch.chains import segmenter as tseg
from flux2_tpu_torch.chains import subject_mask as tsm
from flux2_tpu_torch.cli import main as tcli
from flux2_tpu_torch.io.png import decode_png, encode_png, to_u8
from flux2_tpu_torch.utils import native as tnative

LOGIT_TOL = 1e-4
LEVEL = 1.0 / 255 + 1e-6


@pytest.fixture(scope="module")
def models():
    """(JAX's Segmenter, the port's on the CPU), both on the committed weights."""
    return jseg.load_default(), tseg.load_default("cpu")


def _nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()


def test_weights_are_a_byte_copy_of_jax():
    with open(jseg.WEIGHTS_FILE, "rb") as a, open(tseg.WEIGHTS_FILE, "rb") as b:
        assert a.read() == b.read()
    assert tseg.WEIGHTS_FILE.endswith("flux2_tpu_torch/chains/segmenter_weights.safetensors")


def test_parameter_names_and_count_equal_jax(models):
    jmodel, tmodel = models
    flat = {}

    def walk(node, prefix):
        for k, v in node.items():
            key = f"{prefix}.{k}" if prefix else k
            walk(v, key) if isinstance(v, dict) else flat.__setitem__(key, np.asarray(v).shape)

    walk(jmodel.params, "")
    port = {k: tuple(v.shape) for k, v in tmodel.model.state_dict().items()}
    assert set(port) == set(flat) and sum(np.prod(s) for s in port.values()) == sum(np.prod(s) for s in flat.values())
    for k, shape in flat.items():  # kernels HWIO in JAX, OIHW in the port
        assert port[k] == ((shape[3], shape[2], shape[0], shape[1]) if k.endswith(".kernel") else shape)


@pytest.mark.parametrize("pad", ["same", "symmetric"])
def test_logits_equal_jax(pad, models, monkeypatch):
    """[2, 256, 256, 3] through both U-Nets; with the stride-2 convs padded 1
    on every side (``nn.Conv2d(padding=1)``'s choice) the logits move far past
    the tolerance: the test sees the asymmetric pad."""
    jmodel, tmodel = models
    x = np.random.RandomState(0).rand(2, 256, 256, 3).astype(np.float32)
    ref = np.asarray(jseg.forward(jmodel.params, jnp.asarray(x)))
    if pad == "symmetric":
        monkeypatch.setattr(tseg._Conv, "forward", lambda self, h, stride=1: torch.nn.functional.conv2d(
            h, self.kernel, self.bias, stride=stride, padding=self.kernel.shape[2] // 2))
    with torch.inference_mode():
        got = tmodel.model(_nchw(x)).numpy()
    assert got.shape == ref.shape == (2, 256, 256)
    err = float(np.max(np.abs(got - ref)))
    assert err <= LOGIT_TOL if pad == "same" else err > 1.0, err


@pytest.mark.parametrize("c", [24, 48, 160])
def test_group_norm_equals_jax(c):
    """min(8, c) groups over (h, w, c // g), biased variance, rsqrt(var + 1e-5): at c = 24, 8 groups of 3."""
    rng = np.random.RandomState(c)
    x = (rng.randn(2, 16, 12, c) * 3 + 1).astype(np.float32)
    p = {"scale": jnp.asarray(rng.randn(c).astype(np.float32)), "bias": jnp.asarray(rng.randn(c).astype(np.float32))}
    ref = np.asarray(jseg._gn(p, jnp.asarray(x)))
    norm = tseg._GroupNorm(c)
    norm.scale.data, norm.bias.data = (torch.from_numpy(np.array(p[k])) for k in ("scale", "bias"))
    with torch.inference_mode():
        got = norm(_nchw(x)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)


def test_nearest_upsampling_equals_jax():
    x = np.random.RandomState(1).randn(1, 5, 7, 3).astype(np.float32)
    ref = np.asarray(jseg._upsample2(jnp.asarray(x)))
    got = _nchw(x).repeat_interleave(2, dim=2).repeat_interleave(2, dim=3).permute(0, 2, 3, 1).numpy()
    assert np.array_equal(got, ref)


@pytest.mark.parametrize("hw", [(300, 200), (1024, 1024)], ids=["300x200", "1024x1024"])
def test_segmenter_call_within_one_level_of_jax(hw, models):
    jmodel, tmodel = models
    image = np.random.RandomState(hw[0]).rand(*hw, 3).astype(np.float32)
    ref, got = jmodel(image), tmodel(image)
    assert got.shape == ref.shape == hw and got.dtype == np.float32
    assert float(np.max(np.abs(got - ref))) <= LEVEL


@pytest.mark.parametrize("shape,out", [((300, 200, 3), (256, 256)), ((256, 256, 1), (1024, 700)),
                                       ((97, 513, 3), (256, 256))], ids=["down", "up", "mixed"])
def test_resize_without_pillow_equals_jax_image_resize(shape, out, monkeypatch):
    monkeypatch.setitem(sys.modules, "PIL", None)
    image = np.random.RandomState(sum(shape)).rand(*shape).astype(np.float32)
    ref = jseg._resize_np(image, *out)  # JAX's fallback: jax.image.resize(..., "bilinear")
    got = tseg._resize_np(image, *out)
    assert got.shape == ref.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)
    assert tseg.resize_path() == "numpy"


def test_resize_with_pillow_equals_jax(models):
    image = np.random.RandomState(5).rand(300, 200, 3).astype(np.float32)
    assert np.array_equal(tseg._resize_np(image, 256, 256), jseg._resize_np(image, 256, 256))
    prob = np.random.RandomState(6).rand(256, 256, 1).astype(np.float32)
    assert np.array_equal(tseg._resize_np(prob, 300, 200), jseg._resize_np(prob, 300, 200))
    assert tseg.resize_path() == "Pillow"


def _numpy_segmenter(image: np.ndarray) -> np.ndarray:
    """A fixed segmenter callable: a soft disc plus the image's red channel."""
    h, w = image.shape[:2]
    yy, xx = np.mgrid[0:h, 0:w]
    disc = 1.0 - np.hypot((yy - h / 2) / (h / 3), (xx - w / 2) / (w / 3))
    return np.clip(disc + 0.3 * image[..., 0] - 0.15, 0.0, 1.0)


@pytest.mark.parametrize("path", ["native", "numpy"])
@pytest.mark.parametrize("dilation,ramp", [(0, 0), (8, 16), (3, 0), (0, 5)])
@pytest.mark.parametrize("invert", [True, False], ids=["change_scene", "keep_subject"])
def test_subject_mask_equals_jax(path, dilation, ramp, invert, monkeypatch):
    if path == "numpy":
        monkeypatch.setattr(jnative, "_load", lambda: None)
        monkeypatch.setattr(tnative, "_load", lambda: None)
    image = np.random.RandomState(7).rand(90, 70, 3).astype(np.float32)
    kwargs = dict(segmenter=_numpy_segmenter, threshold=0.45, dilation_px=dilation, ramp_px=ramp,
                  invert_for_change_scene=invert)
    got, ref = tsm.subject_mask(image, **kwargs), jsm.subject_mask(image, **kwargs)
    assert got.dtype == ref.dtype and np.array_equal(got, ref)


def test_saliency_and_morphology_equal_jax():
    image = np.random.RandomState(8).rand(40, 56, 3).astype(np.float32)
    assert np.array_equal(tsm.saliency_foreground(image), jsm.saliency_foreground(image))
    mask = (np.random.RandomState(9).rand(30, 20) > 0.8).astype(np.float32)
    assert np.array_equal(tsm._dilate(mask, 3), jsm._dilate(mask, 3))
    assert np.array_equal(tsm._inward_ramp(mask, 4), jsm._inward_ramp(mask, 4))


def test_synth_composite_and_iou_equal_jax():
    for seed, size in ((5, 256), (11, 96)):
        got = tseg.synth_composite(np.random.RandomState(seed), size)
        ref = jseg.synth_composite(np.random.RandomState(seed), size)
        assert all(np.array_equal(a, b) and a.dtype == b.dtype for a, b in zip(got, ref))
    a, b = np.random.RandomState(1).rand(20, 20), np.random.RandomState(2).rand(20, 20)
    assert tseg.iou(a, b) == jseg.iou(a, b) and tseg.iou(a, b, 0.3) == jseg.iou(a, b, 0.3)
    assert tseg.iou(np.zeros((4, 4)), np.zeros((4, 4))) == 1.0


def test_trained_model_beats_heuristic_iou(models):
    """JAX's test on the port's model: held-out fixtures (seeds >= 10000), the
    model's mean IoU beats the heuristic's by 0.1 and passes 0.6."""
    _, model = models
    rng = np.random.RandomState(10_000)
    ious_model, ious_heur = [], []
    for _ in range(16):
        img, mask = tseg.synth_composite(rng)
        ious_model.append(tseg.iou(model(img), mask))
        ious_heur.append(tseg.iou(tsm.saliency_foreground(img), mask))
    m, h = float(np.mean(ious_model)), float(np.mean(ious_heur))
    assert m > h + 0.1, f"model IoU {m:.3f} vs heuristic {h:.3f}"
    assert m > 0.6, f"model IoU {m:.3f}"


def test_subject_mask_uses_model_by_default(monkeypatch):
    monkeypatch.setattr(tsm, "_DEFAULT_SEGMENTERS", {})
    img, mask = tseg.synth_composite(np.random.RandomState(10_001))
    out = tsm.subject_mask(img, dilation_px=0, ramp_px=0, invert_for_change_scene=False, device="cpu")
    assert tseg.iou(out, mask) > 0.5
    assert isinstance(tsm._DEFAULT_SEGMENTERS["cpu"], tseg.Segmenter)
    assert tsm.default_segmenter("cpu") is tsm._DEFAULT_SEGMENTERS["cpu"]  # loaded once


def test_default_device_is_the_card():
    assert inspect.signature(tsm.default_segmenter).parameters["device"].default == "cuda"
    assert inspect.signature(tsm.subject_mask).parameters["device"].default == "cuda"
    assert inspect.signature(tseg.load_default).parameters["device"].default == "cuda"
    assert tcli.parse_args(["mask-subject", "--image", "x.png"]).device == "cuda"


def test_missing_weights_fall_back_to_the_heuristic(monkeypatch, tmp_path):
    monkeypatch.setattr(tseg, "WEIGHTS_FILE", str(tmp_path / "none.safetensors"))
    monkeypatch.setattr(tsm, "_DEFAULT_SEGMENTERS", {})
    assert tsm.default_segmenter("cpu") is None
    image = np.random.RandomState(3).rand(32, 32, 3).astype(np.float32)
    assert np.array_equal(tsm.subject_mask(image, device="cpu"), jsm.subject_mask(image, jsm.saliency_foreground))


def test_save_weights_round_trips_to_jax_layout(models, tmp_path):
    _, tmodel = models
    path = str(tmp_path / "w.safetensors")
    tseg.save_weights(tmodel.model, path)
    from flux2_tpu.io import safetensors_io as jst

    saved, committed = jst.load_file(path), jst.load_file(tseg.WEIGHTS_FILE)
    assert set(saved) == set(committed)
    assert all(np.array_equal(saved[k], committed[k]) for k in committed)


@pytest.mark.parametrize("flags", [[], ["--keep-scene", "--dilation", "2", "--ramp", "4", "--threshold", "0.4"]],
                         ids=["defaults", "keep_scene"])
def test_mask_subject_command_equals_jax(flags, tmp_path, monkeypatch):
    """``mask-subject --device cpu`` through cli.main against JAX's
    ``cmd_mask_subject`` on JAX's held-out fixture written as a PNG: the same
    pixels and lines (the one test here that jits JAX's U-Net through its CLI)."""
    monkeypatch.setattr(tsm, "_DEFAULT_SEGMENTERS", {})
    image, _ = tseg.synth_composite(np.random.RandomState(10_001))
    src = tmp_path / "in.png"
    src.write_bytes(encode_png(to_u8(image)))
    lines = {}
    for name, main, extra in (("port", tcli.main, ["--device", "cpu"]), ("jax", jcli.main, [])):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert main(["mask-subject", "--image", str(src), "-o", str(tmp_path / f"{name}.png"), *flags,
                         *extra]) == 0
        lines[name] = buf.getvalue().replace(str(tmp_path / f"{name}.png"), "OUT").splitlines()
    assert lines["port"] == lines["jax"]
    report = json.loads(lines["port"][-1])
    assert report["segmenter"] == "unet" and report["convention"] == "white = regenerate"
    got = decode_png((tmp_path / "port.png").read_bytes())
    with Image.open(tmp_path / "jax.png") as im:
        assert np.array_equal(got, np.asarray(im.convert("RGB")))
    assert len(np.unique(got)) > 2  # the ramp: levels between black and white
