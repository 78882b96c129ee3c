"""The port's small subcommands and API gaps against the JAX package's (CPU).

``info`` (the model lines), ``training-control`` (the sentinel files),
``beacons`` and the ``--beacon`` manifest of ``t2i``, the global
``--models-dir`` / ``--token`` / ``--beacon`` flags (the environment JAX's
``main`` sets), ``download`` with ``huggingface_hub.snapshot_download`` patched
in both packages (the same calls, and JAX's RuntimeError without the package;
no network), the CLI's PNG writer against JAX's ``_save_image`` on images off
the 1/255 grid (F5), ``Flux2Pipeline.decode_latents`` against JAX's on the tiny
VAE in float32, and ``GenerationResult.latents`` as a host array.
"""

import contextlib
import dataclasses
import io
import json
import os
import subprocess
import sys
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from flux2_tpu.cli import main as jcli
from flux2_tpu.models.flux2 import config as jcfg
from flux2_tpu.pipeline.pipeline import Flux2Pipeline as JaxPipeline
from flux2_tpu.utils import beacon as jbeacon
from flux2_tpu_torch.cli import main as tcli
from flux2_tpu_torch.io.jax_params import vae_from_jax
from flux2_tpu_torch.io.png import decode_png
from flux2_tpu_torch.models.flux2.config import Flux2Model, Flux2TransformerConfig
from flux2_tpu_torch.models.flux2.vae import VAEConfig
from flux2_tpu_torch.models.text_encoders.config import TINY_DECODER
from flux2_tpu_torch.pipeline.pipeline import Flux2Pipeline
from flux2_tpu_torch.utils import beacon as tbeacon

from tests.test_torch_vae_encoder import CONFIGS, _params

ENV = ("FLUX2_MODELS_DIR", "HF_TOKEN", "FLUX2_RUNTIME_BEACON")


@pytest.fixture
def clean_env(monkeypatch, tmp_path):
    """The flags' variables unset (restored after), the beacon dir in tmp_path."""
    for name in ENV:
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("FLUX2_BEACON_DIR", str(tmp_path / "beacons"))
    monkeypatch.setenv("HF_HOME", str(tmp_path / "hf"))
    return tmp_path


def _run(main, argv) -> list:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(argv) == 0
    return buf.getvalue().splitlines()


def _env() -> dict:
    return {name: os.environ.get(name) for name in ENV}


# -- info -----------------------------------------------------------------------------------------


def test_info_lines_equal_jax(clean_env):
    port = _run(tcli.main, ["info", "--models-dir", str(clean_env / "models")])
    ref = _run(jcli.main, ["info", "--models-dir", str(clean_env / "models")])
    assert port[1:] == ref[1:] and len(port) == 2 + len(jcfg.Flux2Model)
    assert port[1] == f"models dir: {clean_env / 'models'}"
    assert port[0] == "flux2-tpu — backend: cpu, devices: 1"  # no CUDA on this host


def test_info_backend_line_names_cuda_devices(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert tcli._backend_line() == "cuda, devices: 4"


# -- training-control ------------------------------------------------------------------------------


def _tree(root) -> dict:
    return {os.path.relpath(os.path.join(d, f), root): open(os.path.join(d, f), "rb").read()
            for d, _, files in os.walk(root) for f in files}


def test_training_control_sentinels_equal_jax(tmp_path, monkeypatch):
    """The same actions in two directories: the same lines, files and bytes
    (a sentinel holds the time it was written: the clock is frozen)."""
    import time

    monkeypatch.setattr(time, "time", lambda: 1234.5)
    port_dir, jax_dir = tmp_path / "port", tmp_path / "jax"
    port_dir.mkdir()
    jax_dir.mkdir()
    for action in ("pause", "checkpoint", "resume", "stop", "pause", "resume"):
        port = _run(tcli.main, ["training-control", action, "--output-dir", str(port_dir)])
        ref = _run(jcli.main, ["training-control", action, "--output-dir", str(jax_dir)])
        assert [line.replace(str(port_dir), "D") for line in port] == [line.replace(str(jax_dir), "D") for line in ref]
        assert _tree(port_dir) == _tree(jax_dir)
    assert len(_tree(port_dir)) == 2  # the checkpoint and stop sentinels; the pause was cleared


# -- beacons ------------------------------------------------------------------------------------------


def _dead_pid() -> int:
    proc = subprocess.Popen([sys.executable, "-c", "pass"])
    proc.wait()
    return proc.pid


def _manifests(directory, dead: int) -> None:
    os.makedirs(directory, exist_ok=True)
    for pid, task, step in ((os.getpid(), "generate", 2), (dead, "train", 7)):
        with open(os.path.join(directory, f"{pid}-abcd1234.json"), "w") as f:
            json.dump({"pid": pid, "task": task, "model": "klein-4b", "phase": "denoising", "step": step,
                       "total_steps": 4}, f)


def test_beacons_equal_jax(clean_env):
    directory, dead = os.environ["FLUX2_BEACON_DIR"], _dead_pid()
    _manifests(directory, dead)
    port = _run(tcli.main, ["beacons"])
    _manifests(directory, dead)
    ref = _run(jcli.main, ["beacons"])
    assert port == ref == ["gc removed 1 stale manifest(s); 1 active:",
                           f"  pid {os.getpid()} generate klein-4b denoising step 2/4"]


def test_runtime_beacon_manifests_equal_jax(clean_env):
    """The same task written by both packages' RuntimeBeacon: the same keys and
    values but the beacon's id and clock; removed at the end."""
    seen = []
    for mod in (tbeacon, jbeacon):
        with mod.RuntimeBeacon("generate", model="klein-4b", force=True) as b:
            b.update(phase="denoising", step=1, total_steps=4)
            (name,) = os.listdir(mod.beacon_dir())
            with open(os.path.join(mod.beacon_dir(), name)) as f:
                seen.append({k: v for k, v in json.load(f).items() if k not in ("id", "started_at", "updated_at")})
        assert not [n for n in os.listdir(mod.beacon_dir()) if n.endswith(".json")]
    assert seen[0] == seen[1] and seen[0]["runtime"] == "flux2-tpu" and seen[0]["pid"] == os.getpid()


class _Watching:
    """Forwards to the pipeline; ``generate`` records the beacon manifests present while it runs."""

    def __init__(self, pipe):
        self._pipe, self.manifests = pipe, []

    def __getattr__(self, name):
        return getattr(self._pipe, name)

    def generate(self, **kwargs):
        directory = tbeacon.beacon_dir()
        for name in os.listdir(directory):
            with open(os.path.join(directory, name)) as f:
                self.manifests.append(json.load(f))
        return self._pipe.generate(**kwargs)


def _tiny_pipe() -> Flux2Pipeline:
    tc = Flux2TransformerConfig(num_layers=1, num_single_layers=1, num_attention_heads=4, attention_head_dim=128,
                                joint_attention_dim=192, guidance_embeds=False)
    vc = VAEConfig(block_out_channels=(8, 8, 8, 8), layers_per_block=1, norm_num_groups=4)
    return tcli.build_pipeline(types.SimpleNamespace(model="klein-4b", random_init=True), "cpu",
                               torch.Generator().manual_seed(0), transformer_config=tc, vae_config=vc,
                               encoder_config=dataclasses.replace(TINY_DECODER, num_hidden_layers=28, vocab_size=600))


def test_t2i_beacon_flag_writes_a_manifest_while_denoising(clean_env, monkeypatch):
    pipe = _Watching(_tiny_pipe())
    monkeypatch.setattr(tcli, "build_pipeline", lambda args, device: pipe)
    out = str(clean_env / "x.png")
    _run(tcli.main, ["t2i", "--beacon", "--device", "cpu", "--width", "32", "--height", "32", "--steps", "2",
                     "-o", out])
    assert os.environ["FLUX2_RUNTIME_BEACON"] == "1"
    (m,) = pipe.manifests
    assert (m["task"], m["model"], m["phase"], m["step"], m["total_steps"]) == ("generate", "klein-4b", "denoising",
                                                                               0, 2)
    assert not [n for n in os.listdir(tbeacon.beacon_dir()) if n.endswith(".json")]  # ended with the command
    assert decode_png(open(out, "rb").read()).shape == (32, 32, 3)


def test_random_init_pipeline_names_its_encoder():
    assert _tiny_pipe().text_encoder_name == "qwen3-4b"


# -- the global flags' environment --------------------------------------------------------------------


@pytest.mark.parametrize("argv", [
    ["info", "--models-dir", "MD"],
    ["info", "--beacon"],
    ["download", "--token", "secret", "--models-dir", "MD", "--model", "klein-9b"],
], ids=["models_dir", "beacon", "token"])
def test_flags_set_the_environment_as_jax(argv, clean_env, monkeypatch):
    _fake_hub(monkeypatch, [])
    argv = [a.replace("MD", str(clean_env / "models")) for a in argv]
    _run(tcli.main, argv)
    port = _env()
    for name in ENV:
        monkeypatch.delenv(name, raising=False)
    _run(jcli.main, argv)
    assert port == _env() and any(port.values())


# -- download -----------------------------------------------------------------------------------------


def _fake_hub(monkeypatch, calls: list) -> None:
    hub = types.ModuleType("huggingface_hub")
    hub.snapshot_download = lambda repo_id, **kwargs: calls.append((repo_id, kwargs))
    monkeypatch.setitem(sys.modules, "huggingface_hub", hub)


@pytest.mark.parametrize("model", [m.value for m in Flux2Model])
@pytest.mark.parametrize("fmt", ["bf16", "w8a8", "qint8"])
def test_download_calls_equal_jax(model, fmt, clean_env, monkeypatch):
    monkeypatch.setenv("FLUX2_MODELS_DIR", str(clean_env / "models"))
    calls = {"port": [], "jax": []}
    argv = ["download", "--model", model, "--quantization", fmt, "--token", "t0k"]
    _fake_hub(monkeypatch, calls["port"])
    port = _run(tcli.main, argv)
    _fake_hub(monkeypatch, calls["jax"])
    ref = _run(jcli.main, argv)
    assert port == ref and calls["port"] == calls["jax"] and len(calls["port"]) == 3
    assert all(kw["token"] == "t0k" for _, kw in calls["port"])


def test_download_without_huggingface_hub_raises_as_jax(clean_env, monkeypatch):
    monkeypatch.setitem(sys.modules, "huggingface_hub", None)
    for main in (tcli.main, jcli.main):
        with pytest.raises(RuntimeError, match="^huggingface_hub not available$"):
            _run(main, ["download"])


# -- F5: the CLI's PNG writer -------------------------------------------------------------------------


def _jax_written(image: np.ndarray, path) -> np.ndarray:
    with contextlib.redirect_stdout(io.StringIO()):
        jcli._save_image(image, str(path))
    with Image.open(str(path)) as im:
        return np.asarray(im.convert("RGB"))


@pytest.mark.parametrize("kind", ["ramp", "overshoot"])
def test_save_png_writes_jax_pixels(kind, tmp_path, capsys):
    """Off the 1/255 grid JAX truncates; the port's writer must too (F5: it
    rounded, and a ramp moved about half its pixels by one level)."""
    if kind == "ramp":
        image = np.linspace(0.0, 1.0, 64 * 64 * 3, dtype=np.float32).reshape(64, 64, 3)
    else:
        image = (np.random.RandomState(6).rand(33, 47, 3) * 1.4 - 0.2).astype(np.float32)
    tcli._save_png(image, str(tmp_path / "port.png"))
    assert capsys.readouterr().out == f"saved {tmp_path / 'port.png'}\n"
    got = decode_png(open(tmp_path / "port.png", "rb").read())
    want = _jax_written(image, tmp_path / "jax.png")
    assert np.array_equal(got, want)
    rounded = np.rint(np.clip(image, 0, 1) * 255).astype(np.uint8)
    assert (rounded != want).mean() > 0.3  # what the repaired writer would have written


# -- API gaps: decode_latents and GenerationResult.latents ---------------------------------------------


@pytest.mark.parametrize("hw", [(64, 64), (32, 96)], ids=["64x64", "32x96"])
def test_decode_latents_equals_jax(hw):
    params, config = _params("tiny"), CONFIGS["tiny"]
    h, w = hw
    lat = np.random.RandomState(h + w).randn(1, (h // 16) * (w // 16), 128).astype(np.float32)
    jpipe = JaxPipeline(model=jcfg.Flux2Model.KLEIN_4B, transformer_params=None, transformer_config=None,
                        vae_params=params, vae_config=config, vae_compute_dtype=jnp.float32)
    tpipe = Flux2Pipeline(model=Flux2Model.KLEIN_4B, transformer=None, vae=vae_from_jax(params, config),
                          device=torch.device("cpu"), vae_compute_dtype=torch.float32)
    ref = np.asarray(jpipe.decode_latents(jnp.asarray(lat), h, w))
    got = tpipe.decode_latents(torch.from_numpy(lat), h, w)
    assert got.dtype == torch.float32 and tuple(got.shape) == ref.shape == (1, h, w, 3)
    assert float(np.max(np.abs(got.numpy() - ref))) <= 1e-4
    u8 = tpipe.decode_latents_u8(torch.from_numpy(lat), h, w).numpy()
    assert np.array_equal(u8, np.clip(got.numpy() * 255.0 + 0.5, 0, 255).astype(np.uint8))


def test_generation_result_latents_is_a_host_array():
    pipe = _tiny_pipe()
    res = pipe.generate(embeddings=torch.zeros(1, 4, 192), height=32, width=32, num_steps=1, seed=0)
    assert isinstance(res.latents_device, torch.Tensor) and isinstance(res.latents, np.ndarray)
    assert res.latents.dtype == np.float32 and np.array_equal(res.latents, res.latents_device.numpy())


@pytest.mark.parametrize("argv", [
    ["info"], ["info", "--models-dir", "M", "--beacon"], ["beacons"],
    ["download"], ["download", "--model", "klein-9b-kv", "--quantization", "int4", "--token", "t", "--models-dir", "M"],
    ["training-control", "checkpoint", "--output-dir", "D"],
    ["mask-subject", "--image", "a.png"],
    ["mask-subject", "--image", "a.png", "-o", "m.png", "--threshold", "0.3", "--dilation", "2", "--ramp", "5",
     "--keep-scene", "--quiet"],
    ["t2i", "--token", "t", "--beacon", "--models-dir", "M"],
], ids=["info", "info_flags", "beacons", "download", "download_flags", "training_control", "mask_subject",
        "mask_subject_flags", "t2i_global_flags"])
def test_small_command_flags_equal_jax(argv):
    port, ref = vars(tcli.parse_args(argv)), vars(jcli.build_parser().parse_args(argv))
    shared = set(port) & set(ref) - {"fn"}
    assert set(ref) - {"fn"} - set(port) <= {"upsample", "interpret", "lora", "shard", "context_parallel", "dcn",
                                             "dequantize_runtime"}
    assert {k: port[k] for k in shared} == {k: ref[k] for k in shared}
    assert set(port) - set(ref) <= {"command", "device"}


# -- python -m flux2_tpu_torch.cli.encoders (JAX's flux-encoders) ------------------------------------


@pytest.fixture
def one_thread():
    """torch on one thread for the encoder commands' many tiny ops (beside the
    suite's other workers a thread a core oversubscribes the host)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def encoder_tree(tmp_path_factory):
    """The tiny checkpoint tree of test_torch_checkpoints (its HF Qwen3 with the dev tokenizer)."""
    from tests.test_torch_checkpoints import write_tiny_tree

    return write_tiny_tree(tmp_path_factory.mktemp("enc_tree"))["text_encoder"]


def _encoders_both(argv: list, stdin: str = None) -> tuple:
    """(port lines, JAX lines) of one flux-encoders command; the port on the CPU."""
    from flux2_tpu.cli import encoders as jenc
    from flux2_tpu_torch.cli import encoders as tenc

    lines = []
    for main, extra in ((tenc.main, ["--device", "cpu"] if argv[0] != "models" else []), (jenc.main, [])):
        if stdin is not None:
            sys.stdin = io.StringIO(stdin)
        try:
            lines.append(_run(main, argv + extra))
        finally:
            sys.stdin = sys.__stdin__
    return tuple(lines)


def test_encoders_models_lines_equal_jax(clean_env):
    port, ref = _encoders_both(["models"])
    assert port == ref and any("mistral-small-3.2" in line for line in port)


@pytest.mark.parametrize("command", [
    ["generate", "--prompt", "a red fox", "--max-tokens", "3", "--temperature", "0"],
    ["upsample", "--prompt", "a red fox"],
    ["chat", "--max-tokens", "3", "--temperature", "0"],
], ids=["generate", "upsample", "chat"])
def test_encoders_text_commands_print_as_jax(command, encoder_tree, one_thread, monkeypatch):
    """Greedy generate, upsample and chat print JAX's lines. upsample samples
    ``GenerateParameters.upsampling()`` (256 tokens at 0.7, whatever
    --max-tokens says, as JAX's); both packages' preset is patched to 3
    greedy tokens here. The encoder is the tiny tree's Qwen3, bf16 in both."""
    from flux2_tpu.models.text_encoders import generation as jgen
    from flux2_tpu_torch.models.text_encoders import generation as tgen

    for cls in (jgen.GenerateParameters, tgen.GenerateParameters):
        monkeypatch.setattr(cls, "upsampling", classmethod(lambda c: c(max_tokens=3, temperature=0.0)))
    argv = [command[0], "--family", "qwen3-4b", "--encoder-dir", encoder_tree, *command[1:]]
    port, ref = _encoders_both(argv, stdin="hello there\n\n" if command[0] == "chat" else None)
    assert port == ref and port


def test_encoders_embed_and_compare_as_jax(encoder_tree, tmp_path, one_thread):
    out, jout = str(tmp_path / "p.npy"), str(tmp_path / "j.npy")
    from flux2_tpu.cli import encoders as jenc
    from flux2_tpu_torch.cli import encoders as tenc

    port = _run(tenc.main, ["embed", "--encoder-dir", encoder_tree, "--prompt", "a red fox", "-o", out,
                            "--device", "cpu"])
    ref = _run(jenc.main, ["embed", "--encoder-dir", encoder_tree, "--prompt", "a red fox", "-o", jout])
    # numpy has no bfloat16 without ml_dtypes: the port saves the bf16 embeddings as float32, exactly
    assert json.loads(port[0]) == {**json.loads(ref[0]), "output": out, "dtype": "float32"}
    assert json.loads(ref[0])["dtype"] == "bfloat16"
    a, b = np.load(out), np.load(jout)  # JAX's bf16 file loads as raw 2-byte records: widen them to float32
    b = (np.frombuffer(b.tobytes(), np.uint16).astype(np.uint32) << 16).view(np.float32).reshape(b.shape)
    assert a.dtype == np.float32 and a.shape == (1, 512, 192)
    # bf16 in both, rounded at other points by XLA and torch over 28 layers: 2.23e-2 measured
    assert float(np.linalg.norm(a - b) / np.linalg.norm(b)) <= 5e-2
    port, ref = _encoders_both(["compare", "--encoder-dir", encoder_tree, "--encoder-dir-b", encoder_tree,
                                "--prompt", "a red fox"])
    stats, jstats = json.loads("\n".join(port)), json.loads("\n".join(ref))
    assert stats.keys() == jstats.keys() and stats["cosine_similarity"] == pytest.approx(1.0)
    assert stats["max_abs_diff"] == jstats["max_abs_diff"] == 0.0


def test_encoders_vision_and_a_missing_dir_exit(capsys, tmp_path):
    """Without --encoder-dir ``vision`` exits with JAX's message, as the text commands do."""
    from flux2_tpu.cli import encoders as jenc
    from flux2_tpu_torch.cli import encoders as tenc
    from flux2_tpu_torch.models.text_encoders import facade

    image = str(tmp_path / "a.png")
    Image.fromarray(np.zeros((28, 28, 3), np.uint8)).save(image)
    facade.shared.unload_vlm()
    messages = []
    for main in (tenc.main, jenc.main):
        with pytest.raises(SystemExit) as err:
            main(["vision", "--image", image])
        messages.append(str(err.value))
    assert messages[0] == messages[1] and "pass --encoder-dir pointing at a VLM checkpoint" in messages[0]
    with pytest.raises(SystemExit, match="pass --encoder-dir"):
        tenc.main(["generate", "--prompt", "x"])


@pytest.mark.parametrize("second", [False, True], ids=["image", "image2"])
def test_encoders_vision_prints_as_jax(second, tmp_path, one_thread, monkeypatch):
    """``vision --image`` (the sampled description, JAX's uniforms injected)
    and ``vision --image2`` (the comparison JSON) on a tiny Qwen3.5-VL
    checkpoint print JAX's lines; both loaders in f32 here."""
    import functools

    from flux2_tpu.models.text_encoders import facade as jfacade
    from flux2_tpu_torch.io import weight_mapping as twm
    from flux2_tpu_torch.models.text_encoders import facade
    from flux2_tpu_torch.models.text_encoders import generation as tgen
    from tests.test_torch_generation import jax_uniforms
    from tests.test_torch_vlm_loader import write_tiny_qwen35_vl

    vl_dir = write_tiny_qwen35_vl(tmp_path / "vl")
    for name in ("load_qwen35", "load_qwen35_vision"):
        monkeypatch.setattr(twm, name, functools.partial(getattr(twm, name), dtype=torch.float32))
    monkeypatch.setattr(jfacade, "_bf16", lambda tree: tree)
    draws = iter(jax_uniforms(0, 128))
    monkeypatch.setattr(tgen, "_draw_uniform", lambda generator: torch.tensor(next(draws), dtype=torch.float32))
    paths = []
    for seed in (40, 41):
        paths.append(str(tmp_path / f"{seed}.png"))
        Image.fromarray((np.random.RandomState(seed).rand(64, 48, 3) * 255).astype(np.uint8)).save(paths[-1])
    argv = ["vision", "--encoder-dir", vl_dir, "--image", paths[0], *(["--image2", paths[1]] if second else [])]
    for shared in (facade.shared, jfacade.shared):
        shared.unload_vlm()
    try:
        port, ref = _encoders_both(argv)
    finally:
        for shared in (facade.shared, jfacade.shared):
            shared.unload_vlm()
    assert port == ref and port
    if second:
        assert set(json.loads("\n".join(port))) == {"scene_score", "scene_reason", "style_score", "style_reason"}
