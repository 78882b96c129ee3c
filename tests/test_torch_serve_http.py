"""The port's HTTP layer (``flux2_tpu_torch/serve.py``) against the JAX
package's, on the CPU.

1. The handlers: one scripted stub server (``_Stub``, duck-typed, raising each
   package's own ``QueueFullError`` / ``ChatUnavailableError`` and the builtin
   ``TimeoutError`` / ``ValueError`` on cue) is served by
   ``flux2_tpu.serve.make_handler`` and by the port's, each on its own
   localhost server. For every route and error the status line, every header
   but ``Date`` and the raw body bytes (the chunked /chat stream, its
   trailer and its in-band error included) must be equal.
2. The port's ``Flux2Server`` on a tiny random port pipeline over HTTP: the
   /generate PNG and JSON pixels equal to ``generate`` written through JAX's
   writer (F5: truncation); 400, 503 and 504; /preview before and after the
   first step, its PNG equal to JAX's ``_png_bytes``; /embed with a fixed
   encoder; ``cancel_all`` over the running batch, and a real cancel mid-run
   with the forwards counted.
3. ``info()`` and ``models()`` against JAX's, on one models dir holding a fake
   repo; ``serve.main``'s parser against JAX's, and ``--tp 2`` refused.

``flux2_tpu/serve.py`` imports no JAX at module level: nothing here compiles.
"""

import base64
import dataclasses
import io
import json
import socket
import threading
import time
import types
from http.server import ThreadingHTTPServer

import numpy as np
import pytest
import torch
from PIL import Image

from flux2_tpu import serve as jserve
from flux2_tpu.models.flux2 import config as jcfg
from flux2_tpu_torch import serve as tserve
from flux2_tpu_torch.io.png import decode_png, to_u8
from flux2_tpu_torch.models.flux2.config import Flux2Model, Flux2TransformerConfig
from flux2_tpu_torch.models.flux2.vae import VAEConfig
from flux2_tpu_torch.pipeline.pipeline import Flux2Pipeline

PACKAGES = {"jax": jserve, "port": tserve}


# -- raw HTTP ---------------------------------------------------------------------------------------


def _raw(port: int, method: str, path: str, body: bytes = None) -> tuple:
    """One request on its own connection (``Connection: close``): (status
    line, headers without Date as (name, value) pairs in order, raw body)."""
    head = f"{method} {path} HTTP/1.1\r\nHost: 127.0.0.1\r\nConnection: close\r\n"
    if body is not None:
        head += f"Content-Type: application/json\r\nContent-Length: {len(body)}\r\n"
    with socket.create_connection(("127.0.0.1", port), timeout=60) as sock:
        sock.sendall(head.encode() + b"\r\n" + (body or b""))
        data = b""
        while True:
            chunk = sock.recv(65536)
            if not chunk:
                break
            data += chunk
    header_block, _, payload = data.partition(b"\r\n\r\n")
    lines = header_block.decode("latin-1").split("\r\n")
    headers = [tuple(h.split(": ", 1)) for h in lines[1:]]
    return lines[0], [h for h in headers if h[0] != "Date"], payload


def _serve(server) -> ThreadingHTTPServer:
    return _serve_with(tserve.make_handler, server)


def _serve_with(make_handler, server) -> ThreadingHTTPServer:
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(server))
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd


def _close(httpd) -> None:
    httpd.shutdown()
    httpd.server_close()


# -- 1. the handlers against JAX's, on a stub server -----------------------------------------------


PREVIEW_PNG = b"\x89PNG\r\n\x1a\nnot-really-a-png"
EMBEDDING = np.random.RandomState(3).randn(1, 5, 7).astype(np.float32)


class _Stub:
    """Duck-typed server: what it answers (or raises) is chosen by the request."""

    def __init__(self, mod, chat: bool):
        self.mod, self.chat_on = mod, chat

    def info(self):
        return {"model": "klein-4b", "backend": "cpu", "devices": 1, "queue_depth": 0}

    def models(self):
        if not self.chat_on:
            raise RuntimeError("inventory failed")
        return {"loaded": {"model": "klein-4b"}, "transformers": [{"model": "dev", "gated": True}]}

    def get_preview(self, pid):
        return {"step": 2, "total": 4, "png": PREVIEW_PNG, "t": 0.0} if pid == "p1" else None

    def generate_png(self, req):
        prompt = req.get("prompt")
        if prompt == "full":
            raise self.mod.QueueFullError("queue full (1 pending); retry later")
        if prompt == "slow":
            raise TimeoutError("generation exceeded timeout_s=1e-06")
        if prompt == "bad":
            raise ValueError("strength must be a number")
        return b"\x89PNG-for-" + prompt.encode()

    def embed(self, prompt):
        if not prompt.strip():
            raise ValueError("prompt must be a non-empty string")
        if prompt == "none":
            raise self.mod.ChatUnavailableError("no text encoder attached")
        if prompt == "boom":
            raise RuntimeError("encoder failed")
        return EMBEDDING

    def chat_available(self):
        return self.chat_on

    def chat(self, messages, *, max_tokens=512, temperature=0.7, seed=0, on_token=None, thinking=False):
        if not isinstance(messages, list) or not messages:
            raise ValueError("messages must be a non-empty list of {role, content}")
        if not self.chat_on:
            raise self.mod.ChatUnavailableError("no text encoder attached")
        for piece in ("Hel", "lo ", "wörld"):
            if on_token is not None:
                on_token(piece)
        if messages[0].get("content") == "fail":
            raise RuntimeError("decoder failed")
        return {"reply": f"Hello wörld ({max_tokens}, {temperature}, {seed}, {thinking})", "tokens": 3,
                "duration_s": 0.5, "tok_per_s": 6.0}


@pytest.fixture(scope="module")
def stub_ports():
    """{(package, chat on): port} for four stub servers, two per package."""
    servers = {(name, chat): _serve_with(mod.make_handler, _Stub(mod, chat))
               for name, mod in PACKAGES.items() for chat in (True, False)}
    yield {key: httpd.server_address[1] for key, httpd in servers.items()}
    for httpd in servers.values():
        _close(httpd)


def _post(payload) -> bytes:
    return json.dumps(payload).encode()


MESSAGES = [{"role": "user", "content": "hi"}]
ROUTES = {
    "health": ("GET", "/health", None, True),
    "info": ("GET", "/info", None, True),
    "models": ("GET", "/models", None, True),
    "models_500": ("GET", "/models", None, False),
    "page": ("GET", "/", None, True),
    "index_html": ("GET", "/index.html", None, True),
    "preview": ("GET", "/preview?id=p1", None, True),
    "preview_404": ("GET", "/preview?id=nope", None, True),
    "get_404": ("GET", "/nowhere", None, True),
    "post_404": ("POST", "/nowhere", _post({}), True),
    "generate_png": ("POST", "/generate", _post({"prompt": "a fox"}), True),
    "generate_json": ("POST", "/generate", _post({"prompt": "a fox", "format": "json"}), True),
    "generate_503": ("POST", "/generate", _post({"prompt": "full"}), True),
    "generate_504": ("POST", "/generate", _post({"prompt": "slow"}), True),
    "generate_400": ("POST", "/generate", _post({"prompt": "bad"}), True),
    "generate_bad_json": ("POST", "/generate", b"{bad json", True),
    "embed_json": ("POST", "/embed", _post({"prompt": "a cat"}), True),
    "embed_npy": ("POST", "/embed", _post({"prompt": "a cat", "format": "npy"}), True),
    "embed_400": ("POST", "/embed", _post({"prompt": "  "}), True),
    "embed_503": ("POST", "/embed", _post({"prompt": "none"}), True),
    "embed_500": ("POST", "/embed", _post({"prompt": "boom"}), True),
    "chat_json": ("POST", "/chat", _post({"messages": MESSAGES, "max_tokens": 4, "seed": 2}), True),
    "chat_stream": ("POST", "/chat", _post({"messages": MESSAGES, "stream": True}), True),
    "chat_stream_error": ("POST", "/chat", _post({"messages": [{"role": "user", "content": "fail"}],
                                                   "stream": True}), True),
    "chat_400": ("POST", "/chat", _post({"messages": []}), True),
    "chat_bad_number": ("POST", "/chat", _post({"messages": MESSAGES, "max_tokens": "many"}), True),
    "chat_503": ("POST", "/chat", _post({"messages": MESSAGES}), False),
    "chat_stream_503": ("POST", "/chat", _post({"messages": MESSAGES, "stream": True}), False),
}


@pytest.mark.parametrize("route", list(ROUTES))
def test_handler_answers_as_jax(route, stub_ports):
    method, path, body, chat = ROUTES[route]
    port_answer = _raw(stub_ports[("port", chat)], method, path, body)
    jax_answer = _raw(stub_ports[("jax", chat)], method, path, body)
    assert port_answer == jax_answer
    status, headers, payload = port_answer
    names = dict(headers)
    if names.get("Transfer-Encoding") == "chunked":
        assert payload.endswith(b"0\r\n\r\n") and b"\x1e" in payload
    else:
        assert int(names["Content-Length"]) == len(payload)  # keep-alive clients need it
    assert status.startswith("HTTP/1.1 ")


def test_chunked_chat_stream_decodes_to_tokens_then_stats(stub_ports):
    """The chunk framing itself: the pieces, then "\\n\\x1e" and the stats JSON."""
    _, _, raw = _raw(stub_ports[("port", True)], "POST", "/chat", _post({"messages": MESSAGES, "stream": True}))
    text, rest = b"", raw
    while True:
        size, _, rest = rest.partition(b"\r\n")
        n = int(size, 16)
        if n == 0:
            assert rest == b"\r\n"
            break
        text, rest = text + rest[:n], rest[n + 2:]
    visible, _, trailer = text.decode().partition("\x1e")
    assert visible == "Hello wörld\n" and json.loads(trailer) == {"tokens": 3, "duration_s": 0.5, "tok_per_s": 6.0}


# -- 2. the port's server on a tiny port pipeline over HTTP ----------------------------------------------


EMB = torch.from_numpy(np.random.RandomState(1).randn(1, 4, 32).astype(np.float32))


def _tiny_pipe() -> Flux2Pipeline:
    tc = Flux2TransformerConfig(num_layers=1, num_single_layers=1, num_attention_heads=1, attention_head_dim=128,
                                joint_attention_dim=32, guidance_embeds=False)
    vc = VAEConfig(block_out_channels=(8, 8, 8, 8), layers_per_block=1, norm_num_groups=4)
    return Flux2Pipeline.from_random(Flux2Model.KLEIN_4B, device="cpu", dtype=torch.float32,
                                     generator=torch.Generator().manual_seed(0), transformer_config=tc,
                                     vae_config=vc)


@pytest.fixture(scope="module")
def pipe():
    return _tiny_pipe()


def _jax_pixels(png: bytes) -> np.ndarray:
    with Image.open(io.BytesIO(png)) as im:
        return np.asarray(im.convert("RGB"))


@pytest.fixture
def served(pipe):
    server = tserve.Flux2Server(pipe, embeddings_fn=lambda prompt: EMB, batch_window_s=0.0)
    httpd = _serve(server)
    yield server, httpd.server_address[1]
    _close(httpd)
    server.shutdown()


REQ = {"prompt": "a fox", "height": 64, "width": 64, "steps": 2, "seed": 5}


@pytest.mark.parametrize("fmt", ["png", "json"])
def test_generate_pixels_equal_jax_writer_of_generate(fmt, pipe, served):
    """F5: the body's pixels equal ``generate``'s image written by JAX's server writer (truncating)."""
    _, port = served
    status, headers, body = _raw(port, "POST", "/generate", _post(dict(REQ, format=fmt)))
    assert status == "HTTP/1.1 200 OK"
    png = body if fmt == "png" else base64.b64decode(json.loads(body)["image_png_base64"])
    res = pipe.generate(embeddings=EMB, height=64, width=64, num_steps=2, seed=5)
    want = _jax_pixels(jserve._png_bytes(res.image))
    assert np.array_equal(decode_png(png), want)


def test_server_png_writers_equal_jax_on_off_grid_images():
    """F5 on images off the 1/255 grid, where rounding and truncating differ:
    ``to_u8`` (every port writer's conversion) against JAX's ``_png_bytes``."""
    ramp = np.linspace(0.0, 1.0, 64 * 48 * 3, dtype=np.float32).reshape(64, 48, 3)
    noisy = np.clip(np.random.RandomState(4).rand(40, 30, 3).astype(np.float32) * 1.2 - 0.1, -0.1, 1.1)
    for image in (ramp, noisy):
        want = _jax_pixels(jserve._png_bytes(image))
        assert np.array_equal(to_u8(image), want)
        assert not np.array_equal(np.rint(np.clip(image, 0, 1) * 255).astype(np.uint8), want)  # rounding differs


def test_preview_pngs_equal_jax_previews():
    """F5 for previews: ``_preview_dispatch`` on seeded latents stores the
    pixels of JAX's ``_png_bytes(packed_to_rgb_preview(...))``."""
    server = tserve.Flux2Server(types.SimpleNamespace(device=torch.device("cpu")))
    server.shutdown()
    lat = np.random.RandomState(8).randn(2, 24, 128).astype(np.float32) * 1.3
    server._preview_dispatch([(0, "a"), (1, "b")], 64, 96, 4, 3, lat)
    for row, pid in ((0, "a"), (1, "b")):
        entry = server.get_preview(pid)
        assert (entry["step"], entry["total"]) == (3, 4)
        want = _jax_pixels(jserve._png_bytes(jserve.packed_to_rgb_preview(lat[row], 64, 96)))
        assert decode_png(entry["png"]).shape == (8, 12, 3) and np.array_equal(decode_png(entry["png"]), want)


def test_preview_route_before_and_after_the_first_step(pipe, served):
    server, port = served
    status, _, body = _raw(port, "GET", "/preview?id=pv-1")
    assert status == "HTTP/1.1 404 Not Found" and json.loads(body) == {"error": "no preview yet"}
    status, _, _ = _raw(port, "POST", "/generate", _post(dict(REQ, preview_id="pv-1")))
    assert status == "HTTP/1.1 200 OK"
    status, headers, body = _raw(port, "GET", "/preview?id=pv-1")
    headers = dict(headers)
    assert status == "HTTP/1.1 200 OK" and (headers["X-Step"], headers["X-Total-Steps"]) == ("2", "2")
    assert body == server.get_preview("pv-1")["png"] and decode_png(body).shape == (8, 8, 3)


def test_bad_json_is_400_and_the_server_keeps_serving(served):
    _, port = served
    status, _, body = _raw(port, "POST", "/generate", b"{bad json")
    assert status == "HTTP/1.1 400 Bad Request" and json.loads(body)["error"].startswith("JSONDecodeError")
    status, _, _ = _raw(port, "POST", "/generate", _post(REQ))
    assert status == "HTTP/1.1 200 OK"


def test_full_queue_503_and_timeout_504(pipe):
    """On a server whose worker is stopped: timeout_s=1e-6 answers 504 and the
    abandoned request keeps the one queue slot, so the next answers 503."""
    server = tserve.Flux2Server(pipe, embeddings_fn=lambda prompt: EMB, max_queue=1)
    server.shutdown()
    httpd = _serve(server)
    try:
        port = httpd.server_address[1]
        status, _, body = _raw(port, "POST", "/generate", _post(dict(REQ, timeout_s=1e-6)))
        assert status == "HTTP/1.1 504 Gateway Timeout"
        assert json.loads(body) == {"error": "generation exceeded timeout_s=1e-06"}
        status, _, body = _raw(port, "POST", "/generate", _post(REQ))
        assert status == "HTTP/1.1 503 Service Unavailable"
        assert json.loads(body) == {"error": "queue full (1 pending); retry later"}
    finally:
        _close(httpd)


def _fixed_encoder(prompt: str) -> torch.Tensor:
    g = torch.Generator().manual_seed(len(prompt))
    return torch.randn(1, 4, 32, generator=g).to(torch.bfloat16)


def test_embed_returns_encode_prompt_as_float32(pipe):
    import dataclasses

    encoded = dataclasses.replace(pipe, text_encoder=_fixed_encoder)
    server = tserve.Flux2Server(encoded)
    httpd = _serve(server)
    try:
        port = httpd.server_address[1]
        status, headers, body = _raw(port, "POST", "/embed", _post({"prompt": "a tiny cat", "format": "npy"}))
        assert status == "HTTP/1.1 200 OK"
        assert dict(headers)["Content-Disposition"] == 'attachment; filename="embeddings.npy"'
        got = np.load(io.BytesIO(body))
        want = encoded.encode_prompt("a tiny cat").float().numpy()
        assert got.dtype == np.float32 and np.array_equal(got, want)
        status, _, body = _raw(port, "POST", "/embed", _post({"prompt": "a tiny cat"}))
        stats = json.loads(body)
        assert stats["shape"] == [1, 4, 32] and stats["dtype"] == "float32" and stats["mean"] == float(want.mean())
        status, _, _ = _raw(port, "POST", "/embed", _post({"prompt": " "}))
        assert status == "HTTP/1.1 400 Bad Request" and server.embeds_served == 2
    finally:
        _close(httpd)
        server.shutdown()
    bare = tserve.Flux2Server(pipe)
    bare.shutdown()
    with pytest.raises(tserve.ChatUnavailableError, match="to extract embeddings"):
        bare.embed("a cat")


def test_chat_unavailable_without_chat_fn_and_through_chat_fn(pipe):
    """Without an encoder facade chat raises JAX's message; a ``chat_fn``
    chats, counting its tokens, with ``chip_lock`` held."""
    bare = tserve.Flux2Server(pipe)
    bare.shutdown()
    jbare = jserve.Flux2Server(types.SimpleNamespace(encoders=None, text_encoder_name=None))
    jbare.shutdown()
    assert bare.chat_available() is jbare.chat_available() is False
    messages = []
    for server in (bare, jbare):
        with pytest.raises(RuntimeError) as err:
            server.chat(MESSAGES)
        messages.append(str(err.value))
    assert messages[0] == messages[1]

    def chat_fn(msgs, max_tokens, temperature, seed, on_token):
        assert server.chip_lock.locked()
        for piece in ("a", "b"):
            on_token(piece)
        return "ab"

    server = tserve.Flux2Server(pipe, chat_fn=chat_fn)
    server.shutdown()
    seen = []
    out = server.chat(MESSAGES, on_token=seen.append)
    assert out["reply"] == "ab" and out["tokens"] == 2 and seen == ["a", "b"] and server.chats_served == 1


class _WordTokenizer:
    """A deterministic stub chat tokenizer (JAX's test has one of its kind)."""

    pad_token_id = 0
    eos_token_id = None

    def apply_chat_template(self, messages, add_generation_prompt=False):
        text = " ".join(m["content"] for m in messages)
        return [sum(map(ord, w)) % 200 + 3 for w in text.split()][:16]

    def decode(self, tokens):
        return " ".join(f"t{t}" for t in tokens)


def test_chat_through_a_tiny_qwen3_facade_equals_jax(pipe):
    """JAX's test_serving_chat_and_models on both packages: a tiny Qwen3 (JAX's
    perturbed init, carried across) attached through each facade; /chat over
    localhost answers JSON and a chunked stream with the \\x1e trailer, the
    greedy replies and token counts equal to JAX's server's, /models reports
    chat available, and the port counts the chats."""
    import jax
    import jax.numpy as jnp

    from flux2_tpu.models.text_encoders import decoder as jdec
    from flux2_tpu.models.text_encoders import facade as jfacade
    from flux2_tpu_torch.io.jax_params import decoder_from_jax
    from flux2_tpu_torch.models.text_encoders import facade as tfacade
    from flux2_tpu_torch.models.text_encoders.config import TINY_DECODER
    from tests.test_torch_shared_copies import jax_config
    from tests.test_torch_transformer import perturbed_numpy

    params = perturbed_numpy(jdec.init_params(jax.random.PRNGKey(0), jax_config(TINY_DECODER), dtype=jnp.float32), 0)
    jenc, tenc = jfacade.TextEncoders(), tfacade.TextEncoders()
    jenc.attach("qwen3-tiny", jax.tree_util.tree_map(jnp.asarray, params), jax_config(TINY_DECODER),
                _WordTokenizer(), (1, 2, 3), recipe="klein")
    tenc.attach("qwen3-tiny", decoder_from_jax(params, TINY_DECODER), TINY_DECODER, _WordTokenizer(), (1, 2, 3),
                recipe="klein")
    servers = {"jax": jserve.Flux2Server(types.SimpleNamespace(encoders=jenc, text_encoder_name="qwen3-tiny")),
               "port": tserve.Flux2Server(dataclasses.replace(pipe, encoders=tenc, text_encoder_name="qwen3-tiny"))}
    answers = {}
    for name, server in servers.items():
        httpd = _serve_with(PACKAGES[name].make_handler, server)
        try:
            port = httpd.server_address[1]
            status, _, body = _raw(port, "POST", "/chat", _post({"messages": [{"role": "user", "content": "hello world"}],
                                                                 "max_tokens": 4, "temperature": 0.0}))
            assert status == "HTTP/1.1 200 OK", body
            out = json.loads(body)
            assert set(out) == {"reply", "tokens", "duration_s", "tok_per_s"} and out["reply"] and out["tokens"] >= 1
            status, headers, raw = _raw(port, "POST", "/chat", _post({"messages": [{"role": "user", "content": "hello"}],
                                                                      "max_tokens": 4, "temperature": 0.0,
                                                                      "stream": True}))
            assert status == "HTTP/1.1 200 OK" and ("Transfer-Encoding", "chunked") in headers
            visible, _, trailer = _dechunk(raw).decode().partition("\x1e")
            stats = json.loads(trailer)
            assert visible.strip() and stats["tokens"] >= 1
            if name == "port":
                assert server.chats_served == 2 and server.chat_available()
                assert server.models()["loaded"]["chat_available"] is True
            answers[name] = (out["reply"], out["tokens"], visible, stats["tokens"])
        finally:
            _close(httpd)
            server.shutdown()
    assert answers["port"] == answers["jax"]


def _dechunk(raw: bytes) -> bytes:
    """The payload of a chunked HTTP body."""
    out = b""
    while raw:
        size, _, raw = raw.partition(b"\r\n")
        n = int(size, 16)
        if n == 0:
            break
        out, raw = out + raw[:n], raw[n + 2:]
    return out


def test_cancel_all_covers_running_batch(pipe):
    """JAX's test: the running batch is off the queue, and cancel_all reaches it."""
    assert tserve.make_handler(tserve.Flux2Server.__new__(tserve.Flux2Server)).protocol_version == "HTTP/1.1"
    server = tserve.Flux2Server(pipe, embeddings_fn=lambda prompt: EMB, max_batch=2)
    try:
        running = [types.SimpleNamespace(cancelled=threading.Event()) for _ in range(2)]
        server._running_batch = running  # as _pick_batch would set mid-run
        assert server.cancel_all() >= 2
        assert all(p.cancelled.is_set() for p in running)
    finally:
        server.shutdown()


class _CancelAtStep:
    """Forwards to the pipeline; its batch's ``on_latents`` calls
    ``server.cancel_all()`` after step ``step``'s preview."""

    def __init__(self, pipe, step: int):
        self._pipe, self.step, self.server = pipe, step, None

    def __getattr__(self, name):
        return getattr(self._pipe, name)

    def generate(self, **kwargs):
        inner = kwargs["on_latents"]

        def on_latents(step, lat):
            inner(step, lat)
            if step == self.step:
                self.server.cancel_all()

        return self._pipe.generate(**dict(kwargs, on_latents=on_latents))


def test_cancel_all_mid_run_answers_400_after_one_more_step(pipe, monkeypatch):
    """cancel_all after step 2 of 4 is seen at step 3's end, as JAX's cancel
    point: 3 transformer forwards, then 400 "cancelled at step 3/4"; the
    running batch is cleared after it."""
    forwards = []
    forward = pipe.transformer.forward
    monkeypatch.setattr(pipe.transformer, "forward", lambda *a, **k: forwards.append(1) or forward(*a, **k))
    proxy = _CancelAtStep(pipe, 2)
    server = tserve.Flux2Server(proxy, embeddings_fn=lambda prompt: EMB, batch_window_s=0.0)
    proxy.server = server
    httpd = _serve(server)
    try:
        status, _, body = _raw(httpd.server_address[1], "POST", "/generate",
                               _post(dict(REQ, steps=4, preview_id="c")))
    finally:
        _close(httpd)
        server.shutdown()
    assert status == "HTTP/1.1 400 Bad Request"
    assert json.loads(body) == {"error": "GenerationCancelled: cancelled at step 3/4"}
    assert len(forwards) == 3 and server._running_batch is None and server.batches_run == 1


def test_cancel_all_releases_queued_requests(pipe):
    """A queued request that cancel_all abandons is answered (GenerationCancelled) when the worker drops it."""
    server = tserve.Flux2Server(pipe, embeddings_fn=lambda prompt: EMB, batch_window_s=0.0)
    server.shutdown()
    pending = tserve._Pending(dict(REQ), EMB)
    server._queue = [pending]
    assert server.cancel_all() == 1
    with server._queue_cv:
        assert server._pick_batch() == []
    assert pending.event.is_set() and "cancelled before it ran" in str(pending.error)


# -- 3. info, models and main against JAX's ---------------------------------------------------------


@pytest.fixture
def models_dir(tmp_path, monkeypatch):
    monkeypatch.setenv("FLUX2_MODELS_DIR", str(tmp_path / "models"))
    monkeypatch.setenv("HF_HOME", str(tmp_path / "hf"))
    repo = tmp_path / "models" / "black-forest-labs" / "FLUX.2-klein-4B" / "transformer"
    repo.mkdir(parents=True)
    (repo / "model.safetensors").write_bytes(b"\0" * 1234)
    (repo / "config.json").write_text("{}")
    return tmp_path


DEVICE_KEYS = {"backend": str, "devices": int}


def _servers(monkeypatch):
    """The JAX and the port's servers over SimpleNamespace pipelines (klein-4b,
    encoder "qwen3-4b"), with the same counters and a frozen clock."""
    monkeypatch.setattr(time, "time", lambda: 1000.0)
    jpipe = types.SimpleNamespace(model=jcfg.Flux2Model.KLEIN_4B, text_encoder_name="qwen3-4b", mesh=None,
                                  encoders=None)
    tpipe = types.SimpleNamespace(model=Flux2Model.KLEIN_4B, text_encoder_name="qwen3-4b",
                                  device=torch.device("cpu"))
    servers = [jserve.Flux2Server(jpipe), tserve.Flux2Server(tpipe)]
    for s in servers:
        s.shutdown()
        s.requests_served, s.batches_run, s.chats_served, s.embeds_served = 7, 3, 1, 2
    return servers


def test_info_equals_jax(monkeypatch):
    jsrv, tsrv = _servers(monkeypatch)
    ref, got = jsrv.info(), tsrv.info()
    assert set(got) == set(ref)
    for key, kind in DEVICE_KEYS.items():
        assert isinstance(got[key], kind)
    assert (got["backend"], got["devices"]) == ("cpu", 1)
    assert {k: v for k, v in got.items() if k not in DEVICE_KEYS} == {k: v for k, v in ref.items()
                                                                       if k not in DEVICE_KEYS}


def test_models_equals_jax(models_dir, monkeypatch):
    jsrv, tsrv = _servers(monkeypatch)
    ref, got = jsrv.models(), tsrv.models()
    assert set(got) == set(ref)
    assert isinstance(got["memory"], dict) and set(got["memory"]) == set(ref["memory"])
    assert all(isinstance(v, int) for v in got["memory"].values())
    assert got["recommended_quantization"] in ("bf16", "qint8", "int4")
    same = {k for k in ref if k not in ("memory", "recommended_quantization")}
    assert {k: got[k] for k in same} == {k: ref[k] for k in same}
    k4 = next(t for t in got["transformers"] if t["model"] == "klein-4b")
    assert k4["downloaded"] and k4["size_bytes"] == 1236 and k4["loaded"] and k4["prequantized"] == ["qint8"]
    assert next(e for e in got["text_encoders"] if e["name"] == "qwen3-4b")["loaded"]


class _Parsed(Exception):
    pass


@pytest.mark.parametrize("argv", [
    [],
    ["--random-init", "--port", "9000", "--host", "0.0.0.0", "--quantization", "w8a8", "--precompile", "256,512",
     "--steps-default", "2"],
    ["--model", "klein-9b", "--transformer-dir", "T", "--vae-dir", "V", "--encoder-dir", "E", "--no-text-encoder",
     "--small-decoder", "--tp", "0"],
], ids=["defaults", "random_init", "checkpoints"])
def test_main_parses_as_jax(argv, monkeypatch):
    from flux2_tpu.cli import main as jcli
    from flux2_tpu_torch.cli import main as tcli

    seen = {}

    def capture(name):
        def build(args, *a, **k):
            seen[name] = vars(args)
            raise _Parsed

        return build

    monkeypatch.setattr(jserve, "_enable_compile_cache", lambda: None)
    monkeypatch.setattr(jcli, "build_pipeline", capture("jax"))
    monkeypatch.setattr(tcli, "build_pipeline", capture("port"))
    for mod in (jserve, tserve):
        with pytest.raises(_Parsed):
            mod.main(argv)
    assert seen["port"].pop("device") == "cuda"
    assert seen["jax"].pop("lora") == []  # JAX's main sets it for its loader; the port loads no LoRA yet
    assert seen["port"] == seen["jax"]


def test_main_parses_tp_as_jax_and_shards_over_a_two_rank_mesh(monkeypatch):
    """``--tp 2`` (parallelism, ROADMAP item 10): the parsed namespace equals JAX's, and the pipeline is
    sharded over ``make_mesh(data=1, fsdp=1, tp=2)`` as JAX's ``main`` shards it; the port's mesh is
    over the ranks of its torchrun group (``_shard_for_tp``: the CUDA count, the group)."""
    from flux2_tpu.cli import main as jcli
    from flux2_tpu_torch.cli import main as tcli
    from flux2_tpu_torch.parallel import mesh as tmesh

    seen = {}

    class _Pipe:
        device = torch.device("cpu")

        def shard(self, mesh, context_parallel=False):
            seen["shard"] = (mesh, context_parallel)
            raise _Parsed

    def capture(name):
        def build(args, device=None, *a, **k):
            seen[name] = dict(vars(args))
            seen[f"{name}_device"] = device
            if name == "jax":
                raise _Parsed
            return _Pipe()

        return build

    monkeypatch.setattr(jserve, "_enable_compile_cache", lambda: None)
    monkeypatch.setattr(jcli, "build_pipeline", capture("jax"))
    monkeypatch.setattr(tcli, "build_pipeline", capture("port"))
    monkeypatch.setattr(tserve, "_shard_for_tp", lambda args: torch.device("cuda", 1))
    monkeypatch.setattr(tmesh, "make_mesh", lambda **kw: ("mesh", kw))
    argv = ["--tp", "2", "--random-init", "--port", "9001"]
    for mod in (jserve, tserve):
        with pytest.raises(_Parsed):
            mod.main(argv)
    assert seen["port"].pop("device") == "cuda"
    assert seen["jax"].pop("lora") == []
    assert seen["port"] == seen["jax"]
    assert seen["port_device"] == torch.device("cuda", 1)  # this rank's card
    assert seen["shard"] == (("mesh", {"data": 1, "fsdp": 1, "tp": 2, "device_type": "cpu"}), False)


def test_main_tp_exits_naming_the_cuda_device_counts(monkeypatch):
    """``--tp 2`` on a machine with fewer CUDA devices exits before building, naming both counts."""
    from flux2_tpu_torch.cli import main as tcli

    monkeypatch.setattr(tcli, "build_pipeline", lambda *a, **k: pytest.fail("built a pipeline"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(SystemExit, match=r"--tp 2 needs 2 CUDA devices, one per rank; this machine has 1"):
        tserve.main(["--tp", "2", "--random-init"])


def test_main_builds_precompiles_and_serves_a_tiny_pipeline(monkeypatch, capsys):
    """``serve.main`` with ``--random-init --device cpu --precompile 32`` on
    reduced configs: JAX's "precompiled" and "serving on" lines, a server
    whose embeddings come from the attached random encoder."""
    import dataclasses

    from flux2_tpu_torch.models.text_encoders.config import TINY_DECODER

    served = []

    class _Once:
        def __init__(self, address, handler):
            self.address, self.handler = address, handler

        def serve_forever(self):
            served.append(self)

    monkeypatch.setattr(tserve, "ThreadingHTTPServer", _Once)
    tc = Flux2TransformerConfig(num_layers=1, num_single_layers=1, num_attention_heads=4, attention_head_dim=128,
                                joint_attention_dim=192, guidance_embeds=False)
    tserve.main(["--random-init", "--device", "cpu", "--precompile", "32", "--steps-default", "1", "--port", "9"],
                transformer_config=tc, vae_config=VAEConfig(block_out_channels=(8, 8, 8, 8), layers_per_block=1,
                                                            norm_num_groups=4),
                encoder_config=dataclasses.replace(TINY_DECODER, num_hidden_layers=28, vocab_size=600))
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("precompiled 32x32 in ") and lines[0].endswith("s")
    assert lines[1] == "flux2-tpu serving on http://127.0.0.1:9 (model klein-4b)"
    (httpd,) = served
    assert httpd.address == ("127.0.0.1", 9) and httpd.handler.protocol_version == "HTTP/1.1"
