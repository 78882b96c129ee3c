"""The port's span recorder (``flux2_tpu_torch/utils/profiler.py``) and the
spans the program files (CPU, tiny widths, no JAX).

- Off (not enabled, no ``torch.profiler`` running) nothing is recorded, and a
  span costs no object of its own.
- A running ``torch.profiler`` turns recording on in every thread, and its
  stop turns it off; the check is made when a span opens.
- Phases keep one start per thread; the ring keeps its last ``maxlen``.
- ``generate`` files one ``dit.step`` a step inside "2. Denoising"; a prompt
  encode on a cache miss files ``pipeline.encode``; ``Flux2Server`` files a
  ``serve.queue`` (with its batch's size) and a ``serve.png`` a request; a
  train step files ``train.forward`` and ``train.backward`` a micro-batch and
  one ``train.optimizer``.
"""

import itertools
import json
import threading
import time

import numpy as np
import pytest
import torch

from flux2_tpu_torch.models.flux2.config import Flux2Model, Flux2TransformerConfig
from flux2_tpu_torch.models.flux2.transformer import Flux2Transformer
from flux2_tpu_torch.models.flux2.vae import VAEConfig
from flux2_tpu_torch.ops import latents as lu
from flux2_tpu_torch.ops.rope import rope_embeddings
from flux2_tpu_torch.pipeline.pipeline import Flux2Pipeline
from flux2_tpu_torch.serve import Flux2Server
from flux2_tpu_torch.training import trainer
from flux2_tpu_torch.utils import profiler as tprof

TINY_DIT = Flux2TransformerConfig(num_layers=1, num_single_layers=1, num_attention_heads=2, attention_head_dim=128,
                                  joint_attention_dim=96, guidance_embeds=False)
TINY_VAE = VAEConfig(block_out_channels=(8, 8, 16, 16), layers_per_block=1, norm_num_groups=4)


@pytest.fixture
def spans(monkeypatch):
    """An enabled recorder in place of the process's shared one."""
    rec = tprof.PhaseProfiler(enabled=True)
    monkeypatch.setattr(tprof, "_shared", rec)
    return rec


@pytest.fixture(scope="module")
def tiny_pipe():
    return Flux2Pipeline.from_random(Flux2Model.KLEIN_4B, device="cpu", generator=torch.Generator().manual_seed(0),
                                     dtype=torch.float32, transformer_config=TINY_DIT, vae_config=TINY_VAE)


def test_off_records_nothing():
    prof = tprof.PhaseProfiler(enabled=False)
    assert prof.span("a", k=1) is prof.span("b")  # the one shared null context: nothing made per span
    with prof.span("a", k=1):
        pass
    prof.record("b", 0.0, 1.0, batch=2)
    prof.start("c")
    prof.end("c")
    prof.record_step(0.5)
    assert prof.spans() == [] and prof.phases == {} and prof.eta(3) is None


def test_a_running_torch_profiler_turns_recording_on_in_every_thread():
    prof = tprof.PhaseProfiler(enabled=False)

    def work(name):
        with prof.span(name, where="thread"):
            pass

    def in_thread(name):
        th = threading.Thread(target=work, args=(name,))
        th.start()
        th.join(timeout=60)
        assert not th.is_alive()

    torch_prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])
    torch_prof.start()
    try:
        in_thread("during")
        opened = prof.span("open across the stop")
        opened.__enter__()
    finally:
        torch_prof.stop()
    opened.__exit__(None, None, None)  # checked when it opened: filed
    in_thread("after")
    with prof.span("after, main thread"):
        pass
    assert [(s.name, dict(s.attrs)) for s in prof.spans()] == [("during", {"where": "thread"}),
                                                                ("open across the stop", {})]
    assert prof.spans()[0].thread != threading.get_ident() and prof.spans()[1].thread == threading.get_ident()


def test_a_torch_without_the_profiler_flag_records_under_flux2_profile_alone(monkeypatch):
    """The flag is a private global of ``torch.autograd.profiler``: where a
    release lacks it, spans neither raise nor record unless enabled."""
    import types

    assert tprof._flag_holder(torch.autograd.profiler) is torch.autograd.profiler
    monkeypatch.setattr(tprof, "_torch_profiler", tprof._flag_holder(types.SimpleNamespace()))
    off, on = tprof.PhaseProfiler(enabled=False), tprof.PhaseProfiler(enabled=True)
    for prof in (off, on):
        with prof.span("dit.step", step=0):
            pass
        prof.record("serve.queue", 0.0, 1.0, batch=1)
        prof.start("1. Text Encoding")
        prof.end("1. Text Encoding")
    assert off.spans() == []
    assert [s.name for s in on.spans()] == ["dit.step", "serve.queue", "1. Text Encoding"]


def test_two_threads_in_one_phase_keep_their_own_starts(monkeypatch, tmp_path):
    prof = tprof.PhaseProfiler(enabled=True)
    clock = itertools.count()
    monkeypatch.setattr(time, "perf_counter", lambda: float(next(clock)))
    turns = [threading.Event() for _ in range(4)]

    def thread(first, second):
        turns[first].wait(timeout=60)
        prof.start("2. Denoising")
        turns[first + 1].set()
        turns[second].wait(timeout=60)
        prof.end("2. Denoising")
        if second + 1 < len(turns):
            turns[second + 1].set()

    threads = [threading.Thread(target=thread, args=(0, 2)), threading.Thread(target=thread, args=(1, 3))]
    for th in threads:
        th.start()
    turns[0].set()  # A starts (t 0), B starts (t 1), A ends (t 2), B ends (t 3)
    for th in threads:
        th.join(timeout=60)
    assert not any(th.is_alive() for th in threads)
    got = [(s.start, s.end) for s in prof.spans()]
    assert got == [(0.0, 2.0), (1.0, 3.0)] and prof.phases == {"2. Denoising": 4.0}
    prof.export_chrome_trace(str(tmp_path / "t.json"))
    events = json.loads((tmp_path / "t.json").read_text())["traceEvents"]
    assert [e["tid"] for e in events] == [0, 1]  # threads numbered in the order they appear


def test_the_ring_keeps_its_last_maxlen_spans(monkeypatch):
    monkeypatch.setattr(tprof, "RING", 4)
    prof = tprof.PhaseProfiler(enabled=True)
    for i in range(10):
        prof.record("serve.queue", float(i), i + 0.5, batch=1)
    assert [s.start for s in prof.spans()] == [6.0, 7.0, 8.0, 9.0]


def test_generate_files_one_dit_step_a_step_inside_denoising(tiny_pipe, spans):
    tiny_pipe.generate(embeddings=torch.zeros(2, 8, 96), height=64, width=64, num_steps=3, seed=1)
    (denoise,) = spans.spans("2. Denoising")
    steps = spans.spans("dit.step")
    assert [dict(s.attrs) for s in steps] == [{"step": i, "batch": 2} for i in range(3)]
    assert all(denoise.start <= s.start <= s.end <= denoise.end and s.thread == denoise.thread for s in steps)
    assert {s.name for s in spans.spans()} == {"1. Text Encoding", "dit.step", "2. Denoising", "3. VAE Decoding"}
    assert set(spans.phases) == {"1. Text Encoding", "2. Denoising", "3. VAE Decoding"}  # spans stay out


def test_a_prompt_encode_files_a_span_on_a_miss_only(tiny_pipe, spans, monkeypatch):
    monkeypatch.setattr(tiny_pipe, "text_encoder", lambda prompt: torch.zeros(1, 8, 96))
    monkeypatch.setattr(tiny_pipe, "_prompt_cache", type(tiny_pipe._prompt_cache)())
    for prompt in ("a fox", "a fox", "a hen"):
        tiny_pipe.encode_prompt(prompt)
    enc = spans.spans("pipeline.encode")
    assert len(enc) == 2 and all(s.attrs["lock_wait_s"] >= 0.0 and s.end >= s.start for s in enc)


def test_the_server_files_queue_and_png_spans_a_request(tiny_pipe, spans):
    emb = torch.zeros(1, 8, 96)
    server = Flux2Server(tiny_pipe, embeddings_fn=lambda prompt: emb, batch_window_s=3.0)
    errors = []

    def send(i):
        try:
            server.generate_png({"prompt": f"p{i}", "height": 64, "width": 64, "steps": 1, "seed": i})
        except Exception as e:  # reported below
            errors.append(e)

    sent = time.perf_counter()
    threads = [threading.Thread(target=send, args=(i,)) for i in range(3)]
    try:
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
    finally:
        server.shutdown()
    assert not errors and not any(th.is_alive() for th in threads)
    queue = spans.spans("serve.queue")
    assert server.batches_run == 1 and [s.attrs["batch"] for s in queue] == [3, 3, 3]
    assert all(sent <= s.start <= s.end for s in queue) and len({s.end for s in queue}) == 1  # one pick
    png = spans.spans("serve.png")
    assert len(png) == 3 and len({s.thread for s in png}) == 3 and all(s.start >= queue[0].end for s in png)


@pytest.mark.parametrize("micro", [1, 2])
def test_a_train_step_files_its_three_phases(micro, spans):
    gen = torch.Generator().manual_seed(0)
    model = Flux2Transformer(TINY_DIT, device="cpu", dtype=torch.float32, generator=gen)
    cfg = trainer.TrainConfig(rank=4, alpha=4.0, remat=False, grad_accumulation=micro)
    state = trainer.init_train_state(model, cfg, gen)
    ids = np.concatenate([lu.text_position_ids(6), lu.image_position_ids(64, 64)])
    cos, sin = rope_embeddings(torch.from_numpy(ids))
    batch = {"latents": torch.randn(2, 16, 128, generator=gen), "embeddings": torch.randn(2, 6, 96, generator=gen),
             "rope_cos": cos, "rope_sin": sin}
    trainer.make_train_step(model, cfg)(state.lora, state.optimizer, batch, gen)
    names = [s.name for s in spans.spans()]
    assert names == ["train.forward", "train.backward"] * micro + ["train.optimizer"]
    assert [s.attrs["micro"] for s in spans.spans("train.forward")] == list(range(micro))
    got = spans.spans()
    assert all(a.end <= b.start for a, b in zip(got, got[1:]))
