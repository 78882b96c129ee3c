"""The program's spans laid over a device trace (``benchmark/spans.py``) and
the readers of the metrics that rest on them, on a synthetic trace and
synthetic spans filed into the program's recorder."""

from types import SimpleNamespace as Run

import pytest

from benchmark import spans, spec, trace
from flux2_tpu_torch.utils import profiler

NEW = {"dit_dispatch_ms.serve": "dit.step", "idle_in_dispatch.serve": "dit.step",
       "queue_wait_ms.serve": "serve.queue", "encode_ms.serve": "pipeline.encode",
       "png_encode_ms.serve": "serve.png", "optimizer_ms.train": "train.optimizer",
       "idle_in_optimizer.train": "train.optimizer"}


@pytest.fixture
def recorder(monkeypatch):
    rec = profiler.PhaseProfiler(enabled=True)
    monkeypatch.setattr(profiler, "_shared", rec)
    return rec


def _trace():
    """Busy [0, 1] and [2, 3] of the window [0, 4]: idle [1, 2] and [3, 4]."""
    ops = [trace.DeviceOp("k", "kernel", 0.0, 1.0), trace.DeviceOp("k", "kernel", 2.0, 3.0)]
    return trace.DeviceTrace(ops, 0.0, 4.0)


def test_a_gap_half_inside_a_span_counts_half(recorder):
    recorder.record("dit.step", 1.5, 2.5, step=0, batch=1)  # half of the idle [1, 2]
    run = Run(trace=_trace(), t0=0.0, t1=4.0)
    assert spans.idle_share(run, "dit.step") == pytest.approx(100.0 * 0.5 / 4.0)
    assert spans.idle_share(run, "dit.step") <= run.trace.idle_percent()
    assert spans.mean_ms(spans.program_spans(run, "dit.step")) == pytest.approx(1000.0)


def test_overlapping_spans_count_their_union_once(recorder):
    recorder.record("train.optimizer", 0.5, 1.5)
    recorder.record("train.optimizer", 1.2, 3.5)  # from two threads, say: idle [1, 2] and [3, 3.5] once
    run = Run(trace=_trace(), t0=0.0, t1=4.0)
    assert spans.idle_share(run, "train.optimizer") == pytest.approx(100.0 * 1.5 / 4.0)


def test_spans_outside_the_window_are_left_out(recorder):
    for start, end in ((-2.0, -1.0), (3.2, 3.6), (4.5, 5.0), (-0.5, 0.5)):
        recorder.record("serve.queue", start, end, batch=1)
    run = Run(trace=_trace(), t0=0.0, t1=4.0)
    assert [(s.start, s.end) for s in spans.program_spans(run, "serve.queue")] == [(3.2, 3.6), (-0.5, 0.5)]
    assert spans.program_spans(run, "dit.step") == []


def test_idle_split_gives_each_moment_to_the_first_group_that_holds_it():
    s = lambda a, b: Run(start=a, end=b)  # noqa: E731
    split = spans.idle_split(_trace(), [("dit.step", [s(1.0, 1.25)]), ("2. Denoising", [s(0.5, 1.5)]),
                                        ("serve.png", [s(1.4, 1.6), s(3.0, 3.5)])])
    assert split == pytest.approx({"dit.step": 0.25, "2. Denoising": 0.25, "serve.png": 0.6, "no span": 0.9})
    assert sum(split.values()) == pytest.approx(4.0 - _trace().busy_s())


def test_split_summary_files_each_idle_moment_once_and_reads_the_spans():
    """``benchmark.split``'s line, on the synthetic trace: idle [1, 2] and [3, 4]."""
    from benchmark import split

    def s(a, b, thread=1, **attrs):
        return profiler.Span("x", a, b, thread, attrs)

    named = {"dit.step": [s(1.0, 1.25, step=0, batch=1), s(1.3, 1.4, step=1, batch=1)],
             "2. Denoising": [s(0.5, 1.5)], "pipeline.encode": [s(3.0, 3.5, thread=2, lock_wait_s=2e-6)],
             "serve.png": [s(3.25, 3.75, thread=3)], "serve.queue": [s(0.0, 1.0, batch=1)]}
    out = split.summary(_trace(), named, split.SERVE)
    assert out["idle_split_s"] == pytest.approx({"dit.step": 0.35, "2. Denoising": 0.15, "3. VAE Decoding": 0.0,
                                                 "1. Text Encoding": 0.0, "pipeline.encode": 0.5, "serve.png": 0.25,
                                                 "no span": 0.75})
    assert sum(out["idle_split_s"].values()) == pytest.approx(out["idle_s"]) and out["window_s"] == 4.0
    assert out["dispatch_ms_by_step"] == pytest.approx({0: 250.0, 1: 100.0})
    assert out["lock_wait_ms_max"] == pytest.approx(0.002)
    assert out["counts"]["dit.step"] == 2 and out["threads"] == {n: 1 for n in named}
    train = split.summary(_trace(), {}, split.TRAIN)  # a program without spans: every idle moment unclaimed
    assert train["idle_split_s"] == pytest.approx({"train.forward": 0.0, "train.backward": 0.0,
                                                   "train.optimizer": 0.0, "no span": 2.0})
    assert "dispatch_ms_by_step" not in train and "lock_wait_ms_max" not in train


def test_interval_arithmetic():
    xs = [(0.0, 2.0), (3.0, 5.0)]
    ys = spans.union([(1.0, 1.5), (1.4, 3.5), (6.0, 7.0), (8.0, 8.0)])
    assert ys == [(1.0, 3.5), (6.0, 7.0)]
    assert spans.intersect(xs, ys) == [(1.0, 2.0), (3.0, 3.5)]
    assert spans.subtract(xs, ys) == [(0.0, 1.0), (3.5, 5.0)]


@pytest.mark.parametrize("metric", sorted(NEW))
def test_each_new_reader_reads_none_without_a_trace_or_spans(metric, recorder):
    read = spec.reader(metric)
    assert read(Run(trace=None, t0=0.0, t1=4.0)) is None
    assert read(Run(trace=_trace(), t0=0.0, t1=4.0)) is None
    recorder.record(NEW[metric], 1.0, 1.5)
    assert read(Run(trace=None, t0=0.0, t1=4.0)) is None
    assert read(Run(trace=_trace(), t0=0.0, t1=4.0)) == pytest.approx(500.0 if metric.split(".")[0].endswith("_ms")
                                                                       else 100.0 * 0.5 / 4.0)


def test_a_recorder_without_spans_reads_none(monkeypatch):
    """A program whose recorder files no spans (one before them) gives no value and no error."""
    monkeypatch.setattr(profiler, "_shared", Run(enabled=False))
    for metric in NEW:
        assert spec.reader(metric)(Run(trace=_trace(), t0=0.0, t1=4.0)) is None
