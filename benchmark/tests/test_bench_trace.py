"""Reading a device trace: the marker ties it to the host clock, busy time
is the union of intervals inside the window, and a launch's shape is read
back from its grid. The card test traces real launches."""

import pytest
import torch

from benchmark import trace


def _ev(name, ts_us, dur_us, grid=None, cat="kernel"):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts_us, "dur": dur_us}
    if grid is not None:
        e["args"] = {"grid": grid}
    return e


def test_parse_aligns_clips_and_unions():
    events = [_ev("void at::cuda::(anonymous namespace)::spin_kernel(long)", 1_000_000.0, 5.0),
              _ev("flash_fwd_kernel(CUtensorMap_st, int)", 1_000_100.0, 400.0, [36, 24, 1]),
              _ev("void gemm<4>(int)", 1_000_300.0, 400.0),  # overlaps the first
              _ev("Memcpy DtoH", 1_001_000.0, 100.0, cat="gpu_memcpy")]
    host0 = 50.0  # the marker launched at host time 50 s
    tr = trace.parse(events, host0, host0 + 50e-6, host0 + 1.05e-3)
    assert tr.window_s == pytest.approx(1.0e-3)
    assert tr.busy_s() == pytest.approx(600e-6 + 50e-6)
    assert [op.grid for op in tr.kernels("flash_fwd_kernel")] == [(36, 24, 1)]
    assert tr.idle_percent() == pytest.approx(35.0)
    gaps = tr.idle_gaps()
    assert gaps[0] == pytest.approx((host0 + 50e-6, host0 + 100e-6))


def test_parse_without_markers_fails():
    with pytest.raises(RuntimeError):
        trace.parse([_ev("k", 0.0, 1.0)], 0.0, 0.0, 1.0)


def test_roofline_reader_reads_shapes_from_grids():
    from types import SimpleNamespace as Run

    from benchmark import flops, spec

    ops = [trace.DeviceOp("flash_fwd_kernel(x)", "kernel", 0.0, 0.5e-3, (36, 24, 1)),
           trace.DeviceOp("flash_fwd_kernel(x)", "kernel", 1.0, 1.0 + 0.5e-3, (36, 48, 1))]
    config = spec.load_json(spec.BENCH_DIR / "configs" / "klein-4b.json")
    tr = trace.DeviceTrace(ops, 0.0, 2.0)
    run = Run(trace=tr, peaks=flops.H100_SXM, config=config,
              traffic=spec.load_json(spec.BENCH_DIR / "traffic" / "t2i1024-closed.json"))
    share = spec.reader("flash_fwd_roofline.serve")(run)
    bound = flops.roofline_s(*flops.attention_fwd(1, 24, 4608, 4608, 128), flops.H100_SXM)
    assert share == pytest.approx(100.0 * 3 * bound / 1e-3)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_trace_on_the_card(card):
    from flux2_tpu_torch.ops import flash_attention as fa

    q = torch.randn(1, 24, 4608, 128, device=card, dtype=torch.bfloat16)
    fa.flash_attention(q, q, q)
    tr = trace.Tracer(True)
    tr.start()
    import time

    t0 = time.perf_counter()
    for _ in range(3):
        fa.flash_attention(q, q, q)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    tr.stop(t0, t1)
    launches = tr.trace.kernels("flash_fwd_kernel")
    assert len(launches) == 3 and all(op.grid[:2] == (36, 24) for op in launches)
    assert all(t0 - 1e-3 <= op.start and op.end <= t1 + 1e-3 for op in launches)
    assert 0.0 < tr.trace.busy_s() <= tr.trace.window_s
