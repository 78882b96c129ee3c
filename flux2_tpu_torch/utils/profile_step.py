"""Device time by kernel, for the tools that time one kernel on one CUDA card.

``kernel_time_ms(fn, mark)`` is the mean device time of the kernels whose
name holds ``mark`` in one call of ``fn``, by ``torch.profiler``;
``kernel_class`` files a kernel's name under K1, K2, K3/K4, the quantized
matmuls, their activation prologue, convolutions, GEMMs or the rest;
``_card`` is the card's name and power limit. ``chip_smoke.py`` and the
``*_candidate`` tools use them.

Where a whole served or training step's time goes, and the device's idle
share, is the benchmark's to say, from one trace of its own window:
``python3 -m benchmark.run --workload <cell> --seed <n> --seconds 40 --trace 1``
(``benchmark/README.md``).
"""

from __future__ import annotations

import subprocess

import torch

K1_KERNEL = "flash_fwd_kernel"
K2_KERNEL = "flash_fwd_lse_kernel"
K34_MARK = "flash_bwd_"  # flash_bwd_dq_kernel (K3), flash_bwd_dkv_kernel (K4)
_QUANT_MARKS = ("w8a8_kernel", "w4a8_kernel", "dequant_kernel")  # csrc/quant_matmul.cu
PROLOGUE_KERNEL = "quantize_rows_kernel"  # csrc/quant_prologue.cu: K5's and K6's activation prologue
_CONV_MARKS = ("conv", "fprop", "dgrad", "wgrad", "winograd", "implicit_gemm", "cudnn")
_GEMM_MARKS = ("gemm", "nvjet", "cutlass", "xmma", "cublas")


def kernel_class(name: str) -> str:
    low = name.lower()
    if K1_KERNEL in low:
        return "k1"
    if K2_KERNEL in low:
        return "k2"
    if K34_MARK in low:
        return "k34"
    if any(m in low for m in _QUANT_MARKS):
        return "quant"
    if PROLOGUE_KERNEL in low:
        return "prologue"
    if any(m in low for m in _CONV_MARKS):
        return "conv"
    if any(m in low for m in _GEMM_MARKS):
        return "gemm"
    return "other"


def kernel_time_ms(fn, mark: str = "", reps: int = 10) -> float:
    """Mean device time of the kernels whose name holds ``mark`` (all of them
    by default) in one call of ``fn`` (torch.profiler over ``reps`` calls):
    a kernel alone, without its wrapper's other launches or the host's time
    between launches. A trace that holds no such kernel, or a count of them
    that is not a whole number a call (a trace that lost some of its device
    events, so that it reads too short), is taken again."""
    fn()
    torch.cuda.synchronize()
    for _ in range(6):  # such a trace comes now and then, up to three in a row; a sixth raises
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA and mark in e.name]
        if events and len(events) % reps == 0:
            return sum(e.time_range.elapsed_us() for e in events) / reps / 1e3
    raise RuntimeError(f"torch.profiler recorded no whole trace of {mark or 'kernel'} launches in six traces")


def _card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
