"""Check and time a candidate source of the flash-attention forward (K1/K2) on one CUDA card.

    python3 -m flux2_tpu_torch.utils.flash_fwd_candidate --source path/to/flash_attention.cu

Builds ``--source`` on its own with the port's nvcc flags (it must define the
C entries ``flux2_flash_attention_fwd`` and ``flux2_flash_attention_fwd_lse``
with the signatures of ``csrc/flash_attention.cu``) into ``build/candidate/``,
prints ptxas's registers and spills, checks its K1 and K2 against the plain
versions at the K1 shapes ``chip_smoke.py`` checks (relative L2 of out within
1e-2, LSE within 1e-3), says whether its outputs equal the library's bit for
bit (a refactor should), and times it beside the library's own K1/K2 (the
checkout's ``csrc/``) in one process, in turns (library, candidate,
candidate, library), with CUDA events at three sequence lengths. It is how a
redesign of the forward is compared with the current kernel before it
replaces ``csrc/flash_attention.cu``. Every line carries the card's name and
power limit; the exit code is 1 if a check fails.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
import time
from pathlib import Path

import torch

CASES = [  # (name, (b, h, s_q, s_k), span), as chip_smoke.phase_kernel_check
    ("klein4b_1024px", (1, 24, 4608, 4608), None),
    ("klein4b_256px_bs3", (3, 24, 768, 768), None),
    ("ragged", (1, 24, 777, 1000), None),
    ("ragged_961", (1, 24, 777, 961), None),
    ("ragged_one_key", (1, 24, 777, 897), None),
    ("blocked_span", (1, 24, 2560, 2560), (512, 1536, 1536)),
    ("span_mid_tile", (1, 24, 2560, 2560), (100, 1300, 1000)),
]
TIMED_SEQ = (4608, 1056, 4128)  # 1024^2 serving, 512^2 and 1024^2 training
REL_TOL = 1e-2
LSE_ABS_TOL = 1e-3


SYMBOLS = {"flux2_flash_attention_fwd": 4, "flux2_flash_attention_fwd_lse": 5}  # C entry: its pointer count


def build(source: Path, out_dir: Path, symbols: dict = SYMBOLS):
    """nvcc ``source`` into a shared library; (typed C entries, ptxas report, library path)."""
    from flux2_tpu_torch.utils import build as kbuild

    out_dir.mkdir(parents=True, exist_ok=True)
    lib_path = out_dir / f"lib{source.stem}.so"
    cmd = [kbuild._nvcc(), *kbuild.NVCC_FLAGS, "-I", str(kbuild.CSRC_DIR), "-shared", "-o", str(lib_path),
           str(source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed with code {proc.returncode}:\n{' '.join(cmd)}\n{proc.stderr}")
    lib = ctypes.CDLL(str(lib_path))
    entries = {}
    for name, n_ptr in symbols.items():
        fn = getattr(lib, name)
        fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 4 + [ctypes.c_float] + [ctypes.c_int] * 4
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        entries[name] = fn
    return entries, proc.stderr, lib_path


def candidate_forward(entries, q, k, v, scale, span, with_lse: bool):
    """The candidate's K1 (out) or K2 ((out, lse)) on q, k, v [B, H, S, 128] bf16."""
    b, h, s_q, d = q.shape
    q0, q1, k0 = span if span is not None else (0, 0, 0)
    out = torch.empty_like(q)
    lse = torch.empty(q.shape[:3], device=q.device, dtype=torch.float32) if with_lse else None
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr()) + ((lse.data_ptr(),) if with_lse else ())
    name = "flux2_flash_attention_fwd_lse" if with_lse else "flux2_flash_attention_fwd"
    err = entries[name](*ptrs, b * h, s_q, k.shape[2], d, float(scale), q0, q1, k0, int(span is not None),
                        torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name}: launch failed with cudaError {err}")
    return (out, lse) if with_lse else out


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean time of one call over ``reps`` back-to-back calls, CUDA events."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--source", required=True, type=Path, help="the candidate .cu")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("flash_fwd_candidate needs a CUDA device; torch.cuda.is_available() is False")
    from flux2_tpu_torch.ops import flash_attention as fa
    from flux2_tpu_torch.utils.profile_step import _card

    card = _card()
    t0 = time.perf_counter()
    entries, report, _ = build(args.source.resolve(), Path(__file__).resolve().parents[2] / "build" / "candidate")
    print(f"[build] {args.source}: {time.perf_counter() - t0:.2f} s", flush=True)
    for line in report.splitlines():
        if "registers" in line or "spill" in line or "C75" in line:
            print(f"[build] {line.strip()}", flush=True)

    gen = torch.Generator(device="cuda").manual_seed(0)
    ok = True
    for name, (b, h, s_q, s_k), span in CASES:
        q, k, v = (torch.randn(b, h, s, 128, device="cuda", generator=gen).bfloat16() for s in (s_q, s_k, s_k))
        scale = 128**-0.5
        out = candidate_forward(entries, q, k, v, scale, span, with_lse=False)
        out2, lse = candidate_forward(entries, q, k, v, scale, span, with_lse=True)
        lib_out, lib_lse = fa.flash_attention_lse(q, k, v, scale, span)
        same = (torch.equal(out, fa._flash_k1(q, k, v, scale, span)) and torch.equal(out2, lib_out)
                and torch.equal(lse, lib_lse))
        ref, ref_lse = fa.flash_attention_lse_reference(q, k, v, scale, span)
        ref = ref.float()
        rel = float((out.float() - ref).norm() / ref.norm())
        rel2 = float((out2.float() - ref).norm() / ref.norm())
        lse_err = float((lse - ref_lse).abs().max())
        good = bool(torch.isfinite(out).all()) and max(rel, rel2) <= REL_TOL and lse_err <= LSE_ABS_TOL
        ok &= good
        print(f"[check] {name} {(b, h, s_q, s_k)} span={span}: K1 rel_l2 {rel:.3e}, K2 rel_l2 {rel2:.3e}, "
              f"lse max_abs {lse_err:.3e}, K1/K2 bitwise equal to the library's {same} {'ok' if good else 'FAIL'} "
              f"[{card}]", flush=True)
    for s in TIMED_SEQ:
        q, k, v = (torch.randn(1, 24, s, 128, device="cuda", generator=gen).bfloat16() for _ in range(3))
        scale = 128**-0.5
        flop = 4.0 * 24 * s * s * 128
        runs = [("library K1", lambda: fa.flash_attention(q, k, v)),
                ("candidate K1", lambda: candidate_forward(entries, q, k, v, scale, None, False)),
                ("candidate K2", lambda: candidate_forward(entries, q, k, v, scale, None, True)),
                ("library K2", lambda: fa.flash_attention_lse(q, k, v, scale)),
                ("candidate K1", lambda: candidate_forward(entries, q, k, v, scale, None, False)),
                ("library K1", lambda: fa.flash_attention(q, k, v))]
        times = [(label, time_ms(fn)) for label, fn in runs]
        print(f"[time] (1, 24, {s}, 128): " + ", ".join(f"{label} {ms:.4f} ms ({flop / ms / 1e9:.1f} TFLOP/s)"
                                                         for label, ms in times) + f" [{card}]", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
