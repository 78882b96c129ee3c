"""Check and time candidate sources of the quantized matmuls (K5, K6, K7) and their prologue on one CUDA card.

    python3 -m flux2_tpu_torch.utils.quant_candidate --source a.cu [--source b.cu ...] [--kinds w8a8 ...]

Builds each ``--source`` on its own with the port's nvcc flags, all at once
(``flash_fwd_candidate.build``; a source is a working copy of
``csrc/quant_matmul.cu`` with its three C entries, and finds the headers of
``csrc/`` through ``-I``), into ``build/candidate/``, and prints ptxas's
registers and spills and the highest register each kernel's SASS names, for
the candidates and for the library built from the checkout's ``csrc/``. Then
it checks the library's and each candidate's K5, K6 and K7 (qint8, int4)
against their plain versions at the seven served shapes ``chip_smoke.py``
checks and at four edge shapes (relative L2 within 1e-3; K5 and K6 must equal
their plain versions to the bit, in both of their output types), says
whether each candidate's outputs equal the library's bit for bit, and times
the kernels alone (activations quantized beforehand by the plain prologue) in
one process, in turns (library, candidates, candidates in reverse, library),
with CUDA events around back-to-back calls of the C entry and with
torch.profiler's device time. A source that exports the activation
prologue's entry (a working copy of ``csrc/quant_prologue.cu``) is checked
against the plain chain to the bit and timed the same way. ``--kinds``
keeps some of K5 (w8a8), K6 (w4a8), K7 (qint8, int4) and the prologue.
Last, the host's time per call of the shipped wrappers against
``F.linear``. It is how a redesign of a quantized matmul or of the
prologue is compared with the current kernels before it replaces its
source. Every line carries the card's name and power limit; the exit code
is 1 if a check fails.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import sys
import time
from pathlib import Path

import torch

from flux2_tpu_torch.utils.flash_bwd_candidate import sass_max_registers
from flux2_tpu_torch.utils.flash_fwd_candidate import build, time_ms
from flux2_tpu_torch.utils.profile_step import kernel_time_ms

SHAPES = [  # (name, M, K, N): chip_smoke.QMM_SHAPES, then edge shapes of the gates
    ("image_qkvo_1024", 4096, 3072, 3072),
    ("single_mlp_gate", 4608, 3072, 9216),
    ("ff_out", 4096, 9216, 3072),
    ("context_embedder", 512, 7680, 3072),
    ("modulation_bs1", 1, 3072, 18432),
    ("qwen3_gate_proj", 512, 2560, 9216),
    ("bn_regression", 16, 512, 2560),
    ("edge_m1", 1, 512, 256),
    ("edge_m8", 8, 512, 256),
    ("edge_m100", 100, 512, 256),
    ("edge_m4095", 4095, 512, 256),
]
SERVED = {name for name, *_ in SHAPES[:7]}  # timed: the served shapes
KINDS = ("w8a8", "w4a8", "qint8", "int4")
ENTRY = {"w8a8": "flux2_w8a8_matmul", "w4a8": "flux2_w4a8_matmul", "qint8": "flux2_dequant_matmul",
         "int4": "flux2_dequant_matmul"}
PROLOGUE_ENTRY = "flux2_quantize_rows"  # csrc/quant_prologue.cu
REL_TOL = 1e-3


def typed_entries(lib) -> dict:
    """The C entries a library exports (the three quantized matmuls', the
    prologue's, or both), typed as ``ops.quant_kernels._kernel`` types them."""
    from flux2_tpu_torch.ops import quant_kernels as qk

    entries = {}
    for name, (n_ptrs, n_ints) in qk._SIGNATURES.items():
        fn = getattr(lib, name, None)
        if fn is not None:
            fn.argtypes = [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
            entries[name] = fn
    return entries


def entry_args(kind: str, x: torch.Tensor, qw) -> tuple:
    """The C entry's arguments before the stream for x [M, K] bf16 and a weight
    quantized in ``kind``: K5 and K6 take the activations quantized as their
    wrappers quantize them, K5 its wrapper's tile order on an H100."""
    from flux2_tpu_torch.ops import quant_kernels as qk

    m, k = x.shape
    n = qw.q.shape[0]
    if kind == "w8a8":
        return (*qk.quantize_rows(x), qw.q, qw.scale, m, n, k, 0, qk.w8a8_group(m, n, k))
    if kind == "w4a8":
        return (*qk.quantize_row_blocks(x, qw.block), qw.q, qw.scale, m, n, k, 0)
    return (x, qw.q, qw.scale, qw.bias, m, n, k, qw.group_size, int(kind == "int4"))


def quantize(kind: str, w: torch.Tensor):
    """w [N, K] bf16 in the kind's format."""
    from flux2_tpu_torch.ops import quant as tq

    return {"w8a8": tq.to_w8a8, "w4a8": tq.to_w4a8}.get(kind, lambda t: tq.quantize(t, kind))(w)


def call(fn, args, out: torch.Tensor) -> torch.Tensor:
    """One launch of a C entry on the arguments of ``quantized``; the output goes to ``out``."""
    tensors = [a for a in args if isinstance(a, torch.Tensor)]
    ints = [a for a in args if not isinstance(a, torch.Tensor)]
    if out.dtype == torch.float32:  # K5 / K6's out_f32 flag, after m, n, k
        ints[3] = 1
    err = fn(*(t.data_ptr() for t in tensors[:4]), out.data_ptr(), *ints, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"launch failed with cudaError {err}")
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--source", required=True, type=Path, action="append", help="a candidate .cu (repeatable)")
    parser.add_argument("--kinds", nargs="+", choices=(*KINDS, "prologue"), default=[*KINDS, "prologue"],
                        help="the kernels to check and time (default: all)")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("quant_candidate needs a CUDA device; torch.cuda.is_available() is False")
    from flux2_tpu_torch.ops import quant_kernels as qk
    from flux2_tpu_torch.utils.build import build_kernels
    from flux2_tpu_torch.utils.profile_step import _card

    card = _card()
    out_dir = Path(__file__).resolve().parents[2] / "build" / "candidate"
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(args.source) + 1) as pool:  # one nvcc per source, all at once
        shipped_job = pool.submit(build_kernels)
        built = list(pool.map(lambda src: build(src.resolve(), out_dir, {}), args.source))
        shipped = shipped_job.result()
    print(f"[build] {len(built)} source(s) and the library: {time.perf_counter() - t0:.2f} s", flush=True)
    variants = {"library": {name: qk._kernel(name) for name in qk._SIGNATURES}}
    for src, (_, report, lib_path) in zip(args.source, built):
        variants[src.stem] = typed_entries(ctypes.CDLL(str(lib_path)))
        for line in report.splitlines():
            if "registers" in line or "spill" in line or "C75" in line:
                print(f"[build] {src.stem}: {line.strip()}", flush=True)
        for kernel, top in sass_max_registers(lib_path).items():
            print(f"[build] {src.stem}: {kernel} names R0..R{top} in its SASS", flush=True)
    for line in shipped.log.splitlines():
        if "registers" in line or "spill" in line or "C75" in line or "Compiling entry" in line:
            print(f"[build] library: {line.strip()}", flush=True)
    for kernel, top in sass_max_registers(shipped.path).items():
        if "flash" not in kernel:
            print(f"[build] library: {kernel} names R0..R{top} in its SASS", flush=True)

    plain = {"w8a8": qk.w8a8_matmul_reference, "w4a8": qk.w4a8_matmul_reference,
             "qint8": qk.dequant_matmul_reference, "int4": qk.dequant_matmul_reference}
    gen = torch.Generator(device="cuda").manual_seed(1)
    ok = True
    timed = {}
    for name, m, k, n in SHAPES:
        for kind in (kind for kind in args.kinds if kind != "prologue"):
            mk = max(m, 8) if kind in ("qint8", "int4") else m  # K7's gate: at least 8 rows
            if kind == "w4a8" and n % 256:
                continue  # the K6 gate asks N % 256
            x = torch.randn(mk, k, device="cuda", generator=gen).bfloat16()
            w = (torch.randn(n, k, device="cuda", generator=gen) * k**-0.5).bfloat16()
            qw = quantize(kind, w)
            c_args = entry_args(kind, x, qw)
            out_types = (torch.bfloat16, torch.float32) if kind in ("w8a8", "w4a8") else (torch.bfloat16,)
            first = {}
            for label, entries in variants.items():
                if ENTRY[kind] not in entries:
                    continue
                for dtype in out_types:
                    ref = plain[kind](x.to(dtype), qw)
                    out = call(entries[ENTRY[kind]], c_args, torch.empty(mk, n, device="cuda", dtype=dtype))
                    again = call(entries[ENTRY[kind]], c_args, torch.empty_like(out))
                    torch.cuda.synchronize()
                    rel = float((out.float() - ref.float()).norm() / ref.float().norm())
                    exact = torch.equal(out, ref)
                    repeat = torch.equal(out, again)
                    lib_equal = torch.equal(out, first.setdefault(dtype, out))
                    good = (bool(torch.isfinite(out).all()) and rel <= REL_TOL and repeat
                            and (exact or kind in ("qint8", "int4")))
                    ok &= good
                    print(f"[check] {label} {kind} {name} (M,K,N)=({mk},{k},{n}) out {str(dtype)[6:]}: rel_l2 "
                          f"{rel:.3e} (tol {REL_TOL}), equal to plain {exact}, repeat equal {repeat}, equal to the "
                          f"library {lib_equal} {'ok' if good else 'FAIL'} [{card}]", flush=True)
            if name in SERVED:
                timed[(name, kind)] = (mk, k, n, c_args)
            del x, w, qw
        torch.cuda.empty_cache()

    order = list(variants.items())
    order += order[::-1]
    for (name, kind), (m, k, n, c_args) in timed.items():
        out = torch.empty(m, n, device="cuda", dtype=torch.bfloat16)
        times = []
        for label, entries in ((label, e) for label, e in order if ENTRY[kind] in e):
            launch = lambda: call(entries[ENTRY[kind]], c_args, out)  # noqa: E731
            times.append((label, time_ms(launch), kernel_time_ms(launch)))
        print(f"[time] {kind} {name} (M,K,N)=({m},{k},{n}), CUDA events (device time alone): " + ", ".join(
            f"{label} {ms:.4f} ms ({dev:.4f}; {2.0 * m * n * k / dev / 1e9:.1f} TOPS)" for label, ms, dev in times)
            + f" [{card}]", flush=True)
    if "prologue" in args.kinds:
        ok &= check_prologue(order, gen, card)
    print_host_times(gen, card)
    return 0 if ok else 1


def check_prologue(order, gen, card: str) -> bool:
    """Each variant's prologue (in ``order``, library and candidates, there and
    back) against the plain chain at the served shapes, per row (K5) and per
    512-block (K6), bf16 x: codes and scales must be equal to the bit. Prints
    each one's device time alone, in turns."""
    from flux2_tpu_torch.ops import quant_kernels as qk

    ok = True
    for name, m, k, _ in SHAPES[:7]:
        for block in sorted({k, 512}, reverse=True):
            x = torch.randn(m, k, device="cuda", generator=gen).bfloat16()
            ref_q, ref_s = qk.quantize_row_blocks(x, block)
            xq, xs = torch.empty_like(ref_q), torch.empty_like(ref_s)

            def launch(fn):
                err = fn(x.data_ptr(), xq.data_ptr(), xs.data_ptr(), m, k, block, 0,
                         torch.cuda.current_stream().cuda_stream)
                if err != 0:
                    raise RuntimeError(f"prologue launch failed with cudaError {err}")

            times = []
            for label, entries in ((label, e) for label, e in order if PROLOGUE_ENTRY in e):
                xq.zero_()
                xs.zero_()
                launch(entries[PROLOGUE_ENTRY])
                torch.cuda.synchronize()
                equal = torch.equal(xq, ref_q) and torch.equal(xs, ref_s)
                ok &= equal
                ms = kernel_time_ms(lambda: launch(entries[PROLOGUE_ENTRY]))
                times.append(f"{label} {ms:.4f} ms{'' if equal else ' FAIL (not equal to the plain chain)'}")
            print(f"[prologue] {name} (M,K)=({m},{k}) block {block}, device time alone: " + ", ".join(times)
                  + f" [{card}]", flush=True)
    return ok


def host_us(fn, calls: int = 300) -> float:
    """Host time of one call (us) over back-to-back calls with no synchronisation between them."""
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    host = time.perf_counter() - t0
    torch.cuda.synchronize()
    return host / calls * 1e6


def print_host_times(gen, card: str) -> None:
    """The host's time per call of the shipped wrappers at a shape where the
    card's time is small (16, 512, 2560), beside F.linear on the same x: what
    a quantized matmul costs the host, which bounds the smallest steps."""
    import torch.nn.functional as F

    from flux2_tpu_torch.ops import quant_kernels as qk

    x = torch.randn(16, 512, device="cuda", generator=gen).bfloat16()
    w = (torch.randn(2560, 512, device="cuda", generator=gen) * 512**-0.5).bfloat16()
    w8, w4 = quantize("w8a8", w), quantize("w4a8", w)
    c_args = entry_args("w8a8", x, w8)
    out = torch.empty(16, 2560, device="cuda", dtype=torch.bfloat16)
    k5 = qk._kernel(ENTRY["w8a8"])
    times = {"F.linear (bf16)": host_us(lambda: F.linear(x, w)), "w8a8_matmul": host_us(lambda: qk.w8a8_matmul(x, w8)),
             "w4a8_matmul": host_us(lambda: qk.w4a8_matmul(x, w4)),
             "quantize_activations": host_us(lambda: qk.quantize_activations(x, 512)),
             "K5's C entry through call()": host_us(lambda: call(k5, c_args, out))}
    print("[host] us of host a call at (M,K,N)=(16,512,2560): " + ", ".join(f"{k} {v:.1f}" for k, v in times.items())
          + f" [{card}]", flush=True)


if __name__ == "__main__":
    sys.exit(main())
