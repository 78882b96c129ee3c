"""Check and time candidate sources of the quantized matmuls (K5, K6, K7) on one CUDA card.

    python3 -m flux2_tpu_torch.utils.quant_candidate --source a.cu [--source b.cu ...]

Builds each ``--source`` on its own with the port's nvcc flags, all at once
(``flash_fwd_candidate.build``; a source is a working copy of
``csrc/quant_matmul.cu`` with its three C entries, and finds the headers of
``csrc/`` through ``-I``), into ``build/candidate/``, and prints ptxas's
registers and spills and the highest register each kernel's SASS names, for
the candidates and for the library built from the checkout's ``csrc/``. Then
it checks the library's and each candidate's K5, K6 and K7 (qint8, int4)
against their plain versions at the seven served shapes ``chip_smoke.py``
checks and at four edge shapes (relative L2 within 1e-3; K5 and K6 must equal
their plain versions to the bit, K6 in both of its output types), says
whether each candidate's outputs equal the library's bit for bit, and times
the kernels alone (activations quantized beforehand) in one process, in turns
(library, candidates, candidates in reverse, library), with CUDA events. It
is how a redesign of a quantized matmul is compared with the current kernels
before it replaces ``csrc/quant_matmul.cu``. Every line carries the card's
name and power limit; the exit code is 1 if a check fails.
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
REL_TOL = 1e-3


def typed_entries(lib) -> dict:
    """The three C entries of a quantized-matmul library, typed as ``ops.quant_kernels._kernel`` types them."""
    entries = {}
    for name in set(ENTRY.values()):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * (5 if name == "flux2_dequant_matmul" else 4) + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        entries[name] = fn
    return entries


def entry_args(kind: str, x: torch.Tensor, qw) -> tuple:
    """The C entry's arguments before the stream for x [M, K] bf16 and a weight
    quantized in ``kind``: K5 and K6 take the activations quantized as their
    wrappers quantize them."""
    from flux2_tpu_torch.ops import quant_kernels as qk

    m, k = x.shape
    n = qw.q.shape[0]
    if kind == "w8a8":
        return (*qk.quantize_rows(x), qw.q, qw.scale, m, n, k, 0)
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
    if out.dtype == torch.float32:  # K5 / K6's out_f32 flag
        ints[-1] = 1
    err = fn(*(t.data_ptr() for t in tensors[:4]), out.data_ptr(), *ints, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"launch failed with cudaError {err}")
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--source", required=True, type=Path, action="append", help="a candidate .cu (repeatable)")
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
    variants = {"library": {name: qk._kernel(name) for name in set(ENTRY.values())}}
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
        for kind in KINDS:
            mk = max(m, 8) if kind in ("qint8", "int4") else m  # K7's gate: at least 8 rows
            if kind == "w4a8" and n % 256:
                continue  # the K6 gate asks N % 256
            x = torch.randn(mk, k, device="cuda", generator=gen).bfloat16()
            w = (torch.randn(n, k, device="cuda", generator=gen) * k**-0.5).bfloat16()
            qw = quantize(kind, w)
            c_args = entry_args(kind, x, qw)
            out_types = (torch.bfloat16, torch.float32) if kind == "w4a8" else (torch.bfloat16,)
            first = {}
            for label, entries in variants.items():
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
        times = [(label, time_ms(lambda: call(entries[ENTRY[kind]], c_args, out))) for label, entries in order]
        print(f"[time] {kind} {name} (M,K,N)=({m},{k},{n}): " + ", ".join(
            f"{label} {ms:.4f} ms ({2.0 * m * n * k / ms / 1e9:.1f} TOPS)" for label, ms in times)
            + f" [{card}]", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
