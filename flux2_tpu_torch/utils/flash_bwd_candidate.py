"""Check and time candidate sources of the flash-attention backward (K3/K4) on one CUDA card.

    python3 -m flux2_tpu_torch.utils.flash_bwd_candidate --source a.cu [--source b.cu ...]

Builds each ``--source`` on its own with the port's nvcc flags, all at once
(``flash_fwd_candidate.build``; a source must define the C entries
``flux2_flash_attention_bwd_dq`` and ``flux2_flash_attention_bwd_dkv`` with the
signatures of ``csrc/flash_attention_bwd.cu``), into ``build/candidate/``,
and prints ptxas's registers and spills and the highest register each
kernel's SASS names (``cuobjdump -sass``: ptxas reports a warp-specialised
kernel's launch count, not what a branch after ``setmaxnreg`` uses), for the
candidates and for the library built from the checkout's ``csrc/``. Then it
checks the library's and each candidate's K3 and K4 against
``flash_attention_grads_reference`` at the training shapes ``chip_smoke.py``
checks (relative L2 of dq, dk and dv within 1e-2; the forward's out and LSE
come from the library's K2), checks that a second call gives the same bits,
says whether each candidate's gradients equal the library's bit for bit (as
a refactor's should), and times the candidates beside the library's K3 and K4 in one process, in
turns (library, candidates, candidates in reverse, library), with CUDA
events at three sequence lengths. It is how a redesign of the backward is
compared with the current kernels before it replaces
``csrc/flash_attention_bwd.cu``. Every line carries the card's name and
power limit; the exit code is 1 if a check fails.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import re
import subprocess
import sys
import time
from pathlib import Path

import torch

from flux2_tpu_torch.utils.flash_fwd_candidate import build, time_ms

CASES = [  # (name, q shape, k/v shape, span), as chip_smoke.TRAIN_ATTENTION_CASES
    ("train_512px", (1, 24, 1056, 128), (1, 24, 1056, 128), None),
    ("klein4b_1024px", (1, 24, 4608, 128), (1, 24, 4608, 128), None),
    ("train_512px_txt512_bs2", (2, 24, 1536, 128), (2, 24, 1536, 128), None),
    ("blocked_span", (1, 4, 320, 128), (1, 4, 704, 128), (64, 192, 400)),
    ("one_row_tails", (1, 24, 897, 128), (1, 24, 897, 128), None),
    ("span_mid_tile", (1, 24, 2560, 128), (1, 24, 2560, 128), (100, 1300, 1000)),
    ("ragged_q_ne_k", (1, 24, 777, 128), (1, 24, 1000, 128), None),
]
TIMED_SEQ = (1056, 4128, 4608)  # 512^2 and 1024^2 training, 1024^2 serving
REL_TOL = 1e-2
SYMBOLS = {"flux2_flash_attention_bwd_dq": 7, "flux2_flash_attention_bwd_dkv": 8}


def sass_max_registers(lib_path: Path) -> dict:
    """The highest general register each kernel's SASS names, by mangled name."""
    from flux2_tpu_torch.utils import build as kbuild

    cuobjdump = Path(kbuild._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib_path)], capture_output=True, text=True).stdout
    regs, name = {}, None
    for line in sass.splitlines():
        found = re.search(r"Function : (\S+)", line)
        if found:
            name = found.group(1)
            regs[name] = -1
        elif name is not None:
            for r in re.findall(r"\bR(\d+)\b", line):
                regs[name] = max(regs[name], int(r))
    return regs


def backward(entries, q, k, v, dout, lse, delta, scale, span, which: str):
    """One call of a K3 (``which`` "dq": dq) or K4 ("dkv": (dk, dv)) entry."""
    b, h, s_q, d = q.shape
    q0, q1, k0 = span if span is not None else (0, 0, 0)
    outs = (torch.empty_like(q),) if which == "dq" else (torch.empty_like(k), torch.empty_like(v))
    name = f"flux2_flash_attention_bwd_{which}"
    ptrs = [t.data_ptr() for t in (q, k, v, dout, lse, delta, *outs)]
    err = entries[name](*ptrs, b * h, s_q, k.shape[2], d, float(scale), q0, q1, k0, int(span is not None),
                        torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name}: launch failed with cudaError {err}")
    return outs


def _inputs(gen, qs, ks, span):
    from flux2_tpu_torch.ops import flash_attention as fa

    q = torch.randn(*qs, device="cuda", generator=gen).bfloat16()
    k = torch.randn(*ks, device="cuda", generator=gen).bfloat16()
    v = torch.randn(*ks, device="cuda", generator=gen).bfloat16()
    dout = torch.randn(*qs, device="cuda", generator=gen).bfloat16()
    scale = qs[-1] ** -0.5
    out, lse = fa.flash_attention_lse(q, k, v, scale, span)
    delta = (dout.float() * out.float()).sum(-1)
    return q, k, v, dout, lse, delta, scale


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--source", required=True, type=Path, action="append", help="a candidate .cu (repeatable)")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("flash_bwd_candidate needs a CUDA device; torch.cuda.is_available() is False")
    from flux2_tpu_torch.ops import flash_attention as fa
    from flux2_tpu_torch.utils.profile_step import _card

    card = _card()
    out_dir = Path(__file__).resolve().parents[2] / "build" / "candidate"
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(args.source)) as pool:  # one nvcc per source, all at once
        built = list(pool.map(lambda src: build(src.resolve(), out_dir, SYMBOLS), args.source))
    print(f"[build] {len(built)} source(s): {time.perf_counter() - t0:.2f} s", flush=True)
    candidates = {}
    for src, (entries, report, lib_path) in zip(args.source, built):
        candidates[src.stem] = entries
        for line in report.splitlines():
            if "registers" in line or "spill" in line or "C75" in line:
                print(f"[build] {src.stem}: {line.strip()}", flush=True)
        for kernel, top in sass_max_registers(lib_path).items():
            print(f"[build] {src.stem}: {kernel} names R0..R{top} in its SASS", flush=True)
    from flux2_tpu_torch.utils.build import build_kernels

    shipped = build_kernels()
    for line in shipped.log.splitlines():
        if "registers" in line or "spill" in line or "C75" in line or "Compiling entry" in line:
            print(f"[build] library: {line.strip()}", flush=True)
    for kernel, top in sass_max_registers(shipped.path).items():
        if "flash" in kernel:
            print(f"[build] library: {kernel} names R0..R{top} in its SASS", flush=True)
    library = {name: fa._entry(name, n_ptr) for name, n_ptr in SYMBOLS.items()}

    gen = torch.Generator(device="cuda").manual_seed(0)
    ok = True
    for name, qs, ks, span in CASES:
        q, k, v, dout, lse, delta, scale = _inputs(gen, qs, ks, span)
        refs = fa.flash_attention_grads_reference(q, k, v, dout, scale, span)
        first = None
        for label, entries in [("library", library), *candidates.items()]:
            grads = backward(entries, q, k, v, dout, lse, delta, scale, span, "dq") + backward(
                entries, q, k, v, dout, lse, delta, scale, span, "dkv")
            again = backward(entries, q, k, v, dout, lse, delta, scale, span, "dq") + backward(
                entries, q, k, v, dout, lse, delta, scale, span, "dkv")
            torch.cuda.synchronize()
            errs = [float((g.float() - r.float()).norm() / r.float().norm()) for g, r in zip(grads, refs)]
            same = all(torch.equal(a, b) for a, b in zip(grads, again))
            first = first or grads
            lib_equal = all(torch.equal(a, b) for a, b in zip(grads, first))
            good = all(bool(torch.isfinite(g).all()) for g in grads) and max(errs) <= REL_TOL and same
            ok &= good
            print(f"[check] {label} {name} q={list(qs)} k={list(ks)} span={span}: rel_l2 dq {errs[0]:.3e} dk "
                  f"{errs[1]:.3e} dv {errs[2]:.3e} (tol {REL_TOL}), repeat bitwise equal {same}, equal to the "
                  f"library's {lib_equal} {'ok' if good else 'FAIL'} [{card}]", flush=True)
        del q, k, v, dout, lse, delta, refs, first
        torch.cuda.empty_cache()

    order = [("library", library)] + list(candidates.items())
    order += order[::-1]
    for s in TIMED_SEQ:
        q, k, v, dout, lse, delta, scale = _inputs(gen, (1, 24, s, 128), (1, 24, s, 128), None)
        flop = 2.0 * 24 * s * s * 128  # one S x S x 128 product
        for which, products in (("dq", 3), ("dkv", 4)):
            times = [(label, time_ms(lambda: backward(entries, q, k, v, dout, lse, delta, scale, None, which)))
                     for label, entries in order]
            kernel = "K3" if which == "dq" else "K4"
            print(f"[time] {kernel} (1, 24, {s}, 128): " + ", ".join(
                f"{label} {ms:.4f} ms ({products * flop / ms / 1e9:.1f} TFLOP/s)" for label, ms in times)
                + f" [{card}]", flush=True)
        del q, k, v, dout, lse, delta
        torch.cuda.empty_cache()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
