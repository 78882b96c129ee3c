"""Build and load the port's CUDA kernels.

Every ``*.cu`` under ``flux2_tpu_torch/csrc/`` is compiled by its own
``nvcc`` for ``sm_90a`` (Hopper), all at once, and the objects are linked into
one shared library with a plain C interface, loaded with ``ctypes``. The library lands in ``build/kernels/`` at the
repository root, named by a hash of the sources and flags, so a changed
source rebuilds and an unchanged one loads at once. Nothing is built when a
module is imported: the first kernel launch builds.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


@dataclasses.dataclass(frozen=True)
class BuildResult:
    path: Path
    seconds: float  # 0.0 when the library was already built
    log: str  # nvcc's stderr (ptxas register / shared-memory / spill report)


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise FileNotFoundError(f"nvcc not found on PATH or under {cuda_home}/bin")


def _sources() -> list:
    return sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh"))


def library_path() -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"libflux2_kernels-{digest.hexdigest()[:16]}.so"


def build_kernels() -> BuildResult:
    """Compile the kernel library unless a build of these sources exists."""
    out = library_path()
    if out.exists():
        return BuildResult(out, 0.0, "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    nvcc = _nvcc()
    t0 = time.perf_counter()
    compiles = []  # one nvcc per source, all running at once
    for src in (s for s in _sources() if s.suffix == ".cu"):
        obj = BUILD_DIR / f"{tag}.{src.stem}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        compiles.append((cmd, obj, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    logs, failed = [], None
    for cmd, _, proc in compiles:
        _, err = proc.communicate()
        logs.append(err)
        if proc.returncode != 0 and failed is None:
            failed = f"nvcc failed with code {proc.returncode}:\n{' '.join(cmd)}\n{err}"
    tmp = out.with_name(f"{tag}.so.tmp")
    try:
        if failed is None:
            link = [nvcc, "-shared", "-o", str(tmp), *(str(obj) for _, obj, _ in compiles)]
            proc = subprocess.run(link, capture_output=True, text=True)
            if proc.returncode != 0:
                failed = f"nvcc link failed with code {proc.returncode}:\n{' '.join(link)}\n{proc.stderr}"
        if failed is not None:
            raise RuntimeError(failed)
        os.replace(tmp, out)  # atomic: a concurrent loader never sees a partial file
    finally:
        tmp.unlink(missing_ok=True)
        for _, obj, _ in compiles:
            obj.unlink(missing_ok=True)
    return BuildResult(out, time.perf_counter() - t0, "".join(logs))


@functools.lru_cache(maxsize=None)
def load_kernels() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed. Each kernel's wrapper
    declares its C entry's argument types."""
    return ctypes.CDLL(str(build_kernels().path))
