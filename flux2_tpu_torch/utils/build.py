"""Build and load the port's CUDA kernels.

Every ``*.cu`` under ``flux2_tpu_torch/csrc/`` is compiled by ``nvcc`` into
one shared library with a plain C interface, for ``sm_90a`` (Hopper), and
loaded with ``ctypes``. The library lands in ``build/kernels/`` at the
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
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
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
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *(str(s) for s in _sources() if s.suffix == ".cu")]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed with code {proc.returncode}:\n{' '.join(cmd)}\n{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent loader never sees a partial file
    return BuildResult(out, seconds, proc.stderr)


@functools.lru_cache(maxsize=None)
def load_kernels() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed. Each kernel's wrapper
    declares its C entry's argument types."""
    return ctypes.CDLL(str(build_kernels().path))
