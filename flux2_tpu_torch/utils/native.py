"""Host image ops of the chains: the port of ``flux2_tpu/utils/native.py``.

``area_resize``, ``resize_bilinear``, ``u8_to_f32``, ``f32_to_u8``,
``dilate_ramp`` and ``soft_composite`` run the repository's C++ library
(``native/image_ops.cpp``) through ctypes where ``g++`` can build it, and
otherwise numpy code with the same semantics (JAX's own fallback, kept as it
is). The port builds the library itself, once, into ``build/native/`` at the
repository root, named by a hash of the source and flags; it never writes
under ``native/`` and never loads a library found there. No flag ties the
build to the host's CPU (no ``-march=native``), so a build directory copied
to another machine still loads there. This is host preprocessing: nothing
here runs on the card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

SOURCE = Path(__file__).resolve().parents[2] / "native" / "image_ops.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-Wall")

_lib: Optional[ctypes.CDLL] = None
_tried = False
_lock = threading.Lock()

_f32p = ctypes.POINTER(ctypes.c_float)
_u8p = ctypes.POINTER(ctypes.c_uint8)


def library_path() -> Path:
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode() + SOURCE.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"libflux2_image_ops-{digest}.so"


def _build() -> Optional[Path]:
    """The library for this source, built with ``g++`` unless it exists; None
    where the source or the compiler is missing or the build fails. The
    compiler writes a file of its own, renamed into place, so that processes
    building at once never load a half-written library."""
    if not SOURCE.exists():
        return None
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    try:
        subprocess.run([os.environ.get("CXX", "g++"), *CXX_FLAGS, "-o", str(tmp), str(SOURCE)], check=True,
                       capture_output=True, timeout=120)
        os.replace(tmp, out)
    except (OSError, subprocess.SubprocessError):
        tmp.unlink(missing_ok=True)
        return None
    return out


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        path = _build()
        if path is None:
            return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError:
            return None
        lib.area_resize_f32.argtypes = [_f32p, ctypes.c_int, ctypes.c_int, _f32p, ctypes.c_int, ctypes.c_int]
        lib.resize_bilinear_f32.argtypes = [_f32p, ctypes.c_int, ctypes.c_int, ctypes.c_int, _f32p, ctypes.c_int,
                                            ctypes.c_int]
        lib.u8_to_f32.argtypes = [_u8p, _f32p, ctypes.c_longlong]
        lib.f32_to_u8.argtypes = [_f32p, _u8p, ctypes.c_longlong]
        lib.soft_composite_f32.argtypes = [_f32p, _f32p, _f32p, _f32p, ctypes.c_int, ctypes.c_int, ctypes.c_int]
        lib.dilate_ramp_f32.argtypes = [_f32p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, _f32p, _f32p]
        for fn in (lib.area_resize_f32, lib.resize_bilinear_f32, lib.u8_to_f32, lib.f32_to_u8,
                   lib.soft_composite_f32, lib.dilate_ramp_f32):
            fn.restype = None
        _lib = lib
        return _lib


def available() -> bool:
    """Whether the C++ library runs (else every function takes its numpy path)."""
    return _load() is not None


def path_name() -> str:
    """Which path the ops take here: the library's file name, or "numpy"."""
    return library_path().name if available() else "numpy"


def _fp(a: np.ndarray):
    return a.ctypes.data_as(_f32p)


def area_resize(plane: np.ndarray, dh: int, dw: int) -> np.ndarray:
    """Exact box-filter resample of a [H, W] f32 plane to [dh, dw]."""
    plane = np.ascontiguousarray(plane, np.float32)
    sh, sw = plane.shape
    lib = _load()
    if lib is not None:
        out = np.empty((dh, dw), np.float32)
        lib.area_resize_f32(_fp(plane), sh, sw, _fp(out), dh, dw)
        return out
    ys = np.linspace(0, sh, dh + 1).astype(int)
    xs = np.linspace(0, sw, dw + 1).astype(int)
    out = np.empty((dh, dw), np.float32)
    for i in range(dh):
        for j in range(dw):
            cell = plane[ys[i] : max(ys[i] + 1, ys[i + 1]), xs[j] : max(xs[j] + 1, xs[j + 1])]
            out[i, j] = cell.mean()
    return out


def resize_bilinear(image: np.ndarray, dh: int, dw: int) -> np.ndarray:
    """Bilinear resample of a [H, W, C] f32 image (half-pixel centers)."""
    image = np.ascontiguousarray(image, np.float32)
    sh, sw, c = image.shape
    lib = _load()
    out = np.empty((dh, dw, c), np.float32)
    if lib is not None:
        lib.resize_bilinear_f32(_fp(image), sh, sw, c, _fp(out), dh, dw)
        return out
    fy = (np.arange(dh) + 0.5) * sh / dh - 0.5
    fx = (np.arange(dw) + 0.5) * sw / dw - 0.5
    y0 = np.clip(np.floor(fy).astype(int), 0, sh - 1)
    x0 = np.clip(np.floor(fx).astype(int), 0, sw - 1)
    y1 = np.clip(y0 + 1, 0, sh - 1)
    x1 = np.clip(x0 + 1, 0, sw - 1)
    wy = np.clip(fy - np.floor(fy), 0, 1)[:, None, None]
    wx = np.clip(fx - np.floor(fx), 0, 1)[None, :, None]
    top = image[y0][:, x0] * (1 - wx) + image[y0][:, x1] * wx
    bot = image[y1][:, x0] * (1 - wx) + image[y1][:, x1] * wx
    return (top * (1 - wy) + bot * wy).astype(np.float32)


def u8_to_f32(image: np.ndarray) -> np.ndarray:
    image = np.ascontiguousarray(image, np.uint8)
    lib = _load()
    if lib is not None:
        out = np.empty(image.shape, np.float32)
        lib.u8_to_f32(image.ctypes.data_as(_u8p), _fp(out), image.size)
        return out
    return image.astype(np.float32) / 255.0


def f32_to_u8(image: np.ndarray) -> np.ndarray:
    image = np.ascontiguousarray(image, np.float32)
    lib = _load()
    if lib is not None:
        out = np.empty(image.shape, np.uint8)
        lib.f32_to_u8(_fp(image), out.ctypes.data_as(_u8p), image.size)
        return out
    return np.clip(image * 255.0 + 0.5, 0, 255).astype(np.uint8)


def dilate_ramp(mask: np.ndarray, dilation: int, ramp: int) -> Optional[np.ndarray]:
    """Square-element dilation and a linear inward edge ramp of a [H, W] mask
    (two chamfer distance transforms in C++). None where the library does not
    run: callers keep their own slower fallback, as JAX's do."""
    lib = _load()
    if lib is None:
        return None
    mask = np.ascontiguousarray(mask, np.float32)
    h, w = mask.shape
    tmp = np.empty((2, h, w), np.float32)
    out = np.empty((h, w), np.float32)
    lib.dilate_ramp_f32(_fp(mask), h, w, int(dilation), int(ramp), _fp(tmp), _fp(out))
    return out


def soft_composite(orig: np.ndarray, gen: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """out = m*gen + (1-m)*orig for [H, W, C] images and a [H, W] mask."""
    orig = np.ascontiguousarray(orig, np.float32)
    gen = np.ascontiguousarray(gen, np.float32)
    mask = np.ascontiguousarray(mask, np.float32)
    h, w, c = orig.shape
    lib = _load()
    if lib is not None:
        out = np.empty_like(orig)
        lib.soft_composite_f32(_fp(orig), _fp(gen), _fp(mask), _fp(out), h, w, c)
        return out
    return mask[..., None] * gen + (1 - mask[..., None]) * orig
