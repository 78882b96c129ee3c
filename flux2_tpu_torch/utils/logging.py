"""Leveled logger with a loggability gate: the port's own copy of
``flux2_tpu/utils/logging.py``.

Parity with ``Sources/Flux2Core/Utils/Flux2Debug.swift``: levels
verbose/info/warning/error, an ``is_loggable`` gate so debug-only expensive
computations (device stats, tensor reductions) are skipped when the print
would be filtered, and ``timed`` helpers. Level via env ``FLUX2_LOG_LEVEL``.
"""

from __future__ import annotations

import contextlib
import os
import sys
import time
from typing import Iterator

LEVELS = {"verbose": 0, "info": 1, "warning": 2, "error": 3, "off": 4}

_level = LEVELS.get(os.environ.get("FLUX2_LOG_LEVEL", "info").lower(), 1)


def set_level(name: str) -> None:
    global _level
    _level = LEVELS[name.lower()]


def is_loggable(name: str) -> bool:
    return LEVELS[name] >= _level


def _emit(tag: str, msg: str) -> None:
    print(f"[flux2:{tag}] {msg}", file=sys.stderr, flush=True)


def verbose(msg: str) -> None:
    if is_loggable("verbose"):
        _emit("verbose", msg)


def info(msg: str) -> None:
    if is_loggable("info"):
        _emit("info", msg)


def warning(msg: str) -> None:
    if is_loggable("warning"):
        _emit("warn", msg)


def error(msg: str) -> None:
    if is_loggable("error"):
        _emit("error", msg)


@contextlib.contextmanager
def timed(label: str, level: str = "info") -> Iterator[None]:
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if is_loggable(level):
            _emit(level, f"{label}: {time.perf_counter() - t0:.3f}s")
