"""safetensors IO with payload-integrity validation: the port's own copy of
``flux2_tpu/io/safetensors_io.py`` (files written by either load through
the other, tested in ``tests/test_torch_shared_copies.py``).

Wraps the ``safetensors`` package for plain load/save and adds the
reference's truncation guard (PrequantizedCheckpoint.swift:108-142): a
checkpoint whose payload is shorter than its header's ``data_offsets`` claim
would otherwise silently produce uninitialized weights, so completeness is
validated BEFORE any model state is touched.
"""

from __future__ import annotations

import json
import os
import struct
import tempfile
from typing import Any, Dict, Optional

import numpy as np
from safetensors import safe_open
from safetensors.numpy import save_file as _st_save


def read_header(path: str) -> Dict[str, Any]:
    """Parse the raw JSON header (without loading tensors)."""
    with open(path, "rb") as f:
        header_len = struct.unpack("<Q", f.read(8))[0]
        return json.loads(f.read(header_len))


def payload_is_complete(path: str) -> bool:
    """True iff the file's byte length covers the header's max data_offset."""
    try:
        with open(path, "rb") as f:
            header_len = struct.unpack("<Q", f.read(8))[0]
            header = json.loads(f.read(header_len))
    except Exception:
        return False
    max_end = 0
    for key, meta in header.items():
        if key == "__metadata__":
            continue
        offs = meta.get("data_offsets")
        if offs:
            max_end = max(max_end, offs[1])
    return os.path.getsize(path) >= 8 + header_len + max_end


def load_file(path: str, validate: bool = True) -> Dict[str, np.ndarray]:
    if validate and not payload_is_complete(path):
        raise ValueError(
            f"safetensors payload incomplete: {path} — refusing to load "
            "(truncated checkpoints silently yield uninitialized weights)"
        )
    out: Dict[str, np.ndarray] = {}
    with safe_open(path, framework="numpy") as f:
        for key in f.keys():
            out[key] = f.get_tensor(key)
    return out


def load_metadata(path: str) -> Dict[str, str]:
    header = read_header(path)
    return header.get("__metadata__", {}) or {}


def tensor_names(path: str) -> list:
    return [k for k in read_header(path) if k != "__metadata__"]


def save_file(
    tensors: Dict[str, np.ndarray], path: str, metadata: Optional[Dict[str, str]] = None
) -> None:
    """Atomic save: write to a temp file in the target dir, then rename."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(os.path.abspath(path)), suffix=".tmp")
    os.close(fd)
    try:
        _st_save({k: np.ascontiguousarray(v) for k, v in tensors.items()}, tmp, metadata=metadata)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
