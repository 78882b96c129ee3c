"""Checkpoint directories: every ``*.safetensors`` in a directory as one set of
named tensors. Port of the directory half of ``flux2_tpu/io/checkpoints.py``
(``load_weights_dir``, ``:38-46``), so a sharded Diffusers directory loads as
one checkpoint. Tensors are torch tensors in their stored dtype.

``WeightsDir`` is the lazy form the loaders use: it reads every file's header
and checks every payload up front (a truncated file is refused before any
module is touched), then reads each tensor from its file when asked, so the
host holds one tensor at a time rather than a whole checkpoint.

Prequantized load and export (``:166-224``) are not ported yet.
"""

from __future__ import annotations

import os
from collections.abc import Mapping
from typing import Dict, Iterator, List

import torch
from safetensors import safe_open

from flux2_tpu_torch.io import safetensors_io


def safetensors_files(path: str) -> List[str]:
    files = sorted(f for f in os.listdir(path) if f.endswith(".safetensors"))
    if not files:
        raise FileNotFoundError(f"no safetensors files in {path}")
    return [os.path.join(path, f) for f in files]


class WeightsDir(Mapping):
    """Read-only name -> tensor view of a checkpoint directory; keys in file
    order, each tensor read from its file on access."""

    def __init__(self, path: str):
        self.path = path
        self.files = safetensors_files(path)
        for f in self.files:
            safetensors_io.check_complete(f)
        self._index: Dict[str, int] = {}
        for i, f in enumerate(self.files):
            for name in safetensors_io.tensor_names(f):
                self._index[name] = i
        self._handles = [safe_open(f, framework="pt") for f in self.files]

    def __getitem__(self, key: str) -> torch.Tensor:
        return self._handles[self._index[key]].get_tensor(key)

    def __contains__(self, key: object) -> bool:
        return key in self._index

    def __iter__(self) -> Iterator[str]:
        return iter(self._index)

    def __len__(self) -> int:
        return len(self._index)


def load_weights_dir(path: str) -> Dict[str, torch.Tensor]:
    """Merge all safetensors files in a directory into one flat dict."""
    return dict(WeightsDir(path))
