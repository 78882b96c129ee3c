"""Checkpoint directories: every ``*.safetensors`` in a directory as one set of
named tensors. Port of the directory half of ``flux2_tpu/io/checkpoints.py``
(``load_weights_dir``, ``:38-46``), so a sharded Diffusers directory loads as
one checkpoint. Tensors are torch tensors in their stored dtype.

``WeightsDir`` is the lazy form the loaders use: it reads every file's header
and checks every payload up front (a truncated file is refused before any
module is touched), then reads each tensor from its file when asked, so the
host holds one tensor at a time rather than a whole checkpoint.

The prequantized half (``:48-224``): ``export_prequantized`` writes a
quantized DiT at ``<model>/tpu-prequantized/<fmt>/transformer.safetensors``
in JAX's flat names and layout (``flatten_transformer``: ``"double_blocks/
to_q##q"`` stacked [L, K(/2), N], ``##scale``, ``##bias`` and the
``quant:<path>`` metadata JSON), with the source checkpoint's fingerprint
and a ``lora_baked`` tag, atomically; ``load_prequantized`` refuses an
incomplete payload before it reads any tensor and a stale fingerprint, with
JAX's messages, and returns JAX's tree (``load_flat_pytree``: nested dicts,
a ``StoredQTensor`` record per quantized leaf); ``transformer_from_tree``
makes the port's DiT of it on a device. So either package reads the other's
file. Only storage formats are written: a runtime W8A8 / W4A8 weight raises.
"""

from __future__ import annotations

import dataclasses
import json
import os
from collections.abc import Mapping
from typing import Any, Dict, Iterator, List, Optional, Tuple

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


# ---------------------------------------------------------------------------
# Prequantized checkpoints (JAX's flat names and layout)
# ---------------------------------------------------------------------------

PREQUANT_DIRNAME = "tpu-prequantized"

# The port's top-level DiT weights -> their paths in JAX's parameter tree.
_TOP_PATHS = {
    "x_embedder": "x_embedder/kernel",
    "context_embedder": "context_embedder/kernel",
    "time_linear1": "time_embed/linear1",
    "time_linear2": "time_embed/linear2",
    "guidance_linear1": "guidance_embed/linear1",
    "guidance_linear2": "guidance_embed/linear2",
    "double_mod_img": "double_mod_img/kernel",
    "double_mod_txt": "double_mod_txt/kernel",
    "single_mod": "single_mod/kernel",
    "norm_out": "norm_out/kernel",
    "proj_out": "proj_out/kernel",
}
_STACKS = ("double_blocks", "single_blocks")


@dataclasses.dataclass
class StoredQTensor:
    """A stored quantized leaf as a prequantized file holds it, in JAX's
    layout (codes [.., K(/2), N], scale and bias [.., K/g, N]): the fields of
    JAX's ``QTensor``, which ``io/jax_params`` carries into the port's."""

    q: torch.Tensor
    scale: torch.Tensor
    bias: Optional[torch.Tensor]
    format: str
    group_size: int
    orig_in: int


def _leaves(model) -> Iterator[Tuple[str, List[Any]]]:
    """(JAX path, [the port's weight per layer]) for every DiT weight: a
    top-level one as a list of one, a stacked one with a weight per block."""
    from flux2_tpu_torch.ops.quant import is_quantized

    for attr, path in _TOP_PATHS.items():
        if hasattr(model, attr):
            yield path, [getattr(model, attr)]
    for stack in _STACKS:
        blocks = getattr(model, stack)
        names = [n for n, _ in blocks[0].named_parameters(recurse=False)]
        names += [n for n, m in blocks[0].named_children() if is_quantized(m)]
        for name in names:
            yield f"{stack}/{name}", [getattr(b, name) for b in blocks]


def flatten_transformer(model) -> Tuple[Dict[str, torch.Tensor], Dict[str, str]]:
    """The port's DiT as JAX's ``flatten_pytree`` gives JAX's: linear weights
    [in, out] (stacked [L, in, out] for the blocks), norm scales [D] ([L, D]),
    a QTensor as ``<path>##q`` / ``##scale`` / ``##bias`` in [.., K(/2), N]
    with ``quant:<path>`` metadata. Tensors stay on the model's device."""
    from flux2_tpu_torch.ops.quant import QTensor, is_quantized

    flat: Dict[str, torch.Tensor] = {}
    meta: Dict[str, str] = {}
    for path, ws in _leaves(model):
        stacked = path.startswith(_STACKS)

        def join(ts):
            ts = [t.T if t.ndim == 2 else t for t in ts]
            return torch.stack(ts) if stacked else ts[0]

        w = ws[0]
        if isinstance(w, QTensor):
            flat[path + "##q"] = join([x.q for x in ws])
            flat[path + "##scale"] = join([x.scale for x in ws])
            if w.bias is not None:
                flat[path + "##bias"] = join([x.bias for x in ws])
            meta["quant:" + path] = json.dumps(
                {"format": w.format, "group_size": w.group_size, "orig_in": w.orig_in})
        elif is_quantized(w):
            raise ValueError(f"{path} is a runtime-format weight ({type(w).__name__}); only storage formats "
                             "are written to a prequantized checkpoint")
        else:
            flat[path] = join([x.detach() for x in ws])
    return flat, meta


def load_flat_pytree(flat: Dict[str, torch.Tensor], meta: Dict[str, str]) -> dict:
    """JAX's tree from flat tensors and their metadata (no template): nested
    dicts by ``/``, a ``StoredQTensor`` per ``quant:<path>`` entry."""
    tree: Dict[str, Any] = {}
    qpaths = {k[len("quant:"):] for k in meta if k.startswith("quant:")}

    def insert(path: str, value) -> None:
        parts = path.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value

    done = set()
    for key in flat:
        base = key.split("##")[0]
        if base in done:
            continue
        if base in qpaths:
            info = json.loads(meta["quant:" + base])
            insert(base, StoredQTensor(flat[base + "##q"], flat[base + "##scale"], flat.get(base + "##bias"),
                                       info["format"], info["group_size"], info["orig_in"]))
            done.add(base)
        elif "##" not in key:
            insert(key, flat[key])
            done.add(base)
    return tree


def unflatten_to_like(flat: Dict[str, torch.Tensor], meta: Dict[str, str], template,
                      device: "torch.device | str" = "cpu"):
    """A DiT of ``template``'s config from flat tensors, every leaf checked to
    exist (and a dense one to have the template's shape) BEFORE any module
    is built (JAX's validate-before-mutate); a leaf quantized on disk may be
    dense in the template. ``template`` may live on the meta device."""
    want, _ = flatten_transformer(template)
    for path, t in want.items():
        if "quant:" + path in meta:
            if path + "##q" not in flat:
                raise KeyError(f"checkpoint missing tensor: {path}##q")
            continue
        if path + "##q" in flat:
            raise KeyError(f"quantization metadata missing for {path}")
        if path not in flat:
            raise KeyError(f"checkpoint missing tensor: {path}")
        if tuple(flat[path].shape) != tuple(t.shape):
            raise ValueError(f"shape mismatch at {path}: ckpt {tuple(flat[path].shape)} vs model {tuple(t.shape)}")
    return transformer_from_tree(load_flat_pytree(flat, meta), template.config, device)


def transformer_from_tree(tree: dict, config, device: "torch.device | str" = "cpu"):
    """The port's DiT on ``device`` from JAX's tree (``load_flat_pytree``):
    every tensor moved to ``device`` first, so the layout change runs there."""
    from flux2_tpu_torch.io.jax_params import transformer_from_jax

    def to(node):
        if isinstance(node, dict):
            return {k: to(v) for k, v in node.items()}
        if isinstance(node, StoredQTensor):
            return dataclasses.replace(node, q=node.q.to(device), scale=node.scale.to(device),
                                       bias=None if node.bias is None else node.bias.to(device))
        return node.to(device)

    return transformer_from_jax(to(tree), config, device)


def source_fingerprint(source_dir: str) -> str:
    """name/size/mtime fingerprint of the source checkpoint's safetensors files."""
    parts = []
    for f in sorted(os.listdir(source_dir)):
        if f.endswith(".safetensors"):
            st = os.stat(os.path.join(source_dir, f))
            parts.append(f"{f}:{st.st_size}:{int(st.st_mtime)}")
    return "|".join(parts)


def prequantized_path(model_dir: str, fmt: str) -> str:
    return os.path.join(model_dir, PREQUANT_DIRNAME, fmt, "transformer.safetensors")


def export_prequantized(model, model_dir: str, fmt: str, source_dir: Optional[str] = None,
                        lora_baked: bool = False) -> str:
    """Atomically write a quantized DiT to ``prequantized_path(model_dir, fmt)``."""
    path = prequantized_path(model_dir, fmt)
    flat, meta = flatten_transformer(model)
    meta["format"] = fmt
    meta["lora_baked"] = "1" if lora_baked else "0"
    if source_dir and os.path.isdir(source_dir):
        meta["source_fingerprint"] = source_fingerprint(source_dir)
    safetensors_io.save_file(flat, path, metadata=meta)
    return path


def load_prequantized(path: str, expected_source_dir: Optional[str] = None) -> Tuple[dict, Dict[str, str]]:
    """JAX's tree and the metadata of a prequantized checkpoint. Refuses a
    truncated payload before reading any tensor, and a checkpoint whose
    source changed since the export when ``expected_source_dir`` is given."""
    if not safetensors_io.payload_is_complete(path):
        raise ValueError(f"prequantized checkpoint payload incomplete: {path}")
    meta = safetensors_io.load_metadata(path)
    if expected_source_dir and meta.get("source_fingerprint"):
        current = source_fingerprint(expected_source_dir)
        if current != meta["source_fingerprint"]:
            raise ValueError(
                "prequantized checkpoint is stale: source checkpoint changed "
                f"since export ({path})"
            )
    flat = safetensors_io.load_file(path)
    return load_flat_pytree(flat, meta), meta
