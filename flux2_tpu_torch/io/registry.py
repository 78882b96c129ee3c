"""Model registry, local half: the HF repos of each model, and where their
weights are found on disk.

The port's own copy of the local half of ``flux2_tpu/io/registry.py``
(``tests/test_torch_registry.py`` holds the tables against it): the repo
tables, ``variant_for_quantization``, ``training_variant``,
``distilled_sibling``, ``models_dir`` (env ``FLUX2_MODELS_DIR``),
``local_model_path``, ``find_model_path`` (explicit dir, then the models dir,
then the HF cache's snapshots) and ``verify_completeness``. ``download`` needs
the network and is not ported: it raises.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional, Tuple

from flux2_tpu_torch.models.flux2.config import Flux2Model

DEFAULT_MODELS_DIR = os.path.expanduser("~/.cache/flux2_tpu/models")


@dataclasses.dataclass(frozen=True)
class RepoSpec:
    repo_id: str
    subfolder: Optional[str] = None
    gated: bool = False
    approx_size_gb: float = 0.0


TRANSFORMER_REPOS: Dict[Flux2Model, RepoSpec] = {
    Flux2Model.DEV: RepoSpec("black-forest-labs/FLUX.2-dev", "transformer", gated=True, approx_size_gb=64),
    Flux2Model.KLEIN_4B: RepoSpec("black-forest-labs/FLUX.2-klein-4B", "transformer", approx_size_gb=8),
    Flux2Model.KLEIN_4B_BASE: RepoSpec("black-forest-labs/FLUX.2-klein-base-4B", "transformer", approx_size_gb=8),
    Flux2Model.KLEIN_9B: RepoSpec("black-forest-labs/FLUX.2-klein-9B", "transformer", approx_size_gb=18),
    Flux2Model.KLEIN_9B_BASE: RepoSpec("black-forest-labs/FLUX.2-klein-base-9B", "transformer", approx_size_gb=18),
    Flux2Model.KLEIN_9B_KV: RepoSpec("black-forest-labs/FLUX.2-klein-9b-kv", "transformer", approx_size_gb=18),
}

# Pre-quantized transformer checkpoints published as separate repos; formats
# without an entry load the bf16 repo and quantize after mapping.
PREQUANTIZED_TRANSFORMER_REPOS: Dict[Tuple[Flux2Model, str], RepoSpec] = {
    (Flux2Model.DEV, "qint8"): RepoSpec(
        "VincentGOURBIN/flux_qint_8bit", "flux-2-dev/transformer/qint8", approx_size_gb=32
    ),
    (Flux2Model.KLEIN_4B, "qint8"): RepoSpec("aydin99/FLUX.2-klein-4B-int8", None, approx_size_gb=4),
}


def variant_for_quantization(model: Flux2Model, fmt: str) -> Tuple[RepoSpec, bool]:
    """``(spec, quantize_on_the_fly)`` for a (model, quantization) pair: the
    pre-quantized repo when one exists for the format, else the bf16 repo."""
    if fmt == "bf16":
        return TRANSFORMER_REPOS[model], False
    spec = PREQUANTIZED_TRANSFORMER_REPOS.get((model, fmt))
    if spec is not None:
        return spec, False
    return TRANSFORMER_REPOS[model], True


def training_variant(model: Flux2Model) -> Flux2Model:
    """LoRA training MUST use the base (non-distilled) sibling. Dev is already
    non-distilled."""
    return {
        Flux2Model.KLEIN_4B: Flux2Model.KLEIN_4B_BASE,
        Flux2Model.KLEIN_4B_BASE: Flux2Model.KLEIN_4B_BASE,
        Flux2Model.KLEIN_9B: Flux2Model.KLEIN_9B_BASE,
        Flux2Model.KLEIN_9B_BASE: Flux2Model.KLEIN_9B_BASE,
        Flux2Model.KLEIN_9B_KV: Flux2Model.KLEIN_9B_BASE,
        Flux2Model.DEV: Flux2Model.DEV,
    }[model]


def distilled_sibling(model: Flux2Model) -> Flux2Model:
    """The distilled sibling that renders validation images; inverse of training_variant."""
    return {
        Flux2Model.KLEIN_4B_BASE: Flux2Model.KLEIN_4B,
        Flux2Model.KLEIN_9B_BASE: Flux2Model.KLEIN_9B,
    }.get(model, model)


VAE_REPO = RepoSpec("black-forest-labs/FLUX.2-klein-4B", "vae", approx_size_gb=0.4)
VAE_SMALL_DECODER_REPO = RepoSpec("black-forest-labs/FLUX.2-small-decoder", None, approx_size_gb=0.3)

TEXT_ENCODER_REPOS: Dict[str, RepoSpec] = {
    "mistral-small-3.2": RepoSpec("mistralai/Mistral-Small-3.2-24B-Instruct-2506", gated=True, approx_size_gb=48),
    "qwen3-4b": RepoSpec("Qwen/Qwen3-4B", approx_size_gb=8),
    "qwen3-8b": RepoSpec("Qwen/Qwen3-8B", approx_size_gb=16),
    "qwen3-vl-4b": RepoSpec("Qwen/Qwen3-VL-4B-Instruct", approx_size_gb=9),
    "qwen3-vl-8b": RepoSpec("Qwen/Qwen3-VL-8B-Instruct", approx_size_gb=17),
    "qwen35-vlm": RepoSpec("Qwen/Qwen3.5-4B", approx_size_gb=9),
}

ENCODER_FOR_MODEL: Dict[Flux2Model, str] = {
    Flux2Model.DEV: "mistral-small-3.2",
    Flux2Model.KLEIN_4B: "qwen3-4b",
    Flux2Model.KLEIN_4B_BASE: "qwen3-4b",
    Flux2Model.KLEIN_9B: "qwen3-8b",
    Flux2Model.KLEIN_9B_BASE: "qwen3-8b",
    Flux2Model.KLEIN_9B_KV: "qwen3-8b",
}


def models_dir() -> str:
    return os.environ.get("FLUX2_MODELS_DIR", DEFAULT_MODELS_DIR)


def local_model_path(spec: RepoSpec, base_dir: Optional[str] = None) -> str:
    base = base_dir or models_dir()
    path = os.path.join(base, *spec.repo_id.split("/"))
    return os.path.join(path, spec.subfolder) if spec.subfolder else path


def find_model_path(spec: RepoSpec, explicit_dir: Optional[str] = None) -> Optional[str]:
    """Resolve a model directory: explicit dir -> configured dir -> HF cache."""
    candidates = []
    if explicit_dir:
        candidates.append(explicit_dir)
    candidates.append(local_model_path(spec))
    hf_home = os.environ.get("HF_HOME", os.path.expanduser("~/.cache/huggingface"))
    snap_base = os.path.join(hf_home, "hub", "models--" + spec.repo_id.replace("/", "--"), "snapshots")
    if os.path.isdir(snap_base):
        for snap in sorted(os.listdir(snap_base)):
            p = os.path.join(snap_base, snap)
            candidates.append(os.path.join(p, spec.subfolder) if spec.subfolder else p)
    for c in candidates:
        if c and os.path.isdir(c) and _has_weights(c):
            return c
    return None


def _has_weights(path: str) -> bool:
    try:
        return any(f.endswith(".safetensors") for f in os.listdir(path))
    except OSError:
        return False


def verify_completeness(path: str) -> Tuple[bool, List[str]]:
    """Check every safetensors file's payload covers its header offsets."""
    from flux2_tpu_torch.io import safetensors_io

    bad = [f for f in sorted(os.listdir(path))
           if f.endswith(".safetensors") and not safetensors_io.payload_is_complete(os.path.join(path, f))]
    return (not bad, bad)


def download(spec: RepoSpec, token: Optional[str] = None, base_dir: Optional[str] = None) -> str:
    raise NotImplementedError(
        f"downloading {spec.repo_id} needs the network and is not ported to flux2_tpu_torch; put the weights "
        f"under {local_model_path(spec, base_dir)} or pass the directory"
    )
