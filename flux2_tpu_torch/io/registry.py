"""Model registry and downloader: the HF repos of each model, where their
weights are found on disk, and how they are fetched.

The port's own copy of ``flux2_tpu/io/registry.py`` (``tests/test_torch_registry.py``
and ``tests/test_torch_shared_copies.py`` hold it against the original): the
repo tables (transformers, pre-quantized variants, VAE, text encoders and their
quantized variants), ``variant_for_quantization``, ``training_variant``,
``distilled_sibling``, ``models_dir`` (env ``FLUX2_MODELS_DIR``),
``local_model_path``, ``find_model_path`` (explicit dir, then the models dir,
then the HF cache's snapshots), ``verify_completeness``, ``download``
(``huggingface_hub.snapshot_download``; ``RuntimeError`` where that package
does not import), and the memory tables ``QUANT_PRESETS``,
``recommended_preset``, ``MODEL_MIN_MEMORY_GB`` and
``recommended_format_for_model``.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, List, Optional, Tuple

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

# Quantized encoder-variant repos the registry can name (the port quantizes
# on the fly; the table is what the server's model inventory lists).
ENCODER_VARIANT_REPOS: Dict[str, Dict[str, str]] = {
    "mistral-small-3.2": {
        "bf16": "mistralai/Mistral-Small-3.2-24B-Instruct-2506",
        "8bit": "lmstudio-community/Mistral-Small-3.2-24B-Instruct-2506-MLX-8bit",
        "6bit": "lmstudio-community/Mistral-Small-3.2-24B-Instruct-2506-MLX-6bit",
        "4bit": "lmstudio-community/Mistral-Small-3.2-24B-Instruct-2506-MLX-4bit",
    },
    "qwen3-4b": {"bf16": "Qwen/Qwen3-4B", "8bit": "lmstudio-community/Qwen3-4B-MLX-8bit", "4bit": "lmstudio-community/Qwen3-4B-MLX-4bit"},
    "qwen3-8b": {"bf16": "Qwen/Qwen3-8B", "8bit": "lmstudio-community/Qwen3-8B-MLX-8bit", "4bit": "lmstudio-community/Qwen3-8B-MLX-4bit"},
    "qwen3-vl-4b": {"bf16": "Qwen/Qwen3-VL-4B-Instruct", "8bit": "lmstudio-community/Qwen3-VL-4B-Instruct-MLX-8bit", "4bit": "lmstudio-community/Qwen3-VL-4B-Instruct-MLX-4bit"},
    "qwen3-vl-8b": {"bf16": "Qwen/Qwen3-VL-8B-Instruct", "8bit": "lmstudio-community/Qwen3-VL-8B-Instruct-MLX-8bit", "4bit": "lmstudio-community/Qwen3-VL-8B-Instruct-MLX-4bit"},
    "qwen35-vlm": {"bf16": "Qwen/Qwen3.5-4B", "8bit": "mlx-community/Qwen3.5-4B-MLX-8bit", "4bit": "mlx-community/Qwen3.5-4B-MLX-4bit"},
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
    """Download a model snapshot through ``huggingface_hub`` (network
    required) into ``local_model_path(spec, base_dir)``; returns that path."""
    try:
        from huggingface_hub import snapshot_download
    except ImportError as e:
        raise RuntimeError("huggingface_hub not available") from e
    target = local_model_path(spec, base_dir)
    os.makedirs(target, exist_ok=True)
    patterns = [f"{spec.subfolder}/*"] if spec.subfolder else None
    snapshot_download(
        spec.repo_id,
        local_dir=os.path.dirname(target) if spec.subfolder else target,
        allow_patterns=patterns,
        token=token or os.environ.get("HF_TOKEN"),
    )
    return target


# Quantization presets: (text-encoder quant, transformer quant) pairs with the
# estimated total working memory.
QUANT_PRESETS: Dict[str, Dict[str, Any]] = {
    "high-quality": {"text_encoder": "bf16", "transformer": "bf16", "approx_gb": 90},
    "balanced": {"text_encoder": "8bit", "transformer": "qint8", "approx_gb": 57},
    "memory-efficient": {"text_encoder": "4bit", "transformer": "qint8", "approx_gb": 47},
    "minimal": {"text_encoder": "4bit", "transformer": "qint8", "approx_gb": 47},
    "ultra-minimal": {"text_encoder": "4bit", "transformer": "int4", "approx_gb": 30},
}


def recommended_preset(ram_gb: float) -> str:
    """A memory budget in GB -> the name of the preset that fits it."""
    if ram_gb >= 96:
        return "high-quality"
    if ram_gb >= 64:
        return "balanced"
    if ram_gb >= 48:
        return "memory-efficient"
    if ram_gb >= 32:
        return "minimal"
    return "ultra-minimal"


# Per-model minimum memory by transformer format, GB.
MODEL_MIN_MEMORY_GB: Dict[Flux2Model, Dict[str, float]] = {
    Flux2Model.DEV: {"bf16": 72, "qint8": 69, "int4": 28},
    Flux2Model.KLEIN_4B: {"bf16": 18, "qint8": 15, "int4": 13},
    Flux2Model.KLEIN_4B_BASE: {"bf16": 18, "qint8": 15, "int4": 13},
    Flux2Model.KLEIN_9B: {"bf16": 28, "qint8": 20, "int4": 16},
    Flux2Model.KLEIN_9B_BASE: {"bf16": 28, "qint8": 20, "int4": 16},
    Flux2Model.KLEIN_9B_KV: {"bf16": 29, "qint8": 21, "int4": 17},
}


def recommended_format_for_model(model: Flux2Model, ram_gb: float) -> str:
    """The highest-fidelity transformer format that fits the budget."""
    table = MODEL_MIN_MEMORY_GB[model]
    for fmt in ("bf16", "qint8", "int4"):
        if ram_gb >= table[fmt]:
            return fmt
    return "int4"
