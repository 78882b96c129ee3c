"""Device memory: the port of ``flux2_tpu/utils/memory.py``.

Feasibility: ``estimate_generation_bytes``, ``check_feasibility`` and
``recommended_quantization``, with JAX's tables and arithmetic. Memory
profiles: ``MemoryProfile``, ``MEMORY_PROFILES`` and ``auto_profile``; the
pipeline reads a profile's ``vae_tile_threshold_px`` (the decode is tiled
above it), while ``remat`` and ``max_checkpoint_latents`` are carried as data,
as JAX's pipeline carries them. A device's bytes come from
``torch.cuda.get_device_properties(...).total_memory``: where no CUDA device
exists the caller passes ``hbm_bytes``, or the functions raise (JAX falls
back to 16 GiB a device, a TPU v5e's). The last suggestion, to shard over
more chips, names ``Flux2Pipeline.shard`` (``flux2_tpu_torch/parallel/``).

Telemetry: ``MemorySnapshot``, ``MemoryTelemetry`` (``peak_bytes`` and JAX's
``report()`` table), ``telemetry()``, with
``device_memory_stats`` read from ``torch.cuda.memory_stats`` (zeros on the
CPU, as JAX's backends without memory stats give). Also the host's peak
resident set, which the checkpoint loaders report.
"""

from __future__ import annotations

import dataclasses
import os
import resource
from typing import Dict, List, Optional, Tuple, Union

import torch

from flux2_tpu_torch.models.flux2.config import Flux2Model

BYTES_PER_PARAM = {"bf16": 2.0, "qint8": 1.06, "int4": 0.56, "mxfp8": 1.12, "mxfp4": 0.62, "nvfp4": 0.56, "nf4": 0.56}

APPROX_PARAMS = {
    Flux2Model.DEV: 32e9,
    Flux2Model.KLEIN_9B: 9e9,
    Flux2Model.KLEIN_9B_BASE: 9e9,
    Flux2Model.KLEIN_9B_KV: 9e9,
    Flux2Model.KLEIN_4B: 4e9,
    Flux2Model.KLEIN_4B_BASE: 4e9,
}


def device_memory_stats(device: "torch.device | str | None" = None) -> Dict[str, int]:
    """bytes_in_use, peak_bytes_in_use (since the last peak reset) and
    bytes_limit of a CUDA device; zeros for the CPU."""
    device = torch.device(device if device is not None else ("cuda" if torch.cuda.is_available() else "cpu"))
    if device.type != "cuda":
        return {"bytes_in_use": 0, "peak_bytes_in_use": 0, "bytes_limit": 0}
    stats = torch.cuda.memory_stats(device)
    return {
        "bytes_in_use": stats.get("allocated_bytes.all.current", 0),
        "peak_bytes_in_use": stats.get("allocated_bytes.all.peak", 0),
        "bytes_limit": torch.cuda.get_device_properties(device).total_memory,
    }


def total_device_bytes() -> int:
    """The summed memory of every CUDA device; raises where there is none."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass hbm_bytes= (the device memory to plan for)")
    return sum(torch.cuda.get_device_properties(i).total_memory for i in range(torch.cuda.device_count()))


@dataclasses.dataclass
class FeasibilityReport:
    feasible: bool
    required_gb: float
    available_gb: float
    suggestions: List[str]


def estimate_generation_bytes(
    model: Flux2Model,
    quantization: str = "bf16",
    height: int = 1024,
    width: int = 1024,
    num_reference_images: int = 0,
) -> float:
    """Rough transformer + activations + VAE estimate for one generation (JAX's formula)."""
    params = APPROX_PARAMS[model] * BYTES_PER_PARAM.get(quantization, 2.0)
    cfg = model.transformer_config
    seq = 512 + (height // 16) * (width // 16) * (1 + num_reference_images)
    # live activations: a few sequence-sized buffers at inner_dim + attention workspace
    acts = 12 * seq * cfg.inner_dim * 2
    vae = 2e9  # decode workspace at 1MP
    return params + acts + vae


def check_feasibility(
    model: Flux2Model,
    quantization: str = "bf16",
    height: int = 1024,
    width: int = 1024,
    num_reference_images: int = 0,
    hbm_bytes: Optional[int] = None,
) -> FeasibilityReport:
    """Pre-check with actionable suggestions; ``hbm_bytes`` defaults to the
    CUDA devices' total memory."""
    required = estimate_generation_bytes(model, quantization, height, width, num_reference_images)
    available = hbm_bytes if hbm_bytes is not None else total_device_bytes()
    suggestions: List[str] = []
    if required > available:
        if quantization == "bf16":
            suggestions.append("use --quantization qint8 (-47%) or int4 (-72%)")
        if height * width > 1024 * 1024:
            suggestions.append("reduce resolution (activation memory scales with tokens)")
        if num_reference_images > 1:
            suggestions.append("fewer reference images, or klein-9b-kv (caches reference K/V)")
        suggestions.append("shard over more chips: pipeline.shard(make_mesh(tp=N))")
    return FeasibilityReport(
        feasible=required <= available,
        required_gb=required / 1024**3,
        available_gb=available / 1024**3,
        suggestions=suggestions,
    )


def recommended_quantization(model: Flux2Model, hbm_bytes: Optional[int] = None) -> str:
    """The largest format that fits."""
    for fmt in ("bf16", "qint8", "int4"):
        if check_feasibility(model, fmt, hbm_bytes=hbm_bytes).feasible:
            return fmt
    return "int4"


@dataclasses.dataclass(frozen=True)
class MemoryProfile:
    """A named bundle of memory/speed knobs (JAX ``MemoryProfile``)."""

    name: str
    remat: Union[bool, str]  # transformer remat policy (False / 'dots' / 'block'); carried, not read
    vae_tile_threshold_px: int  # tile the VAE decode above this edge length
    max_checkpoint_latents: int  # cap on retained every-Nth checkpoint latents; carried, not read

    @staticmethod
    def named(name: str) -> "MemoryProfile":
        return MEMORY_PROFILES[name]


MEMORY_PROFILES: Dict[str, MemoryProfile] = {
    "performance": MemoryProfile("performance", False, 2048, 32),
    "balanced": MemoryProfile("balanced", "dots", 2048, 16),
    "conservative": MemoryProfile("conservative", "block", 1024, 4),
}


def auto_profile(model: Flux2Model, quantization: str = "bf16", hbm_bytes: Optional[int] = None) -> MemoryProfile:
    """Pick a profile by the estimated 1024^2 working set's share of device memory."""
    required = estimate_generation_bytes(model, quantization)
    available = hbm_bytes if hbm_bytes is not None else total_device_bytes()
    ratio = required / max(available, 1)
    if ratio < 0.5:
        return MEMORY_PROFILES["performance"]
    if ratio < 0.8:
        return MEMORY_PROFILES["balanced"]
    return MEMORY_PROFILES["conservative"]


@dataclasses.dataclass
class MemorySnapshot:
    tag: str
    bytes_in_use: int
    peak_bytes_in_use: int
    bytes_limit: int


class MemoryTelemetry:
    """Collects device-memory snapshots at phase boundaries; zero-cost when disabled."""

    def __init__(self, enabled: bool = True, device: "torch.device | str | None" = None):
        self.enabled = enabled
        self.device = device
        self.snapshots: List[MemorySnapshot] = []

    def snapshot(self, tag: str) -> Optional[MemorySnapshot]:
        if not self.enabled:
            return None
        s = device_memory_stats(self.device)
        snap = MemorySnapshot(tag, s["bytes_in_use"], s["peak_bytes_in_use"], s["bytes_limit"])
        self.snapshots.append(snap)
        return snap

    @property
    def peak_bytes(self) -> int:
        return max((s.peak_bytes_in_use for s in self.snapshots), default=0)

    def as_dict(self) -> Dict[str, Dict[str, float]]:
        gb = 1024**3
        return {
            s.tag: {"in_use_gb": round(s.bytes_in_use / gb, 3), "peak_gb": round(s.peak_bytes_in_use / gb, 3)}
            for s in self.snapshots
        }

    def report(self) -> str:
        """The snapshots as JAX's table: phase, in use and peak in GiB, then the device's limit."""
        lines = [f"{'phase':<20} {'in use':>10} {'peak':>10}"]
        gb = 1024**3
        for s in self.snapshots:
            lines.append(f"{s.tag:<20} {s.bytes_in_use / gb:>9.2f}G {s.peak_bytes_in_use / gb:>9.2f}G")
        if self.snapshots and self.snapshots[-1].bytes_limit:
            lines.append(f"{'HBM limit':<20} {'':>10} {self.snapshots[-1].bytes_limit / gb:>9.2f}G")
        return "\n".join(lines)


_shared_telemetry: Optional[MemoryTelemetry] = None


def telemetry() -> MemoryTelemetry:
    global _shared_telemetry
    if _shared_telemetry is None:
        _shared_telemetry = MemoryTelemetry(enabled=os.environ.get("FLUX2_MEM_TELEMETRY", "1") != "0")
    return _shared_telemetry


# -- host -------------------------------------------------------------------------------


def reset_host_peak_rss() -> bool:
    """Restart the kernel's count of this process's peak resident set (Linux
    ``/proc/self/clear_refs``); False where the host does not allow it."""
    try:
        with open("/proc/self/clear_refs", "w") as f:
            f.write("5")
        return True
    except OSError:
        return False


def host_peak_rss_bytes() -> Tuple[int, str]:
    """Peak resident set of this process and where it was read: ``VmHWM``
    ("since reset", counted from the last ``reset_host_peak_rss``) where the
    kernel keeps it, else ``ru_maxrss`` ("ru_maxrss": since the start; a
    container runtime without ``VmHWM`` may report the whole container there)."""
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmHWM:"):
                return int(line.split()[1]) * 1024, "since reset"
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024, "ru_maxrss"
