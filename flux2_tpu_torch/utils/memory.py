"""Device-memory telemetry: the telemetry part of ``flux2_tpu/utils/memory.py``
(``MemorySnapshot``, ``MemoryTelemetry``, ``telemetry()``), with
``device_memory_stats`` read from ``torch.cuda.memory_stats`` (zeros on the
CPU, as JAX's backends without memory stats give). Also the host's peak
resident set, which the checkpoint loaders report. Memory profiles and
``auto_profile`` are not ported yet.
"""

from __future__ import annotations

import dataclasses
import os
import resource
from typing import Dict, List, Optional, Tuple

import torch


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

    def as_dict(self) -> Dict[str, Dict[str, float]]:
        gb = 1024**3
        return {
            s.tag: {"in_use_gb": round(s.bytes_in_use / gb, 3), "peak_gb": round(s.peak_bytes_in_use / gb, 3)}
            for s in self.snapshots
        }


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
