"""Runtime activity beacon: opt-in JSON manifests for external monitors.

The port's copy of ``flux2_tpu/utils/beacon.py`` (host only;
``tests/test_torch_shared_copies.py`` holds it against the original): when
``FLUX2_RUNTIME_BEACON=1`` (or the CLI's ``--beacon``), a manifest JSON of the
current task (model, phase, step/total, pid, timestamps) is written atomically
to ``$FLUX2_BEACON_DIR``, else ``$XDG_STATE_HOME/ai-runtime-beacons``, as
``<pid>-<id>.json`` and refreshed on updates; manifests of dead pids are
removed by ``gc_stale_manifests`` (``kill(pid, 0)`` liveness).
"""

from __future__ import annotations

import json
import os
import tempfile
import time
import uuid
from typing import Optional


def beacon_dir() -> str:
    base = os.environ.get("XDG_STATE_HOME", os.path.expanduser("~/.local/state"))
    return os.environ.get("FLUX2_BEACON_DIR", os.path.join(base, "ai-runtime-beacons"))


def enabled() -> bool:
    return os.environ.get("FLUX2_RUNTIME_BEACON", "0") == "1"


class RuntimeBeacon:
    def __init__(self, task: str, model: str = "", force: bool = False):
        self.active = force or enabled()
        self.task = task
        self.model = model
        self.phase = ""
        self.step = 0
        self.total_steps = 0
        self._id = uuid.uuid4().hex[:8]
        self._started = time.time()
        self._path = os.path.join(beacon_dir(), f"{os.getpid()}-{self._id}.json")
        if self.active:
            os.makedirs(beacon_dir(), exist_ok=True)
            gc_stale_manifests()
            self._write()

    def update(self, phase: Optional[str] = None, step: Optional[int] = None, total_steps: Optional[int] = None) -> None:
        if not self.active:
            return
        if phase is not None:
            self.phase = phase
        if step is not None:
            self.step = step
        if total_steps is not None:
            self.total_steps = total_steps
        self._write()

    def end(self) -> None:
        if self.active and os.path.exists(self._path):
            os.unlink(self._path)
        self.active = False

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.end()

    def _write(self) -> None:
        manifest = {
            "pid": os.getpid(),
            "id": self._id,
            "task": self.task,
            "model": self.model,
            "phase": self.phase,
            "step": self.step,
            "total_steps": self.total_steps,
            "started_at": self._started,
            "updated_at": time.time(),
            "runtime": "flux2-tpu",
        }
        # atomic: write temp then rename
        fd, tmp = tempfile.mkstemp(dir=beacon_dir(), suffix=".tmp")
        with os.fdopen(fd, "w") as f:
            json.dump(manifest, f)
        os.replace(tmp, self._path)


def gc_stale_manifests() -> int:
    """Remove manifests whose pid is no longer alive. Returns count removed."""
    removed = 0
    d = beacon_dir()
    if not os.path.isdir(d):
        return 0
    for name in os.listdir(d):
        if not name.endswith(".json"):
            continue
        try:
            pid = int(name.split("-")[0])
        except ValueError:
            continue
        try:
            os.kill(pid, 0)
        except ProcessLookupError:
            try:
                os.unlink(os.path.join(d, name))
                removed += 1
            except OSError:
                pass
        except PermissionError:
            pass  # alive, owned by someone else
    return removed


def list_active() -> list:
    d = beacon_dir()
    out = []
    if not os.path.isdir(d):
        return out
    for name in sorted(os.listdir(d)):
        if name.endswith(".json"):
            try:
                with open(os.path.join(d, name)) as f:
                    out.append(json.load(f))
            except (OSError, json.JSONDecodeError):
                pass
    return out
