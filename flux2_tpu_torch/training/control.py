"""Training control and persisted state: the port's own copy of
``flux2_tpu/training/control.py`` (the same sentinels, state file and
``config_hash``, tested in ``tests/test_torch_shared_copies.py``).

Capability parity with ``Training/Control/TrainingController.swift`` and
``TrainingState.swift``:
  - pause / resume / stop / force-stop / checkpoint-now via in-process flags
    AND sentinel files (``.pause`` / ``.stop`` / ``.checkpoint`` in the
    output dir) usable cross-process (TrainingController.swift:113-116) —
    the CLI's ``training-control`` subcommand writes those files.
  - observer callbacks on state changes.
  - ``TrainingState``: step/epoch, loss history/best, timing + ETA, RNG seed,
    config hash, validation score history — JSON-persisted per checkpoint.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import time
from typing import Callable, Dict, List, Optional

PAUSE_SENTINEL = ".pause"
STOP_SENTINEL = ".stop"
CHECKPOINT_SENTINEL = ".checkpoint"


class TrainingController:
    """Cooperative control polled by the training loop each step."""

    def __init__(self, output_dir: str):
        self.output_dir = output_dir
        self._stop = False
        self._pause = False
        self._checkpoint_requested = False
        self._observers: List[Callable[[str], None]] = []
        os.makedirs(output_dir, exist_ok=True)

    # -- in-process API ------------------------------------------------------

    def request_stop(self) -> None:
        self._stop = True
        self._notify("stop")

    def request_pause(self) -> None:
        self._pause = True
        self._notify("pause")

    def request_resume(self) -> None:
        self._pause = False
        self._remove(PAUSE_SENTINEL)
        self._notify("resume")

    def request_checkpoint(self) -> None:
        self._checkpoint_requested = True
        self._notify("checkpoint")

    def add_observer(self, fn: Callable[[str], None]) -> None:
        self._observers.append(fn)

    # -- polled by the loop ----------------------------------------------------

    def should_stop(self) -> bool:
        return self._stop or self._sentinel(STOP_SENTINEL)

    def should_pause(self) -> bool:
        return self._pause or self._sentinel(PAUSE_SENTINEL)

    def consume_checkpoint_request(self) -> bool:
        """True once per request; clears both the flag and the sentinel."""
        requested = self._checkpoint_requested or self._sentinel(CHECKPOINT_SENTINEL)
        self._checkpoint_requested = False
        self._remove(CHECKPOINT_SENTINEL)
        return requested

    def wait_while_paused(self, poll_s: float = 0.5, timeout_s: Optional[float] = None) -> None:
        start = time.time()
        while self.should_pause() and not self.should_stop():
            if timeout_s is not None and time.time() - start > timeout_s:
                return
            time.sleep(poll_s)

    # -- cross-process writers (the CLI uses these) -----------------------------

    @staticmethod
    def write_sentinel(output_dir: str, action: str) -> str:
        name = {"pause": PAUSE_SENTINEL, "stop": STOP_SENTINEL, "checkpoint": CHECKPOINT_SENTINEL}[action]
        path = os.path.join(output_dir, name)
        with open(path, "w") as f:
            f.write(str(time.time()))
        return path

    @staticmethod
    def clear_sentinel(output_dir: str, action: str) -> None:
        name = {"pause": PAUSE_SENTINEL, "stop": STOP_SENTINEL, "checkpoint": CHECKPOINT_SENTINEL}[action]
        try:
            os.unlink(os.path.join(output_dir, name))
        except FileNotFoundError:
            pass

    # -- internals --------------------------------------------------------------

    def _sentinel(self, name: str) -> bool:
        return os.path.exists(os.path.join(self.output_dir, name))

    def _remove(self, name: str) -> None:
        try:
            os.unlink(os.path.join(self.output_dir, name))
        except FileNotFoundError:
            pass

    def _notify(self, event: str) -> None:
        for fn in self._observers:
            fn(event)


@dataclasses.dataclass
class TrainingState:
    """Persisted training progress (TrainingState.swift:67-120)."""

    step: int = 0
    epoch: int = 0
    loss_history: List[float] = dataclasses.field(default_factory=list)
    best_loss: Optional[float] = None
    best_checkpoint_step: Optional[int] = None
    rng_seed: int = 0
    config_hash: str = ""
    started_at: float = dataclasses.field(default_factory=time.time)
    elapsed_s: float = 0.0
    validation_scores: List[Dict] = dataclasses.field(default_factory=list)
    val_loss_history: List[Dict] = dataclasses.field(default_factory=list)  # [{step, loss, gap}]

    def record_val_loss(self, step: int, loss: float, gap: float) -> None:
        self.val_loss_history.append({"step": step, "loss": loss, "gap": gap})

    def record_loss(self, loss: float) -> None:
        self.loss_history.append(loss)
        if self.best_loss is None or loss < self.best_loss:
            self.best_loss = loss

    def record_validation(self, step: int, scene: float, style: float, prompt: str = "") -> None:
        self.validation_scores.append(
            {"step": step, "scene": scene, "style": style, "prompt": prompt, "at": time.time()}
        )

    def best_validation_step(self) -> Optional[int]:
        if not self.validation_scores:
            return None
        best = max(self.validation_scores, key=lambda s: s["scene"] + s["style"])
        return best["step"]

    def eta_seconds(self, total_steps: int) -> Optional[float]:
        if self.step == 0 or self.elapsed_s == 0:
            return None
        return (total_steps - self.step) * (self.elapsed_s / self.step)

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(dataclasses.asdict(self), f, indent=2)

    @classmethod
    def load(cls, path: str) -> "TrainingState":
        with open(path) as f:
            raw = json.load(f)
        # the checkpoint JSON also carries the trainer's compat metadata
        # (rank/alpha/optimizer/...) in the same file — ignore unknown keys
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in raw.items() if k in known})


def config_hash(config_obj) -> str:
    """Stable hash of a training config for resume-compatibility checks."""
    as_dict = dataclasses.asdict(config_obj) if dataclasses.is_dataclass(config_obj) else dict(config_obj)
    blob = json.dumps(as_dict, sort_keys=True, default=str).encode()
    return hashlib.sha256(blob).hexdigest()[:16]
