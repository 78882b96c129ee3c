"""A pool of torch rank processes joined by one gloo group, for the port's
multi-rank CPU tests.

``RankPool(8)`` spawns eight processes (one torch thread each) that join one
gloo process group through a ``FileStore`` in a fresh temporary directory
(no port is chosen ahead of the bind: a port picked free and then bound by
rank 0 seconds later can be taken meanwhile by another test's sockets) and
then wait for work.
``pool.run("module:function", *args)`` runs that function on every rank at
once and returns the eight results in rank order (a rank's exception is
raised here with its traceback); ``start`` and ``collect`` split it, so the
test computes its JAX reference while the ranks work. A test file starts one pool, module-scoped,
and runs every case in it, so it pays for one start-up. The workers import
torch and the port only, never JAX: the references are computed in the
pytest process.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import shutil
import socket
import tempfile
import traceback


def free_port() -> int:
    """A localhost port that was free when asked (the caller must retry if it is taken before it binds)."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _worker(rank: int, world: int, store_path: str, tasks, results) -> None:
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank), OMP_NUM_THREADS="1")
    import datetime
    import importlib

    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world), rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=180))
    results.put((rank, "ready", None))
    while True:
        task = tasks.get()
        if task is None:
            break
        target, args = task
        try:
            mod, fn = target.split(":")
            out = getattr(importlib.import_module(mod), fn)(*args)
            results.put((rank, "ok", out))
        except Exception:  # reported to the test, which raises it; the rank waits for the next case
            results.put((rank, "error", traceback.format_exc()))
    dist.destroy_process_group()


class RankPool:
    def __init__(self, world: int = 8, timeout: float = 600.0):
        ctx = mp.get_context("spawn")
        self.world, self.timeout = world, timeout
        self._dir = tempfile.mkdtemp(prefix="rank_pool_")
        store = os.path.join(self._dir, "store")
        self._tasks = [ctx.Queue() for _ in range(world)]
        self._results = ctx.Queue()
        self._procs = [ctx.Process(target=_worker, args=(r, world, store, self._tasks[r], self._results), daemon=True)
                       for r in range(world)]
        for p in self._procs:
            p.start()
        self._collect()

    def _collect(self) -> list:
        out, errors = [None] * self.world, []
        for _ in range(self.world):
            rank, status, value = self._results.get(timeout=self.timeout)
            if status == "error":
                errors.append(f"rank {rank}:\n{value}")
            out[rank] = value
        if errors:
            raise RuntimeError("\n".join(errors))
        return out

    def start(self, target: str, *args) -> None:
        """Send ``target`` ("module:function") to every rank and return at once: the caller computes its
        reference meanwhile, then takes the ranks' results with ``collect``."""
        for q in self._tasks:
            q.put((target, args))

    def collect(self) -> list:
        """The results of the case ``start`` sent, in rank order."""
        return self._collect()

    def run(self, target: str, *args) -> list:
        """``target`` on every rank; the results in rank order."""
        self.start(target, *args)
        return self.collect()

    def close(self) -> None:
        for q in self._tasks:
            q.put(None)
        for p in self._procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
        shutil.rmtree(self._dir, ignore_errors=True)
