"""The port's sharded command lines under torchrun on the CPU: JAX's
``tests/test_cli.py`` ``--shard`` lines (``:363-380``) on eight gloo ranks,
and ``serve --tp 2`` on two against a one-rank server.

Each run starts ``tests/torch_parallel_entry.py`` (reduced random-init
configs) with ``python -m torch.distributed.run --standalone``; every rank
runs the command, rank 0 writes the PNG and prints the result lines.
"""

import json
import os
import signal
import subprocess
import sys
import time
import urllib.request

import numpy as np
import pytest

from flux2_tpu_torch.io.png import decode_png

from tests.torch_rank_pool import free_port

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENTRY = os.path.join(ROOT, "tests", "torch_parallel_entry.py")
# serve --tp 2 against the one-rank server on the same random bf16 weights: the row-parallel
# projections all-reduce two bf16 partial products where the one-rank server rounds one sum, and the
# tiny random VAE amplifies that latent noise (JAX's _assert_generation_close notes ~1e4x). The
# bounds are JAX's image bounds for sharded against unsharded, 0.06 max and 0.01 mean, in 1/255
# levels; measured max 9, mean 0.63 levels.
SERVE_MAX_LEVELS = 0.06 * 255
SERVE_MEAN_LEVELS = 0.01 * 255
# serve --tp 2 runs with this timeout on every collective (long enough for the ranks' start-up to
# drift apart on a loaded host), and sits idle longer than it between two batches: a follower must
# wait for the next batch outside any collective
GROUP_TIMEOUT_S = 30
IDLE_S = 35


def _env(**extra) -> dict:
    return dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=ROOT, **extra)


def _torchrun(nproc: int, *args) -> list:
    return [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", str(nproc), ENTRY,
            *args]


@pytest.mark.parametrize("flags", [["--shard", "1,2,4"], ["--shard", "1,1,2,4", "--context-parallel"],
                                   ["--shard", "2,2,2", "--dcn"]], ids=["shard", "context_parallel", "dcn"])
def test_t2i_shard_under_torchrun(tmp_path, flags):
    """``t2i --random-init`` at 64^2 and one step, sharded over eight ranks: exit 0, rank 0 alone
    writes the PNG and prints ``saved`` and the JSON line; every rank finishes."""
    out = str(tmp_path / "x.png")
    proc = subprocess.run(_torchrun(8, "cli", "t2i", "--random-init", "--device", "cpu", "--width", "64", "--height",
                                    "64", "--steps", "1", "--prompt", "a red fox", *flags, "-o", out),
                          cwd=ROOT, env=_env(), capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    lines = [line for line in proc.stdout.splitlines() if line.strip()]
    assert lines[-2] == f"saved {out}"
    assert json.loads(lines[-1])["steps"] == 1
    assert sum(line.startswith("saved") for line in lines) == 1
    assert sorted(line for line in proc.stderr.splitlines() if line.endswith(" done")) == \
        [f"rank {r} done" for r in range(8)]
    assert decode_png(open(out, "rb").read()).shape == (64, 64, 3)


def _t2i_in_process(monkeypatch, out: str) -> None:
    """``cli.main t2i --shard 1,1,1`` in this process, on the entry's reduced configs (one rank)."""
    from flux2_tpu_torch.cli import main as cli

    from tests.torch_parallel_entry import CONFIGS

    build = cli.build_pipeline
    monkeypatch.setattr(cli, "build_pipeline",
                        lambda args, device, generator=None, **kw: build(args, device, generator, **CONFIGS))
    cli.main(["t2i", "--random-init", "--device", "cpu", "--width", "64", "--height", "64", "--steps", "1",
              "--prompt", "a red fox", "--shard", "1,1,1", "-o", out])


@pytest.mark.parametrize("rank", ["0", "1"])
def test_main_keeps_a_callers_process_group_and_stdout(tmp_path, monkeypatch, rank):
    """A sharded ``cli.main`` run under a process group its caller started leaves that group as it was,
    and gives ``sys.stdout`` back, also as a rank other than 0, whose output goes to devnull meanwhile
    (and which writes no PNG)."""
    import torch.distributed as dist

    from flux2_tpu_torch.parallel.mesh import ensure_process_group

    ensure_process_group("cpu")
    group, stdout = dist.group.WORLD, sys.stdout
    monkeypatch.setenv("RANK", rank)
    out = tmp_path / "x.png"
    _t2i_in_process(monkeypatch, str(out))
    assert sys.stdout is stdout
    assert dist.is_initialized() and dist.group.WORLD is group
    assert out.exists() == (rank == "0")


def test_main_ends_the_process_group_it_starts(tmp_path, monkeypatch):
    """A sharded ``cli.main`` run that starts the process group (none existed) ends it on the way out."""
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()
    out = tmp_path / "x.png"
    _t2i_in_process(monkeypatch, str(out))
    assert not dist.is_initialized()
    assert decode_png(out.read_bytes()).shape == (64, 64, 3)


def _interrupt(pidfile: str, proc) -> None:
    """SIGUSR1 to the serving rank whose pid ``pidfile`` holds, if it is still ``proc`` or its child: a
    pid of a rank that has exited may belong to another process by now."""
    if proc.poll() is not None or not os.path.exists(pidfile):
        return
    pid = int(open(pidfile).read())
    try:
        with open(f"/proc/{pid}/stat") as f:
            ppid = int(f.read().rsplit(")", 1)[1].split()[1])
    except OSError:
        return
    if proc.pid in (pid, ppid):
        os.kill(pid, signal.SIGUSR1)


def _wait_health(port: int, proc, timeout: float = 300) -> None:
    t0 = time.time()
    while time.time() - t0 < timeout:
        if proc.poll() is not None:
            raise AssertionError(f"server exited {proc.returncode}: {proc.stderr.read()[-3000:]}")
        try:
            with urllib.request.urlopen(f"http://127.0.0.1:{port}/health", timeout=5) as r:
                if r.status == 200:
                    return
        except OSError:
            time.sleep(0.5)
    raise AssertionError("server not up")


def _generate(port: int, timeout: float = 300) -> np.ndarray:
    body = json.dumps({"prompt": "a red fox", "width": 64, "height": 64, "steps": 2, "seed": 5}).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}/generate", data=body, method="POST")
    with urllib.request.urlopen(req, timeout=timeout) as r:
        assert r.headers["Content-Type"] == "image/png"
        return decode_png(r.read()).astype(np.int32)


def test_serve_tp2_matches_one_rank_server(tmp_path):
    """``serve --tp 2`` on two gloo ranks (rank 0 serves, rank 1 follows each batch) answers ``POST
    /generate`` with the one-rank server's PNG within a few levels; after an idle spell longer than the
    group's collective timeout it answers the same request with the same PNG; a shutdown of rank 0 ends
    the follower's loop and both ranks exit 0."""
    port_tp, port_one = free_port(), free_port()
    pid_tp, pid_one = str(tmp_path / "tp.pid"), str(tmp_path / "one.pid")
    common = ["--random-init", "--device", "cpu"]
    tp = subprocess.Popen(_torchrun(2, "serve", "--tp", "2", "--port", str(port_tp), *common), cwd=ROOT,
                          env=_env(PARALLEL_TEST_PIDFILE=pid_tp, PARALLEL_TEST_GROUP_TIMEOUT_S=str(GROUP_TIMEOUT_S)),
                          stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    one = subprocess.Popen([sys.executable, ENTRY, "serve", "--port", str(port_one), *common], cwd=ROOT,
                           env=_env(PARALLEL_TEST_PIDFILE=pid_one), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                           text=True)
    try:
        _wait_health(port_tp, tp)
        _wait_health(port_one, one)
        sharded, single = _generate(port_tp), _generate(port_one)
        time.sleep(IDLE_S)
        again = _generate(port_tp, timeout=120)  # a second batch through the follower, after the idle spell
    finally:
        for path, proc in ((pid_tp, tp), (pid_one, one)):
            _interrupt(path, proc)
        outs = {name: proc.communicate(timeout=120) for name, proc in (("tp", tp), ("one", one))}
    assert tp.returncode == 0, outs["tp"][1][-3000:]
    assert one.returncode == 0, outs["one"][1][-3000:]
    assert sorted(line for line in outs["tp"][1].splitlines() if line.endswith(" done")) == ["rank 0 done",
                                                                                             "rank 1 done"]
    assert sharded.shape == single.shape == (64, 64, 3)
    np.testing.assert_array_equal(sharded, again)
    diff = np.abs(sharded - single)
    assert diff.max() <= SERVE_MAX_LEVELS and diff.mean() <= SERVE_MEAN_LEVELS, (diff.max(), diff.mean())
