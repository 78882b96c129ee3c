"""The port's sharded command lines under torchrun on the CPU: JAX's
``tests/test_cli.py`` ``--shard`` lines (``:363-380``) on eight gloo ranks,
``serve --tp 2`` on two against a one-rank server, and ``train-lora`` with
the YAML's ``pp`` on two ranks against the one-rank run, ``--shard`` in its
checkpoint branch, and JAX's exit texts for the pp and ``--shard`` checks.

Each run starts ``tests/torch_parallel_entry.py`` (reduced random-init
configs) with ``python -m torch.distributed.run --standalone``; every rank
runs the command, rank 0 writes the PNG (or the checkpoints) and prints the
result lines.
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

from tests.test_torch_lora_loader import one_torch_thread  # noqa: F401 (module fixture: the in-process runs)
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


def _serve_on_a_free_port(argv, env: dict, attempts: int = 3):
    """Start ``argv`` + ``--port P`` on a free port and wait until it answers /health: (process, port). A port
    picked free can be taken by another test's sockets before the server binds it (seconds later, after
    torch's import): then the server exits naming the address, and a new port is tried."""
    for attempt in range(attempts):
        port = free_port()
        proc = subprocess.Popen([*argv, "--port", str(port)], cwd=ROOT, env=env, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
        try:
            _wait_health(port, proc)
            return proc, port
        except AssertionError as e:
            if "Address already in use" not in str(e) or attempt == attempts - 1:
                raise
    raise AssertionError("unreachable")


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
    pid_tp, pid_one = str(tmp_path / "tp.pid"), str(tmp_path / "one.pid")
    common = ["--random-init", "--device", "cpu"]
    tp, port_tp = _serve_on_a_free_port(_torchrun(2, "serve", "--tp", "2", *common), _env(
        PARALLEL_TEST_PIDFILE=pid_tp, PARALLEL_TEST_GROUP_TIMEOUT_S=str(GROUP_TIMEOUT_S)))
    one = None
    try:
        one, port_one = _serve_on_a_free_port([sys.executable, ENTRY, "serve", *common],
                                              _env(PARALLEL_TEST_PIDFILE=pid_one))
        sharded, single = _generate(port_tp), _generate(port_one)
        time.sleep(IDLE_S)
        again = _generate(port_tp, timeout=120)  # a second batch through the follower, after the idle spell
    finally:
        procs = [(name, path, proc) for name, path, proc in (("tp", pid_tp, tp), ("one", pid_one, one)) if proc]
        for _, path, proc in procs:
            _interrupt(path, proc)
        outs = {name: proc.communicate(timeout=120) for name, _, proc in procs}
    assert tp.returncode == 0, outs["tp"][1][-3000:]
    assert one.returncode == 0, outs["one"][1][-3000:]
    assert sorted(line for line in outs["tp"][1].splitlines() if line.endswith(" done")) == ["rank 0 done",
                                                                                             "rank 1 done"]
    assert sharded.shape == single.shape == (64, 64, 3)
    np.testing.assert_array_equal(sharded, again)
    diff = np.abs(sharded - single)
    assert diff.max() <= SERVE_MAX_LEVELS and diff.mean() <= SERVE_MEAN_LEVELS, (diff.max(), diff.mean())


# -- train-lora: pp and --shard ------------------------------------------------------------------------

# pp: 2 on two ranks against the one-rank dense run of the same random bf16 base: the microbatches split a
# batch that the dense step runs whole, so bf16 rounds other partial sums (measured 1.1e-4 relative)
PP_LOSS_RTOL = 1e-3


def _train_yaml(path, out, steps=3, extra="", dataset=None) -> str:
    data = f"path: {dataset}, image_size: 64" if dataset else "image_size: 32"
    path.write_text(f"""model: {{name: klein-4b}}
lora: {{rank: 4, alpha: 8, target_layers: attention_ffn}}
dataset: {{{data}}}
training: {{optimizer: adamw, learning_rate: 1.0e-2, warmup_steps: 1, lr_scheduler: cosine, batch_size: 2,
  max_steps: {steps}, log_every: 1{extra}}}
memory: {{gradient_checkpointing: true}}
checkpoints: {{output: {out}, save_every: 2}}
""")
    return str(path)


def _state(out, step: int = 3) -> dict:
    with open(os.path.join(out, f"checkpoint_{step:06d}", "training_state.json")) as f:
        return json.load(f)


def _history(out, step: int = 3) -> list:
    return _state(out, step)["loss_history"]


def test_train_lora_pp2_under_torchrun_matches_the_one_rank_run(tmp_path):
    """``train-lora --random-init`` with ``pp: 2`` on two gloo ranks, on the real data path (a dataset: the random
    encoder, both caches filled by rank 0 first): JAX's log line for the mesh; the losses and the held-out loss
    within PP_LOSS_RTOL of the one-rank dense run's; the previews run through the pipeline on every rank; rank 0
    alone writes the checkpoints and the images and logs the steps, and the output directory holds what the
    one-rank run's does."""
    from flux2_tpu_torch.cli import main as cli
    from flux2_tpu_torch.cli.train import run_training
    from flux2_tpu_torch.utils import synthetic

    from tests.torch_parallel_entry import CONFIGS, TRAIN_CONFIG

    data = synthetic.write_dataset(str(tmp_path / "data"), 0, [(64, 64)] * 2)["dataset"]
    held = synthetic.write_dataset(str(tmp_path / "held"), 1, [(64, 64)])["dataset"]
    validation = "validation: {prompts: [a sks photo], every_n_steps: 2, steps: 1, size: 64}\n"

    def yaml(name: str, out: str, extra: str = "") -> str:
        path = _train_yaml(tmp_path / name, out, steps=2, extra=extra, dataset=data)
        text = open(path).read().replace("image_size: 64", f"image_size: 64, validation_path: {held}")
        with open(path, "w") as f:
            f.write(text + validation)
        return path

    dense_out, pp_out = str(tmp_path / "dense"), str(tmp_path / "pp")
    run_training(cli.parse_args(["train-lora", "--config", yaml("d.yaml", dense_out), "--random-init", "--device",
                                 "cpu"]), "cpu", transformer_config=TRAIN_CONFIG, vae_config=CONFIGS["vae_config"])
    proc = subprocess.run(_torchrun(2, "train", "train-lora", "--config", yaml("p.yaml", pp_out, ", pp: 2"),
                                    "--random-init", "--device", "cpu"), cwd=ROOT, env=_env(), capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "pipeline parallelism: mesh {'data': 1, 'pp': 2}, 2 microbatches (bubble 33%)" in proc.stderr
    assert sum(" step 1/2 loss " in line for line in proc.stderr.splitlines()) == 1
    # the save at step 2 and the final one
    assert [line for line in proc.stdout.splitlines() if line.startswith("checkpoint ->")] == \
        [f"checkpoint -> {pp_out}/checkpoint_000002"] * 2
    assert sorted(os.listdir(pp_out)) == sorted(os.listdir(dense_out))
    states = [_state(d, 2) for d in (pp_out, dense_out)]
    np.testing.assert_allclose(states[0]["loss_history"], states[1]["loss_history"], rtol=PP_LOSS_RTOL)
    np.testing.assert_allclose([r["loss"] for r in states[0]["val_loss_history"]],
                               [r["loss"] for r in states[1]["val_loss_history"]], rtol=PP_LOSS_RTOL)
    assert sorted(os.listdir(os.path.join(pp_out, "validation"))) == \
        sorted(os.listdir(os.path.join(dense_out, "validation"))) == ["val_000000_p0_0.png", "val_000002_p0_0.png"]
    assert sum("validation @ 2:" in line for line in proc.stderr.splitlines()) == 1


@pytest.fixture(scope="module")
def tree_and_data(tmp_path_factory):
    """A tiny checkpoint tree (bf16 DiT, the VAE, a 28-layer Qwen3; its VAE filled from ``jax.eval_shape``)
    and a four-image dataset in two buckets."""
    import tests.test_torch_checkpoints as ckpt_tests
    from flux2_tpu_torch.utils import synthetic
    from tests.test_torch_vae_encoder import _params as vae_params

    root = tmp_path_factory.mktemp("shard_tree")
    saved = ckpt_tests.perturbed_vae_params
    ckpt_tests.perturbed_vae_params = lambda: vae_params("tiny")
    try:
        dirs = ckpt_tests.write_tiny_tree(root / "tree")
    finally:
        ckpt_tests.perturbed_vae_params = saved
    data = synthetic.write_dataset(str(root / "data"), 0, [(64, 64), (64, 96)] * 2)
    return ckpt_tests.tree_argv(dirs), data["dataset"]


def test_train_lora_shard_in_the_checkpoint_branch(tree_and_data, tmp_path):
    """``--shard`` reaches ``build_pipeline`` in the checkpoint branch and the step trains on the DiT it shards:
    ``--shard 1,1,1,1`` (a one-rank mesh shards nothing) gives the unsharded run's losses to the bit, and the
    process group that the flag started ends with the command. The step on a DiT sharded over eight ranks:
    ``tests/test_torch_parallel.py::test_lora_train_step_on_the_sharded_dit_matches_dense``."""
    import torch.distributed as dist

    from flux2_tpu_torch.cli import main as cli

    tree_flags, dataset = tree_and_data
    runs = {}
    for name, flags in (("plain", []), ("one_rank", ["--shard", "1,1,1,1"])):
        out = str(tmp_path / name)
        cfg = _train_yaml(tmp_path / f"{name}.yaml", out, steps=2, dataset=dataset)
        assert cli.main(["train-lora", "--config", cfg, *tree_flags, "--device", "cpu", *flags]) == 0
        runs[name] = _history(out, 2)
    assert not dist.is_initialized()
    assert runs["one_rank"] == runs["plain"] and len(runs["plain"]) == 2


def _jax_template(line: str) -> str:
    """``line`` (a message's f-string template) as it stands in JAX's ``flux2_tpu/cli/train.py``."""
    with open(os.path.join(ROOT, "flux2_tpu", "cli", "train.py")) as f:
        assert line in f.read(), line
    return line


@pytest.mark.parametrize("extra,flags,world,template,values", [
    (", pp: 2", ["--shard", "1,1,2"], 1, 'raise SystemExit("pp and --shard are mutually exclusive (pp builds its own '
     'mesh)")', {}),
    (", pp: 4", [], 1, 'f"pp={cfg.pp} must divide both block stacks of {cfg.model} "', {"cfg.pp": 4}),
    (", pp: 2", [], 1, 'raise SystemExit(f"pp*pp_tp={cfg.pp}*{tp} does not divide {n_dev} devices")',
     {"cfg.pp": 2, "tp": 1, "n_dev": 1}),
    (", pp: 2, pp_tp: 4", [], 8, 'f"pp_tp={tp} must divide the attention head count "', {"tp": 4}),
    (", pp: 2, pp_microbatches: 4", [], 4, 'f"batch_size {cfg.batch_size} must split into {m_micro} microbatches "',
     {"cfg.batch_size": 2, "m_micro": 4}),
], ids=["shard", "stacks", "ranks", "heads", "batch"])
def test_train_lora_pp_checks_exit_with_jax_texts(tmp_path, monkeypatch, extra, flags, world, template, values):
    """JAX's checks after the base is built, in JAX's order and with its texts (each held against its template in
    JAX's source, since JAX's run reaches them only after building a full-width base): pp with ``--shard``, stacks
    that pp does not divide, ranks, heads and the batch split (the last two on a world of 8 or 4 ranks as the
    checks count it). Nothing is written."""
    from flux2_tpu_torch.cli import main as cli
    from flux2_tpu_torch.cli import train as cli_train

    from tests.torch_parallel_entry import TRAIN_CONFIG

    monkeypatch.setattr(cli_train, "_world", lambda: world)
    start = _jax_template(template).split('"', 1)[1].rsplit('"', 1)[0]
    for key, value in values.items():
        start = start.replace("{" + key + "}", str(value))
    start = start.split("{", 1)[0]
    cfg = _train_yaml(tmp_path / "cfg.yaml", tmp_path / "out", extra=extra)
    with pytest.raises(SystemExit) as e:
        cli_train.run_training(cli.parse_args(["train-lora", "--config", cfg, "--random-init", "--device", "cpu",
                                               *flags]), "cpu", transformer_config=TRAIN_CONFIG)
    assert str(e.value).startswith(start), (str(e.value), start)
    assert not os.path.exists(tmp_path / "out" / "checkpoint_000003")


def test_train_lora_pp_knobs_without_pp_exit_as_jax_before_any_build(tmp_path, monkeypatch):
    """pp_tp / pp_microbatches / pp_over_dcn without pp > 1 exit with JAX's own text (JAX's run reaches it before
    building anything), before the port builds a base."""
    from flux2_tpu.cli import main as jcli
    from flux2_tpu.cli import train as jtrain

    from flux2_tpu_torch.cli import main as cli
    from flux2_tpu_torch.cli import train as cli_train

    for extra in (", pp_tp: 2", ", pp_microbatches: 2", ", pp_over_dcn: true"):
        cfg = _train_yaml(tmp_path / "cfg.yaml", tmp_path / "out", extra=extra)
        with pytest.raises(SystemExit) as want:
            jtrain.run_training(jcli.build_parser().parse_args(["train-lora", "--config", cfg, "--random-init"]))
        monkeypatch.setattr(cli_train, "_prepare_synthetic_data", None)  # any build past the check would fail
        with pytest.raises(SystemExit) as got:
            cli_train.run_training(cli.parse_args(["train-lora", "--config", cfg, "--random-init", "--device", "cpu"]),
                                   "cpu")
        assert str(got.value) == str(want.value) and "only take effect with pp > 1" in str(want.value)
