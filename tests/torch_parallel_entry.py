"""Entry of the port's multi-rank CLI and serving tests under torchrun.

    python -m torch.distributed.run --standalone --nproc-per-node N \\
        tests/torch_parallel_entry.py cli t2i --random-init --device cpu --shard 1,2,4 ...
    python -m torch.distributed.run --standalone --nproc-per-node 2 \\
        tests/torch_parallel_entry.py serve --tp 2 --random-init --device cpu --port P
    python -m torch.distributed.run --standalone --nproc-per-node 2 \\
        tests/torch_parallel_entry.py train train-lora --config cfg.yaml --random-init --device cpu

Every rank runs ``cli.main.main`` or ``serve.main`` with the rest of the
command line on reduced random-init configs (a 2-head DiT, a small VAE, a
28-layer tiny Qwen3 whose three hidden layers give the DiT's joint width);
``train`` runs ``cli.main.main`` with ``run_training`` on ``TRAIN_CONFIG``.
Under ``serve``, rank 0 writes its pid to ``$PARALLEL_TEST_PIDFILE`` when
that is set, and SIGUSR1 stops its HTTP server as Ctrl-C would, so its
shutdown reaches the followers; each rank then prints ``rank R done``. With
``$PARALLEL_TEST_GROUP_TIMEOUT_S`` every rank starts the process group
itself, with that timeout for each collective, before ``serve.main``.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import signal
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from flux2_tpu_torch.models.flux2.config import Flux2TransformerConfig  # noqa: E402
from flux2_tpu_torch.models.flux2.vae import VAEConfig  # noqa: E402
from flux2_tpu_torch.models.text_encoders.config import TINY_DECODER  # noqa: E402

CONFIGS = {
    "transformer_config": Flux2TransformerConfig(num_layers=1, num_single_layers=2, num_attention_heads=2,
                                                 attention_head_dim=128, joint_attention_dim=192,
                                                 guidance_embeds=False),
    "vae_config": VAEConfig(block_out_channels=(8, 8, 8, 8), layers_per_block=1, norm_num_groups=4),
    "encoder_config": dataclasses.replace(TINY_DECODER, num_hidden_layers=28, vocab_size=600),
}


# train-lora --random-init (the ``train`` entry): 2 double and 2 single blocks, so pp=2 splits both stacks
TRAIN_CONFIG = Flux2TransformerConfig(num_layers=2, num_single_layers=2, num_attention_heads=2, attention_head_dim=128,
                                      joint_attention_dim=96, guidance_embeds=False)


def _interrupt(signum, frame):
    raise KeyboardInterrupt


def main() -> int:
    torch.set_num_threads(1)
    which, argv = sys.argv[1], sys.argv[2:]
    rank = os.environ.get("RANK", "0")
    if which in ("cli", "train"):
        from flux2_tpu_torch.cli import main as cli
        from flux2_tpu_torch.cli import train

        build = cli.build_pipeline
        cli.build_pipeline = lambda args, device, generator=None, **kw: build(args, device, generator, **CONFIGS)
        if which == "train":  # train-lora --random-init on TRAIN_CONFIG (and the small VAE on a dataset)
            run = train.run_training
            train.run_training = lambda args, device: run(args, device, transformer_config=TRAIN_CONFIG,
                                                          vae_config=CONFIGS["vae_config"])
        rc = cli.main(argv)
    else:
        from flux2_tpu_torch import serve

        if rank == "0":
            signal.signal(signal.SIGUSR1, _interrupt)
            if os.environ.get("PARALLEL_TEST_PIDFILE"):
                with open(os.environ["PARALLEL_TEST_PIDFILE"], "w") as f:
                    f.write(str(os.getpid()))
        timeout = os.environ.get("PARALLEL_TEST_GROUP_TIMEOUT_S")
        if timeout:
            import torch.distributed as dist

            dist.init_process_group("gloo", init_method="env://",
                                    timeout=datetime.timedelta(seconds=float(timeout)))
        try:
            serve.main(argv, **CONFIGS)
        except KeyboardInterrupt:
            pass
        if timeout:
            dist.destroy_process_group()
        rc = 0
    print(f"rank {rank} done", file=sys.stderr, flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
