"""The PyTorch port never imports JAX.

A fresh interpreter imports the port's server, pipeline, quantization,
trainer and CLI, runs a tiny T2I generate on the CPU through the server, a
tiny w8a8 pipeline built by the CLI's ``build_pipeline`` and a one-step
``train-lora --random-init`` (the JAX package's YAML schema, controller,
registry and safetensors helpers come along), and reports whether any
``jax`` module was loaded. (The suite's conftest imports JAX, so this must run
in a subprocess.)
"""

import json
import os
import subprocess
import sys

SCRIPT = r"""
import argparse, dataclasses, json, sys
import torch
from flux2_tpu.models.flux2.config import Flux2Model, Flux2TransformerConfig
from flux2_tpu.models.text_encoders.config import TINY_DECODER
from flux2_tpu_torch.cli.main import build_pipeline
from flux2_tpu_torch.ops import quant
from flux2_tpu_torch.models.flux2.vae import VAEConfig
from flux2_tpu_torch.pipeline.pipeline import Flux2Pipeline
from flux2_tpu_torch.serve import Flux2Server
from flux2_tpu_torch.io.png import decode_png

tc = Flux2TransformerConfig(num_layers=1, num_single_layers=1, num_attention_heads=1,
                            attention_head_dim=128, joint_attention_dim=32, guidance_embeds=False)
vc = VAEConfig(block_out_channels=(8, 8, 8, 8), layers_per_block=1, norm_num_groups=4)
pipe = Flux2Pipeline.from_random(Flux2Model.KLEIN_4B, device="cpu", dtype=torch.float32,
                                 transformer_config=tc, vae_config=vc)
res = pipe.generate(embeddings=torch.zeros(1, 4, 32), height=32, width=32, num_steps=1, seed=0)
server = Flux2Server(pipe, embeddings_fn=lambda prompt: torch.ones(1, 4, 32))
png = server.generate_png({"prompt": "x", "height": 32, "width": 32, "steps": 1})
server.shutdown()
qtc = dataclasses.replace(tc, num_attention_heads=4, joint_attention_dim=192)
args = argparse.Namespace(model="klein-4b", quantization="w8a8", encoder_quantization="w8a8", random_init=True)
qpipe = build_pipeline(args, "cpu", torch.Generator().manual_seed(0), transformer_config=qtc, vae_config=vc,
                       encoder_config=dataclasses.replace(TINY_DECODER, num_hidden_layers=28, vocab_size=600))
qres = qpipe.generate(prompt="a red fox", height=32, width=32, num_steps=1)
import os, tempfile
from flux2_tpu_torch.cli.main import parse_args
from flux2_tpu_torch.cli.train import run_training
from flux2_tpu_torch.training import trainer
with tempfile.TemporaryDirectory() as tmp:
    cfg = os.path.join(tmp, "cfg.yaml")
    with open(cfg, "w") as f:
        f.write("model: {name: klein-4b}\nlora: {rank: 2}\ndataset: {image_size: 32}\n"
                f"training: {{max_steps: 1}}\ncheckpoints: {{output: {tmp}/out}}\n")
    hist = run_training(parse_args(["train-lora", "--config", cfg, "--random-init", "--device", "cpu"]), "cpu",
                        transformer_config=dataclasses.replace(tc, num_attention_heads=2, joint_attention_dim=96))
    ckpt = sorted(os.listdir(os.path.join(tmp, "out")))
print(json.dumps({"jax": sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")),
                  "image": list(res.image.shape), "png": list(decode_png(png).shape),
                  "w8a8_image": list(qres.image.shape),
                  "w8a8": sorted(set(quant.quantized_names(qpipe.transformer).values())),
                  "train_steps": [r["step"] for r in hist], "checkpoints": ckpt}))
"""


def test_port_runs_without_importing_jax():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=root, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    assert report == {"jax": [], "image": [32, 32, 3], "png": [32, 32, 3], "w8a8_image": [32, 32, 3],
                      "w8a8": ["w8a8"], "train_steps": [1], "checkpoints": ["checkpoint_000001", "learning_curve.svg"]}
