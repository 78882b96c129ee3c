"""The PyTorch port never imports JAX, nor anything of the JAX package.

A fresh interpreter imports the port's server, pipeline, quantization,
trainer and CLI (and only the port: its configs, YAML schema, controller,
registry and safetensors helpers are its own copies), runs a tiny T2I generate
on the CPU through the server, a tiny w8a8 pipeline built by the CLI's
``build_pipeline``, a one-step ``train-lora --random-init``, and ``t2i`` and
``profile --compare`` from checkpoint directories it writes (the checkpoint
loaders, registry, facade, profiler and memory telemetry), I2I: a request with a
base64 PNG reference through the server, a klein-9b-kv generate on the
KV-cached path, and ``i2i`` from the checkpoint directories (the VAE
encoder's loader), the editing slice: an inpaint and an outpaint through the
chains (``utils/native.py``'s image ops), a generate with a step hook and
every callback, a tiled decode under a memory profile and ``auto_profile``
(``utils/memory.py``), the serving slice: /generate, /models and /info through
``serve.make_handler`` on localhost, a runtime beacon, ``mask-subject`` and
``subject_mask`` on the committed U-Net, a ``utils/quality.py`` metric, the
LoRA / prequantized slice: ``export-quantized`` with a LoRA baked, ``t2i``
w8a8 from the file and ``t2i --lora`` (the loader), the real-data training
slice: ``train-lora`` from the checkpoint directories on a dataset with a
preview and the held-out loss (``training/data.py``,
``training/validation.py``) and ``evaluate-lora``, the Dev / text-generation
slice: ``t2i --model dev --random-init --upsample`` at a tiny size (Mistral,
Tekken, the KV-cached decode) and ``python -m flux2_tpu_torch.cli.encoders
generate``, the VLM slice: a random Pixtral + Mistral analysis, a Qwen3.5-VL
checkpoint read by ``flux-encoders vision --image2``, its service enriching an
inpaint prompt (``chains/vlm_prompt.py``) and the Qwen3-VL tower, the parallel slice: a sharded w8a8
generate under context parallelism on a one-rank CPU mesh (``flux2_tpu_torch.parallel.*``), the sharded
encoder and ``t2i --shard``, the pp slice: a train step through ``parallel/pipeline.py``'s
``make_pp_forward`` on a one-rank CPU mesh against the dense step (held by ``chip_smoke.py``'s
``phase_pp`` helpers) and ``train-lora --random-init --shard``, the last slice: greedy tokens of a
decoder sharded by ``shard_params`` on that mesh, ``tools.train_segmenter`` for one step and
``tools.fidelity_gate``'s download probe (the hub patched to act offline), and reports whether any ``jax`` or
``flux2_tpu`` module was loaded. (The suite's conftest imports JAX, so this must run in a
subprocess.)
"""

import json
import os
import subprocess
import sys

SCRIPT = r"""
import argparse, dataclasses, json, sys
import torch
torch.set_num_threads(1)  # tiny ops beside the suite's other workers: a thread a core oversubscribes the host
from flux2_tpu_torch.models.flux2.config import Flux2Model, Flux2TransformerConfig
from flux2_tpu_torch.models.text_encoders.config import TINY_DECODER
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
import base64
from flux2_tpu_torch.io.png import encode_png
ref_png = encode_png(decode_png(png))
i2i_png = server.generate_png({"prompt": "x", "height": 32, "width": 32, "steps": 2, "strength": 0.5,
                               "references": [base64.b64encode(ref_png).decode()]})
server.shutdown()
kv = dataclasses.replace(pipe, model=Flux2Model.KLEIN_9B_KV)
ref_lat, ref_ids = kv.encode_reference_images([decode_png(ref_png) / 255.0])
kv_res = kv.generate(embeddings=torch.zeros(1, 4, 32), height=32, width=32, num_steps=2, reference_latents=ref_lat,
                     reference_ids=ref_ids)
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
# checkpoints: the tiny dense pipeline written as checkpoint directories by
# the writers of utils/synthetic.py, then t2i and profile from them through the CLI
import chip_smoke
from flux2_tpu_torch.cli import main as cli
from flux2_tpu_torch.utils import inline_bpe_tokenizer, synthetic
dense = build_pipeline(argparse.Namespace(model="klein-4b", random_init=True), "cpu", torch.Generator().manual_seed(0),
                       transformer_config=qtc, vae_config=vc,
                       encoder_config=dataclasses.replace(TINY_DECODER, num_hidden_layers=28, vocab_size=600))
with tempfile.TemporaryDirectory() as tmp:
    dirs = {k: os.path.join(tmp, k) for k in ("t", "v", "e")}
    synthetic.write_sharded(dirs["t"], synthetic.diffusers_transformer_state(dense.transformer), "m",
                            dataclasses.asdict(qtc))
    synthetic.write_sharded(dirs["v"], synthetic.autoencoder_state(dense.vae, dense.vae_encoder), "m",
                            dataclasses.asdict(vc))
    synthetic.write_sharded(dirs["e"], synthetic.qwen3_state(dense.text_encoder.decoder, 28), "m",
                            dataclasses.asdict(dense.text_encoder.decoder.cfg))
    inline_bpe_tokenizer().save_pretrained(dirs["e"])
    flags = ["--transformer-dir", dirs["t"], "--vae-dir", dirs["v"], "--encoder-dir", dirs["e"], "--width", "32",
             "--height", "32", "--steps", "1", "--device", "cpu"]
    cli.main(["t2i", *flags, "-o", os.path.join(tmp, "x.png")])
    cli.main(["profile", *flags, "--compare", "bf16,w8a8", "--runs", "1"])
    ckpt_png = list(decode_png(open(os.path.join(tmp, "x.png"), "rb").read()).shape)
    cli.main(["i2i", *flags, "--reference", os.path.join(tmp, "x.png"), "-o", os.path.join(tmp, "y.png")])
    i2i_ckpt_png = list(decode_png(open(os.path.join(tmp, "y.png"), "rb").read()).shape)
    # LoRA inference and prequantized checkpoints: a LoRA written by chip_smoke's writer (with its Turbo
    # sidecar), export-quantized with the LoRA baked, t2i w8a8 from the file, t2i --lora
    lora_path = os.path.join(tmp, "lora.safetensors")
    chip_smoke._write_lora(lora_path, chip_smoke._bfl_lora_state(qtc, 2, torch.Generator().manual_seed(0)))
    cli.main(["export-quantized", "--transformer-dir", dirs["t"], "--quantization", "qint8", "--lora", lora_path,
              "--device", "cpu"])
    cli.main(["t2i", *flags, "--quantization", "w8a8", "-o", os.path.join(tmp, "q.png")])
    cli.main(["t2i", *flags, "--lora", f"{lora_path}:0.5", "-o", os.path.join(tmp, "l.png")])
    from flux2_tpu_torch.io import checkpoints as tck
    prequant = sorted(tck.load_prequantized(tck.prequantized_path(dirs["t"], "qint8"), dirs["t"])[1].items())[:2]
    lora_pngs = [list(decode_png(open(os.path.join(tmp, f), "rb").read()).shape) for f in ("q.png", "l.png")]
    # the real-data training slice: train-lora from the directories on a dataset (training/data.py, the
    # previews of training/validation.py, the held-out loss), then evaluate-lora
    data = synthetic.write_dataset(os.path.join(tmp, "data"), 0, [(32, 32), (32, 48)])
    cfg = os.path.join(tmp, "real.yaml")
    with open(cfg, "w") as f:
        f.write(f"model: {{name: klein-4b}}\nlora: {{rank: 2}}\ndataset: {{path: {data['dataset']}, image_size: 32, "
                f"validation_path: {data['dataset']}}}\ntraining: {{max_steps: 1}}\ncheckpoints: {{output: "
                f"{tmp}/real, save_every: 1}}\nvalidation: {{prompts: [a fox], steps: 1, size: 32}}\n")
    cli.main(["train-lora", "--config", cfg, "--transformer-dir", dirs["t"], "--vae-dir", dirs["v"], "--encoder-dir",
              dirs["e"], "--device", "cpu"])
    real = sorted(os.listdir(os.path.join(tmp, "real")))
    cli.main(["evaluate-lora", *flags, "--dataset", data["dataset"], "--max-samples", "1", "--no-vlm", "--output-dir",
              os.path.join(tmp, "eval")])
    evaluated = sorted(os.listdir(os.path.join(tmp, "eval")))
# the editing slice: chains, hooks and callbacks, tiled decode, memory profiles
import numpy as np
from flux2_tpu_torch.chains.inpaint import MaskedInpaintingChain
from flux2_tpu_torch.chains.outpaint import OutpaintingChain
from flux2_tpu_torch.utils import memory, native
src = np.random.RandomState(0).rand(32, 32, 3).astype(np.float32)
mask = np.zeros((32, 32), np.float32)
mask[8:24, 8:24] = 1.0
inpainted = MaskedInpaintingChain(pipe, "x", src, mask, embeddings=torch.zeros(1, 4, 32), steps=2,
                                  mask_crop_padding=4, composite_on_original=True).run()
outpainted = OutpaintingChain(pipe, src, "x", left=32, steps=2, embeddings=torch.zeros(1, 4, 32)).run()
seen = []
pipe.generate(embeddings=torch.zeros(1, 4, 32), height=32, width=32, num_steps=2,
              step_hook=lambda lat, s, sn, i: lat, on_progress=lambda k, n: seen.append(k),
              on_latents=lambda k, lat: seen.append(lat.shape), checkpoint_interval=1,
              on_checkpoint=lambda k, img: seen.append(img.shape))
pipe.memory_profile = dataclasses.replace(memory.MemoryProfile.named("conservative"), vae_tile_threshold_px=16)
tiled = pipe.decode_latents_u8(torch.zeros(1, 4, 128), 32, 32)
profile = memory.auto_profile(Flux2Model.KLEIN_4B, hbm_bytes=80 * 2**30).name
# the serving slice: the HTTP layer, beacons, quality metrics, the segmenter and mask-subject
import http.client, threading
from http.server import ThreadingHTTPServer
from flux2_tpu_torch.serve import make_handler
from flux2_tpu_torch.utils import beacon, quality
from flux2_tpu_torch.chains import segmenter
from flux2_tpu_torch.chains.subject_mask import subject_mask
pipe.memory_profile = None
served = Flux2Server(pipe, embeddings_fn=lambda prompt: torch.ones(1, 4, 32))
httpd = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(served))
threading.Thread(target=httpd.serve_forever, daemon=True).start()
answers = []
for method, path, body in (("POST", "/generate", {"prompt": "x", "height": 32, "width": 32, "steps": 1}),
                           ("GET", "/models", None), ("GET", "/info", None)):
    conn = http.client.HTTPConnection("127.0.0.1", httpd.server_address[1], timeout=60)
    conn.request(method, path, body=json.dumps(body) if body else None)
    resp = conn.getresponse()
    answers.append([resp.status, resp.getheader("Content-Type"), len(resp.read()) > 0])
    conn.close()
httpd.shutdown()
served.shutdown()
with tempfile.TemporaryDirectory() as tmp:
    os.environ["FLUX2_BEACON_DIR"] = tmp
    with beacon.RuntimeBeacon("generate", model="klein-4b", force=True):
        beacons = len(beacon.list_active())
    mask_path = os.path.join(tmp, "m.png")
    with open(mask_path, "wb") as f:
        f.write(encode_png((src[:16, :16] * 255).astype("uint8")))
    cli.main(["mask-subject", "--image", mask_path, "--device", "cpu", "-o", mask_path])
    mask_png = list(decode_png(open(mask_path, "rb").read()).shape)
segmented = list(subject_mask(src, device="cpu").shape)
psnr = round(quality.psnr(src, src * 0.5), 3)
# the Dev / text-generation slice: t2i --model dev --random-init --upsample at a tiny size (a 31-layer
# Mistral, the Tekken tokenizer, the KV-cached decode), and the flux-encoders CLI's generate from a
# Qwen3 checkpoint directory
import contextlib, io
from flux2_tpu_torch.cli import encoders
real_build = cli.build_pipeline
mistral = dataclasses.replace(TINY_DECODER, num_hidden_layers=31, qk_norm=False, tie_word_embeddings=False,
                              llama4_scaling_beta=0.1, vocab_size=1300)
cli.build_pipeline = lambda a, d: real_build(a, d, transformer_config=dataclasses.replace(qtc, guidance_embeds=True),
                                             vae_config=vc, encoder_config=mistral)
with tempfile.TemporaryDirectory() as tmp:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        cli.main(["t2i", "--model", "dev", "--random-init", "--upsample", "--prompt", "a fox", "--width", "32",
                  "--height", "32", "--steps", "1", "--device", "cpu", "-o", os.path.join(tmp, "d.png")])
    dev_png = list(decode_png(open(os.path.join(tmp, "d.png"), "rb").read()).shape)
    dev_upsampled = "[upsample] final prompt: " in out.getvalue()
    enc_dir = os.path.join(tmp, "e")
    synthetic.write_sharded(enc_dir, synthetic.qwen3_state(dense.text_encoder.decoder, 28), "m",
                            dataclasses.asdict(dense.text_encoder.decoder.cfg))
    inline_bpe_tokenizer().save_pretrained(enc_dir)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        encoders.main(["generate", "--encoder-dir", enc_dir, "--prompt", "a fox", "--max-tokens", "2",
                       "--temperature", "0", "--device", "cpu"])
    generated = len(out.getvalue()) > 0
# the VLM slice: a random Pixtral + Mistral service, a Qwen3.5-VL checkpoint written by utils/synthetic.py and
# read by flux-encoders vision (--image2), its service enriching an inpaint prompt, and the Qwen3-VL tower
from flux2_tpu_torch.chains.vlm_prompt import InpaintIntent
from flux2_tpu_torch.models.text_encoders import facade, pixtral, qwen35, qwen35_vision, qwen3vl, vlm_service
from flux2_tpu_torch.models.text_encoders.decoder import Qwen3Decoder
from flux2_tpu_torch.models.text_encoders.generation import GenerateParameters
from flux2_tpu_torch.models.text_encoders.tekken import TekkenTokenizer
g = torch.Generator().manual_seed(0)
mcfg = dataclasses.replace(TINY_DECODER, qk_norm=False, llama4_scaling_beta=0.1, tie_word_embeddings=False,
                           vocab_size=1300)
tower = pixtral.PixtralVision.from_random(dataclasses.replace(pixtral.TINY_PIXTRAL, text_hidden_size=64), "cpu", g,
                                         dtype=torch.float32)
msvc = vlm_service.MistralVLMService(Qwen3Decoder(mcfg, generator=g, dtype=torch.float32), mcfg, tower, tower.cfg,
                                     TekkenTokenizer.byte_fallback())
mistral_reply = isinstance(msvc.analyze_image(src, "describe", GenerateParameters(max_tokens=2, temperature=0)), str)
with tempfile.TemporaryDirectory() as tmp:
    synthetic.write_qwen35_vl_checkpoint(tmp, dataclasses.replace(qwen35.TINY_QWEN35, vocab_size=600),
                                         dataclasses.replace(qwen35_vision.TINY_VISION, depth=1, out_hidden_size=64),
                                         torch.Generator().manual_seed(1), synthetic.vocab_tokenizer(600),
                                         dtype=torch.float32)
    img_path = os.path.join(tmp, "i.png")
    with open(img_path, "wb") as f:
        f.write(encode_png((src * 255).astype("uint8")))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        encoders.main(["vision", "--encoder-dir", tmp, "--image", img_path, "--image2", img_path, "--device", "cpu"])
    compared = sorted(json.loads(out.getvalue()))
    enriched = MaskedInpaintingChain(dataclasses.replace(pipe, vlm=facade.shared._vlm), "a door", src, mask,
                                     enrich_prompt_with_vlm=True, intent=InpaintIntent.REMOVE
                                     )._resolve_final_prompt_and_upsample()[0] != "a door"
ids = torch.arange(5)[None]
vl_states = list(qwen3vl.forward_hidden_states(dense.text_encoder.decoder, ids, torch.ones_like(ids),
                                               section=(4, 2, 2), hf_canonical=True).shape)
# the parallel slice on a one-rank CPU mesh: a sharded w8a8 generate under context parallelism (the
# partitioned K5 body and the ring), the sharded encoder, and the CLI's --shard
from flux2_tpu_torch.parallel import mesh as pmesh, quant_partition, ring_attention, sharding
one = pmesh.make_mesh(1, 1, 1, 1, device_type="cpu")
qpipe.shard(one, context_parallel=True)
cp_image = list(qpipe.generate(prompt="a red fox", height=32, width=32, num_steps=1).image.shape)
qpipe.encoders.shard(qpipe.text_encoder_name, one)
cp_emb = list(qpipe.text_encoder("a red fox").shape)
cli.build_pipeline = lambda a, d: real_build(a, d, transformer_config=qtc, vae_config=vc, encoder_config=dataclasses.replace(
    TINY_DECODER, num_hidden_layers=28, vocab_size=600))
with tempfile.TemporaryDirectory() as tmp:
    with contextlib.redirect_stdout(io.StringIO()):
        cli.main(["t2i", "--random-init", "--width", "32", "--height", "32", "--steps", "1", "--shard", "1,1,1",
                  "--device", "cpu", "-o", os.path.join(tmp, "s.png")])
    shard_png = list(decode_png(open(os.path.join(tmp, "s.png"), "rb").read()).shape)
# the pp slice on the one-rank CPU mesh: a train step through make_pp_forward (2 microbatches) against the
# dense step, held by chip_smoke's phase_pp helpers, and train-lora's --shard in the random-init branch
from flux2_tpu_torch.models.flux2.transformer import Flux2Transformer
from flux2_tpu_torch.parallel import pipeline as ppl
from flux2_tpu_torch.ops import latents as plu
from flux2_tpu_torch.ops.rope import rope_embeddings
ppm = ppl.make_pp_mesh(1, 1, 1, device_type="cpu")
pdit = ppl.place_stages(Flux2Transformer(tc, dtype=torch.float32, generator=torch.Generator().manual_seed(0)), ppm)
pcos, psin = rope_embeddings(torch.from_numpy(__import__("numpy").concatenate(
    [plu.text_position_ids(4), plu.image_position_ids(32, 32)])))
pbatch = {"latents": torch.randn(2, 4, 128), "embeddings": torch.randn(2, 4, 32), "rope_cos": pcos, "rope_sin": psin}
ptcfg = trainer.TrainConfig(rank=2, alpha=2.0, remat=True)
pgrads = []
for pfwd in (None, ppl.make_pp_forward(ppm, 2)):
    pstate = trainer.init_train_state(pdit, ptcfg, torch.Generator().manual_seed(1))
    trainer.make_train_step(pdit, ptcfg, forward_fn=pfwd)(pstate.lora, pstate.optimizer, dict(pbatch),
                                                          torch.Generator().manual_seed(2))
    pgrads.append({n: p.grad for n, p in pstate.lora.named_parameters()})
with tempfile.TemporaryDirectory() as tmp:
    cfg = os.path.join(tmp, "pp.yaml")
    with open(cfg, "w") as f:
        f.write(f"model: {{name: klein-4b}}\nlora: {{rank: 2, alpha: 2}}\ndataset: {{image_size: 32}}\n"
                f"training: {{max_steps: 1}}\ncheckpoints: {{output: {tmp}/out, save_every: 0}}\n")
    phist = run_training(parse_args(["train-lora", "--config", cfg, "--random-init", "--shard", "1,1,1",
                                     "--device", "cpu"]), "cpu", transformer_config=tc)
pp_slice = [chip_smoke._rel_tree(pgrads[1], pgrads[0]) < 1e-5, chip_smoke.PP_QLORA_K5, [r["step"] for r in phist]]
# the last slice: greedy tokens of a decoder sharded by shard_params on the one-rank CPU mesh against the
# unsharded one's, the segmenter trainer for one step, and the fidelity gate's download probe with the hub
# acting offline (its snapshot returns the empty directory, its file download fails)
import copy, huggingface_hub
from flux2_tpu_torch.models.text_encoders import generation
from flux2_tpu_torch.models.text_encoders.decoder import Qwen3Decoder
from flux2_tpu_torch.tools import fidelity_gate, train_segmenter
plain_dec = Qwen3Decoder(TINY_DECODER, dtype=torch.float32, generator=torch.Generator().manual_seed(3))
sharded_dec = sharding.shard_params(copy.deepcopy(plain_dec), one, sharding.DECODER_RULES)
greedy = generation.GenerateParameters(max_tokens=4, temperature=0.0)
decode = [generation.generate(d, [1, 2, 3], greedy) for d in (plain_dec, sharded_dec)]
def _offline(*a, **kw):
    raise OSError("offline")
huggingface_hub.snapshot_download = lambda repo_id, local_dir=None, **kw: local_dir
huggingface_hub.hf_hub_download = _offline
with tempfile.TemporaryDirectory() as tmp:
    os.environ["FLUX2_MODELS_DIR"] = os.path.join(tmp, "models")
    with contextlib.redirect_stdout(io.StringIO()):
        seg_hist = train_segmenter.train(train_segmenter.build_parser().parse_args(
            ["--steps", "1", "--batch", "1", "--device", "cpu", "--out", os.path.join(tmp, "seg.safetensors")]))
        fidelity_gate.main(["--attempt-download", "klein-4b", "--models", "", "--out", os.path.join(tmp, "g.json")])
    gate = json.load(open(os.path.join(tmp, "g.json")))
last = [decode[0] == decode[1] and len(decode[0]) == 4, len(seg_hist["losses"]),
        [gate["download_probe"]["outcome"], gate["tekken_probe"]["outcome"], gate["ok"]]]
parallel = [cp_image, cp_emb, shard_png, sorted(m.rsplit(".", 1)[1] for m in sys.modules
                                                if m.startswith("flux2_tpu_torch.parallel."))]
print(json.dumps({"jax": sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")),
                  "flux2_tpu": sorted(m for m in sys.modules if m == "flux2_tpu" or m.startswith("flux2_tpu.")),
                  "image": list(res.image.shape), "png": list(decode_png(png).shape),
                  "w8a8_image": list(qres.image.shape),
                  "w8a8": sorted(set(quant.quantized_names(qpipe.transformer).values())),
                  "train_steps": [r["step"] for r in hist], "checkpoints": ckpt, "checkpoint_png": ckpt_png,
                  "i2i_png": list(decode_png(i2i_png).shape), "kv_latents": list(kv_res.latents.shape),
                  "i2i_checkpoint_png": i2i_ckpt_png, "inpaint": list(inpainted.image.shape),
                  "outpaint": list(outpainted.image.shape), "callbacks": [list(x) if isinstance(x, tuple) else x
                                                                         for x in seen],
                  "tiled": list(tiled.shape), "auto_profile": profile, "native": native.path_name() != "numpy",
                  "http": answers, "beacons": beacons, "mask_png": mask_png, "segmented": segmented,
                  "psnr": psnr, "lora_pngs": lora_pngs, "prequant": [k for k, _ in prequant], "real": real,
                  "evaluated": evaluated, "dev_png": dev_png, "dev_upsampled": dev_upsampled,
                  "generated": generated, "vlm": [mistral_reply, compared, enriched, vl_states],
                  "parallel": parallel, "pp": pp_slice, "last": last}))
"""


def test_port_runs_without_importing_jax():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root, HF_HUB_OFFLINE="1")
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=root, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    assert report == {"jax": [], "flux2_tpu": [], "image": [32, 32, 3], "png": [32, 32, 3], "w8a8_image": [32, 32, 3],
                      "w8a8": ["w8a8"], "train_steps": [1], "checkpoints": ["checkpoint_000001", "learning_curve.svg"],
                      "checkpoint_png": [32, 32, 3], "i2i_png": [32, 32, 3], "kv_latents": [1, 4, 128],
                      "i2i_checkpoint_png": [32, 32, 3], "inpaint": [32, 32, 3], "outpaint": [32, 64, 3],
                      "callbacks": [1, [1, 4, 128], 2, [1, 4, 128], [32, 32, 3]], "tiled": [1, 32, 32, 3],
                      "auto_profile": "performance", "native": True,
                      "http": [[200, "image/png", True], [200, "application/json", True],
                               [200, "application/json", True]],
                      "beacons": 1, "mask_png": [16, 16, 3], "segmented": [32, 32], "psnr": 10.716,
                      "lora_pngs": [[32, 32, 3], [32, 32, 3]], "prequant": ["format", "lora_baked"],
                      "real": ["best", "checkpoint_000001", "latent_cache", "learning_curve.svg", "val_latent_cache",
                               "validation"],
                      "evaluated": ["baseline_000.png"], "dev_png": [32, 32, 3], "dev_upsampled": True,
                      "generated": True,
                      "vlm": [True, ["scene_reason", "scene_score", "style_reason", "style_score"], True,
                              [29, 1, 5, 64]],
                      "parallel": [[32, 32, 3], [1, 512, 192], [32, 32, 3],
                                   ["mesh", "pipeline", "quant_partition", "ring_attention", "sharding"]],
                      "pp": [True, 806, [1]], "last": [True, 1, ["unavailable", "unavailable", False]]}
