"""FLUX.2 Klein configurations: how the benchmark builds the program under
test from a configuration file, and what the plain reference is.

The program is loaded as a checkpoint download is: the seeded checkpoints
of ``benchmark/weights.py`` go through the port's own loaders
(``io.weight_mapping.load_transformer`` / ``load_vae`` / ``load_decoder``),
into ``Flux2Pipeline`` with the Qwen3 extractor of the Klein recipe, as
``cli.main``'s checkpoint branch assembles it (less the VAE encoder, which
text-to-image never runs). Everything of the program is imported inside
the functions, after the harness has checked for a card.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from benchmark import weights as W
from benchmark.reference import klein as ref
from benchmark.reference.text import WordTokenizer


def runtime(config: dict, quantization=None) -> str:
    """The quantization the program runs: ``quantization`` where given (the
    control's), else the configuration's ``quantization`` key ("bf16"
    when absent)."""
    return quantization or config.get("quantization", "bf16")


def build_pipeline(config: dict, seed: int, device, quantization=None, model: str = None):
    """The port's ``Flux2Pipeline`` of ``config`` on ``device``, weights drawn
    from ``seed``; a runtime other than "bf16" (``runtime``) quantizes the
    DiT and the encoder's layers with the port's own runtime."""
    from flux2_tpu_torch.io import weight_mapping as wm
    from flux2_tpu_torch.models.flux2.config import Flux2Model, Flux2TransformerConfig
    from flux2_tpu_torch.models.flux2.vae import VAEConfig
    from flux2_tpu_torch.models.text_encoders.config import DecoderConfig
    from flux2_tpu_torch.models.text_encoders.extractor import qwen3_extractor, quantize_encoder_params
    from flux2_tpu_torch.ops.quant import quantize_params
    from flux2_tpu_torch.pipeline.pipeline import Flux2Pipeline

    quantization = runtime(config, quantization)
    ck = W.checkpoints(config, seed, device)
    dtype = W.DTYPES[config["dtype"]]
    t = dict(config["transformer"])
    t["axes_dims_rope"] = tuple(t["axes_dims_rope"])
    transformer = wm.load_transformer(ck["transformer"], Flux2TransformerConfig(**t), device, dtype)
    del ck["transformer"]
    if quantization != "bf16":
        quantize_params(transformer, quantization)
    vae = wm.load_vae(ck["vae"], VAEConfig.from_json_dict(config["vae"]), device)
    pipe = Flux2Pipeline(model=Flux2Model(model or config["model"]), transformer=transformer, vae=vae,
                         device=torch.device(device))
    enc = config["text_encoder"]
    decoder = wm.load_decoder(ck["text_encoder"], DecoderConfig.from_json_dict(enc, qk_norm=True), device,
                              dtype)
    if quantization != "bf16":
        quantize_encoder_params(decoder, quantization)
    extractor = qwen3_extractor(decoder, WordTokenizer())
    extractor.hidden_layers = tuple(enc["hidden_layers"])
    extractor.max_length = enc["max_length"]
    pipe.text_encoder = extractor
    return pipe


def reference_requests(config: dict, seed: int, device, served: List[dict],
                       fp8_control: bool = False) -> List[Dict[str, torch.Tensor]]:
    return ref.reference_requests(config, seed, device, served, fp8_control)


# -- LoRA training ---------------------------------------------------------------------------

DOUBLE_LEAVES = {"to_q": (1, 1), "to_k": (1, 1), "to_v": (1, 1), "to_out": (1, 1), "add_q": (1, 1),
                 "add_k": (1, 1), "add_v": (1, 1), "add_out": (1, 1), "ff_in": (1, "2m"), "ff_out": ("m", 1),
                 "ff_ctx_in": (1, "2m"), "ff_ctx_out": ("m", 1)}
SINGLE_LEAVES = {"to_q": (1, 1), "to_k": (1, 1), "to_v": (1, 1), "mlp_gate": (1, "m"), "mlp_up": (1, "m"),
                 "out_attn": (1, 1), "out_mlp": ("m", 1)}


def adapter_groups(t: dict, rank: int, b_scale: float):
    """The adapters an ``attention_ffn`` LoRA puts on the DiT of ``t``, one group
    a block, in the program's names (``double_blocks.i.leaf.a`` [in, r] and
    ``.b`` [r, out]): a ~ N(0, 1 / in), b ~ N(0, b_scale^2), so that every
    leaf has a gradient from the first step (a started at b = 0 would not)."""
    d = t["num_attention_heads"] * t["attention_head_dim"]
    m = int(d * t["mlp_ratio"])
    size = {1: d, "m": m, "2m": 2 * m}
    groups = []
    for group, leaves, n in (("double_blocks", DOUBLE_LEAVES, t["num_layers"]),
                             ("single_blocks", SINGLE_LEAVES, t["num_single_layers"])):
        for i in range(n):
            out = []
            for leaf, (din, dout) in leaves.items():
                key = f"{group}.{i}.{leaf}"
                out.append(W.Leaf(key + ".a", (size[din], rank), "normal", size[din] ** -0.5))
                out.append(W.Leaf(key + ".b", (rank, size[dout]), "normal", b_scale))
            groups.append(W.Group(f"{group}.{i}", tuple(out)))
    return groups


def build_trainer(config: dict, traffic: dict, seed: int, device, quantization=None):
    """(the train step, the adapters, the optimizer) of the port on the DiT of
    ``config``, the adapters set to the benchmark's draw; a runtime other
    than "bf16" (``runtime``) is QLoRA's quantized base."""
    from flux2_tpu_torch.io import weight_mapping as wm
    from flux2_tpu_torch.models.flux2.config import Flux2TransformerConfig
    from flux2_tpu_torch.ops.quant import quantize_params
    from flux2_tpu_torch.training import lora as lora_mod
    from flux2_tpu_torch.training import trainer

    quantization = runtime(config, quantization)
    t = dict(config["transformer"])
    t["axes_dims_rope"] = tuple(t["axes_dims_rope"])
    ck = W.SeededCheckpoint(W.dit_groups(config["transformer"]), seed, "transformer", device,
                            W.DTYPES[config["dtype"]])
    transformer = wm.load_transformer(ck, Flux2TransformerConfig(**t), device, W.DTYPES[config["dtype"]])
    del ck
    if quantization != "bf16":
        quantize_params(transformer, quantization)
    cfg = trainer.TrainConfig(**traffic["train"])
    gen = torch.Generator(device=device).manual_seed(0)
    lora = lora_mod.init_lora(transformer, lora_mod.LoRAConfig(cfg.rank, cfg.alpha, trainer.lora_targets(cfg)), gen)
    drawn = adapters(config, traffic, seed, device)
    params = dict(lora.named_parameters())
    if set(params) != set(drawn):
        raise KeyError(f"adapter names differ: {sorted(set(params) ^ set(drawn))[:4]}")
    with torch.no_grad():
        for name, p in params.items():
            p.copy_(drawn[name])
    return trainer.make_train_step(transformer, cfg), lora, trainer.make_optimizer(cfg, lora)


def adapters(config: dict, traffic: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The adapters' starting values, float32, by name."""
    tr = traffic["train"]
    ck = W.SeededCheckpoint(adapter_groups(config["transformer"], tr["rank"], traffic["adapter_b_scale"]), seed, "lora",
                            device, torch.float32)
    return {k: ck[k].clone() for k in ck}


def train_batches(config: dict, traffic: dict, seed: int, device, n: int) -> List[dict]:
    """``n`` batches of the feed: clean packed latents [B, S_img, 128] float32
    and caption embeddings [B, 512, joint] in the configuration's dtype, each
    batch drawn in two calls from its own generator, as ``train-lora``'s
    latent and caption caches would hand them over."""
    b, px = traffic["batch"], traffic["px"]
    s_img = (px // 16) ** 2
    enc = config["text_encoder"]
    joint = config["transformer"]["joint_attention_dim"]
    out = []
    for i in range(n):
        gen = torch.Generator(device=device).manual_seed(W.group_seed(seed, "batch", i))
        lat = torch.randn((b, s_img, 128), generator=gen, device=device, dtype=torch.float32)
        emb = torch.randn((b, enc["max_length"], joint), generator=gen, device=device,
                          dtype=W.DTYPES[config["dtype"]])
        out.append({"latents": lat, "embeddings": emb})
    return out


def reference_train(config: dict, traffic: dict, seed: int, device, batches: List[dict], draw_seed: int) -> dict:
    """The plain reference's first ``len(batches)`` steps (``reference/lora_train.py``)."""
    from benchmark.reference import dit, lora_train

    tr = traffic["train"]
    ck = W.SeededCheckpoint(W.dit_groups(config["transformer"]), seed, "transformer", device,
                            W.DTYPES[config["dtype"]])
    start = adapters(config, traffic, seed, device)
    keys = sorted({k.rsplit(".", 1)[0] for k in start})
    lora = {k: (start[k + ".a"].requires_grad_(True), start[k + ".b"].requires_grad_(True)) for k in keys}
    px = traffic["px"]
    cos, sin = dit.rope_tables(dit.position_ids(config["text_encoder"]["max_length"], px, px),
                               tuple(config["transformer"]["axes_dims_rope"]), config["transformer"]["rope_theta"],
                               device)
    gen = torch.Generator(device=device).manual_seed(draw_seed)
    with ref.full_f32():
        return lora_train.follow(ck, config["transformer"], lora, tr["alpha"] / tr["rank"], tr,
                                 [{k: v.to(device) for k, v in b.items()} for b in batches], gen, cos, sin)
