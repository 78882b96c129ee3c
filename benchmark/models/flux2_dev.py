"""FLUX.2-dev configurations: how the benchmark builds the program under test
from a configuration file, and what the plain reference is.

The program is assembled as ``cli.main``'s checkpoint branch assembles it for
``--model dev --quantization w8a8 --encoder-quantization w8a8``: the seeded
checkpoints of ``benchmark/weights_dev.py`` go through the port's loaders,
the DiT's blocks and the encoder's layers quantized as they fill
(``load_transformer`` / ``load_decoder`` with ``quantization``: the result of
``quantize_params`` / ``quantize_encoder_params`` after a whole load, without
a whole bf16 model on the card), the VAE decoder, the Mistral extractor of
the Dev recipe over the stand-in Tekken tokenizer, ``Flux2Pipeline(model=
DEV)``. Requests leave ``guidance`` unset, so the pipeline serves the
model's default. Everything of the program is imported inside the
functions, after the harness has checked for a card.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from benchmark import weights as W
from benchmark import weights_dev
from benchmark.models.flux2_klein import runtime
from benchmark.reference import dev as ref
from benchmark.reference.mistral import TekkenWordTokenizer


def build_pipeline(config: dict, seed: int, device, quantization=None, model: str = None):
    """The port's ``Flux2Pipeline`` of ``config`` on ``device``, weights drawn
    from ``seed``, the DiT and the encoder's layers in the runtime
    (``runtime``) from the first block loaded."""
    from flux2_tpu_torch.io import weight_mapping as wm
    from flux2_tpu_torch.models.flux2.config import Flux2Model, Flux2TransformerConfig
    from flux2_tpu_torch.models.flux2.vae import VAEConfig
    from flux2_tpu_torch.models.text_encoders.config import DecoderConfig
    from flux2_tpu_torch.models.text_encoders.extractor import mistral_extractor
    from flux2_tpu_torch.pipeline.pipeline import Flux2Pipeline

    quantization = runtime(config, quantization)
    ck = weights_dev.checkpoints(config, seed, device)
    dtype = W.DTYPES[config["dtype"]]
    t = dict(config["transformer"])
    t["axes_dims_rope"] = tuple(t["axes_dims_rope"])
    transformer = wm.load_transformer(ck["transformer"], Flux2TransformerConfig(**t), device, dtype,
                                      quantization=quantization)
    del ck["transformer"]
    vae = wm.load_vae(ck["vae"], VAEConfig.from_json_dict(config["vae"]), device)
    pipe = Flux2Pipeline(model=Flux2Model(model or config["model"]), transformer=transformer, vae=vae,
                         device=torch.device(device))
    enc = config["text_encoder"]
    decoder = wm.load_decoder(ck["text_encoder"], DecoderConfig.from_json_dict(enc, qk_norm=False, llama4=True),
                              device, dtype, quantization=quantization)
    del ck["text_encoder"]
    extractor = mistral_extractor(decoder, TekkenWordTokenizer(enc["vocab_size"]))
    extractor.hidden_layers = tuple(enc["hidden_layers"])
    extractor.max_length = enc["max_length"]
    pipe.text_encoder = extractor
    return pipe


def reference_requests(config: dict, seed: int, device, served: List[dict],
                       fp8_control: bool = False) -> List[Dict[str, torch.Tensor]]:
    """``reference/dev.py``'s. ``fp8_control`` is the harness's name for the
    later stages' control; here it is one precision below the
    configuration's w8a8: the W4A8-rounded denoising (and the fp8 decode)."""
    return ref.reference_requests(config, seed, device, served, control=fp8_control)
