"""Load the JAX package's parameter pytrees into the port's modules.

Each function takes ``flux2_tpu``'s parameter dict (leaves as numpy arrays,
or anything ``np.asarray`` accepts) and returns the port's module holding the
same weights, on the CPU, so both packages compute the same function. Pure
numpy + torch: JAX stores linear weights [in, out] (stacked [L, in, out] for
layers) and convolutions HWIO; the port stores [out, in] and OIHW.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from flux2_tpu.models.flux2.config import Flux2TransformerConfig
from flux2_tpu.models.text_encoders.config import DecoderConfig
from flux2_tpu_torch.models.flux2.transformer import Flux2Transformer
from flux2_tpu_torch.models.flux2.vae import VAEConfig, VAEDecoder
from flux2_tpu_torch.models.text_encoders.decoder import Qwen3Decoder


def _tensor(x) -> torch.Tensor:
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":  # ml_dtypes bf16: same bits as torch's
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a).copy())


def _linear(x) -> torch.Tensor:
    """[in, out] -> [out, in]."""
    return _tensor(x).T.contiguous()


def _load(module: torch.nn.Module, state: Dict[str, torch.Tensor]) -> torch.nn.Module:
    module.load_state_dict(state, strict=True)
    return module


def transformer_from_jax(params: dict, config: Flux2TransformerConfig) -> Flux2Transformer:
    dtype = _tensor(params["x_embedder"]["kernel"]).dtype
    sd = {
        "x_embedder": _linear(params["x_embedder"]["kernel"]),
        "context_embedder": _linear(params["context_embedder"]["kernel"]),
        "time_linear1": _linear(params["time_embed"]["linear1"]),
        "time_linear2": _linear(params["time_embed"]["linear2"]),
        "double_mod_img": _linear(params["double_mod_img"]["kernel"]),
        "double_mod_txt": _linear(params["double_mod_txt"]["kernel"]),
        "single_mod": _linear(params["single_mod"]["kernel"]),
        "norm_out": _linear(params["norm_out"]["kernel"]),
        "proj_out": _linear(params["proj_out"]["kernel"]),
    }
    if config.guidance_embeds:
        sd["guidance_linear1"] = _linear(params["guidance_embed"]["linear1"])
        sd["guidance_linear2"] = _linear(params["guidance_embed"]["linear2"])
    for stack, n in (("double_blocks", config.num_layers), ("single_blocks", config.num_single_layers)):
        for name, arr in params[stack].items():
            arr = np.asarray(arr)
            for i in range(n):
                # [L, in, out] linear stacks transpose; [L, head_dim] norm scales do not
                sd[f"{stack}.{i}.{name}"] = _linear(arr[i]) if arr.ndim == 3 else _tensor(arr[i])
    return _load(Flux2Transformer(config, device="cpu", dtype=dtype), sd)


def _conv(p: dict, prefix: str, sd: dict) -> None:
    sd[f"{prefix}.weight"] = _tensor(np.asarray(p["kernel"]).transpose(3, 2, 0, 1))  # HWIO -> OIHW
    sd[f"{prefix}.bias"] = _tensor(p["bias"])


def _norm(p: dict, prefix: str, sd: dict) -> None:
    sd[f"{prefix}.weight"] = _tensor(p["scale"])
    sd[f"{prefix}.bias"] = _tensor(p["bias"])


def _resnet(p: dict, prefix: str, sd: dict) -> None:
    _norm(p["norm1"], f"{prefix}.norm1", sd)
    _conv(p["conv1"], f"{prefix}.conv1", sd)
    _norm(p["norm2"], f"{prefix}.norm2", sd)
    _conv(p["conv2"], f"{prefix}.conv2", sd)
    if "conv_shortcut" in p:
        _conv(p["conv_shortcut"], f"{prefix}.conv_shortcut", sd)


def vae_from_jax(params: dict, config) -> VAEDecoder:
    """The decoder half of the JAX VAE. ``config`` is the port's ``VAEConfig``
    or the JAX package's (its decoder fields are read)."""
    config = VAEConfig(**{f.name: getattr(config, f.name) for f in dataclasses.fields(VAEConfig)})
    dec = params["decoder"]
    sd: Dict[str, torch.Tensor] = {}
    _conv(params["post_quant_conv"], "post_quant_conv", sd)
    _conv(dec["conv_in"], "conv_in", sd)
    _resnet(dec["mid"]["resnet1"], "mid_resnet1", sd)
    _resnet(dec["mid"]["resnet2"], "mid_resnet2", sd)
    attn = dec["mid"]["attn"]
    _norm(attn["group_norm"], "mid_attn.group_norm", sd)
    for name in ("to_q", "to_k", "to_v", "to_out"):
        sd[f"mid_attn.{name}.weight"] = _linear(attn[name]["kernel"])
        sd[f"mid_attn.{name}.bias"] = _tensor(attn[name]["bias"])
    for i, blk in enumerate(dec["up_blocks"]):
        for j, r in enumerate(blk["resnets"]):
            _resnet(r, f"up_blocks.{i}.resnets.{j}", sd)
        if "upsample" in blk:
            _conv(blk["upsample"], f"up_blocks.{i}.upsample", sd)
    _norm(dec["norm_out"], "norm_out", sd)
    _conv(dec["conv_out"], "conv_out", sd)
    sd["bn_running_mean"] = _tensor(params["bn"]["running_mean"])
    sd["bn_running_var"] = _tensor(params["bn"]["running_var"])
    return _load(VAEDecoder(config, device="cpu"), sd)


def decoder_from_jax(params: dict, config: DecoderConfig) -> Qwen3Decoder:
    """The hidden-state path of the JAX decoder (``final_norm`` and
    ``lm_head`` are not used by it and are not loaded)."""
    embed = _tensor(params["embed_tokens"])
    sd: Dict[str, torch.Tensor] = {"embed_tokens": embed}
    for name, arr in params["layers"].items():
        arr = np.asarray(arr)
        for i in range(config.num_hidden_layers):
            sd[f"layers.{i}.{name}"] = _linear(arr[i]) if arr.ndim == 3 else _tensor(arr[i])
    return _load(Qwen3Decoder(config, device="cpu", dtype=embed.dtype), sd)
