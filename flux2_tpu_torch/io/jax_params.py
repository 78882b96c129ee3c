"""Load the JAX package's parameter pytrees into the port's modules.

Each function takes ``flux2_tpu``'s parameter dict (leaves as numpy arrays,
or anything ``np.asarray`` accepts) and returns the port's module holding the
same weights, on the CPU, so both packages compute the same function. Pure
numpy + torch: JAX stores linear weights [in, out] (stacked [L, in, out] for
layers) and convolutions HWIO; the port stores [out, in] and OIHW.

A linear leaf may also be one of JAX's quantized weights (``QTensor``,
``W8A8Tensor``, ``W4A8Tensor``, recognised by their fields, so no JAX import):
it is split per layer and carried into the port's quantized module with its
codes and scales moved to the [N, K] layout, bit for bit
(``flux2_tpu_torch/ops/quant.py``).

LoRA adapters go both ways: ``lora_from_jax`` splits JAX's stacked
``{group: {leaf: {a [L, in, r], b [L, r, out]}}}`` into the port's ``LoRA``
module, and ``lora_to_flat`` gives the flat names and shapes of JAX's
``trainer._flatten`` (``"double_blocks.to_q.a"`` -> [L, in, r]), which is what
a ``lora.safetensors`` checkpoint holds in both packages.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from flux2_tpu_torch.models.flux2.config import Flux2TransformerConfig
from flux2_tpu_torch.models.text_encoders.config import DecoderConfig
from flux2_tpu_torch.models.flux2.transformer import Flux2Transformer
from flux2_tpu_torch.models.flux2.vae import VAEConfig, VAEDecoder
from flux2_tpu_torch.models.text_encoders.decoder import Qwen3Decoder
from flux2_tpu_torch.ops.quant import QTensor, W4A8Tensor, W8A8Tensor
from flux2_tpu_torch.training.lora import LoRA, Adapter


# ml_dtypes' types: the same bits as torch's, carried through an integer view
_ML_DTYPES = {"bfloat16": (np.uint16, torch.bfloat16), "float8_e4m3fn": (np.uint8, torch.float8_e4m3fn)}


def _tensor(x) -> torch.Tensor:
    a = np.asarray(x)
    if a.dtype.name in _ML_DTYPES:
        bits, dtype = _ML_DTYPES[a.dtype.name]
        return torch.from_numpy(np.ascontiguousarray(a).view(bits).copy()).view(dtype)
    return torch.from_numpy(np.ascontiguousarray(a).copy())


def _linear(x) -> torch.Tensor:
    """[in, out] -> [out, in]."""
    return _tensor(x).T.contiguous()


def _layer(x, i):
    return np.asarray(x) if i is None else np.asarray(x)[i]


def _quantized(leaf, i=None):
    """JAX quantized leaf (layer ``i`` of a stacked one) -> the port's module, [N, K] layout."""
    def t(x):
        return _linear(_layer(x, i))

    if hasattr(leaf, "group_size"):  # QTensor
        bias = None if leaf.bias is None else t(leaf.bias)
        return QTensor(t(leaf.q), t(leaf.scale), bias, leaf.format, leaf.group_size, leaf.orig_in)
    if hasattr(leaf, "block"):  # W4A8Tensor: packed bytes [K/2, N] -> [N, K/2], same nibbles
        return W4A8Tensor(t(leaf.q), t(leaf.scale), leaf.block, leaf.orig_in)
    return W8A8Tensor(t(leaf.q), _tensor(_layer(leaf.scale, i)[0]), leaf.orig_in)  # scale [1, N] -> [N]


def _is_quantized_leaf(leaf) -> bool:
    return hasattr(leaf, "q") and hasattr(leaf, "scale") and hasattr(leaf, "orig_in")


def _load(module: torch.nn.Module, state: Dict[str, object]) -> torch.nn.Module:
    """Load dense tensors into ``module`` and put each quantized module in place
    of the parameter of its name."""
    dense = {k: v for k, v in state.items() if isinstance(v, torch.Tensor)}
    for name, qw in state.items():
        if name not in dense:
            owner, _, attr = name.rpartition(".")
            mod = module.get_submodule(owner) if owner else module
            delattr(mod, attr)
            setattr(mod, attr, qw)
    missing, unexpected = module.load_state_dict(dense, strict=False)
    quantized = tuple(f"{k}." for k in state if k not in dense)
    missing = [k for k in missing if not k.startswith(quantized)]
    if missing or unexpected:
        raise KeyError(f"missing {missing}, unexpected {unexpected}")
    return module


def _carry(leaf, i=None):
    """A JAX linear leaf (layer ``i`` of a stack) -> the port's [out, in] tensor or quantized module."""
    return _quantized(leaf, i) if _is_quantized_leaf(leaf) else _linear(_layer(leaf, i))


def transformer_from_jax(params: dict, config: Flux2TransformerConfig) -> Flux2Transformer:
    dtype = _tensor(params["double_blocks"]["norm_q"]).dtype  # norm scales are never quantized
    sd = {
        "x_embedder": _carry(params["x_embedder"]["kernel"]),
        "context_embedder": _carry(params["context_embedder"]["kernel"]),
        "time_linear1": _carry(params["time_embed"]["linear1"]),
        "time_linear2": _carry(params["time_embed"]["linear2"]),
        "double_mod_img": _carry(params["double_mod_img"]["kernel"]),
        "double_mod_txt": _carry(params["double_mod_txt"]["kernel"]),
        "single_mod": _carry(params["single_mod"]["kernel"]),
        "norm_out": _carry(params["norm_out"]["kernel"]),
        "proj_out": _carry(params["proj_out"]["kernel"]),
    }
    if config.guidance_embeds:
        sd["guidance_linear1"] = _carry(params["guidance_embed"]["linear1"])
        sd["guidance_linear2"] = _carry(params["guidance_embed"]["linear2"])
    for stack, n in (("double_blocks", config.num_layers), ("single_blocks", config.num_single_layers)):
        for name, leaf in params[stack].items():
            for i in range(n):
                sd[f"{stack}.{i}.{name}"] = _stacked(leaf, i)
    return _load(Flux2Transformer(config, device="cpu", dtype=dtype), sd)


def _stacked(leaf, i):
    """Layer ``i`` of a stacked leaf: [L, in, out] linears (dense or quantized)
    transpose; [L, head_dim] norm scales do not."""
    if _is_quantized_leaf(leaf) or np.asarray(leaf).ndim == 3:
        return _carry(leaf, i)
    return _tensor(np.asarray(leaf)[i])


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
    sd: Dict[str, object] = {"embed_tokens": embed}
    for name, leaf in params["layers"].items():
        for i in range(config.num_hidden_layers):
            sd[f"layers.{i}.{name}"] = _stacked(leaf, i)
    return _load(Qwen3Decoder(config, device="cpu", dtype=embed.dtype), sd)


def lora_from_jax(tree: dict, device: "torch.device | str" = "cpu") -> LoRA:
    """JAX's LoRA pytree (stacked leaves, numpy or anything ``np.asarray``
    takes) -> the port's ``LoRA``, float32 on ``device``."""
    blocks: Dict[str, list] = {}
    for group, leaves in tree.items():
        n = len(np.asarray(next(iter(leaves.values()))["a"]))
        blocks[group] = [{leaf: Adapter(_tensor(np.asarray(ab["a"], np.float32)[i]).to(device),
                                        _tensor(np.asarray(ab["b"], np.float32)[i]).to(device))
                          for leaf, ab in leaves.items()} for i in range(n)]
    return LoRA(blocks)


def lora_from_flat(flat: Dict[str, np.ndarray], device: "torch.device | str" = "cpu") -> LoRA:
    """Flat ``"group.leaf.a"`` arrays (a ``lora.safetensors``) -> the port's ``LoRA``."""
    tree: dict = {}
    for name, arr in flat.items():
        group, leaf, ab = name.split(".")
        tree.setdefault(group, {}).setdefault(leaf, {})[ab] = arr
    return lora_from_jax(tree, device)


def lora_to_flat(lora: LoRA) -> Dict[str, np.ndarray]:
    """The port's ``LoRA`` -> JAX's flat names with stacked float32 leaves."""
    flat: Dict[str, np.ndarray] = {}
    for group, leaf in lora.targets():
        for ab in ("a", "b"):
            flat[f"{group}.{leaf}.{ab}"] = np.stack(
                [getattr(blk[leaf], ab).detach().float().cpu().numpy() for blk in getattr(lora, group)])
    return flat
