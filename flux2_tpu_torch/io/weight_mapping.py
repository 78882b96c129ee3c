"""Checkpoint dialects -> the port's modules: BFL-native and Diffusers FLUX.2
transformers, the Diffusers ``AutoencoderKL`` (decoder and encoder), HF Qwen3
and Mistral (text-only, or a Mistral3 VLM's language model).

Port of ``flux2_tpu/io/weight_mapping.py``: ``dequantize_quanto`` (``:38-54``),
``is_bfl_format`` (``:57``), ``map_transformer_weights`` with ``_map_bfl`` and
``_map_diffusers`` (``:71-232``), ``map_vae_weights`` (``:327-389``, split
into ``map_vae_weights`` for the decoder and ``map_vae_encoder_weights`` for
the encoder and ``quant_conv``), ``map_decoder_weights`` (the final norm and
an untied ``lm_head`` too) and ``strip_language_model_prefix``
(``:397-440``), with the ``model.language_model.`` nesting of newer VLM
checkpoints (JAX reads it for Qwen3.5, ``:568-569``), and the VLMs
(``:442-638``): ``map_pixtral_weights`` (a Mistral3 checkpoint's
``vision_tower.*`` / ``multi_modal_projector.*``), ``map_qwen35_vision_weights``
(``visual.*`` / ``model.visual.*``) and ``map_qwen35_weights`` (qwen3_next
names, the VL nesting too).

Where JAX transposes every linear to [in, out] and stacks the layers, each
``map_*`` here yields (port parameter name, tensor) pairs straight in torch's
[out, in] layout and the checkpoint's dtype, one checkpoint tensor at a time:
the names ``io/jax_params.py`` fills (``double_blocks.{i}.to_q``, ...). Each
``load_*`` builds the module on its device and copies every pair into it as
it comes, cast to the module's dtype (bf16 for the DiT and the encoder, as
JAX's ``_to_bf16``; float32 for the VAE, as ``map_vae_weights``), so the
host holds about one tensor at a time. A weight the module needs and the
checkpoint lacks raises ``KeyError`` naming it, after the whole checkpoint
was read; a checkpoint tensor the module has no place for is skipped, as
JAX skips it.
"""

from __future__ import annotations

import re
from collections.abc import Mapping
from typing import Callable, Iterable, Iterator, List, Optional, Sequence, Tuple

import torch
from torch import nn

from flux2_tpu_torch.models.flux2.config import Flux2TransformerConfig
from flux2_tpu_torch.models.flux2.transformer import Flux2Transformer
from flux2_tpu_torch.models.flux2.vae import VAEConfig, VAEDecoder, VAEEncoder
from flux2_tpu_torch.models.text_encoders.config import DecoderConfig
from flux2_tpu_torch.models.text_encoders.decoder import Qwen3Decoder
from flux2_tpu_torch.models.text_encoders.pixtral import PixtralVision, PixtralVisionConfig
from flux2_tpu_torch.models.text_encoders.qwen35 import Qwen35LM, Qwen35TextConfig
from flux2_tpu_torch.models.text_encoders.qwen35_vision import Qwen35Vision, Qwen35VisionConfig
from flux2_tpu_torch.ops.quant import quantize_params

Item = Tuple[str, torch.Tensor]


# -- quanto (diffusers checkpoints quantized with optimum-quanto) ------------------


def quanto_items(weights: Mapping) -> Iterator[Item]:
    """Every entry of ``weights``, each ``<k>._data`` / ``<k>._scale`` pair
    folded into float ``<k>``: the f32 product of the two (a ``._data``
    without its scale passes as it is)."""
    for key in weights:
        if key.endswith("._scale"):
            continue
        if key.endswith("._data"):
            base = key[: -len("._data")]
            data = weights[key]
            if base + "._scale" in weights:
                data = data.to(torch.float32) * weights[base + "._scale"].to(torch.float32)
            yield base, data
        else:
            yield key, weights[key]


def dequantize_quanto(weights: Mapping) -> dict:
    """Fold ``<k>._data`` (int8) and ``<k>._scale`` pairs into float ``<k>``."""
    return dict(quanto_items(weights))


def _base_names(names: Iterable[str]) -> List[str]:
    return [k[: -len("._data")] if k.endswith("._data") else k for k in names if not k.endswith("._scale")]


def is_bfl_format(names: Iterable[str]) -> bool:
    """True for BFL-native names (a mapping's keys or any iterable of names)."""
    return any(".img_attn.qkv." in k or k == "img_in.weight" for k in _base_names(names))


# -- FLUX.2 transformer ------------------------------------------------------------

_BFL_DOUBLE = {
    "img_attn.proj.weight": "to_out",
    "txt_attn.proj.weight": "add_out",
    "img_attn.norm.query_norm.scale": "norm_q",
    "img_attn.norm.key_norm.scale": "norm_k",
    "txt_attn.norm.query_norm.scale": "norm_added_q",
    "txt_attn.norm.key_norm.scale": "norm_added_k",
    "img_mlp.0.weight": "ff_in",
    "img_mlp.2.weight": "ff_out",
    "txt_mlp.0.weight": "ff_ctx_in",
    "txt_mlp.2.weight": "ff_ctx_out",
}
_BFL_QKV = {"img_attn.qkv.weight": ("to_q", "to_k", "to_v"), "txt_attn.qkv.weight": ("add_q", "add_k", "add_v")}
_BFL_SINGLE = {"norm.query_norm.scale": "norm_q", "norm.key_norm.scale": "norm_k"}
_BFL_TOP = {
    "img_in.weight": "x_embedder",
    "txt_in.weight": "context_embedder",
    "time_in.in_layer.weight": "time_linear1",
    "time_in.out_layer.weight": "time_linear2",
    "guidance_in.in_layer.weight": "guidance_linear1",
    "guidance_in.out_layer.weight": "guidance_linear2",
    "double_stream_modulation_img.lin.weight": "double_mod_img",
    "double_stream_modulation_txt.lin.weight": "double_mod_txt",
    "single_stream_modulation.lin.weight": "single_mod",
    "final_layer.linear.weight": "proj_out",
}

_DIFFUSERS_DOUBLE = {
    "attn.to_q.weight": "to_q",
    "attn.to_k.weight": "to_k",
    "attn.to_v.weight": "to_v",
    "attn.to_out.0.weight": "to_out",
    "attn.add_q_proj.weight": "add_q",
    "attn.add_k_proj.weight": "add_k",
    "attn.add_v_proj.weight": "add_v",
    "attn.to_add_out.weight": "add_out",
    "attn.norm_q.weight": "norm_q",
    "attn.norm_k.weight": "norm_k",
    "attn.norm_added_q.weight": "norm_added_q",
    "attn.norm_added_k.weight": "norm_added_k",
    "ff.linear_in.weight": "ff_in",
    "ff.linear_out.weight": "ff_out",
    "ff_context.linear_in.weight": "ff_ctx_in",
    "ff_context.linear_out.weight": "ff_ctx_out",
}
_DIFFUSERS_SINGLE = {"attn.norm_q.weight": "norm_q", "attn.norm_k.weight": "norm_k"}
_DIFFUSERS_TOP = {
    "x_embedder.weight": "x_embedder",
    "context_embedder.weight": "context_embedder",
    "double_stream_modulation_img.linear.weight": "double_mod_img",
    "double_stream_modulation_txt.linear.weight": "double_mod_txt",
    "single_stream_modulation.linear.weight": "single_mod",
    "norm_out.linear.weight": "norm_out",  # diffusers order: no swap
    "proj_out.weight": "proj_out",
    "time_text_embed.timestep_embedder.linear_1.weight": "time_linear1",
    "time_text_embed.timestep_embedder.linear_2.weight": "time_linear2",
    "time_text_embed.guidance_embedder.linear_1.weight": "guidance_linear1",
    "time_text_embed.guidance_embedder.linear_2.weight": "guidance_linear2",
    "time_guidance_embed.timestep_embedder.linear_1.weight": "time_linear1",
    "time_guidance_embed.timestep_embedder.linear_2.weight": "time_linear2",
    "time_guidance_embed.guidance_embedder.linear_1.weight": "guidance_linear1",
    "time_guidance_embed.guidance_embedder.linear_2.weight": "guidance_linear2",
}

_BLOCK = re.compile(r"(double_blocks|single_blocks|transformer_blocks|single_transformer_blocks)\.(\d+)\.(.+)")


def _single_fused(prefix: str, rest: str, v: torch.Tensor, config: Flux2TransformerConfig) -> List[Item]:
    """A single block's fused input rows [Q | K | V | gate | up] or output
    columns [attn | mlp]."""
    inner, mlp = config.inner_dim, config.mlp_hidden_dim
    if rest == "in":
        parts = torch.split(v, [inner, inner, inner, mlp, mlp], dim=0)
        return [(prefix + n, t) for n, t in zip(("to_q", "to_k", "to_v", "mlp_gate", "mlp_up"), parts)]
    return [(prefix + "out_attn", v[:, :inner]), (prefix + "out_mlp", v[:, inner:])]


def _bfl_items(key: str, v: torch.Tensor, config: Flux2TransformerConfig) -> List[Item]:
    m = _BLOCK.fullmatch(key)
    if m and m.group(1) == "double_blocks":
        p, rest = f"double_blocks.{m.group(2)}.", m.group(3)
        if rest in _BFL_QKV:
            return [(p + n, t) for n, t in zip(_BFL_QKV[rest], torch.chunk(v, 3, dim=0))]
        return [(p + _BFL_DOUBLE[rest], v)] if rest in _BFL_DOUBLE else []
    if m and m.group(1) == "single_blocks":
        p, rest = f"single_blocks.{m.group(2)}.", m.group(3)
        if rest in ("linear1.weight", "linear2.weight"):
            return _single_fused(p, "in" if rest == "linear1.weight" else "out", v, config)
        return [(p + _BFL_SINGLE[rest], v)] if rest in _BFL_SINGLE else []
    if key == "final_layer.adaLN_modulation.1.weight":
        # BFL stores [shift | scale] rows; the port's _final reads [scale | shift].
        d = v.shape[0] // 2
        return [("norm_out", torch.cat([v[d:], v[:d]], dim=0))]
    return [(_BFL_TOP[key], v)] if key in _BFL_TOP else []


def _diffusers_items(key: str, v: torch.Tensor, config: Flux2TransformerConfig) -> List[Item]:
    m = _BLOCK.fullmatch(key)
    if m and m.group(1) == "transformer_blocks":
        p, rest = f"double_blocks.{m.group(2)}.", m.group(3)
        return [(p + _DIFFUSERS_DOUBLE[rest], v)] if rest in _DIFFUSERS_DOUBLE else []
    if m and m.group(1) == "single_transformer_blocks":
        p, rest = f"single_blocks.{m.group(2)}.", m.group(3)
        if rest == "attn.to_qkv_mlp_proj.weight":
            return _single_fused(p, "in", v, config)
        if rest in ("attn.to_out.weight", "attn.to_out.0.weight"):
            return _single_fused(p, "out", v, config)
        return [(p + _DIFFUSERS_SINGLE[rest], v)] if rest in _DIFFUSERS_SINGLE else []
    return [(_DIFFUSERS_TOP[key], v)] if key in _DIFFUSERS_TOP else []


def map_transformer_weights(weights: Mapping, config: Flux2TransformerConfig) -> Iterator[Item]:
    """(port name, tensor) for every transformer weight of a BFL or Diffusers
    checkpoint (quanto pairs folded), [out, in], in the checkpoint's dtype."""
    items = _bfl_items if is_bfl_format(weights) else _diffusers_items
    for key, v in quanto_items(weights):
        yield from items(key, v, config)


def load_transformer(weights: Mapping, config: Flux2TransformerConfig, device: "torch.device | str",
                     dtype: torch.dtype = torch.bfloat16, quantization: Optional[str] = None) -> Flux2Transformer:
    """The DiT of ``config`` on ``device`` in ``dtype``, filled from ``weights``
    block by block (``fill_by_block``). ``quantization`` (a ``quantize_params``
    format) quantizes each block as soon as it is filled, so the DiT never
    sits whole in ``dtype`` on the device: the result equals
    ``quantize_params`` after a whole load, to the bit."""
    fmt = quantization or "bf16"
    model = Flux2Transformer(config, device="meta", dtype=dtype)
    missing = fill_by_block(model, map_transformer_weights(weights, config), device,
                            ("double_blocks", "single_blocks"), lambda prefix: quantize_params(model, fmt, prefix=prefix))
    if config.guidance_embeds and "guidance_linear1" in missing:
        raise KeyError("config.guidance_embeds=True but checkpoint has no guidance embedder")
    _raise_missing(missing)
    return quantize_params(model, fmt)  # the weights outside the blocks


# -- VAE (diffusers AutoencoderKL names) ---------------------------------------------

_VAE_RENAMES: Sequence[Tuple[re.Pattern, str]] = [(re.compile(a), b) for a, b in (
    (r"post_quant_conv\.(weight|bias)", r"post_quant_conv.\1"),
    (r"bn\.running_(mean|var)", r"bn_running_\1"),
    (r"decoder\.mid_block\.resnets\.0\.(.+)", r"mid_resnet1.\1"),
    (r"decoder\.mid_block\.resnets\.1\.(.+)", r"mid_resnet2.\1"),
    (r"decoder\.mid_block\.attentions\.0\.to_out(?:\.0)?\.(weight|bias)", r"mid_attn.to_out.\1"),
    (r"decoder\.mid_block\.attentions\.0\.(.+)", r"mid_attn.\1"),
    (r"decoder\.up_blocks\.(\d+)\.upsamplers\.0\.conv\.(weight|bias)", r"up_blocks.\1.upsample.\2"),
    (r"decoder\.up_blocks\.(.+)", r"up_blocks.\1"),
    (r"decoder\.conv_norm_out\.(weight|bias)", r"norm_out.\1"),
    (r"decoder\.(conv_in|conv_out)\.(weight|bias)", r"\1.\2"),
)]


_VAE_ENCODER_RENAMES: Sequence[Tuple[re.Pattern, str]] = [(re.compile(a), b) for a, b in (
    (r"quant_conv\.(weight|bias)", r"quant_conv.\1"),
    (r"encoder\.down_blocks\.(\d+)\.downsamplers\.0\.conv\.(weight|bias)", r"down_blocks.\1.downsample.\2"),
    (r"encoder\.down_blocks\.(.+)", r"down_blocks.\1"),
    (r"encoder\.mid_block\.resnets\.0\.(.+)", r"mid_resnet1.\1"),
    (r"encoder\.mid_block\.resnets\.1\.(.+)", r"mid_resnet2.\1"),
    (r"encoder\.mid_block\.attentions\.0\.to_out(?:\.0)?\.(weight|bias)", r"mid_attn.to_out.\1"),
    (r"encoder\.mid_block\.attentions\.0\.(.+)", r"mid_attn.\1"),
    (r"encoder\.conv_norm_out\.(weight|bias)", r"norm_out.\1"),
    (r"encoder\.(conv_in|conv_out)\.(weight|bias)", r"\1.\2"),
)]


def _renamed(weights: Mapping, renames) -> Iterator[Item]:
    for key in weights:
        for pattern, repl in renames:
            if pattern.fullmatch(key):
                yield pattern.sub(repl, key), weights[key]
                break


def map_vae_weights(weights: Mapping) -> Iterator[Item]:
    """(port name, tensor) for the decoder's weights, ``post_quant_conv`` and
    the ``bn`` statistics; the encoder's and ``quant_conv`` are skipped."""
    return _renamed(weights, _VAE_RENAMES)


def map_vae_encoder_weights(weights: Mapping) -> Iterator[Item]:
    """(port name, tensor) for the encoder's weights and ``quant_conv``."""
    return _renamed(weights, _VAE_ENCODER_RENAMES)


def load_vae(weights: Mapping, config: VAEConfig, device: "torch.device | str") -> VAEDecoder:
    """The float32 decoder of ``config`` on ``device``; absent ``bn`` statistics
    keep their zero mean and unit variance, as in JAX."""
    vae = VAEDecoder(config, device=device)
    _raise_missing([n for n in fill(vae, map_vae_weights(weights)) if not n.startswith("bn_running_")])
    return vae


def load_vae_encoder(weights: Mapping, config: VAEConfig, device: "torch.device | str") -> VAEEncoder:
    """The float32 encoder of ``config`` (and ``quant_conv``) on ``device``."""
    encoder = VAEEncoder(config, device=device)
    _raise_missing(fill(encoder, map_vae_encoder_weights(weights)))
    return encoder


# -- Qwen3 and Mistral (HF llama-style names) ---------------------------------------------------

_DECODER_LAYER = {
    "input_layernorm.weight": "input_norm",
    "post_attention_layernorm.weight": "post_attn_norm",
    "self_attn.q_proj.weight": "q_proj",
    "self_attn.k_proj.weight": "k_proj",
    "self_attn.v_proj.weight": "v_proj",
    "self_attn.o_proj.weight": "o_proj",
    "self_attn.q_norm.weight": "q_norm",
    "self_attn.k_norm.weight": "k_norm",
    "mlp.gate_proj.weight": "gate_proj",
    "mlp.up_proj.weight": "up_proj",
    "mlp.down_proj.weight": "down_proj",
}
_DECODER_KEY = re.compile(r"layers\.(\d+)\.(.+)")


def strip_language_model_prefix(names: Iterable[str]) -> dict:
    """checkpoint name -> name without ``language_model.`` (the
    Mistral3ForConditionalGeneration layout, JAX's function of that name),
    for every name."""
    pre = "language_model."
    names = list(names)
    if not any(k.startswith(pre) for k in names):
        return {k: k for k in names}
    return {k: k[len(pre):] if k.startswith(pre) else k for k in names}


# Where a decoder's layers sit: text-only ``model.*``; VLM checkpoints nest
# ``model.language_model.*`` (newer transformers) or, once
# ``language_model.`` is stripped, ``model.*`` again (JAX's order).
_DECODER_PREFIXES = ("model.language_model.", "model.", "")


def map_decoder_weights(weights: Mapping) -> Iterator[Item]:
    """(port name, tensor) for the decoder: the embedding, the layers, the
    final ``norm`` and, untied, ``lm_head`` (``lm_head.weight`` at the top
    level, after ``language_model.`` is stripped). Quanto pairs are folded."""
    renamed = strip_language_model_prefix(_base_names(weights))
    names = set(renamed.values())
    pre = next(p for p in _DECODER_PREFIXES if p + "embed_tokens.weight" in names or not p)
    for key, v in quanto_items(weights):
        name = renamed[key]
        if name == "lm_head.weight":
            yield "lm_head", v
            continue
        if not name.startswith(pre):
            continue
        name = name[len(pre):]
        if name == "embed_tokens.weight":
            yield "embed_tokens", v
        elif name == "norm.weight":
            yield "final_norm", v
        else:
            m = _DECODER_KEY.fullmatch(name)
            if m and m.group(2) in _DECODER_LAYER:
                yield f"layers.{m.group(1)}.{_DECODER_LAYER[m.group(2)]}", v


def load_decoder(weights: Mapping, cfg: DecoderConfig, device: "torch.device | str",
                 dtype: torch.dtype = torch.bfloat16, quantization: Optional[str] = None) -> Qwen3Decoder:
    """The decoder of ``cfg`` on ``device`` in ``dtype``, filled from
    ``weights`` layer by layer (``fill_by_block``). ``quantization`` quantizes
    each layer's matmul weights as soon as the layer is filled; the result
    equals ``extractor.quantize_encoder_params`` after a whole load, to the
    bit (the token table, the final norm and ``lm_head`` stay dense)."""
    fmt = quantization or "bf16"
    decoder = Qwen3Decoder(cfg, device="meta", dtype=dtype)
    _raise_missing(fill_by_block(decoder, map_decoder_weights(weights), device, ("layers",),
                                 lambda prefix: quantize_params(decoder.layers, fmt, prefix=prefix[len("layers."):])))
    return decoder


# -- the VLMs ------------------------------------------------------------------------------


class _Subset(Mapping):
    """The entries of ``weights`` whose names ``keep`` accepts; the others are never read."""

    def __init__(self, weights: Mapping, keep):
        self._weights = weights
        self._keys = [k for k in weights if keep(k)]
        self._set = set(self._keys)

    def __getitem__(self, key: str) -> torch.Tensor:
        if key not in self._set:
            raise KeyError(key)
        return self._weights[key]

    def __contains__(self, key: object) -> bool:
        return key in self._set

    def __iter__(self):
        return iter(self._keys)

    def __len__(self) -> int:
        return len(self._keys)


_PIXTRAL_BLOCK = {
    "attention_norm.weight": "attention_norm",
    "attention.q_proj.weight": "q_proj",
    "attention.k_proj.weight": "k_proj",
    "attention.v_proj.weight": "v_proj",
    "attention.o_proj.weight": "o_proj",
    "ffn_norm.weight": "ffn_norm",
    "feed_forward.gate_proj.weight": "gate_proj",
    "feed_forward.up_proj.weight": "up_proj",
    "feed_forward.down_proj.weight": "down_proj",
}
_PIXTRAL_TOP = {
    "vision_tower.ln_pre.weight": "ln_pre",
    "multi_modal_projector.norm.weight": "projector.norm",
    "multi_modal_projector.linear_1.weight": "projector.linear_1",
    "multi_modal_projector.linear_2.weight": "projector.linear_2",
}
_PIXTRAL_LAYER = re.compile(r"vision_tower\.transformer\.layers\.(\d+)\.(.+)")


def map_pixtral_weights(weights: Mapping, cfg: PixtralVisionConfig) -> Iterator[Item]:
    """(port name, tensor) for the Pixtral tower and projector of a Mistral3
    checkpoint (the language model's entries are not read). The patch conv
    [h, 3, p, p] (OIHW) becomes the linear over (ph, pw, c)-flattened
    patches; the merger's columns, channel-major in HF's unfold
    (c * m * m + kh * m + kw), are permuted to the port's spatial-major
    ((kh * m + kw) * d + c)."""
    d, m = cfg.hidden_size, cfg.spatial_merge_size
    sub = _Subset(weights, lambda k: k.startswith(("vision_tower.", "multi_modal_projector.")))
    for key, v in quanto_items(sub):
        layer = _PIXTRAL_LAYER.fullmatch(key)
        if layer and layer.group(2) in _PIXTRAL_BLOCK:
            yield f"blocks.{layer.group(1)}.{_PIXTRAL_BLOCK[layer.group(2)]}", v
        elif key == "vision_tower.patch_conv.weight":
            yield "patch_conv", v.permute(0, 2, 3, 1).reshape(v.shape[0], -1)
        elif key == "multi_modal_projector.patch_merger.merging_layer.weight":
            yield "projector.merge", v.reshape(v.shape[0], d, m, m).permute(0, 2, 3, 1).reshape(v.shape[0], m * m * d)
        elif key in _PIXTRAL_TOP:
            yield _PIXTRAL_TOP[key], v


def load_pixtral(weights: Mapping, cfg: PixtralVisionConfig, device: "torch.device | str",
                 dtype: torch.dtype = torch.bfloat16) -> PixtralVision:
    vision = PixtralVision(cfg, device=device, dtype=dtype)
    _raise_missing(fill(vision, map_pixtral_weights(weights, cfg)))
    return vision


_QWEN35_VISION_RENAMES: Sequence[Tuple[re.Pattern, str]] = [(re.compile(a), b) for a, b in (
    (r"patch_embed\.proj\.bias", r"patch_embed.bias"),
    (r"pos_embed\.weight", r"pos_embed"),
    (r"blocks\.(\d+)\.(norm[12])\.(weight|bias)", r"blocks.\1.\2.\3"),
    (r"blocks\.(\d+)\.attn\.(qkv|proj)\.(weight|bias)", r"blocks.\1.\2.\3"),
    (r"blocks\.(\d+)\.mlp\.linear_(fc[12])\.(weight|bias)", r"blocks.\1.\2.\3"),
    (r"merger\.norm\.(weight|bias)", r"merger.norm.\1"),
    (r"merger\.linear_(fc[12])\.(weight|bias)", r"merger.\1.\2"),
)]


def map_qwen35_vision_weights(weights: Mapping, cfg: Qwen35VisionConfig) -> Iterator[Item]:
    """(port name, tensor) for a Qwen3-VL vision tower (``model.visual.*``,
    ``visual.*`` or bare names). The Conv3d patch embedding [D, C, T, P, P]
    flattens to the linear over (t, ph, pw, c)-ordered patches."""
    names = _base_names(weights)
    pre = next((c for c in ("model.visual.", "visual.") if any(k.startswith(c + "patch_embed.") for k in names)), "")
    sub = _Subset(weights, lambda k: k.startswith(pre) and not k[len(pre):].startswith(("layers.", "embed_tokens.")))
    for key, v in quanto_items(sub):
        name = key[len(pre):]
        if name == "patch_embed.proj.weight":
            yield "patch_embed.weight", v.permute(0, 2, 3, 4, 1).reshape(v.shape[0], -1)
            continue
        for pattern, repl in _QWEN35_VISION_RENAMES:
            if pattern.fullmatch(name):
                yield pattern.sub(repl, name), v
                break


def load_qwen35_vision(weights: Mapping, cfg: Qwen35VisionConfig, device: "torch.device | str",
                       dtype: torch.dtype = torch.bfloat16) -> Qwen35Vision:
    vision = Qwen35Vision(cfg, device=device, dtype=dtype)
    _raise_missing(fill(vision, map_qwen35_vision_weights(weights, cfg)))
    return vision


_QWEN35_LAYER = {
    "mlp.gate_proj.weight": "gate_proj",
    "mlp.up_proj.weight": "up_proj",
    "mlp.down_proj.weight": "down_proj",
    "linear_attn.out_proj.weight": "linear_attn.out_proj",
    "linear_attn.norm.weight": "linear_attn.norm_weight",  # the gated norm: standard, ones-init
    "linear_attn.A_log": "linear_attn.a_log",
    "linear_attn.dt_bias": "linear_attn.dt_bias",
    "self_attn.q_proj.weight": "self_attn.q_proj",
    "self_attn.k_proj.weight": "self_attn.k_proj",
    "self_attn.v_proj.weight": "self_attn.v_proj",
    "self_attn.o_proj.weight": "self_attn.o_proj",
}
# Qwen3NextRMSNorm weights are zero-centred (x * (1 + w)): the +1 is folded in at load
_QWEN35_CENTRED = {
    "input_layernorm.weight": "input_norm",
    "post_attention_layernorm.weight": "post_attn_norm",
    "self_attn.q_norm.weight": "self_attn.q_norm",
    "self_attn.k_norm.weight": "self_attn.k_norm",
}


def _qwen35_layer_items(i: str, name: str, v: torch.Tensor, cfg: Qwen35TextConfig) -> List[Item]:
    p = f"layers.{i}."
    if name in _QWEN35_LAYER:
        return [(p + _QWEN35_LAYER[name], v)]
    if name in _QWEN35_CENTRED:
        return [(p + _QWEN35_CENTRED[name], 1.0 + v.to(torch.float32))]
    hk, hv = cfg.linear_num_key_heads, cfg.linear_num_value_heads
    dk, dv, rep = cfg.linear_key_head_dim, cfg.linear_value_head_dim, hv // hk
    if name == "linear_attn.in_proj_qkvz.weight":  # per key head: [q | k | v * rep | z * rep]
        g = v.reshape(hk, 2 * dk + 2 * rep * dv, -1)
        q, k, vv, z = torch.split(g, [dk, dk, rep * dv, rep * dv], dim=1)
        qkv = torch.cat([t.reshape(-1, g.shape[-1]) for t in (q, k, vv)])
        return [(p + "linear_attn.in_proj_qkv", qkv), (p + "linear_attn.in_proj_z", z.reshape(-1, g.shape[-1]))]
    if name == "linear_attn.in_proj_ba.weight":  # per key head: [b * rep | a * rep]
        g = v.reshape(hk, 2 * rep, -1)
        return [(p + "linear_attn.in_proj_b", g[:, :rep].reshape(-1, g.shape[-1])),
                (p + "linear_attn.in_proj_a", g[:, rep:].reshape(-1, g.shape[-1]))]
    if name == "linear_attn.conv1d.weight":  # [conv_dim, 1, K] -> [K, conv_dim]
        return [(p + "linear_attn.conv_kernel", v[:, 0, :].T)]
    return []


def map_qwen35_weights(weights: Mapping, cfg: Qwen35TextConfig) -> Iterator[Item]:
    """(port name, tensor) for the Qwen3.5 hybrid LM in qwen3_next names
    (``model.language_model.*``, ``language_model.*`` or ``model.*``):
    ``in_proj_qkvz`` / ``in_proj_ba`` split per key-head group into the
    conv path's q / k / v, z, b and a; the conv kernel to [K, conv_dim];
    the zero-centred RMSNorm weights plus 1 (the DeltaNet's gated norm is
    standard and passes as it is)."""
    names = _base_names(weights)
    pre = next((c for c in ("model.language_model.", "language_model.", "model.")
                if any(k.startswith(c + "layers.") for k in names)), "")
    sub = _Subset(weights, lambda k: k.startswith(pre))
    for key, v in quanto_items(sub):
        name = key[len(pre):]
        if name == "embed_tokens.weight":
            yield "embed_tokens", v
        elif name == "norm.weight":
            yield "final_norm", 1.0 + v.to(torch.float32)
        else:
            m = _DECODER_KEY.fullmatch(name)
            if m:
                yield from _qwen35_layer_items(m.group(1), m.group(2), v, cfg)


def load_qwen35(weights: Mapping, cfg: Qwen35TextConfig, device: "torch.device | str",
                dtype: torch.dtype = torch.bfloat16) -> Qwen35LM:
    lm = Qwen35LM(cfg, device=device, dtype=dtype)
    _raise_missing(fill(lm, map_qwen35_weights(weights, cfg)))
    return lm


# -- filling a module ------------------------------------------------------------------


def fill(module: nn.Module, items: Iterable[Item]) -> List[str]:
    """Copy each (name, tensor) into the parameter or buffer of that name,
    cast to its dtype, on its device, as the items come; names the module
    does not hold are skipped. Returns the names left unfilled."""
    targets = dict(module.named_parameters())
    targets.update(module.named_buffers())
    filled = set()
    with torch.no_grad():
        for name, t in items:
            dst = targets.get(name)
            if dst is None:
                continue
            if tuple(dst.shape) != tuple(t.shape):
                raise ValueError(f"checkpoint weight {name}: shape {tuple(t.shape)}, the model's {tuple(dst.shape)}")
            dst.copy_(t)
            filled.add(name)
    return [n for n in targets if n not in filled]


def fill_by_block(module: nn.Module, items: Iterable[Item], device: "torch.device | str",
                  block_lists: Sequence[str], done: Callable[[str], None]) -> List[str]:
    """``fill`` into ``module`` built on the meta device: everything outside
    the blocks of the ``ModuleList``s ``block_lists`` is made on ``device``
    first; a block is made there when its first tensor comes, and
    ``done(prefix)`` runs (``prefix`` = ``"<list>.<i>."``) once its last has
    come, so the device holds the dense weights of the blocks being filled
    alone (``done`` quantizes the block, or does nothing). Returns the names
    left unfilled."""
    left = {}  # prefix -> (block, its names not yet filled)
    for lname in block_lists:
        for i, block in enumerate(getattr(module, lname)):
            p = f"{lname}.{i}."
            left[p] = (block, {p + n for n, _ in (*block.named_parameters(), *block.named_buffers())})
    for mod_name, mod in module.named_modules():
        if any((mod_name + ".").startswith(p) for p in left):
            continue
        for attr, t in (*mod._parameters.items(), *mod._buffers.items()):
            if t is not None and t.is_meta:
                new = torch.empty_like(t, device=device)
                if attr in mod._parameters:
                    mod._parameters[attr] = nn.Parameter(new, requires_grad=t.requires_grad)
                else:
                    mod._buffers[attr] = new
    params = [n for n, _ in module.named_parameters()]
    targets = params + [n for n, _ in module.named_buffers()]
    known, params = set(targets), set(params)
    filled = set()
    with torch.no_grad():
        for name, t in items:
            if name not in known or name in filled:
                continue
            prefix = next((p for p in left if name.startswith(p)), None)
            if prefix is not None and next(left[prefix][0].parameters()).is_meta:
                left[prefix][0].to_empty(device=device)
            dst = module.get_parameter(name) if name in params else module.get_buffer(name)
            if tuple(dst.shape) != tuple(t.shape):
                raise ValueError(f"checkpoint weight {name}: shape {tuple(t.shape)}, the model's {tuple(dst.shape)}")
            dst.copy_(t)
            filled.add(name)
            if prefix is not None:
                left[prefix][1].discard(name)
                if not left[prefix][1]:
                    del left[prefix]
                    done(prefix)
    return [n for n in targets if n not in filled]


def _raise_missing(missing: List[str]) -> None:
    if missing:
        more = f" (and {len(missing) - 1} more)" if len(missing) > 1 else ""
        raise KeyError(f"missing checkpoint weight: {missing[0]}{more}")
