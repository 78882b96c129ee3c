"""Seeded checkpoints: every weight of a configuration, drawn from ``--seed``.

A checkpoint is a ``Mapping`` from the published checkpoint's key names
(Diffusers ``Flux2Transformer2DModel`` and ``AutoencoderKL``, HF ``Qwen3``)
to tensors, so the program loads it through its own checkpoint loaders, as
it loads a real download, and the plain reference reads the same names.

Keys come in groups (the top-level weights, one transformer block, one
decoder layer, ...). A group is drawn in one ``torch.randn`` call on the
device, in the dtype it is served in, from a generator seeded by (seed,
component, group index); so any group can be drawn again on its own, with
the same bits, after the program's state is gone. A group stays cached until
a key of another group is read, so a loader that reads keys in order holds
one group at a time.

The scales follow the program's own random initialisation (N(0, 1) *
fan_in**-0.5 for a projection, 0.02 for a token table, ones for a norm's
scale, zeros for a bias), so the activations stay in the range a random
model of that family has.
"""

from __future__ import annotations

import hashlib
from collections.abc import Mapping
from typing import Dict, Iterator, List, NamedTuple, Sequence, Tuple

import torch


class Leaf(NamedTuple):
    key: str
    shape: Tuple[int, ...]
    init: str  # "normal", "ones" or "zeros"
    # for "normal": one scale, or ((columns, scale), ...) along the last axis
    scale: object = 1.0


class Group(NamedTuple):
    name: str
    leaves: Tuple[Leaf, ...]


def group_seed(seed: int, component: str, index: int) -> int:
    digest = hashlib.sha256(f"{int(seed)}:{component}:{index}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def _numel(shape: Sequence[int]) -> int:
    n = 1
    for s in shape:
        n *= int(s)
    return n


class SeededCheckpoint(Mapping):
    """The checkpoint of one component, drawn lazily group by group."""

    def __init__(self, groups: Sequence[Group], seed: int, component: str, device, dtype: torch.dtype):
        self.groups = list(groups)
        self.seed, self.component = int(seed), component
        self.device, self.dtype = torch.device(device), dtype
        self._where: Dict[str, int] = {}
        for i, g in enumerate(self.groups):
            for leaf in g.leaves:
                if leaf.key in self._where:
                    raise ValueError(f"duplicate checkpoint key {leaf.key}")
                self._where[leaf.key] = i
        self._cached: Tuple[int, Dict[str, torch.Tensor]] = (-1, {})

    def __iter__(self) -> Iterator[str]:
        for g in self.groups:
            for leaf in g.leaves:
                yield leaf.key

    def __len__(self) -> int:
        return len(self._where)

    def __contains__(self, key) -> bool:
        return key in self._where

    def __getitem__(self, key: str) -> torch.Tensor:
        i = self._where[key]
        if self._cached[0] != i:
            self._cached = (-1, {})  # drop the last group before drawing the next
            self._cached = (i, self.draw_group(i))
        return self._cached[1][key]

    def group_keys(self, name: str) -> List[str]:
        """The keys of the group called ``name``, in order."""
        return [leaf.key for g in self.groups if g.name == name for leaf in g.leaves]

    def draw_group(self, i: int) -> Dict[str, torch.Tensor]:
        """Every tensor of group ``i``: one draw for all its normal leaves."""
        g = self.groups[i]
        normal = [leaf for leaf in g.leaves if leaf.init == "normal"]
        total = sum(_numel(leaf.shape) for leaf in normal)
        gen = torch.Generator(device=self.device).manual_seed(group_seed(self.seed, self.component, i))
        flat = torch.randn(total, generator=gen, device=self.device, dtype=self.dtype) if total else None
        out: Dict[str, torch.Tensor] = {}
        pos = 0
        with torch.no_grad():
            for leaf in g.leaves:
                if leaf.init == "ones":
                    out[leaf.key] = torch.ones(leaf.shape, device=self.device, dtype=self.dtype)
                elif leaf.init == "zeros":
                    out[leaf.key] = torch.zeros(leaf.shape, device=self.device, dtype=self.dtype)
                else:
                    n = _numel(leaf.shape)
                    t = flat[pos : pos + n].view(leaf.shape)
                    pos += n
                    if isinstance(leaf.scale, tuple):
                        col = 0
                        for cols, s in leaf.scale:
                            t[..., col : col + cols].mul_(s)
                            col += cols
                    else:
                        t.mul_(leaf.scale)
                    out[leaf.key] = t
        return out


def _lin(key: str, d_out: int, d_in: int) -> Leaf:
    return Leaf(key, (d_out, d_in), "normal", d_in ** -0.5)


# -- FLUX.2 DiT, Diffusers names ------------------------------------------------------------


def dit_groups(t: dict) -> List[Group]:
    """The Diffusers ``Flux2Transformer2DModel`` checkpoint of config ``t``
    (the ``transformer`` entry of a configuration file)."""
    d = t["num_attention_heads"] * t["attention_head_dim"]
    mlp = int(d * t["mlp_ratio"])
    hd, tc = t["attention_head_dim"], t["time_embed_channels"]
    top = [
        _lin("x_embedder.weight", d, t["in_channels"]),
        _lin("context_embedder.weight", d, t["joint_attention_dim"]),
        _lin("time_guidance_embed.timestep_embedder.linear_1.weight", d, tc),
        _lin("time_guidance_embed.timestep_embedder.linear_2.weight", d, d),
        _lin("double_stream_modulation_img.linear.weight", 6 * d, d),
        _lin("double_stream_modulation_txt.linear.weight", 6 * d, d),
        _lin("single_stream_modulation.linear.weight", 3 * d, d),
        _lin("norm_out.linear.weight", 2 * d, d),
        _lin("proj_out.weight", t["out_channels"], d),
    ]
    if t.get("guidance_embeds"):
        top += [_lin("time_guidance_embed.guidance_embedder.linear_1.weight", d, tc),
                _lin("time_guidance_embed.guidance_embedder.linear_2.weight", d, d)]
    groups = [Group("top", tuple(top))]
    for i in range(t["num_layers"]):
        p = f"transformer_blocks.{i}."
        leaves = [_lin(p + f"attn.{n}.weight", d, d) for n in ("to_q", "to_k", "to_v")]
        leaves += [_lin(p + "attn.to_out.0.weight", d, d)]
        leaves += [_lin(p + f"attn.{n}.weight", d, d) for n in ("add_q_proj", "add_k_proj", "add_v_proj")]
        leaves += [_lin(p + "attn.to_add_out.weight", d, d)]
        leaves += [Leaf(p + f"attn.{n}.weight", (hd,), "ones") for n in ("norm_q", "norm_k", "norm_added_q",
                                                                          "norm_added_k")]
        for ff in ("ff", "ff_context"):
            leaves += [_lin(p + f"{ff}.linear_in.weight", 2 * mlp, d), _lin(p + f"{ff}.linear_out.weight", d, mlp)]
        groups.append(Group(f"double.{i}", tuple(leaves)))
    for i in range(t["num_single_layers"]):
        p = f"single_transformer_blocks.{i}."
        leaves = [
            _lin(p + "attn.to_qkv_mlp_proj.weight", 3 * d + 2 * mlp, d),
            Leaf(p + "attn.to_out.weight", (d, d + mlp), "normal", ((d, d ** -0.5), (mlp, mlp ** -0.5))),
            Leaf(p + "attn.norm_q.weight", (hd,), "ones"),
            Leaf(p + "attn.norm_k.weight", (hd,), "ones"),
        ]
        groups.append(Group(f"single.{i}", tuple(leaves)))
    return groups


# -- FLUX.2 VAE decoder, Diffusers AutoencoderKL names ----------------------------------------


def _conv(key: str, cout: int, cin: int, k: int) -> List[Leaf]:
    return [Leaf(key + ".weight", (cout, cin, k, k), "normal", (k * k * cin) ** -0.5),
            Leaf(key + ".bias", (cout,), "zeros")]


def _norm(key: str, c: int) -> List[Leaf]:
    return [Leaf(key + ".weight", (c,), "ones"), Leaf(key + ".bias", (c,), "zeros")]


def _resnet(key: str, cin: int, cout: int) -> List[Leaf]:
    leaves = _norm(key + ".norm1", cin) + _conv(key + ".conv1", cout, cin, 3)
    leaves += _norm(key + ".norm2", cout) + _conv(key + ".conv2", cout, cout, 3)
    if cin != cout:
        leaves += _conv(key + ".conv_shortcut", cout, cin, 1)
    return leaves


def vae_decoder_groups(v: dict) -> List[Group]:
    """The decoder half of the Diffusers ``AutoencoderKL`` checkpoint of
    config ``v`` (the ``vae`` entry), with ``post_quant_conv`` and the
    patchified latents' BatchNorm statistics (zero mean, unit variance)."""
    ch, lc = list(v["block_out_channels"]), v["latent_channels"]
    top = _conv("post_quant_conv", lc, lc, 1) + _conv("decoder.conv_in", ch[-1], lc, 3)
    top += [Leaf("bn.running_mean", (4 * lc,), "zeros"), Leaf("bn.running_var", (4 * lc,), "ones")]
    c = ch[-1]
    mid = _resnet("decoder.mid_block.resnets.0", c, c)
    a = "decoder.mid_block.attentions.0."
    mid += _norm(a + "group_norm", c)
    for n in ("to_q", "to_k", "to_v", "to_out.0"):
        mid += [_lin(a + n + ".weight", c, c), Leaf(a + n + ".bias", (c,), "zeros")]
    mid += _resnet("decoder.mid_block.resnets.1", c, c)
    groups = [Group("top", tuple(top)), Group("mid", tuple(mid))]
    rev = list(reversed(ch))
    prev = ch[-1]
    for i, c in enumerate(rev):
        leaves = []
        for j in range(v["layers_per_block"] + 1):
            leaves += _resnet(f"decoder.up_blocks.{i}.resnets.{j}", prev if j == 0 else c, c)
        if i < len(rev) - 1:
            leaves += _conv(f"decoder.up_blocks.{i}.upsamplers.0.conv", c, c, 3)
        groups.append(Group(f"up.{i}", tuple(leaves)))
        prev = c
    groups.append(Group("out", tuple(_norm("decoder.conv_norm_out", ch[0]) + _conv("decoder.conv_out", 3, ch[0], 3))))
    return groups


# -- Qwen3 text encoder, HF names --------------------------------------------------------------


def qwen3_groups(e: dict) -> List[Group]:
    """The HF ``Qwen3ForCausalLM`` checkpoint of config ``e`` (the
    ``text_encoder`` entry, the published ``config.json``'s keys)."""
    h, hd, inter = e["hidden_size"], e["head_dim"], e["intermediate_size"]
    q_dim, kv_dim = e["num_attention_heads"] * hd, e["num_key_value_heads"] * hd
    groups = [Group("embed", (Leaf("model.embed_tokens.weight", (e["vocab_size"], h), "normal", 0.02),))]
    for i in range(e["num_hidden_layers"]):
        p = f"model.layers.{i}."
        leaves = (
            Leaf(p + "input_layernorm.weight", (h,), "ones"),
            _lin(p + "self_attn.q_proj.weight", q_dim, h),
            _lin(p + "self_attn.k_proj.weight", kv_dim, h),
            _lin(p + "self_attn.v_proj.weight", kv_dim, h),
            _lin(p + "self_attn.o_proj.weight", h, q_dim),
            Leaf(p + "self_attn.q_norm.weight", (hd,), "ones"),
            Leaf(p + "self_attn.k_norm.weight", (hd,), "ones"),
            Leaf(p + "post_attention_layernorm.weight", (h,), "ones"),
            _lin(p + "mlp.gate_proj.weight", inter, h),
            _lin(p + "mlp.up_proj.weight", inter, h),
            _lin(p + "mlp.down_proj.weight", h, inter),
        )
        groups.append(Group(f"layer.{i}", leaves))
    tail = [Leaf("model.norm.weight", (h,), "ones")]
    if not e.get("tie_word_embeddings", False):
        tail.append(_lin("lm_head.weight", e["vocab_size"], h))
    groups.append(Group("tail", tuple(tail)))
    return groups


DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32, "float16": torch.float16}


def checkpoints(config: dict, seed: int, device) -> Dict[str, SeededCheckpoint]:
    """The three checkpoints of a FLUX.2 configuration file: "transformer" and
    "text_encoder" in the configuration's dtype, "vae" in float32 (the
    program keeps its VAE parameters in float32)."""
    dtype = DTYPES[config["dtype"]]
    return {
        "transformer": SeededCheckpoint(dit_groups(config["transformer"]), seed, "transformer", device, dtype),
        "vae": SeededCheckpoint(vae_decoder_groups(config["vae"]), seed, "vae", device, torch.float32),
        "text_encoder": SeededCheckpoint(qwen3_groups(config["text_encoder"]), seed, "text_encoder", device, dtype),
    }
