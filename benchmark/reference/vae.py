"""Plain reference of the FLUX.2 VAE decode, float32, on the Diffusers
``AutoencoderKL`` checkpoint names (``benchmark/weights.py``).

Packed latents [B, S, 128] -> [B, 128, H/16, W/16] -> BatchNorm
de-normalisation (eps 1e-4) -> 2x2 pixel shuffle to [B, 32, H/8, W/8] ->
post_quant_conv, conv_in, mid (resnet, one-head attention, resnet), up
blocks (resnets, then nearest 2x and a conv on all but the last), GroupNorm
(eps 1e-6), SiLU, conv_out -> image in [-1, 1] -> uint8 levels
round(255 * clamp(x / 2 + 0.5, 0, 1)).

``fp8_control=True`` is the output check's control for this stage (the
program has no lower-precision decode of its own): every convolution's and
product's operands rounded to float8 e4m3 with a per-tensor scale, as an
fp8 inference kernel takes them, the arithmetic still float32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from benchmark.reference.dit import _id, fp8


def _conv(w, key, x, stride=1, q=_id):
    weight = w[key + ".weight"]
    return F.conv2d(q(x), q(weight), w[key + ".bias"], stride=stride, padding=weight.shape[-1] // 2)


def _gn(w, key, x, groups, eps):
    return F.group_norm(x, groups, w[key + ".weight"], w[key + ".bias"], eps)


def _resnet(w, key, x, groups, eps, q=_id):
    h = _conv(w, key + ".conv1", F.silu(_gn(w, key + ".norm1", x, groups, eps)), q=q)
    h = _conv(w, key + ".conv2", F.silu(_gn(w, key + ".norm2", h, groups, eps)), q=q)
    return h + (_conv(w, key + ".conv_shortcut", x, q=q) if key + ".conv_shortcut.weight" in w else x)


def _attn(w, key, x, groups, eps, q=_id):
    b, c, hh, ww = x.shape
    h = q(_gn(w, key + ".group_norm", x, groups, eps).reshape(b, c, hh * ww).transpose(1, 2))
    qq, k, v = (F.linear(h, q(w[f"{key}.{n}.weight"]), w[f"{key}.{n}.bias"]) for n in ("to_q", "to_k", "to_v"))
    out = torch.softmax(q(qq) @ q(k).transpose(1, 2) * c ** -0.5, dim=-1) @ q(v)
    out = F.linear(q(out), q(w[key + ".to_out.0.weight"]), w[key + ".to_out.0.bias"])
    return out.transpose(1, 2).reshape(b, c, hh, ww) + x


def decode_u8(ckpt, v: dict, latents: torch.Tensor, height: int, width: int, fp8_control: bool = False) -> torch.Tensor:
    """uint8 image [B, H, W, 3] of packed latents [B, S, 128]."""
    q = fp8 if fp8_control else _id
    w = {k: ckpt[k].float() for g in ckpt.groups for k in ckpt.group_keys(g.name)}
    groups, eps, lc = v["norm_num_groups"], v["norm_eps"], v["latent_channels"]
    b = latents.shape[0]
    z = latents.float().to(ckpt.device).reshape(b, height // 16, width // 16, 4 * lc).permute(0, 3, 1, 2)
    std = torch.sqrt(w["bn.running_var"].double() + 1e-4).float()
    z = z * std[None, :, None, None] + w["bn.running_mean"][None, :, None, None]
    ph, pw = z.shape[2], z.shape[3]
    z = z.reshape(b, lc, 2, 2, ph, pw).permute(0, 1, 4, 2, 5, 3).reshape(b, lc, 2 * ph, 2 * pw)
    h = _conv(w, "decoder.conv_in", _conv(w, "post_quant_conv", z, q=q), q=q)
    h = _resnet(w, "decoder.mid_block.resnets.0", h, groups, eps, q)
    h = _attn(w, "decoder.mid_block.attentions.0", h, groups, eps, q)
    h = _resnet(w, "decoder.mid_block.resnets.1", h, groups, eps, q)
    n_up = len(v["block_out_channels"])
    for i in range(n_up):
        for j in range(v["layers_per_block"] + 1):
            h = _resnet(w, f"decoder.up_blocks.{i}.resnets.{j}", h, groups, eps, q)
        if i < n_up - 1:
            h = _conv(w, f"decoder.up_blocks.{i}.upsamplers.0.conv", F.interpolate(h, scale_factor=2, mode="nearest"),
                      q=q)
    img = _conv(w, "decoder.conv_out", F.silu(_gn(w, "decoder.conv_norm_out", h, groups, eps)), q=q)
    img = torch.clamp(img * 0.5 + 0.5, 0.0, 1.0).permute(0, 2, 3, 1)
    return torch.round(img * 255.0).to(torch.uint8)
