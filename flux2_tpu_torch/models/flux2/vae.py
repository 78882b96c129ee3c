"""FLUX.2 32-channel KL VAE: the decoder, as a PyTorch module.

Port of the decode path of ``flux2_tpu/models/flux2/vae.py``:
``post_quant_conv``, ``conv_in``, mid (resnet, attention, resnet),
``up_blocks`` with nearest-2x upsampling, ``norm_out`` and ``conv_out``, plus
the patchified-latent BatchNorm statistics. NCHW activations and OIHW conv
weights (the JAX package uses NHWC/HWIO inside and NCHW at its boundary, so
``decode`` is NCHW -> NCHW in both).

Parameters are stored in float32, as JAX's ``from_random`` keeps them; the
forward casts each weight to the activations' dtype, so a bf16 decode
computes in bf16 with float32 GroupNorm statistics. The mid-block attention
is plain torch on purpose: one head, C=512, 16384 tokens at 1024^2, so its
dense f32 logits take 1 GiB, which fits. The encoder, tiled decode and the
small decoder are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from flux2_tpu_torch.ops.normalization import group_norm


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    """The decoder's fields of ``flux2_tpu.models.flux2.vae.VAEConfig`` (that
    module imports JAX, so the port keeps its own copy)."""

    in_channels: int = 3
    out_channels: int = 3
    latent_channels: int = 32
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    decoder_block_out_channels: Optional[Tuple[int, ...]] = None
    layers_per_block: int = 2
    norm_num_groups: int = 32
    norm_eps: float = 1e-6

    @property
    def effective_decoder_channels(self) -> Tuple[int, ...]:
        return self.decoder_block_out_channels or self.block_out_channels


FLUX2_VAE = VAEConfig()


def _param(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


class Conv2d(nn.Module):
    """3x3 ("SAME") or 1x1 conv; weight N(0,1) * fan_in**-0.5, zero bias."""

    def __init__(self, cin, cout, ksize, device, generator):
        super().__init__()
        w = torch.empty(cout, cin, ksize, ksize, device=device, dtype=torch.float32)
        if generator is not None:
            w.normal_(generator=generator).mul_((ksize * ksize * cin) ** -0.5)
        self.weight = _param(w)
        self.bias = _param(torch.zeros(cout, device=device, dtype=torch.float32))
        self.padding = ksize // 2

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv2d(x, self.weight.to(x.dtype), padding=self.padding) + self.bias.to(x.dtype)[:, None, None]


class GroupNorm(nn.Module):
    def __init__(self, c, groups, eps, device):
        super().__init__()
        self.weight = _param(torch.ones(c, device=device, dtype=torch.float32))
        self.bias = _param(torch.zeros(c, device=device, dtype=torch.float32))
        self.groups, self.eps = groups, eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return group_norm(x, self.weight, self.bias, self.groups, self.eps)


class Dense(nn.Module):
    """Linear with bias; weight [out, in], N(0,1) * in**-0.5."""

    def __init__(self, cin, cout, device, generator):
        super().__init__()
        w = torch.empty(cout, cin, device=device, dtype=torch.float32)
        if generator is not None:
            w.normal_(generator=generator).mul_(cin**-0.5)
        self.weight = _param(w)
        self.bias = _param(torch.zeros(cout, device=device, dtype=torch.float32))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = torch.promote_types(x.dtype, self.weight.dtype)
        return F.linear(x.to(dtype), self.weight.to(dtype)) + self.bias.to(dtype)


class ResnetBlock(nn.Module):
    def __init__(self, cin, cout, groups, eps, device, generator):
        super().__init__()
        self.norm1 = GroupNorm(cin, groups, eps, device)
        self.conv1 = Conv2d(cin, cout, 3, device, generator)
        self.norm2 = GroupNorm(cout, groups, eps, device)
        self.conv2 = Conv2d(cout, cout, 3, device, generator)
        self.conv_shortcut = Conv2d(cin, cout, 1, device, generator) if cin != cout else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        return h + (self.conv_shortcut(x) if self.conv_shortcut is not None else x)


class AttnBlock(nn.Module):
    """Single-head spatial self-attention of the mid block (dense, f32 logits)."""

    def __init__(self, c, groups, eps, device, generator):
        super().__init__()
        self.group_norm = GroupNorm(c, groups, eps, device)
        self.to_q = Dense(c, c, device, generator)
        self.to_k = Dense(c, c, device, generator)
        self.to_v = Dense(c, c, device, generator)
        self.to_out = Dense(c, c, device, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        hidden = self.group_norm(x).reshape(b, c, h * w).transpose(1, 2)  # [B, HW, C]
        q, k, v = self.to_q(hidden), self.to_k(hidden), self.to_v(hidden)
        logits = torch.matmul(q.float(), k.float().transpose(1, 2)) * (c**-0.5)
        probs = torch.softmax(logits, dim=-1).to(v.dtype)
        out = self.to_out(torch.matmul(probs, v))
        return out.transpose(1, 2).reshape(b, c, h, w) + x


class UpBlock(nn.Module):
    def __init__(self, cin, cout, num_resnets, upsample, groups, eps, device, generator):
        super().__init__()
        self.resnets = nn.ModuleList(
            ResnetBlock(cin if j == 0 else cout, cout, groups, eps, device, generator)
            for j in range(num_resnets)
        )
        self.upsample = Conv2d(cout, cout, 3, device, generator) if upsample else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for r in self.resnets:
            x = r(x)
        if self.upsample is not None:
            x = self.upsample(F.interpolate(x, scale_factor=2, mode="nearest"))
        return x


class VAEDecoder(nn.Module):
    """Latents [B, 32, h, w] -> image [B, 3, 8h, 8w] in [-1, 1] (NCHW)."""

    def __init__(self, config, device: "torch.device | str" = "cpu", generator: Optional[torch.Generator] = None):
        super().__init__()
        self.config = config
        g, eps = config.norm_num_groups, config.norm_eps
        lc = config.latent_channels
        dch = config.effective_decoder_channels
        self.post_quant_conv = Conv2d(lc, lc, 1, device, generator)
        self.conv_in = Conv2d(lc, dch[-1], 3, device, generator)
        self.mid_resnet1 = ResnetBlock(dch[-1], dch[-1], g, eps, device, generator)
        self.mid_attn = AttnBlock(dch[-1], g, eps, device, generator)
        self.mid_resnet2 = ResnetBlock(dch[-1], dch[-1], g, eps, device, generator)
        rev = tuple(reversed(dch))
        blocks, prev = [], dch[-1]
        for i, c in enumerate(rev):
            blocks.append(UpBlock(prev, c, config.layers_per_block + 1, i < len(rev) - 1, g, eps, device, generator))
            prev = c
        self.up_blocks = nn.ModuleList(blocks)
        self.norm_out = GroupNorm(dch[0], g, eps, device)
        self.conv_out = Conv2d(dch[0], config.out_channels, 3, device, generator)
        # Patchified-latent BatchNorm running stats (checkpoint key "bn.*").
        self.register_buffer("bn_running_mean", torch.zeros(lc * 4, device=device, dtype=torch.float32))
        self.register_buffer("bn_running_var", torch.ones(lc * 4, device=device, dtype=torch.float32))

    def get_batchnorm_stats(self) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.bn_running_mean, self.bn_running_var

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        h = self.conv_in(self.post_quant_conv(z))
        h = self.mid_resnet2(self.mid_attn(self.mid_resnet1(h)))
        for blk in self.up_blocks:
            h = blk(h)
        return self.conv_out(F.silu(self.norm_out(h)))
