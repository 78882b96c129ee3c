"""FLUX.2 32-channel KL VAE: the decoder and the encoder, as PyTorch modules.

Port of ``flux2_tpu/models/flux2/vae.py``. ``VAEDecoder``: ``post_quant_conv``,
``conv_in``, mid (resnet, attention, resnet), ``up_blocks`` with nearest-2x
upsampling, ``norm_out`` and ``conv_out``, plus the patchified-latent
BatchNorm statistics. ``VAEEncoder``: ``conv_in``, ``down_blocks`` (a
stride-2 downsample after every level but the last, padded at the bottom and
right only), mid, ``norm_out``, ``conv_out`` to the posterior's mean and
log-variance, then ``quant_conv``. NCHW activations and OIHW conv weights
(the JAX package uses NHWC/HWIO inside and NCHW at its boundary, so
``encode`` is NCHW -> NCHW in both).

Parameters are stored in float32, as JAX's ``from_random`` keeps them; the
forward casts each weight to the activations' dtype, so a bf16 decode
computes in bf16 with float32 GroupNorm statistics. The mid-block attention
is plain torch on purpose: one head, C=512, 16384 tokens at 1024^2, so its
dense f32 logits take 1 GiB, which fits; the encoder's is the same (JAX's is
plain XLA too). ``decode_tiled`` decodes overlapping latent tiles and pastes
them with JAX's halo crop, so peak memory follows the tile, not the image.
``FLUX2_VAE_SMALL_DECODER`` is the distilled decoder's widths (96, 192, 384,
384); ``VAEDecoder`` builds from ``effective_decoder_channels``.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from flux2_tpu_torch.ops.normalization import group_norm


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    """The fields of ``flux2_tpu.models.flux2.vae.VAEConfig`` that the port
    reads (that module imports JAX, so the port keeps its own copy)."""

    in_channels: int = 3
    out_channels: int = 3
    latent_channels: int = 32
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    decoder_block_out_channels: Optional[Tuple[int, ...]] = None
    layers_per_block: int = 2
    norm_num_groups: int = 32
    norm_eps: float = 1e-6
    scaling_factor: float = 0.18215  # unused by FLUX.2 encode/decode; kept for parity with JAX

    @property
    def effective_decoder_channels(self) -> Tuple[int, ...]:
        return self.decoder_block_out_channels or self.block_out_channels

    @classmethod
    def from_json_dict(cls, d: dict) -> "VAEConfig":
        """Parse a diffusers AutoencoderKL config.json (JAX ``VAEConfig.from_json_dict``)."""
        dec = d.get("decoder_block_out_channels")
        return cls(
            in_channels=d.get("in_channels", 3),
            out_channels=d.get("out_channels", 3),
            latent_channels=d.get("latent_channels", 32),
            block_out_channels=tuple(d.get("block_out_channels", (128, 256, 512, 512))),
            decoder_block_out_channels=tuple(dec) if dec else None,
            layers_per_block=d.get("layers_per_block", 2),
            norm_num_groups=d.get("norm_num_groups", 32),
            norm_eps=d.get("norm_eps", 1e-6),
            scaling_factor=d.get("scaling_factor", 0.18215),
        )


FLUX2_VAE = VAEConfig()
FLUX2_VAE_SMALL_DECODER = VAEConfig(decoder_block_out_channels=(96, 192, 384, 384))


@dataclasses.dataclass(frozen=True)
class TilingConfig:
    """Spatial tiling for the decoder, in latent units (JAX ``TilingConfig``)."""

    tile_size: int = 64  # 512 px out
    tile_overlap: int = 8  # 64 px
    min_tile_threshold: int = 128


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


class Downsample(Conv2d):
    """3x3 stride-2 conv after a zero pad of one row at the bottom and one
    column at the right (diffusers' ``downsample_padding=0``, JAX
    ``_downsample_fwd``); a symmetric pad would shift every output by one input pixel."""

    def __init__(self, c, device, generator):
        super().__init__(c, c, 3, device, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.pad(x, (0, 1, 0, 1))
        return F.conv2d(x, self.weight.to(x.dtype), stride=2) + self.bias.to(x.dtype)[:, None, None]


class DownBlock(nn.Module):
    def __init__(self, cin, cout, num_resnets, downsample, groups, eps, device, generator):
        super().__init__()
        self.resnets = nn.ModuleList(
            ResnetBlock(cin if j == 0 else cout, cout, groups, eps, device, generator)
            for j in range(num_resnets)
        )
        self.downsample = Downsample(cout, device, generator) if downsample else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for r in self.resnets:
            x = r(x)
        return self.downsample(x) if self.downsample is not None else x


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


class VAEEncoder(nn.Module):
    """Image [B, 3, H, W] in [-1, 1] -> posterior moments [B, 64, H/8, W/8] or
    latents [B, 32, H/8, W/8] (NCHW). Holds the encoder half and ``quant_conv``;
    the BatchNorm statistics that normalize its latents live in ``VAEDecoder``."""

    def __init__(self, config, device: "torch.device | str" = "cpu", generator: Optional[torch.Generator] = None):
        super().__init__()
        self.config = config
        g, eps = config.norm_num_groups, config.norm_eps
        ch, lc = config.block_out_channels, config.latent_channels
        self.conv_in = Conv2d(config.in_channels, ch[0], 3, device, generator)
        blocks, prev = [], ch[0]
        for i, c in enumerate(ch):
            blocks.append(DownBlock(prev, c, config.layers_per_block, i < len(ch) - 1, g, eps, device, generator))
            prev = c
        self.down_blocks = nn.ModuleList(blocks)
        self.mid_resnet1 = ResnetBlock(ch[-1], ch[-1], g, eps, device, generator)
        self.mid_attn = AttnBlock(ch[-1], g, eps, device, generator)
        self.mid_resnet2 = ResnetBlock(ch[-1], ch[-1], g, eps, device, generator)
        self.norm_out = GroupNorm(ch[-1], g, eps, device)
        self.conv_out = Conv2d(ch[-1], 2 * lc, 3, device, generator)
        self.quant_conv = Conv2d(2 * lc, 2 * lc, 1, device, generator)

    def encode_moments(self, x: torch.Tensor) -> torch.Tensor:
        """Posterior moments, mean then log-variance along channels (JAX ``encode_moments``)."""
        h = self.conv_in(x)
        for blk in self.down_blocks:
            h = blk(h)
        h = self.mid_resnet2(self.mid_attn(self.mid_resnet1(h)))
        h = self.conv_out(F.silu(self.norm_out(h)))
        return self.quant_conv(h)

    def encode(self, x: torch.Tensor, sample_posterior: bool = False,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Latents: the posterior mean, or with ``sample_posterior`` a draw
        mean + exp(logvar / 2) * N(0, 1) from ``generator`` (JAX draws from a
        PRNG key, so the two packages' samples differ). No scaling factor."""
        moments = self.encode_moments(x)
        lc = self.config.latent_channels
        mean, logvar = moments[:, :lc], moments[:, lc:]
        if not sample_posterior:
            return mean
        if generator is None:
            raise ValueError("sample_posterior=True requires a torch.Generator")
        eps = torch.randn(mean.shape, generator=generator, device=mean.device, dtype=mean.dtype)
        return mean + torch.exp(0.5 * logvar) * eps


def _tile_starts(total: int, tile: int, stride: int) -> List[int]:
    """Tile origins along one axis: every ``stride``, the last one pulled back
    so that it ends at ``total`` (JAX ``decode_tiled``'s ``tile_starts``)."""
    starts, pos = [], 0
    while True:
        start = min(pos, max(0, total - tile))
        starts.append(start)
        if start + tile >= total:
            return starts
        pos += stride


def decode_tiled(decoder: VAEDecoder, z: torch.Tensor, tiling: TilingConfig = TilingConfig()) -> torch.Tensor:
    """Tiled decode of latents [B, C, h, w] (JAX ``vae.decode_tiled``): dense
    ``decode`` when neither side exceeds ``min_tile_threshold``; else each
    overlapping tile is decoded alone, its leading halo (half the overlap) is
    cropped off unless it is the first tile of its row or column, and the
    tiles are pasted row by row, so a later tile overwrites the trailing
    edge of the one before. GroupNorm's statistics are the tile's own, so
    the result is close to the dense decode, not equal to it."""
    _, _, h, w = z.shape
    if h <= tiling.min_tile_threshold and w <= tiling.min_tile_threshold:
        return decoder.decode(z)
    ts, ov = tiling.tile_size, tiling.tile_overlap
    up = 2 ** (len(decoder.config.effective_decoder_channels) - 1)  # latent -> pixel scale
    canvas = torch.zeros(z.shape[0], decoder.config.out_channels, h * up, w * up, dtype=z.dtype, device=z.device)
    for iy, y0 in enumerate(_tile_starts(h, ts, ts - ov)):
        for ix, x0 in enumerate(_tile_starts(w, ts, ts - ov)):
            out = decoder.decode(z[:, :, y0 : y0 + ts, x0 : x0 + ts])
            sy = 0 if iy == 0 else (ov // 2) * up
            sx = 0 if ix == 0 else (ov // 2) * up
            canvas[:, :, y0 * up + sy : y0 * up + out.shape[2], x0 * up + sx : x0 * up + out.shape[3]] = (
                out[:, :, sy:, sx:].to(canvas.dtype))
    return canvas
