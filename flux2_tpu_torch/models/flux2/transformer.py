"""FLUX.2 diffusion transformer (DiT) as a PyTorch module.

Port of the T2I forward of ``flux2_tpu/models/flux2/transformer.py``:
``sinusoidal_embedding``, ``time_guidance_embedding``, the modulation
projections, ``double_block``, ``single_block``, ``forward`` and ``_final``,
with JAX's unmerged LoRA (``_lmm``, ``forward(lora=, lora_scale=)``) and
per-block remat (``remat=True`` / ``"block"``: ``torch.utils.checkpoint``).
The KV-extract/KV-cached forwards, the ``"dots"`` remat policy and ring
attention are not ported yet.

Linear weights are stored [out, in] (``F.linear``'s layout); the JAX package
stores [in, out] stacked over layers, and ``flux2_tpu_torch.io.jax_params``
converts. Every matmul goes through ``q_linear`` (JAX's ``mm``), so a
weight may be a quantized module from ``flux2_tpu_torch.ops.quant``
(``quantize_params``); the stream dtype then follows JAX's rules (see
``_mlp_embed`` and ``forward``). The joint sequence is [txt ; img], and the
attention in every block goes through ``sdpa(..., bounded_logits=True)``: on
the card, the hand-written flash-attention kernel.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from flux2_tpu.models.flux2.config import Flux2TransformerConfig
from flux2_tpu_torch.ops.attention import sdpa
from flux2_tpu_torch.ops.normalization import gate, layer_norm, modulate, rms_norm
from flux2_tpu_torch.ops.quant import q_linear
from flux2_tpu_torch.ops.rope import apply_rope


def linear_weight(d_in: int, d_out: int, device, dtype, generator: Optional[torch.Generator]) -> nn.Parameter:
    """[out, in] weight, N(0, 1) * d_in**-0.5 drawn in ``dtype`` (as JAX's ``_linear``);
    left uninitialised when ``generator`` is None (weights loaded after)."""
    w = torch.empty(d_out, d_in, device=device, dtype=dtype)
    if generator is not None:
        w.normal_(generator=generator).mul_(d_in**-0.5)
    return nn.Parameter(w, requires_grad=False)


def ones_weight(n: int, device, dtype) -> nn.Parameter:
    return nn.Parameter(torch.ones(n, device=device, dtype=dtype), requires_grad=False)


def sinusoidal_embedding(t: torch.Tensor, num_channels: int = 256) -> torch.Tensor:
    """Diffusers-style timestep embedding, flip_sin_to_cos=True: [B] -> [B, C] f32."""
    half = num_channels // 2
    exponent = -math.log(10000.0) * torch.arange(half, dtype=torch.float32, device=t.device) / half
    args = t.to(torch.float32)[:, None] * torch.exp(exponent)[None, :]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def _heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """[B, S, H*D] -> contiguous [B, H, S, D]."""
    b, s, _ = x.shape
    return x.reshape(b, s, num_heads, -1).transpose(1, 2).contiguous()


def _unheads(x: torch.Tensor) -> torch.Tensor:
    """[B, H, S, D] -> [B, S, H*D]."""
    b, h, s, d = x.shape
    return x.transpose(1, 2).reshape(b, s, h * d)


def _lmm(x: torch.Tensor, w, lora: Optional[nn.ModuleDict], name: str, scale: float) -> torch.Tensor:
    """Projection with an optional UNMERGED LoRA adapter (JAX ``_lmm``):
    y = x W^T + scale * ((x a) b), the adapter cast to x's dtype. The
    backward forms only [in, r] and [r, out] gradients, never a base-sized one."""
    y = q_linear(x, w)
    if lora is not None and name in lora:
        ad = lora[name]
        y = y + ((x @ ad.a.to(x.dtype)) @ ad.b.to(x.dtype)) * scale
    return y


def _swiglu(x, bp, w_in: str, w_out: str, lora, scale) -> torch.Tensor:
    g, v = _lmm(x, getattr(bp, w_in), lora, w_in, scale).chunk(2, dim=-1)
    return _lmm(F.silu(g) * v, getattr(bp, w_out), lora, w_out, scale)


class DoubleBlock(nn.Module):
    """Double-stream block: per-stream AdaLN + projections, joint attention
    over [txt ; img], per-stream SwiGLU FFNs (JAX ``double_block``)."""

    def __init__(self, config: Flux2TransformerConfig, device, dtype, generator):
        super().__init__()
        d, hd, mlp = config.inner_dim, config.attention_head_dim, config.mlp_hidden_dim
        self.num_heads = config.num_attention_heads
        for name in ("to_q", "to_k", "to_v", "to_out", "add_q", "add_k", "add_v", "add_out"):
            setattr(self, name, linear_weight(d, d, device, dtype, generator))
        for name in ("norm_q", "norm_k", "norm_added_q", "norm_added_k"):
            setattr(self, name, ones_weight(hd, device, dtype))
        self.ff_in = linear_weight(d, 2 * mlp, device, dtype, generator)
        self.ff_out = linear_weight(mlp, d, device, dtype, generator)
        self.ff_ctx_in = linear_weight(d, 2 * mlp, device, dtype, generator)
        self.ff_ctx_out = linear_weight(mlp, d, device, dtype, generator)

    def forward(self, img, txt, img_mod, txt_mod, rope_cos, rope_sin, lora: Optional[nn.ModuleDict] = None,
                lora_scale: float = 1.0) -> Tuple[torch.Tensor, torch.Tensor]:
        nh = self.num_heads
        s_txt = txt.shape[1]
        img_n = modulate(layer_norm(img), img_mod[:, 0, 0], img_mod[:, 0, 1])
        txt_n = modulate(layer_norm(txt), txt_mod[:, 0, 0], txt_mod[:, 0, 1])

        def proj(x, name):
            return _lmm(x, getattr(self, name), lora, name, lora_scale)

        q_img = rms_norm(_heads(proj(img_n, "to_q"), nh), self.norm_q)
        k_img = rms_norm(_heads(proj(img_n, "to_k"), nh), self.norm_k)
        v_img = _heads(proj(img_n, "to_v"), nh)
        q_txt = rms_norm(_heads(proj(txt_n, "add_q"), nh), self.norm_added_q)
        k_txt = rms_norm(_heads(proj(txt_n, "add_k"), nh), self.norm_added_k)
        v_txt = _heads(proj(txt_n, "add_v"), nh)

        q = apply_rope(torch.cat([q_txt, q_img], dim=2), rope_cos, rope_sin)
        k = apply_rope(torch.cat([k_txt, k_img], dim=2), rope_cos, rope_sin)
        v = torch.cat([v_txt, v_img], dim=2)
        attn = sdpa(q, k, v, bounded_logits=True)  # qk are RMS-normed above

        img = img + gate(proj(_unheads(attn[:, :, s_txt:]), "to_out"), img_mod[:, 0, 2])
        txt = txt + gate(proj(_unheads(attn[:, :, :s_txt]), "add_out"), txt_mod[:, 0, 2])

        img_n2 = modulate(layer_norm(img), img_mod[:, 1, 0], img_mod[:, 1, 1])
        txt_n2 = modulate(layer_norm(txt), txt_mod[:, 1, 0], txt_mod[:, 1, 1])
        img = img + gate(_swiglu(img_n2, self, "ff_in", "ff_out", lora, lora_scale), img_mod[:, 1, 2])
        txt = txt + gate(_swiglu(txt_n2, self, "ff_ctx_in", "ff_ctx_out", lora, lora_scale), txt_mod[:, 1, 2])
        return img, txt


class SingleBlock(nn.Module):
    """Single-stream block: one AdaLN set, parallel attention + SwiGLU MLP
    whose two output projections sum (JAX ``single_block``)."""

    def __init__(self, config: Flux2TransformerConfig, device, dtype, generator):
        super().__init__()
        d, hd, mlp = config.inner_dim, config.attention_head_dim, config.mlp_hidden_dim
        self.num_heads = config.num_attention_heads
        for name in ("to_q", "to_k", "to_v"):
            setattr(self, name, linear_weight(d, d, device, dtype, generator))
        self.mlp_gate = linear_weight(d, mlp, device, dtype, generator)
        self.mlp_up = linear_weight(d, mlp, device, dtype, generator)
        self.norm_q = ones_weight(hd, device, dtype)
        self.norm_k = ones_weight(hd, device, dtype)
        self.out_attn = linear_weight(d, d, device, dtype, generator)
        self.out_mlp = linear_weight(mlp, d, device, dtype, generator)

    def forward(self, x, mod, rope_cos, rope_sin, lora: Optional[nn.ModuleDict] = None,
                lora_scale: float = 1.0) -> torch.Tensor:
        nh = self.num_heads

        def proj(x, name):
            return _lmm(x, getattr(self, name), lora, name, lora_scale)

        x_n = modulate(layer_norm(x), mod[:, 0, 0], mod[:, 0, 1])
        q = apply_rope(rms_norm(_heads(proj(x_n, "to_q"), nh), self.norm_q), rope_cos, rope_sin)
        k = apply_rope(rms_norm(_heads(proj(x_n, "to_k"), nh), self.norm_k), rope_cos, rope_sin)
        v = _heads(proj(x_n, "to_v"), nh)
        attn = _unheads(sdpa(q, k, v, bounded_logits=True))  # qk RMS-normed above
        mlp = F.silu(proj(x_n, "mlp_gate")) * proj(x_n, "mlp_up")
        out = proj(attn, "out_attn") + proj(mlp, "out_mlp")
        return x + gate(out, mod[:, 0, 2])


class Flux2Transformer(nn.Module):
    """The FLUX.2 DiT: [B, S_img, 128] latents + [B, S_txt, joint] text -> velocity."""

    def __init__(
        self,
        config: Flux2TransformerConfig,
        device: "torch.device | str" = "cpu",
        dtype: torch.dtype = torch.bfloat16,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.config = config
        d = config.inner_dim
        tc = config.time_embed_channels

        def lin(d_in, d_out):
            return linear_weight(d_in, d_out, device, dtype, generator)

        self.x_embedder = lin(config.in_channels, d)
        self.context_embedder = lin(config.joint_attention_dim, d)
        self.time_linear1 = lin(tc, d)
        self.time_linear2 = lin(d, d)
        self.double_mod_img = lin(d, 6 * d)
        self.double_mod_txt = lin(d, 6 * d)
        self.single_mod = lin(d, 3 * d)
        self.double_blocks = nn.ModuleList(
            DoubleBlock(config, device, dtype, generator) for _ in range(config.num_layers)
        )
        self.single_blocks = nn.ModuleList(
            SingleBlock(config, device, dtype, generator) for _ in range(config.num_single_layers)
        )
        self.norm_out = lin(d, 2 * d)
        self.proj_out = lin(d, config.out_channels)
        if config.guidance_embeds:
            self.guidance_linear1 = lin(tc, d)
            self.guidance_linear2 = lin(d, d)

    @staticmethod
    def _mlp_embed(x: torch.Tensor, w1, w2) -> torch.Tensor:
        """linear2(silu(linear1(x))). ``x`` (the f32 sinusoid) is cast to ``w1``'s
        dtype only when ``w1`` is dense: under a quantized ``w1`` it stays f32 and
        so does the result, as in JAX's ``_mlp_embed``."""
        if isinstance(w1, torch.Tensor):
            x = x.to(w1.dtype)
        return q_linear(F.silu(q_linear(x, w1)), w2)

    def time_guidance_embedding(self, timestep: torch.Tensor, guidance: Optional[torch.Tensor]) -> torch.Tensor:
        """Timestep (+ optional guidance) embedding [B, D]; sigma is scaled x1000."""
        tc = self.config.time_embed_channels
        temb = self._mlp_embed(sinusoidal_embedding(timestep * 1000.0, tc), self.time_linear1, self.time_linear2)
        if self.config.guidance_embeds and guidance is not None:
            g = sinusoidal_embedding(guidance * 1000.0, tc)
            temb = temb + self._mlp_embed(g, self.guidance_linear1, self.guidance_linear2)
        return temb

    @staticmethod
    def _modulation(weight: torch.Tensor, temb: torch.Tensor, num_sets: int) -> torch.Tensor:
        """linear(silu(temb)) -> [B, num_sets, 3, D] of (shift, scale, gate)."""
        out = q_linear(F.silu(temb), weight)
        return out.reshape(out.shape[0], num_sets, 3, -1)

    def _final(self, temb: torch.Tensor, img: torch.Tensor) -> torch.Tensor:
        """AdaLN-continuous out: (scale, shift) in diffusers order, then proj_out."""
        scale, shift = q_linear(F.silu(temb), self.norm_out).chunk(2, dim=-1)
        return q_linear(modulate(layer_norm(img), shift, scale), self.proj_out)

    def forward(
        self,
        hidden_states: torch.Tensor,  # [B, S_img, 128]
        encoder_hidden_states: torch.Tensor,  # [B, S_txt, joint]
        timestep: torch.Tensor,  # [B] sigma in [0, 1]
        rope_cos: torch.Tensor,  # [S_txt + S_img, head_dim] f32, ids in [txt ; img] order
        rope_sin: torch.Tensor,
        guidance: Optional[torch.Tensor] = None,  # [B]
        remat: "bool | str" = False,
        lora=None,  # flux2_tpu_torch.training.lora.LoRA
        lora_scale: float = 1.0,
    ) -> torch.Tensor:
        """Velocity [B, S_img, 128]. ``remat``: False, or True / "block" to
        recompute each block in the backward (``torch.utils.checkpoint``,
        non-reentrant; JAX ``_remat_wrap``). ``lora`` adds the unmerged
        adapters scaled by ``lora_scale``."""
        if remat not in (False, True, "block"):
            raise NotImplementedError(f"remat={remat!r}: only per-block recompute is ported (ROADMAP queue 13)")
        s_txt = encoder_hidden_states.shape[1]
        img = q_linear(hidden_states, self.x_embedder)
        # a quantized context embedder takes the stream's dtype (JAX: hidden_states')
        ctx_w = self.context_embedder
        ctx_dtype = ctx_w.dtype if isinstance(ctx_w, torch.Tensor) else hidden_states.dtype
        txt = q_linear(encoder_hidden_states.to(ctx_dtype), ctx_w)
        # back to the stream dtype when a quantized time embedding left it f32
        temb = self.time_guidance_embedding(timestep, guidance).to(img.dtype)

        img_mod = self._modulation(self.double_mod_img, temb, 2)
        txt_mod = self._modulation(self.double_mod_txt, temb, 2)
        single_mod = self._modulation(self.single_mod, temb, 1)
        rope_cos = rope_cos.to(torch.float32)
        rope_sin = rope_sin.to(torch.float32)

        def run(block, *args, lora_block):
            kw = {"lora": lora_block, "lora_scale": lora_scale}
            if remat:
                return checkpoint(block, *args, use_reentrant=False, **kw)
            return block(*args, **kw)

        for i, block in enumerate(self.double_blocks):
            lb = lora.block("double_blocks", i) if lora is not None else None
            img, txt = run(block, img, txt, img_mod, txt_mod, rope_cos, rope_sin, lora_block=lb)
        x = torch.cat([txt, img], dim=1)
        for i, block in enumerate(self.single_blocks):
            lb = lora.block("single_blocks", i) if lora is not None else None
            x = run(block, x, single_mod, rope_cos, rope_sin, lora_block=lb)
        return self._final(temb, x[:, s_txt:])
