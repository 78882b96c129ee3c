"""Qwen3 causal GQA decoder for the FLUX.2 Klein conditioning, as a PyTorch module.

Port of the hidden-state path of ``flux2_tpu/models/text_encoders/decoder.py``:
per-head qk-RMSNorm before RoPE, the HF half-split LLM RoPE (not the DiT's
interleaved pairs), grouped-query attention with an additive causal + key
padding mask (finite ``NEG_INF``, so a fully masked row never turns NaN),
and ``forward_hidden_states`` / ``extract_hidden_layers``. The attention is
plain torch with float32 logits, as in JAX (an einsum there, no Pallas).
Every layer matmul goes through ``q_linear`` (JAX's ``mm``), so layer weights
may be quantized (``extractor.quantize_encoder_params``). Generation (KV
cache, logits) and Mistral's llama4 query scaling are not ported yet.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from flux2_tpu_torch.models.text_encoders.config import DecoderConfig
from flux2_tpu_torch.models.flux2.transformer import linear_weight, ones_weight
from flux2_tpu_torch.ops.normalization import rms_norm
from flux2_tpu_torch.ops.quant import q_linear

NEG_INF = -1e30


def llm_rope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin [S, head_dim] f32 with the two halves repeated (HF layout)."""
    inv_freq = theta ** -(torch.arange(0, head_dim, 2, dtype=torch.float32, device=positions.device) / head_dim)
    freqs = positions.to(torch.float32)[:, None] * inv_freq[None, :]
    emb = torch.cat([freqs, freqs], dim=-1)
    return torch.cos(emb), torch.sin(emb)


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([-x2, x1], dim=-1)


def apply_llm_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: [B, H, S, D]; cos/sin: [S, D]; f32 math, result in x's dtype."""
    xf = x.to(torch.float32)
    return (xf * cos + _rotate_half(xf) * sin).to(x.dtype)


def causal_padding_mask(attention_mask: torch.Tensor, s: int) -> torch.Tensor:
    """Additive f32 mask [B, 1, S, S]: causal + key-side padding."""
    causal = torch.tril(torch.ones(s, s, dtype=torch.bool, device=attention_mask.device))
    allowed = causal[None, None] & (attention_mask[:, None, None, :] > 0)
    return torch.where(allowed, 0.0, NEG_INF).to(torch.float32)


class DecoderLayer(nn.Module):
    def __init__(self, cfg: DecoderConfig, device, dtype, generator):
        super().__init__()
        self.cfg = cfg
        h, hd = cfg.hidden_size, cfg.head_dim
        q_dim, kv_dim = cfg.num_attention_heads * hd, cfg.num_key_value_heads * hd
        self.input_norm = ones_weight(h, device, dtype)
        self.q_proj = linear_weight(h, q_dim, device, dtype, generator)
        self.k_proj = linear_weight(h, kv_dim, device, dtype, generator)
        self.v_proj = linear_weight(h, kv_dim, device, dtype, generator)
        self.o_proj = linear_weight(q_dim, h, device, dtype, generator)
        self.post_attn_norm = ones_weight(h, device, dtype)
        self.gate_proj = linear_weight(h, cfg.intermediate_size, device, dtype, generator)
        self.up_proj = linear_weight(h, cfg.intermediate_size, device, dtype, generator)
        self.down_proj = linear_weight(cfg.intermediate_size, h, device, dtype, generator)
        if cfg.qk_norm:
            self.q_norm = ones_weight(hd, device, dtype)
            self.k_norm = ones_weight(hd, device, dtype)

    def forward(self, x, cos, sin, mask) -> torch.Tensor:
        cfg = self.cfg
        b, s, _ = x.shape
        nh, nkv, hd = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
        h = rms_norm(x, self.input_norm, cfg.rms_norm_eps)
        q = q_linear(h, self.q_proj).reshape(b, s, nh, hd).transpose(1, 2)
        k = q_linear(h, self.k_proj).reshape(b, s, nkv, hd).transpose(1, 2)
        v = q_linear(h, self.v_proj).reshape(b, s, nkv, hd).transpose(1, 2)
        if cfg.qk_norm:
            q = rms_norm(q, self.q_norm, cfg.rms_norm_eps)
            k = rms_norm(k, self.k_norm, cfg.rms_norm_eps)
        q = apply_llm_rope(q, cos, sin)
        k = apply_llm_rope(k, cos, sin)
        rep = nh // nkv
        if rep > 1:
            k = k.repeat_interleave(rep, dim=1)
            v = v.repeat_interleave(rep, dim=1)
        logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * (hd**-0.5) + mask
        probs = torch.softmax(logits, dim=-1).to(v.dtype)
        attn = torch.matmul(probs, v).transpose(1, 2).reshape(b, s, nh * hd)
        x = x + q_linear(attn, self.o_proj)
        h2 = rms_norm(x, self.post_attn_norm, cfg.rms_norm_eps)
        mlp = q_linear(F.silu(q_linear(h2, self.gate_proj)) * q_linear(h2, self.up_proj), self.down_proj)
        return x + mlp


class Qwen3Decoder(nn.Module):
    """Token ids -> hidden states of every layer (the conditioning encoder)."""

    def __init__(
        self,
        cfg: DecoderConfig,
        device: "torch.device | str" = "cpu",
        dtype: torch.dtype = torch.bfloat16,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        if cfg.llama4_scaling_beta is not None:
            raise NotImplementedError("llama4 query scaling (Mistral) is not ported yet")
        self.cfg = cfg
        emb = torch.empty(cfg.vocab_size, cfg.hidden_size, device=device, dtype=dtype)
        if generator is not None:
            emb.normal_(generator=generator).mul_(0.02)
        self.embed_tokens = nn.Parameter(emb, requires_grad=False)
        self.layers = nn.ModuleList(
            DecoderLayer(cfg, device, dtype, generator) for _ in range(cfg.num_hidden_layers)
        )

    def forward_hidden_states(self, input_ids: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
        """[B, S] ids and mask (1 = token, 0 = pad) -> ALL hidden states
        [L+1, B, S, H]; index 0 is the embedding output, i >= 1 layer i's output."""
        s = input_ids.shape[1]
        x = self.embed_tokens[input_ids]
        # absolute positions 0..S-1 whatever the padding, as the JAX package
        cos, sin = llm_rope_cos_sin(torch.arange(s, device=x.device), self.cfg.head_dim, self.cfg.rope_theta)
        mask = causal_padding_mask(attention_mask, s)
        states = [x]
        for layer in self.layers:
            x = layer(x, cos, sin, mask)
            states.append(x)
        return torch.stack(states)

    def extract_hidden_layers(
        self, input_ids: torch.Tensor, attention_mask: torch.Tensor, layer_indices: Sequence[int]
    ) -> torch.Tensor:
        """Concatenate the given hidden-state layers along features: [B, S, len * H].
        All layers run, as in JAX."""
        hs = self.forward_hidden_states(input_ids, attention_mask)
        return torch.cat([hs[i] for i in layer_indices], dim=-1)
