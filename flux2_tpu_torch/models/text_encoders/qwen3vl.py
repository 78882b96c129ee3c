"""Qwen3-VL language tower: the generic decoder under Qwen3-VL's MRoPE.

Port of ``flux2_tpu/models/text_encoders/qwen3vl.py`` (the experimental
Klein-VL encoder; a library module with no caller in either package's CLI).
The layer math (GQA, QK-RMSNorm, SwiGLU) is ``decoder.Qwen3Decoder``'s
layers'; only the rotary tables and the rotation differ, in two conventions:

- ``mrope_cos_sin``, the reference's: head_dim splits into contiguous
  sections of twice the section sizes ([24, 20, 20] -> [48 | 40 | 40]) for
  (temporal, height, width), each with its own ladder
  ``theta^(-2j / (2 * section))``, rotated as interleaved pairs (the DiT's
  ``ops.rope.apply_rope``);
- ``mrope_cos_sin_hf``, HF's (``apply_interleaved_mrope``): one global ladder
  ``theta^(-2j / head_dim)`` whose slot j takes the height position for j in
  {1, 4, ...} (< 3 * section_h), the width position for j in {2, 5, ...}
  (< 3 * section_w), else the temporal one, rotated half-split.

Text-only position ids are temporal = arange, height = width = 0.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from flux2_tpu_torch.models.text_encoders.config import QWEN3_HIDDEN_LAYERS
from flux2_tpu_torch.models.text_encoders.decoder import Qwen3Decoder, _rotate_half, causal_padding_mask
from flux2_tpu_torch.ops.normalization import rms_norm
from flux2_tpu_torch.ops.quant import q_linear
from flux2_tpu_torch.ops.rope import apply_rope as apply_interleaved_rope

DEFAULT_MROPE_SECTION: Tuple[int, int, int] = (24, 20, 20)  # head_dim 128


def mrope_cos_sin(position_ids: torch.Tensor, head_dim: int, theta: float,
                  section: Sequence[int] = DEFAULT_MROPE_SECTION) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-section pair-interleaved tables, cos / sin [S, head_dim]; dims past
    the sections pass through (cos 1, sin 0). position_ids [3, S]."""
    s, dev = position_ids.shape[1], position_ids.device
    cos_parts, sin_parts = [], []
    for i, sec in enumerate(section):
        inv_freq = theta ** -(2.0 * torch.arange(sec, dtype=torch.float32, device=dev) / (2.0 * sec))
        angles = position_ids[i].float()[:, None] * inv_freq[None, :]
        rep = angles.repeat_interleave(2, dim=-1)
        cos_parts.append(torch.cos(rep))
        sin_parts.append(torch.sin(rep))
    used = 2 * sum(section)
    if used < head_dim:
        cos_parts.append(torch.ones(s, head_dim - used, device=dev))
        sin_parts.append(torch.zeros(s, head_dim - used, device=dev))
    return torch.cat(cos_parts, -1), torch.cat(sin_parts, -1)


def mrope_cos_sin_hf(position_ids: torch.Tensor, head_dim: int, theta: float,
                     section: Sequence[int] = DEFAULT_MROPE_SECTION) -> Tuple[torch.Tensor, torch.Tensor]:
    """HF's interleaved MRoPE: cos / sin [S, head_dim] in the half-split layout."""
    d2, dev = head_dim // 2, position_ids.device
    inv = theta ** -(2.0 * torch.arange(d2, dtype=torch.float32, device=dev) / head_dim)
    freqs = position_ids.float()[:, :, None] * inv[None, None, :]  # [3, S, d2]
    ft = freqs[0].clone()
    idx_h = torch.from_numpy(np.arange(1, 3 * section[1], 3)).to(dev)
    idx_w = torch.from_numpy(np.arange(2, 3 * section[2], 3)).to(dev)
    ft[:, idx_h] = freqs[1][:, idx_h]
    ft[:, idx_w] = freqs[2][:, idx_w]
    emb = torch.cat([ft, ft], dim=-1)
    return torch.cos(emb), torch.sin(emb)


def text_only_position_ids(seq_len: int, offset: int = 0, device=None) -> torch.Tensor:
    """[3, S]: temporal = arange(+offset), height = width = 0."""
    temporal = torch.arange(offset, offset + seq_len, device=device)
    zeros = torch.zeros_like(temporal)
    return torch.stack([temporal, zeros, zeros])


def _vl_layer(layer, cfg, x, cos, sin, mask, half_split: bool = False) -> torch.Tensor:
    """One decoder layer (``decoder.DecoderLayer``'s weights) under the given
    rotary tables: pair-interleaved, or half-split for HF's convention."""
    b, s, _ = x.shape
    nh, nkv, hd = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    h = rms_norm(x, layer.input_norm, cfg.rms_norm_eps)
    q = q_linear(h, layer.q_proj).reshape(b, s, nh, hd).transpose(1, 2)
    k = q_linear(h, layer.k_proj).reshape(b, s, nkv, hd).transpose(1, 2)
    v = q_linear(h, layer.v_proj).reshape(b, s, nkv, hd).transpose(1, 2)
    if cfg.qk_norm:
        q = rms_norm(q, layer.q_norm, cfg.rms_norm_eps)
        k = rms_norm(k, layer.k_norm, cfg.rms_norm_eps)
    if half_split:
        qf, kf = q.float(), k.float()
        q = (qf * cos + _rotate_half(qf) * sin).to(x.dtype)
        k = (kf * cos + _rotate_half(kf) * sin).to(x.dtype)
    else:
        q = apply_interleaved_rope(q, cos, sin)
        k = apply_interleaved_rope(k, cos, sin)
    rep = nh // nkv
    if rep > 1:
        k = k.repeat_interleave(rep, dim=1)
        v = v.repeat_interleave(rep, dim=1)
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * hd**-0.5 + mask
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    attn = torch.matmul(probs, v).transpose(1, 2).reshape(b, s, nh * hd)
    x = x + q_linear(attn, layer.o_proj)
    h2 = rms_norm(x, layer.post_attn_norm, cfg.rms_norm_eps)
    return x + q_linear(F.silu(q_linear(h2, layer.gate_proj)) * q_linear(h2, layer.up_proj), layer.down_proj)


def forward_hidden_states(decoder: Qwen3Decoder, input_ids: torch.Tensor, attention_mask: torch.Tensor,
                          position_ids: Optional[torch.Tensor] = None,
                          section: Sequence[int] = DEFAULT_MROPE_SECTION,
                          hf_canonical: bool = False) -> torch.Tensor:
    """The Qwen3-VL decoder over ``decoder``'s weights; ALL hidden states [L+1, B, S, H].
    ``hf_canonical`` takes HF's MRoPE convention, else the reference's."""
    cfg = decoder.cfg
    s = input_ids.shape[1]
    x = decoder.embed_tokens[input_ids]
    if position_ids is None:
        position_ids = text_only_position_ids(s, device=x.device)
    tables = mrope_cos_sin_hf if hf_canonical else mrope_cos_sin
    cos, sin = tables(position_ids, cfg.head_dim, cfg.rope_theta, section)
    mask = causal_padding_mask(attention_mask, s)
    states = [x]
    for layer in decoder.layers:
        x = _vl_layer(layer, cfg, x, cos, sin, mask, half_split=hf_canonical)
        states.append(x)
    return torch.stack(states)


def extract_klein_vl_embeddings(decoder: Qwen3Decoder, input_ids: torch.Tensor, attention_mask: torch.Tensor,
                                layer_indices: Sequence[int] = QWEN3_HIDDEN_LAYERS,
                                section: Sequence[int] = DEFAULT_MROPE_SECTION,
                                hf_canonical: bool = False) -> torch.Tensor:
    """Klein-VL conditioning: the [9, 18, 27] concat recipe over the MRoPE tower, [B, S, len * H]."""
    hs = forward_hidden_states(decoder, input_ids, attention_mask, section=section, hf_canonical=hf_canonical)
    return torch.cat([hs[i] for i in layer_indices], dim=-1)
