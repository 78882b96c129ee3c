"""Qwen3.5 hybrid language tower: Gated DeltaNet linear attention beside full GQA.

Port of ``flux2_tpu/models/text_encoders/qwen35.py`` (the VLM's language
model, used for prompt enrichment, image analysis and validation scoring):

- A 4-periodic stack: three Gated DeltaNet layers, then one full-attention
  layer (``full_attention_interval``).
- Gated DeltaNet: a fused QKV projection through a causal depthwise conv
  (kernel 4) and SiLU; q and k L2-normalized with fla's eps placement
  (``x * rsqrt(sum(x^2) + 1e-6)``) and q scaled by 1/sqrt(Dk); the decay
  ``g = exp(-exp(A_log) * softplus(a + dt_bias))`` and the write gate
  ``beta = sigmoid(b)``; the delta rule
  ``S_t = g_t S_{t-1} + beta_t (v_t - g_t S_{t-1} k_t) k_t^T``, ``y_t = S_t q_t``;
  the gated RMSNorm ``rmsnorm(y) * silu(z)``. The state is float32.
- Full attention: q_proj gives [q ; gate], per-head QK-RMSNorm, the partial
  rotary (``rotary_dim`` = head_dim * 0.25) with the interleaved 3-section
  MRoPE (frequency i takes position axis i mod 3), GQA, and the output
  ``attn * sigmoid(gate)``.
- ``forward`` / ``forward_logits`` (tied embeddings) and the hybrid
  streaming cache (``init_hybrid_cache``, ``forward_cached``): each
  DeltaNet layer carries (conv state, recurrent state), each full layer a
  static-length KV cache, written in place here where JAX returns a new
  cache.

A prefill longer than 8 tokens takes the chunk-parallel delta rule
(``gated_delta_update_chunked``), shorter ones the sequential recurrence
(``gated_delta_update``), as in JAX. JAX's chunked form takes
``exp(lg_t - lg_i)`` for every (t, i), i > t included, where the exponent
is positive and overflows float32 under strong decay (g around 0.2 at 64
tokens) before a boolean mask multiplies it: inf x 0 gives NaN. The port
masks the exponent to -inf above the diagonal before ``exp``; it equals
JAX's chunked output wherever that output is finite, and the sequential
recurrence everywhere.

Linears are [out, in] through ``q_linear``, whose dtype promotion is
``x @ w``'s in JAX; elementwise ops promote as in JAX too, so a float32
cache on a bf16 model computes as JAX's does.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from flux2_tpu_torch.models.flux2.transformer import linear_weight, ones_weight
from flux2_tpu_torch.models.text_encoders.decoder import NEG_INF, _rotate_half
from flux2_tpu_torch.ops.normalization import rms_norm
from flux2_tpu_torch.ops.quant import q_linear


@dataclasses.dataclass(frozen=True)
class Qwen35TextConfig:
    vocab_size: int = 248_320
    hidden_size: int = 2048
    intermediate_size: int = 5632
    num_hidden_layers: int = 32
    num_attention_heads: int = 16
    num_key_value_heads: int = 4
    head_dim: int = 256
    rms_norm_eps: float = 1e-6
    rope_theta: float = 10_000_000.0
    partial_rotary_factor: float = 0.25
    mrope_sections: Tuple[int, int, int] = (11, 11, 10)
    full_attention_interval: int = 4
    linear_num_key_heads: int = 16
    linear_num_value_heads: int = 32
    linear_key_head_dim: int = 128
    linear_value_head_dim: int = 128
    linear_conv_kernel_dim: int = 4
    tie_word_embeddings: bool = True

    @property
    def rotary_dim(self) -> int:
        return int(self.head_dim * self.partial_rotary_factor)

    @property
    def key_dim(self) -> int:
        return self.linear_num_key_heads * self.linear_key_head_dim

    @property
    def value_dim(self) -> int:
        return self.linear_num_value_heads * self.linear_value_head_dim

    @property
    def conv_dim(self) -> int:
        return 2 * self.key_dim + self.value_dim

    def is_linear_layer(self, i: int) -> bool:
        return (i + 1) % self.full_attention_interval != 0

    @classmethod
    def from_json_dict(cls, d: dict) -> "Qwen35TextConfig":
        rope = d.get("rope_scaling") or {}
        return cls(
            vocab_size=d["vocab_size"],
            hidden_size=d["hidden_size"],
            intermediate_size=d["intermediate_size"],
            num_hidden_layers=d["num_hidden_layers"],
            num_attention_heads=d["num_attention_heads"],
            num_key_value_heads=d["num_key_value_heads"],
            head_dim=d.get("head_dim", 256),
            rms_norm_eps=d.get("rms_norm_eps", 1e-6),
            rope_theta=d.get("rope_theta", 10_000_000.0),
            partial_rotary_factor=d.get("partial_rotary_factor", 0.25),
            mrope_sections=tuple(rope.get("mrope_section", (11, 11, 10))),
            full_attention_interval=d.get("full_attention_interval", 4),
            linear_num_key_heads=d.get("linear_num_key_heads", 16),
            linear_num_value_heads=d.get("linear_num_value_heads", 32),
            linear_key_head_dim=d.get("linear_key_head_dim", 128),
            linear_value_head_dim=d.get("linear_value_head_dim", 128),
            linear_conv_kernel_dim=d.get("linear_conv_kernel_dim", 4),
            tie_word_embeddings=d.get("tie_word_embeddings", True),
        )


TINY_QWEN35 = Qwen35TextConfig(
    vocab_size=128,
    hidden_size=64,
    intermediate_size=96,
    num_hidden_layers=4,  # layers 0, 1, 2 linear; layer 3 full
    num_attention_heads=2,
    num_key_value_heads=1,
    head_dim=32,
    partial_rotary_factor=0.25,  # rotary_dim 8
    mrope_sections=(2, 1, 1),  # halfdim 4
    linear_num_key_heads=2,
    linear_num_value_heads=4,
    linear_key_head_dim=16,
    linear_value_head_dim=16,
)


# -- Gated DeltaNet ----------------------------------------------------------------------


def _causal_depthwise_conv(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """[B, S, C] causal depthwise conv with kernel [K, C] (left pad K - 1)."""
    k = kernel.shape[0]
    pad = F.pad(x, (0, 0, k - 1, 0))
    out = torch.zeros_like(x, dtype=torch.promote_types(x.dtype, kernel.dtype))
    for i in range(k):
        out = out + pad[:, i:i + x.shape[1]] * kernel[i][None, None, :]
    return out


def gated_delta_update(q, k, v, g, beta, state) -> Tuple[torch.Tensor, torch.Tensor]:
    """The sequential delta rule: q, k [B, T, Hv, Dk], v [B, T, Hv, Dv], g and
    beta [B, T, Hv], state [B, Hv, Dv, Dk] -> (y [B, T, Hv, Dv], state), float32."""
    s = state.float()
    ys = []
    for t in range(q.shape[1]):
        qt, kt, vt, gt, bt = q[:, t], k[:, t], v[:, t], g[:, t], beta[:, t]
        s = s * gt[..., None, None]
        kv_mem = torch.einsum("bhdk,bhk->bhd", s, kt)
        delta = (vt - kv_mem) * bt[..., None]
        s = s + torch.einsum("bhd,bhk->bhdk", delta, kt)
        ys.append(torch.einsum("bhdk,bhk->bhd", s, qt))
    return torch.stack(ys, dim=1), s


def gated_delta_update_chunked(q, k, v, g, beta, state, chunk_size: int = 64) -> Tuple[torch.Tensor, torch.Tensor]:
    """The chunk-parallel delta rule (exact; equals ``gated_delta_update``).

    Within a chunk, with Gamma_t = prod_{j <= t} g_j, the writes solve the
    unit-lower-triangular system
        (I + A) U = diag(beta) (V - Gamma * K S_0^T),
        A[t, i] = beta_t (Gamma_t / Gamma_i) (k_t . k_i)   (i < t),
    and then
        y_t = Gamma_t S_0 q_t + sum_{i <= t} (Gamma_t / Gamma_i) (k_i . q_t) u_i,
        S_C = Gamma_C S_0 + sum_i (Gamma_C / Gamma_i) u_i k_i^T.
    Gamma_t / Gamma_i is ``exp(lg_t - lg_i)`` with the exponent set to -inf
    above the diagonal before the exp (see the module docstring); log g is
    taken at least at float32's smallest normal, so a decay that underflows
    to 0 gives ratios of ~1e-38 instead of NaN."""
    b, t, hv, dk = q.shape
    dv = v.shape[-1]
    c = min(chunk_size, t)
    pad = (-t) % c
    if pad:
        q, k, v = (F.pad(x, (0, 0, 0, 0, 0, pad)) for x in (q, k, v))
        g = F.pad(g, (0, 0, 0, pad), value=1.0)  # no decay
        beta = F.pad(beta, (0, 0, 0, pad))  # no write
    n = (t + pad) // c
    dev = q.device
    incl = torch.tril(torch.ones(c, c, dtype=torch.bool, device=dev))
    strict = torch.tril(torch.ones(c, c, dtype=torch.bool, device=dev), -1)
    eye = torch.eye(c, dtype=torch.float32, device=dev)
    tiny = torch.finfo(torch.float32).tiny
    s = state.float()
    ys = []
    for i in range(n):
        sl = slice(i * c, (i + 1) * c)
        qh, kh, vh = (x[:, sl].transpose(1, 2).float() for x in (q, k, v))  # [B, Hv, C, *]
        gh, bh = (x[:, sl].transpose(1, 2).float() for x in (g, beta))  # [B, Hv, C]
        lg = torch.cumsum(torch.log(gh.clamp_min(tiny)), dim=-1)
        ratio = torch.exp(torch.where(incl, lg[..., :, None] - lg[..., None, :], float("-inf")))
        gamma = torch.exp(lg)
        kkt = kh @ kh.transpose(-1, -2)
        a = bh[..., :, None] * ratio * kkt * strict
        z = kh @ s.transpose(-1, -2)  # K S_0^T [B, Hv, C, Dv]
        rhs = bh[..., None] * (vh - gamma[..., None] * z)
        u = torch.linalg.solve_triangular(eye + a, rhs, upper=False, unitriangular=True)
        qkt = qh @ kh.transpose(-1, -2)
        y = gamma[..., None] * (qh @ s.transpose(-1, -2)) + (qkt * ratio) @ u
        w = torch.exp(lg[..., -1:] - lg)  # Gamma_C / Gamma_i
        s = gamma[..., -1][..., None, None] * s + torch.einsum("bhiv,bhid,bhi->bhvd", u, kh, w)
        ys.append(y.transpose(1, 2))
    return torch.cat(ys, dim=1)[:, :t].reshape(b, t, hv, dv), s


class GatedDeltaNet(nn.Module):
    def __init__(self, cfg: Qwen35TextConfig, device, dtype, generator):
        super().__init__()
        self.cfg = cfg
        h, hv = cfg.hidden_size, cfg.linear_num_value_heads
        self.in_proj_qkv = linear_weight(h, cfg.conv_dim, device, dtype, generator)
        self.in_proj_z = linear_weight(h, cfg.value_dim, device, dtype, generator)
        self.in_proj_b = linear_weight(h, hv, device, dtype, generator)
        self.in_proj_a = linear_weight(h, hv, device, dtype, generator)
        self.out_proj = linear_weight(cfg.value_dim, h, device, dtype, generator)
        conv = torch.empty(cfg.linear_conv_kernel_dim, cfg.conv_dim, device=device, dtype=dtype)  # [K, conv_dim]
        if generator is not None:
            conv.normal_(generator=generator).mul_(0.2)
        self.conv_kernel = nn.Parameter(conv, requires_grad=False)
        self.norm_weight = ones_weight(cfg.linear_value_head_dim, device, dtype)
        self.a_log = nn.Parameter(torch.zeros(hv, device=device, dtype=dtype), requires_grad=False)
        self.dt_bias = nn.Parameter(torch.ones(hv, device=device, dtype=dtype), requires_grad=False)

    def forward(self, x: torch.Tensor, conv_state: Optional[torch.Tensor] = None,
                rec_state: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """x [B, S, H] -> (out [B, S, H], new conv state, new recurrent state)."""
        cfg = self.cfg
        b, s, _ = x.shape
        hk, hv = cfg.linear_num_key_heads, cfg.linear_num_value_heads
        dk, dv = cfg.linear_key_head_dim, cfg.linear_value_head_dim
        kd, kk = cfg.key_dim, cfg.linear_conv_kernel_dim

        mixed = q_linear(x, self.in_proj_qkv)  # [B, S, conv_dim]
        z = q_linear(x, self.in_proj_z).reshape(b, s, hv, dv)
        a = q_linear(x, self.in_proj_a)
        bb = q_linear(x, self.in_proj_b)

        if conv_state is None:
            conv_state = torch.zeros(b, kk - 1, cfg.conv_dim, device=x.device, dtype=mixed.dtype)
        dtype = torch.promote_types(conv_state.dtype, mixed.dtype)
        conv_in = torch.cat([conv_state.to(dtype), mixed.to(dtype)], dim=1)
        new_conv_state = conv_in[:, -(kk - 1):]
        conv_out = F.silu(_causal_depthwise_conv(conv_in, self.conv_kernel)[:, kk - 1:])

        q = conv_out[..., :kd].reshape(b, s, hk, dk).float()
        k = conv_out[..., kd:2 * kd].reshape(b, s, hk, dk).float()
        v = conv_out[..., 2 * kd:].reshape(b, s, hv, dv).float()
        q = q * torch.rsqrt(q.square().sum(-1, keepdim=True) + 1e-6) * dk**-0.5
        k = k * torch.rsqrt(k.square().sum(-1, keepdim=True) + 1e-6)

        g = torch.exp(-torch.exp(self.a_log) * F.softplus(a.float() + self.dt_bias))  # exp(A_log) in its dtype, as JAX
        beta = torch.sigmoid(bb.float())
        rep = hv // hk
        if rep > 1:
            q = q.repeat_interleave(rep, dim=2)
            k = k.repeat_interleave(rep, dim=2)
        if rec_state is None:
            rec_state = torch.zeros(b, hv, dv, dk, device=x.device, dtype=torch.float32)
        update = gated_delta_update_chunked if s > 8 else gated_delta_update
        y, new_rec_state = update(q, k, v, g, beta, rec_state)

        normed = rms_norm(y, self.norm_weight, cfg.rms_norm_eps) * F.silu(z.float())
        out = q_linear(normed.reshape(b, s, cfg.value_dim).to(x.dtype), self.out_proj)
        return out, new_conv_state, new_rec_state


# -- full attention with MRoPE and the output gate ---------------------------------------


def mrope_cos_sin(cfg: Qwen35TextConfig, position_ids: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Interleaved 3-section MRoPE; position_ids [3, B, S] (t, h, w). Frequency
    i takes position axis ``i mod 3``. Returns cos / sin [B, S, rotary_dim]
    in the HF two-half layout."""
    half = cfg.rotary_dim // 2
    dev = position_ids.device
    inv_freq = 1.0 / cfg.rope_theta ** (2.0 * torch.arange(half, dtype=torch.float32, device=dev) / cfg.rotary_dim)
    freqs = position_ids.float()[..., None] * inv_freq  # [3, B, S, half]
    axis = torch.arange(half, device=dev) % 3
    sel = torch.gather(freqs.permute(1, 2, 3, 0), -1, axis.expand(*freqs.shape[1:3], half)[..., None])[..., 0]
    emb = torch.cat([sel, sel], dim=-1)
    return torch.cos(emb), torch.sin(emb)


def _apply_partial_rotary(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor, rotary_dim: int) -> torch.Tensor:
    """Rotate the first ``rotary_dim`` dims of x [B, H, S, D]; pass the rest through."""
    rot, rest = x[..., :rotary_dim], x[..., rotary_dim:]
    r = rot.float()
    out = r * cos[:, None] + _rotate_half(r) * sin[:, None]
    return torch.cat([out.to(x.dtype), rest], dim=-1)


class GatedAttention(nn.Module):
    def __init__(self, cfg: Qwen35TextConfig, device, dtype, generator):
        super().__init__()
        self.cfg = cfg
        h, hd = cfg.hidden_size, cfg.head_dim
        qd, kvd = cfg.num_attention_heads * hd, cfg.num_key_value_heads * hd
        self.q_proj = linear_weight(h, 2 * qd, device, dtype, generator)  # [q ; gate]
        self.k_proj = linear_weight(h, kvd, device, dtype, generator)
        self.v_proj = linear_weight(h, kvd, device, dtype, generator)
        self.o_proj = linear_weight(qd, h, device, dtype, generator)
        self.q_norm = ones_weight(hd, device, dtype)
        self.k_norm = ones_weight(hd, device, dtype)

    def _qkv_gate(self, x, position_ids):
        cfg = self.cfg
        b, s, _ = x.shape
        nh, nkv, hd = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
        q_and_gate = q_linear(x, self.q_proj).reshape(b, s, nh, 2 * hd)
        q, gate = q_and_gate[..., :hd], q_and_gate[..., hd:].reshape(b, s, nh * hd)
        k = q_linear(x, self.k_proj).reshape(b, s, nkv, hd)
        v = q_linear(x, self.v_proj).reshape(b, s, nkv, hd)
        q = rms_norm(q, self.q_norm, cfg.rms_norm_eps).transpose(1, 2)
        k = rms_norm(k, self.k_norm, cfg.rms_norm_eps).transpose(1, 2)
        cos, sin = mrope_cos_sin(cfg, position_ids)
        q = _apply_partial_rotary(q, cos, sin, cfg.rotary_dim)
        k = _apply_partial_rotary(k, cos, sin, cfg.rotary_dim)
        return q, k, v.transpose(1, 2), gate

    def _attend(self, q, k, v, gate, mask):
        cfg = self.cfg
        b, _, s, hd = q.shape
        rep = cfg.num_attention_heads // cfg.num_key_value_heads
        if rep > 1:
            k = k.repeat_interleave(rep, dim=1)
            v = v.repeat_interleave(rep, dim=1)
        logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * hd**-0.5 + mask
        probs = torch.softmax(logits, dim=-1).to(v.dtype)
        attn = torch.matmul(probs, v).transpose(1, 2).reshape(b, s, -1)
        return q_linear(attn * torch.sigmoid(gate), self.o_proj)

    def forward(self, x: torch.Tensor, position_ids: torch.Tensor) -> torch.Tensor:
        s = x.shape[1]
        q, k, v, gate = self._qkv_gate(x, position_ids)
        causal = torch.tril(torch.ones(s, s, dtype=torch.bool, device=x.device))
        mask = torch.where(causal, 0.0, NEG_INF)[None, None]
        return self._attend(q, k, v, gate, mask)

    def forward_cached(self, x: torch.Tensor, position_ids: torch.Tensor, layer_cache: dict) -> torch.Tensor:
        """Prefill or step over a static-length KV cache, written in place at ``layer_cache["len"]``."""
        s = x.shape[1]
        q, k, v, gate = self._qkv_gate(x, position_ids)
        ck, cv, pos = layer_cache["k"], layer_cache["v"], layer_cache["len"]
        if pos + s > ck.shape[2]:
            raise ValueError(f"the KV cache is full ({ck.shape[2]} slots)")
        ck[:, :, pos:pos + s] = k.to(ck.dtype)
        cv[:, :, pos:pos + s] = v.to(cv.dtype)
        layer_cache["len"] = pos + s
        q_pos = pos + torch.arange(s, device=x.device)
        allowed = torch.arange(ck.shape[2], device=x.device)[None, :] <= q_pos[:, None]
        mask = torch.where(allowed, 0.0, NEG_INF)[None, None]
        return self._attend(q, ck, cv, gate, mask)


class Qwen35Layer(nn.Module):
    def __init__(self, cfg: Qwen35TextConfig, linear: bool, device, dtype, generator):
        super().__init__()
        h = cfg.hidden_size
        self.input_norm = ones_weight(h, device, dtype)
        self.post_attn_norm = ones_weight(h, device, dtype)
        if linear:
            self.linear_attn = GatedDeltaNet(cfg, device, dtype, generator)
        else:
            self.self_attn = GatedAttention(cfg, device, dtype, generator)
        self.gate_proj = linear_weight(h, cfg.intermediate_size, device, dtype, generator)
        self.up_proj = linear_weight(h, cfg.intermediate_size, device, dtype, generator)
        self.down_proj = linear_weight(cfg.intermediate_size, h, device, dtype, generator)

    def mlp(self, x: torch.Tensor, eps: float) -> torch.Tensor:
        h2 = rms_norm(x, self.post_attn_norm, eps)
        return x + q_linear(F.silu(q_linear(h2, self.gate_proj)) * q_linear(h2, self.up_proj), self.down_proj)


def text_position_ids(batch: int, seq: int, start: int = 0, device=None) -> torch.Tensor:
    """Text-only MRoPE ids: all three axes the token's absolute index. [3, B, S]."""
    pos = torch.arange(start, start + seq, device=device)[None].expand(batch, seq)
    return torch.stack([pos, pos, pos])


class Qwen35LM(nn.Module):
    """The hybrid language model: ``forward`` (final-normed hidden states),
    ``forward_logits`` and the streaming ``forward_cached``."""

    def __init__(self, cfg: Qwen35TextConfig = TINY_QWEN35, device: "torch.device | str" = "cpu",
                 dtype: torch.dtype = torch.bfloat16, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        self.layers = nn.ModuleList(Qwen35Layer(cfg, cfg.is_linear_layer(i), device, dtype, generator)
                                    for i in range(cfg.num_hidden_layers))
        emb = torch.empty(cfg.vocab_size, cfg.hidden_size, device=device, dtype=dtype)
        if generator is not None:
            emb.normal_(generator=generator).mul_(0.02)
        self.embed_tokens = nn.Parameter(emb, requires_grad=False)
        self.final_norm = ones_weight(cfg.hidden_size, device, dtype)

    @classmethod
    def from_random(cls, cfg: Qwen35TextConfig, device: "torch.device | str" = "cuda",
                    generator: Optional[torch.Generator] = None, dtype: torch.dtype = torch.bfloat16):
        device = torch.device(device)
        return cls(cfg, device, dtype, generator or torch.Generator(device=device).manual_seed(0))

    def forward(self, input_ids: torch.Tensor, position_ids: Optional[torch.Tensor] = None,
                inputs_embeds: Optional[torch.Tensor] = None) -> torch.Tensor:
        """[B, S] -> final-normed hidden states [B, S, H]; ``inputs_embeds``
        (vision-merged) replaces the token embeddings."""
        cfg = self.cfg
        b, s = input_ids.shape
        x = inputs_embeds if inputs_embeds is not None else self.embed_tokens[input_ids]
        if position_ids is None:
            position_ids = text_position_ids(b, s, device=x.device)
        for layer in self.layers:
            h = rms_norm(x, layer.input_norm, cfg.rms_norm_eps)
            if hasattr(layer, "linear_attn"):
                attn = layer.linear_attn(h)[0]
            else:
                attn = layer.self_attn(h, position_ids)
            x = layer.mlp(x + attn, cfg.rms_norm_eps)
        return rms_norm(x, self.final_norm, cfg.rms_norm_eps)

    def logits(self, h: torch.Tensor) -> torch.Tensor:
        """Tied vocabulary projection, float32."""
        return q_linear(h, self.embed_tokens).float()

    def forward_logits(self, input_ids: torch.Tensor, **kw) -> torch.Tensor:
        return self.logits(self.forward(input_ids, **kw))

    def forward_cached(self, input_ids: torch.Tensor, cache: List[dict], start_pos: int,
                       inputs_embeds: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, List[dict]]:
        """Prefill (S > 1) or a decode step (S = 1) from absolute position
        ``start_pos`` (text-only MRoPE ids), updating ``cache`` in place;
        returns the last token's logits [B, V] and the cache."""
        cfg = self.cfg
        b, s = input_ids.shape
        x = inputs_embeds if inputs_embeds is not None else self.embed_tokens[input_ids]
        position_ids = text_position_ids(b, s, start_pos, device=x.device)
        for layer, lc in zip(self.layers, cache):
            h = rms_norm(x, layer.input_norm, cfg.rms_norm_eps)
            if hasattr(layer, "linear_attn"):
                attn, lc["conv"], lc["rec"] = layer.linear_attn(h, conv_state=lc["conv"], rec_state=lc["rec"])
            else:
                attn = layer.self_attn.forward_cached(h, position_ids, lc)
            x = layer.mlp(x + attn, cfg.rms_norm_eps)
        return self.logits(rms_norm(x[:, -1], self.final_norm, cfg.rms_norm_eps)), cache


def init_hybrid_cache(cfg: Qwen35TextConfig, batch: int, max_len: int, dtype: torch.dtype = torch.float32,
                      device: "torch.device | str" = "cpu") -> List[dict]:
    """One dict a layer: DeltaNet layers {"conv" [B, K-1, conv_dim], "rec"
    [B, Hv, Dv, Dk] float32}, full layers {"k", "v" [B, kv_heads, max_len,
    head_dim], "len"}. ``dtype`` (float32 by default, as JAX's) is the conv
    state's and the KV cache's."""
    cache = []
    for i in range(cfg.num_hidden_layers):
        if cfg.is_linear_layer(i):
            cache.append({
                "conv": torch.zeros(batch, cfg.linear_conv_kernel_dim - 1, cfg.conv_dim, dtype=dtype, device=device),
                "rec": torch.zeros(batch, cfg.linear_num_value_heads, cfg.linear_value_head_dim,
                                   cfg.linear_key_head_dim, dtype=torch.float32, device=device)})
        else:
            shape = (batch, cfg.num_key_value_heads, max_len, cfg.head_dim)
            cache.append({"k": torch.zeros(shape, dtype=dtype, device=device),
                          "v": torch.zeros(shape, dtype=dtype, device=device), "len": 0})
    return cache
