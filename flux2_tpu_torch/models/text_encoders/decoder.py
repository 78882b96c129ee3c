"""The generic causal GQA decoder (Qwen3 and Mistral Small 3.2) as a PyTorch module.

Port of ``flux2_tpu/models/text_encoders/decoder.py``: per-head qk-RMSNorm
before RoPE (Qwen3), Llama-4 query scaling ``1 + beta * log1p(floor(pos /
original_max))`` applied to q after RoPE (Mistral), the HF half-split LLM
RoPE (not the DiT's interleaved pairs), grouped-query attention with an
additive mask (finite ``NEG_INF``, so a fully masked row never turns NaN),
``forward_hidden_states`` / ``extract_hidden_layers`` (the conditioning
path), ``final_norm`` and the LM head (tied to ``embed_tokens`` or not),
``forward_logits``, and generation over a preallocated KV cache:
``init_kv_cache``, ``prefill`` (also from ``inputs_embeds``) and
``decode_step``. As in JAX the cache has a static ``max_len`` and a step
attends to every slot ``<= pos`` through the mask; the port writes the new
keys and values into the cache in place, where JAX returns a new cache.
The attention is plain torch with float32 logits, as in JAX (an einsum
there, no Pallas). Every layer matmul and the untied head go through
``q_linear`` (JAX's ``mm``), so they may be quantized
(``extractor.quantize_encoder_params`` quantizes the layers only).

Sharded under DECODER_RULES (``parallel.sharding.shard_params``, which sets
``self.mesh``), ``forward_hidden_states`` takes plain ids and returns a
DTensor: the token table is vocab-parallel (``F.embedding`` of a
vocab-sharded DTensor), the projections are partitioned in ``q_linear``, and
the attention runs on each rank's local heads under ``local_map``. Where
``k_proj`` / ``v_proj`` stay whole but ``q_proj`` is split over tp (the KV
width does not divide), each local query head still meets its KV head: the
KV head is indexed by the *global* query head. The cached generation path
(``prefill``, ``decode_step``) runs unsharded decoders only.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from flux2_tpu_torch.models.text_encoders.config import DecoderConfig
from flux2_tpu_torch.models.flux2.transformer import linear_weight, ones_weight
from flux2_tpu_torch.ops.normalization import rms_norm
from flux2_tpu_torch.ops.quant import q_linear
from flux2_tpu_torch.parallel.sharding import on_head_boundaries, replicate, unshard_last

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


def llama4_attention_scale(positions: torch.Tensor, beta: float, original_max: int) -> torch.Tensor:
    """1 + beta * log(1 + floor(pos / original_max)), f32: [S] -> [S, 1]."""
    floored = torch.floor(positions.to(torch.float32) / original_max)
    return (1.0 + beta * torch.log1p(floored))[:, None]


def causal_padding_mask(attention_mask: torch.Tensor, s: int) -> torch.Tensor:
    """Additive f32 mask [B, 1, S, S]: causal + key-side padding."""
    causal = torch.tril(torch.ones(s, s, dtype=torch.bool, device=attention_mask.device))
    allowed = causal[None, None] & (attention_mask[:, None, None, :] > 0)
    return torch.where(allowed, 0.0, NEG_INF).to(torch.float32)


@dataclasses.dataclass
class KVCache:
    """Static-length KV cache [L, B, kv_heads, max_len, head_dim] and the
    number of slots filled (JAX's ``KVCache``, updated in place)."""

    k: torch.Tensor
    v: torch.Tensor
    length: int = 0

    @property
    def max_len(self) -> int:
        return self.k.shape[3]


def init_kv_cache(cfg: DecoderConfig, batch: int, max_len: int, dtype: torch.dtype = torch.bfloat16,
                  device: "torch.device | str" = "cpu") -> KVCache:
    shape = (cfg.num_hidden_layers, batch, cfg.num_key_value_heads, max_len, cfg.head_dim)
    return KVCache(torch.zeros(shape, dtype=dtype, device=device), torch.zeros(shape, dtype=dtype, device=device))


def _heads(x: torch.Tensor, n: int, hd: int) -> torch.Tensor:
    """[B, S, n*hd] -> [B, n, S, hd] (a sharded x split on head boundaries)."""
    x = on_head_boundaries(x, n)
    b, s, _ = x.shape
    return x.reshape(b, s, n, hd).transpose(1, 2)


def _attend(q, k, v, mask, rep: int, hd: int, q_start: int = 0, kv_start: int = 0) -> torch.Tensor:
    """GQA of query heads ``q_start..`` over KV heads ``kv_start..``: query
    head j reads KV head (q_start + j) // rep, as the whole model's
    ``repeat_interleave`` gives it."""
    if rep > 1 or q_start or kv_start:
        idx = (torch.arange(q.shape[1], device=q.device) + q_start) // rep - kv_start
        k, v = k[:, idx], v[:, idx]
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * (hd**-0.5) + mask
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.matmul(probs, v)


def _gqa_attention(q, k, v, mask, rep: int, hd: int) -> torch.Tensor:
    """``_attend``, on each rank's local heads when q/k/v are DTensors."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    if not isinstance(q, DTensor):
        return _attend(q, k, v, mask, rep, hd)
    mesh = q.device_mesh

    def heads_only(t):
        return [p if isinstance(p, Shard) and p.dim == 1 else Replicate() for p in t.placements]

    def start(places, n_local):
        """The global index of this rank's first head."""
        i = next((i for i, p in enumerate(places) if isinstance(p, Shard)), None)
        return 0 if i is None else mesh.get_local_rank(i) * n_local

    qp, kp = heads_only(q), heads_only(k)

    def body(q_loc, k_loc, v_loc, m):
        return _attend(q_loc, k_loc, v_loc, m, rep, hd, start(qp, q_loc.shape[1]), start(kp, k_loc.shape[1]))

    fn = local_map(body, out_placements=qp, in_placements=(qp, kp, kp, [Replicate()] * mesh.ndim),
                   device_mesh=mesh, redistribute_inputs=True)
    return fn(q, k, v, replicate(mask, mesh))


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

    def forward(self, x, cos, sin, mask, q_scale=None, cache_kv=None, cache_pos: int = 0) -> torch.Tensor:
        """One layer over x [B, S, H]. With ``cache_kv`` (this layer's [B, kv,
        max_len, hd] slices) the new keys and values are written at
        ``cache_pos`` and the attention reads the whole cache."""
        cfg = self.cfg
        b, s, _ = x.shape
        nh, nkv, hd = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
        h = rms_norm(x, self.input_norm, cfg.rms_norm_eps)
        q = _heads(q_linear(h, self.q_proj), nh, hd)
        k = _heads(q_linear(h, self.k_proj), nkv, hd)
        v = _heads(q_linear(h, self.v_proj), nkv, hd)
        if cfg.qk_norm:
            q = rms_norm(q, self.q_norm, cfg.rms_norm_eps)
            k = rms_norm(k, self.k_norm, cfg.rms_norm_eps)
        q = apply_llm_rope(q, cos, sin)
        k = apply_llm_rope(k, cos, sin)
        if q_scale is not None:
            q = q * q_scale.to(q.dtype)
        if cache_kv is not None:
            ck, cv = cache_kv
            ck[:, :, cache_pos:cache_pos + s] = k
            cv[:, :, cache_pos:cache_pos + s] = v
            k, v = ck, cv
        attn = _gqa_attention(q, k, v, mask, nh // nkv, hd).transpose(1, 2).reshape(b, s, nh * hd)
        x = x + unshard_last(q_linear(attn, self.o_proj))
        h2 = rms_norm(x, self.post_attn_norm, cfg.rms_norm_eps)
        mlp = q_linear(F.silu(q_linear(h2, self.gate_proj)) * q_linear(h2, self.up_proj), self.down_proj)
        return x + unshard_last(mlp)


class Qwen3Decoder(nn.Module):
    """Token ids -> hidden states of every layer (the conditioning encoder),
    logits, and KV-cached generation. Despite its name it is the generic
    decoder: a config with ``llama4_scaling_beta`` is Mistral's."""

    mesh = None  # the DeviceMesh its weights are sharded over (``parallel.sharding.shard_params``)

    def __init__(
        self,
        cfg: DecoderConfig,
        device: "torch.device | str" = "cpu",
        dtype: torch.dtype = torch.bfloat16,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.cfg = cfg
        emb = torch.empty(cfg.vocab_size, cfg.hidden_size, device=device, dtype=dtype)
        if generator is not None:
            emb.normal_(generator=generator).mul_(0.02)
        self.embed_tokens = nn.Parameter(emb, requires_grad=False)
        self.layers = nn.ModuleList(
            DecoderLayer(cfg, device, dtype, generator) for _ in range(cfg.num_hidden_layers)
        )
        self.final_norm = ones_weight(cfg.hidden_size, device, dtype)
        if not cfg.tie_word_embeddings:  # drawn last, as JAX's init_params draws it
            self.lm_head = linear_weight(cfg.hidden_size, cfg.vocab_size, device, dtype, generator)

    def _embed(self, ids: torch.Tensor) -> torch.Tensor:
        """Token embeddings; a sharded table is looked up vocab-parallel and
        the result made whole on every rank."""
        if self.mesh is None:
            return self.embed_tokens[ids]
        from torch.distributed.tensor import Replicate

        out = F.embedding(replicate(ids, self.mesh), self.embed_tokens)
        return out.redistribute(self.mesh, [Replicate()] * self.mesh.ndim)

    def _require_unsharded(self, what: str) -> None:
        if self.mesh is not None:
            raise NotImplementedError(f"{what} runs unsharded decoders only; this one is sharded over {self.mesh}")

    def _q_scale(self, positions: torch.Tensor) -> Optional[torch.Tensor]:
        cfg = self.cfg
        if cfg.llama4_scaling_beta is None:
            return None
        return llama4_attention_scale(positions, cfg.llama4_scaling_beta, cfg.original_max_position_embeddings)

    def forward_hidden_states(self, input_ids: torch.Tensor, attention_mask: torch.Tensor,
                              inputs_embeds: Optional[torch.Tensor] = None) -> torch.Tensor:
        """[B, S] ids and mask (1 = token, 0 = pad) -> ALL hidden states
        [L+1, B, S, H]; index 0 is the embedding output, i >= 1 layer i's output.
        ``inputs_embeds`` [B, S, H] replaces the token embeddings (VLM merge)."""
        s = input_ids.shape[1]
        x = inputs_embeds if inputs_embeds is not None else self._embed(input_ids)
        # absolute positions 0..S-1 whatever the padding, as the JAX package
        positions = torch.arange(s, device=x.device)
        cos, sin = llm_rope_cos_sin(positions, self.cfg.head_dim, self.cfg.rope_theta)
        mask = causal_padding_mask(attention_mask, s)
        q_scale = self._q_scale(positions)
        x, cos, sin, mask, q_scale = (replicate(t, self.mesh) for t in (x, cos, sin, mask, q_scale))
        states = [x]
        for layer in self.layers:
            x = layer(x, cos, sin, mask, q_scale)
            states.append(x)
        return torch.stack(states)

    def extract_hidden_layers(
        self, input_ids: torch.Tensor, attention_mask: torch.Tensor, layer_indices: Sequence[int]
    ) -> torch.Tensor:
        """Concatenate the given hidden-state layers along features: [B, S, len * H].
        All layers run, as in JAX."""
        hs = self.forward_hidden_states(input_ids, attention_mask)
        return torch.cat([hs[i] for i in layer_indices], dim=-1)

    def logits(self, h: torch.Tensor) -> torch.Tensor:
        """Vocabulary projection of final-normed states, float32 (JAX ``_logits``)."""
        if self.cfg.tie_word_embeddings:
            return F.linear(h, self.embed_tokens).float()
        return q_linear(h, self.lm_head).float()

    def forward_logits(self, input_ids: torch.Tensor, attention_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Full forward to vocabulary logits [B, S, V] float32."""
        if attention_mask is None:
            attention_mask = torch.ones_like(input_ids)
        hs = self.forward_hidden_states(input_ids, attention_mask)
        return self.logits(rms_norm(hs[-1], self.final_norm, self.cfg.rms_norm_eps))

    def _cached(self, x: torch.Tensor, positions: torch.Tensor, mask: torch.Tensor, cache: KVCache) -> torch.Tensor:
        """Every layer over x [B, S, H] at ``positions``, writing the cache from
        slot ``positions[0]``; returns the last token's logits [B, V]."""
        cos, sin = llm_rope_cos_sin(positions, self.cfg.head_dim, self.cfg.rope_theta)
        q_scale = self._q_scale(positions)
        pos = cache.length
        for i, layer in enumerate(self.layers):
            x = layer(x, cos, sin, mask, q_scale, cache_kv=(cache.k[i], cache.v[i]), cache_pos=pos)
        cache.length = pos + x.shape[1]
        return self.logits(rms_norm(x[:, -1], self.final_norm, self.cfg.rms_norm_eps))

    def prefill(self, input_ids: torch.Tensor, cache: KVCache,
                inputs_embeds: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, KVCache]:
        """Fill an empty cache with a prompt [B, S] (or its ``inputs_embeds``,
        VLM image-token splicing); returns the last token's logits [B, V]
        and the cache, ``length`` S."""
        self._require_unsharded("prefill")
        if cache.length:
            raise ValueError(f"prefill takes an empty cache, this one holds {cache.length} slots")
        s = input_ids.shape[1]
        x = inputs_embeds if inputs_embeds is not None else self.embed_tokens[input_ids]
        positions = torch.arange(s, device=x.device)
        key_idx = torch.arange(cache.max_len, device=x.device)
        mask = torch.where(positions[:, None] >= key_idx[None, :], 0.0, NEG_INF).to(torch.float32)
        return self._cached(x, positions, mask[None, None], cache), cache

    def decode_step(self, token: torch.Tensor, cache: KVCache) -> Tuple[torch.Tensor, KVCache]:
        """One token [B, 1] at position ``cache.length``, attending to the cache
        slots ``<= pos``; returns its logits [B, V] and the cache, one longer."""
        self._require_unsharded("decode_step")
        pos = cache.length
        if pos >= cache.max_len:
            raise ValueError(f"the KV cache is full ({cache.max_len} slots)")
        x = self.embed_tokens[token]
        positions = torch.full((1,), pos, device=x.device, dtype=torch.long)
        key_idx = torch.arange(cache.max_len, device=x.device)
        mask = torch.where(key_idx <= pos, 0.0, NEG_INF).to(torch.float32)
        return self._cached(x, positions, mask[None, None, None], cache), cache
