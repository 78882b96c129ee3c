"""FLUX.2 diffusion transformer (DiT) as a PyTorch module.

Port of ``flux2_tpu/models/flux2/transformer.py``: ``sinusoidal_embedding``,
``time_guidance_embedding``, the modulation projections, ``double_block``,
``single_block``, ``forward`` and ``_final``, with JAX's unmerged LoRA
(``_lmm``, ``forward(lora=, lora_scale=)``) and JAX's remat policies
(``remat=True`` / ``"block"``: ``torch.utils.checkpoint`` around each block;
``"dots"``: the same with a selective policy that keeps the 2-D products'
outputs, see ``_dots_policy``); and the
klein-9b-kv pair ``forward_kv_extract`` / ``forward_kv_cached``: step 0 runs
[txt ; ref ; img] with the reference queries blind to the output keys and
returns each block's post-RoPE reference K/V, steps 1+ run [txt ; img] with
that K/V inserted between the text and image keys.

Sharded (``parallel.sharding.shard_params(model, mesh, DIT_RULES)`` sets
``self.mesh``): the forwards take plain tensors that every rank holds alike,
make them ``Replicate()`` DTensors once (the sinusoids too: DTensor refuses
to mix plain tensors in), run the blocks on DTensors with every weight
product partitioned in ``q_linear`` and every attention on local heads
(``sdpa``), and return the velocity as a DTensor (``parallel.sharding.gather``
gives its value). A projection whose output joins the residual stream is
gathered whole on the feature axis (``_lmm(full=True)``), so the stream
stays replicated, or token-sharded under ``ring``. ``ring=(mesh, axis)``
(``forward``, ``forward_kv_cached``) runs every attention as ring attention
and pins the streams' token axis to ``axis`` between blocks (JAX's
``_seq_shard``); ``forward_kv_extract`` stays dense, since its blocked span
cannot ride the ring.

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
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor
from torch.utils.checkpoint import CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts

from flux2_tpu_torch.models.flux2.config import Flux2TransformerConfig
from flux2_tpu_torch.ops.attention import sdpa
from flux2_tpu_torch.ops.normalization import gate, layer_norm, modulate, rms_norm
from flux2_tpu_torch.ops.quant import q_linear
from flux2_tpu_torch.ops.rope import apply_rope
from flux2_tpu_torch.parallel.sharding import on_head_boundaries, replicate, seq_shard, unshard_last


def _dots_policy(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    """JAX's ``checkpoint_dots_with_no_batch_dims``: keep the outputs of the
    2-D products (aten ``mm`` / ``addmm``: ``F.linear`` and the LoRA's
    ``x @ a``, ``@ b``) for the backward and recompute everything else: the
    batched products (``bmm``), the attention (K2 on the card, the Pallas call
    inside JAX's remat), the elementwise glue, and the quantized routes'
    kernel launches, which no policy sees (as JAX's Pallas ``q_matmul`` is no
    dot)."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _dots_context():
    return create_selective_checkpoint_contexts(_dots_policy)


def linear_weight(d_in: int, d_out: int, device, dtype, generator: Optional[torch.Generator]) -> nn.Parameter:
    """[out, in] weight, N(0, 1) * d_in**-0.5 drawn in ``dtype`` (as JAX's ``_linear``);
    left uninitialised when ``generator`` is None (weights loaded after)."""
    w = torch.empty(d_out, d_in, device=device, dtype=dtype)
    if generator is not None:
        w.normal_(generator=generator).mul_(d_in**-0.5)
    return nn.Parameter(w, requires_grad=False)


def ones_weight(n: int, device, dtype) -> nn.Parameter:
    return nn.Parameter(torch.ones(n, device=device, dtype=dtype), requires_grad=False)


def param_count(*modules: nn.Module) -> int:
    """Elements of every parameter and buffer (a quantized weight's codes and
    scales: JAX's leaves) of ``modules``; ``vae.param_count`` too."""
    return sum(t.numel() for m in modules for t in (*m.parameters(), *m.buffers()))


def sinusoidal_embedding(t: torch.Tensor, num_channels: int = 256) -> torch.Tensor:
    """Diffusers-style timestep embedding, flip_sin_to_cos=True: [B] -> [B, C] f32."""
    half = num_channels // 2
    exponent = -math.log(10000.0) * torch.arange(half, dtype=torch.float32, device=t.device) / half
    args = t.to(torch.float32)[:, None] * torch.exp(exponent)[None, :]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def _heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """[B, S, H*D] -> contiguous [B, H, S, D] (a sharded x split on head boundaries)."""
    x = on_head_boundaries(x, num_heads)
    b, s, _ = x.shape
    return x.reshape(b, s, num_heads, -1).transpose(1, 2).contiguous()


def _unheads(x: torch.Tensor) -> torch.Tensor:
    """[B, H, S, D] -> [B, S, H*D]."""
    b, h, s, d = x.shape
    return x.transpose(1, 2).reshape(b, s, h * d)


def _lmm(x: torch.Tensor, w, lora: Optional[nn.ModuleDict], name: str, scale: float,
         full: bool = False) -> torch.Tensor:
    """Projection with an optional UNMERGED LoRA adapter (JAX ``_lmm``):
    y = x W^T + scale * ((x a) b), the adapter cast to x's dtype. The
    backward forms only [in, r] and [r, out] gradients, never a base-sized one.
    ``full``: a sharded output is gathered whole on the feature axis. Under
    a mesh the plain adapters enter as ``Replicate()`` DTensors on x's mesh
    (DTensor refuses to mix the two); their gradient is the unsharded one."""
    y = q_linear(x, w)
    if lora is not None and name in lora:
        ad = lora[name]
        a, b = ad.a.to(x.dtype), ad.b.to(x.dtype)
        if isinstance(x, DTensor):
            a, b = replicate(a, x.device_mesh), replicate(b, x.device_mesh)
        y = y + ((x @ a) @ b) * scale
    return unshard_last(y) if full else y


def _swiglu(x, bp, w_in: str, w_out: str, lora, scale) -> torch.Tensor:
    g, v = _lmm(x, getattr(bp, w_in), lora, w_in, scale).chunk(2, dim=-1)
    return _lmm(F.silu(g) * v, getattr(bp, w_out), lora, w_out, scale, full=True)


KV = Tuple[torch.Tensor, torch.Tensor]  # post-RoPE (k, v), [B, H, S, head_dim] each


def _extract(k: torch.Tensor, v: torch.Tensor, span: Optional[Tuple[int, int]]) -> Optional[KV]:
    """K/V of joint positions [start, start + length), copied so that the cache
    does not keep the whole sequence's K/V alive."""
    if span is None:
        return None
    start, length = span
    return k[:, :, start : start + length].contiguous(), v[:, :, start : start + length].contiguous()


def _insert(k: torch.Tensor, v: torch.Tensor, extra_kv: Optional[KV], at: int) -> KV:
    """K/V with the cached ``extra_kv`` put in after the first ``at`` positions."""
    if extra_kv is None:
        return k, v
    ck, cv = extra_kv
    return (torch.cat([k[:, :, :at], ck, k[:, :, at:]], dim=2), torch.cat([v[:, :, :at], cv, v[:, :, at:]], dim=2))


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
                lora_scale: float = 1.0, extra_kv: Optional[KV] = None,
                kv_extract_span: Optional[Tuple[int, int]] = None, blocked_span: Optional[Tuple[int, int, int]] = None,
                ring: Optional[tuple] = None):
        """(img, txt), and with ``kv_extract_span=(start, length)`` also the
        post-RoPE K/V of those joint positions, taken before ``extra_kv`` (cached
        post-RoPE reference K/V) is inserted between the text and image keys.
        ``ring=(mesh, axis)``: ring attention."""
        nh = self.num_heads
        s_txt = txt.shape[1]
        img_n = modulate(layer_norm(img), img_mod[:, 0, 0], img_mod[:, 0, 1])
        txt_n = modulate(layer_norm(txt), txt_mod[:, 0, 0], txt_mod[:, 0, 1])

        def proj(x, name, full=False):
            return _lmm(x, getattr(self, name), lora, name, lora_scale, full)

        q_img = rms_norm(_heads(proj(img_n, "to_q"), nh), self.norm_q)
        k_img = rms_norm(_heads(proj(img_n, "to_k"), nh), self.norm_k)
        v_img = _heads(proj(img_n, "to_v"), nh)
        q_txt = rms_norm(_heads(proj(txt_n, "add_q"), nh), self.norm_added_q)
        k_txt = rms_norm(_heads(proj(txt_n, "add_k"), nh), self.norm_added_k)
        v_txt = _heads(proj(txt_n, "add_v"), nh)

        q = apply_rope(torch.cat([q_txt, q_img], dim=2), rope_cos, rope_sin)
        k = apply_rope(torch.cat([k_txt, k_img], dim=2), rope_cos, rope_sin)
        v = torch.cat([v_txt, v_img], dim=2)
        extracted = _extract(k, v, kv_extract_span)
        k, v = _insert(k, v, extra_kv, s_txt)
        attn = sdpa(q, k, v, blocked_span=blocked_span, ring=ring, bounded_logits=True)  # qk are RMS-normed above

        img = img + gate(proj(_unheads(attn[:, :, s_txt:]), "to_out", True), img_mod[:, 0, 2])
        txt = txt + gate(proj(_unheads(attn[:, :, :s_txt]), "add_out", True), txt_mod[:, 0, 2])

        img_n2 = modulate(layer_norm(img), img_mod[:, 1, 0], img_mod[:, 1, 1])
        txt_n2 = modulate(layer_norm(txt), txt_mod[:, 1, 0], txt_mod[:, 1, 1])
        img = img + gate(_swiglu(img_n2, self, "ff_in", "ff_out", lora, lora_scale), img_mod[:, 1, 2])
        txt = txt + gate(_swiglu(txt_n2, self, "ff_ctx_in", "ff_ctx_out", lora, lora_scale), txt_mod[:, 1, 2])
        if kv_extract_span is not None:
            return img, txt, extracted
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

    def forward(self, x, mod, rope_cos, rope_sin, lora: Optional[nn.ModuleDict] = None, lora_scale: float = 1.0,
                extra_kv: Optional[KV] = None, txt_len: int = 0, kv_extract_span: Optional[Tuple[int, int]] = None,
                blocked_span: Optional[Tuple[int, int, int]] = None, ring: Optional[tuple] = None):
        """x, and with ``kv_extract_span`` also the extracted K/V (as ``DoubleBlock``);
        ``extra_kv`` goes in after the first ``txt_len`` keys."""
        nh = self.num_heads

        def proj(x, name, full=False):
            return _lmm(x, getattr(self, name), lora, name, lora_scale, full)

        x_n = modulate(layer_norm(x), mod[:, 0, 0], mod[:, 0, 1])
        q = apply_rope(rms_norm(_heads(proj(x_n, "to_q"), nh), self.norm_q), rope_cos, rope_sin)
        k = apply_rope(rms_norm(_heads(proj(x_n, "to_k"), nh), self.norm_k), rope_cos, rope_sin)
        v = _heads(proj(x_n, "to_v"), nh)
        extracted = _extract(k, v, kv_extract_span)
        k, v = _insert(k, v, extra_kv, txt_len)
        attn = _unheads(sdpa(q, k, v, blocked_span=blocked_span, ring=ring, bounded_logits=True))  # qk RMS-normed
        mlp = F.silu(proj(x_n, "mlp_gate")) * proj(x_n, "mlp_up")
        out = proj(attn, "out_attn", True) + proj(mlp, "out_mlp", True)
        res = x + gate(out, mod[:, 0, 2])
        if kv_extract_span is not None:
            return res, extracted
        return res


def run_block(block: nn.Module, *args, remat: "bool | str" = False, lora: Optional[nn.ModuleDict] = None,
              lora_scale: float = 1.0, ring: Optional[tuple] = None):
    """One block under ``remat`` (JAX ``_remat_wrap``): False runs it; True /
    "block" recomputes it in the backward (``torch.utils.checkpoint``,
    non-reentrant); "dots" recomputes all but its 2-D products."""
    kw = {"lora": lora, "lora_scale": lora_scale, "ring": ring}
    if remat == "dots":
        return checkpoint(block, *args, use_reentrant=False, context_fn=_dots_context, **kw)
    if remat:
        return checkpoint(block, *args, use_reentrant=False, **kw)
    return block(*args, **kw)


class Flux2Transformer(nn.Module):
    """The FLUX.2 DiT: [B, S_img, 128] latents + [B, S_txt, joint] text -> velocity."""

    mesh = None  # the DeviceMesh its weights are sharded over (``parallel.sharding.shard_params``)

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
        t = replicate(sinusoidal_embedding(timestep * 1000.0, tc), self.mesh)
        temb = self._mlp_embed(t, self.time_linear1, self.time_linear2)
        if self.config.guidance_embeds and guidance is not None:
            g = replicate(sinusoidal_embedding(guidance * 1000.0, tc), self.mesh)
            temb = temb + self._mlp_embed(g, self.guidance_linear1, self.guidance_linear2)
        return unshard_last(temb)

    @staticmethod
    def _modulation(weight: torch.Tensor, temb: torch.Tensor, num_sets: int) -> torch.Tensor:
        """linear(silu(temb)) -> [B, num_sets, 3, D] of (shift, scale, gate)."""
        out = unshard_last(q_linear(F.silu(temb), weight))
        return out.reshape(out.shape[0], num_sets, 3, -1)

    def _inputs(self, *tensors):
        """The forward's tensor inputs as ``Replicate()`` DTensors when sharded
        (rope tables in float32)."""
        return [replicate(t, self.mesh) for t in tensors]

    def _prelude(self, hidden_states, encoder_hidden_states, timestep, guidance, ring=None):
        """Embedded image and text streams, the time embedding and the three
        modulations (JAX ``_prelude``); the streams' token axis on the ring's
        mesh axis under ``ring``."""
        hidden_states, encoder_hidden_states = self._inputs(hidden_states, encoder_hidden_states)
        img = seq_shard(unshard_last(q_linear(hidden_states, self.x_embedder)), ring)
        # a quantized context embedder takes the stream's dtype (JAX: hidden_states')
        ctx_w = self.context_embedder
        ctx_dtype = ctx_w.dtype if isinstance(ctx_w, torch.Tensor) else hidden_states.dtype
        txt = seq_shard(unshard_last(q_linear(encoder_hidden_states.to(ctx_dtype), ctx_w)), ring)
        # back to the stream dtype when a quantized time embedding left it f32
        temb = self.time_guidance_embedding(timestep, guidance).to(img.dtype)
        img_mod = self._modulation(self.double_mod_img, temb, 2)
        txt_mod = self._modulation(self.double_mod_txt, temb, 2)
        single_mod = self._modulation(self.single_mod, temb, 1)
        return img, txt, temb, img_mod, txt_mod, single_mod

    def _final(self, temb: torch.Tensor, img: torch.Tensor) -> torch.Tensor:
        """AdaLN-continuous out: (scale, shift) in diffusers order, then proj_out."""
        scale, shift = unshard_last(q_linear(F.silu(temb), self.norm_out)).chunk(2, dim=-1)
        return unshard_last(q_linear(modulate(layer_norm(img), shift, scale), self.proj_out))

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
        ring: Optional[tuple] = None,
    ) -> torch.Tensor:
        """Velocity [B, S_img, 128]. ``remat``: False; True / "block" to
        recompute each block in the backward (``torch.utils.checkpoint``,
        non-reentrant; JAX ``_remat_wrap``); "dots" to recompute each block
        but its 2-D products (``_dots_policy``). ``lora`` adds the unmerged
        adapters scaled by ``lora_scale``. ``ring=(mesh, axis)``: ring
        attention in every block, the token axis sharded over ``axis``."""
        if remat not in (False, True, "block", "dots"):
            raise ValueError(f"remat={remat!r}: choose False, True, 'block' or 'dots'")
        s_txt = encoder_hidden_states.shape[1]
        img, txt, temb, img_mod, txt_mod, single_mod = self._prelude(hidden_states, encoder_hidden_states, timestep,
                                                                     guidance, ring)
        rope_cos, rope_sin = self._inputs(rope_cos.to(torch.float32), rope_sin.to(torch.float32))

        kw = {"remat": remat, "lora_scale": lora_scale, "ring": ring}
        for i, block in enumerate(self.double_blocks):
            lb = lora.block("double_blocks", i) if lora is not None else None
            img, txt = run_block(block, img, txt, img_mod, txt_mod, rope_cos, rope_sin, lora=lb, **kw)
            img, txt = seq_shard(img, ring), seq_shard(txt, ring)
        x = seq_shard(torch.cat([txt, img], dim=1), ring)
        for i, block in enumerate(self.single_blocks):
            lb = lora.block("single_blocks", i) if lora is not None else None
            x = seq_shard(run_block(block, x, single_mod, rope_cos, rope_sin, lora=lb, **kw), ring)
        return seq_shard(self._final(temb, x[:, s_txt:]), ring)

    def forward_kv_extract(
        self,
        hidden_states: torch.Tensor,  # [B, S_img, 128] output tokens
        reference_hidden_states: torch.Tensor,  # [B, S_ref, 128] clean reference tokens
        encoder_hidden_states: torch.Tensor,  # [B, S_txt, joint]
        timestep: torch.Tensor,
        rope_cos: torch.Tensor,  # [S_txt + S_ref + S_img, head_dim], ids in [txt ; ref ; img] order
        rope_sin: torch.Tensor,
        guidance: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, List[KV], List[KV]]:
        """Step 0 of KV-cached denoising (JAX ``forward_kv_extract``): the joint
        sequence is [txt ; ref ; img], and the reference queries see no output
        key (blocked span (s_txt, s_txt + s_ref, s_txt + s_ref), which the
        kernel applies in-tile), so their K/V do not depend on the output
        latents. Returns (velocity [B, S_img, 128], the double blocks' and the
        single blocks' post-RoPE reference (k, v), [B, H, S_ref, head_dim] each)."""
        s_txt = encoder_hidden_states.shape[1]
        s_ref = reference_hidden_states.shape[1]
        img, txt, temb, img_mod, txt_mod, single_mod = self._prelude(hidden_states, encoder_hidden_states, timestep,
                                                                     guidance)
        (reference_hidden_states,) = self._inputs(reference_hidden_states)
        ref = unshard_last(q_linear(reference_hidden_states, self.x_embedder))
        img = torch.cat([ref, img], dim=1)  # image stream = [ref ; img]
        blocked = (s_txt, s_txt + s_ref, s_txt + s_ref)
        span = (s_txt, s_ref)
        rope_cos, rope_sin = self._inputs(rope_cos.to(torch.float32), rope_sin.to(torch.float32))
        double_kv, single_kv = [], []
        for block in self.double_blocks:
            img, txt, kv = block(img, txt, img_mod, txt_mod, rope_cos, rope_sin, blocked_span=blocked,
                                 kv_extract_span=span)
            double_kv.append(kv)
        x = torch.cat([txt, img], dim=1)
        for block in self.single_blocks:
            x, kv = block(x, single_mod, rope_cos, rope_sin, blocked_span=blocked, kv_extract_span=span)
            single_kv.append(kv)
        return self._final(temb, x[:, s_txt + s_ref :]), double_kv, single_kv

    def forward_kv_cached(
        self,
        hidden_states: torch.Tensor,  # [B, S_img, 128]
        encoder_hidden_states: torch.Tensor,
        timestep: torch.Tensor,
        rope_cos: torch.Tensor,  # [S_txt + S_img, head_dim], ids in [txt ; img] order (no reference)
        rope_sin: torch.Tensor,
        double_kv: List[KV],
        single_kv: List[KV],
        guidance: Optional[torch.Tensor] = None,
        ring: Optional[tuple] = None,
    ) -> torch.Tensor:
        """Steps 1+ of KV-cached denoising (JAX ``forward_kv_cached``): only
        [txt ; img] runs through the network; each attention takes the cached
        reference K/V between the text and image keys (S_q = S_txt + S_img
        queries over S_k = S_q + S_ref keys). Velocity [B, S_img, 128].
        ``ring``: the [txt ; img] queries ride the ring against the rotating
        [txt ; cached ref ; img] K/V."""
        s_txt = encoder_hidden_states.shape[1]
        img, txt, temb, img_mod, txt_mod, single_mod = self._prelude(hidden_states, encoder_hidden_states, timestep,
                                                                     guidance, ring)
        rope_cos, rope_sin = self._inputs(rope_cos.to(torch.float32), rope_sin.to(torch.float32))
        for block, kv in zip(self.double_blocks, double_kv, strict=True):
            img, txt = block(img, txt, img_mod, txt_mod, rope_cos, rope_sin, extra_kv=kv, ring=ring)
            img, txt = seq_shard(img, ring), seq_shard(txt, ring)
        x = seq_shard(torch.cat([txt, img], dim=1), ring)
        for block, kv in zip(self.single_blocks, single_kv, strict=True):
            x = seq_shard(block(x, single_mod, rope_cos, rope_sin, extra_kv=kv, txt_len=s_txt, ring=ring), ring)
        return seq_shard(self._final(temb, x[:, s_txt:]), ring)
