"""Plain reference of the FLUX.2 DiT forward, float32, on the Diffusers
``Flux2Transformer2DModel`` checkpoint names (``benchmark/weights.py``).

Joint sequence [txt ; img]; 4-axis RoPE (T, H, W, L) of 32 dims each, theta
2000, consecutive pairs rotated; qk RMSNorm (eps 1e-6) before RoPE; affine-
free LayerNorm (eps 1e-6) with AdaLN (x * (1 + scale) + shift) and gates
from the shared modulation projections, laid out [set][shift, scale, gate];
double-stream blocks, then single-stream blocks whose one input projection
gives [q | k | v | mlp gate | mlp up] and whose one output projection takes
[attention | mlp]; the output AdaLN's projection gives [scale | shift].
Each block's weights are upcast alone, when the block runs.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F


def position_ids(s_txt: int, height: int, width: int) -> np.ndarray:
    """[txt ; img] ids (T, H, W, L): text (0, 0, 0, l); image (0, row, col, 0)."""
    nh, nw = height // 16, width // 16
    txt = np.zeros((s_txt, 4), np.int64)
    txt[:, 3] = np.arange(s_txt)
    rows, cols = np.meshgrid(np.arange(nh), np.arange(nw), indexing="ij")
    img = np.zeros((nh * nw, 4), np.int64)
    img[:, 1], img[:, 2] = rows.reshape(-1), cols.reshape(-1)
    return np.concatenate([txt, img])


def rope_tables(ids: np.ndarray, axes=(32, 32, 32, 32), theta: float = 2000.0, device="cpu"):
    """cos, sin [S, sum(axes)] float32, each frequency repeated for its pair."""
    cos, sin = [], []
    for a, dim in enumerate(axes):
        inv = theta ** -(np.arange(0, dim, 2, dtype=np.float64) / dim)
        ang = ids[:, a:a + 1].astype(np.float64) * inv[None]
        cos.append(np.repeat(np.cos(ang), 2, axis=1))
        sin.append(np.repeat(np.sin(ang), 2, axis=1))
    return (torch.tensor(np.concatenate(cos, 1), dtype=torch.float32, device=device),
            torch.tensor(np.concatenate(sin, 1), dtype=torch.float32, device=device))


def _rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    pairs = x.view(*x.shape[:-1], -1, 2)
    rot = torch.stack([-pairs[..., 1], pairs[..., 0]], dim=-1).view(x.shape)
    return x * cos + rot * sin


def _ln(x: torch.Tensor) -> torch.Tensor:
    return F.layer_norm(x, x.shape[-1:], eps=1e-6)


def _rms(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + 1e-6) * w


def _heads(x: torch.Tensor, n: int) -> torch.Tensor:
    b, s, _ = x.shape
    return x.view(b, s, n, -1).transpose(1, 2)


def _id(x):
    return x


def fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 (largest magnitude 448) under a per-tensor scale."""
    scale = x.abs().amax().clamp_min(1e-30) / 448.0
    return (x / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale


def _attention(q, k, v, r=_id) -> torch.Tensor:
    probs = torch.softmax(r(q) @ r(k).transpose(-1, -2) * q.shape[-1] ** -0.5, dim=-1)
    out = r(probs) @ r(v)
    b, h, s, d = out.shape
    return out.transpose(1, 2).reshape(b, s, h * d)


def timestep_sinusoid(sigma: torch.Tensor, channels: int = 256) -> torch.Tensor:
    """cos | sin of (1000 sigma) over ``channels / 2`` log-spaced frequencies."""
    half = channels // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(half, dtype=torch.float32, device=sigma.device) / half)
    ang = (sigma.float() * 1000.0)[:, None] * freqs[None]
    return torch.cat([ang.cos(), ang.sin()], dim=-1)


def _w(ckpt, key: str) -> torch.Tensor:
    return ckpt[key].float()


def _proj(x, w, lora, key, scale, r=_id):
    """x W^T, plus the unmerged adapter scale * (x a) b of ``lora[key]`` (a [in, r], b [r, out])."""
    y = r(x) @ r(w).T
    if lora is not None and key in lora:
        a, b = lora[key]
        y = y + scale * ((x @ a) @ b)
    return y


def velocity(ckpt, t: dict, x: torch.Tensor, ctx: torch.Tensor, sigma: torch.Tensor,
             cos: torch.Tensor, sin: torch.Tensor, lora=None, lora_scale: float = 1.0, wrap=None,
             fp8_control: bool = False) -> torch.Tensor:
    """Velocity [B, S_img, out] of latents ``x`` [B, S_img, in] under text
    ``ctx`` [B, S_txt, joint] at ``sigma`` [B]. ``lora``: {"double_blocks.i.leaf"
    or "single_blocks.i.leaf": (a, b)} in the program's leaf names (to_q, ...,
    add_out, ff_in, ff_ctx_out; to_q, ..., mlp_gate, mlp_up, out_attn,
    out_mlp), applied unmerged. ``wrap(fn, *args)`` runs each block (e.g.
    ``torch.utils.checkpoint``). ``fp8_control``: every block product's
    operands (projections and attention) rounded to float8 e4m3 under a
    per-tensor scale, the arithmetic float32: the stage's control."""
    r = fp8 if fp8_control else _id
    nh = t["num_attention_heads"]
    d = nh * t["attention_head_dim"]
    mlp = int(d * t["mlp_ratio"])
    s_txt = ctx.shape[1]
    wrap = wrap or (lambda fn, *args: fn(*args))
    img = x.float() @ _w(ckpt, "x_embedder.weight").T
    txt = ctx.float() @ _w(ckpt, "context_embedder.weight").T
    te = "time_guidance_embed.timestep_embedder."
    temb = F.silu(timestep_sinusoid(sigma, t["time_embed_channels"]) @ _w(ckpt, te + "linear_1.weight").T)
    temb = temb @ _w(ckpt, te + "linear_2.weight").T
    act = F.silu(temb)
    b = x.shape[0]
    m_img = (act @ _w(ckpt, "double_stream_modulation_img.linear.weight").T).view(b, 2, 3, d)
    m_txt = (act @ _w(ckpt, "double_stream_modulation_txt.linear.weight").T).view(b, 2, 3, d)
    m_one = (act @ _w(ckpt, "single_stream_modulation.linear.weight").T).view(b, 3, d)

    def mod(v, m):  # m: [B, 3, D] of shift, scale, gate
        return _ln(v) * (1 + m[:, 1, None]) + m[:, 0, None]

    def double(i, img, txt):
        p = f"transformer_blocks.{i}."
        w = {k[len(p):]: ckpt[k].float() for k in ckpt.group_keys(f"double.{i}")}

        def proj(v, name, leaf):
            return _proj(v, w[name], lora, f"double_blocks.{i}.{leaf}", lora_scale, r)

        ni, nt = mod(img, m_img[:, 0]), mod(txt, m_txt[:, 0])
        q = torch.cat([_rms(_heads(proj(nt, "attn.add_q_proj.weight", "add_q"), nh), w["attn.norm_added_q.weight"]),
                       _rms(_heads(proj(ni, "attn.to_q.weight", "to_q"), nh), w["attn.norm_q.weight"])], dim=2)
        k = torch.cat([_rms(_heads(proj(nt, "attn.add_k_proj.weight", "add_k"), nh), w["attn.norm_added_k.weight"]),
                       _rms(_heads(proj(ni, "attn.to_k.weight", "to_k"), nh), w["attn.norm_k.weight"])], dim=2)
        v = torch.cat([_heads(proj(nt, "attn.add_v_proj.weight", "add_v"), nh),
                       _heads(proj(ni, "attn.to_v.weight", "to_v"), nh)], dim=2)
        a = _attention(_rope(q, cos, sin), _rope(k, cos, sin), v, r)
        img = img + m_img[:, 0, 2, None] * proj(a[:, s_txt:], "attn.to_out.0.weight", "to_out")
        txt = txt + m_txt[:, 0, 2, None] * proj(a[:, :s_txt], "attn.to_add_out.weight", "add_out")
        h = mod(img, m_img[:, 1])
        g, u = proj(h, "ff.linear_in.weight", "ff_in").chunk(2, dim=-1)
        img = img + m_img[:, 1, 2, None] * proj(F.silu(g) * u, "ff.linear_out.weight", "ff_out")
        h = mod(txt, m_txt[:, 1])
        g, u = proj(h, "ff_context.linear_in.weight", "ff_ctx_in").chunk(2, dim=-1)
        txt = txt + m_txt[:, 1, 2, None] * proj(F.silu(g) * u, "ff_context.linear_out.weight", "ff_ctx_out")
        return img, txt

    def single(i, xs):
        p = f"single_transformer_blocks.{i}."
        w = {k[len(p):]: ckpt[k].float() for k in ckpt.group_keys(f"single.{i}")}
        w_in = dict(zip(("to_q", "to_k", "to_v", "mlp_gate", "mlp_up"),
                        w["attn.to_qkv_mlp_proj.weight"].split([d, d, d, mlp, mlp], dim=0)))
        w_out = {"out_attn": w["attn.to_out.weight"][:, :d], "out_mlp": w["attn.to_out.weight"][:, d:]}

        def proj(v, leaf, table):
            return _proj(v, table[leaf], lora, f"single_blocks.{i}.{leaf}", lora_scale, r)

        h = mod(xs, m_one)
        q = _rope(_rms(_heads(proj(h, "to_q", w_in), nh), w["attn.norm_q.weight"]), cos, sin)
        k = _rope(_rms(_heads(proj(h, "to_k", w_in), nh), w["attn.norm_k.weight"]), cos, sin)
        a = _attention(q, k, _heads(proj(h, "to_v", w_in), nh), r)
        mlp_out = F.silu(proj(h, "mlp_gate", w_in)) * proj(h, "mlp_up", w_in)
        return xs + m_one[:, 2, None] * (proj(a, "out_attn", w_out) + proj(mlp_out, "out_mlp", w_out))

    for i in range(t["num_layers"]):
        img, txt = wrap(double, i, img, txt)
    xs = torch.cat([txt, img], dim=1)
    for i in range(t["num_single_layers"]):
        xs = wrap(single, i, xs)
    scale, shift = (act @ _w(ckpt, "norm_out.linear.weight").T).chunk(2, dim=-1)
    out = _ln(xs[:, s_txt:]) * (1 + scale[:, None]) + shift[:, None]
    return out @ _w(ckpt, "proj_out.weight").T


def sigmas(num_steps: int, image_seq_len: int) -> np.ndarray:
    """The FLUX.2 schedule: linspace(1, 1/n) time-shifted by the empirical mu
    of (image tokens, steps), then 0; float32 (computed in float64)."""
    a1, b1, a2, b2 = 8.73809524e-05, 1.89833333, 0.00016927, 0.45666666
    if image_seq_len > 4300:
        mu = a2 * image_seq_len + b2
    else:
        m200, m10 = a2 * image_seq_len + b2, a1 * image_seq_len + b1
        a = (m200 - m10) / 190.0
        mu = a * num_steps + (m200 - 200.0 * a)
    t = 1.0 - np.arange(num_steps, dtype=np.float64) / num_steps
    shifted = math.exp(mu) / (math.exp(mu) + (1.0 / t - 1.0))
    return np.concatenate([shifted, [0.0]]).astype(np.float32)


def noise(seed: int, height: int, width: int, device) -> torch.Tensor:
    """The request's initial noise [1, S_img, 128] float32: N(0, 1) drawn as
    [1, 128, H/16, W/16] from a generator on ``device`` seeded with the
    request's seed, token-major."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    z = torch.randn((1, 128, height // 16, width // 16), generator=gen, device=device, dtype=torch.float32)
    return z.permute(0, 2, 3, 1).reshape(1, -1, 128)


def denoise(ckpt, t: dict, cond: torch.Tensor, seed: int, height: int, width: int,
            num_steps: int, fp8_control: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Euler over the schedule from the request's noise: (noise, final latents), [1, S_img, 128] float32."""
    dev = ckpt.device
    x0 = noise(seed, height, width, dev)
    ids = position_ids(cond.shape[1], height, width)
    cos, sin = rope_tables(ids, tuple(t["axes_dims_rope"]), t["rope_theta"], dev)
    sig = sigmas(num_steps, x0.shape[1])
    x = x0
    for i in range(num_steps):
        v = velocity(ckpt, t, x, cond.to(dev), torch.tensor([float(sig[i])], device=dev), cos, sin,
                     fp8_control=fp8_control)
        x = x + float(np.float32(sig[i + 1]) - np.float32(sig[i])) * v
    return x0, x
