"""The plain reference of a served FLUX.2-dev text-to-image request: prompt ->
Mistral-Small-3.2 conditioning (``reference/mistral.py``) -> Euler denoising
with the guidance embedding -> VAE decode, float32 with TF32 off
(``klein.full_f32``), the weights drawn again from the run's seed
(``benchmark/weights_dev.py``). It imports nothing of the program.

The Dev velocity is ``reference/dit.py``'s equations (its helpers, imported)
plus the guidance term of Diffusers' ``Flux2Transformer2DModel``: ``temb =
timestep_embedder(sinusoid(1000 sigma)) + guidance_embedder(sinusoid(1000
guidance))``, each embedder ``linear_2(silu(linear_1(.)))``. The schedule
(``dit.sigmas``), the request's noise (``dit.noise``), the positions and RoPE
and the decode (``vae.decode_u8``) are the Klein reference's.

``control=True`` is the denoising stage's control one precision below the
configuration's w8a8: every block projection's operands rounded as the
program's W4A8 runtime stores and feeds them (weights to int4 codes in
[-7, 7] under one scale per output column and 512-wide K block, activations
to int8 under one scale per token and 512-wide K block, both scales amax
over the levels), the arithmetic float32; attention and the products
outside the blocks stay float32, as the program keeps them out of its
kernels. The decode's control stays fp8 (``vae.decode_u8``): the
configuration does not quantize the VAE, so one precision below its own
is the Klein cells'.

``fp8_parts`` is the control of the DiT's parts the configuration keeps in
bf16: "attention" rounds q, k, the probabilities and v to fp8 (as
``dit.py``'s control does), "stream" the residual stream after the
embedders and after every residual update; the block projections stay
exact. ``python3 -m benchmark.reference.dev --workload <cell> --seed <n>``
prints each one's ``latents_rel_l2`` against the exact denoising, from the
reference's own conditioning of the cell's first request.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from benchmark import weights_dev
from benchmark.reference import dit, mistral, vae
from benchmark.reference.dit import _attention, _heads, _id, _ln, _rms, _rope, _w, fp8, timestep_sinusoid
from benchmark.reference.klein import full_f32

BLOCK = 512  # the W4A8 runtime's K block


def _round_blocks(x: torch.Tensor, levels: int) -> torch.Tensor:
    """``x`` [.., K] rounded to symmetric integer codes in [-levels, levels]
    under one scale per 512-wide block of its last axis (amax / levels), back
    in float32."""
    *lead, k = x.shape
    xb = x.reshape(*lead, k // BLOCK, BLOCK)
    scale = xb.abs().amax(-1, keepdim=True).clamp_min(1e-30) / levels
    return (torch.clamp(torch.round(xb / scale), -levels, levels) * scale).reshape(x.shape)


def w4a8(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w.T`` with w [N, K] as int4 codes and x as int8 codes (see the
    module docstring); a K that 512 does not divide stays float32, as the
    runtime keeps such a weight dense."""
    if x.shape[-1] % BLOCK:
        return x @ w.T
    return _round_blocks(x, 127) @ _round_blocks(w, 7).T


def _plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return x @ w.T


def _embed(ckpt, key: str, v: torch.Tensor) -> torch.Tensor:
    return F.silu(v @ _w(ckpt, key + "linear_1.weight").T) @ _w(ckpt, key + "linear_2.weight").T


def velocity(ckpt, t: dict, x: torch.Tensor, ctx: torch.Tensor, sigma: torch.Tensor, guidance: torch.Tensor,
             cos: torch.Tensor, sin: torch.Tensor, control: bool = False,
             fp8_parts: Sequence[str] = ()) -> torch.Tensor:
    """Velocity [B, S_img, out] of latents ``x`` [B, S_img, in] under text
    ``ctx`` [B, S_txt, joint] at ``sigma`` [B] with distilled guidance
    ``guidance`` [B]; ``control``: the block projections in W4A8's rounding;
    ``fp8_parts``: "attention" and / or "stream" rounded to fp8."""
    mm = w4a8 if control else _plain
    ra = fp8 if "attention" in fp8_parts else _id
    rs = fp8 if "stream" in fp8_parts else _id
    nh = t["num_attention_heads"]
    d = nh * t["attention_head_dim"]
    mlp = int(d * t["mlp_ratio"])
    s_txt = ctx.shape[1]
    img = rs(x.float() @ _w(ckpt, "x_embedder.weight").T)
    txt = rs(ctx.float() @ _w(ckpt, "context_embedder.weight").T)
    ch = t["time_embed_channels"]
    temb = _embed(ckpt, "time_guidance_embed.timestep_embedder.", timestep_sinusoid(sigma, ch))
    if t["guidance_embeds"]:
        temb = temb + _embed(ckpt, "time_guidance_embed.guidance_embedder.", timestep_sinusoid(guidance, ch))
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
        ni, nt = mod(img, m_img[:, 0]), mod(txt, m_txt[:, 0])
        q = torch.cat([_rms(_heads(mm(nt, w["attn.add_q_proj.weight"]), nh), w["attn.norm_added_q.weight"]),
                       _rms(_heads(mm(ni, w["attn.to_q.weight"]), nh), w["attn.norm_q.weight"])], dim=2)
        k = torch.cat([_rms(_heads(mm(nt, w["attn.add_k_proj.weight"]), nh), w["attn.norm_added_k.weight"]),
                       _rms(_heads(mm(ni, w["attn.to_k.weight"]), nh), w["attn.norm_k.weight"])], dim=2)
        v = torch.cat([_heads(mm(nt, w["attn.add_v_proj.weight"]), nh), _heads(mm(ni, w["attn.to_v.weight"]), nh)],
                      dim=2)
        a = _attention(_rope(q, cos, sin), _rope(k, cos, sin), v, ra)
        img = rs(img + m_img[:, 0, 2, None] * mm(a[:, s_txt:], w["attn.to_out.0.weight"]))
        txt = rs(txt + m_txt[:, 0, 2, None] * mm(a[:, :s_txt], w["attn.to_add_out.weight"]))
        g, u = mm(mod(img, m_img[:, 1]), w["ff.linear_in.weight"]).chunk(2, dim=-1)
        img = rs(img + m_img[:, 1, 2, None] * mm(F.silu(g) * u, w["ff.linear_out.weight"]))
        g, u = mm(mod(txt, m_txt[:, 1]), w["ff_context.linear_in.weight"]).chunk(2, dim=-1)
        txt = rs(txt + m_txt[:, 1, 2, None] * mm(F.silu(g) * u, w["ff_context.linear_out.weight"]))
        return img, txt

    def single(i, xs):
        p = f"single_transformer_blocks.{i}."
        w = {k[len(p):]: ckpt[k].float() for k in ckpt.group_keys(f"single.{i}")}
        wq, wk, wv, wg, wu = w["attn.to_qkv_mlp_proj.weight"].split([d, d, d, mlp, mlp], dim=0)
        h = mod(xs, m_one)
        q = _rope(_rms(_heads(mm(h, wq), nh), w["attn.norm_q.weight"]), cos, sin)
        k = _rope(_rms(_heads(mm(h, wk), nh), w["attn.norm_k.weight"]), cos, sin)
        a = _attention(q, k, _heads(mm(h, wv), nh), ra)
        out = w["attn.to_out.weight"]
        return rs(xs + m_one[:, 2, None] * (mm(a, out[:, :d]) + mm(F.silu(mm(h, wg)) * mm(h, wu), out[:, d:])))

    for i in range(t["num_layers"]):
        img, txt = double(i, img, txt)
    xs = torch.cat([txt, img], dim=1)
    for i in range(t["num_single_layers"]):
        xs = single(i, xs)
    scale, shift = (act @ _w(ckpt, "norm_out.linear.weight").T).chunk(2, dim=-1)
    out = _ln(xs[:, s_txt:]) * (1 + scale[:, None]) + shift[:, None]
    return out @ _w(ckpt, "proj_out.weight").T


def denoise(ckpt, t: dict, cond: torch.Tensor, seed: int, height: int, width: int, num_steps: int,
            guidance: float, control: bool = False, fp8_parts: Sequence[str] = ()) -> Tuple[torch.Tensor, torch.Tensor]:
    """Euler over the schedule from the request's noise: (noise, final latents), [1, S_img, 128] float32."""
    dev = ckpt.device
    x0 = dit.noise(seed, height, width, dev)
    cos, sin = dit.rope_tables(dit.position_ids(cond.shape[1], height, width), tuple(t["axes_dims_rope"]),
                               t["rope_theta"], dev)
    sig = dit.sigmas(num_steps, x0.shape[1])
    g = torch.tensor([float(guidance)], device=dev)
    x = x0
    for i in range(num_steps):
        v = velocity(ckpt, t, x, cond.to(dev), torch.tensor([float(sig[i])], device=dev), g, cos, sin, control,
                     fp8_parts)
        x = x + float(np.float32(sig[i + 1]) - np.float32(sig[i])) * v
    return x0, x


def reference_requests(config: dict, seed: int, device, served: List[dict],
                       control: bool = False) -> List[Dict[str, torch.Tensor]]:
    """As ``klein.reference_requests``: "cond" [1, 512, joint] from the
    request's prompt; "noise" and "latents" from the request's seed, the
    conditioning the program gave it and the configuration's ``guidance``
    (a request's own where it sets one); "image" uint8 [H, W, 3] from the
    latents the program gave it. With ``control`` also "latents_fp8" (the
    W4A8-rounded denoising: the key the harness's check reads a stage's
    control under) and "image_fp8" (the fp8 decode). Float32, TF32 off;
    results on the host; one component's float32 weights alive at a time."""
    ck = weights_dev.checkpoints(config, seed, device)
    enc, t = config["text_encoder"], config["transformer"]
    out: List[Dict[str, torch.Tensor]] = [{} for _ in served]
    with torch.no_grad(), full_f32():
        tok = mistral.TekkenWordTokenizer(enc["vocab_size"])
        for s, o in zip(served, out):
            ids, mask = mistral.mistral_ids(tok, s["request"]["prompt"], enc["max_length"])
            o["cond"] = mistral.mistral_conditioning(ck["text_encoder"], enc, ids, mask, enc["hidden_layers"])
        del ck["text_encoder"]
        for s, o in zip(served, out):
            r = s["request"]
            if s.get("cond") is not None:
                g = r.get("guidance") or config["guidance"]
                o["noise"], o["latents"] = denoise(ck["transformer"], t, s["cond"], r["seed"], r["height"], r["width"],
                                                   r["steps"], g)
                if control:
                    o["latents_fp8"] = denoise(ck["transformer"], t, s["cond"], r["seed"], r["height"], r["width"],
                                               r["steps"], g, control=True)[1]
        del ck["transformer"]
        for s, o in zip(served, out):
            r = s["request"]
            if s.get("latents") is not None:
                o["image"] = vae.decode_u8(ck["vae"], config["vae"], s["latents"], r["height"], r["width"])[0]
                if control:
                    o["image_fp8"] = vae.decode_u8(ck["vae"], config["vae"], s["latents"], r["height"], r["width"],
                                                   fp8_control=True)[0]
    return [{k: v.cpu() for k, v in o.items()} for o in out]


def fp8_part_controls(config: dict, seed: int, device, request: dict,
                      parts=(("attention",), ("stream",), ("attention", "stream"))) -> Dict[str, float]:
    """``latents_rel_l2`` of the denoising with each of ``parts`` rounded to
    fp8 against the exact one, both from the reference's conditioning of
    ``request``'s prompt, keyed by the parts joined with "+"."""
    ck = weights_dev.checkpoints(config, seed, device)
    enc, t = config["text_encoder"], config["transformer"]
    r = request
    with torch.no_grad(), full_f32():
        ids, mask = mistral.mistral_ids(mistral.TekkenWordTokenizer(enc["vocab_size"]), r["prompt"], enc["max_length"])
        cond = mistral.mistral_conditioning(ck["text_encoder"], enc, ids, mask, enc["hidden_layers"])
        del ck["text_encoder"]
        g = r.get("guidance") or config["guidance"]
        exact = denoise(ck["transformer"], t, cond, r["seed"], r["height"], r["width"], r["steps"], g)[1].double()
        out = {}
        for p in parts:
            got = denoise(ck["transformer"], t, cond, r["seed"], r["height"], r["width"], r["steps"], g,
                          fp8_parts=p)[1].double()
            out["+".join(p)] = float((got - exact).norm() / exact.norm())
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="latents_rel_l2 of the DiT's bf16 parts rounded to fp8")
    p.add_argument("--workload", default="dev-w8a8-t2i1024-closed")
    p.add_argument("--seed", type=int, required=True)
    args = p.parse_args(argv)
    from benchmark import spec, traffic

    cell = spec.load_cell(args.workload)
    request = next(traffic.closed_requests(cell.traffic, args.seed))
    readings = fp8_part_controls(cell.config, args.seed, torch.device("cuda", 0), request)
    print(json.dumps({"seed": args.seed, "latents_rel_l2": readings}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
