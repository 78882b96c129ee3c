"""The yardstick's arithmetic: published peaks, and the operations and bytes
that each kernel and each model step needs, as functions of shapes alone.

Counts follow what the inputs need: a multiply-add is 2 operations; each
input byte is read once and each output byte written once; a causal
attention computes half its score matrix.
"""

from __future__ import annotations

from typing import Dict, Tuple

# NVIDIA H100 SXM data sheet, dense (no sparsity), at its 700 W limit.
H100_SXM = {"bf16_flops": 989e12, "int8_ops": 1979e12, "tf32_flops": 495e12, "f32_flops": 67e12,
            "hbm_bytes_per_s": 3.35e12}


def peaks(device_name: str) -> Dict[str, float]:
    """The peaks of the card the run used; only the H100 is tabled."""
    if "H100" not in device_name:
        raise ValueError(f"no peak table for {device_name!r}")
    return H100_SXM


def attention_fwd(b: int, h: int, sq: int, sk: int, d: int, elem: int = 2) -> Tuple[float, float]:
    """K1/K2 (flash forward): QK^T and PV; q, k, v read and o written once."""
    return 4.0 * b * h * sq * sk * d, float(elem * b * h * d * (2 * sq + 2 * sk))


def attention_bwd_dq(b: int, h: int, sq: int, sk: int, d: int, elem: int = 2) -> Tuple[float, float]:
    """K3 (flash backward, dq): S = QK^T again, dP = dO V^T, dQ = dS K; reads
    q, k, v, dO, the row LSE and delta (f32), writes dq."""
    return 6.0 * b * h * sq * sk * d, float(elem * b * h * d * (3 * sq + 2 * sk) + 8 * b * h * sq)


def attention_bwd_dkv(b: int, h: int, sq: int, sk: int, d: int, elem: int = 2) -> Tuple[float, float]:
    """K4 (flash backward, dk and dv): S again, dP, dV = P^T dO, dK = dS^T Q;
    reads q, k, v, dO, LSE and delta, writes dk and dv."""
    return 8.0 * b * h * sq * sk * d, float(elem * b * h * d * (2 * sq + 4 * sk) + 8 * b * h * sq)


def roofline_s(flops: float, nbytes: float, peak: Dict[str, float]) -> float:
    """The least time the card could take: the larger of the two bounds."""
    return max(flops / peak["bf16_flops"], nbytes / peak["hbm_bytes_per_s"])


def dit_step(t: dict, s_img: int, s_txt: int = 512) -> float:
    """Matmul and attention operations of one DiT forward of one image (the
    per-image modulation and time MLPs, < 0.1%, left out). A double block
    runs per token QKV (D -> 3D), out (D -> D) and the SwiGLU FFN (D -> 2M,
    M -> D) on both streams, a single block its fused D -> 3D + 2M in and
    D + M -> D out; both attend over all S = s_img + s_txt tokens."""
    d = t["num_attention_heads"] * t["attention_head_dim"]
    m = int(d * t["mlp_ratio"])
    s = s_img + s_txt
    per_block = 2.0 * s * (4 * d * d + 3 * d * m) + 4.0 * s * s * d
    emb = 2.0 * s_img * t["in_channels"] * d + 2.0 * s_txt * t["joint_attention_dim"] * d \
        + 2.0 * s_img * d * t["out_channels"]
    return (t["num_layers"] + t["num_single_layers"]) * per_block + emb


def encoder(e: dict) -> float:
    """Qwen3 over one prompt of ``max_length`` tokens, through the deepest
    layer the recipe reads (the layers after it change no conditioning)."""
    s, h, hd = e["max_length"], e["hidden_size"], e["head_dim"]
    q, kv = e["num_attention_heads"] * hd, e["num_key_value_heads"] * hd
    per_layer = 2.0 * s * (2 * h * q + 2 * h * kv + 3 * h * e["intermediate_size"]) + 2.0 * s * s * q
    return max(e["hidden_layers"]) * per_layer


def vae_decode(v: dict, height: int, width: int) -> float:
    """Convolutions, the mid attention and its projections of one decode."""
    ch = list(v["block_out_channels"])
    lc = v["latent_channels"]
    hw = (height // 8) * (width // 8)

    def conv(cin, cout, k, pixels):
        return 2.0 * cin * cout * k * k * pixels

    def resnet(cin, cout, pixels):
        return conv(cin, cout, 3, pixels) + conv(cout, cout, 3, pixels) + (conv(cin, cout, 1, pixels) if cin != cout
                                                                             else 0.0)

    c = ch[-1]
    total = conv(lc, lc, 1, hw) + conv(lc, c, 3, hw) + 2 * resnet(c, c, hw)
    total += 4 * 2.0 * hw * c * c + 4.0 * hw * hw * c
    prev, pixels = c, hw
    for i, c in enumerate(reversed(ch)):
        for j in range(v["layers_per_block"] + 1):
            total += resnet(prev if j == 0 else c, c, pixels)
        if i < len(ch) - 1:
            pixels *= 4
            total += conv(c, c, 3, pixels)
        prev = c
    return total + conv(ch[0], 3, 3, pixels)


def t2i_image(config: dict, height: int, width: int, steps: int, encodes: float = 1.0) -> float:
    """One text-to-image result: ``encodes`` prompt encodes (1 unless the
    prompt cache served it), ``steps`` DiT forwards, one decode."""
    s_img = (height // 16) * (width // 16)
    return (encodes * encoder(config["text_encoder"]) + steps * dit_step(config["transformer"], s_img)
            + vae_decode(config["vae"], height, width))


def dit_attention(t: dict, s_img: int, s_txt: int = 512) -> float:
    """The attention part of ``dit_step``: 4 S^2 D a block."""
    d = t["num_attention_heads"] * t["attention_head_dim"]
    s = s_img + s_txt
    return (t["num_layers"] + t["num_single_layers"]) * 4.0 * s * s * d


def lora_train_step(t: dict, s_img: int, batch: int, remat: bool = True, s_txt: int = 512) -> float:
    """One LoRA train step on a frozen base: the forward, the forward again
    under remat (each block recomputed in the backward), and the backward,
    which takes the inputs' gradients of every projection (as many
    operations as its forward; the frozen weights get none) and of every
    attention (2.5 times its forward: S again, dP, dQ, dK, dV). The
    adapters' own products (rank r against widths of thousands) are left
    out."""
    fwd = dit_step(t, s_img, s_txt)
    attn = dit_attention(t, s_img, s_txt)
    return batch * ((2.0 if remat else 1.0) * fwd + (fwd - attn) + 2.5 * attn)
