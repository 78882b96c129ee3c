"""The yardstick's arithmetic for the w8a8 runtime: the operations and bytes of
K5 (``w8a8_kernel``) and of its prologue (``quantize_rows_kernel``), the K5
launches of a DiT forward and of an encoder pass, and the least time a
served image's work could take at the peaks of the precisions it runs in.
Shapes alone, as ``benchmark/flops.py`` (which counts bf16 products and stays
as it is).

Which products take K5 follows the program's rules, restated here from
their description: a weight is quantized when its name is a matmul's (no
"norm", "bias", "embed" in it: the DiT's ``norm_out`` projection stays
dense) and its stacked size (layers x elements) is at least 2^16
(``quantize_params``; the encoder's layers alone); a quantized weight takes
K5 when K % 256 == 0 and N % 256 == 0 (JAX's gate), else it is dequantized
and multiplied in bf16.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from benchmark import flops

Shape = Tuple[int, int, int]  # (M, K, N): x [M, K] by the weight [N, K]
MIN_SIZE = 1 << 16


def w8a8_matmul(m: int, k: int, n: int, out_elem: int = 2) -> Tuple[float, float]:
    """K5: 2 M K N integer operations; the int8 activations and weights
    read once, their f32 row and column scales, the M x N output written."""
    return 2.0 * m * k * n, float(m * k + k * n + 4 * m + 4 * n + out_elem * m * n)


def quantize_rows(m: int, k: int, elem: int = 2) -> Tuple[float, float]:
    """The prologue of one K5 call: x [M, K] read, int8 codes and one f32 scale a row written."""
    return 0.0, float(elem * m * k + m * k + 4 * m)


def roofline_s(ops: float, nbytes: float, peak: Dict[str, float], rate: str = "int8_ops") -> float:
    """The least time the card could take: the larger of ``ops`` at the
    ``rate`` peak and ``nbytes`` at HBM's."""
    return max(ops / peak[rate], nbytes / peak["hbm_bytes_per_s"])


def _takes_k5(k: int, n: int, stacked: int) -> bool:
    return stacked >= MIN_SIZE and k % 256 == 0 and n % 256 == 0


def dit_products(t: dict, s_img: int, s_txt: int = 512, batch: int = 1) -> Tuple[List[Shape], List[Shape]]:
    """(the K5 products, the products left in bf16) of one w8a8 DiT forward
    of ``batch`` images: the prelude (x, context, time and guidance
    embeddings, the three modulations), each double block's image and text
    streams, each single block over the joint sequence, the output AdaLN and
    projection."""
    d = t["num_attention_heads"] * t["attention_head_dim"]
    m = int(d * t["mlp_ratio"])
    tc, nd, ns = t["time_embed_channels"], t["num_layers"], t["num_single_layers"]
    b, img, txt, joint = batch, batch * s_img, batch * s_txt, batch * (s_img + s_txt)
    prods = [(img, t["in_channels"], d, 1), (txt, t["joint_attention_dim"], d, 1), (b, tc, d, 1), (b, d, d, 1)]
    if t.get("guidance_embeds"):
        prods += [(b, tc, d, 1), (b, d, d, 1)]
    prods += [(b, d, 6 * d, 1), (b, d, 6 * d, 1), (b, d, 3 * d, 1)]
    for _ in range(nd):
        for rows in (img, txt):
            prods += [(rows, d, d, nd)] * 4 + [(rows, d, 2 * m, nd), (rows, m, d, nd)]
    for _ in range(ns):
        prods += [(joint, d, d, ns)] * 3 + [(joint, d, m, ns)] * 2 + [(joint, d, d, ns), (joint, m, d, ns)]
    prods += [(img, d, t["out_channels"], 1)]
    k5 = [(mm, k, n) for mm, k, n, layers in prods if _takes_k5(k, n, layers * k * n)]
    rest = [(mm, k, n) for mm, k, n, layers in prods if not _takes_k5(k, n, layers * k * n)]
    return k5, rest + [(b, d, 2 * d)]  # the output AdaLN's projection, ``norm_out``: its name keeps it dense


def encoder_products(e: dict, layers: int = None) -> Tuple[List[Shape], List[Shape]]:
    """(the K5 products, the bf16 ones) of one w8a8 encoder pass over
    ``max_length`` tokens through ``layers`` layers (all of them by default,
    as the program runs them): each layer's q, k, v, o and SwiGLU
    projections; the token table, the norms and the head stay out."""
    s, h, hd, inter = e["max_length"], e["hidden_size"], e["head_dim"], e["intermediate_size"]
    q, kv = e["num_attention_heads"] * hd, e["num_key_value_heads"] * hd
    n = e["num_hidden_layers"] if layers is None else layers
    stack = e["num_hidden_layers"]
    prods = [(s, h, q), (s, h, kv), (s, h, kv), (s, q, h), (s, h, inter), (s, h, inter), (s, inter, h)] * n
    k5 = [p for p in prods if _takes_k5(p[1], p[2], stack * p[1] * p[2])]
    return k5, [p for p in prods if not _takes_k5(p[1], p[2], stack * p[1] * p[2])]


def launches_bound_s(shapes: List[Shape], peak: Dict[str, float]) -> Tuple[float, float]:
    """(Σ K5 bound, Σ prologue bound) over the launches ``shapes``, each its own roofline."""
    k5 = sum(roofline_s(*w8a8_matmul(*s), peak) for s in shapes)
    pro = sum(roofline_s(*quantize_rows(s[0], s[1]), peak) for s in shapes)
    return k5, pro


def _products_s(k5: List[Shape], rest: List[Shape], peak: Dict[str, float]) -> float:
    return (sum(2.0 * m * k * n for m, k, n in k5) / peak["int8_ops"]
            + sum(2.0 * m * k * n for m, k, n in rest) / peak["bf16_flops"])


def dit_step_s(t: dict, s_img: int, peak: Dict[str, float], s_txt: int = 512, batch: int = 1) -> float:
    """A w8a8 DiT forward's work at its precisions' peaks: the K5 products
    at int8's, the other products and the attention (``flops.dit_attention``)
    at bf16's."""
    k5, rest = dit_products(t, s_img, s_txt, batch)
    return _products_s(k5, rest, peak) + batch * flops.dit_attention(t, s_img, s_txt) / peak["bf16_flops"]


def encode_s(e: dict, peak: Dict[str, float]) -> float:
    """An encode's work through the deepest layer the recipe reads (the
    layers after it change no conditioning, as ``flops.encoder``): the K5
    products at int8's peak, the causal attention at bf16's."""
    n = max(e["hidden_layers"])
    k5, rest = encoder_products(e, n)
    s, q = e["max_length"], e["num_attention_heads"] * e["head_dim"]
    return _products_s(k5, rest, peak) + n * 2.0 * s * s * q / peak["bf16_flops"]


def t2i_image_s(config: dict, height: int, width: int, steps: int, peak: Dict[str, float]) -> float:
    """One w8a8 text-to-image result's work at its peaks: one encode,
    ``steps`` DiT forwards, the VAE decode at bf16's."""
    s_img = (height // 16) * (width // 16)
    return (encode_s(config["text_encoder"], peak) + steps * dit_step_s(config["transformer"], s_img, peak)
            + flops.vae_decode(config["vae"], height, width) / peak["bf16_flops"])


def launch_mix(config: dict, traffic: dict, steps: List[dict], encodes: List[dict],
               peak: Dict[str, float]) -> Optional[Tuple[float, float, int]]:
    """(Σ K5 bound, Σ prologue bound, launches) of the K5 launches that the
    program's spans say it dispatched: ``steps``, the attributes of
    ``dit.step`` spans (one DiT forward of ``batch`` images each), and
    ``encodes``, those of ``pipeline.encode`` spans (one encoder pass each),
    at the traffic's one image size. None where a span carries no ``w8a8``
    count, or one that is not the configuration's (the yardstick does not
    know the program's launches), or where there is nothing."""
    t, e = config["transformer"], config["text_encoder"]
    sizes = {(s["px"] // 16) ** 2 for s in traffic["sizes"]}
    if len(sizes) != 1:
        return None
    s_img = sizes.pop()
    spans = [(a, dit_products(t, s_img, e["max_length"], a.get("batch", 1))[0]) for a in steps]
    spans += [(a, encoder_products(e)[0]) for a in encodes]
    k5 = pro = 0.0
    n = 0
    for attrs, shapes in spans:
        if attrs.get("w8a8") != len(shapes):
            return None
        a, b = launches_bound_s(shapes, peak)
        k5, pro, n = k5 + a, pro + b, n + len(shapes)
    return (k5, pro, n) if n else None
