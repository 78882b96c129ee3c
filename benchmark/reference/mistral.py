"""Plain reference of the FLUX.2-dev conditioning: the tokenizer both sides are
handed, the Mistral recipe's ids, and Mistral-Small-3.2's hidden states, in
float32.

``TekkenWordTokenizer`` stands in for Mistral's Tekken tokenizer as
``text.WordTokenizer`` does for Qwen3's: the control tokens of the Mistral
Small 3.2 chat template by Tekken's ids (``<s>`` 1, ``[INST]`` 3, ``[/INST]``
4, ``<pad>`` 11, ``[SYSTEM_PROMPT]`` 17, ``[/SYSTEM_PROMPT]`` 18), any other
word or punctuation mark by a stable hash into the ids above Tekken's 1000
special ones. The program is handed an instance and runs its own recipe over
it; the reference works the ids out again here.

The Mistral recipe (Diffusers' ``Flux2Pipeline``): the system prompt below
(a copy of the program's, held equal to it by a test) and the user turn, no
generation prompt, truncated and LEFT-padded to 512 tokens; the
conditioning is hidden states 10, 20 and 30 (0 is the token embedding)
concatenated along the features.

The decoder is Mistral's: RMSNorm (the configuration's eps), no q/k norm,
the half-split RoPE at the configuration's theta over the absolute positions
0..S-1 (padding included: the published pipeline passes no position ids),
Llama-4's query scaling ``1 + beta * log1p(floor(pos / original_max))``
after RoPE (1 below ``original_max_position_embeddings``), grouped-query
attention, SwiGLU. Where it departs from a float ``-inf`` mask: a left
pad's query row has no key it may see, and here (as in the program, and as
HF's SDPA path unmasks such rows) it attends to every key evenly, through a
finite additive mask, where ``-inf`` would give NaN.
"""

from __future__ import annotations

import re
import zlib
from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F

from benchmark.reference.text import _rms, _rope_half

SYSTEM_MESSAGE = (
    "You are an AI that reasons about image descriptions. You give structured "
    "responses focusing on object relationships, object attribution and "
    "actions without speculation.\n"
)

BOS, INST, END_INST, PAD, SYSTEM, END_SYSTEM = 1, 3, 4, 11, 17, 18
SPECIAL_IDS = 1000  # Tekken reserves ids 0..999 for control tokens
_TOKEN = re.compile(r"\w+|[^\w\s]|\n")
NEG_INF = -1e30  # finite: a row with no visible key averages every key


class TekkenWordTokenizer:
    """Deterministic stand-in with the ``apply_chat_template`` /
    ``pad_token_id`` interface the program's Mistral recipe calls."""

    pad_token_id = PAD

    def __init__(self, vocab_size: int = 131072):
        self.vocab_size = vocab_size

    def encode(self, text: str) -> List[int]:
        span = self.vocab_size - SPECIAL_IDS
        return [SPECIAL_IDS + zlib.crc32(tok.encode()) % span for tok in _TOKEN.findall(text)]

    def apply_chat_template(self, messages: Sequence[dict], add_generation_prompt: bool = False) -> List[int]:
        """The Mistral Small 3.2 template, control tokens spliced as ids:
        ``<s>[SYSTEM_PROMPT]system[/SYSTEM_PROMPT][INST]user[/INST]``."""
        ids = [BOS]
        for m in messages:
            if m["role"] == "system":
                ids += [SYSTEM, *self.encode(m["content"]), END_SYSTEM]
            elif m["role"] == "user":
                ids += [INST, *self.encode(m["content"]), END_INST]
            else:
                raise ValueError(f"role {m['role']!r}: the recipe sends a system and a user turn")
        return ids


def mistral_ids(tokenizer: TekkenWordTokenizer, prompt: str, max_length: int = 512) -> Tuple[torch.Tensor, torch.Tensor]:
    """(ids, mask) int64 [1, max_length] of the Mistral recipe, worked out
    here from the tokenizer's word ids and Tekken's control ids."""
    ids = [BOS, SYSTEM, *tokenizer.encode(SYSTEM_MESSAGE), END_SYSTEM,
           INST, *tokenizer.encode(prompt.replace("[IMG]", "")), END_INST][:max_length]
    pad = max_length - len(ids)
    return (torch.tensor([[PAD] * pad + ids], dtype=torch.long),
            torch.tensor([[0] * pad + [1] * len(ids)], dtype=torch.long))


def mistral_conditioning(ckpt, e: dict, ids: torch.Tensor, mask: torch.Tensor, layers: Sequence[int]) -> torch.Tensor:
    """Hidden states ``layers`` of the decoder of config ``e`` (a Mistral3
    checkpoint's ``language_model.model.*``) over ``ids`` [1, S],
    concatenated: [1, S, len(layers) * hidden] float32. Runs the layers up to
    the deepest one read, each layer's weights upcast alone."""
    prefix = "language_model.model."
    dev = ckpt.device
    ids, mask = ids.to(dev), mask.to(dev)
    s, hd, eps = ids.shape[1], e["head_dim"], e["rms_norm_eps"]
    nh, nkv = e["num_attention_heads"], e["num_key_value_heads"]
    x = ckpt[prefix + "embed_tokens.weight"][ids[0]].float()[None]
    pos = torch.arange(s, dtype=torch.float64, device=dev)
    inv = e["rope_theta"] ** -(torch.arange(0, hd, 2, dtype=torch.float64, device=dev) / hd)
    ang = pos[:, None] * inv[None]
    ang = torch.cat([ang, ang], dim=-1)
    cos, sin = ang.cos().float(), ang.sin().float()
    q_scale = (1.0 + e["llama4_scaling_beta"] * torch.log1p(torch.floor(pos / e["original_max_position_embeddings"])))
    q_scale = q_scale.float()[:, None]
    allowed = torch.ones(s, s, dtype=torch.bool, device=dev).tril() & (mask[0] > 0)[None, :]
    bias = torch.zeros(s, s, device=dev).masked_fill(~allowed, NEG_INF)
    states = {0: x}
    for i in range(max(layers)):
        p = f"{prefix}layers.{i}."
        w = {k: ckpt[p + k].float() for k in (
            "input_layernorm.weight", "self_attn.q_proj.weight", "self_attn.k_proj.weight", "self_attn.v_proj.weight",
            "self_attn.o_proj.weight", "post_attention_layernorm.weight", "mlp.gate_proj.weight",
            "mlp.up_proj.weight", "mlp.down_proj.weight")}
        h = _rms(x, w["input_layernorm.weight"], eps)
        q = (h @ w["self_attn.q_proj.weight"].T).view(1, s, nh, hd).transpose(1, 2)
        k = (h @ w["self_attn.k_proj.weight"].T).view(1, s, nkv, hd).transpose(1, 2)
        v = (h @ w["self_attn.v_proj.weight"].T).view(1, s, nkv, hd).transpose(1, 2)
        q = _rope_half(q, cos, sin) * q_scale
        k = _rope_half(k, cos, sin)
        k, v = k.repeat_interleave(nh // nkv, dim=1), v.repeat_interleave(nh // nkv, dim=1)
        probs = torch.softmax(q @ k.transpose(-1, -2) * hd ** -0.5 + bias, dim=-1)
        attn = (probs @ v).transpose(1, 2).reshape(1, s, nh * hd)
        x = x + attn @ w["self_attn.o_proj.weight"].T
        h = _rms(x, w["post_attention_layernorm.weight"], eps)
        x = x + (F.silu(h @ w["mlp.gate_proj.weight"].T) * (h @ w["mlp.up_proj.weight"].T)) @ w["mlp.down_proj.weight"].T
        states[i + 1] = x
    return torch.cat([states[i] for i in layers], dim=-1)
