"""Plain reference of the Klein conditioning: the tokenizer both sides are
handed, the Klein recipe's ids, and Qwen3's hidden states, in float32.

The benchmark has no tokenizer download, so ``WordTokenizer`` stands in for
Qwen3's BPE as the seeded weights stand in for its checkpoint: special tokens
of the chat template by their Qwen3 ids, any other word or punctuation mark
by a stable hash into the vocabulary. The program is handed an instance and
runs its own recipe over it (template, truncation, padding); the reference
here works the same ids out again by itself.

The Klein recipe (published Qwen3 chat template with thinking disabled):
``<|im_start|>user\\n{prompt}<|im_end|>\\n<|im_start|>assistant\\n<think>\\n\\n</think>\\n\\n``,
truncated and RIGHT-padded to 512 tokens; the conditioning is hidden states
9, 18 and 27 (0 is the token embedding) concatenated along the features.
"""

from __future__ import annotations

import re
import zlib
from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F

SPECIAL_IDS = {"<|endoftext|>": 151643, "<|im_start|>": 151644, "<|im_end|>": 151645,
               "<think>": 151667, "</think>": 151668}
PAD_ID = SPECIAL_IDS["<|endoftext|>"]
_TOKEN = re.compile(r"<\|[a-z_]+\|>|</?think>|\w+|[^\w\s]|\n")
_WORD_IDS = 151_000  # words hash into [0, 151000), below every special id


class WordTokenizer:
    """Deterministic stand-in tokenizer with the ``encode`` / ``pad_token_id``
    interface of an HF tokenizer."""

    pad_token_id = PAD_ID

    def encode(self, text: str) -> List[int]:
        return [SPECIAL_IDS.get(tok, zlib.crc32(tok.encode()) % _WORD_IDS) for tok in _TOKEN.findall(text)]


def klein_ids(tokenizer, prompt: str, max_length: int = 512) -> Tuple[torch.Tensor, torch.Tensor]:
    """(ids, mask) int64 [1, max_length] of the Klein recipe."""
    text = ("<|im_start|>user\n" + prompt.replace("[IMG]", "") + "<|im_end|>\n"
            + "<|im_start|>assistant\n<think>\n\n</think>\n\n")
    ids = list(tokenizer.encode(text))[:max_length]
    n = len(ids)
    ids = ids + [tokenizer.pad_token_id] * (max_length - n)
    mask = [1] * n + [0] * (max_length - n)
    return torch.tensor([ids], dtype=torch.long), torch.tensor([mask], dtype=torch.long)


def _rms(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w


def _rope_half(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    x1, x2 = x.chunk(2, dim=-1)
    return x * cos + torch.cat([-x2, x1], dim=-1) * sin


def qwen3_conditioning(ckpt, e: dict, ids: torch.Tensor, mask: torch.Tensor,
                       layers: Sequence[int]) -> torch.Tensor:
    """Hidden states ``layers`` of Qwen3 (config ``e``) over ``ids`` [1, S],
    concatenated: [1, S, len(layers) * hidden] float32. Runs the decoder
    layers up to the deepest one read, each layer's weights upcast alone."""
    dev = ckpt.device
    ids, mask = ids.to(dev), mask.to(dev)
    s, hd, eps = ids.shape[1], e["head_dim"], e["rms_norm_eps"]
    nh, nkv = e["num_attention_heads"], e["num_key_value_heads"]
    x = ckpt["model.embed_tokens.weight"][ids[0]].float()[None]
    inv = e["rope_theta"] ** -(torch.arange(0, hd, 2, dtype=torch.float64, device=dev) / hd)
    ang = torch.arange(s, dtype=torch.float64, device=dev)[:, None] * inv[None]
    ang = torch.cat([ang, ang], dim=-1)
    cos, sin = ang.cos().float(), ang.sin().float()
    allowed = torch.ones(s, s, dtype=torch.bool, device=dev).tril() & (mask[0] > 0)[None, :]
    bias = torch.zeros(s, s, device=dev).masked_fill(~allowed, float("-inf"))
    states = {0: x}
    for i in range(max(layers)):
        p = f"model.layers.{i}."
        w = {k: ckpt[p + k].float() for k in (
            "input_layernorm.weight", "self_attn.q_proj.weight", "self_attn.k_proj.weight", "self_attn.v_proj.weight",
            "self_attn.o_proj.weight", "self_attn.q_norm.weight", "self_attn.k_norm.weight",
            "post_attention_layernorm.weight", "mlp.gate_proj.weight", "mlp.up_proj.weight", "mlp.down_proj.weight")}
        h = _rms(x, w["input_layernorm.weight"], eps)
        q = (h @ w["self_attn.q_proj.weight"].T).view(1, s, nh, hd).transpose(1, 2)
        k = (h @ w["self_attn.k_proj.weight"].T).view(1, s, nkv, hd).transpose(1, 2)
        v = (h @ w["self_attn.v_proj.weight"].T).view(1, s, nkv, hd).transpose(1, 2)
        q = _rope_half(_rms(q, w["self_attn.q_norm.weight"], eps), cos, sin)
        k = _rope_half(_rms(k, w["self_attn.k_norm.weight"], eps), cos, sin)
        k, v = k.repeat_interleave(nh // nkv, dim=1), v.repeat_interleave(nh // nkv, dim=1)
        probs = torch.softmax(q @ k.transpose(-1, -2) * hd ** -0.5 + bias, dim=-1)
        attn = (probs @ v).transpose(1, 2).reshape(1, s, nh * hd)
        x = x + attn @ w["self_attn.o_proj.weight"].T
        h = _rms(x, w["post_attention_layernorm.weight"], eps)
        mlp = F.silu(h @ w["mlp.gate_proj.weight"].T) * (h @ w["mlp.up_proj.weight"].T)
        x = x + mlp @ w["mlp.down_proj.weight"].T
        states[i + 1] = x
    return torch.cat([states[i] for i in layers], dim=-1)
