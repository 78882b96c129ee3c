"""Random checkpoints, tokenizers and datasets written to disk from a seed.

The fixtures of ``chip_smoke.py`` and of the CPU tests: HF / Diffusers /
BFL-layout state dicts of the port's modules (each written out on its own,
the inverse of the port's weight maps), a sharded safetensors writer, a
Qwen3.5-VL checkpoint with a vocabulary-wide byte-level tokenizer, and a
training dataset of PNGs with captions. Nothing here is on a serving path.
"""

import json
import os

import torch

SHARD_BYTES = 5 * 10**9  # the largest safetensors file written


def diffusers_transformer_state(model) -> dict:
    """The DiT in the Diffusers dialect (Flux2Transformer2DModel names): the
    inverse of the port's map, written out on its own so a round trip
    checks the map rather than restating it."""
    double = {"to_q": "attn.to_q", "to_k": "attn.to_k", "to_v": "attn.to_v", "to_out": "attn.to_out.0",
              "add_q": "attn.add_q_proj", "add_k": "attn.add_k_proj", "add_v": "attn.add_v_proj",
              "add_out": "attn.to_add_out", "norm_q": "attn.norm_q", "norm_k": "attn.norm_k",
              "norm_added_q": "attn.norm_added_q", "norm_added_k": "attn.norm_added_k", "ff_in": "ff.linear_in",
              "ff_out": "ff.linear_out", "ff_ctx_in": "ff_context.linear_in", "ff_ctx_out": "ff_context.linear_out"}
    top = {"x_embedder": "x_embedder", "context_embedder": "context_embedder",
           "time_linear1": "time_guidance_embed.timestep_embedder.linear_1",
           "time_linear2": "time_guidance_embed.timestep_embedder.linear_2",
           "double_mod_img": "double_stream_modulation_img.linear",
           "double_mod_txt": "double_stream_modulation_txt.linear",
           "single_mod": "single_stream_modulation.linear", "norm_out": "norm_out.linear", "proj_out": "proj_out"}
    out = {f"{name}.weight": getattr(model, attr) for attr, name in top.items()}
    for i, blk in enumerate(model.double_blocks):
        for attr, name in double.items():
            out[f"transformer_blocks.{i}.{name}.weight"] = getattr(blk, attr)
    for i, blk in enumerate(model.single_blocks):
        p = f"single_transformer_blocks.{i}.attn."
        out[p + "to_qkv_mlp_proj.weight"] = torch.cat([blk.to_q, blk.to_k, blk.to_v, blk.mlp_gate, blk.mlp_up])
        out[p + "to_out.weight"] = torch.cat([blk.out_attn, blk.out_mlp], dim=1)
        out[p + "norm_q.weight"], out[p + "norm_k.weight"] = blk.norm_q, blk.norm_k
    return out


def autoencoder_state(vae, encoder) -> dict:
    """The VAE decoder and encoder (with quant_conv) in diffusers AutoencoderKL names."""
    mid = (("mid_resnet1.", "mid_block.resnets.0."), ("mid_resnet2.", "mid_block.resnets.1."),
           ("mid_attn.to_out.", "mid_block.attentions.0.to_out.0."), ("mid_attn.", "mid_block.attentions.0."),
           ("norm_out.", "conv_norm_out."), ("conv_in.", "conv_in."), ("conv_out.", "conv_out."))
    out = {}
    for name, t in vae.state_dict().items():
        if name.startswith("up_blocks."):
            key = "decoder." + name.replace(".upsample.", ".upsamplers.0.conv.")
        elif name.startswith(("bn_running_", "post_quant_conv.")):
            key = name.replace("bn_running_", "bn.running_")
        else:
            key = next("decoder." + dst + name[len(src):] for src, dst in mid if name.startswith(src))
        out[key] = t
    for name, t in encoder.state_dict().items():
        if name.startswith("down_blocks."):
            key = "encoder." + name.replace(".downsample.", ".downsamplers.0.conv.")
        elif name.startswith("quant_conv."):
            key = name
        else:
            key = next("encoder." + dst + name[len(src):] for src, dst in mid if name.startswith(src))
        out[key] = t
    return out


def qwen3_state(decoder, layers: int) -> dict:
    """The first ``layers`` layers in HF Qwen3 names, tied embeddings (no
    lm_head), and ``model.norm`` (the decoder's ``final_norm``)."""
    names = {"input_norm": "input_layernorm", "post_attn_norm": "post_attention_layernorm",
             "q_proj": "self_attn.q_proj", "k_proj": "self_attn.k_proj", "v_proj": "self_attn.v_proj",
             "o_proj": "self_attn.o_proj", "q_norm": "self_attn.q_norm", "k_norm": "self_attn.k_norm",
             "gate_proj": "mlp.gate_proj", "up_proj": "mlp.up_proj", "down_proj": "mlp.down_proj"}
    out = {"model.embed_tokens.weight": decoder.embed_tokens,
           "model.norm.weight": decoder.final_norm}
    for i in range(layers):
        for attr, name in names.items():
            out[f"model.layers.{i}.{name}.weight"] = getattr(decoder.layers[i], attr)
    return out


def write_sharded(path: str, state: dict, stem: str, config: dict) -> int:
    """``state`` as safetensors files of at most SHARD_BYTES each (copied off
    the card one file at a time) with its config.json; returns bytes written."""
    from flux2_tpu_torch.io import safetensors_io

    os.makedirs(path, exist_ok=True)
    shards, size = [[]], 0
    for name, t in state.items():
        nbytes = t.numel() * t.element_size()
        if shards[-1] and size + nbytes > SHARD_BYTES:
            shards.append([])
            size = 0
        shards[-1].append(name)
        size += nbytes
    for i, names in enumerate(shards):
        safetensors_io.save_file({n: state[n].detach().cpu() for n in names},
                                 os.path.join(path, f"{stem}-{i + 1:05d}-of-{len(shards):05d}.safetensors"))
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(config, f)
    return sum(os.path.getsize(os.path.join(path, f)) for f in os.listdir(path))


DATASET_CAPTIONS = ("a photo of [trigger] on a wooden table", "[trigger] in a garden at dawn",
                    "a close-up of [trigger], studio light", "[trigger] beside a mountain lake",
                    "a sketch of [trigger]", "[trigger] on a beach at noon")


def write_dataset(root: str, seed: int, sizes, captions=DATASET_CAPTIONS, control=(), manifest: bool = False) -> dict:
    """A training dataset written from ``seed``: one PNG per (width, height) of
    ``sizes`` (smooth colour fields with noise), its caption (``[trigger]``
    placeholders) as a ``.txt`` sidecar or, with ``manifest``, one
    ``manifest.jsonl``; the items of ``control`` (indices) also get a control
    image of their size in ``<root>_control``. Returns the directories."""
    import numpy as np

    from flux2_tpu_torch.io.png import encode_png

    rng = np.random.RandomState(seed)
    control_dir = root + "_control"
    os.makedirs(root, exist_ok=True)
    records = []
    for i, (w, h) in enumerate(sizes):
        for directory, name in [(root, f"image_{i:02d}.png")] + ([(control_dir, f"image_{i:02d}.png")]
                                                                  if i in control else []):
            os.makedirs(directory, exist_ok=True)
            yy, xx = np.mgrid[0:h, 0:w] / max(w, h)
            base = np.stack([np.sin(2 * np.pi * (rng.uniform(0.5, 3) * xx + rng.uniform(0.5, 3) * yy + rng.uniform()))
                             for _ in range(3)], axis=-1)
            img = np.clip(127.5 + 100 * base + rng.normal(0, 12, (h, w, 3)), 0, 255).astype(np.uint8)
            with open(os.path.join(directory, name), "wb") as f:
                f.write(encode_png(img))
        caption = captions[i % len(captions)]
        records.append({"image": f"image_{i:02d}.png", "caption": caption})
        if i in control:
            records[-1]["control"] = os.path.relpath(os.path.join(control_dir, f"image_{i:02d}.png"), root)
        if not manifest:
            with open(os.path.join(root, f"image_{i:02d}.txt"), "w") as f:
                f.write(caption)
    if manifest:
        with open(os.path.join(root, "manifest.jsonl"), "w") as f:
            f.writelines(json.dumps(r) + "\n" for r in records)
    return {"dataset": root, "control": control_dir if control else None}


QWEN35_SPECIALS = ("<|im_start|>", "<|im_end|>", "<|pad|>")


def vocab_tokenizer(vocab_size: int):
    """A byte-level BPE tokenizer (HF fast, the Qwen chat template) whose
    vocabulary covers ids [0, vocab_size): the three chat specials, the 256
    byte symbols, then byte pairs and triples, with no merges. Every id a
    random model draws decodes to text (a trained tiny BPE leaves ids past
    its few hundred undecodable, and a random reply would decode to "")."""
    import itertools

    import tokenizers
    from transformers import PreTrainedTokenizerFast

    from flux2_tpu_torch.utils.dev_tokenizer import _QWEN_CHAT_TEMPLATE

    alphabet = sorted(tokenizers.pre_tokenizers.ByteLevel.alphabet())
    vocab = {s: i for i, s in enumerate(QWEN35_SPECIALS)}
    symbols = itertools.chain(alphabet, ("".join(t) for n in (2, 3) for t in itertools.product(alphabet, repeat=n)))
    for s in itertools.islice(symbols, max(0, vocab_size - len(vocab))):
        vocab[s] = len(vocab)
    tok = tokenizers.Tokenizer(tokenizers.models.BPE(vocab=vocab, merges=[], unk_token=None))
    tok.pre_tokenizer = tokenizers.pre_tokenizers.ByteLevel(add_prefix_space=False)
    tok.decoder = tokenizers.decoders.ByteLevel()
    tok.add_special_tokens(list(QWEN35_SPECIALS))
    return PreTrainedTokenizerFast(tokenizer_object=tok, pad_token="<|pad|>", eos_token="<|im_end|>",
                                   chat_template=_QWEN_CHAT_TEMPLATE)


def qwen35_text_json(cfg) -> dict:
    """A ``Qwen35TextConfig`` as an HF qwen3_next ``text_config``."""
    return {"model_type": "qwen3_next", "vocab_size": cfg.vocab_size, "hidden_size": cfg.hidden_size,
            "intermediate_size": cfg.intermediate_size, "num_hidden_layers": cfg.num_hidden_layers,
            "num_attention_heads": cfg.num_attention_heads, "num_key_value_heads": cfg.num_key_value_heads,
            "head_dim": cfg.head_dim, "rms_norm_eps": cfg.rms_norm_eps, "rope_theta": cfg.rope_theta,
            "partial_rotary_factor": cfg.partial_rotary_factor,
            "rope_scaling": {"mrope_section": list(cfg.mrope_sections)},
            "full_attention_interval": cfg.full_attention_interval,
            "linear_num_key_heads": cfg.linear_num_key_heads, "linear_num_value_heads": cfg.linear_num_value_heads,
            "linear_key_head_dim": cfg.linear_key_head_dim, "linear_value_head_dim": cfg.linear_value_head_dim,
            "linear_conv_kernel_dim": cfg.linear_conv_kernel_dim, "tie_word_embeddings": cfg.tie_word_embeddings}


def qwen35_vl_state(text_cfg, vision_cfg, gen: torch.Generator, dtype: torch.dtype = torch.bfloat16) -> dict:
    """Random weights in an HF Qwen3.5-VL checkpoint's names and layouts, drawn
    from ``gen`` on its device: the hybrid LM as ``model.language_model.*``
    (qwen3_next: packed ``in_proj_qkvz`` / ``in_proj_ba``, ``conv1d`` [C, 1,
    K], zero-centred RMSNorm weights) and the Qwen3-VL tower as
    ``model.visual.*`` (Conv3d patch embedding [D, C, T, P, P])."""
    device = gen.device

    def draw(*shape, scale=1.0, shift=0.0):
        return (torch.randn(shape, generator=gen, device=device) * scale + shift).to(dtype)

    def linear(d_out, d_in):
        return draw(d_out, d_in, scale=d_in**-0.5)

    c = text_cfg
    h, inter = c.hidden_size, c.intermediate_size
    hk, hv, dk, dv = c.linear_num_key_heads, c.linear_num_value_heads, c.linear_key_head_dim, c.linear_value_head_dim
    rep = hv // hk
    out = {"model.language_model.embed_tokens.weight": draw(c.vocab_size, h, scale=0.02),
           "model.language_model.norm.weight": draw(h, scale=0.1)}
    for i in range(c.num_hidden_layers):
        p = f"model.language_model.layers.{i}."
        out[p + "input_layernorm.weight"] = draw(h, scale=0.1)
        out[p + "post_attention_layernorm.weight"] = draw(h, scale=0.1)
        out[p + "mlp.gate_proj.weight"] = linear(inter, h)
        out[p + "mlp.up_proj.weight"] = linear(inter, h)
        out[p + "mlp.down_proj.weight"] = linear(h, inter)
        if c.is_linear_layer(i):
            out[p + "linear_attn.in_proj_qkvz.weight"] = linear(hk * (2 * dk + 2 * rep * dv), h)
            out[p + "linear_attn.in_proj_ba.weight"] = linear(hk * 2 * rep, h)
            out[p + "linear_attn.out_proj.weight"] = linear(h, hv * dv)
            out[p + "linear_attn.conv1d.weight"] = draw(c.conv_dim, 1, c.linear_conv_kernel_dim, scale=0.2)
            out[p + "linear_attn.norm.weight"] = draw(dv, scale=0.1, shift=1.0)
            # mild decays (g ~ 0.9 a token): JAX's chunked DeltaNet stays finite, so CPU tests compare to it
            out[p + "linear_attn.A_log"] = draw(hv, scale=0.5, shift=-2.5)
            out[p + "linear_attn.dt_bias"] = draw(hv, scale=0.3, shift=1.0)
        else:
            qd, kvd = c.num_attention_heads * c.head_dim, c.num_key_value_heads * c.head_dim
            out[p + "self_attn.q_proj.weight"] = linear(2 * qd, h)
            out[p + "self_attn.k_proj.weight"] = linear(kvd, h)
            out[p + "self_attn.v_proj.weight"] = linear(kvd, h)
            out[p + "self_attn.o_proj.weight"] = linear(h, qd)
            out[p + "self_attn.q_norm.weight"] = draw(c.head_dim, scale=0.1)
            out[p + "self_attn.k_norm.weight"] = draw(c.head_dim, scale=0.1)
    v = vision_cfg
    d, m2 = v.hidden_size, v.hidden_size * v.spatial_merge_size**2
    patch = (d, v.in_channels, v.temporal_patch_size, v.patch_size, v.patch_size)
    out["model.visual.patch_embed.proj.weight"] = draw(*patch, scale=v.patch_dim**-0.5)
    out["model.visual.patch_embed.proj.bias"] = draw(d, scale=0.02)
    out["model.visual.pos_embed.weight"] = draw(v.num_position_embeddings, d, scale=0.02)

    def norm(prefix, n):
        out[prefix + ".weight"] = draw(n, scale=0.1, shift=1.0)
        out[prefix + ".bias"] = draw(n, scale=0.02)

    def dense(prefix, d_out, d_in):
        out[prefix + ".weight"] = linear(d_out, d_in)
        out[prefix + ".bias"] = draw(d_out, scale=0.02)

    for i in range(v.depth):
        p = f"model.visual.blocks.{i}."
        norm(p + "norm1", d)
        norm(p + "norm2", d)
        dense(p + "attn.qkv", 3 * d, d)
        dense(p + "attn.proj", d, d)
        dense(p + "mlp.linear_fc1", v.intermediate_size, d)
        dense(p + "mlp.linear_fc2", d, v.intermediate_size)
    norm("model.visual.merger.norm", d)
    dense("model.visual.merger.linear_fc1", m2, m2)
    dense("model.visual.merger.linear_fc2", v.out_hidden_size, m2)
    return out


def write_qwen35_vl_checkpoint(path: str, text_cfg, vision_cfg, gen: torch.Generator, tokenizer,
                               dtype: torch.dtype = torch.bfloat16) -> int:
    """A random Qwen3.5-VL checkpoint directory (``qwen35_vl_state``, its
    config.json with ``text_config`` / ``vision_config`` and the image token,
    and ``tokenizer`` saved beside it); returns the bytes written."""
    v = vision_cfg
    config = {"model_type": "qwen3_vl", "image_token_id": v.image_token_id, "text_config": qwen35_text_json(text_cfg),
              "vision_config": {"depth": v.depth, "hidden_size": v.hidden_size, "num_heads": v.num_heads,
                                "intermediate_size": v.intermediate_size, "patch_size": v.patch_size,
                                "spatial_merge_size": v.spatial_merge_size,
                                "temporal_patch_size": v.temporal_patch_size, "in_channels": v.in_channels,
                                "out_hidden_size": v.out_hidden_size,
                                "num_position_embeddings": v.num_position_embeddings}}
    written = write_sharded(path, qwen35_vl_state(text_cfg, vision_cfg, gen, dtype), "model", config)
    tokenizer.save_pretrained(path)
    return written
