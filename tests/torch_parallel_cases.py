"""Rank-side cases of the port's multi-rank CPU tests (``tests/torch_rank_pool.py``).

Every function here runs on each rank of the pool at once, on the CPU with
gloo, and returns numpy (or plain Python) results; the tests compute JAX's
references in the pytest process and compare. Nothing here imports JAX or
``flux2_tpu``: weights arrive as JAX's parameter trees of numpy leaves and
load through ``flux2_tpu_torch.io.jax_params``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from flux2_tpu_torch.io.jax_params import decoder_from_jax, transformer_from_jax
from flux2_tpu_torch.models.flux2.config import Flux2Model, Flux2TransformerConfig
from flux2_tpu_torch.models.flux2.vae import VAEConfig
from flux2_tpu_torch.models.text_encoders.config import DecoderConfig
from flux2_tpu_torch.ops import quant
from flux2_tpu_torch.parallel import mesh as mesh_mod
from flux2_tpu_torch.parallel import sharding as sh


def mesh(dims, dcn: bool = False):
    if dcn:
        return mesh_mod.make_multislice_mesh(dims[0], *dims[1:], device_type="cpu")
    return mesh_mod.make_mesh(*dims, device_type="cpu")


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a))


def _out(y) -> dict:
    """An output's full value and this rank's local bytes."""
    local = y.to_local() if isinstance(y, DTensor) else y
    return {"value": sh.gather(y).float().numpy(), "local_bytes": local.nbytes}


# -- the mesh ------------------------------------------------------------------------


def mesh_shapes():
    out = {}
    out["2,2,2"] = mesh_mod.mesh_shape(mesh_mod.make_mesh(data=2, fsdp=2, tp=2, device_type="cpu"))
    out["tp=-1"] = mesh_mod.mesh_shape(mesh_mod.make_mesh(data=1, fsdp=1, tp=-1, device_type="cpu"))
    out["sp=4"] = mesh_mod.mesh_shape(mesh_mod.make_mesh(data=1, fsdp=1, tp=2, sp=4, device_type="cpu"))
    out["best"] = mesh_mod.mesh_shape(mesh_mod.best_mesh_for_inference(device_type="cpu"))
    errors = []
    for kw in ({"data": 3, "fsdp": 1, "tp": 1}, {"data": -1, "fsdp": -1}, {"data": 3, "fsdp": 1, "tp": -1},
               {"data": 1, "fsdp": 1, "tp": 16}):
        try:
            mesh_mod.make_mesh(**kw, device_type="cpu")
        except ValueError as e:
            errors.append(str(e))
    out["errors"] = errors
    single = mesh_mod.single_device_mesh(device_type="cpu")
    out["single"] = (mesh_mod.mesh_shape(single), single.mesh.flatten().tolist())
    return out


def multislice_layout():
    m = mesh_mod.make_multislice_mesh(num_slices=2, fsdp=2, tp=2, sp=1, device_type="cpu")
    errors = []
    for args in ((3,), (2, 3, 1, 1)):
        try:
            mesh_mod.make_multislice_mesh(*args, device_type="cpu")
        except ValueError as e:
            errors.append(str(e))
    return {"shape": mesh_mod.mesh_shape(m), "ranks": m.mesh.tolist(), "errors": errors}


# -- the DiT ---------------------------------------------------------------------------


def dit_forward(params, cfg_kw: dict, inputs: dict, dims, ring_axis: Optional[str] = None,
                fmt: Optional[str] = None):
    """The DiT from JAX's ``params`` (quantized to ``fmt`` in the port), sharded
    over ``dims`` with DIT_RULES; the forward's output and the placements."""
    model = transformer_from_jax(params, Flux2TransformerConfig(**cfg_kw))
    if fmt:
        quant.quantize_params(model, fmt, min_size=1 << 10)
    m = mesh(dims)
    sh.shard_params(model, m, sh.DIT_RULES)
    x, txt, t, cos, sin = (_t(inputs[k]) for k in ("hidden", "txt", "t", "cos", "sin"))
    ring = (m, ring_axis) if ring_axis else None
    with torch.no_grad():
        y = model(x, txt, t, cos, sin, ring=ring)
    return _out(y)


def dit_train_step(params, cfg_kw: dict, inputs: dict, dims):
    """One LoRA train step (remat) on the DiT sharded over ``dims`` (train-lora
    --shard's path: the adapters replicated on the DiT's mesh, the velocity
    gathered) and on the unsharded DiT, from the same seeds: losses, gradient
    norms and the LoRA gradients."""
    from flux2_tpu_torch.training import trainer

    tcfg = trainer.TrainConfig(rank=2, alpha=4.0, remat=True)
    batch = {"latents": _t(inputs["hidden"]), "embeddings": _t(inputs["txt"]), "rope_cos": _t(inputs["cos"]),
             "rope_sin": _t(inputs["sin"])}
    out = {}
    for kind in ("dense", "sharded"):
        model = transformer_from_jax(params, Flux2TransformerConfig(**cfg_kw))
        if kind == "sharded":
            sh.shard_params(model, mesh(dims), sh.DIT_RULES)
        state = trainer.init_train_state(model, tcfg, torch.Generator().manual_seed(1))
        metrics = trainer.make_train_step(model, tcfg)(state.lora, state.optimizer, dict(batch),
                                                       torch.Generator().manual_seed(5))
        out[kind] = {"loss": float(metrics["loss"]), "grad_norm": float(metrics["grad_norm"]),
                     "grads": {n: p.grad.numpy().copy() for n, p in state.lora.named_parameters()}}
    return out


def dit_local_param_bytes(params, cfg_kw: dict, dims, fmt: Optional[str] = None):
    """Every rank's bytes of parameters and buffers after ``shard_params``."""
    model = transformer_from_jax(params, Flux2TransformerConfig(**cfg_kw))
    if fmt:
        quant.quantize_params(model, fmt, min_size=1 << 10)
    full = quant.param_bytes(model)
    sh.shard_params(model, mesh(dims), sh.DIT_RULES)
    local = sum(t.to_local().nbytes for t in list(model.parameters()) + list(model.buffers()))
    return {"full": full, "local": local}


def dit_placements(params, cfg_kw: dict, dims, fmt: Optional[str] = None):
    """{leaf: [placement per mesh dim]} of the sharded DiT (as strings)."""
    model = transformer_from_jax(params, Flux2TransformerConfig(**cfg_kw))
    if fmt:
        quant.quantize_params(model, fmt, min_size=1 << 10)
    sh.shard_params(model, mesh(dims), sh.DIT_RULES)
    out = {}
    for name, t in list(model.named_parameters()) + list(model.named_buffers()):
        out[name] = [str(p) for p in t.placements]
    return out


# -- ring attention ---------------------------------------------------------------------


def ring_forward(q, k, v, dims, axis: str, use_flash: Optional[bool] = None):
    from flux2_tpu_torch.parallel.ring_attention import ring_attention

    out = ring_attention(_t(q), _t(k), _t(v), mesh=mesh(dims), axis=axis, use_flash=use_flash)
    return _out(out)


def ring_grad(q, k, v, dims, axis: str, use_flash: bool):
    """d(sum(o^2))/d(q, k, v) through the ring, as numpy."""
    from flux2_tpu_torch.parallel.ring_attention import ring_attention

    leaves = [_t(a).requires_grad_() for a in (q, k, v)]
    o = ring_attention(*leaves, mesh=mesh(dims), axis=axis, use_flash=use_flash)
    (o.full_tensor() ** 2).sum().backward()
    return [t.grad.numpy() for t in leaves]


def ring_rejects_indivisible(dims):
    from flux2_tpu_torch.parallel.ring_attention import ring_attention

    x = torch.zeros(1, 2, 60, 32)
    try:
        ring_attention(x, x, x, mesh=mesh(dims), axis="tp")
    except ValueError as e:
        return str(e)
    return None


def sdpa_ring_fallback(q, k, v, dims):
    """``sdpa(ring=)`` on a sequence the axis does not divide: the warning's
    text (once, however many calls) and the dense result."""
    import logging

    from flux2_tpu_torch.ops import attention

    records = []

    class _Keep(logging.Handler):
        def emit(self, record):
            records.append(record.getMessage())

    log = logging.getLogger("flux2_tpu")
    handler = _Keep()
    log.addHandler(handler)
    try:
        m = mesh(dims)
        attention._warn_ring_fallback.cache_clear()
        out = attention.sdpa(_t(q), _t(k), _t(v), ring=(m, "tp"))
        attention.sdpa(_t(q), _t(k), _t(v), ring=(m, "tp"))
    finally:
        log.removeHandler(handler)
    return {"value": sh.gather(out).numpy(), "warnings": records}


# -- the pipeline --------------------------------------------------------------------------


def _pipe(params: dict, vae_params: dict, model: str, cfg_kw: dict, vae_kw: dict):
    from flux2_tpu_torch.io.jax_params import vae_encoder_from_jax, vae_from_jax
    from flux2_tpu_torch.pipeline.pipeline import Flux2Pipeline

    vc = VAEConfig(**vae_kw)
    return Flux2Pipeline(model=Flux2Model(model), transformer=transformer_from_jax(params, Flux2TransformerConfig(
        **cfg_kw)), vae=vae_from_jax(vae_params, vc), device=torch.device("cpu"),
        vae_encoder=vae_encoder_from_jax(vae_params, vc), vae_compute_dtype=torch.float32)


def pipeline_generate(params, vae_params, model: str, cfg_kw: dict, vae_kw: dict, gen_kw: dict, dims,
                      context_parallel: bool = False, reference: Optional[np.ndarray] = None):
    """``Flux2Pipeline.shard(mesh, context_parallel)`` then ``generate``
    (``noise=`` from the caller); with ``reference`` (an image) an I2I run."""
    pipe = _pipe(params, vae_params, model, cfg_kw, vae_kw)
    m = mesh(dims)
    pipe.shard(m, context_parallel=context_parallel)
    kw = {k: (_t(v) if isinstance(v, np.ndarray) else v) for k, v in gen_kw.items()}
    if reference is not None:
        kw["reference_latents"], kw["reference_ids"] = pipe.encode_reference_images([reference])
    res = pipe.generate(**kw)
    ring = None if pipe.ring is None else pipe.ring[1]
    dtensors = sum(isinstance(p, DTensor) for p in pipe.transformer.parameters())
    return {"latents": res.latents, "image": res.image, "ring": ring, "dtensors": dtensors}


# -- the text encoder ------------------------------------------------------------------------


def decoder_hidden_states(params, cfg_kw: dict, ids, dims, fmt: Optional[str] = None):
    dec = decoder_from_jax(params, DecoderConfig(**cfg_kw))
    if fmt:
        from flux2_tpu_torch.models.text_encoders.extractor import quantize_encoder_params

        quantize_encoder_params(dec, fmt)
    sh.shard_params(dec, mesh(dims), sh.DECODER_RULES)
    ids_t = _t(ids)
    with torch.no_grad():
        hs = dec.forward_hidden_states(ids_t, torch.ones_like(ids_t))
    return _out(hs)


def decoder_generate(params, cfg_kw: dict, ids, dims, n_tokens: int, fmt: Optional[str] = None):
    """A decoder sharded by ``shard_params``: its prefill logits over a cache of this rank's KV heads, and
    ``n_tokens`` greedy tokens through ``generation.generate``."""
    from flux2_tpu_torch.models.text_encoders import generation
    from flux2_tpu_torch.models.text_encoders.extractor import quantize_encoder_params

    dec = decoder_from_jax(params, DecoderConfig(**cfg_kw))
    if fmt:
        quantize_encoder_params(dec, fmt)
    sh.shard_params(dec, mesh(dims), sh.DECODER_RULES)
    cache = dec.new_cache(1, len(ids) + n_tokens, torch.float32, "cpu")
    with torch.inference_mode():
        logits, cache = dec.prefill(torch.tensor([ids]), cache)
    tokens = generation.generate(dec, list(ids), generation.GenerateParameters(max_tokens=n_tokens, temperature=0.0))
    return {"prefill": logits.numpy(), "plain": not isinstance(logits, DTensor), "tokens": tokens,
            "cache_heads": cache.k.shape[2], "cache_length": cache.length}


def decoder_placements(params, cfg_kw: dict, dims):
    dec = decoder_from_jax(params, DecoderConfig(**cfg_kw))
    return sh.make_shardings(dec, mesh_mod.mesh_shape(mesh(dims)), sh.DECODER_RULES)


VOCAB = 200


class WordTokenizer:
    """A deterministic stub chat tokenizer for the facade (JAX's test has one of its kind): one id a word."""

    pad_token_id = 0
    eos_token_id = None

    def __init__(self, vocab: int = VOCAB):
        self.vocab = vocab

    def apply_chat_template(self, messages, add_generation_prompt=False, **kwargs):
        text = " ".join(m["content"] for m in messages)
        return [sum(map(ord, w)) % (self.vocab - 3) + 3 for w in text.split()][:16]

    def decode(self, tokens):
        return " ".join(f"t{t}" for t in tokens)


def facade_shard_encoder(params, cfg_kw: dict, prompt: str, layers, dims):
    """``TextEncoders.shard`` of an attached tiny Qwen3: the Klein embeddings before and after."""
    from flux2_tpu_torch.models.text_encoders.facade import TextEncoders

    cfg = DecoderConfig(**cfg_kw)
    enc = TextEncoders()
    enc.attach("tiny", decoder_from_jax(params, cfg), cfg, WordTokenizer(), tuple(layers), recipe="klein")
    before = enc.extract_klein_embeddings(prompt, name="tiny").float().numpy()
    enc.shard("tiny", mesh(dims))
    after = enc.extract_klein_embeddings(prompt, name="tiny").float().numpy()
    return {"before": before, "after": after}


def facade_shard_generate(params, cfg_kw: dict, dims, uniforms, messages, prompt: str):
    """``TextEncoders.shard`` of an attached tiny Qwen3 with the dev tokenizer, then ``chat`` (greedy) and
    ``upsample_prompt`` (sampled, its draws JAX's ``uniforms``)."""
    from flux2_tpu_torch.models.text_encoders import generation
    from flux2_tpu_torch.models.text_encoders.facade import TextEncoders
    from flux2_tpu_torch.utils.dev_tokenizer import inline_bpe_tokenizer

    cfg = DecoderConfig(**cfg_kw)
    enc = TextEncoders()
    enc.attach("qwen3-tiny", decoder_from_jax(params, cfg), cfg, inline_bpe_tokenizer(), (1, 2), recipe="klein")
    enc.shard("qwen3-tiny", mesh(dims))
    sharded = isinstance(enc.get("qwen3-tiny").decoder.embed_tokens, DTensor)
    chat = enc.chat(messages, "qwen3-tiny", params=generation.GenerateParameters(max_tokens=12, temperature=0.0))
    draws = iter(uniforms)
    real = generation._draw_uniform
    generation._draw_uniform = lambda generator: torch.tensor(next(draws), dtype=torch.float32)
    try:
        upsampled = enc.upsample_prompt(prompt, "qwen3-tiny", seed=4)
    finally:
        generation._draw_uniform = real
    return {"sharded": sharded, "chat": chat, "upsampled": upsampled}


def mistral_vlm_sharded(lm_params, lm_kw: dict, vis_params, vis_kw: dict, image, dims):
    """A Mistral VLM whose LM is sharded by ``TextEncoders.shard``: a greedy 8-token ``analyze_image``."""
    from flux2_tpu_torch.io.jax_params import pixtral_from_jax
    from flux2_tpu_torch.models.text_encoders import generation
    from flux2_tpu_torch.models.text_encoders.facade import TextEncoders
    from flux2_tpu_torch.models.text_encoders.pixtral import PixtralVisionConfig
    from flux2_tpu_torch.models.text_encoders.vlm_service import MistralVLMService

    cfg, vcfg = DecoderConfig(**lm_kw), PixtralVisionConfig(**vis_kw)
    enc = TextEncoders()
    lm = enc.attach("mistral", decoder_from_jax(lm_params, cfg), cfg, WordTokenizer(cfg.vocab_size), (1, 2))
    enc.attach_vlm(MistralVLMService(lm.decoder, cfg, pixtral_from_jax(vis_params, vcfg), vcfg, lm.tokenizer,
                                     image_token_id=7))
    enc.shard("mistral", mesh(dims))
    greedy = generation.GenerateParameters(max_tokens=8, temperature=0.0)
    return {"sharded": isinstance(lm.decoder.embed_tokens, DTensor),
            "reply": enc._vlm.analyze_image(np.asarray(image), "describe the scene", gen_params=greedy)}


# -- partitioned W8A8 on one weight ------------------------------------------------------------


def _w8a8_case(dims, spec):
    """x [16, 512], a W8A8 weight [64, 512] whose codes are sharded by ``spec`` ((N axis, K axis)) on the
    mesh's active axes, and ``q_linear``'s W8A8 route sent to the kernel's plain version
    (``quant_kernels.w8a8_matmul`` on a CPU tensor), so each shard runs K5's arithmetic."""
    from flux2_tpu_torch.ops import quant_kernels as qk
    from flux2_tpu_torch.parallel import quant_partition as qp

    g = torch.Generator().manual_seed(0)
    x = torch.randn(16, 512, generator=g)
    wq = quant.to_w8a8(torch.randn(64, 512, generator=g))
    active = sh.active_mesh(mesh(dims))
    scale_spec = (spec[0],)
    w = quant.W8A8Tensor(sh.distribute(wq.q, active, sh.placements(spec, active)),
                         sh.distribute(wq.scale, active, sh.placements(scale_spec, active)), 512)
    orig = quant.q_linear
    quant.q_linear = lambda x_, w_: qk.w8a8_matmul(x_, w_) if isinstance(w_, quant.W8A8Tensor) else orig(x_, w_)
    try:
        y = qp.w8a8_matmul_partitioned(x, w)
    finally:
        quant.q_linear = orig
    return x, wq, y, active


def row_parallel_w8a8(dims):
    from flux2_tpu_torch.ops import quant_kernels as qk

    x, wq, y, active = _w8a8_case(dims, (None, "tp"))
    n = sh.axis_size(active, "tp")
    k = x.shape[1] // n
    per_shard = sum(qk.w8a8_matmul_reference(x[:, i * k:(i + 1) * k],
                                             quant.W8A8Tensor(wq.q[:, i * k:(i + 1) * k], wq.scale, k))
                    for i in range(n))
    return {"partitioned": sh.gather(y).numpy(), "per_shard_sum": per_shard.numpy(),
            "unsharded": qk.w8a8_matmul_reference(x, wq).numpy(), "k_local": k, "shards": n, "k": x.shape[1]}


def column_parallel_w8a8(dims):
    from flux2_tpu_torch.ops import quant_kernels as qk

    x, wq, y, active = _w8a8_case(dims, ("tp", None))
    i = active.mesh_dim_names.index("tp")
    n, r = active.size(i), active.get_local_rank(i)
    cols = wq.q.shape[0] // n
    full = qk.w8a8_matmul_reference(x, wq)
    placement = str(y.placements[i]).replace("Shard(dim=", "S(")
    return {"placement": placement, "local": y.to_local().numpy(),
            "unsharded_columns": full[:, r * cols:(r + 1) * cols].numpy()}


# -- serve --tp: rank 0 leads, the others follow -----------------------------------------------


def serve_leader_and_followers(params, vae_params, cfg_kw: dict, vae_kw: dict, gen_kw: dict, dims):
    """``serve``'s protocol on every rank of the pool: rank 0 calls ``_Leader.generate`` twice, the first
    cancelled at step 1 (its cancel check broadcast to the followers), the second whole, then sends the
    shutdown; the others ``_follow``. Returns rank 0's latents and what it saw, or the follower's end."""
    import torch.distributed as dist

    from flux2_tpu_torch import serve
    from flux2_tpu_torch.pipeline.pipeline import GenerationCancelled

    pipe = _pipe(params, vae_params, "klein-4b", cfg_kw, vae_kw)
    pipe.shard(mesh(dims))
    if dist.get_rank() != 0:
        serve._follow(pipe)
        return {"followed": True}
    leader = serve._Leader(pipe)
    kw = {k: (_t(v) if isinstance(v, np.ndarray) else v) for k, v in gen_kw.items()}
    steps = []
    try:
        leader.generate(**kw, cancel=lambda: True, on_progress=lambda k, n: steps.append(k))
        cancelled = None
    except GenerationCancelled as e:
        cancelled = str(e)
    res = leader.generate(**kw)
    serve._send_call(None, pipe.device)
    return {"cancelled": cancelled, "steps": steps, "latents": res.latents}
