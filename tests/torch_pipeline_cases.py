"""Rank-side cases of the port's pipeline-parallel CPU tests (``tests/torch_rank_pool.py``).

Every function here runs on each rank of the pool at once, on the CPU with
gloo, and returns numpy (or plain Python) results. Nothing here imports JAX
or ``flux2_tpu``: weights arrive as JAX's parameter trees of numpy leaves
and load through ``flux2_tpu_torch.io.jax_params``. A case on a mesh of
fewer ranks than the pool builds the mesh on every rank (DeviceMesh
creation is collective) and returns None on the ranks outside it.
"""

from __future__ import annotations

import copy
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from flux2_tpu_torch.io.jax_params import transformer_from_jax
from flux2_tpu_torch.models.flux2.config import Flux2TransformerConfig
from flux2_tpu_torch.ops import quant
from flux2_tpu_torch.parallel import pipeline as pp
from flux2_tpu_torch.parallel.mesh import mesh_shape
from flux2_tpu_torch.training import lora as lora_mod
from flux2_tpu_torch.training import trainer


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a))


def _mesh(dims: Sequence[int], n_ranks: Optional[int] = None, dcn: bool = False):
    """A (data, pp[, tp]) mesh over the first ``n_ranks`` ranks (default all); None off it."""
    data, stages, tp = (list(dims) + [1])[:3]
    devices = list(range(n_ranks)) if n_ranks else None
    m = pp.make_pp_mesh(stages, data, tp, devices=devices, pp_over_dcn=dcn, device_type="cpu")
    return m if m.get_coordinate() is not None else None


def _inputs(inputs: dict):
    return [_t(inputs[k]) for k in ("hidden", "txt", "t", "cos", "sin")]


def _lora(tree: dict) -> lora_mod.LoRA:
    """The port's LoRA from JAX's {group: {leaf: {a: [L, in, r], b: [L, r, out]}}} of numpy leaves."""
    blocks = {}
    for group, leaves in tree.items():
        n = next(iter(leaves.values()))["a"].shape[0]
        blocks[group] = [{leaf: lora_mod.Adapter(_t(ab["a"][i]).clone(), _t(ab["b"][i]).clone())
                          for leaf, ab in leaves.items()} for i in range(n)]
    return lora_mod.LoRA(blocks)


def _grads(lora) -> dict:
    return {n: p.grad.numpy().copy() for n, p in lora.named_parameters()}


# -- the mesh and the specs --------------------------------------------------------------


def mesh_layouts():
    """Shapes, rank arrays and error texts of JAX's mesh layout cases."""
    out = {}
    for key, kw in {"4x2": dict(pp=4, data=2), "4x2_dcn": dict(pp=4, data=2, pp_over_dcn=True),
                    "2x2x2": dict(pp=2, data=2, tp=2), "2x2x2_dcn": dict(pp=2, data=2, tp=2, pp_over_dcn=True)}.items():
        m = pp.make_pp_mesh(**kw, device_type="cpu")
        out[key] = (mesh_shape(m), m.mesh.tolist())
    errors = []
    for kw in (dict(pp=3, data=2), dict(pp=2, data=2, tp=3)):
        try:
            pp.make_pp_mesh(**kw, device_type="cpu")
        except ValueError as e:
            errors.append(str(e))
    out["errors"] = errors
    return out


def specs(params, cfg_kw: dict, dims, fmt: Optional[str] = None):
    """``pp_param_sharding`` of the DiT (quantized to ``fmt``) on a (data, pp[, tp]) mesh."""
    model = transformer_from_jax(params, Flux2TransformerConfig(**cfg_kw))
    if fmt:
        quant.quantize_params(model, fmt, min_size=1 << 10)
    return pp.pp_param_sharding(_mesh(dims), model)


def stage_bytes(params, cfg_kw: dict, dims, fmt: Optional[str] = None):
    """This rank's bytes after ``place_stages`` against ``stage_param_bytes``,
    the whole model's, and which blocks it kept."""
    model = transformer_from_jax(params, Flux2TransformerConfig(**cfg_kw))
    if fmt:
        quant.quantize_params(model, fmt, min_size=1 << 10)
    full = quant.param_bytes(model)
    m = _mesh(dims)
    pp.place_stages(model, m)
    stage = m.get_local_rank("pp")
    kept = {g: [i for i, b in enumerate(getattr(model, g)) if not any(t.is_meta for t in b.parameters())]
            for g in pp.STACKS}
    n_stages, tp = dims[1], (dims[2] if len(dims) > 2 else 1)
    return {"local": pp.local_param_bytes(model), "expected": pp.stage_param_bytes(model, n_stages, tp, stage),
            "full": full, "stage": stage, "kept": kept}


# -- the forward ----------------------------------------------------------------------------


def forward(params, cfg_kw: dict, inputs: dict, dims, m: Optional[int] = None, n_ranks: Optional[int] = None):
    """``pipelined_forward`` on a placed DiT; the output on every rank of the mesh."""
    model = transformer_from_jax(params, Flux2TransformerConfig(**cfg_kw))
    mesh = _mesh(dims, n_ranks)
    if mesh is None:
        return None
    pp.place_stages(model, mesh)
    with torch.no_grad():
        y = pp.pipelined_forward(model, *_inputs(inputs), mesh=mesh, num_microbatches=m)
    return y.numpy()


def lora_grads(params, cfg_kw: dict, inputs: dict, lora_tree: dict, scale: float, dims, n_ranks: int):
    """sum(out**2) and the LoRA gradients: the dense forward, and the pipelined
    one with ``remat=True`` after ``reduce_grads``."""
    config = Flux2TransformerConfig(**cfg_kw)
    dense = transformer_from_jax(params, config)
    model = transformer_from_jax(params, config)
    mesh = _mesh(dims, n_ranks)
    if mesh is None:
        return None
    lo_d, lo_p = _lora(lora_tree), _lora(lora_tree)
    loss_d = (dense(*_inputs(inputs), lora=lo_d, lora_scale=scale) ** 2).sum()
    loss_d.backward()
    pp.place_stages(model, mesh)
    fwd = pp.make_pp_forward(mesh)
    loss_p = (fwd(model, *_inputs(inputs), remat=True, lora=lo_p, lora_scale=scale) ** 2).sum()
    loss_p.backward()
    fwd.reduce_grads(list(lo_p.parameters()))
    return {"dense": (float(loss_d), _grads(lo_d)), "piped": (float(loss_p), _grads(lo_p))}


def train_step(params, cfg_kw: dict, batch: dict, dims, n_ranks: int, fmt: Optional[str] = None):
    """One ``make_train_step`` through ``make_pp_forward`` against the dense
    step from the same generator seed (with ``fmt``: the pp step alone, on a
    quantized base): the losses and the LoRA after the update."""
    config = Flux2TransformerConfig(**cfg_kw)
    mesh = _mesh(dims, n_ranks)
    if mesh is None:
        return None
    tcfg = trainer.TrainConfig(rank=2, alpha=2.0 if fmt else 4.0, remat=True, grad_accumulation=1)
    batch = {k: _t(v) for k, v in batch.items()}
    out = {}
    for kind in (("pp",) if fmt else ("dense", "pp")):
        model = transformer_from_jax(params, config)
        if fmt:
            model.to(torch.bfloat16)
            quant.quantize_params(model, fmt, min_size=1 << 10)
        state = trainer.init_train_state(model, tcfg, torch.Generator().manual_seed(1))
        fwd = None
        if kind == "pp":
            pp.place_stages(model, mesh)
            fwd = pp.make_pp_forward(mesh)
        step = trainer.make_train_step(model, tcfg, forward_fn=fwd)
        metrics = step(state.lora, state.optimizer, dict(batch), torch.Generator().manual_seed(5))
        held_out = trainer.make_eval_loss(model, tcfg, forward_fn=fwd)(state.lora, dict(batch),
                                                                       torch.Generator().manual_seed(6))
        out[kind] = {"loss": float(metrics["loss"]), "grad_norm": float(metrics["grad_norm"]),
                     "held_out": float(held_out),
                     "lora": {n: p.detach().numpy().copy() for n, p in state.lora.named_parameters()}}
    return out


def preview_forward(params, cfg_kw: dict, inputs: dict, lora_tree: dict, scale: float, dims):
    """The previews' path: ``merged_copy`` of the stage-placed DiT run as a
    ``PipelinedDiT`` (one microbatch, no data split) on a batch of one,
    against the dense DiT with the LoRA merged; and whether the placed base
    kept its weights (R5)."""
    config = Flux2TransformerConfig(**cfg_kw)
    dense = lora_mod.merge_into_params(transformer_from_jax(params, config), _lora(lora_tree), scale)
    model = transformer_from_jax(params, config)
    mesh = _mesh(dims)
    pp.place_stages(model, mesh)
    before = {n: t.clone() for n, t in model.state_dict().items() if not t.is_meta}
    merged = lora_mod.merged_copy(model, _lora(lora_tree), scale)
    one = {k: (v[:1] if k in ("hidden", "txt", "t") else v) for k, v in inputs.items()}
    with torch.no_grad():
        y = pp.PipelinedDiT(merged, mesh)(*_inputs(one))
        y_dense = dense(*_inputs(one))
    kept = all(torch.equal(before[n], t) for n, t in model.state_dict().items() if n in before)
    return {"piped": y.numpy(), "dense": y_dense.numpy(), "base_kept": kept,
            "bytes": (pp.local_param_bytes(model), pp.local_param_bytes(merged))}


def validation_errors(params, cfg_kw: dict, odd_kw: dict, inputs: dict):
    """The texts of ``pipelined_forward``'s errors: 3 microbatches of 8, and
    an odd stack on pp=2 (on the (4, 2) mesh)."""
    model = transformer_from_jax(params, Flux2TransformerConfig(**cfg_kw))
    mesh = _mesh((4, 2))
    errors = []
    for config, m in ((None, 3), (Flux2TransformerConfig(**odd_kw), None)):
        probe = copy.copy(model)
        if config is not None:
            probe.config = config
        try:
            pp.pipelined_forward(probe, *_inputs(inputs), mesh=mesh, num_microbatches=m)
        except ValueError as e:
            errors.append(str(e))
    dist.barrier()
    return errors
