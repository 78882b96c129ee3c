"""Partition rules for the port's modules: the port of ``flux2_tpu/parallel/sharding.py``.

The rule tables are JAX's, verbatim: (path regex -> spec) over JAX's key
paths of *stacked* ``[L, in, out]`` leaves (``double_blocks/to_q``). The port
keeps per-block ``nn.ModuleList``s with ``[out, in]`` weights, and its
quantized buffers are ``[N, K]``, ``[N, K/2]``, ``[N, K/g]`` and ``[N]``
(``ops/quant.py``). So each port leaf is resolved through
``io/jax_params.jax_path`` to its JAX path, given the shape JAX's leaf has
(the stacked axis in front, ``[in, out]`` order, W8A8's ``[1, N]`` scale), run
through JAX's ``make_shardings`` logic (a spec longer than the leaf
replicates; an axis that does not divide its dimension drops), and the
result is carried back: the stacked axis dropped, the spec reversed into the
port's layout. A spec here is a tuple with one mesh axis name (or None) per
dimension of the port's tensor, so it names the same logical dimension (K,
N) as JAX's.

``shard_params`` turns each parameter and quantized buffer into a
``DTensor`` on the mesh with those placements; every rank keeps only its
chunk. ``local_shape`` gives a chunk's shape from the global shape, the spec
and the mesh shape alone, with no process group (the fit proofs use it on
``meta`` tensors).

The DTensor helpers the sharded forwards share live here too: ``replicate``
(a plain tensor as a ``Replicate()`` DTensor: DTensor refuses to mix the two),
``gather`` (an activation's full value), ``unshard_last``,
``on_head_boundaries`` and ``seq_shard`` (JAX's ``_seq_shard``: the token
axis pinned to the ring's mesh axis).
"""

from __future__ import annotations

import functools
import re
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
from torch import nn
from torch.distributed.tensor import DTensor, Replicate, Shard

from flux2_tpu_torch.parallel.mesh import FSDP_AXIS, TP_AXIS

Spec = Tuple[Optional[str], ...]
Rules = Sequence[Tuple[str, Spec]]


def P(*axes: Optional[str]) -> Spec:
    """JAX's ``PartitionSpec`` as a plain tuple."""
    return tuple(axes)


# --- FLUX.2 DiT (JAX's table; specs over the stacked [L, in, out] leaves) -----

DIT_RULES: Rules = (
    # stacked double-stream blocks [L, in, out]
    (r"double_blocks/(to_q|to_k|to_v|add_q|add_k|add_v)$", P(None, FSDP_AXIS, TP_AXIS)),
    (r"double_blocks/(to_out|add_out)$", P(None, TP_AXIS, FSDP_AXIS)),
    (r"double_blocks/(ff_in|ff_ctx_in)$", P(None, FSDP_AXIS, TP_AXIS)),
    (r"double_blocks/(ff_out|ff_ctx_out)$", P(None, TP_AXIS, FSDP_AXIS)),
    (r"double_blocks/norm_", P(None, None)),
    # stacked single-stream blocks
    (r"single_blocks/(to_q|to_k|to_v|mlp_gate|mlp_up)$", P(None, FSDP_AXIS, TP_AXIS)),
    (r"single_blocks/(out_attn|out_mlp)$", P(None, TP_AXIS, FSDP_AXIS)),
    (r"single_blocks/norm_", P(None, None)),
    # embedders / modulation: shard the big input dim over fsdp only
    (r"(x_embedder|context_embedder)/kernel$", P(FSDP_AXIS, TP_AXIS)),
    (r"(time_embed|guidance_embed)/linear1$", P(None, FSDP_AXIS)),
    (r"(time_embed|guidance_embed)/linear2$", P(FSDP_AXIS, None)),
    (r"(double_mod_img|double_mod_txt|single_mod)/kernel$", P(FSDP_AXIS, None)),
    (r"norm_out/kernel$", P(FSDP_AXIS, None)),
    (r"proj_out/kernel$", P(TP_AXIS, None)),
)

# --- Text encoders (Mistral / Qwen3) ------------------------------------------

DECODER_RULES: Rules = (
    (r"embed_tokens$", P(TP_AXIS, FSDP_AXIS)),
    (r"layers/(q_proj|k_proj|v_proj)$", P(None, FSDP_AXIS, TP_AXIS)),
    (r"layers/o_proj$", P(None, TP_AXIS, FSDP_AXIS)),
    (r"layers/(gate_proj|up_proj)$", P(None, FSDP_AXIS, TP_AXIS)),
    (r"layers/down_proj$", P(None, TP_AXIS, FSDP_AXIS)),
    (r"layers/(input_norm|post_attn_norm|q_norm|k_norm)$", P(None, None)),
    (r"final_norm$", P(None)),
    (r"lm_head$", P(FSDP_AXIS, TP_AXIS)),
)

# --- VAE: small; replicate ----------------------------------------------------

VAE_RULES: Rules = ()


def spec_for_path(path_str: str, rules: Rules) -> Spec:
    """The first rule matching a JAX key path (a quantized child's
    ``/[<flat index N>]`` suffix stripped, as JAX does), else replicated."""
    path_str = re.sub(r"/\[<flat index \d+>\]$", "", path_str)
    for pattern, spec in rules:
        if re.search(pattern, path_str):
            return spec
    return P()


def _leaves(module: nn.Module):
    """(owner, attribute, port name, tensor, JAX path, stacked, transposed) for
    every parameter and every quantized weight's buffer. A quantized buffer
    takes its weight's JAX path (JAX's flat-index children of one leaf);
    every 2-D parameter but a token-embedding table is an [out, in] linear."""
    from flux2_tpu_torch.io.jax_params import jax_path
    from flux2_tpu_torch.ops.quant import is_quantized

    for mname, mod in module.named_modules():
        if is_quantized(mod):
            path, stacked = jax_path(mname)
            for bname, buf in mod._buffers.items():
                if buf is not None:
                    yield mod, bname, f"{mname}.{bname}", buf, path, stacked, True
            continue
        for pname, p in mod._parameters.items():
            if p is None:
                continue
            name = f"{mname}.{pname}" if mname else pname
            path, stacked = jax_path(name)
            yield mod, pname, name, p, path, stacked, p.ndim == 2 and "embed_tokens" not in name


def resolve_spec(shape: Sequence[int], path: str, stacked: bool, transposed: bool, mesh_shape: Dict[str, int],
                 rules: Rules) -> Spec:
    """One port leaf's spec: JAX's ``make_shardings`` on the shape JAX's leaf
    has, carried back to the port's layout (see the module docstring)."""
    jshape = tuple(shape)
    if transposed:
        jshape = jshape[::-1]
        if len(jshape) == 1:  # W8A8's per-column scale: JAX's [1, N]
            jshape = (1, *jshape)
    if stacked:  # no rule shards the stacked axis, so its length does not matter
        jshape = (1, *jshape)
    spec = spec_for_path(path, rules)
    if len(spec) > len(jshape):
        spec = P()
    fixed = [axis if axis is not None and jshape[i] % mesh_shape[axis] == 0 else None for i, axis in enumerate(spec)]
    fixed += [None] * (len(jshape) - len(fixed))
    if stacked:
        fixed = fixed[1:]
    if transposed:
        fixed = fixed[::-1][: len(shape)]
    return tuple(fixed)


def make_shardings(module: nn.Module, mesh_shape: Dict[str, int], rules: Rules) -> Dict[str, Spec]:
    """{port leaf name: spec} for every parameter and quantized buffer of
    ``module``, resolved from ``rules`` (JAX's ``make_shardings``)."""
    return {name: resolve_spec(t.shape, path, stacked, transposed, mesh_shape, rules)
            for _, _, name, t, path, stacked, transposed in _leaves(module)}


def local_shape(shape: Sequence[int], spec: Spec, mesh_shape: Dict[str, int]) -> Tuple[int, ...]:
    """The shape of one rank's chunk of a tensor of ``shape`` under ``spec``."""
    return tuple(n // mesh_shape[a] if a is not None else n for n, a in zip(shape, tuple(spec) + (None,) * len(shape)))


@functools.lru_cache(maxsize=16)
def active_mesh(mesh):
    """The mesh's axes of size > 1 as a sub-mesh (its ``tp`` axis when every
    axis has size 1). DTensors live there: DTensor picks an operator's
    placements by enumerating them over every mesh axis, so the size-1 axes
    would multiply its work and change nothing."""
    if mesh is None:
        return None
    names = tuple(n for n, size in zip(mesh.mesh_dim_names, mesh.mesh.shape) if size > 1) or (TP_AXIS,)
    return mesh if names == tuple(mesh.mesh_dim_names) else mesh[names]


def shards_nothing(mesh) -> bool:
    """Every axis of the mesh has size 1 (one rank): ``Flux2Pipeline.shard``
    and ``TextEncoders.shard`` then leave the weights as they are."""
    return mesh.size() == 1


def axis_size(mesh, axis: str) -> int:
    """A named axis's size (1 for an axis the mesh does not have)."""
    names = mesh.mesh_dim_names
    return mesh.size(names.index(axis)) if axis in names else 1


def placements(spec: Spec, mesh) -> Tuple:
    """DTensor placements, one per mesh dimension, for a spec."""
    return tuple(Shard(spec.index(a)) if a in spec else Replicate() for a in mesh.mesh_dim_names)


def _chunk(t: torch.Tensor, mesh, places) -> torch.Tensor:
    """This rank's chunk of the full tensor ``t`` (every rank holds the same ``t``)."""
    for i, p in enumerate(places):
        if isinstance(p, Shard):
            t = t.chunk(mesh.size(i), dim=p.dim)[mesh.get_local_rank(i)]
    return t.contiguous()


def distribute(t: torch.Tensor, mesh, places) -> DTensor:
    """A DTensor from the full ``t`` that every rank holds, with no collective."""
    return DTensor.from_local(_chunk(t.detach(), mesh, places), mesh, places, run_check=False)


def shard_params(module: nn.Module, mesh, rules: Rules) -> nn.Module:
    """Turn every parameter and quantized buffer of ``module`` into a DTensor
    with its rule's placements, in place, on ``active_mesh(mesh)``, which
    becomes ``module.mesh``. Leaves already sharded stay as they are."""
    mshape = dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
    mesh = active_mesh(mesh)
    for owner, attr, _, t, path, stacked, transposed in list(_leaves(module)):
        if isinstance(t, DTensor):
            continue
        spec = resolve_spec(t.shape, path, stacked, transposed, mshape, rules)
        d = distribute(t, mesh, placements(spec, mesh))
        if attr in owner._parameters:
            owner._parameters[attr] = nn.Parameter(d, requires_grad=False)
        else:
            owner._buffers[attr] = d
    module.mesh = mesh
    return module


def activation_sharding(mesh, *axes: Optional[str]) -> Tuple:
    """Placements of an activation whose dimension i is sharded over ``axes[i]``
    (JAX's API; the port's forwards place their activations themselves)."""
    return placements(P(*axes), mesh)


# -- the sharded forwards' helpers ----------------------------------------------------


def replicate(t: Optional[torch.Tensor], mesh) -> Any:
    """``t`` as a ``Replicate()`` DTensor on ``mesh`` (None and DTensors pass);
    every rank holds the same ``t``."""
    if t is None or mesh is None or isinstance(t, DTensor):
        return t
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim, run_check=False)


def gather(t):
    """An activation's full value as a plain tensor (a DTensor's ``full_tensor``)."""
    return t.full_tensor() if isinstance(t, DTensor) else t


def unshard_last(t):
    """A DTensor whose last dimension is whole on every rank (an all-gather
    where it is sharded); anything else passes."""
    if not isinstance(t, DTensor):
        return t
    last = t.ndim - 1
    if not any(isinstance(p, Shard) and p.dim == last for p in t.placements):
        return t
    places = [Replicate() if isinstance(p, Shard) and p.dim == last else p for p in t.placements]
    return t.redistribute(t.device_mesh, places)


def on_head_boundaries(x, num_heads: int):
    """``x`` [.., H*D], gathered whole on its last dimension when that is
    split a number of ways that does not divide ``num_heads`` (a column split
    falling inside a head); anything else passes."""
    if not isinstance(x, DTensor):
        return x
    ways = 1
    for i, p in enumerate(x.placements):
        if isinstance(p, Shard) and p.dim == x.ndim - 1:
            ways *= x.device_mesh.size(i)
    return unshard_last(x) if num_heads % ways else x


def seq_shard(x, ring: Optional[tuple]):
    """JAX's ``_seq_shard``: the token axis of [B, S, D] on the ring's mesh
    axis, when context parallelism is on and S divides; else ``x``."""
    if ring is None or not isinstance(x, DTensor):
        return x
    mesh, axis = x.device_mesh, ring[1]
    n = axis_size(mesh, axis)
    if n == 1 or x.shape[1] % n:
        return x
    places = [Shard(1) if name == axis else Replicate() for name in mesh.mesh_dim_names]
    return x.redistribute(mesh, places)

