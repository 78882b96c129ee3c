"""Partitioned matmuls over sharded weights: the port of ``flux2_tpu/parallel/quant_partition.py``.

A hand-written kernel launch is opaque to DTensor, as a ``pallas_call`` is to
XLA's partitioner, so every product with a sharded weight runs through
``torch.distributed.tensor.experimental.local_map`` (the counterpart of
``custom_partitioning``) with explicit placements, and the body calls the
unsharded ``ops.quant.q_linear`` on the local shards: K5 (with its prologue)
or K6 on a CUDA tensor that passes JAX's gate, the dequantizing path
elsewhere, ``F.linear`` for a dense weight. JAX's rules, for a weight
``[N, K]`` (the port's layout):

  - N sharded -> COLUMN-parallel: K's sharding is stripped (the weight is
    gathered over those axes), x's contraction dim is whole, every rank
    multiplies its N slice; the result stays N-sharded, no collective.
  - else K sharded -> ROW-parallel: x's contraction dim is sharded as K,
    every rank multiplies its K slice, and ONE all-reduce over the K axes
    sums the partial products (inside the body, JAX's ``psum``).
  - neither -> the replicated body.

W8A8 (``w8a8_matmul_partitioned``) takes all three. W4A8
(``w4a8_matmul_partitioned``) is column-parallel only: its packed codes'
K/2 and its scales' K/512 do not map onto x's K, so K is gathered, as
JAX's ``need_replication`` does. A dense weight takes W8A8's rules; a stored
``QTensor`` (K7's formats: JAX has no rule for it) takes the replicated body,
which gathers the weight, as XLA does with an opaque call. JAX routes W8A8 /
W4A8 here only under its partitioned runtime; the port always does.
Mesh axes of size 1 shard nothing and are treated as replicated. x's
leading dims keep their placements (a data-sharded batch, sp-sharded
tokens) unless the weight uses the same mesh axis.

In the row-parallel branch each rank's K5 prologue quantizes its own K slice
of the activations with its own per-row scale, so the sum is that of the
per-shard plain versions, not the unsharded kernel's result: what JAX's TPU
body (``_impl`` per shard) computes too.
"""

from __future__ import annotations

from typing import Callable, List, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from flux2_tpu_torch.parallel.sharding import replicate


def _axes(t: DTensor, dim: int) -> Tuple[int, ...]:
    """The mesh dims (of size > 1) that shard dimension ``dim`` of ``t``."""
    mesh = t.device_mesh
    return tuple(i for i, p in enumerate(t.placements) if isinstance(p, Shard) and p.dim == dim and mesh.size(i) > 1)


class _SumPartials(torch.autograd.Function):
    """The row-parallel all-reduce of the partial products. Its output is
    replicated, so every rank's cotangent is the whole one, and each partial
    takes it as it is: the backward is the identity (LoRA training through a
    sharded DiT differentiates through here)."""

    @staticmethod
    def forward(ctx, y, group):
        y = y.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SumGrads(torch.autograd.Function):
    """The identity on the column-parallel input, whose backward sums the
    ranks' cotangents: each rank's ``dy @ w`` covers its N slice only, and
    the input is replicated (Megatron's ``f``)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def _run(x, parts: Sequence[DTensor], rebuild: Callable, n_axes: Tuple[int, ...], k_axes: Tuple[int, ...]):
    """``q_linear(x, rebuild(*local parts))`` under ``local_map``: column-parallel
    over ``n_axes``, else row-parallel over ``k_axes``, else replicated. Each
    part is [N, ..] with the weight's K (or its packing) on dimension 1."""
    from flux2_tpu_torch.ops.quant import q_linear

    mesh = parts[0].device_mesh
    x = replicate(x, mesh)
    last = x.ndim - 1
    used = set(n_axes) | set(k_axes)
    x_in: List = [p if isinstance(p, Shard) and p.dim != last and i not in used else Replicate()
                  for i, p in enumerate(x.placements)]
    w_in = [[Replicate()] * mesh.ndim for _ in parts]
    out = list(x_in)
    for i in n_axes:
        for places in w_in:
            places[i] = Shard(0)
        out[i] = Shard(last)
    for i in k_axes:
        x_in[i] = Shard(last)
        w_in[0][i] = Shard(1)  # the codes (or dense weight) only: scales are per column

    def body(x_loc, *locs):
        for i in n_axes:
            x_loc = _SumGrads.apply(x_loc, mesh.get_group(i))
        y = q_linear(x_loc, rebuild(*locs))
        for i in k_axes:
            y = _SumPartials.apply(y, mesh.get_group(i))
        return y

    fn = local_map(body, out_placements=out, in_placements=(x_in, *w_in), device_mesh=mesh,
                   redistribute_inputs=True)
    return fn(x, *parts)


def w8a8_matmul_partitioned(x, w):
    """x [.., K] by a W8A8 weight whose codes [N, K] and scales [N] are DTensors."""
    from flux2_tpu_torch.ops.quant import W8A8Tensor

    n_axes = _axes(w.q, 0)
    k_axes = () if n_axes else _axes(w.q, 1)
    return _run(x, (w.q, w.scale), lambda q, s: W8A8Tensor(q, s, q.shape[-1]), n_axes, k_axes)


def w4a8_matmul_partitioned(x, w):
    """x [.., K] by a W4A8 weight whose packed codes [N, K/2] and scales
    [N, K/512] are DTensors: column-parallel, K gathered."""
    from flux2_tpu_torch.ops.quant import W4A8Tensor

    block, orig_in = w.block, w.orig_in
    return _run(x, (w.q, w.scale), lambda q, s: W4A8Tensor(q, s, block, orig_in), _axes(w.q, 0), ())


def dense_linear_partitioned(x, w: DTensor):
    """x [.., K] by a dense [N, K] DTensor weight, with W8A8's rules."""
    n_axes = _axes(w, 0)
    k_axes = () if n_axes else _axes(w, 1)
    return _run(x, (w,), lambda t: t, n_axes, k_axes)


def replicated_linear(x, w):
    """x by a quantized weight with DTensor buffers, gathered whole on every
    rank first (the replicated body: K7's formats)."""
    names = [n for n, b in w._buffers.items() if b is not None]
    parts = [w._buffers[n] for n in names]

    def rebuild(*locs):
        local = type(w).__new__(type(w))
        local.__dict__.update(w.__dict__)
        local._buffers = dict(w._buffers, **dict(zip(names, locs)))
        return local

    return _run(x, parts, rebuild, (), ())
