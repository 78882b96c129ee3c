"""Ring attention: sequence-parallel exact attention over the mesh.

Port of ``flux2_tpu/parallel/ring_attention.py``. The token axis of q/k/v
is sharded over one mesh axis; K/V blocks rotate around the ring of that
axis's ranks while each rank accumulates an exact online softmax over its
own queries. FLUX.2's joint attention is non-causal, so every rank needs
every K/V block once: the pure ring.

Two bodies, as JAX's:
  - ``_ring_einsum``: f32 online softmax over einsum blocks (the plain
    version; fully differentiable);
  - ``_ring_flash``: each step's block through K2 (``ops.flash_attention.
    flash_attention_lse``, ``csrc/flash_attention.cu``), the blocks merged by
    ``logaddexp`` of their row LSEs. Its backward recomputes through the
    einsum ring and differentiates that (JAX's ``_ring_flash_bwd``).

JAX's ``ppermute`` is ``_Shift``: one ``batch_isend_irecv`` to the next rank
and from the previous one, an autograd function whose backward shifts the
gradient the other way round (send/recv have no autograd). On a ring of one
rank the shift is the identity and sends nothing. The wasted last rotation
of JAX's scan is skipped. The ring runs under ``local_map`` on q/k/v
DTensors laid out ``(batch, heads on tp, tokens on the ring axis, dim)``;
plain q/k/v on a mesh of one rank (an unsharded model under context
parallelism) take the ring of one directly and give a plain tensor.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from flux2_tpu_torch.ops import flash_attention as fa
from flux2_tpu_torch.parallel.mesh import TP_AXIS
from flux2_tpu_torch.parallel.sharding import active_mesh, axis_size, replicate

NEG_INF = -1e30


def _ring_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def _shift_raw(x: torch.Tensor, group, step: int) -> torch.Tensor:
    """Send ``x`` ``step`` ranks on round the ring (``step`` = +1 or -1) and
    return what arrives from the other side; ``group`` None is a ring of one."""
    n = _ring_size(group)
    if n == 1:
        return x
    me = dist.get_rank(group)
    x = x.contiguous()
    out = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x, dist.get_global_rank(group, (me + step) % n), group),
           dist.P2POp(dist.irecv, out, dist.get_global_rank(group, (me - step) % n), group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


class _Shift(torch.autograd.Function):
    """JAX's ``ppermute`` to the next rank; the backward shifts back."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _shift_raw(x, group, 1)

    @staticmethod
    def backward(ctx, g):
        return _shift_raw(g, ctx.group, -1), None


def _ring_einsum(q, k, v, group, scale: float) -> torch.Tensor:
    """Einsum online-softmax ring (f32 accumulators); differentiable."""
    n = _ring_size(group)
    b, h, s_loc, d = q.shape
    qf = q.float()
    m = torch.full((b, h, s_loc, 1), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, s_loc, 1), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, h, s_loc, d), dtype=torch.float32, device=q.device)
    k_cur, v_cur = k, v
    for step in range(n):
        s = torch.einsum("bhqd,bhkd->bhqk", qf, k_cur.float()) * scale
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.einsum("bhqk,bhkd->bhqd", p, v_cur.float())
        m = m_new
        if step < n - 1:
            k_cur, v_cur = _Shift.apply(k_cur, group), _Shift.apply(v_cur, group)
    return (acc / l).to(q.dtype)


class _RingFlash(torch.autograd.Function):
    """K2 on every ring step's block, merged by LSE. The backward recomputes
    the ring with ``_ring_einsum`` and differentiates it (JAX's custom VJP)."""

    @staticmethod
    def forward(ctx, q, k, v, group, scale):
        n = _ring_size(group)
        b, h, s_loc, d = q.shape
        lse = torch.full((b, h, s_loc), NEG_INF, dtype=torch.float32, device=q.device)
        out = torch.zeros((b, h, s_loc, d), dtype=torch.float32, device=q.device)
        k_cur, v_cur = k, v
        for step in range(n):
            o_i, lse_i = fa.flash_attention_lse(q, k_cur, v_cur, scale)
            lse_new = torch.logaddexp(lse, lse_i)
            out = out * torch.exp(lse - lse_new)[..., None] + o_i.float() * torch.exp(lse_i - lse_new)[..., None]
            lse = lse_new
            if step < n - 1:
                k_cur, v_cur = _shift_raw(k_cur, group, 1), _shift_raw(v_cur, group, 1)
        ctx.save_for_backward(q, k, v)
        ctx.group, ctx.scale = group, scale
        return out.to(q.dtype)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_() for t in (q, k, v)]
            out = _ring_einsum(*leaves, ctx.group, ctx.scale)
            grads = torch.autograd.grad(out, leaves, g.to(q.dtype))
        return (*grads, None, None)


def _use_flash_default(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> bool:
    """On for CUDA tensors that K2's gate admits, unless ``FLUX2_DISABLE_FLASH=1``."""
    return q.is_cuda and os.environ.get("FLUX2_DISABLE_FLASH", "0") != "1" and fa.supported(q, k, v)


def _ring_local(q, k, v, group, scale: float, use_flash: Optional[bool]) -> torch.Tensor:
    """The ring over this rank's blocks of q/k/v (plain tensors): K2's or the einsum's."""
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if _use_flash_default(q, k, v) if use_flash is None else use_flash:
        return _RingFlash.apply(q, k, v, group, float(scale))
    return _ring_einsum(q, k, v, group, float(scale))


def ring_attention(
    q,
    k,
    v,
    mesh,
    axis: str = TP_AXIS,
    scale: Optional[float] = None,
    use_flash: Optional[bool] = None,
    bounded_logits: bool = False,
):
    """Exact non-causal attention with the token axis sharded over ``axis``.

    q/k/v: [B, H, S, D] (plain tensors every rank holds alike, or DTensors);
    S must divide by the axis size. Returns a DTensor laid out (batch, heads
    on tp when the ring is not on tp and H divides, tokens on ``axis``, dim),
    or a plain tensor for plain q/k/v on a mesh of one rank.
    ``use_flash`` (default: ``_use_flash_default`` on the local block) runs
    each step's block through K2; otherwise the einsum ring. ``bounded_logits``
    is taken for JAX's signature and changes nothing here.
    """
    del bounded_logits
    if scale is None:
        scale = q.shape[-1] ** -0.5
    n = axis_size(mesh, axis)
    if q.shape[2] % n or k.shape[2] % n:
        raise ValueError(f"sequence {q.shape[2]}/{k.shape[2]} not divisible by {axis}={n}")
    if mesh.size() == 1 and not isinstance(q, DTensor):
        return _ring_local(q, k, v, None, scale, use_flash)
    mesh = active_mesh(mesh)
    names = mesh.mesh_dim_names
    # Keep the head axis on tp inside the ring when the ring is on another
    # axis: otherwise every rank would gather all heads at the boundary.
    tp = axis_size(mesh, TP_AXIS)
    places = [Replicate()] * mesh.ndim
    if n > 1:
        places[names.index(axis)] = Shard(2)
    if axis != TP_AXIS and tp > 1 and q.shape[1] % tp == 0:
        places[names.index(TP_AXIS)] = Shard(1)
    group = mesh.get_group(names.index(axis)) if n > 1 else None
    q, k, v = (replicate(x, mesh) for x in (q, k, v))

    def body(q_loc, k_loc, v_loc):
        return _ring_local(q_loc, k_loc, v_loc, group, scale, use_flash)

    fn = local_map(body, out_placements=places, in_placements=(places, places, places), device_mesh=mesh,
                   redistribute_inputs=True)
    return fn(q, k, v)
