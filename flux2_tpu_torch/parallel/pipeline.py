"""Pipeline parallelism (GPipe) over the DiT's block stacks: the port of
``flux2_tpu/parallel/pipeline.py``.

Stage ``p`` of ``P`` holds blocks ``[p*L/P, (p+1)*L/P)`` of each stack; the
prelude (embedders, time embedding, modulations) and the AdaLN head run
whole on every rank. The batch splits into ``M`` microbatches, each split
again over the ``data`` axis; the two stacks run as two chained pipelines
of ``M + P - 1`` ticks, and at tick ``t`` stage ``p`` applies its blocks to
microbatch ``t - p``. Per-microbatch modulations are indexed locally and
never sent; the RoPE tables are replicated.

Where JAX's single controller runs the tick scan under ``shard_map`` on
arrays sharded ``P("pp")``, torch runs one process per rank:

- ``place_stages`` keeps this rank's blocks and moves every other block to
  the ``meta`` device, quantized buffers included, so a rank's parameter
  bytes fall to its stage's share (what JAX's ``P("pp")`` buys). With a
  ``tp`` axis the kept blocks' leaves become DTensors on the mesh's ``tp``
  sub-mesh, with ``DIT_RULES``' placements on their feature dims; a stage
  runs its blocks on ``Replicate()`` DTensors of the carry and gives back
  its full value. On a mesh of one rank nothing becomes a DTensor.
- JAX's ``ppermute`` is ``_Exchange``: per tick, one ``batch_isend_irecv``
  of the carry to the next stage and from the previous one, an autograd
  function whose backward sends the cotangents the other way. The chain is
  open: stage ``P - 1`` sends nothing and stage 0 injects its microbatch.
  Bubble ticks are skipped, not computed and thrown away. The double
  stack's output goes from stage ``P - 1`` to stage 0 the same way.
- JAX's ``psum`` of zeros but on the last stage is ``_FromLast``, a
  broadcast from stage ``P - 1``, and the data ranks' rows meet in
  ``_GatherData``, an all-gather. Every rank then computes the same loss
  from the same output, so both backwards take the rank's own cotangent and
  sum none: a sum would make each gradient ``P`` (or ``data``) times too
  large. ``PPForward.reduce_grads`` then sums the adapters' gradients over
  ``pp`` (other stages' are zero) and over ``data`` (each data rank's are
  its rows' part), which gives every rank the dense gradient.
- Every communicating autograd node takes and returns a zero-size token,
  which orders them on each rank, so every rank runs their backwards in the
  reverse of the forward's order and the point-to-point pairs match.

Same arithmetic as the dense forward: the same block functions in the same
order on each microbatch.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.device_mesh import DeviceMesh

from flux2_tpu_torch.models.flux2.transformer import run_block
from flux2_tpu_torch.parallel import mesh as mesh_mod
from flux2_tpu_torch.parallel import sharding as sh

PP_AXIS = "pp"
DATA_AXIS = "data"
TP_AXIS = "tp"
STACKS = ("double_blocks", "single_blocks")


def make_pp_mesh(
    pp: int,
    data: int = 1,
    tp: int = 1,
    devices: Optional[Sequence[int]] = None,
    pp_over_dcn: bool = False,
    device_type: str = "cuda",
) -> DeviceMesh:
    """A (data, pp[, tp]) mesh over ``devices`` (ranks; default all), each rank
    at the coordinates JAX gives that device id. ``tp > 1`` adds a
    tensor-parallel axis inside each stage. ``pp_over_dcn`` strides the stage
    axis over contiguous groups of ranks (with ``tp``: stage ``s`` holds a
    contiguous ``data * tp`` block), JAX's layout for stages across slices."""
    devices = list(devices if devices is not None else mesh_mod.ranks(device_type))
    mesh_mod.ensure_process_group(device_type)
    n = len(devices)
    if pp * data * tp != n:
        raise ValueError(f"pp*data*tp = {pp}*{data}*{tp} != {n} devices")
    ids = np.asarray(devices, dtype=np.int64)
    if tp == 1:
        arr = ids.reshape(pp, data).T if pp_over_dcn else ids.reshape(data, pp)
        names: Tuple[str, ...] = (DATA_AXIS, PP_AXIS)
    else:
        arr = ids.reshape(pp, data, tp).transpose(1, 0, 2) if pp_over_dcn else ids.reshape(data, pp, tp)
        names = (DATA_AXIS, PP_AXIS, TP_AXIS)
    return DeviceMesh(device_type, torch.from_numpy(np.ascontiguousarray(arr)), mesh_dim_names=names)


# -- stage placement ---------------------------------------------------------------


def _block_index(name: str) -> Tuple[Optional[str], int]:
    """``double_blocks.3.to_q`` -> ("double_blocks", 3); a prelude or head leaf -> (None, -1)."""
    parts = name.split(".")
    if len(parts) > 2 and parts[0] in STACKS and parts[1].isdigit():
        return parts[0], int(parts[1])
    return None, -1


def _jax_spec(shape: Sequence[int], path: str, stacked: bool, transposed: bool, tp: int, n_layers: int) -> tuple:
    """JAX's ``pp_param_sharding`` spec of the JAX leaf a port leaf belongs to:
    () off the stacks, ("pp",) on a stacked leaf, and with ``tp > 1`` the
    rule's tp placements on the feature dims they divide (fsdp dropped)."""
    if not stacked:
        return ()
    if tp == 1:
        return (PP_AXIS,)
    jshape = tuple(shape)
    if transposed:
        jshape = jshape[::-1]
        if len(jshape) == 1:  # W8A8's per-column scale: JAX's [1, N]
            jshape = (1, *jshape)
    jshape = (n_layers, *jshape)
    axes = [PP_AXIS]
    for i, ax in enumerate(list(sh.spec_for_path(path, sh.DIT_RULES))[1:], start=1):
        axes.append(TP_AXIS if ax == TP_AXIS and i < len(jshape) and jshape[i] % tp == 0 else None)
    return tuple(axes[: max(1, len(jshape))])


def _port_spec(jspec: tuple, shape: Sequence[int], transposed: bool) -> tuple:
    """A stacked leaf's JAX spec carried to the port's layout: the layer axis
    dropped, [in, out] reversed into [out, in]."""
    rest = list(jspec[1:]) + [None] * (len(shape) + 1 - len(jspec))
    if transposed:
        rest = rest[::-1][: len(shape)] if len(shape) > 1 else rest[-1:]
    return tuple(rest[: len(shape)])


def _specs(module: nn.Module, tp: int):
    """(owner, attr, port name, tensor, JAX path, JAX spec, port spec) for every
    parameter and quantized buffer of the DiT ``module``."""
    n_layers = {group: len(getattr(module, group)) for group in STACKS}
    for owner, attr, name, t, path, stacked, transposed in sh._leaves(module):
        group, _ = _block_index(name)
        jspec = _jax_spec(t.shape, path, stacked, transposed, tp, n_layers.get(group, 0))
        port = _port_spec(jspec, t.shape, transposed) if stacked else ()
        yield owner, attr, name, t, path, jspec, port


def pp_param_sharding(mesh: DeviceMesh, module: nn.Module) -> Dict[str, tuple]:
    """{JAX path: JAX's spec} for the DiT ``module`` on ``mesh`` (JAX's
    ``pp_param_sharding``): ("pp",) on a stacked block leaf, () on the prelude
    and the head, and with ``tp > 1`` ``DIT_RULES``' tp placements on the
    feature dims they divide. A quantized weight's buffers are keyed
    ``<path>/<buffer>`` (JAX's flat-index children). ``place_stages`` applies it."""
    tp = sh.axis_size(mesh, TP_AXIS)
    out = {}
    for owner, attr, _, _, path, jspec, _ in _specs(module, tp):
        out[f"{path}/{attr}" if attr in owner._buffers else path] = jspec
    return out


def stage_range(n_layers: int, n_stages: int, stage: int) -> range:
    """The blocks of one stack that stage ``stage`` holds."""
    per = n_layers // n_stages
    return range(stage * per, (stage + 1) * per)


def _check_stacks(config, n_stages: int) -> None:
    if config.num_layers % n_stages or config.num_single_layers % n_stages:
        raise ValueError(
            f"block stacks ({config.num_layers} double, {config.num_single_layers} single) "
            f"must divide by pp={n_stages}"
        )


def place_stages(module: nn.Module, mesh: DeviceMesh) -> nn.Module:
    """Place the DiT ``module`` on ``mesh``, in place: this rank keeps its
    stage's blocks, every other block moves to ``meta`` (no storage), the
    prelude and head stay plain; with ``tp > 1`` the kept blocks' leaves
    become DTensors on the ``tp`` sub-mesh. Sets ``module.pp_mesh``."""
    n_stages, tp = sh.axis_size(mesh, PP_AXIS), sh.axis_size(mesh, TP_AXIS)
    _check_stacks(module.config, n_stages)
    stage = mesh.get_local_rank(PP_AXIS)
    for group in STACKS:
        blocks = getattr(module, group)
        keep = stage_range(len(blocks), n_stages, stage)
        for i, block in enumerate(blocks):
            if i not in keep:
                block.to("meta")
    if tp > 1:
        tp_mesh = mesh[TP_AXIS]
        for owner, attr, name, t, _, _, port in list(_specs(module, tp)):
            if _block_index(name)[0] is None or t.is_meta:
                continue
            d = sh.distribute(t, tp_mesh, sh.placements(port, tp_mesh))
            if attr in owner._parameters:
                owner._parameters[attr] = nn.Parameter(d, requires_grad=False)
            else:
                owner._buffers[attr] = d
    module.pp_mesh = mesh
    return module


def local_param_bytes(module: nn.Module) -> int:
    """Bytes this rank holds of ``module``'s parameters and buffers: ``meta``
    tensors count nothing, a DTensor its local chunk."""
    total = 0
    for t in list(module.parameters()) + list(module.buffers()):
        if t.is_meta:
            continue
        total += (t.to_local() if isinstance(t, sh.DTensor) else t).nbytes
    return total


def stage_param_bytes(module: nn.Module, pp: int, tp: int = 1, stage: int = 0) -> int:
    """Bytes one rank of stage ``stage`` holds under ``place_stages`` on a
    (data, pp, tp) mesh, from shapes alone (``module`` may live on ``meta``):
    the prelude and head whole, the stage's blocks with their tp chunks."""
    total = 0
    for _, _, name, t, _, _, port in _specs(module, tp):
        group, i = _block_index(name)
        if group is None:
            total += t.nbytes
        elif i in stage_range(len(getattr(module, group)), pp, stage):
            total += int(np.prod(sh.local_shape(t.shape, port, {TP_AXIS: tp}))) * t.element_size()
    return total


# -- the communicating autograd nodes ------------------------------------------------


def _token(device) -> torch.Tensor:
    """The zero-size tensor that threads the communicating nodes in order."""
    return torch.zeros(0, device=device, requires_grad=torch.is_grad_enabled())


def _spec(t: torch.Tensor) -> tuple:
    """What a receiver needs to allocate ``t``: (shape, dtype, device)."""
    return tuple(t.shape), t.dtype, t.device


def _empty(specs) -> List[torch.Tensor]:
    return [torch.empty(shape, dtype=dtype, device=device) for shape, dtype, device in specs]


def _p2p(send: Sequence[torch.Tensor], send_to: Optional[int], recv_specs, recv_from: Optional[int]) -> List[torch.Tensor]:
    """Post every send and receive at once and wait for them all; the
    received tensors are allocated from ``recv_specs`` (``_spec``)."""
    out = _empty(recv_specs) if recv_from is not None else []
    ops = []
    if send_to is not None:
        ops += [dist.P2POp(dist.isend, t.contiguous(), send_to) for t in send]
    if recv_from is not None:
        ops += [dist.P2POp(dist.irecv, t, recv_from) for t in out]
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return out


class _Exchange(torch.autograd.Function):
    """JAX's ``ppermute`` on one rank: send ``tensors`` to global rank
    ``send_to`` and receive tensors of ``recv_specs`` from ``recv_from``
    (either None). The backward sends the received tensors' cotangents back
    and receives those of the sent ones."""

    @staticmethod
    def forward(ctx, token, send_to, recv_from, recv_specs, *tensors):
        ctx.send_to, ctx.recv_from, ctx.n_sent = send_to, recv_from, len(tensors)
        ctx.sent_specs = [_spec(t) for t in tensors]
        return (token.clone(), *_p2p(tensors, send_to, recv_specs, recv_from))

    @staticmethod
    def backward(ctx, g_token, *g_recv):
        g_sent = _p2p(g_recv, ctx.recv_from, ctx.sent_specs, ctx.send_to)
        if not g_sent:
            g_sent = [None] * ctx.n_sent
        return (g_token, None, None, None, *g_sent)


def exchange(token, send_to, recv_from, recv_specs, tensors=()):
    """(token, received tensors) of one ``_Exchange``."""
    out = _Exchange.apply(token, send_to, recv_from, list(recv_specs), *tensors)
    return out[0], list(out[1:])


class _FromLast(torch.autograd.Function):
    """The last stage's ``tensors`` on every rank of the pp group (a
    broadcast from global rank ``src``). Every rank computes the same loss
    from them, so the backward keeps the last stage's own cotangent and
    gives the others' tokens zero: a sum would count it ``P`` times."""

    @staticmethod
    def forward(ctx, token, group, src, specs, *tensors):
        ctx.mine = len(tensors) > 0
        out = [t.contiguous().clone() for t in tensors] if ctx.mine else _empty(specs)
        if group is not None:
            for t in out:
                dist.broadcast(t, src, group=group)
        return tuple(out)

    @staticmethod
    def backward(ctx, *grads):
        token = torch.zeros(0, device=grads[0].device)
        return (token, None, None, None, *(grads if ctx.mine else ()))


class _GatherData(torch.autograd.Function):
    """[M, Bl, ...] rows of every data rank, all-gathered into [M, data*Bl, ...]
    in data-rank order. The backward keeps this rank's rows of the cotangent
    (every rank's loss is the same one) and sums nothing."""

    @staticmethod
    def forward(ctx, x, group, index, order):
        ctx.index, ctx.rows = index, x.shape[1]
        parts = [torch.empty_like(x) for _ in order]
        dist.all_gather(parts, x.contiguous(), group=group)
        by_coord = [None] * len(order)
        for part, k in zip(parts, order):
            by_coord[k] = part
        return torch.cat(by_coord, dim=1)

    @staticmethod
    def backward(ctx, g):
        return g[:, ctx.index * ctx.rows:(ctx.index + 1) * ctx.rows], None, None, None


# -- the schedule ------------------------------------------------------------------------


class _Layout:
    """This rank's place on a pp mesh: its stage, the global ranks of the
    stages of its pp line, and its data line."""

    def __init__(self, mesh: DeviceMesh, split_data: bool):
        self.n_stages = sh.axis_size(mesh, PP_AXIS)
        self.stage = mesh.get_local_rank(PP_AXIS)
        self.pp_group = mesh.get_group(PP_AXIS) if self.n_stages > 1 else None
        self.stage_ranks = self._line(mesh, PP_AXIS)
        self.n_data = sh.axis_size(mesh, DATA_AXIS) if split_data else 1
        self.data_index = mesh.get_local_rank(DATA_AXIS) if self.n_data > 1 else 0
        self.data_group = mesh.get_group(DATA_AXIS) if self.n_data > 1 else None
        if self.data_group is not None:  # the data coordinate of each rank of the data group, in group order
            line = self._line(mesh, DATA_AXIS)
            self.data_order = [line.index(dist.get_global_rank(self.data_group, i)) for i in range(self.n_data)]
        self.tp_mesh = mesh[TP_AXIS] if sh.axis_size(mesh, TP_AXIS) > 1 else None

    @staticmethod
    def _line(mesh: DeviceMesh, axis: str) -> List[int]:
        """The global ranks along ``axis`` through this rank's coordinates."""
        coord = list(mesh.get_coordinate())
        dim = mesh.mesh_dim_names.index(axis)
        out = []
        for k in range(mesh.size(dim)):
            coord[dim] = k
            out.append(int(mesh.mesh[tuple(coord)]))
        return out

    def global_rank(self, stage: int) -> int:
        return self.stage_ranks[stage]

    @property
    def last(self) -> bool:
        return self.stage == self.n_stages - 1


def pipeline_scan(stage_fn, m: int, injected: List[List[torch.Tensor]], specs: list, layout: _Layout,
                  token: torch.Tensor):
    """GPipe over ``M + P - 1`` ticks on this rank. ``stage_fn(carry, j)``
    applies the stage's blocks to microbatch ``j``'s carry (a list of
    tensors); ``injected`` holds the M input carries (read on stage 0 only),
    ``specs`` one carry's tensors (``_spec``). Returns (token, the last
    stage's M output carries; empty on the other stages). Bubble ticks run
    nothing."""
    n, p = layout.n_stages, layout.stage
    outs: List[List[torch.Tensor]] = []
    recv: List[torch.Tensor] = []
    for t in range(m + n - 1):
        out = None
        if 0 <= t - p < m:
            cur = injected[t] if p == 0 else recv
            out = stage_fn(cur, t - p)
            if layout.last:
                outs.append(out)
        if n == 1 or t == m + n - 2:
            continue
        sending = out is not None and not layout.last
        receiving = p > 0 and 0 <= t + 1 - p < m
        if sending and [_spec(o) for o in out] != specs:
            raise RuntimeError(f"a stage changed its carry from {specs} to {[_spec(o) for o in out]}")
        token, recv = exchange(token, layout.global_rank(p + 1) if sending else None,
                               layout.global_rank(p - 1) if receiving else None, specs, out if sending else ())
    return token, outs


def _stage_fn(transformer, group: str, layout: _Layout, per_mb, consts, remat, lora, lora_scale):
    """The stage function of one stack: this stage's blocks in order, on a
    carry of plain tensors (``Replicate()`` DTensors on the tp sub-mesh
    inside, the full value out)."""
    blocks = getattr(transformer, group)
    idx = stage_range(len(blocks), layout.n_stages, layout.stage)
    tp_mesh = layout.tp_mesh
    cos, sin = (sh.replicate(c, tp_mesh) for c in consts)

    def fn(carry: List[torch.Tensor], j: int) -> List[torch.Tensor]:
        carry = [sh.replicate(c, tp_mesh) for c in carry]
        mods = [sh.replicate(x[j], tp_mesh) for x in per_mb]
        for i in idx:
            lb = lora.block(group, i) if lora is not None else None
            out = run_block(blocks[i], *carry, *mods, cos, sin, remat=remat, lora=lb, lora_scale=lora_scale)
            carry = list(out) if isinstance(out, tuple) else [out]
        return [sh.gather(c) for c in carry]

    return fn


def pipelined_forward(
    transformer: nn.Module,
    hidden_states: torch.Tensor,  # [B, S_img, 128]
    encoder_hidden_states: torch.Tensor,  # [B, S_txt, joint]
    timestep: torch.Tensor,  # [B]
    rope_cos: torch.Tensor,
    rope_sin: torch.Tensor,
    guidance: Optional[torch.Tensor] = None,
    *,
    mesh: DeviceMesh,
    num_microbatches: Optional[int] = None,
    remat: "bool | str" = False,
    lora=None,
    lora_scale: float = 1.0,
    split_data: bool = True,
) -> torch.Tensor:
    """``Flux2Transformer.forward`` with both block stacks pipelined over ``pp``
    (JAX's ``pipelined_forward``), on a DiT placed by ``place_stages``: the
    velocity [B, S_img, 128] on every rank. Requires ``batch %
    num_microbatches == 0``, the microbatch divisible by ``data`` and both
    stacks divisible by ``pp``. ``split_data=False`` runs every microbatch
    whole on each data rank (the previews' batch of one)."""
    if remat not in (False, True, "block", "dots"):
        raise ValueError(f"remat={remat!r}: choose False, True, 'block' or 'dots'")
    n_stages = sh.axis_size(mesh, PP_AXIS)
    b = hidden_states.shape[0]
    m = num_microbatches if num_microbatches is not None else n_stages
    if b % m:
        raise ValueError(f"batch {b} not divisible into {m} microbatches")
    n_data = sh.axis_size(mesh, DATA_AXIS) if split_data else 1
    if (b // m) % n_data:
        raise ValueError(
            f"microbatch size {b // m} not divisible by data axis {n_data} "
            f"(batch {b} / {m} microbatches)"
        )
    _check_stacks(transformer.config, n_stages)
    layout = _Layout(mesh, split_data)
    s_txt = encoder_hidden_states.shape[1]

    img, txt, temb, img_mod, txt_mod, single_mod = transformer._prelude(
        hidden_states, encoder_hidden_states, timestep, guidance)
    consts = (rope_cos.to(torch.float32), rope_sin.to(torch.float32))
    rows = b // m // n_data
    lo = layout.data_index * rows

    def mb_split(x: torch.Tensor) -> List[torch.Tensor]:
        """The M microbatches of ``x``, this data rank's rows of each."""
        return list(x.reshape(m, b // m, *x.shape[1:])[:, lo:lo + rows].unbind(0))

    token = _token(hidden_states.device)
    img_mbs, txt_mbs = mb_split(img), mb_split(txt)
    specs = [_spec(img_mbs[0]), _spec(txt_mbs[0])]
    double = _stage_fn(transformer, "double_blocks", layout, (mb_split(img_mod), mb_split(txt_mod)), consts,
                       remat, lora, lora_scale)
    token, outs = pipeline_scan(double, m, [list(c) for c in zip(img_mbs, txt_mbs)], specs, layout, token)

    # the double stack's output: from the last stage to stage 0, which injects it into the single stack
    if layout.n_stages > 1 and (layout.last or layout.stage == 0):
        sent = [torch.cat([o[k] for o in outs]) for k in range(2)] if layout.last else ()
        stacked = [((m * rows, *shape[1:]), dtype, device) for shape, dtype, device in specs]
        token, got = exchange(token, layout.global_rank(0) if layout.last else None,
                              layout.global_rank(n_stages - 1) if layout.stage == 0 else None, stacked, sent)
        if layout.stage == 0:
            outs = [list(pair) for pair in zip(got[0].chunk(m), got[1].chunk(m))]
    x_mbs = [[torch.cat([t, i], dim=1)] for i, t in outs] if layout.stage == 0 else []
    (img_shape, img_dtype, device), (_, txt_dtype, _) = specs
    x_spec = ((rows, s_txt + img_shape[1], img_shape[2]), torch.promote_types(img_dtype, txt_dtype), device)

    single = _stage_fn(transformer, "single_blocks", layout, (mb_split(single_mod),), consts, remat, lora,
                       lora_scale)
    token, outs = pipeline_scan(single, m, x_mbs, [x_spec], layout, token)

    if layout.n_stages > 1:
        mine = (torch.stack([o[0] for o in outs]),) if layout.last else ()
        shape, dtype, device = x_spec
        (x,) = _FromLast.apply(token, layout.pp_group, layout.global_rank(n_stages - 1), [((m, *shape), dtype, device)],
                               *mine)
    else:
        x = torch.stack([o[0] for o in outs])
    if layout.n_data > 1:
        x = _GatherData.apply(x, layout.data_group, layout.data_index, layout.data_order)
    x = x.reshape(b, *x.shape[2:])
    return transformer._final(temb, x[:, s_txt:])


# -- the forward_fn of training, and the previews' module ----------------------------------


class PPForward:
    """A ``Flux2Transformer.forward``-compatible callable routed through
    ``pipelined_forward`` on ``mesh`` (JAX's ``make_pp_forward``): the
    ``forward_fn`` of ``trainer.make_train_step`` / ``make_eval_loss``. The
    DiT must be placed by ``place_stages(transformer, mesh)``."""

    def __init__(self, mesh: DeviceMesh, num_microbatches: Optional[int] = None):
        self.mesh, self.num_microbatches = mesh, num_microbatches

    def __call__(self, transformer, hidden, txt, timestep, cos, sin, guidance=None, remat=False, lora=None,
                 lora_scale=1.0):
        return pipelined_forward(transformer, hidden, txt, timestep, cos, sin, guidance=guidance, mesh=self.mesh,
                                 num_microbatches=self.num_microbatches, remat=remat, lora=lora,
                                 lora_scale=lora_scale)

    @torch.no_grad()
    def reduce_grads(self, params: Sequence[torch.Tensor]) -> None:
        """Every rank's adapters' ``.grad`` -> the dense gradient: summed over
        ``pp`` (the other stages' blocks gave zero) and over ``data`` (each
        data rank's rows gave their part). One flat buffer per collective."""
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        groups = [self.mesh.get_group(axis) for axis in (PP_AXIS, DATA_AXIS) if sh.axis_size(self.mesh, axis) > 1]
        if not groups:
            return
        flat = torch.cat([p.grad.reshape(-1) for p in params])
        for group in groups:
            dist.all_reduce(flat, group=group)
        offset = 0
        for p in params:
            p.grad.copy_(flat[offset:offset + p.numel()].view_as(p.grad))
            offset += p.numel()


def make_pp_forward(mesh: DeviceMesh, num_microbatches: Optional[int] = None) -> PPForward:
    """JAX's ``make_pp_forward``: the pipelined ``forward_fn`` on ``mesh``."""
    return PPForward(mesh, num_microbatches)


class PipelinedDiT(nn.Module):
    """A stage-placed DiT that ``Flux2Pipeline`` can run as its transformer:
    ``forward`` is ``pipelined_forward`` with one microbatch and no data
    split, so every rank of the mesh calls ``generate`` alike and every rank
    gets the velocity. The validation previews under pp run through it."""

    mesh = None

    def __init__(self, transformer: nn.Module, mesh: DeviceMesh):
        super().__init__()
        self.inner = transformer
        self.pp_mesh = mesh
        self.config = transformer.config

    @property
    def x_embedder(self):
        return self.inner.x_embedder

    def forward(self, hidden_states, encoder_hidden_states, timestep, rope_cos, rope_sin, guidance=None,
                remat=False, lora=None, lora_scale=1.0, ring=None):
        if ring is not None:
            raise ValueError("a pipelined DiT runs no ring attention")
        return pipelined_forward(self.inner, hidden_states, encoder_hidden_states, timestep, rope_cos, rope_sin,
                                 guidance=guidance, mesh=self.pp_mesh, num_microbatches=1, remat=remat, lora=lora,
                                 lora_scale=lora_scale, split_data=False)
