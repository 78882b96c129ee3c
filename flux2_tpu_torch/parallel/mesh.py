"""Device mesh construction: the port of ``flux2_tpu/parallel/mesh.py``.

One mesh, four axes, as in JAX: ``data`` (batch), ``fsdp`` (weights at
rest), ``tp`` (attention heads and MLP hidden) and ``sp`` (the joint token
axis of ring attention), sized so ``data * fsdp * tp * sp`` covers every
device, with ``sp`` innermost.

Where JAX's single controller sees every chip, torch runs one process per
rank (SPMD under ``torchrun``), so "the devices" are the ranks of the default
process group and each mesh is a ``torch.distributed.device_mesh.DeviceMesh``
built by every rank alike. When no group exists, ``make_mesh`` starts one:
from ``torchrun``'s environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR``/``MASTER_PORT``) when it is set, else a one-rank group on a
``HashStore``, which needs no port. The backend is NCCL for ``cuda`` and gloo
for ``cpu``; each CUDA rank takes ``cuda:LOCAL_RANK``. Torch has no
``slice_index``: ``make_multislice_mesh`` groups contiguous ranks, JAX's
virtual branch.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

DATA_AXIS = "data"
FSDP_AXIS = "fsdp"
TP_AXIS = "tp"
SP_AXIS = "sp"
AXIS_NAMES = (DATA_AXIS, FSDP_AXIS, TP_AXIS, SP_AXIS)


def ensure_process_group(device_type: str = "cuda") -> None:
    """Start the default process group if none exists: from ``torchrun``'s
    environment, else one rank on a ``HashStore``. The backend is NCCL for
    ``cuda`` and gloo for ``cpu``; a CUDA rank takes ``cuda:LOCAL_RANK``."""
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("a cuda mesh needs a CUDA device; pass device_type='cpu' for the CPU")
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    if dist.is_initialized():
        return
    backend = "nccl" if device_type == "cuda" else "gloo"
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend, init_method="env://")
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)


def ranks(device_type: str = "cuda") -> List[int]:
    """Every rank of the default process group (started if need be): the port's "devices"."""
    ensure_process_group(device_type)
    return list(range(dist.get_world_size()))


def _mesh(ranks_: Sequence[int], sizes: Sequence[int], device_type: str) -> DeviceMesh:
    arr = torch.tensor(list(ranks_), dtype=torch.int64).reshape(*sizes)
    return DeviceMesh(device_type, arr, mesh_dim_names=AXIS_NAMES)


def make_mesh(
    data: int = 1,
    fsdp: int = 1,
    tp: int = -1,
    sp: int = 1,
    devices: Optional[Sequence[int]] = None,
    device_type: str = "cuda",
) -> DeviceMesh:
    """Build a (data, fsdp, tp, sp) mesh over ``devices`` (ranks; default all).
    ``-1`` sizes one axis from the rest."""
    devices = list(devices if devices is not None else ranks(device_type))
    ensure_process_group(device_type)
    n = len(devices)
    sizes = [data, fsdp, tp, sp]
    if sizes.count(-1) > 1:
        raise ValueError("at most one axis may be -1")
    if -1 in sizes:
        known = int(np.prod([s for s in sizes if s != -1]))
        if n % known:
            raise ValueError(f"{n} devices not divisible by fixed axes {known}")
        sizes[sizes.index(-1)] = n // known
    if int(np.prod(sizes)) != n:
        raise ValueError(f"mesh {sizes} does not cover {n} devices")
    return _mesh(devices, sizes, device_type)


def single_device_mesh(device: Optional[int] = None, device_type: str = "cuda") -> DeviceMesh:
    """A (1, 1, 1, 1) mesh over one rank (default: this one)."""
    ensure_process_group(device_type)
    rank = dist.get_rank() if device is None else device
    return _mesh([rank], (1, 1, 1, 1), device_type)


def best_mesh_for_inference(n_devices: Optional[int] = None, device_type: str = "cuda") -> DeviceMesh:
    """Default inference layout: all ranks on tp (batch-1 latency)."""
    devices = ranks(device_type)
    n = n_devices if n_devices is not None else len(devices)
    return make_mesh(data=1, fsdp=1, tp=n, devices=devices[:n], device_type=device_type)


def make_multislice_mesh(
    num_slices: int,
    fsdp: int = 1,
    tp: int = -1,
    sp: int = 1,
    devices: Optional[Sequence[int]] = None,
    device_type: str = "cuda",
) -> DeviceMesh:
    """Multi-slice layout: ``data`` spans ``num_slices`` contiguous groups of
    ranks (JAX's DCN axis), the model axes stay inside each group."""
    devices = list(devices if devices is not None else ranks(device_type))
    n = len(devices)
    if n % num_slices:
        raise ValueError(f"{n} devices not divisible into {num_slices} slices")
    per_slice = n // num_slices
    sizes = [fsdp, tp, sp]
    if sizes.count(-1) > 1:
        raise ValueError("at most one of fsdp/tp/sp may be -1")
    if -1 in sizes:
        known = int(np.prod([s for s in sizes if s != -1]))
        if per_slice % known:
            raise ValueError(f"{per_slice} devices/slice not divisible by {known}")
        sizes[sizes.index(-1)] = per_slice // known
    if int(np.prod(sizes)) != per_slice:
        raise ValueError(f"in-slice mesh {sizes} does not cover {per_slice} devices/slice")
    return _mesh(devices, (num_slices, *sizes), device_type)


def mesh_shape(mesh: DeviceMesh) -> dict:
    """{axis name: size}, JAX's ``mesh.shape``."""
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
