"""K5's tile order on the CPU (``quant_kernels.w8a8_group``, the ``group``
of ``csrc/quant_matmul.cu``'s ``w8a8_kernel``), no JAX.

- One row band walks row-band major (G = 1): M <= 64 (the modulations and
  every decode token) and M <= 128.
- At every K5 product of a 1024^2 forward and of an encode of Dev, Klein-4B
  and Klein-9B the group's x bands and the weight slices in flight fit half
  the L2; a Dev forward groups every launch but its seven at M = 1.
- The kernel's tile map, mirrored here, is a permutation of the tiles at any
  group, the ragged last group included, and G = 1 is the row-band-major walk.
- A tiny w8a8 Dev generate counts its grouped K5 launches in
  ``launches["w8a8_grouped"]`` and in each ``dit.step`` span's ``w8a8_grouped``.
"""

import dataclasses
import json
from pathlib import Path

import pytest
import torch

from benchmark import flops_int8
from flux2_tpu_torch.models.flux2 import transformer as ttr
from flux2_tpu_torch.models.flux2.config import Flux2Model, Flux2TransformerConfig
from flux2_tpu_torch.models.flux2.vae import VAEConfig
from flux2_tpu_torch.ops import quant as tq
from flux2_tpu_torch.ops import quant_kernels as tqk
from flux2_tpu_torch.pipeline.pipeline import Flux2Pipeline
from flux2_tpu_torch.utils import profiler as tprof

CONFIGS = Path(__file__).resolve().parents[1] / "benchmark" / "configs"


def _served_shapes(name: str):
    """(M, K, N) of every K5 launch of a 1024^2 forward and of an encode."""
    cfg = json.loads((CONFIGS / f"{name}.json").read_text())
    enc = cfg["text_encoder"]
    dit = flops_int8.dit_products(cfg["transformer"], 4096, enc["max_length"])[0]
    return dit, flops_int8.encoder_products(enc)[0]


def _tile(tile: int, mt: int, ntn: int, group: int):
    """``w8a8_tile`` of csrc/quant_matmul.cu, after the kernel's clamp of the group to the row bands."""
    group = min(group, mt)
    first = tile // (group * ntn) * group
    bands = min(group, mt - first)
    local = tile - first * ntn
    return first + local % bands, local // bands


@pytest.mark.parametrize("m", [1, 8, 37, 64, 65, 128])
@pytest.mark.parametrize("k,n", [(6144, 36864), (32768, 5120), (3072, 18432), (512, 256)])
def test_one_row_band_walks_row_band_major(m, k, n):
    assert tqk.w8a8_group(m, n, k) == 1


@pytest.mark.parametrize("name", ["dev-w8a8", "klein-4b", "klein-9b"])
def test_the_group_fits_half_the_l2_at_every_served_shape(name):
    dit, enc = _served_shapes(name)
    for m, k, n in sorted(set(dit) | set(enc)):
        g = tqk.w8a8_group(m, n, k)
        bm, bn, stages, per_sm = tqk.w8a8_tile_shape(m, n)
        mt = -(-m // bm)
        in_flight = min(tqk.H100_SMS * per_sm, mt * (n // bn))
        assert 1 <= g <= mt
        assert g == 1 or g * bm * k + -(-in_flight // g) * bn * 128 * stages <= tqk.L2_BYTES // 2, (m, k, n, g)
        if mt * (n // bn) <= in_flight:  # one wave holds every tile: the order moves no byte
            assert g == 1, (m, k, n)
    if name == "dev-w8a8":  # w8a8_grouped_launches.serve a step: all but the time and guidance embeddings and
        grouped = sum(tqk.w8a8_group(m, n, k) > 1 for m, k, n in dit)  # the modulations, at M = 1
        assert (len(dit), grouped, sum(m == 1 for m, _, _ in dit)) == (440, 433, 7)


@pytest.mark.parametrize("mt,ntn,group", [(36, 72, 16), (33, 72, 16), (36, 24, 8), (4, 48, 4), (4, 40, 2), (7, 3, 16),
                                          (5, 2, 1), (33, 1, 16), (1, 5, 4)])
def test_the_tile_map_is_a_permutation(mt, ntn, group):
    tiles = [_tile(t, mt, ntn, group) for t in range(mt * ntn)]
    assert sorted(tiles) == [(i, j) for i in range(mt) for j in range(ntn)]
    if group == 1:
        assert tiles == [(t // ntn, t % ntn) for t in range(mt * ntn)]
    g = min(group, mt)
    if g * ntn >= tqk.H100_SMS:  # the first wave holds g row bands and ~132 / g weight tiles
        wave = tiles[:tqk.H100_SMS]
        assert {i for i, _ in wave} == set(range(g)) and {j for _, j in wave} == set(range(-(-tqk.H100_SMS // g)))


def test_a_tiny_dev_generate_counts_its_grouped_k5_launches(monkeypatch):
    """Each product that K5's gate takes counts as a launch, as the CUDA
    wrapper counts it, on a card of ``sms`` SMs, where the tiny products span
    more than one wave."""
    sms = 4
    tc = Flux2TransformerConfig(num_layers=1, num_single_layers=1, num_attention_heads=2, attention_head_dim=128,
                                joint_attention_dim=256, guidance_embeds=True)
    vc = VAEConfig(block_out_channels=(8, 8, 16, 16), layers_per_block=1, norm_num_groups=4)
    pipe = Flux2Pipeline.from_random(Flux2Model.DEV, device="cpu", generator=torch.Generator().manual_seed(0),
                                     dtype=torch.float32, transformer_config=tc, vae_config=vc)
    tq.quantize_params(pipe.transformer, "w8a8")
    shapes = []

    def launching(x, w):
        m, k, n = x.numel() // x.shape[-1], x.shape[-1], w.q.shape[0]
        shapes.append((m, k, n))
        tqk._count("w8a8")
        if tqk.w8a8_group(m, n, k, sms) > 1:
            tqk._count("w8a8_grouped")
        return tqk.w8a8_matmul_reference(x, w)

    def routed(x, w, _linear=ttr.q_linear):  # q_linear's route on a CUDA tensor
        gated = isinstance(w, tq.W8A8Tensor) and tq.kernel_route(x, w) == "w8a8"
        return launching(x, w) if gated else _linear(x, w)

    monkeypatch.setattr(ttr, "q_linear", routed)
    rec = tprof.PhaseProfiler(enabled=True)
    monkeypatch.setattr(tprof, "_shared", rec)
    before = tqk.launches["w8a8_grouped"]
    pipe.generate(embeddings=torch.randn(1, 8, 256, generator=torch.Generator().manual_seed(1)), height=256,
                  width=256, num_steps=2, seed=1)
    forward = flops_int8.dit_products(dataclasses.asdict(tc), 256, 8)[0]
    assert sorted(shapes) == sorted(forward * 2)
    grouped = sum(tqk.w8a8_group(m, n, k, sms) > 1 for m, k, n in forward)
    assert 0 < grouped < len(forward)
    steps = rec.spans("dit.step")
    assert [(s.attrs["w8a8"], s.attrs["w8a8_grouped"]) for s in steps] == [(len(forward), grouped)] * 2
    assert tqk.launches["w8a8_grouped"] - before == 2 * grouped
