"""The quantized-matmul candidate runner's CPU side (``flux2_tpu_torch.utils.quant_candidate``).

The runner's checks and timings need a card; here: it refuses to run without
one, its served shapes are chip_smoke.py's, and the C-entry arguments it
builds for each kind carry the activations quantized as the kernel wrappers
quantize them, in the order of the C signatures (``ops.quant_kernels._kernel``).
"""

import numpy as np
import pytest
import torch

from flux2_tpu_torch.ops import quant as tq
from flux2_tpu_torch.ops import quant_kernels as tqk
from flux2_tpu_torch.utils import quant_candidate as qc


def test_quant_candidate_refuses_to_run_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        qc.main(["--source", "candidate.cu"])


def test_served_shapes_are_chip_smokes():
    import chip_smoke

    assert qc.SHAPES[:7] == chip_smoke.QMM_SHAPES
    assert qc.SERVED == {name for name, *_ in chip_smoke.QMM_SHAPES}


@pytest.mark.parametrize("kind", qc.KINDS)
def test_entry_args_follow_the_wrappers(kind):
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(16, 512).astype(np.float32)).bfloat16()
    qw = qc.quantize(kind, torch.from_numpy(rng.randn(256, 512).astype(np.float32) * 512**-0.5).bfloat16())
    args = qc.entry_args(kind, x, qw)
    tensors = [a for a in args if isinstance(a, torch.Tensor)]
    ints = [a for a in args if not isinstance(a, torch.Tensor)]
    if kind in ("w8a8", "w4a8"):
        assert isinstance(qw, tq.W8A8Tensor if kind == "w8a8" else tq.W4A8Tensor)
        xq, xs = tqk.quantize_rows(x) if kind == "w8a8" else tqk.quantize_row_blocks(x, qw.block)
        assert torch.equal(tensors[0], xq) and torch.equal(tensors[1], xs)
        assert tensors[2] is qw.q and tensors[3] is qw.scale
        assert ints == ([16, 256, 512, 0, 1] if kind == "w8a8" else [16, 256, 512, 0])  # m, n, k, out_f32[, group]
    else:
        assert qw.format == kind and tensors[0] is x
        assert tensors[1] is qw.q and tensors[2] is qw.scale and tensors[3] is qw.bias
        assert ints == [16, 256, 512, qw.group_size, int(kind == "int4")]  # m, n, k, group, int4
