"""flux2-tpu's PyTorch port for NVIDIA Hopper (H100).

A second package beside the JAX reference ``flux2_tpu``: same module layout,
same math, PyTorch idiom (``nn.Module``s, explicit ``device`` and
``torch.Generator`` arguments), and every Pallas kernel on a ported path
replaced by a hand-written CUDA kernel under ``csrc/``. It imports nothing of
JAX or of ``flux2_tpu``: it keeps its own copies of the configs and helpers
it shares with the reference (``tests/test_torch_shared_copies.py`` holds
them against the originals).
"""

__version__ = "0.1.0"
