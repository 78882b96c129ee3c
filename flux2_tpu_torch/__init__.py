"""flux2-tpu's PyTorch port for NVIDIA Hopper (H100).

A second package beside the JAX reference ``flux2_tpu``: same module layout,
same math, PyTorch idiom (``nn.Module``s, explicit ``device`` and
``torch.Generator`` arguments), and every Pallas kernel on a ported path
replaced by a hand-written CUDA kernel under ``csrc/``. It never imports JAX;
from ``flux2_tpu`` it imports only the JAX-free config and tokenizer modules.
"""

__version__ = "0.1.0"
