"""The benchmark of the PyTorch and CUDA port (``flux2_tpu_torch``) on the H100.

``python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>``;
see ``benchmark/README.md``.
"""
