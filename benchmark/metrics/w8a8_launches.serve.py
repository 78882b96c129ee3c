"""w8a8_launches.serve (launches; layer: pipeline and DiT; moves
images_per_s): the mean ``w8a8`` attribute of the program's ``dit.step``
spans that ended in the traced window: the K5 launches (``w8a8_kernel``, with
one prologue each) of one denoising step on the denoising thread
(``flux2_tpu_torch/ops/quant_kernels.thread_launches``), so an encode on a
request's thread beside it is not counted. It shows the w8a8 route engaged:
a FLUX.2-dev forward at batch 1 launches one K5 a quantized projection whose
K and N the gate admits (``benchmark/flops_int8.dit_products``). A program
whose spans carry no ``w8a8`` gives nothing, and the metric is left out."""

from benchmark import spans


def read(run):
    counts = [s.attrs["w8a8"] for s in spans.program_spans(run, "dit.step") if "w8a8" in s.attrs]
    return sum(counts) / len(counts) if counts else None
