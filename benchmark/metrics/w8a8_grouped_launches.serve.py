"""w8a8_grouped_launches.serve (launches; layer: kernel K5, csrc/quant_matmul.cu;
moves images_per_s): the mean ``w8a8_grouped`` attribute of the program's
``dit.step`` spans that ended in the traced window: the K5 launches of one
denoising step, on the denoising thread, that walked their output tiles in
groups of more than one row band (``flux2_tpu_torch/ops/quant_kernels.w8a8_group``),
so that the CTAs in flight share each weight tile. It shows the grouped order
engaged: a FLUX.2-dev forward at batch 1 takes it in every K5 launch but the
seven at M = 1 (433 of 440). It counts the wrapper's choice, not what the
kernel did with it: at fixed shapes it is a constant of the rule and measures
no throughput, and a later rule that keeps group 1 where that is faster reads
lower without being worse. A program whose spans carry no ``w8a8_grouped``
gives nothing, and the metric is left out."""

from benchmark import spans


def read(run):
    counts = [s.attrs["w8a8_grouped"] for s in spans.program_spans(run, "dit.step") if "w8a8_grouped" in s.attrs]
    return sum(counts) / len(counts) if counts else None
