"""glue_launches.serve (launches; layer: pipeline and DiT; moves images_per_s):
the mean ``glue`` attribute of the program's ``dit.step`` spans that ended in
the traced window: the launches of the DiT's fused glue kernels, G1 (the AdaLN,
``adaln_modulate``) and G2 (q/k RMSNorm, RoPE and the head layout,
``qkv_heads``), in one denoising step (``flux2_tpu_torch/ops/dit_glue.py``). It
shows the fused route engaged: a Klein-4B step on it launches 41 G1 and 30 G2,
a Klein-9B step 57 and 40. A program whose spans carry no ``glue`` gives
nothing, and the metric is left out."""

from benchmark import spans


def read(run):
    counts = [s.attrs["glue"] for s in spans.program_spans(run, "dit.step") if "glue" in s.attrs]
    return sum(counts) / len(counts) if counts else None
