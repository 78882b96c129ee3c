"""w8a8_roofline.serve (%; layer: kernel K5, csrc/quant_matmul.cu; moves
images_per_s): the least time the card could take for the trace's
``w8a8_kernel`` launches (each 2 M K N operations at the int8 peak, or its
int8 operands, scales and bf16 output moved once at HBM's, whichever is
longer: ``benchmark/flops_int8.py``), over the time they took.

The trace gives each launch's time but not its shape: K5 is persistent, so
its grid is the card's SMs (or the tiles, when fewer) and its name its tile
shape. The launches' shapes are those the program dispatched in the traced
window: every ``dit.step`` span that ended in it is one DiT forward of
``batch`` images, every ``pipeline.encode`` span one encoder pass, each with
the configuration's projections (``flops_int8.launch_mix``). Each traced
launch takes the mean bound of that mix, so a launch cut by the window's
ends counts as an average one. A span whose ``w8a8`` count is not the one
the configuration gives means the yardstick does not know the program's
launches, and nothing is read; so does a program whose spans carry no
``w8a8``."""

from benchmark import flops_int8, spans


def read(run):
    if run.trace is None or run.peaks is None:
        return None
    m = flops_int8.launch_mix(run.config, run.traffic, [s.attrs for s in spans.program_spans(run, "dit.step")],
                              [s.attrs for s in spans.program_spans(run, "pipeline.encode")], run.peaks)
    launches = run.trace.kernels("w8a8_kernel")
    spent = sum(op.dur for op in launches)
    if m is None or spent <= 0:
        return None
    return 100.0 * len(launches) * (m[0] / m[2]) / spent
