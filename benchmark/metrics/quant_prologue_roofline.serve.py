"""quant_prologue_roofline.serve (%; layer: the K5 prologue,
csrc/quant_prologue.cu; moves images_per_s): the least time the card could
take for the trace's ``quantize_rows_kernel`` launches, which are bound by
their bytes (x [M, K] bf16 read, its int8 codes and one f32 scale a row
written: ``benchmark/flops_int8.quantize_rows``), over the time they took.
Each launch takes the mean bound of the prologues of the K5 launches the
window's spans dispatched (``flops_int8.launch_mix``), as
``w8a8_roofline.serve`` reads K5's: one prologue a K5 launch (the cell runs
no K6)."""

from benchmark import flops_int8, spans


def read(run):
    if run.trace is None or run.peaks is None:
        return None
    m = flops_int8.launch_mix(run.config, run.traffic, [s.attrs for s in spans.program_spans(run, "dit.step")],
                              [s.attrs for s in spans.program_spans(run, "pipeline.encode")], run.peaks)
    launches = run.trace.kernels("quantize_rows_kernel")
    spent = sum(op.dur for op in launches)
    if m is None or spent <= 0:
        return None
    return 100.0 * len(launches) * (m[1] / m[2]) / spent
