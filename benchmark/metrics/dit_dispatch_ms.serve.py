"""dit_dispatch_ms.serve (ms; layer: pipeline and DiT; moves images_per_s):
the mean of the program's ``dit.step`` spans that ended in the traced
window. A span runs from the top of a denoising step to the return of its
step end (``Flux2Pipeline._denoise``), with no synchronise inside: the
host's dispatch of one DiT step, and any wait on a full launch queue.
Beside ``dit_step_ms.serve``, which holds the device's time too, it says
whether a step's launches keep pace with the device. It moves with where
the host next waits for the card: a change that makes the dispatch return
at once (a CUDA graph's replay) brings it near 0 and moves the wait into
"3. VAE Decoding", whatever happens end to end; ``device_idle.serve`` and
``benchmark/split.py``'s split judge such a change."""

from benchmark import spans


def read(run):
    return spans.mean_ms(spans.program_spans(run, "dit.step"))
