"""dit_step_ms.serve (ms; layer: pipeline / DiT; moves images_per_s): the
pipeline's denoising time (its phase timing, host clock after a
synchronise) over the steps run, summed over the batches that ended in the
window."""


def read(run):
    spans = [s for s in run.spans if s.name == "generate" and run.t0 <= s.end <= run.t1]
    steps = sum(s.info["steps"] for s in spans)
    return 1000.0 * sum(s.info["denoising_s"] for s in spans) / steps if steps else None
