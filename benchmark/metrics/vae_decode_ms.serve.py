"""vae_decode_ms.serve (ms; layer: VAE decoder; moves images_per_s): mean
decode time of a batch (the pipeline's phase timing) over the batches that
ended in the window."""


def read(run):
    d = [s.info["vae_decoding_s"] for s in run.spans if s.name == "generate" and run.t0 <= s.end <= run.t1]
    return 1000.0 * sum(d) / len(d) if d else None
