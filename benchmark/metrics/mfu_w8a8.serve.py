"""mfu_w8a8.serve (%; layer: whole served model step; moves images_per_s): the
least time a served w8a8 image's work could take, each product at the peak
of the precision it runs in (K5's at int8's, the products its gate leaves
in bf16, the attention and the VAE decode at bf16's: one encode through the
deepest layer the recipe reads, every DiT step, the decode;
``benchmark/flops_int8.t2i_image_s``), over the time the images took: the
pipeline's denoising and decoding phases (its phase timings, host clock
after a synchronise) of the batches that ended in the traced window, as
``dit_step_ms.serve`` reads them. A traced part of 12 s holds one or two
FLUX.2-dev images, so the window's length would count a partial image;
the encode of the next prompt shares the one stream with these phases, so
its work is counted with the image it feeds."""

from benchmark import flops_int8


def read(run):
    if run.peaks is None:
        return None
    batches = [s for s in run.spans if s.name == "generate" and run.t0 <= s.end <= run.t1]
    spent = sum(s.info["denoising_s"] + s.info["vae_decoding_s"] for s in batches)
    if spent <= 0:
        return None
    bound = sum(s.info["batch"] * flops_int8.t2i_image_s(run.config, s.info["height"], s.info["width"],
                                                          s.info["steps"], run.peaks) for s in batches)
    return 100.0 * bound / spent
