"""mfu.serve (%; layer: the whole served model step; moves images_per_s):
the analytic operations of every image completed in the window (its
prompt's Qwen3 encode through the deepest layer the recipe reads, every
DiT step, the VAE decode; benchmark/flops.py) over the window times the
card's bf16 peak."""

from benchmark import flops


def read(run):
    if run.peaks is None or run.t1 <= run.t0:
        return None
    ops = sum(flops.t2i_image(run.config, c.request["height"], c.request["width"], c.request["steps"])
              for c in run.window if c.png is not None)
    return 100.0 * ops / ((run.t1 - run.t0) * run.peaks["bf16_flops"])
