"""mfu.train (%; layer: the whole LoRA train step; moves train_step_s): the
analytic operations of the steps completed in the window (forward, the
forward again under remat, backward; benchmark/flops.py) over the window
times the card's bf16 peak."""

from benchmark import flops


def read(run):
    if run.peaks is None or not run.steps:
        return None
    tr = run.traffic
    ops = run.steps * flops.lora_train_step(run.config["transformer"], (tr["px"] // 16) ** 2, tr["batch"],
                                            tr["train"]["remat"], run.config["text_encoder"]["max_length"])
    return 100.0 * ops / ((run.t1 - run.t0) * run.peaks["bf16_flops"])
