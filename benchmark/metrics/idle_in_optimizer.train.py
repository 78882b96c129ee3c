"""idle_in_optimizer.train (%; layer: device; moves train_step_s): the
device's idle time inside the program's ``train.optimizer`` spans
(benchmark/spans.py), over the traced window: the part of
``device_idle.train`` that the optimizer's per-leaf launches explain, and
so at most that."""

from benchmark import spans


def read(run):
    return spans.idle_share(run, "train.optimizer")
