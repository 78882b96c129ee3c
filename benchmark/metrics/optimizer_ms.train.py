"""optimizer_ms.train (ms; layer: trainer; moves train_step_s): the mean of
the program's ``train.optimizer`` spans that ended in the traced window, one
a step: the gradients' reduction where there is one, their global norm and
the optimizer's update (``training/trainer.make_train_step``)."""

from benchmark import spans


def read(run):
    return spans.mean_ms(spans.program_spans(run, "train.optimizer"))
