"""train_step_s (s, end to end, host clock): the window's length over the
train steps completed in it; the window runs from the first step end after
set-up to the first step end at or after --seconds later, each step ended
by a synchronise."""


def read(run):
    return (run.t1 - run.t0) / run.steps if run.steps else None
