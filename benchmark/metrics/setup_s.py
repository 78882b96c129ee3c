"""setup_s (s, end to end, host clock): process start to the window's start:
library load or build, weights drawn on the card, warm-up."""


def read(run):
    return run.setup_s
