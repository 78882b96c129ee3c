"""device_idle (%; layer: device): the share of the traced window in which
no kernel, copy or set ran on the card: 100 * (1 - busy / window)."""


def read(run):
    return run.trace.idle_percent() if run.trace is not None else None
