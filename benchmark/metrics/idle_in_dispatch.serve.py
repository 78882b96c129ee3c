"""idle_in_dispatch.serve (%; layer: device; moves images_per_s): the
device's idle time inside the program's ``dit.step`` spans (the host
dispatching a DiT step, benchmark/spans.py), over the traced window: the
part of ``device_idle.serve`` that the DiT's dispatch explains, and so at
most that. Like ``dit_dispatch_ms.serve`` it moves with where the host next
waits for the card: a dispatch that returns at once reads near 0 and leaves
the idle to the phase that waits next, so a dispatch change is judged by
``device_idle.serve`` and ``benchmark/split.py``'s split."""

from benchmark import spans


def read(run):
    return spans.idle_share(run, "dit.step")
