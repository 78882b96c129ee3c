"""images_per_s (images/s, end to end, host clock): images completed in the
window over its length; the window runs from the first completion after
warm-up to the first completion at or after --seconds later, so no partial
image is counted and a stall inside it counts in full."""


def read(run):
    done = [c for c in run.window if c.png is not None]
    return len(done) / (run.t1 - run.t0) if run.window and run.t1 > run.t0 else None
