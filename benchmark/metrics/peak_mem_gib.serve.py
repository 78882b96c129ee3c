"""peak_mem_gib.serve (GiB; layer: device; moves images_per_s): the
allocator's peak (torch.cuda.max_memory_allocated) over the window, reset
at its start."""


def read(run):
    return run.window_peak_bytes / 2**30 if run.window_peak_bytes else None
