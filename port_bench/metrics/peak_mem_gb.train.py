"""torch.cuda.max_memory_allocated over the window, reset at its start,
in GB (1e9 bytes)."""


def read(run):
    return run.window_peak_bytes / 1e9 if run.window_peak_bytes else None
