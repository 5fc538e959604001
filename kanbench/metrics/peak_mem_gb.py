"""peak_mem_gb: the most device memory the program's allocations held
during the window (``torch.cuda.max_memory_allocated`` after a reset at
the window's start), in GB of 10^9 bytes."""


def read(ctx):
    return ctx.window_peak_bytes / 1e9 if ctx.window_peak_bytes else None
