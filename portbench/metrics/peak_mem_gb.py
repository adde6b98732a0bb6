"""``peak_mem_gb``: the CUDA allocator's peak over the window
(``torch.cuda.max_memory_allocated`` after a reset at its start), in GB
of 1e9 bytes; nothing off the card."""


def read(run):
    return run.peak_window_bytes / 1e9 if run.peak_window_bytes else None
