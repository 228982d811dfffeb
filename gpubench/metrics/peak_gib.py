"""Peak device memory over the measured window
(``torch.cuda.max_memory_allocated``), in GiB."""


def read(trace):
    return trace.peak_bytes / 2**30 if trace.peak_bytes else None
