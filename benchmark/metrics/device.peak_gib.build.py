"""Peak device memory allocated over the window
(``torch.cuda.max_memory_allocated()`` after a reset at its start), in
GiB."""


def read(run):
    return run.window_peak_bytes / 2**30
