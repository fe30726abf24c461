"""torch.cuda.max_memory_allocated over the window, after a reset at its start."""

from portbench import readers


def read(record: dict):
    return readers.peak_gib(record)
