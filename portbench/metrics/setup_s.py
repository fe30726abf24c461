"""Seconds from the start of the process to the start of the window: imports, weights and data from the seed, the kernels' build or load, warm-up."""

from portbench import readers


def read(record: dict):
    return readers.setup_s(record)
