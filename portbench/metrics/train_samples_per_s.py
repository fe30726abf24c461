"""Training samples (triplets or volume triplets) completed in the window, over its wall time."""

from portbench import readers


def read(record: dict):
    return readers.rate(record, "train")
