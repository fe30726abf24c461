"""Interpolated frames or volumes completed in the window, over its wall time."""

from portbench import readers


def read(record: dict):
    return readers.rate(record, "interp")
