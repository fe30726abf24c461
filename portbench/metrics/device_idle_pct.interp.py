"""The share of the traced sub-window of interpolation in which nothing ran on the card."""

from portbench import readers


def read(record: dict):
    return readers.idle_pct(record, "interp")
