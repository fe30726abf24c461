"""The warps' share of their roofline in training, forward and backward, in the traced sub-window."""

from portbench import readers


def read(record: dict):
    return readers.warp_roofline_pct(record, "train")
