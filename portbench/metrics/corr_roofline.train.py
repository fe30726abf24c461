"""The cost volume's share of its roofline in training, forward and backward, in the traced sub-window."""

from portbench import roofline_corr


def read(record: dict):
    return roofline_corr.corr_roofline_pct(record, "train")
