"""Device time of the convolution kernels in the traced sub-window of interpolation, per sample."""

from portbench import readers


def read(record: dict):
    return readers.conv_ms_per_sample(record, "interp")
