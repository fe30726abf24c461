"""Device time of the losses' kernels and copies in a traced sub-window of
training with the spans on, forward and backward (``ofs.losses`` and its
parts), per sample."""

from portbench import spans


def read(record: dict):
    return spans.loss_ms_per_sample(record)
