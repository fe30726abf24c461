"""Kernel launches made inside ``ofs.train_step`` (any thread) in a traced sub-
window of training with the spans on, per step."""

from portbench import spans


def read(record: dict):
    return spans.train_step_per_step(record, "launches")
