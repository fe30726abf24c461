"""Device time of the update (``ofs.optimizer``: clip, AdamW, schedule) in a
traced sub-window of training with the spans on, per step."""

from portbench import spans


def read(record: dict):
    return spans.optimizer_ms_per_step(record)
