"""The host's time in the synchronising CUDA calls made inside
``ofs.train_step`` in a traced sub-window of training with the spans on, per
step."""

from portbench import spans


def read(record: dict):
    return spans.train_step_per_step(record, "sync_ms")
