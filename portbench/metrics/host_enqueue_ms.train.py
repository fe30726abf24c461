"""The host's mean time in Trainer.train_step until it returns, unsynchronised, over the window's steps."""

from portbench import readers


def read(record: dict):
    return readers.host_enqueue_ms(record, "train")
