"""The whole training step's share of the card's dense bfloat16 peak, by the reference's FLOP count."""

from portbench import readers


def read(record: dict):
    return readers.mfu_pct(record, "train")
