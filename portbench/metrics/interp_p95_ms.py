"""The 95th percentile of the latency of every request in the window, from its send to its synchronised output."""

from portbench import readers


def read(record: dict):
    return readers.p95_ms(record)
