"""Device time of the copies of ``ofs.series.upload`` and
``ofs.series.download`` in a traced sub-window of series calls with the
spans on, per call."""

from portbench import spans


def read(record: dict):
    return spans.transfer_ms_per_call(record)
