"""The arithmetic of the metrics, one function per quantity; each file of
``metrics/`` names its quantity and the kind of run (``train`` or
``interp``) it reads.  A function returns None where the run has nothing to
read, never 0 for a share."""

from __future__ import annotations

import statistics

from portbench import roofline, trace


def _kind(record: dict, kind: str | None) -> bool:
    return kind is None or record["kind"] == kind


def rate(record: dict, kind: str) -> float | None:
    """Samples completed in the window over its wall time."""
    if not _kind(record, kind):
        return None
    return record["samples"] / record["window_s"]


def p95_ms(record: dict) -> float | None:
    """The 95th percentile of every request's latency in the window."""
    lat = record.get("latencies_s")
    if not lat or len(lat) < 2:
        return None
    return statistics.quantiles(lat, n=100, method="inclusive")[94] * 1e3


def peak_gib(record: dict) -> float | None:
    """The window's peak of allocated device memory, after a reset at its start."""
    return record["peak_bytes"] / 2**30 if record["peak_bytes"] else None


def setup_s(record: dict) -> float:
    return record["setup_s"]


def host_enqueue_ms(record: dict, kind: str) -> float | None:
    """The host's mean time in ``train_step`` until it returns, unsynchronised."""
    s = record.get("host_enqueue_s")
    if not _kind(record, kind) or not s:
        return None
    return statistics.fmean(s) * 1e3


def _profile(record: dict, kind: str):
    prof = record.get("profile")
    if not _kind(record, kind) or not prof or not prof["kernels"]:
        return None
    return prof


def conv_ms_per_sample(record: dict, kind: str) -> float | None:
    """Device time of the convolutions' kernels in the traced sub-window over its samples."""
    prof = _profile(record, kind)
    if prof is None:
        return None
    conv = trace.conv_seconds(prof)
    return conv / prof["samples"] * 1e3 if conv else None


def warp_roofline_pct(record: dict, kind: str) -> float | None:
    """The warps' least time by the benchmark's count over their kernels'
    device time in the traced sub-window."""
    prof = _profile(record, kind)
    if prof is None:
        return None
    spent = trace.warp_seconds(prof)
    if not spent:
        return None
    return 100.0 * record["work"]["warp_bound_s_per_sample"] * prof["samples"] / spent


def idle_pct(record: dict, kind: str) -> float | None:
    """The share of the traced sub-window in which nothing ran on the card."""
    prof = _profile(record, kind)
    if prof is None:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])


def mfu_pct(record: dict, kind: str) -> float | None:
    """The reference's FLOPs per sample times the window's rate, over the
    card's dense bfloat16 peak."""
    if not _kind(record, kind) or record["device"]["platform"] != "gpu":
        return None
    flops = record["work"]["flops_per_sample"] * rate(record, kind)
    return 100.0 * flops / roofline.BF16_FLOPS_PER_S
