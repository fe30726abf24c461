"""The cost volume's bytes and operations, its least time and its share of
that bound in a traced run, copied from the bring-up smoke's formulas (each
input byte read once, each output byte written once).

A call is one launch of ``corr_fwd_kernel`` or ``corr_bwd_kernel``
(``csrc/corr.cu``) on feature maps ``[B', C, H, W]``, ``B'`` the stacked
batch, at ``max_disp`` 4: ``D = 81`` displacements.
"""

from __future__ import annotations

import re

from portbench import roofline

CORR_KERNEL = re.compile(r"\bcorr_(fwd|bwd)_kernel\b")


def corr_forward_work(shape, size: int, max_disp: int = 4) -> tuple[int, int]:
    """``f1`` and ``f2`` read, the volume written: ``B'·H·W·(2C + D)``
    elements of ``size`` bytes; a multiply and an add per channel and
    displacement."""
    b, c, h, w = shape
    d = (2 * max_disp + 1) ** 2
    px = b * h * w
    return px * (2 * c + d) * size, px * d * 2 * c


def corr_backward_work(shape, size: int, grads: int = 2, max_disp: int = 4) -> tuple[int, int]:
    """``f1``, ``f2`` and the volume's gradient read, ``grads`` feature
    gradients written (both: ``B'·H·W·(4C + D)`` elements); a multiply and
    an add per channel and displacement of each gradient."""
    b, c, h, w = shape
    d = (2 * max_disp + 1) ** 2
    px = b * h * w
    return px * ((2 + grads) * c + d) * size, px * d * 2 * c * grads


def corr_bound_s(calls: list[dict], max_disp: int = 4) -> float:
    """Seconds the cost-volume ``calls`` (``reference.upflow_count``'s
    records: ``shape``, ``bytes``, ``grads``, ``backward``) take at least."""
    total = 0.0
    for call in calls:
        total += roofline.bound_s(corr_forward_work(call["shape"], call["bytes"], max_disp))
        if call["backward"] and call["grads"]:
            total += roofline.bound_s(
                corr_backward_work(call["shape"], call["bytes"], call["grads"], max_disp))
    return total


def corr_seconds(prof: dict) -> float:
    return sum(sec for name, sec in prof["kernels"] if CORR_KERNEL.search(name))


def corr_roofline_pct(record: dict, kind: str) -> float | None:
    """The cost volume's least time by the count over the device time of its
    kernels in the traced sub-window; None where the run has no profile, no
    count or no such kernel."""
    prof = record.get("profile")
    bound = record.get("work", {}).get("corr_bound_s_per_sample")
    if record.get("kind") != kind or not prof or not prof.get("kernels") or not bound:
        return None
    spent = corr_seconds(prof)
    return 100.0 * bound * prof["samples"] / spent if spent else None
