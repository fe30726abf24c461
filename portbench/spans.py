"""The port's ``ofs.`` spans in a profile: the span each kernel, copy,
launch and host wait belongs to, and the readings by span.

``profile(fn, n, sync)`` runs ``fn(i)`` for ``i < n`` under CPU and CUDA
activity with the port's spans on (``utils.profiling.spans``; a program
without them runs as it is and shows none), and returns ``read_trace``'s
numbers over the events without the spans, so that ``idle_gaps`` keeps the
names of host operations, and under ``spans`` the attribution
(``attribute``).

The attribution, over Chrome-trace events:

- a kernel, copy or fill belongs to the CUDA runtime or driver call with
  the same ``correlation``;
- a call belongs to the innermost of two things that enclose it on its
  thread: an ``ofs.`` span, or a backward ``cpu_op`` (one with a
  ``Fwd thread id``).  A backward op sends it on to the forward op with the
  same ``Sequence number`` (on the forward op's thread, where two threads
  hold the number), which is resolved the same way: so the backward of the
  losses is the losses', and a block rerun under remat is the block's;
- what neither encloses falls to the innermost span open on any thread at
  the call's start (in practice ``ofs.backward`` for autograd's own
  accumulation), and what no span encloses is the benchmark's own work;
- a span's parent is the innermost span enclosing it on its thread, else
  the innermost one open on any thread at its start;
- an idle gap of the card belongs to the innermost span open on any thread
  at the gap's start.

For each span instance its own (``self``) device ms, copy ms, kernel
launches, synchronising calls (``SYNC_CALLS``) with their host ms, and idle
ms; ``total`` adds its descendants'.  Summed by name under ``spans``; the
instances without a parent under ``roots``; the rest under ``outside``.

    python -m portbench.spans --workload <name> [--seed <n>] [--units <k>] [--overhead <r>]

builds one cell's program at its size, warms it up, profiles ``units``
steps, calls or requests with the spans on, and prints the six per-layer
readings and the table by span (``--overhead r``: before it, a session to
warm the profiler and ``r`` pairs of sessions with the spans off and on, the
host's ms a unit in each).
"""

from __future__ import annotations

import argparse
import bisect
import contextlib
import json
import sys
import time
from collections import defaultdict

from portbench import trace

SPAN_PREFIX = "ofs."
SYNC_CALLS = frozenset(
    ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize", "cudaMemcpy"))
QUANTITIES = ("device_ms", "copy_ms", "launches", "syncs", "sync_ms", "idle_ms")
_CALL_CATS = ("cuda_runtime", "cuda_driver")
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def is_span(e: dict) -> bool:
    return e.get("cat") == "user_annotation" and e.get("name", "").startswith(SPAN_PREFIX)


def _args(e: dict) -> dict:
    return e.get("args") or {}


class _Spans:
    """The span instances of a trace, in order of start."""

    def __init__(self, events: list[dict]):
        self.items = sorted(events, key=lambda e: (e["ts"], -e["dur"]))
        self.starts = [e["ts"] for e in self.items]
        self.parent: list[int | None] = [None] * len(self.items)

    def open_at(self, t: float, before: int | None = None) -> int | None:
        """The innermost span open on any thread at ``t``: the latest to start
        (of those ordered before span ``before``)."""
        last = bisect.bisect_right(self.starts, t) if before is None else before
        for i in range(last - 1, -1, -1):
            e = self.items[i]
            if t < e["ts"] + e["dur"]:
                return i
        return None


def attribute(events: list[dict]) -> dict:
    """The profile's readings by span (module docstring)."""
    xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
    spans = _Spans([e for e in xs if is_span(e)])
    index = {id(e): i for i, e in enumerate(spans.items)}

    # one sweep a thread: what encloses each call and each forward op
    threads = defaultdict(list)
    for e in xs:
        cat, a = e.get("cat"), _args(e)
        if is_span(e) or (cat == "cpu_op" and "Sequence number" in a) or cat in _CALL_CATS:
            threads[(e.get("pid"), e.get("tid"))].append(e)
    anchor: dict[int, tuple | None] = {}  # id(call or forward op) -> ("span", i) | ("bwd", ...)
    forward = defaultdict(list)  # sequence number -> [(ts, thread, id(op))]
    for thread, items in threads.items():
        items.sort(key=lambda e: (e["ts"], -e["dur"]))
        stack: list[dict] = []  # the spans and backward ops open at the item's start
        for e in items:
            while stack and stack[-1]["ts"] + stack[-1]["dur"] <= e["ts"]:
                stack.pop()
            a = _args(e)
            if is_span(e):
                outer = next((o for o in reversed(stack) if is_span(o)), None)
                i = index[id(e)]
                spans.parent[i] = (index[id(outer)] if outer is not None
                                   else spans.open_at(e["ts"], before=i))
                stack.append(e)
            elif a.get("Fwd thread id", 0) > 0:
                stack.append(e)
            else:
                inner = stack[-1] if stack else None
                if inner is None:
                    anchor[id(e)] = None
                elif is_span(inner):
                    anchor[id(e)] = ("span", index[id(inner)])
                else:
                    b = _args(inner)
                    anchor[id(e)] = ("bwd", b["Sequence number"], b["Fwd thread id"], inner["ts"])
                if e.get("cat") == "cpu_op":
                    forward[a["Sequence number"]].append((e["ts"], thread, id(e)))
    # which thread each forward thread id is, from the numbers one thread alone holds
    bwd_threads = defaultdict(lambda: defaultdict(int))  # fwd thread id -> {thread: matches}
    for e in xs:
        a = _args(e)
        if e.get("cat") == "cpu_op" and a.get("Fwd thread id", 0) > 0:
            cands = forward.get(a["Sequence number"], [])
            if len({c[1] for c in cands}) == 1:
                bwd_threads[a["Fwd thread id"]][cands[0][1]] += 1
    home = {t: max(c, key=c.get) for t, c in bwd_threads.items()}

    def resolve(found, t: float, depth: int = 0) -> int | None:
        if found is not None and found[0] == "span":
            return found[1]
        if found is not None and depth < 64:
            _, seq, fwd_tid, ts = found
            cands = [c for c in forward.get(seq, []) if c[0] <= ts]
            if fwd_tid in home and any(c[1] == home[fwd_tid] for c in cands):
                cands = [c for c in cands if c[1] == home[fwd_tid]]
            if cands:
                op_ts, _, op = max(cands)
                return resolve(anchor[op], op_ts, depth + 1)
        return spans.open_at(t)

    n = len(spans.items)
    own = [dict.fromkeys(QUANTITIES, 0.0) for _ in range(n + 1)]  # the last: outside every span
    calls = {}
    for e in xs:
        if e.get("cat") in _CALL_CATS:
            i = resolve(anchor.get(id(e)), e["ts"])
            slot = own[n if i is None else i]
            if e["name"] in SYNC_CALLS:
                slot["syncs"] += 1
                slot["sync_ms"] += e["dur"] * 1e-3
            if "correlation" in _args(e):
                calls[_args(e)["correlation"]] = n if i is None else i
    device = []
    for e in xs:
        if e.get("cat") in _DEVICE_CATS:
            device.append((e["ts"], e["ts"] + e["dur"]))
            slot = own[calls.get(_args(e).get("correlation"), n)]
            slot["device_ms"] += e["dur"] * 1e-3
            if e["cat"] == "kernel":
                slot["launches"] += 1
            elif e["cat"] == "gpu_memcpy":
                slot["copy_ms"] += e["dur"] * 1e-3
    busy = trace._union(device)
    for (_, a), (b, _) in zip(busy, busy[1:]):
        i = spans.open_at(a)
        own[n if i is None else i]["idle_ms"] += (b - a) * 1e-3

    total = [dict(q) for q in own[:n]]
    for i in range(n):
        p = spans.parent[i]
        while p is not None:
            for q in QUANTITIES:
                total[p][q] += own[i][q]
            p = spans.parent[p]

    def summed(members) -> dict:
        out: dict = {}
        for i in members:
            name = spans.items[i]["name"]
            entry = out.setdefault(name, {"count": 0, "self": dict.fromkeys(QUANTITIES, 0.0),
                                          "total": dict.fromkeys(QUANTITIES, 0.0)})
            entry["count"] += 1
            for q in QUANTITIES:
                entry["self"][q] += own[i][q]
                entry["total"][q] += total[i][q]
        return out

    return {"device_events": len(device), "spans": summed(range(n)),
            "roots": summed(i for i in range(n) if spans.parent[i] is None),
            "outside": own[n]}


def read(events: list[dict], window_s: float) -> dict:
    """``read_trace``'s numbers over the events without the spans, and the
    attribution under ``spans``."""
    out = trace.read_trace([e for e in events if not is_span(e)], window_s)
    out["spans"] = attribute(events)
    return out


def _switch(on: bool):
    """The port's span switch, or nothing where the program has none."""
    from opticalflowscivis_tpu_torch.utils import profiling

    switch = getattr(profiling, "spans", None)
    return contextlib.nullcontext() if switch is None else switch(on)


def profile(fn, n: int, sync, on: bool = True) -> dict:
    """``fn(i)``, ``i < n``, under CPU and CUDA activity with the spans
    ``on``; ``sync()`` waits for the device."""
    import torch
    from torch.profiler import ProfilerActivity

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with _switch(on):
        return read(*trace._session(fn, range(n), sync, activities))


# -- the readings of the per-layer metrics -------------------------------------------------


def _summary(record: dict, kind: str) -> dict | None:
    prof = record.get("profile")
    if record.get("kind") != kind or not prof or not prof.get("spans"):
        return None
    return prof["spans"] if prof["spans"]["device_events"] else None


def _per(record: dict, kind: str, name: str, quantity: str, unit: str) -> float | None:
    """A span's ``total`` of ``quantity`` over the profile's samples
    (``unit`` ``"sample"``) or over the instances of its top span."""
    s = _summary(record, kind)
    top = "ofs.train_step" if kind == "train" else "ofs.series"
    if s is None or name not in s["spans"] or top not in s["spans"]:
        return None
    units = record["profile"]["samples"] if unit == "sample" else s["spans"][top]["count"]
    return s["spans"][name]["total"][quantity] / units


def loss_ms_per_sample(record: dict) -> float | None:
    return _per(record, "train", "ofs.losses", "device_ms", "sample")


def optimizer_ms_per_step(record: dict) -> float | None:
    return _per(record, "train", "ofs.optimizer", "device_ms", "step")


def train_step_per_step(record: dict, quantity: str) -> float | None:
    return _per(record, "train", "ofs.train_step", quantity, "step")


def transfer_ms_per_call(record: dict) -> float | None:
    parts = [_per(record, "interp", name, "copy_ms", "call")
             for name in ("ofs.series.upload", "ofs.series.download")]
    return None if None in parts else sum(parts)


METRICS = ("loss_ms_per_sample.train", "optimizer_ms_per_step.train", "launches_per_step.train",
           "host_syncs_per_step.train", "host_wait_ms_per_step.train",
           "transfer_ms_per_call.interp")


# -- one cell under the spans --------------------------------------------------------------


def cell_program(ctx):
    """``(kind, fn, samples a unit, units a profile)`` of the cell's
    program, built and warmed up as the cell's run builds it."""
    from portbench.drivers import common, pairs, series, train

    phases = common.Phases(ctx.t0)
    driver = ctx.traffic["driver"]
    if driver == "train":
        cell = train.TrainCell(ctx, phases)
        cell.check_steps()
        return "train", cell.step, cell.batch_size, ctx.traffic["profile_steps"]
    if driver == "series":
        cell = series.SeriesCell(ctx, phases)
        return "interp", cell.call, cell.interpolated(), ctx.traffic["profile_calls"]
    cell = pairs.PairCell(ctx, phases)
    return "interp", cell.request, 1, ctx.traffic["profile_requests"]


def measure(ctx, units: int | None = None, warmup: int = 5, overhead: int = 0) -> dict:
    """The cell's profile with the spans on as a record the metrics read,
    and with ``overhead`` pairs of sessions, the host's ms a unit with the
    spans off and on."""
    import torch

    from portbench import harness
    from portbench.drivers import common

    device = torch.device(ctx.device)
    kind, fn, per_unit, default = cell_program(ctx)
    units = units or default
    for i in range(warmup):
        fn(i)
    common.sync(device)
    host: list[float] = []

    def timed(i):
        t = time.perf_counter()
        fn(warmup + i)
        host.append(time.perf_counter() - t)

    def session(on: bool) -> dict:
        host.clear()
        t = time.perf_counter()
        prof = profile(timed, units, lambda: common.sync(device), on)
        print(f"{ctx.workload}: a session with the spans {'on' if on else 'off'}, "
              f"{time.perf_counter() - t:.1f} s", file=sys.stderr, flush=True)
        return prof

    cost = {"off": [], "on": []}
    if overhead:
        session(False)  # the profiler's first session in a process runs slower
    for k in range(overhead):
        for on in ((False, True) if k % 2 == 0 else (True, False)):
            session(on)
            cost["on" if on else "off"].append(1e3 * sum(host) / len(host))
    prof = session(True)
    prof["samples"] = units * per_unit
    record = {"kind": kind, "profile": prof}
    metrics = {}
    for name in METRICS:
        value = harness.reader(name)(record)
        if value is not None:
            metrics[name] = value
    return {"workload": ctx.workload, "kind": kind, "units": units, "metrics": metrics,
            "device": common.device_record(device, 0)["kind"], "host_ms_a_unit": cost,
            "spans": prof["spans"], "idle_gaps": prof["idle_gaps"],
            "busy_s": prof["busy_s"], "window_s": prof["window_s"]}


def table(result: dict) -> list[str]:
    """The spans' readings a unit, one line a span name."""
    n = result["units"]
    lines = [f"{result['workload']}: by span, a unit of {n} (self; device ms total in brackets)"]
    rows = sorted(result["spans"]["spans"].items(), key=lambda kv: -kv[1]["total"]["device_ms"])
    rows.append(("(no span)", {"count": 0, "self": result["spans"]["outside"],
                               "total": result["spans"]["outside"]}))
    for name, entry in rows:
        s, t = entry["self"], entry["total"]
        lines.append(f"  {name:22s} x{entry['count'] / n:g}: device {s['device_ms'] / n:.3f} ms "
                     f"[{t['device_ms'] / n:.3f}], copies {s['copy_ms'] / n:.3f} ms, "
                     f"launches {s['launches'] / n:g}, syncs {s['syncs'] / n:g} "
                     f"({s['sync_ms'] / n:.3f} ms), idle {s['idle_ms'] / n:.3f} ms")
    return lines


def main(argv: list[str] | None = None) -> int:
    t0 = time.perf_counter()
    ap = argparse.ArgumentParser(prog="portbench.spans")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=2**31 + 11)
    ap.add_argument("--units", type=int, default=None)
    ap.add_argument("--warmup", type=int, default=5)
    ap.add_argument("--overhead", type=int, default=0)
    args = ap.parse_args(argv)

    import torch

    from portbench import harness

    if not torch.cuda.is_available():
        print("portbench.spans reads the card's activity: no CUDA device", file=sys.stderr)
        return 2
    cell = harness.find_cell(harness.load_benchmark(), args.workload)
    ctx = harness.context(cell, args.seed, 0.0, True, "cuda", t0)
    result = measure(ctx, args.units, args.warmup, args.overhead)
    for line in table(result):
        print(line, file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
