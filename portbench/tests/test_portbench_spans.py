"""The attribution of a profile to the port's ``ofs.`` spans
(``portbench/spans.py``) on hand-written Chrome-trace events, its readings
on a CPU run (none: no device activity), and on a card the share of each
top-level span's device time that no child span holds."""

import pytest

from portbench import harness, spans, trace
from portbench.tests.conftest import tiny_context
from portbench.tests.test_portbench_drivers import CELLS


def X(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 1, "tid": tid,
            "args": args}


def fwd(name, ts, dur, seq, tid=1):
    return X("cpu_op", name, ts, dur, tid, **{"Sequence number": seq, "Fwd thread id": 0})


def bwd(name, ts, dur, seq, fwd_tid, tid=2):
    return X("cpu_op", name, ts, dur, tid, **{"Sequence number": seq, "Fwd thread id": fwd_tid})


def launch(ts, correlation, tid=1, name="cudaLaunchKernel", dur=1):
    return X("cuda_runtime", name, ts, dur, tid, correlation=correlation)


def device(name, ts, dur, correlation, cat="kernel"):
    return X(cat, name, ts, dur, 7, correlation=correlation)


# one train step (times in microseconds): the forward on thread 1, the backward
# on autograd's thread 2, a kernel after the step
STEP = [
    X("user_annotation", "ofs.train_step", 0, 100),
    X("user_annotation", "ofs.ifnet", 1, 20),
    fwd("aten::conv2d", 2, 5, seq=7), launch(3, 1),
    X("user_annotation", "ofs.losses", 25, 20),
    fwd("aten::pow", 26, 5, seq=8), launch(27, 2),
    launch(30, 3, name="cudaMemcpyAsync", dur=2),
    launch(32, None, name="cudaStreamSynchronize", dur=5),
    X("user_annotation", "ofs.backward", 50, 30),
    bwd("autograd::engine::evaluate_function: PowBackward0", 52, 6, seq=8, fwd_tid=1),
    launch(53, 4, tid=2),
    X("cpu_op", "torch::autograd::AccumulateGrad", 60, 3, 2), launch(61, 5, tid=2),
    X("user_annotation", "ofs.optimizer", 82, 10), launch(83, 6),
    launch(105, 7),
    device("conv", 4, 10, 1), device("pow", 28, 2, 2),
    device("Memcpy HtoD (Pageable -> Device)", 31, 1, 3, cat="gpu_memcpy"),
    device("pow_bwd", 54, 4, 4), device("accumulate", 62, 1, 5), device("adam", 84, 3, 6),
    device("gather", 106, 2, 7),
]


def _close(got: dict, want: dict):
    for q, v in want.items():
        assert got[q] == pytest.approx(v, abs=1e-12), (q, got)


def test_calls_kernels_copies_and_idle_gaps_go_to_their_spans():
    s = spans.attribute(STEP)
    by = s["spans"]
    assert s["device_events"] == 7 and set(s["roots"]) == {"ofs.train_step"}
    # a kernel through its launch's correlation
    _close(by["ofs.ifnet"]["self"], {"device_ms": 0.010, "launches": 1, "idle_ms": 0.014})
    # the backward kernel to the forward op's span through its Sequence number; the copy
    # and the synchronising call where they were made
    _close(by["ofs.losses"]["self"], {"device_ms": 0.007, "copy_ms": 0.001, "launches": 2,
                                      "syncs": 1, "sync_ms": 0.005, "idle_ms": 0.023})
    # autograd's accumulation, under no backward op with a number: the span open on any thread
    _close(by["ofs.backward"]["self"], {"device_ms": 0.001, "launches": 1, "idle_ms": 0.025})
    _close(by["ofs.optimizer"]["self"], {"device_ms": 0.003, "launches": 1, "idle_ms": 0.019})
    _close(by["ofs.train_step"]["self"], {"device_ms": 0.0, "launches": 0})
    _close(by["ofs.train_step"]["total"], {"device_ms": 0.021, "copy_ms": 0.001, "launches": 5,
                                           "syncs": 1, "sync_ms": 0.005, "idle_ms": 0.081})
    # outside every span: the benchmark's own
    _close(s["outside"], {"device_ms": 0.002, "launches": 1, "idle_ms": 0.0})

    record = {"kind": "train", "profile": {"samples": 4, "spans": s}}
    read = {name: harness.reader(name)(record) for name in spans.METRICS}
    assert read == pytest.approx({
        "loss_ms_per_sample.train": 0.007 / 4, "optimizer_ms_per_step.train": 0.003,
        "launches_per_step.train": 5, "host_syncs_per_step.train": 1,
        "host_wait_ms_per_step.train": 0.005, "transfer_ms_per_call.interp": None})


def test_a_block_rerun_under_remat_is_the_blocks():
    """The rerun's forward ops run on autograd's thread inside the backward op
    that unpacked them; their own backward reaches the block through both."""
    events = [
        X("user_annotation", "ofs.train_step", 0, 100),
        X("user_annotation", "ofs.block0", 1, 10), fwd("aten::conv3d", 2, 5, seq=40),
        X("user_annotation", "ofs.losses", 12, 10), fwd("aten::abs", 13, 2, seq=3),
        X("user_annotation", "ofs.backward", 30, 60),
        bwd("ConvolutionBackward0", 40, 20, seq=40, fwd_tid=1),
        fwd("aten::conv3d", 41, 5, seq=3, tid=2), launch(42, 1, tid=2),  # the rerun
        bwd("ConvolutionBackward0", 50, 5, seq=3, fwd_tid=2), launch(51, 2, tid=2),
        bwd("AbsBackward0", 70, 5, seq=3, fwd_tid=1), launch(71, 3, tid=2),
        device("rerun", 43, 2, 1), device("rerun_bwd", 52, 2, 2), device("abs_bwd", 72, 2, 3),
    ]
    by = spans.attribute(events)["spans"]
    assert by["ofs.block0"]["self"]["launches"] == 2
    assert by["ofs.block0"]["self"]["device_ms"] == pytest.approx(0.004)
    assert by["ofs.losses"]["self"]["launches"] == 1
    assert by["ofs.backward"]["self"]["launches"] == 0


def test_idle_gaps_keep_the_host_operations_names():
    """The spans enclose the gaps that no operation does; ``read`` leaves them
    out of ``idle_gaps`` as ``read_trace`` has it without them."""
    plain = [e for e in STEP if not spans.is_span(e)]
    assert spans.read(STEP, 1.0)["idle_gaps"] == trace.read_trace(plain, 1.0)["idle_gaps"]
    assert trace.read_trace(STEP, 1.0)["idle_gaps"] != trace.read_trace(plain, 1.0)["idle_gaps"]


def test_a_profile_without_device_activity_reads_nothing():
    empty = spans.attribute([e for e in STEP if e["cat"] not in ("kernel", "gpu_memcpy")])
    record = {"kind": "train", "profile": {"samples": 4, "spans": empty}}
    assert all(harness.reader(name)(record) is None for name in spans.METRICS)


@pytest.mark.parametrize("workload", CELLS)
def test_a_tiny_cpu_run_reports_the_span_metrics_absent(workload):
    """A traced run of the cell (its profile has no spans) and the spans'
    own session on the CPU (no device activity): every metric absent, not 0;
    the session holds one top-level span a unit."""
    record = harness.driver(tiny_context(workload).traffic).run(tiny_context(workload, trace=True))
    assert all(harness.reader(name)(record) is None for name in spans.METRICS)
    result = spans.measure(tiny_context(workload, trace=True), units=1, warmup=1)
    assert result["metrics"] == {}
    top = {"train": "ofs.train_step", "series": "ofs.series", "pairs": "ofs.interpolate"}
    assert result["spans"]["roots"][top[tiny_context(workload).traffic["driver"]]]["count"] == 1


EXPECTED = {"train": [m for m in spans.METRICS if m.endswith(".train")],
            "series": ["transfer_ms_per_call.interp"], "pairs": []}


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_the_child_spans_hold_the_top_level_spans_kernels(workload, cuda):
    """On a card, at the cell's size: inside every top-level span the device
    time that no child span holds is under 5 % of the span's, and the cell's
    metrics read a number."""
    cell = harness.find_cell(harness.load_benchmark(), workload)
    ctx = harness.context(cell, 2**31 + 321, 0.0, True, "cuda", 0.0)
    result = spans.measure(ctx, warmup=3)
    for name, root in result["spans"]["roots"].items():
        assert root["self"]["device_ms"] < 0.05 * root["total"]["device_ms"], (name, root)
    assert sorted(result["metrics"]) == sorted(EXPECTED[ctx.traffic["driver"]]), result["metrics"]
