"""The benchmark's own tests: CPU at tiny sizes; those marked ``cuda`` run
the cells' control readings on a card and skip elsewhere.

    python -m pytest portbench/tests -q
"""

import copy

import pytest

from portbench import harness

# a few channels a block, float32, small frames: the plain CPU path
TINY_MODEL = {"block_channels": [16, 12, 8], "teacher_channels": 8, "bfloat16": False}
TINY_TRAFFIC = {
    "train": {"batch": 2, "series_frames": 10, "profile_steps": 1},
    "series": {"series_frames": 40, "call_frames": 17, "call_stride": 8, "start_wrap": 20,
               "warmup_calls": 1, "profile_calls": 1},
    "pairs": {"series_frames": 4, "warmup_requests": 1, "profile_requests": 2},
}


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA GPU; skips on hosts without one")


def tiny_context(workload: str, seed: int = 2**33 + 7, seconds: float = 0.5,
                 trace: bool = False, here=harness.HERE, root=harness.ROOT):
    """A cell's context shrunk to the CPU: narrow blocks, small frames, few
    steps; everything else as the cell's files say."""
    cell = harness.find_cell(harness.load_benchmark(root), workload)
    ctx = harness.context(cell, seed, seconds, trace, "cpu", 0.0, here)
    ctx.config = copy.deepcopy(ctx.config)
    ctx.config["model"].update(TINY_MODEL)
    ctx.config["size"] = [32, 64] if ctx.config["model"]["ndim"] == 2 else [32, 32, 32]
    ctx.traffic.update(TINY_TRAFFIC[ctx.traffic["driver"]])
    return ctx


def run_tiny(ctx, root=harness.ROOT, here=harness.HERE) -> dict:
    """One run of the context on the CPU: the result line."""
    import time

    ctx.t0 = time.perf_counter()
    bench = harness.load_benchmark(root)
    cell = harness.find_cell(bench, ctx.workload)
    record = harness.driver(ctx.traffic).run(ctx)
    return harness.result(bench, cell, record, ctx.trace, here)


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
