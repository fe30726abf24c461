"""Profiling, timing and debug helpers over ``torch.profiler``.

- ``trace``: context manager that profiles the enclosed block (host and, on
  a GPU, device activity) and writes a Chrome trace (``chrome://tracing``,
  Perfetto) into ``log_dir``.
- ``StepTimer``: step-rate meter that waits for the device only when it
  samples, so that timing does not serialize the launch queue.
- ``check_tensor``: prints a tensor's shape, min, max, mean and whether it
  holds a NaN.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch


@contextlib.contextmanager
def trace(log_dir: str = "torch-trace"):
    """Profile the enclosed block: ``with trace('tb') as path: step(...)``
    leaves the Chrome trace at ``path`` (``<log_dir>/trace.json``)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, "trace.json")
    with profile(activities=activities) as prof:
        yield path
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(path)


class StepTimer:
    """Rolling steps-per-second meter."""

    def __init__(self, sample_every: int = 50):
        self.sample_every = sample_every
        self.t0 = time.perf_counter()
        self.steps = 0
        self.rate = 0.0

    def tick(self, result=None) -> float | None:
        """Count one step; every ``sample_every`` steps, wait for ``result``
        (a tensor, or a dict / list / tuple of them) to be computed and
        return the steps per second since the last sample."""
        self.steps += 1
        if self.steps % self.sample_every:
            return None
        if result is not None:
            _synchronize(result)
        now = time.perf_counter()
        self.rate = self.sample_every / (now - self.t0)
        self.t0 = now
        return self.rate


def _synchronize(result) -> None:
    """Wait for the devices that hold ``result``'s tensors."""
    if isinstance(result, torch.Tensor):
        if result.device.type == "cuda":
            torch.cuda.synchronize(result.device)
    elif isinstance(result, dict):
        for v in result.values():
            _synchronize(v)
    elif isinstance(result, (list, tuple)):
        for v in result:
            _synchronize(v)


def check_tensor(x: torch.Tensor, name: str = "tensor") -> None:
    """Print ``x``'s shape, min, max, mean and whether it holds a NaN."""
    xf = x.detach().float()
    print(f"{name}: shape={tuple(x.shape)} min={float(xf.min()):.5f} "
          f"max={float(xf.max()):.5f} mean={float(xf.mean()):.5f} "
          f"nan={bool(torch.isnan(xf).any())}", flush=True)
