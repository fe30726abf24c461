"""Profiling and debug helpers over ``torch.profiler``.

- ``trace``: context manager that profiles the enclosed block (host and, on
  a GPU, device activity) and writes a Chrome trace (``chrome://tracing``,
  Perfetto) into ``log_dir``; the port's spans are on inside it.
- ``span``: a named span at one of the port's layer boundaries (all names
  start with ``ofs.``).  While spans are on it is a
  ``torch.profiler.record_function``, which lands in whatever profiler
  session is running as a ``user_annotation`` event on the clock of the
  device's activity; while they are off it is one shared no-op.
- ``spans``: turns the spans on (or off) for its extent.
- ``check_tensor``: prints a tensor's shape, min, max, mean and whether it
  holds a NaN.

A span never synchronises, allocates a tensor or reads a device value.  Its
parent is the span that encloses it on its thread; a step or request is
one instance of its top-level span (``ofs.train_step``, ``ofs.series``,
``ofs.interpolate``).
"""

from __future__ import annotations

import contextlib
import os

import torch

_OFF = contextlib.nullcontext()
# the switch is the process's, not a thread's: autograd's threads run the
# backward of a step whose spans the caller turned on
_on = False


def span(name: str):
    """``with span('ofs.losses'): ...``; free while spans are off."""
    if not _on:
        return _OFF
    return torch.profiler.record_function(name)


@contextlib.contextmanager
def spans(enabled: bool = True):
    """Spans on (``enabled``) or off for the enclosed block; the previous
    state comes back after it."""
    global _on
    before, _on = _on, enabled
    try:
        yield
    finally:
        _on = before


@contextlib.contextmanager
def trace(log_dir: str = "torch-trace"):
    """Profile the enclosed block with the spans on: ``with trace('tb') as
    path: step(...)`` leaves the Chrome trace at ``path``
    (``<log_dir>/trace.json``)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, "trace.json")
    with profile(activities=activities) as prof, spans():
        yield path
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(path)


def check_tensor(x: torch.Tensor, name: str = "tensor") -> None:
    """Print ``x``'s shape, min, max, mean and whether it holds a NaN."""
    xf = x.detach().float()
    print(f"{name}: shape={tuple(x.shape)} min={float(xf.min()):.5f} "
          f"max={float(xf.max()):.5f} mean={float(xf.mean()):.5f} "
          f"nan={bool(torch.isnan(xf).any())}", flush=True)
