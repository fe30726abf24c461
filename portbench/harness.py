"""The general part of a run: find a cell's files by name, run its traffic's
driver, check the outputs against the cell's limits, read the metrics and
assemble the result line.

A cell is an entry of ``workloads`` in ``BENCHMARK.json``.  Its files:

- ``portbench/configs/<config>.json``: the model, loss and optimizer groups
  and the sizes, as run;
- ``portbench/traffic/<traffic>.json``: the traffic's parameters and the
  ``driver`` (a module of ``portbench/drivers/``) that plays them;
- ``portbench/limits/<workload>.json``: the numbers of the comparison with
  the plain reference that the cell compares, each with its limit (the
  others are readings, shown and not judged);
- ``portbench/metrics/<metric>.py``: one reader per metric, ``read(record)``,
  returning a number or None (nothing to read in this run).

A driver's ``run(ctx)`` returns the run's record: the window's counts and
clocks, the profile of the traced sub-window, the work the reference counts,
and ``checks``, the numbers of the comparison.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import math
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
HERE = ROOT / "portbench"
# top-level module names a run may not hold: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "opticalflowscivis_tpu")


@dataclasses.dataclass
class Context:
    """What a driver gets: the cell, its files' contents and the run's knobs."""

    workload: str
    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: str
    t0: float  # the host clock at the start of the process


def load_benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def find_cell(bench: dict, name: str) -> dict:
    for cell in bench["workloads"]:
        if cell["name"] == name:
            return cell
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def read_json(kind: str, name: str, here: Path = HERE) -> dict:
    with open(here / kind / f"{name}.json") as f:
        return json.load(f)


def context(cell: dict, seed: int, seconds: float, trace: bool, device: str, t0: float,
            here: Path = HERE) -> Context:
    return Context(cell["name"], read_json("configs", cell["config"], here),
                   read_json("traffic", cell["traffic"], here), seed, seconds, trace, device, t0)


def driver(traffic: dict):
    return importlib.import_module(f"portbench.drivers.{traffic['driver']}")


def reader(name: str, here: Path = HERE):
    """The ``read`` function of ``portbench/metrics/<name>.py``."""
    path = here / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def cell_metrics(bench: dict, cell: str, trace: bool) -> list[dict]:
    """The metrics a run of ``cell`` reports: the end-to-end ones without
    ``trace``, the per-layer ones with it; each where it lists the cell or
    lists no cells."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole (the port's name begins with the JAX package's)."""
    return sorted({name for name in list(sys.modules)
                   if name.split(".", 1)[0] in FORBIDDEN})


def judge(checks: dict, limits: dict) -> tuple[bool, dict]:
    """``(correct, {name: {"value", "limit"}})`` over the numbers that the
    limits name: each one there, finite and at or under its limit."""
    shown = {name: {"value": checks.get(name), "limit": limit} for name, limit in limits.items()}
    ok = bool(shown) and all(
        v["value"] is not None and math.isfinite(v["value"]) and v["value"] <= v["limit"]
        for v in shown.values())
    return ok, shown


def result(bench: dict, cell: dict, record: dict, trace: bool, here: Path = HERE) -> dict:
    """The result line: ``correct``, ``attempted``, ``failed``, ``metrics``,
    ``device``, with ``trace`` ``breakdown``, and last ``checks``."""
    limits = read_json("limits", cell["name"], here)
    correct, checks = judge(record["checks"], limits)
    metrics = {}
    for m in cell_metrics(bench, cell["name"], trace):
        value = reader(m["name"], here)(record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = dict(record["device"])
    line = {"correct": correct, "attempted": record["attempted"], "failed": record["failed"],
            "metrics": metrics, "device": device}
    if trace and record.get("profile"):
        prof = record["profile"]
        device.update(busy_s=prof["busy_s"], window_s=prof["window_s"])
        line["breakdown"] = {"device_ops": prof["device_ops"], "idle_gaps": prof["idle_gaps"]}
    line["checks"] = checks
    return line
