"""Run one cell of the benchmark once and print its result line.

    python -m portbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds the port.  Set-up (imports, weights
and data from the seed, the kernels' build or load, the first training steps
or warm-up requests) is timed from the start of this process; then the cell's
traffic runs for ``--seconds``; with ``--trace 1`` a few more steps or
requests run under the profiler.  Then the outputs are compared with the
plain reference, each number beside its limit on standard error, and the
last line of standard output is the result as JSON.  Without a CUDA device,
or with fewer than the cell asks for, it prints no result and exits 2; if
JAX or the JAX package was loaded, it exits 3.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

from portbench import harness  # noqa: E402


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="portbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    bench = harness.load_benchmark()
    cell = harness.find_cell(bench, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); "
              f"torch.cuda.is_available() = {torch.cuda.is_available()}", file=sys.stderr)
        return 2
    ctx = harness.context(cell, args.seed, args.seconds, bool(args.trace), "cuda", T0)
    record = harness.driver(ctx.traffic).run(ctx)
    bad = harness.forbidden_modules()
    if bad:
        print(f"modules of JAX or the JAX package were loaded: {bad}", file=sys.stderr)
        return 3
    line = harness.result(bench, cell, record, bool(args.trace))
    notes = list(record.get("notes", []))
    if args.trace:  # the window's end-to-end readings, for the record
        notes.append(f"window: {harness.result(bench, cell, record, False)['metrics']}")
    for note in notes:
        print(note, file=sys.stderr)
    for name, value in record["checks"].items():
        if name not in line["checks"]:
            print(f"reading {name} = {value!r} (not compared)", file=sys.stderr)
    for name, c in line["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
