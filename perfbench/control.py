#!/usr/bin/env python3
"""The control of a cell's comparison: the reference put in the program's
place in the nearest precision below the configuration's (float8 e4m3
operands for a bfloat16 configuration, bfloat16 arithmetic for the fp32
sampler step; reference/precision.py), on the inputs the program's window
produced, for several seeds in one process. Its readings take the
program's place in the run's checks, so the run's own `correct` says
whether the control passes the cell's limits. Not run by the benchmark's
runs: it gives the readings that the limits are set from.

    python3 perfbench/control.py --workload <cell> --seconds <s> --seeds <n> [<n> ...] [--fault <name>]

One JSON line a seed: {"seed", "correct", "checks": {number: {value,
limit}}, "program": {number: value}, "control": {...}}. With `--fault`, the
program runs with that fault planted under its timed path
(perfbench/faults.py), no control is read, and the checks are the fault's.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, "build", "torch_extensions")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--fault", help="read the program's numbers with this fault planted (perfbench/faults.py) instead")
    args = p.parse_args(argv)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import contextlib

    from perfbench import faults, harness

    cell = harness.load_cell(args.workload)
    if args.fault and args.fault not in faults.faults_of(cell.traffic["driver"]):
        p.error(f"--fault must be one of {faults.faults_of(cell.traffic['driver'])}")
    harness.require_cuda(cell.chips)
    for seed in args.seeds:
        ctx = harness.Context(cell, seed, args.seconds, False, time.perf_counter(), control=args.fault is None)
        with faults.plant(args.fault, cell.traffic["driver"]) if args.fault else contextlib.nullcontext():
            harness.driver_module(cell.traffic["driver"]).run(ctx)
        out, _lines = harness.result_line(ctx)
        print(json.dumps({"seed": seed, "correct": out["correct"], "checks": out["checks"],
                          "program": ctx.run.program, "control": ctx.run.control}), flush=True)
        harness.free_memory()
    return 0


if __name__ == "__main__":
    sys.exit(main())
