#!/usr/bin/env python3
"""Run one cell of the benchmark once and print its result line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. Set-up (weights from the seed on the card, the
kernels from build/kernels/, a warm-up of the cell's shapes) counts as
`setup_s`; then the cell's driver measures for `--seconds`, compares what
the window produced with the plain reference, and the last line of
standard output is one JSON object: `correct`, `attempted`, `failed`,
`metrics` (the cell's end-to-end metrics, or with `--trace 1` its
per-layer ones), `device`, with `--trace 1` `breakdown`, and last `checks`,
each number compared with its limit (also the last lines of standard
error). Exits non-zero, with no result, without enough CUDA devices, or if
JAX or the JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# build and kernel caches at fixed paths inside the checkout
os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, "build", "torch_extensions")


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from perfbench import harness

    cell = harness.load_cell(args.workload)
    harness.require_cuda(cell.chips)
    ctx = harness.Context(cell, args.seed, args.seconds, bool(args.trace), T_START)
    harness.driver_module(cell.traffic["driver"]).run(ctx)
    harness.report_traced_steps(ctx.run)
    out, lines = harness.result_line(ctx)
    loaded = harness.forbidden_modules()
    if loaded:
        print(f"perfbench: the run loaded {loaded}; no result", file=sys.stderr)
        return 1
    sys.stdout.flush()
    print("\n".join(lines), file=sys.stderr, flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
