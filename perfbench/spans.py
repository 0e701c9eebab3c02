#!/usr/bin/env python3
"""The program's own spans and counters over a cell's measured window.

    python3 perfbench/spans.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Runs one cell as perfbench/run.py does (the same driver, set-up, window,
comparison and result line), with the port's recorder
(`utils/profiling.recording`) open over the measured window: run.py on the
same seed is the run without it. The result line (the last line of
standard output) adds `program`:

  metrics     the per-layer readings of the cell's program spans and
              counters (READERS: the cell each is for, its unit);
  spans       each span name's calls, total and self seconds in the window
              (also a table on standard error);
  idle_split  with --trace 1, the traced sub-window's idle gaps split where
              the innermost open program span changes, each piece named
              `<benchmark span>/<program span>` (the benchmark's span as
              run.py names the gap; its name alone under no program span),
              seconds by name;
  idle_named  for each benchmark span, the share of its idle time that lies
              under a program span.

The innermost open program span is that of the thread that drives the
window where it has one open, else the latest opened on another thread.
The benchmark's own numbers are run.py's: its reduction of the trace runs
unchanged, and the split reads the same events beside it.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import bisect  # noqa: E402
import collections  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import threading  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def mean_ms(name: str):
    def read(spans, counts):
        d = [s.end_ns - s.start_ns for s in spans if s.name == name]
        return sum(d) / len(d) / 1e6 if d else None

    return read


def blank_share(spans, counts):
    n = counts.get("engine.frames_transformed", 0)
    return 100.0 * counts.get("engine.frames_blank", 0) / n if n else None


# metric -> (the cell it is read in, unit, reader(spans, counts) -> float | None)
READERS = {
    "plan_ms.pass1": ("basic-768x576-pass1", "ms", mean_ms("renderer.prepare")),
    "prepare_images_ms.pass1": ("basic-768x576-pass1", "ms", mean_ms("prepare_images")),
    "blank_frames.pass1": ("basic-768x576-pass1", "%", blank_share),
    "step_host_ms.render": ("basic-768x576-pass2", "ms", mean_ms("sample.step")),
    "step_host_ms.train": ("finetune-576-t21", "ms", mean_ms("train.step")),
    "optimizer_host_ms.train": ("finetune-576-t21", "ms", mean_ms("train.optimizer")),
    "data_wait_ms.train": ("finetune-576-t21", "ms", mean_ms("data.wait")),
    "batch_build_ms.train": ("finetune-576-t21", "ms", mean_ms("data.batch")),
}


def readings(cell: str, spans, counts) -> dict:
    out = {}
    for name, (for_cell, unit, read) in READERS.items():
        value = read(spans, counts) if for_cell == cell else None
        if value is not None:
            out[name] = {"value": value, "unit": unit}
    return out


def device_gaps(events, trace_start_ns: int, window) -> list[tuple[float, float]]:
    """The idle gaps of the traced window (us after the trace's start), as
    perfbench/trace.reduce_events finds them: the device's work is every
    CUDA event but a range's annotation, clipped to the window."""
    from torch.autograd import DeviceType

    from perfbench import trace

    w0, w1 = ((t - trace_start_ns) / 1e3 for t in window)
    device = []
    for e in events:
        if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False):
            a, b = max(e.time_range.start, w0), min(e.time_range.end, w1)
            if b > a:
                device.append((a, b))
    if not device:
        return [(w0, w1)]
    _, gaps = trace.union_length(device)
    first, last = min(a for a, _ in device), max(b for _, b in device)
    return [(w0, first)] * (first > w0) + gaps + [(last, w1)] * (w1 > last)


class _Open:
    """Which of a set of intervals is the innermost one open at a time: the
    latest opened that holds it (intervals of one thread nest)."""

    def __init__(self, intervals):
        self.items = sorted(intervals)
        self.starts = [a for a, _, _ in self.items]

    def at(self, t):
        i = bisect.bisect_right(self.starts, t) - 1
        while i >= 0:
            a, b, name = self.items[i]
            if a <= t <= b:
                return name
            i -= 1
        return None


def split_idle(gaps, trace_start_ns: int, bench_spans, program_spans, thread: int) -> list[tuple[str, float]]:
    """Each idle gap (us after the trace's start) cut where the innermost
    open program span changes: [(name, seconds)], longest first. A piece's
    name is the benchmark span open where its gap starts, as
    trace.reduce_events names the gap, then `/` and the program span, if
    any. `bench_spans` are [(start_ns, end_ns, name)], `program_spans` the
    program's `utils/profiling.Span`s; `thread` drives the window."""

    def us(t):
        return (t - trace_start_ns) / 1e3

    bench = _Open([(us(a), us(b), name) for a, b, name in bench_spans])
    own = _Open([(us(s.start_ns), us(s.end_ns), s.name) for s in program_spans if s.thread == thread])
    other = _Open([(us(s.start_ns), us(s.end_ns), s.name) for s in program_spans if s.thread != thread])
    cuts = sorted({t for x in (own, other) for a, b, _ in x.items for t in (a, b)})
    pieces = []
    for a, b in gaps:
        where = bench.at(a) or "outside spans"
        inner = cuts[bisect.bisect_right(cuts, a):bisect.bisect_left(cuts, b)]
        for p, q in zip([a] + inner, inner + [b]):
            if q <= p:
                continue
            mid = (p + q) / 2
            span = own.at(mid) or other.at(mid)
            name = f"{where}/{span}" if span else where
            if pieces and pieces[-1][0] == name and pieces[-1][2] == p:
                pieces[-1][1] += (q - p) / 1e6
                pieces[-1][2] = q
            else:
                pieces.append([name, (q - p) / 1e6, q])
    return sorted(((n, s) for n, s, _ in pieces), key=lambda x: -x[1])


def idle_summary(pieces) -> tuple[dict, dict]:
    """(seconds by piece name, longest first; for each benchmark span, the
    share of its idle time under a program span)."""
    by_name: collections.Counter = collections.Counter()
    named, total = collections.Counter(), collections.Counter()
    for name, s in pieces:
        by_name[name] += s
        where = name.split("/", 1)[0]
        total[where] += s
        if "/" in name:
            named[where] += s
    return dict(by_name.most_common()), {w: named[w] / total[w] for w in total if total[w] > 0}


@contextlib.contextmanager
def recorded(state: dict):
    """Within the block, every measured window a driver opens
    (`harness.window_memory`) runs under a program recording, kept in
    `state["recording"]`, and the traced sub-window's reduction also
    splits its idle gaps by program span (`state["pieces"]`)."""
    from perfbench import harness, trace
    from stable_virtual_camera_tpu_torch.utils import profiling

    window_memory, reduce_events = harness.window_memory, trace.reduce_events
    thread = threading.get_ident()

    @contextlib.contextmanager
    def window(*args, **kwargs):
        with window_memory(*args, **kwargs):
            with profiling.recording() as rec:
                yield
        state["recording"] = rec

    def reduce(events, trace_start_ns, window_ns, spans):
        events = list(events)
        rec = state.get("recording")
        state["pieces"] = split_idle(device_gaps(events, trace_start_ns, window_ns), trace_start_ns, spans,
                                     rec.spans if rec else [], thread)
        return reduce_events(events, trace_start_ns, window_ns, spans)

    harness.window_memory, trace.reduce_events = window, reduce
    try:
        yield state
    finally:
        harness.window_memory, trace.reduce_events = window_memory, reduce_events


def program_result(cell: str, state: dict) -> dict:
    from stable_virtual_camera_tpu_torch.utils import profiling

    rec = state.get("recording")
    if rec is None:
        return {}
    counts = rec.counts()
    out = {"metrics": readings(cell, rec.spans, counts), "counts": counts,
           "spans": {k: list(v) for k, v in profiling.summary(rec.spans).items()}}
    if "pieces" in state:
        by_name, named = idle_summary(state["pieces"])
        out["idle_split"] = by_name
        out["idle_named"] = named
        out["idle_longest"] = [[n, s] for n, s in state["pieces"][:12]]
    return out


def span_table(spans: dict) -> str:
    lines = [f"{'span':<28} {'calls':>7} {'total_s':>10} {'self_s':>10} {'mean_ms':>10}"]
    for name, (calls, total, own) in spans.items():
        lines.append(f"{name:<28} {calls:7d} {total:10.4f} {own:10.4f} {1e3 * total / calls:10.3f}")
    return "\n".join(lines)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    # the build and kernel caches at run.py's paths inside the checkout
    os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, "build", "torch_extensions")
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from perfbench import harness

    cell = harness.load_cell(args.workload)
    harness.require_cuda(cell.chips)
    ctx = harness.Context(cell, args.seed, args.seconds, bool(args.trace), T_START)
    state: dict = {}
    with recorded(state):
        harness.driver_module(cell.traffic["driver"]).run(ctx)
    harness.report_traced_steps(ctx.run)
    out, lines = harness.result_line(ctx)
    out["program"] = program_result(cell.name, state)
    if out["program"]:
        print(span_table(out["program"]["spans"]), file=sys.stderr, flush=True)
    loaded = harness.forbidden_modules()
    if loaded:
        print(f"perfbench: the run loaded {loaded}; no result", file=sys.stderr)
        return 1
    print("\n".join(lines), file=sys.stderr, flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
