"""What every cell shares: the files a cell is made of, the seeds, the
measured window, the traced sub-window and the result line.

A cell is an entry of BENCHMARK.json's `workloads`. Its files, found by
name: configs/<config>.json (the model as it is run), traffic/<traffic>.json
(the traffic's parameters and the `driver` that runs it:
drivers/<driver>.py), limits/<cell>.json (the limit of each number the
comparison with the reference gives) and, for each per-layer metric the
cell reports, layer_metrics/<metric>.py. A driver's `run(ctx)` makes the
cell's set-up and window and fills `ctx.run` (a `RunData`); the harness
reports from it.
"""

from __future__ import annotations

import contextlib
import gc
import hashlib
import importlib.util
import json
import math
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

import torch

from perfbench import trace as trace_mod

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# top-level module names that a run may not hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "stable_virtual_camera_tpu")
GIB = float(1 << 30)
# the caching allocator's counters read over the window: retries after a
# failed allocation (each frees cached blocks and synchronizes), and the
# segments it took from and gave back to the device
ALLOCATOR_COUNTS = ("num_alloc_retries", "num_device_alloc", "num_device_free")


def derive_seed(seed: int, *tags) -> int:
    """A 63-bit seed for one use of a run's seed."""
    h = hashlib.sha256(repr((int(seed),) + tags).encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list[dict]
    per_layer: list[dict]


def load_cell(name: str, root: Path = ROOT, bench: dict | None = None, files: Path = HERE) -> Cell:
    """The cell `name` of BENCHMARK.json (or of `bench`), with its files
    under `files`, and the metrics it reports."""
    bench = bench if bench is not None else load_json(root / "BENCHMARK.json")
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if name in m.get("workloads", []) or ("workloads" not in m and m["moves"] in reported)]
    return Cell(name=name, chips=entry["chips"], config=load_json(root / conf["file"]),
                traffic=load_json(files / "traffic" / f"{entry['traffic']}.json"),
                limits=load_json(files / "limits" / f"{name}.json"), end_to_end=e2e, per_layer=per_layer)


def layer_reader(metric: str, files: Path = HERE):
    """The `read(run) -> float | None` of layer_metrics/<metric>.py."""
    path = files / "layer_metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"perfbench_layer_metric_{metric.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def driver_module(name: str):
    return importlib.import_module(f"perfbench.drivers.{name}")


def require_cuda(chips: int) -> None:
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        sys.exit(f"perfbench: this cell needs {chips} CUDA device(s); {have} available")


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def free_memory() -> None:
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


@dataclass
class RunData:
    """What a driver measured, for the result line and the layer readers."""

    # the window: host wall seconds and the work it completed
    window_s: float = 0.0
    steps: int = 0
    # e2e metric name -> value, filled by the driver
    end_to_end: dict = field(default_factory=dict)
    # CUDA event milliseconds between consecutive steps of the window, and
    # for each gap whether a unit of work (chunk or request) ended before it
    step_ms: list = field(default_factory=list)
    boundary_after: list = field(default_factory=list)
    # the traced sub-window (trace runs): its reduction and the steps it holds
    traced: trace_mod.TraceWindow | None = None
    traced_steps: int = 0
    # the work of one step, from counts/: FLOPs, K1's and K2's bounds (s)
    step_flops: float = 0.0
    step_k1_bound_s: float = 0.0
    step_k2_bound_s: float = 0.0
    # number compared -> (value, limit): the program's readings, or in a
    # control run the control's where it has one
    checks: dict = field(default_factory=dict)
    memory_peak_bytes: int = 0
    power_limit_w: str = ""
    # the program's own readings, and the control's (a control run only)
    program: dict = field(default_factory=dict)
    control: dict = field(default_factory=dict)
    # a driver's own readings for its layer readers
    extra: dict = field(default_factory=dict)


@dataclass
class Context:
    cell: Cell
    seed: int
    seconds: float
    trace: bool
    t_start: float
    device: str = "cuda"
    control: bool = False
    run: RunData = field(default_factory=RunData)

    def record(self, readings: dict, control: dict) -> None:
        """Record the numbers compared with the reference against their
        limits: the program's readings, or in a control run the control's in
        their place (the program's where the control has no reading of its
        own), so that the result line says whether the control passes."""
        self.run.program, self.run.control = dict(readings), dict(control)
        for name, value in readings.items():
            chosen = control.get(name, value) if self.control else value
            self.run.checks[name] = (float(chosen), float(self.cell.limits[name]))


class Phases:
    """Host seconds of the set-up's phases, each ending in a synchronize,
    reported on standard error."""

    def __init__(self, device):
        self.device, self.seconds = device, {}

    @contextlib.contextmanager
    def __call__(self, name: str):
        t0 = time.perf_counter()
        yield
        sync(self.device)
        self.seconds[name] = time.perf_counter() - t0

    def report(self, t_start: float) -> None:
        parts = " ".join(f"{k} {v:.2f}" for k, v in self.seconds.items())
        print(f"perfbench set-up: {time.perf_counter() - t_start:.2f} s ({parts})", file=sys.stderr, flush=True)


class StepClock:
    """Per-step CUDA events of the window (recorded after each step is
    enqueued, so each completes when its step's work has), and the deadline
    that ends the window."""

    def __init__(self, device, seconds: float):
        self.cuda = torch.device(device).type == "cuda"
        self.deadline = time.perf_counter() + seconds
        self.events, self.ends_unit = [], []

    def step(self, unit_done: bool) -> bool:
        """Mark a completed step; True once the deadline has passed."""
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.events.append(ev)
            self.ends_unit.append(unit_done)
        return time.perf_counter() >= self.deadline

    def fill(self, run: RunData) -> None:
        ev = self.events
        run.step_ms = [a.elapsed_time(b) for a, b in zip(ev, ev[1:])]
        run.boundary_after = self.ends_unit[:-1]


class SubWindow:
    """The traced sub-window: torch.profiler, recording the device's
    activity alone, from the end of step `first` of the window to the end
    of step `last` (or the window's end, if that comes first), timed on the
    host's clock between two synchronizes, with the benchmark's own spans
    taken on the same clock."""

    def __init__(self, enabled: bool, first: int, last: int, device):
        self.enabled, self.first, self.last, self.device = enabled, first, last, device
        self.cuda = torch.device(device).type == "cuda"
        self.prof = self.open = None
        self.seen = self.closed_at = self.t0 = 0
        self.window_ns = (0, 0)
        self.spans = []  # (start_ns, end_ns, name)

    def _profile(self):
        from torch.profiler import ProfilerActivity, profile

        return profile(activities=[ProfilerActivity.CUDA if self.cuda else ProfilerActivity.CPU])

    def warm(self) -> None:
        """Start and stop the profiler once in set-up, so that the window
        does not pay its first start."""
        if self.enabled:
            with self._profile():
                torch.zeros(1, device=self.device).add_(1)
                sync(self.device)

    def span(self, name: str | None) -> None:
        """Close the open span and open `name` (while profiling)."""
        if self.prof is None or self.closed_at:
            return
        now = time.time_ns()
        if self.open is not None:
            self.spans.append((self.open[1], now, self.open[0]))
        self.open = None if name is None else (name, now)

    def at_step(self, step: int, next_span: str) -> None:
        """Called after step `step` (1-based count of the window's steps)
        with the name of the span that opens now."""
        self.seen = step
        if not self.enabled or self.closed_at:
            return
        if step == self.first:
            self.prof = self._profile()
            self.prof.start()
            sync(self.device)
            self.t0 = time.time_ns()
        if self.prof is not None:
            if step >= self.last:
                self.close()
            else:
                self.span(next_span)

    def close(self) -> None:
        if self.prof is None or self.closed_at:
            return
        sync(self.device)
        self.span(None)
        self.window_ns = (self.t0, time.time_ns())
        self.prof.stop()
        self.closed_at = self.seen

    def reduce(self, run: RunData) -> None:
        if not self.enabled:
            return
        if self.prof is None:
            raise RuntimeError(f"the window ended before step {self.first}, where its traced sub-window starts")
        start_ns = self.prof.profiler.kineto_results.trace_start_ns()
        run.traced = trace_mod.reduce_events(self.prof.events(), start_ns, self.window_ns, self.spans)
        run.traced_steps = self.closed_at - self.first
        self.prof = None


def power_limit() -> str:
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else ""
    except (OSError, subprocess.SubprocessError):
        return ""


def result_line(ctx: Context) -> tuple[dict, list[str]]:
    """The result object, and the lines of numbers compared (for stderr)."""
    cell, run = ctx.cell, ctx.run
    checks = {k: {"value": v, "limit": lim} for k, (v, lim) in run.checks.items()}
    failed = [k for k, c in checks.items() if not (math.isfinite(c["value"]) and c["value"] <= c["limit"])]
    metrics = {}
    if ctx.trace:
        for m in cell.per_layer:
            value = layer_reader(m["name"])(run)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": float(run.end_to_end[m["name"]]), "unit": m["unit"]}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0) if torch.cuda.is_available() else "cpu",
              "count": cell.chips, "memory_peak_bytes": int(run.memory_peak_bytes)}
    out = {"correct": bool(checks) and not failed, "attempted": len(checks), "failed": len(failed),
           "metrics": metrics, "device": device}
    if ctx.trace and run.traced is not None:
        tw = run.traced
        device["busy_s"], device["window_s"] = tw.busy_s, tw.window_s
        out["breakdown"] = {"device_ops": [[c, s] for c, s in list(tw.class_s.items())[:10]],
                            "idle_gaps": [[n, s] for n, s in tw.idle_gaps[:10]]}
    out["power_limit"] = run.power_limit_w
    out["checks"] = checks
    lines = [f"check {k}: {c['value']!r} limit {c['limit']!r}" for k, c in checks.items()]
    return out, lines


@contextlib.contextmanager
def window_memory(device, run: RunData, metric: str = "peak_mem_gib"):
    """Peak memory of the set-up, then of the window alone (reset at its
    start), reported as the end-to-end metric `metric`; and what the caching
    allocator did in the window (on standard error)."""
    cuda = torch.device(device).type == "cuda"
    setup_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    before = torch.cuda.memory_stats(device) if cuda else {}
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    yield
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    run.end_to_end[metric] = peak / GIB
    run.memory_peak_bytes = max(setup_peak, peak)
    if cuda:
        after = torch.cuda.memory_stats(device)
        counts = {k: after.get(k, 0) - before.get(k, 0) for k in ALLOCATOR_COUNTS}
        run.extra["allocator"] = {**counts, "reserved_peak_gib": after.get("reserved_bytes.all.peak", 0) / GIB}
        print(f"perfbench allocator in the window: {run.extra['allocator']}", file=sys.stderr, flush=True)


def report_traced_steps(run: RunData) -> None:
    """The traced sub-window's wall time a step beside the rest of the
    window's (standard error): what tracing costs the steps it traces."""
    tw = run.traced
    rest = run.steps - run.traced_steps
    if tw is None or not run.traced_steps or rest <= 0:
        return
    print(f"perfbench traced steps: {run.traced_steps} at {tw.window_s / run.traced_steps!r} s a step; "
          f"the window's other {rest} at {(run.window_s - tw.window_s) / rest!r} s", file=sys.stderr, flush=True)
