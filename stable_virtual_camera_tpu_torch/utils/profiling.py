"""Tracing and profiling hooks on torch.profiler.

Counterpart of stable_virtual_camera_tpu/utils/profiling.py:
  * `trace(logdir)`: torch.profiler over a block, CPU and CUDA activity,
    written as a Chrome trace under `logdir` (TensorBoard's layout, also
    read by Perfetto and by utils/trace_analysis.py);
  * `annotate(name)`: a named range in that trace
    (`torch.profiler.record_function`);
  * `StageTimer`: host wall-clock per stage with a printable report, the
    JAX package's interface and format. Its times include device work only
    where the caller synchronizes the device before a stage ends, as
    `SceneEngine.run_one_scene(timer=...)` does.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block; yields the `torch.profiler.profile`, whose
    `key_averages()` cover the same window as the trace written on exit."""
    import torch
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(logdir, use_gzip=True)) as prof:
        yield prof


def annotate(name: str):
    import torch

    return torch.profiler.record_function(name)


class StageTimer:
    def __init__(self):
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] += dt
            self.counts[name] += 1

    def report(self) -> str:
        lines = ["stage                          total_s   calls   mean_ms"]
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            t, c = self.totals[name], self.counts[name]
            lines.append(f"{name:<30} {t:8.3f} {c:7d} {1e3 * t / c:9.2f}")
        return "\n".join(lines)
