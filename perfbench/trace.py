"""The traced sub-window of a run, reduced from torch.profiler's events.

The profiler records the device's activity alone: recording every host
operation as well would stretch the host-bound steps it measures. The
kernel class table is a copy of the port's
`utils/trace_analysis.KERNEL_CLASSES` (the port's kernels by their entry
points, then the library kernels), kept here so that a change to the
program cannot change the yardstick. The device's work is every event that
ran on the device: kernels, copies and sets (torch.profiler gives them
`DeviceType.CUDA`; the device-side copies of record_function ranges, which
the profiler also gives that type, are left out). The window is taken on
the host's clock between two synchronizes, so the device work inside it is
exactly the work of the steps it covers; device events are clipped to it.
The benchmark's spans around its calls into the program (`step`,
`chunk_boundary`, `batch_wait`), also taken on the host's clock, name the
device's idle gaps: a gap is named by the span that was open on the host
when it began. The host's times are `time.time_ns()`, the clock of the
profiler's own timestamps, which give each event's start in microseconds
after the trace's start.
"""

from __future__ import annotations

import bisect
import collections
import re
from dataclasses import dataclass, field

SPANS = ("step", "chunk_boundary", "batch_wait")

# (class, pattern searched in the kernel's name), first match wins
KERNEL_CLASSES: list[tuple[str, str]] = [
    ("int8 GEMM (cuBLASLt)", r"(?i)(gemm|xmma|nvjet|cutlass).*(s8|i8|imma)|(s8|i8|imma).*gemm"),
    ("K1 flash attention", r"flash_fwd_kernel"),
    ("K1-dKV", r"flash_bwd_dkv_kernel"),
    ("K1-dQ", r"flash_bwd_dq_kernel"),
    ("K2 temporal attention", r"time_attn_kernel"),
    ("K3 flash attention", r"flash_blhd_kernel"),
    ("K4 flash attention", r"flash_packed_kernel"),
    ("K5 layer norm", r"^void \(anonymous namespace\)::layer_norm_kernel<"),
    ("convolution (cuDNN)", r"conv|Conv|cudnn|dgrad|wgrad|fprop|implicit"),
    ("GEMM (cuBLAS)", r"gemm|Gemm|cutlass|xmma|nvjet|sm90_|sm80_"),
    ("optimizer", r"multi_tensor|adam|Adam|foreach"),
    ("reductions", r"reduce|Reduce|norm"),
    ("elementwise and copies", r"elementwise|Elementwise|vectorized|CatArray|copy|fill|index|Memcpy|Memset"),
]
_COMPILED = [(c, re.compile(rx)) for c, rx in KERNEL_CLASSES]
K1, K1_DKV, K1_DQ, K2 = "K1 flash attention", "K1-dKV", "K1-dQ", "K2 temporal attention"
ELTWISE = "elementwise and copies"


def categorize(name: str) -> str:
    return next((c for c, rx in _COMPILED if rx.search(name)), "other")


def union_length(spans: list[tuple[float, float]]) -> tuple[float, list[tuple[float, float]]]:
    """(the length of the union of the intervals, the gaps between its parts)."""
    total, end, gaps = 0.0, None, []
    for a, b in sorted(spans):
        if end is None or a > end:
            if end is not None:
                gaps.append((end, a))
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total, gaps


@dataclass
class TraceWindow:
    """The traced sub-window, in seconds."""

    window_s: float
    busy_s: float
    class_s: dict[str, float]
    launches: dict[str, int]
    idle_gaps: list[tuple[str, float]] = field(default_factory=list)

    @property
    def idle_share(self) -> float:
        return 1.0 - self.busy_s / self.window_s


def reduce_events(events, trace_start_ns: int, window: tuple[int, int], spans: list) -> TraceWindow:
    """Reduce torch.profiler FunctionEvents (`prof.events()`, times in us
    after `trace_start_ns`): device work is `device_type == CUDA`. `window`
    (start, end) and `spans` [(start, end, name)] are host times in ns on
    the profiler's clock."""
    from torch.autograd import DeviceType

    w0, w1 = ((t - trace_start_ns) / 1e3 for t in window)
    spans = sorted(((a - trace_start_ns) / 1e3, (b - trace_start_ns) / 1e3, name) for a, b, name in spans)
    device = []
    for e in events:
        # the device side of a record_function range is an annotation, not work
        if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False):
            a, b = max(e.time_range.start, w0), min(e.time_range.end, w1)
            if b > a:
                device.append((e.name, a, b))
    if not device:
        raise RuntimeError("the profiler saw no device work in the traced window")
    class_us: collections.Counter = collections.Counter()
    launches: collections.Counter = collections.Counter()
    for name, a, b in device:
        cls = categorize(name)
        class_us[cls] += b - a
        launches[cls] += 1
    busy_us, gaps = union_length([(a, b) for _, a, b in device])
    # a gap before the first or after the last device event counts too
    first, last = min(a for _, a, _ in device), max(b for _, _, b in device)
    gaps = [(w0, first)] * (first > w0) + gaps + [(last, w1)] * (w1 > last)
    starts = [s[0] for s in spans]

    def open_span(t):
        i = bisect.bisect_right(starts, t) - 1
        while i >= 0:
            s0, s1, name = spans[i]
            if s0 <= t <= s1:
                return name
            i -= 1
        return "outside spans"

    named = sorted(((open_span(a), (b - a) / 1e6) for a, b in gaps), key=lambda g: -g[1])
    return TraceWindow(window_s=(w1 - w0) / 1e6, busy_s=busy_us / 1e6,
                       class_s={c: us / 1e6 for c, us in class_us.most_common()},
                       launches=dict(launches), idle_gaps=named)
