"""Spans, counters and traces of the port's layers.

Counterpart of stable_virtual_camera_tpu/utils/profiling.py, plus the
spans the port's layers open at their boundaries:

  * `span(name)`: a context manager around one stage of a layer. While a
    recording is open it records a `Span`: the name, start and end on
    `time.time_ns()` (the clock of torch.profiler's own timestamps), the
    thread, its parent (the innermost span open on the same thread, or for
    work handed to a worker with `carry`, the span that handed it over) and
    the request it belongs to (one render, one training step). Inside
    `trace(logdir)` it also opens a `torch.profiler.record_function` range,
    so the Chrome trace shows it;
  * `count(name, n=1)`: a counter, recorded where the work happens;
  * `recording(*sinks)`: opens a `Recording` that keeps every span and
    count made anywhere in the process until it is closed, in memory
    (appended under the GIL, no lock on the hot path), then hands itself
    to each sink (a callable), however the block ends;
  * `request()`, `in_request(gen, rid)`, `carry(fn)`: which request and
    parent the spans that follow belong to, on this thread, in a generator,
    on a worker thread;
  * `summary(spans)`: each name's calls, total and self seconds;
  * `trace(logdir)`: torch.profiler over a block, CPU and CUDA activity,
    written as a Chrome trace under `logdir` (TensorBoard's layout, also
    read by Perfetto and by utils/trace_analysis.py);
  * `StageTimer`: host seconds per stage with a printable report, the JAX
    package's interface and format; `add(spans)` takes a recording's spans
    (`SceneEngine.run_one_scene(timer=...)` records the render and hands
    it the engine's stages when it ends). No stage synchronizes the
    device, so a stage's time is the host's: its device work shows in the
    stage that waits for it.

With no recording and no trace open, `span` returns one shared context that
does nothing (no clock read, no allocation) and `count` returns at once: the
path the port runs untraced. The open recordings are process-wide, because
the spans sit deep in code that no caller threads an object through; each
is an object its caller creates, reads and closes.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from collections import defaultdict
from typing import Callable, Iterable, Iterator, NamedTuple


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    thread: int
    id: int
    parent: int | None
    request: int | None


class Recording:
    """The spans and counts made while it is open. `recording(*sinks)`
    opens one; `close()` (or the end of its `with` block) stops it and
    calls each sink with it."""

    def __init__(self, sinks: tuple = ()):
        self.spans: list[Span] = []
        self._counts: list[tuple[str, int]] = []
        self._sinks = sinks
        self._open = True
        _install(self)

    def __enter__(self) -> "Recording":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def close(self) -> None:
        if not self._open:
            return
        self._open = False
        _uninstall(self)
        for sink in self._sinks:
            sink(self)

    def counts(self) -> dict[str, int]:
        out: dict[str, int] = defaultdict(int)
        for name, n in self._counts:
            out[name] += n
        return dict(out)


# the open recordings (replaced whole under the lock, read without it), the
# depth of open `trace` blocks, and whether either is on
_recordings: tuple[Recording, ...] = ()
_ranges = 0
_on = False
_lock = threading.Lock()
_ids = itertools.count(1)
# per thread: (the innermost open span's id, its request)
_local = threading.local()
_NOOP = contextlib.nullcontext()


def _set_on() -> None:
    global _on
    _on = bool(_recordings) or _ranges > 0


def _install(rec: Recording) -> None:
    global _recordings
    with _lock:
        _recordings = _recordings + (rec,)
        _set_on()


def _uninstall(rec: Recording) -> None:
    global _recordings
    with _lock:
        _recordings = tuple(r for r in _recordings if r is not rec)
        _set_on()


def _where() -> tuple[int | None, int | None]:
    return getattr(_local, "where", (None, None))


def recording(*sinks: Callable[[Recording], object]) -> Recording:
    """Record every span and count until the recording is closed; then
    call each sink with it."""
    return Recording(sinks)


def enabled() -> bool:
    """Whether a recording is open: for a count whose value costs work."""
    return bool(_recordings)


class _Open:
    __slots__ = ("name", "id", "where", "start", "range")

    def __init__(self, name: str):
        self.name = name
        self.range = None

    def __enter__(self):
        self.where = where = _where()
        self.id = next(_ids)
        _local.where = (self.id, where[1])
        if _ranges:
            import torch

            self.range = torch.profiler.record_function(self.name)
            self.range.__enter__()
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        if self.range is not None:
            self.range.__exit__(*exc)
        _local.where = self.where
        record = Span(self.name, self.start, end, threading.get_ident(), self.id, *self.where)
        for rec in _recordings:
            rec.spans.append(record)
        return False


def span(name: str):
    """A context manager that records the block as span `name` while a
    recording or a trace is open, and does nothing otherwise."""
    if not _on:
        return _NOOP
    return _Open(name)


def count(name: str, n: int = 1) -> None:
    """Add `n` to counter `name` in every open recording."""
    if _recordings:
        for rec in _recordings:
            rec._counts.append((name, n))


@contextlib.contextmanager
def _as(where, value=None):
    prev = _where()
    _local.where = where
    try:
        yield value
    finally:
        _local.where = prev


def request():
    """The block's spans on this thread belong to a new request; yields its
    id (None, and nothing is done, while no recording is open)."""
    if not _recordings:
        return _NOOP
    rid = next(_ids)
    return _as((_where()[0], rid), rid)


def in_request(gen: Iterator, rid: int | None) -> Iterator:
    """`gen` with each of its resumptions (and its close) run under request
    `rid`, wherever it is driven from: a generator's spans would otherwise
    take the request of whoever calls `next`. `gen` itself when `rid` is
    None."""
    if rid is None:
        return gen

    def resumed():
        end = object()
        try:
            while True:
                with _as((None, rid)):
                    item = next(gen, end)
                if item is end:
                    return
                yield item
        finally:
            with _as((None, rid)):
                gen.close()

    return resumed()


def carry(fn: Callable) -> Callable:
    """`fn`, to be run on another thread, with the calling thread's open
    span as the parent of the spans it opens, and its request; `fn` itself
    while nothing is recorded or traced."""
    if not _on:
        return fn
    where = _where()

    def carried(*args, **kwargs):
        with _as(where):
            return fn(*args, **kwargs)

    return carried


def summary(spans: Iterable[Span]) -> dict[str, tuple[int, float, float]]:
    """name -> (calls, total seconds, self seconds), by total: a span's self
    time is its duration less the part of it that its children (the spans
    whose parent it is, on any thread) cover."""
    spans = list(spans)
    children: dict[int, list[Span]] = defaultdict(list)
    for s in spans:
        if s.parent is not None:
            children[s.parent].append(s)
    rows: dict[str, list] = {}
    for s in spans:
        covered, end = 0, s.start_ns
        for a, b in sorted((max(c.start_ns, s.start_ns), min(c.end_ns, s.end_ns)) for c in children[s.id]):
            a = max(a, end)
            if b > a:
                covered += b - a
                end = b
        row = rows.setdefault(s.name, [0, 0, 0])
        row[0] += 1
        row[1] += s.end_ns - s.start_ns
        row[2] += s.end_ns - s.start_ns - covered
    ordered = sorted(rows.items(), key=lambda kv: -kv[1][1])
    return {name: (c, t / 1e9, own / 1e9) for name, (c, t, own) in ordered}


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block; yields the `torch.profiler.profile`, whose
    `key_averages()` cover the same window as the trace written on exit.
    Spans opened in the block are ranges in the trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    global _ranges
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(logdir, use_gzip=True)) as prof:
        with _lock:
            _ranges += 1
            _set_on()
        try:
            yield prof
        finally:
            with _lock:
                _ranges -= 1
                _set_on()


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

    def add(self, spans: Iterable[Span]) -> None:
        """Add each span's host seconds to its name's stage."""
        for s in spans:
            self.totals[s.name] += (s.end_ns - s.start_ns) / 1e9
            self.counts[s.name] += 1

    def report(self) -> str:
        lines = ["stage                          total_s   calls   mean_ms"]
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            t, c = self.totals[name], self.counts[name]
            lines.append(f"{name:<30} {t:8.3f} {c:7d} {1e3 * t / c:9.2f}")
        return "\n".join(lines)
