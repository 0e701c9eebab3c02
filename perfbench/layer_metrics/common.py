"""The arithmetic that per-layer readers share; each reader file names what
it reads and calls one of these. A reader returns None where its run has
nothing to read."""

from perfbench.counts.peaks import BF16_FLOPS
from perfbench.trace import ELTWISE


def chunk_gap_s(run):
    """Mean CUDA-event time from a unit's (chunk's or request's) last step
    to the next one's first, less the mean step inside units, in seconds."""
    inside = [ms for ms, b in zip(run.step_ms, run.boundary_after) if not b]
    across = [ms for ms, b in zip(run.step_ms, run.boundary_after) if b]
    if not inside or not across:
        return None
    return (sum(across) / len(across) - sum(inside) / len(inside)) / 1e3


def mfu(run):
    """The step's FLOPs times the traced steps, over the traced time and the
    bf16 peak, in %."""
    if run.traced is None or not run.traced_steps:
        return None
    return 100.0 * run.step_flops * run.traced_steps / run.traced.window_s / BF16_FLOPS


def eltwise_ms(run):
    """Device ms a step of the "elementwise and copies" class."""
    if run.traced is None or not run.traced_steps or ELTWISE not in run.traced.class_s:
        return None
    return 1e3 * run.traced.class_s[ELTWISE] / run.traced_steps


def roofline(run, bound_s: float, classes: tuple):
    """A step's bound times the traced steps over the classes' device time, in %."""
    if run.traced is None:
        return None
    busy = sum(run.traced.class_s.get(c, 0.0) for c in classes)
    return 100.0 * bound_s * run.traced_steps / busy if busy else None


def device_idle(run):
    """The share of the traced sub-window with nothing on the device, in %."""
    return None if run.traced is None else 100.0 * run.traced.idle_share
