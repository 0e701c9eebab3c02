"""device_idle.render (device; moves render_step_s): the share of the traced
sub-window in which no kernel, copy or set ran on the card (the union of the
device's intervals), in %."""

from perfbench.layer_metrics.common import device_idle


def read(run):
    return device_idle(run)
