"""mfu.render (models, the whole step; moves render_step_s): the UNet's FLOPs a
step (perfbench/counts: one CFG-doubled forward) times the traced steps,
over the traced sub-window's length and the bf16 peak (989 TFLOP/s), in %;
the chunk boundary's work counts in the time, not in the FLOPs."""

from perfbench.layer_metrics.common import mfu


def read(run):
    return mfu(run)
