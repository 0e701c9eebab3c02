"""mfu.train (training, the whole step; moves train_step_s): three times the
UNet forward's FLOPs a step (forward and backward; remat's recompute, the
VAE and CLIP not counted) times the traced steps, over the traced sub-
window's length and the bf16 peak (989 TFLOP/s), in %."""

from perfbench.layer_metrics.common import mfu


def read(run):
    return mfu(run)
