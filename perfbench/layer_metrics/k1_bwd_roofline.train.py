"""k1_bwd_roofline.train (kernels: K1-dKV and K1-dQ; moves train_step_s): the
backward pair's bound at the training sites a step (perfbench/counts; D =
rowsum(o dO) left out) times the traced steps, over the two classes' device
time, in %."""

from perfbench.layer_metrics.common import roofline
from perfbench.trace import K1_DKV, K1_DQ


def read(run):
    return roofline(run, run.extra.get("k1_bwd_bound_s", 0.0), (K1_DKV, K1_DQ))
