"""k1_roofline.pass1 (kernels: K1, svc::flash_attention; moves pass1_step_s):
the bound of the UNet's K1 sites a step (perfbench/counts: the larger of
their FLOPs at 989 TFLOP/s and q, k, v read and o written once at 3.35 TB/s)
times the traced steps, over K1's device time, in %."""

from perfbench.layer_metrics.common import roofline
from perfbench.trace import K1


def read(run):
    return roofline(run, run.step_k1_bound_s, (K1,))
