"""k2_roofline.pass1 (kernels: K2, svc::time_attention; moves pass1_step_s):
the bound of the UNet's temporal sites a step (perfbench/counts: fp32 FLOPs
at 67 TFLOP/s, or the bf16 bytes of q, k, v and o at 3.35 TB/s) times the
traced steps, over K2's device time, in %."""

from perfbench.layer_metrics.common import roofline
from perfbench.trace import K2


def read(run):
    return roofline(run, run.step_k2_bound_s, (K2,))
