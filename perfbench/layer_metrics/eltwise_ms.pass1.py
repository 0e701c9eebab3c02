"""eltwise_ms.pass1 (ops: plain PyTorch norms, GEGLU, copies; moves
pass1_step_s): device ms a step of the "elementwise and copies" class in the
traced sub-window."""

from perfbench.layer_metrics.common import eltwise_ms


def read(run):
    return eltwise_ms(run)
