"""chunk_gap_s.pass1 (engine; moves pass1_step_s): the device time from a
chunk's (or request's) last step to the next one's first step, less the
window's mean step, averaged over the window's boundaries; from the CUDA
events the benchmark records after each step."""

from perfbench.layer_metrics.common import chunk_gap_s


def read(run):
    return chunk_gap_s(run)
