"""fused_cnn_tiled_kernel_roofline (%): the fused conv->pool->act
launches of the profiled slice, the sum of each launch's bound over the
sum of its device time."""
from perfbench.harness.spans import roofline


def read(run):
    return roofline(run, "fused_cnn_tiled_kernel", "fused")
