"""conv2d_mxu_tiled_kernel_roofline (%): the standalone Conv2 launches
(``ip2_mxu``) of the profiled slice, the sum of each launch's bound over
the sum of its device time."""
from perfbench.harness.spans import roofline


def read(run):
    return roofline(run, "conv2d_mxu_tiled_kernel", "conv", ("ip2_mxu",))
