"""conv2d_vpu_tiled_kernel_roofline (%): the standalone Conv1 launches
(``ip1_vpu``) of the profiled slice, the sum of each launch's bound over
the sum of its device time."""
from perfbench.harness.spans import roofline


def read(run):
    return roofline(run, "conv2d_vpu_tiled_kernel", "conv", ("ip1_vpu",))
