"""mfu.bulk (%): model FLOPs of the images answered in the profiled slice
(2 x the convs' and the projection's multiply-adds an image) over the
slice, as a share of the card's FP32 peak (67e12 on the SXM part, the
rate every member here computes at)."""


def read(run):
    if run.trace is None:
        return None
    flops = sum(run.flops_per_image(tenant) * size
                for tenant, size, _ in run.slice_plans)
    rate = flops / run.trace["window_s"]
    return 100.0 * rate / run.peaks()["fp32_flops"]
