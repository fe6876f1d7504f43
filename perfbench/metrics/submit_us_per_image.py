"""submit_us_per_image (us): host time of the server's submit() calls
a request, on the benchmark's clock around them, outside the profiled
slice (the profiler's host cost stays out)."""


def read(run):
    w = run.window
    if not w.submitted_out_of_slice:
        return None
    return 1e6 * w.submit_s_out_of_slice / w.submitted_out_of_slice
