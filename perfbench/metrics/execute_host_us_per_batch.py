"""execute_host_us_per_batch (us): mean length of the program's
``serve.execute`` span (one a batch: planning, quantization, launches,
the light tenant's measured error), outside the profiled slice."""
from perfbench.harness.spans import durations_out_of_slice


def read(run):
    d = durations_out_of_slice(run, "serve.execute")
    return sum(d) / len(d) if d else None
