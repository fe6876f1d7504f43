"""device_idle.bulk (fraction): share of the profiled slice in which no
kernel and no copy of the process ran on the card."""
from perfbench.harness.spans import idle_share

read = idle_share
