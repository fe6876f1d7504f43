"""matmul IP family — the paper's conv IPs generalized to the LM hot path."""
