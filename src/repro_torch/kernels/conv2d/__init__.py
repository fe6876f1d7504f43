"""conv2d IP family — the paper's four convolution IPs."""
