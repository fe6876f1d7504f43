"""pool2d IP family — windowed pooling (the paper's future work)."""
