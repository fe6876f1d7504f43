"""Plain references, frozen for the benchmark."""
