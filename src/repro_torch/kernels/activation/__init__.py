"""activation IP family — exact and LUT activations."""
