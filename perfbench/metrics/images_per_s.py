"""images_per_s (images/s): images answered within the window over the
window's length, each round done at its CUDA event; the round that
straddles the window's end counts with the share of it that falls
inside."""


def read(run):
    return run.images_done_in_window() / run.seconds
