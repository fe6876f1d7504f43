"""Kernel families.  Each family mirrors ``repro.kernels.<family>``:
``ref.py`` (the oracle), one module per member (its CUDA launch, its
plain PyTorch version and its footprint) and ``ops.py`` (the ``ip=`` /
``budget=`` wrapper).  The CUDA sources live in ``csrc/`` and are built
by ``cuda.py`` at first use."""
