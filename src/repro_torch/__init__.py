"""PyTorch/CUDA port of the adaptive-IP library (``repro``) for one
NVIDIA H100.

The layout mirrors ``repro`` module for module (``core/``, ``obs/``,
``kernels/<family>/``, ``quant/``, ``models/``, ``runtime/``).  Public functions
keep ``repro``'s tensor layout — NHWC activations, HWIO weights — and
run on the tensor's device: a CUDA tensor launches the hand-written
kernel of ``kernels/csrc/``, a CPU tensor runs the plain PyTorch
version beside it.  Entry points (``AdaptiveServer``,
``init_cnn_frontend``) default to ``cuda``.

This package never imports ``jax`` or ``repro``.
"""
