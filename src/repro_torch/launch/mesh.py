"""Mesh builders (``repro/launch/mesh.py``).

A ``Mesh`` is a numpy object array of ``torch.device``s with one name
an axis, as ``jax.sharding.Mesh`` holds its devices: ``.devices`` is
the array and ``.shape`` the ordered axis sizes.  One Python process
owns every device of a mesh (the single controller of
``distributed/collectives.py``).  The device pool defaults to every
CUDA card; a ``devices=`` list may name a card more than once, which
gives that many logical devices on it.  Too few devices raise the
reference's ``ValueError``: a CUDA mesh is never filled with CPU
devices and no card stands in for a missing one.

Functions, not module constants: importing this module touches no
device and imports no toolchain.
"""
from __future__ import annotations

import collections
from typing import Optional, Sequence

import numpy as np
import torch


class Mesh:
    """``devices``: an array (any nesting of lists) of devices, one
    axis of it per name in ``axis_names``."""

    def __init__(self, devices, axis_names: Sequence[str]):
        arr = np.asarray(devices, dtype=object)
        flat = np.empty(arr.size, dtype=object)
        flat[:] = [torch.device(d) for d in arr.reshape(-1)]
        self.devices = flat.reshape(arr.shape)
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"mesh of shape {self.devices.shape} needs one "
                             f"name an axis, got {self.axis_names}")

    @property
    def shape(self) -> "collections.OrderedDict[str, int]":
        return collections.OrderedDict(zip(self.axis_names,
                                           self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def __repr__(self) -> str:
        axes = ", ".join(f"{a}={n}" for a, n in self.shape.items())
        return f"Mesh({axes}; {sorted(set(map(str, self.devices.flat)))})"


def _pool(devices: Optional[Sequence]) -> list:
    if devices is None:
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [torch.device(d) for d in devices]


def _grid(shape, axes, devices) -> Mesh:
    pool = _pool(devices)
    need = int(np.prod(shape))
    if len(pool) < need:
        raise ValueError(
            f"Number of devices {len(pool)} must be >= the product of "
            f"mesh_shape {tuple(shape)} (pass devices= to run several "
            f"logical devices on one card)")
    grid = np.empty(need, dtype=object)
    grid[:] = pool[:need]
    return Mesh(grid.reshape(shape), axes)


def make_production_mesh(*, multi_pod: bool = False, devices=None) -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _grid(shape, axes, devices)


def make_host_mesh(data: int = 1, model: int = 1, devices=None) -> Mesh:
    """Small mesh over whatever devices exist (tests / examples)."""
    n = len(_pool(devices))
    if n == 0:
        raise ValueError("no device for a mesh: no CUDA card is visible "
                         "(pass devices=, e.g. ['cpu'])")
    data = min(data, n)
    model = min(model, max(n // data, 1))
    return _grid((data, model), ("data", "model"), devices)


def mesh_axis_sizes(mesh) -> dict:
    return dict(zip(mesh.axis_names, mesh.devices.shape))


def dp_axes(mesh):
    """Data-parallel axes: ('pod','data') on multi-pod, ('data',) else."""
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)
