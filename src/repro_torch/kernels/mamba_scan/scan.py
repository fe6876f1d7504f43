"""Selective scan — the SSM recurrence of a Mamba block with the state
kept on chip for the whole sequence.

Replaces ``repro/kernels/mamba_scan/scan.py::selective_scan``.  The
reference walks a grid (B, Di/bdi), holds one (bdi, Ds) state block in
VMEM scratch and loops over T with ``fori_loop``, so only x/dt/B/C
stream in and y streams out: device-memory traffic O(T·(Di + Ds))
where the ``lax.scan`` twin round-trips the (Di x Ds) state every step.
It is the Conv1-style logic-only end of the library: no MXU.

The kernel (``selective_scan_kernel<DS>`` in ``csrc/scan_kernels.cu``)
computes the same function: a group of Ds lanes owns one channel
(b, di), each lane one state h[b, di, s] in a register; every step
computes ``exp(dt·A)`` with ``expf`` and the h update on CUDA cores,
and y_t is a shuffle reduction over the group.  Chunks of 32 steps of
x, dt (for the CTA's channels) and of Bp, Cp (shared by every channel
of a batch row) are staged in shared memory.  ``block_di`` is the
reference's VMEM block hint (``bdi = min(block_di, Di)``): validated,
priced by ``footprint``, it does not shape the launch, so results never
depend on it.
"""
from __future__ import annotations

import torch

from repro_torch.core.resources import (Footprint, cost_cycles,
                                        vpu_op_cycles)
from repro_torch.kernels import cuda
from repro_torch.kernels.conv2d.inner import check_block
from repro_torch.kernels.mamba_scan.ref import selective_scan_ref

# d_state values the kernel is instantiated for (a group of Ds lanes
# must tile a warp)
KERNEL_DS = (4, 8, 16)


def _check(x, dt, bp, cp, a) -> None:
    if x.dim() != 3 or dt.shape != x.shape:
        raise ValueError(f"selective_scan takes x and dt (B, T, Di); got "
                         f"{tuple(x.shape)} and {tuple(dt.shape)}")
    b, t, di = x.shape
    if a.dim() != 2 or a.shape[0] != di:
        raise ValueError(f"A must be (Di, Ds) = ({di}, Ds); got "
                         f"{tuple(a.shape)}")
    want = (b, t, a.shape[1])
    for name, v in (("Bp", bp), ("Cp", cp)):
        if tuple(v.shape) != want:
            raise ValueError(f"{name} must be (B, T, Ds) = {want}; got "
                             f"{tuple(v.shape)}")


def selective_scan_plain(x: torch.Tensor, dt: torch.Tensor, bp: torch.Tensor,
                         cp: torch.Tensor, a: torch.Tensor):
    """The kernel's function in plain PyTorch (the family oracle)."""
    _check(x, dt, bp, cp, a)
    return selective_scan_ref(x, dt, bp, cp, a)


def selective_scan(x: torch.Tensor, dt: torch.Tensor, bp: torch.Tensor,
                   cp: torch.Tensor, a: torch.Tensor, *,
                   block_di: int = 256):
    """x/dt: (B,T,Di); bp/cp: (B,T,Ds); a: (Di,Ds) -> (y (B,T,Di), h
    (B,Di,Ds)), both f32; inputs are cast to f32.  CUDA tensors launch
    the kernel once; CPU tensors run ``selective_scan_plain``."""
    _check(x, dt, bp, cp, a)
    check_block("block_di", block_di)
    if not x.is_cuda:
        return selective_scan_plain(x, dt, bp, cp, a)
    b, t, di = x.shape
    ds = a.shape[1]
    if ds not in KERNEL_DS:
        raise ValueError(f"d_state {ds} has no CUDA selective-scan kernel "
                         f"(have {KERNEL_DS})")
    ops = [v.to(torch.float32).contiguous() for v in (x, dt, bp, cp, a)]
    for name, v in zip(("x", "dt", "Bp", "Cp", "A"), ops):
        cuda.require(v, name)
        if v.device != x.device:
            raise ValueError(f"x and {name} lie on {x.device} and "
                             f"{v.device}")
    y = torch.empty((b, t, di), dtype=torch.float32, device=x.device)
    h = torch.empty((b, di, ds), dtype=torch.float32, device=x.device)
    if h.numel() == 0:
        return y, h
    cuda.launch("selective_scan", "scan_selective", x.device,
                *(v.data_ptr() for v in ops), y.data_ptr(), h.data_ptr(),
                b, t, di, ds)
    return y, h


def footprint(b, t, di, ds, *, block_di: int = 256) -> Footprint:
    bdi = min(block_di, di)
    vmem = (2 * t * bdi + 2 * t * ds + bdi * ds * 2 + t * bdi) * 4
    hbm = (2 * b * t * di + 2 * b * t * ds + di * ds
           + b * t * di + b * di * ds) * 4
    vpu = b * t * di * ds * 6       # dA, dBx, h update, y reduce
    return Footprint(vmem_bytes=int(vmem), hbm_bytes=int(hbm), mxu_passes=0,
                     vpu_ops=int(vpu),
                     est_cycles=cost_cycles(vpu_op_cycles(vpu), hbm),
                     outputs_per_pass=1, max_operand_bits=32)
