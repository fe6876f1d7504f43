"""Resource model — the resource vector the selector adapts to.

The paper adapts convolution IPs to the FPGA resource vector (DSP
slices, LUT/CLB fabric, BRAM).  The planner reads an abstract vector of
the same shape: matrix-unit passes, vector ops, on-chip bytes ("VMEM"),
device-memory bytes and link bandwidth.  ``ResourceBudget`` is the
machine-readable "available resources" a deployment hands to the
selector; ``Footprint`` is what one kernel IP costs against that budget
for a concrete shape.

The module constants below are the reference planner's cost units, not
a measurement of any device.  They are kept numerically equal to the
reference's so that the port's plans (members, fractions, est-cycles and
the ``budget`` block of ``NetworkPlan.to_json()``) are byte-equal to the
reference's.  Fits measured on the H100 replace them with the
measurement loop (ROADMAP queue 1, item 7).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

# ---------------------------------------------------------------------------
# The reference planner's cost units (per device), the ones the planner
# reads.  Not a measurement of any device: every est-cycles number the
# planner prints is in these units, and the ROADMAP's measurement loop
# replaces them with fits.
# ---------------------------------------------------------------------------
HBM_BYTES = 16 * 1024**3          # device-memory capacity unit
HBM_BW = 819e9                    # device-memory bytes/s
VMEM_BYTES = 128 * 1024 * 1024    # on-chip working-set capacity unit
ICI_BW_PER_LINK = 50e9            # bytes/s per inter-device link
VPU_LANES = 8 * 128               # vector lanes
VPU_OPS_PER_CYCLE = 4 * VPU_LANES # vector ops per cycle
CLOCK_HZ = 940e6                  # the cycle unit of est_cycles
MXU_DIM = 128                     # matrix-unit tile edge
LANE = 128                        # last-dim tile (the autotuner's grid)
SUBLANE = 8                       # second-to-last-dim tile
# Collective pricing unit: bytes one link moves per cycle.
ICI_BYTES_PER_CYCLE = ICI_BW_PER_LINK / CLOCK_HZ


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """A device mesh the planner may spread one plan across.

    ``devices`` identical devices joined by links of finite bandwidth:
    how many, the mesh-axis name execution shards over, and the link
    rate collective traffic is priced at (``ici_bytes_per_cycle``, the
    reference's cost unit; on the card the links are NVLink, or, for
    logical devices sharing one card, its own memory).  Hashable — it
    participates in plan cache keys, so its fields stay the
    reference's.
    """

    devices: int = 1
    axis: str = "shard"
    ici_bytes_per_cycle: float = ICI_BYTES_PER_CYCLE

    def __post_init__(self):
        if self.devices < 1:
            raise ValueError(f"mesh needs >= 1 device, got {self.devices}")
        if self.ici_bytes_per_cycle <= 0.0:
            raise ValueError("ici_bytes_per_cycle must be positive")

    def ici_cycles(self, n_bytes: float) -> float:
        """Cycles to move ``n_bytes`` across one link."""
        return n_bytes / self.ici_bytes_per_cycle

    def all_gather_cycles(self, n_bytes: float) -> float:
        """Ring all-gather of a tensor of GLOBAL size ``n_bytes``: each
        device receives the (devices-1)/devices of it that it does not
        already hold."""
        d = self.devices
        if d <= 1:
            return 0.0
        return self.ici_cycles(n_bytes * (d - 1) / d)

    def all_reduce_cycles(self, n_bytes: float) -> float:
        """Ring all-reduce (reduce-scatter + all-gather) of a tensor of
        size ``n_bytes``: 2 * (d-1)/d of it crosses each link — the cost
        a channel-split conv pays to sum its partial outputs."""
        d = self.devices
        if d <= 1:
            return 0.0
        return self.ici_cycles(2.0 * n_bytes * (d - 1) / d)

    def halo_cycles(self, n_bytes: float) -> float:
        """Neighbor exchange of ``n_bytes`` of boundary rows — what a
        spatial conv split pays per step (both edges move in parallel
        over distinct links, so one halo's bytes price the exchange)."""
        if self.devices <= 1:
            return 0.0
        return self.ici_cycles(n_bytes)


@dataclasses.dataclass(frozen=True)
class ResourceBudget:
    """Available resources a kernel IP may consume — the paper's
    "available FPGA resources".

    ``mxu_available`` mirrors "DSP availability": False steers the
    selector to the logic-only members (on the card: members that issue
    no tensor-core instruction).  ``precision_bits`` mirrors the paper's
    operand-width limits (Conv3 is only legal up to 8-bit operands).
    ``vmem_bytes`` is the on-chip working-set unit of the reference
    planner; it has no Hopper meaning until the kernels tile spatially
    (ROADMAP queue 2).
    """

    vmem_bytes: int = VMEM_BYTES
    hbm_bytes: int = HBM_BYTES
    mxu_available: bool = True
    mxu_passes_budget: Optional[int] = None   # None = unlimited
    vpu_ops_budget: Optional[int] = None      # None = unlimited
    precision_bits: int = 16                  # max operand width required
    prefer_parallel_streams: bool = False     # paper: "demand high parallelism"

    def scaled(self, fraction: float) -> "ResourceBudget":
        """A fractional slice of this budget: every quantitative column
        scales, the qualitative knobs pass through unchanged."""
        def _slice(v):
            return None if v is None else int(v * fraction)

        return dataclasses.replace(
            self,
            vmem_bytes=int(self.vmem_bytes * fraction),
            hbm_bytes=int(self.hbm_bytes * fraction),
            mxu_passes_budget=_slice(self.mxu_passes_budget),
            vpu_ops_budget=_slice(self.vpu_ops_budget),
        )


@dataclasses.dataclass(frozen=True)
class Footprint:
    """What one IP costs for one concrete call — paper Table II,
    machine-readable.

    FPGA column mapping: DSPs -> mxu_passes, LUTs/CLBs -> vpu_ops,
    BRAM -> vmem_bytes, DDR traffic -> hbm_bytes, WNS -> est_cycles,
    convs/cycle -> outputs_per_pass.
    """

    vmem_bytes: int
    hbm_bytes: int
    mxu_passes: int
    vpu_ops: int
    est_cycles: float
    outputs_per_pass: int = 1       # Conv3/Conv4 produce 2 convolutions/pass
    max_operand_bits: int = 32      # Conv3 is limited to 8
    launches: int = 1               # kernel launches per invocation; a
                                    # fused conv->pool->act member is 1
                                    # where the unfused chain costs 3
    comm_cycles: float = 0.0        # collective traffic of a sharded
                                    # site (0 on one device)

    @property
    def compute_cycles(self) -> float:
        """The compute term of the additive ``cost_cycles`` split:
        ``est_cycles`` minus the DMA cycles its ``hbm_bytes`` price in
        and minus its collective ``comm_cycles`` (clamped at zero).
        These are the analytical axes the measurement-calibrated cost
        model (``core/calibrate_cost.py``) regresses over."""
        return max(self.est_cycles - hbm_cycles(self.hbm_bytes)
                   - self.comm_cycles, 0.0)

    def calibrated_cycles(self, calibration, member: str) -> float:
        """This footprint's cost under a measurement-derived
        ``CalibrationTable`` (cycle units; ``member`` is the calibration
        key, ``@int<bits>`` for a lowered rung); ``calibration=None`` is
        the analytical ``est_cycles``."""
        if calibration is None:
            return self.est_cycles
        return calibration.calibrated_cycles(self, member)

    def fits(self, budget: ResourceBudget) -> bool:
        if self.vmem_bytes > budget.vmem_bytes:
            return False
        if self.hbm_bytes > budget.hbm_bytes:
            return False
        if self.mxu_passes > 0 and not budget.mxu_available:
            return False
        if (budget.mxu_passes_budget is not None
                and self.mxu_passes > budget.mxu_passes_budget):
            return False
        if (budget.vpu_ops_budget is not None
                and self.vpu_ops > budget.vpu_ops_budget):
            return False
        if budget.precision_bits > self.max_operand_bits:
            return False
        return True


def cost_cycles(compute_cycles: float, hbm_bytes: int,
                comm_cycles: float = 0.0) -> float:
    """The shared est-cycles rule every footprint prices with: compute
    plus device-memory traffic plus collectives, added serially (so the
    intermediate round-trips fusion removes show up as a counted drop)."""
    return compute_cycles + hbm_cycles(hbm_bytes) + comm_cycles


def mxu_pass_cycles(m: int, k: int, n: int) -> float:
    """Cycles for an (m,k)x(k,n) matmul streamed through MXU_DIM tiles."""
    tiles = (math.ceil(m / MXU_DIM) * math.ceil(k / MXU_DIM)
             * math.ceil(n / MXU_DIM))
    return tiles * MXU_DIM  # one column of results per cycle per tile


def vpu_op_cycles(n_ops: int) -> float:
    """Cycles for ``n_ops`` scalar-equivalent elementwise vector ops."""
    return n_ops / VPU_OPS_PER_CYCLE


def hbm_cycles(n_bytes: int) -> float:
    """Cycles to move ``n_bytes`` at the device-memory rate."""
    return n_bytes / HBM_BW * CLOCK_HZ
