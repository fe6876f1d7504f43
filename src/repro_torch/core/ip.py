"""KernelIP — one entry of the adaptive IP library.

The paper ships four VHDL IPs, each a (behaviour, resource-contract)
pair.  Here an IP is a callable plus a ``footprint(shape)`` function that
prices it against the resource vector, plus the static capability bits
from paper Table I (operand-width ceiling, outputs per pass, whether it
needs the matrix unit).

``SiteSpec`` / ``SiteRequest`` are the planner-facing half of the
contract: a family registers a *site adapter* (``IPFamily.site_adapter``,
populated in ``core/library.py``) that translates a declarative op site
— family, shapes, dtype, knobs — into the candidate set and footprint
arguments the generic selection engine (``core/plan.py``) prices.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.resources import Footprint, ResourceBudget

# Canonical dtype names (numpy's spelling, which the reference's plan
# JSON uses) and their widths in bytes.
_ITEMSIZE = {"bool": 1, "int8": 1, "uint8": 1, "int16": 2, "int32": 4,
             "int64": 8, "float16": 2, "bfloat16": 2, "float32": 4,
             "float64": 8}
_INTEGER = ("int8", "uint8", "int16", "int32", "int64")


def dtype_name(dtype) -> str:
    """Canonical name of a torch dtype, numpy dtype, Python type or
    string, spelled as ``jnp.dtype(...).name`` spells it in the
    reference: ``torch.float32``, ``np.float32`` and ``"float32"`` all
    give ``"float32"`` (and Python's ``float`` gives ``"float64"``)."""
    if isinstance(dtype, torch.dtype):
        name = str(dtype).replace("torch.", "")
    elif isinstance(dtype, str) and dtype in _ITEMSIZE:
        name = dtype
    else:
        name = np.dtype(dtype).name
    if name not in _ITEMSIZE:
        raise TypeError(f"unsupported dtype {dtype!r}; have "
                        f"{sorted(_ITEMSIZE)}")
    return name


def dtype_itemsize(dtype) -> int:
    return _ITEMSIZE[dtype_name(dtype)]


def is_integer_dtype(dtype) -> bool:
    return dtype_name(dtype) in _INTEGER


# Widths a precision ladder may assign, and the fixed-point dtype a
# lowered site is priced at.  A native-width rung is never "lowered", so
# 32 is deliberately NOT a legal ladder entry.
LADDER_WIDTHS = (16, 8)
WIDTH_DTYPES = {8: "int8", 16: "int16"}


def _freeze(value):
    """Normalize knob/shape values to hashable, JSON-stable forms."""
    if isinstance(value, (list, tuple)):
        return tuple(_freeze(v) for v in value)
    return value


@dataclasses.dataclass(frozen=True)
class SiteSpec:
    """One op site of a network graph, declaratively.

    Hashable (it is the planner's cache-key unit) and JSON-serializable.
    ``shapes`` holds the operand shapes the family adapter expects (e.g.
    ``(x_shape, w_shape)`` for conv2d); ``knobs`` are the op-level
    switches (``dual``, ``mode``, ``kind``, ``window``...) as a sorted
    tuple of pairs so equal specs hash equally.  ``ladder`` is the
    site's precision ladder: the operand widths the planner may
    quantize this site down to when it cannot fit at native width.
    """

    name: str
    family: str
    shapes: Tuple[Tuple[int, ...], ...]
    dtype: str = "float32"
    knobs: Tuple[Tuple[str, Any], ...] = ()
    ladder: Tuple[int, ...] = ()

    @classmethod
    def make(cls, name: str, family: str, shapes, dtype="float32",
             ladder=(), **knobs) -> "SiteSpec":
        norm_shapes = tuple(tuple(int(d) for d in s) for s in shapes)
        norm_knobs = tuple(sorted((k, _freeze(v)) for k, v in knobs.items()))
        norm_ladder = tuple(sorted({int(b) for b in ladder}, reverse=True))
        for b in norm_ladder:
            if b not in LADDER_WIDTHS:
                raise ValueError(f"unsupported ladder width {b}; "
                                 f"have {sorted(LADDER_WIDTHS)}")
        return cls(name=name, family=family, shapes=norm_shapes,
                   dtype=dtype_name(dtype), knobs=norm_knobs,
                   ladder=norm_ladder)

    def knob(self, key: str, default=None):
        for k, v in self.knobs:
            if k == key:
                return v
        return default

    @property
    def native_bits(self) -> int:
        """Physical width of the caller's operands at this site."""
        return dtype_itemsize(self.dtype) * 8

    def widths(self) -> Tuple[int, ...]:
        """Widths the planner may try, native first then the ladder's
        strictly-narrower rungs in descending order."""
        native = self.native_bits
        return (native,) + tuple(b for b in self.ladder if b < native)

    def at_precision(self, bits: int) -> "SiteSpec":
        """This site lowered to ``bits``-wide fixed-point operands;
        native width returns self."""
        if bits >= self.native_bits:
            return self
        return dataclasses.replace(self, dtype=WIDTH_DTYPES[bits])

    def to_dict(self) -> dict:
        return {"name": self.name, "family": self.family,
                "shapes": [list(s) for s in self.shapes],
                "dtype": self.dtype,
                "knobs": {k: list(v) if isinstance(v, tuple) else v
                          for k, v in self.knobs},
                "ladder": list(self.ladder)}

    @classmethod
    def from_dict(cls, d: dict) -> "SiteSpec":
        return cls.make(d["name"], d["family"], d["shapes"], d["dtype"],
                        ladder=d.get("ladder", ()), **d.get("knobs", {}))


@dataclasses.dataclass(frozen=True)
class SiteRequest:
    """What a family's site adapter hands the selection engine: the
    candidate members to price, the arguments their footprint functions
    take for this site, and the physical operand width of the caller's
    data (0 when the member re-encodes on ingest)."""

    candidates: Tuple["KernelIP", ...]
    fp_args: Tuple
    fp_kwargs: Tuple[Tuple[str, Any], ...] = ()
    op_bits: int = 32


@dataclasses.dataclass(frozen=True)
class KernelIP:
    name: str                 # e.g. "conv2d.ip3_packed"
    family: str               # "conv2d" | "pool2d" | "activation" | ...
    impl: Callable[..., Any]  # the op wrapper (kernel on CUDA tensors)
    footprint_fn: Callable[..., Footprint]
    description: str = ""
    # Static capability bits (paper Table I columns):
    uses_mxu: bool = True
    max_operand_bits: int = 32
    outputs_per_pass: int = 1
    supports_dtypes: Tuple[str, ...] = ("int8", "bfloat16", "float32")
    tags: Tuple[str, ...] = ()

    def footprint(self, *shape_args, **shape_kwargs) -> Footprint:
        fp = self.footprint_fn(*shape_args, **shape_kwargs)
        # The static ceiling is authoritative; a footprint_fn may tighten
        # it per-shape but never widen it.
        return dataclasses.replace(
            fp, max_operand_bits=min(fp.max_operand_bits, self.max_operand_bits),
            outputs_per_pass=self.outputs_per_pass)

    def feasible(self, budget: ResourceBudget, *shape_args, **shape_kwargs) -> bool:
        return self.footprint(*shape_args, **shape_kwargs).fits(budget)

    def __call__(self, *args, **kwargs):
        return self.impl(*args, **kwargs)


@dataclasses.dataclass
class IPFamily:
    """All IPs implementing one op contract (same ``ref.py`` oracle).

    ``site_adapter`` makes the family plannable; ``quantizable`` gates
    the precision ladder; a fused family declares the chain it absorbs
    in ``fuses`` and registers ``fuse_sites`` mapping that many adjacent
    SiteSpecs to one fused SiteSpec (or None when not fusable).
    """

    name: str
    members: Dict[str, KernelIP] = dataclasses.field(default_factory=dict)
    reference: Optional[Callable[..., Any]] = None
    site_adapter: Optional[Callable[[SiteSpec], SiteRequest]] = None
    quantizable: bool = True
    fuses: Tuple[str, ...] = ()
    fuse_sites: Optional[Callable[[Tuple[SiteSpec, ...]],
                                  Optional[SiteSpec]]] = None

    def plan_site(self, spec: SiteSpec) -> SiteRequest:
        if spec.family != self.name:
            raise ValueError(f"site {spec.name!r} is a {spec.family!r} site, "
                             f"not {self.name!r}")
        if self.site_adapter is None:
            raise NotImplementedError(
                f"family {self.name!r} has no site adapter registered; "
                "it cannot be planned (see docs/adaptive_ips.md)")
        return self.site_adapter(spec)

    def register(self, ip: KernelIP) -> KernelIP:
        if ip.name in self.members:
            raise ValueError(f"duplicate IP {ip.name!r} in family {self.name!r}")
        self.members[ip.name] = ip
        return ip

    def __iter__(self):
        return iter(self.members.values())

    def __getitem__(self, name: str) -> KernelIP:
        if name in self.members:
            return self.members[name]
        # allow short names: "ip3_packed" for "conv2d.ip3_packed"
        qual = f"{self.name}.{name}"
        if qual in self.members:
            return self.members[qual]
        raise KeyError(f"no IP {name!r} in family {self.name!r}; "
                       f"have {sorted(self.members)}")

    def names(self) -> Sequence[str]:
        return sorted(self.members)
