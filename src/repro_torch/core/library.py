"""The adaptive IP library — paper Table I, machine-readable.

Registered: the CNN families — conv2d (the paper's literal object, all
four members), pool2d and activation (the paper's stated future work)
and cnn_fused (conv -> pool -> activation as one launch) — and their
generalizations to the LM hot path, matmul (single- and dual-stream),
attention and ssm_scan (the selective scan of a Mamba block), in the
reference's order.  Every member carries the Table I capability bits
and a footprint function pricing it against the resource vector.
ssm_scan has no site adapter, as in the reference: planning an
ssm_scan site raises ``NotImplementedError``.
"""
from __future__ import annotations

import math

from repro_torch.core.ip import (IPFamily, KernelIP, SiteRequest, SiteSpec,
                                 dtype_itemsize)
from repro_torch.kernels.activation import lut_poly as act_lut_mod
from repro_torch.kernels.activation import vpu_exact as act_exact_mod
from repro_torch.kernels.activation.ref import activation_ref
from repro_torch.kernels.attention import decode as attn_decode_mod
from repro_torch.kernels.attention import flash as attn_flash_mod
from repro_torch.kernels.attention.ref import attention_ref
from repro_torch.kernels.conv2d import ip1_vpu, ip2_mxu, ip3_packed, ip4_dual
from repro_torch.kernels.conv2d.ref import conv2d_ref
from repro_torch.kernels.fused import cnn_block as fused_mod
from repro_torch.kernels.mamba_scan import scan as mamba_scan_mod
from repro_torch.kernels.mamba_scan.ref import selective_scan_ref
from repro_torch.kernels.matmul import dual as mm_dual
from repro_torch.kernels.matmul import mxu as mm_mxu_mod
from repro_torch.kernels.matmul.ref import matmul_ref
from repro_torch.kernels.pool2d import mxu_im2col as pool_im2col_mod
from repro_torch.kernels.pool2d import vpu_window as pool_vpu_mod
from repro_torch.kernels.pool2d.ref import (check_pool_geometry,
                                            pool2d_out_shape, pool2d_ref)

# --------------------------------------------------------------------------
# conv2d family — the paper's four IPs.
# --------------------------------------------------------------------------
CONV2D = IPFamily("conv2d", reference=conv2d_ref)
CONV2D.register(KernelIP(
    name="conv2d.ip1_vpu", family="conv2d", impl=ip1_vpu.conv2d_ip1,
    footprint_fn=ip1_vpu.footprint, uses_mxu=False, max_operand_bits=32,
    outputs_per_pass=1, tags=("paper:Conv1", "logic-only"),
    description="No DSP/MXU; one convolution per pass; high vector logic."))
CONV2D.register(KernelIP(
    name="conv2d.ip2_mxu", family="conv2d", impl=ip2_mxu.conv2d_ip2,
    footprint_fn=ip2_mxu.footprint, uses_mxu=True, max_operand_bits=32,
    outputs_per_pass=1, tags=("paper:Conv2",),
    description="One MXU pass per tile; minimal vector logic."))
CONV2D.register(KernelIP(
    name="conv2d.ip3_packed", family="conv2d", impl=ip3_packed.conv2d_ip3,
    footprint_fn=ip3_packed.footprint, uses_mxu=False, max_operand_bits=8,
    outputs_per_pass=2, supports_dtypes=("int8",),
    tags=("paper:Conv3", "packed", "dual-stream"),
    description="Operand packing: two 8-bit convolutions per multiplier."))
CONV2D.register(KernelIP(
    name="conv2d.ip4_dual", family="conv2d", impl=ip4_dual.conv2d_ip4,
    footprint_fn=ip4_dual.footprint, uses_mxu=True, max_operand_bits=32,
    outputs_per_pass=2, tags=("paper:Conv4", "dual-stream"),
    description="Two parallel convolutions via dual MXU passes; full precision."))

# --------------------------------------------------------------------------
# pool2d family — same resource split as Conv1/Conv2.
# --------------------------------------------------------------------------
POOL2D = IPFamily("pool2d", reference=pool2d_ref)
POOL2D.register(KernelIP(
    name="pool2d.pool_vpu", family="pool2d", impl=pool_vpu_mod.pool2d_window,
    footprint_fn=pool_vpu_mod.footprint, uses_mxu=False,
    tags=("analogue:Conv1", "windowed-reduce"),
    description="Unrolled strided-slice window reduce; pure VPU, "
                "minimal VMEM."))
POOL2D.register(KernelIP(
    name="pool2d.pool_im2col", family="pool2d",
    impl=pool_im2col_mod.pool2d_im2col,
    footprint_fn=pool_im2col_mod.footprint, uses_mxu=True,
    tags=("analogue:Conv2", "im2col"),
    description="Patch tensor in VMEM; avg collapses to one MXU pass, "
                "max to one vectorized reduce."))

# --------------------------------------------------------------------------
# activation family — exact transcendental vs the paper's fixed-point
# spirit (256-entry LUT over the saturation range, 8-bit operand ceiling).
# --------------------------------------------------------------------------
ACTIVATION = IPFamily("activation", reference=activation_ref)
ACTIVATION.register(KernelIP(
    name="activation.act_vpu", family="activation",
    impl=act_exact_mod.activation_exact,
    footprint_fn=act_exact_mod.footprint, uses_mxu=False,
    tags=("exact",),
    description="Exact float32 transcendental on the VPU; full precision, "
                "high op count for tanh/gelu."))
ACTIVATION.register(KernelIP(
    name="activation.act_lut", family="activation",
    impl=act_lut_mod.activation_lut,
    footprint_fn=act_lut_mod.footprint, uses_mxu=False,
    max_operand_bits=8, supports_dtypes=("int8", "bfloat16", "float32"),
    tags=("fixed-point", "lut"),
    description="256-entry LUT over the saturation range; ~4 VPU ops and "
                "1-byte streaming per element; saturating kinds only."))


# --------------------------------------------------------------------------
# cnn_fused family — conv -> pool -> activation as ONE launch.
# --------------------------------------------------------------------------
def _fused_ref(x, w, *, window=(2, 2), stride=None, mode="max",
               kind="relu"):
    """Composite oracle: the three family references chained."""
    return activation_ref(
        pool2d_ref(conv2d_ref(x, w), window=window, stride=stride,
                   mode=mode), kind=kind)


CNN_FUSED = IPFamily("cnn_fused", reference=_fused_ref,
                     fuses=("conv2d", "pool2d", "activation"))
CNN_FUSED.register(KernelIP(
    name="cnn_fused.fused_vpu", family="cnn_fused",
    impl=fused_mod.fused_cnn_vpu, footprint_fn=fused_mod.footprint_vpu,
    uses_mxu=False, tags=("fused", "analogue:Conv1"),
    description="Whole CNN block in one launch: Conv1-style VPU MAC, pool "
                "reduce + activation applied to the VMEM-resident tile; "
                "writes only the pooled, activated tensor."))
CNN_FUSED.register(KernelIP(
    name="cnn_fused.fused_mxu", family="cnn_fused",
    impl=fused_mod.fused_cnn_mxu, footprint_fn=fused_mod.footprint_mxu,
    uses_mxu=True, tags=("fused", "analogue:Conv2"),
    description="Whole CNN block in one launch: im2col + one MXU pass, "
                "pool + activation in register; single HBM write."))

# --------------------------------------------------------------------------
# matmul family — the LM-hot-path generalization.
# --------------------------------------------------------------------------
MATMUL = IPFamily("matmul", reference=matmul_ref)
MATMUL.register(KernelIP(
    name="matmul.mm_vpu", family="matmul", impl=mm_mxu_mod.mm_vpu,
    footprint_fn=mm_mxu_mod.footprint_vpu, uses_mxu=False,
    tags=("analogue:Conv1",),
    description="Dot-free broadcast-multiply matmul; VPU only."))
MATMUL.register(KernelIP(
    name="matmul.mm_mxu", family="matmul", impl=mm_mxu_mod.mm_mxu,
    footprint_fn=mm_mxu_mod.footprint_mxu, uses_mxu=True,
    tags=("analogue:Conv2",),
    description="Tiled MXU matmul, f32/int32 VMEM accumulator."))
MATMUL.register(KernelIP(
    name="matmul.mm_dual_shared", family="matmul", impl=mm_dual.mm_dual_shared,
    footprint_fn=mm_dual.footprint_shared,
    uses_mxu=True, max_operand_bits=8, outputs_per_pass=2,
    supports_dtypes=("int8",), tags=("analogue:Conv3", "dual-stream"),
    description="Two int8 streams, one weight fetch, 2x int8 MXU rate."))
MATMUL.register(KernelIP(
    name="matmul.mm_dual_full", family="matmul", impl=mm_dual.mm_dual_full,
    footprint_fn=mm_dual.footprint_full,
    uses_mxu=True, outputs_per_pass=2, tags=("analogue:Conv4", "dual-stream"),
    description="Two full-precision streams sharing one weight fetch."))

# --------------------------------------------------------------------------
# attention family.
# --------------------------------------------------------------------------
# No integer kernels exist for attention — the precision ladder must
# never lower its sites (quantizable=False; see IPFamily docstring).
ATTENTION = IPFamily("attention", reference=attention_ref, quantizable=False)
ATTENTION.register(KernelIP(
    name="attention.attn_naive", family="attention", impl=attention_ref,
    footprint_fn=lambda b, hq, hkv, sq, skv, d, **kw: attn_flash_mod.footprint(
        b, hq, hkv, sq, skv, d, bq=sq, bk=skv, **kw),
    uses_mxu=True, tags=("reference",),
    description="Materialized-scores attention; VMEM O(S^2) — small S only."))
ATTENTION.register(KernelIP(
    name="attention.attn_flash", family="attention",
    impl=attn_flash_mod.flash_attention,
    footprint_fn=attn_flash_mod.footprint, uses_mxu=True,
    tags=("train", "prefill"),
    description="Tiled online-softmax; VMEM O(block), HBM O(S*D)."))
ATTENTION.register(KernelIP(
    name="attention.attn_decode", family="attention",
    impl=attn_decode_mod.flash_decode,
    footprint_fn=attn_decode_mod.footprint, uses_mxu=True,
    tags=("decode",),
    description="Single-token flash-decode over KV blocks; HBM-bound."))

# --------------------------------------------------------------------------
# ssm_scan family — the attention-free recurrence (jamba/rwkv end of the
# spectrum; Conv1-style logic-only contract: zero MXU passes).
# --------------------------------------------------------------------------
SSM_SCAN = IPFamily("ssm_scan", reference=selective_scan_ref,
                    quantizable=False)
SSM_SCAN.register(KernelIP(
    name="ssm_scan.selective_vmem", family="ssm_scan",
    impl=mamba_scan_mod.selective_scan,
    footprint_fn=mamba_scan_mod.footprint, uses_mxu=False,
    tags=("analogue:Conv1", "ssm"),
    description="Selective scan with VMEM-resident state: HBM traffic "
                "O(T·(Di+Ds)) vs the scan twin's O(T·Di·Ds)."))

FAMILIES = {f.name: f for f in (CONV2D, POOL2D, ACTIVATION, CNN_FUSED,
                                MATMUL, ATTENTION, SSM_SCAN)}


# --------------------------------------------------------------------------
# Site adapters — what makes each family *plannable*: a declarative
# SiteSpec -> the candidate members and footprint arguments the generic
# engine (core/plan.py) prices.
# --------------------------------------------------------------------------
def _bits(dtype) -> int:
    return dtype_itemsize(dtype) * 8


def _conv2d_adapter(spec: SiteSpec) -> SiteRequest:
    x_shape, w_shape = spec.shapes
    n, h, w_, cin = x_shape
    kh, kw, _, cout = w_shape
    want = (("conv2d.ip3_packed", "conv2d.ip4_dual")
            if spec.knob("dual", False)
            else ("conv2d.ip1_vpu", "conv2d.ip2_mxu"))
    return SiteRequest(
        candidates=tuple(CONV2D[name] for name in want),
        fp_args=(n, h, w_, cin, kh, kw, cout),
        fp_kwargs=(("itemsize", dtype_itemsize(spec.dtype)),),
        op_bits=_bits(spec.dtype))


def _pool2d_adapter(spec: SiteSpec) -> SiteRequest:
    (x_shape,) = spec.shapes
    (kh, kw), (sh, sw) = check_pool_geometry(
        x_shape, spec.knob("window", (2, 2)), spec.knob("stride"))
    n, h, w_, c = x_shape
    return SiteRequest(
        candidates=(POOL2D["pool2d.pool_vpu"], POOL2D["pool2d.pool_im2col"]),
        fp_args=(n, h, w_, c, kh, kw, sh, sw),
        fp_kwargs=(("itemsize", dtype_itemsize(spec.dtype)),
                   ("mode", spec.knob("mode", "max"))),
        op_bits=_bits(spec.dtype))


def _activation_adapter(spec: SiteSpec) -> SiteRequest:
    kind = spec.knob("kind", "relu")
    cands = [ACTIVATION["activation.act_vpu"]]
    if kind in act_lut_mod.SUPPORTED_KINDS:
        # capability filter: the LUT is constant-off-range, so only
        # saturating kinds may offer it
        cands.append(ACTIVATION["activation.act_lut"])
    n_elems = int(math.prod(int(d) for d in spec.shapes[0]))
    # Activation IPs re-encode their input on ingest, so the caller's
    # dtype imposes no operand-width floor (op_bits=0).
    return SiteRequest(
        candidates=tuple(cands),
        fp_args=(n_elems,),
        fp_kwargs=(("itemsize", dtype_itemsize(spec.dtype)),
                   ("kind", kind)),
        op_bits=0)


def _matmul_adapter(spec: SiteSpec) -> SiteRequest:
    a_shape, b_shape = spec.shapes
    m, k = a_shape[-2], a_shape[-1]
    n = b_shape[-1]
    want = (("matmul.mm_dual_shared", "matmul.mm_dual_full")
            if spec.knob("dual", False)
            else ("matmul.mm_vpu", "matmul.mm_mxu"))
    return SiteRequest(
        candidates=tuple(MATMUL[name] for name in want),
        fp_args=(m, k, n),
        fp_kwargs=(("itemsize", dtype_itemsize(spec.dtype)),),
        op_bits=_bits(spec.dtype))


def _attention_adapter(spec: SiteSpec) -> SiteRequest:
    q_shape, kv_shape = spec.shapes
    b, hq, sq, d = q_shape
    _, hkv, skv, _ = kv_shape
    if sq == 1:
        cands = (ATTENTION["attention.attn_decode"],)
        args = (b, hq, hkv, skv, d)
    else:
        cands = (ATTENTION["attention.attn_naive"],
                 ATTENTION["attention.attn_flash"])
        args = (b, hq, hkv, sq, skv, d)
    return SiteRequest(
        candidates=cands, fp_args=args,
        fp_kwargs=(("itemsize", dtype_itemsize(spec.dtype)),),
        op_bits=_bits(spec.dtype))


def _cnn_fused_adapter(spec: SiteSpec) -> SiteRequest:
    x_shape, w_shape = spec.shapes
    n, h, w_, cin = x_shape
    kh, kw, _, cout = w_shape
    conv_out = (n, h - kh + 1, w_ - kw + 1, cout)
    (ph, pw), (sh, sw) = check_pool_geometry(
        conv_out, spec.knob("window", (2, 2)), spec.knob("stride"))
    return SiteRequest(
        candidates=(CNN_FUSED["fused_vpu"], CNN_FUSED["fused_mxu"]),
        fp_args=(n, h, w_, cin, kh, kw, cout, ph, pw, sh, sw),
        fp_kwargs=(("itemsize", dtype_itemsize(spec.dtype)),
                   ("mode", spec.knob("mode", "max")),
                   ("kind", spec.knob("kind", "relu"))),
        op_bits=_bits(spec.dtype))


def _cnn_fuse_sites(run) -> "SiteSpec | None":
    """Map an adjacent (conv, pool, act) SiteSpec triple to the single
    fused-block SiteSpec, or None when the run is not fusable: a
    dual-stream conv, shapes that do not chain conv->pool->act, or a
    pool window the conv output cannot host."""
    conv, pool, act = run
    if conv.knob("dual", False):
        return None
    x_shape, w_shape = conv.shapes
    n, h, w_, cin = x_shape
    kh, kw, _, cout = w_shape
    conv_out = (n, h - kh + 1, w_ - kw + 1, cout)
    if tuple(pool.shapes[0]) != conv_out:
        return None
    try:
        window, stride = check_pool_geometry(
            conv_out, pool.knob("window", (2, 2)), pool.knob("stride"))
        if tuple(act.shapes[0]) != pool2d_out_shape(conv_out, window,
                                                    stride):
            return None
    except ValueError:
        return None
    base = conv.name[:-len(".conv")] if conv.name.endswith(".conv") \
        else conv.name
    ladder = set(conv.ladder) & set(pool.ladder) & set(act.ladder)
    return SiteSpec.make(
        f"{base}.fused", "cnn_fused", (x_shape, w_shape), conv.dtype,
        ladder=tuple(ladder), window=window, stride=stride,
        mode=pool.knob("mode", "max"), kind=act.knob("kind", "relu"))


CONV2D.site_adapter = _conv2d_adapter
POOL2D.site_adapter = _pool2d_adapter
ACTIVATION.site_adapter = _activation_adapter
CNN_FUSED.site_adapter = _cnn_fused_adapter
CNN_FUSED.fuse_sites = _cnn_fuse_sites
MATMUL.site_adapter = _matmul_adapter
ATTENTION.site_adapter = _attention_adapter


def get_family(name: str) -> IPFamily:
    return FAMILIES[name]


def get_ip(qualified: str) -> KernelIP:
    family, _, short = qualified.partition(".")
    return FAMILIES[family][short or qualified]
