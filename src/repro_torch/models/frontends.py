"""CNN vision frontend — the adaptive-IP image stem the server runs.

Every conv/pool/activation of every block is dispatched through the
resource-driven planner, and the pooled feature map is flattened to the
(B, S, d_model) patch-embedding contract.  The LM-side input specs of
``repro.models.frontends`` are ROADMAP queue 1, item 12.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.ip import dtype_name


class CudaUnavailableError(RuntimeError):
    """Raised by an entry point asked to run on the card (the default)
    where PyTorch sees no CUDA device."""


def resolve_device(device=None) -> torch.device:
    """``None`` means ``cuda``.  Asking for CUDA without a CUDA device
    raises ``CudaUnavailableError`` — entry points never fall back to the
    CPU quietly; pass ``device="cpu"`` to run the plain versions."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise CudaUnavailableError(
            "no CUDA device is available; pass device=\"cpu\" to run the "
            "plain PyTorch versions on the CPU")
    return dev


def init_cnn_frontend(generator=0, *, channels=(3, 16, 32), k: int = 3,
                      d_model: int = 64, dtype=torch.float32, device=None):
    """Random frontend params from a ``torch.Generator`` (or a seed):
    ``{"blocks": [{"w": (k, k, cin, cout)}, ...], "proj": (C, d_model)}``
    on ``device`` (``None`` = ``cuda``)."""
    from repro_torch.models.blocks import _generator, init_cnn_block
    dev = resolve_device(device)
    gen = _generator(generator)
    blocks = [init_cnn_block(gen, cin, cout, k, dtype=dtype, device=dev)
              for cin, cout in zip(channels[:-1], channels[1:])]
    proj = torch.randn((channels[-1], d_model), generator=gen) \
        * channels[-1] ** -0.5
    return {"blocks": blocks, "proj": proj.to(dtype=dtype, device=dev)}


def params_from_numpy(tree, device=None):
    """The reference's frontend params (``{"blocks": [{"w": ...}],
    "proj": ...}`` with numpy or array-like leaves) as this package's,
    on ``device`` (``None`` = ``cuda``)."""
    dev = resolve_device(device)

    def leaf(a):
        a = np.array(a, copy=True)
        if a.dtype.name == "bfloat16":      # ml_dtypes' bf16: exact via f32
            return torch.from_numpy(a.astype(np.float32)).to(
                dtype=torch.bfloat16, device=dev)
        return torch.from_numpy(a).to(dev)

    return {"blocks": [{"w": leaf(b["w"])} for b in tree["blocks"]],
            "proj": leaf(tree["proj"])}


def cnn_frontend_site_specs(p, image_shape, image_dtype, *,
                            pool_window=(2, 2), activation: str = "relu",
                            ladder=()):
    """All op sites of the frontend stack, chained by shape arithmetic —
    the whole-network graph the planner partitions one budget across."""
    from repro_torch.models.blocks import cnn_block_site_specs
    specs = []
    shape, dtype = tuple(image_shape), dtype_name(image_dtype)
    for li, bp in enumerate(p["blocks"]):
        block_specs, (shape, dtype) = cnn_block_site_specs(
            shape, bp["w"].shape, x_dtype=dtype, w_dtype=bp["w"].dtype,
            pool_window=pool_window, activation=activation,
            site=f"frontend.block{li}", ladder=ladder)
        specs.extend(block_specs)
    return specs


def apply_cnn_frontend(p, images, *, budget=None, pool_window=(2, 2),
                       activation: str = "relu", plan=None, ladder=(),
                       quant_report=None, network=None, tile_overrides=None,
                       fuse: bool = True):
    """images: (B, H, W, Cin) -> patch embeddings (B, S, d_model).

    The entire stack is planned as ONE NetworkPlan: the budget is
    partitioned across all sites at once.  ``network`` executes from an
    externally built plan (the serving runtime's entry point) instead of
    planning here; every block still validates its sites against it.
    ``fuse`` (default True) plans fusion-aware, so every block the
    planner maps onto a fused conv->pool->act site runs as ONE launch.
    The projection is a plain float32 einsum, as in the reference.
    """
    from repro_torch.core.plan import plan_network
    from repro_torch.models.blocks import apply_cnn_block
    if network is None:
        network = plan_network(
            cnn_frontend_site_specs(p, images.shape, images.dtype,
                                    pool_window=pool_window,
                                    activation=activation, ladder=ladder),
            budget, fuse=fuse)
    x = images
    for li, bp in enumerate(p["blocks"]):
        x = apply_cnn_block(bp, x, pool_window=pool_window,
                            activation=activation, plan=plan,
                            site=f"frontend.block{li}", network=network,
                            ladder=ladder, quant_report=quant_report,
                            tile_overrides=tile_overrides)
    b, h, w, c = x.shape
    tokens = x.reshape(b, h * w, c)
    return torch.einsum("bsc,cd->bsd", tokens, p["proj"].to(x.dtype))
