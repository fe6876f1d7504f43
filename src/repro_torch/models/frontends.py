"""Modality frontends + input spec providers
(``repro/models/frontends.py``).

The [audio]/[vlm] archs specify the transformer backbone only:
``input_specs()`` provides precomputed frame/patch embeddings.  The CNN
vision frontend is the exception — the adaptive-IP image stem the
server runs: every conv/pool/activation of every block is dispatched
through the resource-driven planner, and the pooled feature map is
flattened to the (B, S, d_model) patch-embedding contract.
``input_specs`` / ``make_inputs`` say what each (arch x shape x
step-kind) consumes: abstract specs are ``device="meta"`` tensors, and
concrete inputs are drawn from ``np.random.default_rng(seed)`` in the
reference's order, so both packages get the same numbers.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
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


def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig,
                shape: ShapeConfig) -> Dict[str, torch.Tensor]:
    """Abstract inputs (``meta`` tensors) for the step implied by
    ``shape.kind``; token ids are int32, as the reference's."""
    B, S = shape.global_batch, shape.seq_len
    cd = cfg.dtype("compute")
    i32 = torch.int32
    if shape.kind == "train":
        if cfg.family == "encdec":
            return {"embeds": _spec((B, S, cfg.d_model), cd),
                    "tokens": _spec((B, S), i32),
                    "labels": _spec((B, S), i32)}
        if cfg.embed_inputs:
            return {"embeds": _spec((B, S, cfg.d_model), cd),
                    "labels": _spec((B, S), i32)}
        return {"tokens": _spec((B, S), i32), "labels": _spec((B, S), i32)}
    if shape.kind == "prefill":
        if cfg.family == "encdec":
            return {"embeds": _spec((B, S, cfg.d_model), cd),
                    "tokens": _spec((B, S), i32)}
        if cfg.embed_inputs:
            return {"embeds": _spec((B, S, cfg.d_model), cd)}
        return {"tokens": _spec((B, S), i32)}
    # decode: one new token against a cache of S (caches built separately)
    return {"tokens": _spec((B, 1), i32)}


def make_inputs(cfg: ModelConfig, shape: ShapeConfig, *, seed: int = 0,
                abstract: bool = True,
                device=None) -> Dict[str, torch.Tensor]:
    """``input_specs`` when ``abstract``, else tensors on ``device``
    (``None`` = ``cuda``) drawn spec by spec from
    ``np.random.default_rng(seed)``: token ids in [0, vocab), floats
    N(0, 1) in f32, then cast to the spec's dtype."""
    specs = input_specs(cfg, shape)
    if abstract:
        return specs
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    out = {}
    for name, s in specs.items():
        if not s.dtype.is_floating_point:
            a = rng.integers(0, cfg.vocab_size, tuple(s.shape),
                             dtype=np.int32)
            out[name] = torch.from_numpy(a).to(dev)
        else:
            a = rng.normal(0, 1, tuple(s.shape)).astype(np.float32)
            out[name] = torch.from_numpy(a).to(dtype=s.dtype, device=dev)
    return out


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
