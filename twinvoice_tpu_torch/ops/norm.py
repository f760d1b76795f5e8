"""Inference-time BatchNorm folding (``twinvoice_tpu.ops.norm``)."""

from __future__ import annotations

import torch


def fold_batchnorm_into_conv(conv_params, bn_params, bn_state, *, eps=1e-5):
    """Fold eval-mode BN into the conv before it.

    y = ((conv(x,W)+b) − μ)·γ/√(σ²+ε) + β
      = conv(x, W·s) + (b−μ)·s + β      with s = γ/√(σ²+ε)  (per out-channel)

    ``conv_params["weight"]`` is OIHW, so ``s`` scales dim 0. Every step is
    one correctly rounded float32 operation, as in the JAX fold, so the folded
    weights are bit-equal to it. PyTorch's CPU ``sqrt`` is not always
    correctly rounded in float32, so the root is taken in float64 and rounded
    once (exact: float64 has more than twice float32's precision).
    """
    var_eps = bn_state["var"] + eps
    root = torch.sqrt(var_eps.to(torch.float64)).to(var_eps.dtype)
    s = bn_params["scale"] / root
    weight = conv_params["weight"] * s[:, None, None, None]
    bias = (conv_params.get("bias", 0.0) - bn_state["mean"]) * s + bn_params["bias"]
    return {"weight": weight, "bias": bias}
