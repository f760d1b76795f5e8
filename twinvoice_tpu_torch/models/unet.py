"""The BN-folded U-Net serving forward (``twinvoice_tpu.models.unet``), NCHW.

``fold_unet`` folds every eval-mode BatchNorm into the conv before it, once;
``unet_apply_folded`` runs the conv+ReLU graph with the concat-free split
decoder. Parameters are the torch-layout trees of ``weights.from_jax_params``.
"""

from __future__ import annotations

import torch

from twinvoice_tpu_torch.config import UNetConfig
from twinvoice_tpu_torch.ops.conv import (
    conv1x1,
    conv3x3,
    conv_transpose2x2_serving,
    max_pool2,
)
from twinvoice_tpu_torch.ops.norm import fold_batchnorm_into_conv


def _fold_double_conv(p, s, eps):
    return {
        "conv1": fold_batchnorm_into_conv(p["conv1"], p["bn1"], s["bn1"], eps=eps),
        "conv2": fold_batchnorm_into_conv(p["conv2"], p["bn2"], s["bn2"], eps=eps),
    }


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_map(fn, v) for v in tree]
    return fn(tree)


def fold_unet(params, state, *, cfg: UNetConfig = UNetConfig(), dtype=None,
              device=None):
    """Fold all eval-mode BNs into their convs (in the params' dtype, float32
    for bundled weights), then cast to ``dtype`` and move to ``device``."""
    eps = cfg.bn_eps
    folded = {
        "enc": [_fold_double_conv(p, s, eps)
                for p, s in zip(params["enc"], state["enc"])],
        "bottleneck": _fold_double_conv(params["bottleneck"], state["bottleneck"], eps),
        "up": [dict(p) for p in params["up"]],
        "dec": [_fold_double_conv(p, s, eps)
                for p, s in zip(params["dec"], state["dec"])],
        "out": dict(params["out"]),
    }
    return _tree_map(lambda a: a.to(device=device, dtype=dtype), folded)


def _folded_double_conv(p, x):
    x = torch.relu(conv3x3(x, p["conv1"]))
    return torch.relu(conv3x3(x, p["conv2"]))


def unet_apply_folded(folded, x):
    """Inference forward on BN-folded params: (N,Cin,H,W) → (N,classes,H,W)
    logits in ``x``'s dtype; H and W divisible by 2^depth.

    The decoder's skip concatenation is eliminated:
    ``conv([up, skip], K) == conv(up, K[:, :C]) + conv(skip, K[:, C:])``, so
    the (2C, H, W) concat tensor is never written.
    """
    skips = []
    h = x
    for p in folded["enc"]:
        h = _folded_double_conv(p, h)
        skips.append(h)
        h = max_pool2(h)
    h = _folded_double_conv(folded["bottleneck"], h)
    for up_p, dec_p, skip in zip(folded["up"], folded["dec"], reversed(skips)):
        h = conv_transpose2x2_serving(h, up_p)
        c = h.shape[1]
        k1 = dec_p["conv1"]["weight"]
        part_up = conv3x3(h, {"weight": k1[:, :c], "bias": dec_p["conv1"]["bias"]})
        part_skip = conv3x3(skip, {"weight": k1[:, c:]})
        h = torch.relu(part_up + part_skip)
        h = torch.relu(conv3x3(h, dec_p["conv2"]))
    return conv1x1(h, folded["out"])
