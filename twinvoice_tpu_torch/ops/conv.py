"""Convolution and pooling on NCHW tensors with PyTorch-layout weights.

Ports of ``twinvoice_tpu.ops.conv`` (NHWC + HWIO there). A parameter dict is
``{"weight": (Co,Ci,kH,kW), "bias": (Co,)}``; for the transpose conv the
weight is ``(Ci,Co,2,2)``, ``nn.ConvTranspose2d``'s layout, which maps the JAX
kernel ``K[a,b,ci,co]`` to ``W[ci,co,a,b]``. Weights must already be in the
activation's dtype (``models.unet.fold_unet`` casts them once).
"""

from __future__ import annotations

import torch.nn.functional as F


def conv3x3(x, p):
    """3×3 stride-1 pad-1 conv (``ops/conv.py:conv3x3``)."""
    return F.conv2d(x, p["weight"], p.get("bias"), padding=1)


def conv1x1(x, p):
    """1×1 conv (``ops/conv.py:conv1x1``)."""
    return F.conv2d(x, p["weight"], p.get("bias"))


def conv_transpose2x2_serving(x, p):
    """2×2 stride-2 transpose conv: ``out[o, 2i+a, 2j+b] = Σ_c x[c,i,j]·W[c,o,a,b]
    + bias[o]`` (``ops/conv.py:conv_transpose2x2_serving``)."""
    return F.conv_transpose2d(x, p["weight"], p.get("bias"), stride=2)


def max_pool2(x):
    """2×2 stride-2 max pool, floor mode (``ops/conv.py:max_pool2``)."""
    return F.max_pool2d(x, 2)
