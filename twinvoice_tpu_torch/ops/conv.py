"""Convolution, pooling and initialisers on NCHW tensors with PyTorch-layout
weights.

Ports of ``twinvoice_tpu.ops.conv`` (NHWC + HWIO there). A parameter dict is
``{"weight": (Co,Ci,kH,kW), "bias": (Co,)}``; for the transpose conv the
weight is ``(Ci,Co,2,2)``, ``nn.ConvTranspose2d``'s layout, which maps the JAX
kernel ``K[a,b,ci,co]`` to ``W[ci,co,a,b]``.

Mixed precision, as in the JAX package: weights are cast to the activation's
dtype inside the op (a no-op when they already are, as on the serving path,
where ``models.unet.fold_unet`` casts them once), so in training the cast is
differentiated and the gradient lands on the float32 master weight; the
output is in the input's dtype.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def conv2d(x, weight, bias=None, *, padding=0):
    """General stride-1 conv (``ops/conv.py:conv2d``); ``weight`` OIHW."""
    return F.conv2d(x, weight.to(x.dtype),
                    None if bias is None else bias.to(x.dtype), padding=padding)


def conv3x3(x, p):
    """3×3 stride-1 pad-1 conv (``ops/conv.py:conv3x3``)."""
    return conv2d(x, p["weight"], p.get("bias"), padding=1)


def conv1x1(x, p):
    """1×1 conv (``ops/conv.py:conv1x1``)."""
    return conv2d(x, p["weight"], p.get("bias"))


def conv_transpose2x2(x, p):
    """2×2 stride-2 transpose conv: ``out[o, 2i+a, 2j+b] = Σ_c x[c,i,j]·W[c,o,a,b]
    + bias[o]``. One function for training and serving: JAX's two forms
    (``ops/conv.py:conv_transpose2x2``, a product and a reshape, and
    ``conv_transpose2x2_serving``) compute the same function, and
    ``F.conv_transpose2d`` computes it and its gradient within float32
    rounding of both."""
    bias = p.get("bias")
    return F.conv_transpose2d(x, p["weight"].to(x.dtype),
                              None if bias is None else bias.to(x.dtype), stride=2)


def max_pool2(x):
    """2×2 stride-2 max pool, floor mode (``ops/conv.py:max_pool2``). On a
    tie in a window the gradient goes to the first maximum in row-major
    order, where XLA's ``select_and_scatter`` (select ``ge``) sends it."""
    return F.max_pool2d(x, 2)


# ---------------------------------------------------------------------------
# Initialisers: torch Conv2d/ConvTranspose2d default init distributions
# (kaiming_uniform(a=√5) ⇒ U(−1/√fan_in, 1/√fan_in) for weight and bias),
# drawn from an explicit CPU generator and then moved, so one seed gives the
# same weights on every device.
# ---------------------------------------------------------------------------


def _uniform(generator, shape, bound, dtype, device):
    u = torch.rand(shape, generator=generator, dtype=torch.float64)
    return ((2 * u - 1) * bound).to(dtype=dtype, device=device)


def init_conv(generator, kh, kw, cin, cout, *, dtype=torch.float32, device=None,
              bias_init=None):
    bound = 1.0 / math.sqrt(cin * kh * kw)
    weight = _uniform(generator, (cout, cin, kh, kw), bound, dtype, device)
    if bias_init is None:
        bias = _uniform(generator, (cout,), bound, dtype, device)
    else:
        bias = torch.full((cout,), bias_init, dtype=dtype, device=device)
    return {"weight": weight, "bias": bias}


def init_conv_transpose(generator, cin, cout, *, dtype=torch.float32, device=None):
    # torch's fan_in for ConvTranspose2d(Cin, Cout, 2, 2) is Cout·k·k (weight dim 1)
    bound = 1.0 / math.sqrt(cout * 2 * 2)
    return {"weight": _uniform(generator, (cin, cout, 2, 2), bound, dtype, device),
            "bias": _uniform(generator, (cout,), bound, dtype, device)}
