"""The compact convolutional CTC recognizer, NCHW: the port of
``twinvoice_tpu/ocr/jaxocr/model.py`` (``init_crnn``, ``crnn_apply``).

Four conv+BN+ReLU stages with pooling collapse the 32×256 grayscale line to
a feature sequence; two 1×5 residual context convs and a 1×1 head emit the
CTC logits. The parameter trees keep JAX's names with each ``kernel``
replaced by an OIHW ``weight`` (``crnn_params_from_jax``, and back
``crnn_params_to_jax``). BatchNorm runs unfolded, ``(x − mean)·(scale/√(var
+ eps)) + bias`` in float32, as the JAX forward does: at eval from the
running statistics, in training (``train=True``) from the batch's, through
``ops.norm.batchnorm_apply``.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn.functional as F

from twinvoice_tpu_torch.ocr.torchocr.charset import CHARSET, NUM_CLASSES, Charset
from twinvoice_tpu_torch.ops.conv import init_conv
from twinvoice_tpu_torch.ops.norm import batchnorm_apply, init_batchnorm
from twinvoice_tpu_torch.weights import (
    _array,
    _conv,
    _insert,
    _jax_conv,
    _lists,
    _tensor,
    parse_keystr,
)

IMG_H = 32
IMG_W = 256
BN_EPS = 1e-5
CONV_CHANNELS = (32, 64, 96, 128)
CONTEXT = 256
# a recognizer npz's keys that are not ``p/``/``s/`` leaves
META_KEYS = ("charset", "arch", "channels", "context")

DEFAULT_WEIGHTS_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))),
    "twinvoice_tpu", "ocr", "jaxocr", "weights.npz",
)


def crnn_params_from_jax(p_tree, s_tree):
    """JAX ``(params, state)`` of ``init_crnn``, as numpy arrays → the port's
    trees on the CPU: every conv's HWIO ``kernel`` becomes an OIHW
    ``weight``; BatchNorm parameters and statistics keep their names."""
    params = {
        "conv": [_conv(p) for p in p_tree["conv"]],
        "bn": [{k: _tensor(v) for k, v in p.items()} for p in p_tree["bn"]],
        "proj": _conv(p_tree["proj"]),
        "ctx": [_conv(p) for p in p_tree["ctx"]],
        "ctx_bn": [{k: _tensor(v) for k, v in p.items()} for p in p_tree["ctx_bn"]],
        "head": _conv(p_tree["head"]),
    }
    state = {name: [{k: _tensor(v) for k, v in s.items()} for s in s_tree[name]]
             for name in ("bn", "ctx_bn")}
    return params, state


def crnn_params_to_jax(params, state):
    """The inverse of :func:`crnn_params_from_jax`: the port's trees (on any
    device) → numpy trees in the JAX layout (HWIO ``kernel``), copies."""
    hwio = (2, 3, 1, 0)
    jp = {
        "conv": [_jax_conv(p, hwio) for p in params["conv"]],
        "bn": _bn_arrays(params["bn"]),
        "proj": _jax_conv(params["proj"], hwio),
        "ctx": [_jax_conv(p, hwio) for p in params["ctx"]],
        "ctx_bn": _bn_arrays(params["ctx_bn"]),
        "head": _jax_conv(params["head"], hwio),
    }
    return jp, {name: _bn_arrays(state[name]) for name in ("bn", "ctx_bn")}


def _bn_arrays(layers):
    return [{k: _array(v) for k, v in d.items()} for d in layers]


def init_crnn(generator: torch.Generator, *, num_classes: int = NUM_CLASSES,
              channels=CONV_CHANNELS, context: int = CONTEXT, device=None):
    """→ ``(params, state)`` of a fresh recognizer, JAX's ``init_crnn``
    shapes and distributions (torch's conv default, U(±1/√fan_in) for
    weights and biases; BatchNorm scale 1, bias 0, mean 0, var 1), drawn
    from ``generator`` on the CPU and moved to ``device``. ``channels`` and
    ``context`` widen the trunk (the "wide" variant: (48, 96, 144, 192),
    384)."""
    params = {"conv": [], "bn": [], "ctx": [], "ctx_bn": []}
    state = {"bn": [], "ctx_bn": []}
    kw = {"device": device}
    cin = 1
    for c in channels:
        params["conv"].append(init_conv(generator, 3, 3, cin, c, **kw))
        bn_p, bn_s = init_batchnorm(c, **kw)
        params["bn"].append(bn_p)
        state["bn"].append(bn_s)
        cin = c
    feat = channels[-1] * (IMG_H // 8)  # height collapsed into features
    params["proj"] = init_conv(generator, 1, 1, feat, context, **kw)
    for _ in range(2):
        params["ctx"].append(init_conv(generator, 1, 5, context, context, **kw))
        bn_p, bn_s = init_batchnorm(context, **kw)
        params["ctx_bn"].append(bn_p)
        state["ctx_bn"].append(bn_s)
    params["head"] = init_conv(generator, 1, 1, context, num_classes, **kw)
    return params, state


def load_crnn_weights(path: str = DEFAULT_WEIGHTS_PATH):
    """A recognizer npz (``p/<keystr>`` and ``s/<keystr>`` leaves, plus
    ``charset``, ``arch``, ``channels`` and ``context``) → ``(params, state,
    charset, arch)`` on the CPU, read with numpy. Files without a charset or
    an arch get the ASCII charset and ``"t32"``, as in the JAX loader."""
    trees = {"p": {}, "s": {}}
    with np.load(path) as z:
        charset = Charset(str(z["charset"])) if "charset" in z.files else Charset(CHARSET)
        arch = str(z["arch"]) if "arch" in z.files else "t32"
        for key in z.files:
            if key not in META_KEYS:
                prefix, keystr = key.split("/", 1)
                _insert(trees[prefix], parse_keystr(keystr), np.asarray(z[key]))
    params, state = crnn_params_from_jax(_lists(trees["p"]), _lists(trees["s"]))
    return params, state, charset, arch


def _bn_eval(x, p, s):
    """Eval-mode BatchNorm over dim 1, in float32, unfolded. The root is
    taken in float64 and rounded once (PyTorch's CPU float32 ``sqrt`` is not
    always correctly rounded)."""
    root = torch.sqrt(s["var"].to(torch.float64) + BN_EPS).to(torch.float32)
    inv = p["scale"] / root
    shape = (1, -1, 1, 1)
    return (x - s["mean"].view(shape)) * inv.view(shape) + p["bias"].view(shape)


def crnn_apply(params, state, x, *, arch: str = "t32", train: bool = False):
    """``x``: (B, 1, 32, 256) float32 in [0, 1] → ``(logits (B, T, classes),
    new_state)``, T = 32 (``"t32"``) or 64 (``"t64"``, whose third pool
    halves the height only). At eval ``new_state`` is ``state``; with
    ``train=True`` BatchNorm normalises with the batch statistics and
    returns the new running ones, detached. A tie in a pool window sends
    the gradient to the first maximum in row-major order, where XLA's
    ``select_and_scatter`` (select ``ge``) sends it."""
    new_state = {"bn": [], "ctx_bn": []}

    def bn(h, p, s, name):
        if not train:
            return _bn_eval(h, p, s)
        h, ns = batchnorm_apply(h, p, s, train=True, eps=BN_EPS)
        new_state[name].append(ns)
        return h

    h = x
    for i, (cp, bp) in enumerate(zip(params["conv"], params["bn"])):
        h = F.conv2d(h, cp["weight"], cp["bias"], padding=1)
        h = torch.relu(bn(h, bp, state["bn"][i], "bn"))
        if i < 3:
            h = F.max_pool2d(h, (2, 1) if (i == 2 and arch == "t64") else 2)
    # (B, C, H, W) → the time-major sequence as (B, H·C, 1, W), features
    # h-major and c-minor, the order JAX's (B, W, H, C) flatten gives
    b, c, hh, ww = h.shape
    h = h.permute(0, 3, 2, 1).reshape(b, ww, hh * c)
    h = h.permute(0, 2, 1).reshape(b, hh * c, 1, ww)
    h = torch.relu(F.conv2d(h, params["proj"]["weight"], params["proj"]["bias"]))
    for i, (cp, bp) in enumerate(zip(params["ctx"], params["ctx_bn"])):
        r = F.conv2d(h, cp["weight"], cp["bias"], padding=(0, 2))
        h = h + torch.relu(bn(r, bp, state["ctx_bn"][i], "ctx_bn"))
    logits = F.conv2d(h, params["head"]["weight"], params["head"]["bias"])
    return logits[:, :, 0].permute(0, 2, 1), (new_state if train else state)
