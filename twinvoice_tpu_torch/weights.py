"""Segmenter weights: the bundled npz files read with numpy alone, and the
map from the JAX package's parameter pytree to PyTorch layouts.

The npz keys are JAX ``keystr`` paths under a ``p/`` (params) or ``s/``
(BatchNorm state) prefix, e.g. ``p/['enc'][0]['conv1']['kernel']``
(written by ``twinvoice_tpu.train.checkpoint.save_params_npz``).

Layouts: a conv kernel is HWIO in JAX and OIHW here; a 2×2 stride-2
transpose-conv kernel is (2,2,Ci,Co) in JAX and (Ci,Co,2,2) here, which is
``torch.nn.ConvTranspose2d``'s weight layout. The recognizer's and the
textness head's maps, both ways, sit beside their models
(``ocr/torchocr/model.py:crnn_params_from_jax``/``crnn_params_to_jax``,
``textness.py:textness_params_from_jax``/``textness_params_to_jax``) and
use this module's conv helpers.
"""

from __future__ import annotations

import re

import numpy as np
import torch

_KEY_PART = re.compile(r"\['([^']*)'\]|\[(\d+)\]")


def parse_keystr(keystr: str):
    """``"['enc'][0]['conv1']"`` → ``["enc", 0, "conv1"]``."""
    parts = [m.group(1) if m.group(1) is not None else int(m.group(2))
             for m in _KEY_PART.finditer(keystr)]
    if "".join(m.group(0) for m in _KEY_PART.finditer(keystr)) != keystr:
        raise ValueError(f"not a keystr path: {keystr!r}")
    return parts


def _insert(tree, path, leaf):
    node = tree
    for key in path[:-1]:
        node = node.setdefault(key, {})
    node[path[-1]] = leaf


def _lists(node):
    """Dicts keyed 0..n-1 (list positions in the keystr) become lists."""
    if not isinstance(node, dict):
        return node
    out = {k: _lists(v) for k, v in node.items()}
    if out and all(isinstance(k, int) for k in out):
        if sorted(out) != list(range(len(out))):
            raise ValueError(f"list indices with gaps: {sorted(out)}")
        return [out[i] for i in range(len(out))]
    return out


def read_npz_tree(path):
    """→ ``(params, state)``: nested dicts/lists of numpy arrays in the JAX
    package's layout, as ``load_params_npz`` would rebuild them."""
    trees = {"p": {}, "s": {}}
    with np.load(path) as z:
        for key in z.files:
            prefix, keystr = key.split("/", 1)
            _insert(trees[prefix], parse_keystr(keystr), np.asarray(z[key]))
    return _lists(trees["p"]), _lists(trees["s"])


def _tensor(a, perm=None):
    a = np.asarray(a)
    if perm is not None:
        a = np.transpose(a, perm)
    return torch.from_numpy(np.array(a, order="C"))  # a writable copy


def _conv(p):
    return {"weight": _tensor(p["kernel"], (3, 2, 0, 1)), "bias": _tensor(p["bias"])}


def _conv_transpose(p):
    return {"weight": _tensor(p["kernel"], (2, 3, 0, 1)), "bias": _tensor(p["bias"])}


def _double_conv(p):
    return {
        "conv1": _conv(p["conv1"]),
        "bn1": {k: _tensor(v) for k, v in p["bn1"].items()},
        "conv2": _conv(p["conv2"]),
        "bn2": {k: _tensor(v) for k, v in p["bn2"].items()},
    }


def _bn_state(s):
    return {name: {k: _tensor(v) for k, v in bn.items()} for name, bn in s.items()}


def from_jax_params(params, state):
    """Carry a JAX U-Net ``(params, state)`` pytree, given as numpy arrays,
    into PyTorch layouts: the same tree with each conv's ``kernel`` replaced
    by an OIHW ``weight`` and each transpose conv's by a (Ci,Co,2,2) one.
    BatchNorm parameters and running statistics keep their names."""
    tp = {
        "enc": [_double_conv(p) for p in params["enc"]],
        "bottleneck": _double_conv(params["bottleneck"]),
        "up": [_conv_transpose(p) for p in params["up"]],
        "dec": [_double_conv(p) for p in params["dec"]],
        "out": _conv(params["out"]),
    }
    ts = {
        "enc": [_bn_state(s) for s in state["enc"]],
        "bottleneck": _bn_state(state["bottleneck"]),
        "dec": [_bn_state(s) for s in state["dec"]],
    }
    return tp, ts


def _array(t, perm=None):
    a = t.detach().cpu().numpy()
    return np.array(a if perm is None else np.transpose(a, perm), order="C")  # a copy


def _jax_conv(p, perm):
    return {"kernel": _array(p["weight"], perm), "bias": _array(p["bias"])}


def _jax_double_conv(p):
    return {
        "conv1": _jax_conv(p["conv1"], (2, 3, 1, 0)),
        "bn1": {k: _array(v) for k, v in p["bn1"].items()},
        "conv2": _jax_conv(p["conv2"], (2, 3, 1, 0)),
        "bn2": {k: _array(v) for k, v in p["bn2"].items()},
    }


def _jax_bn_state(s):
    return {name: {k: _array(v) for k, v in bn.items()} for name, bn in s.items()}


def to_jax_params(params, state):
    """The inverse of :func:`from_jax_params`: torch ``(params, state)`` trees
    → numpy trees in the JAX package's layouts (HWIO ``kernel``, (2,2,Ci,Co)
    transpose kernels). A pure transpose, so a round trip is bit-exact."""
    jp = {
        "enc": [_jax_double_conv(p) for p in params["enc"]],
        "bottleneck": _jax_double_conv(params["bottleneck"]),
        "up": [_jax_conv(p, (2, 3, 0, 1)) for p in params["up"]],
        "dec": [_jax_double_conv(p) for p in params["dec"]],
        "out": _jax_conv(params["out"], (2, 3, 1, 0)),
    }
    js = {
        "enc": [_jax_bn_state(s) for s in state["enc"]],
        "bottleneck": _jax_bn_state(state["bottleneck"]),
        "dec": [_jax_bn_state(s) for s in state["dec"]],
    }
    return jp, js


def keystr_items(tree, prefix=""):
    """``(keystr, leaf)`` pairs of a nested dict/list tree, the paths written
    as JAX's ``keystr`` writes them (``['enc'][0]['conv1']['kernel']``)."""
    if isinstance(tree, dict):
        return [kv for k, v in tree.items() for kv in keystr_items(v, f"{prefix}['{k}']")]
    if isinstance(tree, list):
        return [kv for i, v in enumerate(tree) for kv in keystr_items(v, f"{prefix}[{i}]")]
    return [(prefix, tree)]


def load_npz(path):
    """Bundled npz → ``(params, state)`` torch trees on the CPU, float32."""
    return from_jax_params(*read_npz_tree(path))


def _qconv(p, device):
    """JAX int8 conv leaf (kernel (kh,kw,Ci,Co)) → the port's (Co,kh,kw,Ci)."""
    return {
        "kernel": _tensor(p["kernel"], (3, 0, 1, 2)).to(device),
        "w_scale": _tensor(np.asarray(p["w_scale"], np.float32)).to(device),
        "bias": _tensor(np.asarray(p["bias"], np.float32)).to(device),
    }


def _q_double_conv(q, device):
    return {"conv1": _qconv(q["conv1"], device), "conv2": _qconv(q["conv2"], device),
            "s1": float(q["s1"]), "s2": float(q["s2"])}


def from_jax_qparams(q, device="cpu"):
    """Carry the JAX int8 qparams pytree (``twinvoice_tpu.infer.quant.
    quantize_unet``; leaves as numpy or JAX arrays) into the port's tree on
    ``device`` (``infer.quant``'s module doc): int8 kernels (kh,kw,Ci,Co) →
    (Co,kh,kw,Ci), the upsample's (2,2,Ci,Co) likewise, the out conv's
    (1,1,C,3) float32 kernel → a (C,3) ``weight``; ``w_scale`` and biases as
    float32, activation scales as Python floats."""
    return {
        "enc": [_q_double_conv(lq, device) for lq in q["enc"]],
        "bottleneck": _q_double_conv(q["bottleneck"], device),
        "up": [{**_qconv(uq, device), "s_out": float(uq["s_out"])} for uq in q["up"]],
        "dec": [_q_double_conv(dq, device) for dq in q["dec"]],
        "out": {
            "weight": _tensor(np.asarray(q["out"]["kernel"], np.float32)[0, 0]).to(device),
            "bias": _tensor(np.asarray(q["out"]["bias"], np.float32)).to(device),
        },
    }
