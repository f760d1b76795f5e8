"""Reference ``state_dict`` ↔ the port's U-Net trees
(``twinvoice_tpu.port.torch_port``).

The reference checkpoint schema (reference ``unet_model.py:29-53``):

  down{1..4}.net.{0,3}.{weight,bias}            Conv2d  (O,I,3,3)
  down{1..4}.net.{1,4}.{weight,bias,running_mean,running_var,num_batches_tracked}
  bottleneck.net.*                              same DoubleConv schema
  up{4..1}.{weight,bias}                        ConvTranspose2d (I,O,2,2)
  conv{4..1}.net.*                              decoder DoubleConvs
  out_conv.{weight,bias}                        Conv2d (3,64,1,1)

The port's trees (``weights.from_jax_params``) keep PyTorch's layouts, OIHW
convs and (I,O,2,2) transpose convs, so porting is a renaming with no
transposes, and :func:`export_state_dict` is its exact inverse.
``num_batches_tracked`` is not read, and not written back.
"""

from __future__ import annotations

import numpy as np
import torch

from twinvoice_tpu_torch.config import UNetConfig


def _tensor(x, dtype):
    """A tensor or an ndarray → a CPU tensor of ``dtype`` that owns its data."""
    if torch.is_tensor(x):
        return x.detach().to("cpu", dtype, copy=True)
    return torch.tensor(np.asarray(x), dtype=dtype)


def _conv(sd, prefix, dtype):
    return {"weight": _tensor(sd[prefix + ".weight"], dtype),
            "bias": _tensor(sd[prefix + ".bias"], dtype)}


def _bn(sd, prefix, dtype):
    params = {"scale": _tensor(sd[prefix + ".weight"], dtype),
              "bias": _tensor(sd[prefix + ".bias"], dtype)}
    state = {"mean": _tensor(sd[prefix + ".running_mean"], dtype),
             "var": _tensor(sd[prefix + ".running_var"], dtype)}
    return params, state


def _double_conv(sd, prefix, dtype):
    bn1_p, bn1_s = _bn(sd, prefix + ".net.1", dtype)
    bn2_p, bn2_s = _bn(sd, prefix + ".net.4", dtype)
    params = {"conv1": _conv(sd, prefix + ".net.0", dtype), "bn1": bn1_p,
              "conv2": _conv(sd, prefix + ".net.3", dtype), "bn2": bn2_p}
    return params, {"bn1": bn1_s, "bn2": bn2_s}


def port_state_dict(sd, cfg: UNetConfig = UNetConfig(), *, dtype=torch.float32):
    """A reference-schema state_dict (tensors or ndarrays) → ``(params,
    state)``, the port's trees on the CPU."""
    params = {"enc": [], "dec": [], "up": []}
    state = {"enc": [], "dec": []}
    for i in range(1, cfg.depth + 1):
        p, s = _double_conv(sd, f"down{i}", dtype)
        params["enc"].append(p)
        state["enc"].append(s)
    params["bottleneck"], state["bottleneck"] = _double_conv(sd, "bottleneck", dtype)
    for i in range(cfg.depth, 0, -1):  # up4, conv4, up3, conv3, ...
        params["up"].append(_conv(sd, f"up{i}", dtype))
        p, s = _double_conv(sd, f"conv{i}", dtype)
        params["dec"].append(p)
        state["dec"].append(s)
    params["out"] = _conv(sd, "out_conv", dtype)
    return params, state


def load_pth(path, cfg: UNetConfig = UNetConfig(), *, dtype=torch.float32):
    """Load a reference ``.pth`` checkpoint file (tensors only:
    ``weights_only=True``) and port it."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return port_state_dict(sd, cfg, dtype=dtype)


def _array(t):
    return t.detach().cpu().numpy().copy()


def _export_double_conv(out, prefix, p, s):
    for idx, conv, bn in ((0, "conv1", "bn1"), (3, "conv2", "bn2")):
        out[f"{prefix}.net.{idx}.weight"] = _array(p[conv]["weight"])
        out[f"{prefix}.net.{idx}.bias"] = _array(p[conv]["bias"])
        out[f"{prefix}.net.{idx + 1}.weight"] = _array(p[bn]["scale"])
        out[f"{prefix}.net.{idx + 1}.bias"] = _array(p[bn]["bias"])
        out[f"{prefix}.net.{idx + 1}.running_mean"] = _array(s[bn]["mean"])
        out[f"{prefix}.net.{idx + 1}.running_var"] = _array(s[bn]["var"])


def export_state_dict(params, state, cfg: UNetConfig = UNetConfig()):
    """``(params, state)`` → a reference-schema dict of numpy arrays, in the
    JAX package's key order. Save it for the reference with
    ``torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, path)``."""
    out = {}
    for i, (p, s) in enumerate(zip(params["enc"], state["enc"])):
        _export_double_conv(out, f"down{i + 1}", p, s)
    _export_double_conv(out, "bottleneck", params["bottleneck"], state["bottleneck"])
    for j, (up, p, s) in enumerate(zip(params["up"], params["dec"], state["dec"])):
        i = cfg.depth - j  # up4 first
        out[f"up{i}.weight"] = _array(up["weight"])
        out[f"up{i}.bias"] = _array(up["bias"])
        _export_double_conv(out, f"conv{i}", p, s)
    out["out_conv.weight"] = _array(params["out"]["weight"])
    out["out_conv.bias"] = _array(params["out"]["bias"])
    return out
