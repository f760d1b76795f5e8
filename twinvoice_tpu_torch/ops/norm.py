"""BatchNorm in train and eval mode, and inference-time BatchNorm folding
(``twinvoice_tpu.ops.norm``), on NCHW tensors.

torch ``BatchNorm2d`` semantics (eps 1e-5, momentum 0.1, affine, running
statistics): train mode normalises with the *biased* batch variance and
updates the running variance with the *unbiased* one (Bessel n/(n−1)),
``running = (1−m)·running + m·batch``; eval mode normalises with the running
statistics.
"""

from __future__ import annotations

import torch

from twinvoice_tpu_torch.core.collectives import alone, sum_over


def init_batchnorm(c, *, dtype=torch.float32, device=None):
    params = {"scale": torch.ones(c, dtype=dtype, device=device),
              "bias": torch.zeros(c, dtype=dtype, device=device)}
    state = {"mean": torch.zeros(c, dtype=dtype, device=device),
             "var": torch.ones(c, dtype=dtype, device=device)}
    return params, state


def batchnorm_apply(x, params, state, *, train, momentum=0.1, eps=1e-5,
                    norm_in_compute_dtype=False, group=None):
    """Returns ``(y, new_state)``; ``x`` is NCHW, statistics reduce over
    (N, H, W). Functional: ``state`` is never written, the new running
    statistics are returned (detached from the graph), so a recomputed
    forward (``unet_apply(remat=True)``) counts each step's statistics once.

    The batch variance is E[x²] − E[x]² in float32, as the JAX package takes
    it (``torch.var`` and ``F.batch_norm`` are two-pass and round
    differently). ``norm_in_compute_dtype``: the statistics stay float32, but
    the normalise itself runs in ``x.dtype`` (bf16 training: no float32
    copy of the activation).

    ``group``: a ``core.mesh.Axis`` over whose ranks the batch is split (the
    mesh's ``batch`` axis). The statistics are then the global batch's, as
    XLA's SPMD takes them in the JAX step: Σx and Σx² summed over the ranks
    (``core.collectives.sum_over``), divided by the global count.
    """
    scale, bias = params["scale"], params["bias"]
    if train:
        x32 = x.to(torch.float32)
        n = x.shape[0] * x.shape[2] * x.shape[3]
        if group is None or alone(group):
            mean = torch.mean(x32, dim=(0, 2, 3))
            var = torch.mean(torch.square(x32), dim=(0, 2, 3)) - torch.square(mean)
        else:
            n *= group.size
            sums = sum_over(torch.stack([torch.sum(x32, dim=(0, 2, 3)),
                                         torch.sum(torch.square(x32), dim=(0, 2, 3))]), group)
            mean = sums[0] / n
            var = sums[1] / n - torch.square(mean)
        with torch.no_grad():
            unbiased = var * (n / max(n - 1, 1))
            new_state = {
                "mean": (1 - momentum) * state["mean"] + momentum * mean,
                "var": (1 - momentum) * state["var"] + momentum * unbiased,
            }
    else:
        mean, var = state["mean"], state["var"]
        new_state = state
    inv = scale.to(torch.float32) / torch.sqrt(var.to(torch.float32) + eps)
    if norm_in_compute_dtype and x.dtype != torch.float32:
        dt = x.dtype
        y = ((x - mean.to(dt)[:, None, None]) * inv.to(dt)[:, None, None]
             + bias.to(dt)[:, None, None])
        return y, new_state
    y = ((x.to(torch.float32) - mean[:, None, None]) * inv[:, None, None]
         + bias.to(torch.float32)[:, None, None])
    return y.to(x.dtype), new_state


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
