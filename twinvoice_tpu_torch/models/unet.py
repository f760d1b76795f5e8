"""The config-driven U-Net field segmenter (``twinvoice_tpu.models.unet``),
NCHW.

``init_unet`` returns ``(params, state)`` trees (state = BatchNorm running
statistics) and ``unet_apply(params, state, x, train=...)`` returns
``(logits, new_state)``: the training forward, with train- or eval-mode
BatchNorm. For serving, ``fold_unet`` folds every eval-mode BatchNorm into the
conv before it, once, and ``unet_apply_folded`` runs the conv+ReLU graph with
the concat-free split decoder. Parameters are the torch-layout trees of
``weights.from_jax_params``. Defaults give the reference's
31,043,651-parameter 3→3 class model.

``unet_apply(mesh=...)`` is the sharded training forward that XLA derives for
the JAX step from its shardings (``core.mesh``): each rank runs its block of
the batch, with the slices of the model-sharded layers it holds.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from twinvoice_tpu_torch import resolve_device
from twinvoice_tpu_torch.config import UNetConfig
from twinvoice_tpu_torch.core.collectives import copy_to, gather_from
from twinvoice_tpu_torch.core.mesh import model_sharded, parallel
from twinvoice_tpu_torch.ops.conv import (
    conv1x1,
    conv2d,
    conv3x3,
    conv_transpose2x2,
    init_conv,
    init_conv_transpose,
    max_pool2,
)
from twinvoice_tpu_torch.ops.norm import (
    batchnorm_apply,
    fold_batchnorm_into_conv,
    init_batchnorm,
)
from twinvoice_tpu_torch.parallel.spatial import halo_exchange_h

# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def _init_double_conv(generator, cin, cout, dtype, device):
    bn1_p, bn1_s = init_batchnorm(cout, dtype=dtype, device=device)
    bn2_p, bn2_s = init_batchnorm(cout, dtype=dtype, device=device)
    params = {
        "conv1": init_conv(generator, 3, 3, cin, cout, dtype=dtype, device=device),
        "bn1": bn1_p,
        "conv2": init_conv(generator, 3, 3, cout, cout, dtype=dtype, device=device),
        "bn2": bn2_p,
    }
    return params, {"bn1": bn1_s, "bn2": bn2_s}


def init_unet(generator, cfg: UNetConfig = UNetConfig(), *, dtype=torch.float32,
              device=None):
    """Returns ``(params, state)`` trees on ``device`` (``None`` means the
    card), drawn from the CPU ``torch.Generator`` ``generator``."""
    device = resolve_device(device)
    widths = cfg.encoder_widths()
    params = {"enc": [], "dec": [], "up": []}
    state = {"enc": [], "dec": []}

    cin = cfg.in_channels
    for wdt in widths:
        p, s = _init_double_conv(generator, cin, wdt, dtype, device)
        params["enc"].append(p)
        state["enc"].append(s)
        cin = wdt

    bw = cfg.bottleneck_width()
    params["bottleneck"], state["bottleneck"] = _init_double_conv(
        generator, widths[-1], bw, dtype, device)

    up_in = bw
    for wdt in reversed(widths):
        params["up"].append(init_conv_transpose(generator, up_in, wdt, dtype=dtype,
                                                device=device))
        p, s = _init_double_conv(generator, 2 * wdt, wdt, dtype, device)
        params["dec"].append(p)
        state["dec"].append(s)
        up_in = wdt

    params["out"] = init_conv(generator, 1, 1, widths[0], cfg.num_classes, dtype=dtype,
                              device=device, bias_init=cfg.out_bias_init)
    return params, state


# ---------------------------------------------------------------------------
# apply
# ---------------------------------------------------------------------------


class _Sharded:
    """How one rank runs the layers of the sharded forward on a mesh.

    A layer whose out-channels are sharded over ``model`` (``core.mesh``'s
    rule) takes its input through ``copy_to`` (its input gradient is partial
    on each rank), computes its slice of the channels (BatchNorm on them,
    statistics over the ``batch`` axis) and gathers them after its ReLU. A 3×3
    conv over H-sharded rows first takes a halo row from each neighbour.
    Pooling, the transpose conv and the skip concat are row-local."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.model, self.spatial = mesh.axis("model"), mesh.axis("spatial")
        self.batch = mesh.axis("batch")

    def sharded(self, co):
        return model_sharded(self.mesh, co)

    def conv(self, x, p, co, k):
        pad = 0
        if k == 3:
            x, pad = halo_exchange_h(x, self.spatial, 1), (0, 1)
        if self.sharded(co):
            x = copy_to(x, self.model)
        return conv2d(x, p["weight"], p.get("bias"), padding=pad)

    def gather(self, x, co):
        return gather_from(x, self.model, 1) if self.sharded(co) else x

    def up(self, x, p, co):
        if self.sharded(co):
            x = copy_to(x, self.model)
        return self.gather(conv_transpose2x2(x, p), co)


def _double_conv(p, s, x, *, train, momentum, eps, fast_norm, par=None, co=None):
    def conv(x, cp):
        return conv3x3(x, cp) if par is None else par.conv(x, cp, co, 3)

    group = None if par is None else par.batch
    x = conv(x, p["conv1"])
    x, s1 = batchnorm_apply(x, p["bn1"], s["bn1"], train=train, momentum=momentum,
                            eps=eps, norm_in_compute_dtype=fast_norm, group=group)
    x = torch.relu(x)
    if par is not None:
        x = par.gather(x, co)
    x = conv(x, p["conv2"])
    x, s2 = batchnorm_apply(x, p["bn2"], s["bn2"], train=train, momentum=momentum,
                            eps=eps, norm_in_compute_dtype=fast_norm, group=group)
    x = torch.relu(x)
    if par is not None:
        x = par.gather(x, co)
    return x, {"bn1": s1, "bn2": s2}


def unet_apply(params, state, x, *, cfg: UNetConfig = UNetConfig(), train=False,
               remat=False, fast_norm=False, mesh=None):
    """Forward pass. ``x``: (N,Cin,H,W) with H, W divisible by 2^depth.

    Returns ``(logits (N,num_classes,H,W) in x's dtype, new_state)``.

    ``mesh`` (a ``core.mesh.Mesh`` of more than one rank): ``x`` is this
    rank's block of the global batch (``core.mesh.shard_batch``), its local H
    divisible by 2^depth, and ``params``/``state`` this rank's slices
    (``core.mesh.shard_tree``); the logits are this rank's block, the new
    state its slices. With ``mesh=None`` or a mesh of one rank, the path is
    the plain one.

    ``remat=True`` runs every DoubleConv under ``torch.utils.checkpoint``:
    the backward pass recomputes the block's insides instead of keeping them
    live. The recompute runs BatchNorm again; that is safe because
    ``batchnorm_apply`` only returns statistics and writes none.

    ``fast_norm=True`` runs the BN normalise in the activation dtype (the
    statistics stay float32).
    """
    mom, eps = cfg.bn_momentum, cfg.bn_eps
    par = _Sharded(mesh) if parallel(mesh) else None

    def dc(p, s, h, co):
        kw = dict(train=train, momentum=mom, eps=eps, fast_norm=fast_norm, par=par, co=co)
        if remat:
            return checkpoint(_double_conv, p, s, h, use_reentrant=False, **kw)
        return _double_conv(p, s, h, **kw)

    widths = cfg.encoder_widths()
    new_state = {"enc": [], "dec": []}
    skips = []
    h = x
    for p, s, w in zip(params["enc"], state["enc"], widths):
        h, ns = dc(p, s, h, w)
        new_state["enc"].append(ns)
        skips.append(h)
        h = max_pool2(h)

    h, new_state["bottleneck"] = dc(params["bottleneck"], state["bottleneck"], h,
                                    cfg.bottleneck_width())

    for up_p, dec_p, dec_s, skip, w in zip(
        params["up"], params["dec"], state["dec"], reversed(skips), reversed(widths)
    ):
        h = conv_transpose2x2(h, up_p) if par is None else par.up(h, up_p, w)
        h = torch.cat([h, skip], dim=1)  # [upsampled, skip]: torch's cat order
        h, ns = dc(dec_p, dec_s, h, w)
        new_state["dec"].append(ns)

    if par is None:
        return conv1x1(h, params["out"]), new_state
    co = cfg.num_classes
    return par.gather(par.conv(h, params["out"], co, 1), co), new_state


def param_count(params) -> int:
    return sum(int(a.numel()) for a in tree_leaves(params))


def tree_leaves(tree):
    """The tensors of a params/state tree, in a fixed order: dict keys sorted
    (as JAX flattens a dict), then list order. So two trees with the same
    keys give their leaves in the same order whatever order their dicts were
    built in (``init_unet``'s and ``weights.load_npz``'s differ), which the
    optimizer's and the checkpoint's leaf indices rely on."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in tree_leaves(tree[k])]
    if isinstance(tree, list):
        return [t for v in tree for t in tree_leaves(v)]
    return [tree]


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
        h = conv_transpose2x2(h, up_p)
        c = h.shape[1]
        k1 = dec_p["conv1"]["weight"]
        part_up = conv3x3(h, {"weight": k1[:, :c], "bias": dec_p["conv1"]["bias"]})
        part_skip = conv3x3(skip, {"weight": k1[:, c:]})
        h = torch.relu(part_up + part_skip)
        h = torch.relu(conv3x3(h, dec_p["conv2"]))
    return conv1x1(h, folded["out"])
