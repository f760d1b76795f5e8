"""Spatial (image-H) parallelism with explicit halo exchange
(``twinvoice_tpu.parallel.spatial``), on NCHW tensors.

For frames larger than one card would rather hold (camera frames above
512²), H is split over the mesh's ``spatial`` axis and each 3×3 conv first
takes its neighbours' border rows. JAX moves them with ``ppermute`` inside
``shard_map``; the port gathers every rank's edge rows with
``core.collectives.gather_from`` (an exact all-reduce into a zero buffer)
and keeps its two neighbours'. The training forward
(``models.unet.unet_apply(mesh=...)``) takes the same halo, with autograd.

An ``axis`` argument is a ``core.mesh.Axis`` (``mesh.axis("spatial")``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from twinvoice_tpu_torch.core.collectives import alone, gather_from
from twinvoice_tpu_torch.core.mesh import Mesh
from twinvoice_tpu_torch.ops.conv import conv2d, conv_transpose2x2, max_pool2


def halo_exchange_h(x, axis, halo: int = 1):
    """``halo`` rows from each H-neighbour around the local shard ``x``
    (N, C, H_local, W) → (N, C, H_local + 2·halo, W), zeros at the global
    edges: what a global pad-``halo`` conv sees. Differentiable: the
    gradient of the rows a neighbour took flows back to their owner."""
    if alone(axis):
        return F.pad(x, (0, 0, halo, halo))
    edges = torch.stack([x[:, :, :halo], x[:, :, -halo:]])    # my top, my bottom
    every = gather_from(edges, axis, 0, sum_grads=True)        # (2·size, N, C, halo, W)
    i = axis.index
    zeros = torch.zeros_like(edges[0])
    above = every[2 * i - 1] if i > 0 else zeros               # bottom rows of rank i−1
    below = every[2 * i + 2] if i < axis.size - 1 else zeros   # top rows of rank i+1
    return torch.cat([above, x, below], dim=2)


def _conv_w(x, p):
    """A 3×3 conv padded along W only: H already carries its halo."""
    return conv2d(x, p["weight"], p.get("bias"), padding=(0, 1))


def conv3x3_spatial(x, p, axis):
    """3×3 pad-1 conv on an H-sharded activation."""
    return _conv_w(halo_exchange_h(x, axis, halo=1), p)


def _edge_mask(h, axis):
    """Zero the context row above the first shard and below the last: a
    dense conv2 zero-pads its input there, it does not see relu(conv1(0))."""
    if axis.index == 0:
        h = torch.cat([torch.zeros_like(h[:, :, :1]), h[:, :, 1:]], dim=2)
    if axis.index == axis.size - 1:
        h = torch.cat([h[:, :, :-1], torch.zeros_like(h[:, :, -1:])], dim=2)
    return h


def _folded_double_conv_spatial(p, x, axis):
    """BN-folded DoubleConv (conv3×3+ReLU ×2) on an H-sharded activation.

    One halo-2 exchange feeds both convs: conv1 runs over the extended shard
    and emits one extra context row per side, which conv2 consumes; those
    rows are masked on the edge shards (:func:`_edge_mask`)."""
    xh = halo_exchange_h(x, axis, halo=2)                             # H+4 rows
    h = _edge_mask(torch.relu(_conv_w(xh, p["conv1"])), axis)          # H+2 rows
    return torch.relu(_conv_w(h, p["conv2"]))                          # H rows


def unet_apply_folded_spatial(folded, x, axis):
    """The BN-folded U-Net forward (``models.unet.unet_apply_folded``) on an
    H-sharded input ``x`` (N, Cin, H_local, W).

    Only the 3×3 convs reach across shards (one halo-2 exchange per
    DoubleConv); every other op is row-local: 2×2/s2 pool windows never
    straddle a shard boundary while the local H stays even (hence the
    precondition), the 2×2/s2 transpose conv maps input row i to output rows
    2i and 2i+1, skip connections pair rows of the same shard at every level,
    and the 1×1 out-conv is pointwise. Precondition: local H divisible by
    2^depth, i.e. global H divisible by shards · 2^depth."""
    depth = len(folded["enc"])
    if x.shape[2] % (1 << depth):
        raise ValueError(f"local H {x.shape[2]} not divisible by 2^{depth}; "
                         f"use a global H divisible by n_shards*2^depth")
    skips = []
    h = x
    for p in folded["enc"]:
        h = _folded_double_conv_spatial(p, h, axis)
        skips.append(h)
        h = max_pool2(h)
    h = _folded_double_conv_spatial(folded["bottleneck"], h, axis)
    for up_p, dec_p, skip in zip(folded["up"], folded["dec"], reversed(skips)):
        h = conv_transpose2x2(h, up_p)
        # concat-free decoder DoubleConv with a shared halo-2 schedule:
        # conv([up, skip], K1) == conv(up, K1[:, :C]) + conv(skip, K1[:, C:])
        c = h.shape[1]
        k1 = dec_p["conv1"]["weight"]
        part_up = _conv_w(halo_exchange_h(h, axis, halo=2),
                          {"weight": k1[:, :c], "bias": dec_p["conv1"]["bias"]})
        part_skip = _conv_w(halo_exchange_h(skip, axis, halo=2), {"weight": k1[:, c:]})
        g = _edge_mask(torch.relu(part_up + part_skip), axis)         # H+2 rows
        h = torch.relu(_conv_w(g, dec_p["conv2"]))                    # H rows
    return conv2d(h, folded["out"]["weight"], folded["out"]["bias"])


def _rows(x, axis):
    k = x.shape[2] // axis.size
    if k * axis.size != x.shape[2]:
        raise ValueError(f"H {x.shape[2]} is not divisible over {axis.size} shards")
    return x[:, :, axis.index * k:(axis.index + 1) * k]


def spatial_unet_forward(folded, x, mesh: Mesh, axis: str = "spatial"):
    """The folded U-Net on the full NCHW ``x`` (the same on every rank), H
    sharded over ``mesh``'s ``axis`` with explicit halo exchanges, params
    replicated. → the full logits on every rank, as JAX's ``shard_map``
    turns a global array into a global array."""
    ax = mesh.axis(axis)
    return gather_from(unet_apply_folded_spatial(folded, _rows(x, ax), ax), ax, 2)


def spatial_shard_apply(fn, mesh: Mesh, axis: str = "spatial"):
    """Wrap a per-shard function ``fn(x_shard, params)`` (NCHW, H sharded
    over ``axis``; use :func:`conv3x3_spatial` / :func:`halo_exchange_h`
    with ``mesh.axis(axis)`` inside it) into ``(x, params) → y`` on full
    tensors, on every rank."""
    ax = mesh.axis(axis)

    def apply(x, params):
        return gather_from(fn(_rows(x, ax), params), ax, 2)

    return apply
