"""The rank grid and its sharding rules (``twinvoice_tpu.core.mesh``), on
``torch.distributed``.

JAX lays a ``(data, model, spatial)`` mesh over its devices and XLA inserts
the collectives the shardings imply. The port lays the same grid over the
ranks of the default process group, in JAX's row-major device order, and
makes one process group for each line of each axis, which the collectives of
``core.collectives`` reduce over:

- ``data``    — batch rows. Gradients are summed over it.
- ``model``   — conv out-channel sharding: a rank holds a slice of each wide
  conv's out-channels, and the activation is gathered after the conv.
- ``spatial`` — image rows (H). 3×3 convs exchange halo rows with the
  neighbours (``parallel.spatial``).

and ``batch``, the data × spatial lines: the ranks that hold different parts
of the batch, over which BatchNorm's statistics, the loss and the gradients
are summed.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from twinvoice_tpu_torch.config import MeshConfig
from twinvoice_tpu_torch.core.collectives import gather_from

AXES = ("data", "model", "spatial")


@dataclass(frozen=True)
class Axis:
    """This rank's line along one axis of a :class:`Mesh`: its size, this
    rank's index on it, and its process group (``None`` where the line is
    one rank, or on a mesh laid out without a process group, whose
    collectives over more than one rank raise)."""

    name: str
    size: int
    index: int
    group: Any = None


class Mesh:
    """A grid of ``prod(sizes)`` ranks named ``names``, row-major
    (``devices`` holds the ranks in the grid's shape, as JAX's
    ``Mesh.devices`` holds devices). ``combined`` names further axes that
    span several of them, e.g. ``{"batch": ("data", "spatial")}``.

    With a default process group it must span the whole group, and every rank
    must build the same meshes in the same order: each line becomes a group
    (``dist.new_group``, which every rank calls for every line), a line that
    is the whole world the default group. Without one it is a layout only
    (rank 0; its axes have no group, and a collective over one of size > 1
    raises). ``timeout`` is the new groups' (``None``: the backend's
    default)."""

    def __init__(self, names, sizes, *, combined=None, timeout=None):
        self.axis_names = tuple(names)
        self.shape = dict(zip(self.axis_names, (int(s) for s in sizes)))
        self.world = int(np.prod(sizes))
        self.devices = np.arange(self.world).reshape(tuple(self.shape.values()))
        self.distributed = dist.is_available() and dist.is_initialized()
        if self.distributed and dist.get_world_size() != self.world:
            raise ValueError(f"mesh of {self.world} ranks over a process group of "
                             f"{dist.get_world_size()}")
        self.rank = dist.get_rank() if self.distributed else 0
        lines = {n: (n,) for n in self.axis_names}
        lines.update(combined or {})
        self._axes = {name: self._line(name, members, timeout)
                      for name, members in lines.items()}

    def _line(self, name, members, timeout):
        dims = [self.axis_names.index(m) for m in members]
        size = int(np.prod([self.devices.shape[d] for d in dims]))
        # one column per line: the member axes first, row-major within a line
        cols = np.moveaxis(self.devices, dims, range(len(dims))).reshape(size, -1)
        mine = None
        for line in cols.T.tolist():
            group = None
            if self.distributed and size > 1:
                group = (dist.group.WORLD if size == self.world
                         else dist.new_group(line, timeout=timeout))
            if self.rank in line:
                mine = Axis(name, size, line.index(self.rank), group)
        return mine

    def axis(self, name) -> Axis:
        return self._axes[name]


def parallel(mesh) -> bool:
    """Whether ``mesh`` spans more than one rank; ``None`` or a mesh of one
    rank takes the plain path."""
    return mesh is not None and mesh.world > 1


def mesh_shape(cfg: MeshConfig, world: int):
    """→ (data, model, spatial) for ``world`` ranks; ``data=-1`` takes what
    the other two leave."""
    model, spatial = cfg.model, cfg.spatial
    data = cfg.data if cfg.data > 0 else world // (model * spatial)
    if data * model * spatial != world:
        raise ValueError(f"mesh {data}x{model}x{spatial} != {world} devices")
    return data, model, spatial


def make_mesh(cfg: MeshConfig = MeshConfig(), world=None, *, timeout=None) -> Mesh:
    """The (data, model, spatial) grid over the default process group (or,
    without one, the layout of ``world`` ranks, default 1), with its
    ``batch`` axis (data × spatial)."""
    if world is None:
        world = dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1
    return Mesh(AXES, mesh_shape(cfg, world), combined={"batch": ("data", "spatial")},
                timeout=timeout)


def batch_sharding(mesh: Mesh, n, h):
    """Which of a global batch's ``n`` images and ``h`` rows this rank holds
    (JAX's ``P("data", "spatial", None, None)``): → (row slice, H slice)."""
    out = []
    for name, size in (("data", n), ("spatial", h)):
        ax = mesh.axis(name)
        if size % ax.size:
            raise ValueError(f"{size} is not divisible over the {ax.size} ranks of {name!r}")
        k = size // ax.size
        out.append(slice(ax.index * k, (ax.index + 1) * k))
    return tuple(out)


def shard_batch(x, mesh: Mesh, h_dim=2):
    """This rank's block of a global batch ``x`` (a tensor or array; images
    along dim 0, rows along ``h_dim``: 2 for NCHW, 1 for NHWC)."""
    rows, hrows = batch_sharding(mesh, x.shape[0], x.shape[h_dim])
    return x[rows][(slice(None),) * h_dim + (hrows,)]


# -- parameter sharding ---------------------------------------------------------


def _co_dim(path, shape):
    """The out-channel dim of a leaf of the port's U-Net trees (params, BN
    state, optimizer moments): dim 0 of a conv weight (Co,Ci,kH,kW) and of a
    vector, dim 1 of a transpose conv's weight (Ci,Co,2,2), under ``up``."""
    if len(shape) == 4:
        return 1 if "up" in path else 0
    return 0 if len(shape) == 1 else None


def _spec_for(shape, axis_size, co_dim):
    """Sharding rule for one leaf (JAX ``core/mesh.py:_spec_for``): shard the
    out-channel dim over ``model`` when it divides and is at least twice the
    axis; otherwise replicate. → a tuple of axis names per dim, ``()`` for
    replicated."""
    if co_dim is None:
        return ()
    co = shape[co_dim]
    if co % axis_size == 0 and co >= 2 * axis_size:
        return tuple("model" if d == co_dim else None for d in range(len(shape)))
    return ()


def _map_path(fn, tree, path=()):
    """``fn(path, leaf)`` over a tree, dict keys in sorted order (the order
    of a gather's collectives, the same on every rank)."""
    if isinstance(tree, dict):
        return {k: _map_path(fn, tree[k], path + (k,)) for k in sorted(tree)}
    if isinstance(tree, list):
        return [_map_path(fn, v, path + (i,)) for i, v in enumerate(tree)]
    return fn(path, tree)


def param_shardings(mesh: Mesh, params):
    """Tree of specs (:func:`_spec_for`) for a params, BN-state or moments
    tree of the port's layouts, leaves the full tensors."""
    m = mesh.shape["model"]
    return _map_path(lambda path, a: () if m == 1 else
                     _spec_for(tuple(a.shape), m, _co_dim(path, tuple(a.shape))), params)


def model_sharded(mesh: Mesh, co) -> bool:
    """Whether a layer with ``co`` out-channels is sharded over ``model``."""
    m = mesh.shape["model"]
    return m > 1 and bool(_spec_for((co,), m, 0))


def shard_leaf(t, spec, mesh: Mesh):
    """This rank's slice (a contiguous copy) of the full tensor ``t``."""
    if not spec:
        return t
    ax, d = mesh.axis("model"), spec.index("model")
    k = t.shape[d] // ax.size
    return t.narrow(d, ax.index * k, k).contiguous()


def gather_leaf(t, spec, mesh: Mesh):
    """The full tensor of this rank's slice ``t`` (a collective over
    ``model``: every rank of the line calls it), outside autograd."""
    t = t.detach()
    if not spec:
        return t
    with torch.no_grad():
        return gather_from(t, mesh.axis("model"), spec.index("model"))


def shard_tree(tree, mesh: Mesh, specs):
    """:func:`shard_leaf` of every leaf (``specs``: :func:`param_shardings`
    of the full tree)."""
    return _map_path(lambda path, t: shard_leaf(t, _get(specs, path), mesh), tree)


def gather_tree(tree, mesh: Mesh, specs):
    """:func:`gather_leaf` of every leaf, in a fixed order on every rank."""
    return _map_path(lambda path, t: gather_leaf(t, _get(specs, path), mesh), tree)


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree
