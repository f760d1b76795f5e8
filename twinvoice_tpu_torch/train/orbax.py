"""Orbax PyTree checkpoint directories read without orbax, TensorStore or
``zstandard``: what ``twinvoice_tpu.train.checkpoint.save`` and
``save_params`` write (``ocp.PyTreeCheckpointer().save``), read back as
``ocp.PyTreeCheckpointer().restore`` would, into nested dicts and lists of
numpy arrays in the JAX package's layout.

- ``_METADATA`` (JSON): ``tree_metadata`` gives each leaf's path (its
  ``key_metadata``: key type 1 a sequence index, 2 a dict key) and
  ``value_type``; leaves that orbax skips (empty dicts, lists and tuples,
  ``None``, optax's ``EmptyState``) come back as ``{}``, ``[]``, ``()`` and
  ``None``, and ``scalar`` leaves as Python scalars, as orbax restores
  them. ``use_ocdbt`` must be true and ``use_zarr3`` false, which is how the
  JAX package writes: other layouts raise ``ValueError`` naming what was
  found.
- Each array leaf is a zarr v2 array in the directory's OCDBT store
  (``train/ocdbt.py``) under its path joined with ``.``: ``<name>/.zarray``
  and its chunks ``<name>/<i>.<j>...`` (``0`` for a 0-d leaf), each zstd
  (``ops/host_zstd``) or uncompressed, assembled in C order; a chunk that is
  absent reads as the fill value (zero where it is ``null``), since orbax
  may leave out chunks equal to it.
- Dtypes: ``<f4``, ``<f8``, ``<i4``, ``<i8``, ``|b1`` as numpy arrays and
  ``bfloat16`` as a torch bfloat16 tensor (numpy has no bfloat16); any other
  raises.

Writing Orbax is not done here: the port saves its own ``torch.save``
checkpoints, and weights go back to the JAX package as the npz of
``checkpoint.save_params_npz``.
"""

from __future__ import annotations

import json
import math
import os

import numpy as np
import torch

from twinvoice_tpu_torch.ops.host_zstd import decompress
from twinvoice_tpu_torch.train.ocdbt import OcdbtStore

METADATA = "_METADATA"
DTYPES = {"<f4": np.float32, "<f8": np.float64, "<i4": np.int32, "<i8": np.int64,
          "|b1": np.bool_, "bfloat16": np.uint16}
ARRAY_TYPES = ("np.ndarray", "jax.Array", "scalar")
EMPTY = {"Dict": dict, "List": list, "Tuple": tuple, "None": lambda: None}


def is_checkpoint(path) -> bool:
    """Whether ``path`` is an Orbax PyTree checkpoint directory (it holds
    ``_METADATA``)."""
    return os.path.isfile(os.path.join(path, METADATA))


def read_metadata(path) -> dict:
    """``_METADATA`` of the checkpoint ``path``, after checking that its
    layout is the one read here."""
    with open(os.path.join(path, METADATA)) as f:
        meta = json.load(f)
    if not meta.get("use_ocdbt", False):
        raise ValueError(f"{path}: use_ocdbt is {meta.get('use_ocdbt')!r}; only the "
                         "OCDBT layout (orbax's default) is read")
    if meta.get("use_zarr3", False):
        raise ValueError(f"{path}: use_zarr3 is {meta['use_zarr3']!r}; only zarr v2 "
                         "(orbax's default) is read")
    return meta


def _path(entry):
    keys = []
    for k in entry["key_metadata"]:
        if k["key_type"] == 1:
            keys.append(int(k["key"]))
        elif k["key_type"] == 2:
            keys.append(str(k["key"]))
        else:
            raise ValueError(f"unknown key type {k['key_type']} in {entry['key_metadata']}")
    return keys


def read_zarr(store: OcdbtStore, name: str):
    """The zarr v2 array ``name`` of ``store`` → a numpy array (a torch
    bfloat16 tensor for ``bfloat16``)."""
    meta = json.loads(store.read(f"{name}/.zarray"))
    dtype = DTYPES.get(meta["dtype"])
    if dtype is None:
        raise ValueError(f"{name}: dtype {meta['dtype']!r} is not one the JAX package saves "
                         f"({', '.join(DTYPES)})")
    if meta.get("zarr_format") != 2 or meta.get("order", "C") != "C" or meta.get("filters"):
        raise ValueError(f"{name}: zarr format {meta.get('zarr_format')}, order "
                         f"{meta.get('order')}, filters {meta.get('filters')}: only v2, C "
                         "order without filters is read")
    comp = meta.get("compressor")
    if comp is not None and comp.get("id") != "zstd":
        raise ValueError(f"{name}: compressor {comp!r}; only zstd or none is read")
    shape, chunks = tuple(meta["shape"]), tuple(meta["chunks"])
    sep = meta.get("dimension_separator", ".")
    fill = meta.get("fill_value")
    out = np.full(shape, 0 if fill is None else fill, dtype)
    grid = [math.ceil(s / c) if c else 0 for s, c in zip(shape, chunks)]
    nbytes = math.prod(chunks) * np.dtype(dtype).itemsize
    for idx in np.ndindex(*grid):
        key = f"{name}/{sep.join(map(str, idx)) if idx else '0'}"
        if key not in store:
            continue  # a chunk equal to the fill value
        raw = store.read(key)
        if comp is not None:
            raw = decompress(raw, max_out=nbytes)
        if len(raw) != nbytes:
            raise ValueError(f"{key}: {len(raw)} bytes, a chunk of {chunks} {meta['dtype']} "
                             f"is {nbytes}")
        block = np.frombuffer(raw, dtype).reshape(chunks)
        sl = tuple(slice(i * c, min((i + 1) * c, s)) for i, c, s in zip(idx, chunks, shape))
        out[sl] = block[tuple(slice(0, s.stop - s.start) for s in sl)]
    if meta["dtype"] == "bfloat16":
        return torch.from_numpy(out.view(np.int16)).view(torch.bfloat16)
    return out


def _insert(tree, path, leaf):
    node = tree
    for key in path[:-1]:
        node = node.setdefault(key, {})
    node[path[-1]] = leaf


def _lists(node):
    """Dicts keyed by the sequence indices 0..n-1 become lists."""
    if not isinstance(node, dict):
        return node
    out = {k: _lists(v) for k, v in node.items()}
    if out and all(isinstance(k, int) for k in out):
        if sorted(out) != list(range(len(out))):
            raise ValueError(f"sequence indices with gaps: {sorted(out)}")
        return [out[i] for i in range(len(out))]
    return out


def read(path, top=None):
    """The PyTree checkpoint directory ``path`` → its tree (module doc).
    ``top``: only the leaves under these top-level keys (e.g. ``("params",
    "bn_state")`` of a train state)."""
    path = os.fspath(path)
    meta = read_metadata(path)
    store = OcdbtStore(path)
    tree = {}
    for entry in meta["tree_metadata"].values():
        keys = _path(entry)
        if top is not None and keys[0] not in top:
            continue
        kind = entry["value_metadata"]["value_type"]
        if kind in ARRAY_TYPES:
            leaf = read_zarr(store, ".".join(map(str, keys)))
            if kind == "scalar":  # orbax restores these as Python scalars
                leaf = leaf.item()
        elif kind in EMPTY:
            leaf = EMPTY[kind]()
        else:
            raise ValueError(f"{path}: leaf {keys} has value type {kind!r}")
        _insert(tree, keys, leaf)
    return _lists(tree)
