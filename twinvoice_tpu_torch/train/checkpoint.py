"""Checkpoint and resume (``twinvoice_tpu.train.checkpoint``).

The whole train state (params, BatchNorm state, the optimizer's
``state_dict``, epoch, best loss) goes into one ``torch.save`` file in a
directory and comes back with ``torch.load(weights_only=True)``. The
weights-only npz is the JAX package's format: ``save_params_npz`` writes its
``keystr`` layout (the JAX ``load_params_npz`` reads it), and
``load_params_npz`` is ``weights.load_npz``.

A checkpoint always holds the whole tree: ``trainer.fit(mesh=...)`` saves a
gathered state (``trainer.gather_train_state``), and ``restore`` into a
sharded template (``trainer.shard_train_state``) slices it again, so either
trainer resumes from the other's files.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from twinvoice_tpu_torch.core.mesh import shard_leaf, shard_tree
from twinvoice_tpu_torch.models.unet import _tree_map, tree_leaves
from twinvoice_tpu_torch.weights import keystr_items, load_npz, to_jax_params

_FILE = "train_state.pt"

load_params_npz = load_npz


def save(path, state):
    """Save a ``trainer.TrainState`` into the directory ``path`` (written to a
    temporary file first, then renamed, so a cut save leaves the old one)."""
    os.makedirs(path, exist_ok=True)
    payload = {
        "params": _tree_map(torch.Tensor.detach, state.params),
        "bn_state": _tree_map(torch.Tensor.detach, state.bn_state),
        "optimizer": state.optimizer.state_dict(),
        "meta": {"epoch": int(state.epoch), "best_loss": float(state.best_loss)},
    }
    tmp = os.path.join(path, _FILE + ".tmp")
    torch.save(payload, tmp)
    os.replace(tmp, os.path.join(path, _FILE))


def has_checkpoint(path) -> bool:
    return os.path.isfile(os.path.join(path, _FILE))


def map_optimizer_state(sd, fn):
    """An optimizer ``state_dict`` with each per-parameter tensor that is not
    a scalar (moments, momentum buffers) replaced by ``fn(index, tensor)``."""
    state = {i: {k: fn(i, v) if torch.is_tensor(v) and v.dim() else v
                 for k, v in st.items()} for i, st in sd["state"].items()}
    return {"state": state, "param_groups": sd["param_groups"]}


def restore(path, state, mesh=None):
    """Restore into a template ``TrainState`` of the same structure: the
    params are copied into the template's tensors (the optimizer holds
    them), the BN state is replaced, the optimizer state loaded. A template
    sharded over ``mesh`` (its ``shardings`` set) gets this rank's slices."""
    got = torch.load(os.path.join(path, _FILE), map_location="cpu", weights_only=True)
    if state.shardings is not None:
        specs = state.shardings
        got["params"] = shard_tree(got["params"], mesh, specs["params"])
        got["bn_state"] = shard_tree(got["bn_state"], mesh, specs["bn_state"])
        leaf_specs = tree_leaves(specs["params"])
        got["optimizer"] = map_optimizer_state(
            got["optimizer"], lambda i, t: shard_leaf(t, leaf_specs[i], mesh))
    mine, saved = tree_leaves(state.params), tree_leaves(got["params"])
    if [t.shape for t in mine] != [t.shape for t in saved]:
        raise ValueError(f"checkpoint {path} does not match the model")
    with torch.no_grad():
        for dst, src in zip(mine, saved):
            dst.copy_(src)
    state.bn_state = _tree_map(lambda t: t.to(mine[0].device), got["bn_state"])
    state.optimizer.load_state_dict(got["optimizer"])
    state.epoch = int(got["meta"]["epoch"])
    state.best_loss = float(got["meta"]["best_loss"])
    return state


def save_params_npz(path, params, state):
    """Portable flat-npz weights in the JAX package's layout and key names
    (``p/`` + ``keystr`` for params, ``s/`` for BN state)."""
    jp, js = to_jax_params(params, state)
    flat = {}
    for prefix, tree in (("p", jp), ("s", js)):
        for key, leaf in keystr_items(tree):
            flat[prefix + "/" + key] = leaf
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez_compressed(path, **flat)
