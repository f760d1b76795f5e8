"""Checkpoint and resume (``twinvoice_tpu.train.checkpoint``).

The whole train state (params, BatchNorm state, the optimizer's
``state_dict``, epoch, best loss) goes into one ``torch.save`` file in a
directory and comes back with ``torch.load(weights_only=True)``. The
weights-only npz is the JAX package's format: ``save_params_npz`` writes its
``keystr`` layout (the JAX ``load_params_npz`` reads it), and
``load_params_npz`` is ``weights.load_npz``.

``save_params``/``restore_params`` are the weights-only pair of the JAX
package's orbax ``save_params``/``restore_params``, in the port's own format:
one ``torch.save`` file of ``{"params", "bn_state"}`` in a directory.

``restore`` and ``restore_params`` also read the JAX package's Orbax
directories (``twinvoice_tpu.train.checkpoint.save``: ``fit``'s ``best`` and
``latest``; ``save_params``) through ``train/orbax.py``, which needs neither
orbax nor TensorStore nor ``zstandard``; so a run trained with the JAX
package resumes (``fit(resume_dir=...)``, the CLI's ``train --resume``) and
serves (``Segmenter.from_checkpoint``, ``compat.load_model``, the app) here.
The optax ``inject_hyperparams(adamw)`` state maps into the template's
``torch.optim.AdamW`` (:func:`optimizer_state_from_optax`). Writing Orbax is
not done here: the port saves its own format, and weights go back to the JAX
package as the npz of ``save_params_npz``.

A checkpoint always holds the whole tree: ``trainer.fit(mesh=...)`` saves a
gathered state (``trainer.gather_train_state``), and ``restore`` into a
sharded template (``trainer.shard_train_state``) slices it again, so either
trainer resumes from the other's files.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from twinvoice_tpu_torch.config import UNetConfig
from twinvoice_tpu_torch.core.mesh import shard_leaf, shard_tree
from twinvoice_tpu_torch.models.unet import _tree_map, tree_leaves
from twinvoice_tpu_torch.train import orbax
from twinvoice_tpu_torch.weights import from_jax_params, keystr_items, load_npz, to_jax_params

_FILE = "train_state.pt"
_PARAMS_FILE = "params.pt"

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
    """Any non-empty directory, as the JAX package's rule: the port's own
    files or an Orbax directory, which :func:`restore` reads, or anything
    else, which :func:`restore` refuses (so ``fit`` never quietly starts
    from scratch on a directory it cannot read)."""
    return os.path.isdir(path) and bool(os.listdir(path))


def map_optimizer_state(sd, fn):
    """An optimizer ``state_dict`` with each per-parameter tensor that is not
    a scalar (moments, momentum buffers) replaced by ``fn(index, tensor)``."""
    state = {i: {k: fn(i, v) if torch.is_tensor(v) and v.dim() else v
                 for k, v in st.items()} for i, st in sd["state"].items()}
    return {"state": state, "param_groups": sd["param_groups"]}


def _unknown(path):
    return ValueError(f"{path} holds no checkpoint the port reads: neither {_FILE} nor "
                      f"{_PARAMS_FILE} nor an Orbax directory ({orbax.METADATA}); "
                      f"it has {sorted(os.listdir(path))[:8]}")


def optimizer_state_from_optax(opt_state, bn_state, state):
    """The optax ``inject_hyperparams(adamw)`` state of a JAX train state
    (``twinvoice_tpu.train.trainer.make_optimizer``), as ``train/orbax.py``
    reads it, → a ``state_dict`` for the template ``TrainState``'s optimizer
    (the port's AdamW over ``tree_leaves(params)``): ``inner_state[0]``'s
    ``count`` becomes each leaf's ``step``, ``mu`` and ``nu`` in the params'
    torch layouts its ``exp_avg`` and ``exp_avg_sq``, matched to the
    template's leaves by name; the injected ``learning_rate`` becomes each
    group's ``lr``. Raises where ``b1``, ``b2``, ``eps``, ``eps_root`` or
    ``weight_decay`` differ from the optimizer's own."""
    hp, adam = opt_state["hyperparams"], opt_state["inner_state"][0]
    mu = dict(keystr_items(from_jax_params(adam["mu"], bn_state)[0]))
    nu = dict(keystr_items(from_jax_params(adam["nu"], bn_state)[0]))
    names = {id(t): k for k, t in keystr_items(state.params)}
    step = torch.tensor(float(adam["count"]), dtype=torch.float32)
    sd = state.optimizer.state_dict()
    moments, index = {}, 0
    for group, saved in zip(state.optimizer.param_groups, sd["param_groups"]):
        b1, b2 = group["betas"]
        for name, mine in (("b1", b1), ("b2", b2), ("eps", group["eps"]), ("eps_root", 0.0),
                           ("weight_decay", group["weight_decay"])):
            if name in hp and np.float32(hp[name]) != np.float32(mine):
                raise ValueError(f"the checkpoint's optax {name} is {float(hp[name])}, the "
                                 f"optimizer's {mine}")
        saved["lr"] = float(hp["learning_rate"])
        for p in group["params"]:
            name = names[id(p)]
            moments[index] = {"step": step.clone(), "exp_avg": mu[name],
                              "exp_avg_sq": nu[name]}
            index += 1
    return {"state": moments, "param_groups": sd["param_groups"]}


def _from_orbax_state(path, state):
    """A JAX ``TrainState`` Orbax directory → what ``torch.load`` of the
    port's own file gives."""
    tree = orbax.read(path)
    missing = {"params", "bn_state", "opt_state", "meta"} - set(tree)
    if missing:
        raise ValueError(f"{path} is an Orbax directory but no JAX train state "
                         f"(it lacks {sorted(missing)}): a save_params directory "
                         "serves (restore_params) but does not resume")
    params, bn_state = from_jax_params(tree["params"], tree["bn_state"])
    return {"params": params, "bn_state": bn_state,
            "optimizer": optimizer_state_from_optax(tree["opt_state"], tree["bn_state"], state),
            "meta": {"epoch": int(tree["meta"]["epoch"]),
                     "best_loss": float(tree["meta"]["best_loss"])}}


def _load_state(path, state):
    if os.path.isfile(os.path.join(path, _FILE)):
        return torch.load(os.path.join(path, _FILE), map_location="cpu", weights_only=True)
    if orbax.is_checkpoint(path):
        return _from_orbax_state(path, state)
    raise _unknown(path)


def restore(path, state, mesh=None):
    """Restore into a template ``TrainState`` of the same structure, from the
    port's own checkpoint or the JAX package's Orbax one (module doc): the
    params are copied into the template's tensors (the optimizer holds
    them), the BN state is replaced, the optimizer state loaded. A template
    sharded over ``mesh`` (its ``shardings`` set) gets this rank's slices.
    A directory of neither kind raises."""
    got = _load_state(path, state)
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


def save_params(path, params, bn_state):
    """Weights-only checkpoint (the serving artifact) in the directory
    ``path``: ``params.pt``, written to a temporary file first, then
    renamed."""
    os.makedirs(path, exist_ok=True)
    payload = {"params": _tree_map(lambda t: t.detach().cpu(), params),
               "bn_state": _tree_map(lambda t: t.detach().cpu(), bn_state)}
    tmp = os.path.join(path, _PARAMS_FILE + ".tmp")
    torch.save(payload, tmp)
    os.replace(tmp, os.path.join(path, _PARAMS_FILE))


def restore_params(path, cfg: UNetConfig = UNetConfig()):
    """→ ``(params, bn_state)`` on the CPU from a :func:`save_params`
    directory, or from a :func:`save` directory (``fit``'s ``best`` and
    ``latest``), whose file holds the same two trees, or from either kind of
    the JAX package's Orbax directories (module doc). Raises when the
    weights are not ``cfg``'s architecture, or the directory is of no known
    kind."""
    if os.path.isfile(os.path.join(path, _PARAMS_FILE)) or os.path.isfile(os.path.join(path, _FILE)):
        name = _PARAMS_FILE if os.path.isfile(os.path.join(path, _PARAMS_FILE)) else _FILE
        got = torch.load(os.path.join(path, name), map_location="cpu", weights_only=True)
        params, bn_state = got["params"], got["bn_state"]
    elif orbax.is_checkpoint(path):
        tree = orbax.read(path, top=("params", "bn_state"))
        if set(tree) != {"params", "bn_state"}:
            raise ValueError(f"{path} is an Orbax directory without params and bn_state")
        params, bn_state = from_jax_params(tree["params"], tree["bn_state"])
    else:
        raise _unknown(path)
    widths = tuple(int(p["conv1"]["weight"].shape[0]) for p in params["enc"])
    if (widths != cfg.encoder_widths()
            or int(params["enc"][0]["conv1"]["weight"].shape[1]) != cfg.in_channels
            or int(params["out"]["weight"].shape[0]) != cfg.num_classes):
        raise ValueError(f"checkpoint {path} (encoder widths {widths}) does not "
                         f"match {cfg}")
    return params, bn_state
