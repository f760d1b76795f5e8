"""Ranks of a gloo process group on the CPU for the port's parallel tests.

:func:`run_ranks` spawns N processes (``chip_smoke.run_ranks``:
``torch.multiprocessing``, ``spawn``), joins them into a gloo group over a
``file://`` store and runs one of this module's rank functions in each:
``fn(rank, world, *args) → result``. Each rank runs one intra-op thread
(several ranks share the test worker's cores), every collective has a
timeout, and the whole spawn a deadline past which every rank is killed and
the test fails, so a hung collective fails one test.

This module imports torch, numpy, the port and ``chip_smoke`` only: a
spawned rank never imports JAX (each checks it before returning). The rank
functions live here, not in a test module, because a spawned process imports
the module of the function it runs.
"""

from __future__ import annotations

import datetime
import os

import numpy as np
import torch

import chip_smoke
from twinvoice_tpu_torch.config import Config, MeshConfig, TrainConfig, UNetConfig
from twinvoice_tpu_torch.core.mesh import Mesh, make_mesh, shard_batch
from twinvoice_tpu_torch.data.dataset import synthetic_dataset
from twinvoice_tpu_torch.models.unet import fold_unet, tree_leaves
from twinvoice_tpu_torch.ops.conv import conv3x3
from twinvoice_tpu_torch.ops.norm import batchnorm_apply
from twinvoice_tpu_torch.parallel.pipeline import pipeline_apply, stack_stage_params
from twinvoice_tpu_torch.parallel.spatial import (
    conv3x3_spatial,
    spatial_shard_apply,
    spatial_unet_forward,
)
from twinvoice_tpu_torch.train import checkpoint as ckpt
from twinvoice_tpu_torch.train.trainer import (
    TrainState,
    fit,
    gather_train_state,
    make_optimizer,
    make_train_step,
    shard_train_state,
)
from twinvoice_tpu_torch.weights import from_jax_params, to_jax_params

# the whole spawn's: the 2-rank checks take ~10 s alone and ~70 s beside
# five busy test workers
DEADLINE_S = 180


def run_ranks(fn, world, tmp_path, *args, deadline=DEADLINE_S):
    """``fn(rank, world, *args)`` on ``world`` gloo ranks of one thread each
    (``chip_smoke.run_ranks``); → their results in rank order."""
    return chip_smoke.run_ranks(fn, world, os.path.join(str(tmp_path), f"ranks-{fn.__name__}"
                                                        f"-{world}"), args, deadline=deadline)


def _mesh(cfg):
    return make_mesh(cfg, timeout=datetime.timedelta(seconds=chip_smoke.PAR_TIMEOUT_S))


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(a, (0, 3, 1, 2))))


def _nhwc(t):
    return np.ascontiguousarray(t.detach().numpy().transpose(0, 2, 3, 1))


def _conv_params(p):
    """A JAX conv's params (numpy, HWIO kernel) in the port's layout."""
    return {"weight": torch.from_numpy(np.ascontiguousarray(p["kernel"].transpose(3, 2, 0, 1))),
            "bias": torch.from_numpy(p["bias"])}


# -- data, model and spatial parallel training ---------------------------------------


def sgd_state(tree):
    """A ``TrainState`` over the numpy JAX-layout ``tree`` (params, state)
    with SGD at lr 1e-3: its update is linear in the gradient, so a step's
    params show the gradients' sum."""
    params, state = from_jax_params(*tree)
    leaves = [t.requires_grad_() for t in tree_leaves(params)]
    return TrainState(params, state, torch.optim.SGD(leaves, lr=1e-3))


def sgd_step(tree, x, y, mesh=None, cfg=UNetConfig(base_width=4), remat=False):
    """One SGD step (lr 1e-3) from ``tree`` on the NHWC batch ``x``/``y``,
    on ``mesh`` (every rank) or alone. → (loss, params, state) in JAX's
    layout, whole on every rank."""
    state = sgd_state(tree)
    if mesh is not None:
        state = shard_train_state(state, mesh)
    step = make_train_step(cfg, TrainConfig(batch_size=x.shape[0], remat=remat),
                           device="cpu", mesh=mesh)
    state.params, state.bn_state, loss = step(state.params, state.bn_state, state.optimizer,
                                              _nchw(x), _nchw(y), 1e-3)
    if mesh is not None:
        state = gather_train_state(state, mesh)
    return (float(loss),) + to_jax_params(state.params, state.bn_state)


def _bn_stats(x, mesh):
    """BatchNorm's new running statistics of a random channel block of this
    rank's rows of ``x``: over the global batch (``group``) and over this
    rank's rows alone."""
    h = conv3x3(shard_batch(_nchw(x), mesh).contiguous(),
                {"weight": torch.linspace(-1, 1, 4 * 3 * 9).reshape(4, 3, 3, 3)})
    p = {"scale": torch.ones(4), "bias": torch.zeros(4)}
    s = {"mean": torch.zeros(4), "var": torch.ones(4)}
    glob = batchnorm_apply(h, p, s, train=True, group=mesh.axis("batch"))[1]
    local = batchnorm_apply(h, p, s, train=True)[1]
    return {k: (glob[k].numpy(), local[k].numpy()) for k in glob}


def _fit_cfg(tmp, name, epochs):
    return Config(model=UNetConfig(base_width=4), train=TrainConfig(
        epochs=epochs, checkpoint_dir=os.path.join(tmp, name, "ckpt"),
        visualize_dir=os.path.join(tmp, name, "vis")))


def fit_losses(tmp, name, epochs, mesh=None, resume=None):
    """``fit`` on 8 synthetic 32² images at base width 4, on ``mesh`` or
    alone, its files under ``tmp/name``. → its losses."""
    _, history = fit(synthetic_dataset(n=8, size=32), _fit_cfg(tmp, name, epochs),
                     mesh=mesh, device="cpu", resume_dir=resume, log=lambda m: None)
    return [r["loss"] for r in history]


def data_parallel_ranks(rank, world, tree, x, y, tmp, one_rank_ckpt):
    """The checks that run on 2 ranks: the ``data=2`` SGD step, an AdamW
    step, global against per-rank BatchNorm statistics, ``fit(mesh)`` for 2
    epochs and resumed from the one-rank ``fit``'s checkpoint, and its
    checkpoint restored into a ``model=2`` template."""
    mesh = _mesh(MeshConfig(data=2))
    out = {"coords": (mesh.axis("data").index, mesh.axis("batch").size),
           "sgd": sgd_step(tree, x, y, mesh), "bn": _bn_stats(x, mesh)}
    params, bn = from_jax_params(*tree)
    state = shard_train_state(TrainState(params, bn, make_optimizer(params, TrainConfig())),
                              mesh)
    step = make_train_step(UNetConfig(base_width=4), TrainConfig(), device="cpu", mesh=mesh)
    *_, loss = step(state.params, state.bn_state, state.optimizer, _nchw(x), _nchw(y), 1e-3)
    out["adamw_loss"] = float(loss)
    out["adamw_finite"] = all(bool(torch.isfinite(t).all()) for t in tree_leaves(state.params))
    out["fit"] = fit_losses(tmp, "mesh", 2, mesh)
    out["fit_resumed"] = fit_losses(tmp, "mesh_resumed", 3, mesh, resume=one_rank_ckpt)
    # the 2-rank fit's whole checkpoint, sliced into a model-sharded template
    mp_mesh = _mesh(MeshConfig(data=1, model=2))
    params, bn = from_jax_params(*tree)
    template = shard_train_state(TrainState(params, bn, make_optimizer(params, TrainConfig())),
                                 mp_mesh)
    got = ckpt.restore(os.path.join(tmp, "mesh", "ckpt", "latest"), template, mp_mesh)
    whole = gather_train_state(got, mp_mesh)
    out["restored"] = (whole.epoch, to_jax_params(whole.params, whole.bn_state),
                       [whole.optimizer.state[p]["exp_avg"].numpy()
                        for p in tree_leaves(whole.params)])
    return out


def mesh_ranks(rank, world, tree, x, y):
    """The 2×2×2 SGD step on 8 ranks, and each rank's place on the grid."""
    mesh = _mesh(MeshConfig(data=2, model=2, spatial=2))
    place = {name: (mesh.axis(name).index, mesh.axis(name).size)
             for name in ("data", "model", "spatial", "batch")}
    return {"place": place, "sgd": sgd_step(tree, x, y, mesh)}


# -- spatial serving and pipelines ----------------------------------------------------


def spatial_ranks(rank, world, conv_case, stacked_case, unet_cases):
    """JAX's four spatial cases (``tests/distributed/test_spatial.py``) on a
    ``spatial=world`` mesh: → NHWC outputs."""
    mesh = _mesh(MeshConfig(data=1, spatial=world))
    ax = mesh.axis("spatial")
    x, p = conv_case
    one = spatial_shard_apply(lambda xs, pp: conv3x3_spatial(xs, pp, ax), mesh)(
        _nchw(x), _conv_params(p))

    def two(xs, pp):
        return conv3x3_spatial(torch.relu(conv3x3_spatial(xs, pp[0], ax)), pp[1], ax)

    x, p1, p2 = stacked_case
    stacked = spatial_shard_apply(two, mesh)(_nchw(x), (_conv_params(p1), _conv_params(p2)))
    unets = []
    for depth, x, params, state in unet_cases:
        folded = fold_unet(*from_jax_params(params, state), cfg=UNetConfig(base_width=4,
                                                                          depth=depth),
                           device="cpu")
        unets.append(_nhwc(spatial_unet_forward(folded, _nchw(x), mesh)))
    return {"conv": _nhwc(one), "stacked": _nhwc(stacked), "unets": unets}


def pipeline_ranks(rank, world, tower, x, identity_x):
    """JAX's pipeline cases (``tests/distributed/test_pipeline.py``) on a
    ``stage`` mesh over the world: the tanh tower when ``tower`` is given,
    the 2-stage identity when ``identity_x`` is."""
    mesh = Mesh(("stage",), (world,),
                timeout=datetime.timedelta(seconds=chip_smoke.PAR_TIMEOUT_S))
    out = {}
    if tower is not None:
        stages = stack_stage_params([{k: torch.from_numpy(v) for k, v in p.items()}
                                     for p in tower])
        out["tower"] = pipeline_apply(lambda p, h: torch.tanh(h @ p["w"] + p["b"]), stages,
                                      torch.from_numpy(x), mesh).numpy()
    if identity_x is not None:
        stages = stack_stage_params([{"w": torch.eye(8) * 2.0}, {"w": torch.eye(8) * 0.5}])
        out["identity"] = pipeline_apply(lambda p, h: h @ p["w"], stages,
                                         torch.from_numpy(identity_x), mesh).numpy()
    return out
