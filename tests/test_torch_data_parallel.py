"""PyTorch port: data, model and spatial parallel training on gloo ranks
(``tests/torch_dist.py``) against the JAX package's single-device step, with
the tolerances of ``tests/distributed/test_data_parallel.py``: a 2-rank
``data=2`` SGD step and an 8-rank 2×2×2 one, AdamW, ``fit(mesh)`` and its
checkpoints both ways, and BatchNorm's global-batch statistics."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from twinvoice_tpu.config import TrainConfig as JaxTrainConfig
from twinvoice_tpu.config import UNetConfig as JaxUNetConfig
from twinvoice_tpu.train.trainer import make_train_step as jax_make_train_step
from twinvoice_tpu_torch.config import TrainConfig
from twinvoice_tpu_torch.models.unet import tree_leaves
from twinvoice_tpu_torch.ops.conv import conv3x3
from twinvoice_tpu_torch.ops.norm import batchnorm_apply
from twinvoice_tpu_torch.train import checkpoint as ckpt
from twinvoice_tpu_torch.train.trainer import TrainState, make_optimizer
from twinvoice_tpu_torch.weights import from_jax_params, keystr_items, to_jax_params

from tests import torch_dist
from tests.torch_port_cases import random_unet


@pytest.fixture(scope="module")
def case():
    """Base width 4, b8 32² (JAX's oracle): the numpy tree, the batch, JAX's
    single-device SGD step and the port's one-rank step."""
    _, params, state = random_unet(0, base_width=4)
    rng = np.random.default_rng(0)
    x = rng.uniform(0, 1, (8, 32, 32, 3)).astype(np.float32)
    y = (rng.uniform(size=(8, 32, 32, 3)) > 0.8).astype(np.float32)
    opt = optax.inject_hyperparams(optax.sgd)(learning_rate=1e-3)
    jp, js = jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, state)
    step = jax_make_train_step(JaxUNetConfig(base_width=4), JaxTrainConfig(batch_size=8), opt)
    p, bn, _, loss = step(jp, js, opt.init(jp), jnp.asarray(x), jnp.asarray(y),
                          jnp.float32(1e-3))
    jax_step = (float(loss), jax.tree.map(np.asarray, p), jax.tree.map(np.asarray, bn))
    return {"tree": (params, state), "x": x, "y": y, "jax": jax_step,
            "port": torch_dist.sgd_step((params, state), x, y)}


@pytest.fixture(scope="module")
def dp2(case, tmp_path_factory):
    """The 2-rank checks (``torch_dist.data_parallel_ranks``), after the
    one-rank ``fit`` whose checkpoint they resume from."""
    tmp = str(tmp_path_factory.mktemp("dp2"))
    one = {"fit": torch_dist.fit_losses(tmp, "one", 2)}
    one["resumed"] = torch_dist.fit_losses(tmp, "one_resumed", 3,
                                           resume=os.path.join(tmp, "one", "ckpt", "latest"))
    ranks = torch_dist.run_ranks(torch_dist.data_parallel_ranks, 2, tmp, case["tree"],
                                 case["x"], case["y"], tmp,
                                 os.path.join(tmp, "one", "ckpt", "latest"))
    return {"tmp": tmp, "one": one, "ranks": ranks}


@pytest.fixture(scope="module")
def mesh8(case, tmp_path_factory):
    return torch_dist.run_ranks(torch_dist.mesh_ranks, 8, tmp_path_factory.mktemp("mesh8"),
                                case["tree"], case["x"], case["y"])


def assert_step(got, want, loss_rtol=1e-5):
    """``test_dp8_matches_single_device``'s tolerances: loss, params, BN."""
    np.testing.assert_allclose(got[0], want[0], rtol=loss_rtol, atol=1e-6)
    for i, (rtol, atol) in ((1, (1e-5, 1e-7)), (2, (1e-5, 1e-6))):
        w = dict(keystr_items(want[i]))
        assert sorted(w) == sorted(k for k, _ in keystr_items(got[i]))
        for key, a in keystr_items(got[i]):
            np.testing.assert_allclose(a, np.asarray(w[key]), rtol=rtol, atol=atol, err_msg=key)


def test_dp2_sgd_step_matches_jax_single_device(case, dp2):
    """Same batch, same params: the port's 2-rank ``data=2`` SGD step equals
    JAX's single-device step (the gradient sum over ranks is exact up to
    float32 rounding) on both ranks, and the port's one-rank step does too."""
    assert [r["coords"] for r in dp2["ranks"]] == [(0, 2), (1, 2)]
    assert_step(case["port"], case["jax"])
    for r in dp2["ranks"]:
        assert_step(r["sgd"], case["jax"])


def test_mesh_2x2x2_step_matches_single_device(case, mesh8):
    """The 2 data × 2 model × 2 spatial step on 8 ranks (channel-sharded
    params, H-sharded activations with halos): its loss within rtol 1e-5 of
    JAX's single-device step, its params and BN state at the data-parallel
    oracle's tolerances of the port's one-rank step; each rank at its place
    on JAX's row-major grid."""
    for rank, r in enumerate(mesh8):
        d, m, s = np.unravel_index(rank, (2, 2, 2))
        assert r["place"] == {"data": (d, 2), "model": (m, 2), "spatial": (s, 2),
                              "batch": (2 * d + s, 4)}
        np.testing.assert_allclose(r["sgd"][0], case["jax"][0], rtol=1e-5, atol=1e-6)
        assert_step(r["sgd"], case["port"])


def test_adamw_step_on_two_ranks_is_finite(dp2):
    for r in dp2["ranks"]:
        assert np.isfinite(r["adamw_loss"]) and r["adamw_finite"]


def test_fit_on_two_ranks_gives_the_one_rank_losses(dp2):
    """``fit(mesh)`` on 2 ranks for 2 epochs: the one-rank ``fit``'s losses
    at rtol 1e-5, on both ranks; resumed from the one-rank checkpoint for a
    third epoch, the loss of the one-rank ``fit`` resumed from it."""
    for r in dp2["ranks"]:
        np.testing.assert_allclose(r["fit"], dp2["one"]["fit"], rtol=1e-5)
        np.testing.assert_allclose(r["fit_resumed"], dp2["one"]["resumed"], rtol=1e-5)


def test_two_rank_checkpoint_restores_into_one_rank_fit(dp2):
    """Rank 0's checkpoint holds the whole tree: it restores into the
    one-rank template and the one-rank ``fit`` resumes from it."""
    tmp = dp2["tmp"]
    latest = os.path.join(tmp, "mesh", "ckpt", "latest")
    params, bn = from_jax_params(*random_unet(1, base_width=4)[1:])
    state = ckpt.restore(latest, TrainState(params, bn, make_optimizer(params, TrainConfig())))
    assert state.epoch == 2 and state.shardings is None
    resumed = torch_dist.fit_losses(tmp, "one_from_mesh", 3, resume=latest)
    np.testing.assert_allclose(resumed, dp2["one"]["resumed"], rtol=1e-5)


def test_checkpoint_restores_into_a_model_sharded_template(dp2):
    """The 2-rank checkpoint sliced into a ``model=2`` template and gathered
    again is the file's tree: params, BN state and AdamW's moments."""
    saved = torch.load(os.path.join(dp2["tmp"], "mesh", "ckpt", "latest", "train_state.pt"),
                       weights_only=True)
    want = to_jax_params(saved["params"], saved["bn_state"])
    moments = [saved["optimizer"]["state"][i]["exp_avg"].numpy()
               for i in range(len(tree_leaves(saved["params"])))]
    for r in dp2["ranks"]:
        epoch, got, got_moments = r["restored"]
        assert epoch == 2
        for g, w in zip(got, want):
            wd = dict(keystr_items(w))
            for key, a in keystr_items(g):
                np.testing.assert_array_equal(a, wd[key], err_msg=key)
        assert len(got_moments) == len(moments)
        for a, b in zip(got_moments, moments):
            np.testing.assert_array_equal(a, b)


def test_batchnorm_takes_global_batch_statistics(case, dp2):
    """With the ``batch`` axis as its group, BatchNorm's statistics on each
    rank's half of the batch are the whole batch's (as XLA's SPMD takes them
    in the JAX step); each rank's own rows alone give other numbers."""
    h = conv3x3(torch.from_numpy(np.ascontiguousarray(case["x"].transpose(0, 3, 1, 2))),
                {"weight": torch.linspace(-1, 1, 4 * 3 * 9).reshape(4, 3, 3, 3)})
    p = {"scale": torch.ones(4), "bias": torch.zeros(4)}
    s = {"mean": torch.zeros(4), "var": torch.ones(4)}
    whole = batchnorm_apply(h, p, s, train=True)[1]
    for r in dp2["ranks"]:
        for k, (glob, local) in r["bn"].items():
            np.testing.assert_allclose(glob, whole[k].numpy(), rtol=1e-5, atol=1e-7)
            assert np.abs(local - whole[k].numpy()).max() > 1e-4
