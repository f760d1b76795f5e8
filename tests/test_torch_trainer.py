"""PyTorch port, the trainer (``train.trainer``) against the JAX package's on
the CPU: one train step (loss, every gradient, the new BatchNorm state, the
update), AdamW against ``optax.adamw`` on identical gradients, ``fit``'s
behaviours (learning, checkpoints, visual dumps equal to JAX's, resume,
validation split, prefetch), and the npz weights both ways."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from twinvoice_tpu.config import TrainConfig as JaxTrainConfig
from twinvoice_tpu.models.unet import unet_apply as jax_unet_apply
from twinvoice_tpu.train import checkpoint as jax_ckpt
from twinvoice_tpu.train import trainer as jax_trainer
from twinvoice_tpu.train.losses import invoice_loss as jax_invoice_loss
from twinvoice_tpu.train.visualize import dump_epoch_visual as jax_dump
from twinvoice_tpu_torch.config import Config, TrainConfig, UNetConfig, replace
from twinvoice_tpu_torch.data.dataset import synthetic_dataset
from twinvoice_tpu_torch.models.unet import _tree_map, init_unet, tree_leaves
from twinvoice_tpu_torch.train import checkpoint as ckpt
from twinvoice_tpu_torch.train import trainer
from twinvoice_tpu_torch.train.visualize import dump_epoch_visual
from twinvoice_tpu_torch.weights import from_jax_params, keystr_items, to_jax_params

from chip_smoke import pre_bn_bias, rel_dist
from tests.torch_port_cases import float64_step, random_unet

W4 = UNetConfig(base_width=4)


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2)


def test_train_step_matches_jax_and_the_exact_step():
    """One float32 step from the same weights and batch.

    Tolerances: against the exact float64 step (``float64_step``), the loss
    within 1e-6 and each gradient within 1e-4 (‖·‖ of the difference over
    the exact one); against JAX's, within JAX's own distance from the exact
    value plus that 1e-4. XLA's CPU reductions add the batch statistics up
    one element after another and E[x²] − E[x]² amplifies that, so JAX's
    gradients sit about 1e-3 from the exact ones at this size (up to 1.3e-2
    at the first layer); the port's about 3e-6. The pre-BN conv biases,
    whose exact gradient is 0, are held to 1e-6 of their kernel's gradient
    (JAX's to 1e-4: 7e-6 at the first layer).
    The BN state within 1e-5 of both. The update: each leaf's step norm
    within 1e-2 of JAX's (Adam's first step is lr·g/(|g|+eps): ±lr wherever
    |g| ≫ 1e-8, so the norms agree though a near-0 gradient's sign may not,
    and gradients 1e-2 apart move it by at most 1e-2 where |g| is near eps); the pre-BN biases' steps, Adam's step of a rounding-noise
    gradient on both sides, only within lr·√n."""
    jcfg, params, state = random_unet(0, base_width=4)
    ds = synthetic_dataset(n=4, size=32)
    images, masks = next(ds.batches(4, shuffle=False))

    jopt = jax_trainer.make_optimizer(JaxTrainConfig())
    jstep = jax_trainer.make_train_step(jcfg, JaxTrainConfig(), jopt)
    jp = jax.tree.map(jnp.array, params)
    js = jax.tree.map(jnp.array, state)
    jp1, js1, _, jloss = jstep(jp, js, jopt.init(jp), jnp.asarray(images),
                               jnp.asarray(masks), jnp.float32(1e-3))

    def loss_fn(p):
        logits, _ = jax_unet_apply(p, state, images, cfg=jcfg, train=True)
        return jax_invoice_loss(logits, masks)

    jgrads = dict(keystr_items(jax.tree.map(
        np.asarray, jax.jit(jax.grad(loss_fn))(jax.tree.map(jnp.asarray, params)))))
    exact_loss, exact_grads, exact_state = float64_step(params, state, images, masks)

    tp, ts = from_jax_params(params, state)
    opt = trainer.make_optimizer(tp, TrainConfig())
    step = trainer.make_train_step(W4, TrainConfig(), device="cpu")
    tp1, ts1, loss = step(tp, ts, opt, nchw(images), nchw(masks), 1e-3)
    assert loss.dtype == torch.float32 and loss.shape == () and not loss.requires_grad
    assert tree_leaves(tp1)[0] is tree_leaves(tp)[0]  # updated in place

    assert abs(float(loss) - exact_loss) <= 1e-6 * exact_loss
    assert abs(float(loss) - float(jloss)) <= 1e-5 * exact_loss
    grads = dict(keystr_items(to_jax_params(_tree_map(lambda t: t.grad, tp), ts)[0]))
    for key, exact in exact_grads.items():
        if pre_bn_bias(key):
            scale = np.linalg.norm(exact_grads[key.replace("['bias']", "['kernel']")])
            assert np.linalg.norm(grads[key]) <= 1e-6 * scale, key
            assert np.linalg.norm(jgrads[key]) <= 1e-4 * scale, key
            continue
        assert rel_dist(grads[key], exact) <= 1e-4, key
        assert rel_dist(grads[key], jgrads[key]) <= rel_dist(jgrads[key], exact) * 1.01 + 1e-4, key

    mine = dict(keystr_items(to_jax_params(tp1, ts1)[1]))
    for key, want in keystr_items(jax.tree.map(np.asarray, js1)):
        assert rel_dist(mine[key], want) <= 1e-5, key
        assert rel_dist(mine[key], exact_state[key]) <= 1e-5, key

    after = dict(keystr_items(to_jax_params(tp1, ts1)[0]))
    jafter = dict(keystr_items(jax.tree.map(np.asarray, jp1)))
    for key, before in keystr_items(params):
        mine_step = np.linalg.norm(after[key] - before)
        jax_step = np.linalg.norm(jafter[key] - before)
        if pre_bn_bias(key):  # Adam's step of a rounding-noise gradient
            assert mine_step <= 1.01e-3 * np.sqrt(before.size), key
            continue
        assert abs(mine_step - jax_step) <= 1e-2 * jax_step, key


def test_adamw_matches_optax_on_identical_gradients():
    """Six updates with the learning rate changing between them, the same
    params and gradients fed to JAX's jitted ``optax.adamw`` (the JAX
    trainer's ``make_optimizer``) and to the port's ``torch.optim.AdamW``:
    params within 1e-6 relative and 2e-6 absolute after every step: the two
    order an update's float32 operations differently, so they part by a few
    ulps of the largest param (|p| < 3, ulp 2.4e-7; 6.9e-7 at worst here),
    and a param near 0 keeps the error of the larger value it came from.
    Gradients include exact zeros and values near ``eps``. The learning rates (near 1e-1) and
    the weight decay (0.5) make the decay a step's whole change on the
    first step, whose gradients are all zero (Adam's term is 0/(0 + eps)):
    it moves each param by 5e-2 of its value there, and by 1e-2 to 5e-2 on
    the later steps, far above the tolerance, so a decay left out or of the
    wrong strength fails the first step."""
    rng = np.random.default_rng(11)
    shapes = {"a": (7, 5), "b": (3,), "c": (2, 3, 4)}
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: np.zeros(s, np.float32) for k, s in shapes.items()}]
    for _ in range(5):
        g = {k: (rng.standard_normal(s) * 10.0 ** rng.integers(-9, 1, s)).astype(np.float32)
             for k, s in shapes.items()}
        g["a"][0] = 0.0
        grads.append(g)
    lrs = [1e-1, 5e-2, 2e-1, 1e-1, 2e-2, 7e-2]
    wd = 0.5

    jopt = jax_trainer.make_optimizer(JaxTrainConfig(weight_decay=wd))

    @jax.jit
    def jupdate(p, s, g, lr):
        s.hyperparams["learning_rate"] = lr
        updates, s = jopt.update(g, s, p)
        return jax.tree.map(lambda a, b: a + b, p, updates), s

    jp = jax.tree.map(jnp.asarray, params)
    js = jopt.init(jp)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    opt = trainer.make_optimizer(tp, TrainConfig(weight_decay=wd))
    for i, (g, lr) in enumerate(zip(grads, lrs)):
        before = {k: t.detach().numpy().copy() for k, t in tp.items()}
        jp, js = jupdate(jp, js, g, jnp.float32(lr))
        for k, t in tp.items():
            t.grad = torch.from_numpy(g[k])
        for group in opt.param_groups:
            group["lr"] = float(np.float32(lr))
        opt.step()
        for k in shapes:
            np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]),
                                       rtol=1e-6, atol=2e-6, err_msg=k)
            if i == 0:  # the decay alone
                np.testing.assert_allclose(tp[k].detach().numpy(),
                                           before[k] * (1 - lr * wd), rtol=1e-6, err_msg=k)


def tiny_config(tmp_path, epochs=2, **train_kw):
    return Config(model=W4, train=TrainConfig(
        batch_size=4, epochs=epochs, checkpoint_dir=str(tmp_path / "ckpts"),
        visualize_dir=str(tmp_path / "vis"), **train_kw))


def quiet(*_):
    pass


def test_fit_learns_checkpoints_and_dumps(tmp_path):
    ds = synthetic_dataset(n=8, size=32)
    cfg = tiny_config(tmp_path, epochs=4)
    state, history = trainer.fit(ds, cfg, device="cpu", log=quiet)
    assert [r["epoch"] for r in history] == [1, 2, 3, 4] and state.epoch == 4
    assert history[-1]["loss"] < history[0]["loss"]  # it learns
    assert [r["lr"] for r in history] == [
        float(np.float32(jax_trainer.cosine_warm_restarts(1e-3, 10, 2)(e))) for e in range(4)]
    assert state.best_loss == min(r["loss"] for r in history)
    for name in ("best", "latest"):
        assert ckpt.has_checkpoint(os.path.join(cfg.train.checkpoint_dir, name))
    vis = sorted(os.listdir(cfg.train.visualize_dir))
    assert vis == [f"epoch{e:03d}_{k}.png" for e in range(1, 5) for k in ("img", "pred", "true")]


def test_fit_needs_a_card_unless_told_otherwise(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trainer.fit(synthetic_dataset(n=4, size=32), tiny_config(tmp_path), log=quiet)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_unet(torch.Generator(), W4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trainer.make_train_step(W4, TrainConfig())


def test_visual_dump_pngs_equal_jax(tmp_path):
    """The three PNGs, decoded with Pillow, pixel-equal to the JAX trainer's
    dumps of the same weights and image."""
    jcfg, params, state = random_unet(5, base_width=4)
    ds = synthetic_dataset(n=1, size=32, seed=3)
    image, mask = next(ds.batches(1, shuffle=False))
    jax_dump(image[0], mask[0], jax.tree.map(jnp.asarray, params),
             jax.tree.map(jnp.asarray, state), jcfg, str(tmp_path / "jax"), "e")
    tp, ts = from_jax_params(params, state)
    dump_epoch_visual(image[0], mask[0], tp, ts, W4, str(tmp_path / "port"), "e")
    for kind in ("img", "true", "pred"):
        with Image.open(tmp_path / "jax" / f"e_{kind}.png") as a, \
                Image.open(tmp_path / "port" / f"e_{kind}.png") as b:
            assert b.mode == "RGB" and b.size == (32, 32)
            want = np.asarray(a)
            np.testing.assert_array_equal(np.asarray(b), want, err_msg=kind)
    assert (want > 0).any() and (want == 0).any()  # some fields found, some not


def test_resume_runs_only_the_remaining_epochs(tmp_path):
    ds = synthetic_dataset(n=8, size=32)
    cfg = tiny_config(tmp_path, epochs=2)
    first, _ = trainer.fit(ds, cfg, device="cpu", log=quiet)
    latest = os.path.join(cfg.train.checkpoint_dir, "latest")
    logs = []
    cfg3 = replace(cfg, train=replace(cfg.train, epochs=3))
    state, history = trainer.fit(ds, cfg3, device="cpu", resume_dir=latest, log=logs.append)
    assert logs[0] == f"resumed from {latest} at epoch 2"
    assert [r["epoch"] for r in history] == [3] and state.epoch == 3


def test_checkpoint_round_trip_restores_everything(tmp_path):
    ds = synthetic_dataset(n=4, size=32)
    cfg = tiny_config(tmp_path, epochs=2)
    state, _ = trainer.fit(ds, cfg, device="cpu", log=quiet)
    params, bn = init_unet(torch.Generator().manual_seed(9), W4, device="cpu")
    fresh = trainer.TrainState(params, bn, trainer.make_optimizer(params, TrainConfig()))
    got = ckpt.restore(os.path.join(cfg.train.checkpoint_dir, "latest"), fresh)
    assert got.epoch == 2 and got.best_loss == state.best_loss
    for a, b in zip(tree_leaves(got.params), tree_leaves(state.params)):
        assert torch.equal(a, b)
    for a, b in zip(tree_leaves(got.bn_state), tree_leaves(state.bn_state)):
        assert torch.equal(a, b)
    sa, sb = got.optimizer.state_dict(), state.optimizer.state_dict()
    assert sa["param_groups"] == sb["param_groups"]
    for i, s in sb["state"].items():
        for k, v in s.items():
            assert torch.equal(sa["state"][i][k], v)
    assert all(a is b for a, b in zip(tree_leaves(got.params), tree_leaves(params)))


def test_checkpoint_of_loaded_weights_restores_into_fits_template(tmp_path):
    """A train state built on weights carried in (``from_jax_params``, whose
    dicts are built in another key order than ``init_unet``'s), stepped once
    so that AdamW holds moments, restores into ``fit``'s template leaf for
    leaf: each param, BN statistic and AdamW moment lands on the leaf of the
    same path, bit for bit."""
    _, params, state = random_unet(2, base_width=4)
    tp, ts = from_jax_params(params, state)
    opt = trainer.make_optimizer(tp, TrainConfig())
    g = torch.Generator().manual_seed(3)
    for t in tree_leaves(tp):
        t.grad = torch.randn(t.shape, generator=g)
    opt.step()
    saved = trainer.TrainState(tp, ts, opt, epoch=1, best_loss=0.5)
    ckpt.save(str(tmp_path / "c"), saved)
    params2, bn2 = init_unet(torch.Generator().manual_seed(9), W4, device="cpu")
    got = ckpt.restore(str(tmp_path / "c"), trainer.TrainState(
        params2, bn2, trainer.make_optimizer(params2, TrainConfig())))
    assert list(params2) != list(tp)  # the two trees' dicts are in another order

    def pairs(a, b):
        if isinstance(a, dict):
            assert sorted(a) == sorted(b)
            return [p for k in a for p in pairs(a[k], b[k])]
        if isinstance(a, list):
            return [p for x, y in zip(a, b) for p in pairs(x, y)]
        return [(a, b)]

    for a, b in pairs(got.params, tp):
        assert torch.equal(a, b)
        for k in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(got.optimizer.state[a][k], opt.state[b][k])
    for a, b in pairs(got.bn_state, ts):
        assert torch.equal(a, b)


def test_validation_split_runs(tmp_path):
    ds = synthetic_dataset(n=8, size=32)
    cfg = tiny_config(tmp_path, epochs=2, val_fraction=0.25)
    _, history = trainer.fit(ds, cfg, device="cpu", log=quiet)
    for rec in history:
        assert np.isfinite(rec["val_loss"])
        assert len(rec["val_iou"]) == 3 and all(0 <= v <= 1 for v in rec["val_iou"])


def test_prefetch_and_sync_every_give_the_synchronous_losses(tmp_path):
    ds = synthetic_dataset(n=12, size=32)
    runs = []
    for prefetch, sync_every in ((0, 0), (2, 0), (2, 1)):
        cfg = tiny_config(tmp_path / f"{prefetch}{sync_every}", epochs=2, prefetch=prefetch,
                          sync_every=sync_every, visualize=False)
        runs.append([r["loss"] for r in trainer.fit(ds, cfg, device="cpu", log=quiet)[1]])
    assert runs[0] == runs[1] == runs[2]


def test_prefetch_surfaces_loader_errors():
    def gen():
        yield np.zeros((1, 4, 4, 3), np.float32), np.zeros((1, 4, 4, 3), np.float32)
        raise ValueError("bad batch")

    it = trainer._prefetch_batches(gen(), 2, torch.float32, torch.device("cpu"))
    images, masks = next(it)
    assert images.shape == (1, 3, 4, 4)
    with pytest.raises(ValueError, match="bad batch"):
        next(it)


def test_npz_weights_load_in_both_packages(tmp_path):
    """The port's ``save_params_npz`` loads in JAX's ``load_params_npz`` and
    JAX's loads in the port, both exactly."""
    jcfg, params, state = random_unet(6, base_width=4)
    tp, ts = from_jax_params(params, state)
    path = str(tmp_path / "port.npz")
    ckpt.save_params_npz(path, tp, ts)
    jp, js = jax_ckpt.load_params_npz(path, jcfg)
    for tree, ref in (((jp, params)), ((js, state))):
        got = dict(keystr_items(jax.tree.map(np.asarray, tree)))
        assert got.keys() == dict(keystr_items(ref)).keys()
        for key, want in keystr_items(ref):
            np.testing.assert_array_equal(got[key], want, err_msg=key)
    path = str(tmp_path / "jax.npz")
    jax_ckpt.save_params_npz(path, jax.tree.map(jnp.asarray, params),
                             jax.tree.map(jnp.asarray, state))
    lp, ls = ckpt.load_params_npz(path)
    for got, want in zip(to_jax_params(lp, ls), (params, state)):
        gd = dict(keystr_items(got))
        for key, w in keystr_items(want):
            np.testing.assert_array_equal(gd[key], w, err_msg=key)
