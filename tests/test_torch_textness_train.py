"""PyTorch port, the textness head's training (``ocr/torchocr/textness.py``)
against the JAX package's ``textness.train`` on pages its ``render_textpage``
draws.

Tolerances: the labels, the input floats, the weight files and ``train``'s
trajectory are exact; the loss within 1e-6 relative of JAX's and its
gradient within 1e-5 of its largest element (float32 sums in another
order); 3 steps: the step-1 loss within 1e-5 relative of a float64 step
(``scripts/make_torch_smoke_ocrtrain.py:textness64``) and each step-1
gradient within 1e-4 of its float64 norm (2.2e-6 at most on the bundled
head's fixture step), each leaf after 3 steps within 1e-3 of its step from
JAX's.
"""

import importlib.util
import os

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from twinvoice_tpu.ocr.jaxocr import textness as JX
from twinvoice_tpu_torch.ocr.torchocr import textness as TX
from twinvoice_tpu_torch.ocr.torchocr import train as T

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _script():
    path = os.path.join(ROOT, "scripts", "make_torch_smoke_ocrtrain.py")
    spec = importlib.util.spec_from_file_location("make_torch_smoke_ocrtrain", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _pages(n, size, seed=0):
    rng = np.random.default_rng(seed)
    pages, masks = zip(*[JX.render_textpage(rng, size) for _ in range(n)])
    return np.stack(pages), np.stack(masks)


def _jax_loss(p, x, y):  # textness.train's loss
    logits = JX.textness_apply(p, x)
    pos = jnp.maximum(y.mean(), 1e-3)
    w = y / pos + (1 - y) / (1 - pos)
    return jnp.mean(w * optax.sigmoid_binary_cross_entropy(logits, y))


def _leaves(params):
    """Copies of each layer's bias and weight, in ``jax.tree.leaves`` order."""
    return [t.detach().numpy().copy() for p in params for t in (p["bias"], p["weight"])]


def test_init_textness_has_jax_shapes_and_distributions():
    got = TX.textness_params_to_jax(TX.init_textness(torch.Generator().manual_seed(0)))
    want = JX.init_textness(jax.random.key(0))
    assert [{k: v.shape for k, v in p.items()} for p in got] == \
        [{k: v.shape for k, v in p.items()} for p in want]
    assert TX.n_params(TX.init_textness(torch.Generator().manual_seed(0))) == \
        JX.n_params(want) == 32561
    for p in got:
        assert not p["bias"].any()
        fan = np.prod(p["kernel"].shape[:3])
        assert abs(p["kernel"].std() / np.sqrt(2.0 / fan) - 1) < 0.25


@pytest.mark.parametrize("size", [256, 128])
def test_textness_labels_bit_equal_cv2(size):
    _, masks = _pages(4, size, seed=size)
    rng = np.random.default_rng(1)
    masks = np.concatenate([masks, rng.integers(0, 2, (2, size, size)).astype(np.uint8) * 255,
                            rng.integers(0, 256, (1, size, size)).astype(np.uint8)])
    want = np.stack([cv2.resize(m, (size // 4, size // 4), interpolation=cv2.INTER_AREA) > 64
                     for m in masks]).astype(np.float32)
    got = TX.textness_labels(masks)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_pages_to_batch_is_make_batchs_float_and_labels():
    pages, masks = _pages(3, 128, seed=3)
    x, y = TX.pages_to_batch(pages, masks, "cpu")
    imgs = np.zeros((3, 128, 128, 1), np.float32)
    imgs[..., 0] = pages / 255.0  # make_batch's float64 division, stored as float32
    np.testing.assert_array_equal(x[:, 0].numpy().view(np.int32), imgs[..., 0].view(np.int32))
    np.testing.assert_array_equal(y[:, 0].numpy(), TX.textness_labels(masks))


def test_textness_loss_and_gradient_equal_jax():
    rng = np.random.default_rng(4)
    logits = rng.normal(0, 3, (4, 1, 16, 16)).astype(np.float32)
    y = (rng.random((4, 1, 16, 16)) < 0.2).astype(np.float32)
    t = torch.from_numpy(logits).requires_grad_()
    loss = TX.textness_loss(t, torch.from_numpy(y))
    loss.backward()

    def jl(lg):
        yy = jnp.asarray(y)
        pos = jnp.maximum(yy.mean(), 1e-3)
        w = yy / pos + (1 - yy) / (1 - pos)
        return jnp.mean(w * optax.sigmoid_binary_cross_entropy(lg, yy))

    want, g = jax.value_and_grad(jl)(jnp.asarray(logits))
    assert abs(float(loss.detach()) - float(want)) <= 1e-6 * float(want)
    assert np.abs(t.grad.numpy() - np.asarray(g)).max() <= 1e-5 * np.abs(np.asarray(g)).max()
    # no text at all: pos is clamped to 1e-3, as in JAX
    zero = TX.textness_loss(torch.zeros(1, 1, 4, 4), torch.zeros(1, 1, 4, 4))
    assert abs(float(zero) - np.log(2) / (1 - 1e-3)) < 1e-6


def test_three_steps_match_jax_and_a_float64_step():
    pages, masks = _pages(4, 128, seed=5)
    tparams = TX.init_textness(torch.Generator().manual_seed(2))
    jp = TX.textness_params_to_jax(tparams)
    x, y = TX.pages_to_batch(pages, masks, "cpu")
    jx = jnp.asarray(x.permute(0, 2, 3, 1).numpy())
    jy = jnp.asarray(y.permute(0, 2, 3, 1).numpy())
    opt = optax.adamw(optax.cosine_decay_schedule(2e-3, 3), weight_decay=1e-5)

    @jax.jit
    def jstep(p, o):
        loss, g = jax.value_and_grad(_jax_loss)(p, jx, jy)
        u, o = opt.update(g, o, p)
        return optax.apply_updates(p, u), o, loss

    p, o, jl = jp, opt.init(jp), []
    for _ in range(3):
        p, o, loss = jstep(p, o)
        jl.append(float(loss))
    textness64 = _script().textness64
    with jax.enable_x64(True):
        p64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), jp)

        def loss64(q):
            logits = textness64(q, jnp.asarray(jx, jnp.float64))
            yy = jnp.asarray(jy, jnp.float64)
            pos = jnp.maximum(yy.mean(), 1e-3)
            w = yy / pos + (1 - yy) / (1 - pos)
            return jnp.mean(w * optax.sigmoid_binary_cross_entropy(logits, yy))

        l64, g64 = jax.value_and_grad(loss64)(p64)
        l64, g64 = float(l64), [np.asarray(v) for v in jax.tree.leaves(g64)]

    optim = T.make_optimizer(tparams)
    step = TX.make_train_step(device="cpu")
    sched = T.cosine_decay(2e-3, 3)
    start = _leaves(tparams)
    tl = []
    for i in range(3):
        tparams, loss = step(tparams, optim, x, y, sched(i))
        tl.append(float(loss))
        if i == 0:
            grads = [t.grad.numpy().copy() for q in tparams for t in (q["bias"], q["weight"])]
    assert abs(tl[0] - l64) <= 1e-5 * l64
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    for g, e in zip(grads, g64):
        e = np.transpose(e, (3, 2, 0, 1)) if e.ndim == 4 else e
        assert np.linalg.norm(g - e) <= 1e-4 * np.linalg.norm(e)
    for got, s, want in zip(_leaves(tparams), start, jax.tree.leaves(p)):
        want = np.asarray(want)
        want = np.transpose(want, (3, 2, 0, 1)) if want.ndim == 4 else want
        assert np.linalg.norm(got - want) <= 1e-3 * np.linalg.norm(want - s)


def test_weight_files_load_in_both_packages(tmp_path):
    params = TX.init_textness(torch.Generator().manual_seed(3))
    for p in params:
        p["bias"] += torch.arange(p["bias"].numel()) * 0.01  # non-zero biases
    TX.save_textness(tmp_path / "port.npz", params)
    got = JX.load_textness(str(tmp_path / "port.npz"))
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(TX.textness_params_to_jax(params))):
        np.testing.assert_array_equal(np.asarray(a), b)
    JX.save_textness(str(tmp_path / "jax.npz"), got)
    back = TX.load_textness(str(tmp_path / "jax.npz"))
    for a, b in zip(_leaves(back), _leaves(params)):
        np.testing.assert_array_equal(a, b)
    bundled = TX.load_textness()
    TX.save_textness(tmp_path / "bundled.npz", bundled)
    with np.load(tmp_path / "bundled.npz") as a, np.load(TX.DEFAULT_TEXTNESS_PATH) as b:
        assert a.files == b.files and all(np.array_equal(a[k], b[k]) for k in a.files)


def test_train_follows_its_schedule_and_pool_draws(tmp_path):
    pages, masks = _pages(8, 64, seed=6)
    log = []
    params = TX.train(steps=5, bs=4, seed=1, out_path=str(tmp_path / "t.npz"), log=log.append,
                      pages=pages, masks=masks, device="cpu")
    rng = np.random.default_rng(1)
    hp = TX.init_textness(torch.Generator().manual_seed(1))
    opt, step = T.make_optimizer(hp), TX.make_train_step(device="cpu")
    sched = T.cosine_decay(2e-3, 5)
    for it in range(5):
        i = 4 * int(rng.integers(0, 2))
        hp, _ = step(hp, opt, *TX.pages_to_batch(pages[i:i + 4], masks[i:i + 4], "cpu"), sched(it))
    for a, b in zip(_leaves(params), _leaves(hp)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(_leaves(TX.load_textness(str(tmp_path / "t.npz"))), _leaves(hp)):
        np.testing.assert_array_equal(a, b)
    assert log[0] == "textness head: 32561 params" and any("step 1/5" in m for m in log)
    with pytest.raises(ValueError):
        TX.train(steps=1, bs=16, pages=pages, masks=masks, device="cpu", log=log.append)
