"""Make ``tests/data/torch_smoke_ocrtrain.npz``: the fixture that holds the
PyTorch port's recognizer and textness-head training against the JAX
trainers' on the card (``chip_smoke.py`` phases 23-24) and on the CPU
(``tests/test_torch_fixture_ocrtrain.py``).

Recognizer: two b64 batches of 32×256 lines from the JAX package's
``data.make_batch(64, rng, cjk_charset())`` (``rng`` seeded 0), stored as
uint8 (``np.rint(img·255)``, asserted to give JAX's float32 back as
``u8 / 255.0``); batch 0 trains, batch 1 is the eval batch. From the bundled
recognizer (``weights.npz``: t64, 420 classes) the JAX trainer's own
``make_train_step(optax.adamw(3e-4, weight_decay=1e-5), arch="t64")`` runs 3
steps on batch 0 at that constant lr. Textness head: 8 pages from
``render_textpage(rng, 256)`` (``rng`` seeded 1) with their masks, and from
the bundled ``textness.npz`` 3 steps of ``textness.train``'s step and
optimizer at ``steps=3`` (lr 2e-3 at optax's cosine decay) on the 8 pages.
The referee of each is one float64 step written here from the formulas
(JAX's modules cast BatchNorm's statistics and the CTC logits to float32):
the forward with two-pass batch statistics and ``optax.ctc_loss`` or the
class-balanced BCE, in JAX under ``jax.enable_x64``. Stored:

- ``charset``; ``lines`` (64, 32, 256) uint8, ``labels`` (64, 24) int32,
  ``label_pad`` (64, 24) float32, ``texts``; the same under ``eval_`` for
  batch 1 (the layout ``torchocr.train``'s ``__main__`` reads)
- ``param_keys``, ``state_keys``: the recognizer's ``keystr`` paths, in the
  order of every per-leaf array; ``sample_idx`` (L, 16) flat indices into
  each leaf, from ``np.random.default_rng(0)``
- ``rec_losses`` (3,); ``rec_grad_norms`` (L,) and ``rec_grad_sample``
  (L, 16) of the step-1 gradients; ``rec_bn1``, ``rec_bn3`` the BN running
  statistics after steps 1 and 3 (state leaves concatenated);
  ``rec_step_norms`` (L,) norms of params after step 3 minus the start;
  ``rec_exact_loss``, ``rec_exact_grad_norms``, ``rec_exact_grad_sample``,
  ``rec_exact_bn1``: the float64 step 1
- ``eval_greedy`` JAX's greedy texts on batch 1 at the bundled weights,
  ``eval_gap`` (64, 64) each frame's top-1 minus top-2 logit,
  ``eval_exact`` and ``eval_cer``
- ``pages``, ``masks`` (8, 256, 256) uint8, ``page_labels`` (8, 64, 64)
  float32 (JAX's ``make_batch`` labels); ``tx_keys``, ``tx_sample_idx``,
  ``tx_losses``, ``tx_grad_norms``, ``tx_grad_sample``, ``tx_step_norms``,
  ``tx_exact_loss``, ``tx_exact_grad_norms``, ``tx_exact_grad_sample``

    JAX_PLATFORMS=cpu python scripts/make_torch_smoke_ocrtrain.py    # ~1 min
"""

from __future__ import annotations

import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "tests", "data", "torch_smoke_ocrtrain.npz")
BATCH = 64
PAGES = 8
STEPS = 3
LR = 3e-4
TX_LR = 2e-3
SAMPLES = 16


def render_lines():
    """→ two batches of ``(lines uint8, labels, label_pad, texts)`` and the
    charset, from the JAX package's ``make_batch``."""
    from twinvoice_tpu.ocr.jaxocr import data as D
    from twinvoice_tpu.ocr.jaxocr.charset import cjk_charset

    cs = cjk_charset()
    rng = np.random.default_rng(0)
    out = []
    for _ in range(2):
        imgs, labels, pad, texts = D.make_batch(BATCH, rng, cs)
        u8 = np.rint(imgs[..., 0] * 255).astype(np.uint8)
        assert np.array_equal(u8.astype(np.float32) / 255.0, imgs[..., 0])
        out.append((u8, labels, pad, texts))
    return out, cs


def render_pages():
    """→ (pages uint8 (8, 256, 256), masks uint8, labels float32 (8, 64,
    64)), as ``textness.make_batch`` builds them."""
    import cv2

    from twinvoice_tpu.ocr.jaxocr.textness import render_textpage

    rng = np.random.default_rng(1)
    pages, masks = zip(*[render_textpage(rng, 256) for _ in range(PAGES)])
    labels = np.stack([cv2.resize(m, (64, 64), interpolation=cv2.INTER_AREA) > 64
                       for m in masks]).astype(np.float32)
    return np.stack(pages), np.stack(masks), labels


def leaf_items(tree):
    import jax

    return [(jax.tree_util.keystr(kp), np.asarray(leaf))
            for kp, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]]


def grad_stats(grads, idx):
    g = [v.astype(np.float64) for _, v in leaf_items(grads)]
    return (np.asarray([np.linalg.norm(v) for v in g]),
            np.stack([v.reshape(-1)[i] for v, i in zip(g, idx)]))


def crnn64(params, state, x, arch):
    """The CRNN's train-mode forward in float64 from the formulas: convs,
    BatchNorm with two-pass batch statistics (and torch's running-statistics
    rule, Bessel on the variance), ReLU, the pools, the residual context.
    → (logits, {keystr of a state leaf: new value})."""
    import jax.numpy as jnp
    from jax import lax

    new = {}

    def conv(h, p, pad):
        return lax.conv_general_dilated(h, p["kernel"], (1, 1), pad,
                                        dimension_numbers=("NHWC", "HWIO", "NHWC")) + p["bias"]

    def bn(h, p, s, key):
        mean = h.mean((0, 1, 2))
        var = ((h - mean) ** 2).mean((0, 1, 2))
        n = h.shape[0] * h.shape[1] * h.shape[2]
        new[key + "['mean']"] = 0.9 * s["mean"] + 0.1 * mean
        new[key + "['var']"] = 0.9 * s["var"] + 0.1 * var * n / (n - 1)
        return (h - mean) / jnp.sqrt(var + 1e-5) * p["scale"] + p["bias"]

    h = x
    for i, cp in enumerate(params["conv"]):
        h = bn(conv(h, cp, ((1, 1), (1, 1))), params["bn"][i], state["bn"][i], f"['bn'][{i}]")
        h = jnp.maximum(h, 0)
        if i < 3:
            win = (1, 2, 1, 1) if (i == 2 and arch == "t64") else (1, 2, 2, 1)
            h = lax.reduce_window(h, -jnp.inf, lax.max, win, win, "VALID")
    b, hh, ww, cc = h.shape
    h = jnp.transpose(h, (0, 2, 1, 3)).reshape(b, 1, ww, hh * cc)
    h = jnp.maximum(conv(h, params["proj"], "VALID"), 0)
    for i, cp in enumerate(params["ctx"]):
        r = bn(conv(h, cp, ((0, 0), (2, 2))), params["ctx_bn"][i], state["ctx_bn"][i],
               f"['ctx_bn'][{i}]")
        h = h + jnp.maximum(r, 0)
    return conv(h, params["head"], "VALID")[:, 0], new


def textness64(params, x):
    """The textness head's forward in float64 from the formulas (XLA's SAME
    padding, stride 2 at the first two convs)."""
    import jax.numpy as jnp
    from jax import lax

    h = x
    for i, p in enumerate(params):
        stride = 2 if i < 2 else 1
        h = lax.conv_general_dilated(h, p["kernel"], (stride, stride), "SAME",
                                     dimension_numbers=("NHWC", "HWIO", "NHWC")) + p["bias"]
        if i < len(params) - 1:
            h = jnp.maximum(h, 0)
    return h


def recognizer_numbers(batch, idx, skeys):
    """The JAX trainer's 3 steps and the float64 step 1 from the bundled
    weights on ``batch`` (see the module doc)."""
    import jax
    import jax.numpy as jnp
    import optax

    from twinvoice_tpu.ocr.jaxocr import train as JT
    from twinvoice_tpu.ocr.jaxocr.model import crnn_apply

    lines, labels, pad, _ = batch
    params, state, _, arch = JT.load_weights_ex()
    x = jnp.asarray(lines[..., None].astype(np.float32) / 255.0)

    def loss_fn(p):  # make_train_step's loss
        logits, _ = crnn_apply(p, state, x, train=True, arch=arch)
        return jnp.mean(optax.ctc_loss(logits.astype(jnp.float32),
                                       jnp.zeros(logits.shape[:2], jnp.float32),
                                       jnp.asarray(labels), jnp.asarray(pad)))

    out = {}
    out["rec_grad_norms"], out["rec_grad_sample"] = grad_stats(
        jax.jit(jax.grad(loss_fn))(params), idx)
    opt = optax.adamw(LR, weight_decay=1e-5)
    step = JT.make_train_step(opt, arch=arch)
    p, s = jax.tree.map(jnp.array, params), jax.tree.map(jnp.array, state)
    o = opt.init(p)
    losses, bn = [], []
    for _ in range(STEPS):
        p, s, o, loss = step(p, s, o, x, jnp.asarray(labels), jnp.asarray(pad))
        losses.append(float(loss))
        bn.append(np.concatenate([v for _, v in leaf_items(s)]))
    start = dict(leaf_items(params))
    out["rec_losses"] = np.asarray(losses, np.float32)
    out["rec_bn1"], out["rec_bn3"] = bn[0], bn[-1]
    out["rec_step_norms"] = np.asarray([np.linalg.norm((v - start[k]).astype(np.float64))
                                        for k, v in leaf_items(p)])

    with jax.enable_x64(True):
        p64 = jax.tree.map(lambda a: jnp.asarray(np.asarray(a), jnp.float64), params)
        s64 = jax.tree.map(lambda a: jnp.asarray(np.asarray(a), jnp.float64), state)
        x64 = jnp.asarray(lines[..., None].astype(np.float64) / 255.0)

        def loss64(p):
            logits, new = crnn64(p, s64, x64, arch)
            return jnp.mean(optax.ctc_loss(logits, jnp.zeros(logits.shape[:2]),
                                           jnp.asarray(labels),
                                           jnp.asarray(pad, jnp.float64))), new

        (loss, new), grads = jax.jit(jax.value_and_grad(loss64, has_aux=True))(p64)
        out["rec_exact_loss"] = np.float64(loss)
        out["rec_exact_grad_norms"], out["rec_exact_grad_sample"] = grad_stats(grads, idx)
        out["rec_exact_bn1"] = np.concatenate([np.asarray(new[k]) for k in skeys])
    return out


def eval_numbers(batch):
    """JAX's greedy texts, each frame's top-2 gap, exact-match and CER on
    ``batch`` at the bundled weights (``evaluate``'s decode)."""
    import jax
    import jax.numpy as jnp

    from twinvoice_tpu.ocr.jaxocr import train as JT
    from twinvoice_tpu.ocr.jaxocr.model import crnn_apply

    lines, _, _, texts = batch
    params, state, charset, arch = JT.load_weights_ex()
    infer = jax.jit(lambda p, s, x: crnn_apply(p, s, x, train=False, arch=arch)[0])
    logits = np.asarray(infer(params, state, jnp.asarray(lines[..., None] / np.float32(255))))
    top2 = np.sort(logits, axis=-1)[..., -2:]
    got = [charset.greedy_ctc_decode(row) for row in logits.argmax(-1)]
    errs = sum(JT._levenshtein(g, t) for g, t in zip(got, texts))
    return {"eval_greedy": np.asarray(got), "eval_gap": (top2[..., 1] - top2[..., 0]),
            "eval_exact": np.float64(np.mean([g == t for g, t in zip(got, texts)])),
            "eval_cer": np.float64(errs / sum(max(1, len(t)) for t in texts))}


def textness_numbers(pages, labels, idx):
    """``textness.train``'s step and optimizer at ``steps=3`` for 3 steps
    from the bundled head, and the float64 step 1."""
    import jax
    import jax.numpy as jnp
    import optax

    from twinvoice_tpu.ocr.jaxocr.textness import load_textness, textness_apply

    params = load_textness()
    x = jnp.asarray(pages[..., None] / 255.0, jnp.float32)
    y = jnp.asarray(labels[..., None])

    def loss_fn(p, x, y, apply=textness_apply):  # textness.train's loss
        logits = apply(p, x)
        pos = jnp.maximum(y.mean(), 1e-3)
        w = y / pos + (1 - y) / (1 - pos)
        return jnp.mean(w * optax.sigmoid_binary_cross_entropy(logits, y))

    opt = optax.adamw(optax.cosine_decay_schedule(TX_LR, STEPS), weight_decay=1e-5)

    @jax.jit
    def step(params, opt_state, x, y):
        loss, grads = jax.value_and_grad(loss_fn)(params, x, y)
        updates, opt_state = opt.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss

    out = {}
    out["tx_grad_norms"], out["tx_grad_sample"] = grad_stats(
        jax.jit(jax.grad(loss_fn))(params, x, y), idx)
    p, o, losses = params, opt.init(params), []
    for _ in range(STEPS):
        p, o, loss = step(p, o, x, y)
        losses.append(float(loss))
    start = dict(leaf_items(params))
    out["tx_losses"] = np.asarray(losses, np.float32)
    out["tx_step_norms"] = np.asarray([np.linalg.norm((v - start[k]).astype(np.float64))
                                       for k, v in leaf_items(p)])
    with jax.enable_x64(True):
        p64 = jax.tree.map(lambda a: jnp.asarray(np.asarray(a), jnp.float64), params)
        x64 = jnp.asarray(pages[..., None] / 255.0, jnp.float64)
        y64 = jnp.asarray(labels[..., None], jnp.float64)
        loss, grads = jax.jit(jax.value_and_grad(
            lambda p: loss_fn(p, x64, y64, apply=textness64)))(p64)
        out["tx_exact_loss"] = np.float64(loss)
        out["tx_exact_grad_norms"], out["tx_exact_grad_sample"] = grad_stats(grads, idx)
    return out


def main():
    sys.path.insert(0, ROOT)
    from twinvoice_tpu.ocr.jaxocr import train as JT
    from twinvoice_tpu.ocr.jaxocr.textness import load_textness

    (train_b, eval_b), cs = render_lines()
    pages, masks, page_labels = render_pages()
    params, state, charset, arch = JT.load_weights_ex()
    assert charset.chars == cs.chars and arch == "t64"
    pkeys = [k for k, _ in leaf_items(params)]
    skeys = [k for k, _ in leaf_items(state)]
    rng = np.random.default_rng(0)
    idx = np.stack([rng.integers(0, v.size, SAMPLES) for _, v in leaf_items(params)])
    tx = leaf_items(load_textness())
    tx_idx = np.stack([rng.integers(0, v.size, SAMPLES) for _, v in tx])

    out = {"charset": np.array(cs.chars), "param_keys": np.asarray(pkeys),
           "state_keys": np.asarray(skeys), "sample_idx": idx,
           "pages": pages, "masks": masks, "page_labels": page_labels,
           "tx_keys": np.asarray([k for k, _ in tx]), "tx_sample_idx": tx_idx}
    for prefix, (lines, labels, pad, texts) in (("", train_b), ("eval_", eval_b)):
        out.update({prefix + "lines": lines, prefix + "labels": labels,
                    prefix + "label_pad": pad, prefix + "texts": np.asarray(texts)})
    out.update(recognizer_numbers(train_b, idx, skeys))
    out.update(eval_numbers(eval_b))
    out.update(textness_numbers(pages, page_labels, tx_idx))
    np.savez_compressed(OUT, **out)
    print(f"wrote {OUT} ({os.path.getsize(OUT) / 1e6:.2f} MB): recognizer losses "
          f"{out['rec_losses'].tolist()} (float64 step 1 {float(out['rec_exact_loss']):.8f}), "
          f"eval exact {float(out['eval_exact']):.4f} cer {float(out['eval_cer']):.4f}; "
          f"textness losses {out['tx_losses'].tolist()} (float64 "
          f"{float(out['tx_exact_loss']):.8f})")


if __name__ == "__main__":
    main()
