"""Make ``tests/data/torch_smoke_train.npz``: the fixture that holds the
PyTorch port's segmenter training against the JAX trainer's on the card
(``chip_smoke.py`` phase 21) and on the CPU
(``tests/test_torch_fixture_train.py``).

It renders the four invoices of ``make_torch_smoke_pages.py`` in RGB
(``data.synthetic.render_invoice``, 440×640), fills each field's box into
its mask channel (invoice_no, date, total_amount), and scales pages (OpenCV's
INTER_AREA) and boxes to 512². From the bundled w16 segmenter
(``segmenter_synth_w16.npz``) it runs the JAX trainer's ``make_train_step``
for 3 steps at lr 1e-3 on that one b4 batch (``ArrayDataset.batches``
without shuffling), under three settings: ``fp32``, ``bf16`` and
``bf16_fast`` (bf16 with ``fast_norm``); and the float64 step of
``tests/torch_port_cases.float64_step`` once (``exact``). Stored:

- ``pages`` (4, 512, 512, 3) uint8 RGB, ``masks`` (4, 512, 512, 3) uint8 0/255
- ``param_keys``, ``state_keys``: the ``keystr`` paths of the leaves, in the
  order of every per-leaf array below; ``sample_idx`` (L, 16) flat indices
  into each param leaf, drawn from ``np.random.default_rng(0)``
- per setting ``<tag>_losses`` (3,), ``<tag>_grad_norms`` (L,) L2 norms of
  the step-1 gradients, ``<tag>_grad_sample`` (L, 16) their elements at
  ``sample_idx``, ``<tag>_bn1`` and ``<tag>_bn3`` the BN running statistics
  after steps 1 and 3 (the state leaves concatenated), ``<tag>_step_norms``
  (L,) norms of params after step 3 minus the start
- ``<tag>_eval_loss`` and ``<tag>_eval_iou`` (3,) for ``fp32`` and ``bf16``:
  the JAX ``make_eval_step`` on the batch at the start weights
- ``exact_loss``, ``exact_grad_norms``, ``exact_grad_sample``, ``exact_bn1``:
  the float64 step-1 values

    JAX_PLATFORMS=cpu python scripts/make_torch_smoke_train.py    # ~2 min
"""

from __future__ import annotations

import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "tests", "data", "torch_smoke_train.npz")
SIZE = 512
STEPS = 3
LR = 1e-3
SAMPLES = 16
SETTINGS = {"fp32": ("float32", False), "bf16": ("bfloat16", False),
            "bf16_fast": ("bfloat16", True)}


def render_batch():
    """→ (pages (4,512,512,3) uint8, masks (4,512,512,3) uint8 0/255)."""
    sys.path.insert(0, ROOT)
    import cv2

    from scripts.make_torch_smoke_pages import PAGES
    from twinvoice_tpu.data.synthetic import render_invoice

    fields = ("invoice_no", "date", "total_amount")
    pages, masks = [], []
    for kw in PAGES:
        img, boxes = render_invoice(**kw)
        rgb = np.asarray(img.convert("RGB"))
        h, w = rgb.shape[:2]
        pages.append(cv2.resize(rgb, (SIZE, SIZE), interpolation=cv2.INTER_AREA))
        m = np.zeros((SIZE, SIZE, 3), np.uint8)
        for c, field in enumerate(fields):
            x1, y1, x2, y2 = boxes[field]
            m[round(y1 * SIZE / h):round(y2 * SIZE / h),
              round(x1 * SIZE / w):round(x2 * SIZE / w), c] = 255
        masks.append(m)
    return np.stack(pages), np.stack(masks)


def leaf_items(tree):
    import jax

    return [(jax.tree_util.keystr(kp), np.asarray(leaf, np.float32))
            for kp, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]]


def jax_run(params, state, images, masks, dtype, fast):
    """The JAX trainer's numbers for one setting (see the module doc)."""
    import jax
    import jax.numpy as jnp

    from twinvoice_tpu.config import TrainConfig, UNetConfig
    from twinvoice_tpu.models.unet import unet_apply
    from twinvoice_tpu.train.losses import invoice_loss
    from twinvoice_tpu.train.trainer import make_eval_step, make_optimizer, make_train_step

    mcfg = UNetConfig(base_width=16)
    tcfg = TrainConfig(dtype=dtype, fast_norm=fast)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    x, y = jnp.asarray(images, jdt), jnp.asarray(masks, jdt)

    def loss_fn(p):
        logits, _ = unet_apply(p, state, x, cfg=mcfg, train=True, fast_norm=fast)
        return invoice_loss(logits, y)

    grads = leaf_items(jax.jit(jax.grad(loss_fn))(params))
    opt = make_optimizer(tcfg)
    step = make_train_step(mcfg, tcfg, opt)
    p = jax.tree.map(jnp.array, params)
    s = jax.tree.map(jnp.array, state)
    o = opt.init(p)
    losses, bn = [], []
    for _ in range(STEPS):
        p, s, o, loss = step(p, s, o, x, y, jnp.float32(LR))
        losses.append(float(loss))
        bn.append(np.concatenate([v for _, v in leaf_items(s)]))
    start = dict(leaf_items(params))
    out = {
        "losses": np.asarray(losses, np.float32),
        "grad_norms": np.asarray([np.linalg.norm(g.astype(np.float64)) for _, g in grads]),
        "grads": grads,
        "bn1": bn[0], "bn3": bn[-1],
        "step_norms": np.asarray([np.linalg.norm((v - start[k]).astype(np.float64))
                                  for k, v in leaf_items(p)]),
    }
    if not fast:
        loss, iou = make_eval_step(mcfg, tcfg)(params, state, x, y)
        out["eval_loss"] = np.float32(loss)
        out["eval_iou"] = np.asarray(iou, np.float32)
    return out


def main():
    sys.path.insert(0, ROOT)
    import jax

    from tests.torch_port_cases import float64_step
    from twinvoice_tpu.config import UNetConfig
    from twinvoice_tpu.data.dataset import ArrayDataset
    from twinvoice_tpu.train.checkpoint import load_params_npz

    pages, masks = render_batch()
    images, targets = next(ArrayDataset(pages, masks).batches(4, shuffle=False))
    params, state = load_params_npz(
        os.path.join(ROOT, "twinvoice_tpu", "models", "weights", "segmenter_synth_w16.npz"),
        UNetConfig(base_width=16))
    np_params = jax.tree.map(np.asarray, params)
    np_state = jax.tree.map(np.asarray, state)
    pkeys = [k for k, _ in leaf_items(params)]
    skeys = [k for k, _ in leaf_items(state)]
    rng = np.random.default_rng(0)
    sizes = [v.size for _, v in leaf_items(params)]
    idx = np.stack([rng.integers(0, n, SAMPLES) for n in sizes])

    out = {"pages": pages, "masks": masks, "param_keys": np.asarray(pkeys),
           "state_keys": np.asarray(skeys), "sample_idx": idx}
    for tag, (dtype, fast) in SETTINGS.items():
        got = jax_run(params, state, images, targets, dtype, fast)
        grads = got.pop("grads")
        out[f"{tag}_grad_sample"] = np.stack(
            [g.reshape(-1)[i] for (_, g), i in zip(grads, idx)]).astype(np.float32)
        for k, v in got.items():
            out[f"{tag}_{k}"] = v
        print(tag, "losses", got["losses"].tolist(), flush=True)

    loss, grads, new_state = float64_step(np_params, np_state, images, targets)
    out["exact_loss"] = np.float64(loss)
    out["exact_grad_norms"] = np.asarray([np.linalg.norm(grads[k]) for k in pkeys])
    out["exact_grad_sample"] = np.stack(
        [grads[k].reshape(-1)[i] for k, i in zip(pkeys, idx)])
    out["exact_bn1"] = np.concatenate([new_state[k] for k in skeys])
    print("exact loss", loss)
    np.savez_compressed(OUT, **out)
    print(f"wrote {OUT} ({os.path.getsize(OUT)} bytes)")


if __name__ == "__main__":
    main()
