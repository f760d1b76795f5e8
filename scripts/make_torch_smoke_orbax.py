"""Make ``tests/data/torch_smoke_orbax/`` and ``tests/data/torch_smoke_orbax.npz``:
the JAX package's Orbax checkpoints that the PyTorch port reads without orbax,
TensorStore or zstandard (``chip_smoke.py`` phase 33 on the card,
``tests/test_torch_fixture_orbax.py`` on the CPU). The card's machine has no
orbax, so the JAX side is committed.

Directories, each written by the JAX package's own functions:

- ``w16_params/``: ``checkpoint.save_params`` of the bundled
  ``segmenter_synth_w16.npz`` (the full width of a model the repo ships).
- ``w8_state/``: ``checkpoint.save`` of a ``base_width=8`` ``TrainState``
  after two ``make_train_step`` steps (lr 1e-3) on a b4 128² synthetic batch
  (``synthetic_dataset(n=4, size=128, seed=0)``), from a numpy-built random
  U-Net (``tests/torch_port_cases.random_unet(3, base_width=8)``), with
  ``epoch=2`` and ``best_loss`` the second step's loss.

The npz:

- ``w16_keys``/``w16_digests``, ``w8_keys``/``w8_digests``: every leaf of
  each directory (``/``-joined path) and the SHA-256 of its dtype, shape and
  bytes (``chip_smoke.leaf_digest``), as orbax restores it; the w16 leaves are also the
  bundled npz's, which the checks compare value for value.
- ``images``, ``masks`` (4, 128, 128, 3) uint8: the next batch's
  ``synthetic_dataset(n=4, size=128, seed=1)`` (its ``batches(4,
  shuffle=False)`` is the step's input); ``lr``: its learning rate,
  the JAX trainer's schedule at epoch 3 rounded to float32.
- ``param_keys``, ``state_keys``: ``keystr`` paths in the order of the
  per-leaf arrays; ``sample_idx`` (L, 16) flat indices into each param leaf.
- ``jax_loss``, ``jax_step_norms`` (L,) ‖new − old‖ of each param leaf,
  ``jax_step_sample`` (L, 16) the new params at ``sample_idx``, ``jax_bn``
  the BN state after: JAX's ``make_train_step`` from the restored state.
- ``exact_loss``, ``exact_grad_norms``, ``exact_grad_sample``, ``exact_bn``:
  the float64 step (``tests/torch_port_cases.float64_step``) on the saved
  params.
- ``epoch``, ``best_loss``, ``count`` (the optax step count): the saved meta.
- ``pages_ok``, ``pages_boxes``: JAX's ``Segmenter.from_checkpoint(
  w16_params/)`` at fp32 on ``torch_smoke_pages.npz``'s pages
  (``segment_batch(pre_resized=False)``).

    JAX_PLATFORMS=cpu python scripts/make_torch_smoke_orbax.py    # ~1 min
"""

from __future__ import annotations

import os
import shutil
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT_DIR = os.path.join(ROOT, "tests", "data", "torch_smoke_orbax")
OUT = os.path.join(ROOT, "tests", "data", "torch_smoke_orbax.npz")
LR = 1e-3
SAMPLES = 16


def main():
    sys.path.insert(0, ROOT)
    import jax
    import jax.numpy as jnp
    import orbax.checkpoint as ocp

    from chip_smoke import flat_leaves, leaf_digest
    from tests.torch_port_cases import float64_step, random_unet
    from twinvoice_tpu.config import InferConfig, TrainConfig, UNetConfig
    from twinvoice_tpu.data.dataset import synthetic_dataset
    from twinvoice_tpu.infer.pipeline import Segmenter
    from twinvoice_tpu.train import checkpoint, trainer
    from twinvoice_tpu.train.schedule import cosine_warm_restarts
    from twinvoice_tpu_torch.weights import keystr_items, read_npz_tree

    shutil.rmtree(OUT_DIR, ignore_errors=True)
    os.makedirs(OUT_DIR)
    out = {}

    # w16: the bundled weights as a save_params directory
    w16 = os.path.join(OUT_DIR, "w16_params")
    bp, bs = read_npz_tree(os.path.join(ROOT, "twinvoice_tpu", "models", "weights",
                                        "segmenter_synth_w16.npz"))
    checkpoint.save_params(w16, jax.tree.map(jnp.asarray, bp), jax.tree.map(jnp.asarray, bs))

    # w8: a train state after two steps
    jcfg, params, state = random_unet(3, base_width=8)
    tcfg = TrainConfig()
    opt = trainer.make_optimizer(tcfg)
    step = trainer.make_train_step(jcfg, tcfg, opt)
    images, masks = next(synthetic_dataset(n=4, size=128, seed=0).batches(4, shuffle=False))
    p, s = jax.tree.map(jnp.array, params), jax.tree.map(jnp.array, state)
    o = opt.init(p)
    for _ in range(2):
        p, s, o, loss = step(p, s, o, jnp.asarray(images), jnp.asarray(masks), jnp.float32(LR))
    best = float(loss)
    w8 = os.path.join(OUT_DIR, "w8_state")
    checkpoint.save(w8, trainer.TrainState(p, s, o, epoch=2, best_loss=best))

    for tag, d in (("w16", w16), ("w8", w8)):
        leaves = flat_leaves(ocp.PyTreeCheckpointer().restore(os.path.abspath(d)))
        out[f"{tag}_keys"] = np.asarray([k for k, _ in leaves])
        out[f"{tag}_digests"] = np.asarray([leaf_digest(v) for _, v in leaves])
        print(tag, len(leaves), "leaves", flush=True)

    # the next step from the restored state, in JAX and in float64
    template = trainer.TrainState(jax.tree.map(jnp.array, params),
                                  jax.tree.map(jnp.array, state),
                                  opt.init(jax.tree.map(jnp.array, params)))
    got = checkpoint.restore(w8, template)
    sp = jax.tree.map(np.array, got.params)  # copies: the step donates its inputs
    ss = jax.tree.map(np.array, got.bn_state)
    count = np.int64(np.asarray(got.opt_state.inner_state[0].count))
    nds = synthetic_dataset(n=4, size=128, seed=1)
    nimages, nmasks = next(nds.batches(4, shuffle=False))
    schedule = cosine_warm_restarts(tcfg.lr, tcfg.warm_restart_t0, tcfg.warm_restart_tmult,
                                    tcfg.eta_min)
    lr = np.float32(schedule(2))
    p1, s1, _, jloss = step(got.params, got.bn_state, got.opt_state, jnp.asarray(nimages),
                            jnp.asarray(nmasks), jnp.float32(lr))
    before = dict(keystr_items(sp))
    after = dict(keystr_items(jax.tree.map(np.asarray, p1)))
    pkeys = list(before)
    skeys = [k for k, _ in keystr_items(ss)]
    rng = np.random.default_rng(0)
    idx = np.stack([rng.integers(0, before[k].size, SAMPLES) for k in pkeys])
    new_bn = dict(keystr_items(jax.tree.map(np.asarray, s1)))
    exact_loss, exact_grads, exact_state = float64_step(sp, ss, nimages, nmasks)
    out.update({
        "images": nds.images, "masks": nds.masks, "lr": lr,
        "param_keys": np.asarray(pkeys), "state_keys": np.asarray(skeys),
        "sample_idx": idx, "jax_loss": np.float32(jloss),
        "jax_step_norms": np.asarray([np.linalg.norm((after[k] - before[k]).astype(np.float64))
                                      for k in pkeys]),
        "jax_step_sample": np.stack([after[k].reshape(-1)[i] for k, i in zip(pkeys, idx)]),
        "jax_bn": np.concatenate([new_bn[k].reshape(-1) for k in skeys]),
        "exact_loss": np.float64(exact_loss),
        "exact_grad_norms": np.asarray([np.linalg.norm(exact_grads[k]) for k in pkeys]),
        "exact_grad_sample": np.stack([exact_grads[k].reshape(-1)[i] for k, i in zip(pkeys, idx)]),
        "exact_bn": np.concatenate([exact_state[k].reshape(-1) for k in skeys]),
        "epoch": np.int64(2), "best_loss": np.float64(best),
        "count": count,
    })
    print(f"next step: JAX loss {float(jloss):.8f}, exact {exact_loss:.8f}, lr {lr}", flush=True)

    # JAX's from_checkpoint boxes on the pages fixture at fp32
    with np.load(os.path.join(ROOT, "tests", "data", "torch_smoke_pages.npz")) as z:
        pages = z["pages"]
    seg = Segmenter.from_checkpoint(os.path.abspath(w16), UNetConfig(base_width=16),
                                    InferConfig(img_size=512), jnp.float32)
    _, boxes, ok = seg.segment_batch(np.repeat(pages[..., None], 3, axis=-1), pre_resized=False)
    out["pages_ok"], out["pages_boxes"] = np.asarray(ok), np.asarray(boxes)
    print("from_checkpoint ok", np.asarray(ok).tolist(), flush=True)

    np.savez_compressed(OUT, **out)
    size = sum(os.path.getsize(os.path.join(dp, f)) for dp, _, fs in os.walk(OUT_DIR) for f in fs)
    print(f"wrote {OUT} ({os.path.getsize(OUT)} bytes) and {OUT_DIR} ({size} bytes)")


if __name__ == "__main__":
    main()
