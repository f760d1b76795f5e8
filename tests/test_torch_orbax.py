"""PyTorch port: the JAX package's Orbax checkpoints read without orbax,
TensorStore or zstandard (``train/orbax.py``, ``train/ocdbt.py``,
``ops/host_zstd``) and used by ``train/checkpoint.py``'s ``restore`` and
``restore_params`` and the entry points on them.

JAX writes into ``tmp_path`` with its own functions (``checkpoint.save``,
``save_params``, a directory saved twice with ``force=True``) from
numpy-built trees at ``base_width=8``, plus a tree of every dtype the JAX
package saves and a tree of thousands of leaves; every leaf the port reads
equals ``ocp.PyTreeCheckpointer().restore``'s in value, dtype and shape.
TensorStore itself writes the layouts orbax does not make here (B+tree
interior nodes, zarr arrays of several chunks with some absent). Then: one
port step after ``restore`` against the JAX step after JAX's ``restore``
(``test_torch_trainer.py``'s tolerances), ``fit(resume_dir=)``,
``Segmenter.from_checkpoint`` and ``compat.load_model`` against JAX's at 64²,
and the refusals."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import orbax.checkpoint as ocp
import pytest
import torch

from tests.torch_port_cases import random_unet
from twinvoice_tpu import compat as jax_compat
from twinvoice_tpu.config import InferConfig as JaxInferConfig
from twinvoice_tpu.config import TrainConfig as JaxTrainConfig
from twinvoice_tpu.config import UNetConfig as JaxUNetConfig
from twinvoice_tpu.data.dataset import synthetic_dataset
from twinvoice_tpu.infer.pipeline import Segmenter as JaxSegmenter
from twinvoice_tpu.train import checkpoint as jax_ckpt
from twinvoice_tpu.train import trainer as jax_trainer
from twinvoice_tpu_torch import compat
from twinvoice_tpu_torch.config import Config, InferConfig, TrainConfig, UNetConfig
from twinvoice_tpu_torch.data.dataset import ArrayDataset
from twinvoice_tpu_torch.data.dataset import synthetic_dataset as port_synthetic_dataset
from twinvoice_tpu_torch.infer.pipeline import Segmenter
from twinvoice_tpu_torch.models.unet import init_unet
from twinvoice_tpu_torch.train import checkpoint, orbax, trainer
from twinvoice_tpu_torch.train.ocdbt import OcdbtStore
from twinvoice_tpu_torch.weights import from_jax_params, keystr_items, to_jax_params

W8 = UNetConfig(base_width=8)
GRID = 64
LR = 1e-3


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    """The directories JAX writes: ``state`` (a TrainState after two steps,
    epoch 2), ``params`` (save_params), ``twice`` (saved at epoch 1, then
    again at epoch 4 with force=True), ``dtypes``, ``raw`` (orbax without
    compression) and ``many`` (3,600 leaves)."""
    root = tmp_path_factory.mktemp("orbax")
    jcfg, params, bn = random_unet(11, base_width=8)
    opt = jax_trainer.make_optimizer(JaxTrainConfig())
    step = jax_trainer.make_train_step(jcfg, JaxTrainConfig(), opt)
    images, masks = next(synthetic_dataset(n=4, size=32, seed=0).batches(4, shuffle=False))
    p, s = jax.tree.map(jnp.array, params), jax.tree.map(jnp.array, bn)
    o = opt.init(p)
    for _ in range(2):
        p, s, o, loss = step(p, s, o, jnp.asarray(images), jnp.asarray(masks), jnp.float32(LR))
    out = {k: str(root / k) for k in ("state", "params", "twice", "dtypes", "raw", "many")}
    out["jax_step"] = (opt, step)  # compiled once, reused by the step test
    jax_ckpt.save(out["state"], jax_trainer.TrainState(p, s, o, epoch=2, best_loss=float(loss)))
    jax_ckpt.save_params(out["params"], p, s)
    jax_ckpt.save(out["twice"], jax_trainer.TrainState(p, s, o, epoch=1, best_loss=9.0))
    jax_ckpt.save(out["twice"], jax_trainer.TrainState(p, s, o, epoch=4, best_loss=0.5))
    rng = np.random.default_rng(0)
    ocp.PyTreeCheckpointer().save(out["dtypes"], {
        "f4": rng.standard_normal((3, 5)).astype(np.float32),
        "f8": rng.standard_normal(7),
        "i4": np.arange(-4, 5, dtype=np.int32),
        "i8": np.asarray([[1 << 40, -3]], np.int64),
        "b1": np.asarray([True, False, True]),
        "bf16": jnp.asarray(rng.standard_normal(9), jnp.bfloat16),
        "zero_d": np.float32(2.5),
        "scalars": [np.int64(7), 0.125, np.float32(3.0)],
        "empty": {"d": {}, "l": [], "t": (), "n": None},
    })
    ocp.Checkpointer(ocp.PyTreeCheckpointHandler(use_compression=False)).save(
        out["raw"], {"w": rng.standard_normal((4, 6)).astype(np.float32), "i": np.int32(3)})
    ocp.PyTreeCheckpointer().save(out["many"], {
        f"g{i}": {"w": rng.standard_normal((2, i % 4 + 1)).astype(np.float32),
                  "n": [np.int32(i), np.float64(i / 3)]} for i in range(1200)})
    return out


def _same(mine, ref, path=()):
    """``mine`` (the port's) equals ``ref`` (orbax's restore): structure, and
    every leaf's value, dtype and shape."""
    if isinstance(ref, dict) or hasattr(ref, "_asdict"):
        ref = ref if isinstance(ref, dict) else ref._asdict()
        assert isinstance(mine, dict) and set(mine) == set(ref), path
        for k in ref:
            _same(mine[k], ref[k], path + (k,))
    elif isinstance(ref, (list, tuple)):
        assert type(mine) is type(ref) and len(mine) == len(ref), path
        for i, (a, b) in enumerate(zip(mine, ref)):
            _same(a, b, path + (i,))
    elif ref is None or isinstance(ref, (bool, int, float)):
        assert type(mine) is type(ref) and mine == ref, (path, mine, ref)
    else:
        want = np.asarray(ref)
        if str(want.dtype) == "bfloat16":
            assert torch.is_tensor(mine) and mine.dtype == torch.bfloat16, path
            assert tuple(mine.shape) == want.shape, path
            assert np.array_equal(mine.view(torch.int16).numpy(), want.view(np.int16)), path
        else:
            assert isinstance(mine, np.ndarray), (path, type(mine))
            assert mine.dtype == want.dtype and mine.shape == want.shape, (path, mine.dtype,
                                                                          want.dtype)
            assert np.array_equal(mine, want), path


@pytest.mark.parametrize("name", ["state", "params", "twice", "dtypes", "raw", "many"])
def test_leaves_equal_orbax_restore(dirs, name):
    _same(orbax.read(dirs[name]), ocp.PyTreeCheckpointer().restore(dirs[name]))


def test_orbax_writes_no_zero_size_leaf(tmp_path):
    """Why no zero-size leaf is read: orbax refuses to write one."""
    with pytest.raises(ValueError, match="zero size"):
        ocp.PyTreeCheckpointer().save(str(tmp_path / "z"), {"z": np.zeros((0, 3), np.float32)})


def test_ocdbt_interior_nodes_and_zarr_chunks(tmp_path):
    """Layouts orbax does not make here, written by TensorStore: a B+tree of
    height ≥ 1 (many keys, a small node limit, an indirect value) read key
    for key; a zarr v2 array of several chunks, one of them never written
    (its fill value), zstd and uncompressed, read as TensorStore reads it."""
    import tensorstore as ts

    base = f"file://{tmp_path / 'kv'}"
    kv = ts.KvStore.open({"driver": "ocdbt", "base": base,
                          "config": {"max_decoded_node_bytes": 1500}}).result()
    txn = ts.Transaction()
    for i in range(3000):
        kv.with_transaction(txn).write(f"key/{i:05d}/x".encode(), b"v%d" % i * (1 + i % 7)).result()
    txn.commit_async().result()
    kv.write(b"zz/big", os.urandom(5000)).result()
    store = OcdbtStore(tmp_path / "kv")
    assert store.version.height >= 1
    keys = kv.list().result()
    assert store.keys() == sorted(keys)
    for k in keys[::97] + [b"zz/big"]:
        assert store.read(k) == kv.read(k).result().value
    for comp in ({"id": "zstd", "level": 3}, None):
        d = tmp_path / f"zarr_{comp is None}"
        spec = {"driver": "zarr", "kvstore": {"driver": "ocdbt", "base": f"file://{d}"},
                "path": "a.b",
                "metadata": {"shape": [10, 9], "chunks": [4, 4], "dtype": "<f4",
                             "fill_value": 1.5, "compressor": comp,
                             "dimension_separator": "."}}
        arr = ts.open(spec, create=True).result()
        data = np.arange(90, dtype=np.float32).reshape(10, 9)
        arr[:8, :].write(data[:8]).result()  # the last row of chunks is never written
        got = orbax.read_zarr(OcdbtStore(d), "a.b")
        np.testing.assert_array_equal(got, arr.read().result())
        assert (got[8:] == 1.5).all()


def _port_state(jcfg_seed=0):
    params, bn = init_unet(torch.Generator().manual_seed(jcfg_seed), W8, device="cpu")
    return trainer.TrainState(params, bn, trainer.make_optimizer(params, TrainConfig()))


def test_restore_maps_the_optimizer_and_steps_as_jax(dirs):
    """``restore`` of the JAX state: params, BN state, epoch, best loss, each
    leaf's step and moments exactly the checkpoint's; then one step on a new
    batch equal to JAX's step after JAX's ``restore`` within
    ``test_torch_trainer.py``'s tolerances (loss 1e-5, BN state 1e-5, each
    kernel's step norm 1e-2 of JAX's)."""
    state = checkpoint.restore(dirs["state"], _port_state())
    ref = ocp.PyTreeCheckpointer().restore(dirs["state"])
    assert (state.epoch, state.best_loss) == (2, ref["meta"]["best_loss"])
    adam = ref["opt_state"]["inner_state"][0]
    jp, js = from_jax_params(ref["params"], ref["bn_state"])
    mu = dict(keystr_items(from_jax_params(adam["mu"], ref["bn_state"])[0]))
    nu = dict(keystr_items(from_jax_params(adam["nu"], ref["bn_state"])[0]))
    want = dict(keystr_items(jp))
    for name, p in keystr_items(state.params):
        st = state.optimizer.state[p]
        assert torch.equal(p.detach(), want[name]), name
        assert float(st["step"]) == int(adam["count"]) == 2
        assert torch.equal(st["exp_avg"], mu[name]) and torch.equal(st["exp_avg_sq"], nu[name])
    assert state.optimizer.param_groups[0]["lr"] == float(ref["opt_state"]["hyperparams"]
                                                          ["learning_rate"])
    for name, t in keystr_items(state.bn_state):
        assert torch.equal(t, dict(keystr_items(js))[name])

    images, masks = next(synthetic_dataset(n=4, size=32, seed=5).batches(4, shuffle=False))
    opt, jstep = dirs["jax_step"]
    _, params, bn = random_unet(11, base_width=8)
    template = jax_trainer.TrainState(jax.tree.map(jnp.array, params),
                                      jax.tree.map(jnp.array, bn),
                                      opt.init(jax.tree.map(jnp.array, params)))
    got = jax_ckpt.restore(dirs["state"], template)
    before = dict(keystr_items(jax.tree.map(np.array, got.params)))
    jp1, js1, _, jloss = jstep(got.params, got.bn_state, got.opt_state, jnp.asarray(images),
                               jnp.asarray(masks), jnp.float32(LR))
    step = trainer.make_train_step(W8, TrainConfig(), device="cpu")
    x = torch.from_numpy(images).permute(0, 3, 1, 2).contiguous()
    y = torch.from_numpy(masks).permute(0, 3, 1, 2).contiguous()
    tp1, ts1, loss = step(state.params, state.bn_state, state.optimizer, x, y, LR)
    assert abs(float(loss) - float(jloss)) <= 1e-5 * float(jloss)
    mp, ms = to_jax_params(tp1, ts1)
    for key, v in keystr_items(jax.tree.map(np.asarray, js1)):
        assert _rel(dict(keystr_items(ms))[key], v) <= 1e-5, key
    after, jafter = dict(keystr_items(mp)), dict(keystr_items(jax.tree.map(np.asarray, jp1)))
    for key, b in before.items():
        if key.endswith("['kernel']"):
            mine, theirs = np.linalg.norm(after[key] - b), np.linalg.norm(jafter[key] - b)
            assert abs(mine - theirs) <= 1e-2 * theirs, key


def test_fit_resumes_from_the_jax_state(dirs, tmp_path):
    ds = port_synthetic_dataset(n=4, size=32, seed=1)
    cfg = Config(model=W8, train=TrainConfig(epochs=3, checkpoint_dir=str(tmp_path / "ck"),
                                             visualize_dir=str(tmp_path / "vis")))
    logs = []
    state, history = trainer.fit(ds, cfg, device="cpu", resume_dir=dirs["state"],
                                 log=logs.append)
    assert [h["epoch"] for h in history] == [3] and state.epoch == 3
    assert any(m.startswith(f"resumed from {dirs['state']} at epoch 2") for m in logs)


def _pages(n=3, seed=0):
    rng = np.random.default_rng(seed)
    a = np.full((n, 90, 120, 3), 225, np.uint8) + rng.integers(0, 25, (n, 90, 120, 3),
                                                               dtype=np.uint8)
    for i in range(n):
        for _ in range(5):
            y, x = rng.integers(0, 80), rng.integers(0, 90)
            a[i, y:y + 6, x:x + 25] = rng.integers(0, 60)
    return a


def test_segmenter_and_compat_serve_the_jax_directory(dirs, monkeypatch):
    """``Segmenter.from_checkpoint`` and ``compat.load_model`` on the JAX
    ``save_params`` directory (and on the train state) give JAX's boxes and
    ok flags at 64². JAX's side is its ``Segmenter`` on orbax's restore of
    the directory: its own ``restore_params`` builds an ``init_unet``
    template first, 33 s eagerly on this CPU, which only fixes the
    structure of the same leaves."""
    ref = ocp.PyTreeCheckpointer().restore(dirs["params"])
    jseg = JaxSegmenter(ref["params"], ref["bn_state"], JaxUNetConfig(base_width=8),
                        JaxInferConfig(img_size=GRID), jnp.float32)
    pages = _pages()
    _, jboxes, jok = jseg.segment_batch(pages, pre_resized=False)
    for d in (dirs["params"], dirs["state"]):
        seg = Segmenter.from_checkpoint(d, W8, InferConfig(img_size=GRID), device="cpu")
        _, boxes, ok = seg.segment_batch(pages, pre_resized=False)
        np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))
        np.testing.assert_array_equal(boxes.numpy(), np.asarray(jboxes))

    monkeypatch.setattr(jax_compat, "UNetConfig", lambda: JaxUNetConfig(base_width=8))
    monkeypatch.setattr(jax_compat, "InferConfig", lambda: JaxInferConfig(img_size=GRID))
    monkeypatch.setattr(compat, "UNetConfig", lambda: W8)
    monkeypatch.setattr(compat, "InferConfig", lambda: InferConfig(img_size=GRID))
    monkeypatch.setattr(jax_ckpt, "restore_params",
                        lambda path, cfg: (lambda t: (t["params"], t["bn_state"]))(
                            ocp.PyTreeCheckpointer().restore(os.path.abspath(path))))
    jax_compat._segmenters.clear()
    compat._segmenters.clear()
    try:
        _, cb, co = compat.load_model(dirs["params"], device="cpu").segment_batch(
            pages, pre_resized=False)
        _, jb, jo = jax_compat.load_model(dirs["params"]).segment_batch(pages, pre_resized=False)
    finally:
        jax_compat._segmenters.clear()
        compat._segmenters.clear()
    np.testing.assert_array_equal(co.numpy(), np.asarray(jo))
    np.testing.assert_array_equal(cb.numpy(), np.asarray(jb))
    assert np.asarray(jok).any()


def test_refusals(dirs, tmp_path):
    """``use_zarr3``, ``use_ocdbt: false`` and a non-empty directory of no
    known kind raise (``fit`` does not start from scratch on one);
    ``has_checkpoint`` is JAX's rule; a ``save_params`` directory does not
    resume."""
    tree = {"params": {"w": np.ones(3, np.float32)}}
    for name, handler in (("zarr3", ocp.PyTreeCheckpointHandler(use_zarr3=True)),
                          ("no_ocdbt", ocp.PyTreeCheckpointHandler(use_ocdbt=False))):
        ocp.Checkpointer(handler).save(str(tmp_path / name), tree)
    with pytest.raises(ValueError, match="use_zarr3"):
        orbax.read(tmp_path / "zarr3")
    with pytest.raises(ValueError, match="use_ocdbt"):
        orbax.read(tmp_path / "no_ocdbt")
    other = tmp_path / "other"
    other.mkdir()
    (other / "notes.txt").write_text("not a checkpoint")
    assert checkpoint.has_checkpoint(str(other)) and checkpoint.has_checkpoint(dirs["state"])
    assert not checkpoint.has_checkpoint(str(tmp_path / "missing"))
    empty = tmp_path / "empty"
    empty.mkdir()
    assert not checkpoint.has_checkpoint(str(empty))
    with pytest.raises(ValueError, match="no checkpoint the port reads"):
        checkpoint.restore(str(other), _port_state())
    with pytest.raises(ValueError, match="no checkpoint the port reads"):
        checkpoint.restore_params(str(other), W8)
    with pytest.raises(ValueError, match="no checkpoint the port reads"):
        trainer.fit(ArrayDataset(np.zeros((4, 32, 32, 3), np.uint8),
                                 np.zeros((4, 32, 32, 3), np.uint8)),
                    Config(model=W8, train=TrainConfig(epochs=1, visualize=False,
                                                       checkpoint_dir=str(tmp_path / "c"))),
                    device="cpu", resume_dir=str(other), log=lambda m: None)
    with pytest.raises(ValueError, match="does not resume"):
        checkpoint.restore(dirs["params"], _port_state())
    with pytest.raises(ValueError, match="does not match"):
        checkpoint.restore_params(dirs["params"], UNetConfig(base_width=16))
