"""PyTorch port: the reference ``.pth`` schema and the weights-only
checkpoints (``twinvoice_tpu_torch.port``, ``train.checkpoint``) against the
JAX package's porter, and the ``Segmenter`` built from each against JAX's
``Segmenter.from_pth`` (base width 8, 64² grid, float32)."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_oracle import random_state_dict
from twinvoice_tpu.config import InferConfig as JaxInferConfig
from twinvoice_tpu.config import UNetConfig as JaxUNetConfig
from twinvoice_tpu.infer.pipeline import Segmenter as JaxSegmenter
from twinvoice_tpu.port import export_state_dict as jax_export
from twinvoice_tpu.port import port_state_dict as jax_port
from twinvoice_tpu_torch.config import Config, InferConfig, TrainConfig, UNetConfig
from twinvoice_tpu_torch.data.dataset import synthetic_dataset
from twinvoice_tpu_torch.infer import Segmenter
from twinvoice_tpu_torch.models.unet import tree_leaves
from twinvoice_tpu_torch.port import export_state_dict, load_pth, port_state_dict
from twinvoice_tpu_torch.train import checkpoint
from twinvoice_tpu_torch.train.trainer import fit
from twinvoice_tpu_torch.weights import from_jax_params

WIDTHS = (8, 16, 32, 64)
CFG = UNetConfig(base_width=8)
GRID = 64


def state_dict(seed=0):
    """A reference-schema state_dict whose masks cover part of each image."""
    return random_state_dict(np.random.default_rng(seed), widths=WIDTHS, scale=0.3)


def assert_trees_equal(a, b):
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            assert_trees_equal(a[k], b[k])
    elif isinstance(a, list):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert_trees_equal(x, y)
    else:
        assert a.dtype == b.dtype and torch.equal(a, b)


def pages(seed, n=3):
    return np.random.default_rng(seed).integers(0, 256, (n, GRID, GRID, 3), dtype=np.uint8)


SIZES = np.asarray([[640, 480], [GRID, GRID], [37, 90]], np.int32)


def test_port_state_dict_equals_jax_porter_in_torch_layout():
    sd = state_dict()
    jp, js = jax_port(sd, JaxUNetConfig(base_width=8))
    want = from_jax_params(*_numpy_trees(jp, js))
    got = port_state_dict(sd, CFG)
    assert_trees_equal(list(got), list(want))
    # tensors are copies: the state_dict is not aliased
    got[0]["out"]["bias"] += 1
    assert not np.array_equal(got[0]["out"]["bias"].numpy(), sd["out_conv.bias"])


def _numpy_trees(*trees):
    def np_tree(t):
        if isinstance(t, dict):
            return {k: np_tree(v) for k, v in t.items()}
        if isinstance(t, list):
            return [np_tree(v) for v in t]
        return np.asarray(t)
    return [np_tree(t) for t in trees]


@pytest.mark.parametrize("as_tensors", [False, True])
def test_export_state_dict_round_trips_and_equals_jax(as_tensors):
    sd = state_dict(1)
    src = {k: torch.from_numpy(v) for k, v in sd.items()} if as_tensors else sd
    params, state = port_state_dict(src, CFG)
    out = export_state_dict(params, state, CFG)
    jout = jax_export(*jax_port(sd, JaxUNetConfig(base_width=8)), JaxUNetConfig(base_width=8))
    assert list(out) == list(jout)  # the same keys in the same order
    assert set(out) == set(sd)
    for k, v in out.items():
        assert isinstance(v, np.ndarray) and v.dtype == np.float32
        np.testing.assert_array_equal(v, sd[k], err_msg=k)
        np.testing.assert_array_equal(v, np.asarray(jout[k]), err_msg=k)
    assert_trees_equal(list(port_state_dict(out, CFG)), [params, state])


def test_load_pth_reads_a_saved_state_dict(tmp_path):
    sd = state_dict(2)
    path = tmp_path / "best_unet_model.pth"
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}
               | {"down1.net.1.num_batches_tracked": torch.tensor(7)}, str(path))
    assert_trees_equal(list(load_pth(str(path), CFG)), list(port_state_dict(sd, CFG)))
    bf16 = load_pth(str(path), CFG, dtype=torch.bfloat16)
    assert all(t.dtype == torch.bfloat16 for t in tree_leaves(list(bf16)))


@pytest.fixture(scope="module")
def pth(tmp_path_factory):
    path = tmp_path_factory.mktemp("pth") / "model.pth"
    torch.save({k: torch.from_numpy(v) for k, v in state_dict(3).items()}, str(path))
    return str(path)


def test_from_pth_equals_jax_from_pth(pth):
    jseg = JaxSegmenter.from_pth(pth, JaxUNetConfig(base_width=8),
                                 JaxInferConfig(img_size=GRID), jnp.float32)
    tseg = Segmenter.from_pth(pth, CFG, InferConfig(img_size=GRID), torch.float32,
                              device="cpu")
    assert tseg.device.type == "cpu" and tseg.dtype == torch.float32
    x = pages(0)
    jm, jb, jo = jseg.segment_batch(x, SIZES)
    tm, tb, to = tseg.segment_batch(x, SIZES)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    mean = tm.numpy().mean()
    assert 0.05 < mean < 0.95, mean  # the masks cover part of each image


def test_from_pth_passes_keywords_on(pth):
    calib = [pages(5, 2)]
    seg = Segmenter.from_pth(pth, CFG, InferConfig(img_size=GRID), device="cpu",
                             int8_calib=calib)
    assert seg.qparams is not None
    if not torch.cuda.is_available():  # the default device is the card
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Segmenter.from_pth(pth, CFG, InferConfig(img_size=GRID))


def test_save_params_restore_params_round_trip(tmp_path, pth):
    params, state = load_pth(pth, CFG)
    checkpoint.save_params(str(tmp_path / "w"), params, state)
    assert os.listdir(tmp_path / "w") == ["params.pt"]
    assert_trees_equal(list(checkpoint.restore_params(str(tmp_path / "w"), CFG)),
                       [params, state])
    with pytest.raises(ValueError, match="does not match"):
        checkpoint.restore_params(str(tmp_path / "w"), UNetConfig(base_width=16))
    got = Segmenter.from_checkpoint(str(tmp_path / "w"), CFG, InferConfig(img_size=GRID),
                                    device="cpu").segment_batch(pages(1), SIZES)
    want = Segmenter(params, state, CFG, InferConfig(img_size=GRID),
                     device="cpu").segment_batch(pages(1), SIZES)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_from_checkpoint_reads_fits_directories(tmp_path):
    """``fit``'s ``best`` and ``latest`` hold the whole train state; their
    weights serve through ``from_checkpoint`` and equal the trained tree."""
    cfg4 = UNetConfig(base_width=4)
    cfg = Config(model=cfg4, train=TrainConfig(
        epochs=1, checkpoint_dir=str(tmp_path / "c"), visualize=False))
    state, _ = fit(synthetic_dataset(n=4, size=32), cfg, device="cpu", log=lambda m: None)
    x = np.random.default_rng(2).integers(0, 256, (2, 32, 32, 3), dtype=np.uint8)
    want = Segmenter(state.params, state.bn_state, cfg4, InferConfig(img_size=32),
                     device="cpu").segment_batch(x)
    for name in ("best", "latest"):
        d = str(tmp_path / "c" / name)
        assert_trees_equal(list(checkpoint.restore_params(d, cfg4)),
                           [state.params, state.bn_state])
        got = Segmenter.from_checkpoint(d, cfg4, InferConfig(img_size=32),
                                        device="cpu").segment_batch(x)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
