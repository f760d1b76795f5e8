"""PyTorch port: the reference-shaped convenience API
(``twinvoice_tpu_torch.compat``) against the JAX package's ``compat``. Both
packages' ``UNetConfig`` and ``InferConfig`` are patched small (base width
8, 64² grid), so no full-width JAX model is compiled."""

import numpy as np
import pytest
import torch
from PIL import Image

from tests.torch_oracle import random_state_dict
from twinvoice_tpu import compat as jax_compat
from twinvoice_tpu.config import InferConfig as JaxInferConfig
from twinvoice_tpu.config import UNetConfig as JaxUNetConfig
from twinvoice_tpu_torch import compat
from twinvoice_tpu_torch.config import InferConfig, UNetConfig
from twinvoice_tpu_torch.port import load_pth
from twinvoice_tpu_torch.train import checkpoint

GRID = 64


@pytest.fixture(scope="module")
def pth(tmp_path_factory):
    sd = random_state_dict(np.random.default_rng(4), widths=(8, 16, 32, 64), scale=0.3)
    path = tmp_path_factory.mktemp("ckpt") / "best_unet_model.pth"
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, str(path))
    return str(path)


@pytest.fixture
def small(monkeypatch):
    monkeypatch.setattr(jax_compat, "UNetConfig", lambda: JaxUNetConfig(base_width=8))
    monkeypatch.setattr(jax_compat, "InferConfig", lambda: JaxInferConfig(img_size=GRID))
    monkeypatch.setattr(compat, "UNetConfig", lambda: UNetConfig(base_width=8))
    monkeypatch.setattr(compat, "InferConfig", lambda: InferConfig(img_size=GRID))
    jax_compat._segmenters.clear()
    compat._segmenters.clear()
    yield
    jax_compat._segmenters.clear()
    compat._segmenters.clear()


def photo(seed, w=120, h=90):
    """A bright photo with dark 'text' bars, so the crops are not black."""
    rng = np.random.default_rng(seed)
    a = np.full((h, w, 3), 230, np.uint8) + rng.integers(0, 20, (h, w, 3), dtype=np.uint8)
    for _ in range(5):
        y, x = rng.integers(0, h - 10), rng.integers(0, w - 30)
        a[y:y + 6, x:x + 25] = rng.integers(0, 60)
    return Image.fromarray(a)


@pytest.mark.parametrize("mode,size", [("RGB", (100, 80)), ("L", (37, 90)),
                                       ("RGBA", (640, 480))])
def test_preprocess_equals_jax(mode, size):
    rng = np.random.default_rng(size[0])
    chans = {"RGB": 3, "L": None, "RGBA": 4}[mode]
    shape = (size[1], size[0]) + ((chans,) if chans else ())
    img = Image.fromarray(rng.integers(0, 256, shape, dtype=np.uint8), mode)
    got, want = compat.preprocess(img), jax_compat.preprocess(img)
    assert got.shape == (1, 512, 512, 3) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed,size", [(0, (120, 90)), (1, (300, 417))])
def test_run_unet_equals_jax(small, pth, seed, size):
    img = photo(seed, *size)
    masks, crops = compat.run_unet(img, pth, device="cpu")
    jmasks, jcrops = jax_compat.run_unet(img, pth)
    assert list(masks) == list(jmasks) == compat.FIELDS
    assert list(crops) == list(jcrops)
    for f in compat.FIELDS:
        assert masks[f].shape == (GRID, GRID)
        np.testing.assert_array_equal(masks[f], np.asarray(jmasks[f]), err_msg=f)
        assert (crops[f] is None) == (jcrops[f] is None), f
        if crops[f] is not None:
            np.testing.assert_array_equal(np.asarray(crops[f]), np.asarray(jcrops[f]))
    assert any(c is not None for c in crops.values())


def test_load_model_loads_once_per_path_dtype_and_device(small, pth, tmp_path):
    seg = compat.load_model(pth, device="cpu")
    assert compat.load_model(pth, device="cpu") is seg
    assert seg.dtype == torch.float32 and seg.model_cfg == UNetConfig(base_width=8)
    assert compat.load_model(pth, device="cpu", dtype=torch.bfloat16) is not seg
    # a directory is a checkpoint directory
    checkpoint.save_params(str(tmp_path / "w"), *load_pth(pth, UNetConfig(base_width=8)))
    from_dir = compat.load_model(str(tmp_path / "w"), device="cpu")
    assert from_dir is not seg
    x = np.random.default_rng(0).integers(0, 256, (2, GRID, GRID, 3), dtype=np.uint8)
    for a, b in zip(seg.segment_batch(x), from_dir.segment_batch(x)):
        assert torch.equal(a, b)
    if not torch.cuda.is_available():  # the default device is the card
        with pytest.raises(RuntimeError, match="no CUDA device"):
            compat.load_model(pth)
